"""Global JAX configuration for finch_tpu.

The murmur/bottom-k pipeline is 64-bit integer arithmetic; we require
jax_enable_x64.
"""

import os

_configured = False

# persistent compilation cache used when JAX_COMPILATION_CACHE_DIR is not
# set: a fixed path inside the checkout (listed in .gitignore), so every
# process of one checkout finds what an earlier one compiled
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def cache_dir(environ=os.environ):
    """The directory this package points JAX's compilation cache at, or
    None when JAX_COMPILATION_CACHE_DIR is set (JAX then reads it itself
    and no other directory is set in code)."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return REPO_CACHE_DIR


def configure() -> None:
    global _configured
    if _configured:
        return
    # Must run before JAX creates any arrays.
    os.environ.setdefault("JAX_ENABLE_X64", "1")
    try:
        import jax

        jax.config.update("jax_enable_x64", True)
        # FINCH_TPU_PLATFORM selects the JAX platform (e.g. force "cpu"
        # in CI on a machine that has an accelerator)
        platform = os.environ.get("FINCH_TPU_PLATFORM")
        if platform:
            jax.config.update("jax_platforms", platform)
        # the sketch pipeline's big sorts compile slowly; CLI invocations
        # reuse compiled executables across processes
        cache = cache_dir()
        if cache is not None:
            os.makedirs(cache, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", cache)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except ImportError:  # pragma: no cover - jax is a hard dep in practice
        pass
    _configured = True
