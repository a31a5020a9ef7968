"""Process-level configuration: the compilation-cache rule and the
`auto` backend's device detection."""

import os
import subprocess
import sys

import pytest

from finch_tpu import _config
from finch_tpu.models import engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir_in_child(env_update):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_update, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-c",
         "import finch_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        env=env, capture_output=True, text=True, check=True, timeout=120)
    return out.stdout.strip()


def test_cache_follows_jax_compilation_cache_dir(tmp_path):
    assert _config.cache_dir({"JAX_COMPILATION_CACHE_DIR": "x"}) is None
    got = _cache_dir_in_child({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert got == str(tmp_path)


def test_cache_defaults_to_the_checkout():
    assert _config.cache_dir({}) == os.path.join(REPO, ".jax_cache")
    assert _cache_dir_in_child({}) == os.path.join(REPO, ".jax_cache")


def test_accelerator_present_false_on_cpu():
    assert engine._accelerator_present() is False
    assert isinstance(engine.make_engine(
        engine.SketchParams.mash(kmers_to_sketch=10, final_size=10)),
        engine.NativeEngine)


def test_accelerator_backend_error_propagates(monkeypatch):
    """A backend that fails to initialise must not quietly send `auto`
    to the host fold."""
    import jax

    def broken():
        raise RuntimeError("Unable to initialize backend 'cuda'")

    monkeypatch.setattr(jax, "default_backend", broken)
    with pytest.raises(RuntimeError, match="cuda"):
        engine._accelerator_present()
    with pytest.raises(RuntimeError, match="cuda"):
        engine.make_engine(engine.SketchParams.mash(kmers_to_sketch=10,
                                                    final_size=10))
