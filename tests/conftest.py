"""Test configuration: force an 8-virtual-device CPU mesh.

Multi-chip hardware is not available in CI; sharding logic is validated on a
virtual CPU mesh (the driver separately dry-run-compiles the multi-chip path
via __graft_entry__.dryrun_multichip).
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


QUERY_FA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "query.fa")


@pytest.fixture(scope="session")
def query_fa_path():
    return QUERY_FA
