"""Test configuration.

The suite runs on the CPU (``JAX_PLATFORMS=cpu``) with 8 virtual devices, so
mesh and sharding tests run without a multi-device machine.  Tests marked
``gpu`` need a card and skip elsewhere; run them on the card in one process
(see README).  Whether a test can run is decided inside fixtures, never at
import: every xdist worker must collect the same tests.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )

import jax  # noqa: E402
import pytest  # noqa: E402

from dropout_hamiltonian_montecarlo_tpu.utils.runtime import configure  # noqa: E402

jax.config.update("jax_threefry_partitionable", True)
# The library's operating point (cli.py/bench.py): float32 matmuls and the
# persistent compile cache.
configure()


@pytest.fixture
def multidevice():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices (run via scripts/test_cpu_mesh.sh)")


requires_multidevice = pytest.mark.usefixtures("multidevice")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if (request.node.get_closest_marker("gpu") is not None
            and jax.devices()[0].platform != "gpu"):
        pytest.skip("needs a GPU (run the gpu-marked tests on the card)")
