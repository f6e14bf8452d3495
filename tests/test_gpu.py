"""Device checks on a GPU. They skip on any other device; run them on a card
with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py``."""

import pytest

from heatflow_tpu.devicecheck import CHECKS


@pytest.fixture
def gpu():
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda on a card)")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CHECKS))
def test_device_check_on_gpu(gpu, name):
    assert CHECKS[name]() >= 0.0
