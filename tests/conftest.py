"""Test harness config.

Run the suite on the CPU with `JAX_PLATFORMS=cpu python -m pytest tests/`:
it then sees a virtual 8-device mesh (fake multi-device, the pattern the
reference lacks — SURVEY.md §4(d)).  Without JAX_PLATFORMS=cpu on a machine
with a GPU, JAX picks the GPU, `backend="auto"` resolves to the Triton sweep
and the mesh has as many devices as there are cards, so tests that assume
the CPU or eight devices fail there.  Tests that need the GPU are marked
`gpu` and take the `gpu_device` fixture, which skips them where JAX finds
no GPU; on the card run only them, with `python -m pytest tests/ -m gpu`.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402
import pytest  # noqa: E402

from rtm_tpu.utils.cache import enable_compile_cache  # noqa: E402
from rtm_tpu.utils.compare import images_close  # noqa: E402

enable_compile_cache()


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU")
    config.addinivalue_line("markers", "slow: long-running test")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX finds none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU device")


@pytest.fixture
def image_compare():
    return images_close
