"""Test configuration: run JAX on a virtual 8-device CPU mesh so sharding tests
exercise multi-device layouts without accelerator hardware. Tests that need
the card carry the ``gpu`` marker and skip here (see ``gpu_device``).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# CPU unless the caller names platforms: the card's tests run with
# JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
os.environ.setdefault('JAX_PLATFORMS', 'cpu')
flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (flags + ' --xla_force_host_platform_device_count=8').strip()

import jax  # noqa: E402
import pytest  # noqa: E402

from pav_tpu.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()

if os.environ['JAX_PLATFORMS'] == 'cpu':
    assert jax.devices()[0].platform == 'cpu', 'tests must run on the CPU backend'


@pytest.fixture
def gpu_device():
    """The GPU for ``gpu``-marked tests. Decided here, at run time, so every
    xdist worker collects the same tests."""
    try:
        gpus = jax.devices('gpu')
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip('needs an NVIDIA GPU (run on the card: python chip_smoke.py)')
    return gpus[0]
