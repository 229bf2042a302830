"""Platform plumbing: DP kernel choice, compile-cache placement, the KDE device
kernel against the float64 host path, and cohort card assignment."""

import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pav_tpu import runtime
from pav_tpu.ops import affine_dp

# (max_n, width) per DP regime: full width, row/wave band, and the widest band.
SHAPES = {'full': (2048, 2049), 'band': (8192, 513), 'wide_band': (8192, 2049)}


class _SealedEnviron(dict):
    """An os.environ that fails any read: proves the caller consults none."""

    def __getitem__(self, key):
        raise AssertionError(f'read environment variable {key}')

    def get(self, key, default=None):
        raise AssertionError(f'read environment variable {key}')

    def __contains__(self, key):
        raise AssertionError(f'read environment variable {key}')


@pytest.mark.parametrize('platform,shape,expected', [
    ('cpu', 'full', 'full'), ('cpu', 'band', 'row'), ('cpu', 'wide_band', 'row'),
    ('gpu', 'full', 'full'), ('gpu', 'band', 'wave'), ('gpu', 'wide_band', 'wave'),
])
def test_dp_kernel_selection(platform, shape, expected, monkeypatch):
    """One kernel per DP regime per platform, chosen from the platform and the
    shape alone: the choice reads no environment variable, so none can
    change it."""
    max_n, width = SHAPES[shape]
    monkeypatch.setattr(os, 'environ', _SealedEnviron())
    assert affine_dp.dp_kernel(platform, max_n, width) == expected


@pytest.mark.parametrize('env_dir', [None, 'set'])
def test_compile_cache_placement(env_dir, tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins and the code sets no other directory;
    without it the cache is the fixed, gitignored directory in the checkout."""
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_dir:
            target = str(tmp_path / 'jax_cache')
            monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', target)
            jax.config.update('jax_compilation_cache_dir', target)
            assert runtime.enable_compile_cache() == target
            assert jax.config.jax_compilation_cache_dir == target
        else:
            monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
            path = runtime.enable_compile_cache()
            root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            assert path == os.path.join(root, '.jax_cache')
            assert jax.config.jax_compilation_cache_dir == path
            with open(os.path.join(root, '.gitignore')) as fh:
                assert '.jax_cache/' in fh.read().split()
    finally:
        jax.config.update('jax_compilation_cache_dir', before)


def test_kde_device_kernel_matches_float64_host():
    """The float32 FFT device kernel at n_pad = 2^15 decides the same state as
    the float64 host path wherever the host's two best densities are not a
    near-tie (bench.KDE_TIE_TOL of the grid's peak density)."""
    import jax.numpy as jnp

    import bench
    from pav_tpu.ops import kde

    n_pad = 1 << 15
    state, sigmas = bench.kde_inputs(n_pad)
    st, dens = kde._density_state_kernel(jnp.asarray(state),
                                         jnp.asarray(sigmas), n_pad, 3)
    agree = bench.kde_agreement(state, sigmas, np.asarray(st), np.asarray(dens))
    assert agree['decided'] > 0.9 * n_pad
    assert agree['mismatched_states'] == 0, agree
    assert agree['max_abs_err_rel_to_peak'] < bench.KDE_TIE_TOL


@pytest.mark.parametrize('env,expected', [
    ({'JAX_PLATFORMS': 'cpu'}, 0),
    ({'JAX_PLATFORMS': 'cuda', 'CUDA_VISIBLE_DEVICES': '0,1,2,3'}, 4),
    ({'JAX_PLATFORMS': '', 'CUDA_VISIBLE_DEVICES': '1'}, 1),
])
def test_cohort_gpu_count(env, expected, monkeypatch):
    """Cohort processes each take one card: the card count is read without
    starting a JAX backend, and a CPU-only run assigns none."""
    from pav_tpu.parallel.multihost import local_gpu_count

    for key, val in env.items():
        monkeypatch.setenv(key, val)
    assert local_gpu_count() == expected
