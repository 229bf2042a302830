"""Gaussian KDE over integer positions as FFT convolution (device kernel).

The reference evaluates scipy gaussian_kde per k-mer state over a
multiprocessing pool with sampled evaluation + interpolation
(pavlib/density.py:136-323). Because evaluation points are exactly the integer
grid 0..n-1 and the data points are a subset of that grid, the scaled KDE
  count_s * KDE_s(x) = sum_i N(x; p_i, sigma_s^2)
is exactly the linear convolution of the state's indicator histogram with a
Gaussian kernel — computed here for every position at once with real FFTs.
O(n log n), batched over states and regions, XLA-compiled (on the GPU XLA
hands the FFTs to cuFFT); no sampling or interpolation error.

Shape discipline: the device program is keyed ONLY by the pow2-padded grid
length (n_pad) — the Gaussian kernels are built on device from the 3 sigmas
with full +-n_pad support, so varying bandwidths never mint new programs (a
repeat-rich haplotype triggers hundreds of scans with data-dependent sigmas;
per-sigma shapes would each cost an XLA compile). Truncating the
kernel at +-n_pad is exact for every evaluated position: data points and
evaluation grid both live in [0, n) with n <= n_pad, so |x - p| < n_pad.
Small grids (n_pad <= 2^14) run on the host with numpy's float64 FFT instead
— a device launch is pure overhead at these sizes, and the host result is
strictly closer to the scipy reference values.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

_TRUNC_SIGMAS = 8.0  # kernel support half-width in sigmas (host path)

# Grids at or below this run on the host (numpy FFT): a device launch is
# pure overhead at these sizes. Override with PAV_TPU_KDE_HOST_MAX (0 disables).
_HOST_FFT_MAX = int(os.environ.get('PAV_TPU_KDE_HOST_MAX', 1 << 14))


def _next_pow2(x):
    n = 1
    while n < x:
        n <<= 1
    return n


@functools.partial(jax.jit, static_argnames=('fft_len',))
def _conv_batch(hist, kernels, fft_len):
    """hist: [B, n] float32, kernels: [B, kw] float32 (kw odd, centered).
    Returns linear convolution same-size as hist: [B, n]. (Also exercised by
    the multichip dryrun's device step.)"""
    kw = kernels.shape[1]
    half = kw // 2
    H = jnp.fft.rfft(hist, n=fft_len, axis=1)
    K = jnp.fft.rfft(kernels, n=fft_len, axis=1)
    full = jnp.fft.irfft(H * K, n=fft_len, axis=1)
    return full[:, half:half + hist.shape[1]]


@functools.partial(jax.jit, static_argnames=('n_pad', 'n_states'))
def _density_state_kernel(state_mer, sigmas, n_pad, n_states):
    """state_mer: int8 [n_pad] (values 0..n_states-1, or -1 padding);
    sigmas: float32 [n_states]. Kernel build, histogram, convolution, spike
    clamp, and argmax all run on device; returns (state int8 [n_pad],
    dens f32 [n_states, n_pad]). Callers transfer only the state vector on
    the scan path. Program shape depends on n_pad alone."""
    # Gaussian kernels with full +-n_pad support, built on device (h2d is the
    # int8 state vector + 3 floats; never a kernel array).
    x = jnp.arange(-n_pad, n_pad + 1, dtype=jnp.float32)
    sg = jnp.maximum(sigmas[:, None], 1e-30)
    kernels = jnp.where(
        sigmas[:, None] > 0,
        jnp.exp(-0.5 * (x[None, :] / sg) ** 2)
        / (sg * np.float32(np.sqrt(2 * np.pi))),
        jnp.float32(0))
    hist = jnp.stack([
        (state_mer == s).astype(jnp.float32) for s in range(n_states)
    ])
    fft_len = 4 * n_pad  # >= n_pad + (2*n_pad+1) - 1, pow2
    H = jnp.fft.rfft(hist, n=fft_len, axis=1)
    K = jnp.fft.rfft(kernels, n=fft_len, axis=1)
    full = jnp.fft.irfft(H * K, n=fft_len, axis=1)
    dens = full[:, n_pad:2 * n_pad]
    dens = jnp.where(dens > 1.0, 1.0 / jnp.maximum(dens, 1e-30), dens)
    state = jnp.argmax(dens, axis=0).astype(jnp.int8)
    return state, dens


@functools.partial(jax.jit, static_argnames=('n_pad', 'n_states'))
def _density_state_kernel_batch(state_mers, sigmas, n_pad, n_states):
    """Batched variant of _density_state_kernel: state_mers int8 [B, n_pad],
    sigmas float32 [B, n_states]. Every op is batch-elementwise, so a batch
    sharded along B over a device mesh partitions with no collectives — this
    is the multi-device path for the density engine (INV batch fan-out ->
    data-parallel region shards)."""
    x = jnp.arange(-n_pad, n_pad + 1, dtype=jnp.float32)
    sg = jnp.maximum(sigmas[:, :, None], 1e-30)                  # [B, S, 1]
    kernels = jnp.where(
        sigmas[:, :, None] > 0,
        jnp.exp(-0.5 * (x[None, None, :] / sg) ** 2)
        / (sg * np.float32(np.sqrt(2 * np.pi))),
        jnp.float32(0))                                           # [B, S, 2n+1]
    hist = jnp.stack([
        (state_mers == s).astype(jnp.float32) for s in range(n_states)
    ], axis=1)                                                    # [B, S, n]
    fft_len = 4 * n_pad
    H = jnp.fft.rfft(hist, n=fft_len, axis=2)
    K = jnp.fft.rfft(kernels, n=fft_len, axis=2)
    full = jnp.fft.irfft(H * K, n=fft_len, axis=2)
    dens = full[:, :, n_pad:2 * n_pad]
    dens = jnp.where(dens > 1.0, 1.0 / jnp.maximum(dens, 1e-30), dens)
    state = jnp.argmax(dens, axis=1).astype(jnp.int8)             # [B, n]
    return state, dens


def smoothed_states_batch(state_mers, sigmas_list, n_states=3, mesh=None):
    """Batch of independent density-smoothing problems in ONE device program.

    Regions pad to a common pow2 grid; with a mesh the batch shards along its
    leading axis (pav_tpu.parallel.mesh) and XLA partitions the FFTs across
    devices with no collectives.

    :param state_mers: list of int arrays (state labels per position).
    :param sigmas_list: list of per-state sigma arrays.
    :return: list of int8 state arrays, one per input, unpadded.
    """
    if not state_mers:
        return []
    lens = [len(s) for s in state_mers]
    n_pad = _next_pow2(max(max(lens), 16))
    B = len(state_mers)
    batch = np.full((B, n_pad), -1, dtype=np.int8)
    for i, s in enumerate(state_mers):
        batch[i, :lens[i]] = np.asarray(s, dtype=np.int8)
    sig = np.asarray(sigmas_list, dtype=np.float32).reshape(B, n_states)

    if mesh is not None and B % mesh.size == 0:
        from jax.sharding import NamedSharding, PartitionSpec as P
        shard = NamedSharding(mesh, P(mesh.axis_names[0]))
        batch_d = jax.device_put(jnp.asarray(batch), shard)
        sig_d = jax.device_put(jnp.asarray(sig), shard)
    else:
        batch_d, sig_d = jnp.asarray(batch), jnp.asarray(sig)

    state, _dens = _density_state_kernel_batch(batch_d, sig_d, n_pad, n_states)
    state_np = np.asarray(state)
    return [state_np[i, :lens[i]] for i in range(B)]


def _host_density_states(state_mer, sigmas, n_states):
    """Host numpy mirror of the device kernel for small grids: float64 FFT
    (closer to the scipy reference), float32 clamp + argmax to match the
    device's decision arithmetic."""
    n = len(state_mer)
    hist = np.zeros((n_states, n), dtype=np.float64)
    for s in range(n_states):
        hist[s, np.nonzero(state_mer == s)[0]] = 1.0

    max_sigma = float(np.max(sigmas)) if len(sigmas) else 0.0
    half = min(int(np.ceil(_TRUNC_SIGMAS * max(max_sigma, 1.0))), n)
    x = np.arange(-half, half + 1, dtype=np.float64)
    kernels = np.zeros((n_states, 2 * half + 1), dtype=np.float64)
    for s in range(n_states):
        sg = sigmas[s]
        if sg > 0 and np.any(state_mer == s):
            kernels[s] = np.exp(-0.5 * (x / sg) ** 2) / (sg * np.sqrt(2 * np.pi))

    fft_len = _next_pow2(n + 2 * half + 1)
    H = np.fft.rfft(hist, n=fft_len, axis=1)
    K = np.fft.rfft(kernels, n=fft_len, axis=1)
    full = np.fft.irfft(H * K, n=fft_len, axis=1)
    dens = full[:, half:half + n].astype(np.float32)
    dens = np.where(dens > 1.0, np.float32(1.0) / np.maximum(dens, 1e-30), dens)
    state = np.argmax(dens, axis=0).astype(np.int8)
    return state, dens


def smoothed_states(state_mer, sigmas, n_states=3, with_density=False):
    """Density-smoothed state per grid position (device round trip is int8 in,
    int8 out on the scan path; densities transferred only when requested).

    :param state_mer: int array [n] of state labels in [0, n_states).
    :param sigmas: per-state Gaussian sigma.

    :return: (state int8 [n], dens float32 [n_states, n] or None).
    """
    state_mer = np.asarray(state_mer, dtype=np.int8)
    sigmas = np.asarray(sigmas, dtype=np.float64)
    n = len(state_mer)

    if n <= _HOST_FFT_MAX:
        state_np, dens = _host_density_states(state_mer, sigmas, n_states)
        return state_np, (dens if with_density else None)

    n_pad = _next_pow2(max(n, 16))
    padded = np.full(n_pad, -1, dtype=np.int8)
    padded[:n] = state_mer
    state, dens = _density_state_kernel(
        jnp.asarray(padded), jnp.asarray(sigmas, dtype=jnp.float32),
        n_pad, n_states)
    state_np = np.asarray(state)[:n]
    if with_density:
        return state_np, np.asarray(dens)[:, :n]
    return state_np, None


def gaussian_density_states(state_mer, sigmas, n_states=3):
    """Per-state scaled KDE at every grid position (spike clamp NOT applied;
    exact scipy-parity values). float32 array [n_states, n]. Host float64
    FFT: this is the scipy-parity evaluation surface."""
    state_mer = np.asarray(state_mer)
    sigmas = np.asarray(sigmas, dtype=np.float64)
    n = len(state_mer)
    n_states = int(n_states)

    hist = np.zeros((n_states, n), dtype=np.float64)
    for s in range(n_states):
        hist[s, np.nonzero(state_mer == s)[0]] = 1.0

    max_sigma = float(np.max(sigmas)) if len(sigmas) else 0.0
    half = min(int(np.ceil(_TRUNC_SIGMAS * max(max_sigma, 1.0))), max(n, 1))
    x = np.arange(-half, half + 1, dtype=np.float64)
    kernels = np.zeros((n_states, 2 * half + 1), dtype=np.float64)
    for s in range(n_states):
        sg = sigmas[s]
        if sg > 0 and np.any(state_mer == s):
            kernels[s] = np.exp(-0.5 * (x / sg) ** 2) / (sg * np.sqrt(2 * np.pi))

    fft_len = _next_pow2(n + 2 * half + 1)
    H = np.fft.rfft(hist, n=fft_len, axis=1)
    K = np.fft.rfft(kernels, n=fft_len, axis=1)
    full = np.fft.irfft(H * K, n=fft_len, axis=1)
    return full[:, half:half + n].astype(np.float32)


def scott_sigmas(state_mer, bw_factor, n_states=3):
    """Per-state sigma replicating scipy.stats.gaussian_kde with a scalar
    bw_method: sigma_s = bw_factor * std(points_s, ddof=1)."""
    state_mer = np.asarray(state_mer)
    sigmas = np.zeros(n_states, dtype=np.float64)
    for s in range(n_states):
        pts = np.nonzero(state_mer == s)[0]
        if len(pts) > 1:
            sigmas[s] = bw_factor * np.std(pts, ddof=1)
        elif len(pts) == 1:
            # scipy would fail on singular covariance; a point mass with tiny
            # sigma keeps the state representable (low-count states are removed
            # upstream with min_state_count anyway).
            sigmas[s] = bw_factor
    return sigmas
