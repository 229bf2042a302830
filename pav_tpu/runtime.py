"""Runtime/backend helpers."""

import os

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Persistent compile cache used when JAX_COMPILATION_CACHE_DIR is not set: one
# fixed directory in the checkout (gitignored). The path is part of the
# cache's key, so it must not move between runs.
COMPILE_CACHE_DIR = os.path.join(_REPO_ROOT, '.jax_cache')


def retain_heap(warm_bytes=0):
    """Keep freed large allocations in the process heap instead of returning
    them to the OS (glibc mallopt), optionally pre-faulting warm_bytes once.

    On hosts with lazily-restored / ballooned VM memory, first-touch page
    faults can run orders of magnitude below DRAM speed; retaining and
    re-using faulted pages keeps steady-state allocation at memory speed.
    No-op (returns False) on non-glibc platforms.
    """
    import ctypes
    try:
        libc = ctypes.CDLL('libc.so.6', use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD, M_MMAP_MAX = -1, -3, -4
        M_ARENA_MAX = -8
        ok = (libc.mallopt(M_MMAP_THRESHOLD, 2**31 - 1)
              and libc.mallopt(M_MMAP_MAX, 0)
              and libc.mallopt(M_TRIM_THRESHOLD, 2**31 - 1))
        # One malloc arena for ALL threads: per-thread arenas defeat page
        # retention — every worker pool faults a fresh heap segment instead
        # of reusing the warmed pages (measured 10x slowdown of concurrent
        # native planning on lazily-restored VM memory).
        libc.mallopt(M_ARENA_MAX, 1)
    except Exception:
        return False
    if ok and warm_bytes > 0:
        # Fault pages from several threads: a lazily-restored host's page
        # supply scales with parallel faulting.
        import threading
        buf = np.empty(int(warm_bytes), dtype=np.uint8)
        n_th = 8
        step = (len(buf) + n_th - 1) // n_th
        chunk = 256 << 20

        def touch(lo):
            for c0 in range(lo, lo + step, chunk):
                buf[c0:min(c0 + chunk, lo + step):4096] = 1

        threads = [threading.Thread(target=touch, args=(i * step,))
                   for i in range(n_th)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        del buf
    return bool(ok)


def enable_compile_cache():
    """Turn on JAX's persistent compilation cache and return its directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
    set here. Otherwise the cache goes to COMPILE_CACHE_DIR. Executables of
    different backends never collide: the platform is part of JAX's key.
    """
    env = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if env:
        return env
    import jax
    jax.config.update('jax_compilation_cache_dir', COMPILE_CACHE_DIR)
    return COMPILE_CACHE_DIR


# The aligner's hot DP shape classes ((m_pad, n_pad), width): rows and
# columns pad independently (large inter-anchor segments are nearly pure
# indels). Each class runs at ONE fixed batch size (core._shape_batch), so
# each entry below is exactly one compiled program. This is the observed
# working set of human-like genome runs; unlisted combinations still compile
# on demand (persistent cache makes each a once-per-machine cost).
_DP_SHAPES = [
    # Exactly the width classes reachable from the bucketing rules in
    # core._run_segments for each (m_pad, n_pad) class (width is driven by
    # |m-n|, whose range the class constrains).
    ((16, 16), 17), ((16, 32), 33), ((32, 16), 17), ((32, 32), 33),
    ((16, 64), 65), ((64, 16), 17), ((32, 64), 33), ((32, 64), 65),
    ((64, 32), 33), ((64, 64), 33), ((64, 64), 65),
    ((16, 128), 129), ((128, 16), 17), ((32, 128), 129), ((128, 32), 33),
    ((64, 128), 33), ((64, 128), 65), ((64, 128), 129),
    ((128, 64), 33), ((128, 64), 65),
    ((128, 128), 33), ((128, 128), 65), ((128, 128), 129),
    ((16, 256), 257), ((256, 16), 17), ((32, 256), 257), ((256, 32), 33),
    ((64, 256), 257), ((256, 64), 65),
    ((128, 256), 129), ((128, 256), 257), ((256, 128), 65), ((256, 128), 129),
    ((256, 256), 129), ((256, 256), 257),
]

_DP_SHAPES_LARGE = [
    ((16, 512), 513), ((512, 16), 17),
    ((16, 1024), 1025), ((1024, 16), 17),
    ((16, 2048), 2049), ((2048, 16), 17),
    ((32, 512), 513), ((512, 32), 33),
    ((32, 1024), 1025), ((1024, 32), 33),
    ((32, 2048), 2049), ((2048, 32), 33),
    ((64, 512), 513), ((512, 64), 65),
    ((128, 512), 513), ((512, 128), 129),
    ((256, 512), 257), ((256, 512), 513), ((512, 256), 257),
    ((512, 512), 257), ((512, 512), 513),
]

# Accelerator backends bucket on the coarse ladder instead
# (core._accel_bucket): about an order of magnitude fewer compiled programs.
# m <= n always: core transposes segments so rows = the shorter side (scan
# depth) and I/D swap back on the host. Everything <= 2048 columns runs
# full-width through the gather-free kernel; only large classes past the
# full-width cell cap stay banded. Ordered smallest-area-first: the classes
# that carry nearly all segments (min-side <= 16) come first.
_ACCEL_SMALL = (16, 32, 64, 128, 256, 512, 1024, 2048)
_DP_SHAPES_ACCEL = sorted(
    [((m_b, n_b), n_b + 1)
     for m_b in _ACCEL_SMALL for n_b in _ACCEL_SMALL if n_b >= m_b],
    key=lambda s: s[0][0] * s[0][1])
_DP_SHAPES_ACCEL += [((m_b, 8192), 8193) for m_b in (16, 32, 64, 128, 256, 512)]
_DP_SHAPES_ACCEL += [
    # Banded classes (past the full-width cell cap): on the GPU, the CUDA
    # wavefront kernel (ops/wave_gpu.py).
    ((1024, 8192), 2048),
    ((2048, 8192), 2048),
    ((8192, 8192), 512),       # balanced mid-size, diagonal-hugging band
    ((8192, 8192), 2048),      # end extensions (compiles at width 2049)
]


def prime_kernels(sizes=('small', 'medium', 'large'),
                  kde_grids=(1 << 15, 1 << 16, 1 << 17, 1 << 18,
                             1 << 19, 1 << 20, 1 << 21),
                  verbose=False):
    """Pre-compile the engine's canonical kernel shapes so data-dependent work
    never stalls on a compile (one cold genome run touches ~30 DP programs).
    Compiled programs persist in the compile cache (enable_compile_cache)."""
    import sys
    import time

    import jax

    from .align.aligner.core import _shape_batch
    from .ops import affine_dp, kde

    dp = affine_dp.BandedAligner()
    rng = np.random.default_rng(0)
    accel = jax.default_backend() != 'cpu'

    if accel:
        # Accelerators bucket on the coarse ladder (core._accel_bucket) and
        # launch through the device-resident gather path.
        import jax.numpy as jnp
        from .align.aligner.core import _RESIDENT_MIN
        launches = list(_DP_SHAPES_ACCEL)
        resident = jnp.full(_RESIDENT_MIN, 4, dtype=jnp.int8)
    else:
        launches = list(_DP_SHAPES)
        if 'large' in sizes:
            launches += _DP_SHAPES_LARGE

    def prime_one(launch):
        (m_b, n_b), width_b = launch
        t0 = time.time()
        items = [(0, max(m_b // 2, 1), 0, 64, max(n_b // 2, 1), 0)]
        # Batch quantization is pow2-down (core.batch_pad); prime the cap
        # and two common part-full variants. Unprimed fills compile once
        # inline and persist in the cache.
        cap = _shape_batch(m_b, width_b, n_b)
        for b_pad in sorted({cap, max(cap // 2, 8), max(cap // 8, 8)}):
            dp.align_batch_refs_async(
                items, width=width_b, pad_to=(m_b, n_b),
                pad_batch=b_pad, resident=resident)()
        if verbose:
            sys.stderr.write(f'[prime] dp ({m_b},{n_b})w{width_b} '
                             f'{time.time() - t0:.1f}s\n')

    if accel:
        # XLA compiles release the GIL: compile several programs at once.
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=4) as pool:
            list(pool.map(prime_one, launches))
    else:
        handles = []
        for (m_b, n_b), width_b in launches:
            q = rng.integers(0, 4, max(m_b // 2, 1)).astype(np.uint8)
            r = rng.integers(0, 4, max(n_b // 2, 1)).astype(np.uint8)
            handles.append(dp.align_batch_async(
                [(q, r)], width=width_b, pad_to=(m_b, n_b),
                pad_batch=_shape_batch(m_b, width_b)))
        for h in handles:
            h()

    # KDE shapes: the device program is keyed by the pow2 grid length alone
    # (kernels are built on device from the sigmas), so one call per grid
    # size covers every bandwidth. Grids at/below the host-FFT threshold
    # never reach the device and need no priming.
    for n in kde_grids:
        if n <= kde._HOST_FFT_MAX:
            continue
        state = np.zeros(n, dtype=np.int8)
        state[n // 3: 2 * n // 3] = 2
        state[2 * n // 3:] = 1
        t0 = time.time()
        kde.smoothed_states(state, np.full(3, max(2.0, 0.02 * n)))
        if verbose:
            sys.stderr.write(f'[prime] kde n={n} {time.time() - t0:.1f}s\n')
