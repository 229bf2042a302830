"""Wavefront banded DP: the CUDA kernel's cell code and wrapper against the
XLA reference (ops/affine_dp._align_batch_wave).

The GPU runs banded classes through the CUDA kernel (native/cuda/wave_dp.cu,
ops/wave_gpu.py). Its cell arithmetic lives in native/cuda/wave_cell.h, which
the host build native/cuda/wave_host.cpp runs here with g++; the wrapper's
geometry, padding and layout are plain JAX. Both must reproduce the XLA
reference's tapes bit for bit, and the wave path's CIGARs must equal the
row-banded and full-width kernels' whenever the path stays in band (tie-break
semantics are shared — see the traceback byte layout in ops/affine_dp.py).
The card itself runs the CUDA kernel in the ``gpu``-marked test.

Reference role: minimap2's banded extension stage (the native DP behind
rules/align.snakefile:206-214); the band-escape -> full-width retry mirrors
its -r bandwidth semantics.
"""

import ctypes
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pav_tpu.ops import affine_dp as A

SCORING = (1, -5, 5, 56, 4, 1)
CUDA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'native', 'cuda')


@pytest.fixture(scope='module')
def host_wave(tmp_path_factory):
    """The wave kernel's cell code built for the host: numpy in, tape out."""
    so = str(tmp_path_factory.mktemp('wave') / 'libwavehost.so')
    subprocess.run(['g++', '-O2', '-std=c++17', '-shared', '-fPIC',
                    '-I', CUDA_DIR, os.path.join(CUDA_DIR, 'wave_host.cpp'),
                    '-o', so], check=True, capture_output=True)
    lib = ctypes.CDLL(so)

    def run(q, r, m, n, doffs, ww, scoring):
        q, r = (np.ascontiguousarray(a, dtype=np.int8) for a in (q, r))
        m, n, doffs = (np.ascontiguousarray(a, dtype=np.int32)
                       for a in (m, n, doffs))
        B, max_m = q.shape
        max_n = r.shape[1]
        tb = np.zeros((B, max_m + max_n, ww), np.uint8)
        sc = np.asarray(scoring, dtype=np.int32)
        lib.pav_wave_dp_host(*(ctypes.c_void_p(a.ctypes.data)
                               for a in (q, r, m, n, doffs, tb)),
                             B, max_m, max_n, ww, ctypes.c_void_p(sc.ctypes.data))
        return tb
    return run


@pytest.fixture
def wave_on_host(host_wave, monkeypatch):
    """Route the wave path's CUDA call to the host build (pure_callback)."""
    def wave_tb(q, r, m, n, doffs, ww, scoring):
        B, max_m = q.shape
        shape = jax.ShapeDtypeStruct((B, max_m + r.shape[1], ww), jnp.uint8)
        return jax.pure_callback(
            lambda *a: host_wave(*a, ww, scoring), shape, q, r, m, n, doffs)
    monkeypatch.setattr(A, '_wave_tb', wave_tb)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _mutate(r, rng):
    q = r.copy()
    for _ in range(int(rng.integers(0, 8))):
        p = int(rng.integers(0, max(len(q) - 1, 1)))
        op = rng.random()
        if op < 0.5:
            q[p] = (q[p] + 1 + rng.integers(0, 3)) % 4
        elif op < 0.75 and len(q) > 6:
            q = np.delete(q, slice(p, min(p + int(rng.integers(1, 6)), len(q))))
        else:
            q = np.insert(q, p, rng.integers(0, 4, int(rng.integers(1, 6))).astype(np.int8))
    return q


def _decode(buf, i):
    err = bool(buf[i, -1])
    pl_ = int(sum(int(buf[i, -5 + k]) << (8 * k) for k in range(4)))
    return err, A.packed_steps_to_cigar(buf[i, :-5], pl_)


def _random_batch(rng, B, max_m, max_n):
    q = rng.integers(0, 5, (B, max_m)).astype(np.int8)
    r = rng.integers(0, 5, (B, max_n)).astype(np.int8)
    m = rng.integers(1, max_m + 1, B).astype(np.int32)
    n = rng.integers(1, max_n + 1, B).astype(np.int32)
    return q, r, np.minimum(m, n), np.maximum(m, n)


def test_wave_matches_row_and_full_kernels(wave_on_host):
    """Wave-path CIGARs == row-banded CIGARs == full-width CIGARs whenever
    neither band flags an escape (random related sequences, m <= n)."""
    rng = np.random.default_rng(5)
    n_cases = 0
    for trial in range(40):
        n_len = int(rng.integers(8, 400))
        r = rng.integers(0, 4, n_len).astype(np.int8)
        q = _mutate(r, rng)
        if len(q) > n_len:
            q, r = r, q
        m_len, n_len = len(q), len(r)
        max_m = ((m_len + 15) // 16) * 16
        max_n = ((n_len + 15) // 16) * 16
        width = min(2 * abs(m_len - n_len) + 33, max_n + 1)
        if width >= max_n + 1:
            continue
        B = 4
        qp = np.full((B, max_m), 4, np.int8)
        qp[0, :m_len] = q
        rp = np.full((B, max_n), 4, np.int8)
        rp[0, :n_len] = r
        qp[1:, 0] = 0
        rp[1:, 0] = 0
        m = np.array([m_len, 1, 1, 1], np.int32)
        n = np.array([n_len, 1, 1, 1], np.int32)
        args = (qp, rp, m, n, max_m, width) + SCORING
        bw = np.asarray(A._align_and_trace(*args, kernel='wave'))
        br = np.asarray(A._align_and_trace(*args, kernel='row'))
        bf = np.asarray(A._align_and_trace(
            qp, rp, m, n, max_m, max_n + 1, *SCORING, kernel='full'))
        ew, cw = _decode(bw, 0)
        er, cr = _decode(br, 0)
        ef, cf = _decode(bf, 0)
        assert not ef
        if not ew and not er:
            assert np.array_equal(cw[0], cr[0]) and np.array_equal(cw[1], cr[1]), \
                f'wave != row at trial {trial} (m={m_len} n={n_len} w={width})'
        if not ew:
            assert np.array_equal(cw[0], cf[0]) and np.array_equal(cw[1], cf[1]), \
                f'wave != full at trial {trial} (m={m_len} n={n_len} w={width})'
            n_cases += 1
    assert n_cases >= 20   # the generator must actually exercise the band


def test_wave_host_build_bit_parity(host_wave):
    """The kernel's cell code (host build) produces the identical tape as the
    XLA reference, including padded batch rows and ragged m/n."""
    rng = np.random.default_rng(7)
    for trial in range(6):
        max_m, max_n, width = 64, 128, 65
        q, r, m, n = _random_batch(rng, 8, max_m, max_n)
        tb_ref, offs = A._align_batch_wave(q, r, m, n, max_m, width, *SCORING)
        tb = host_wave(q, r, m, n, np.asarray(offs), A._wave_width(width), SCORING)
        assert np.array_equal(tb, np.asarray(tb_ref)), trial


@pytest.mark.parametrize('substitute', ['xla_reference', 'host_build'])
@pytest.mark.parametrize('max_m,max_n,width', [(64, 128, 65), (32, 256, 129),
                                               (128, 128, 33)])
def test_wave_wrapper_host_side(substitute, max_m, max_n, width, host_wave,
                                monkeypatch):
    """_wave_align's host side — band geometry, operand dtypes and layout,
    output shape — against _align_batch_wave, with the CUDA call replaced by
    the XLA reference itself or by the host build of the kernel."""
    rng = np.random.default_rng(max_m + max_n + width)
    q, r, m, n = _random_batch(rng, 8, max_m, max_n)
    tb_ref, offs_ref = (np.asarray(a) for a in A._align_batch_wave(
        q, r, m, n, max_m, width, *SCORING))
    seen = {}

    def wave_tb(q_, r_, m_, n_, doffs, ww, scoring):
        seen.update(dtypes=(q_.dtype, r_.dtype, m_.dtype, n_.dtype, doffs.dtype),
                    ww=ww, scoring=scoring)
        if substitute == 'xla_reference':
            return jnp.asarray(tb_ref)
        shape = jax.ShapeDtypeStruct(tb_ref.shape, jnp.uint8)
        return jax.pure_callback(
            lambda *a: host_wave(*a, ww, scoring), shape, q_, r_, m_, n_, doffs)

    monkeypatch.setattr(A, '_wave_tb', wave_tb)
    tb, offs = A._wave_align(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m),
                             jnp.asarray(n), max_m, width, *SCORING)
    assert seen['dtypes'] == (jnp.int8, jnp.int8, jnp.int32, jnp.int32, jnp.int32)
    assert seen['ww'] == A._wave_width(width) and seen['scoring'] == SCORING
    assert np.array_equal(np.asarray(offs), offs_ref)
    assert np.asarray(tb).shape == (8, max_m + max_n, A._wave_width(width))
    assert np.array_equal(np.asarray(tb), tb_ref)


@pytest.mark.gpu
def test_cuda_wave_kernel_bit_parity(gpu_device):
    """On the card: the CUDA kernel's tape equals the XLA reference's."""
    rng = np.random.default_rng(11)
    for max_m, max_n, width in ((64, 128, 65), (256, 1024, 513)):
        args = [jax.device_put(a, gpu_device)
                for a in _random_batch(rng, 16, max_m, max_n)]
        tb, offs = A._wave_align(*args, max_m, width, *SCORING)
        tb_ref, offs_ref = A._align_batch_wave(*args, max_m, width, *SCORING)
        assert np.array_equal(np.asarray(offs), np.asarray(offs_ref))
        assert np.array_equal(np.asarray(tb), np.asarray(tb_ref))
