"""CUDA wavefront DP kernel (native/cuda/wave_dp.cu) as a JAX operation.

The banded DP classes run on the GPU through this kernel: one thread block
per item keeps the band state in shared memory for the whole diagonal loop,
where the XLA formulation (affine_dp._align_batch_wave, the plain reference
it is held bit-identical to) runs one while-loop step per anti-diagonal.

The shared library is built with nvcc into build/ at first use, the way
pav_tpu/native.py builds the host library, and registered for the CUDA
platform only. A failed build or launch raises; nothing falls back.
"""

import ctypes
import os
import shutil
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np

TARGET = 'pav_wave_dp'

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC_DIR = os.path.join(_REPO_ROOT, 'native', 'cuda')
_SRCS = [os.path.join(_SRC_DIR, 'wave_dp.cu'),
         os.path.join(_SRC_DIR, 'wave_cell.h')]
_SO_PATH = os.path.join(_REPO_ROOT, 'build', 'libpavwave.so')

_LOCK = threading.Lock()
_REGISTERED = False


def _nvcc():
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA wave kernel is built '
                           'with the CUDA toolkit at first use')
    return path


def build_command(out_path):
    """nvcc command line that builds the kernel library into out_path."""
    return [_nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
            '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
            '-I', jax.ffi.include_dir(), '-I', _SRC_DIR,
            '-o', out_path, _SRCS[0]]


def _build():
    os.makedirs(os.path.dirname(_SO_PATH), exist_ok=True)
    tmp = f'{_SO_PATH}.{os.getpid()}.tmp'
    proc = subprocess.run(build_command(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed to build {_SRCS[0]}:\n{proc.stderr}')
    os.replace(tmp, _SO_PATH)   # atomic: other processes never load a partial file


def ensure_registered():
    """Build (if stale) and register the FFI target once per process."""
    global _REGISTERED
    with _LOCK:
        if _REGISTERED:
            return
        if (not os.path.exists(_SO_PATH)
                or any(os.path.getmtime(_SO_PATH) < os.path.getmtime(s)
                       for s in _SRCS)):
            _build()
        lib = ctypes.CDLL(_SO_PATH)
        jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.PavWaveDp),
                                    platform='CUDA')
        # Every operand and the result lead with the batch axis, so under a
        # device mesh (config mesh_devices) each device runs its own shard.
        jax.ffi.register_ffi_target_as_batch_partitionable(TARGET)
        _REGISTERED = True


def wave_tb(q, r, m, n, doffs, ww, scoring):
    """Traceback tape of the banded wavefront DP.

    :param q: int8 [B, max_m] padded query codes (4 = N / padding).
    :param r: int8 [B, max_n] padded reference codes.
    :param m, n: int32 [B] true lengths (m <= n per item).
    :param doffs: int32 [B, D] band offset per diagonal (affine_dp._wave_geometry).
    :param ww: band lanes per diagonal (affine_dp._wave_width).
    :param scoring: (match, mismatch, o1, o2, e1, e2).
    :return: uint8 [B, D, ww], the layout of _align_batch_wave's tape.
    """
    ensure_registered()
    B, max_m = q.shape
    D = max_m + r.shape[1]
    match, mismatch, o1, o2, e1, e2 = (np.int32(v) for v in scoring)
    return jax.ffi.ffi_call(
        TARGET, jax.ShapeDtypeStruct((B, D, ww), jnp.uint8))(
            q, r, m, n, doffs, match=match, mismatch=mismatch,
            o1=o1, o2=o2, e1=e1, e2=e2)
