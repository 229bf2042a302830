// Wavefront banded affine DP for NVIDIA Hopper, called from JAX through the
// XLA foreign function interface (target "pav_wave_dp", CUDA platform).
//
// One thread block runs one DP item: the whole anti-diagonal loop stays in
// one launch, the band state of the last diagonals lives in shared memory
// (double-buffered, triple for H), and each diagonal ends with one block
// barrier. Threads stride over the band lanes, so the traceback bytes of a
// diagonal are written coalesced and the +-1 lane shifts are shared-memory
// reads at a neighbouring index. The cell arithmetic is wave_cell.h, shared
// with the host build that the CPU tests run.
//
// Build (see pav_tpu/ops/wave_gpu.py, which runs it at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -I <jax.ffi.include_dir()> -o build/libpavwave.so \
//        native/cuda/wave_dp.cu

#include <cuda_runtime.h>

#include <cstdint>
#include <string>

#include "wave_cell.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

using pav_wave::Next;
using pav_wave::Prev;
using pav_wave::Scoring;

// Shared memory: 3 H diagonals + 2 diagonals each of Htilde, E1, E2, F1, F2.
constexpr int kStateRows = 3 + 2 * 5;

__global__ void wave_kernel(const int8_t* __restrict__ q,
                            const int8_t* __restrict__ r,
                            const int32_t* __restrict__ m,
                            const int32_t* __restrict__ n,
                            const int32_t* __restrict__ doffs,
                            uint8_t* __restrict__ tb, int max_m, int max_n,
                            int ww, Scoring sc) {
  extern __shared__ int32_t smem[];
  int32_t* h3 = smem;
  int32_t* ht2 = h3 + 3 * ww;
  int32_t* e12 = ht2 + 2 * ww;
  int32_t* e22 = e12 + 2 * ww;
  int32_t* f12 = e22 + 2 * ww;
  int32_t* f22 = f12 + 2 * ww;

  const int b = blockIdx.x;
  const int D = max_m + max_n;
  const int8_t* qi = q + static_cast<int64_t>(b) * max_m;
  const int8_t* ri = r + static_cast<int64_t>(b) * max_n;
  const int32_t* dof = doffs + static_cast<int64_t>(b) * D;
  uint8_t* tbi = tb + static_cast<int64_t>(b) * D * ww;
  const int mi = m[b];
  const int ni = n[b];

  for (int w = threadIdx.x; w < ww; w += blockDim.x) {
    pav_wave::init_lane(w, h3, ht2, e12, e22, f12, f22, ww);
  }
  __syncthreads();

  for (int k = 0; k < D; ++k) {
    const pav_wave::Slots s = pav_wave::slots_for(k);
    const int doff = dof[k];
    const int t1 = doff - pav_wave::doff_at(dof, k - 1);
    const int t2 = doff - pav_wave::doff_at(dof, k - 2);
    const Prev p{h3 + s.h_prev * ww, ht2 + s.prev * ww, h3 + s.h_pp * ww,
                 e12 + s.prev * ww,  e22 + s.prev * ww, f12 + s.prev * ww,
                 f22 + s.prev * ww};
    const Next o{h3 + s.h_cur * ww, ht2 + s.cur * ww, e12 + s.cur * ww,
                 e22 + s.cur * ww,  f12 + s.cur * ww, f22 + s.cur * ww};
    uint8_t* row = tbi + static_cast<int64_t>(k) * ww;
    for (int w = threadIdx.x; w < ww; w += blockDim.x) {
      row[w] = pav_wave::wave_cell(w, ww, k + 1, doff, t1, t2, mi, ni, max_m,
                                   max_n, qi, ri, p, o, sc);
    }
    __syncthreads();
  }
}

ffi::Error WaveDpImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> q,
                      ffi::Buffer<ffi::S8> r, ffi::Buffer<ffi::S32> m,
                      ffi::Buffer<ffi::S32> n, ffi::Buffer<ffi::S32> doffs,
                      int32_t match, int32_t mismatch, int32_t o1, int32_t o2,
                      int32_t e1, int32_t e2,
                      ffi::ResultBuffer<ffi::U8> tb) {
  const auto qd = q.dimensions();
  const auto rd = r.dimensions();
  const auto td = tb->dimensions();
  if (qd.size() != 2 || rd.size() != 2 || td.size() != 3) {
    return ffi::Error::InvalidArgument("pav_wave_dp: bad operand ranks");
  }
  const int B = static_cast<int>(qd[0]);
  const int max_m = static_cast<int>(qd[1]);
  const int max_n = static_cast<int>(rd[1]);
  const int ww = static_cast<int>(td[2]);
  if (td[0] != B || td[1] != max_m + max_n || rd[0] != B) {
    return ffi::Error::InvalidArgument("pav_wave_dp: shape mismatch");
  }
  if (B == 0) return ffi::Error::Success();

  // Threads stride over lanes: as many lanes per thread as a 1024-thread
  // block needs, then round the block up to whole warps.
  const int per = (ww + 1023) / 1024;
  const int threads = (((ww + per - 1) / per) + 31) / 32 * 32;
  const size_t smem = sizeof(int32_t) * kStateRows * static_cast<size_t>(ww);
  cudaError_t err = cudaFuncSetAttribute(
      wave_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("pav_wave_dp: ") +
                                cudaGetErrorString(err));
  }
  const Scoring sc{match, mismatch, o1, o2, e1, e2};
  wave_kernel<<<B, threads, smem, stream>>>(
      q.typed_data(), r.typed_data(), m.typed_data(), n.typed_data(),
      doffs.typed_data(), tb->typed_data(), max_m, max_n, ww, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("pav_wave_dp: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(PavWaveDp, WaveDpImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()   // q
                                  .Arg<ffi::Buffer<ffi::S8>>()   // r
                                  .Arg<ffi::Buffer<ffi::S32>>()  // m
                                  .Arg<ffi::Buffer<ffi::S32>>()  // n
                                  .Arg<ffi::Buffer<ffi::S32>>()  // doffs
                                  .Attr<int32_t>("match")
                                  .Attr<int32_t>("mismatch")
                                  .Attr<int32_t>("o1")
                                  .Attr<int32_t>("o2")
                                  .Attr<int32_t>("e1")
                                  .Attr<int32_t>("e2")
                                  .Ret<ffi::Buffer<ffi::U8>>());  // tb
