// One cell of the anti-diagonal (wavefront) banded affine DP.
//
// Shared by the CUDA kernel (wave_dp.cu) and its host build (wave_host.cpp),
// so the CPU tests run exactly the arithmetic the card runs. The recurrence,
// band geometry and traceback byte layout are those of
// pav_tpu.ops.affine_dp._align_batch_wave, which is the plain reference the
// kernel is held bit-identical to.
//
// Band layout: diagonal d = k + 1 (k = 0 .. D-1) holds cells (i, j) with
// i + j = d, lane w at i = doffs[k] + w. State arrays are indexed by lane;
// the previous diagonal's arrays are read at w + t for t in {-1, 0, +1}
// (out of range -> NEG), the new diagonal's arrays are written at w.

#pragma once

#include <cstdint>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace pav_wave {

constexpr int32_t NEG = -(1 << 29);

struct Scoring {
  int32_t match, mismatch, o1, o2, e1, e2;
};

// Previous-diagonal state (read) and new-diagonal state (written).
struct Prev {
  const int32_t *h, *ht, *hpp, *e1, *e2, *f1, *f2;
};
struct Next {
  int32_t *h, *ht, *e1, *e2, *f1, *f2;
};

__host__ __device__ __forceinline__ int32_t lane_at(const int32_t* a, int w,
                                                    int ww) {
  return (w >= 0 && w < ww) ? a[w] : NEG;
}

__host__ __device__ __forceinline__ int32_t imax(int32_t a, int32_t b) {
  return a > b ? a : b;
}

// Computes lane w of diagonal d and returns its traceback byte.
//   doff: doffs[d-1]; t1 = doffs[d-1] - doffs[d-2]; t2 = doffs[d-1] - doffs[d-3]
//   (doffs of diagonals before the first are 0).
//   q, r: the item's padded sequences (max_m and max_n codes, 4 = N/padding).
__host__ __device__ __forceinline__ uint8_t wave_cell(
    int w, int ww, int d, int doff, int t1, int t2, int mi, int ni,
    int max_m, int max_n, const int8_t* q, const int8_t* r, const Prev& p,
    const Next& o, const Scoring& s) {
  const int i = doff + w;
  const int j = d - i;
  const bool valid = (i <= mi) && (j >= 0) && (j <= ni);

  const int32_t h_up = lane_at(p.h, w + t1 - 1, ww);    // H(i-1, j)
  const int32_t e1_up = lane_at(p.e1, w + t1 - 1, ww);
  const int32_t e2_up = lane_at(p.e2, w + t1 - 1, ww);
  const int32_t ht_lf = lane_at(p.ht, w + t1, ww);      // Htilde(i, j-1)
  const int32_t f1_lf = lane_at(p.f1, w + t1, ww);
  const int32_t f2_lf = lane_at(p.f2, w + t1, ww);
  const int32_t h_dg = lane_at(p.hpp, w + t2 - 1, ww);  // H(i-1, j-1)

  // Vertical (query-consuming, 'I') gap states.
  const int32_t e1_open = h_up - (s.o1 + s.e1);
  const int32_t e1_ext = e1_up - s.e1;
  int32_t e1_new = imax(e1_open, e1_ext);
  const bool bit_e1_ext = e1_ext > e1_open;
  const int32_t e2_open = h_up - (s.o2 + s.e2);
  const int32_t e2_ext = e2_up - s.e2;
  int32_t e2_new = imax(e2_open, e2_ext);
  const bool bit_e2_ext = e2_ext > e2_open;
  const int32_t e_best = imax(e1_new, e2_new);
  const bool bit_e_piece2 = e2_new > e1_new;

  // Horizontal (ref-consuming, 'D') gap states; opening wins ties.
  const int32_t f1_open = ht_lf - (s.o1 + s.e1);
  const int32_t f1_ext = f1_lf - s.e1;
  int32_t f1_new = imax(f1_open, f1_ext);
  const bool bit_f1_open = f1_open >= f1_ext;
  const int32_t f2_open = ht_lf - (s.o2 + s.e2);
  const int32_t f2_ext = f2_lf - s.e2;
  int32_t f2_new = imax(f2_open, f2_ext);
  const bool bit_f2_open = f2_open >= f2_ext;
  const int32_t f_best = imax(f1_new, f2_new);
  const bool bit_f_piece2 = f2_new > f1_new;

  // Diagonal move; cells on row 0 or column 0 have none.
  int32_t diag = NEG;
  if (i >= 1 && j >= 1) {
    const int qi = i - 1 < max_m ? i - 1 : max_m - 1;
    const int rj = j - 1 < max_n ? j - 1 : max_n - 1;
    const int8_t qb = q[qi];
    const int8_t rb = r[rj];
    const bool eq = (qb == rb) && (qb < 4) && (rb < 4);
    diag = h_dg + (eq ? s.match : s.mismatch);
  }
  int32_t htilde = imax(diag, e_best);
  const bool bit_ht_e = e_best > diag;
  int32_t h_new = imax(htilde, f_best);
  const bool bit_h_f = f_best > htilde;

  // Row 0 is analytic: H[0][j] = -gapcost(j).
  if (i == 0) {
    const int32_t g1 = s.o1 + j * s.e1;
    const int32_t g2 = s.o2 + j * s.e2;
    h_new = j == 0 ? 0 : -(g1 < g2 ? g1 : g2);
  }
  if (!valid) {
    h_new = htilde = e1_new = e2_new = f1_new = f2_new = NEG;
  }
  o.h[w] = h_new;
  o.ht[w] = htilde;
  o.e1[w] = e1_new;
  o.e2[w] = e2_new;
  o.f1[w] = f1_new;
  o.f2[w] = f2_new;
  return static_cast<uint8_t>(
      (bit_ht_e ? 1 : 0) | (bit_h_f ? 2 : 0) | (bit_e_piece2 ? 4 : 0) |
      (bit_f_piece2 ? 8 : 0) | (bit_e1_ext ? 16 : 0) | (bit_e2_ext ? 32 : 0) |
      (bit_f1_open ? 64 : 0) | (bit_f2_open ? 128 : 0));
}

// Buffer rotation over diagonals: H keeps three diagonals (d, d-1, d-2), the
// other states two. Slot 0 of each array is the diagonal-0 state at k = 0.
struct Slots {
  int h_cur, h_prev, h_pp, cur, prev;
};

__host__ __device__ __forceinline__ Slots slots_for(int k) {
  return Slots{k % 3, (k + 2) % 3, (k + 1) % 3, k & 1, (k + 1) & 1};
}

// Diagonal-0 state: lane 0 is cell (0, 0) with H = Htilde = 0.
__host__ __device__ __forceinline__ void init_lane(int w, int32_t* h3,
                                                   int32_t* ht2, int32_t* e12,
                                                   int32_t* e22, int32_t* f12,
                                                   int32_t* f22, int ww) {
  const Slots s0 = slots_for(0);
  const int32_t z = w == 0 ? 0 : NEG;
  h3[s0.h_prev * ww + w] = z;
  h3[s0.h_pp * ww + w] = NEG;
  ht2[s0.prev * ww + w] = z;
  e12[s0.prev * ww + w] = NEG;
  e22[s0.prev * ww + w] = NEG;
  f12[s0.prev * ww + w] = NEG;
  f22[s0.prev * ww + w] = NEG;
}

// Band offset of diagonal k (0 before the first diagonal).
__host__ __device__ __forceinline__ int doff_at(const int32_t* doffs, int k) {
  return k >= 0 ? doffs[k] : 0;
}

}  // namespace pav_wave
