// Host build of the wavefront DP kernel's cell code (wave_cell.h): the same
// diagonal loop as wave_dp.cu with the block's lanes run one after another.
// The CPU tests compile it with g++ and hold it bit-identical to
// pav_tpu.ops.affine_dp._align_batch_wave, which checks the card's arithmetic
// where there is no card.

#include <cstdint>
#include <vector>

#include "wave_cell.h"

extern "C" void pav_wave_dp_host(const int8_t* q, const int8_t* r,
                                 const int32_t* m, const int32_t* n,
                                 const int32_t* doffs, uint8_t* tb, int B,
                                 int max_m, int max_n, int ww,
                                 const int32_t* scoring) {
  const pav_wave::Scoring sc{scoring[0], scoring[1], scoring[2],
                             scoring[3], scoring[4], scoring[5]};
  const int D = max_m + max_n;
  std::vector<int32_t> h3(3 * ww), ht2(2 * ww), e12(2 * ww), e22(2 * ww),
      f12(2 * ww), f22(2 * ww);
  for (int b = 0; b < B; ++b) {
    const int8_t* qi = q + static_cast<int64_t>(b) * max_m;
    const int8_t* ri = r + static_cast<int64_t>(b) * max_n;
    const int32_t* dof = doffs + static_cast<int64_t>(b) * D;
    uint8_t* tbi = tb + static_cast<int64_t>(b) * D * ww;
    for (int w = 0; w < ww; ++w) {
      pav_wave::init_lane(w, h3.data(), ht2.data(), e12.data(), e22.data(),
                          f12.data(), f22.data(), ww);
    }
    for (int k = 0; k < D; ++k) {
      const pav_wave::Slots s = pav_wave::slots_for(k);
      const int doff = dof[k];
      const int t1 = doff - pav_wave::doff_at(dof, k - 1);
      const int t2 = doff - pav_wave::doff_at(dof, k - 2);
      const pav_wave::Prev p{h3.data() + s.h_prev * ww,
                             ht2.data() + s.prev * ww,
                             h3.data() + s.h_pp * ww,
                             e12.data() + s.prev * ww,
                             e22.data() + s.prev * ww,
                             f12.data() + s.prev * ww,
                             f22.data() + s.prev * ww};
      const pav_wave::Next o{h3.data() + s.h_cur * ww,
                             ht2.data() + s.cur * ww,
                             e12.data() + s.cur * ww,
                             e22.data() + s.cur * ww,
                             f12.data() + s.cur * ww,
                             f22.data() + s.cur * ww};
      uint8_t* row = tbi + static_cast<int64_t>(k) * ww;
      for (int w = 0; w < ww; ++w) {
        row[w] = pav_wave::wave_cell(w, ww, k + 1, doff, t1, t2, m[b], n[b],
                                     max_m, max_n, qi, ri, p, o, sc);
      }
    }
  }
}
