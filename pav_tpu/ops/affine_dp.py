"""Batched banded global alignment with two-piece affine gaps (device kernel).

The base-level workhorse of the native aligner: all inter-anchor gap segments
from every chain are bucketed by size, padded to static shapes, and aligned in
one vmapped lax.scan per bucket — rows advance sequentially, the banded window
slides along a per-problem center line, and the horizontal (F) dependency is
resolved with an exact prefix-max scan, so each row is fully data-parallel
across the band and the batch.

Scoring follows the reference's minimap2 parameterization (match 1, mismatch
-5, gaps min(5+4g, 56+g): rules/align.snakefile:188). Traceback decisions are
packed one byte per cell and walked on the host.

Traceback byte layout (bit set ⇒):
  0: Htilde chose E (diagonal otherwise)
  1: H chose F (overrides bit 0)
  2: E piece-2 strictly better than piece-1
  3: F piece-2 strictly better than piece-1
  4: E1 extended (came from E1 above, not opened from H above)
  5: E2 extended
  6: F1 opened at the immediate left cell (gap length 1 from there)
  7: F2 opened at the immediate left cell
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

NEG = jnp.int32(-(1 << 29))

# Device-interaction counters (reset with stats_reset; read via STATS).
# Maintained unconditionally — a few dict adds per *launch* (not per item)
# is noise next to the launch itself — and surfaced by bench.py.
STATS = {'launches': 0, 'items': 0, 'h2d_bytes': 0, 'd2h_bytes': 0,
         'resolve_s': 0.0, 'dispatch_s': 0.0, 'prefetch_s': 0.0,
         # Mesh accounting (multi-chip scaling evidence): number of
         # device_puts that were sharded over a mesh, mesh size, the
         # per-device batch rows of the most recent sharded put, and the
         # ACCUMULATED padded DP cells assigned to each device across every
         # sharded launch — the measured work-balance record (max/min of
         # shard_cells is the empirical balance ratio).
         'sharded_puts': 0, 'mesh_devices': 0, 'shard_rows': (),
         'shard_cells': (),
         # (max_m, max_n, width, B_pad) ->
         #   [launches, resolve_s, items, cells_pad, cells_real]
         # cells_pad  = B_pad*max_m*width per launch (what the program scans)
         # cells_real = sum_i m_i*min(n_i+1, width)  (what the problems need)
         'classes': {}}


def stats_reset():
    for k in STATS:
        STATS[k] = ({} if k == 'classes'
                    else () if k in ('shard_rows', 'shard_cells')
                    else (0.0 if k.endswith('_s') else 0))

DEFAULT_SCORING = {
    'match': 1, 'mismatch': -5,
    'gap_open': (5, 56), 'gap_ext': (4, 1),
}


def _next_pow2(x):
    v = 1
    while v < x:
        v <<= 1
    return v


def gap_cost(g, scoring=DEFAULT_SCORING):
    """Two-piece affine gap cost (positive number)."""
    o1, o2 = scoring['gap_open']
    e1, e2 = scoring['gap_ext']
    return np.minimum(o1 + g * e1, o2 + g * e2)


@functools.partial(jax.jit, static_argnames=('max_m', 'width', 'match', 'mismatch',
                                             'o1', 'o2', 'e1', 'e2'))
def _align_batch_full(q, r, m, n, max_m, width, match, mismatch, o1, o2, e1, e2):
    """Full-width specialization (width == max_n + 1): no band window, so no
    dynamic shifts, no per-step gathers, and no row-0 special case inside the
    scan — the substitution matrix is one broadcast compare consumed as a
    scan input, and the step body is purely fused elementwise work + an
    O(log width) prefix max. Accumulators are float32 (exact: |score| stays
    far below 2^24).

    Returns (score [B] f32, tb [B, max_m, width] uint8, offsets [B, max_m]
    int32 zeros) — same contract as _align_batch.
    """
    B, max_n = r.shape
    w_idx = jnp.arange(width, dtype=jnp.int32)
    NEGF = jnp.float32(-1e30)

    def one(qi, ri, mi, ni):
        j_valid = w_idx <= ni                                   # [w]
        # Row 0: H[0][j] = -gapcost(j).
        gap_j = -jnp.minimum(o1 + w_idx * e1, o2 + w_idx * e2).astype(jnp.float32)
        h0 = jnp.where(w_idx == 0, 0.0, gap_j)
        h0 = jnp.where(j_valid, h0, NEGF)

        # Substitution rows for i = 1..max_m in one broadcast compare
        # (column j consumes r[j-1]; column 0 is never a diagonal target).
        ri_pad = jnp.concatenate([jnp.full((1,), 4, ri.dtype), ri])  # r[j-1] at j
        eq = (qi[:max_m, None] == ri_pad[None, :width]) & \
             (qi[:max_m, None] < 4) & (ri_pad[None, :width] < 4)
        subst = jnp.where(eq, jnp.float32(match), jnp.float32(mismatch))
        diag_ok = (w_idx >= 1)[None, :] & j_valid[None, :]
        subst = jnp.where(diag_ok, subst, NEGF)                 # [max_m, w]
        i_arr = jnp.arange(1, max_m + 1, dtype=jnp.int32)
        row_valid = (j_valid[None, :] & (i_arr[:, None] <= mi))  # [max_m, w]

        e1f, e2f = jnp.float32(e1), jnp.float32(e2)
        o1f, o2f = jnp.float32(o1), jnp.float32(o2)
        aug1 = w_idx.astype(jnp.float32) * e1f
        aug2 = w_idx.astype(jnp.float32) * e2f

        def step(carry, x):
            h_prev, e1_prev, e2_prev = carry
            subst_row, valid = x

            # Vertical (query-consuming, 'I') gap states.
            e1_open = h_prev - (o1f + e1f)
            e1_ext = e1_prev - e1f
            e1_new = jnp.maximum(e1_open, e1_ext)
            bit_e1_ext = e1_ext > e1_open

            e2_open = h_prev - (o2f + e2f)
            e2_ext = e2_prev - e2f
            e2_new = jnp.maximum(e2_open, e2_ext)
            bit_e2_ext = e2_ext > e2_open

            e_best = jnp.maximum(e1_new, e2_new)
            bit_e_piece2 = e2_new > e1_new

            # Diagonal: H[i-1][j-1] is a static shift-right of the previous row.
            h_diag = jnp.concatenate([jnp.full((1,), NEGF), h_prev[:-1]])
            diag = h_diag + subst_row

            htilde = jnp.maximum(diag, e_best)
            bit_ht_e = e_best > diag

            # Horizontal (ref-consuming, 'D') gaps via prefix-max scans.
            def f_scan(aug, ext, open_):
                a = htilde + aug
                runmax = jax.lax.associative_scan(jnp.maximum, a)
                prev_max = jnp.concatenate([jnp.full((1,), NEGF), runmax[:-1]])
                f = prev_max - open_ - aug
                opened_at_prev = jnp.concatenate(
                    [jnp.full((1,), True), prev_max[1:] == a[:-1]])
                return f, opened_at_prev

            f1, bit_f1_open = f_scan(aug1, e1f, o1f)
            f2, bit_f2_open = f_scan(aug2, e2f, o2f)
            f_best = jnp.maximum(f1, f2)
            bit_f_piece2 = f2 > f1

            h_new = jnp.maximum(htilde, f_best)
            bit_h_f = f_best > htilde

            h_new = jnp.where(valid, h_new, NEGF)
            e1_new = jnp.where(valid, e1_new, NEGF)
            e2_new = jnp.where(valid, e2_new, NEGF)

            tb = (bit_ht_e.astype(jnp.uint8)
                  | (bit_h_f.astype(jnp.uint8) << 1)
                  | (bit_e_piece2.astype(jnp.uint8) << 2)
                  | (bit_f_piece2.astype(jnp.uint8) << 3)
                  | (bit_e1_ext.astype(jnp.uint8) << 4)
                  | (bit_e2_ext.astype(jnp.uint8) << 5)
                  | (bit_f1_open.astype(jnp.uint8) << 6)
                  | (bit_f2_open.astype(jnp.uint8) << 7))

            return (h_new, e1_new, e2_new), tb

        e_init = jnp.full(width, NEGF)
        (h_last, _, _), tb = jax.lax.scan(step, (h0, e_init, e_init),
                                          (subst, row_valid))
        return h_last, tb

    h_last, tb = jax.vmap(one)(q, r, m, n)
    offs = jnp.zeros((B, max_m), dtype=jnp.int32)
    return h_last, tb, offs


@functools.partial(jax.jit, static_argnames=('max_m', 'width', 'match', 'mismatch',
                                             'o1', 'o2', 'e1', 'e2'))
def _align_batch(q, r, m, n, max_m, width, match, mismatch, o1, o2, e1, e2):
    """q: [B, max_m] int8 (padded), r: [B, max_n] int8, m/n: [B] int32 lengths.

    Returns (score [B] int32, tb [B, max_m, width] uint8, offsets [B, max_m] int32).
    Row i of tb corresponds to DP row i+1 (query base i).
    """
    w_idx = jnp.arange(width, dtype=jnp.int32)

    def one(qi, ri, mi, ni):
        max_off = jnp.maximum(ni + 1 - width, 0)

        # Per-row band placement and substitution rows are all precomputed
        # OUTSIDE the scan: a per-step dynamic gather from ri serializes the
        # row loop on address math. One batched gather up front plus pure
        # elementwise scan steps avoids that.
        i_arr = jnp.arange(1, max_m + 1, dtype=jnp.int32)
        center = jnp.where(mi > 0, (i_arr * ni) // jnp.maximum(mi, 1), 0)
        offs_all = jnp.clip(center - width // 2, 0, max_off)      # [max_m]
        s_all = offs_all - jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), offs_all[:-1]])          # [max_m]
        j_glob = offs_all[:, None] + w_idx[None, :]               # [max_m, w]
        valid_all = (j_glob <= ni) & (i_arr[:, None] <= mi)       # [max_m, w]

        # Band-aligned reference bases: ONE gather per item. int8 rows with a
        # -128 sentinel (column 0 is never a diagonal target): the scan
        # streams max_m x width of these per item, and int32 quadrupled the
        # transient footprint (~35 MB/item on the big banded classes).
        rb = ri[jnp.clip(j_glob - 1, 0, ri.shape[0] - 1)]         # [max_m, w]
        qb = qi[:max_m, None]
        subst_all = jnp.where((qb == rb) & (qb < 4) & (rb < 4),
                              jnp.int8(match), jnp.int8(mismatch))
        subst_all = jnp.where(j_glob >= 1, subst_all, jnp.int8(-128))

        # Row 0 is analytic (H[0][j] = -gapcost(j)), so leading deletions are
        # scored exactly even when row 1's window starts past column 0. Only
        # row 1 consumes it; precompute its window once.
        def row0_at(j):
            v = jnp.where(j == 0, 0,
                          -jnp.minimum(o1 + j * e1, o2 + j * e2)).astype(jnp.int32)
            return jnp.where((j >= 0) & (j <= ni), v, NEG)

        row1_h0 = row0_at(j_glob[0])                              # H[0][j], row 1 window
        row1_d0 = row0_at(j_glob[0] - 1)                          # H[0][j-1]

        # Row 0: H[0][j] = -gapcost(j), E = -inf, at offset row_offset(0)=0.
        j0 = w_idx
        h0 = jnp.where(
            j0 == 0, 0,
            -jnp.minimum(o1 + j0 * e1, o2 + j0 * e2)).astype(jnp.int32)
        h0 = jnp.where(j0 <= ni, h0, NEG)
        e10 = jnp.full(width, NEG, dtype=jnp.int32)
        e20 = jnp.full(width, NEG, dtype=jnp.int32)

        def step(carry, x):
            h_prev, e1_prev, e2_prev = carry
            subst, valid, s, first = x

            # Align previous-row windows to this row's offset.
            def shift(a, k):
                return jnp.where(
                    (w_idx + k >= 0) & (w_idx + k < width),
                    jnp.roll(a, -k), NEG)

            h_up = jnp.where(first, row1_h0, shift(h_prev, s))        # H[i-1][j]
            e1_up = jnp.where(first, NEG, shift(e1_prev, s))
            e2_up = jnp.where(first, NEG, shift(e2_prev, s))
            h_diag = jnp.where(first, row1_d0, shift(h_prev, s - 1))  # H[i-1][j-1]

            # Vertical (query-consuming, 'I') gap states.
            e1_open = h_up - (o1 + e1)
            e1_ext = e1_up - e1
            e1_new = jnp.maximum(e1_open, e1_ext)
            bit_e1_ext = e1_ext > e1_open

            e2_open = h_up - (o2 + e2)
            e2_ext = e2_up - e2
            e2_new = jnp.maximum(e2_open, e2_ext)
            bit_e2_ext = e2_ext > e2_open

            e_best = jnp.maximum(e1_new, e2_new)
            bit_e_piece2 = e2_new > e1_new

            # Diagonal (subst carries the j>=1 sentinel for column 0).
            diag = jnp.where(subst == jnp.int8(-128), NEG,
                             h_diag + subst.astype(jnp.int32))
            # Column 0 base case: H[i][0] = -gapcost(i) arrives via E from H[i-1][0].

            htilde = jnp.maximum(diag, e_best)
            bit_ht_e = e_best > diag

            # Horizontal (ref-consuming, 'D') gaps via prefix-max scans over the row.
            def f_scan(ext, open_):
                aug = htilde + w_idx * ext
                runmax = jax.lax.associative_scan(jnp.maximum, aug)
                prev_max = jnp.concatenate([jnp.full((1,), NEG), runmax[:-1]])
                f = prev_max - open_ - w_idx * ext
                opened_at_prev = jnp.concatenate(
                    [jnp.full((1,), True), prev_max[1:] == aug[:-1]])
                return f, opened_at_prev

            f1, bit_f1_open = f_scan(e1, o1)
            f2, bit_f2_open = f_scan(e2, o2)
            f_best = jnp.maximum(f1, f2)
            bit_f_piece2 = f2 > f1

            h_new = jnp.maximum(htilde, f_best)
            bit_h_f = f_best > htilde

            h_new = jnp.where(valid, h_new, NEG)
            e1_new = jnp.where(valid, e1_new, NEG)
            e2_new = jnp.where(valid, e2_new, NEG)

            tb = (bit_ht_e.astype(jnp.uint8)
                  | (bit_h_f.astype(jnp.uint8) << 1)
                  | (bit_e_piece2.astype(jnp.uint8) << 2)
                  | (bit_f_piece2.astype(jnp.uint8) << 3)
                  | (bit_e1_ext.astype(jnp.uint8) << 4)
                  | (bit_e2_ext.astype(jnp.uint8) << 5)
                  | (bit_f1_open.astype(jnp.uint8) << 6)
                  | (bit_f2_open.astype(jnp.uint8) << 7))

            return (h_new, e1_new, e2_new), tb

        (h_last, _, _), tb = jax.lax.scan(
            step, (h0, e10, e20),
            (subst_all, valid_all, s_all, i_arr == 1))

        # Score of the real last row (mi may be < max_m): gather H[mi][ni].
        # Recompute by tracking row mi's H: use where-trick inside scan instead.
        return h_last, tb, offs_all

    h_last, tb, offs = jax.vmap(one)(q, r, m, n)
    return h_last, tb, offs


def _wave_width(width):
    """i-space band width for the wavefront kernel. Launches are transposed
    so m <= n per item, hence the i-deviation of any cell from the wave
    center line is j-deviation * m/(m+n) <= half the row-band deviation —
    width/2 lanes cover the same paths the row band does (+ rounding slop).
    Rounded up to a multiple of 128 lanes: the CUDA and XLA wave kernels
    share this one band geometry."""
    return ((width // 2 + 8 + 127) // 128) * 128


def _wave_geometry(mi, ni, max_m, max_n, D, Ww):
    """Per-item wavefront band placement: (doffs, s1, s2), each [D] int32.

    Window shifts s1 are in {0, 1} by construction: every term of the offset
    formula is nondecreasing with unit increments (m <= n keeps the center
    slope <= 1/2)."""
    d_arr = jnp.arange(1, D + 1, dtype=jnp.int32)
    tot = jnp.maximum(mi + ni, 1)
    c = (d_arr * mi) // tot
    lo = jnp.maximum(d_arr - ni, 0)
    hi = jnp.maximum(mi + 1 - Ww, 0)
    doffs = jnp.maximum(lo, jnp.minimum(c - Ww // 2, hi))
    doffs_prev = jnp.concatenate([jnp.zeros((1,), jnp.int32), doffs[:-1]])
    doffs_pp = jnp.concatenate([jnp.zeros((2,), jnp.int32), doffs[:-2]])
    s1 = doffs - doffs_prev          # {0, 1}
    s2 = doffs - doffs_pp            # {0, 1, 2}
    return doffs, s1, s2


def _wave_precompute(qi, ri, mi, ni, max_m, max_n, width, match, mismatch):
    """Per-item wavefront geometry + band-aligned substitution rows.

    Returns (subst [D, Ww] int8 with -128 = diag-invalid sentinel,
    doffs/s1/s2 [D] int32).
    """
    D = max_m + max_n
    Ww = _wave_width(width)
    w_idx = jnp.arange(Ww, dtype=jnp.int32)
    SENT = jnp.int8(-128)

    d_arr = jnp.arange(1, D + 1, dtype=jnp.int32)
    doffs, s1, s2 = _wave_geometry(mi, ni, max_m, max_n, D, Ww)

    i_g = doffs[:, None] + w_idx[None, :]
    j_g = d_arr[:, None] - i_g
    qb = qi[jnp.clip(i_g - 1, 0, max_m - 1)]
    rb = ri[jnp.clip(j_g - 1, 0, max_n - 1)]
    subst = jnp.where((qb == rb) & (qb < 4) & (rb < 4),
                      jnp.int8(match), jnp.int8(mismatch))
    subst = jnp.where((i_g >= 1) & (j_g >= 1), subst, SENT)
    return subst, doffs, s1, s2


@functools.partial(jax.jit, static_argnames=('max_m', 'width', 'match', 'mismatch',
                                             'o1', 'o2', 'e1', 'e2'))
def _align_batch_wave(q, r, m, n, max_m, width, match, mismatch, o1, o2, e1, e2):
    """Anti-diagonal (wavefront) banded DP in plain XLA: the reference the
    GPU's CUDA wave kernel (ops/wave_gpu.py, native/cuda/) is held
    bit-identical to.

    Returns (tb [B, D, Ww] uint8, doffs [B, D] int32) with D = max_m + max_n:
    diagonal d = k+1 is stored at row k, holding cells (i, j) with i + j = d,
    i = doffs[k] + lane. Traceback byte layout is identical to _align_batch.

    Why wavefront: the row-banded scan needs per-step dynamic window shifts
    (up to ceil(n/m) lanes) and a prefix-max F-scan. On anti-diagonals every
    dependency sits on the previous two diagonals at relative offset
    {-1, 0, +1}: window shifts become selects between two STATIC shifts (the
    window advances 0 or 1 lanes per diagonal because m <= n), and the
    horizontal gap state F turns into an ordinary cross-step recurrence from
    the carried Htilde — no scan.
    The step body is purely elementwise; all gathers (band-aligned bases)
    happen once, outside the scan.
    """
    B, max_n = r.shape
    D = max_m + max_n
    Ww = _wave_width(width)
    w_idx = jnp.arange(Ww, dtype=jnp.int32)
    SENT = jnp.int8(-128)   # diag-invalid sentinel in the int8 subst rows

    def gapc(k):
        return jnp.minimum(o1 + k * e1, o2 + k * e2).astype(jnp.int32)

    def one(qi, ri, mi, ni):
        d_arr = jnp.arange(1, D + 1, dtype=jnp.int32)
        subst, doffs, s1, s2 = _wave_precompute(
            qi, ri, mi, ni, max_m, max_n, width, match, mismatch)

        NEGv = jnp.full((1,), NEG, dtype=jnp.int32)

        def shift_sel(a, t):
            """out[w] = a[w + t] for scalar t in {-1, 0, 1}; OOB -> NEG."""
            left = jnp.concatenate([a[1:], NEGv])
            right = jnp.concatenate([NEGv, a[:-1]])
            return jnp.where(t == 1, left, jnp.where(t == 0, a, right))

        def step(carry, x):
            h_p, ht_p, h_pp, e1_p, e2_p, f1_p, f2_p = carry
            subst8, d, doff, t1, t2 = x
            i_vec = doff + w_idx
            j_vec = d - i_vec
            valid = (i_vec <= mi) & (j_vec >= 0) & (j_vec <= ni)

            h_up = shift_sel(h_p, t1 - 1)     # H(i-1, j)   on d-1
            e1_up = shift_sel(e1_p, t1 - 1)
            e2_up = shift_sel(e2_p, t1 - 1)
            ht_lf = shift_sel(ht_p, t1)       # Htilde(i, j-1) on d-1
            f1_lf = shift_sel(f1_p, t1)
            f2_lf = shift_sel(f2_p, t1)
            h_dg = shift_sel(h_pp, t2 - 1)    # H(i-1, j-1) on d-2

            # Vertical (query-consuming, 'I') gap states.
            e1_open = h_up - (o1 + e1)
            e1_ext = e1_up - e1
            e1_new = jnp.maximum(e1_open, e1_ext)
            bit_e1_ext = e1_ext > e1_open

            e2_open = h_up - (o2 + e2)
            e2_ext = e2_up - e2
            e2_new = jnp.maximum(e2_open, e2_ext)
            bit_e2_ext = e2_ext > e2_open

            e_best = jnp.maximum(e1_new, e2_new)
            bit_e_piece2 = e2_new > e1_new

            # Horizontal (ref-consuming, 'D') gaps: direct recurrence from
            # Htilde — open wins ties, matching the prefix-max scan's
            # opened_at_prev semantics in _align_batch/_align_batch_full.
            f1_open_v = ht_lf - (o1 + e1)
            f1_ext_v = f1_lf - e1
            f1_new = jnp.maximum(f1_open_v, f1_ext_v)
            bit_f1_open = f1_open_v >= f1_ext_v

            f2_open_v = ht_lf - (o2 + e2)
            f2_ext_v = f2_lf - e2
            f2_new = jnp.maximum(f2_open_v, f2_ext_v)
            bit_f2_open = f2_open_v >= f2_ext_v

            f_best = jnp.maximum(f1_new, f2_new)
            bit_f_piece2 = f2_new > f1_new

            diag = jnp.where(subst8 == SENT, NEG,
                             h_dg + subst8.astype(jnp.int32))
            htilde = jnp.maximum(diag, e_best)
            bit_ht_e = e_best > diag

            h_new = jnp.maximum(htilde, f_best)
            bit_h_f = f_best > htilde

            # Row 0 is analytic (H[0][j] = -gapcost(j)) exactly like the row
            # kernel's init row; column 0 flows through E naturally.
            h_new = jnp.where(i_vec == 0,
                              jnp.where(j_vec == 0, 0, -gapc(j_vec)), h_new)

            h_new = jnp.where(valid, h_new, NEG)
            htilde = jnp.where(valid, htilde, NEG)
            e1_new = jnp.where(valid, e1_new, NEG)
            e2_new = jnp.where(valid, e2_new, NEG)
            f1_new = jnp.where(valid, f1_new, NEG)
            f2_new = jnp.where(valid, f2_new, NEG)

            tb = (bit_ht_e.astype(jnp.uint8)
                  | (bit_h_f.astype(jnp.uint8) << 1)
                  | (bit_e_piece2.astype(jnp.uint8) << 2)
                  | (bit_f_piece2.astype(jnp.uint8) << 3)
                  | (bit_e1_ext.astype(jnp.uint8) << 4)
                  | (bit_e2_ext.astype(jnp.uint8) << 5)
                  | (bit_f1_open.astype(jnp.uint8) << 6)
                  | (bit_f2_open.astype(jnp.uint8) << 7))

            return (h_new, htilde, h_p, e1_new, e2_new, f1_new, f2_new), tb

        # Diagonal 0 window (anchored at i=0): lane 0 = cell (0,0), H = 0.
        h0 = jnp.where(w_idx == 0, 0, NEG)
        negs = jnp.full((Ww,), NEG, dtype=jnp.int32)
        (_, _, _, _, _, _, _), tb = jax.lax.scan(
            step, (h0, h0, negs, negs, negs, negs, negs),
            (subst, d_arr, doffs, s1, s2))
        return tb, doffs

    tb, doffs = jax.vmap(one)(q, r, m, n)
    return tb, doffs


# Step codes emitted by the device traceback (host maps to CIGAR ops).
STEP_EQ, STEP_X, STEP_I, STEP_D, STEP_DONE = 0, 1, 2, 3, 255


def _pack_codes(arr):
    """Host-side 2-bit pack + ambiguity bitmap: [B, L] uint8 codes ->
    ([B, L/4] uint8, [B, L/8] uint8). L must divide 8."""
    vals = np.where(arr > 3, 0, arr).astype(np.uint8)
    quads = vals.reshape(arr.shape[0], -1, 4)
    packed = (quads[:, :, 0] | (quads[:, :, 1] << 2) | (quads[:, :, 2] << 4)
              | (quads[:, :, 3] << 6)).astype(np.uint8)
    bits = (arr > 3).astype(np.uint8).reshape(arr.shape[0], -1, 8)
    ambig = np.zeros(bits.shape[:2], dtype=np.uint8)
    for b in range(8):
        ambig |= bits[:, :, b] << b
    return packed, ambig


def _unpack_codes(packed, ambig, L):
    """Device-side inverse of _pack_codes -> int8 [B, L] with 4 = ambiguous."""
    shifts = jnp.arange(4, dtype=jnp.uint8) * 2
    vals = ((packed[:, :, None] >> shifts[None, None, :]) & 3).reshape(
        packed.shape[0], -1)[:, :L]
    bshifts = jnp.arange(8, dtype=jnp.uint8)
    amb = ((ambig[:, :, None] >> bshifts[None, None, :]) & 1).reshape(
        ambig.shape[0], -1)[:, :L]
    return jnp.where(amb == 1, jnp.int8(4), vals.astype(jnp.int8))


@functools.partial(jax.jit, static_argnames=('max_m', 'max_n', 'width', 'match',
                                             'mismatch', 'o1', 'o2', 'e1', 'e2',
                                             'kernel'))
def _align_and_trace_packed(qp, qa, rp, ra, m, n, max_m, max_n, width,
                            match, mismatch, o1, o2, e1, e2, kernel):
    """Packed-input wrapper: unpack 2-bit sequence + ambiguity bitmaps on
    device, then run DP + traceback."""
    q = _unpack_codes(qp, qa, max_m)
    r = _unpack_codes(rp, ra, max_n)
    return _align_and_trace_impl(q, r, m, n, max_m, width,
                                 match, mismatch, o1, o2, e1, e2, kernel)


@functools.partial(jax.jit, static_argnames=('max_m', 'width', 'match', 'mismatch',
                                             'o1', 'o2', 'e1', 'e2', 'kernel'))
def _align_and_trace(q, r, m, n, max_m, width, match, mismatch, o1, o2, e1, e2,
                     kernel):
    return _align_and_trace_impl(q, r, m, n, max_m, width,
                                 match, mismatch, o1, o2, e1, e2, kernel)


@functools.partial(jax.jit, static_argnames=('max_m', 'max_n', 'width', 'match',
                                             'mismatch', 'o1', 'o2', 'e1', 'e2',
                                             'kernel'))
def _align_and_trace_resident(resident, desc,
                              max_m, max_n, width,
                              match, mismatch, o1, o2, e1, e2,
                              kernel):
    """Device-resident variant: sequences are gathered on-device from one
    resident int8 buffer using (offset, len, flags) descriptors — the launch
    h2d payload is ONE [B, 6] int32 array (columns: qoff, qlen, qflags, roff,
    rlen, rflags) instead of padded sequence bytes. flags bit0 = read the
    window reversed; bit1 = complement bases (3 - code for ACGT). Together
    they express reverse-complement windows, so only the forward orientation
    of each contig is ever uploaded."""
    L = resident.shape[0]

    def gather(off, rev, ln, max_len):
        idx = jnp.arange(max_len, dtype=jnp.int32)
        pos = jnp.where((rev & 1) == 1, off + ln - 1 - idx, off + idx)
        v = resident[jnp.clip(pos, 0, L - 1)]
        v = jnp.where(((rev & 2) == 2) & (v < 4), jnp.int8(3) - v, v)
        return jnp.where(idx < ln, v, jnp.int8(4))

    m = desc[:, 1]
    n = desc[:, 4]
    q = jax.vmap(lambda d: gather(d[0], d[2], d[1], max_m))(desc)
    r = jax.vmap(lambda d: gather(d[3], d[5], d[4], max_n))(desc)
    return _align_and_trace_impl(q, r, m, n, max_m, width,
                                 match, mismatch, o1, o2, e1, e2, kernel)


@functools.partial(jax.jit, static_argnames=('rows',))
def _slice_rows(arr, rows):
    """Static leading-dim slice: drops batch padding before the d2h transfer
    (padding rows dominate transfer bytes when a fixed-batch launch is
    part-full; one compiled program per (shape, pow2-rows) pair)."""
    return arr[:rows]


def dp_kernel(platform, max_n, width):
    """The one DP kernel for a shape class on a platform.

    'full': full-width classes (width == max_n + 1), _align_batch_full on
        every platform.
    'wave': banded classes on the GPU, the CUDA wavefront kernel
        (ops/wave_gpu.py; plain reference _align_batch_wave).
    'row': banded classes elsewhere, the row-banded _align_batch.
    """
    if width == max_n + 1:
        return 'full'
    return 'wave' if platform == 'gpu' else 'row'


def _wave_align(q, r, m, n, max_m, width, match, mismatch, o1, o2, e1, e2):
    """Banded wavefront DP through the CUDA kernel: band geometry here, the
    diagonal loop on the card. Returns (tb [B, D, Ww], doffs [B, D]) exactly
    as _align_batch_wave does."""
    B, max_n = r.shape
    D = max_m + max_n
    Ww = _wave_width(width)
    doffs = jax.vmap(
        lambda mi, ni: _wave_geometry(mi, ni, max_m, max_n, D, Ww)[0])(m, n)
    tb = _wave_tb(q.astype(jnp.int8), r.astype(jnp.int8),
                  m.astype(jnp.int32), n.astype(jnp.int32), doffs, Ww,
                  (match, mismatch, o1, o2, e1, e2))
    return tb, doffs


def _wave_tb(q, r, m, n, doffs, ww, scoring):
    from . import wave_gpu
    return wave_gpu.wave_tb(q, r, m, n, doffs, ww, scoring)


def _align_and_trace_impl(q, r, m, n, max_m, width, match, mismatch, o1, o2, e1, e2,
                          kernel):
    """Banded DP + device-side traceback. Only the compact step tape leaves the
    device: [B, L] uint8 (L = 2*max_m + max_n bound), reversed order, plus a
    band-exit error flag per element. The [B, max_m, width] traceback tensor
    never leaves the device.

    :param kernel: dp_kernel(platform, max_n, width) for this class.
    """
    wave = kernel == 'wave'
    if kernel == 'full':
        # Full-width classes: the gather-free specialized scan.
        _, tb, offs = _align_batch_full(q, r, m, n, max_m, width,
                                        match, mismatch, o1, o2, e1, e2)
    elif wave:
        # GPU band kernel: anti-diagonal layout, see _align_batch_wave.
        tb, offs = _wave_align(q, r, m, n, max_m, width,
                               match, mismatch, o1, o2, e1, e2)
    else:
        _, tb, offs = _align_batch(q, r, m, n, max_m, width,
                                   match, mismatch, o1, o2, e1, e2)

    L = ((max_m + r.shape[1] + 3) // 4) * 4  # multiple of 4 for 2-bit packing
    w_dim = _wave_width(width) if wave else width

    def one(tb_i, offs_i, q_i, r_i, m_i, n_i):
        # state: 0=H, 1=E, 2=F; piece in {0,1}. Codes are emitted as scan ys:
        # a steps.at[t].set() accumulator lowers to a per-step dynamic-update
        # that cost 10x the whole walk (measured 1.08s -> 0.107s at B=64).
        def body(carry, _):
            i, j, st, piece, err = carry
            done = (i <= 0) & (j <= 0)

            # Row/column edges: pure gaps.
            at_top = (i <= 0) & (j > 0)
            at_left = (j <= 0) & (i > 0)

            if wave:
                # Diagonal-major tape: cell (i, j) lives on diagonal d = i+j
                # (stored at row d-1), lane i - doffs[d-1].
                row = jnp.maximum(i + j - 1, 0)
                w = i - offs_i[row]
            else:
                row = jnp.maximum(i - 1, 0)
                w = j - offs_i[row]
            in_band = (w >= 0) & (w < w_dim)
            byte = tb_i[row, jnp.clip(w, 0, w_dim - 1)].astype(jnp.int32)

            # Resolve the action for this step.
            h_f = (byte & 2) != 0
            h_e = (byte & 1) != 0
            act_from_h = jnp.where(h_f, 2, jnp.where(h_e, 1, 0))  # 0=diag,1=E,2=F
            act = jnp.where(st == 0, act_from_h, st)
            new_piece = jnp.where(
                (st == 0) & (act == 1), ((byte >> 2) & 1),
                jnp.where((st == 0) & (act == 2), ((byte >> 3) & 1), piece))

            # Edge overrides.
            act = jnp.where(at_top, 2, jnp.where(at_left, 1, act))

            qb = q_i[jnp.maximum(i - 1, 0)]
            rb = r_i[jnp.maximum(j - 1, 0)]
            diag_code = jnp.where((qb == rb) & (qb < 4) & (rb < 4), STEP_EQ, STEP_X)

            e_ext = jnp.where(new_piece == 0, (byte >> 4) & 1, (byte >> 5) & 1)
            f_open = jnp.where(new_piece == 0, (byte >> 6) & 1, (byte >> 7) & 1)

            code = jnp.where(act == 0, diag_code,
                             jnp.where(act == 1, STEP_I, STEP_D)).astype(jnp.uint8)
            code = jnp.where(done, jnp.uint8(STEP_DONE), code)

            di = jnp.where(act == 0, 1, jnp.where(act == 1, 1, 0))
            dj = jnp.where(act == 0, 1, jnp.where(act == 2, 1, 0))
            # Edge moves don't consult the byte.
            e_ext_eff = jnp.where(at_left, jnp.int32(1), e_ext)
            f_open_eff = jnp.where(at_top, jnp.int32(0), f_open)

            new_st = jnp.where(act == 0, 0,
                               jnp.where(act == 1,
                                         jnp.where(e_ext_eff == 1, 1, 0),
                                         jnp.where(f_open_eff == 1, 0, 2)))

            err = err | (~done & ~at_top & ~at_left & (st == 0) & ~in_band & (act == 0))
            err = err | (~done & ~at_top & ~at_left & ~in_band)

            i = jnp.where(done, i, i - di)
            j = jnp.where(done, j, j - dj)
            st = jnp.where(done, st, new_st)
            return (i, j, st, new_piece, err), code

        init = (m_i.astype(jnp.int32), n_i.astype(jnp.int32),
                jnp.int32(0), jnp.int32(0), jnp.bool_(False))
        (i, j, st, piece, err), steps = jax.lax.scan(
            body, init, None, length=L, unroll=4)
        err = err | (i > 0) | (j > 0)

        # 2-bit pack the tape (codes 0-3; DONE positions zeroed, length kept
        # separately): a 4x cut in the only tensor that leaves the device.
        path_len = jnp.sum((steps != STEP_DONE).astype(jnp.int32))
        codes = jnp.where(steps == STEP_DONE, 0, steps).astype(jnp.uint8)
        quads = codes.reshape(-1, 4)
        packed = (quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4)
                  | (quads[:, 3] << 6)).astype(jnp.uint8)
        return packed, path_len, err

    packed, path_len, err = jax.vmap(one)(tb, offs, q, r, m, n)
    # Fuse the three outputs into ONE uint8 buffer per launch, so the tape,
    # the path length (4 LE bytes) and the error flag come back in one
    # device->host copy.
    pl_bytes = jnp.stack([(path_len >> (8 * i)).astype(jnp.uint8)
                          for i in range(4)], axis=1)
    return jnp.concatenate(
        [packed, pl_bytes, err.astype(jnp.uint8)[:, None]], axis=1)


class BandedAligner:
    """Host-facing wrapper: pad/bucket segments, run the kernel, traceback.

    With a mesh, batches are device_put sharded along the batch axis — every op
    in the kernel is batch-elementwise, so XLA partitions it across the mesh
    with no collectives and the DP scales linearly over devices.
    """

    def __init__(self, scoring=None, mesh=None):
        self.scoring = dict(DEFAULT_SCORING, **(scoring or {}))
        self.mesh = mesh
        self._shard = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            self._shard = NamedSharding(mesh, P(mesh.axis_names[0]))

    def _put(self, arr):
        a = jnp.asarray(arr)
        if self._shard is not None and arr.shape[0] % self.mesh.size == 0:
            out = jax.device_put(a, self._shard)
            STATS['sharded_puts'] += 1
            STATS['mesh_devices'] = self.mesh.size
            STATS['shard_rows'] = tuple(
                s.data.shape[0] for s in out.addressable_shards)
            return out
        return a

    @staticmethod
    def _note_shard_cells(prev_puts, max_m, width):
        """Accumulate per-device padded DP cells for a just-sharded launch —
        the measured mesh work-balance record (see STATS['shard_cells'])."""
        if STATS['sharded_puts'] <= prev_puts:
            return
        rows = STATS['shard_rows']
        cur = STATS['shard_cells']
        if len(cur) != len(rows):
            cur = (0,) * len(rows)
        STATS['shard_cells'] = tuple(
            c + r * max_m * width for c, r in zip(cur, rows))

    def align_batch(self, pairs, width, pad_to=None):
        """Align a list of (q_codes, r_codes) with one bucket shape.

        :param pairs: list of (q, r) uint8 code arrays; len(q) <= max_m.
        :param width: band window width (covers whole row when >= max(n)+1).
        :param pad_to: pad both sequence dims to this size (canonical square
            bucket); defaults to per-batch power-of-two padding.

        :return: list of (lens, ops) CIGAR arrays (I = query-consuming gap,
            D = ref-consuming gap, =/X matches).
        """
        return self.align_batch_async(pairs, width, pad_to=pad_to)()

    def align_batch_async(self, pairs, width, pad_to=None, pad_batch=None):
        """Dispatch the batch to the device and return a no-arg callable that
        blocks, transfers the packed tapes, and yields the CIGAR list. Lets the
        caller launch every bucket before paying any transfer latency."""
        sc = self.scoring
        B = len(pairs)
        m = np.array([len(q) for q, _ in pairs], dtype=np.int32)
        n = np.array([len(r) for _, r in pairs], dtype=np.int32)
        max_m = int(m.max()) if B else 0
        max_n = int(n.max()) if B else 0
        if max_m == 0:
            result = [_pure_gap(len(r), 'D') for _, r in pairs]
            return lambda: result

        if pad_batch:
            B_pad = int(pad_batch)
        else:
            # Quantize to powers of 4 (>= 8): a handful of compiled batch
            # shapes per size class, bounded padding waste.
            B_pad = 8
            while B_pad < B:
                B_pad *= 4
        if isinstance(pad_to, tuple):
            max_m, max_n = int(pad_to[0]), int(pad_to[1])
        elif pad_to is not None:
            max_m = max_n = int(pad_to)
        else:
            max_m = max(_next_pow2(max_m), 8)
            max_n = max(_next_pow2(max(max_n, 1)), 8)
        width = min(_next_pow2(int(width)) + 1, max_n + 1)

        m_p = np.concatenate([m, np.ones(B_pad - B, dtype=np.int32)])
        n_p = np.concatenate([n, np.ones(B_pad - B, dtype=np.int32)])
        qpad = np.full((B_pad, max_m), 4, dtype=np.int8)
        rpad = np.full((B_pad, max_n), 4, dtype=np.int8)
        for i, (qq, rr) in enumerate(pairs):
            qpad[i, :len(qq)] = qq
            rpad[i, :len(rr)] = rr

        import time as _time
        _t0 = _time.time()
        prev_puts = STATS['sharded_puts']
        # Sequences cross to the device 2-bit packed (+ ambiguity bitmap) on
        # accelerators; the CPU backend skips the pack/unpack step.
        platform = jax.default_backend()
        kernel = dp_kernel(platform, max_n, int(width))
        scoring = (int(sc['match']), int(sc['mismatch']),
                   int(sc['gap_open'][0]), int(sc['gap_open'][1]),
                   int(sc['gap_ext'][0]), int(sc['gap_ext'][1]))
        if platform != 'cpu':
            qp, qa = _pack_codes(qpad)
            rp, ra = _pack_codes(rpad)
            fused = _align_and_trace_packed(
                self._put(qp), self._put(qa), self._put(rp), self._put(ra),
                self._put(m_p), self._put(n_p),
                max_m, max_n, int(width), *scoring, kernel=kernel)
        else:
            fused = _align_and_trace(
                self._put(qpad), self._put(rpad),
                self._put(m_p), self._put(n_p),
                max_m, int(width), *scoring, kernel=kernel)

        STATS['launches'] += 1
        STATS['items'] += B
        STATS['h2d_bytes'] += (B_pad * (max_m + max_n) // 4 * 5 // 4
                               if platform != 'cpu'
                               else B_pad * (max_m + max_n))
        STATS['dispatch_s'] += _time.time() - _t0
        self._note_shard_cells(prev_puts, max_m, int(width))

        cells_real = int(np.sum(m.astype(np.int64)
                                * np.minimum(n + 1, int(width))))
        return self._finish(fused, B, B_pad, max_m, max_n, int(width),
                            cells_real=cells_real)

    def align_batch_refs_async(self, items, width, pad_to, pad_batch=None,
                               resident=None):
        """Device-resident launch: like align_batch_async, but sequences are
        described as (qoff, qlen, qflags, roff, rlen, rflags) windows into a
        resident device buffer and gathered on-device.

        :param items: list of 6-tuples (offsets resolved into the resident
            buffer). flags is a 2-bit field: bit0 = gather the window
            reversed, bit1 = complement bases (3 - code for ACGT); together
            they express reverse-complement windows so only the forward
            orientation of each source is ever uploaded (see
            _align_and_trace_resident and core.py rc_map).
        :param resident: int8 device array from core._build_resident.
        """
        sc = self.scoring
        B = len(items)
        max_m, max_n = int(pad_to[0]), int(pad_to[1])
        width = min(_next_pow2(int(width)) + 1, max_n + 1)
        B_pad = int(pad_batch) if pad_batch else max(8, _next_pow2(B))

        arr = np.zeros((B_pad, 6), dtype=np.int32)
        if B:
            arr[:B] = np.asarray(items, dtype=np.int32)
        arr[B:, 1] = 1   # padding items: 1-base windows
        arr[B:, 4] = 1

        import time as _time
        _t0 = _time.time()
        prev_puts = STATS['sharded_puts']
        fused = _align_and_trace_resident(
            resident, self._put(arr),
            max_m, max_n, int(width),
            int(sc['match']), int(sc['mismatch']),
            int(sc['gap_open'][0]), int(sc['gap_open'][1]),
            int(sc['gap_ext'][0]), int(sc['gap_ext'][1]),
            kernel=dp_kernel(jax.default_backend(), max_n, int(width)))
        STATS['launches'] += 1
        STATS['items'] += B
        STATS['h2d_bytes'] += arr.nbytes
        STATS['dispatch_s'] += _time.time() - _t0
        self._note_shard_cells(prev_puts, max_m, int(width))
        cells_real = int(np.sum(
            arr[:B, 1].astype(np.int64)
            * np.minimum(arr[:B, 4].astype(np.int64) + 1, int(width))))
        return self._finish(fused, B, B_pad, max_m, max_n, int(width),
                            cells_real=cells_real)

    def _finish(self, fused, B, B_pad, max_m, max_n, width, cells_real=0):
        """Build the (prefetchable) resolver for one dispatched launch."""
        import time as _time

        # Drop batch padding on-device before the transfer: a part-full
        # fixed-batch launch would otherwise copy mostly-padding tape bytes
        # to the host.
        rows = max(8, _next_pow2(B))
        if rows < B_pad:
            fused = _slice_rows(fused, rows=rows)

        def prefetch():
            # Start the device->host copy without blocking: with every
            # launch's transfer queued up front, sequential resolves overlap
            # all transfers (see core._resolve_handles).
            _t1 = _time.time()
            try:
                fused.copy_to_host_async()
            except Exception:
                pass    # optional acceleration; resolve() blocks regardless
            STATS['prefetch_s'] += _time.time() - _t1

        def resolve():
            # One transfer per launch; slice on host. (Device-side `arr[:B]`
            # with a free-varying B would compile a fresh XLA slice program
            # per distinct B.)
            _t1 = _time.time()
            buf = np.asarray(fused)
            _dt = _time.time() - _t1
            STATS['resolve_s'] += _dt
            key = (max_m, max_n, width, B_pad)
            cls = STATS['classes'].setdefault(key, [0, 0.0, 0, 0, 0])
            cls[0] += 1
            cls[1] += _dt
            cls[2] += B
            cls[3] += B_pad * max_m * width
            cls[4] += cells_real
            STATS['d2h_bytes'] += buf.nbytes
            pk = buf[:B, :-5]
            pl = buf[:B, -5:-1].astype(np.int32) << np.arange(
                4, dtype=np.int32) * 8
            pl = pl.sum(axis=1)
            er = buf[:B, -1]
            if er.any() and width >= max_n + 1:
                raise RuntimeError('Traceback failed at full width (program bug)')
            # Band-too-narrow items resolve to None; the caller re-runs just
            # those at full width (per-item, not per-batch).
            return [None if er[i] else packed_steps_to_cigar(pk[i], int(pl[i]))
                    for i in range(B)]

        resolve.prefetch = prefetch
        return resolve


_UNPACK_LUT = None


def packed_steps_to_cigar(packed_row, path_len):
    """2-bit packed device step tape (reversed path) -> (lens, ops)."""
    from ..align import cigar as cg
    global _UNPACK_LUT

    if path_len == 0:
        return np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int8)
    if _UNPACK_LUT is None:
        lut = np.empty((256, 4), dtype=np.uint8)
        for b in range(256):
            lut[b] = [(b >> (2 * i)) & 3 for i in range(4)]
        _UNPACK_LUT = lut

    codes = _UNPACK_LUT[packed_row].reshape(-1)[:path_len][::-1]
    op_map = np.array([cg.EQ, cg.X, cg.I, cg.D], dtype=np.int8)
    ops_full = op_map[codes]
    boundary = np.concatenate([[True], ops_full[1:] != ops_full[:-1]])
    starts = np.nonzero(boundary)[0]
    ends = np.concatenate([starts[1:], [len(ops_full)]])
    return (ends - starts).astype(np.int32), ops_full[boundary]


def _pure_gap(length, op_char):
    from ..align import cigar as cg
    if length == 0:
        return np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int8)
    op = cg.I if op_char == 'I' else cg.D
    return np.array([length], dtype=np.int32), np.array([op], dtype=np.int8)


def traceback(tb, offs, q, r, width):
    """Walk packed traceback bytes from (m, n) to (0, 0); emit (lens, ops)."""
    from ..align import cigar as cg

    m, n = len(q), len(r)
    if m == 0:
        return _pure_gap(n, 'D')
    if n == 0:
        return _pure_gap(m, 'I')

    ops_rev = []  # (op, run) appended in reverse order

    def emit(op):
        if ops_rev and ops_rev[-1][0] == op:
            ops_rev[-1][1] += 1
        else:
            ops_rev.append([op, 1])

    i, j = m, n
    state = 'H'
    piece = 0
    while i > 0 and j > 0:
        row_tb = tb[i - 1]
        off = int(offs[i - 1])
        w = j - off
        if w < 0 or w >= width:
            raise RuntimeError(
                f'Traceback left the band at ({i},{j}) off={off} width={width}; '
                'band too narrow for this segment')
        byte = int(row_tb[w])

        if state == 'H':
            if byte & 2:
                state = 'F'
                piece = 1 if (byte & 8) else 0
                continue
            if byte & 1:
                state = 'E'
                piece = 1 if (byte & 4) else 0
                continue
            emit(cg.EQ if (q[i - 1] == r[j - 1] and q[i - 1] < 4) else cg.X)
            i -= 1
            j -= 1
        elif state == 'E':
            emit(cg.I)
            extend = byte & (16 if piece == 0 else 32)
            i -= 1
            if not extend:
                state = 'H'
        else:  # F
            emit(cg.D)
            opened = byte & (64 if piece == 0 else 128)
            j -= 1
            if opened:
                state = 'H'

    if i > 0:
        emit_run(ops_rev, cg.I, i)
    if j > 0:
        emit_run(ops_rev, cg.D, j)

    ops_rev.reverse()
    lens = np.array([rl for _, rl in ops_rev], dtype=np.int32)
    ops = np.array([op for op, _ in ops_rev], dtype=np.int8)
    return lens, ops


def emit_run(ops_rev, op, run):
    if run <= 0:
        return
    if ops_rev and ops_rev[-1][0] == op:
        ops_rev[-1][1] += run
    else:
        ops_rev.append([op, run])
