#!/usr/bin/env python
"""Benchmark: end-to-end contig Mbp aligned+called per second on one GPU.

Synthesizes diploid assemblies against synthetic references (planted SNVs,
indels, SVs and an inversion at human-like densities), runs the full engine
(align -> trim -> call -> integrate -> merge -> VCF) and reports throughput.
Three phases run in order in this one process:

  headline     16 Mbp uniform genome, best of N timed runs after a warm-up
  repeat-rich   8 Mbp repeat-rich genome (tandem arrays, segdups, N-gaps)
  chromosome  100 Mbp genome, one warm and one timed pass

``--kernels`` instead times each DP shape class and the KDE device kernel,
and compares the CUDA wave kernel with its XLA reference, per class and on
the repeat-rich genome end to end.

The benchmark fails when JAX finds no GPU: a CPU run measures no device.
Baseline: the reference pipeline processes ~6 Gbp diploid in ~5 h on a
32-core host ~= 0.33 Mbp/s (BASELINE.md).

Prints one JSON line per completed phase; the last line carries them all.
"""

import argparse
import json
import os
import pickle
import resource
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'tests'))

import numpy as np  # noqa: E402

BASELINE_MBP_S = 0.33
SEED = 11
REF_MBP = 16
CHROM_MBP = 100
# Synthesized genomes, keyed by (generator version, seed, length): gitignored.
GENOME_CACHE = os.path.join(ROOT, '.bench_cache')


def build_genome(ref_len, seed):
    """Uniform random reference + two haplotypes with planted variants.

    :return: (ref, h1, h2, truth1, truth2); truth lists hold the planted
        records (tests/helpers.py Mutator.truth). Deterministic in
        (ref_len, seed) and cached with its truth under GENOME_CACHE. Bump
        the _v2 tag if the generator in tests/helpers.py changes.
    """
    from helpers import Mutator, random_seq

    cache = os.path.join(GENOME_CACHE, f'genome_v2_{seed}_{ref_len}.pkl')
    try:
        with open(cache, 'rb') as fh:
            return pickle.load(fh)
    except (OSError, EOFError, pickle.UnpicklingError):
        pass

    rng = np.random.default_rng(seed)
    ref = random_seq(ref_len, rng)

    def make_hap(seed2, with_inv):
        rng2 = np.random.default_rng(seed2)
        mut = Mutator(ref)
        pos = 2000
        inv_planted = False
        while pos < ref_len - 20000:
            r = rng2.random()
            if r < 0.80:
                mut.snv(pos, rng=rng2)          # ~1 SNV / 1.25 kb
            elif r < 0.95:
                ln = int(rng2.integers(1, 25))
                if rng2.random() < 0.5:
                    mut.ins(pos, random_seq(ln, rng2))
                else:
                    mut.dele(pos, ln)
            elif r < 0.985:
                ln = int(rng2.integers(50, 1500))
                if rng2.random() < 0.5:
                    mut.ins(pos, random_seq(ln, rng2))
                else:
                    mut.dele(pos, ln)
            else:
                if with_inv and not inv_planted and pos < ref_len - 40000:
                    mut.inv(pos, int(rng2.integers(3000, 8000)))
                    inv_planted = True
            # Advance past the reference span the last event consumed.
            pos = max(pos + int(rng2.integers(800, 1800)), mut.cursor + 200)
        return mut.finish(), mut.truth

    h1, t1 = make_hap(seed + 1, with_inv=False)
    h2, t2 = make_hap(seed + 2, with_inv=True)
    out = (ref, h1, h2, t1, t2)
    os.makedirs(GENOME_CACHE, exist_ok=True)
    tmp = f'{cache}.{os.getpid()}.tmp'
    with open(tmp, 'wb') as fh:
        pickle.dump(out, fh, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, cache)
    return out


def build_repeat_genome(ref_len, seed):
    """Repeat-rich reference (tests/helpers.repeat_rich_ref) + one haplotype
    with planted SNVs and indels: (ref, hap)."""
    from helpers import Mutator, random_seq, repeat_rich_ref

    rng = np.random.default_rng(seed)
    ref, _ann = repeat_rich_ref(ref_len, rng)
    mut = Mutator(ref)
    pos = 2000
    while pos < len(ref) - 20000:
        r = rng.random()
        if r < 0.8:
            if ref[pos] < 4:   # never SNV an N-gap base
                mut.snv(pos, rng=rng)
        elif r < 0.97:
            ln = int(rng.integers(1, 40))
            if rng.random() < 0.5:
                mut.ins(pos, random_seq(ln, rng))
            else:
                mut.dele(pos, ln)
        else:
            ln = int(rng.integers(50, 1200))
            if rng.random() < 0.5:
                mut.ins(pos, random_seq(ln, rng))
            else:
                mut.dele(pos, ln)
        pos = max(pos + int(rng.integers(900, 2000)), mut.cursor + 200)
    return ref, mut.finish()


def truth_table(truth, chrom='chr1'):
    """Planted truth records -> callset table for pav_tpu.eval.concordance."""
    import pandas as pd

    rows = []
    for t in truth:
        if t['type'] == 'SNV':
            rows.append((chrom, t['pos'], t['pos'] + 1, 'SNV', 1,
                         t['ref'], t['alt']))
        elif t['type'] == 'INS':
            rows.append((chrom, t['pos'], t['pos'] + 1, 'INS', t['len'], 'N', 'N'))
        elif t['type'] == 'DEL':
            rows.append((chrom, t['pos'], t['pos'] + t['len'], 'DEL', t['len'], 'N', 'N'))
        elif t['type'] == 'INV':
            rows.append((chrom, t['pos'], t['pos'] + t['len'], 'INV', t['len'], 'N', 'N'))
    df = pd.DataFrame(rows, columns=['#CHROM', 'POS', 'END', 'SVTYPE', 'SVLEN',
                                     'REF', 'ALT'])
    df['ID'] = [f'truth{i}' for i in range(df.shape[0])]
    df['FILTER'] = 'PASS'
    df['GT'] = '1'
    return df


def require_gpu():
    """The first GPU, or SystemExit: nothing here measures a CPU run."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        raise SystemExit(f'no GPU: JAX found {dev.platform} devices only')
    return dev


def card_line():
    """`nvidia-smi --query-gpu=name,power.limit` for the record."""
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as ex:
        return f'nvidia-smi unavailable ({ex})'


def stage_breakdown(timings):
    tot = {}
    for (_, stage), secs in timings.items():
        tot[stage] = tot.get(stage, 0.0) + secs
    return dict(sorted(tot.items(), key=lambda kv: -kv[1]))


def report_dp_classes(st):
    """Per-class DP launch accounting (useful% = cells the problems needed /
    cells the padded programs scanned)."""
    for (m, n, w, bp), (launches, res_s, items, c_pad, c_real) in sorted(
            st['classes'].items()):
        sys.stderr.write(
            f'[bench]   dp class m{m} n{n} w{w} B{bp}: {launches} launches, '
            f'{items} items, wait {res_s:.3f}s, {c_pad / 1e9:.3f}G cells '
            f'padded, useful {100 * c_real / max(c_pad, 1):.1f}%\n')


def run_headline(logf, iters=4):
    from pav_tpu.align.aligner import chain as chain_mod
    from pav_tpu.align.aligner.core import ALIGN_STATS, align_stats_reset
    from pav_tpu.io.fasta import SeqStore
    from pav_tpu.ops import affine_dp
    from pav_tpu.pipeline import Pipeline

    ref, h1, h2, _t1, _t2 = build_genome(int(REF_MBP * 1e6), SEED)
    contig_mbp = (len(h1) + len(h2)) / 1e6
    ref_store = SeqStore({'chr1': ref})

    # Warm-up on a small genome compiles the common kernel shape buckets.
    wref, wh1, wh2, *_ = build_genome(300000, SEED + 99)
    Pipeline(SeqStore({'chr1': wref}), {'aligner_min_chain_score': 1000},
             log=logf).run_sample(
        'warm', {'h1': SeqStore({'w1': wh1}), 'h2': SeqStore({'w2': wh2})},
        write_vcf=False)

    best = None
    for it in range(iters):
        affine_dp.stats_reset()
        align_stats_reset()
        chain_mod.chain_stats_reset()
        pipeline = Pipeline(ref_store, {'aligner_min_chain_score': 1000},
                            run_dir=os.path.join(ROOT, '.bench_cache', 'run'),
                            log=logf)
        t0 = time.time()
        result = pipeline.run_sample(
            'bench', {'h1': SeqStore({'tig1': h1}), 'h2': SeqStore({'tig2': h2})})
        secs = time.time() - t0
        n_snv = result['merged'][('snv_snv', 'pass')].shape[0]
        n_indel = (result['merged'][('svindel_ins', 'pass')].shape[0]
                   + result['merged'][('svindel_del', 'pass')].shape[0])
        assert n_snv > 100 and n_indel > 10, \
            f'implausible callset: {n_snv} SNV, {n_indel} indel'
        sys.stderr.write(f'[bench] headline iteration {it}: {secs:.2f}s\n')
        if best is None or secs < best[0]:
            best = (secs, pipeline.timings,
                    {k: (dict(v) if isinstance(v, dict) else v)
                     for k, v in affine_dp.STATS.items()},
                    dict(ALIGN_STATS), dict(chain_mod.CHAIN_STATS))

    secs, timings, st, align_stats, chain_stats = best
    for stage, s in stage_breakdown(timings).items():
        sys.stderr.write(f'[bench]   {stage:<14} {s:7.2f}s '
                         f'{100 * s / max(secs, 1e-9):5.1f}%\n')
    sys.stderr.write(
        f'[bench] device DP: {st["launches"]} launches, {st["items"]} items, '
        f'h2d {st["h2d_bytes"] / 1e6:.1f}MB, d2h {st["d2h_bytes"] / 1e6:.1f}MB, '
        f'dispatch {st["dispatch_s"]:.2f}s, resolve-wait {st["resolve_s"]:.2f}s\n')
    report_dp_classes(st)
    sys.stderr.write('[bench] align phases: ' + '  '.join(
        f'{k}={v:.2f}s' for k, v in align_stats.items()) + '\n')
    sys.stderr.write('[bench] chain phases: ' + '  '.join(
        f'{k}={v:.2f}s' for k, v in chain_stats.items()) + '\n')
    return contig_mbp / secs


def run_repeat(logf):
    """Repeat-rich genome: one warm and one timed pass -> Mbp/s."""
    from pav_tpu.io.fasta import SeqStore
    from pav_tpu.pipeline import Pipeline

    ref, hap = build_repeat_genome(int(REF_MBP * 1e6 / 2), SEED + 7)
    secs = []
    for _ in range(2):
        pipe = Pipeline(SeqStore({'chr1': ref}),
                        {'aligner_min_chain_score': 1000}, log=logf)
        t0 = time.time()
        pipe.run_sample('bench_rep', {'h1': SeqStore({'rtig1': hap})},
                        write_vcf=False)
        secs.append(time.time() - t0)
    for stage, s in stage_breakdown(pipe.timings).items():
        sys.stderr.write(f'[bench]   repeat {stage:<14} {s:7.2f}s\n')
    return len(hap) / 1e6 / min(secs)


def run_chrom(logf):
    """Chromosome-scale genome: one warm and one timed pass ->
    (Mbp/s, peak host RSS GB)."""
    from pav_tpu.io.fasta import SeqStore
    from pav_tpu.pipeline import Pipeline

    ref, h1, h2, _t1, _t2 = build_genome(int(CHROM_MBP * 1e6), SEED + 17)
    secs = []
    for _ in range(2):
        pipe = Pipeline(SeqStore({'chr1': ref}),
                        {'aligner_min_chain_score': 1000}, log=logf)
        t0 = time.time()
        pipe.run_sample('bench_chrom',
                        {'h1': SeqStore({'c1': h1}), 'h2': SeqStore({'c2': h2})},
                        write_vcf=False)
        secs.append(time.time() - t0)
    for stage, s in stage_breakdown(pipe.timings).items():
        sys.stderr.write(f'[bench]   chrom {stage:<14} {s:7.2f}s\n')
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    return (len(h1) + len(h2)) / 1e6 / min(secs), rss_gb


# ---------------------------------------------------------------- kernels

def _timed(fn, reps=3):
    """(first call seconds incl. compile, best steady-state seconds, out)."""
    import jax
    t0 = time.time()
    out = jax.block_until_ready(fn())
    first = time.time() - t0
    best = float('inf')
    for _ in range(reps):
        t0 = time.time()
        out = jax.block_until_ready(fn())
        best = min(best, time.time() - t0)
    return first, best, out


def dp_class_inputs(m_b, n_b, B, seed=0):
    """B related sequence pairs filling an (m_b, n_b) class: q is r's prefix
    of length m_b with ~2% substitutions and short indels."""
    rng = np.random.default_rng(seed)
    q = np.full((B, m_b), 4, np.int8)
    r = rng.integers(0, 4, (B, n_b)).astype(np.int8)
    for b in range(B):
        src = r[b].copy()
        if n_b > 64:
            cut = int(rng.integers(0, n_b // 16))
            src = np.delete(src, slice(n_b // 2, n_b // 2 + cut))
        qq = src[:m_b].copy()
        sub = rng.random(len(qq)) < 0.02
        qq[sub] = (qq[sub] + 1) % 4
        q[b, :len(qq)] = qq
    m = np.full(B, m_b, np.int32)
    n = np.full(B, n_b, np.int32)
    return q, r, m, n


def time_dp_classes():
    """Per-class DP kernel time on the card at each class's batch cap:
    _align_batch_full for full-width classes; for banded classes the CUDA
    wave kernel beside its XLA reference _align_batch_wave, tapes compared."""
    import jax.numpy as jnp

    from pav_tpu.align.aligner.core import _shape_batch
    from pav_tpu.ops import affine_dp as A
    from pav_tpu.runtime import _DP_SHAPES_ACCEL

    sc = A.DEFAULT_SCORING
    scoring = (sc['match'], sc['mismatch'], *sc['gap_open'], *sc['gap_ext'])
    rows = []
    for (m_b, n_b), w in _DP_SHAPES_ACCEL:
        width = min(A._next_pow2(w) + 1, n_b + 1)
        B = _shape_batch(m_b, w, n_b)
        q, r, m, n = (jnp.asarray(a) for a in dp_class_inputs(m_b, n_b, B))
        kernel = A.dp_kernel('gpu', n_b, width)
        row = {'m': m_b, 'n': n_b, 'width': width, 'B': B, 'kernel': kernel}
        if kernel == 'full':
            first, best, _ = _timed(lambda: A._align_batch_full(
                q, r, m, n, m_b, width, *scoring))
            row.update(compile_s=first, xla_s=best)
        else:
            f_c, b_c, (tb_c, off_c) = _timed(lambda: A._wave_align(
                q, r, m, n, m_b, width, *scoring))
            f_x, b_x, (tb_x, off_x) = _timed(lambda: A._align_batch_wave(
                q, r, m, n, m_b, width, *scoring))
            row.update(compile_s=f_c, cuda_s=b_c, xla_compile_s=f_x, xla_s=b_x,
                       bit_identical=bool(
                           np.array_equal(np.asarray(tb_c), np.asarray(tb_x))
                           and np.array_equal(np.asarray(off_c),
                                              np.asarray(off_x))))
        # Cells the kernel scans: rows x width, or diagonals x band lanes.
        cells = (B * m_b * width if kernel == 'full'
                 else B * (m_b + n_b) * A._wave_width(width))
        row['gcells_per_s'] = cells / row.get('cuda_s', row['xla_s']) / 1e9
        print('DPCLASS ' + json.dumps(row), flush=True)
        rows.append(row)
    return rows


def time_kde(grids=(1 << 15, 1 << 16, 1 << 17, 1 << 18, 1 << 19, 1 << 20,
                    1 << 21)):
    """KDE device kernel time and state agreement with the float64 host path."""
    import jax.numpy as jnp

    from pav_tpu.ops import kde

    rows = []
    for n_pad in grids:
        state, sigmas = kde_inputs(n_pad)
        first, best, (st_d, dens_d) = _timed(lambda: kde._density_state_kernel(
            jnp.asarray(state), jnp.asarray(sigmas, jnp.float32), n_pad, 3))
        agree = kde_agreement(state, sigmas, np.asarray(st_d), np.asarray(dens_d))
        row = {'n_pad': n_pad, 'compile_s': first, 'device_s': best, **agree}
        print('KDE ' + json.dumps(row), flush=True)
        rows.append(row)
    return rows


# States are compared wherever the host's two best densities differ by more
# than this fraction of the grid's largest density: float32 FFT error is
# absolute, on the scale of the largest values, so a near-tie at low density
# is not a disagreement.
KDE_TIE_TOL = 1e-5


def kde_inputs(n, seed=0):
    """Inversion-scan-like k-mer state labels: three state blocks with 10%
    label noise and 5% unmatched (-1) positions, Scott-rule sigmas."""
    from pav_tpu.ops import kde

    rng = np.random.default_rng(seed)
    state = np.zeros(n, np.int8)
    state[n // 3: 2 * n // 3] = 1
    state[2 * n // 3:] = 2
    noise = rng.random(n) < 0.10
    state[noise] = rng.integers(0, 3, int(noise.sum()))
    state[rng.random(n) < 0.05] = -1
    return state, kde.scott_sigmas(state, 0.1).astype(np.float32)


def kde_agreement(state, sigmas, st_dev, dens_dev):
    """Device states vs the float64 host path (ops.kde._host_density_states
    with full kernel support) outside near-ties (KDE_TIE_TOL)."""
    from pav_tpu.ops import kde

    _, dens_h = kde._host_density_states(state, sigmas.astype(np.float64), 3)
    st_h = np.argmax(dens_h, axis=0)
    top2 = np.sort(dens_h, axis=0)[-2:]
    scale = float(dens_h.max())
    decided = (top2[1] - top2[0]) > KDE_TIE_TOL * scale
    n = len(state)
    mism = int(np.sum((st_dev[:n] != st_h) & decided))
    rel = float(np.max(np.abs(dens_dev[:, :n] - dens_h)) / scale)
    return {'mismatched_states': mism, 'decided': int(decided.sum()),
            'max_abs_err_rel_to_peak': rel}


def compare_wave_end_to_end(logf):
    """Repeat-rich genome end to end with the banded classes on the CUDA wave
    kernel, then on its XLA reference (one warm + one timed pass each)."""
    import jax

    from pav_tpu.io.fasta import SeqStore
    from pav_tpu.ops import affine_dp as A
    from pav_tpu.pipeline import Pipeline

    ref, hap = build_repeat_genome(int(REF_MBP * 1e6 / 2), SEED + 7)
    cuda_align = A._wave_align
    out = {}
    for name, impl in (('cuda', cuda_align), ('xla', A._align_batch_wave),
                       ('cuda_again', cuda_align)):
        A._wave_align = impl
        jax.clear_caches()
        secs = []
        for _ in range(2):
            A.stats_reset()
            pipe = Pipeline(SeqStore({'chr1': ref}),
                            {'aligner_min_chain_score': 1000}, log=logf)
            t0 = time.time()
            pipe.run_sample('bench_rep', {'h1': SeqStore({'rtig1': hap})},
                            write_vcf=False)
            secs.append(time.time() - t0)
        stages = stage_breakdown(pipe.timings)
        banded = {f'{k[0]}x{k[1]}w{k[2]}B{k[3]}': v[:3]
                  for k, v in A.STATS['classes'].items() if k[2] < k[1] + 1}
        out[name] = {'mbp_s': len(hap) / 1e6 / secs[1], 'timed_s': secs[1],
                     'warm_s': secs[0], 'align_s': stages.get('align'),
                     'banded_classes': banded}
        print(f'WAVE_E2E {name} ' + json.dumps(out[name]), flush=True)
    A._wave_align = cuda_align
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--kernels', action='store_true',
                        help='time DP classes, the KDE kernel and the wave '
                             'kernel end to end instead of the phases')
    parser.add_argument('--verbose', action='store_true')
    args = parser.parse_args(argv)

    from pav_tpu.runtime import enable_compile_cache, retain_heap

    dev = require_gpu()
    print(card_line(), flush=True)
    print(f'device {dev.platform} {dev.device_kind}; compile cache '
          f'{enable_compile_cache()}', flush=True)
    logf = sys.stderr if args.verbose else open(os.devnull, 'w')

    if args.kernels:
        time_dp_classes()
        time_kde()
        compare_wave_end_to_end(logf)
        return 0

    from pav_tpu.runtime import prime_kernels
    t0 = time.time()
    prime_kernels(verbose=args.verbose)
    sys.stderr.write(f'[bench] priming {time.time() - t0:.1f}s\n')
    retain_heap(0)

    import jax
    out = {'metric': 'contig_mbp_aligned_called_per_s', 'unit': 'Mbp/s',
           'device': {'platform': dev.platform, 'kind': dev.device_kind,
                      'count': len(jax.devices())}}
    value = run_headline(logf)
    out['value'] = value
    out['vs_baseline'] = value / BASELINE_MBP_S
    out['peak_rss_gb'] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(json.dumps(out), flush=True)
    out['repeat_rich_mbp_s'] = run_repeat(logf)
    print(json.dumps(out), flush=True)
    out['chrom_scale_mbp_s'], out['chrom_peak_rss_gb'] = run_chrom(logf)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
