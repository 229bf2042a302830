#!/usr/bin/env python
"""Smoke test of pav_tpu on one NVIDIA GPU, through its normal entry points.

  python chip_smoke.py               one card: kernel parity, main path, banded path
  python chip_smoke.py --four-cards  four cards: headline genome with
                                     mesh_devices=4 against one card

Phases (one card):
  1. kernel parity: every DP shape class the GPU runs, at its batch cap.
     Full-width classes (_align_batch_full) against the CPU backend on the
     same items; banded classes (the CUDA wave kernel) against the XLA
     reference _align_batch_wave; both bit-exact. The KDE device kernel
     against the float64 host path at n_pad 2^15..2^21.
  2. main path: a 100 Mbp chromosome with a phased diploid assembly through
     `python -m pav_tpu` (in process), the VCF scored against the planted
     truth at the recall floors of tests/test_recall.py.
  3. banded path: the 8 Mbp repeat-rich genome through Pipeline.run_sample;
     prints the banded DP classes that launched and the kernel serving them.

Exits non-zero, printing no result, when JAX finds no GPU or any phase
fails. The last line of stdout is the JSON result.
"""

import argparse
import gzip
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 11
MAIN_MBP = 100   # one human-chromosome-scale reference
WORK = os.path.join(ROOT, '.bench_cache', 'smoke')


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f'FAILED: {msg}')


def kernel_parity():
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from pav_tpu.align.aligner.core import _shape_batch
    from pav_tpu.ops import affine_dp as A
    from pav_tpu.runtime import _DP_SHAPES_ACCEL

    cpu = jax.devices('cpu')[0]
    sc = A.DEFAULT_SCORING
    scoring = (sc['match'], sc['mismatch'], *sc['gap_open'], *sc['gap_ext'])
    for (m_b, n_b), w in _DP_SHAPES_ACCEL:
        width = min(A._next_pow2(w) + 1, n_b + 1)
        B = _shape_batch(m_b, w, n_b)
        q, r, m, n = bench.dp_class_inputs(m_b, n_b, B, seed=m_b + n_b)
        args = [jnp.asarray(a) for a in (q, r, m, n)]
        kernel = A.dp_kernel('gpu', n_b, width)
        t0 = time.time()
        if kernel == 'full':
            _, tb, _ = A._align_batch_full(*args, m_b, width, *scoring)
            tb = np.asarray(tb)
            secs = time.time() - t0
            k = 4   # the CPU checks the first items (the kernel is per item)
            _, tb_ref, _ = A._align_batch_full(
                *(jax.device_put(a[:k], cpu) for a in (q, r, m, n)),
                m_b, width, *scoring)
            ok = np.array_equal(tb[:k], np.asarray(tb_ref))
            ref_name = f'cpu[:{k}]'
        else:
            tb, offs = A._wave_align(*args, m_b, width, *scoring)
            tb, offs = np.asarray(tb), np.asarray(offs)
            secs = time.time() - t0
            tb_ref, offs_ref = A._align_batch_wave(*args, m_b, width, *scoring)
            ok = (np.array_equal(tb, np.asarray(tb_ref))
                  and np.array_equal(offs, np.asarray(offs_ref)))
            ref_name = '_align_batch_wave'
        log(f'dp ({m_b},{n_b}) w{width} B{B} {kernel}: '
            f'{"bit-identical" if ok else "MISMATCH"} vs {ref_name}, '
            f'{secs:.3f}s incl. compile')
        check(ok, f'DP class ({m_b},{n_b}) w{width} differs from {ref_name}')

    for n_pad in (1 << 15, 1 << 16, 1 << 17, 1 << 18, 1 << 19, 1 << 20, 1 << 21):
        from pav_tpu.ops import kde
        state, sigmas = bench.kde_inputs(n_pad)
        t0 = time.time()
        st, dens = kde._density_state_kernel(
            jnp.asarray(state), jnp.asarray(sigmas), n_pad, 3)
        st, dens = np.asarray(st), np.asarray(dens)
        secs = time.time() - t0
        agree = bench.kde_agreement(state, sigmas, st, dens)
        log(f'kde n_pad={n_pad}: {agree["mismatched_states"]} of '
            f'{agree["decided"]} decided states differ from the float64 host '
            f'path (tie tolerance {bench.KDE_TIE_TOL} of peak), max |err| '
            f'{agree["max_abs_err_rel_to_peak"]:.2e} of peak, '
            f'{secs:.3f}s incl. compile')
        check(agree['mismatched_states'] == 0, f'KDE states differ at {n_pad}')


def write_inputs(work, ref, haps):
    """ref.fa, one FASTA per haplotype, asm.tsv -> asm.tsv path."""
    from pav_tpu.io.fasta import write_fasta

    os.makedirs(work, exist_ok=True)
    write_fasta({'chr1': ref}, os.path.join(work, 'ref.fa'))
    cols = []
    for hap, (name, seq) in haps.items():
        path = os.path.join(work, f'{hap}.fa')
        write_fasta({name: seq}, path)
        cols.append((hap, path))
    with open(os.path.join(work, 'asm.tsv'), 'w') as fh:
        fh.write('NAME\t' + '\t'.join(f'HAP_{h}' for h, _ in cols) + '\n')
        fh.write('S1\t' + '\t'.join(p for _, p in cols) + '\n')
    return os.path.join(work, 'asm.tsv')


def run_cli(work, asm, run_dir, extra=()):
    """python -m pav_tpu, in process -> (VCF path, seconds)."""
    from pav_tpu.__main__ import main as cli

    shutil.rmtree(run_dir, ignore_errors=True)
    t0 = time.time()
    rc = cli(['--ref', os.path.join(work, 'ref.fa'), '--assemblies', asm,
              '--run-dir', run_dir, '--set', 'aligner_min_chain_score=1000',
              *extra])
    secs = time.time() - t0
    check(rc == 0, f'pav_tpu exited {rc}')
    vcf = os.path.join(run_dir, 'S1.vcf.gz')
    check(os.path.exists(vcf), f'no VCF at {vcf}')
    return vcf, secs


def main_path(mbp):
    import bench
    from pav_tpu import eval as ev

    t0 = time.time()
    ref, h1, h2, t1, t2 = bench.build_genome(int(mbp * 1e6), SEED + 17)
    work = os.path.join(WORK, f'main{mbp}')
    asm = write_inputs(work, ref, {'h1': ('c1', h1), 'h2': ('c2', h2)})
    log(f'main path: {mbp} Mbp reference, {(len(h1) + len(h2)) / 1e6:.1f} Mbp '
        f'of contigs, inputs ready in {time.time() - t0:.1f}s')
    vcf, secs = run_cli(work, asm, os.path.join(work, 'run'))
    truth = bench.truth_table(t1 + t2).drop_duplicates(
        subset=['POS', 'SVTYPE', 'SVLEN', 'ALT'])
    rep = ev.concordance(truth, ev.read_vcf(vcf)).set_index('SVTYPE')
    log(f'main path: pav_tpu {secs:.1f}s, '
        f'{(len(h1) + len(h2)) / 1e6 / secs:.3f} Mbp/s incl. compile')
    log(rep.to_string())
    floors = [('SNV', 'RECALL', 0.99), ('SNV', 'PRECISION', 0.99),
              ('INS', 'RECALL', 0.97), ('DEL', 'RECALL', 0.97),
              ('INS', 'PRECISION', 0.95), ('DEL', 'PRECISION', 0.95),
              ('INV', 'RECALL', 1.0)]
    for svtype, col, floor in floors:
        check(rep.loc[svtype, col] >= floor,
              f'{svtype} {col} {rep.loc[svtype, col]} < {floor}')
    check(rep.loc['INV', 'N_TRUTH'] >= 1, 'no planted inversion')


def banded_path():
    import bench
    from pav_tpu.io.fasta import SeqStore
    from pav_tpu.ops import affine_dp as A
    from pav_tpu.pipeline import Pipeline

    ref, hap = bench.build_repeat_genome(8_000_000, SEED + 7)
    A.stats_reset()
    t0 = time.time()
    res = Pipeline(SeqStore({'chr1': ref}), {'aligner_min_chain_score': 1000},
                   log=open(os.devnull, 'w')).run_sample(
        'rep', {'h1': SeqStore({'rtig1': hap})}, write_vcf=False)
    secs = time.time() - t0
    n_calls = sum(df.shape[0] for (_, tier), df in res['merged'].items()
                  if tier == 'pass')
    log(f'banded path: repeat-rich {len(hap) / 1e6:.1f} Mbp in {secs:.1f}s '
        f'incl. compile, {n_calls} PASS calls')
    banded = [(k, v) for k, v in sorted(A.STATS['classes'].items())
              if k[2] < k[1] + 1]
    for (m_b, n_b, w, bp), (launches, wait_s, items, _, _) in banded:
        log(f'  banded class ({m_b},{n_b}) w{w} B{bp}: {launches} launches, '
            f'{items} items, kernel {A.dp_kernel("gpu", n_b, w)}, '
            f'resolve wait {wait_s:.3f}s')
    check(banded, 'no banded DP class launched')
    check(n_calls > 100, f'implausible repeat-rich callset: {n_calls} calls')


def four_cards():
    import jax

    import bench
    from pav_tpu.ops import affine_dp as A

    check(len(jax.devices()) >= 4, f'{len(jax.devices())} devices, need 4')
    ref, h1, h2, _t1, _t2 = bench.build_genome(int(bench.REF_MBP * 1e6), SEED)
    work = os.path.join(WORK, 'four')
    asm = write_inputs(work, ref, {'h1': ('tig1', h1), 'h2': ('tig2', h2)})
    vcf1, s1 = run_cli(work, asm, os.path.join(work, 'run1'))
    A.stats_reset()
    vcf4, s4 = run_cli(work, asm, os.path.join(work, 'run4'),
                       ['--set', 'mesh_devices=4'])
    with gzip.open(vcf1, 'rb') as a, gzip.open(vcf4, 'rb') as b:
        same = a.read() == b.read()
    log(f'four cards: 1 card {s1:.1f}s, mesh_devices=4 {s4:.1f}s '
        f'(both incl. compile); VCFs {"identical" if same else "DIFFER"}')
    log(f'four cards: shard_cells per device {A.STATS["shard_cells"]}, '
        f'sharded launches {A.STATS["sharded_puts"]}')
    check(same, 'mesh_devices=4 VCF differs from the one-card VCF')
    cells = A.STATS['shard_cells']
    check(len(cells) == 4 and min(cells) > 0, 'not every card did DP work')


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--four-cards', action='store_true',
                        help='run only the four-card mesh check')
    args = parser.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != 'gpu':
        print(f'chip_smoke: no GPU (JAX found {devs[0].platform})',
              file=sys.stderr)
        return 1

    sys.path.insert(0, ROOT)
    import jaxlib
    import pandas

    import bench
    from pav_tpu.runtime import enable_compile_cache

    log(bench.card_line())
    log(f'jax {jax.__version__} jaxlib {jaxlib.__version__} '
        f'pandas {pandas.__version__}; {len(devs)} x {devs[0].device_kind}')
    log(f'compile cache: {enable_compile_cache()}')

    t0 = time.time()
    if args.four_cards:
        four_cards()
    else:
        kernel_parity()
        log(f'kernel parity done at {time.time() - t0:.1f}s')
        main_path(MAIN_MBP)
        log(f'main path done at {time.time() - t0:.1f}s')
        banded_path()
    log(f'all phases passed in {time.time() - t0:.1f}s')
    print(json.dumps({'ok': True, 'device': {
        'platform': devs[0].platform, 'kind': devs[0].device_kind,
        'count': len(devs)}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
