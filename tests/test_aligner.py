"""End-to-end native aligner: synthetic contigs must align with correct
coordinates, =/X CIGARs, passing record invariants, and recover planted variants
through the CIGAR caller."""

import numpy as np
import pandas as pd
import pytest

from pav_tpu import seqcodec
from pav_tpu.align import cigar as cg
from pav_tpu.align.aligner import Aligner
from pav_tpu.align.aligner.index import minimizers, MinimizerIndex
from pav_tpu.align.table import check_table, finalize_align_table
from pav_tpu.call.cigar_calls import make_insdel_snv_calls
from pav_tpu.io.fasta import SeqStore

from helpers import Mutator, random_seq


def test_minimizers_basic():
    rng = np.random.default_rng(3)
    codes = random_seq(5000, rng)
    pos, h, strand = minimizers(codes, 19, 10)
    # Density ~ 2/(w+1); every w-window of k-mer starts contains a minimizer.
    assert len(pos) > 5000 * 2 / 11 * 0.5
    assert (np.diff(pos) > 0).all()
    assert (np.diff(pos) <= 10).all()
    # Reverse complement yields the same canonical hash set
    pos_rc, h_rc, _ = minimizers(seqcodec.revcomp(codes), 19, 10)
    assert set(h.tolist()) == set(h_rc.tolist())


def test_index_lookup():
    rng = np.random.default_rng(4)
    ref = SeqStore({'c1': random_seq(20000, rng), 'c2': random_seq(15000, rng)})
    idx = MinimizerIndex(ref, k=19, w=10)
    # Query with an exact slice of c2
    sub = ref.get('c2')[5000:6000]
    pos, h, strand = minimizers(sub, 19, 10)
    q_idx, t_chrom, t_pos, t_strand = idx.lookup(h, max_occ=16)
    assert len(q_idx) >= len(h) * 0.9
    on_c2 = t_chrom == 1
    assert on_c2.mean() > 0.9
    # Positions of true hits differ from query minimizer positions by 5000
    diffs = t_pos[on_c2] - pos[q_idx[on_c2]]
    vals, counts = np.unique(diffs, return_counts=True)
    assert vals[np.argmax(counts)] == 5000


def _run_aligner(ref, contigs, min_chain_score=200):
    ref_store = SeqStore({'chr1': ref})
    qry_store = SeqStore(contigs)
    aligner = Aligner(ref_store, {'aligner_min_chain_score': min_chain_score})
    df = aligner.align_store(qry_store, 'h1')
    check_table(df, qry_store.fai())
    return df, ref_store, qry_store


def test_align_exact_contig():
    rng = np.random.default_rng(21)
    ref = random_seq(50000, rng)
    contig = ref[10000:30000].copy()
    df, *_ = _run_aligner(ref, {'tig1': contig})
    assert df.shape[0] == 1
    row = df.iloc[0]
    assert not row['REV']
    # Exact contig: one = run (modulo tiny clipped ends), positions near truth
    assert abs(row['POS'] - 10000) < 50
    assert abs(row['END'] - 30000) < 50
    lens, ops = cg.parse(row['CIGAR'])
    body = ops[~np.isin(ops, [cg.H])]
    assert (body == cg.EQ).all()


def test_align_reverse_contig():
    rng = np.random.default_rng(22)
    ref = random_seq(50000, rng)
    contig = seqcodec.revcomp(ref[10000:30000])
    df, *_ = _run_aligner(ref, {'tig1': contig})
    assert df.shape[0] == 1
    row = df.iloc[0]
    assert row['REV']
    assert abs(row['POS'] - 10000) < 50
    assert abs(row['END'] - 30000) < 50


def test_align_with_variants_and_call():
    rng = np.random.default_rng(23)
    ref = random_seq(60000, rng)
    mut = Mutator(ref)
    mut.snv(5000, rng=rng)
    mut.ins(12000, random_seq(8, rng))
    mut.dele(20000, 12)
    mut.ins(30000, random_seq(250, rng))
    mut.dele(40000, 350)
    mut.snv(50000, rng=rng)
    contig = mut.finish()

    df, ref_store, qry_store = _run_aligner(ref, {'tig1': contig})
    assert df.shape[0] == 1, f'expected single alignment, got {df.shape[0]}'

    df_snv, df_insdel = make_insdel_snv_calls(df, ref_store, qry_store, 'h1')

    truth_snv = {t['pos'] for t in mut.truth if t['type'] == 'SNV'}
    called_snv = set(df_snv['POS'].tolist())
    assert truth_snv <= called_snv, f'missing SNVs: {truth_snv - called_snv}'
    assert len(called_snv - truth_snv) <= 2  # no spurious calls beyond edges

    for t in mut.truth:
        if t['type'] == 'INS':
            m = df_insdel.loc[(df_insdel['SVTYPE'] == 'INS') & (df_insdel['SVLEN'] == t['len'])]
            assert m.shape[0] == 1, f'INS len {t["len"]} not found once'
            assert abs(int(m.iloc[0]['POS']) - t['pos']) <= t['len'] + 50
        elif t['type'] == 'DEL':
            m = df_insdel.loc[(df_insdel['SVTYPE'] == 'DEL') & (df_insdel['SVLEN'] == t['len'])]
            assert m.shape[0] == 1, f'DEL len {t["len"]} not found once'


def test_align_split_contig_large_sv():
    # A 30kb deletion exceeds the chain gap limit -> two alignment records.
    rng = np.random.default_rng(24)
    ref = random_seq(100000, rng)
    contig = np.concatenate([ref[5000:35000], ref[65000:95000]])
    df, *_ = _run_aligner(ref, {'tig1': contig})
    assert df.shape[0] == 2
    df = df.sort_values('POS').reset_index(drop=True)
    assert abs(df.loc[0, 'END'] - 35000) < 50
    assert abs(df.loc[1, 'POS'] - 65000) < 50
    # Query coordinates must abut around the deletion
    assert abs(df.loc[0, 'QRY_END'] - df.loc[1, 'QRY_POS']) < 100


def test_align_two_contigs_batched():
    rng = np.random.default_rng(25)
    ref = random_seq(80000, rng)
    c1 = ref[1000:39000].copy()
    c1[500] = (c1[500] + 1) % 4
    c2 = seqcodec.revcomp(ref[41000:79000])
    df, *_ = _run_aligner(ref, {'a': c1, 'b': c2})
    assert df.shape[0] == 2
    assert set(df['QRY_ID']) == {'a', 'b'}
    fin = finalize_align_table(df)
    assert 'CALL_BATCH' in fin.columns and 'TRIM_REF_L' in fin.columns


def test_end_extension_divergent_tails():
    """SNV-dense contig tails have no minimizer anchors (every k-mer hits a
    mismatch) but must still be aligned via semi-global end extension."""
    rng = np.random.default_rng(31)
    ref = random_seq(60000, rng)
    contig = ref[10000:40000].copy()
    # ~6.7% divergence over the first and last 400 bp: no exact 19-mers.
    for i in range(5, 400, 15):
        contig[i] = (contig[i] + 1 + rng.integers(3)) % 4
        j = len(contig) - 1 - i
        contig[j] = (contig[j] + 1 + rng.integers(3)) % 4

    df, ref_store, qry_store = _run_aligner(ref, {'tig1': contig})
    assert df.shape[0] == 1
    row = df.iloc[0]
    # Tails aligned: clips (if any) are much smaller than the divergent region.
    assert row['QRY_POS'] < 40
    assert row['QRY_END'] > len(contig) - 40
    assert abs(row['POS'] - 10000) < 40
    assert abs(row['END'] - 40000) < 40

    # The tail SNVs are recoverable through the CIGAR caller.
    lens, ops = cg.parse(row['CIGAR'])
    assert int(lens[ops == cg.X].sum()) >= 40


def test_end_extension_reverse_strand():
    rng = np.random.default_rng(32)
    ref = random_seq(50000, rng)
    contig = seqcodec.revcomp(ref[10000:30000])
    for i in range(5, 300, 15):
        contig[i] = (contig[i] + 1 + rng.integers(3)) % 4

    df, *_ = _run_aligner(ref, {'tig1': contig})
    assert df.shape[0] == 1
    row = df.iloc[0]
    assert row['REV']
    assert row['QRY_POS'] < 30
    assert abs(row['END'] - 30000) < 30


def test_end_extension_rejects_foreign_tail():
    """A tail that is not homologous to the flanking reference must stay
    clipped (the best-prefix trim drops a non-aligning extension)."""
    rng = np.random.default_rng(33)
    ref = random_seq(50000, rng)
    foreign = random_seq(300, rng)
    contig = np.concatenate([foreign, ref[10000:30000]])

    df, *_ = _run_aligner(ref, {'tig1': contig})
    assert df.shape[0] == 1
    row = df.iloc[0]
    # The foreign prefix remains (mostly) clipped.
    assert row['QRY_POS'] > 250
    assert abs(row['POS'] - 10000) < 60


def test_accel_bucketing_transpose_equivalence(monkeypatch):
    """The accelerator path (coarse ladder classes + transposed DP for
    query-major segments, core._run_segments accel branch) produces the same
    alignment table as the CPU path on the same input. Global DP is symmetric
    under (q<->r, I<->D); ladder classes only widen bands/padding."""
    import jax

    rng = np.random.default_rng(33)
    ref = random_seq(400000, rng)
    mut = Mutator(ref)
    mut.snv(5000, rng=rng)
    mut.ins(40000, random_seq(800, rng))      # query-major segment
    mut.dele(80000, 700)                      # ref-major segment
    mut.ins(120000, random_seq(30, rng))
    mut.dele(160000, 25)
    mut.snv(200000, rng=rng)
    hap = mut.finish()
    store = SeqStore({'c1': hap})
    ref_store = SeqStore({'chr1': ref})

    df_cpu = Aligner(ref_store, {'aligner_min_chain_score': 500}).align_store(
        store, 'h1')

    # Force the accel branch (ladder bucketing, transposed DP, and the
    # device-resident gather path; DP still executes on the CPU backend).
    # Batch padding is capped so the padded accelerator batches stay cheap
    # enough for CPU execution.
    from pav_tpu.align.aligner import core as core_mod
    monkeypatch.setattr(jax, 'default_backend', lambda: 'fake-accel')
    monkeypatch.setattr(core_mod, '_shape_batch',
                        lambda m_b, w_b, n_b=None: 16)
    df_acc = Aligner(ref_store, {'aligner_min_chain_score': 500}).align_store(
        store, 'h1')

    pd.testing.assert_frame_equal(
        df_cpu.reset_index(drop=True), df_acc.reset_index(drop=True))
