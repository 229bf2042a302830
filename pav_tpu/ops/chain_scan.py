"""Anchor chaining as a compiled lax.scan (minimap2-style chain DP).

The chain score recurrence f[i] = max(k, max_j f[j] + match - gap_cost) has a
sequential dependency, so it runs as a jitted scan over anchors with a fixed
lookback window held in a rolling carry buffer — one fused device loop instead
of a Python-per-anchor walk. Grouping (chrom/strand) is enforced by masking on a
group-id channel, letting all groups run concatenated in a single scan.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

NEG = -1e18


@functools.partial(jax.jit, static_argnames=('lookback', 'k'))
def _chain_scan(qpos, rpos, group, lookback, k, max_dist, max_gap_diff, gap_scale):
    n = qpos.shape[0]

    def step(carry, x):
        q_buf, r_buf, f_buf, g_buf, i_buf = carry
        q, r, g, idx = x

        dq = q - q_buf
        dr = r - r_buf
        dd = jnp.abs(dr - dq)
        match = jnp.minimum(jnp.minimum(dq, dr), k).astype(jnp.float32)
        # Integer log2 via float-exponent extraction: bit-exact with the
        # native kernel (native/chain.cpp ilog2_via_float) on every backend —
        # int->float conversion is round-to-nearest in both. ilog2(1) = 0, so
        # dd == 0 costs 0 without a special case. (minimap2-style gamma.)
        fdd1 = (dd + 1).astype(jnp.float32)
        ilog = (jax.lax.bitcast_convert_type(fdd1, jnp.int32) >> 23) - 127
        gap_cost = (gap_scale * dd.astype(jnp.float32)
                    + 0.5 * ilog.astype(jnp.float32))

        ok = ((g_buf == g) & (dq > 0) & (dr > 0)
              & (dq <= max_dist) & (dr <= max_dist) & (dd <= max_gap_diff))
        cand = jnp.where(ok, f_buf + match - gap_cost, NEG)

        best = jnp.argmax(cand)
        best_score = cand[best]
        use = best_score > k  # extending must beat starting fresh
        f = jnp.where(use, best_score, float(k))
        parent = jnp.where(use, i_buf[best], -1)

        # Roll buffers, appending this anchor.
        q_buf = jnp.concatenate([q_buf[1:], q[None]])
        r_buf = jnp.concatenate([r_buf[1:], r[None]])
        f_buf = jnp.concatenate([f_buf[1:], f[None]])
        g_buf = jnp.concatenate([g_buf[1:], g[None]])
        i_buf = jnp.concatenate([i_buf[1:], idx[None]])

        return (q_buf, r_buf, f_buf, g_buf, i_buf), (f, parent)

    init = (
        jnp.zeros(lookback, dtype=jnp.int32),
        jnp.zeros(lookback, dtype=jnp.int32),
        jnp.full(lookback, NEG, dtype=jnp.float32),
        jnp.full(lookback, -1, dtype=jnp.int32),
        jnp.full(lookback, -1, dtype=jnp.int32),
    )
    xs = (qpos, rpos, group, jnp.arange(n, dtype=jnp.int32))
    _, (f, parent) = jax.lax.scan(step, init, xs)
    return f, parent


@functools.partial(jax.jit, static_argnames=('lookback', 'k'))
def _chain_scan_batch(qpos, rpos, group, lookback, k, max_dist, max_gap_diff,
                      gap_scale):
    """vmapped _chain_scan over a [B, n] slab batch. Slabs are independent
    chain subproblems (split at group changes / rpos gaps — see
    align.aligner.chain.find_chains), so a batch sharded along B over a
    device mesh partitions with no collectives: the multi-chip variant of
    chain scoring (the host-native kernel remains the single-host path)."""
    fn = functools.partial(_chain_scan, lookback=lookback, k=k,
                           max_dist=max_dist, max_gap_diff=max_gap_diff,
                           gap_scale=gap_scale)
    return jax.vmap(fn)(qpos, rpos, group)


def chain_scores_batch(slabs, k, lookback=64, max_dist=50000,
                       max_gap_diff=10000, gap_scale=None, mesh=None):
    """Chain DP over a list of (qpos, rpos, group) slabs in one device call.

    :param slabs: list of (qpos, rpos, group) array triples.
    :param mesh: optional jax.sharding.Mesh; the slab batch shards along its
        leading axis (pav_tpu.parallel.mesh data parallelism).
    :return: list of (scores float32, parents int64) per slab, parents local
        to the slab (-1 = chain start), identical to per-slab chain_scores.
    """
    if gap_scale is None:
        gap_scale = 0.01 * k
    if not slabs:
        return []
    lens = [len(s[0]) for s in slabs]
    n_pad = 1
    while n_pad < max(lens):
        n_pad <<= 1
    B = len(slabs)
    qp = np.zeros((B, n_pad), dtype=np.int32)
    rp = np.zeros((B, n_pad), dtype=np.int32)
    gp = np.full((B, n_pad), -9, dtype=np.int32)
    for i, (q, r, g) in enumerate(slabs):
        qp[i, :lens[i]] = q
        rp[i, :lens[i]] = r
        gp[i, :lens[i]] = g

    if mesh is not None and B % mesh.size == 0:
        from jax.sharding import NamedSharding, PartitionSpec as P
        shard = NamedSharding(mesh, P(mesh.axis_names[0]))
        put = lambda a: jax.device_put(jnp.asarray(a), shard)
    else:
        put = jnp.asarray
    f, parent = _chain_scan_batch(
        put(qp), put(rp), put(gp), int(lookback), int(k),
        float(max_dist), float(max_gap_diff), float(gap_scale))
    f_np, p_np = np.asarray(f), np.asarray(parent)
    return [(f_np[i, :lens[i]], p_np[i, :lens[i]].astype(np.int64))
            for i in range(B)]


def chain_scores(qpos, rpos, group, k, lookback=64, max_dist=50000,
                 max_gap_diff=10000, gap_scale=None):
    """Compute chain DP scores and parent pointers for sorted anchors.

    :param qpos: int64 query positions (strand-transformed, ascending within
        each (group, rpos) sort).
    :param rpos: int64 reference positions.
    :param group: int64 group ids (chrom x strand); chaining never crosses groups.
    :param k: anchor (k-mer) length.

    :return: (scores float32, parents int64) numpy arrays; parent -1 = chain start.
    """
    if gap_scale is None:
        gap_scale = 0.01 * k
    n = len(qpos)
    if n == 0:
        return np.zeros(0, dtype=np.float32), np.zeros(0, dtype=np.int64)

    # The recurrence is sequential and irregular — the native host kernel is
    # the primary path (pav_tpu/native.py, native/chain.cpp); the jitted scan
    # below is the fallback and the device-resident variant.
    from .. import native
    res = native.chain_dp(qpos, rpos, group, k, lookback,
                          max_dist, max_gap_diff, gap_scale)
    if res is not None:
        return res

    # Pad to a power-of-two scan length so XLA compiles once per bucket, not
    # once per contig. Padding anchors carry group -9 and can never chain.
    n_pad = 1
    while n_pad < n:
        n_pad <<= 1
    qpos_p = np.zeros(n_pad, dtype=np.int32)
    rpos_p = np.zeros(n_pad, dtype=np.int32)
    group_p = np.full(n_pad, -9, dtype=np.int32)
    qpos_p[:n] = qpos
    rpos_p[:n] = rpos
    group_p[:n] = group

    f, parent = _chain_scan(
        jnp.asarray(qpos_p), jnp.asarray(rpos_p), jnp.asarray(group_p),
        int(lookback), int(k),
        float(max_dist), float(max_gap_diff), float(gap_scale))
    return np.asarray(f)[:n], np.asarray(parent)[:n]
