"""The batched read-classification device pipeline — the hot path.

Reference equivalent: core match/FastqKMerMatcher.java:327-535 (matchRead),
a scalar per-read rolling loop with striped-lock shared accumulators. The
redesign processes a [B, L] batch of packed reads as pure array ops:

 1. window k-mers: genestrip_tpu.ops.kmer.window_kmers (k shifted ORs).
 2. lookup: vectorized binary search -> per-window label
      label[s] = node index of the hit, -1 = miss, -2 = INVALID window
      (contains a non-CGAT base), -3 = beyond the read.
    This matches the reference exactly because its bad-base skipping labels
    precisely the windows containing a bad base as INVALID (see
    FastqKMerMatcher.java:345-363,415-417 — every skipped window covers the
    bad base, and run lengths merge across consecutive bad regions).
 3. contig stats: run-length segmentation of labels (boundaries where the
    label changes), per-node scatter-adds replacing the reference's
    per-contig locked updates (:390-420,452-473).
 4. classification (ref :474-535):
      - the candidate-path set of mergeReadTaxidPath (:568-586) equals the
        set of *maximal* distinct hit nodes (no other hit node strictly below
        them) whenever at most maxPaths chains arise; computed via one sort
        of (label, window) per read + the pre-order/Euler-interval property
        that a node's descendants directly follow it in index order.
        When more than maxPaths maximal nodes occur the reference's
        insertion-order capping applies; we cap by first-occurrence order
        (equivalent except for exotic interleavings; >10 distinct maximal
        taxa in one read does not occur in practice).
      - sumCounts (SmallTaxTree.java:184-193) = number of hit windows whose
        node is an ancestor-or-equal of the candidate — a [B, P, W] masked
        count, no per-node vote counters needed.
      - the winner is the first candidate achieving the maximal path sum and
        the classification is the LCA of *all* candidates achieving it —
        identical to the reference's first-best + ties fold (:474-497).
      - read tax error: the reference's running threshold abort (:371-379)
        is sticky and only gates the final classification, so it equals a
        closed-form test on the total miss+invalid window count.
 5. unique counting: scatter into a per-store-position seen/count vector
    (ref: KMerUniqueCounterBits.putInlined:117-143 — the lock-striped bit
    set becomes a scatter-max; positions are sorted-table ranks).

 6. threshold promotion (minKMersForClass > 1, ref :487-507 +
    SmallTaxTree.lowestNodeWhereSumAboveThreshold:208-221): each tie
    candidate is promoted to its deepest ancestor a where the number of hit
    windows whose node lies on the candidate..a path segment reaches the
    threshold (null if the candidate's whole root path stays below it); the
    classification is the LCA of the promoted nodes with null propagation,
    and readKmers is recomputed as the path sum of the promoted first-best
    candidate. Vectorized via a per-(read, candidate) histogram of hit
    counts over ancestor depth + suffix sums.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from genestrip_tpu.ops.kmer import window_kmers
from genestrip_tpu.ops.scan import assoc_scan_1d
from genestrip_tpu.store.hash import (
    BUCKET, build_hash, lookup_hash, lookup_join,
)

# flattened query count at or above which the scatter-join lookup is used
# instead of the two-gather path (the join's fixed costs — sorts, scratch,
# dense bucket pass — amortize over the batch). The crossover on the GPU is
# not yet measured (ROADMAP A3).
_JOIN_MIN_Q = 1 << 16


def _attach_aux(vaux, idx, n_planes: int):
    """Gather-free small-table row attach: planes[c][q] = vaux[idx[q], c].

    Replaces a [Q, 4] row-gather with a sort + V-sized scatter + run
    broadcast: sort queries by idx, scatter each distinct idx's first
    position into a V-sized scratch, scatter the table values back to those
    positions, broadcast along equal-idx runs, unsort. Exact for any idx in
    [0, V). Which of the two is cheaper on the GPU is not yet measured
    (ROADMAP A4).
    """
    Q = idx.shape[0]
    V = vaux.shape[0]
    qid = jax.lax.broadcasted_iota(jnp.int32, (Q, 1), 0).reshape(-1)
    vbits = max(int(np.ceil(np.log2(V + 1))), 1)
    qbits = max(int(np.ceil(np.log2(Q + 1))), 1)
    if vbits + qbits <= 31:
        # single-operand sort: the packed key orders by (idx, qid) exactly,
        # and one operand is less for XLA's sort to move than two
        s_p = jax.lax.sort((idx << qbits) | qid)
        s_i = s_p >> qbits
        s_q = s_p & ((1 << qbits) - 1)
    else:
        s_i, s_q = jax.lax.sort((idx, qid), num_keys=1)
    pos = qid                      # iota again (same shape)
    prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32), s_i[:-1]])
    new = s_i != prev
    first_pos = jnp.full(V + 1, Q, jnp.int32).at[
        jnp.where(new, s_i, V)].set(pos)
    run_id = jnp.where(new, pos, -1)

    def comb(a, b):
        keep = b[0] >= 0
        return (jnp.where(keep, b[0], a[0]), jnp.where(keep, b[1], a[1]))

    planes = []
    for c in range(n_planes):
        r = jnp.zeros(Q + 1, jnp.int32).at[first_pos[:V]].set(vaux[:V, c])
        vals = assoc_scan_1d(comb, (run_id, r[:Q]),
                             (jnp.int32(-1), jnp.int32(0)))[1]
        planes.append(jnp.zeros(Q, jnp.int32).at[s_q].set(vals))
    return planes

LABEL_MISS = -1
LABEL_INVALID = -2
LABEL_NONE = -3


@dataclass(frozen=True)
class MatchConfig:
    k: int
    max_paths: int = 10
    classify: bool = True
    with_unique: bool = True
    with_counts: bool = False
    max_read_tax_error: float = -1.0     # ref GSConfigKey maxReadTaxErrorCount
    max_read_class_error: float = -1.0   # ref maxReadClassErrorCount
    threshold: int = 1                   # ref minKMersForClass
    # label matrix is only needed for kraken-style output; it is a [B, W]
    # transfer per batch, so default off (Matcher enables it on demand)
    return_labels: bool = False


@dataclass(frozen=True)
class TableSpec:
    """Static lookup geometry of the quotient hash (store/hash.py):
    n = slot count (the unique-counter position space), nb_bits = log2 of
    the bucket count."""

    n: int
    nb_bits: int


def vaux_from_nov(nov: np.ndarray, tree) -> np.ndarray:
    """The small [n_values + 1, 4] value-indexed aux table of
    (node, tout(node), depth(node), pad) with a trailing miss row — shared
    by build_match_arrays and the benchmark's cached-world loader so both
    always measure the production layout."""
    nv = len(nov)
    safe = np.maximum(nov, 0)
    vaux = np.zeros((nv + 1, 4), np.int32)
    vaux[:nv, 0] = nov
    vaux[:nv, 1] = np.where(nov >= 0, tree.tout[safe], 0)
    vaux[:nv, 2] = np.where(nov >= 0, tree.depth[safe], 0)
    vaux[nv] = (-1, 0, 0, 0)   # miss row
    return vaux


def build_match_arrays(table, tree, ht=None):
    """Device lookup arrays for matching + their TableSpec.

    Returns ({rows, vaux, vidx_of_slot}, spec): `rows` is the quotient-hash
    bucket table ([NB, 8] i32, two row-gathers per lookup — see
    store/hash.py); `vaux` is a small [n_values + 1, 4] value-indexed table
    of (node, tout(node), depth(node), pad) gathered once per hit to attach
    the taxonomy data (the value table is tiny, so this gather is cheap —
    unlike per-entry fused planes, which would widen the hot hash rows 3x).
    vidx_of_slot maps unique-counter slots back to values for host-side
    aggregation (ref KMerUniqueCounterBits.getUniqueKmerCounts).

    ht: optional prebuilt KmerHashTable (e.g. persisted in the db zip,
    store/database.py) — skips the hash build."""
    if ht is None:
        ht = build_hash(table.keys, table.value_idx)
    nov = tree.node_of_value(table).astype(np.int32)
    vaux = vaux_from_nov(nov, tree)
    import jax.numpy as jnp
    sa = {"rows": jnp.asarray(ht.rows), "vaux": jnp.asarray(vaux),
          "vidx_of_slot": ht.vidx_of_slot, "n": ht.n_slots,
          "nb_bits": ht.nb_bits}
    return sa, TableSpec(ht.n_slots, ht.nb_bits)


def _lca_pair(anc, a, b):
    """Vectorized LCA of index vectors a, b (assumed >= 0) via ancestor table."""
    aa = anc[a]
    ab = anc[b]
    match = (aa == ab) & (aa >= 0)
    d = jnp.sum(match.astype(jnp.int32), axis=-1) - 1
    return jnp.where(d >= 0, jnp.take_along_axis(aa, jnp.maximum(d, 0)[..., None], axis=-1)[..., 0], -1)


def error_bounds(lengths: np.ndarray, k: int, cfg: MatchConfig) -> np.ndarray:
    """Per-read integer error bounds, precomputed on the host in float64.

    Keeps the reference's Java-double threshold semantics without any
    64-bit math on device: a read tax-fails iff tax_err >= bounds[:, 0]
    (err > A or err > A*n_win, ref FastqKMerMatcher.java:371-379), and its
    per-tax stats count iff class_err <= bounds[:, 1] (ref :508-510).
    Disabled thresholds map to never/always via INT32_MAX.
    """
    big = np.int64(2**31 - 1)
    n = len(lengths)
    n_win = np.maximum(lengths.astype(np.int64) - (k - 1), 0).astype(np.float64)
    A = cfg.max_read_tax_error
    if A < 0:
        tb = np.full(n, big)
    elif A >= 1:
        tb = np.full(n, np.int64(np.floor(A)) + 1)
    else:
        tb = np.floor(A * n_win).astype(np.int64) + 1
    Bc = cfg.max_read_class_error
    if Bc < 0:
        cb = np.full(n, big)
    elif Bc >= 1:
        cb = np.floor(np.maximum(Bc, Bc * n_win)).astype(np.int64)
    else:
        cb = np.floor(Bc * n_win).astype(np.int64)
    return np.stack([np.minimum(tb, big), np.minimum(cb, big)],
                    axis=1).astype(np.int32)


@functools.partial(jax.jit,
                   static_argnames=("cfg", "spec", "n_nodes", "db_axis"),
                   donate_argnames=("seen", "counts"))
def match_step(cfg: MatchConfig, spec: TableSpec, n_nodes: int,
               rows, vaux, anc,
               codes, lengths, err_bounds, seen, counts,
               db_axis: str | None = None):
    """One batch of reads against the table. Returns per-read and per-node stats.

    rows is the quotient-hash bucket table (two [NB,8] row gathers per
    lookup, store/hash.py); vaux is the small [n_values+1, 4] value table of
    (node, tout(node), depth(node), pad) — one cheap row gather attaches the
    per-window taxonomy data. seen/counts are donated unique-counter state
    ([n_slots+1] uint8/int32; last slot is a dummy scatter target).
    """
    B, L = codes.shape
    T = n_nodes
    n_table = spec.n
    k = cfg.k
    hi, lo, clean, exists = window_kmers(codes, lengths, k)
    W = L - k + 1

    if db_axis is not None:
        # sharded-DB lookup (SURVEY §5.8): queries all-gathered over the
        # mesh axis, each shard joins its bucket range of the table, shard
        # partials psum-merged inside lookup_join; this shard keeps its own
        # read-slice of the merged results. Table memory scales 1/n_dev.
        q_loc = B * W
        hi_g = jax.lax.all_gather(hi.reshape(-1), db_axis, tiled=True)
        lo_g = jax.lax.all_gather(lo.reshape(-1), db_axis, tiled=True)
        pos_g, fnd_g, vid_g = lookup_join(rows, hi_g, lo_g,
                                          nb_bits=spec.nb_bits, axis=db_axis)
        i0 = jax.lax.axis_index(db_axis) * q_loc
        pos = jax.lax.dynamic_slice(pos_g, (i0,), (q_loc,)).reshape(B, W)
        found_win = jax.lax.dynamic_slice(fnd_g, (i0,), (q_loc,)).reshape(B, W)
        vidx = jax.lax.dynamic_slice(vid_g, (i0,), (q_loc,)).reshape(B, W)
    else:
        lk = lookup_join if B * W >= _JOIN_MIN_Q else lookup_hash
        pos, found_win, vidx = lk(rows, hi, lo, nb_bits=spec.nb_bits)
    valid = clean & exists
    hit0 = valid & found_win
    nv = vaux.shape[0] - 1
    # attach (node, tout, depth) from the small value table without a
    # per-window gather (see _attach_aux); depth is only consumed by the
    # threshold-promotion path
    n_planes = 3 if (cfg.classify and cfg.threshold > 1) else 2
    aux = _attach_aux(vaux, jnp.where(hit0, vidx, nv).reshape(-1), n_planes)
    node = jnp.where(hit0, aux[0].reshape(B, W), -1)
    hit = hit0 & (node >= 0)
    tout_lab = jnp.where(hit, aux[1].reshape(B, W), 0)
    depth_lab = (jnp.where(hit, aux[2].reshape(B, W), anc.shape[1])
                 if n_planes > 2 else jnp.full((B, W), anc.shape[1], jnp.int32))
    label = jnp.where(exists,
                      jnp.where(clean, jnp.where(hit, node, LABEL_MISS), LABEL_INVALID),
                      LABEL_NONE)

    n_win = jnp.maximum(lengths - (k - 1), 0)          # per-read window count ("max")
    found = jnp.any(hit, axis=1)

    # ---- unique counting (by storage position) ----------------------------
    if cfg.with_unique:
        upos = jnp.where(hit, pos, n_table).reshape(-1)
        seen = seen.at[upos].max(jnp.uint8(1))
        if cfg.with_counts:
            counts = counts.at[upos].add(1)

    # ---- contig segmentation ----------------------------------------------
    s_idx = jax.lax.broadcasted_iota(jnp.int32, (B, W), 1)
    prev = jnp.concatenate([jnp.full((B, 1), LABEL_NONE, label.dtype), label[:, :-1]], axis=1)
    nxt = jnp.concatenate([label[:, 1:], jnp.full((B, 1), LABEL_NONE, label.dtype)], axis=1)
    boundary = exists & (label != prev)
    is_end = exists & (label != nxt)
    run_start = jax.lax.associative_scan(jnp.maximum, jnp.where(boundary, s_idx, -1), axis=1)
    clen = s_idx - run_start + 1

    end_hit = is_end & hit
    tnode = jnp.where(end_hit, label, T).reshape(-1)
    clen_f = jnp.where(end_hit, clen, 0).reshape(-1)
    zT = jnp.zeros(T + 1, jnp.int32)
    # NOTE: scalar scatters, one per statistic, rather than one fused
    # [.., 3]-row scatter (not yet compared on the GPU).
    contigs = zT.at[tnode].add(jnp.where(end_hit, 1, 0).reshape(-1))[:T]
    kmers = zT.at[tnode].add(clen_f)[:T]
    # Per-batch sum of clen^2 is bounded by B*W*W per node. Exact in pure
    # int32 by splitting the batch into G row-groups with Bg*W^2 < 2^30 and
    # returning [G, T] partial sums — the host accumulates in int64 (the
    # mesh path stacks groups across shards instead of psum-ing, for the
    # same no-overflow guarantee). G == 1 for ordinary read lengths.
    G = max(1, -(-(B * W * W) // (1 << 30)))
    Bg = -(-B // G)
    sq_val = clen_f * clen_f
    if G == 1:
        contig_sq = zT.at[tnode].add(sq_val)[None, :T]
    else:
        grp = (jax.lax.broadcasted_iota(jnp.int32, (B, W), 0) // Bg).reshape(-1)
        tgt_sq = grp * (T + 1) + tnode
        contig_sq = jnp.zeros(G * (T + 1), jnp.int32).at[tgt_sq].add(
            sq_val).reshape(G, T + 1)[:, :T]
    # max contig + first achiever in ONE scatter-min of a composite
    # ((W - clen) in the high bits, encoded (read, window) below): the min
    # composite per node IS (max clen, smallest enc) — replacing the
    # reference's two-pass max + argmax and its extra [B, W] gather.
    enc_bits = max(int(np.ceil(np.log2(B * W))), 1)
    if enc_bits + int(np.ceil(np.log2(W + 2))) <= 31:
        enc = (s_idx + W * jax.lax.broadcasted_iota(jnp.int32, (B, W), 0)).reshape(-1)
        comp_mc = jnp.where(end_hit.reshape(-1),
                            ((W - clen.reshape(-1)) << enc_bits) | enc,
                            jnp.iinfo(jnp.int32).max)
        mc = jnp.full(T + 1, jnp.iinfo(jnp.int32).max, jnp.int32).at[
            tnode].min(comp_mc)[:T]
        has_mc = mc != jnp.iinfo(jnp.int32).max
        max_contig = jnp.where(has_mc, W - (mc >> enc_bits), 0)
        argmax_enc = jnp.where(has_mc, mc & ((1 << enc_bits) - 1),
                               jnp.iinfo(jnp.int32).max)
    else:
        max_contig = zT.at[tnode].max(clen_f)[:T]
        is_max = end_hit & (clen == max_contig[jnp.minimum(label, T - 1)]) & (max_contig[jnp.minimum(label, T - 1)] > 0)
        enc = jnp.where(is_max, s_idx + W * jax.lax.broadcasted_iota(jnp.int32, (B, W), 0),
                        jnp.iinfo(jnp.int32).max)
        argmax_enc = jnp.full(T + 1, jnp.iinfo(jnp.int32).max, jnp.int32).at[
            jnp.where(is_max, label, T).reshape(-1)].min(enc.reshape(-1))[:T]

    # ---- per-read distinct nodes: 2-key int32 sort of (label, s) -----------
    # Non-hit windows are pushed to the row end via INT32_MAX keys; tout and
    # depth of each window's node ride along as payload so no node-indexed
    # gathers are needed afterwards. All 32-bit (no 64-bit emulation).
    BIG = jnp.iinfo(jnp.int32).max
    node_key = jnp.where(hit, node, BIG)
    s_key, s_first, s_tout, s_depth = jax.lax.sort(
        (node_key, s_idx, jnp.where(hit, tout_lab, BIG), depth_lab),
        dimension=1, num_keys=2)
    s_node = jnp.where(s_key != BIG, s_key, -1)
    sp = jnp.concatenate([jnp.full((B, 1), -9, jnp.int32), s_node[:, :-1]], axis=1)
    sn = jnp.concatenate([s_node[:, 1:], jnp.full((B, 1), -9, jnp.int32)], axis=1)
    run_start_m = (s_node >= 0) & (s_node != sp)      # first window of each distinct node
    run_end_m = (s_node >= 0) & (s_node != sn)

    # reads >= 1 kmer per node (ref :434-439): one per (read, node)
    reads1 = zT.at[jnp.where(run_start_m, s_node, T).reshape(-1)].add(
        jnp.where(run_start_m, 1, 0).reshape(-1))[:T]

    out = {
        "found": found,
        "n_win": n_win,
        "contigs": contigs,
        "kmers": kmers,
        "contig_sq": contig_sq,
        "max_contig": max_contig,
        "argmax_enc": argmax_enc,
        "reads1": reads1,
        "seen": seen,
        "counts": counts,
    }
    if cfg.return_labels:
        out["label"] = label

    if not cfg.classify:
        out["class_node"] = jnp.full((B,), -1, jnp.int32)
        out["read_kmers"] = jnp.zeros((B,), jnp.int32)
        out["tax_err"] = jnp.zeros((B,), jnp.int32)
        out["stats_ok"] = jnp.zeros((B,), bool)
        return out

    # ---- candidate paths: maximal distinct hit nodes -----------------------
    # Node indices are pre-order positions, so a node's descendants directly
    # follow it: the run's successor in sorted order is its smallest-tin
    # descendant candidate. Non-maximal iff that successor is inside tout.
    succ = jnp.where(sn >= 0, sn, BIG)
    non_max = run_end_m & (succ < s_tout)
    # A run's first occurrence s sits at its start (within equal labels the
    # 2-key sort orders by s). Propagate it to the run end with a running
    # max over run-start (node, s) composites: node indices strictly ascend
    # across a row's runs, so the latest run start always holds the row max.
    Wp = 1 << max(int(np.ceil(np.log2(W + 1))), 1)
    if T * Wp < 2**31:
        start_comp = jnp.where(run_start_m, s_node * Wp + s_first, -1)
        run_first = jax.lax.associative_scan(
            jnp.maximum, start_comp, axis=1) & (Wp - 1)
    else:
        rs_idx = jax.lax.associative_scan(
            jnp.maximum, jnp.where(run_start_m, s_idx, 0), axis=1)
        run_first = jnp.take_along_axis(s_first, rs_idx, axis=1)
    cand_mask = run_end_m & ~non_max
    # first-occurrence-order cap to max_paths (ref mergeReadTaxidPath): sort
    # candidates by (first window, node); the run-end sorted-row position e
    # rides along — it IS the label rank query (#(label <= cand) = e + 1),
    # so no binary search is needed for cnt_label.
    c1, c2, c3 = jax.lax.sort(
        (jnp.where(cand_mask, run_first, BIG),
         jnp.where(cand_mask, s_node, BIG),
         s_idx), dimension=1, num_keys=2)
    cand = jnp.where(c1[:, : cfg.max_paths] != BIG, c2[:, : cfg.max_paths], -1)
    cnt_label = jnp.where(cand >= 0, c3[:, : cfg.max_paths] + 1, 0)

    # ---- path sums (ref sumCounts): hits whose node is ancestor-or-eq ------
    # A hit window with node a contributes to candidate c iff a <= c < tout(a)
    # (pre-order/Euler containment), so
    #   sum(c) = #(label <= c) - #(tout(label) <= c).
    # #(label <= c) fell out of the candidate sort above. #(tout <= c) comes
    # from ONE merged row-sort of the window touts and the candidates
    # (encoded 2*tout vs 2*cand+1 so equal values order tout-first): at a
    # candidate's merged position, the number of non-candidate entries before
    # it is exactly its tout rank. No gathers — sorts and scans only.
    P = cfg.max_paths
    m_key = jnp.concatenate(
        [jnp.where(hit, tout_lab * 2, BIG),
         jnp.where(cand >= 0, cand * 2 + 1, BIG - 1)], axis=1)
    m_pay = jnp.concatenate(
        [jnp.full((B, W), -1, jnp.int32),
         jax.lax.broadcasted_iota(jnp.int32, (B, P), 1)], axis=1)
    mk, mp = jax.lax.sort((m_key, m_pay), dimension=1, num_keys=1)
    is_c = mp >= 0
    cs = jnp.cumsum(is_c.astype(jnp.int32), axis=1)
    mpos = jax.lax.broadcasted_iota(jnp.int32, (B, W + P), 1)
    rank_t = mpos - (cs - 1)           # touts before this candidate entry
    row_off = jax.lax.broadcasted_iota(jnp.int32, (B, W + P), 0) * P
    tgt_c = jnp.where(is_c, row_off + mp, B * P).reshape(-1)
    cnt_tout = jnp.zeros(B * P + 1, jnp.int32).at[tgt_c].set(
        rank_t.reshape(-1))[: B * P].reshape(B, P)
    sums = jnp.where(cand >= 0, cnt_label - cnt_tout, 0)

    best = jnp.max(sums, axis=1)
    has_cand = jnp.any(cand >= 0, axis=1)

    # ---- read tax error (closed form of the sticky abort) ------------------
    # The reference increments readTaxErrorCount once per *loop iteration*
    # hitting a miss or a bad base (:371-379) — a bad-base skip covers many
    # INVALID windows with a single increment. Each bad base gets exactly one
    # iteration, except bad bases following another bad base at position
    # >= max-1 (the scan has already left the window range by then):
    #   tax_err = #miss windows + #bad bases at pos <= max-2
    #             + (1 if any bad base at pos in [max-1, len))
    n_miss = jnp.sum((label == LABEL_MISS).astype(jnp.int32), axis=1)
    col = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    bad_b = (codes > 3) & (col < lengths[:, None])
    early = jnp.sum((bad_b & (col <= (n_win - 2)[:, None])).astype(jnp.int32), axis=1)
    late = jnp.any(bad_b & (col >= (n_win - 1)[:, None]), axis=1).astype(jnp.int32)
    tax_err = n_miss + early + late
    # host-precomputed integer bound (error_bounds) — no float64 on device
    tax_failed = tax_err >= err_bounds[:, 0]

    # ---- winner: LCA of all candidates achieving the best sum --------------
    is_best = (sums == best[:, None]) & (cand >= 0) & (best[:, None] > 0)

    if cfg.threshold > 1:
        # threshold promotion (ref :487-492 + lowestNodeWhereSumAboveThreshold)
        D = anc.shape[1]
        w_idx2 = jax.lax.broadcasted_iota(jnp.int32, (B, W), 1)
        rs_idx = jax.lax.associative_scan(
            jnp.maximum, jnp.where(run_start_m, w_idx2, -1), axis=1)
        run_cnt = jnp.where(run_end_m, w_idx2 - rs_idx + 1, 0)
        # hit labels that are ancestor-or-equal of each candidate
        sn_e = s_node[:, None, :]
        tout_sn = s_tout[:, None, :]
        c_e2 = cand[:, :, None]
        anc_ok = (sn_e >= 0) & (c_e2 >= 0) & (sn_e <= c_e2) & (c_e2 < tout_sn)
        d_lab = jnp.where(run_end_m & (s_node >= 0), s_depth, D)
        # hist[b,p,d] = hit windows on candidate p's root path at depth d —
        # an integer scatter-add over [B, P, W] run contributions (the former
        # [B, W, D] one-hot einsum materialized B*W*D floats and OOMed at
        # bench shapes)
        bp_off = (jax.lax.broadcasted_iota(jnp.int32, (B, cfg.max_paths, W), 0)
                  * cfg.max_paths
                  + jax.lax.broadcasted_iota(jnp.int32, (B, cfg.max_paths, W), 1))
        tgt_h = jnp.where(anc_ok & (d_lab[:, None, :] < D),
                          bp_off * D + d_lab[:, None, :],
                          B * cfg.max_paths * D).reshape(-1)
        hist = jnp.zeros(B * cfg.max_paths * D + 1, jnp.int32).at[tgt_h].add(
            jnp.broadcast_to(run_cnt[:, None, :],
                             (B, cfg.max_paths, W)).reshape(-1))[
            : B * cfg.max_paths * D].reshape(B, cfg.max_paths, D)
        # suffix[b,p,j] = running sum of the walk candidate -> depth-j ancestor
        suffix = jnp.cumsum(hist[:, :, ::-1], axis=2)[:, :, ::-1]
        suffix_pad = jnp.concatenate(
            [suffix, jnp.zeros((B, cfg.max_paths, 1), jnp.int32)], axis=2)
        # deepest ancestor where the running sum reaches the threshold
        promo_depth = jnp.sum(suffix >= cfg.threshold, axis=2) - 1
        promoted = jnp.where(
            (cand >= 0) & (promo_depth >= 0),
            anc[jnp.maximum(cand, 0), jnp.maximum(promo_depth, 0)], -1)
        # sumCounts(promoted) for the stale-count recompute (ref :503-507)
        sum_at_promo = suffix_pad[:, :, 0] - jnp.take_along_axis(
            suffix_pad, jnp.maximum(promo_depth, 0)[:, :, None] + 1,
            axis=2)[:, :, 0]
        fold_nodes = promoted
    else:
        fold_nodes = cand

    # LCA of the selected set in ONE pair-LCA: with pre-order indices and
    # Euler intervals, LCA(set) = LCA(min, max) — the interval of LCA(min,
    # max) contains every index in [min, max], and any common ancestor of
    # the set is an ancestor of both extremes. Replaces the former
    # max_paths-step sequential fold (2 ancestor-row gathers per step).
    sel_nodes = jnp.where(is_best & (fold_nodes >= 0), fold_nodes, BIG)
    mn = jnp.min(sel_nodes, axis=1)
    mx = jnp.max(jnp.where(is_best & (fold_nodes >= 0), fold_nodes, -1), axis=1)
    any_null = jnp.any(is_best & (fold_nodes < 0), axis=1)
    pair = _lca_pair(anc, jnp.maximum(jnp.where(mn == BIG, 0, mn), 0),
                     jnp.maximum(mx, 0))
    acc = jnp.where(mx >= 0, jnp.where(mn == mx, mx, pair), -1)

    classified = found & ~tax_failed & has_cand & ~any_null
    class_node = jnp.where(classified, acc, -1)
    # A null class node (threshold promotion exhausted every tie's root path)
    # makes matchRead return false — the read is dropped from the filtered
    # fastq too (ref :497-499). Tax-error-aborted reads still return found.
    out["found"] = found & (tax_failed | ~any_null)
    if cfg.threshold > 1:
        first_best = jnp.argmax(is_best, axis=1)
        rk = jnp.take_along_axis(sum_at_promo, first_best[:, None], axis=1)[:, 0]
        read_kmers = jnp.where(classified, rk, 0)
    else:
        read_kmers = jnp.where(classified, best, 0)

    # ---- class error check (gates per-tax stats only, ref :508-510) --------
    class_err_c = n_win - read_kmers
    stats_ok = (class_err_c <= err_bounds[:, 1]) & (class_node >= 0)

    out["class_node"] = class_node
    out["read_kmers"] = read_kmers
    out["tax_err"] = tax_err
    out["stats_ok"] = stats_ok
    return out


# ---------------------------------------------------------------------------
# accumulating step — ONE device->host transfer per batch
# ---------------------------------------------------------------------------
#
# Pulling the raw match_step output dict costs ~12 separate device->host
# transfers per batch, i.e. 12 transfer latencies. The accumulating step
# keeps every per-NODE statistic in donated device state (drained every few
# batches; the drain interval bounds int32 overflow of the contig^2 sums)
# and packs the per-READ results into one int32 word
# per read (or a [B, 3] wide layout for long reads — see per_read_layout).
# Per-read float error accumulation stays on the host in read order, which
# preserves the reference's exact double-sum semantics
# (ref CountsPerTaxid/ResultReporter formatting).

def node_state_init(n_nodes: int):
    """Initial per-node accumulator state (one leading [T] vector each)."""
    import jax.numpy as jnp
    T = n_nodes
    return {
        "kmers": jnp.zeros(T, jnp.int32),
        "contigs": jnp.zeros(T, jnp.int32),
        "contig_sq": jnp.zeros(T, jnp.int32),
        "reads1": jnp.zeros(T, jnp.int32),
        "mc_len": jnp.zeros(T, jnp.int32),
        "mc_enc": jnp.zeros(T, jnp.int32),
        "mc_bno": jnp.full(T, -1, jnp.int32),
    }


def contig_sq_drain_every(B: int, W: int) -> int:
    """Batches between drains keeping the int32 contig^2 accumulator exact."""
    per_batch = B * W * W
    return max(1, (2**31 - 1) // max(per_batch, 1))


def fold_node_state(state, out, batch_no):
    """Fold one match_step output into the node accumulators (device)."""
    import jax.numpy as jnp
    new = {
        "kmers": state["kmers"] + out["kmers"],
        "contigs": state["contigs"] + out["contigs"],
        "contig_sq": state["contig_sq"] + jnp.sum(out["contig_sq"], axis=0),
        "reads1": state["reads1"] + out["reads1"],
    }
    # strict > keeps the earliest batch's achiever on ties, matching the
    # host-side per-batch fold (ref FastqKMerMatcher.java:404-408)
    better = out["max_contig"] > state["mc_len"]
    new["mc_len"] = jnp.where(better, out["max_contig"], state["mc_len"])
    new["mc_enc"] = jnp.where(better, out["argmax_enc"], state["mc_enc"])
    new["mc_bno"] = jnp.where(better, batch_no, state["mc_bno"])
    return new


def per_read_layout(n_nodes: int, W: int, L: int):
    """Bit layout of the per-read result word(s) for a given batch shape.

    Returns (words, nbits, kbits, ebits): with words == 1 everything fits one
    int32 [B] vector (half the per-batch transfer) —
      [found(1) | stats_ok(1) | tax_err(ebits) | read_kmers(kbits) |
       class_node+1(nbits)];
    words == 3 is the wide fallback for long reads ([B, 3]: class_node;
    found|stats_ok|tax_err; read_kmers) — every field at full width, so
    classification-enabled long reads are never clamped (tax_err <= W + L
    < 2^30 for any feasible read length).
    Field bounds: read_kmers <= n_win <= W; tax_err <= n_win + #bad bases
    <= W + L; class_node in [-1, n_nodes)."""
    nbits = max(int(np.ceil(np.log2(n_nodes + 2))), 1)
    kbits = max(int(np.ceil(np.log2(W + 2))), 1)
    ebits = max(int(np.ceil(np.log2(W + L + 2))), 1)
    if 2 + ebits + kbits + nbits <= 31:
        return 1, nbits, kbits, ebits
    return 3, 0, 0, 0


def pack_per_read(out, n_nodes: int, W: int, L: int):
    import jax.numpy as jnp
    words, nbits, kbits, ebits = per_read_layout(n_nodes, W, L)
    if words == 1:
        w = (jnp.where(out["found"], jnp.int32(1 << (ebits + kbits + nbits + 1)), 0)
             | jnp.where(out["stats_ok"], jnp.int32(1 << (ebits + kbits + nbits)), 0)
             | ((out["tax_err"] & ((1 << ebits) - 1)) << (kbits + nbits))
             | ((out["read_kmers"] & ((1 << kbits) - 1)) << nbits)
             | ((out["class_node"] + 1) & ((1 << nbits) - 1)))
        return w
    w1 = (jnp.where(out["found"], jnp.int32(-(1 << 31)), 0)
          | jnp.where(out["stats_ok"], jnp.int32(1 << 30), 0)
          | (out["tax_err"] & ((1 << 30) - 1)))
    return jnp.stack([out["class_node"], w1, out["read_kmers"]], axis=1)


def unpack_per_read_np(pk: np.ndarray, n_nodes: int, W: int, L: int):
    """Host inverse of pack_per_read.

    Returns (class_node i64, found bool, stats_ok bool, tax_err i64,
    read_kmers i64)."""
    words, nbits, kbits, ebits = per_read_layout(n_nodes, W, L)
    if words == 1:
        w = pk.astype(np.int64)
        cls = (w & ((1 << nbits) - 1)) - 1
        read_kmers = (w >> nbits) & ((1 << kbits) - 1)
        tax_err = (w >> (kbits + nbits)) & ((1 << ebits) - 1)
        stats_ok = ((w >> (ebits + kbits + nbits)) & 1) != 0
        found = ((w >> (ebits + kbits + nbits + 1)) & 1) != 0
        return cls, found, stats_ok, tax_err, read_kmers
    cls = pk[:, 0].astype(np.int64)
    w1 = pk[:, 1].view(np.uint32)
    found = (w1 >> 31) != 0
    stats_ok = ((w1 >> 30) & 1) != 0
    tax_err = (w1 & ((1 << 30) - 1)).astype(np.int64)
    read_kmers = pk[:, 2].astype(np.int64)
    return cls, found, stats_ok, tax_err, read_kmers


@functools.partial(jax.jit,
                   static_argnames=("cfg", "spec", "n_nodes"),
                   donate_argnames=("seen", "counts", "nstate"))
def match_accum_step(cfg: MatchConfig, spec: TableSpec, n_nodes: int,
                     rows, vaux, anc, codes, lengths, err_bounds,
                     seen, counts, nstate, batch_no):
    """match_step + device-side accumulation; returns
    (per_read packed i32 (see per_read_layout), label or None, seen, counts,
    nstate)."""
    out = match_step(cfg, spec, n_nodes, rows, vaux, anc,
                     codes, lengths, err_bounds, seen, counts)
    nstate = fold_node_state(nstate, out, batch_no)
    B, L = codes.shape
    packed = pack_per_read(out, n_nodes, L - cfg.k + 1, L)
    label = out["label"] if cfg.return_labels else None
    return packed, label, out["seen"], out["counts"], nstate
