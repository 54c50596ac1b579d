"""Quotient-packed two-choice (cuckoo-style) hash — the fast device lookup.

Reference equivalent: the lookup role of store/KMerSortedArray.java:298-349
(bloom probe + binary search) and store/RadixKMerStore.java:38-88 (radix
buckets + in-bucket search). This layout needs exactly TWO [8]i32 row
gathers per lookup (one per bucket choice), with the value index packed
into the row, where a radix binary search needs 5-6 dependent gathers. The
production batch path (lookup_join below) avoids per-query gathers
altogether.

Exactness (no false positives) by quotienting:
  * The 64-bit key container (hi, lo) is mixed by a 2-round Feistel
    bijection -> (h2, l2).
  * bucket1 = l2 & (NB-1); rem2 = l2 >> nb  (nb = log2(NB)).
  * bucket2 = bucket1 ^ (g(h2, rem2) | 1)   (cuckoo XOR trick: bucket1 is
    recoverable from bucket2 and the remainder, so storing WHICH choice was
    used makes (bucket, choice, h2, rem2) reconstruct the full key).
  * A slot stores h2 (plane1) and [rem2 | choice | vidx] (plane2). A query
    matches iff h2, rem2 AND the choice bit agree — that pins l2's bucket
    bits, i.e. the whole 64-bit key. Exact, zero false positives.

Bucket = 4 slots = one [8]i32 row: 4x plane1 then 4x plane2. Two-choice
placement at load <= 0.5 practically never overflows; on overflow the
builder doubles NB and retries.

The *slot id* (bucket*4 + lane) replaces the sorted-array storage position
(ref KMerSortedArray posStore) as the stable k-mer index feeding exact
unique counting (ref KMerUniqueCounterBits) — the semantics only need a
stable bijection, which slot ids provide via slot_of_entry.

Value-index capacity: vidx gets nb-1 bits (>= 16 since NB >= 2^17), so
large tables naturally support value spaces far beyond the sorted-array
cap of 65535 (ref RadixKMerStore maxValuesForRadix).
"""

from __future__ import annotations

import numpy as np

BUCKET = 4
MIN_NB_BITS = 17          # vidx gets nb-1 >= 16 bits


def _feistel_np(hi: np.ndarray, lo: np.ndarray):
    """2-round Feistel mix of the 64-bit container; bijective."""
    hi = hi.astype(np.uint32)
    lo = lo.astype(np.uint32)
    def mix(x, c):
        x = (x ^ (x >> np.uint32(16))) * np.uint32(c)
        x = (x ^ (x >> np.uint32(13))) * np.uint32(0xC2B2AE35)
        return x ^ (x >> np.uint32(16))
    h1 = hi ^ mix(lo, 0x85EBCA6B)
    l1 = lo ^ mix(h1, 0x9E3779B1)
    return h1, l1


def _g_np(h2: np.ndarray, rem2: np.ndarray, mask: np.uint32):
    g = (h2 * np.uint32(0x27D4EB2F)) ^ (rem2 * np.uint32(0x165667B1))
    g ^= g >> np.uint32(15)
    return (g & mask) | np.uint32(1)


class KmerHashTable:
    """Device-ready quotient hash of a KmerTable (derived data, built at load).

    Attributes:
      rows: [NB, 8] int32 — per bucket: 4x h2 then 4x (rem2|choice|vidx).
      nb_bits: log2(number of buckets).
      slot_of_entry: [N] int64 — table entry -> slot id (bucket*4 + lane).
      vidx_of_slot: [NB*4] int32 value index per slot (-1 = empty), for
        aggregating slot-indexed unique counts per value on the host.
    """

    def __init__(self, rows, nb_bits, slot_of_entry, vidx_of_slot):
        self.rows = rows
        self.nb_bits = nb_bits
        self.slot_of_entry = slot_of_entry
        self.vidx_of_slot = vidx_of_slot

    @property
    def nb(self) -> int:
        return 1 << self.nb_bits

    @property
    def n_slots(self) -> int:
        return self.nb * BUCKET

    @property
    def vidx_bits(self) -> int:
        return self.nb_bits - 1


def vidx_of_slot_from_rows(rows: np.ndarray, nb_bits: int) -> np.ndarray:
    """Derive the per-slot value index from the packed rows (plane2's low
    nb-1 bits; the all-ones pattern marks an empty slot). Lets persisted
    hashes store only rows + slot_of_entry (store/database.py)."""
    vb = nb_bits - 1
    empty = np.uint32((1 << vb) - 1)
    plane2 = rows.view(np.uint32)[:, 4:].reshape(-1)   # slot id order
    v = (plane2 & empty).astype(np.int64)
    return np.where(v == empty, -1, v)


def max_values_for(n_keys: int) -> int:
    """Value-space capacity of the hash layout for a table of n_keys."""
    nb_bits = max(int(np.ceil(np.log2(max(2 * n_keys, 1) / BUCKET + 1))), MIN_NB_BITS)
    return (1 << (nb_bits - 1)) - 1   # all-ones vidx is the empty marker


def build_hash(keys: np.ndarray, value_idx: np.ndarray) -> KmerHashTable:
    """Builds the quotient hash host-side (vectorized numpy).

    keys: [N] uint64 distinct canonical k-mers; value_idx: [N] integer
    value indices (must fit in nb-1 bits; all-ones reserved for empty).
    """
    n = len(keys)
    keys = np.asarray(keys, dtype=np.uint64)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    h2, l2 = _feistel_np(hi, lo)

    nb_bits = max(int(np.ceil(np.log2(max(2 * n, 1) / BUCKET + 1))), MIN_NB_BITS)
    # widen buckets until the value-index space fits (vidx gets nb-1 bits,
    # all-ones reserved as the empty marker)
    max_vidx = int(np.max(value_idx)) if n else 0
    while (1 << (nb_bits - 1)) - 1 <= max_vidx:
        nb_bits += 1
    while True:
        nb = 1 << nb_bits
        mask = np.uint32(nb - 1)
        b1 = (l2 & mask).astype(np.int64)
        rem2 = (l2 >> np.uint32(nb_bits)).astype(np.uint32)
        b2 = (b1 ^ _g_np(h2, rem2, mask).astype(np.int64))
        placed = _place(b1, b2, nb)
        if placed is not None:
            break
        nb_bits += 1

    bucket_of, lane_of, choice_of = placed
    vb = nb_bits - 1
    empty = (1 << vb) - 1
    vidx = np.asarray(value_idx, dtype=np.int64)
    if np.any(vidx >= empty) or np.any(vidx < 0):
        raise ValueError(f"value index out of range for hash layout "
                         f"(max {empty - 1})")
    slot = bucket_of * BUCKET + lane_of

    rows = np.zeros((nb, 8), np.uint32)
    rows[:, 4:] = np.uint32(empty)   # choice=0, rem2=0, vidx=all-ones: empty
    plane2 = ((rem2.astype(np.uint64) << np.uint64(vb + 1))
              | (choice_of.astype(np.uint64) << np.uint64(vb))
              | vidx.astype(np.uint64)).astype(np.uint32)
    rows[bucket_of, lane_of] = h2
    rows[bucket_of, 4 + lane_of] = plane2

    vidx_of_slot = np.full(nb * BUCKET, -1, np.int64)
    vidx_of_slot[slot] = vidx
    return KmerHashTable(rows.view(np.int32), nb_bits,
                         slot.astype(np.int64), vidx_of_slot)


def _place(b1, b2, nb):
    """Two-choice cuckoo placement with eviction; (bucket, lane, choice) or None.

    Phase 1: two vectorized greedy rounds (everyone tries b1, losers try b2)
    — places ~all keys at load <= 0.5. Phase 2: vectorized random-walk
    eviction for the stragglers (one actor per bucket per round; a full
    bucket evicts a random victim, which re-joins the pending set with its
    other choice). Load 0.5 on 4-slot two-choice buckets is far below the
    cuckoo capacity bound, so the walk terminates in a handful of rounds."""
    n = len(b1)
    # int32 throughout: bucket ids < nb <= ~2^27 and entry ids < n < 2^31,
    # halving the bytes of the dominant argsort/copy/scatter work
    b1 = b1.astype(np.int32)
    b2 = b2.astype(np.int32)
    bucket_of = np.full(n, -1, np.int32)
    lane_of = np.full(n, -1, np.int32)
    choice_of = np.zeros(n, np.uint32)
    fill = np.zeros(nb, np.int32)
    slot_key = np.full(nb * BUCKET, -1, np.int32)

    pending = np.arange(n, dtype=np.int32)
    cur = b1.copy()
    alt = b2.copy()
    cur_c = np.zeros(n, np.uint32)

    def greedy_round(pending):
        want = cur[pending]
        order = np.argsort(want, kind="stable").astype(np.int32)
        w_sorted = want[order]
        first = np.ones(len(order), bool)
        first[1:] = w_sorted[1:] != w_sorted[:-1]
        pos = np.arange(len(order), dtype=np.int32)
        seg_start = np.maximum.accumulate(np.where(first, pos, 0))
        rank = pos - seg_start
        lane = fill[w_sorted] + rank
        ok = lane < BUCKET
        idx = pending[order]
        win = idx[ok]
        bucket_of[win] = w_sorted[ok]
        lane_of[win] = lane[ok].astype(np.int32)
        choice_of[win] = cur_c[win]
        slot_key[w_sorted[ok] * BUCKET + lane[ok]] = win
        np.add.at(fill, w_sorted[ok], 1)
        return idx[~ok]

    def swap_to_alt(keys):
        c = cur[keys].copy()
        cur[keys] = alt[keys]
        alt[keys] = c
        cur_c[keys] ^= np.uint32(1)

    for _ in range(2):
        if len(pending) == 0:
            return bucket_of, lane_of, choice_of
        pending = greedy_round(pending)
        swap_to_alt(pending)

    rng = np.random.default_rng(0x9E3779B1)
    for _ in range(2000):
        if len(pending) == 0:
            return bucket_of, lane_of, choice_of
        want = cur[pending]
        order = np.argsort(want, kind="stable").astype(np.int32)
        w_sorted = want[order]
        first = np.ones(len(order), bool)
        first[1:] = w_sorted[1:] != w_sorted[:-1]
        idx = pending[order]
        act, wb = idx[first], w_sorted[first]     # one actor per bucket
        waiters = idx[~first]
        free = fill[wb] < BUCKET
        fa, fb = act[free], wb[free]
        lane = fill[fb]
        bucket_of[fa] = fb
        lane_of[fa] = lane.astype(np.int32)
        choice_of[fa] = cur_c[fa]
        slot_key[fb * BUCKET + lane] = fa
        fill[fb] += 1
        ea, eb = act[~free], wb[~free]
        lane = rng.integers(0, BUCKET, len(ea))
        victim = slot_key[eb * BUCKET + lane]
        bucket_of[ea] = eb
        lane_of[ea] = lane.astype(np.int32)
        choice_of[ea] = cur_c[ea]
        slot_key[eb * BUCKET + lane] = ea
        # victim re-joins pending, targeting its other bucket
        bucket_of[victim] = -1
        v_other_is_b2 = b1[victim] == eb
        cur[victim] = np.where(v_other_is_b2, b2[victim], b1[victim])
        alt[victim] = eb
        cur_c[victim] = v_other_is_b2.astype(np.uint32)
        pending = np.concatenate([waiters, victim])
    return None


# ---------------------------------------------------------------------------
# device lookup — scatter-join (the fast path)
# ---------------------------------------------------------------------------
#
# The scatter-join inverts the two-gather lookup's access pattern: instead
# of bringing table rows to the queries (random gathers), it delivers the
# queries TO the table's bucket space with sorts + scatters and resolves all
# of them in ONE dense elementwise pass over the bucket table, with results
# bit-identical to the gather path. Which of the two is faster on the GPU,
# and at which batch size, is not yet measured (ROADMAP A3).
#
# Per call (Q queries, 2 entries each — one per cuckoo bucket choice):
#   1. entries (bucket, h2, want=rem2<<1|choice, qid) sorted by (bucket, key).
#   2. distinct keys get rank lanes r < R in a [NB, R] scratch via scatter;
#      equal-key duplicates share their run-first's lane.
#   3. dense pass over [NB, R] scratch vs the 4 slots of rows[NB, 8]:
#      exact compare (h2 + quotient + choice) -> (found, vidx, slot).
#   4. results scatter back to entry positions, broadcast along equal-key
#      runs (associative scan), and combine per query by qid scatter.
#   5. a query is RESOLVED iff some entry found it, or both entries held
#      lanes (then a miss is definitive). The handful of rank-overflow
#      queries (~1e-4 at R=4) are re-looked-up exactly by the two-gather
#      path on a compacted fixed-size slice; a lax.cond falls back to a
#      full two-gather pass in the (astronomically unlikely) case the
#      slice capacity is exceeded — exactness is unconditional.

def _entry_count_bits(e: int) -> int:
    return max(int(np.ceil(np.log2(e + 2))), 1)


def lookup_join(rows, q_hi, q_lo, *, nb_bits: int, r_lanes: int = 0,
                fallback_cap: int = 8192, axis: str | None = None):
    """Exact scatter-join hash lookup on device; contract == lookup_hash.

    rows: [NB, 8] int32; q_hi/q_lo: uint32 query halves, any shape.
    Returns (slot int32 [n_slots where miss], found bool, vidx int32 [-1
    where miss]).

    Sharded-DB mode (`axis` inside shard_map): rows holds only this shard's
    contiguous bucket range (global buckets [i*NB_local, (i+1)*NB_local));
    queries must be replicated across the axis. The sort/rank/lane logic is
    a pure function of the (identical) queries, so every shard computes it
    identically with zero communication — only the dense-pass compare
    results and the fallback probes are psum-merged. This is the
    radix-bits-as-shard-key design of SURVEY.md §5.8 (ref role:
    store/RadixKMerStore.java:38-88) transplanted onto the quotient hash.
    """
    import jax
    import jax.numpy as jnp

    from genestrip_tpu.ops.scan import assoc_scan_1d, cumsum_1d, running_max_1d

    shape = q_hi.shape
    q_hi = jax.lax.bitcast_convert_type(q_hi.reshape(-1), jnp.uint32)
    q_lo = jax.lax.bitcast_convert_type(q_lo.reshape(-1), jnp.uint32)
    Q = q_hi.shape[0]
    E = 2 * Q
    nb = 1 << nb_bits
    vb = nb_bits - 1
    if axis is None:
        nb_local = nb
        bucket_lo = None
    else:
        nb_local = rows.shape[0]
        bucket_lo = jax.lax.axis_index(axis) * nb_local
    if not r_lanes:
        lam = E / nb
        r_lanes = 4 if lam <= 0.5 else (6 if lam <= 1.0 else 8)
    R = r_lanes
    FB = min(fallback_cap, Q)

    def mix(x, c):
        x = (x ^ (x >> jnp.uint32(16))) * jnp.uint32(c)
        x = (x ^ (x >> jnp.uint32(13))) * jnp.uint32(0xC2B2AE35)
        return x ^ (x >> jnp.uint32(16))

    h2 = q_hi ^ mix(q_lo, 0x85EBCA6B)
    l2 = q_lo ^ mix(h2, 0x9E3779B1)
    mask = jnp.uint32(nb - 1)
    b1 = (l2 & mask).astype(jnp.int32)
    rem2 = l2 >> jnp.uint32(nb_bits)
    g = (h2 * jnp.uint32(0x27D4EB2F)) ^ (rem2 * jnp.uint32(0x165667B1))
    g = ((g ^ (g >> jnp.uint32(15))) & mask) | jnp.uint32(1)
    b2 = b1 ^ g.astype(jnp.int32)

    want1 = (rem2 << jnp.uint32(1)).astype(jnp.int32)
    e_b = jnp.concatenate([b1, b2])
    e_h = jax.lax.bitcast_convert_type(jnp.concatenate([h2, h2]), jnp.int32)
    e_w = jnp.concatenate([want1, want1 | 1])
    qid = jax.lax.broadcasted_iota(jnp.int32, (Q, 1), 0).reshape(-1)
    e_q = jnp.concatenate([qid, qid])

    # entry sort groups identical (bucket, h2, want) triples; the entry id
    # rides along. Packing (want, id) into one lane drops an operand from
    # the big 1-D sort — the dominant compile-time cost of this graph.
    wbits = 33 - nb_bits
    ebits = _entry_count_bits(E)
    if wbits + ebits <= 31:
        wq = (e_w << ebits) | e_q
        s_b, s_h, s_wq = jax.lax.sort((e_b, e_h, wq), num_keys=3)
        s_w = s_wq >> ebits
        s_q = s_wq & ((1 << ebits) - 1)
    else:
        s_b, s_h, s_w, s_q = jax.lax.sort((e_b, e_h, e_w, e_q), num_keys=3)

    pb = jnp.concatenate([jnp.full((1,), -1, jnp.int32), s_b[:-1]])
    ph = jnp.concatenate([jnp.full((1,), 0, jnp.int32), s_h[:-1]])
    pw = jnp.concatenate([jnp.full((1,), -1, jnp.int32), s_w[:-1]])
    new_key = (s_b != pb) | (s_h != ph) | (s_w != pw)
    new_bucket = s_b != pb
    pos = jax.lax.broadcasted_iota(jnp.int32, (E, 1), 0).reshape(-1)
    # two-level scans of this long 1-D array (see ops/scan.py)
    kidx = cumsum_1d(new_key.astype(jnp.int32))
    bstart_k = running_max_1d(jnp.where(new_bucket, kidx, 0))
    rank = kidx - bstart_k

    lane_ok = new_key & (rank < R)
    if bucket_lo is None:
        tgt = jnp.where(lane_ok, s_b * R + rank, nb_local * R)
    else:
        # scratch lanes only for locally-owned buckets; lane_ok stays the
        # GLOBAL predicate (identical on every shard) for resolution logic
        lb = s_b - bucket_lo
        local_ok = lane_ok & (lb >= 0) & (lb < nb_local)
        tgt = jnp.where(local_ok, lb * R + rank, nb_local * R)
    # pack (want, pos) into one scratch plane when the bits fit: want has
    # 33 - nb_bits significant bits, pos needs log2(E + 2)
    wbits = 33 - nb_bits
    pbits = _entry_count_bits(E)
    packed = (wbits + pbits) <= 32
    sc_h = jnp.zeros(nb_local * R + 1, jnp.int32).at[tgt].set(s_h)
    if packed:
        wp = (s_w << pbits) | pos
        sc_wp = jnp.full(nb_local * R + 1, -1, jnp.int32).at[tgt].set(wp)
        sw2 = jax.lax.bitcast_convert_type(
            sc_wp[:-1].reshape(nb_local, R), jnp.uint32)
        sw_probe = (sw2 >> jnp.uint32(pbits)).astype(jnp.int32)
        sp2 = (sw2 & jnp.uint32((1 << pbits) - 1)).astype(jnp.int32)
    else:
        sc_w = jnp.full(nb_local * R + 1, -1, jnp.int32).at[tgt].set(s_w)
        sc_p = jnp.zeros(nb_local * R + 1, jnp.int32).at[tgt].set(pos)
        sw_probe = sc_w[:-1].reshape(nb_local, R)
        sp2 = sc_p[:-1].reshape(nb_local, R)
    sh2 = sc_h[:-1].reshape(nb_local, R)

    fnd, v, slot = dense_pass(rows, sh2, sw_probe, vb=vb,
                              bucket_lo=bucket_lo)

    # scatter back to entry space
    f_flat = fnd.reshape(-1)
    p_flat = jnp.where(f_flat, sp2.reshape(-1), E)
    r_v = jnp.full(E + 1, -1, jnp.int32).at[p_flat].set(v.reshape(-1))
    r_s = jnp.full(E + 1, -1, jnp.int32).at[p_flat].set(slot.reshape(-1))
    r_ok = jnp.zeros(E + 1, jnp.int32).at[
        jnp.where(lane_ok, pos, E)].set(1)
    rv, rs, rok = r_v[:E], r_s[:E], r_ok[:E]

    # broadcast along equal-key runs (run-first holds the result)
    run_id = jnp.where(new_key, pos, -1)

    def seg_copy(vals):
        def comb(a, b):
            keep = b[0] >= 0
            return (jnp.where(keep, b[0], a[0]), jnp.where(keep, b[1], a[1]))
        return assoc_scan_1d(comb, (run_id, vals),
                             (jnp.int32(-1), jnp.int32(0)))[1]

    rv_b = seg_copy(rv)
    rs_b = seg_copy(rs)
    rok_b = seg_copy(rok)

    # combine per query: at most one of a query's two entries can be found
    env = jnp.zeros(Q, jnp.int32).at[s_q].max(
        jnp.where(rv_b >= 0, rv_b + 1, 0))
    slot_q = jnp.full(Q, -1, jnp.int32).at[s_q].max(rs_b)
    n_lanes = jnp.zeros(Q, jnp.int32).at[s_q].add(rok_b)
    if axis is not None:
        # merge shard partials: at most one shard can find a query, and
        # n_lanes is already the global predicate (identical everywhere)
        env = jax.lax.psum(env, axis)
        slot_q = jax.lax.pmax(slot_q, axis)
    found = env > 0
    vidx = jnp.where(found, env - 1, -1)
    resolved = found | (n_lanes == 2)

    def fb_lookup(qh, ql):
        if axis is None:
            return lookup_hash(rows, qh, ql, nb_bits=nb_bits)
        s_, f_, v_ = lookup_hash(rows, qh, ql, nb_bits=nb_bits,
                                 bucket_lo=bucket_lo)
        env_ = jax.lax.psum(jnp.where(f_, v_ + 1, 0), axis)
        sl_ = jax.lax.pmax(jnp.where(f_, s_, -1), axis)
        f2 = env_ > 0
        return (jnp.where(f2, sl_, nb * BUCKET), f2,
                jnp.where(f2, env_ - 1, -1))

    # fallback: compact unresolved to the front (stable), two-gather them.
    # In sharded mode the compaction order and cond predicate are pure
    # functions of replicated data, so every shard executes the same branch
    # and the psums inside line up.
    n_unres = jnp.sum((~resolved).astype(jnp.int32))
    qbits = max(int(np.ceil(np.log2(Q + 1))), 1)
    if qbits + 1 <= 31:
        comp = jax.lax.sort((resolved.astype(jnp.int32) << qbits) | qid)
        fb_idx = (comp & ((1 << qbits) - 1))[:FB]
    else:
        # Q >= 2^30: the packed key would overflow int32; two-operand sort
        _, fb_idx = jax.lax.sort((resolved.astype(jnp.int32), qid),
                                 num_keys=1)
        fb_idx = fb_idx[:FB]

    def fb_partial(args):
        found, vidx, slot_q = args
        s_fb, f_fb, v_fb = fb_lookup(q_hi[fb_idx], q_lo[fb_idx])
        # overwrite the slice (resolved entries in it get identical values)
        found = found.at[fb_idx].set(f_fb)
        vidx = vidx.at[fb_idx].set(v_fb)
        slot_q = slot_q.at[fb_idx].set(jnp.where(f_fb, s_fb, -1))
        return found, vidx, slot_q

    def fb_full(args):
        s_all, f_all, v_all = fb_lookup(q_hi, q_lo)
        return f_all, v_all, jnp.where(f_all, s_all, -1)

    found, vidx, slot_q = jax.lax.cond(
        n_unres <= FB, fb_partial, fb_full, (found, vidx, slot_q))

    slot_out = jnp.where(found, slot_q, nb * BUCKET)
    return (slot_out.reshape(shape), found.reshape(shape), vidx.reshape(shape))


def dense_pass(rows, sh2, sw_probe, *, vb: int, bucket_lo=None):
    """The scatter-join's dense compare: every [NB, R] scratch lane (h2 in
    sh2, rem2|choice in sw_probe) against the 4 slots of its bucket's row,
    as plain elementwise XLA ops, which fuse into one pass over the bucket
    table. A hand-written kernel of it is worth having only if a trace
    shows this fusion far from the device's memory bandwidth (ROADMAP).

    rows: [NB, 8] int32 (this shard's bucket range when bucket_lo is set).
    Returns (found bool, vidx int32, slot int32), each [NB, R]."""
    import jax
    import jax.numpy as jnp

    nb_local, R = sh2.shape
    empty = jnp.int32((1 << vb) - 1)
    with jax.named_scope("dense_pass"):
        fnd = jnp.zeros((nb_local, R), bool)
        v = jnp.zeros((nb_local, R), jnp.int32)
        lane = jnp.zeros((nb_local, R), jnp.int32)
        for j in range(BUCKET):
            kj = rows[:, j][:, None]
            pj = jax.lax.bitcast_convert_type(
                rows[:, BUCKET + j], jnp.uint32)[:, None]
            vj = (pj & jnp.uint32(empty)).astype(jnp.int32)
            eqj = ((kj == sh2)
                   & ((pj >> jnp.uint32(vb)).astype(jnp.int32) == sw_probe)
                   & (vj != empty))
            first = eqj & ~fnd
            v = jnp.where(first, vj, v)
            lane = jnp.where(first, j, lane)
            fnd = fnd | eqj
        bidx = jax.lax.broadcasted_iota(jnp.int32, (nb_local, R), 0)
        if bucket_lo is not None:
            bidx = bidx + bucket_lo      # globalize the slot id
        slot = bidx * BUCKET + lane
    return fnd, v, slot


# ---------------------------------------------------------------------------
# device lookup — two-gather (fallback + small-Q path)
# ---------------------------------------------------------------------------

def lookup_hash(rows, q_hi, q_lo, *, nb_bits: int, bucket_lo=None):
    """Two-gather exact hash lookup on device.

    With `bucket_lo` (sharded-DB mode), rows holds only the local bucket
    range; probes of non-local buckets report not-found and the caller
    merges shard partials (see lookup_join).

    rows: [NB, 8] int32; q_hi/q_lo: uint32 query halves, any shape.
    Returns (slot int32, found bool, vidx int32); slot is the stable k-mer
    index (NB*4 where not found — a dummy scatter target); vidx is -1 where
    not found.

    Queries are flattened internally to one [Q, 8] row-gather per bucket
    choice. The 4-slot probe is unrolled into elementwise selects — no
    tiny-trailing-dim ops.
    """
    import jax
    import jax.numpy as jnp

    shape = q_hi.shape
    q_hi = jax.lax.bitcast_convert_type(q_hi.reshape(-1), jnp.uint32)
    q_lo = jax.lax.bitcast_convert_type(q_lo.reshape(-1), jnp.uint32)

    def mix(x, c):
        x = (x ^ (x >> jnp.uint32(16))) * jnp.uint32(c)
        x = (x ^ (x >> jnp.uint32(13))) * jnp.uint32(0xC2B2AE35)
        return x ^ (x >> jnp.uint32(16))

    h2 = q_hi ^ mix(q_lo, 0x85EBCA6B)
    l2 = q_lo ^ mix(h2, 0x9E3779B1)
    nb = 1 << nb_bits
    vb = nb_bits - 1
    empty = jnp.uint32((1 << vb) - 1)
    mask = jnp.uint32(nb - 1)
    b1 = (l2 & mask).astype(jnp.int32)
    rem2 = l2 >> jnp.uint32(nb_bits)
    g = (h2 * jnp.uint32(0x27D4EB2F)) ^ (rem2 * jnp.uint32(0x165667B1))
    g = ((g ^ (g >> jnp.uint32(15))) & mask) | jnp.uint32(1)
    b2 = b1 ^ g.astype(jnp.int32)

    if bucket_lo is None:
        r1 = rows[b1]                      # [Q, 8]
        r2 = rows[b2]
        own1 = own2 = None
    else:
        nb_local = rows.shape[0]
        lb1, lb2 = b1 - bucket_lo, b2 - bucket_lo
        own1 = (lb1 >= 0) & (lb1 < nb_local)
        own2 = (lb2 >= 0) & (lb2 < nb_local)
        r1 = rows[jnp.clip(lb1, 0, nb_local - 1)]
        r2 = rows[jnp.clip(lb2, 0, nb_local - 1)]

    def probe(r, choice, own):
        want_hi = (rem2 << jnp.uint32(1)) | jnp.uint32(choice)
        f = jnp.zeros(h2.shape, bool)
        lane = jnp.zeros(h2.shape, jnp.int32)
        v = jnp.zeros(h2.shape, jnp.uint32)
        for j in range(BUCKET):
            kj = jax.lax.bitcast_convert_type(r[:, j], jnp.uint32)
            pj = jax.lax.bitcast_convert_type(r[:, BUCKET + j], jnp.uint32)
            vj = pj & empty
            eqj = (kj == h2) & ((pj >> jnp.uint32(vb)) == want_hi) & (vj != empty)
            first = eqj & ~f
            lane = jnp.where(first, j, lane)
            v = jnp.where(first, vj, v)
            f = f | eqj
        if own is not None:
            f = f & own
        return f, lane, v.astype(jnp.int32)

    f1, l1_, v1 = probe(r1, 0, own1)
    f2, l2_, v2 = probe(r2, 1, own2)
    found = f1 | f2
    bucket = jnp.where(f1, b1, b2)
    lane = jnp.where(f1, l1_, l2_)
    slot = jnp.where(found, bucket * BUCKET + lane, nb * BUCKET)
    vidx = jnp.where(found, jnp.where(f1, v1, v2), -1)
    return (slot.reshape(shape), found.reshape(shape), vidx.reshape(shape))
