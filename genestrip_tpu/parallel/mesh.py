"""Multi-device data-parallel matching over a device mesh.

Replaces the reference's single-JVM producer/consumer thread fan-out
(ref: fastq/AbstractFastqReader.java:88-185, ExecutionContext) with SPMD
over a jax.sharding.Mesh: read batches are sharded over the batch dimension
("reads" axis), the k-mer table and taxonomy arrays are replicated in every
device's memory (Genestrip databases are small by design, ref README.md:39),
and per-tax-id statistic vectors are merged with psum. The unique-k-mer
seen/count vectors are per-shard partial states (position-space partition)
that are OR/sum-merged host-side at aggregation time (SURVEY.md §5.8).

The Matcher picks this path automatically whenever more than one device is
visible (genestrip_tpu/match/matcher.py); tests exercise it on a virtual
8-device CPU mesh and assert shard-merged == single-device for every output.

For databases too large to replicate, the hash rows are bucket-range-sharded
over the mesh instead (dbShard; store/hash.py lookup_join with `axis`), and
should_shard_db decides between the two.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from genestrip_tpu.match.pipeline import (
    MatchConfig, TableSpec, fold_node_state, match_step, node_state_init,
    pack_per_read,
)

# outputs that are per-node vectors and must be summed across shards
_PSUM_OUTS = ("contigs", "kmers", "reads1")
# outputs that stay sharded along the read axis (read order is preserved:
# shard s holds the contiguous block s of the batch)
_SHARDED_OUTS = ("found", "n_win", "class_node", "read_kmers", "tax_err",
                 "stats_ok", "label")


# dbShard=auto replicates the hash rows while they take at most this share of
# the smallest device's memory limit. Derived, not measured: it leaves the
# rest of each device to the match step's batch working set and to XLA.
SHARD_MEMORY_FRACTION = 0.25


def make_mesh(devices=None, axis: str = "reads") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def auto_shard_min_bytes(devices) -> int | None:
    """Table bytes above which dbShard=auto shards the hash rows:
    SHARD_MEMORY_FRACTION of the smallest device's memory_stats()
    ["bytes_limit"]. None when any device reports no limit (the CPU
    backend): no memory size is assumed, and auto replicates."""
    limits = []
    for d in devices:
        stats = d.memory_stats()
        if not stats or "bytes_limit" not in stats:
            return None
        limits.append(int(stats["bytes_limit"]))
    return int(min(limits) * SHARD_MEMORY_FRACTION) if limits else None


def should_shard_db(mode, table_bytes: int, devices,
                    min_bytes: int = 0) -> bool:
    """Whether a mesh over `devices` bucket-range-shards the hash rows
    (config dbShard: "on"/True, "off"/False or "auto"). Under "auto" the
    rows shard above `min_bytes` (config dbShardMinBytes) or, when that is
    0, above auto_shard_min_bytes(devices)."""
    if mode is True or mode == "on":
        return True
    if mode != "auto":
        return False
    limit = min_bytes or auto_shard_min_bytes(devices)
    return limit is not None and table_bytes > limit


def make_sharded_match_step(mesh: Mesh, cfg: MatchConfig, spec: TableSpec,
                            n_nodes: int, axis: str = "reads",
                            shard_db: bool = False):
    """A jitted shard_map data-parallel match step over the given mesh.

    Signature matches match_step minus the static args:
      fn(rows, vaux, anc, codes, lengths, seen, counts) -> outputs
    codes/lengths are sharded over `axis`; seen/counts carry a leading device
    axis (per-shard partial unique-counter state); table/tree arrays are
    replicated. Per-node outputs come back shard-merged (psum/pmax); per-read
    outputs come back sharded in read order. max-contig tie-breaking uses
    globally offset (read, window) encodings so the first achiever in global
    read order wins, exactly as single-device (ref FastqKMerMatcher.java:404).
    """
    n_dev = mesh.shape[axis]

    def local_step(rows, vaux, anc, codes, lengths, err_bounds, seen, counts):
        B_local, L = codes.shape
        W = L - cfg.k + 1
        out = match_step(cfg, spec, n_nodes, rows, vaux, anc,
                         codes, lengths, err_bounds, seen[0], counts[0],
                         db_axis=axis if shard_db else None)
        idx = jax.lax.axis_index(axis)
        res = {}
        for k_, v in out.items():
            if k_ in _PSUM_OUTS:
                res[k_] = jax.lax.psum(v, axis)
            elif k_ == "contig_sq":
                res[k_] = v              # [G, T] i32: stack shards, no psum
                #    (host sums groups in int64; a psum could overflow i32)
            elif k_ == "max_contig":
                res[k_] = jax.lax.pmax(v, axis)
            elif k_ == "argmax_enc":
                # min globally-offset encoded (read, window) among shards
                # achieving the global max contig length
                gmax = jax.lax.pmax(out["max_contig"], axis)
                big = jnp.iinfo(jnp.int32).max
                enc = jnp.where((out["max_contig"] == gmax) & (v != big),
                                v + idx * (B_local * W), big)
                res[k_] = jax.lax.pmin(enc, axis)
            elif k_ in ("seen", "counts"):
                res[k_] = v[None]       # keep per-shard (position-space state)
            else:
                res[k_] = v
        return res

    repl = P()
    rows_spec = P(axis) if shard_db else repl         # bucket-range sharding
    in_specs = (rows_spec, repl, repl,                # table + tree arrays
                P(axis), P(axis), P(axis),            # codes, lengths, bounds
                P(axis), P(axis))                     # seen, counts (stacked)

    def spec_for(name):
        if name in _SHARDED_OUTS or name in ("seen", "counts", "contig_sq"):
            return P(axis)
        return repl

    keys = ["found", "n_win", "contigs", "kmers", "contig_sq", "max_contig",
            "argmax_enc", "reads1", "seen", "counts",
            "class_node", "read_kmers", "tax_err", "stats_ok"]
    if cfg.return_labels:
        keys.append("label")
    out_specs = {k_: spec_for(k_) for k_ in keys}

    fn = shard_map(local_step, mesh=mesh, in_specs=in_specs,
                   out_specs=out_specs, check_vma=False)
    return jax.jit(fn, donate_argnums=(6, 7))


def make_sharded_accum_step(mesh: Mesh, cfg: MatchConfig, spec: TableSpec,
                            n_nodes: int, axis: str = "reads",
                            shard_db: bool = False):
    """Accumulating data-parallel step: ONE sharded per-read output per batch.

    Same sharding contract as make_sharded_match_step, plus a donated
    per-shard node-accumulator state (see pipeline.node_state_init): additive
    statistics accumulate as per-shard partials (summed host-side at drain —
    no per-step psum traffic), while the max-contig achiever is globalized
    per step (pmax/pmin over [T]) so every shard's accumulator holds the
    identical global best with a globally-offset (read, window) encoding.

    fn(rows, vaux, anc, codes, lengths, bounds, seen, counts, nstate,
       batch_no) -> (packed [B, 2], label|None, seen, counts, nstate)
    """
    def local_step(rows, vaux, anc, codes, lengths, err_bounds,
                   seen, counts, nstate, batch_no):
        B_local, L = codes.shape
        W = L - cfg.k + 1
        out = match_step(cfg, spec, n_nodes, rows, vaux, anc,
                         codes, lengths, err_bounds, seen[0], counts[0],
                         db_axis=axis if shard_db else None)
        idx = jax.lax.axis_index(axis)
        big = jnp.iinfo(jnp.int32).max
        gmax = jax.lax.pmax(out["max_contig"], axis)
        enc = jnp.where((out["max_contig"] == gmax)
                        & (out["argmax_enc"] != big),
                        out["argmax_enc"] + idx * (B_local * W), big)
        out2 = dict(out)
        out2["max_contig"] = gmax
        out2["argmax_enc"] = jax.lax.pmin(enc, axis)
        ns = fold_node_state({k: v[0] for k, v in nstate.items()}, out2,
                             batch_no)
        packed = pack_per_read(out, n_nodes, W, L)
        res = {"packed": packed,
               "seen": out["seen"][None], "counts": out["counts"][None],
               "nstate": {k: v[None] for k, v in ns.items()}}
        if cfg.return_labels:
            res["label"] = out["label"]
        return res

    repl = P()
    rows_spec = P(axis) if shard_db else repl
    in_specs = (rows_spec, repl, repl,
                P(axis), P(axis), P(axis),
                P(axis), P(axis),
                {k: P(axis) for k in node_state_init(1)}, repl)
    out_specs = {"packed": P(axis), "seen": P(axis), "counts": P(axis),
                 "nstate": {k: P(axis) for k in node_state_init(1)}}
    if cfg.return_labels:
        out_specs["label"] = P(axis)
    fn = shard_map(local_step, mesh=mesh, in_specs=in_specs,
                   out_specs=out_specs, check_vma=False)
    return jax.jit(fn, donate_argnums=(6, 7, 8))


def node_state_sharded(n_nodes: int, mesh: Mesh, axis: str = "reads"):
    """Per-shard stacked node accumulators ([n_dev, T] each)."""
    n_dev = mesh.shape[axis]
    sh = NamedSharding(mesh, P(axis))
    base = node_state_init(n_nodes)
    return {k: jax.device_put(np.broadcast_to(np.asarray(v), (n_dev,) + v.shape).copy(), sh)
            for k, v in base.items()}


def drain_node_state(nstate) -> dict:
    """Pull + merge node accumulators to host numpy (sum partials across
    shards; the max-contig trio is replicated — take shard 0)."""
    out = {}
    for k, v in nstate.items():
        a = np.asarray(v)
        if a.ndim == 2:
            if k in ("mc_len", "mc_enc", "mc_bno"):
                out[k] = a[0]
            else:
                out[k] = a.sum(axis=0, dtype=np.int64)
        else:
            out[k] = a.astype(np.int64) if k not in ("mc_len", "mc_enc", "mc_bno") else a
    return out


def unique_state(n_table: int, mesh: Mesh | None, with_counts: bool,
                 axis: str = "reads"):
    """Unique-counter state: per-shard stacked when a mesh is given."""
    if mesh is None:
        seen = jnp.zeros(n_table + 1, jnp.uint8)
        counts = jnp.zeros(n_table + 1 if with_counts else 1, jnp.int32)
        return seen, counts
    n_dev = mesh.shape[axis]
    sh = NamedSharding(mesh, P(axis))
    seen = jax.device_put(np.zeros((n_dev, n_table + 1), np.uint8), sh)
    counts = jax.device_put(
        np.zeros((n_dev, n_table + 1 if with_counts else 1), np.int32), sh)
    return seen, counts


def merge_seen(seen) -> np.ndarray:
    """OR-merge the per-shard seen vectors (host side)."""
    a = np.asarray(seen)
    return a.max(axis=0) if a.ndim == 2 else a


def merge_counts(counts) -> np.ndarray:
    """Sum-merge the per-shard count vectors (host side)."""
    a = np.asarray(counts)
    return a.sum(axis=0, dtype=np.int64) if a.ndim == 2 else a
