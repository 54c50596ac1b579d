"""Benchmarks on the real device over a synthetic database + read mix shaped
like the reference's human_virus micro-benchmark (small curated DB, 150 bp
reads, ~half of the reads classifiable).

Emits one JSON line per metric. The HEADLINE metric (device-pipeline
classification reads/s/chip) runs FIRST — a later phase stall can then never
eat it — and its line is RE-PRINTED after every later phase, so the LAST
stdout line is always the headline once it exists (the driver parses the
last line). Metrics:

  1. classification throughput, device pipeline (HEADLINE, reads/s/chip).
  2. k-mer lookup throughput (lookups/s) — the match hot op alone.
  3. DB build wall-clock on a synthetic category (bases/s).
  4. host input pipeline (gzip fastq -> packed batches, reads/s): one
     stream, plus an N-pinned-worker aggregate (1 worker/core). A single
     stream is bound by gzip inflate, since a single gzip member cannot be
     decompressed in parallel; the product scales via multi-file data
     parallelism (multi-host file sharding, parallel/distributed.py).
     Also: end-to-end reads/s from a gzip fastq on disk through the full
     Matcher, host-to-device and device-to-host copies included.
  5. sharded-DB match step (bucket-range rows + all-gather/psum graph) and
  6. the device-resident LCA update step — secondary metrics, skipped
     first when the global budget runs low.

Each phase runs in its OWN subprocess, one after another, with a
per-phase timeout and a global deadline, so one stalled phase cannot take
the rest with it. Whether that isolation is still needed is ROADMAP A1.

The 16M-key world (table keys, quotient-hash rows, genome) is built ONCE by
a cache phase and memoized as .npy files under --cache-dir; every phase
subprocess mmap-loads from there instead of paying the full world build
each time.

vs_baseline: the reference publishes no numbers (BASELINE.md) and cannot run
here (no JVM). The constant below is a deliberately generous estimate of its
multithreaded CPU throughput for small DBs (per-k-mer binary search hot
loop): 250k reads/s. vs_baseline = measured / 250k.
"""

import argparse
import gzip
import json
import os
import subprocess
import sys
import time

import numpy as np

BASELINE_READS_PER_SEC = 250_000.0
BASELINE_LOOKUPS_PER_SEC = 250_000.0 * 120     # reads/s x windows/read
BASELINE_DB_BASES_PER_SEC = 2_000_000.0        # "viral: minutes" README.md:129

HEADLINE_METRIC = ("classification throughput (k=31, 150bp reads, "
                   "16M-kmer DB, device pipeline)")


# ---------------------------------------------------------------------------
# synthetic world (taxonomy is cheap and rebuilt per phase; the table/hash/
# genome are heavy and cached on disk)
# ---------------------------------------------------------------------------

def build_tax(n_taxa: int):
    """Binary-ish taxonomy over the taxa + root chain; returns
    (SmallTaxTree, node_of_value int32 [n_taxa])."""
    from genestrip_tpu.tax.small import SmallTaxTree

    n_nodes = n_taxa + n_taxa // 4 + 1
    parent = np.full(n_nodes, -1, np.int32)
    for i in range(1, n_taxa // 4 + 1):
        parent[i] = (i - 1) // 2
    for t in range(n_taxa):
        parent[n_taxa // 4 + 1 + t] = 1 + (t % (n_taxa // 4))
    depth = np.zeros(n_nodes, np.int32)
    for i in range(1, n_nodes):
        depth[i] = depth[parent[i]] + 1
    order = np.argsort(depth, kind="stable")
    ren = np.empty(n_nodes, np.int64)
    ren[order] = np.arange(n_nodes)
    parent2 = np.full(n_nodes, -1, np.int32)
    for i in range(n_nodes):
        if parent[i] >= 0:
            parent2[ren[i]] = ren[parent[i]]
    taxids = [str(2000 + i) for i in range(n_nodes)]
    tree = SmallTaxTree(taxids, taxids, [-1] * n_nodes, parent2,
                        np.zeros(n_nodes, bool))
    node_of_value = np.array(
        [int(ren[n_taxa // 4 + 1 + t]) for t in range(n_taxa)], np.int32)
    return tree, node_of_value


def build_world(n_genome_bp: int, n_taxa: int, seed: int = 7, k: int = 31):
    """(table, tree, node_of_value, genome) — used by the cache phase and by
    probe scripts; bench phases load the cached arrays instead."""
    from genestrip_tpu.ops.kmer import window_kmers_np
    from genestrip_tpu.store.table import TableBuilder

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=n_genome_bp, dtype=np.int64).astype(np.uint8)
    kmers, valid = window_kmers_np(genome, k)
    kmers = kmers[valid]
    builder = TableBuilder(k)
    bounds = np.linspace(0, len(kmers), n_taxa + 1).astype(np.int64)
    for t in range(n_taxa):
        builder.add(kmers[bounds[t]:bounds[t + 1]], str(1000 + t))
    table = builder.build()
    tree, node_of_value = build_tax(n_taxa)
    nov = np.full(table.n_values, -1, np.int32)
    nov[: len(node_of_value)] = node_of_value
    return table, tree, nov, genome


def make_reads(genome: np.ndarray, n_reads: int, read_len: int, hit_frac: float,
               seed: int = 3):
    rng = np.random.default_rng(seed)
    n_hit = int(n_reads * hit_frac)
    starts = rng.integers(0, len(genome) - read_len, size=n_hit)
    idx = starts[:, None] + np.arange(read_len)[None, :]
    hit_reads = genome[idx]
    rand_reads = rng.integers(0, 4, size=(n_reads - n_hit, read_len),
                              dtype=np.int64).astype(np.uint8)
    codes = np.concatenate([hit_reads, rand_reads])
    rng.shuffle(codes, axis=0)
    return codes


def emit(metric, value, unit, baseline):
    print(json.dumps({
        "metric": metric,
        "value": round(float(value), 1),
        "unit": unit,
        "vs_baseline": round(float(value) / baseline, 2),
    }), flush=True)


# ---------------------------------------------------------------------------
# world cache
# ---------------------------------------------------------------------------

def cache_dir_for(args) -> str:
    base = args.cache_dir or os.environ.get(
        "GENESTRIP_BENCH_CACHE",
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     ".bench_cache"))
    tag = (f"w{args.db_bp}_{args.taxa}_k31_s7_r{args.e2e_reads}"
           f"_h{args.hostin_reads}_l{args.read_len}_f{args.hit_frac}")
    return os.path.join(base, tag)


def ensure_cache(args) -> str:
    """Build (if missing) and return the world cache dir."""
    d = cache_dir_for(args)
    done = os.path.join(d, "DONE")
    if os.path.exists(done):
        return d
    os.makedirs(d, exist_ok=True)
    t0 = time.time()
    table, tree, nov, genome = build_world(args.db_bp, args.taxa)
    from genestrip_tpu.store.hash import build_hash
    ht = build_hash(table.keys, table.value_idx)
    np.save(os.path.join(d, "keys.npy"), table.keys)
    np.save(os.path.join(d, "value_idx.npy"), table.value_idx)
    np.save(os.path.join(d, "genome.npy"), genome)
    np.save(os.path.join(d, "rows.npy"), ht.rows)
    np.save(os.path.join(d, "soe.npy"), ht.slot_of_entry)
    np.save(os.path.join(d, "nov.npy"), nov)
    meta = {"k": 31, "nb_bits": ht.nb_bits, "n_slots": ht.n_slots,
            "entries": table.entries, "n_values": table.n_values,
            "taxa": args.taxa}
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(meta, f)
    # e2e fastq + single-batch warmup fastq + a bigger host-input fastq
    # (16k reads is too small to measure the host pipeline stably)
    codes = make_reads(genome, args.e2e_reads, args.read_len, args.hit_frac)
    _write_bench_fastq(os.path.join(d, "bench.fastq.gz"), codes,
                       args.read_len)
    _write_bench_fastq(os.path.join(d, "warm.fastq.gz"), codes[: args.batch],
                       args.read_len)
    codes_h = make_reads(genome, args.hostin_reads, args.read_len,
                         args.hit_frac, seed=4)
    _write_bench_fastq(os.path.join(d, "hostin.fastq.gz"), codes_h,
                       args.read_len)
    with open(done, "w") as f:
        f.write("ok\n")
    print(f"# world cache built in {time.time() - t0:.1f}s at {d}",
          flush=True)
    return d


class World:
    """mmap-loaded cached world + cheaply rebuilt taxonomy/value tables."""

    def __init__(self, args):
        d = cache_dir_for(args)
        if not os.path.exists(os.path.join(d, "DONE")):
            raise SystemExit(f"world cache missing at {d}; run --phase cache")
        self.dir = d
        with open(os.path.join(d, "meta.json")) as f:
            self.meta = json.load(f)
        self.rows_np = np.load(os.path.join(d, "rows.npy"), mmap_mode="r")
        self.genome = np.load(os.path.join(d, "genome.npy"), mmap_mode="r")
        self.tree, node_of_value = build_tax(self.meta["taxa"])
        nov = np.load(os.path.join(d, "nov.npy"))
        self.nov = nov
        self.tree.node_of_value = lambda tb: nov          # bench tree glue

    # -- lazy heavy pieces --------------------------------------------------

    def keys(self):
        return np.load(os.path.join(self.dir, "keys.npy"), mmap_mode="r")

    def hash_table(self):
        from genestrip_tpu.store.hash import (
            KmerHashTable, vidx_of_slot_from_rows)
        rows = np.ascontiguousarray(self.rows_np)
        soe = np.load(os.path.join(self.dir, "soe.npy"), mmap_mode="r")
        return KmerHashTable(rows, self.meta["nb_bits"], soe,
                             vidx_of_slot_from_rows(rows, self.meta["nb_bits"]))

    def table(self):
        from genestrip_tpu.store.table import KmerTable
        keys = np.load(os.path.join(self.dir, "keys.npy"))
        vidx = np.load(os.path.join(self.dir, "value_idx.npy"))
        values = [str(1000 + t) for t in range(self.meta["n_values"])]
        return KmerTable(self.meta["k"], keys, vidx, values)

    def match_arrays(self):
        """(sa, spec, anc) device arrays straight from the cache — no table
        object, no hash build; vaux comes from the production helper so the
        bench always measures the production layout."""
        import jax.numpy as jnp
        from genestrip_tpu.match.pipeline import TableSpec, vaux_from_nov

        vaux = vaux_from_nov(self.nov, self.tree)
        nb_bits = self.meta["nb_bits"]
        n_slots = self.meta["n_slots"]
        sa = {"rows": jnp.asarray(np.ascontiguousarray(self.rows_np)),
              "vaux": jnp.asarray(vaux), "n": n_slots, "nb_bits": nb_bits}
        return sa, TableSpec(n_slots, nb_bits), jnp.asarray(
            self.tree.ancestor_at_depth)


def _write_bench_fastq(fq, codes, read_len):
    qual = b"I" * read_len
    with gzip.open(fq, "wb", compresslevel=1) as f:
        base_map = np.frombuffer(b"ACGT", np.uint8)
        for s0 in range(0, len(codes), 4096):
            blk = codes[s0:s0 + 4096]
            txt = base_map[blk]
            recs = []
            for j in range(len(blk)):
                recs.append(b"@r%d\n" % (s0 + j))
                recs.append(txt[j].tobytes())
                recs.append(b"\n+\n")
                recs.append(qual)
                recs.append(b"\n")
            f.write(b"".join(recs))


# ---------------------------------------------------------------------------
# phases (each runs in its own process)
# ---------------------------------------------------------------------------

def phase_cache(args):
    ensure_cache(args)


def phase_device(args):
    """HEADLINE: staged-batch classification throughput on the chip."""
    import jax
    import jax.numpy as jnp
    from genestrip_tpu.io.reads import _bucket_len
    from genestrip_tpu.match.pipeline import (
        MatchConfig, error_bounds, match_step)

    w = World(args)
    sa, spec, anc = w.match_arrays()
    rows, vaux = sa["rows"], sa["vaux"]
    cfg = MatchConfig(k=w.meta["k"], return_labels=False)
    n_nodes = len(w.tree)
    k = w.meta["k"]
    B = args.batch
    codes_all = make_reads(np.asarray(w.genome), args.reads, args.read_len,
                           args.hit_frac)
    L = _bucket_len(args.read_len)
    n_batches = max(args.reads // B, 1)
    staged = np.full((n_batches, B, L), 255, np.uint8)
    staged[:, :, : args.read_len] = codes_all[: n_batches * B].reshape(
        n_batches, B, args.read_len)
    lengths = jnp.full((B,), args.read_len, jnp.int32)
    bounds = jnp.asarray(error_bounds(
        np.full(B, args.read_len, np.int32), k, cfg))
    # ONE bulk h2d upload, then split into per-batch device arrays on the
    # device (outside the timed loop), so no step pays for indexing the big
    # array.
    staged_big = jnp.asarray(staged)
    staged_d = [jax.block_until_ready(staged_big[i])
                for i in range(n_batches)]
    del staged_big
    seen = jnp.zeros(spec.n + 1, jnp.uint8)
    counts = jnp.zeros(1, jnp.int32)

    t0 = time.time()
    out = match_step(cfg, spec, n_nodes, rows, vaux, anc,
                     staged_d[0], lengths, bounds, seen, counts)
    seen, counts = out["seen"], out["counts"]
    jax.block_until_ready(out["class_node"])
    t_compile = time.time() - t0

    # Block every step and report the best of three passes (ROADMAP A1
    # replaces this with a median over a steady window).
    rps = 0.0
    for rep in range(3):
        t0 = time.time()
        for i in range(n_batches):
            ts = time.time()
            out = match_step(cfg, spec, n_nodes, rows, vaux, anc,
                             staged_d[i], lengths, bounds, seen, counts)
            seen, counts = out["seen"], out["counts"]
            jax.block_until_ready(out["class_node"])
            if args.loop_debug and rep == 0 and i < 8:
                print(f"# step {i}: {(time.time() - ts) * 1e3:8.1f} ms",
                      flush=True)
        dt = time.time() - t0
        rps = max(rps, n_batches * B / dt)
    cls = int(jnp.sum((out["class_node"] >= 0).astype(jnp.int32)))
    if args.verbose:
        print(f"# compile={t_compile:.1f}s device loop: {n_batches * B} "
              f"reads, best {n_batches * B / rps * 1e3:.1f} ms/pass; "
              f"classified(last batch)={cls}/{B}; "
              f"entries={w.meta['entries']}; device={jax.devices()[0]}",
              flush=True)
    emit(HEADLINE_METRIC, rps, "reads/s/chip", BASELINE_READS_PER_SEC)


def phase_lookup(args):
    import jax
    import jax.numpy as jnp
    from genestrip_tpu.ops.kmer import split_u64
    from genestrip_tpu.store.hash import lookup_join

    w = World(args)
    sa, spec, _ = w.match_arrays()
    rows = sa["rows"]
    keys = w.keys()
    rngq = np.random.default_rng(5)
    qk = np.concatenate([
        np.asarray(keys[rngq.integers(0, len(keys), 1 << 19)]),
        rngq.integers(0, 1 << 62, 1 << 19, dtype=np.uint64)])
    q_hi, q_lo = split_u64(qk)
    q_hi_d = jnp.asarray(q_hi.view(np.int32))
    q_lo_d = jnp.asarray(q_lo.view(np.int32))

    @jax.jit
    def lk(rows, qh, ql):
        s, f, v = lookup_join(rows, qh, ql, nb_bits=spec.nb_bits)
        return jnp.sum(f.astype(jnp.int32)), jnp.sum(v)

    nfound, _ = jax.block_until_ready(lk(rows, q_hi_d, q_lo_d))
    t0 = time.time()
    reps = 20
    for _ in range(reps):
        jax.block_until_ready(lk(rows, q_hi_d, q_lo_d))
    lookup_ps = len(qk) * reps / (time.time() - t0)
    if args.verbose:
        print(f"# lookup: {len(qk)} queries, found={int(nfound)}", flush=True)
    emit("k-mer lookup throughput (16M-key table, 1M queries/batch)",
         lookup_ps, "lookups/s/chip", BASELINE_LOOKUPS_PER_SEC)


def phase_dbbuild(args):
    import tempfile
    from genestrip_tpu.db.build import BuildOptions, DBFiller, DBUpdater
    from genestrip_tpu.tax.tree import TaxTree
    from pathlib import Path

    bp = args.dbbuild_bp
    rngg = np.random.default_rng(11)
    with tempfile.TemporaryDirectory() as td:
        paths = []
        n_files = 8
        per = bp // n_files
        base_map = np.frombuffer(b"ACGT", np.uint8)
        for i in range(n_files):
            seq = base_map[rngg.integers(0, 4, per)].tobytes()
            p = os.path.join(td, f"g{i}.fna.gz")
            with gzip.open(p, "wb", compresslevel=1) as f:
                f.write(b">NC_%06d.1 synthetic genome\n" % i)
                for j in range(0, len(seq), 80):
                    f.write(seq[j:j + 80] + b"\n")
            paths.append(p)
        taxdir = os.path.join(td, "tax")
        os.makedirs(taxdir)
        rows_t = [("1", "1", "no rank")] + [
            (str(100 + i), "1", "species") for i in range(n_files)]
        with open(os.path.join(taxdir, "nodes.dmp"), "w") as f:
            for tid, par, rank in rows_t:
                f.write(f"{tid}\t|\t{par}\t|\t{rank}\t|\t\t|\t8\t|\t0\t|"
                        f"\t1\t|\t0\t|\t0\t|\t0\t|\t0\t|\t0\t|\t\t|\n")
        with open(os.path.join(taxdir, "names.dmp"), "w") as f:
            for tid, _, _ in rows_t:
                f.write(f"{tid}\t|\tn{tid}\t|\t\t|\tscientific name\t|\n")
        tree2 = TaxTree(Path(taxdir))
        nodes = [tree2.get(str(100 + i)) for i in range(n_files)]
        opts = BuildOptions(k=31)
        t0 = time.time()
        filler = DBFiller(tree2, set(), None, opts)
        filler.feed_items([(p, nodes[i % len(nodes)])
                           for i, p in enumerate(paths)], threads=-1)
        tb2 = filler.build()
        # host update path benchmarked here; phase_devupdate times the
        # device step
        upd = DBUpdater(tree2, tb2, set(), None, opts, device_update=False)
        upd.feed_items([(p, nodes[(i + 1) % len(nodes)])
                        for i, p in enumerate(paths)], threads=-1)
        upd.finalize()
        dt = time.time() - t0
    emit(f"DB build wall-clock ({bp/1e6:.0f}M bases fill+update, host)",
         bp * 2 / dt, "bases/s", BASELINE_DB_BASES_PER_SEC)
    if args.verbose:
        print(f"# db build: {dt:.1f}s, {tb2.entries} kmers, "
              f"moved={upd.kmers_moved}", flush=True)


def _host_input_rate(fq: str, B: int, cores=None) -> float:
    """reads/s of the gzip -> parse -> packed-batch pipeline; optionally
    pinned to a core set (per-core scaling measurement)."""
    from genestrip_tpu.io.reads import BatchPacker, parse_fastq_blocks
    from genestrip_tpu.io.streams import ReadAhead
    if cores is not None:
        os.sched_setaffinity(0, cores)
    t0 = time.time()
    n = 0
    packer = BatchPacker(B)
    with gzip.open(fq, "rb") as f, ReadAhead(f) as src:
        for b_ in parse_fastq_blocks(src, packer):
            n += b_.n
    return n / (time.time() - t0)


def _pinned_host_worker(fq, B, core, q, barrier):
    # imports happen before the barrier; all workers then parse
    # concurrently and report their own timed rate
    from genestrip_tpu.io import reads as _warm  # noqa: F401
    os.sched_setaffinity(0, {core})
    barrier.wait()
    q.put(_host_input_rate(fq, B))


def _allowed_cores():
    return sorted(os.sched_getaffinity(0))


def phase_e2e(args):
    import multiprocessing as mp

    import jax
    from genestrip_tpu.match.matcher import Matcher
    from genestrip_tpu.match.pipeline import MatchConfig

    w = World(args)
    B = args.batch
    fq = os.path.join(w.dir, "bench.fastq.gz")
    fqh = os.path.join(w.dir, "hostin.fastq.gz")
    # 4a. host input pipeline alone (gzip -> parse -> packed batches);
    # this is the host-side ceiling a local-link chip would see
    # (ref producer contract: fastq/AbstractFastqReader.java:88-185)
    parse_rps = max(_host_input_rate(fqh, B) for _ in range(2))
    emit("host input pipeline (gzip fastq -> packed 2-bit batches)",
         parse_rps, "reads/s", BASELINE_READS_PER_SEC)
    # 4b. multi-stream scaling: N workers, one per core, each decoding its
    # own stream — the product's multi-file/multi-host scaling unit.
    cores = _allowed_cores()         # the allowed set may not be {0..n-1}
    ncpu = len(cores)
    nw = min(max(ncpu, 1), 8)
    if nw >= 2:
        ctx = mp.get_context("spawn")
        qq = ctx.Queue()
        barrier = ctx.Barrier(nw)
        ps = [ctx.Process(target=_pinned_host_worker,
                          args=(fqh, B, cores[i % ncpu], qq, barrier))
              for i in range(nw)]
        # the workers parse on the host only: keep them off the accelerator
        # so this process stays the only one holding it
        saved = os.environ.get("JAX_PLATFORMS")
        os.environ["JAX_PLATFORMS"] = "cpu"
        try:
            for p_ in ps:
                p_.start()
        finally:
            if saved is None:
                del os.environ["JAX_PLATFORMS"]
            else:
                os.environ["JAX_PLATFORMS"] = saved
        rates = [qq.get(timeout=120) for _ in ps]
        for p_ in ps:
            p_.join()
        agg = sum(rates)     # concurrent post-barrier rates; startup excluded
        emit(f"host input aggregate ({nw} pinned workers, 1/core - "
             "multi-file scaling unit)", agg, "reads/s",
             BASELINE_READS_PER_SEC)
    # 4b. full pipeline including device round trips; one full-batch
    # warmup run first so XLA compilation stays out of the timed region
    cfg = MatchConfig(k=w.meta["k"], return_labels=False)
    m = Matcher(w.table(), w.tree, cfg, batch_size=B,
                devices=jax.local_devices()[:1],
                prebuilt_hash=w.hash_table())
    m.progress = False
    m.run([os.path.join(w.dir, "warm.fastq.gz")])
    m.reset()
    t0 = time.time()
    m.run([fq])
    e2e_rps = m.total_reads / (time.time() - t0)
    emit("end-to-end classification (gzip fastq -> CSV stats, incl. "
         "h2d+d2h)", e2e_rps, "reads/s/chip", BASELINE_READS_PER_SEC)


def phase_shard(args):
    """Sharded-DB match step (SURVEY §5.8): hash rows bucket-range-sharded
    over a mesh, queries all-gathered, shard partials psum-merged. On the
    1-chip bench this exercises the full collective graph shape (trivial
    collectives) — the metric is the overhead of the sharded graph vs the
    replicated one (phase_device), not multi-chip scaling."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from genestrip_tpu.io.reads import _bucket_len
    from genestrip_tpu.match.pipeline import MatchConfig, error_bounds
    from genestrip_tpu.parallel import mesh as mesh_mod

    w = World(args)
    sa, spec, anc = w.match_arrays()
    cfg = MatchConfig(k=w.meta["k"], return_labels=False)
    n_nodes = len(w.tree)
    B = args.batch
    mesh = mesh_mod.make_mesh(jax.local_devices()[:1])
    step = mesh_mod.make_sharded_match_step(mesh, cfg, spec, n_nodes,
                                            shard_db=True)
    rows = jax.device_put(sa["rows"], NamedSharding(mesh, P("reads")))
    vaux = jax.device_put(sa["vaux"], NamedSharding(mesh, P()))
    anc = jax.device_put(anc, NamedSharding(mesh, P()))
    codes_all = make_reads(np.asarray(w.genome), 16 * B, args.read_len,
                           args.hit_frac)
    L = _bucket_len(args.read_len)
    n_batches = 16
    staged = np.full((n_batches, B, L), 255, np.uint8)
    staged[:, :, : args.read_len] = codes_all.reshape(n_batches, B,
                                                      args.read_len)
    bsh = NamedSharding(mesh, P("reads"))
    lengths = jax.device_put(np.full(B, args.read_len, np.int32), bsh)
    bounds = jax.device_put(error_bounds(
        np.full(B, args.read_len, np.int32), w.meta["k"], cfg), bsh)
    seen, counts = mesh_mod.unique_state(spec.n, mesh, False)
    # pre-stage all batches on device, exactly like phase_device (one bulk
    # upload + on-device split) — the metric must isolate the sharded
    # GRAPH's overhead, not per-step h2d
    staged_big = jax.device_put(staged, NamedSharding(
        mesh, P(None, "reads")))
    staged_d = [jax.block_until_ready(
        jax.device_put(staged_big[i], bsh)) for i in range(n_batches)]
    del staged_big
    out = step(rows, vaux, anc, staged_d[0], lengths, bounds, seen, counts)
    seen, counts = out["seen"], out["counts"]
    jax.block_until_ready(out["class_node"])
    rps = 0.0
    for rep in range(3):
        t0 = time.time()
        for i in range(n_batches):
            out = step(rows, vaux, anc, staged_d[i],
                       lengths, bounds, seen, counts)
            seen, counts = out["seen"], out["counts"]
            jax.block_until_ready(out["class_node"])
        rps = max(rps, n_batches * B / (time.time() - t0))
    emit("sharded-DB classification (bucket-range rows + all-gather/psum "
         "graph, 1-chip shape)", rps, "reads/s/chip", BASELINE_READS_PER_SEC)


def phase_devupdate(args):
    """Device-resident LCA update (db/build._DeviceUpdateEngine): the
    production scatter-join searches region chunks against the hash on
    device and rewrites the value vector in place. Chunks are pre-staged on
    device and the engine's jitted step is driven directly, so the metric is
    the DEVICE update rate — excluding the h2d chunk uploads and the
    one-time finalize pull."""
    import jax
    import jax.numpy as jnp
    from genestrip_tpu.db.build import _DeviceUpdateEngine

    w = World(args)
    table = w.table()
    eng = _DeviceUpdateEngine(table, ht=w.hash_table())
    rng = np.random.default_rng(17)
    n_chunks, per = 8, 1 << 20
    keys = w.keys()
    staged = []
    for _ in range(n_chunks):
        c = np.concatenate([
            np.asarray(keys[rng.integers(0, len(keys), per // 2)]),
            rng.integers(0, 1 << 62, per // 2, dtype=np.uint64)])
        c = np.unique(c)
        c = np.concatenate([c, np.full(per - len(c), np.uint64(2**64 - 1))])
        hi = (c >> np.uint64(32)).astype(np.uint32).view(np.int32)
        lo = (c & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
        staged.append((jnp.asarray(hi), jnp.asarray(lo)))
    nv = table.n_values
    pair_map = np.arange(nv, dtype=np.int32)
    pair_map[rng.integers(0, nv, nv // 4)] = 0      # a quarter move to "root"
    pm = 1 << max(int(np.ceil(np.log2(nv))), 8)
    pair_map = np.concatenate([pair_map, np.full(pm - nv, -1, np.int32)])
    pm_d = jnp.asarray(pair_map)
    hi0, lo0 = staged[0]
    eng.vidx, eng.moved = eng._step(eng.rows, eng.slot_to_pos, eng.vidx,
                                    eng.moved, hi0, lo0, pm_d,
                                    nb_bits=eng.nb_bits)
    jax.block_until_ready(eng.vidx)                  # compile + warmup
    t0 = time.time()
    for i_, (hi, lo) in enumerate(staged):
        ts = time.time()
        eng.vidx, eng.moved = eng._step(eng.rows, eng.slot_to_pos, eng.vidx,
                                        eng.moved, hi, lo, pm_d,
                                        nb_bits=eng.nb_bits)
        # block every step — same discipline as phase_device
        jax.block_until_ready(eng.vidx)
        if args.loop_debug:
            print(f"# upd step {i_}: {(time.time() - ts) * 1e3:8.1f} ms",
                  flush=True)
    dt = time.time() - t0
    total = n_chunks * per
    # every step above is block_until_ready'd, so dt covers the device work
    emit("LCA update on device (scatter-join search + value rewrite, excl. "
         "h2d/final pull)", total / dt, "kmers/s/chip",
         BASELINE_DB_BASES_PER_SEC)
    if args.verbose:
        print(f"# devupdate: {total} kmers in {dt:.2f}s, "
              f"moved={eng.drain_moved()}", flush=True)


PHASES = {
    "cache": phase_cache,
    "device": phase_device,
    "lookup": phase_lookup,
    "dbbuild": phase_dbbuild,
    "e2e": phase_e2e,
    "shard": phase_shard,
    "devupdate": phase_devupdate,
}

# (phase, timeout_s) in run order; device = headline runs first so a later
# stall can never eat it. The global --total-budget (default 18 min) skips
# remaining phases once the clock runs low.
PHASE_PLAN = [
    ("cache", 900),
    ("device", 480),
    ("lookup", 240),
    ("dbbuild", 300),
    ("e2e", 360),
    ("shard", 420),        # secondary metrics: the global budget skips
    ("devupdate", 420),    # them first when the clock runs low
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--db-bp", type=int, default=16_000_000)
    ap.add_argument("--taxa", type=int, default=256)
    ap.add_argument("--reads", type=int, default=256 * 1024)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--hit-frac", type=float, default=0.5)
    ap.add_argument("--e2e-reads", type=int, default=16 * 1024)
    ap.add_argument("--hostin-reads", type=int, default=192 * 1024)
    ap.add_argument("--dbbuild-bp", type=int, default=32_000_000)
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--skip", action="append", default=[],
                    choices=sorted(PHASES), help="phase(s) to skip")
    ap.add_argument("--loop-debug", action="store_true")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--phase", choices=sorted(PHASES))
    ap.add_argument("--total-budget", type=int, default=1080,
                    help="global deadline (s); remaining phases are skipped")
    args = ap.parse_args()

    if args.phase:
        PHASES[args.phase](args)
        return

    t_start = time.time()
    headline_line = None
    passthrough = [a for a in sys.argv[1:]]

    def run_phase(ph, tmo):
        nonlocal headline_line
        left = args.total_budget - (time.time() - t_start)
        cmd = [sys.executable, os.path.abspath(__file__),
               "--phase", ph] + passthrough
        env = dict(os.environ)
        if ph in ("cache", "dbbuild"):
            # host-only phases stay off the accelerator
            env["JAX_PLATFORMS"] = "cpu"
        try:
            r = subprocess.run(cmd, timeout=min(tmo, max(left, 60)),
                               env=env, capture_output=True, text=True)
            sys.stderr.write(r.stderr[-2000:] if r.stderr else "")
            out = r.stdout or ""
            rc = r.returncode
        except subprocess.TimeoutExpired as e:
            out = e.stdout or ""
            if isinstance(out, bytes):
                out = out.decode(errors="replace")
            rc = "timeout"
        for line in out.splitlines():
            if not line.strip():
                continue
            print(line, flush=True)
            if HEADLINE_METRIC in line and line.lstrip().startswith("{"):
                headline_line = line
        if rc == "timeout":
            print(f"# phase {ph} timed out - skipping",
                  file=sys.stderr, flush=True)
        elif rc != 0:
            print(f"# phase {ph} exited with {rc}",
                  file=sys.stderr, flush=True)

    for ph, tmo in PHASE_PLAN:
        if ph in args.skip:
            continue
        left = args.total_budget - (time.time() - t_start)
        if ph != "cache" and headline_line is not None and left < 60:
            print(f"# global budget exhausted before phase {ph} - skipping",
                  file=sys.stderr, flush=True)
            continue
        run_phase(ph, tmo)
        if ph == "device" and headline_line is None:
            # the headline is the one metric that must land: retry once
            # in a fresh subprocess before moving on (ROADMAP A1 decides
            # whether this stays)
            print("# headline missing - retrying device phase once",
                  file=sys.stderr, flush=True)
            run_phase(ph, tmo)
        # keep the headline as the LAST stdout line at every point in time
        if headline_line is not None and ph != "device":
            print(headline_line, flush=True)


if __name__ == "__main__":
    main()
