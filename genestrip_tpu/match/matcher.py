"""Host orchestration of the batched matcher: streams reads, runs the device
step, accumulates statistics, writes filtered fastq / Kraken-style output.

Reference equivalent: core match/FastqKMerMatcher.java (runMatcher:181-235 +
the producer/consumer engine of fastq/AbstractFastqReader.java). Threads and
striped locks are replaced by batched device steps; per-read classified
statistics are accumulated on the host in read order, which reproduces the
reference's single-threaded (deterministic) accumulation exactly.
"""

from __future__ import annotations

import numpy as np

from genestrip_tpu.io.reads import (
    BatchPacker, ReadBatch, batch_feeder, parse_reads,
)
from genestrip_tpu.io.streams import Progress, ReadAhead, StreamingResource
from genestrip_tpu.match.pipeline import (
    LABEL_INVALID, LABEL_MISS, MatchConfig, error_bounds, match_accum_step,
    match_step, node_state_init, unpack_per_read_np,
)
from genestrip_tpu.match.results import CountsPerTaxid, MatchingResult
from genestrip_tpu.store.table import KmerTable
from genestrip_tpu.tax.small import SmallTaxTree
from genestrip_tpu.parallel import distributed as dist
from genestrip_tpu.parallel import mesh as mesh_mod

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P


class Matcher:
    """Matches fastq/fasta resources against a database."""

    def __init__(self, table: KmerTable, tree: SmallTaxTree, cfg: MatchConfig,
                 db_md5: str = "", batch_size: int = 4096, max_kmer_res_counts: int = 0,
                 write_all: bool = True, devices=None,
                 shard_db: str | bool = "auto",
                 shard_db_min_bytes: int = 0,
                 prebuilt_hash=None):
        """devices: device list for data-parallel matching (default: all
        local devices; with more than one, batches are sharded over a
        jax.sharding.Mesh and per-node stats psum-merged — the replacement
        for the reference's consumer-thread fan-out,
        ref fastq/AbstractFastqReader.java:88-185).
        shard_db / shard_db_min_bytes: see parallel/mesh.should_shard_db
        (0 derives the threshold from the devices' memory)."""
        self.table = table
        self.tree = tree
        self.db_md5 = db_md5
        self.max_kmer_res_counts = max_kmer_res_counts
        self.write_all = write_all
        self.cfg = cfg
        # progress/throughput logging (ref AbstractLoggingFastqStreamer)
        self.progress = True
        self.progress_interval_ms = 1000
        # ref GSConfigKey withProbs: carry input quality strings through to
        # filtered-fastq output instead of synthesizing '~'
        self.with_probs = False
        # ref GSConfigKey threads (ConfigParams.md:4): the reference's
        # consumer-thread count. Here it gates the async input pipeline —
        # 0 = parse synchronously; otherwise parse/pack runs on a worker
        # thread with a bounded prefetch queue overlapping the device steps
        # (-1 = default on, like the reference's "#processors - 1").
        self.threads = -1
        # Long-read handling (SURVEY.md §5.7): reads longer than this many
        # bases are cut into singleton batches; with classification off
        # (matchlr, ref Goals.md:15) they are matched in fixed-size window
        # chunks whose per-node stats merge on the host — memory stays
        # bounded for arbitrarily long (e.g. 1 Mbp nanopore) reads.
        self.long_read_threshold = 10_000
        self.long_chunk_windows = 8192
        T = len(tree)
        self.n_nodes = T
        # local devices only: multi-host runs file-level data parallelism with
        # per-process meshes + an aggregation-time merge (parallel/distributed)
        devices = devices if devices is not None else jax.local_devices()
        self._mesh = mesh_mod.make_mesh(devices) if len(devices) > 1 else None
        self._n_dev = len(devices) if self._mesh is not None else 1
        # batch size must split evenly over the device mesh
        self.batch_size = -(-batch_size // self._n_dev) * self._n_dev
        self._sharded_steps: dict = {}
        # device-side constants (quotient-hash rows + small value-aux table)
        from genestrip_tpu.match.pipeline import build_match_arrays
        sa, self._spec = build_match_arrays(table, tree, ht=prebuilt_hash)
        self._rows, self._vaux = sa["rows"], sa["vaux"]
        self._vidx_of_slot = sa["vidx_of_slot"]
        self._n_table = sa["n"]
        self._anc = jnp.asarray(tree.ancestor_at_depth)
        # sharded-DB mode (SURVEY §5.8): bucket-range-shard the hash rows
        # over the mesh when the table is too big to replicate per device.
        # Ref role: store/RadixKMerStore.java:38-88 (radix bits as the
        # shard key).
        nb_rows = int(self._rows.shape[0])
        self.shard_db = bool(
            self._mesh is not None
            and nb_rows % self._n_dev == 0
            and mesh_mod.should_shard_db(shard_db, self._rows.nbytes,
                                         devices, shard_db_min_bytes))
        if self._mesh is not None:
            repl = NamedSharding(self._mesh, P())
            rows_sh = (NamedSharding(self._mesh, P("reads"))
                       if self.shard_db else repl)
            self._rows = jax.device_put(self._rows, rows_sh)
            self._vaux = jax.device_put(self._vaux, repl)
            self._anc = jax.device_put(self._anc, repl)
            self._batch_sharding = NamedSharding(self._mesh, P("reads"))
        self.reset()

    def reset(self):
        T = self.n_nodes
        N = self._n_table
        self.kmers = np.zeros(T, np.int64)
        self.contigs = np.zeros(T, np.int64)
        self.contig_sq = np.zeros(T, np.int64)
        self.max_contig = np.zeros(T, np.int64)
        self.max_contig_desc = [b""] * T
        # global-order key of each node's max-contig achiever (resource
        # index, read number): lets the multi-host merge pick the same
        # first-achiever a single-host run over all files would
        self.max_contig_src = np.full(T, np.iinfo(np.int64).max, np.int64)
        self._res_idx = 0
        self.reads1 = np.zeros(T, np.int64)
        self.reads = np.zeros(T, np.int64)
        self.reads_kmers = np.zeros(T, np.int64)
        self.reads_bps = np.zeros(T, np.int64)
        self.error_sum = np.zeros(T, np.float64)
        self.error_sq_sum = np.zeros(T, np.float64)
        self.class_error_sum = np.zeros(T, np.float64)
        self.class_error_sq_sum = np.zeros(T, np.float64)
        self.total_reads = 0
        self.total_kmers = 0
        self.total_bps = 0
        self._seen, self._counts = mesh_mod.unique_state(
            N, self._mesh, self.cfg.with_counts)
        # device node-statistic accumulators (drained every few batches; the
        # int32 contig^2 budget decides when) + descriptor ring for resolving
        # max-contig achievers at drain time
        self._nstate = (mesh_mod.node_state_sharded(T, self._mesh)
                        if self._mesh is not None else node_state_init(T))
        self._ws_budget = 0
        self._batch_no = 0
        self._ring: dict[int, tuple] = {}

    # ------------------------------------------------------------------
    # device node-accumulator drain

    _WS_CAP = 2**31 - 1

    def _drain(self):
        """Pull + fold the device node accumulators into the host arrays,
        resolve max-contig achiever descriptors from the batch ring, and
        reset the device state (additive parts zeroed; the max-contig trio
        re-seeded from the host so the strict-> fold keeps first-achiever
        semantics across drains and host-side long-read updates)."""
        if not self._ring:
            return          # nothing folded since the last drain
        if self._mesh is not None:
            d = mesh_mod.drain_node_state(self._nstate)
        else:
            d = {k: np.asarray(v) for k, v in self._nstate.items()}
        self.kmers += d["kmers"].astype(np.int64)
        self.contigs += d["contigs"].astype(np.int64)
        self.contig_sq += d["contig_sq"].astype(np.int64)
        self.reads1 += d["reads1"].astype(np.int64)
        mc_len, mc_enc, mc_bno = d["mc_len"], d["mc_enc"], d["mc_bno"]
        improved = (mc_bno >= 0) & (mc_len.astype(np.int64) > self.max_contig)
        for t in np.nonzero(improved)[0]:
            t = int(t)
            descriptors, read_no0, res_idx, W = self._ring[int(mc_bno[t])]
            b = int(mc_enc[t]) // W
            desc = descriptors[b]
            sp = desc.find(b" ")
            self.max_contig[t] = int(mc_len[t])
            self.max_contig_desc[t] = desc[1:sp if sp >= 0 else len(desc)]
            self.max_contig_src[t] = (res_idx << 40) | (read_no0 + b)
        self._ring.clear()
        self._ws_budget = 0
        # reset device state: zero adds, seed mc_len from host, mark resolved
        T = self.n_nodes
        seed = node_state_init(T)
        seed["mc_len"] = jnp.asarray(
            np.minimum(self.max_contig, 2**31 - 1).astype(np.int32))
        seed["mc_bno"] = jnp.full(T, -1, jnp.int32)
        if self._mesh is not None:
            n_dev = self._n_dev
            sh = NamedSharding(self._mesh, P("reads"))
            self._nstate = {
                k: jax.device_put(
                    np.broadcast_to(np.asarray(v), (n_dev,) + v.shape).copy(),
                    sh)
                for k, v in seed.items()}
        else:
            self._nstate = seed

    # ------------------------------------------------------------------

    def run(self, resources, filtered_out=None, kraken_out=None):
        """Match all resources; returns a MatchingResult.

        filtered_out/kraken_out are writable binary streams or None.

        Host and device overlap by one batch (double buffering): batch N+1 is
        parsed, packed and dispatched before batch N's outputs are pulled back
        and accumulated — JAX dispatch is async, so the device runs batch N
        while the host packs N+1 (ref equivalent: the producer/consumer
        overlap of fastq/AbstractFastqReader.java:88-185).
        """
        pending = None
        nproc, pid = dist.process_count(), dist.process_index()

        def all_batches():
            """Tagged (res_idx, progress, batch|None) across this process's
            resource shard; None closes a resource's progress. Running this
            on the feeder thread means resource i+1's open + decompress +
            parse overlap resource i's device steps (no inter-file stall;
            ref: the reference keeps its consumer pool busy across files,
            AbstractLoggingFastqStreamer.processFastqStreams:95-140)."""
            for res_idx, res in enumerate(resources):
                if res_idx % nproc != pid:
                    continue        # another host's shard (file-level DP)
                if not isinstance(res, StreamingResource):
                    res = StreamingResource(res)
                fasta = res.type_hint == "fasta"
                packer = BatchPacker(self.batch_size,
                                     with_probs=self.with_probs,
                                     long_threshold=self.long_read_threshold)
                progress = Progress(f"match {res.name}", res,
                                    enabled=self.progress,
                                    interval_ms=self.progress_interval_ms)
                with res.open() as stream:
                    src = (ReadAhead(stream) if self.threads != 0
                           else stream)
                    try:
                        for batch in parse_reads(src, packer, fasta):
                            yield res_idx, progress, batch
                    finally:
                        if src is not stream:
                            src.close()   # stop the read-ahead thread
                yield res_idx, progress, None

        gen = all_batches()
        if self.threads != 0:
            gen = batch_feeder(gen, prefetch=4)
        for res_idx, progress, batch in gen:
            if batch is None:
                progress.done()
                continue
            self._res_idx = res_idx
            if batch.is_long and not self.cfg.classify:
                # chunked long-read path (host-merged stats); keep
                # output order by finalizing the pending batch first
                if pending is not None:
                    self._finalize_batch(*pending, filtered_out, kraken_out)
                    pending = None
                self._match_long_read(batch, filtered_out, kraken_out)
                progress.update(1)
                continue
            out = self._dispatch_batch(batch, kraken_out is not None)
            if pending is not None:
                self._finalize_batch(*pending, filtered_out, kraken_out)
            pending = (batch, out)
            progress.update(batch.n)
        if pending is not None:
            self._finalize_batch(*pending, filtered_out, kraken_out)
        return self._build_result()

    def _dispatch_batch(self, batch: ReadBatch, need_labels: bool):
        """Pack + enqueue the accumulating device step; returns the (async)
        (packed [B, 2] per-read output, label|None)."""
        cfg = self.cfg
        need_labels = need_labels or cfg.return_labels
        if need_labels != cfg.return_labels:
            cfg = MatchConfig(**{**cfg.__dict__, "return_labels": need_labels})
        # Pad partial batches to the fixed batch size (zero-length rows are
        # inert) so XLA compiles one shape per length bucket, not per batch.
        n_real = batch.n
        codes, lengths = batch.codes, batch.lengths
        # long singleton batches keep B minimal (mesh divisibility only) so
        # padding cost does not scale with batch_size * read length
        b_target = self._n_dev if batch.is_long else self.batch_size
        if n_real < b_target:
            pad = b_target - n_real
            codes = np.concatenate(
                [codes, np.full((pad, codes.shape[1]), 255, np.uint8)])
            lengths = np.concatenate([lengths, np.zeros(pad, np.int32)])
        B, L = codes.shape
        W = L - cfg.k + 1
        if self._ws_budget + B * W * W > self._WS_CAP:
            self._drain()          # keep the int32 contig^2 accumulator exact
        bounds = error_bounds(lengths, cfg.k, cfg)
        bno = self._batch_no
        if self._mesh is not None:
            step = self._sharded_steps.get(("acc", cfg))
            if step is None:
                step = mesh_mod.make_sharded_accum_step(
                    self._mesh, cfg, self._spec, self.n_nodes,
                    shard_db=self.shard_db)
                self._sharded_steps[("acc", cfg)] = step
            res = step(self._rows, self._vaux, self._anc,
                       jax.device_put(codes, self._batch_sharding),
                       jax.device_put(lengths, self._batch_sharding),
                       jax.device_put(bounds, self._batch_sharding),
                       self._seen, self._counts, self._nstate,
                       jnp.int32(bno))
            packed, label = res["packed"], res.get("label")
            self._seen, self._counts = res["seen"], res["counts"]
            self._nstate = res["nstate"]
        else:
            packed, label, self._seen, self._counts, self._nstate = \
                match_accum_step(cfg, self._spec, self.n_nodes,
                                 self._rows, self._vaux, self._anc,
                                 jnp.asarray(codes), jnp.asarray(lengths),
                                 jnp.asarray(bounds), self._seen,
                                 self._counts, self._nstate, jnp.int32(bno))
        self._ring[bno] = (batch.descriptors, batch.read_no0,
                           self._res_idx, W)
        self._batch_no = bno + 1
        self._ws_budget += B * W * W
        return packed, label

    def _match_long_read(self, batch: ReadBatch, filtered_out, kraken_out):
        """Match one long read in fixed-window chunks (classification off).

        Chunks overlap by k-1 bases so their window sets partition the
        read's windows exactly; chunk rows form the batch dimension (sharded
        over the mesh like ordinary reads). Contig stats are computed on the
        host from the concatenated label row, so runs spanning chunk
        boundaries merge exactly as in the unchunked case
        (ref FastqKMerMatcher.java:390-420; SURVEY.md §5.7)."""
        # drain device node accumulators first: the long-read path updates
        # the host arrays directly, and max-contig first-achiever ordering
        # needs the host state current before comparing
        self._drain()
        cfg, k = self.cfg, self.cfg.k
        n = int(batch.lengths[0])
        seq_codes = batch.codes[0, :n]
        n_win = n - k + 1
        C = self.long_chunk_windows
        n_chunks = -(-n_win // C)
        Bc = max(self._n_dev, 8)
        while Bc < n_chunks:
            Bc *= 2
        Lc = C + k - 1
        mat = np.full((Bc, Lc), 255, np.uint8)
        clens = np.zeros(Bc, np.int32)
        for i in range(n_chunks):
            start = i * C
            end = min(start + Lc, n)
            mat[i, : end - start] = seq_codes[start:end]
            clens[i] = end - start
        cfg2 = MatchConfig(k=k, max_paths=cfg.max_paths, classify=False,
                           with_unique=cfg.with_unique,
                           with_counts=cfg.with_counts, return_labels=True)
        bounds = error_bounds(clens, cfg2.k, cfg2)
        if self._mesh is not None:
            step = self._sharded_steps.get(cfg2)
            if step is None:
                step = mesh_mod.make_sharded_match_step(
                    self._mesh, cfg2, self._spec, self.n_nodes,
                    shard_db=self.shard_db)
                self._sharded_steps[cfg2] = step
            out = step(self._rows, self._vaux, self._anc,
                       jax.device_put(mat, self._batch_sharding),
                       jax.device_put(clens, self._batch_sharding),
                       jax.device_put(bounds, self._batch_sharding),
                       self._seen, self._counts)
        else:
            out = match_step(cfg2, self._spec, self.n_nodes,
                             self._rows, self._vaux, self._anc,
                             jnp.asarray(mat), jnp.asarray(clens),
                             jnp.asarray(bounds), self._seen, self._counts)
        self._seen = out["seen"]
        self._counts = out["counts"]

        # windows of chunk i sit at label row i columns [0, C) (full rows
        # have exactly C valid windows); trailing invalid columns only in
        # the last chunk row
        lab = np.asarray(out["label"])[:n_chunks, :C].reshape(-1)[:n_win]

        self.total_reads += 1
        self.total_kmers += n_win
        self.total_bps += n

        ch = np.nonzero(np.diff(lab))[0] + 1
        starts = np.concatenate([[0], ch])
        ends = np.concatenate([ch, [n_win]])
        vals = lab[starts]
        runs = (ends - starts).astype(np.int64)
        hit = vals >= 0
        hv, hr = vals[hit].astype(np.int64), runs[hit]
        np.add.at(self.kmers, hv, hr)
        np.add.at(self.contigs, hv, 1)
        np.add.at(self.contig_sq, hv, hr * hr)
        np.add.at(self.reads1, np.unique(hv), 1)
        desc = batch.descriptors[0]
        sp = desc.find(b" ")
        name = desc[1:sp if sp >= 0 else len(desc)]
        # first achiever in read order wins (strict >), as in the batch path
        order = np.argsort(starts[hit], kind="stable")
        for j in order:
            t, ln = int(hv[j]), int(hr[j])
            if ln > self.max_contig[t]:
                self.max_contig[t] = ln
                self.max_contig_desc[t] = name
                self.max_contig_src[t] = ((self._res_idx << 40)
                                          | batch.read_no0)

        found = bool(hit.any())
        if filtered_out is not None and found:
            filtered_out.write(desc + b"\n" + batch.seqs[0] + b"\n+\n")
            probs = batch.probs
            if probs is not None and probs[0]:
                filtered_out.write(probs[0])
            else:
                filtered_out.write(b"~" * len(batch.seqs[0]))
            filtered_out.write(b"\n")
        if kraken_out is not None:
            taxids = self.tree.taxids
            segs = []
            for s0, e0 in zip(starts, ends):
                v = int(lab[s0])
                tag = (b"A" if v == LABEL_INVALID else
                       b"0" if v == LABEL_MISS else taxids[v].encode())
                segs.append(tag + b":" + str(e0 - s0).encode())
            kraken_out.write(b"U\t" + name + b"\t0\t" + str(n).encode() +
                             b"\t" + b" ".join(segs) + b"\n")

    def _finalize_batch(self, batch: ReadBatch, out, filtered_out, kraken_out):
        """Unpack ONE packed int32 per-read transfer (see pipeline
        pack_per_read) and accumulate the host-side per-read statistics in
        read order (ref :508-530); per-node statistics stay on device until
        the next drain."""
        cfg = self.cfg
        packed, label = out
        n_real = batch.n
        pk = np.asarray(packed)[:n_real]
        L = batch.codes.shape[1]
        cls, found, stats_ok, tax_err, read_kmers = unpack_per_read_np(
            pk, self.n_nodes, L - cfg.k + 1, L)
        n_win = np.maximum(batch.lengths.astype(np.int64) - (cfg.k - 1), 0)

        # totals (ref: AbstractFastqReader.doReadFastq:343-349)
        self.total_reads += n_real
        self.total_kmers += int(n_win.sum())
        self.total_bps += int(batch.lengths.sum())

        # per-read classified stats, in read order (ref :508-530)
        if cfg.classify:
            ok = stats_ok & (cls >= 0)
            idx = np.nonzero(ok)[0]
            if len(idx):
                nodes = cls[idx]
                nw = n_win[idx].astype(np.float64)
                err = tax_err[idx] / nw
                rk = read_kmers[idx]
                cerr = (n_win[idx] - rk) / nw
                np.add.at(self.reads, nodes, 1)
                np.add.at(self.reads_kmers, nodes, rk)
                np.add.at(self.reads_bps, nodes, batch.lengths[idx].astype(np.int64))
                np.add.at(self.error_sum, nodes, err)
                np.add.at(self.error_sq_sum, nodes, err * err)
                np.add.at(self.class_error_sum, nodes, cerr)
                np.add.at(self.class_error_sq_sum, nodes, cerr * cerr)

        # outputs
        if filtered_out is not None and found.any():
            probs = batch.probs
            for b in np.nonzero(found)[0]:
                filtered_out.write(batch.descriptors[b])
                filtered_out.write(b"\n")
                filtered_out.write(batch.seqs[b])
                filtered_out.write(b"\n+\n")
                if probs is not None and probs[b]:
                    filtered_out.write(probs[b])
                else:
                    filtered_out.write(b"~" * len(batch.seqs[b]))
                filtered_out.write(b"\n")

        if kraken_out is not None:
            self._write_kraken(batch, np.asarray(label)[:n_real], n_win,
                               cls, kraken_out)

    def _write_kraken(self, batch: ReadBatch, labels, n_win, class_node, out):
        """Kraken-style output lines (ref: FastqKMerMatcher.printKrakenStyleOut
        :597-611 + MatcherReadEntry.writeMatchDetails:723-756)."""
        taxids = self.tree.taxids
        for b in range(batch.n):
            W = int(n_win[b])
            if W <= 0:
                continue  # no windows -> no output buffer in the reference
            cn = int(class_node[b])
            if not (self.write_all or cn >= 0):
                continue
            row = labels[b, :W]
            # RLE segments
            bounds = np.nonzero(np.diff(row))[0] + 1
            starts = np.concatenate([[0], bounds])
            ends = np.concatenate([bounds, [W]])
            segs = []
            for s, e in zip(starts, ends):
                v = int(row[s])
                if v == LABEL_INVALID:
                    tag = b"A"
                elif v == LABEL_MISS:
                    tag = b"0"
                else:
                    tag = taxids[v].encode()
                segs.append(tag + b":" + str(e - s).encode())
            desc = batch.descriptors[b]
            sp = desc.find(b" ")
            name = desc[1:sp if sp >= 0 else len(desc)]
            line = (b"C\t" if cn >= 0 else b"U\t") + name + b"\t" + \
                (taxids[cn].encode() if cn >= 0 else b"0") + b"\t" + \
                str(int(batch.lengths[b])).encode() + b"\t" + b" ".join(segs) + b"\n"
            out.write(line)

    # ------------------------------------------------------------------

    _SUM_FIELDS = ("kmers", "contigs", "contig_sq", "reads1", "reads",
                   "reads_kmers", "reads_bps", "error_sum", "error_sq_sum",
                   "class_error_sum", "class_error_sq_sum")

    def _merge_across_processes(self, allgather=None):
        """Merge per-process matcher states into the global result state
        (multi-host file-level DP; see parallel/distributed.py). Statistic
        vectors sum; unique-counter 'seen' ORs, counts sum; max-contig picks
        the longest with ties broken by global (resource, read) order, so
        every integer/bit statistic equals a single-host run over all files
        exactly. The float64 error accumulators sum per-process partials in
        process order — deterministic, but potentially a few ulps from the
        single-host read-order sum (the reference's multi-threaded runs are
        likewise order-sensitive there; its goldens pin THREADS=0 for that
        reason, ref ComprehensiveMatchTest.java:122)."""
        allgather = allgather or dist.allgather_stats
        T = self.n_nodes
        desc_w = 256
        desc_mat = np.zeros((T, desc_w), np.uint8)
        for t, d in enumerate(self.max_contig_desc):
            b = d[:desc_w]
            desc_mat[t, : len(b)] = np.frombuffer(b, np.uint8)
        local = {
            "sum": {k: np.asarray(getattr(self, k)) for k in self._SUM_FIELDS},
            "totals": np.array([self.total_reads, self.total_kmers,
                                self.total_bps], np.int64),
            "mc": self.max_contig,
            "mcsrc": self.max_contig_src,
            "mcdesc": desc_mat,
            "seen": mesh_mod.merge_seen(self._seen).astype(np.uint8),
            "counts": mesh_mod.merge_counts(self._counts).astype(np.int64),
        }
        g = allgather(local)
        for k in self._SUM_FIELDS:
            setattr(self, k, g["sum"][k].sum(axis=0))
        self.total_reads, self.total_kmers, self.total_bps = (
            int(x) for x in g["totals"].sum(axis=0))
        mc, src = g["mc"], g["mcsrc"]
        nproc = mc.shape[0]
        best_p = np.zeros(T, np.int64)
        best_mc, best_src = mc[0].copy(), src[0].copy()
        for p_ in range(1, nproc):
            better = (mc[p_] > best_mc) | ((mc[p_] == best_mc)
                                           & (src[p_] < best_src))
            best_p = np.where(better, p_, best_p)
            best_mc = np.where(better, mc[p_], best_mc)
            best_src = np.where(better, src[p_], best_src)
        self.max_contig = best_mc
        self.max_contig_src = best_src
        self.max_contig_desc = [
            g["mcdesc"][best_p[t], t].tobytes().rstrip(b"\x00")
            for t in range(T)]
        self._seen = g["seen"].max(axis=0)
        self._counts = g["counts"].sum(axis=0)

    def _build_result(self) -> MatchingResult:
        self._drain()
        if dist.process_count() > 1:
            self._merge_across_processes()
        tree = self.tree
        unique = self._unique_per_node() if self.cfg.with_unique else None
        count_map = (self._max_kmer_counts()
                     if self.cfg.with_counts and self.max_kmer_res_counts > 0
                     else None)
        taxid2stats: dict[str, CountsPerTaxid] = {}
        touched = (self.kmers > 0) | (self.reads > 0) | (self.reads1 > 0)
        for t in np.nonzero(touched)[0]:
            t = int(t)
            s = CountsPerTaxid(int(tree.depth[t]), tree.taxids[t])
            s.reads = int(self.reads[t])
            s.reads1_kmer = int(self.reads1[t])
            s.reads_bps = int(self.reads_bps[t])
            s.reads_kmers = int(self.reads_kmers[t])
            s.kmers = int(self.kmers[t])
            s.contigs = int(self.contigs[t])
            s.contig_len_squared_sum = int(self.contig_sq[t])
            s.max_contig_len = int(self.max_contig[t])
            s.max_contig_descriptor = self.max_contig_desc[t]
            s.error_sum = float(self.error_sum[t])
            s.error_squared_sum = float(self.error_sq_sum[t])
            s.class_error_sum = float(self.class_error_sum[t])
            s.class_error_squared_sum = float(self.class_error_sq_sum[t])
            s.unique_kmers = int(unique[t]) if unique is not None else -1
            if count_map is not None:
                s.max_kmer_counts = count_map.get(tree.taxids[t])
            taxid2stats[tree.taxids[t]] = s
        return MatchingResult(self.cfg.k, taxid2stats, self.db_md5,
                              self.total_reads, self.total_kmers, self.total_bps,
                              total_max_counts=(count_map.get(None)
                                                if count_map is not None else None))

    def _max_kmer_counts(self) -> dict:
        """Top-N per-k-mer match counts per taxid among its matched k-mers,
        plus the overall top-N under the None key (ref:
        KMerUniqueCounterBits.getMaxCountsCounts:172-199). The reference's
        count vector is a short; counts saturate at 32767."""
        N = self.max_kmer_res_counts
        seen = mesh_mod.merge_seen(self._seen)[:-1] > 0
        counts = np.minimum(mesh_mod.merge_counts(self._counts)[:-1], 32767)
        sel = np.nonzero(seen)[0]
        out: dict = {None: [0] * N}
        if len(sel) == 0:
            return out
        c = counts[sel].astype(np.int64)
        vi = self._vidx_of_slot[sel]
        keep = vi >= 0
        sel, c, vi = sel[keep], c[keep], vi[keep]
        # per value: top-N counts descending (zero-padded)
        order = np.lexsort((-c, vi))
        vi_s, c_s = vi[order], c[order]
        starts = np.nonzero(np.concatenate([[True], vi_s[1:] != vi_s[:-1]]))[0]
        ends = np.concatenate([starts[1:], [len(vi_s)]])
        for s0, e0 in zip(starts, ends):
            taxid = self.table.values[int(vi_s[s0])]
            top = c_s[s0:min(e0, s0 + N)].tolist()
            out[taxid] = top + [0] * (N - len(top))
        total = np.sort(c)[::-1][:N].tolist()
        out[None] = total + [0] * (N - len(total))
        return out

    def _unique_per_node(self) -> np.ndarray:
        """Unique k-mers per node: segment-sum of the seen bits over the
        table's value indexes (ref: KMerUniqueCounterBits.getUniqueKmerCounts)."""
        seen = mesh_mod.merge_seen(self._seen)[:-1].astype(np.int64)
        vos = self._vidx_of_slot
        m_ = vos >= 0
        per_value = np.bincount(vos[m_], weights=seen[m_],
                                minlength=self.table.n_values).astype(np.int64)
        out = np.zeros(self.n_nodes, np.int64)
        nov = self.tree.node_of_value(self.table)
        m = nov >= 0
        np.add.at(out, nov[m], per_value[m])
        return out
