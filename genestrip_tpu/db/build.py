"""Database build: fill phase (k-mer extraction per genome region) and the
LCA update phase (unspecific k-mer pruning).

Reference equivalents: goals/refseq/FillDBGoal.java (+ the reader stack
refseq/AbstractStoreFastaReader.java, AbstractRefSeqFastaReader.java) and
goals/refseq/DBGoal.java. The redesign replaces per-base rolling and
per-k-mer store inserts/binary-searches with whole-region vectorized window
extraction (ops/kmer.py) and bulk sorted-table operations; the reference's
fillsize/tempindex pre-sizing goals are unnecessary because the table is
built by exact sort-unique at the end of the fill.

Order independence of the update phase is inherited from the reference:
the LCA merge is commutative/associative (ref FastaReaderGoal.java:104-109),
so bulk per-region batching yields the same final table.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from genestrip_tpu.io.fasta import iter_fasta_regions
from genestrip_tpu.io.streams import open_input
from genestrip_tpu.ops.dust import window_dust_chunked
from genestrip_tpu.ops.kmer import window_kmers_np
from genestrip_tpu.store.table import KmerTable, TableBuilder
from genestrip_tpu.tax.tree import TaxNode, TaxTree
from genestrip_tpu.utils.dna import seq_to_codes

NO_LIMIT = 2**63 - 1


@dataclass
class BuildOptions:
    k: int = 31
    max_dust: int = -1
    step_size: int = 1
    lowercase: bool = True
    max_genomes_per_taxid: int = 2**31 - 1
    max_genomes_rank = None
    max_kmers_per_taxid: int = NO_LIMIT
    complete_genomes_only: bool = False
    data_nodes: bool = False
    file_nodes: bool = False
    id_nodes: bool = False
    min_update: bool = False
    update_complete_genomes_only: bool = False


def extract_region_kmers(seq: bytes, opts: BuildOptions) -> np.ndarray:
    """Canonical k-mers of one region after validity, stepSize and DUST
    filters (ref: AbstractStoreFastaReader.dataLine:88-114).

    The stepSize condition selects windows whose 1-based end position within
    the region is a multiple of stepSize (the reference counts every fed
    base, including non-CGAT ones, in bpsInRegion).
    """
    codes = seq_to_codes(seq, lowercase=opts.lowercase)
    kmers, valid = window_kmers_np(codes, opts.k)
    if len(kmers) == 0:
        return kmers
    if opts.step_size > 1:
        ends = np.arange(opts.k, opts.k + len(kmers))
        valid = valid & (ends % opts.step_size == 0)
    if opts.max_dust >= 0:
        dust = window_dust_chunked(codes, opts.k)
        valid = valid & (dust <= opts.max_dust)
    return kmers[valid]


def iter_extracted_regions(items, opts: BuildOptions, threads: int = 0):
    """Yields (path, mapped_node, header, kmers) over a list of
    (path, mapped_node) fasta files, in deterministic file/region order.

    With threads != 0|1, file IO + gzip decompress + window extraction run
    on a bounded worker pool while accounting stays sequential on the
    caller — the batched shape of the reference's one-reader-per-thread
    file fan-out (ref: goals/refseq/FastaReaderGoal.java:101-160; order
    independence of the downstream merge per FastaReaderGoal.java:104-109,
    but deterministic order is kept anyway)."""
    items = list(items)
    if threads in (0, 1) or len(items) <= 1:
        for path, mnode in items:
            with open_input(path) as stream:
                for header, seq in iter_fasta_regions(stream):
                    yield path, mnode, header, extract_region_kmers(seq, opts)
        return
    import os
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    nw = threads if threads > 0 else max((os.cpu_count() or 2) - 1, 1)
    nw = min(nw, len(items))

    def load(pm):
        path, mnode = pm
        out = []
        with open_input(path) as stream:
            for header, seq in iter_fasta_regions(stream):
                out.append((header, extract_region_kmers(seq, opts)))
        return path, mnode, out

    with ThreadPoolExecutor(nw) as exe:
        it = iter(items)
        pending = deque()
        for _ in range(nw + 1):
            nxt = next(it, None)
            if nxt is None:
                break
            pending.append(exe.submit(load, nxt))
        while pending:
            path, mnode, regions = pending.popleft().result()
            nxt = next(it, None)
            if nxt is not None:
                pending.append(exe.submit(load, nxt))
            for header, kmers in regions:
                yield path, mnode, header, kmers


class _SeenKmers:
    """Exact incremental membership over a growing k-mer set, vectorized:
    a sorted base array + pending fresh chunks, merged geometrically
    (replaces the per-k-mer Python set of the cap-accounting path)."""

    def __init__(self):
        self._sorted = np.empty(0, np.uint64)
        self._pending: list[np.ndarray] = []
        self._pending_n = 0

    def _compact(self):
        if self._pending:
            allp = np.concatenate([self._sorted] + self._pending)
            self._sorted = np.unique(allp)
            self._pending, self._pending_n = [], 0

    def contains(self, kmers: np.ndarray) -> np.ndarray:
        if self._pending_n > max(len(self._sorted) // 2, 1 << 20):
            self._compact()
        s = self._sorted
        p = np.searchsorted(s, kmers)
        pc = np.minimum(p, max(len(s) - 1, 0))
        m = (len(s) > 0) & (s[pc] == kmers)
        for cs in self._pending:
            p = np.searchsorted(cs, kmers)
            pc = np.minimum(p, max(len(cs) - 1, 0))
            m |= (len(cs) > 0) & (cs[pc] == kmers)
        return m

    def update(self, kmers: np.ndarray):
        if len(kmers):
            self._pending.append(np.sort(np.asarray(kmers, np.uint64)))
            self._pending_n += len(kmers)


class _RegionCounts:
    """Per-taxid (regions, kmers) counters on nodes and their ancestors
    (ref: AbstractRefSeqFastaReader.endRegion + StringLong2DigitTrie)."""

    def __init__(self):
        self.counts: dict[str, list[int]] = {}

    def add(self, node: TaxNode, kmers: int):
        n = node
        while n is not None:
            c = self.counts.setdefault(n.tax_id, [0, 0])
            c[0] += 1
            c[1] += kmers
            n = n.parent

    def get(self, tax_id: str):
        return self.counts.get(tax_id)


class DBFiller:
    """The fill phase (ref: FillDBGoal)."""

    def __init__(self, tree: TaxTree, tax_nodes: set[TaxNode], accession_map,
                 opts: BuildOptions):
        self.tree = tree
        self.tax_nodes = tax_nodes
        self.accession_map = accession_map
        self.opts = opts
        self.builder = TableBuilder(opts.k)
        self.region_counts = _RegionCounts()
        self.total_kmers = 0      # incl. duplicates (the fillsize statistic)
        caps = (opts.max_kmers_per_taxid < NO_LIMIT)
        self._seen: _SeenKmers | None = _SeenKmers() if caps else None

    def feed_file(self, path, mapped_node: TaxNode | None = None) -> None:
        with open_input(path) as stream:
            for header, seq in iter_fasta_regions(stream):
                self._region(header, seq, path, mapped_node)

    def feed_items(self, items, threads: int = 0) -> None:
        """Feed many (path, mapped_node) files with parallel extraction."""
        for path, mnode, header, kmers in iter_extracted_regions(
                items, self.opts, threads):
            self._region(header, None, path, mnode, kmers=kmers)

    def _resolve(self, header: bytes, mapped_node, complete_only: bool):
        if mapped_node is not None:
            return mapped_node
        if self.accession_map is None:
            return None
        sp = header.find(b" ")
        acc = header[:sp] if sp >= 0 else None
        if acc is None:
            return None
        return self.accession_map.get(acc.decode(), complete_only)

    def _region(self, header: bytes, seq, path, mapped_node,
                kmers: np.ndarray | None = None) -> None:
        opts = self.opts
        node = self._resolve(header, mapped_node, opts.complete_genomes_only)
        if node is None or not (not self.tax_nodes or node in self.tax_nodes):
            return
        # caps (ref: AbstractRefSeqFastaReader.infoLine:180-211)
        kmers_for_node = 0
        cap_node = node
        if opts.max_genomes_rank is not None:
            cap_node = None
            n = node
            while n is not None:
                if n.rank is opts.max_genomes_rank:
                    cap_node = n
                    break
                n = n.parent
        if cap_node is not None:
            c = self.region_counts.get(cap_node.tax_id)
            if c is not None:
                kmers_for_node = c[1]
                if (kmers_for_node >= opts.max_kmers_per_taxid
                        or c[0] >= opts.max_genomes_per_taxid):
                    return
        node.mark_required()
        store_node = self._rework_fill(node, header, path)
        store_node.mark_required()

        if kmers is None:
            kmers = extract_region_kmers(seq, opts)
        self.total_kmers += len(kmers)
        if self._seen is not None:
            # exact incremental dedup needed for cap accounting parity —
            # vectorized membership over a sorted/pending seen set (was a
            # per-k-mer Python set loop)
            fresh = kmers[~self._seen.contains(kmers)]
            budget = opts.max_kmers_per_taxid - kmers_for_node
            fresh = fresh[: max(budget, 0)]
            self._seen.update(fresh)
            new_count = len(fresh)
            self.builder.add(fresh, store_node.tax_id)
        else:
            self.builder.add(kmers, store_node.tax_id)
            new_count = len(kmers)   # duplicates resolved by the final dedup
        self.region_counts.add(store_node, new_count)

    def _rework_fill(self, node: TaxNode, header: bytes, path) -> TaxNode:
        """ref: FillDBGoal.createFastaReader reworkNode (data/file/id nodes)."""
        opts = self.opts
        res = node
        from genestrip_tpu.tax.tree import RANK_DATA, RANK_FILE, RANK_ID
        if opts.data_nodes and res.rank_ordinal != RANK_DATA.ordinal:
            res = self.tree.data_node(res)
        if opts.file_nodes and path is not None and res.rank_ordinal != RANK_FILE.ordinal:
            import os
            res = self.tree.file_node(res, os.path.basename(str(path)))
        if opts.id_nodes and res.rank_ordinal != RANK_ID.ordinal:
            sp = header.find(b" ")
            name = (header[:sp] if sp >= 0 else header).decode("utf-8", "replace")
            res = self.tree.id_node(res, name)
        return res

    def build(self) -> KmerTable:
        return self.builder.build()


class _DeviceUpdateEngine:
    """Device-resident LCA update: the production scatter-join lookup
    (store/hash.py lookup_join) searches each chunk against the quotient
    hash on device, and a value vector indexed by table position is
    rewritten in place through a host-computed per-(value, node) LCA map.
    The final value vector is pulled once at finalize. Ref role:
    DBGoal.java:75-110 update loop."""

    def __init__(self, table: KmerTable, ht=None):
        import functools

        import jax
        import jax.numpy as jnp

        from genestrip_tpu.store.hash import build_hash, lookup_join

        self._jnp = jnp
        self._jax = jax
        n = len(table.keys)
        self.n = n
        if ht is None:
            ht = build_hash(table.keys, table.value_idx)
        self.nb_bits = ht.nb_bits
        self.rows = jnp.asarray(ht.rows)
        s2p = np.full(ht.n_slots + 1, n, np.int64)
        s2p[ht.slot_of_entry] = np.arange(n)
        self.slot_to_pos = jnp.asarray(s2p.astype(np.int32))
        self.vidx = jnp.asarray(
            np.append(table.value_idx.astype(np.int32), -1))
        self.moved = jnp.zeros((), jnp.int32)

        @functools.partial(jax.jit, static_argnames=("nb_bits",),
                           donate_argnames=("vidx", "moved"))
        def step(rows, slot_to_pos, vidx, moved, q_hi, q_lo, pair_map,
                 nb_bits):
            slot, found, _ = lookup_join(rows, q_hi, q_lo, nb_bits=nb_bits)
            pos = jnp.where(found, slot_to_pos[slot], n)
            cur = vidx[pos]
            new = jnp.where(found & (cur >= 0),
                            pair_map[jnp.maximum(cur, 0)], cur)
            moved = moved + jnp.sum((new != cur).astype(jnp.int32))
            vidx = vidx.at[pos].set(jnp.where(pos < n, new, -1))
            return vidx, moved

        self._step = step

    def apply_group(self, kmers: np.ndarray, pair_map: np.ndarray):
        jnp = self._jnp
        # pad to pow2 lengths with an unmatchable key (canonical k-mers use
        # at most 62 bits) to bound the number of compiled shapes
        m = 1 << max(int(np.ceil(np.log2(max(len(kmers), 1)))), 12)
        if m != len(kmers):
            kmers = np.concatenate(
                [kmers, np.full(m - len(kmers), np.uint64(2**64 - 1))])
        pm = 1 << max(int(np.ceil(np.log2(max(len(pair_map), 1)))), 8)
        if pm != len(pair_map):
            pair_map = np.concatenate(
                [pair_map, np.full(pm - len(pair_map), -1, np.int32)])
        hi = (kmers >> np.uint64(32)).astype(np.uint32)
        lo = (kmers & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        self.vidx, self.moved = self._step(
            self.rows, self.slot_to_pos, self.vidx, self.moved,
            jnp.asarray(hi.view(np.int32)), jnp.asarray(lo.view(np.int32)),
            jnp.asarray(pair_map.astype(np.int32)), nb_bits=self.nb_bits)

    def drain_moved(self) -> int:
        m = int(self.moved)
        self.moved = self._jnp.zeros((), self._jnp.int32)
        return m

    def finalize(self) -> np.ndarray:
        """Pull the final per-position value vector (one transfer)."""
        return np.asarray(self.vidx[: self.n])


class DBUpdater:
    """The LCA update phase (ref: DBGoal). Rewrites each stored k-mer's value
    to the LCA of its current node and the node of every region it occurs in.

    Scaling redesign: regions are accumulated into large chunks
    (`chunk_kmers`, config dbBuildChunkKMers) and applied in ONE bulk pass —
    one table search over the whole chunk, LCAs computed once per distinct
    (current value, region node) pair. The reference proves order
    independence of the LCA merge (FastaReaderGoal.java:104-109 — it is
    commutative/associative), which is exactly what makes chunked batch
    application equivalent to the per-region loop. k-mers hit by several
    distinct nodes within one chunk are folded sequentially (rare path)."""

    def __init__(self, tree: TaxTree, table: KmerTable, tax_nodes: set[TaxNode],
                 accession_map, opts: BuildOptions,
                 chunk_kmers: int = 1 << 24,
                 device_update: "str | bool" = "auto"):
        self.tree = tree
        self.table = table
        self.tax_nodes = tax_nodes
        self.accession_map = accession_map
        self.opts = opts
        self.kmers_moved = 0
        self.chunk_kmers = max(int(chunk_kmers), 1)
        self._pend_kmers: list[np.ndarray] = []
        self._pend_nodes: list[TaxNode] = []   # one node per pending chunk
        self._pend_n = 0
        # device-resident update (config key dbDeviceUpdate): "auto" and
        # "on" take it whenever the table is non-empty; "off" keeps the
        # host path
        use_dev = device_update in (True, "on", "auto")
        self._dev: _DeviceUpdateEngine | None = (
            _DeviceUpdateEngine(table) if use_dev and len(table.keys) else None)

    def feed_file(self, path, mapped_node: TaxNode | None = None) -> None:
        with open_input(path) as stream:
            for header, seq in iter_fasta_regions(stream):
                self._region(header, seq, path, mapped_node)

    def feed_items(self, items, threads: int = 0) -> None:
        """Feed many (path, mapped_node) files with parallel extraction."""
        for path, mnode, header, kmers in iter_extracted_regions(
                items, self.opts, threads):
            self._region(header, None, path, mnode, kmers=kmers)

    def _region(self, header: bytes, seq, path, mapped_node,
                kmers: np.ndarray | None = None) -> None:
        opts = self.opts
        if mapped_node is not None:
            node = mapped_node
        elif self.accession_map is not None:
            sp = header.find(b" ")
            acc = header[:sp].decode() if sp >= 0 else None
            node = self.accession_map.get(acc, opts.update_complete_genomes_only) if acc else None
        else:
            node = None
        if opts.min_update:
            # only regions of the requested taxids (ref DBGoal.infoLine:267-274)
            if node is None or not (not self.tax_nodes or node in self.tax_nodes):
                return
            node = self._rework_update(node, header, path)
        else:
            if node is not None:
                node = self._rework_update(node, header, path)
        if node is None:
            # LCA(old, null) keeps the old value (ref provider :246-253) — no-op
            return
        if kmers is None:
            kmers = extract_region_kmers(seq, opts)
        if len(kmers) == 0:
            return
        self._pend_kmers.append(kmers)
        self._pend_nodes.append(node)
        self._pend_n += len(kmers)
        if self._pend_n >= self.chunk_kmers:
            self.flush()

    def flush(self) -> None:
        """Apply all pending regions' LCA updates, one bulk pass per node.

        Pending regions are grouped by their mapped node (first-appearance
        order) and each group is applied sequentially: sort-unique the
        group's k-mers (a numpy value sort, cheaper than an argsort), search
        them against the table with SORTED queries (the binary-search tree
        stays cache-resident, unlike random-order searchsorted), then
        rewrite values through a per-(current value, node) LCA map.
        Sequential group application reproduces the reference's
        region-order fold exactly (and the LCA merge is order-independent
        anyway, ref FastaReaderGoal.java:104-109); a repeated application of
        the same node is a no-op LCA, which makes the in-group dedup exact."""
        if not self._pend_kmers:
            return
        # group pending region chunks by node, keeping first-appearance order
        nodes: list[TaxNode] = []
        node_idx_of: dict[str, int] = {}
        groups: list[list[np.ndarray]] = []
        for chunk, node in zip(self._pend_kmers, self._pend_nodes):
            i = node_idx_of.get(node.tax_id)
            if i is None:
                i = node_idx_of[node.tax_id] = len(nodes)
                nodes.append(node)
                groups.append([])
            groups[i].append(chunk)
        self._pend_kmers, self._pend_nodes, self._pend_n = [], [], 0

        lca_cache: dict[tuple[int, int], int] = {}

        def lca_vi(vi: int, node_i: int) -> int:
            key = (vi, node_i)
            r = lca_cache.get(key)
            if r is None:
                old_node = self.tree.get(self.table.values[vi])
                lca = self.tree.lca(old_node, nodes[node_i])
                r = (self.table.get_add_value_index(lca.tax_id)
                     if lca is not None else vi)
                lca_cache[key] = r
            return r

        if self._dev is not None:
            # device path: the production lookup kernel searches each group's
            # k-mers on device and rewrites the device value vector through a
            # host-computed full (value -> LCA(value, node)) map. The value
            # vector stays device-resident across flushes; finalize() pulls
            # it to the host table ONCE at the end.
            for g, chunks in enumerate(groups):
                # dedup keeps the moved counter exact (duplicate entries in
                # one scatter would each compare against the pre-step value)
                kk = np.unique(np.concatenate(chunks) if len(chunks) > 1
                               else chunks[0])
                pair_map = np.array(
                    [lca_vi(vi, g) for vi in range(len(self.table.values))],
                    np.int32)
                self._dev.apply_group(kk, pair_map)
            self.kmers_moved += self._dev.drain_moved()
            return

        for g, chunks in enumerate(groups):
            kk = np.unique(np.concatenate(chunks) if len(chunks) > 1
                           else chunks[0])
            pos = self.table.find_np(kk)
            pos = pos[pos >= 0]
            if len(pos) == 0:
                continue
            cur = self.table.value_idx[pos]
            uvi = np.unique(cur)
            new_for = np.array([lca_vi(int(v), g) for v in uvi], np.int32)
            nv = new_for[np.searchsorted(uvi, cur)]
            ch = nv != cur
            if ch.any():
                self.table.set_value_idx_at(pos[ch], nv[ch])
                self.kmers_moved += int(ch.sum())

    def finalize(self) -> None:
        """Apply any pending regions and sync the table: in device mode this
        performs the ONE device->host value-vector pull (ref: the single
        update pass of DBGoal.java:75-110 ends with the store fixed). Must be
        called once after the last feed; flush() alone leaves the device
        path's host table stale."""
        self.flush()
        if self._dev is not None:
            self.table.set_value_idx_at(
                np.arange(self._dev.n), self._dev.finalize())

    def _rework_update(self, node: TaxNode, header: bytes, path) -> TaxNode:
        """ref: DBGoal reworkNode — only uses *existing* data/file/id children."""
        opts = self.opts
        from genestrip_tpu.tax.tree import RANK_DATA, RANK_FILE, RANK_ID
        res = node
        if opts.data_nodes and res.rank_ordinal != RANK_DATA.ordinal:
            for child in res.children:
                if child.rank_ordinal == RANK_DATA.ordinal:
                    res = child
                    break
        if opts.file_nodes and path is not None and res.rank_ordinal != RANK_FILE.ordinal:
            import os
            name = os.path.basename(str(path))
            for child in res.children:
                if child.name == name:
                    res = child
                    break
        if opts.id_nodes and res.rank_ordinal != RANK_ID.ordinal:
            sp = header.find(b" ")
            name = (header[:sp] if sp >= 0 else header).decode("utf-8", "replace")
            for child in res.children:
                if child.name == name:
                    res = child
                    break
        return res
