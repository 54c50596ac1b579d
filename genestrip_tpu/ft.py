"""Database-quality extension ("finertree"): measure, per tax id, how many
k-mers of its genomes the built database attributes correctly.

Reference equivalents: the `ft` module — finertree/FinerTreeMaker.java (goal
wiring), finertree/goals/DBQualityCountsGoal.java (the quality scan) and
finertree/goals/DBQualityCSVGoal.java (the CSV).

Redesign: the reference re-reads every genome base-by-base, probes the
store per k-mer and dedups (k-mer, taxid-index) pairs through an XOR bloom
filter (ft/.../bloom/XORKMerIndexBloomFilter.java). Here regions are
vectorized into canonical k-mer arrays, looked up in bulk against the sorted
table, and (leaf, store-position) pairs are deduplicated *exactly* by
sort-unique over composite int64 keys — no probabilistic filter needed, and
the numbers are exact rather than fpp-approximate.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from genestrip_tpu.db import build as dbbuild
from genestrip_tpu.report.java_format import decimal_format_8
from genestrip_tpu.store.database import Database


@dataclass
class QualityCounts:
    """ref: DBQualityCountsGoal.Counts."""

    tp: int = 0
    tp_plus_fp: int = 0
    tp_plus_fn: int = 0
    aggregations: int = 0
    agg_precision_sum: float = 0.0
    agg_recall_sum: float = 0.0

    @property
    def precision(self) -> float:
        return self.tp / self.tp_plus_fp if self.tp_plus_fp else float("nan")

    @property
    def recall(self) -> float:
        return self.tp / self.tp_plus_fn if self.tp_plus_fn else float("nan")

    @property
    def avg_precision(self) -> float:
        if self.agg_precision_sum == 0:
            return self.precision
        return self.agg_precision_sum / self.aggregations

    @property
    def avg_recall(self) -> float:
        if self.agg_recall_sum == 0:
            return self.recall
        return self.agg_recall_sum / self.aggregations

    def aggregate(self, c: "QualityCounts") -> None:
        self.tp += c.tp
        self.tp_plus_fp += c.tp_plus_fp
        self.tp_plus_fn += c.tp_plus_fn
        self.aggregations += 1
        self.agg_precision_sum += c.avg_precision
        self.agg_recall_sum += c.avg_recall


# ranks aggregated into (ref: DBQualityCountsGoal.doMakeThis aggRanks)
AGG_RANKS = ("cellular root", "acellular root", "species", "genus")


class QualityScanner:
    """Streams genomes against a built database and tallies per-taxid
    true/false positive k-mer counts (ref: DBQualityCountsGoal)."""

    def __init__(self, db: Database, accession_map, opts: dbbuild.BuildOptions):
        self.db = db
        self.table = db.table
        self.tree = db.tree
        self.accession_map = accession_map
        self.opts = opts
        # stored node per table position (pre-order node index; -1 = foreign)
        self._node_of_value = self.tree.node_of_value(self.table)
        self._pairs: list[np.ndarray] = []  # composite leaf<<40 | pos

    def feed_file(self, path, mapped_node=None) -> None:
        from genestrip_tpu.io.fasta import iter_fasta_regions
        from genestrip_tpu.io.streams import open_input
        with open_input(path) as stream:
            for header, seq in iter_fasta_regions(stream):
                self._region(header, seq, mapped_node)

    def _region(self, header: bytes, seq: bytes, mapped_node) -> None:
        if mapped_node is not None:
            node = mapped_node
        elif self.accession_map is not None:
            sp = header.find(b" ")
            acc = header[:sp].decode() if sp >= 0 else None
            node = self.accession_map.get(
                acc, self.opts.complete_genomes_only) if acc else None
        else:
            node = None
        if node is None:
            return
        leaf = self.tree.get(node.tax_id)
        # "There may be no corresponding node in the database"
        # (ref: DBQualityCountsGoal.MyFastaReader.handleStore)
        if leaf < 0:
            return
        kmers = dbbuild.extract_region_kmers(seq, self.opts)
        if len(kmers) == 0:
            return
        pos = self.table.find_np(kmers)
        pos = pos[pos >= 0]
        if len(pos):
            self._pairs.append((np.int64(leaf) << np.int64(40)) | pos)

    def finish(self) -> dict[str, QualityCounts]:
        tree = self.tree
        counts: dict[str, QualityCounts] = {}
        if self._pairs:
            pairs = np.unique(np.concatenate(self._pairs))
            leaf = (pairs >> np.int64(40)).astype(np.int64)
            pos = (pairs & np.int64((1 << 40) - 1)).astype(np.int64)
            stored_node = self._node_of_value[
                self.table.value_idx[pos].astype(np.int64)]
            # stored node on the leaf's root path = true positive
            ok = stored_node >= 0
            is_tp = np.zeros(len(pairs), dtype=bool)
            sn = np.maximum(stored_node, 0)
            is_tp[ok] = ((tree.tin[sn] <= tree.tin[leaf])
                         & (tree.tin[leaf] < tree.tout[sn]))[ok]
            for li in np.unique(leaf).tolist():
                m = leaf == li
                c = QualityCounts()
                c.tp_plus_fn = int(m.sum())
                c.tp = int(is_tp[m].sum())
                counts[tree.taxids[li]] = c

        # tp+fp = path sum of stored k-mers from the node to the root
        # (ref: DBQualityCountsGoal.getPathSum)
        stats = self.db.stats()
        for taxid, c in counts.items():
            i = tree.get(taxid)
            s = 0
            while i >= 0:
                s += stats.get(tree.taxids[i], 0)
                i = int(tree.parent[i])
            c.tp_plus_fp += s

        # aggregate to ranked ancestors not counted themselves
        agg: dict[str, QualityCounts] = {}
        for taxid, c in counts.items():
            i = tree.get(taxid)
            for rank in AGG_RANKS:
                j = i
                while j >= 0 and tree.rank_name(j) != rank:
                    j = int(tree.parent[j])
                if j >= 0 and tree.taxids[j] not in counts:
                    agg.setdefault(tree.taxids[j], QualityCounts()).aggregate(c)
        counts.update(agg)
        return counts


def write_quality_csv(db: Database, counts: dict[str, QualityCounts], out) -> None:
    """ref: DBQualityCSVGoal.makeFile — one row per counted node in tree order.

    Column order mirrors the reference exactly (the 'precision'/'recall'
    columns carry the unweighted averages, the 'weighted avg' columns the
    plain ratios — as in DBQualityCSVGoal.java:75-80)."""
    tree = db.tree
    out.write("taxid;name;rank;parent taxid;tp;tp+fp;tp+fn;precision;recall;"
              "weighted avg precision;weighted avg recall;\n")
    for i in range(len(tree)):
        taxid = tree.taxids[i]
        c = counts.get(taxid)
        if c is None:
            continue
        parent = tree.parent[i]
        parent_taxid = "null" if parent < 0 else tree.taxids[int(parent)]
        out.write(f"{taxid};{tree.names[i]};{tree.rank_name(i)};{parent_taxid};"
                  f"{c.tp};{c.tp_plus_fp};{c.tp_plus_fn};"
                  f"{decimal_format_8(c.avg_precision)};"
                  f"{decimal_format_8(c.avg_recall)};"
                  f"{decimal_format_8(c.precision)};"
                  f"{decimal_format_8(c.recall)};\n")
