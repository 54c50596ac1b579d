"""Property test: the vectorized device pipeline must reproduce the golden
scalar transcription of the reference matcher exactly — per-node statistics,
per-read classifications, Kraken-style segments, and unique k-mer counts.

This is the batched analogue of the reference's matcher tests
(core match/FastqKMerMatcherTest.java) plus its KrakenUniq byte-parity
strategy (goals/refseq/ComprehensiveMatchTest.java), with the golden model
playing the role of the reference binary.
"""

import io

import numpy as np
import pytest

from fixtures import MINI_TAX, write_mini_taxonomy, write_fastq
from golden_matcher import GoldenMatcher

from genestrip_tpu.ops.kmer import window_kmers_np
from genestrip_tpu.store.table import TableBuilder
from genestrip_tpu.tax.tree import TaxTree
from genestrip_tpu.tax.small import SmallTaxTree
from genestrip_tpu.utils.dna import seq_to_codes
from genestrip_tpu.match.pipeline import MatchConfig
from genestrip_tpu.match.matcher import Matcher

K = 11
GENOME_TAXIDS = ["11053", "11060", "11069", "9606", "139"]


def build_world(tmp_path, rng):
    tree = TaxTree(write_mini_taxonomy(tmp_path / "tax"))
    genomes = {}
    builder = TableBuilder(K)
    for tid in GENOME_TAXIDS:
        g = rng.choice(list(b"CGAT"), size=600).astype(np.uint8).tobytes()
        genomes[tid] = g
        kmers, valid = window_kmers_np(seq_to_codes(g), K)
        builder.add(kmers[valid], tid)
        tree.get(tid).mark_required()
        tree.get(tid).requested = True
    table = builder.build()
    small = SmallTaxTree.from_tax_tree(tree)
    small.init_store_indices(table)
    return table, small, genomes


def make_reads(rng, genomes, n_reads=300):
    reads = []
    gs = list(genomes.values())
    for i in range(n_reads):
        kind = rng.integers(0, 6)
        glen = rng.integers(5, 120)
        g = gs[rng.integers(0, len(gs))]
        start = rng.integers(0, max(len(g) - glen, 1))
        seq = bytearray(g[start:start + glen])
        if kind == 1:  # random read
            seq = bytearray(rng.choice(list(b"CGAT"), size=glen).astype(np.uint8).tobytes())
        elif kind == 2:  # mutations
            for _ in range(rng.integers(1, 5)):
                if len(seq):
                    seq[rng.integers(0, len(seq))] = rng.choice(list(b"CGAT"))
        elif kind == 3:  # bad bases
            for _ in range(rng.integers(1, 4)):
                if len(seq):
                    seq[rng.integers(0, len(seq))] = ord("N")
        elif kind == 4:  # chimera of two genomes
            g2 = gs[rng.integers(0, len(gs))]
            s2 = rng.integers(0, max(len(g2) - glen, 1))
            seq = bytearray(g[start:start + glen // 2] + g2[s2:s2 + glen // 2])
        elif kind == 5:  # reverse complement slice
            comp = {67: 71, 71: 67, 65: 84, 84: 65}
            seq = bytearray(comp.get(c, c) for c in reversed(seq))
        reads.append((f"read{i} extra", bytes(seq)))
    return reads


@pytest.mark.parametrize("tax_err,class_err,threshold", [
    (-1.0, -1.0, 1), (0.5, -1.0, 1), (3.0, 0.2, 1),
    (-1.0, -1.0, 2), (-1.0, -1.0, 5), (0.5, 0.3, 3),
])
def test_pipeline_matches_golden(tmp_path, tax_err, class_err, threshold):
    rng = np.random.default_rng(12345 + int(tax_err * 10) + int(class_err * 10)
                                + 1000 * threshold)
    table, small, genomes = build_world(tmp_path, rng)
    reads = make_reads(rng, genomes)
    fastq = write_fastq(tmp_path / "test.fastq", [(d, s) for d, s in reads])

    golden = GoldenMatcher(table, small, K, max_tax_err=tax_err,
                           max_class_err=class_err, threshold=threshold)
    for _, seq in reads:
        golden.match_read(seq_to_codes(seq))

    cfg = MatchConfig(k=K, max_read_tax_error=tax_err, max_read_class_error=class_err,
                      threshold=threshold)
    m = Matcher(table, small, cfg, db_md5="f00", batch_size=64)
    kraken = io.BytesIO()
    filtered = io.BytesIO()
    res = m.run([str(fastq)], filtered_out=filtered, kraken_out=kraken)

    # --- per-node stats ---
    T = len(small)
    g = golden.stats
    np.testing.assert_array_equal(m.kmers, [g[t].kmers for t in range(T)])
    np.testing.assert_array_equal(m.contigs, [g[t].contigs for t in range(T)])
    np.testing.assert_array_equal(m.contig_sq, [g[t].contig_sq for t in range(T)])
    np.testing.assert_array_equal(m.max_contig, [g[t].max_contig for t in range(T)])
    np.testing.assert_array_equal(m.reads1, [g[t].reads1_kmer for t in range(T)])
    np.testing.assert_array_equal(m.reads, [g[t].reads for t in range(T)])
    np.testing.assert_array_equal(m.reads_kmers, [g[t].reads_kmers for t in range(T)])
    np.testing.assert_array_equal(m.reads_bps, [g[t].reads_bps for t in range(T)])
    np.testing.assert_allclose(m.error_sum, [g[t].error_sum for t in range(T)], rtol=0, atol=1e-12)
    np.testing.assert_allclose(m.class_error_sum, [g[t].class_error_sum for t in range(T)], rtol=0, atol=1e-12)

    # --- unique counts ---
    np.testing.assert_array_equal(m._unique_per_node(), golden.unique_per_node())

    # --- kraken-style per-read lines vs golden segments/classification ---
    got_lines = kraken.getvalue().split(b"\n")[:-1]
    exp_lines = []
    for i, (desc, seq) in enumerate(reads):
        cls, segments, found = golden.results[i]
        if len(seq) < K:
            continue
        segs = b" ".join(
            (b"A" if lab == -2 else b"0" if lab == -1 else small.taxids[lab].encode())
            + b":" + str(ln).encode()
            for lab, ln in segments)
        name = desc.split(" ")[0].encode()
        tag = b"C\t" if cls >= 0 else b"U\t"
        tax = small.taxids[cls].encode() if cls >= 0 else b"0"
        exp_lines.append(tag + name + b"\t" + tax + b"\t" + str(len(seq)).encode() + b"\t" + segs)
    assert got_lines == exp_lines

    # --- filtered fastq: exactly the found reads ---
    exp_f = b"".join(
        f"@{d}\n".encode() + s + b"\n+\n" + b"~" * len(s) + b"\n"
        for (d, s), (cls, segments, fnd) in zip(reads, golden.results) if fnd)
    assert filtered.getvalue() == exp_f

    # --- totals ---
    assert m.total_reads == len(reads)
    assert m.total_bps == sum(len(s) for _, s in reads)
    assert m.total_kmers == sum(max(len(s) - K + 1, 0) for _, s in reads)


def test_max_kmer_counts(tmp_path):
    """Top-N per-k-mer match counts (ref: getMaxCountsCounts:172-199)."""
    rng = np.random.default_rng(77)
    table, small, genomes = build_world(tmp_path, rng)
    g = genomes["11053"]
    # read r1 covers g[0:40] once; r2 covers g[0:25] twice more
    reads = [("r1", g[0:40]), ("r2", g[0:25]), ("r3", g[0:25])]
    fastq = write_fastq(tmp_path / "t.fastq", reads)
    m = Matcher(table, small, MatchConfig(k=K, with_counts=True),
                batch_size=4, max_kmer_res_counts=5)
    res = m.run([str(fastq)])
    cm = m._max_kmer_counts()
    # windows of g[0:25] hit 3x (15 windows), rest of g[0:40] hit once
    assert cm["11053"] == [3, 3, 3, 3, 3]
    assert cm[None] == [3, 3, 3, 3, 3]
    assert res.with_max_kmer_counts
    assert res.taxid2stats["11053"].max_kmer_counts == [3, 3, 3, 3, 3]
    # a taxid with fewer matched k-mers than N pads with zeros
    m2 = Matcher(table, small, MatchConfig(k=K, with_counts=True),
                 batch_size=4, max_kmer_res_counts=5)
    reads2 = [("q1", g[0:K + 1])]   # 2 k-mers, each hit once
    m2.run([str(write_fastq(tmp_path / "t2.fastq", reads2))])
    assert m2._max_kmer_counts()["11053"] == [1, 1, 0, 0, 0]


def test_max_contig_descriptor(tmp_path):
    rng = np.random.default_rng(5)
    table, small, genomes = build_world(tmp_path, rng)
    reads = [("short hit", genomes["11053"][10:40]),
             ("long hit", genomes["11053"][5:80]),
             ("other", genomes["9606"][0:50])]
    fastq = write_fastq(tmp_path / "t.fastq", reads)
    m = Matcher(table, small, MatchConfig(k=K), batch_size=4)
    m.run([str(fastq)])
    t = small.get("11053")
    assert m.max_contig[t] == 80 - 5 - K + 1
    assert m.max_contig_desc[t] == b"long"
    t2 = small.get("9606")
    assert m.max_contig_desc[t2] == b"other"
