"""Multi-chip data parallelism: shard-merged results must equal
single-device results for every output (reads, kmers, contigs, max-contig
descriptor, unique counts, classifications, error sums, kraken-out bytes,
filtered fastq bytes).

Runs on the virtual 8-device CPU mesh provisioned by conftest.py. The
single-device reference Matcher is constructed with devices=[one device].
"""

import io

import jax
import numpy as np
import pytest

from fixtures import write_mini_taxonomy

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


def _mk_fastq(tmp_path, reads, name="in.fastq"):
    from fixtures import write_fastq
    return str(write_fastq(tmp_path / name,
                           [(f"r{i} extra", seq) for i, seq in enumerate(reads)]))


def _reads(rng, genomes, n_reads=300):
    gs = list(genomes.values())
    reads = []
    for _ in range(n_reads):
        r = rng.integers(0, 4)
        if r == 0:
            reads.append(bytes(rng.choice(list(b"CGAT"), 100).astype(np.uint8)))
        else:
            g = gs[rng.integers(0, len(gs))]
            s = rng.integers(0, len(g) - 100)
            read = bytearray(g[s:s + 100])
            for _ in range(rng.integers(0, 3)):
                read[rng.integers(0, len(read))] = ord("N")
            reads.append(bytes(read))
    return reads


@pytest.mark.parametrize("with_counts", [False, True])
def test_sharded_equals_single(tmp_path, with_counts):
    assert len(jax.devices()) == 8, "conftest must provision 8 CPU devices"
    rng = np.random.default_rng(7)
    table, tree, genomes = build_world(tmp_path, rng)
    reads = _reads(rng, genomes)
    cfg = MatchConfig(k=K, with_counts=with_counts)

    fq = _mk_fastq(tmp_path, reads)

    def run(devices):
        m = Matcher(table, tree, cfg, batch_size=64,
                    max_kmer_res_counts=3 if with_counts else 0,
                    devices=devices)
        kraken = io.BytesIO()
        filtered = io.BytesIO()
        res = m.run([fq], filtered_out=filtered,
                    kraken_out=kraken)
        return m, res, kraken.getvalue(), filtered.getvalue()

    m1, r1, ko1, fo1 = run([jax.devices()[0]])
    m8, r8, ko8, fo8 = run(None)
    assert m8._mesh is not None and m1._mesh is None

    np.testing.assert_array_equal(m1.kmers, m8.kmers)
    np.testing.assert_array_equal(m1.contigs, m8.contigs)
    np.testing.assert_array_equal(m1.contig_sq, m8.contig_sq)
    np.testing.assert_array_equal(m1.reads1, m8.reads1)
    np.testing.assert_array_equal(m1.max_contig, m8.max_contig)
    assert m1.max_contig_desc == m8.max_contig_desc
    np.testing.assert_array_equal(m1.reads, m8.reads)
    np.testing.assert_array_equal(m1.reads_kmers, m8.reads_kmers)
    np.testing.assert_array_equal(m1.reads_bps, m8.reads_bps)
    np.testing.assert_allclose(m1.error_sum, m8.error_sum, rtol=0, atol=0)
    np.testing.assert_allclose(m1.class_error_sum, m8.class_error_sum,
                               rtol=0, atol=0)
    assert m1.total_reads == m8.total_reads
    assert m1.total_kmers == m8.total_kmers
    assert ko1 == ko8
    assert fo1 == fo8

    s1 = {t: vars(c) for t, c in r1.taxid2stats.items()}
    s8 = {t: vars(c) for t, c in r8.taxid2stats.items()}
    assert s1 == s8


def test_sharded_unique_counts_merge(tmp_path):
    """Unique counting is per storage position: the same k-mer hit on two
    different shards must count once after the OR-merge."""
    rng = np.random.default_rng(0)
    table, tree, genomes = build_world(tmp_path, rng)
    cfg = MatchConfig(k=K)
    reads = [list(genomes.values())[0][:100]] * 64  # identical on every shard

    fq = _mk_fastq(tmp_path, reads)

    def run(devices):
        m = Matcher(table, tree, cfg, batch_size=64, devices=devices)
        return m, m.run([fq])

    m1, r1 = run([jax.devices()[0]])
    m8, r8 = run(None)
    u1 = m1._unique_per_node()
    u8 = m8._unique_per_node()
    np.testing.assert_array_equal(u1, u8)
    assert int(u8.sum()) > 0


def test_sharded_db_equals_single(tmp_path):
    """Sharded-DB mode (hash rows bucket-range-sharded over the mesh,
    lookup shard partials psum-merged) must equal single-device results
    for every output (SURVEY §5.8; ref role RadixKMerStore.java:38-88)."""
    assert len(jax.devices()) == 8
    rng = np.random.default_rng(21)
    table, tree, genomes = build_world(tmp_path, rng)
    reads = _reads(rng, genomes)
    cfg = MatchConfig(k=K)
    fq = _mk_fastq(tmp_path, reads)

    def run(devices, shard_db):
        m = Matcher(table, tree, cfg, batch_size=64, devices=devices,
                    shard_db=shard_db)
        kraken = io.BytesIO()
        filtered = io.BytesIO()
        res = m.run([fq], filtered_out=filtered, kraken_out=kraken)
        return m, res, kraken.getvalue(), filtered.getvalue()

    m1, r1, ko1, fo1 = run([jax.devices()[0]], False)
    ms, rs, kos, fos = run(None, "on")
    assert ms.shard_db and ms._mesh is not None
    # the sharded rows really are distributed: each device holds 1/8
    assert ms._rows.sharding.shard_shape(ms._rows.shape)[0] == \
        ms._rows.shape[0] // 8

    np.testing.assert_array_equal(m1.kmers, ms.kmers)
    np.testing.assert_array_equal(m1.contigs, ms.contigs)
    np.testing.assert_array_equal(m1.contig_sq, ms.contig_sq)
    np.testing.assert_array_equal(m1.reads1, ms.reads1)
    np.testing.assert_array_equal(m1.max_contig, ms.max_contig)
    assert m1.max_contig_desc == ms.max_contig_desc
    np.testing.assert_array_equal(m1.reads, ms.reads)
    np.testing.assert_array_equal(m1.reads_kmers, ms.reads_kmers)
    np.testing.assert_array_equal(m1._unique_per_node(), ms._unique_per_node())
    assert ko1 == kos
    assert fo1 == fos
    s1 = {t: vars(c) for t, c in r1.taxid2stats.items()}
    ss = {t: vars(c) for t, c in rs.taxid2stats.items()}
    assert s1 == ss


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_auto_shard_threshold_from_device_memory():
    """dbShard=auto shards above SHARD_MEMORY_FRACTION of the smallest
    device's bytes_limit; an explicit dbShardMinBytes overrides it."""
    from genestrip_tpu.parallel import mesh
    devs = [_FakeDevice({"bytes_limit": 80 << 30}),
            _FakeDevice({"bytes_limit": 40 << 30})]
    limit = int((40 << 30) * mesh.SHARD_MEMORY_FRACTION)
    assert mesh.auto_shard_min_bytes(devs) == limit
    assert not mesh.should_shard_db("auto", limit, devs)
    assert mesh.should_shard_db("auto", limit + 1, devs)
    assert not mesh.should_shard_db("auto", limit + 1, devs,
                                    min_bytes=limit + 1)
    assert mesh.should_shard_db("on", 1, devs)
    assert not mesh.should_shard_db("off", 1 << 40, devs)


def test_auto_shard_replicates_without_memory_limit():
    """A device that reports no memory limit (the CPU backend) makes auto
    replicate at any table size; no memory size is assumed."""
    from genestrip_tpu.parallel import mesh
    for stats in (None, {}, {"bytes_in_use": 0}):
        devs = [_FakeDevice({"bytes_limit": 80 << 30}), _FakeDevice(stats)]
        assert mesh.auto_shard_min_bytes(devs) is None
        assert not mesh.should_shard_db("auto", 1 << 40, devs)
    assert not mesh.should_shard_db("auto", 1 << 40, jax.devices())
