"""Device-resident LCA update (db/build.py _DeviceUpdateEngine) must produce
exactly the host path's table: same values, same kmers_moved. Runs on the CPU
backend; dbDeviceUpdate=auto takes this path whenever the table is non-empty
(ref role: DBGoal.java:75-110)."""

import numpy as np
import pytest

from fixtures import write_mini_taxonomy

from genestrip_tpu.db.build import BuildOptions, DBUpdater
from genestrip_tpu.store.table import KmerTable
from genestrip_tpu.tax.tree import TaxTree


@pytest.fixture()
def tree(tmp_path):
    return TaxTree(write_mini_taxonomy(tmp_path / "tax"))


def _table(rng, n, values):
    keys = np.sort(np.unique(
        rng.integers(0, 2**62, int(2.5 * n), dtype=np.uint64))[:n])
    vidx = rng.integers(0, len(values), n).astype(np.int32)
    return KmerTable(31, keys, vidx.copy(), list(values))


def _run(tree, table, regions, device):
    upd = DBUpdater(tree, table, set(), None, BuildOptions(k=31),
                    chunk_kmers=1 << 30, device_update=device)
    for taxid, kmers in regions:
        upd._pend_kmers.append(kmers)
        upd._pend_nodes.append(tree.get(taxid))
        upd._pend_n += len(kmers)
    upd.finalize()
    return upd


def test_device_update_matches_host(tree):
    rng = np.random.default_rng(7)
    values = ["11053", "11060", "12637"]
    t_host = _table(rng, 4096, values)
    t_dev = KmerTable(31, t_host.keys.copy(), t_host.value_idx.copy(),
                      list(values))

    # region streams: hits + misses, overlapping nodes, repeated k-mers
    r1 = np.concatenate([t_host.keys[rng.integers(0, 4096, 3000)],
                         rng.integers(0, 2**62, 500, dtype=np.uint64)])
    r2 = np.concatenate([t_host.keys[:1024], t_host.keys[:512]])
    r3 = t_host.keys[2000:2600]
    regions = [("9606", r1), ("11053", r2), ("10239", r3)]

    host = _run(tree, t_host, regions, device=False)
    dev = _run(tree, t_dev, regions, device=True)

    assert dev.kmers_moved == host.kmers_moved
    # value SPACES can differ in creation order only if LCA discovery order
    # differed — compare by resolved taxid per position
    host_tax = np.array([t_host.values[v] for v in t_host.value_idx])
    dev_tax = np.array([t_dev.values[v] for v in t_dev.value_idx])
    np.testing.assert_array_equal(host_tax, dev_tax)
    assert host.kmers_moved > 0


def test_device_update_multiple_flushes(tree):
    rng = np.random.default_rng(8)
    values = ["11053", "11060"]
    t_host = _table(rng, 2048, values)
    t_dev = KmerTable(31, t_host.keys.copy(), t_host.value_idx.copy(),
                      list(values))
    chunks = [("9606", t_host.keys[rng.integers(0, 2048, 700)])
              for _ in range(3)]

    host = DBUpdater(tree, t_host, set(), None, BuildOptions(k=31),
                     device_update=False)
    dev = DBUpdater(tree, t_dev, set(), None, BuildOptions(k=31),
                    device_update=True)
    for u in (host, dev):
        for taxid, kk in chunks:
            u._pend_kmers.append(kk)
            u._pend_nodes.append(tree.get(taxid))
            u._pend_n += len(kk)
            u.flush()                      # one flush per region
        u.finalize()
    assert dev.kmers_moved == host.kmers_moved
    host_tax = np.array([t_host.values[v] for v in t_host.value_idx])
    dev_tax = np.array([t_dev.values[v] for v in t_dev.value_idx])
    np.testing.assert_array_equal(host_tax, dev_tax)


def test_auto_takes_device_engine(tree):
    """dbDeviceUpdate=auto: the device path whenever the table is
    non-empty; off keeps the host path; an empty table has no engine."""
    rng = np.random.default_rng(9)
    table = _table(rng, 256, ["11053"])
    auto = DBUpdater(tree, table, set(), None, BuildOptions(k=31),
                     device_update="auto")
    assert auto._dev is not None
    off = DBUpdater(tree, table, set(), None, BuildOptions(k=31),
                    device_update="off")
    assert off._dev is None
    empty = KmerTable(31, np.zeros(0, np.uint64), np.zeros(0, np.int32),
                      ["11053"])
    assert DBUpdater(tree, empty, set(), None, BuildOptions(k=31),
                     device_update="auto")._dev is None
