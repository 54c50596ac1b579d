"""The filtering index: the set of k-mers of requested tax nodes.

Reference equivalent: goals/refseq/BloomIndexGoal.java builds a bloom filter
over the database k-mers whose tax node is requested (fpp 1e-8 by default),
serialized as `<project>_index.ser.gz`. This index is the *exact*
sorted subset of those k-mers, probed with the same vectorized binary-search
lookup as the main table — no false positives (a strict improvement at the
same memory order in device memory) and batch-friendly. File format: npz.
"""

from __future__ import annotations

import numpy as np

from genestrip_tpu.store.database import Database
from genestrip_tpu.store.table import KmerTable
from genestrip_tpu.ops.kmer import split_u64


class KmerIndex:
    def __init__(self, k: int, keys: np.ndarray):
        self.k = k
        self.keys = np.asarray(keys, dtype=np.uint64)
        self._device = None

    @staticmethod
    def from_database(db: Database) -> "KmerIndex":
        tree = db.tree
        req_nodes = {tree.taxids[i] for i in np.nonzero(tree.requested)[0]}
        req_vi = np.array(
            [vi for vi, t in enumerate(db.table.values) if t in req_nodes],
            dtype=np.int64)
        mask = np.isin(db.table.value_idx.astype(np.int64), req_vi)
        return KmerIndex(db.k, db.table.keys[mask])

    def search_arrays(self):
        """Quotient-hash arrays for the containment probe (two row gathers
        per lookup, see store/hash.py)."""
        if self._device is None:
            import jax.numpy as jnp
            from genestrip_tpu.store.hash import build_hash
            ht = build_hash(self.keys, np.zeros(len(self.keys), np.int64))
            self._device = {"rows": jnp.asarray(ht.rows),
                            "nb_bits": ht.nb_bits}
        return self._device

    def contains_np(self, kmers: np.ndarray) -> np.ndarray:
        pos = np.searchsorted(self.keys, kmers)
        pos = np.minimum(pos, max(len(self.keys) - 1, 0))
        return (len(self.keys) > 0) & (self.keys[pos] == kmers)

    def save_npz(self, path) -> None:
        # open explicitly: np.savez appends '.npz' to plain string paths
        with open(path, "wb") as fh:
            np.savez_compressed(fh, k=np.int64(self.k), keys=self.keys)

    @staticmethod
    def load_npz(path) -> "KmerIndex":
        with open(path, "rb") as fh, np.load(fh) as z:
            return KmerIndex(int(z["k"]), z["keys"])
