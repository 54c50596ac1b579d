"""Fastq filtering through the k-mer index.

Reference equivalent: core bloom/FastqBloomFilter.java — per read, count the
k-mers contained in the index; accept when the count reaches the positive
threshold (minPosCountFilter, or ceil-less int(max * posRatioFilter) when
minPosCountFilter == 0, ref isAcceptRead:120-…). The early accept/reject
short-circuits of the reference do not change the decision, which reduces
to: accept iff #contained >= max(posThreshold, 1). Filtered (and optionally
dumped) reads are rewritten as 4-line fastq.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from genestrip_tpu.io.reads import BatchPacker, batch_feeder, parse_reads
from genestrip_tpu.io.streams import ReadAhead, StreamingResource
from genestrip_tpu.ops.kmer import window_kmers
from genestrip_tpu.store.index import KmerIndex
from genestrip_tpu.store.hash import lookup_hash


@functools.partial(jax.jit, static_argnames=("k", "nb_bits"))
def filter_step(k: int, nb_bits: int, rows, codes, lengths, thr):
    """thr: [B] int32 acceptance thresholds, precomputed on the host in
    float64 (the ratio threshold is `int(max * posRatioFilter)` in Java
    double math, ref isAcceptRead — kept off-device so the device graph
    stays 32-bit)."""
    hi, lo, clean, exists = window_kmers(codes, lengths, k)
    _, found, _ = lookup_hash(rows, hi, lo, nb_bits=nb_bits)
    contained = jnp.sum((found & clean & exists).astype(jnp.int32), axis=1)
    return contained >= jnp.maximum(thr, 1)


def filter_thresholds(lengths: np.ndarray, k: int, min_pos_count: int,
                      pos_ratio: float) -> np.ndarray:
    n_win = np.maximum(lengths.astype(np.int64) - (k - 1), 0)
    if min_pos_count > 0:
        return np.full_like(lengths, min_pos_count, dtype=np.int32)
    return (n_win.astype(np.float64) * pos_ratio).astype(np.int32)


class FastqFilter:
    def __init__(self, index: KmerIndex, min_pos_count: int = 1,
                 pos_ratio: float = 0.2, batch_size: int = 8192,
                 with_probs: bool = False):
        self.with_probs = with_probs
        self.index = index
        self.min_pos_count = min_pos_count
        self.pos_ratio = pos_ratio
        self.batch_size = batch_size
        self.accepted = 0
        self.total = 0

    def run(self, resources, filtered_out, dumped_out=None) -> None:
        from genestrip_tpu.io.streams import Progress
        d = self.index.search_arrays()
        for res in resources:
            if not isinstance(res, StreamingResource):
                res = StreamingResource(res)
            fasta = res.type_hint == "fasta"
            packer = BatchPacker(self.batch_size, with_probs=self.with_probs)
            with res.open() as stream:
                progress = Progress(f"filter {res.name}", res)
                # decompress + parse/pack overlap the device steps, as in
                # the matcher (ref producer/consumer contract,
                # fastq/AbstractFastqReader.java:88-118)
                src = ReadAhead(stream)
                try:
                    gen = batch_feeder(parse_reads(src, packer, fasta),
                                       prefetch=4)
                    for batch in gen:
                        progress.update(batch.n)
                        codes, lengths = batch.codes, batch.lengths
                        if batch.n < self.batch_size:
                            pad = self.batch_size - batch.n
                            codes = np.concatenate(
                                [codes, np.full((pad, codes.shape[1]), 255, np.uint8)])
                            lengths = np.concatenate([lengths, np.zeros(pad, np.int32)])
                        thr = filter_thresholds(lengths, self.index.k,
                                                self.min_pos_count, self.pos_ratio)
                        acc = np.asarray(filter_step(
                            self.index.k, d["nb_bits"],
                            d["rows"], jnp.asarray(codes), jnp.asarray(lengths),
                            jnp.asarray(thr)))
                        self.total += batch.n
                        for b in range(batch.n):
                            out = filtered_out if acc[b] else dumped_out
                            if acc[b]:
                                self.accepted += 1
                            if out is not None:
                                out.write(batch.descriptors[b])
                                out.write(b"\n")
                                out.write(batch.seqs[b])
                                out.write(b"\n+\n")
                                if batch.probs is not None and batch.probs[b]:
                                    out.write(batch.probs[b])
                                else:
                                    out.write(b"~" * len(batch.seqs[b]))
                                out.write(b"\n")
                finally:
                    src.close()   # stop the read-ahead thread
                progress.done()
