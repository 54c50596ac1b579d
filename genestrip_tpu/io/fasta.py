"""Genome FASTA region iteration for database building.

Reference equivalent: core fasta/AbstractFastaReader.java (event-driven
region scan: startRegion/infoLine/dataLine/endRegion). The batched build wants
whole-region byte arrays to run the vectorized k-mer extraction over, so
regions are yielded as (header, sequence) pairs; very large regions can be
processed in overlapping chunks by the caller.
"""

from __future__ import annotations


def iter_fasta_regions(stream):
    """Yield (header_line_without_gt, seq_bytes) per region from a binary stream.

    Handles CRLF and arbitrary line wrapping (ref: AbstractStoreFastaReader
    dataLine handling of '\\r').
    """
    readline = stream.readline
    header = None
    parts: list[bytes] = []
    while True:
        line = readline()
        if not line:
            break
        if line.startswith(b">"):
            if header is not None:
                yield header, b"".join(parts)
            header = line[1:].rstrip(b"\r\n")
            parts = []
        elif header is not None:
            parts.append(line.rstrip(b"\r\n"))
    if header is not None:
        yield header, b"".join(parts)
