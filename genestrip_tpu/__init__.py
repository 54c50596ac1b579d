"""genestrip_tpu — a JAX metagenomic k-mer classification engine.

A from-scratch JAX/XLA re-design of the capabilities of Genestrip
(reference: pfeiferd/genestrip, Java): database generation from RefSeq/Genbank
genomes for a selected tax-id set (canonical k-mer extraction + LCA-based
pruning of unspecific k-mers), Kraken/KrakenUniq-style read classification with
exact unique/total k-mer counting per tax id, bloom-index fastq filtering, and
the same CSV / Kraken-style / filtered-fastq output formats.

Layering (bottom-up), mirroring the reference's layer map (SURVEY.md §1):
  utils/   — byte/DNA codecs, Java-format helpers          (ref: base io/util)
  ops/     — device k-mer math: rolling windows, dust      (ref: core util/CGAT)
  store/   — k-mer table in device memory + unique counting (ref: core store/)
  tax/     — taxonomy parse + flattened device arrays      (ref: core tax/)
  io/      — fastq/fasta streaming + 2-bit packing         (ref: core fastq/fasta)
  match/   — batched classification pipeline + reports     (ref: core match/)
  make/    — goal/artifact engine (make-style DAG)         (ref: base make/)
  goals/   — the pipeline: db build, match, filter, ...    (ref: core goals/)
  parallel/— mesh sharding, psum merges, multi-host        (new)
"""

import os

import jax

# The k-mer key space is 2k bits (k <= 31 => up to 62 bits). Host code uses
# numpy uint64 freely; DEVICE code is 32-bit (uint32 hi/lo key halves, int32
# everywhere else), so global x64 stays OFF and float64 threshold math lives
# on the host (match/pipeline.py error_bounds).

# Persistent XLA compilation cache: the match/filter graphs are large, so
# caching makes every run after the first start without recompiling (safe to
# share — keyed by HLO + compiler version). JAX reads
# JAX_COMPILATION_CACHE_DIR itself; without it the cache lives at one fixed
# path inside the checkout, so every later run finds it.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)

__version__ = "0.1.0"
