"""Generated user documentation: config-parameter and goal reference.

Reference equivalent: the reference auto-generates `ConfigParams.md` and
`Goals.md` from its typed `ConfigKey`/`GoalKey` registries via test-side
`GenDocFiles` (ref: base make/ConfigParamInfo.java + GSConfigKey.java doc
strings; README.md links both). Here the registry is `config.KEYS` /
`config.NOOP_KEYS` plus the goal table below; `write_docs()` renders
`ConfigParams.md` and `Goals.md`, and tests assert every key and every
registered user goal is documented (tests/test_docs.py), so the docs
cannot drift from the code.
"""

from __future__ import annotations

from genestrip_tpu.config import KEYS, NOOP_KEYS

# one-line doc per config key (reference semantics per ConfigParams.md;
# keys new in this implementation marked [new])
KEY_DOCS = {
    "logLevel": "Log level: error, warn, info or trace.",
    "threads": "Worker threads for input parsing/extraction; -1 = number of processors - 1, 0 = synchronous.",
    "progressBar": "Show progress/throughput logging for long-running steps.",
    "progressBarUpdateMs": "Progress update interval in milliseconds.",
    "kMerSize": "The k of the k-mers (15..31; the database fixes it at build time).",
    "extractKey": "Descriptor prefix selecting reads for the extract goal.",
    "httpBaseURL": "Base HTTP URL of the NCBI mirror.",
    "ftpBaseURL": "Base FTP host of the NCBI mirror.",
    "refseq.httpBaseURL": "Base HTTP URL for RefSeq releases.",
    "refseq.ftpBaseURL": "Base FTP host for RefSeq releases.",
    "useHttp": "Download via HTTP(S) rather than FTP.",
    "ignoreMissingFastas": "Skip genome files that fail to download instead of failing the goal.",
    "maxDownloadTries": "Bounded retries per download (with MD5 verification and a .md5ok marker cache).",
    "seqType": "RefSeq accession sequence type filter (GENOMIC, RNA, ...).",
    "rankCompletionDepth": "Complete requested tax ids with their descendants down to this rank.",
    "checkSumCacheFile": "Cache successful checksum verifications in marker files.",
    "maxGenomesPerTaxid": "Cap on genomes ingested per tax id during the DB build.",
    "maxKMersPerTaxid": "Cap on k-mers stored per tax id during the DB build.",
    "maxPerTaxidRank": "Rank at which the per-taxid genome/k-mer caps are scoped.",
    "alwaysAssumeGzip": "Treat URL fastq inputs as gzip regardless of suffix.",
    "refseq.filldb": "Fill the database from RefSeq (otherwise only additional fastas are used).",
    "refseq.completeGenomesOnly": "Only ingest complete genomes during the fill phase.",
    "refSeq.limitForGenbankAccess": "Use Genbank for requested tax ids with fewer than this many RefSeq genomes.",
    "refSeq.limitForGenbankRank": "Rank scope for the Genbank-access limit.",
    "refseq.status": "Accepted RefSeq entry statuses (e.g. PROVISIONAL, REVIEWED).",
    "reqseq.extract.gzip": "Gzip the per-accession fastas produced by the RefSeq extract goals.",
    "gzipFastqOutput": "Gzip generated fastq outputs (filtered, extracted, db2fastq).",
    "genbank.maxPerTaxid": "Maximum Genbank assemblies per tax id (-1 = unlimited).",
    "genbank.fastaQualities": "Accepted Genbank assembly quality levels, best first.",
    "genbank.referenceOnly": "Only use Genbank assemblies flagged as reference genomes.",
    "maxDust": "Dust-filter threshold; k-mers with a dust score above it are dropped (-1 = off).",
    "dbResizingFactor": "Store allocation head-room factor during the fill phase.",
    "useRadixStore": "Reference compatibility switch for its radix store (accepted; one exact hash layout here).",
    "radixStoreBits": "Reference compatibility: radix bucket bits of its radix store.",
    "xorBloomHash": "Reference compatibility: bloom-filter hash family selector.",
    "minUpdate": "LCA-update only with the requested tax ids' own genomes instead of all categories.",
    "refseq.updateWithCompleteGenomesOnly": "Only complete genomes take part in the LCA update phase.",
    "removeTempDB": "Delete the temporary database once the final one is saved.",
    "stepSize": "Stride between stored k-mers of a genome (1 = every position).",
    "dataNodes": "Attribute stored k-mers to artificial per-data sub-nodes (rank DATA).",
    "idNodes": "Attribute stored k-mers to artificial per-accession sub-nodes (rank ID).",
    "fileNodes": "Attribute stored k-mers to artificial per-file sub-nodes (rank FILE).",
    "lowerCaseBases": "Accept lower-case bases in genomes and reads.",
    "logProgressUpdateCycle": "Trace-log progress every N reads (0 = off).",
    "classifyReads": "Classify reads (Kraken-style voting); off = k-mer counting only.",
    "countUniqueKMers": "Exact unique-k-mer counting per tax id (KrakenUniq semantics).",
    "writeFilteredFastq": "Write reads with at least one database hit to a filtered fastq.",
    "writeKrakenStyleOut": "Write a Kraken-style per-read output file.",
    "writeAll": "Kraken-style output includes unclassified reads (U lines).",
    "useBloomFilterForMatch": "Reference compatibility: match-time bloom pre-filter (no-op; exact hash).",
    "maxReadTaxErrorCount": "Per-read error bound: max miss/bad-base count (>=1) or fraction of windows (<1); -1 = off.",
    "maxReadClassErrorCount": "Per-read classification-error bound gating per-taxid stats; -1 = off.",
    "minKMersForClass": "Minimum k-mers for classification; higher values promote to ancestors (threshold promotion).",
    "maxKMerResCounts": "Track the top-N per-k-mer match counts per tax id (0 = off).",
    "writeDumpedFastq": "Filter goal also writes the rejected reads to a dumped fastq.",
    "minPosCountFilter": "Filter accepts a read at this many index hits (0 = use posRatioFilter).",
    "posRatioFilter": "Filter accepts a read when hits/windows reaches this ratio.",
    "withProbs": "Carry input quality strings through to fastq outputs.",
    "taxids": "Additional tax ids (supplementing taxids.txt).",
    "svgFont": "SVG tax tree: font family.",
    "svgFontSize": "SVG tax tree: font size.",
    "svgLineHeightFactor": "SVG tax tree: line height as a factor of the font height.",
    "svgIndentFactor": "SVG tax tree: per-level standard indent as a factor of the line height.",
    "svgTextGapFactor": "SVG tax tree: gap between connector and label.",
    "svgKmerNodeIndentFactor": "SVG tax tree: extra indent proportional to k-mer count (or distance).",
    "svgDistanceIndent": "SVG tax tree: indent by evolutionary distance instead of k-mer count.",
    "svgReqNodesBold": "SVG tax tree: bold labels for requested tax ids.",
    "svgShowRank": "SVG tax tree: append the rank to node labels.",
    "svgTooLargeDistance": "SVG tax tree: dash connectors whose distance exceeds this.",
    "svgMarkLongestPath": "SVG tax tree: draw the longest path in red.",
    "svgShowDistance": "SVG tax tree: append the evolutionary distance to labels.",
    "svgShowDistancePortion": "SVG tax tree: append the distance portion to labels.",
    "tempBloomFilterFpp": "Reference compatibility: temp-index bloom fpp (no-op; exact dedup).",
    "indexBloomFilterFpp": "Reference compatibility: filter-index bloom fpp (no-op; exact index).",
    "fillBloomFilterFpp": "Reference compatibility: fill bloom fpp (no-op; exact dedup).",
    "optBloomFilterFpp": "Reference compatibility: optimized bloom fpp (no-op; exact hash).",
    "threadQueueSize": "Bounded prefetch queue size of the input pipeline.",
    "initialReadSizeBytes": "Reference compatibility: initial read buffer size.",
    "maxClassificationPaths": "Maximum candidate taxonomy paths tracked per read.",
    "fastaLineSizeBytes": "Reference compatibility: fasta line buffer size.",
    "krakenBin": "External kraken/krakenuniq binary (parity-test harness).",
    "krakenExecExpr": "Command format string for the external kraken run.",
    "krakenDB": "Database name passed to the external kraken run.",
    "matchBatchSize": "[new] Reads per device batch of the match pipeline.",
    "dbShard": "[new] Shard the k-mer hash over the device mesh: auto (above dbShardMinBytes), on, off.",
    "dbShardMinBytes": "[new] Table size above which auto sharding engages; 0 = a quarter of the smallest device's memory limit (devices that report none replicate).",
    "dbBuildChunkKMers": "[new] Pending k-mers per bulk LCA-update pass.",
    "dbDeviceUpdate": "[new] Run the LCA update on device: auto or on (whenever the table is non-empty), off (host path).",
    "dbSaveLookupHash": "[new] Persist the derived lookup hash in the final db zip (instant match-time load).",
}

# user-facing goals (ref: Goals.md / GSGoalKey.java); name -> description
GOAL_DOCS = {
    "db": "Generate the project database (download, fill, LCA update, save).",
    "tempdb": "Generate and keep the temporary (pre-update) database.",
    "dbinfo": "CSV of per-taxid stored k-mers and evolutionary distances.",
    "tempdbinfo": "dbinfo for the temporary database.",
    "index": "Build the filtering index of the requested tax ids' k-mers.",
    "match": "Classify fastq reads against the database; writes the match CSV.",
    "matchlr": "Long-read matching: k-mer counting without read classification.",
    "filter": "Filter fastqs through the k-mer index.",
    "extract": "Extract reads whose descriptor starts with extractKey.",
    "db2fastq": "Dump database k-mers of selected tax ids as synthetic fastq.",
    "fasta2fastq": "Convert fasta input to fastq.",
    "svgtaxtree": "Render the database taxonomy as an SVG tree.",
    "dbquality": "DB-quality CSV: correctly vs incorrectly attributed k-mers per taxid (ft).",
    "dbqualitycounts": "In-memory DB-quality counts (ft).",
    "genall": "Make every primary artifact (db, index, ...).",
    "clear": "Delete the project's generated files.",
    "dbdownload": "Install a prebuilt database from a URL.",
    "showdbconf": "Print the database's provenance properties.",
    "dbconf": "Write the database's provenance properties to a file.",
}


def config_params_md() -> str:
    lines = [
        "# Configuration parameters",
        "",
        "Generated by `python -m genestrip_tpu.docs` from the typed key",
        "registry (`genestrip_tpu/config.py`). Precedence: CLI `-C` >",
        "project `config.properties` > base `config.properties`.",
        "",
        "| Name | Type | Default | Range | Description |",
        "|---|---|---|---|---|",
    ]
    for k in KEYS.values():
        rng = ""
        if k.lo is not None or k.hi is not None:
            rng = f"[{k.lo if k.lo is not None else ''}..{k.hi if k.hi is not None else ''}]"
        d = k.default
        if isinstance(d, list):
            d = ", ".join(str(x) for x in d)
        lines.append(f"| `{k.name}` | {k.type} | {d} | {rng} | "
                     f"{KEY_DOCS[k.name]} |")
    lines += [
        "",
        "## Accepted no-op keys",
        "",
        "These reference keys are accepted for project compatibility but are",
        "deliberately non-functional here (a warning is logged when set):",
        "",
    ]
    for name, why in sorted(NOOP_KEYS.items()):
        lines.append(f"* `{name}` — {why}.")
    return "\n".join(lines) + "\n"


def goals_md() -> str:
    lines = [
        "# Goals",
        "",
        "Generated by `python -m genestrip_tpu.docs`. Run via",
        "`python -m genestrip_tpu.cli -d <base> <project> <goal> [...]`;",
        "`-t clean|cleanall|cleantotal` invalidates selectively; with no",
        "goal given the CLI prints the user goals.",
        "",
        "| Goal | Description |",
        "|---|---|",
    ]
    for name, doc in GOAL_DOCS.items():
        lines.append(f"| `{name}` | {doc} |")
    return "\n".join(lines) + "\n"


def write_docs(directory=".") -> None:
    import os
    with open(os.path.join(directory, "ConfigParams.md"), "w") as f:
        f.write(config_params_md())
    with open(os.path.join(directory, "Goals.md"), "w") as f:
        f.write(goals_md())


if __name__ == "__main__":
    import sys
    write_docs(sys.argv[1] if len(sys.argv) > 1 else ".")
    print("wrote ConfigParams.md, Goals.md")
