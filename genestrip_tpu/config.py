"""Typed configuration keys with defaults, ranges and docs.

Reference equivalents: GSConfigKey.java (~75 typed keys) + the generated
ConfigParams.md table. Layered precedence (CLI -C > project
config.properties > base config.properties) is implemented in project.py
(ref: Project.initConfigParams, README.md:331-346).
"""

from __future__ import annotations

from dataclasses import dataclass

from genestrip_tpu.tax.tree import Rank


@dataclass(frozen=True)
class Key:
    name: str
    type: str          # bool | int | float | str | rank | list
    default: object
    lo: float | None = None
    hi: float | None = None

    def parse(self, s):
        if s is None:
            return self.default
        if isinstance(s, str):
            s = s.strip()
        if self.type == "bool":
            if isinstance(s, bool):
                return s
            return str(s).lower() in ("true", "1", "yes")
        if self.type == "int":
            v = int(s)
        elif self.type == "float":
            v = float(s)
        elif self.type == "rank":
            if isinstance(s, Rank) or s is None:
                return s
            return Rank.by_name(str(s)) if str(s) else None
        elif self.type == "list":
            if isinstance(s, (list, tuple)):
                return list(s)
            return [x.strip() for x in str(s).split(",") if x.strip()]
        else:
            return str(s)
        if self.lo is not None and v < self.lo:
            raise ValueError(f"{self.name}: {v} below minimum {self.lo}")
        if self.hi is not None and v > self.hi:
            raise ValueError(f"{self.name}: {v} above maximum {self.hi}")
        return v


_KEYS = [
    # user-facing keys (ref: ConfigParams.md)
    Key("logLevel", "str", "info"),
    Key("threads", "int", -1, -1, 64),
    Key("progressBar", "bool", True),
    Key("progressBarUpdateMs", "int", 1000, 100),
    Key("kMerSize", "int", 31, 15, 31),
    Key("extractKey", "str", ""),
    Key("httpBaseURL", "str", "https://ftp.ncbi.nlm.nih.gov"),
    Key("ftpBaseURL", "str", "ftp.ncbi.nih.gov"),
    Key("refseq.httpBaseURL", "str", "https://ftp.ncbi.nlm.nih.gov/refseq"),
    Key("refseq.ftpBaseURL", "str", "ftp.ncbi.nih.gov"),
    Key("useHttp", "bool", True),
    Key("ignoreMissingFastas", "bool", False),
    Key("maxDownloadTries", "int", 5, 1, 1024),
    Key("seqType", "str", "GENOMIC"),
    Key("rankCompletionDepth", "rank", None),
    Key("checkSumCacheFile", "bool", True),
    Key("maxGenomesPerTaxid", "int", 2**31 - 1, 1),
    Key("maxKMersPerTaxid", "int", 2**63 - 1, 0),
    Key("maxPerTaxidRank", "rank", None),
    Key("alwaysAssumeGzip", "bool", True),
    Key("refseq.filldb", "bool", True),
    Key("refseq.completeGenomesOnly", "bool", False),
    Key("refSeq.limitForGenbankAccess", "int", 0, 0),
    Key("refSeq.limitForGenbankRank", "rank", Rank.by_name("species")),
    Key("refseq.status", "list",
        ["NA", "UNKNOWN", "REVIEWED", "VALIDATED", "PROVISIONAL", "PREDICTED",
         "INFERRED", "MODEL"]),
    Key("reqseq.extract.gzip", "bool", False),
    Key("gzipFastqOutput", "bool", True),
    Key("genbank.maxPerTaxid", "int", 1, -1),
    Key("genbank.fastaQualities", "list", ["COMPLETE_LATEST", "CHROMOSOME_LATEST"]),
    Key("genbank.referenceOnly", "bool", False),
    Key("maxDust", "int", -1, -1),
    Key("dbResizingFactor", "float", 1.0),
    Key("useRadixStore", "bool", False),
    Key("radixStoreBits", "int", 17, 16, 24),
    Key("xorBloomHash", "bool", True),
    Key("minUpdate", "bool", False),
    Key("refseq.updateWithCompleteGenomesOnly", "bool", False),
    Key("removeTempDB", "bool", True),
    Key("stepSize", "int", 1, 1),
    Key("dataNodes", "bool", False),
    Key("idNodes", "bool", False),
    Key("fileNodes", "bool", False),
    Key("lowerCaseBases", "bool", True),
    Key("logProgressUpdateCycle", "int", 1000000, 0),
    Key("classifyReads", "bool", True),
    Key("countUniqueKMers", "bool", True),
    Key("writeFilteredFastq", "bool", False),
    Key("writeKrakenStyleOut", "bool", False),
    Key("writeAll", "bool", True),
    Key("useBloomFilterForMatch", "bool", True),
    Key("maxReadTaxErrorCount", "float", -1.0, -1.0),
    Key("maxReadClassErrorCount", "float", -1.0, -1.0),
    Key("minKMersForClass", "int", 1, 1),
    Key("maxKMerResCounts", "int", 0, 0, 65536),
    Key("writeDumpedFastq", "bool", False),
    Key("minPosCountFilter", "int", 1, 0, 1024),
    Key("posRatioFilter", "float", 0.2, 0.0, 1.0),
    Key("withProbs", "bool", False),
    Key("taxids", "list", []),
    # svg keys
    Key("svgFont", "str", "SansSerif"),
    Key("svgFontSize", "int", 18, 1, 100),
    Key("svgLineHeightFactor", "float", 1.0, 0.5, 10.0),
    Key("svgIndentFactor", "float", 0.75, 0.0, 10.0),
    Key("svgTextGapFactor", "float", 0.25, 0.0, 1.0),
    Key("svgKmerNodeIndentFactor", "float", 0.0, 0.0),
    Key("svgDistanceIndent", "bool", False),
    Key("svgReqNodesBold", "bool", True),
    Key("svgShowRank", "bool", False),
    Key("svgTooLargeDistance", "float", 1.0, 0.0, 1.0),
    Key("svgMarkLongestPath", "bool", False),
    Key("svgShowDistance", "bool", False),
    Key("svgShowDistancePortion", "bool", False),
    # internal keys (ref: GSConfigKey.java:190-400)
    Key("tempBloomFilterFpp", "float", 0.001, 0.0, 1.0),
    Key("indexBloomFilterFpp", "float", 0.00000001, 0.0, 1.0),
    Key("fillBloomFilterFpp", "float", 0.00000000001, 0.0, 1.0),
    Key("optBloomFilterFpp", "float", 0.01, 0.0, 1.0),
    Key("threadQueueSize", "int", 1000, 1),
    Key("initialReadSizeBytes", "int", 4096, 1),
    Key("maxClassificationPaths", "int", 10, 1),
    Key("fastaLineSizeBytes", "int", 4096, 1),
    Key("krakenBin", "str", "krakenuniq"),
    Key("krakenExecExpr", "str", "{0} -db {1} {2}"),
    Key("krakenDB", "str", "krakenuniq"),  # ref GSConfigKey.java:395
    # keys new in this implementation (no reference equivalent)
    Key("matchBatchSize", "int", 8192, 1),
    # shard the k-mer hash table over the device mesh ("auto": when its rows
    # exceed dbShardMinBytes), always ("on") or never ("off") — SURVEY §5.8,
    # the radix-bits-as-shard-key design (ref role:
    # store/RadixKMerStore.java:38-88). dbShardMinBytes = 0 derives the
    # threshold from the smallest device's memory limit
    # (parallel/mesh.auto_shard_min_bytes); a device that reports none
    # replicates.
    Key("dbShard", "str", "auto"),
    Key("dbShardMinBytes", "int", 0, 0),
    Key("dbBuildChunkKMers", "int", 1 << 24, 1 << 16),
    # run the LCA update phase's chunk search + value rewrite on device via
    # the production scatter-join lookup ("auto"/"on": whenever the table
    # is non-empty; "off": host path)
    Key("dbDeviceUpdate", "str", "auto"),
    # persist the derived quotient-hash in the final db zip (bigger file,
    # instant match-time load — the reference similarly serializes its
    # store's internal layout, ref store/Database.java:201-250)
    Key("dbSaveLookupHash", "bool", True),
]

KEYS: dict[str, Key] = {k.name: k for k in _KEYS}

# Keys accepted for compatibility but non-functional in this implementation,
# with the reason. The reference warns about misapplied keys
# (Project.checkConfigProperties:300); we warn when one is set explicitly.
NOOP_KEYS: dict[str, str] = {
    "useBloomFilterForMatch": "the exact quotient hash replaces the bloom pre-filter",
    "useRadixStore": "the device store is always the quotient hash",
    "radixStoreBits": "the device store is always the quotient hash",
    "xorBloomHash": "no bloom filters in this implementation (exact dedup)",
    "tempBloomFilterFpp": "no bloom filters in this implementation (exact dedup)",
    "indexBloomFilterFpp": "the filter index is exact, not probabilistic",
    "fillBloomFilterFpp": "no bloom filters in this implementation (exact dedup)",
    "optBloomFilterFpp": "no bloom filters in this implementation (exact dedup)",
    "threadQueueSize": "batched device pipeline replaces the thread queue",
    "initialReadSizeBytes": "reads are packed into resizable numpy batches",
    "fastaLineSizeBytes": "reads are packed into resizable numpy batches",
}


class Config:
    """Layered typed configuration (highest first: overrides > project > base)."""

    def __init__(self, *layers: dict):
        self.layers = [dict(l) for l in layers if l]
        import logging
        _log = logging.getLogger("genestrip")
        for layer in self.layers:
            for name in layer:
                if name not in KEYS:
                    _log.warning("Unknown config key: %s", name)
                elif name in NOOP_KEYS:
                    _log.warning("Config key '%s' has no effect in this "
                                 "implementation: %s", name, NOOP_KEYS[name])

    def get(self, name: str):
        key = KEYS[name]
        for layer in self.layers:
            if name in layer:
                return key.parse(layer[name])
        return key.default

    def __getitem__(self, name):
        return self.get(name)

    def set_override(self, name: str, value) -> None:
        if not self.layers:
            self.layers = [{}]
        self.layers[0][name] = value

    def as_dict(self) -> dict:
        out = {}
        for k in KEYS:
            v = self.get(k)
            if v is not None:
                out[k] = v
        return out
