"""GPU smoke run of the main path: build a database, then match reads, both
through the program's own entry point (genestrip_tpu.cli.main), on data
generated from a seed.

    python chip_smoke.py              # one card
    python chip_smoke.py --four       # the 4-card mesh legs only

One card (the default): a synthetic NCBI-style mirror (taxonomy dump,
RefSeq catalog, a `viral` category of ~17 Mbp of .fna.gz genomes) and a
gzip fastq of 1 M reads of 150 bp are written under --workdir. Then
  * `db` builds a ~16 M k-mer database; its LCA update must take the device
    path and move k-mers;
  * `match` runs twice on the fastq with Kraken-style output, and both runs
    must write byte-identical CSV and Kraken-style files;
  * the first 5000 reads are matched alone, and they and their per-read
    lines from the full run must equal the scalar reference
    (tests/golden_matcher.py) on the database just built;
  * the hit half of the reads must be mostly classified;
  * the scatter-join's dense pass (store/hash.dense_pass) is timed alone at
    the database's own bucket count.

--four: three legs on the same database and reads, each in a child process
of its own and one after another (the parent never opens a card): one card
(which builds the database), four cards with the database replicated
(dbShard=off) and four cards with it sharded (dbShard=on). Both 4-card legs
must write byte-identical CSV and Kraken-style files to the 1-card leg.

Exits non-zero, and prints no result line, when JAX finds no GPU or any
check fails. Otherwise the last stdout line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1 or 4}}.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
import zipfile
from dataclasses import dataclass
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PROJECT = "smoke"
READ_LEN = 150
K = 31
BASES = np.frombuffer(b"ACGT", np.uint8)


class SmokeFailure(Exception):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------------------
# the synthetic world (numpy only: no JAX, no genestrip_tpu)
# ---------------------------------------------------------------------------

@dataclass
class World:
    """The files of a world generated under `workdir`."""
    workdir: Path

    @property
    def base(self) -> Path:         # the CLI's -d base directory
        return self.workdir / "data"

    @property
    def fastq(self) -> Path:        # all reads
        return self.workdir / "reads.fastq.gz"

    @property
    def sample(self) -> Path:       # the first reads of `fastq`
        return self.workdir / "sample.fastq.gz"


def _taxonomy(n_species: int):
    """(taxid, parent, rank, name) rows: root -> Viruses -> clades A and B
    -> genera of 8 species. Clade A, the requested subtree, holds 7/8 of
    the genera."""
    rows = [("1", "1", "no rank", "root"),
            ("10239", "1", "acellular root", "Viruses"),
            ("9000001", "10239", "clade", "Smoke clade A"),
            ("9000002", "10239", "clade", "Smoke clade B")]
    n_genera = max(n_species // 8, 2)
    n_req_genera = max(n_genera * 7 // 8, 1)
    species = []
    for g in range(n_genera):
        gid = str(9100000 + g)
        clade = "9000001" if g < n_req_genera else "9000002"
        rows.append((gid, clade, "genus", f"Smoke genus {g}"))
        for j in range(n_species // n_genera):
            sid = str(9200000 + len(species))
            rows.append((sid, gid, "species", f"Smoke virus {len(species)}"))
            species.append((sid, g, g < n_req_genera))
    return rows, species


def _write_fastq_gz(path: Path, codes: np.ndarray, kinds: np.ndarray) -> None:
    """Fixed-width records '@<kind><7 digits>' / seq / '+' / qual, written in
    vectorized blocks."""
    n, L = codes.shape
    rec = 1 + 8 + 1 + L + 3 + L + 1
    with gzip.open(path, "wb", compresslevel=1) as f:
        for s0 in range(0, n, 1 << 16):
            c = codes[s0:s0 + (1 << 16)]
            m = len(c)
            buf = np.empty((m, rec), np.uint8)
            buf[:, 0] = ord("@")
            buf[:, 1] = kinds[s0:s0 + m]
            idx = np.arange(s0, s0 + m)
            for d in range(7):
                buf[:, 2 + d] = ord("0") + (idx // 10 ** (6 - d)) % 10
            buf[:, 9] = ord("\n")
            buf[:, 10:10 + L] = BASES[c]
            buf[:, 10 + L:13 + L] = np.frombuffer(b"\n+\n", np.uint8)
            buf[:, 13 + L:13 + 2 * L] = ord("I")
            buf[:, -1] = ord("\n")
            f.write(buf.tobytes())


def make_world(workdir: Path, seed: int = 0, genome_bp: int = 17_200_000,
               n_reads: int = 1_000_000, n_sample: int = 5000,
               n_species: int = 256) -> World:
    """Mirror + project + reads under `workdir` (wiped first).

    Requested species share a twentieth of their genome with a sibling of
    their genus; the genomes of clade B, which is not requested, are half
    copies of requested ones. So the LCA update moves k-mers to genus and
    to Viruses level. Half of the reads are 150 bp slices of requested
    genomes (either strand) with 1 % substitutions, half are random."""
    rng = np.random.default_rng(seed)
    if workdir.exists():
        shutil.rmtree(workdir)
    mirror = workdir / "mirror"
    tax_rows, species = _taxonomy(n_species)
    (mirror / "pub/taxonomy").mkdir(parents=True)
    nodes = "".join(f"{t}\t|\t{p}\t|\t{r}\t|\t\t|\t8\t|\t0\t|\t1\t|\t0\t|\t0\t|"
                    f"\t0\t|\t0\t|\t0\t|\t\t|\n" for t, p, r, _ in tax_rows)
    names = "".join(f"{t}\t|\t{nm}\t|\t\t|\tscientific name\t|\n"
                    for t, _, _, nm in tax_rows)
    with zipfile.ZipFile(mirror / "pub/taxonomy/taxdmp.zip", "w") as z:
        z.writestr("nodes.dmp", nodes)
        z.writestr("names.dmp", names)

    req = [i for i, s in enumerate(species) if s[2]]
    other = [i for i, s in enumerate(species) if not s[2]]
    glen = np.zeros(len(species), np.int64)
    glen[req] = genome_bp // len(req)
    glen[other] = max(genome_bp // 16 // max(len(other), 1), 2 * READ_LEN)
    genomes = [rng.integers(0, 4, int(n), dtype=np.uint8) for n in glen]
    for i in req:                     # a twentieth shared with the sibling
        j = i - 1
        if j >= 0 and species[j][1] == species[i][1]:
            n = int(glen[i]) // 20
            a = rng.integers(0, glen[j] - n)
            b = rng.integers(0, glen[i] - n)
            genomes[i][b:b + n] = genomes[j][a:a + n]
    for i in other:                   # every other block from clade A
        seg = min(1000, int(glen[i]) // 2)
        for b in range(0, int(glen[i]) - seg + 1, 2 * seg):
            j = req[rng.integers(0, len(req))]
            a = rng.integers(0, glen[j] - seg)
            genomes[i][b:b + seg] = genomes[j][a:a + seg]

    rel = mirror / "refseq/release"
    (rel / "viral").mkdir(parents=True)
    (rel / "release-catalog").mkdir(parents=True)
    (rel / "RELEASE_NUMBER").write_text("230\n")
    catalog, installed = [], []
    n_files = 8
    for fi in range(n_files):
        name = f"viral.{fi + 1}.1.genomic.fna.gz"
        fna = rel / "viral" / name
        with gzip.open(fna, "wb", compresslevel=1) as f:
            for i in range(fi, len(species), n_files):
                acc = f"NC_{900000 + i:06d}.1"
                f.write(f">{acc} Smoke virus {i}, complete genome\n".encode())
                txt = BASES[genomes[i]]
                pad = (-len(txt)) % 80
                lines = np.concatenate([txt, np.full(pad, 0, np.uint8)])
                lines = lines.reshape(-1, 80)
                out = np.empty((len(lines), 81), np.uint8)
                out[:, :80] = lines
                out[:, 80] = ord("\n")
                blob = out.tobytes()
                if pad:
                    blob = blob[:-(pad + 1)] + b"\n"
                f.write(blob)
                catalog.append(f"{species[i][0]}\tSmoke virus {i}\t{acc}\t"
                               f"viral\tPROVISIONAL\t{glen[i]}\n")
        installed.append(f"{hashlib.md5(fna.read_bytes()).hexdigest()}\t{name}\n")
    with gzip.open(rel / "release-catalog/RefSeq-release230.catalog.gz",
                   "wb") as f:
        f.write("".join(catalog).encode())
    (rel / "release-catalog/release230.files.installed").write_text(
        "".join(installed))

    world = World(workdir)
    proj = world.base / "projects" / PROJECT
    proj.mkdir(parents=True)
    (proj / "taxids.txt").write_text("9000001\n")
    (proj / "categories.txt").write_text("viral\n")
    (proj / "config.properties").write_text(
        f"httpBaseURL=file://{mirror}\n"
        f"refseq.httpBaseURL=file://{mirror}/refseq\n")

    # reads: hits are slices of requested genomes, either strand
    n_hit = n_reads // 2
    cat = np.concatenate([genomes[i] for i in req])
    offs = np.concatenate([[0], np.cumsum(glen[req])[:-1]])
    span = glen[req] - READ_LEN + 1
    g = rng.choice(len(req), n_hit, p=span / span.sum())
    start = offs[g] + (rng.random(n_hit) * span[g]).astype(np.int64)
    hits = cat[start[:, None] + np.arange(READ_LEN)]
    sub = rng.random(hits.shape) < 0.01
    hits[sub] = (hits[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    rc = rng.random(n_hit) < 0.5
    hits[rc] = 3 - hits[rc, ::-1]
    rand = rng.integers(0, 4, (n_reads - n_hit, READ_LEN), dtype=np.uint8)
    codes = np.concatenate([hits, rand])
    kinds = np.concatenate([np.full(n_hit, ord("h"), np.uint8),
                            np.full(n_reads - n_hit, ord("r"), np.uint8)])
    order = rng.permutation(n_reads)
    codes, kinds = codes[order], kinds[order]
    _write_fastq_gz(world.fastq, codes, kinds)
    _write_fastq_gz(world.sample, codes[:n_sample], kinds[:n_sample])
    return world


# ---------------------------------------------------------------------------
# the program, in-process, and the checks
# ---------------------------------------------------------------------------

def run_cli(world: World, *args) -> float:
    """genestrip_tpu.cli.main(-d <base> ... <project> <goal>); wall s."""
    from genestrip_tpu import cli
    t0 = time.time()
    rc = cli.main(["-d", str(world.base), *args])
    check(rc == 0, f"cli {' '.join(args)} exited with {rc}")
    return time.time() - t0


def match_args(world: World, key: str, sample: bool = False, extra=()):
    fq = world.sample if sample else world.fastq
    return ["-f", str(fq), "-k", key, "-C", "writeKrakenStyleOut=true",
            *extra, PROJECT, "match"]


def outputs(world: World, key: str) -> tuple[Path, Path]:
    """(match CSV, Kraken-style output) of a match run under `key`."""
    from genestrip_tpu.project import Common, Project
    p = Project(Common(world.base), PROJECT)
    return (p.output_file("match", "csv", key=key),
            p.output_file("matchres", "kraken_out", key=key))


def load_db(world: World):
    from genestrip_tpu.project import Common, Project
    from genestrip_tpu.store.database import Database
    return Database.load(Project(Common(world.base), PROJECT).db_file)


def _sample_reads(world: World) -> list[tuple[str, bytes]]:
    with gzip.open(world.sample, "rb") as f:
        lines = f.read().split(b"\n")
    return [(lines[i][1:].decode(), lines[i + 1])
            for i in range(0, len(lines) - 1, 4)]


def golden_compare(world: World, db, full_key: str, sample_key: str) -> dict:
    """The sample's per-read lines of the full run and the per-taxid
    integer columns of the sample's own match CSV must equal the scalar
    reference (tests/golden_matcher.py) on `db`. The float error means may
    differ by host summation order only: atol 1e-12, the tolerance of
    tests/test_match_parity.py."""
    sys.path.insert(0, str(ROOT / "tests"))
    from golden_matcher import GoldenMatcher
    from genestrip_tpu.utils.dna import seq_to_codes

    tree = db.tree
    gm = GoldenMatcher(db.table, tree, db.k)
    reads = _sample_reads(world)
    exp_lines = []
    for name, seq in reads:
        cls, segments, _ = gm.match_read(seq_to_codes(seq))
        segs = b" ".join(
            (b"A" if lab == -2 else b"0" if lab == -1
             else tree.taxids[lab].encode()) + b":" + str(ln).encode()
            for lab, ln in segments)
        exp_lines.append((b"C\t" if cls >= 0 else b"U\t") + name.encode()
                         + b"\t" + (tree.taxids[cls].encode() if cls >= 0
                                    else b"0")
                         + b"\t" + str(len(seq)).encode() + b"\t" + segs)
    with open(outputs(world, full_key)[1], "rb") as f:
        got_lines = [f.readline().rstrip(b"\n") for _ in reads]
    bad = [i for i, (a, b) in enumerate(zip(got_lines, exp_lines)) if a != b]
    check(not bad, f"{len(bad)} of {len(reads)} sample reads differ from the "
                   f"golden matcher, first: {got_lines[bad[0]]!r} vs "
                   f"{exp_lines[bad[0]]!r}" if bad else "")

    lines = outputs(world, sample_key)[0].read_text().splitlines()
    head = lines[0].split(";")
    col = {name: head.index(name) for name in (
        "taxid", "reads", "kmers from reads", "kmers", "unique kmers",
        "contigs", "max contig length", "reads >=1 kmer", "mean error",
        "mean class error")}
    unique = gm.unique_per_node()
    seen_nodes = set()
    for line in lines[1:]:
        f = line.split(";")
        if not f[col["taxid"]] or f[2] == "TOTAL":
            continue
        t = tree.get(f[col["taxid"]])
        check(t >= 0, f"CSV taxid {f[col['taxid']]} not in the database")
        seen_nodes.add(t)
        g = gm.stats[t]
        want = {"reads": g.reads, "kmers from reads": g.reads_kmers,
                "kmers": g.kmers, "unique kmers": int(unique[t]),
                "contigs": g.contigs, "max contig length": g.max_contig,
                "reads >=1 kmer": g.reads1_kmer}
        for name, v in want.items():
            check(int(f[col[name]]) == v,
                  f"taxid {f[col['taxid']]} {name}: {f[col[name]]} != {v}")
        for name, s in (("mean error", g.error_sum),
                        ("mean class error", g.class_error_sum)):
            if g.reads:
                check(abs(float(f[col[name]]) - s / g.reads) <= 1e-12,
                      f"taxid {f[col['taxid']]} {name}: {f[col[name]]} "
                      f"vs {s / g.reads}")
    active = {t for t, g in enumerate(gm.stats)
              if g.reads or g.kmers or g.reads1_kmer}
    check(active <= seen_nodes,
          f"golden taxa missing from the CSV: {sorted(active - seen_nodes)}")
    classified = sum(1 for l in exp_lines if l.startswith(b"C"))
    return {"sample_reads": len(reads), "sample_classified": classified,
            "taxa_compared": len(seen_nodes)}


def classified_share(kraken_path: Path) -> tuple[int, float]:
    """(classified reads, classified share of the hit reads)."""
    n_cls = n_hit = n_hit_cls = 0
    with open(kraken_path, "rb") as f:
        for line in f:
            c = line[0] == ord("C")
            n_cls += c
            if line[2] == ord("h"):
                n_hit += 1
                n_hit_cls += c
    return n_cls, n_hit_cls / max(n_hit, 1)


class _Probe:
    """Records, through wrappers around the program's own functions, what
    the checks read: which LCA-update path ran and what it moved, the first
    match step's compile time, Matcher.run's wall time and mesh choice."""

    def __init__(self):
        import jax
        from genestrip_tpu.db import build
        from genestrip_tpu.match import matcher as mm

        self.update = {}
        self.runs = []
        self.first_step = None
        self.compile_s = []
        jax.monitoring.register_event_duration_secs_listener(
            lambda ev, s, **kw: self.compile_s.append(s)
            if ev == "/jax/core/compile/backend_compile_duration" else None)

        fin = build.DBUpdater.finalize

        def finalize(upd):
            fin(upd)
            self.update = {"device": upd._dev is not None,
                           "moved": upd.kmers_moved}
        build.DBUpdater.finalize = finalize

        run = mm.Matcher.run

        def timed_run(m, *a, **kw):
            t0 = time.time()
            res = run(m, *a, **kw)
            self.runs.append({"s": time.time() - t0, "reads": m.total_reads,
                              "mesh": m._mesh is not None,
                              "shard_db": m.shard_db})
            return res
        mm.Matcher.run = timed_run

        step = mm.match_accum_step

        def first_step(*a, **kw):
            if self.first_step is not None:
                return step(*a, **kw)
            n0, t0 = len(self.compile_s), time.time()
            out = jax.block_until_ready(step(*a, **kw))
            self.first_step = {"s": time.time() - t0,
                               "compile_s": sum(self.compile_s[n0:])}
            return out
        mm.match_accum_step = first_step


def time_dense_pass(db) -> dict:
    """The scatter-join's dense pass alone (store/hash.dense_pass, as XLA
    compiles it) at the database's bucket count and the lane count a
    default 8192-read batch gets; random scratch lanes."""
    import jax
    import jax.numpy as jnp
    from genestrip_tpu.store.hash import dense_pass

    ht = db.prebuilt_hash
    rows = jnp.asarray(ht.rows)
    nb = rows.shape[0]
    q = 8192 * (READ_LEN - K + 1)
    r = 4 if 2 * q / nb <= 0.5 else (6 if 2 * q / nb <= 1.0 else 8)
    rng = np.random.default_rng(1)
    sh2 = jnp.asarray(rng.integers(-2**31, 2**31, (nb, r), np.int64)
                      .astype(np.int32))
    sw = jnp.asarray(rng.integers(0, 2**20, (nb, r), np.int64)
                     .astype(np.int32))
    fn = jax.jit(lambda a, b, c: dense_pass(a, b, c, vb=ht.nb_bits - 1))
    jax.block_until_ready(fn(rows, sh2, sw))
    reps = 20
    t0 = time.time()
    for _ in range(reps):
        out = fn(rows, sh2, sw)
    jax.block_until_ready(out)
    dt = (time.time() - t0) / reps
    # rows + 2 scratch planes read, found (1 B) + vidx + slot written
    nbytes = nb * 32 + nb * r * (8 + 9)
    return {"buckets": nb, "lanes": r, "ms": dt * 1e3,
            "GB_per_s": nbytes / dt / 1e9}


def nvidia_smi() -> list[str]:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    check(r.returncode == 0 and r.stdout.strip(), "nvidia-smi failed")
    return r.stdout.strip().splitlines()


def _device(n_expected: int) -> dict:
    import jax
    devs = jax.devices()
    check(jax.default_backend() == "gpu",
          f"JAX backend is {jax.default_backend()!r}, not 'gpu'")
    check(len(devs) == n_expected,
          f"{len(devs)} devices visible, {n_expected} expected")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def _same_outputs(world: World, key_a: str, key_b: str) -> None:
    for a, b in zip(outputs(world, key_a), outputs(world, key_b)):
        check(a.read_bytes() == b.read_bytes(),
              f"{a.name} and {b.name} differ")


def run_single(args) -> dict:
    import jax
    device = _device(1)
    for line in nvidia_smi():
        print(line, flush=True)
    probe = _Probe()
    t0 = time.time()
    world = make_world(args.workdir, args.seed, args.genome_bp, args.reads)
    print(f"world: {args.reads} reads, {time.time() - t0:.1f} s to generate",
          flush=True)

    db_s = run_cli(world, PROJECT, "db")
    check(probe.update.get("device"), "the LCA update did not run on device")
    check(probe.update["moved"] > 0, "the LCA update moved no k-mers")
    db = load_db(world)
    ht = db.prebuilt_hash
    print(f"db: {db.table.entries} stored k-mers, "
          f"{probe.update['moved']} moved by the device LCA update, "
          f"{ht.rows.nbytes} bytes of hash rows ({ht.nb} buckets); "
          f"{db_s:.1f} s", flush=True)

    m1_s = run_cli(world, *match_args(world, "run1"))
    opts = jax.profiler.ProfileOptions()
    opts.python_tracer_level = 0        # device + XLA host events only
    with (jax.profiler.trace(str(args.trace), profiler_options=opts)
          if args.trace else contextlib.nullcontext()):
        m2_s = run_cli(world, *match_args(world, "run2"))
    _same_outputs(world, "run1", "run2")
    run2 = probe.runs[1]
    print(f"match: run 1 {m1_s:.1f} s, run 2 {m2_s:.1f} s (CLI goal wall); "
          f"first match step {probe.first_step['s']:.2f} s of which XLA "
          f"compile {probe.first_step['compile_s']:.2f} s; "
          f"{run2['reads'] / run2['s']:.0f} reads/s through Matcher.run "
          f"(run 2); runs 1 and 2 byte-identical", flush=True)

    n_cls, hit_share = classified_share(outputs(world, "run1")[1])
    check(n_cls > 0, "no read was classified")
    check(hit_share >= 0.9, f"only {hit_share:.3f} of the hit reads classified")
    sample_s = run_cli(world, *match_args(world, "sample", sample=True))
    gold = golden_compare(world, db, "run1", "sample")
    print(f"golden: {gold['sample_reads']} sample reads "
          f"({gold['sample_classified']} classified) and {gold['taxa_compared']}"
          f" taxa equal the scalar reference; sample match {sample_s:.1f} s; "
          f"{n_cls} of {args.reads} reads classified, hit reads "
          f"{hit_share:.4f}", flush=True)

    dp = time_dense_pass(db)
    print(f"dense pass (XLA): {dp['buckets']} buckets x {dp['lanes']} lanes, "
          f"{dp['ms']:.3f} ms, {dp['GB_per_s']:.0f} GB/s", flush=True)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    print(f"peak_bytes_in_use: {peak}", flush=True)
    shutil.rmtree(args.workdir)
    return device


def run_leg(args) -> None:
    """One leg of --four, in its own process: prints one JSON line."""
    n = 1 if args.leg == "one" else 4
    device = _device(n)
    probe = _Probe()
    world = World(args.workdir)
    db_s = run_cli(world, PROJECT, "db") if args.leg == "one" else None
    extra = {"one": (), "rep": ("-C", "dbShard=off"),
             "shard": ("-C", "dbShard=on")}[args.leg]
    m_s = run_cli(world, *match_args(world, args.leg, extra=extra))
    print(json.dumps({"leg": args.leg, "device": device, "db_s": db_s,
                      "match_s": m_s, "run": probe.runs[-1]}), flush=True)


def run_four(args) -> dict:
    for line in nvidia_smi():
        print(line, flush=True)
    world = make_world(args.workdir, args.seed, args.genome_bp, args.reads)
    legs = {}
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    for leg in ("one", "rep", "shard"):
        env = dict(os.environ)
        if leg == "one":
            env["CUDA_VISIBLE_DEVICES"] = first
        cmd = [sys.executable, str(Path(__file__).resolve()), "--leg", leg,
               "--workdir", str(args.workdir)]
        r = subprocess.run(cmd, env=env, stdout=subprocess.PIPE, text=True)
        check(r.returncode == 0, f"leg {leg} exited with {r.returncode}")
        legs[leg] = json.loads(r.stdout.strip().splitlines()[-1])
        print(f"leg {leg}: {json.dumps(legs[leg])}", flush=True)
    check(not legs["rep"]["run"]["shard_db"] and legs["rep"]["run"]["mesh"],
          "the replicated leg did not run on a replicated mesh")
    check(legs["shard"]["run"]["shard_db"], "the sharded leg did not shard")
    _same_outputs(world, "one", "rep")
    _same_outputs(world, "one", "shard")
    print("4-card replicated and 4-card sharded outputs are byte-identical "
          "to the 1-card leg", flush=True)
    shutil.rmtree(args.workdir)
    return legs["shard"]["device"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run the 1-card / 4-card replicated / 4-card "
                         "sharded legs only")
    ap.add_argument("--reads", type=int, default=1_000_000)
    ap.add_argument("--genome-bp", type=int, default=17_200_000,
                    help="bases of the requested genomes")
    ap.add_argument("--workdir", type=Path, default=ROOT / ".smoke")
    ap.add_argument("--trace", type=Path,
                    help="write a jax.profiler trace of match run 2 here")
    ap.add_argument("--leg", choices=("one", "rep", "shard"),
                    help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.four and not args.leg:
        # one card: Matcher would otherwise mesh over every visible card
        os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get(
            "CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    try:
        if args.leg:
            run_leg(args)
            return 0
        device = run_four(args) if args.four else run_single(args)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
