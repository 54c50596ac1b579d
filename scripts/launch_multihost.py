"""REAL 2-process multi-host run: jax.distributed.initialize over a local
coordinator, file-level data parallelism, aggregation-time merge — and a
1-vs-2-process scaling measurement written to MULTIHOST.json.

What this establishes: the production multi-host path
(parallel/distributed.maybe_initialize -> Matcher file sharding ->
_merge_across_processes via jax.experimental.multihost_utils) executes with
process_count() == 2 REAL processes and the merged statistics equal a
single-process run over all files bit-for-bit.

Usage:
  python scripts/launch_multihost.py            # parent: runs everything
  (children are spawned internally with --child)

Runs on the CPU backend (JAX_PLATFORMS=cpu) — the distributed coordination
service is backend-independent, and the children get their coordinator,
process count and id from the environment (parallel/distributed.py).
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np

N_FILES = 8
N_READS = 6000         # per file
READ_LEN = 120
K = 21
SEED = 424242

# one XLA intra-op thread per process: the single-process run must not use
# the whole host's cores, or the 2-process "scaling efficiency" on a small
# host measures core contention instead of the distributed overhead (on real
# multi-host, every process owns a full host)
def _fair_env(env):
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_cpu_multi_thread_eigen=false"
                        " intra_op_parallelism_threads=1").strip()
    env["OPENBLAS_NUM_THREADS"] = "1"
    return env


def build_world(tmp: Path):
    """Deterministic world: every process builds the identical table/tree
    (bench.build_world is the single synthetic-world recipe)."""
    import bench

    table, tree, nov, genome = bench.build_world(200_000, 16, seed=SEED, k=K)
    tree.node_of_value = lambda tb: nov
    return table, tree, genome


def write_shards(tmp: Path, genome) -> list:
    import gzip
    if (tmp / "shards.done").exists():
        # already written by an earlier run in this tmp (the single-process
        # reference run precedes the 2-process one) — rewriting here would
        # race with the other process reading them
        return [str(tmp / f"shard{i}.fastq.gz") for i in range(N_FILES)]
    rng = np.random.default_rng(SEED + 1)
    base_map = np.frombuffer(b"ACGT", np.uint8)
    files = []
    for i in range(N_FILES):
        p = tmp / f"shard{i}.fastq.gz"
        with gzip.open(p, "wb", compresslevel=1) as f:
            for r in range(N_READS):
                if rng.random() < 0.5:
                    s = int(rng.integers(0, len(genome) - READ_LEN))
                    codes = genome[s:s + READ_LEN]
                else:
                    codes = rng.integers(0, 4, READ_LEN).astype(np.uint8)
                f.write(b"@f%d_r%d\n" % (i, r))
                f.write(base_map[codes].tobytes())
                f.write(b"\n+\n" + b"I" * READ_LEN + b"\n")
        files.append(str(p))
    (tmp / "shards.done").write_text("ok\n")
    return files


def run_match(tmp: Path, out_npz: Path):
    """Runs the matcher over all shards (this process's share) and saves the
    merged state. Under a 2-process launch Matcher.run shards the files and
    _merge_across_processes all-gathers for real."""
    from genestrip_tpu.match.matcher import Matcher
    from genestrip_tpu.match.pipeline import MatchConfig
    from genestrip_tpu.parallel import distributed as dist

    table, tree, genome = build_world(tmp)
    files = write_shards(tmp, genome) if dist.process_index() == 0 else None
    if files is None:
        files = [str(tmp / f"shard{i}.fastq.gz") for i in range(N_FILES)]
    # barrier-by-poll on the completion marker (file existence alone could
    # observe a half-written shard)
    for _ in range(600):
        if (tmp / "shards.done").exists():
            break
        time.sleep(0.1)
    m = Matcher(table, tree, MatchConfig(k=K), db_md5="mh", batch_size=256)
    m.progress = False
    if os.environ.get("MH_DEBUG"):
        orig_merge = m._merge_across_processes

        def timed_merge(allgather=None):
            t = time.time()
            orig_merge(allgather)
            print(f"# p{dist.process_index()} merge {time.time() - t:.2f}s",
                  flush=True)
        m._merge_across_processes = timed_merge
    # warmup excludes per-process XLA compile from the scaling measurement
    # (every process pays it once regardless of process count); one file per
    # process so EVERY process's jit actually compiles here
    tw = time.time()
    m.run(files[: dist.process_count()])
    m.reset()
    t0 = time.time()
    res = m.run(files)
    dt = time.time() - t0
    if os.environ.get("MH_DEBUG"):
        print(f"# p{dist.process_index()}: warmup={t0 - tw:.2f}s "
              f"run={dt:.2f}s", flush=True)
    np.savez(out_npz,
             kmers=m.kmers, contigs=m.contigs, contig_sq=m.contig_sq,
             reads=m.reads, reads1=m.reads1, reads_kmers=m.reads_kmers,
             reads_bps=m.reads_bps, error_sum=m.error_sum,
             max_contig=m.max_contig,
             unique=m._unique_per_node(),
             totals=np.array([m.total_reads, m.total_kmers, m.total_bps]),
             wall=np.float64(dt))
    return res


def _force_cpu():
    # the children run on the CPU backend even where an accelerator is
    # visible; forcing through jax.config after import wins over any
    # platform preset (same as tests/conftest.py)
    import jax
    jax.config.update("jax_platforms", "cpu")


def child_main():
    _force_cpu()
    # the production init path must trigger via the environment
    from genestrip_tpu.parallel import distributed as dist
    dist.maybe_initialize()
    import jax
    assert jax.process_count() == 2, jax.process_count()
    tmp = Path(os.environ["MH_TMP"])
    pid = jax.process_index()
    run_match(tmp, tmp / f"merged_p{pid}.npz")
    print(f"# child {pid}: process_count={jax.process_count()} done",
          flush=True)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def parent_main():
    import tempfile
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        # --- single-process reference run (also the 1-proc wall-clock) ---
        env1 = _fair_env(dict(os.environ, JAX_PLATFORMS="cpu",
                              MH_TMP=str(tmp)))
        env1.pop("JAX_COORDINATOR_ADDRESS", None)
        # pin every process (single AND each child) to ONE core: each
        # "host" then has identical compute, so efficiency measures the
        # distributed overhead, not core contention on this small machine
        r = subprocess.run(
            ["taskset", "-c", "0", sys.executable, __file__, "--single"],
            env=env1, timeout=600)
        assert r.returncode == 0
        single = np.load(tmp / "merged_single.npz")
        t1 = float(single["wall"])

        # --- real 2-process run ---
        port = free_port()
        procs = []
        t0 = time.time()
        for pid in range(2):
            env = _fair_env(dict(os.environ,
                                 JAX_PLATFORMS="cpu",
                                 GENESTRIP_COORDINATOR=f"127.0.0.1:{port}",
                                 JAX_NUM_PROCESSES="2",
                                 JAX_PROCESS_ID=str(pid),
                                 MH_TMP=str(tmp)))
            procs.append(subprocess.Popen(
                ["taskset", "-c", str(pid), sys.executable, __file__,
                 "--child"], env=env))
        rcs = [p.wait(timeout=600) for p in procs]
        t2_total = time.time() - t0
        assert rcs == [0, 0], rcs

        # merged state must be identical on every process and equal single
        fields = ["kmers", "contigs", "contig_sq", "reads", "reads1",
                  "reads_kmers", "reads_bps", "error_sum", "max_contig",
                  "unique", "totals"]
        for pid in range(2):
            got = np.load(tmp / f"merged_p{pid}.npz")
            for f in fields:
                if got[f].dtype.kind == "f":
                    # float error sums: deterministic partial-sum order, may
                    # differ from read-order addition in the last ulps
                    np.testing.assert_allclose(
                        got[f], single[f], rtol=1e-12, atol=1e-12,
                        err_msg=f"p{pid}:{f}")
                else:
                    np.testing.assert_array_equal(
                        got[f], single[f], err_msg=f"p{pid}:{f}")
        t2 = max(float(np.load(tmp / f"merged_p{pid}.npz")["wall"])
                 for pid in range(2))
        eff = t1 / (2 * t2) if t2 > 0 else 0.0
        out = {
            "processes": 2,
            "merged_equals_single": True,
            "wall_1proc_s": round(t1, 2),
            "wall_2proc_s": round(t2, 2),
            "wall_2proc_total_s": round(t2_total, 2),
            "scaling_efficiency": round(eff, 3),
            "note": ("CPU backend; every process pinned to one core so the "
                     "configs have identical per-process compute - the "
                     "efficiency measures the REAL jax.distributed "
                     "coordination + packed process_allgather merge "
                     "overhead (warmup excludes per-process XLA compile)"),
        }
        with open(ROOT / "MULTIHOST.json", "w") as f:
            json.dump(out, f, indent=1)
        print(json.dumps(out))


def single_main():
    _force_cpu()
    tmp = Path(os.environ["MH_TMP"])
    run_match(tmp, tmp / "merged_single.npz")


if __name__ == "__main__":
    if "--child" in sys.argv:
        child_main()
    elif "--single" in sys.argv:
        single_main()
    else:
        parent_main()
