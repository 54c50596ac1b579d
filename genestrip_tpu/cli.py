"""Command-line interface: `genestrip-tpu [options] <project> [<goal1> ...]`.

Reference equivalent: core Main.java (options -v -d -t -i -f -k -m -r -tx
-db -C; parse -> createProject -> GSMaker -> make/clean targets,
ref Main.java:70-114,197-324).
"""

from __future__ import annotations

import argparse
import logging
import sys

from genestrip_tpu import __version__
from genestrip_tpu.maker import GSMaker
from genestrip_tpu.project import Common, Project


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="genestrip-tpu",
        description="JAX metagenomic k-mer classification engine "
                    "(Genestrip-compatible projects and goals)")
    ap.add_argument("-v", action="store_true", help="Print version.")
    ap.add_argument("-d", metavar="base dir", default="./data",
                    help="Base directory for all data files (default './data').")
    ap.add_argument("-t", metavar="target", default="make",
                    choices=["make", "clean", "cleanall", "cleantotal"],
                    help="Generation target ('make', 'clean', 'cleanall' or 'cleantotal').")
    ap.add_argument("-f", metavar="fqfile1,fqfile2,...",
                    help="Fastq files (or URLs) to match or filter, separated by ','.")
    ap.add_argument("-k", metavar="key", help="Key for given fastq files.")
    ap.add_argument("-m", metavar="fqmap", help="Mapping file '<key> <path_or_URL>' per line.")
    ap.add_argument("-r", metavar="res dir", help="Directory for result CSV files.")
    ap.add_argument("-db", metavar="database", help="Path to database file (use without project context).")
    ap.add_argument("-tx", metavar="taxids", help="Tax ids for db2fastq, separated by ','.")
    ap.add_argument("-C", metavar="key=value", action="append", default=[],
                    help="Configuration parameter override (repeatable).")
    ap.add_argument("-ll", action="store_true", help="Download URL fastqs to common dir.")
    ap.add_argument("-l", action="store_true", help="Download URL fastqs to project dir.")
    ap.add_argument("-i", action="store_true",
                    help="Make goals independently (release memory between them).")
    ap.add_argument("project", nargs="?", help="Project name.")
    ap.add_argument("goals", nargs="*", help="Goals to run (default: show).")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.v:
        print(f"genestrip-tpu {__version__}")
        return 0
    # multi-host launch (explicit coordinator env or GENESTRIP_MULTIHOST=1):
    # no-op when single-process — see parallel/distributed.py
    from genestrip_tpu.parallel import distributed
    distributed.maybe_initialize()
    if not args.project:
        print("Missing project name. Use -h for help.", file=sys.stderr)
        return 2

    overrides = {}
    for kv in args.C:
        k, _, v = kv.partition("=")
        overrides[k.strip()] = v.strip()

    logging.basicConfig(
        level=getattr(logging, overrides.get("logLevel", "info").upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")

    common = Common(args.d)
    project = Project(common, args.project, overrides=overrides,
                      db_path=args.db, csv_dir=args.r)
    fastqs = args.f.split(",") if args.f else []
    download_fastqs = "common" if args.ll else ("project" if args.l else None)
    maker = GSMaker(project, fastq_args=fastqs, map_file=args.m, key=args.k,
                    taxids_arg=args.tx, download_fastqs=download_fastqs)

    goals = args.goals or ["show"]
    make_names = []
    for goal_name in goals:
        if goal_name in ("show", "showall"):
            names = (maker.maker.user_goals() if goal_name == "show"
                     else sorted(maker.maker.goals))
            print("Goals:", " ".join(names))
            continue
        g = maker.goal(goal_name)
        if args.t == "make":
            make_names.append(goal_name)
        elif args.t == "clean":
            g.clean()
        elif args.t == "cleanall":
            g.clean_all(False)
        elif args.t == "cleantotal":
            g.clean_all(True)
    if make_names:
        # default: one aggregate run so shared in-memory values live across
        # goals; -i makes each goal independently (ref Main.java:214,320)
        maker.maker.make(*make_names, isolate=args.i)
    return 0


if __name__ == "__main__":
    sys.exit(main())
