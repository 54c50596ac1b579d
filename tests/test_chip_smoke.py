"""chip_smoke.py on the CPU: its entry point refuses a non-GPU backend, and
its world generator, CLI runs and golden comparison work end to end at a
tiny size (the card runs the same functions at full size)."""

import importlib.util
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod      # its dataclass resolves through it
    spec.loader.exec_module(mod)
    return mod


def test_main_fails_without_gpu(smoke, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    assert smoke.main(["--workdir", str(tmp_path / "w")]) != 0
    assert '"ok"' not in capsys.readouterr().out
    assert not (tmp_path / "w").exists()        # refused before any work


def test_world_cli_and_golden_at_tiny_size(smoke, tmp_path):
    world = smoke.make_world(tmp_path / "w", seed=3, genome_bp=100_000,
                             n_reads=400, n_sample=200, n_species=16)
    smoke.run_cli(world, smoke.PROJECT, "db")
    db = smoke.load_db(world)
    assert db.table.entries > 90_000
    # the update moved the clade-B-shared k-mers up to Viruses
    assert db.stats().get("10239", 0) > 0
    smoke.run_cli(world, *smoke.match_args(world, "run1"))
    smoke.run_cli(world, *smoke.match_args(world, "run2"))
    smoke._same_outputs(world, "run1", "run2")
    smoke.run_cli(world, *smoke.match_args(world, "sample", sample=True))
    gold = smoke.golden_compare(world, db, "run1", "sample")
    assert gold["sample_reads"] == 200 and gold["sample_classified"] > 50
    n_cls, hit_share = smoke.classified_share(smoke.outputs(world, "run1")[1])
    assert n_cls > 0 and hit_share >= 0.9
