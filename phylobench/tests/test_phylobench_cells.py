"""Every cell's traffic, dry-run at a tiny size on the CPU, the import
check, and the cells on the card (marked `cuda`)."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT, WORKLOADS, tiny
from phylobench import run


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_dry_run(workload, trace):
    out, rows = run.run_cell(workload, 2 ** 33 + 5, 0.6, bool(trace),
                             device="cpu", config=tiny(workload))
    assert out["correct"], rows
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    bench = run.load_json(ROOT / "BENCHMARK.json")
    names = {m["name"] for m in bench["end_to_end"]
             if workload in m.get("workloads", [workload])}
    if not trace:
        assert set(out["metrics"]) == names
        assert all(m["value"] > 0 for m in out["metrics"].values())
    else:
        # No device here: only what the host measures is reported.
        assert "busy_s" in out["device"] and "window_s" in out["device"]
        for name in out["metrics"]:
            assert name in {"push_ms_per_probe", "candidates_per_dispatch"}


def test_spr_counts_agree_with_the_program():
    out, rows = run.run_cell("birds48.spr", 77, 1.5, False, device="cpu",
                             config=tiny("birds48.spr"))
    assert dict((n, v) for n, v, _ in rows)["plan_mismatches"] == 0


CHECK = """
import sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from conftest import tiny
from phylobench import run
run.run_cell("birds48.probe", 5, 0.3, False, device="cpu",
             config=tiny("birds48.probe"))
import examl_tpu_torch
print(run.forbidden_modules())
"""


def test_no_jax_module_after_a_run():
    code = CHECK.format(root=str(ROOT), tests=str(ROOT / "phylobench/tests"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    # examl_tpu_torch is loaded; its name begins with examl_tpu, but the
    # whole top-level name differs.
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "examl_tpu_torchx", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]


def test_no_result_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the harness exits with an
    error and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "phylobench", tmp_path / "phylobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "phylobench", "--workload",
                        "birds48.probe", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert not p.stdout.strip()


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_on_the_card(card, workload):
    p = subprocess.run([sys.executable, "-m", "phylobench", "--workload",
                        workload, "--seed", "2147483999", "--seconds", "5",
                        "--trace", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["busy_s"] > 0
