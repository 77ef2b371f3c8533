"""The extension bank and the kernel-free scan route on the CPU.

No nvcc and no card here: a fake `nvcc` first on PATH (a Python script)
copies a stub shared library that exports every symbol of
`_build.SIGNATURES`, fails, or hangs with a child of its own (as nvcc
hangs in ptxas), and logs each build it starts; `EXAML_BUILD_DIR` puts
the build directory in the test's temporary directory.

* the families each config banks, against the JAX package's enumeration
  for the same routes;
* without `--bank` a failed build raises KernelError, and `build_all`'s
  deadline kills nvcc with its process group;
* `run_bank` builds in workers, records the manifest (families and
  entries, round trip, merge), warms the main process; a hanging build
  is killed at its deadline and its family degraded onto the right flag
  (B1 -> `--newview scan`, B2 -> `--newview chunk`), as are a
  `bank.worker` kill and a `compile.hang` in the worker; through the
  CLI a hung build ends on the scan route with an ERROR line, the
  counters, and the lnL of a plain `--newview scan` run;
* the export bank: a truncated, corrupt or mismatched library is
  quarantined and rebuilt under `on`, raises `ExportBankRequired` under
  `require`, and the `bank.export.write` / `bank.export.load` faults are
  survivable;
* `bank_barrier` over a 2-rank gloo group: the library is built once;
* the scan route (`newview="scan"`) never enters a kernel wrapper and
  matches the JAX package under EXAML_FAST_TRAVERSAL=0 (rtol 1e-10,
  f64): ref49 from the initial model on the gradient route (evaluate,
  `tree_evaluate`, one `mod_opt` round; the whole `-f e` through both
  CLIs, -16205.711310 in both, is marked slow: ~13 minutes on the CPU),
  and the pinned 8-taxon `-f d` with per-branch smoothing
  (EXAML_GRAD_SMOOTH=0) from one newick text.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from examl_tpu_torch import obs
from examl_tpu_torch.cli.main import main
from examl_tpu_torch.ops import _build, bank, engine, export_bank
from examl_tpu_torch.resilience import faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF49 = os.path.join(REPO, "tests", "fixtures", "ref49")

FAKE_NVCC = r'''#!{python}
import os, subprocess, sys, time
args = sys.argv[1:]
if args == ["--version"]:
    print("nvcc: NVIDIA (R) Cuda compiler driver")
    print("Cuda compilation tools, release 12.4, V12.4.131")
    sys.exit(0)
out = args[args.index("-o") + 1]
src = os.path.basename(args[-1])
with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
    f.write(f"{{os.getpid()}} {{src}}\n")
mode = os.environ.get("FAKE_NVCC_MODE", "ok")
if mode == "fail":
    print(f"{{src}}(1): error: a fake compile error")
    sys.exit(1)
if mode.startswith("hang") and (mode == "hang"
                                 or src.startswith(mode.split(":")[1])):
    child = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(3600)"])
    with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
        f.write(f"child {{child.pid}}\n")
    time.sleep(3600)
time.sleep(float(os.environ.get("FAKE_NVCC_SLEEP", "0")))
print("ptxas info    : Used 32 registers")
with open(os.environ["FAKE_NVCC_STUB"], "rb") as f, open(out, "wb") as g:
    g.write(f.read())
'''


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (the suite runs on several xdist
    workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stub_so(tmp_path_factory):
    """A shared library exporting every symbol `_build.library` binds."""
    d = tmp_path_factory.mktemp("stub")
    syms = sorted({f for fns in _build.SIGNATURES.values() for f in fns})
    (d / "stub.c").write_text("".join(f"int {s}(void) {{ return 0; }}\n"
                                      for s in syms))
    cc = shutil.which("cc") or shutil.which("gcc")
    subprocess.run([cc, "-shared", "-fPIC", "-o", str(d / "stub.so"),
                    str(d / "stub.c")], check=True)
    return str(d / "stub.so")


@pytest.fixture
def fake(tmp_path, monkeypatch, stub_so):
    """A fake nvcc first on PATH and a build directory of this test's own;
    `fake.mode(...)` sets its behaviour, `fake.builds()` lists the
    sources it was asked to build."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    log = tmp_path / "nvcc.log"
    log.write_text("")
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setenv("FAKE_NVCC_STUB", stub_so)
    monkeypatch.setenv("FAKE_NVCC_MODE", "ok")
    monkeypatch.setenv(_build.BUILD_DIR_VAR, str(tmp_path / "kernels"))
    monkeypatch.delenv(export_bank.ENV_VAR, raising=False)
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    obs.reset()
    faults.reset()
    bank.reset()
    export_bank._HOST.clear()

    class Fake:
        dir = tmp_path / "kernels"

        @staticmethod
        def mode(m):
            monkeypatch.setenv("FAKE_NVCC_MODE", m)

        @staticmethod
        def lines():
            return log.read_text().split("\n")[:-1]

        @classmethod
        def builds(cls):
            return [x.split()[1] for x in cls.lines()
                    if not x.startswith("child")]

        @classmethod
        def pids(cls):
            return [int(x.split()[x.startswith("child")])
                    for x in cls.lines()]

    yield Fake
    _build._LIBS.clear()
    export_bank._HOST.clear()
    obs.reset()
    faults.reset()
    bank.reset()


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # A zombie of an exited child still answers signal 0.
    with open(f"/proc/{pid}/stat") as f:
        return f.read().split(")")[-1].split()[0] != "Z"


def _args(**kw):
    base = dict(mode="d", model="GAMMA", save_memory=False, newview=None,
                compile_timeout=180.0)
    base.update(kw)
    return argparse.Namespace(**base)


# -- families ---------------------------------------------------------------


@pytest.mark.parametrize("cfg,want,jax_env", [
    (dict(), ["newview_chunk"], {}),
    (dict(newview="chunk", mode="e"), ["newview_chunk"], {}),
    (dict(newview="whole"), ["newview_chunk", "newview_whole"],
     {"EXAML_PALLAS": "whole"}),
    (dict(newview="scan"), [], {"EXAML_FAST_TRAVERSAL": "0"}),
    (dict(psr=True), [], {}),
    (dict(save_memory=True, mode="q"), [], {}),
])
def test_families_for_each_config(cfg, want, jax_env):
    """The port banks a library where the JAX package banks the program
    family that route runs: its chunk tier ("fast"), its whole-tree
    kernel ("whole")."""
    from examl_tpu.ops import bank as jbank
    assert bank.enumerate_families(**cfg) == want
    jfams = jbank.enumerate_families(
        cfg.get("mode", "d"), psr=cfg.get("psr", False),
        save_memory=cfg.get("save_memory", False), env=jax_env)
    assert ("fast" in jfams) == ("newview_chunk" in want)
    assert ("whole" in jfams) == ("newview_whole" in want)
    assert set(bank.FALLBACK_FLAG) == {"newview_chunk", "newview_whole"}
    assert bank.CORE_FAMILIES == ()


# -- builds without the bank --------------------------------------------------


def test_failed_build_raises_kernel_error_without_bank(fake):
    fake.mode("fail")
    with pytest.raises(_build.KernelError, match="a fake compile error"):
        _build.library("newview_chunk")
    assert fake.builds() == ["newview_chunk.cu"]
    assert not _build._lib_path("newview_chunk").exists()
    fake.mode("ok")
    lib = _build.library("newview_chunk")
    assert _build.library("newview_chunk") is lib
    assert fake.builds() == ["newview_chunk.cu"] * 2
    assert obs.snapshot_counters()["engine.compile_count"] == 1


def test_build_deadline_kills_nvcc_and_its_group(fake):
    fake.mode("hang")
    t0 = time.monotonic()
    with pytest.raises(_build.KernelError,
                       match=r"nvcc for \['newview_chunk'\] outlived the "
                             r"1.5 s build deadline"):
        _build.build_all(["newview_chunk"], timeout=1.5)
    assert time.monotonic() - t0 < 10
    time.sleep(0.2)
    pids = fake.pids()
    assert len(pids) == 2 and not any(_alive(p) for p in pids)
    assert not list(fake.dir.glob("*.tmp"))


def test_in_process_build_past_the_timeout_barks(fake, monkeypatch):
    """Without --bank a slow first load is only warned about."""
    fake.mode("ok")
    monkeypatch.setenv("FAKE_NVCC_SLEEP", "1.5")
    monkeypatch.setenv(_build.TIMEOUT_VAR, "0.5")
    _build.library("newview_chunk")
    assert obs.snapshot_counters()["engine.watchdog_barks"] == 1


# -- the bank -----------------------------------------------------------------


def test_bank_builds_records_and_warms(fake):
    logs = []
    args = _args(newview="whole")
    report = bank.run_bank(args, log=logs.append)
    assert {f: r["status"] for f, r in report.items()} == {
        "newview_chunk": "banked", "newview_whole": "banked"}
    assert all(r["built"] for r in report.values())
    assert sorted(fake.builds()) == ["newview_chunk.cu", "newview_whole.cu"]
    assert args.newview == "whole" and bank.degraded() == {}
    man = bank.load_manifest()
    assert man == bank.load_manifest(fake.dir)
    for fam in ("newview_chunk", "newview_whole"):
        rec = man["families"][fam]
        assert rec["status"] == "banked"
        assert rec["nvcc"] == "Cuda compilation tools, release 12.4, " \
                              "V12.4.131"
        assert rec["source"] == _build.source_hash(fam)
        entry = man["exports"][_build._lib_path(fam).name]
        assert entry["digest"] == export_bank.digest(_build._lib_path(fam))
        assert entry["abi"] == export_bank.EXPORT_ABI
    c = obs.snapshot_counters()
    assert c["bank.families"] == 2 and c["bank.banked"] == 2
    assert c["bank.engine.compile_count"] == 2
    assert c["bank.export.writes"] == 2
    bank.warm_instance(report, logs.append)
    assert obs.snapshot_counters().get("engine.compile_count", 0) == 0
    assert _build.library("newview_chunk") is \
        _build._LIBS[_build._lib_path("newview_chunk")]
    assert len(fake.builds()) == 2
    # A second bank finds both built.
    report = bank.run_bank(_args(newview="whole"), log=logs.append)
    assert not any(r["built"] for r in report.values())
    assert len(fake.builds()) == 2


@pytest.mark.parametrize("hang,newview,want", [
    ("hang", None, "scan"),
    ("hang:newview_whole", "whole", "chunk"),
    ("hang", "whole", "scan"),
])
def test_hanging_build_is_killed_and_degraded(fake, hang, newview, want):
    fake.mode(hang)
    logs = []
    args = _args(newview=newview)
    t0 = time.monotonic()
    report = bank.run_bank(args, log=logs.append, timeout=2.0)
    wall = time.monotonic() - t0
    assert 2.0 < wall < 12.0
    assert args.newview == want
    hung = [f for f, r in report.items() if r["status"] == "timeout"]
    assert hung == (["newview_whole"] if hang.endswith("whole")
                    else list(report))
    assert set(bank.degraded()) == set(hung)
    assert bank.manifest_degraded_families(bank.load_manifest()) == \
        set(hung)
    c = obs.snapshot_counters()
    assert c["bank.timeouts"] == len(hung) == c["bank.fallbacks"]
    errors = [m for m in logs if m.startswith("ERROR: bank:")]
    assert len(errors) == len(hung)
    assert f"pinned to --newview {want}" in errors[-1]
    time.sleep(0.2)
    assert not any(_alive(p) for p in fake.pids())    # nvcc and its child


@pytest.mark.parametrize("spec,status", [
    ("bank.worker", "error"), ("compile.hang", "timeout"),
    ("compile.hang:signal=SEGV", "error")])
def test_worker_faults_degrade(fake, monkeypatch, spec, status):
    monkeypatch.setenv(faults.ENV_VAR, spec)
    args = _args()
    report = bank.run_bank(args, timeout=3.0)
    r = report["newview_chunk"]
    assert r["status"] == status and args.newview == "scan"
    if status == "error":
        assert "(signal SIG" in r["error"]
    assert fake.builds() == []          # the seams fire before nvcc


def test_failed_build_under_bank_is_not_degraded(fake):
    """An nvcc error is not a wedge: the family is recorded, the run
    keeps its route, and the main process's load raises."""
    fake.mode("fail")
    args = _args()
    report = bank.run_bank(args)
    assert report["newview_chunk"]["status"] == "error"
    assert "a fake compile error" in report["newview_chunk"]["error"]
    assert args.newview is None and bank.degraded() == {}
    bank.warm_instance(report, lambda m: None)       # nothing banked
    with pytest.raises(_build.KernelError):
        _build.library("newview_chunk")


def test_manifest_round_trip_and_merge(fake):
    bank._save_manifest({"newview_chunk": {"status": "timeout",
                                           "seconds": 5.0}}, print)
    bank._save_manifest({"newview_whole": {"status": "banked",
                                           "seconds": 1.0}}, print)
    man = bank.load_manifest()
    assert set(man["families"]) == {"newview_chunk", "newview_whole"}
    assert bank.manifest_degraded_families(man) == {"newview_chunk"}
    assert bank.manifest_degraded_families(None) == set()
    from examl_tpu.ops import bank as jbank
    # The JAX reader gives the same verdicts on the port's manifest.
    assert jbank.manifest_degraded_families(man) == {"newview_chunk"}
    bank._save_manifest({"newview_chunk": {"status": "banked"}}, print)
    assert bank.manifest_degraded_families(bank.load_manifest()) == set()
    assert bank.load_manifest(fake.dir / "absent") is None


# -- the export bank ----------------------------------------------------------


def _replace(path, data):
    """Put `data` at `path` as a new file: the library this process
    mapped keeps its pages (a write in place would fault them)."""
    tmp = path.with_suffix(".new")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def _reload(name="newview_chunk"):
    _build._LIBS.clear()
    return _build.library(name)


def test_export_on_quarantines_a_truncated_library(fake, monkeypatch):
    _build.library("newview_chunk")
    path = _build._lib_path("newview_chunk")
    monkeypatch.setenv(export_bank.ENV_VAR, "on")
    obs.reset()
    _reload()
    assert obs.snapshot_counters()["bank.export.hits"] == 1
    data = path.read_bytes()
    _replace(path, data[:len(data) // 2])
    obs.reset()
    _reload()
    c = obs.snapshot_counters()
    assert c["bank.export.rejected.digest"] == 1
    assert c["bank.export.quarantined"] == 1
    assert c["engine.compile_count"] == 1
    assert (path.parent / (path.name + ".quarantined")).exists()
    assert path.read_bytes() == data and len(fake.builds()) == 2


@pytest.mark.parametrize("field,reason", [("nvcc", "nvcc"), ("abi", "abi"),
                                          ("card", "host"),
                                          ("source", "source")])
def test_export_on_rejects_a_mismatched_entry(fake, monkeypatch, field,
                                              reason):
    _build.library("newview_chunk")
    name = _build._lib_path("newview_chunk").name
    with export_bank.updating_manifest(fake.dir) as doc:
        doc["exports"][name][field] = "another"
    monkeypatch.setenv(export_bank.ENV_VAR, "on")
    obs.reset()
    _reload()
    c = obs.snapshot_counters()
    assert c[f"bank.export.rejected.{reason}"] == 1
    assert c["bank.export.quarantined"] == 1 and len(fake.builds()) == 2
    assert export_bank.read_manifest(fake.dir)["exports"][name][field] != \
        "another"


def test_export_on_quarantines_a_library_the_loader_refuses(fake,
                                                             monkeypatch):
    """Bytes that match their entry but do not load: corrupt."""
    path = _build._lib_path("newview_chunk")
    path.parent.mkdir(parents=True)
    staged = path.with_suffix(".staged")
    staged.write_bytes(b"not an ELF file")
    export_bank.publish("newview_chunk", staged, path,
                        _build.source_hash("newview_chunk"))
    monkeypatch.setenv(export_bank.ENV_VAR, "on")
    _reload()
    c = obs.snapshot_counters()
    assert c["bank.export.hits"] == 1 and c["bank.export.corrupt"] == 1
    assert c["bank.export.quarantined"] == 1 and fake.builds() == \
        ["newview_chunk.cu"]
    # Without the bank's checks the loader's refusal is a KernelError.
    monkeypatch.setenv(export_bank.ENV_VAR, "off")
    monkeypatch.setenv(_build.BUILD_DIR_VAR, str(fake.dir / "other"))
    other = _build._lib_path("newview_chunk")
    other.parent.mkdir()
    other.write_bytes(b"not an ELF file")
    with pytest.raises(_build.KernelError, match="does not load"):
        _build.library("newview_chunk")


def test_export_require_raises_where_a_build_is_needed(fake, monkeypatch):
    monkeypatch.setenv(export_bank.ENV_VAR, "require")
    with pytest.raises(export_bank.ExportBankRequired, match="none is built"):
        _build.library("newview_chunk")
    assert fake.builds() == []
    monkeypatch.setenv(export_bank.ENV_VAR, "off")
    _build.library("newview_chunk")
    monkeypatch.setenv(export_bank.ENV_VAR, "require")
    _reload()                                     # verified: no build
    path = _build._lib_path("newview_chunk")
    _replace(path, path.read_bytes()[:100])
    with pytest.raises(export_bank.ExportBankRequired,
                       match="entry was rejected"):
        _reload()
    assert len(fake.builds()) == 1


def test_export_faults_are_survivable(fake, monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "bank.export.write")
    _build.library("newview_chunk")
    path = _build._lib_path("newview_chunk")
    assert path.exists()
    assert "exports" not in export_bank.read_manifest(fake.dir)
    assert obs.snapshot_counters()["bank.export.write_errors"] == 1
    monkeypatch.setenv(export_bank.ENV_VAR, "on")
    monkeypatch.setenv(faults.ENV_VAR, "bank.export.load")
    faults.reset()
    obs.reset()
    _reload()                                # the fault: a rebuild
    c = obs.snapshot_counters()
    assert c["bank.export.rejected.error"] == 1
    assert c["engine.compile_count"] == 1 and len(fake.builds()) == 2
    monkeypatch.delenv(faults.ENV_VAR)
    obs.reset()
    _reload()
    assert obs.snapshot_counters()["bank.export.hits"] == 1


def test_export_bank_typo_is_a_usage_error(monkeypatch, capsys, tmp_path):
    monkeypatch.setenv(export_bank.ENV_VAR, "requrie")
    with pytest.raises(SystemExit) as ei:
        main(["-s", "a", "-n", "T", "-w", str(tmp_path)], device="cpu")
    assert ei.value.code == 2
    assert "EXAML_EXPORT_BANK='requrie'" in capsys.readouterr().err
    monkeypatch.delenv(export_bank.ENV_VAR)
    with pytest.raises(SystemExit):
        main(["-s", "a", "-n", "T", "--compile-timeout", "0"], device="cpu")


# -- the barrier --------------------------------------------------------------

RANK = r"""
import argparse, datetime, json, sys
import torch.distributed as dist
from examl_tpu_torch.ops import bank
from examl_tpu_torch.parallel import launch
from examl_tpu_torch.parallel.sharding import SiteGroup
rank, port = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
args = argparse.Namespace(mode="d", model="GAMMA", save_memory=False,
                          newview=None, compile_timeout=60.0)
report = bank.run_bank(args)
group = SiteGroup(rank, 2, dist.group.WORLD)
launch.bank_barrier(args, group, report, log=print)
bank.warm_instance(report, print)
dist.destroy_process_group()
print(json.dumps({f: r["status"] for f, r in report.items()}))
"""


def test_bank_barrier_two_ranks_build_once(fake, monkeypatch):
    import socket
    monkeypatch.setenv("FAKE_NVCC_SLEEP", "1.0")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r),
                               str(port)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert json.loads(out.strip().splitlines()[-1]) == {
            "newview_chunk": "banked"}
        assert "2 ranks banked (barrier passed)" in out
    assert fake.builds() == ["newview_chunk.cu"]


# -- the CLI ------------------------------------------------------------------


def _cli_inputs(tmp_path):
    from tests.test_torch_cli import _inputs
    return _inputs(tmp_path)


def test_cli_hung_build_finishes_on_the_scan_route(fake, tmp_path):
    fake.mode("hang")
    aln, trees = _cli_inputs(tmp_path)
    out = tmp_path / "bank"
    t0 = time.monotonic()
    rc = main(["-s", aln, "-t", trees, "-n", "T", "-w", str(out), "-f", "e",
               "--bank", "--compile-timeout", "2", "--metrics",
               str(out / "m.json")], device="cpu")
    assert rc == 0 and time.monotonic() - t0 < 120
    info = (out / "ExaML_info.T").read_text()
    assert "ERROR: bank: CUDA library 'newview_chunk' timeout" in info
    assert "pinned to --newview scan" in info and "newview: scan" in info
    snap = json.loads((out / "m.json").read_text())
    c = snap["counters"]
    assert c["bank.timeouts"] == 1 and c["bank.fallbacks"] == 1
    assert c.get("kernel.newview_chunk.launches", 0) == 0
    assert bank.manifest_degraded_families(bank.load_manifest()) == \
        {"newview_chunk"}
    plain = tmp_path / "plain"
    assert main(["-s", aln, "-t", trees, "-n", "T", "-w", str(plain),
                 "-f", "e", "--newview", "scan"], device="cpu") == 0
    assert (out / "ExaML_log.T").read_text().split()[1::2] == \
        (plain / "ExaML_log.T").read_text().split()[1::2]
    time.sleep(0.2)
    assert not any(_alive(p) for p in fake.pids())


# -- the scan route -----------------------------------------------------------


def test_scan_route_enters_no_kernel(monkeypatch):
    """Full traversals, makenewz, gradient smoothing and the batched scan
    on newview="scan": no kernel wrapper and no library is reached."""
    from examl_tpu_torch.instance import PhyloInstance
    from examl_tpu_torch.io.alignment import build_alignment_data
    from examl_tpu_torch.ops import newview_chunk, newview_whole
    from examl_tpu_torch.optimize.branch import smooth_tree
    from tests.test_torch_cli import _sequences

    def refuse(*a, **k):
        raise AssertionError("a kernel path was entered")

    for mod, name in ((_build, "library"), (_build, "build_all"),
                      (newview_chunk, "chunk_apply"),
                      (newview_chunk, "chunk_operands"),
                      (newview_whole, "whole_apply")):
        monkeypatch.setattr(mod, name, refuse)
    names, seqs = _sequences(8, 240)
    inst = PhyloInstance(build_alignment_data(names, seqs),
                         dtype=torch.float64, device="cpu", newview="scan")
    tree = inst.random_tree(1)
    full0 = engine.FULL_TRAVERSALS
    l0 = inst.evaluate(tree, full=True)
    smooth_tree(inst, tree, 2)
    assert inst.evaluate(tree, full=True) > l0
    assert engine.FULL_TRAVERSALS == full0
    eng = next(iter(inst.engines.values()))
    assert eng.fast_slack == 0 and eng.newview == "scan"
    monkeypatch.undo()
    ref = PhyloInstance(build_alignment_data(names, seqs),
                        dtype=torch.float64, device="cpu")
    assert ref.evaluate(ref.random_tree(1), full=True) == pytest.approx(
        l0, rel=1e-12)


def test_fleet_on_the_scan_route(tmp_path):
    """`-N` with smoothing cycles on `--newview scan`: every job on the
    wave-scan tier (no stacked launch table), each job's lnL that of the
    chunk tier's batch."""
    from examl_tpu_torch.fleet import batch
    aln, _ = _cli_inputs(tmp_path)
    lnls = {}
    for tier in ("chunk", "scan"):
        out = tmp_path / tier
        tables0 = batch.TABLES
        assert main(["-s", aln, "-n", "F", "-w", str(out), "-N", "4",
                     "--fleet-cycles", "2", "--newview", tier],
                    device="cpu") == 0
        assert (batch.TABLES == tables0) == (tier == "scan")
        rows = [x.split() for x in (out / "ExaML_fleet.F").read_text()
                .splitlines() if x and not x.startswith("#")]
        lnls[tier] = {r[0]: float(r[5]) for r in rows}
    assert lnls["scan"].keys() == lnls["chunk"].keys()
    for job, lnl in lnls["chunk"].items():
        assert lnls["scan"][job] == pytest.approx(lnl, rel=1e-9)


def test_scan_route_combinations():
    from examl_tpu_torch.instance import PhyloInstance
    from examl_tpu_torch.io.alignment import build_alignment_data
    from tests.test_torch_cli import _sequences
    names, seqs = _sequences(8, 240)
    ad = build_alignment_data(names, seqs)
    with pytest.raises(ValueError, match="save_memory"):
        PhyloInstance(ad, dtype=torch.float64, device="cpu",
                      newview="scan", save_memory=True)
    lnl = {}
    for key, kw in (("f32", {}), ("bf16", {"clv_dtype": "bf16"}),
                    ("psr", {"rate_model": "PSR"})):
        inst = PhyloInstance(ad, dtype=torch.float32, device="cpu",
                             newview="scan", **kw)
        lnl[key] = inst.evaluate(inst.random_tree(3), full=True)
        assert np.isfinite(lnl[key])
    assert lnl["bf16"] == pytest.approx(lnl["f32"], rel=1e-3)


JAX_SCAN_ENV = {"EXAML_FAST_TRAVERSAL": "0", "EXAML_GRAD_SMOOTH": "0",
                "EXAML_BATCH_SCAN": "0"}


def test_scan_search_matches_jax(monkeypatch):
    """The pinned 8-taxon `-f d` (tests/test_torch_search.py) on the scan
    route with per-branch smoothing, against the JAX package with its
    full traversals on the scan tier."""
    import jax.numpy as jnp
    from examl_tpu.instance import PhyloInstance as JaxInstance
    from examl_tpu.io.alignment import build_alignment_data as jbuild
    from examl_tpu.search import raxml_search as jsearch
    from examl_tpu.search import snapshots as jsnap
    from examl_tpu_torch.instance import PhyloInstance
    from examl_tpu_torch.io.alignment import build_alignment_data
    from examl_tpu_torch.search import raxml_search, snapshots
    from tests.test_torch_search import _correlated_dna
    for k, v in JAX_SCAN_ENV.items():
        monkeypatch.setenv(k, v)
    names, seqs = _correlated_dna(8, 150)
    jinst = JaxInstance(jbuild(names, seqs), dtype=jnp.float64)
    assert next(iter(jinst.engines.values())).force_scan
    newick = jinst.random_tree(seed=7).to_newick(names)
    jtree = jinst.tree_from_newick(newick)
    tinst = PhyloInstance(build_alignment_data(names, seqs),
                          dtype=torch.float64, device="cpu", newview="scan",
                          grad_smooth=False)
    ttree = tinst.tree_from_newick(newick)
    opts = dict(initial_set=True, initial=5)
    jres = jsearch.compute_big_rapid(jinst, jtree,
                                     jsearch.SearchOptions(**opts))
    full0 = engine.FULL_TRAVERSALS
    tres = raxml_search.compute_big_rapid(tinst, ttree,
                                          raxml_search.SearchOptions(**opts))
    assert engine.FULL_TRAVERSALS == full0
    assert (tres.fast_iterations, tres.thorough_iterations) == \
        (jres.fast_iterations, jres.thorough_iterations)
    assert snapshots.topology_key(ttree) == jsnap.topology_key(jtree)
    assert tres.likelihood == pytest.approx(jres.likelihood, rel=1e-10)


def test_scan_ref49_smoothing_and_modopt_match_jax(monkeypatch):
    """ref49 from the initial model on the scan route in both packages
    (f64, full traversals on the scan tier, the gradient route): the
    first `-f e` steps, `tree_evaluate` and one `mod_opt` round, rtol
    1e-10 (the whole `-f e` is the slow test below)."""
    import jax.numpy as jnp
    from examl_tpu.instance import PhyloInstance as JaxInstance
    from examl_tpu.io.bytefile import read_bytefile as jread
    from examl_tpu.optimize import branch as jbranch
    from examl_tpu.optimize import model_opt as jmodel_opt
    from examl_tpu_torch.instance import PhyloInstance
    from examl_tpu_torch.io.bytefile import read_bytefile
    from examl_tpu_torch.optimize import branch, model_opt
    monkeypatch.setenv("EXAML_FAST_TRAVERSAL", "0")
    aln = os.path.join(REF49, "aln49.binary")
    newick = open(os.path.join(REF49, "TreeFile")).read()
    jinst = JaxInstance(jread(aln), dtype=jnp.float64)
    assert next(iter(jinst.engines.values())).force_scan
    tinst = PhyloInstance(read_bytefile(aln), dtype=torch.float64,
                          device="cpu", newview="scan")
    jtree, ttree = jinst.tree_from_newick(newick), \
        tinst.tree_from_newick(newick)
    full0 = engine.FULL_TRAVERSALS
    for step in (lambda i, t, m, b: i.evaluate(t, full=True),
                 lambda i, t, m, b: b.tree_evaluate(i, t, 1.0),
                 lambda i, t, m, b: m.mod_opt(i, t, 0.1, max_rounds=1)):
        jl = step(jinst, jtree, jmodel_opt, jbranch)
        tl = step(tinst, ttree, model_opt, branch)
        assert tl == pytest.approx(jl, rel=1e-10)
    assert engine.FULL_TRAVERSALS == full0


@pytest.mark.slow
def test_scan_fe_ref49_matches_jax(monkeypatch, tmp_path):
    """ref49 `-f e` through both CLIs on the gradient route, full
    traversals on the scan tier in both (f64): -16205.711310.  About 10
    minutes of the port's CLI on one CPU thread, 3 of the JAX one's."""
    import jax
    from examl_tpu.cli import main as jmain
    monkeypatch.setenv("EXAML_FAST_TRAVERSAL", "0")
    monkeypatch.setenv("EXAML_COMPILE_CACHE", str(tmp_path / "xla"))
    argv = ["-s", os.path.join(REF49, "aln49.binary"), "-t",
            os.path.join(REF49, "TreeFile"), "-n", "S", "-f", "e"]
    assert main(argv + ["-w", str(tmp_path / "port"), "--newview", "scan"],
                device="cpu") == 0
    assert jax.config.jax_enable_x64
    assert jmain.main(argv + ["-w", str(tmp_path / "jax"),
                              "--single-device"]) == 0
    lnls = [float((tmp_path / w / "ExaML_log.S").read_text().split()[-1])
            for w in ("port", "jax")]
    assert lnls[0] == pytest.approx(lnls[1], rel=1e-10)
    assert lnls[0] == pytest.approx(-16205.711310, abs=1e-6)
