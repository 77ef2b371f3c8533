"""Inference entry point, the counterpart of the reference `examl`
binary (`axml.c`: `get_args` :935-1302, `makeFileNames` :1316-1357, modes
dispatched at `main` :2719-2781).

    python -m examl_tpu_torch.cli.main -s aln.binary -n RUN \\
        [-t tree | -g constraint | -R] [-w DIR] [-f d|o|e|E|q] \\
        [-m GAMMA|PSR] [-c categories] [-a] [-i radius] [-D] [-B N] [-M] \\
        [-S] [-p seed] [-Y groups | -r N] [-I N] [-e epsilon] \\
        [--newview chunk|whole|scan] [--grad-smooth on|off] \\
        [--batch-scan auto|on|off] [--clv-dtype same|bf16] \\
        [--auto-prot ml|bic|aic|aicc] [--bank] [--compile-timeout S] \\
        [--metrics FILE] [--ledger DIR] [--trace-events DIR] \\
        [--profile DIR] [--inject-fault SPEC ...] \\
        [--coordinator HOST:PORT --nprocs N --procid K] \\
        [--supervise [--supervise-retries R] [--supervise-stall S] \\
         [--supervise-backoff B]] [--launch N [--launch-emulate] \\
         [--launch-min-ranks M]]
    python -m examl_tpu_torch.cli.main -s aln.binary -n RUN \\
        (-b K -t tree | -N K | --serve jobs.jsonl) [--fleet-batch J] \\
        [--fleet-cycles C] [--fleet-job-attempts A] [--serve-poll S] \\
        [--serve-max-pending P] [--fleet-job-deadline S] \\
        [--fleet-lease-ttl T] [--fleet-devices D | --mesh SxT] \\
        [--single-device] [--nprocs N --procid K] [-R] [-p seed]

Modes: `-f d` (the default) runs the RAxML SPR hill climb
(`search/raxml_search.py`) from the `-t` tree or from the random
resolution of the `-g` constraint tree; `-f o` is the same search without
the lnL-cutoff heuristic.  `-f e` / `-f E` evaluate each tree of the `-t`
file: smooth its branch lengths and optimize the model (`mod_opt`); with
`-f e` the trees after the first only re-smooth.  `-f q` optimizes the
model on the `-t` tree (to `-e`'s lnL epsilon), then scores every
4-taxon set under its three topologies (`search/quartets.py`): all sets,
`-r N` random ones, or those the `-Y` grouping file's four groups give.
Every mode writes numbered checkpoints (`search/checkpoint.py`, the JAX
package's format; `-f q` every `-I` sets) and resumes from the newest one
with `-R`.

`-m PSR` replaces the discrete gamma model by per-site rates grouped
into at most `-c` categories (25 by default) per partition.  Partitions
are DNA, binary or amino-acid (GTR, an empirical matrix, LG4M/LG4X, or
AUTO, which `mod_opt` resolves to the best matrix by `--auto-prot`'s
criterion, ML by default), as the byteFile names them.

The fleet modes replace `-f` (cli/fleet.py, fleet/): `-b K` scores K
bootstrap weight replicates of the `-t` topology, `-N K` K random
starting trees, and `--serve` the jobs of a JSONL file as they are
appended; tree jobs batch through one launch of kernel B1 whatever their
topologies, and every job lands in ExaML_fleet.RUN.  `--fleet-devices D`
cuts up to one batch a round per lane on D cards (0 = every visible
card; fleet/shard.py), `--mesh SxT` (or EXAML_MESH) cuts each batch over
the T tree slices of a likelihood fabric, each slice's jobs with their
sites over its S cards, and `--single-device` keeps the run on one
card.

Without `--single-device` a run of the other modes splits its packed
site blocks over every visible card when there are two or more (one
process, a site shard per card: parallel/shards.py), as the JAX
package's does; `--mesh Sx1` takes the first S cards.  With one card
the run is the single-card run.

Outputs in DIR: ExaML_info.RUN (progress), ExaML_log.RUN ("seconds lnL"
rows), ExaML_modelFile.RUN (the final model, in the reference's
`printModelParams` layout; under PSR the category count and rates take
the alpha line's place); the search writes ExaML_result.RUN (the best
tree), ExaML_goodTrees.RUN (`-B`) and ExaML_perGeneBranchLengths.RUN
(`-M`); tree evaluation writes ExaML_TreeFile.RUN (one newick per tree);
quartet evaluation ExaML_quartets.RUN ("a b | c d: lnL" rows).

`-S` is ExaML's memory saving for gappy alignments: CLVs live in a
block-cell pool that stores no (node, block) cell whose subtree is all
gap there (ops/sev.py), and every traversal runs on the pooled wave-scan
tier, with no newview kernel, as the JAX package runs it; the info file
reports each bucket's pool and, at the end, the cells it allocated.

`--newview` selects the full-traversal tier: `chunk` (kernel B1, the
default), `whole` (kernel B2, one launch per traversal) or `scan` (the
wave-scan tier of torch ops, no kernel: the JAX package's
EXAML_FAST_TRAVERSAL=0); `-S` takes none of them.  `--grad-smooth off`
smooths full trees branch by branch instead of by whole-tree gradients
(the JAX package's EXAML_GRAD_SMOOTH=0).  `--batch-scan` selects the
SPR search's scan: `auto` (the default) batches it where the arenas live
on the card and keeps it sequential on the CPU, `on` / `off` force it
(`PhyloInstance(batch_scan=...)`).  `--clv-dtype bf16` stores the CLV
arenas, their scan regions and `-S`'s pools in bfloat16 while computing
in float32 (the JAX package's EXAML_CLV_DTYPE=bf16): full traversals run
kernel B1's bfloat16-storage instances; it is refused with `--newview
whole` and on a float64 run.  `main` runs on the card in float32 unless
the caller passes `device="cpu"` (float64 there) or a `dtype`.

`--bank` builds the run's CUDA libraries before start-up in killable
worker processes (ops/bank.py), each with a deadline of
`--compile-timeout` seconds (180 by default): a build that outlives it
is killed, recorded as degraded in the build directory's
`bank_manifest.json`, logged as an ERROR, and the run continues on the
next route down (`--newview whole` -> `chunk` -> `scan`).  Without
`--bank` a build is in-process and only warned about past the deadline,
and a failed build raises.  `EXAML_EXPORT_BANK=off|on|require` sets how
a built library is trusted: by its hashed name (off, the default),
verified against its manifest entry and quarantined and rebuilt when it
does not match (on), or never built at all (require: a run that would
need a build fails).  `EXAML_BUILD_DIR` moves the build directory
(default `build/torch_kernels/` beside the package).

The run's instruments (obs/) and in-process resilience (resilience/), as
in the JAX package: `--metrics FILE` writes the metrics snapshot
(counters, gauges, timers with latency histograms, the program table) at
exit and autoflushes it on the heartbeat's clock while the run lasts;
`--ledger DIR` the per-rank run ledger (`ledger.p<rank>.jsonl`, merged
into `ledger.merged.jsonl`; next to the metrics file by default);
`--trace-events DIR` Chrome-trace span files (`trace.p<rank>.jsonl`,
rank 0 merges `summary.json`); `--profile DIR` a torch.profiler trace of
the inference phase (CPU, plus CUDA on the card); `--inject-fault SPEC`
arms a fault point (resilience/faults.py).  SIGTERM/SIGINT write an
emergency checkpoint at the next checkpoint site and exit with
EXIT_PREEMPTED (75), resumable with `-R`; a memory budget the fleet
cannot get under exits with EXIT_ALLOC_OOM (76).  The metrics snapshot,
the trace and the ledger are finalized even for a failed run.

`--coordinator HOST:PORT --nprocs N --procid K` runs this process as rank
K of a site-parallel run of N ranks, one process per GPU
(parallel/launch.py): rank K runs on `cuda:(K mod device_count)`, reads
only its own byteFile columns (`selective_read_decision`), packs them
into its block window of the global packing and reduces every site sum
over a gloo group.  Every rank takes the same decisions from the same
reduced values; only rank 0 writes run files and checkpoints (the other
ranks' workdir is DIR/.proc<K>, and they restore from DIR).  With a fleet
mode, `--nprocs N --procid K` makes this process a LEASED rank instead
(fleet/lease.py): it joins no process group, and the ranks share the
queue through per-job leases in DIR.

Supervision (resilience/supervisor.py): `--supervise` makes this process
a thin watcher that never imports torch and runs the whole run as a
killable child (`python -m examl_tpu_torch.cli.main`, on the card): a
crash, or a heartbeat stall longer than `--supervise-stall` seconds,
restarts it from the newest checkpoint with `-R`, at most
`--supervise-retries` times, with jittered backoff from
`--supervise-backoff` seconds and a degradation ladder of flags
(`--newview chunk`, then also `--batch-scan off`, then the kernel-free
`--newview scan --batch-scan off --grad-smooth off`); a preemption (exit 75)
resumes without using a retry, and a SIGTERM to the watcher preempts the
child.  `--launch N` spawns and watches N ranks (a gloo group on
127.0.0.1, or with `--launch-emulate` N independent ranks): any rank's
death restarts the gang from the newest coordinated (two-phase)
checkpoint, and a rank that keeps dying shrinks it, down to
`--launch-min-ranks`.  With a fleet mode the ranks are leased and
restart alone.  `--fleet-job-deadline S` declares each fleet batch's
deadline to the supervisor, which kills a batch that overruns it as
`fleet-job-stuck` without using a retry (its jobs pay attempts);
`--fleet-lease-ttl` is how long a leased rank's lease lives unrenewed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import struct
from typing import List

import numpy as np

# This module imports no torch at its top: the supervisor's parent parses
# the command line here and must never load torch (the CUDA context is the
# child's).  Everything that needs torch imports it inside `main`, after
# the routing to the supervisor.
from examl_tpu_torch import obs
from examl_tpu_torch.constants import (CLV_STORAGE_NAMES, NEWVIEW_TIERS,
                                       POOLED_TIER, ZMAX, ZMIN)
from examl_tpu_torch.ops import _build, bank, export_bank
from examl_tpu_torch.parallel import launch
from examl_tpu_torch.resilience import faults, heartbeat, memgov, preempt

# State letters of the model file's "rate X <-> Y" and "freq pi(X)" lines.
_STATE_LETTERS = {"DNA": "ACGT", "AA": "ARNDCQEGHILKMFPSTWYV", "BIN": "01"}
# Seconds between two mid-tree MOD_OPT checkpoints of -f e / -f E.
MID_TREE_CHECKPOINT_S = 60.0


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="examl_tpu_torch.cli.main",
        description="maximum-likelihood phylogenetic tree inference on the "
                    "GPU")
    ap.add_argument("-s", dest="bytefile", required=True,
                    help="binary alignment file (byteFile)")
    ap.add_argument("-n", dest="run_id", required=True, help="run name")
    ap.add_argument("-t", dest="tree_file", default=None,
                    help="starting tree (-f d/o) or trees to evaluate "
                         "(-f e/E), newick")
    ap.add_argument("-R", dest="restart", action="store_true",
                    help="restart from the newest checkpoint")
    ap.add_argument("-m", dest="model", default="GAMMA",
                    choices=["GAMMA", "PSR"],
                    help="rate heterogeneity model")
    ap.add_argument("-c", dest="categories", type=int, default=25,
                    help="maximum PSR rate categories")
    ap.add_argument("-a", dest="median", action="store_true",
                    help="median instead of mean discrete gamma rates")
    ap.add_argument("-f", dest="mode", default="d",
                    choices=["d", "o", "e", "E", "q"],
                    help="d: SPR tree search; o: the search without the lnL "
                         "cutoff; e: evaluate trees, optimizing the model "
                         "on the first tree only; E: evaluate trees, "
                         "optimizing the model on every tree; q: quartets")
    ap.add_argument("-e", dest="epsilon", type=float, default=0.1,
                    help="lnL epsilon for quartet-mode model optimization "
                         "(the search and tree-evaluation modes use the "
                         "reference's fixed modOpt schedule)")
    ap.add_argument("-i", dest="initial", type=int, default=None,
                    help="fixed initial rearrangement radius")
    ap.add_argument("-D", dest="rf_convergence", action="store_true",
                    help="stop when consecutive SPR cycles are <=1%% RF "
                         "apart")
    ap.add_argument("-B", dest="save_best", type=int, default=0,
                    help="also report the N best distinct trees found")
    ap.add_argument("-M", dest="per_partition_bl", action="store_true",
                    help="estimate per-partition branch lengths")
    ap.add_argument("-S", dest="save_memory", action="store_true",
                    help="memory saving for gappy alignments")
    ap.add_argument("-g", dest="constraint_file", default=None,
                    help="multifurcating constraint tree")
    ap.add_argument("-p", dest="seed", type=int, default=12345,
                    help="random seed (constraint-tree resolution)")
    ap.add_argument("-Y", "-Q", dest="quartet_file", default=None,
                    help="quartet grouping file (-f q; the reference "
                         "spells this -Y, axml.c:1063)")
    ap.add_argument("-r", dest="quartet_samples", type=int, default=0,
                    help="number of random quartets to evaluate (-f q)")
    ap.add_argument("-I", dest="quartet_ckpt_interval", type=int,
                    default=10000,
                    help="quartet checkpoint interval (-f q)")
    ap.add_argument("-w", dest="workdir", default=".",
                    help="output directory")
    ap.add_argument("--newview", default=None, choices=NEWVIEW_TIERS,
                    help="full-traversal tier: chunk (kernel B1, the "
                         "default), whole (kernel B2) or scan (the "
                         "wave-scan tier, no kernel); not with -S")
    ap.add_argument("--grad-smooth", dest="grad_smooth", default="on",
                    choices=["on", "off"],
                    help="full-tree branch smoothing by whole-tree "
                         "gradients (on, the default) or branch by branch "
                         "(off)")
    ap.add_argument("--batch-scan", dest="batch_scan", default="auto",
                    choices=["auto", "on", "off"],
                    help="SPR scan: batched on the card and sequential on "
                         "the CPU (auto), or forced on / off")
    ap.add_argument("--clv-dtype", dest="clv_dtype", default="same",
                    choices=list(CLV_STORAGE_NAMES),
                    help="CLV storage: the compute dtype (same) or "
                         "bfloat16 with float32 compute (bf16); not with "
                         "--newview whole")
    ap.add_argument("--auto-prot", dest="auto_prot", default="ml",
                    choices=["ml", "bic", "aic", "aicc"],
                    help="criterion for AUTO protein model selection")
    f = ap.add_argument_group("fleet modes (one at a time; they replace -f)")
    f.add_argument("-b", "--bootstrap", dest="bootstrap", type=int,
                   default=0, metavar="K",
                   help="evaluate K bootstrap weight replicates of the -t "
                        "topology (site-multiplicity resampling, seeds "
                        "derived from -p; one CLV pass and one batched "
                        "root reduction a batch)")
    f.add_argument("-N", "--multi-start", dest="multi_start", type=int,
                   default=0, metavar="K",
                   help="evaluate K random starting trees (seeds derived "
                        "from -p), any mix of topologies in one kernel "
                        "launch a batch; --fleet-cycles adds "
                        "branch-length smoothing rounds per tree")
    f.add_argument("--serve", dest="serve", default=None, metavar="JOBS",
                   help="drain a JSONL jobs file (fleet/jobs.py format), "
                        "polling for appended jobs until an {\"op\": "
                        "\"stop\"} line; --serve-poll 0 drains once and "
                        "exits")
    f.add_argument("--serve-poll", dest="serve_poll", type=float,
                   default=1.0,
                   help="seconds between jobs-file polls under --serve (0 "
                        "= drain the current contents and exit; default 1)")
    f.add_argument("--serve-max-pending", dest="serve_max_pending",
                   type=int, default=10000,
                   help="stop taking new jobs-file lines while this many "
                        "jobs are pending (default 10000)")
    f.add_argument("--fleet-job-attempts", dest="fleet_job_attempts",
                   type=int, default=2,
                   help="attempts before a failing job (non-finite lnL, "
                        "dispatch error) is quarantined to "
                        "ExaML_fleetFailed.<run> (default 2)")
    f.add_argument("--fleet-batch", dest="fleet_batch", type=int,
                   default=16,
                   help="most jobs a batch (default 16); a batch whose "
                        "stacked arena does not fit on the card runs in "
                        "parts")
    f.add_argument("--fleet-cycles", dest="fleet_cycles", type=int,
                   default=1,
                   help="evaluation cycles per tree job; cycles after the "
                        "first smooth branch lengths before re-scoring "
                        "(default 1)")
    f.add_argument("--fleet-devices", dest="fleet_devices", type=int,
                   default=1,
                   help="tree-axis lanes: cut up to one batch a round per "
                        "lane and round-robin the groups over them, one "
                        "lane per card (0 = every visible card; default 1 "
                        "= one lane; a card that fails its lane's init "
                        "degrades the set, never aborts)")
    f.add_argument("--fleet-job-deadline", dest="fleet_job_deadline",
                   type=float, default=0.0,
                   help="wall-clock seconds one batched fleet dispatch may "
                        "take before a --supervise parent kills the "
                        "attempt as job-stuck (no run-level retry used; "
                        "repeat offenders are quarantined); 0 disables "
                        "the deadline (default)")
    f.add_argument("--fleet-lease-ttl", dest="fleet_lease_ttl", type=float,
                   default=60.0,
                   help="leased fleet ranks (--launch N or --nprocs N "
                        "--procid K with a fleet mode): seconds a rank's "
                        "job lease lives without renewal; a dead rank's "
                        "leases expire after this and the other ranks "
                        "reap them (default 60)")
    s = ap.add_argument_group("supervision")
    s.add_argument("--supervise", dest="supervise", action="store_true",
                   help="self-healing supervision: run the whole run as a "
                        "killable child, watch its heartbeat, and on a "
                        "crash or stall restart it from the newest "
                        "checkpoint with capped retries, backoff and a "
                        "degradation ladder (--newview chunk, then "
                        "--batch-scan off, then --newview scan "
                        "--grad-smooth off: the last rung runs no "
                        "kernel); "
                        "SIGTERM/SIGINT preemptions resume without using "
                        "a retry")
    s.add_argument("--supervise-retries", dest="supervise_retries",
                   type=int, default=3,
                   help="most failure restarts under --supervise "
                        "(preemption resumes are not counted; default 3)")
    s.add_argument("--supervise-stall", dest="supervise_stall", type=float,
                   default=300.0,
                   help="seconds without a heartbeat before the supervisor "
                        "declares a wedge and kills the child (default "
                        "300; 0 disables stall detection)")
    s.add_argument("--supervise-backoff", dest="supervise_backoff",
                   type=float, default=2.0,
                   help="base seconds of the supervisor's exponential "
                        "restart backoff (default 2)")
    s.add_argument("--launch", dest="launch", type=int, default=None,
                   metavar="N",
                   help="gang mode: the supervisor spawns all N ranks "
                        "itself (a gloo group on 127.0.0.1, every rank on "
                        "the card), watches their heartbeats, and on a "
                        "rank death, a straggler or a collective wedge "
                        "restarts the WHOLE gang from the newest "
                        "coordinated checkpoint (the --supervise-* flags "
                        "apply gang-wide); a rank that keeps dying "
                        "shrinks the gang to N-1 (down to "
                        "--launch-min-ranks).  With a fleet mode the "
                        "ranks are leased and restart alone")
    s.add_argument("--launch-emulate", dest="launch_emulate",
                   action="store_true",
                   help="spawn the --launch gang WITHOUT a process group: "
                        "N independent single-process ranks that follow "
                        "the same rank, heartbeat and checkpoint contract")
    s.add_argument("--launch-min-ranks", dest="launch_min_ranks", type=int,
                   default=1,
                   help="elastic-resume floor: never shrink the gang below "
                        "this many ranks (default 1)")
    b = ap.add_argument_group("kernel builds")
    b.add_argument("--bank", dest="bank", action="store_true",
                   help="build every CUDA library this run will load "
                        "before start-up, one killable worker process "
                        "each; a build past --compile-timeout is killed "
                        "and the run degrades to the next route down "
                        "(--newview whole -> chunk -> scan) instead of "
                        "wedging")
    b.add_argument("--compile-timeout", dest="compile_timeout",
                   type=float, default=180.0,
                   help="per-library build deadline in seconds: hard "
                        "(kill + the next route down) for --bank workers, "
                        "a logged warning for an in-process build "
                        "(default 180)")
    o = ap.add_argument_group("instruments and fault injection")
    o.add_argument("--inject-fault", dest="inject_fault",
                   action="append", metavar="SPEC", default=None,
                   help="arm a named fault-injection point (repeatable; "
                        "resilience/faults.py): "
                        "point[@rank=R][:after=N][:attempt=K]"
                        "[:signal=NAME][:hang[=S]] — e.g. "
                        "search.kill:after=10 or "
                        "search.kill@rank=1:after=10 (rank 1 only); "
                        "equivalent to EXAML_FAULTS entries")
    o.add_argument("--profile", dest="profile_dir", default=None,
                   help="write a torch.profiler trace of the inference "
                        "phase to this directory (Chrome trace; CPU, plus "
                        "CUDA on the card)")
    o.add_argument("--metrics", dest="metrics_file", default=None,
                   help="write the runtime metrics-registry snapshot "
                        "(dispatch/compile/cache counters, phase timers) "
                        "to this JSON file at exit (process 0 only)")
    o.add_argument("--trace-events", dest="trace_events_dir", default=None,
                   help="write Chrome-trace/Perfetto span events to "
                        "per-process JSONL files in this directory "
                        "(trace.p<procid>.jsonl; open in ui.perfetto.dev)")
    o.add_argument("--ledger", dest="ledger_dir", default=None,
                   help="write the append-only run ledger (phases, "
                        "faults, checkpoint cycles, fleet jobs) to "
                        "per-rank JSONL files in this directory "
                        "(ledger.p<procid>.jsonl; merged into "
                        "ledger.merged.jsonl at exit).  Defaults to the "
                        "--metrics file's directory when --metrics is "
                        "given")
    launch.add_launch_args(ap)
    return ap


class RunFiles:
    """Output files (reference `makeFileNames`/`printBothOpen`).  On a -R
    restart the info and log files are appended to, keeping the
    interrupted run's history.  primary=False (a site-parallel rank other
    than 0) writes nothing, the reference's processID == 0 gating; its
    checkpoints live in `shared_dir`, rank 0's workdir."""

    def __init__(self, workdir: str, run_id: str, append: bool = False,
                 primary: bool = True, shared_dir: str | None = None):
        self.primary = primary
        self.shared_dir = shared_dir if shared_dir is not None else workdir
        os.makedirs(workdir, exist_ok=True)
        pre = os.path.join(workdir, "ExaML_")
        self.info_path = f"{pre}info.{run_id}"
        self.log_path = f"{pre}log.{run_id}"
        self.result_path = f"{pre}result.{run_id}"
        self.model_path = f"{pre}modelFile.{run_id}"
        self.treefile_path = f"{pre}TreeFile.{run_id}"
        self.quartets_path = f"{pre}quartets.{run_id}"
        self.start_time = time.time()
        self._phases = {}
        if not append and primary:
            for p in (self.info_path, self.log_path):
                open(p, "w").close()

    def info(self, msg: str) -> None:
        if not self.primary:
            return
        print(msg)
        with open(self.info_path, "a") as f:
            f.write(msg + "\n")

    # -- per-phase wall-time accounting: `phase.<name>` timers, `phase:*`
    # spans and ledger `phase` events, as in the JAX CLI --------------------

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        obs.ledger_event("phase", name=name, status="begin")
        try:
            with obs.span(f"phase:{name}", cat="phase"):
                yield
        finally:
            dt = time.time() - t0
            self._phases[name] = self._phases.get(name, 0.0) + dt
            obs.observe(f"phase.{name}", dt)
            obs.ledger_event("phase", name=name, status="end",
                             seconds=round(dt, 3))

    def report_phases(self) -> None:
        if not self._phases:
            return
        total = time.time() - self.start_time
        self.info("")
        self.info("Wall-clock by phase:")
        for name, dt in self._phases.items():
            pct = 100.0 * dt / total if total > 0 else 0.0
            self.info(f"  {name:24s} {dt:10.2f} s  ({pct:5.1f}%)")
        self.info(f"  {'total':24s} {total:10.2f} s")

    def log_lnl(self, lnl: float) -> None:
        if not self.primary:
            return
        with open(self.log_path, "a") as f:
            f.write(f"{time.time() - self.start_time:.6f} {lnl:.6f}\n")

    def write_result(self, text: str) -> None:
        if not self.primary:
            return
        with open(self.result_path, "w") as f:
            f.write(text if text.endswith("\n") else text + "\n")


def tree_length(tree, slot: int) -> float:
    """Sum of branch lengths -log z of one branch slot (the model rates
    are normalized to mean 1, so -log z is substitutions per site)."""
    return sum(-math.log(min(max(p.z[slot], ZMIN), ZMAX))
               for p, _ in tree.all_branches())


def write_model_params(path: str, inst, tree) -> None:
    """Final model parameters in the reference's layout
    (`printModelParams`, `axml.c:1733-1835`): an amino-acid partition
    names its matrix (AUTO's choice for an AUTO partition; an LG4 model's
    rate lines are its first category's matrix), LG4X adds its free
    category rates and weights."""
    from examl_tpu_torch.models.lg4 import LG4Params
    with open(path, "w") as f:
        for gid, (part, m) in enumerate(
                zip(inst.alignment.partitions, inst.models)):
            name = part.datatype.name
            letters = _STATE_LETTERS[name]
            slot = gid if inst.per_partition_branches else 0
            f.write(f"\n\nModel Parameters of Partition {gid}, Name: "
                    f"{part.name}, Type of Data: {name}\n")
            if name == "AA":
                f.write("Substitution Matrix: "
                        f"{inst.auto_prot_models.get(gid, part.model_name)}"
                        "\n")
            if inst.psr:
                psr = inst.per_site_rates[gid]
                f.write(f"categories: {len(psr)}\n")
                f.write("category rates: "
                        + " ".join(f"{r:.6f}" for r in psr) + "\n")
            else:
                f.write(f"alpha: {m.alpha:.6f}\n")
            if isinstance(m, LG4Params) and m.is_lg4x:
                f.write("LG4X category rates: " + " ".join(
                    f"{r:.6f}" for r in m.gamma_rates) + "\n")
                f.write("LG4X category weights: " + " ".join(
                    f"{w:.6f}" for w in m.rate_weights) + "\n")
            f.write(f"Tree-Length: {tree_length(tree, slot):.6f}\n")
            pairs = [(a, b) for a in range(m.states)
                     for b in range(a + 1, m.states)]
            for (a, b), r in zip(pairs, m.rates):
                f.write(f"rate {letters[a]} <-> {letters[b]}: {r:.6f}\n")
            f.write("\n")
            for s, x in enumerate(m.freqs):
                f.write(f"freq pi({letters[s]}): {x:.6f}\n")
            f.write("\n")


def _read_trees(path: str) -> List[str]:
    with open(path) as f:
        text = f.read()
    return [t.strip() + ";" for t in text.split(";") if t.strip()]


def checkpoint_manager(args, files: RunFiles, **kwargs):
    """The run's CheckpointManager: in rank 0's workdir, which every rank
    restores from.  The ranks of a gang that a supervisor spawned share
    the two-phase manager there (every rank stages, the cycle publishes
    once all have); otherwise only rank 0 writes."""
    from examl_tpu_torch.search.checkpoint import CheckpointManager
    gang = getattr(args, "_gang", None)
    if gang is not None:
        rank, size, shared = gang
        return CheckpointManager(shared, args.run_id, log=files.info,
                                 gang_rank=rank, gang_size=size, **kwargs)
    return CheckpointManager(files.shared_dir, args.run_id, log=files.info,
                             primary=files.primary, **kwargs)


def _load_constraint(args, inst):
    from examl_tpu_torch.tree.constraint import load_constraint
    with open(args.constraint_file) as f:
        return load_constraint(f.read(), inst.alignment.taxon_names,
                               args.seed, inst.num_branch_slots)


def run_search(args, inst, files: RunFiles) -> int:
    """-f d / -f o: the RAxML hill climb (reference `computeBIGRAPID`)."""
    from examl_tpu_torch.search.convergence import RfConvergence
    from examl_tpu_torch.search.raxml_search import (SearchOptions,
                                                     compute_big_rapid)

    mgr = checkpoint_manager(args, files)
    resume = None
    constraint = None
    if args.restart:
        tree = inst.random_tree(seed=args.seed)     # overwritten by restore
        resume = mgr.restore(inst, tree)
        if resume is None:
            files.info("no checkpoint found; cannot restart")
            return 1
        files.info(f"restart from state {resume['state']} with likelihood "
                   f"{inst.likelihood:.6f}")
        if args.constraint_file:
            # Keep enforcing the constraint after the restart: the
            # restored tree already honors it, so only the checker is
            # rebuilt (the random resolution is not redone).
            _, constraint = _load_constraint(args, inst)
            constraint._tree = tree
    elif args.constraint_file:
        tree, constraint = _load_constraint(args, inst)
        inst.evaluate(tree, full=True)
        files.info(f"constraint tree randomly resolved (seed {args.seed}), "
                   f"lnL {inst.likelihood:.6f}")
    else:
        if not args.tree_file:
            files.info("a starting tree (-t), a constraint tree (-g), or "
                       "-R is required for the tree search")
            return 1
        tree = inst.tree_from_newick(_read_trees(args.tree_file)[0])
        inst.evaluate(tree, full=True)
        files.info(f"starting tree lnL {inst.likelihood:.6f}")
    files.log_lnl(inst.likelihood)

    def log(msg: str) -> None:
        files.info(msg)
        files.log_lnl(inst.likelihood)

    opts = SearchOptions(
        initial=args.initial if args.initial is not None else 10,
        initial_set=args.initial is not None,
        save_best_trees=args.save_best,
        constraint=constraint,
        do_cutoff=args.mode != "o",
        search_convergence=args.rf_convergence,
        log=log)
    from examl_tpu_torch.search.spr import batched_scan_enabled
    files.info("SPR lazy-arm scan: "
               + ("batched (one dispatch per pruned node)"
                  if batched_scan_enabled(inst) else "sequential"))
    conv = (RfConvergence(inst.alignment.ntaxa, log=files.info)
            if args.rf_convergence else None)
    if conv is not None and resume is not None:
        blob = resume.get("extras", {}).get("rf_history")
        if blob:
            conv.load_blob(blob)
            files.info("restored RF-convergence history from checkpoint")

    def checkpoint_cb(state: str, extras: dict) -> None:
        # The -D convergence evidence rides along with every checkpoint,
        # so a restart keeps comparing against the pre-restart cycle.
        if conv is not None:
            extras = dict(extras, rf_history=conv.to_blob())
        mgr.write(state, extras, inst, tree)
        # The checkpoint just written is coherent: a pending SIGTERM /
        # SIGINT exits resumable here (PreemptCheckpointed).
        preempt.check_after_checkpoint(log=files.info)

    res = compute_big_rapid(inst, tree, opts, convergence_cb=conv,
                            checkpoint_cb=checkpoint_cb, resume=resume)

    files.info(f"Likelihood of best tree: {res.likelihood:.6f}")
    files.write_result(tree.to_newick(inst.alignment.taxon_names))
    _write_per_gene_trees(args, inst, tree, files)
    if files.primary:
        write_model_params(files.model_path, inst, tree)
    if res.good_trees and files.primary:
        good = os.path.join(args.workdir, f"ExaML_goodTrees.{args.run_id}")
        with open(good, "w") as f:
            for snap in res.good_trees:
                snap.restore_into(tree)
                f.write(tree.to_newick(inst.alignment.taxon_names) + "\n")
        files.info(f"{len(res.good_trees)} other good trees written to "
                   f"{good}")
    return 0


def _write_per_gene_trees(args, inst, tree, files: RunFiles) -> None:
    """Under -M, write one tree per partition with that partition's own
    branch lengths (reference `printTreePerGene`, `treeIO.c:348`)."""
    if not args.per_partition_bl or not files.primary:
        return
    path = os.path.join(args.workdir,
                        f"ExaML_perGeneBranchLengths.{args.run_id}")
    with open(path, "w") as f:
        for gid, part in enumerate(inst.alignment.partitions):
            f.write(f"[partition {gid} {part.name}]\n")
            f.write(tree.to_newick(inst.alignment.taxon_names,
                                   branch_index=gid) + "\n")
    files.info(f"Per-partition branch-length trees written to {path}")


def run_tree_evaluation(args, inst, files: RunFiles) -> int:
    """-f e / -f E: optimize model+branches on each tree in the file
    (reference `optimizeTrees`, `axml.c:2251-2356`), checkpointing with the
    MOD_OPT state per optimizer round (at most one per
    MID_TREE_CHECKPOINT_S) and per finished tree (reference
    `axml.h:655-659`, restart dispatch `searchAlgo.c:1730-1749`)."""
    from examl_tpu_torch.optimize.branch import tree_evaluate
    from examl_tpu_torch.optimize.model_opt import mod_opt

    if not args.tree_file:
        files.info("tree evaluation mode requires -t")
        return 1
    trees_txt = _read_trees(args.tree_file)
    if not trees_txt:
        files.info(f"no trees found in {args.tree_file}")
        return 1
    files.info(f"Found {len(trees_txt)} trees to evaluate")
    fast = args.mode == "e"
    # Each checkpoint embeds the accumulated results, so only the last two
    # are kept: disk use stays linear in the number of trees.
    mgr = checkpoint_manager(args, files, keep_last=2)
    last_ckpt = [0.0]
    # Gang ranks skip the wall-clock mid-tree cadence: a cycle's number
    # is each rank's write COUNT, and a per-rank clock would let the
    # counts drift apart until no cycle's halves meet.  They checkpoint
    # per finished tree; a pending preemption still stages at once (an
    # incomplete cycle never publishes, and at most this tree is redone).
    gang = getattr(args, "_gang", None) is not None

    start_i = 0
    results = []
    lnls = []
    resumed_tree = None
    if args.restart:
        tree = inst.tree_from_newick(trees_txt[0])   # scaffold for restore
        resume = mgr.restore(inst, tree)
        if resume is None:
            files.info("no checkpoint found; cannot restart")
            return 1
        if resume["state"] != "MOD_OPT":
            files.info(f"checkpoint state {resume['state']} is not a "
                       "tree-evaluation checkpoint")
            return 1
        ex = resume["extras"]
        start_i = ex["tree_iteration"]
        results = list(ex.get("results", []))
        lnls = list(ex.get("lnls", []))
        # Only a mid-optimization checkpoint carries a tree worth resuming
        # into; a per-finished-tree checkpoint restarts at trees_txt[i+1].
        resumed_tree = tree if ex.get("mid_tree") else None
        files.info(f"restart at tree {start_i} with likelihood "
                   f"{inst.likelihood:.6f}")

    for i in range(start_i, len(trees_txt)):
        if i == start_i and resumed_tree is not None:
            tree = resumed_tree        # mid-optimization topology+branches
        else:
            tree = inst.tree_from_newick(trees_txt[i])
        inst.evaluate(tree, full=True)

        def ckpt_cb(state: str, extras: dict, i=i, tree=tree) -> None:
            # A pending preemption writes regardless of the cadence.
            if gang and not preempt.requested():
                return
            if (time.time() - last_ckpt[0] < MID_TREE_CHECKPOINT_S
                    and not preempt.requested()):
                return
            merged = dict(extras)
            merged.update(tree_iteration=i, results=results, lnls=lnls,
                          mid_tree=True)
            mgr.write(state, merged, inst, tree)
            last_ckpt[0] = time.time()
            preempt.check_after_checkpoint(log=files.info)

        if fast and i > 0:
            tree_evaluate(inst, tree, 2.0)
        else:
            tree_evaluate(inst, tree, 1.0)
            mod_opt(inst, tree, 0.1, checkpoint_cb=ckpt_cb)
        files.info(f"Likelihood tree {i}: {inst.likelihood:.6f}")
        files.log_lnl(inst.likelihood)
        results.append(tree.to_newick(inst.alignment.taxon_names))
        lnls.append(inst.likelihood)
        # Per-finished-tree checkpoint so a restart moves on to tree i+1.
        mgr.write("MOD_OPT", {"tree_iteration": i + 1, "results": results,
                              "lnls": lnls}, inst, tree)
        last_ckpt[0] = time.time()
        heartbeat.beat("TREE_EVAL")
        preempt.check_after_checkpoint(log=files.info)
    best = max(range(len(lnls)), key=lambda i: lnls[i])
    files.info(f"Evaluated {len(lnls)} trees; best is tree {best} "
               f"with likelihood {lnls[best]:.6f}")
    if files.primary:
        with open(files.treefile_path, "w") as f:
            f.write("\n".join(results) + "\n")
        write_model_params(files.model_path, inst, tree)
    return 0


def _packing_report(inst, files: RunFiles) -> None:
    """Startup site-packing report (the reference's `printAssignments` /
    `printLoad`, `partitionAssignment.c:461-502`; here the load is lane
    padding per state bucket), with the SEV pool noted under -S.  In a
    site-parallel run the counts are those of rank 0's block window; site
    shards in one process add each shard's window and card."""
    for states, bucket in sorted(inst.buckets.items()):
        where = ""
        true_sites = int(sum(bucket.part_widths))
        if bucket.is_local:
            b0 = bucket.block_offset
            where = (f" (rank {inst.group.rank}'s window: blocks {b0}.."
                     f"{b0 + bucket.local_num_blocks - 1} of "
                     f"{bucket.num_blocks})")
            true_sites = int(np.count_nonzero(bucket.weights))
        padded = bucket.local_num_sites
        files.info(
            f"bucket states={states}{where}: {bucket.num_parts} partitions, "
            f"{true_sites} patterns -> {bucket.local_num_blocks} blocks x "
            f"{bucket.lane} lanes ({padded - true_sites} padding sites, "
            f"{100.0 * (padded - true_sites) / padded:.1f}% pad)")
        if inst.site_shards > 1:
            for r, eng in enumerate(inst.engines[states].shards):
                b0 = eng.bucket.block_offset
                files.info(f"  site shard {r} on {eng.device}: blocks "
                           f"{b0}..{b0 + eng.B - 1}")
        if inst.save_memory:
            files.info("  SEV (-S) pool active for this bucket")


def _sev_report(inst, files: RunFiles) -> None:
    """Each bucket's SEV pool at the end of a -S run (rank 0's window in a
    site-parallel run: each rank's pool covers its own; each site shard's
    pool region in one process)."""
    where = (f" (rank {inst.group.rank}'s window)" if inst.group.size > 1
             else "")
    for states, eng in inst.engines.items():
        for r, shard in enumerate(eng.shards):
            st = shard.sev.stats()
            if inst.site_shards > 1:
                where = f" (site shard {r}'s region)"
            files.info(
                f"SEV bucket states={states}{where}: {st['allocated_cells']}"
                f" of {st['dense_cells']} CLV cells allocated "
                f"({100.0 * st['saving_ratio']:.1f}% saved)")


def selective_read_decision(model: str, is_bytefile: bool,
                            has_auto_aa: bool, nprocs: int,
                            save_memory: bool = False):
    """("slice" | "whole" | "error"), reason — the per-rank data-loading
    policy, pure so it is unit-testable without a process group:

    * "slice": each rank seeks only its site blocks (readMyData,
      `byteFile.c:278-382`) — including -m PSR, whose per-site rate
      state stays host-global via allgathers (engine.rate_scan output;
      one weight-window gather, instance.psr_packed_weights — the
      reference's CAT Gatherv/Scatterv, `optimizeModel.c:2135-2254`,
      as collectives);
    * "whole": every rank reads the full file and keeps its window
      (single-process runs; AUTO-protein partitions, whose BIC/AICc
      sample sizes must be global; non-byteFile inputs);
    * "error": currently unreachable — kept for future hard
      incompatibilities so callers keep handling it.
    """
    if nprocs <= 1:
        return "whole", "single process"
    if not is_bytefile:
        return "whole", "input is not a byteFile"
    if has_auto_aa:
        return "whole", ("AUTO protein model selection needs global "
                         "sample sizes")
    note = ""
    if model == "PSR":
        note = " (-m PSR rate state allgathers to every process)"
    if save_memory:
        note += " (-S gap bookkeeping follows the window)"
    return "slice", "selective byteFile read" + note


def _is_bytefile(path: str) -> bool:
    from examl_tpu_torch.io.bytefile import BYTEFILE_MAGIC
    with open(path, "rb") as f:
        head = f.read(12)
    return (len(head) == 12
            and struct.unpack("<iii", head)[2] == BYTEFILE_MAGIC)


def _load_alignment(args, group, files: RunFiles):
    """(alignment, local_window): this rank's columns of the byteFile, or
    the whole file (`selective_read_decision`)."""
    from examl_tpu_torch.io.bytefile import (PROT_MODELS, read_bytefile,
                                             read_bytefile_for_process,
                                             read_bytefile_meta)
    is_bf = _is_bytefile(args.bytefile)
    has_auto = False
    if group.size > 1 and is_bf:
        has_auto = any(PROT_MODELS[pm.prot] == "AUTO"
                       for pm in read_bytefile_meta(args.bytefile).parts
                       if pm.dtype_i == 2)
    policy, reason = selective_read_decision(
        args.model, is_bf, has_auto, group.size, args.save_memory)
    if policy == "error":
        raise ValueError(reason)
    if policy == "slice":
        files.info(f"{reason}: rank {group.rank} of {group.size} loads "
                   "only its site blocks")
        return (read_bytefile_for_process(args.bytefile, group.rank,
                                          group.size),
                (group.rank, group.size))
    if group.size > 1:
        files.info(f"whole-file reads per rank ({reason})")
    return read_bytefile(args.bytefile), None


def run_mode(args, inst, files: RunFiles) -> int:
    """The mode `-f` names, on a built instance."""
    if args.mode in ("d", "o"):
        return run_search(args, inst, files)
    if args.mode == "q":
        from examl_tpu_torch.cli.quartets import run_quartets
        return run_quartets(args, inst, files)
    return run_tree_evaluation(args, inst, files)


def fleet_mode(args) -> bool:
    return bool(args.bootstrap or args.multi_start or args.serve)


def _check_mesh_args(ap, args, fleet_modes: int):
    """The declared (sites, tree) fabric's flag hygiene, at argument time
    (the JAX CLI's): the spec parses, and every (S, T) combination that
    cannot compose is named.  Returns (S, T), or None without a mesh."""
    spec = launch.mesh_spec_requested(args)
    if spec is None:
        return None
    from examl_tpu_torch.parallel.sharding import parse_mesh_spec
    try:
        shape = parse_mesh_spec(spec)
    except ValueError as exc:
        ap.error(f"--mesh: {exc}")
    s, t = shape
    if args.single_device and shape != (1, 1):
        ap.error("--mesh SxT declares a device mesh; it cannot combine "
                 "with --single-device (use --mesh 1x1 for an explicit "
                 "single-device run)")
    if t > 1 and not fleet_modes:
        ap.error(f"mesh {s}x{t}: the tree axis batches independent fleet "
                 "jobs, so T>1 needs a fleet mode (-b/-N/--serve); a single "
                 f"-f search uses --mesh {s}x1")
    if args.save_memory and t > 1:
        ap.error(f"mesh {s}x{t} cannot compose with -S: the SEV pool holds "
                 "ONE arena per instance, so per-job arenas cannot stack "
                 f"along the tree axis — only Sx1 meshes support -S (use "
                 f"--mesh {s}x1 without a fleet mode)")
    return shape


def _refuse_ranks_with_site_axis(ap, args, mesh_shape) -> None:
    """A declared site axis runs in one process; the ranks of `--nprocs N
    > 1` (a process group) hold one card each."""
    if mesh_shape is not None and mesh_shape[0] > 1 and \
            launch.launch_requested(args) and (args.nprocs or 1) > 1:
        ap.error(f"mesh {mesh_shape[0]}x{mesh_shape[1]} splits the sites "
                 "over cards in one process; it cannot combine with "
                 "--nprocs ranks, which hold one card each")


def _check_fleet_args(ap, args) -> None:
    """The JAX CLI's fleet flag hygiene (one fleet mode at a time, and
    what conflicts with the batched tier refused up front), and its
    routing of ranks started by hand: with a fleet mode, `--nprocs N
    --procid K` makes a LEASED rank that joins no process group (the
    jobs are independent), so the launch flags are cleared here and the
    rank identity rides `args._fleet_rank` into the run.  A fleet
    without a mesh pins `--single-device`: its lanes come from
    `--fleet-devices`."""
    if args.bootstrap < 0 or args.multi_start < 0:
        ap.error("-b/-N replicate counts must be positive")
    modes = sum(bool(x) for x in (args.bootstrap, args.multi_start,
                                  args.serve))
    if modes > 1:
        ap.error("-b, -N and --serve are mutually exclusive fleet modes")
    mesh_shape = _check_mesh_args(ap, args, modes)
    if not modes:
        _refuse_ranks_with_site_axis(ap, args, mesh_shape)
        return
    if args.mode == "q":
        ap.error("fleet modes (-b/-N/--serve) replace the -f algorithm; "
                 "they cannot combine with -f q")
    if args.save_memory:
        # The shape is named, so the operator sees that the mesh was
        # considered and cannot compose, not that routing is missing.
        s_sh = mesh_shape[0] if mesh_shape else 1
        t_sh = mesh_shape[1] if mesh_shape else "J"
        ap.error(f"fleet modes do not support -S: the (S={s_sh}, T={t_sh}) "
                 "combination cannot compose because the SEV pool holds one "
                 "arena per instance and per-job arenas cannot stack along "
                 "the tree axis; drop -S, or run Sx1 site sharding without "
                 "a fleet mode")
    if mesh_shape is not None and args.fleet_devices != 1:
        ap.error("--mesh and --fleet-devices are mutually exclusive: the "
                 "fabric's tree axis replaces the per-device lane "
                 "round-robin (T slices of one mesh instead of whole-device "
                 "lanes)")
    if args.fleet_devices < 0:
        ap.error("--fleet-devices must be >= 0 (0 = all local)")
    if args.bootstrap and not args.tree_file:
        ap.error("-b bootstrap replicates resample weights on a fixed "
                 "topology: a starting tree (-t) is required")
    if args.fleet_job_attempts < 1:
        ap.error("--fleet-job-attempts must be at least 1")
    if args.fleet_job_deadline < 0:
        ap.error("--fleet-job-deadline must be >= 0")
    if args.serve_max_pending < 1:
        ap.error("--serve-max-pending must be at least 1")
    if args.fleet_batch < 1:
        ap.error("--fleet-batch must be at least 1")
    if args.fleet_lease_ttl <= 0:
        ap.error("--fleet-lease-ttl must be positive")
    if args.launch is None and launch.launch_requested(args):
        if (args.nprocs or 1) > 1 and args.procid is None:
            # Two ranks sharing slot 0 would steal each other's live
            # leases through the own-rank reclaim path.
            ap.error("fleet ranks never join a collective process group; "
                     "every rank needs an explicit id: use --nprocs N "
                     "--procid K per rank (or --launch N, which spawns "
                     "the ranks itself)")
        if args.coordinator is not None and args.procid is None:
            ap.error("fleet ranks never join a collective process group; "
                     "use --nprocs N --procid K per rank (or --launch N, "
                     "which spawns the ranks)")
        args._fleet_rank = (args.procid or 0, args.nprocs or 1)
        args.nprocs = args.coordinator = args.procid = None
    if mesh_shape is None:
        args.single_device = True


def _check_supervisor_args(ap, args) -> None:
    if args.launch is None:
        return
    if args.launch < 1:
        ap.error("--launch requires at least 1 rank")
    if launch.launch_requested(args) or args.procid is not None:
        ap.error("--launch spawns every rank itself (it supplies "
                 "--coordinator/--nprocs/--procid per rank); it cannot be "
                 "combined with --nprocs/--procid/--coordinator")


def main(argv=None, device=None, dtype=None) -> int:
    """Run the mode `-f` names; `device` defaults to the card ("cuda"; a
    rank of a site-parallel run takes `cuda:(rank mod device_count)`),
    `dtype` to the device's compute dtype (`config.default_dtype`).
    Under `--supervise` or `--launch` this process only watches: its
    children run `python -m examl_tpu_torch.cli.main` on the card, and
    `device` and `dtype` are not passed on."""
    raw_argv = list(sys.argv[1:] if argv is None else argv)
    ap = build_argparser()
    args = ap.parse_args(raw_argv)
    # The reference's quartet flag-combination checks (axml.c:1206-1222):
    # -Y and -r belong to -f q only, and are mutually exclusive.
    if args.quartet_file and args.mode != "q":
        ap.error('you must specify "-Y quartetGroupingFileName" in '
                 'combination with "-f q"')
    if args.quartet_samples > 0 and args.mode != "q":
        ap.error('you must specify "-r randomQuartetNumber" in '
                 'combination with "-f q"')
    if args.quartet_samples > 0 and args.quartet_file:
        ap.error('you must specify either "-r randomQuartetNumber" or '
                 '"-Y quartetGroupingFileName"')
    if args.save_memory and args.newview is not None:
        ap.error(f"--newview {args.newview} cannot combine with -S: kernels "
                 "B1 and B2 have no pooled form, so -S runs every traversal "
                 "on the pooled wave-scan tier")
    if args.compile_timeout <= 0:
        ap.error("--compile-timeout must be positive")
    # EXAML_EXPORT_BANK is read at every library load; a typo must stop
    # the run here, not minutes in.
    try:
        export_bank.mode()
    except ValueError as exc:
        ap.error(str(exc))
    _check_supervisor_args(ap, args)
    _check_fleet_args(ap, args)
    try:
        launch.check_launch_args(args)
    except ValueError as exc:
        ap.error(str(exc))
    if args.inject_fault:
        try:
            faults.parse_spec(",".join(args.inject_fault))
        except ValueError as exc:
            ap.error(f"--inject-fault: {exc}")
    if args.launch is not None:
        # Gang mode: this process becomes the torch-free gang supervisor,
        # and every rank is a killable child (--supervise is implied).
        from examl_tpu_torch.resilience import supervisor
        return supervisor.launch_gang(raw_argv, args, log=print)
    if args.supervise:
        # The whole run (faults, kernels, search) happens in killable
        # children; the child gets the argv minus the supervisor flags.
        from examl_tpu_torch.resilience import supervisor
        return supervisor.supervise(raw_argv, args, log=print)

    import torch

    from examl_tpu_torch import config
    if dtype is None:
        dtype = config.default_dtype(torch.device(
            "cuda" if device is None else device))
    try:
        storage = config.clv_storage_dtype(dtype, args.clv_dtype)
    except ValueError as exc:
        ap.error(f"--clv-dtype {args.clv_dtype}: {exc}")
    if storage != dtype and args.newview == "whole":
        ap.error(f"--newview whole cannot combine with --clv-dtype "
                 f"{args.clv_dtype}: kernel B2 has no bfloat16-storage "
                 "instance, so full traversals take the chunk tier")
    # One run = one record: callers invoking main() repeatedly in one
    # process must not accumulate counters, fault hits, a heartbeat
    # stream or a ledger across runs.
    from examl_tpu_torch.obs import ledger as _ledger
    from examl_tpu_torch.obs import programs as _programs
    obs.reset()
    _programs.reset()
    faults.reset()
    heartbeat.reset()
    memgov.reset()
    _ledger.reset()
    prior_env = {k: os.environ.get(k) for k in (
        faults.ENV_VAR, _ledger.ENV_VAR, heartbeat.PROCID_VAR,
        heartbeat.GANG_VAR, _build.TIMEOUT_VAR)}
    try:
        for spec in (args.inject_fault or []):
            faults.arm(spec)
        # The in-process build watchdog's threshold (ops/_build.py).
        os.environ[_build.TIMEOUT_VAR] = repr(float(args.compile_timeout))
        fleet_rank = getattr(args, "_fleet_rank", None)
        if fleet_rank is not None:
            # A leased rank started by hand publishes the rank contract
            # through the variables a gang supervisor exports.
            os.environ[heartbeat.PROCID_VAR] = str(fleet_rank[0])
            if fleet_rank[1] > 1:
                os.environ[heartbeat.GANG_VAR] = str(fleet_rank[1])
        # The memory-budget knobs are read here, once per run.
        memgov.configure(memgov.knobs_from_env())
        # Join the run's process group before any output: only rank 0
        # writes run files; the others compute alike with their workdir
        # diverted.
        group = launch.init_distributed(args)
        try:
            return _instrumented_run(args, group, device, dtype, storage)
        finally:
            launch.shutdown(group)
    finally:
        # Fault arming, the ledger export and the rank identity are
        # per-run: callers in the same process inherit none of them.
        for key, val in prior_env.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val


def _instrumented_run(args, group, device, dtype, storage) -> int:
    """The run wrapped in its instruments (the JAX CLI's run wrapper):
    trace files, the ledger and its `run` events, the metrics autoflush
    and exit snapshot, the log sink into ExaML_info, the heartbeat, and
    the preemption handlers.  The snapshot, the trace and the ledger are
    finalized in a `finally`, so a failed run leaves them too."""
    from examl_tpu_torch.obs import ledger as _ledger
    shared_dir = args.workdir
    # The rank: the process group's, or, for a rank of an emulated gang or
    # a leased fleet rank (no group), the one its launcher exported.
    gang_size = heartbeat.env_gang_size()
    rank = group.rank if group.size > 1 else (
        heartbeat.env_rank() if gang_size else 0)
    if group.size > 1 or rank:
        device = launch.use_rank_device(rank, device)
        # Rank-targeted fault specs (`point@rank=R`) and the heartbeat
        # read the rank from EXAML_PROCID.
        os.environ[heartbeat.PROCID_VAR] = str(rank)
        if rank:
            args.workdir = os.path.join(args.workdir, f".proc{rank}")
    # A gang a supervisor spawned (or leased ranks) shares one directory:
    # coordinated checkpoints, leases and journals live there.
    args._gang = ((rank, gang_size, shared_dir)
                  if gang_size and gang_size > 1 else None)
    files = RunFiles(args.workdir, args.run_id, append=args.restart,
                     primary=rank == 0, shared_dir=shared_dir)
    if args.trace_events_dir:
        launch.enable_process_tracing(args.trace_events_dir, log=files.info)
    if args.profile_dir or args.trace_events_dir:
        obs.set_annotations(True)
    ledger_dir = _ledger.default_dir(args.ledger_dir, args.metrics_file)
    if ledger_dir:
        lpath = obs.enable_ledger(ledger_dir, proc=rank)
        if lpath:
            # Exported so subprocesses append to the same timeline.
            os.environ[_ledger.ENV_VAR] = ledger_dir
            files.info(f"run ledger -> {lpath}")
    obs.ledger_event("run", status="start", run_id=args.run_id,
                     mode=args.mode, restart=bool(args.restart),
                     rank=rank,
                     attempt=os.environ.get(faults.ATTEMPT_VAR))
    # Periodic --metrics flush on the heartbeat's clock: a killed process
    # leaves its last-known counters (the exit snapshot below wins when
    # the run ends normally).
    if args.metrics_file and files.primary:
        obs.set_autoflush(args.metrics_file)
    obs.set_log_sink(files.info)
    # SIGTERM/SIGINT only set a flag; the next checkpoint site turns it
    # into an emergency checkpoint and EXIT_PREEMPTED (no-op off the main
    # thread).
    preempt_installed = preempt.install(log=obs.log)
    launch.install_heartbeat(rank, log=files.info)
    rc = 1
    try:
        rc = _run(args, group, rank, device, dtype, storage, files)
        return rc
    except preempt.PreemptCheckpointed as exc:
        obs.ledger_event("run", status="preempted", signame=exc.signame)
        files.info(f"run preempted ({exc.signame}): emergency checkpoint "
                   "written; restart with -R to resume")
        rc = preempt.EXIT_PREEMPTED
        return rc
    except memgov.MemoryBudgetExhausted as exc:
        obs.ledger_event("run", status="alloc-oom", error=str(exc)[:200])
        files.info(f"run stopped on device-allocator OOM: {exc} (retry "
                   "with a lower EXAML_MEM_BUDGET_FRACTION)")
        rc = memgov.MemoryBudgetExhausted.exit_code
        return rc
    finally:
        obs.ledger_event("run", status="end", rc=rc)
        obs.set_autoflush(None)      # the exit snapshot below is the record
        if args.metrics_file and files.primary:
            try:
                with open(args.metrics_file, "w") as f:
                    json.dump(obs.snapshot(), f, indent=2, sort_keys=True,
                              default=str)
                files.info(f"metrics snapshot -> {args.metrics_file}")
            except OSError as exc:
                files.info(f"metrics snapshot failed ({exc})")
        obs.set_log_sink(None)
        obs.set_annotations(False)
        obs.finalize_tracing()
        obs.finalize_ledger()
        if preempt_installed:
            preempt.uninstall()
        heartbeat.reset()


@contextlib.contextmanager
def _profiled(args, rank: int, device, files: RunFiles):
    """--profile DIR: torch.profiler over the block (CPU activity, plus
    CUDA on the card), exported as a Chrome trace
    DIR/torch_trace.p<rank>.json."""
    if not args.profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(args.profile_dir, exist_ok=True)
    path = os.path.join(args.profile_dir, f"torch_trace.p{rank}.json")
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(path)
    files.info(f"profiler trace -> {path}")


def _run(args, group, rank, device, dtype, storage,
         files: RunFiles) -> int:
    from examl_tpu_torch.instance import PhyloInstance

    bank.reset()
    if args.bank:
        # The run's CUDA libraries, built before any engine in killable
        # workers with a deadline; a wedged family pins args.newview one
        # route down.  Then every rank waits for its peers' builds.
        with files.phase("bank (build)"):
            report = bank.run_bank(args, log=files.info)
            launch.bank_barrier(args, group, report, log=files.info)
            bank.warm_instance(report, files.info)
    tier = args.newview or (POOLED_TIER if args.save_memory else "chunk")
    mode = "fleet" if fleet_mode(args) else f"-f {args.mode}"
    files.info(f"alignment: {args.bytefile}  mode: {mode}  "
               f"model: {args.model}  newview: {tier}")
    if group.size > 1:
        files.info(
            f"site-parallel: {group.size} ranks, gloo group at tcp://"
            f"{args.coordinator}; rank devices: " + ", ".join(
                str(launch.rank_device(r, device))
                for r in range(group.size)))
    with files.phase("startup (io + engines)"):
        heartbeat.phase_beat("PARSE")
        try:
            data, local_window = _load_alignment(args, group, files)
        except ValueError as exc:
            files.info(f"ERROR: {exc}")
            return 1
        files.info(f"{data.ntaxa} taxa, {data.total_patterns} patterns"
                   + (" (this rank)" if local_window else "")
                   + f", {len(data.partitions)} partitions")
        heartbeat.phase_beat("PACK")
        try:
            sharding = launch.select_sharding(args, args.save_memory,
                                              log=files.info, device=device)
        except ValueError as exc:
            # A declared mesh the visible cards cannot hold (--mesh 2x1 on
            # one card): a configuration error with the arithmetic, not a
            # traceback.
            files.info(f"ERROR: {exc}")
            return 1
        inst = PhyloInstance(data, dtype=dtype, device=device,
                             use_median=args.median,
                             per_partition_branches=args.per_partition_bl,
                             newview=args.newview,
                             grad_smooth=args.grad_smooth == "on",
                             rate_model=args.model,
                             psr_categories=args.categories,
                             batch_scan={"auto": None, "on": True,
                                         "off": False}[args.batch_scan],
                             save_memory=args.save_memory,
                             clv_dtype=storage, local_window=local_window,
                             group=group, sharding=sharding)
        inst.auto_prot_criterion = args.auto_prot
        files.info(f"device: {inst.device}  dtype: {inst.dtype}  clv "
                   "storage: "
                   f"{str(inst.storage_dtype).removeprefix('torch.')}")
        _packing_report(inst, files)
    phase_name = f"inference ({mode})"
    with _profiled(args, rank, inst.device, files), \
            files.phase(phase_name):
        if fleet_mode(args):
            from examl_tpu_torch.cli.fleet import run_fleet
            rc = run_fleet(args, inst, files)
        else:
            rc = run_mode(args, inst, files)
    if inst.save_memory:
        _sev_report(inst, files)
    files.report_phases()
    return rc


if __name__ == "__main__":
    sys.exit(main())
