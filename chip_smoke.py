#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (examl_tpu_torch).

Builds the port's CUDA kernels from the sources in this checkout, holds
each kernel against its plain PyTorch version on the card, checks the
ref49 likelihood anchors on both full-traversal tiers (`newview="chunk"`,
the launch table through kernel B1; `newview="whole"`, kernel B2), runs
`-f e` on ref49 through the port's CLI (GAMMA on the whole tier, then
`-m PSR` on the wave-scan tier), runs the `-f d` SPR search through the
CLI on an 8-taxon, four-partition alignment (the batched SPR scan, the
default on the card) and restarts it with `-R` from its last-but-one
checkpoint on the other tier, runs `-f q` through the CLI on the same
alignment (the batched quartet scorer, held against the sequential one),
and drives the port's main paths — full-traversal evaluate,
Newton-Raphson branch updates, the SPR scan's scored insertions on both
routes (sequential and batched, each candidate held against the other),
whole-tree gradients and the gradient
smoothing route, a model-optimization pass, a PSR categorization round —
at a real per-GPU size (512 taxa x 131,072 DNA patterns in four
partitions, f32), where the batched quartet scorer also scores 16 sets
against the sequential one.  Kernels B1 and B2 are held against their plain
versions at K = 4 (DNA), 20 (amino acids) and 2 (binary); `-f e` runs
through the CLI on amino-acid and binary data (WAG, LG+F, LG4M, LG4X,
AUTO and a binary partition), and the amino-acid path runs at real size
(512 taxa x 32,768 amino-acid patterns in four partitions plus 32,768
binary ones) on both tiers.  SEV memory saving (`-S`) runs at real width
(512 taxa x 16 partitions of 8,192 patterns, each sequenced for one clade
of the tree): the pool on the pooled tier against the dense arena on the
chunk tier (lnL, Newton-Raphson, a batched lazy scan, the saving, pool
and peak memory), then through the CLI at small size (`-f d`, `-R`,
`-m PSR -f e`, `-f q`), with no newview kernel launched under `-S`.
bfloat16 CLV storage (float32 compute) runs kernel B1's bfloat16
instances: each against its plain version, the real-size DNA and AA +
BIN instances against their float32-storage lnL, `-f d --clv-dtype bf16`
and `-S -f e --clv-dtype bf16` through the CLI.  Site-parallel runs
start two ranks (processes of this script, `--site-child`) in a gloo
group that share the card: each rank reads its columns of the real-size
DNA set-up and runs the main path on its block window, held against one
process (the window's arena rows bit for bit), kernel B1 against its
plain version on windows that end in a partial tile, and ref49 `-f e
--newview whole` and `-f d` through the CLI over two ranks.  The fleet
runs eight real-size DNA start jobs (f32, then bf16 storage), three
AA + BIN ones and sixteen 64-taxon gene trees as one batch each, one B1 launch table per engine over a
stacked arena, each job's arena rows and lnL held bit for bit to the
job evaluated alone; 64 bootstrap replicates as one CLV pass and one
batched reduction; and `-b`, `-N` with smoothing cycles, `--serve` and
`-R` through the CLI.  The run's instruments and in-process resilience
(phase 25): `-f d` with `--metrics --ledger --trace-events` (the
artifacts parsed, the trace balanced, the dispatch counter and the
card's peak memory held against B1's launches and the arena) and `-f e
--profile` (B1 in the trace); the real-size evaluate with the
instruments off, traced and profiled, in turns; `engine.nonfinite` on
it (the wave-scan retry timed, its lnL held to the clean one);
`mem.oom` and `mem.pressure` on the fleet batch of phase 23 (each job's
lnL bit for bit as alone); a SIGTERM to a `-f d` process (exit 75) and
its `-R` (phase 7's lnL).  Supervision (phase 26): `python -m
examl_tpu_torch.cli.main --supervise` on 64 taxa of the real-size DNA
set-up, its child SIGKILLed at its first checkpoint (the time to recover,
split; no extension rebuilt; the supervisor never in nvidia-smi's compute
apps); a kill, a heartbeat stall and a SIGTERM on phase 7's alignment,
each resumed to the unsupervised lnLs bit for bit; `--launch 2` (a gloo
gang on the card) with a rank killed and with a checkpoint publish
killed; the 8-job real-size fleet as two leased ranks, one killed; a
fleet job that blows `--fleet-job-deadline`.  The extension bank (phase
27; phase 2's build already runs in its workers and records each
library's cold build seconds), side by side on 8 taxa x 1,024 columns
of its own: `-f e --bank --compile-timeout 5` with `compile.hang` armed
on a cold relocated build directory (the B1 worker killed at the
deadline, `newview_chunk` degraded in the manifest, the run ends on
`--newview scan` with no B1 launch, its lnL against the same run with
`--newview chunk`); a truncated copy of the library that built fastest
under `EXAML_EXPORT_BANK=require` (ExportBankRequired) and `on`
(quarantined, rebuilt, the run succeeds); `--supervise -f e` with
`compile.hang:signal=SEGV` on every attempt (rungs 1-3 climbed, rung 3
bit for bit as the unsupervised kernel-free run, no B1 launch); and the
B1 wedge check, one dataflow launch whose only row waits on its own
output rows, in a child process killed after 20 s.  The fleet's tree
axis (phase 28, run right after phase 23 on its real-size DNA instance
and prepared jobs): the driver over two lanes that share the card
(`devices=[cuda:0, cuda:0]`, each lane its own stream and ready flags)
on phase 23's 8 jobs as two batches of 4, every lnL bit for bit phase
23's with one dispatch and one B1 launch per lane, the round against
the same batches on one lane in turns; a MeshShard on a 1x2 fabric of
the card twice (slices 4/4, bit for bit); a PSR fleet on two lanes bit
for bit one lane; and through the CLI `-N 6` with `--fleet-devices 0`
and `--mesh 1x1` against plain `-N 6`, and `-N 4 --mesh 1x2` refused
("needs 2 devices").  The site axis (phase 29, run right after phase 22
on its one-process instance): two site shards of one tree in this
process on a 2x1 fabric of the card twice (each shard its own thread,
stream and window; parallel/shards.py), the real-size DNA set-up on B1
and on B2, each launched once a shard, the lnL bit for bit phase 22's
two ranks and each shard's arena rows against its window of the
one-process arena; `-S` on phase 19's set and bf16 storage on 2x1; and,
beside phases 6-8, ref49's anchors and `-f e --newview whole` through
the CLI with `--mesh 2x1`, PSR's evaluate, gradient smoothing and a
categorization round on 2x1 against one card, `--mesh 2x1` refused on
the card as it is and phase 7's `-f d` again with no mesh, bit for bit.
The fleet over site shards (phase 30, run right after phase 28 on phase
23's prepared jobs): a MeshShard on a 2x2 fabric of the card four times
(two tree slices of two site lanes each; fleet/shard.py) over a 2x1
instance of the real-size set-up, phase 23's 8 DNA jobs and 3 AA + BIN
jobs each as one batch, B1 once a lane and engine, every row bit for
bit the 2x1 evaluate and within 1e-6 of one card; batched smoothing of
phase 23's 16 gene trees on one card, 2x1 and 2x2 (the same sweeps,
d1/d2 bit for bit 2x1 = 2x2); 64 bootstrap replicates and a PSR fleet
on 2x2 bit for bit 2x1; and `-N 4 --mesh 2x2` refused on the card as it
is ("needs 4 devices").  Phases 9, 15, 17, 20 and 27 and the side parts
of phases 28, 29 and 30 time no kernel and run as side phases: each in
a process of its own (`--side-child`), 9, 15, 20 and 29 (b) started
after phase 5, 17, 27, 28 (d), 29 (e) and 30 (f) after phase 8, while
the script runs phases 6-8; all
are joined before phase 10, and each prints its lines in its own
place.  Every phase is fatal: any failure exits non-zero before the
result line.

    python3 chip_smoke.py [--seed N]     # one card
    python3 chip_smoke.py --host-ab DIR  # the real-size evaluate and -f d
                                         # against the port of the tree
                                         # at DIR, instruments off, in turns
    python3 chip_smoke.py --site-psr     # ref49 -m PSR -f e through the CLI
                                         # on one card, then on 2x1 of it

Output: progress and numbers on the earlier lines (each phase with its
seconds); the card's name and power limit; one line {"kernels": [...]}
with each kernel's launches on its paths, its agreement with the plain
version, its time per full traversal, the plain version's time and the
memory-traffic bound, in total and by instance K (`by_K`), B1's
bfloat16-storage instances in a row of their own; last,
{"ok": true, "device": {...}}.  The full
report is written as JSON beside the script (see `main`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REF49 = os.path.join(HERE, "tests", "fixtures", "ref49")
LNL_JAX_F64 = -16205.671707      # JAX package, CPU f64 (ROADMAP.md)
LNL_REF_BINARY = -16205.671990   # reference ExaML binary (ref49/lnl.txt)
# The reference binary's -m PSR -f e endpoint on ref49 (ref49psr/lnl.txt)
# and the one-sided margin tests/test_reference_parity.py allows below it.
LNL_REF_PSR, PSR_MARGIN = -14702.970620, 1.0
PSR_CATEGORIES = 25              # -c default: categories per partition
MODOPT_EPSILON = 0.1             # the -f e model-optimization epsilon
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published
F32_FLOPS = 67e12                # H100 SXM, float32 outside tensor cores
RTOL = {"float32": 1e-5, "float64": 1e-12}
# The real-size run: 512 taxa x 4 partitions of 32,768 DNA patterns.
TAXA, PARTITIONS, PART_WIDTH = 512, 4, 32768
# Site blocks of 128 in the kernel-vs-plain cases, by state count (the
# amino-acid cases cut to fit the f64 arenas and the plain version's
# temporaries in memory; at 128 blocks a 64-entry launch of B1 still has
# 8,192 tiles of K = 20 in f32, 32,768 in f64, against 132 CTAs).
CHECK_BLOCKS = {4: 1024, 20: 128, 2: 1024}
CHECK_WIDTH = 64        # chunk width of the kernel-vs-plain cases
# Blocks of the whole-traversal cases of phase 3 by (K, storage): a
# quarter of the real-size DNA width at K = 4, the real amino-acid and
# binary widths at K = 20 and 2, cut to 64 blocks for the f64 amino-acid
# arena (three arenas of 1,023 rows must fit the card with the plain
# version's temporaries).
ROUTE_BLOCKS = {(K, d): (64 if (K, d) == (20, "float64") else 256)
                for K in (4, 20, 2) for d in ("float32", "float64",
                                               "bfloat16")}
WHOLE_CHECK_BLOCKS = {4: 256, 20: 32, 2: 256}   # the B2-vs-plain cases
REPS = 5                # timed repeats
SEV_REPS = 3            # timed repeats of phase 19's evaluates
# The -f d run through the CLI: FD_TAXA taxa x 4 partitions of FD_WIDTH
# DNA columns.  The taxa are cut by the run's time limit; the width by
# the f64 re-evaluation check (abs 2e-3), which f32 evaluation of the
# result tree no longer meets reliably at twice this width.
FD_TAXA, FD_WIDTH = 8, 1024
SCAN_SLOTS = 4          # pruned slots of the lazy real-size SPR scan
# Batched against sequential candidate lnLs (f32): about 50 times the
# largest difference measured on the card (rel 2.1e-10).
SCAN_RTOL = 1e-8
# -f q: sets also scored by the sequential scorer, and the agreement asked
# of the scorers (f32).
FQ_SEQ_SETS, QUARTET_RTOL = 10, 1e-6
# The batched quartet scorer at real width: REAL_FQ_SETS sets (one
# JOB_CHUNK batch of 48 topologies), REAL_FQ_SEQ_SETS of them also by the
# sequential scorer.
REAL_FQ_SETS, REAL_FQ_SEQ_SETS = 16, 4
GRAD_RTOL = 1e-3        # f32 against f64 whole-tree d1, of max |d1|
# tree_evaluate's smooth_factor at real size: 8 smoothings, so at most 32
# gradient sweeps (the default 32 smoothings run 128 sweeps there, cut by
# the run's time limit).
REAL_SMOOTH_FACTOR = 0.25
# -f e through the CLI on amino-acid and binary data: AA_TAXA taxa, five
# amino-acid partitions of AA_CLI_WIDTH columns and a binary one of
# BIN_CLI_WIDTH (taxa cut from 24 by the script's time limit: AUTO's scans
# took 95-145 s there).
AA_TAXA, AA_CLI_WIDTH, BIN_CLI_WIDTH = 16, 200, 400
AA_LETTERS = "ARNDCQEGHILKMFPSTWYV"
# The real-size amino-acid instance: AA_REAL_TAXA taxa, four amino-acid
# partitions of AA_REAL_WIDTH patterns (one per model) and a binary one of
# BIN_REAL_WIDTH: a quarter of the DNA cell's 131,072 patterns at five
# times the bytes a pattern, an arena of 6.0 GB against DNA's 4.8 GB.
AA_REAL_TAXA, AA_REAL_WIDTH, BIN_REAL_WIDTH = 512, 8192, 32768
AA_REAL_MODELS = ("WAG", "LG", "LG4M", "LG4X")
# Phase 19, -S at real width: SEV_TAXA taxa, SEV_PARTS partitions of
# SEV_WIDTH columns (64 blocks each), each sequenced for one clade of
# SEV_CLADE taxa; pooled against dense at rel SEV_RTOL (f32: a dense
# all-gap CLV is ~1 after rounding, a pooled one exactly 1), Newton-Raphson
# on SEV_NEWTON branches, a lazy scan of SEV_SCAN_SLOTS pruned nodes.
SEV_TAXA, SEV_PARTS, SEV_WIDTH = 512, 16, 8192
SEV_CLADE = (64, 192)
SEV_RTOL, SEV_MIN_SAVING = 1e-6, 0.5
SEV_NEWTON, SEV_SCAN_SLOTS = 4, 2
# Phase 20, -S through the CLI: the JAX package's tests/test_sev.py shape
# (3 genes, each present in a third of the taxa, the gene clades as the
# start tree), its taxa and columns cut by the phase's time (per-branch
# smoothing under -S is host-bound), the saving asked of it (that
# module's bound for a random tree) and the -f q sets.
SEV_CLI_TAXA, SEV_CLI_GENES, SEV_CLI_WIDTH = 12, 3, 128
SEV_CLI_MIN_SAVING, SEV_CLI_QUARTETS = 0.2, 30
# Phase 21, bfloat16 CLV storage against float32 storage: the real-size
# lnL and the CLI runs' endpoints within rel BF16_RTOL (each gap measured is
# reported).  An absolute bound does not carry over between alignments:
# the -f d endpoint on phase 7's alignment sits 7.91 below its float32
# re-evaluation on the card (rel 4.1e-4), and on ref49 both packages' bf16
# lnL sits 5.19 below their float32 lnL (tests/test_torch_bf16.py), beyond
# the 4.0 that tests/test_numerics.py holds the JAX package to on
# testData/49.
BF16_RTOL = 1e-3
# Phase 22, site-parallel ranks: SITE_RANKS processes in a gloo group
# sharing the card; each waits at most SITE_TIMEOUT_S.  The allreduce and
# the Newton-Raphson iteration are timed as medians of so many calls;
# the tail windows' alignments have TAIL_TAXA taxa.  SITE_DIGEST_SEED
# seeds the arena digests' position weights.
SITE_RANKS, SITE_TIMEOUT_S = 2, 300
SITE_ALLREDUCE_CALLS, SITE_NR_CALLS = 60, 20
TAIL_TAXA, SITE_DIGEST_SEED = 64, 12345
# B1's instances held against their plain versions on the tail windows:
# float32 K = 4 and 20 (one-unit tiles: no partial tile at block
# granularity), and every dataflow instance whose tiles hold several
# units (float32 K = 2, bfloat16 K = 4 and 2).
TAIL_INSTANCES = (("float32", 4), ("float32", 20), ("float32", 2),
                  ("bfloat16", 4), ("bfloat16", 2))
# Phase 23's fleet: start jobs of a real-size DNA batch (f32 and bf16
# storage) and of an AA + BIN batch, and bootstrap replicates; and a
# batch of FLEET_GENE_JOBS per-gene trees (taxa, columns), the width at
# which one tree alone is bound by launches and host time.
FLEET_JOBS, FLEET_AA_JOBS, FLEET_REPLICATES = 8, 3, 64
FLEET_GENE_JOBS, FLEET_GENE = 16, (64, 2048)
# Phase 23's site sums at many partitions: the real-size DNA set-up
# (MANY_TAXA taxa) cut into MANY_PARTS gene-sized partitions of
# MANY_WIDTH columns (a phylogenomic matrix partitioned by gene, one
# block each).  The segment sum alone is timed at SEGSUM_LANES lanes (one
# branch, a gradient chunk, a wide lane batch), the Newton-Raphson
# iteration as the median of MANY_NR_CALLS calls.
MANY_TAXA, MANY_PARTS, MANY_WIDTH = 512, 1024, 128
SEGSUM_LANES, MANY_NR_CALLS = (1, 32, 256), 20
# Phase 25: evaluates per block of the instruments' turns, and the spans
# timed alone for the host cost of one.
INSTR_BLOCK, SPAN_COST_SPANS = 6, 2000
# `--host-ab`: timed real-size evaluates and `-f d` runs on each side.
HOST_AB_EVALUATES, HOST_AB_FD_RUNS = 40, 2
# Phase 26, supervision: part (a)'s supervised -f e runs on SUP_TAXA taxa
# of the real-size DNA set-up at its full width (TAXA cut by the script's
# time: 512 taxa do not finish a -f e and its restart in the part's
# 150 s, 128 took 125 s of a 1,028 s run); (b)(ii)'s stall window (10 s, not the CPU test's 3: (b)-(e) run
# side by side, and a restarted child's first launches must not read as a
# stall), (d)'s lease ttl and (e)'s job deadline, in seconds; every
# supervised run or rank is stopped after SUP_TIMEOUT_S.
SUP_TAXA, SUP_STALL_S, SUP_TTL_S, SUP_DEADLINE_S = 64, 10.0, 5.0, 5.0
SUP_TIMEOUT_S = 240
# Phase 27, the extension bank: the opening build's deadline per library
# (phase 2 builds through bank workers), (b)'s --compile-timeout, and the
# B1 wedge check's limit (its kernel traps after ~2^34 cycles, ~9 s).
BANK_BUILD_TIMEOUT_S, BANK_TIMEOUT_S, WEDGE_CHECK_S = 600.0, 5.0, 20.0
# Side phases: the host-bound CLI phases 9, 15 and 20 and part (b) of
# phase 29 start side by side after phase 5, each in a process of its own,
# while this process runs phases 6-8; phases 17 and 27, part (d) of phase
# 28 and part (e) of phase 29 start so after phase 8.  None of them
# times a kernel, and no kernel is timed while they run: all are joined
# before phase 10, each stopped after SIDE_TIMEOUT_S.  SIDE_THREADS caps
# each one's CPU threads.
SIDE_EARLY, SIDE_LATE = (("psr49", "aa_cli", "sev_cli", "site_ref49"),
                         ("quartets", "bank", "lanes_cli", "site_cli"))
SIDE_PHASES = SIDE_EARLY + SIDE_LATE
SIDE_TIMEOUT_S, SIDE_THREADS = 600, 2
# Its (b)-(d) run on FD_TAXA taxa x PARTITIONS x BANK_WIDTH columns of
# its own (phase 7's alignment cut to a quarter: the script's time).
BANK_WIDTH = 256
# Phase 28, the fleet's tree axis: phase 23's FLEET_JOBS real-size DNA
# jobs as batches of LANE_BATCH on two lanes that share the card (and on
# a 1x2 fabric of the card twice), the round against one lane timed in
# LANE_TURNS turns; a PSR fleet of LANE_PSR_JOBS start jobs on phase 7's
# alignment; its CLI part (d) runs with the side phases of phase 8 (-N
# LANE_CLI_JOBS, and -N 4 on a 1x2 mesh).
LANE_BATCH, LANE_TURNS, LANE_PSR_JOBS, LANE_CLI_JOBS = 4, 3, 6, 6
# Phase 29, the site axis: SHARDS site shards of one tree in this process
# on a SHARDS x 1 fabric of the card twice, each evaluate timed over
# SHARD_REPS; its lnLs within SHARD_RTOL of one card's.  Its parts (b)
# and (e) run as a side phase beside phase 8.
SHARDS, SHARD_REPS, SHARD_RTOL = 2, 3, 1e-6
# Phase 30, the fleet over site shards: a SHARDS x 2 fabric of the card
# named four times over phase 23's jobs; its batched smoothing of the gene
# trees runs MESH_SMOOTHINGS smoothings (at most 4 x that many sweeps; the
# fleet's default 32 would take the phase past its time); its part (f)
# runs in the side phase `site_cli`.
MESH_SMOOTHINGS = 2
NPHASES = 30
# The phases in the order they run: phase 29 runs right after phase 22,
# on its one-process instance, and phases 28 and 30 right after phase 23,
# on its prepared jobs.
PHASE_ORDER = list(range(1, 23)) + [29, 23, 28, 30] + list(range(24, 28))


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def release_memory() -> None:
    """Return the card memory of dropped instances: collect reference
    cycles first (the profiler's traced frames keep a phase's locals
    alive until the cycle collector runs, which would otherwise count
    them in a later phase's peak memory), then empty the cache."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def time_ms(fn, device, reps: int) -> float:
    """Mean wall time of fn() in ms over reps runs (CUDA events on the
    card, after one warm-up run)."""
    import torch
    fn()
    sync(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


# -- phase 3: kernel B1 against its plain version ---------------------------


# Kernel instances by state count: the data type, and the tip codes the
# kernel-vs-plain cases draw (DNA: A, C, G, T, N and a two-state code; all
# 23 amino-acid codes; binary 0, 1 and the gap).
STATES = (4, 20, 2)
CASE_CODES = {4: [1, 2, 4, 8, 15, 5], 20: list(range(23)), 2: [1, 2, 3]}


def datatype_of(K: int):
    from examl_tpu_torch import datatypes
    return {4: datatypes.DNA, 20: datatypes.AA, 2: datatypes.BINARY}[K]


def random_models(M: int, rng, dtype, device, ncat: int = 4, K: int = 4):
    """M random GTR+G models of K states (the last exchangeability 1)."""
    from examl_tpu_torch.models.gtr import build_model, n_exchange
    from examl_tpu_torch.ops.engine import stack_models
    models = []
    for _ in range(M):
        rates = rng.uniform(0.3, 6.0, n_exchange(K))
        rates[-1] = 1.0
        models.append(build_model(datatype_of(K),
                                  rng.dirichlet(np.ones(K) * 5),
                                  rates=rates, alpha=rng.uniform(0.2, 1.5),
                                  ncat=ncat))
    return models, stack_models(models, [0] * M, dtype, device)


def b1_case(tag: str, launch_spec, dtype_name: str, rescale: bool, B: int,
            W: int, seed: int, device, chained: bool = False, K: int = 4):
    """One kernel-vs-plain comparison of kernel B1 over a launch table.

    launch_spec lists (kind, real) per launch.  Inner children of launch
    0 (and of every launch unless `chained`) are rows of a random region
    [0, 2W); chained launches read the rows the launch before wrote, so
    the comparison fails if a launch reads before its predecessor's
    writes are visible.  Each launch writes the next `real` rows after
    2W, and W - real slack rows follow the last launch: rows past the
    real ones must stay bit for bit untouched.  Forced rescale scales
    each partition's P by f * 2^(-E/2), f in 0.25..4, so the children's
    products straddle 2^-E.  dtype_name is the arena's storage dtype;
    "bfloat16" computes in float32 and is held to its plain version within
    one bfloat16 ulp of each site's maximum (compare_arenas).  Returns a
    result dict."""
    import torch
    from examl_tpu_torch.ops import fastpath, newview_chunk
    storage = getattr(torch, dtype_name)
    dtype = torch.float32 if storage == torch.bfloat16 else storage
    E = 256 if dtype == torch.float64 else 32
    L, R, M, ntips = 128, 4, 4, 16
    rng = np.random.default_rng(seed)
    _, dm = random_models(M, rng, dtype, device, K=K)
    table = torch.as_tensor(datatype_of(K).tip_indicator_table(),
                            dtype=dtype, device=device)
    P = sum(r for _, r in launch_spec)
    zl = torch.as_tensor(rng.uniform(0.05, 0.99, (P, 1)), dtype=dtype,
                         device=device)
    zr = torch.as_tensor(rng.uniform(0.05, 0.99, (P, 1)), dtype=dtype,
                         device=device)
    pmat = newview_chunk.chunk_operands(dm, zl, zr)
    if rescale:
        f = torch.as_tensor([0.25, 0.8, 1.5, 4.0], dtype=dtype,
                            device=device) * 2.0 ** (-E / 2)
        pmat = (pmat * f.reshape(1, 1, M, 1, 1, 1)).contiguous()
    launch, lidx, ridx = [], [], []
    row, slot, prev = 2 * W, 0, None
    for kind, real in launch_spec:
        src = (np.arange(prev[0], prev[0] + prev[1])
               if chained and prev is not None else np.arange(2 * W))
        lidx.append(rng.choice(src, real))
        ridx.append(rng.choice(src, real))
        launch.append((kind, row, slot, real))
        prev = (row, real)
        row += real
        slot += real
    rows = row + (W - launch_spec[-1][1]) + 1
    launch = np.asarray(launch, np.int32)
    # The arena-sized inputs are drawn on the card, from the same seed.
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    clv = torch.rand((rows, B, L, R, K), generator=gen, dtype=dtype,
                     device=device).to(storage)
    scaler = torch.randint(0, 4, (rows, B, L), generator=gen,
                           dtype=torch.int32, device=device)
    codes = torch.as_tensor(CASE_CODES[K], dtype=torch.uint8,
                            device=device)[torch.randint(
                                0, len(CASE_CODES[K]), (ntips, B, L),
                                generator=gen, device=device)]
    block_part = torch.as_tensor(rng.integers(0, M, B), dtype=torch.int32,
                                 device=device)
    i32 = dict(dtype=torch.int32, device=device)
    args = (codes, table, block_part, launch,
            torch.as_tensor(np.concatenate(lidx), **i32),
            torch.as_tensor(np.concatenate(ridx), **i32),
            torch.as_tensor(rng.integers(0, ntips, P), **i32),
            torch.as_tensor(rng.integers(0, ntips, P), **i32), pmat, E)
    c_ref, s_ref = clv.clone(), scaler.clone()
    newview_chunk.chunk_apply_plain(c_ref, s_ref, *args)
    c_k, s_k = clv.clone(), scaler.clone()
    flow = fastpath.dataflow(launch, args[4], args[5], device)
    n0 = newview_chunk.LAUNCHES
    newview_chunk.chunk_apply(c_k, s_k, *args, flow)
    sync(device)
    launched = newview_chunk.LAUNCHES - n0
    what = f"B1 K={K} {tag} {dtype_name} rescale={rescale}"
    check(launched == newview_chunk.table_launches(K, storage, len(launch)),
          f"{what}: {launched} launches for a table of {len(launch)} rows")
    mism = (s_k != s_ref).nonzero()
    check(mism.shape[0] == 0, f"{what}: {mism.shape[0]} scaler mismatches, "
          f"first at (row, block, lane) "
          f"{mism[0].tolist() if mism.shape[0] else None}")
    out = slice(2 * W, row)
    check(torch.equal(c_k[:2 * W], clv[:2 * W])
          and torch.equal(c_k[row:], clv[row:])
          and torch.equal(s_k[row:], scaler[row:]),
          f"{what}: kernel wrote outside its rows")
    if storage == torch.bfloat16:
        rel, abs_err, ndiff = compare_arenas(c_k[out], c_ref[out], s_k[out],
                                             s_ref[out], what)
    else:
        diff = (c_k[out] - c_ref[out]).abs()
        smax = c_ref[out].abs().amax(dim=(3, 4), keepdim=True)
        rel = float((diff / smax.clamp_min(torch.finfo(dtype).tiny)).max())
        check(rel <= RTOL[dtype_name], f"{what}: CLV rel err {rel:.3e} > "
              f"{RTOL[dtype_name]}")
        abs_err, ndiff = float(diff.max()), int((diff > 0).sum())
    inc = int((s_ref[out] - scaler_sums(s_ref, launch, args[4], args[5])
               ).sum())
    return {"K": K, "case": tag, "dtype": dtype_name,
            "forced_rescale": rescale,
            "table_rows": len(launch_spec), "launches": launched,
            "entries": P, "blocks": B,
            "tiles": P * B, "max_abs_err": abs_err,
            "max_rel_err": rel, "differing_cells": ndiff,
            "cells": (row - 2 * W) * B * L * R * K, "rescaled_sites": inc}


def scaler_sums(scaler, launch, lidx, ridx):
    """The children's scaler sums of a launch table's entries (the part
    of each output scaler that is not its rescale increment), in output
    row order, read from the finished scaler array: every row a launch
    reads is either outside the table's rows or written once by an
    earlier launch."""
    import torch
    out = []
    for kind, _, slot, real in launch.tolist():
        s = torch.zeros((real,) + scaler.shape[1:], dtype=scaler.dtype,
                        device=scaler.device)
        if kind == 2:
            s += scaler[lidx[slot:slot + real].long()]
        if kind >= 1:
            s += scaler[ridx[slot:slot + real].long()]
        out.append(s)
    return torch.cat(out)


def layout_case(dtype_name: str, K: int, shape: str, B: int, seed: int,
                device, ntaxa: int = TAXA):
    """A full traversal's launch table on the card: a random tree or a
    caterpillar (one entry a wave on each side of its centroid) of
    `ntaxa` taxa, its fastpath structure (with the dataflow operands), B
    blocks of 128 sites in two partitions of random GTR+G models of K
    states, random tip codes, and a tip table scaled by 2^-(E/2 + 1), so
    every tip/tip product rescales.  Returns (clv, scaler, args of
    chunk_apply, Dataflow, rows written)."""
    import torch
    from examl_tpu_torch.ops import fastpath, newview_chunk
    from examl_tpu_torch.tree.topology import Tree
    storage = getattr(torch, dtype_name)
    dtype = torch.float32 if storage == torch.bfloat16 else storage
    E = 256 if dtype == torch.float64 else 32
    names = [f"t{i}" for i in range(ntaxa)]
    tree = (Tree.from_newick(caterpillar_newick(ntaxa), names, 1)
            if shape == "caterpillar" else Tree.random(names, seed, 1))
    rng = np.random.default_rng(seed)
    for p, _ in tree.all_branches():
        p.z[:] = [float(rng.uniform(0.05, 0.98))]
    flat = tree.flat_full_traversal(tree.centroid_branch())
    st = fastpath.build_structure(flat, ntaxa, device)
    _, dm = random_models(2, rng, dtype, device, K=K)
    zl, zr = fastpath.refresh_z(st, flat, 1, dtype, device)
    pmat = newview_chunk.chunk_operands(dm, zl, zr)
    dt = datatype_of(K)
    table = torch.as_tensor(dt.tip_indicator_table(), dtype=dtype,
                            device=device) * 2.0 ** -(E // 2 + 1)
    rows = ntaxa - 2 + fastpath.slack_rows(ntaxa) + 1
    clv = torch.zeros((rows, B, 128, 4, K), dtype=storage, device=device)
    scaler = torch.zeros((rows, B, 128), dtype=torch.int32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    codes = torch.randint(0, dt.num_codes, (ntaxa, B, 128), generator=gen,
                          device=device).to(torch.uint8)
    bp = torch.as_tensor(np.arange(B) * 2 // B, dtype=torch.int32,
                         device=device)
    args = (codes, table, bp, st.launch, st.lidx, st.ridx, st.lcode,
            st.rcode, pmat, E)
    flow = newview_chunk.Dataflow(st.flow_rows, st.wait,
                                  newview_chunk.Ready())
    written = torch.as_tensor(np.sort(st.row_of[st.row_of >= 0]),
                              device=device)
    return clv, scaler, args, flow, written


def phase_b1_routes(device, seed: int, reps: int) -> list:
    """Every instance of B1 (K = 4, 20, 2 in float32, float64 and bfloat16
    storage) over whole traversals of TAXA taxa through the route it
    takes (newview_chunk.ROUTE): a random tree at ROUTE_BLOCKS and a
    caterpillar at 8 blocks against the plain version, every tip/tip
    product rescaled (scalers equal, rows within the storage's bound, the
    differing cells counted); the random tree three times from the same
    inputs with one Ready, bitwise equal; then both routes in turns (per
    chunk, dataflow, dataflow, per chunk) on the random tree, rows of
    both bitwise equal (route_turns)."""
    import torch
    from examl_tpu_torch.ops import newview_chunk as nc
    out = []
    for dname in ("float32", "float64", "bfloat16"):
        for K in STATES:
            r = {"dtype": dname, "K": K, "route": nc.ROUTE[(
                K, getattr(torch, dname))]}
            for shape, B in (("caterpillar", 8),
                             ("random", ROUTE_BLOCKS[(K, dname)])):
                clv, sc, args, flow, rows = layout_case(dname, K, shape, B,
                                                        seed + K, device)
                c_ref, s_ref = clv.clone(), sc.clone()
                nc.chunk_apply_plain(c_ref, s_ref, *args)
                c_k, s_k = clv.clone(), sc.clone()
                n0 = nc.LAUNCHES
                nc.chunk_apply(c_k, s_k, *args, flow)
                sync(device)
                what = f"B1 K={K} {dname} {shape} traversal"
                check(nc.LAUNCHES - n0 == nc.table_launches(
                    K, clv.dtype, len(args[3])), f"{what}: launches")
                rel, abs_err, ndiff = compare_arenas(
                    c_k[rows], c_ref[rows], s_k[rows], s_ref[rows], what)
                check(int(s_ref[rows].sum()) > 0, f"{what}: no rescale")
                r[shape] = {"blocks": B, "table_rows": len(args[3]),
                            "max_rel_err": rel, "max_abs_err": abs_err,
                            "differing_cells": ndiff,
                            "cells": int(c_k[rows].numel())}
                del c_ref, s_ref
                if shape == "caterpillar":
                    continue
                for _ in range(2):
                    c2, s2 = clv.clone(), sc.clone()
                    nc.chunk_apply(c2, s2, *args, flow)
                    sync(device)
                    check(torch.equal(c2, c_k) and torch.equal(s2, s_k),
                          f"{what}: a repeat is not bitwise equal")
                    del c2, s2
                r["turns"] = route_turns(clv, sc, args, flow, device, reps)
                check(r["turns"]["bitwise_equal"],
                      f"{what}: the routes' rows differ")
                del clv, sc, c_k, s_k
            release_memory()
            t = r["turns"]
            faster = "flow" if t["flow_ms"] <= t["chunks_ms"] else "chunks"
            rel = max(r[k]["max_rel_err"] for k in ("random", "caterpillar"))
            log(f"  K={K:2d} {dname:8s} route {r['route']:6s}: random "
                f"{r['random']['table_rows']} rows x {r['random']['blocks']} "
                f"blocks, caterpillar {r['caterpillar']['table_rows']} rows; "
                f"vs plain rel {rel:.3e}, "
                f"differing cells {r['random']['differing_cells']} + "
                f"{r['caterpillar']['differing_cells']}; 3 runs bitwise "
                f"equal; in turns per chunk {t['chunks_ms']:.3f} ms "
                f"({t['launches']['chunks']} launches), dataflow "
                f"{t['flow_ms']:.3f} ms (1 launch): {faster} faster"
                + ("" if faster == r["route"] else " (route table differs)"))
            out.append(r)
    return out


def phase_kernel_vs_plain(device, blocks: dict, W: int, seed: int,
                          dtypes=("float32", "float64")):
    """For each instance K (blocks[K] blocks of 128 sites) and storage
    dtype: kinds 0/1/2 over W entries (more tiles than the persistent
    grid: the ring wraps many times), with and without forced rescale;
    then one entry over few blocks (fewer tiles than CTAs), a chunk of
    real < W entries, and a chain of launches each reading its
    predecessor's rows (run twice)."""
    results = []
    for K in STATES:
        B = blocks[K]
        cases = [(f"kind {k}", [(k, W)], d, r, B, False)
                 for d in dtypes for k in (0, 1, 2)
                 for r in (False, True)]
        for d in dtypes:
            chain = [(0, W), (1, 9), (2, 1), (2, 3), (2, W)]
            cases += [("real=1 few tiles", [(2, 1)], d, True, 64, False),
                      ("real<W", [(1, W * 5 // 8)], d, True, B, False),
                      ("chain", chain, d, True, max(B // 4, 8), True),
                      ("chain again", chain, d, True, max(B // 4, 8), True)]
        for i, (tag, spec, d, resc, nb, chained) in enumerate(cases):
            r = b1_case(tag, spec, d, resc, nb, W, seed + i, device, chained,
                        K)
            if resc:
                check(r["rescaled_sites"] > 0, f"B1 K={K} {tag} {d}: the "
                      "forced-rescale case rescaled no site")
            results.append(r)
            log(f"  K={K:2d} {tag:16s} {d:8s} rescale={resc!s:5s} rows="
                f"{r['table_rows']} launches={r['launches']} entries="
                f"{r['entries']} tiles="
                f"{r['tiles']} max_abs_err={r['max_abs_err']:.3e} "
                f"max_rel_err={r['max_rel_err']:.3e} differing cells "
                f"{r['differing_cells']} of {r['cells']}, rescaled_sites="
                f"{r['rescaled_sites']}")
    return results


# -- launch accounting ------------------------------------------------------


def reset_counts() -> None:
    from examl_tpu_torch.fleet import batch
    from examl_tpu_torch.ops import engine, newview_chunk, newview_whole
    from examl_tpu_torch.optimize import branch
    from examl_tpu_torch.search import batchscan, quartets_batch, spr
    batch.TABLES = 0
    newview_chunk.LAUNCHES = 0
    newview_whole.LAUNCHES = 0
    newview_chunk.LAUNCHES_BY_K.clear()
    newview_chunk.LAUNCHES_BY_DTYPE.clear()
    newview_whole.LAUNCHES_BY_K.clear()
    engine.FULL_TRAVERSALS = 0
    engine.PARTIAL_TRAVERSALS = 0
    engine.POOLED_TRAVERSALS = 0
    engine.CHUNK_LAUNCH_ROWS = 0
    engine.GRAD_PASSES = 0
    branch.GRAD_SWEEPS = 0
    spr.INSERTIONS_SCORED = 0
    batchscan.SCAN_CALLS = 0
    quartets_batch.JOBS_SCORED = 0


def read_counts() -> dict:
    """The counts since the last reset.  Under PSR every traversal, full
    ones included, runs on the wave-scan tier and counts as partial, as
    does each batched SPR scan call; under -S every traversal, full,
    partial or a batched scan call's, counts as pooled."""
    from examl_tpu_torch.fleet import batch
    from examl_tpu_torch.ops import engine, newview_chunk, newview_whole
    from examl_tpu_torch.optimize import branch
    from examl_tpu_torch.search import batchscan, quartets_batch, spr
    return {"b1": newview_chunk.LAUNCHES, "b2": newview_whole.LAUNCHES,
            "b1_by_K": dict(newview_chunk.LAUNCHES_BY_K),
            "b1_by_dtype": dict(newview_chunk.LAUNCHES_BY_DTYPE),
            "b2_by_K": dict(newview_whole.LAUNCHES_BY_K),
            "full_traversals": engine.FULL_TRAVERSALS,
            "partial_traversals": engine.PARTIAL_TRAVERSALS,
            "pooled_traversals": engine.POOLED_TRAVERSALS,
            "chunk_launch_rows": engine.CHUNK_LAUNCH_ROWS,
            "grad_passes": engine.GRAD_PASSES,
            "grad_sweeps": branch.GRAD_SWEEPS,
            "insertions_scored": spr.INSERTIONS_SCORED,
            "scan_calls": batchscan.SCAN_CALLS,
            "quartet_jobs": quartets_batch.JOBS_SCORED,
            "fleet_tables": batch.TABLES}


def add_counts(a: dict, b: dict) -> dict:
    """The counts of two runs of one path, summed (launches by K too)."""
    return {k: ({K: a[k].get(K, 0) + b[k].get(K, 0)
                 for K in set(a[k]) | set(b[k])}
                if isinstance(a[k], dict) else a[k] + b[k]) for k in a}


def b1_per_table(eng, rows: int) -> int:
    """B1's launches for one launch table of `rows` rows on engine eng's
    instance: one on the dataflow route, one a row per chunk."""
    from examl_tpu_torch.ops import newview_chunk
    return newview_chunk.table_launches(eng.K, eng.clv.dtype, rows)


def check_tier(counts: dict, tier: str, path: str) -> None:
    """A whole-tier path launches B2 once per full traversal and B1 never;
    a chunk-tier path never launches B2, and launches B1 at least once per
    full traversal (a table on the dataflow route) and at most once per
    launch-table row (every chunk with real entries on the per-chunk
    route), so at all exactly when it ran a full traversal."""
    if tier == "whole":
        check(counts["b1"] == 0, f"{path}: B1 launched {counts['b1']} "
              "times on the whole tier")
        check(counts["b2"] == counts["full_traversals"] > 0,
              f"{path}: {counts['b2']} B2 launches for "
              f"{counts['full_traversals']} full traversals")
    else:
        check(counts["b2"] == 0, f"{path}: B2 launched {counts['b2']} "
              "times on the chunk tier")
        check(counts["full_traversals"] <= counts["b1"]
              <= counts["chunk_launch_rows"],
              f"{path}: {counts['b1']} B1 launches for "
              f"{counts['chunk_launch_rows']} launch-table rows of "
              f"{counts['full_traversals']} full traversals")


# -- phase 4: kernel B2 against its plain version ----------------------------


def caterpillar_newick(n: int) -> str:
    text = "t0"
    for i in range(1, n):
        text = f"({text},t{i})"
    return text + ";"


def whole_case(dtype_name: str, shape: str, rescale: bool, B: int,
               seed: int, device, K: int = 4):
    """One kernel-vs-plain comparison of a whole traversal over B blocks
    of 128 sites: a random 512-taxon tree rooted at its centroid (wide
    waves), or a 64-taxon caterpillar rooted at its first tip (one entry
    per wave, the most barriers).  Forced rescale scales the tip table by
    0.75 * 2^(-E/2), so every tip/tip site rescales and tip/inner sites
    rescale every few levels."""
    import torch
    from examl_tpu_torch.ops import newview_whole
    from examl_tpu_torch.tree.topology import Tree
    dtype = getattr(torch, dtype_name)
    E = 256 if dtype == torch.float64 else 32
    L, M = 128, 4
    rng = np.random.default_rng(seed)
    ntaxa = 512 if shape == "random" else 64
    names = [f"t{i}" for i in range(ntaxa)]
    if shape == "random":
        tree = Tree.random(names, seed, 1)
    else:
        tree = Tree.from_newick(caterpillar_newick(ntaxa), names, 1)
    for p, _ in tree.all_branches():
        p.z[:] = [float(rng.uniform(0.05, 0.98))]
    root = tree.centroid_branch() if shape == "random" else tree.start
    flat = tree.flat_full_traversal(root)
    _, dm = random_models(M, rng, dtype, device, K=K)
    st = newview_whole.build_structure(flat, ntaxa, 1, device)
    zl, zr = newview_whole.refresh_z(st, flat, 1)
    pmat = newview_whole.whole_operands(dm, zl, zr, dtype, device)
    table = torch.as_tensor(datatype_of(K).tip_indicator_table(),
                            dtype=dtype, device=device)
    if rescale:
        table = table * (0.75 * 2.0 ** (-E / 2))
    n = flat.n
    rows = n + 4
    clv = torch.as_tensor(rng.uniform(0.0, 1.0, (rows, B, L, 4, K)),
                          dtype=dtype, device=device)
    scaler = torch.as_tensor(rng.integers(0, 4, (rows, B, L)),
                             dtype=torch.int32, device=device)
    codes = torch.as_tensor(rng.choice(CASE_CODES[K], (ntaxa, B, L)),
                            dtype=torch.uint8, device=device)
    block_part = torch.as_tensor(rng.integers(0, M, B), dtype=torch.int32,
                                 device=device)
    args = (codes, table, block_part, st.meta, st.l_code, st.r_code,
            st.wave_start, pmat, E)
    c_ref, s_ref = clv.clone(), scaler.clone()
    newview_whole.whole_apply_plain(c_ref, s_ref, *args)
    c_k, s_k = clv.clone(), scaler.clone()
    newview_whole.whole_apply(c_k, s_k, *args)
    sync(device)
    tag = f"K={K} {shape} {dtype_name} rescale={rescale}"
    mism = (s_k != s_ref).nonzero()
    check(mism.shape[0] == 0, f"B2 {tag}: {mism.shape[0]} scaler "
          f"mismatches, first at (row, block, lane) "
          f"{mism[0].tolist() if mism.shape[0] else None}")
    check(torch.equal(c_k[n:], clv[n:]) and torch.equal(s_k[n:], scaler[n:]),
          f"B2 {tag}: kernel wrote outside rows [0, {n})")
    diff = (c_k[:n] - c_ref[:n]).abs()
    smax = c_ref[:n].abs().amax(dim=(3, 4), keepdim=True)
    rel = float((diff / smax.clamp_min(torch.finfo(dtype).tiny)).max())
    check(rel <= RTOL[dtype_name], f"B2 {tag}: CLV rel err {rel:.3e} > "
          f"{RTOL[dtype_name]}")
    return {"K": K, "shape": shape, "dtype": dtype_name,
            "forced_rescale": rescale,
            "entries": n, "waves": int(st.wave_start.shape[0] - 1),
            "grid_blocks": newview_whole.LAST_GRID,
            "max_abs_err": float(diff.max()), "max_rel_err": rel,
            "max_scaler": int(s_ref[:n].max())}


def phase_whole_vs_plain(device, blocks: dict, seed: int):
    results = []
    for K in STATES:
        for dtype_name in ("float32", "float64"):
            for shape in ("random", "caterpillar"):
                for rescale in (False, True):
                    r = whole_case(dtype_name, shape, rescale, blocks[K],
                                   seed, device, K)
                    if rescale:
                        check(r["max_scaler"] > 0, f"B2 K={K} {shape} "
                              f"{dtype_name}: the forced-rescale case "
                              "rescaled no site")
                    results.append(r)
                    log(f"  K={K:2d} {shape:11s} {dtype_name:7s} "
                        f"rescale={rescale!s:5s} entries={r['entries']} "
                        f"waves={r['waves']} grid={r['grid_blocks']} blocks "
                        f"max_abs_err={r['max_abs_err']:.3e} "
                        f"max_rel_err={r['max_rel_err']:.3e} "
                        f"max_scaler={r['max_scaler']}")
    return results


# -- phase 5: ref49 on the chunk tier: anchor, NR, smoothing --------------


def refmodel():
    """tests/refmodel.py by path: an installed package named `tests` may
    shadow the repository's directory."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "refmodel", os.path.join(HERE, "tests", "refmodel.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ref49_instance(dtype, device, newview: str = "chunk",
                   reference_model: bool = True):
    """The ref49 alignment and tree, under the reference binary's
    optimized model (or the initial default model)."""
    from examl_tpu_torch.instance import PhyloInstance
    from examl_tpu_torch.io.bytefile import read_bytefile
    from examl_tpu_torch.transfer import install_model_params
    inst = PhyloInstance(read_bytefile(os.path.join(REF49, "aln49.binary")),
                         dtype=dtype, device=device, newview=newview)
    if reference_model:
        params = refmodel().parse_model_file(os.path.join(REF49,
                                                          "modelFile"))
        install_model_params(inst, [(p.rates, p.freqs, p.alpha)
                                    for p in params])
    with open(os.path.join(REF49, "TreeFile")) as f:
        tree = inst.tree_from_newick(f.read())
    return inst, tree


def anchors(device, newview: str):
    """ref49 lnL under the reference model: f64 within 2e-6 of the JAX
    package, f32 within 2e-3 of the reference binary."""
    import torch
    out = {}
    for dtype, ref, tol, name in (
            (torch.float64, LNL_JAX_F64, 2e-6, "JAX CPU f64"),
            (torch.float32, LNL_REF_BINARY, 2e-3, "reference binary")):
        inst, tree = ref49_instance(dtype, device, newview)
        lnl = inst.evaluate(tree, full=True)
        key = "lnl_f64" if dtype == torch.float64 else "lnl_f32"
        out[key] = lnl
        log(f"  {newview} {key[4:]} lnL {lnl!r} ({name} {ref}, "
            f"diff {lnl - ref:.3e})")
        check(abs(lnl - ref) <= tol, f"{newview} {key[4:]} anchor {lnl} "
              f"vs {ref}")
    return out, inst, tree


def phase_anchor(device):
    from examl_tpu_torch.optimize.branch import smooth_tree
    reset_counts()
    out, inst, tree = anchors(device, "chunk")
    # Move off the optimum (every branch twice as long) so the NR step and
    # the sweep have lnL to gain beyond f32 evaluation noise.
    for p, _ in tree.all_branches():
        p.z[:] = [z * z for z in p.z]
    l0 = inst.evaluate(tree, full=True)
    p = tree.centroid_branch()
    z = inst.makenewz(tree, p, p.back, list(p.z), maxiter=30)
    p.z[:] = [float(v) for v in z]
    l1 = inst.evaluate(tree, full=True)
    smooth_tree(inst, tree, 1)
    l2 = inst.evaluate(tree, full=True)
    out.update(lnl_perturbed=l0, lnl_after_makenewz=l1,
               lnl_after_smooth=l2)
    log(f"  f32 perturbed {l0!r} -> makenewz {l1!r} -> smooth_tree {l2!r}")
    check(l1 >= l0, f"makenewz decreased lnL: {l0} -> {l1}")
    check(l2 >= l1, f"smooth_tree decreased lnL: {l1} -> {l2}")
    out["launches"] = read_counts()
    check_tier(out["launches"], "chunk", "ref49 chunk tier")
    check(out["launches"]["grad_passes"] == out["launches"]["grad_sweeps"]
          > 0, f"smooth_tree took {out['launches']['grad_sweeps']} gradient "
          f"sweeps with {out['launches']['grad_passes']} gradient passes")
    log(f"  launches {out['launches']} (smooth_tree by whole-tree "
        f"gradients: {out['launches']['grad_sweeps']} sweeps)")
    return out


# -- phase 6: ref49 on the whole tier: anchors, -f e through the CLI ---------


def phase_ref49_whole(device, out_dir: str):
    import torch
    from examl_tpu_torch.cli import main as cli
    from examl_tpu_torch.optimize import branch
    reset_counts()
    out, _, _ = anchors(device, "whole")
    out["launches_anchors"] = read_counts()
    check_tier(out["launches_anchors"], "whole", "ref49 whole anchors")
    # -f e from the initial model (GTR rates 1, empirical frequencies,
    # alpha 1), f32 on the card, through the port's CLI in-process.
    inst, tree = ref49_instance(torch.float32, device, "whole",
                                reference_model=False)
    start = inst.evaluate(tree, full=True)
    del inst, tree
    workdir = os.path.join(out_dir, "fe_ref49")
    # Time the branch-length smoothing inside the run (tree_evaluate looks
    # smooth_tree up in its module at each call).
    smooth = branch.smooth_tree
    smooth_s = [0.0]

    def timed_smooth(*a, **k):
        t = time.perf_counter()
        smooth(*a, **k)
        sync(device)
        smooth_s[0] += time.perf_counter() - t

    branch.smooth_tree = timed_smooth
    reset_counts()
    t0 = time.perf_counter()
    try:
        rc = cli.main(["-s", os.path.join(REF49, "aln49.binary"),
                       "-t", os.path.join(REF49, "TreeFile"), "-n", "smoke",
                       "-w", workdir, "-f", "e", "--newview", "whole"])
        sync(device)
    finally:
        branch.smooth_tree = smooth
    wall = time.perf_counter() - t0
    counts = read_counts()
    check(rc == 0, f"-f e through the CLI returned {rc}")
    check_tier(counts, "whole", "-f e CLI")
    with open(os.path.join(workdir, "ExaML_log.smoke")) as f:
        final = float(f.read().split()[-1])
    floor = LNL_REF_BINARY - MODOPT_EPSILON
    check(final >= floor, f"-f e endpoint {final} below {floor}")
    check(final >= start, f"-f e ended at {final}, below its start {start}")
    params = refmodel().parse_model_file(
        os.path.join(workdir, "ExaML_modelFile.smoke"))
    check(len(params) == 4 and all(
        p.alpha is not None and p.rates is not None and len(p.rates) == 6
        and len(p.freqs) == 4 for p in params),
        "ExaML_modelFile does not parse as four GTR+G partitions")
    check(counts["grad_passes"] > 0, "-f e smoothed without a gradient pass")
    out.update(fe_start_lnl=start, fe_final_lnl=final, fe_wall_s=wall,
               fe_smooth_s=smooth_s[0], fe_smooth_share=smooth_s[0] / wall,
               fe_launches=counts)
    log(f"  -f e (CLI, whole tier, f32): start {start!r} -> final "
        f"{final!r} (floor {floor}); {wall:.1f} s, of which branch "
        f"smoothing {smooth_s[0]:.1f} s ({smooth_s[0] / wall:.1%}: "
        f"{counts['grad_sweeps']} gradient sweeps, {counts['grad_passes']} "
        f"gradient passes); {counts['full_traversals']} full traversals, "
        f"{counts['b2']} B2 launches, {counts['b1']} B1 launches")
    return out


# -- phases 7 and 8: -f d through the CLI, and its -R restart ---------------


def read_checkpoints(workdir: str) -> dict:
    """{number: state} of the smoke run's checkpoint files."""
    import gzip
    out = {}
    for name in os.listdir(workdir):
        m = re.match(r"ExaML_binaryCheckpoint\.smoke\.ckpt_(\d+)\.json\.gz$",
                     name)
        if m:
            with gzip.open(os.path.join(workdir, name), "rt") as f:
                out[int(m.group(1))] = json.load(f)["state"]
    return out


def run_cli(argv, device, workdir: str):
    """The port's CLI in-process on `device` (the card by default, as a
    user runs it); returns (rc, wall s, counts, info-file text)."""
    from examl_tpu_torch.cli import main as cli
    reset_counts()
    t0 = time.perf_counter()
    rc = cli.main(argv + ["-n", "smoke", "-w", workdir],
                  device=None if device.type == "cuda" else device)
    sync(device)
    wall = time.perf_counter() - t0
    counts = read_counts()
    with open(os.path.join(workdir, "ExaML_info.smoke")) as f:
        info = f.read()
    return rc, wall, counts, info


def side_phase(name: str, device, out_dir: str, seed: int) -> dict:
    """One of SIDE_PHASES, run here (in its `--side-child` process); the
    late ones read what they need of earlier phases from side_inputs.pkl."""
    import pickle
    if name == "psr49":
        return phase_ref49_psr(device, out_dir)
    if name == "aa_cli":
        return phase_aa_cli(device, out_dir, seed)
    if name == "sev_cli":
        return phase_sev_cli(device, out_dir, seed)
    if name == "site_ref49":
        return site_ref49(device, out_dir)
    with open(os.path.join(out_dir, "side_inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    if name == "quartets":
        return phase_quartets(device, out_dir, inputs["search"])
    if name == "lanes_cli":
        return lanes_cli(device, out_dir, inputs["search"])
    if name == "site_cli":
        return site_cli(device, out_dir, inputs["search"])
    return phase_bank(device, inputs["bank_report"], inputs["bank_wall"],
                      inputs["smi"], seed)


def side_spawn(names, out_dir: str, seed: int, inputs=None) -> dict:
    """Each side phase of `names` in a `--side-child` process of its own
    group, started now: {name: (process, start)}.  Its output goes to
    side_<name>.log in `out_dir`, its result to side_<name>.pkl; `inputs`
    ({name: value} of earlier phases), if given, to side_inputs.pkl
    first."""
    import pickle
    if inputs is not None:
        path = os.path.join(out_dir, "side_inputs.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(inputs, f)
        os.replace(path + ".tmp", path)
    procs = {}
    for name in names:
        with open(os.path.join(out_dir, f"side_{name}.log"), "w") as f:
            procs[name] = (subprocess.Popen(
                [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                 "--side-child", name, "--seed", str(seed)], cwd=HERE,
                stdout=f, stderr=subprocess.STDOUT, start_new_session=True,
                env=dict(os.environ, OMP_NUM_THREADS=str(SIDE_THREADS))),
                time.perf_counter())
    return procs


def side_wait(procs: dict, out_dir: str) -> dict:
    """{name: (result, wall s, its output)} of every side phase, polled
    until each has ended; one that fails, or outlives SIDE_TIMEOUT_S from
    its start, fails the phase at once."""
    import pickle
    out = {}
    while len(out) < len(procs):
        for name, (proc, t0) in procs.items():
            if name in out:
                continue
            wall = time.perf_counter() - t0
            if proc.poll() is None:
                check(wall < SIDE_TIMEOUT_S, f"side phase {name} ran past "
                      f"{SIDE_TIMEOUT_S} s")
                continue
            with open(os.path.join(out_dir, f"side_{name}.log")) as f:
                text = f.read().rstrip("\n")
            check(proc.returncode == 0, f"side phase {name} exited "
                  f"{proc.returncode}: {text[-3000:]}")
            with open(os.path.join(out_dir, f"side_{name}.pkl"), "rb") as f:
                out[name] = (pickle.load(f), wall, text)
        time.sleep(0.2)
    return out


def side_stop(procs: dict) -> None:
    """Stop every side phase still running, with its group."""
    import signal
    for proc, _ in procs.values():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def side_child(name: str, out_dir: str, seed: int) -> int:
    """A `--side-child` process: run side phase `name` on the card and
    pickle its result beside its log."""
    import pickle
    import torch
    try:
        res = side_phase(name, torch.device("cuda", 0), out_dir, seed)
    except SmokeFailure as exc:
        print(f"chip_smoke: side phase {name} FAILED: {exc}", flush=True)
        return 1
    path = os.path.join(out_dir, f"side_{name}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(res, f)
    os.replace(path + ".tmp", path)
    return 0


def reevaluate(workdir: str, aln: str, dtype, device):
    """ExaML_result under ExaML_modelFile, evaluated afresh: (lnL,
    instance, tree)."""
    from examl_tpu_torch.instance import PhyloInstance
    from examl_tpu_torch.io.bytefile import read_bytefile
    from examl_tpu_torch.transfer import install_model_params
    inst = PhyloInstance(read_bytefile(aln), dtype=dtype, device=device)
    params = refmodel().parse_model_file(
        os.path.join(workdir, "ExaML_modelFile.smoke"))
    install_model_params(inst, [(p.rates, p.freqs, p.alpha)
                                for p in params])
    with open(os.path.join(workdir, "ExaML_result.smoke")) as f:
        tree = inst.tree_from_newick(f.read())
    return inst.evaluate(tree, full=True), inst, tree


class SearchClock:
    """Wall time of a search's parts, taken around the module functions the
    search calls (each ends with a read-back to the host, and the wrapper
    synchronizes): every branch-length smoothing (`smooth_tree`), model
    optimization (`mod_opt`, whose own smoothing is counted apart), and
    every scored insertion: one at a time on the sequential arm
    (`spr.test_insert`, which includes the thorough arm's local
    smoothing), a pruned endpoint's window at a time on the batched one
    (`batchscan.run_plan` / `run_plan_thorough`)."""

    def __init__(self, device):
        from examl_tpu_torch.optimize import branch
        from examl_tpu_torch.search import batchscan, raxml_search, spr
        self.s = {"smoothing": 0.0, "smoothing_in_mod_opt": 0.0,
                  "mod_opt": 0.0, "insertions": 0.0}
        self._in_mod_opt = False
        self._patches = [(branch, "smooth_tree", "smoothing"),
                         (raxml_search, "mod_opt", "mod_opt"),
                         (spr, "test_insert", "insertions"),
                         (batchscan, "run_plan", "insertions"),
                         (batchscan, "run_plan_thorough", "insertions")]
        self._saved = []
        for mod, name, key in self._patches:
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, self._timed(fn, key, device))

    def _timed(self, fn, key, device):
        def run(*a, **k):
            outer = self._in_mod_opt
            if key == "mod_opt":
                self._in_mod_opt = True
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                sync(device)
                dt = time.perf_counter() - t
                self.s[key] += dt
                if key == "smoothing" and outer:
                    self.s["smoothing_in_mod_opt"] += dt
                self._in_mod_opt = outer
        return run

    def restore(self) -> None:
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def phase_search(device, out_dir: str, seed: int):
    """-f d -i 5 through the port's CLI on the chunk tier and the default
    (batched) SPR scan: FD_TAXA taxa x 4 GTR+G4 partitions of FD_WIDTH DNA
    columns from the seed, the seed's random tree as the start."""
    import torch
    from examl_tpu_torch.io.bytefile import write_bytefile
    from examl_tpu_torch.tree.topology import Tree
    workdir = os.path.join(out_dir, "fd")
    os.makedirs(workdir, exist_ok=True)
    ad = synthetic_alignment(FD_TAXA, PARTITIONS, FD_WIDTH, seed)
    aln = os.path.join(out_dir, "fd_aln.binary")
    write_bytefile(aln, ad)
    start = os.path.join(out_dir, "fd_start.nwk")
    with open(start, "w") as f:
        f.write(Tree.random(ad.taxon_names, seed, 1).to_newick(
            ad.taxon_names) + "\n")
    argv = ["-s", aln, "-t", start, "-i", "5"]
    clock = SearchClock(device)
    try:
        rc, wall, counts, info = run_cli(argv, device, workdir)
    finally:
        clock.restore()
    check(rc == 0, f"-f d through the CLI returned {rc}")
    check_tier(counts, "chunk", "-f d CLI")
    check("SPR lazy-arm scan: batched" in info and counts["scan_calls"] > 0,
          "-f d on the card did not take the batched SPR scan "
          f"({counts['scan_calls']} scan calls)")
    logged = [float(line.split()[1]) for line in open(os.path.join(
        workdir, "ExaML_log.smoke")).read().splitlines()]
    final = float(re.search(r"Likelihood of best tree: (\S+)",
                            info).group(1))
    check(final > logged[0], f"-f d ended at {final}, not above its start "
          f"{logged[0]}")
    lnl32, inst, tree = reevaluate(workdir, aln, torch.float32, device)
    lnl64, _, _ = reevaluate(workdir, aln, torch.float64, device)
    check(abs(lnl32 - final) <= 1e-6 * abs(final),
          f"result re-evaluates to {lnl32} (f32) against the logged {final}")
    check(abs(lnl64 - final) <= 2e-3,
          f"result re-evaluates to {lnl64} (f64) against the logged {final}")
    ckpts = read_checkpoints(workdir)
    states = sorted(set(ckpts.values()))
    check({"FAST_SPRS", "SLOW_SPRS"} <= set(states),
          f"-f d wrote checkpoints of states {states} only")
    fast = len(re.findall(r"^fast cycle \d+ start", info, re.M))
    thorough = len(set(re.findall(r"^thorough cycle (\d+) radius", info,
                                  re.M)))
    # Host against device in full-tree smoothing: smooth_tree(.., 1) on the
    # result tree (up to 4 gradient sweeps), profiled.
    from examl_tpu_torch.optimize import branch
    sweeps0 = branch.GRAD_SWEEPS
    profile = device_breakdown(lambda: branch.smooth_tree(inst, tree, 1),
                               device)
    profile["sweeps"] = branch.GRAD_SWEEPS - sweeps0
    del inst, tree
    parts = dict(clock.s)
    parts["brent_probes"] = parts["mod_opt"] - parts["smoothing_in_mod_opt"]
    parts["other"] = wall - parts["smoothing"] - parts["brent_probes"] \
        - parts["insertions"]
    out = {"taxa": FD_TAXA, "patterns": int(sum(p.width for p in
                                                ad.partitions)),
           "wall_s": wall, "start_lnl": logged[0], "final_lnl": final,
           "reevaluated_f32": lnl32, "reevaluated_f64": lnl64,
           "launches": counts, "checkpoints": len(ckpts),
           "checkpoint_states": states, "fast_iterations": fast,
           "thorough_iterations": thorough, "parts_s": parts,
           "smoothing_sweep_profile": profile, "aln": aln,
           "start_tree": start, "workdir": workdir}
    log(f"  {FD_TAXA} taxa x {out['patterns']} patterns: lnL {logged[0]!r} "
        f"-> {final!r} in {wall:.1f} s; re-evaluated f32 {lnl32!r}, f64 "
        f"{lnl64!r}; {fast} fast + {thorough} thorough iterations; "
        f"{len(ckpts)} checkpoints ({', '.join(states)})")
    log(f"  {counts['full_traversals']} full traversals, "
        f"{counts['partial_traversals']} partial, "
        f"{counts['insertions_scored']} insertions scored in "
        f"{counts['scan_calls']} batched scan calls, "
        f"{counts['grad_sweeps']} gradient sweeps; B1 "
        f"{counts['b1']} launches for {counts['chunk_launch_rows']} "
        f"launch-table rows, B2 {counts['b2']}")
    log(f"  wall by part: smoothing {parts['smoothing']:.1f} s (of which "
        f"inside mod_opt {parts['smoothing_in_mod_opt']:.1f} s), mod_opt's "
        f"Brent probes {parts['brent_probes']:.1f} s, scored insertions "
        f"{parts['insertions']:.1f} s, the rest {parts['other']:.1f} s")
    if profile["measured"]:
        log(f"  profiled smooth_tree(1), {profile['sweeps']} gradient "
            f"sweeps: wall {profile['wall_ms']:.1f} ms, device busy "
            f"{profile['busy_ms']:.1f} ms (idle share "
            f"{profile['idle_share']:.3f}) in {profile['launches']} device "
            f"ops")
    else:
        log(f"  profiled smooth_tree: not measured ({profile['error']})")
    return out


def phase_restart(device, out_dir: str, fd: dict):
    """-R --newview whole from the -f d run's last-but-one checkpoint."""
    import shutil
    workdir = os.path.join(out_dir, "fd_restart")
    shutil.rmtree(workdir, ignore_errors=True)
    shutil.copytree(fd["workdir"], workdir)
    ckpts = read_checkpoints(workdir)
    check(len(ckpts) >= 2, f"-f d wrote {len(ckpts)} checkpoints")
    keep = sorted(ckpts)[-2]
    for n in ckpts:
        if n > keep:
            os.remove(os.path.join(
                workdir, f"ExaML_binaryCheckpoint.smoke.ckpt_{n}.json.gz"))
    argv = ["-s", fd["aln"], "-t", fd["start_tree"], "-i", "5", "-R",
            "--newview", "whole"]
    rc, wall, counts, info = run_cli(argv, device, workdir)
    check(rc == 0, f"-R through the CLI returned {rc}")
    check_tier(counts, "whole", "-R --newview whole")
    m = re.search(r"restart from state (\S+) with likelihood (\S+)", info)
    check(m is not None and m.group(1) == ckpts[keep],
          f"-R did not resume at checkpoint {keep} ({ckpts[keep]})")
    final = float(re.findall(r"Likelihood of best tree: (\S+)", info)[-1])
    check(final >= fd["final_lnl"] - 0.5, f"-R ended at {final}, below the "
          f"continuous run's {fd['final_lnl']} less 0.5")
    log(f"  resumed at checkpoint {keep} ({m.group(1)}, lnL {m.group(2)}) "
        f"-> {final!r} (continuous {fd['final_lnl']!r}) in {wall:.1f} s; "
        f"{counts['full_traversals']} full traversals, B2 {counts['b2']} "
        f"launches, B1 {counts['b1']}")
    return {"checkpoint": keep, "state": m.group(1),
            "resumed_lnl": float(m.group(2)), "final_lnl": final,
            "wall_s": wall, "launches": counts}


# -- phase 17: -f q through the CLI ------------------------------------------


def phase_quartets(device, out_dir: str, fd: dict):
    """-f q through the port's CLI on the -f d phase's alignment and start
    tree: the model optimized, then every one of the C(FD_TAXA, 4) sets
    under its three topologies by the batched scorer, a QUARTETS
    checkpoint every 30 sets.  The newest checkpoint is restored into a
    fresh instance; there the batched scorer scores every row again
    (against the file's values) and the sequential scorer the first
    FQ_SEQ_SETS sets (against the batched values), both at rel
    QUARTET_RTOL."""
    import shutil
    from examl_tpu_torch.instance import PhyloInstance
    from examl_tpu_torch.io.bytefile import read_bytefile
    from examl_tpu_torch.search import quartets, quartets_batch
    from examl_tpu_torch.search.checkpoint import CheckpointManager
    workdir = os.path.join(out_dir, "fq")
    shutil.rmtree(workdir, ignore_errors=True)
    argv = ["-s", fd["aln"], "-t", fd["start_tree"], "-f", "q", "-I", "30"]
    rc, wall, counts, info = run_cli(argv, device, workdir)
    check(rc == 0, f"-f q through the CLI returned {rc}")
    check_tier(counts, "chunk", "-f q CLI")
    check("quartet scoring: batched" in info,
          "-f q on the card did not take the batched scorer")
    with open(os.path.join(workdir, "ExaML_quartets.smoke")) as f:
        rows = [line.rstrip("\n").split(": ") for line in f if "|" in line]
    nsets = math.comb(FD_TAXA, 4)
    check(len(rows) == 3 * nsets == counts["quartet_jobs"],
          f"-f q wrote {len(rows)} rows and scored "
          f"{counts['quartet_jobs']} jobs for {nsets} sets")
    jobs = [tuple(int(t) for t in r[0].replace("|", " ").split())
            for r in rows]
    in_file = np.array([float(r[1]) for r in rows])
    check(np.isfinite(in_file).all() and (in_file < 0).all(),
          "-f q wrote a non-finite or non-negative lnL")
    inst = PhyloInstance(read_bytefile(fd["aln"]), device=device)
    tree = inst.random_tree(seed=0)
    resume = CheckpointManager(workdir, "smoke").restore(inst, tree)
    check(resume is not None and resume["state"] == "QUARTETS",
          "no QUARTETS checkpoint to restore")
    sync(device)
    t0 = time.perf_counter()
    batched = quartets_batch.score_jobs(inst, jobs)
    sync(device)
    batched_s = time.perf_counter() - t0
    n = inst.alignment.ntaxa
    q1, q2 = tree.nodep[n + 1], tree.nodep[n + 2]
    t0 = time.perf_counter()
    seq = np.array([quartets.quartet_likelihood(
        inst, tree, q1, q2, *(tree.nodep[t] for t in job))
        for job in jobs[:3 * FQ_SEQ_SETS]])
    sync(device)
    seq_s = time.perf_counter() - t0
    rel_file = float(np.max(np.abs(batched - in_file) / np.abs(in_file)))
    rel_seq = float(np.max(np.abs(batched[:seq.size] - seq) / np.abs(seq)))
    check(rel_file <= QUARTET_RTOL, f"-f q rows re-scored at rel {rel_file}")
    check(rel_seq <= QUARTET_RTOL, "batched and sequential quartet lnLs "
          f"differ by rel {rel_seq:.3g}")
    out = {"sets": nsets, "rows": len(rows), "wall_s": wall,
           "launches": counts, "checkpoint_counter":
           resume["extras"]["quartet_counter"],
           "batched_ms_per_topology": batched_s * 1e3 / len(jobs),
           "sequential_ms_per_topology": seq_s * 1e3 / seq.size,
           "sequential_topologies": int(seq.size),
           "rel_vs_file": rel_file, "rel_batched_vs_sequential": rel_seq,
           "best_row": rows[int(np.argmax(in_file))]}
    log(f"  {nsets} sets x 3 topologies in {wall:.1f} s through the CLI "
        f"({counts['full_traversals']} full traversals, B1 {counts['b1']} "
        f"launches); restored at set {out['checkpoint_counter']}: batched "
        f"{out['batched_ms_per_topology']:.2f} ms per topology (rel "
        f"{rel_file:.3g} to the file), sequential "
        f"{out['sequential_ms_per_topology']:.2f} ms per topology on "
        f"{seq.size} of them (rel {rel_seq:.3g} to the batched)")
    return out


# -- phase 18: the quartet scorers at real width ----------------------------


def phase_real_quartets(device, setup: dict, seed: int):
    """The batched quartet scorer on the real-size DNA instance of phase 10
    (512 taxa x 131,072 patterns, built anew): REAL_FQ_SETS random 4-taxon
    sets under their three topologies, one JOB_CHUNK batch, timed after a
    warm-up call, with the device memory it takes above the instance's;
    the sequential scorer on the first REAL_FQ_SEQ_SETS sets, held against
    the batched lnLs at rel QUARTET_RTOL (it leaves the tree a quartet
    scaffold, so the instance is dropped after)."""
    import torch
    from examl_tpu_torch.search import quartets, quartets_batch
    inst, tree = real_instance(setup, device, "chunk")
    n = inst.alignment.ntaxa
    rng = np.random.default_rng(seed)
    sets = [tuple(sorted(int(t) for t in rng.choice(n, 4, replace=False)
                         + 1)) for _ in range(REAL_FQ_SETS)]
    jobs = [j for s in sets for j in quartets_batch.three_topology_jobs(*s)]
    check(len(jobs) == quartets_batch.JOB_CHUNK,
          f"{len(jobs)} jobs, not one batch of {quartets_batch.JOB_CHUNK}")
    quartets_batch.score_jobs(inst, jobs)
    sync(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    batched = quartets_batch.score_jobs(inst, jobs)
    sync(device)
    batched_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) - base
    check(np.isfinite(batched).all() and (batched < 0).all(),
          "the batched scorer gave a non-finite or non-negative lnL")
    q1, q2 = tree.nodep[n + 1], tree.nodep[n + 2]
    nseq = 3 * REAL_FQ_SEQ_SETS
    t0 = time.perf_counter()
    seq = np.array([quartets.quartet_likelihood(
        inst, tree, q1, q2, *(tree.nodep[t] for t in job))
        for job in jobs[:nseq]])
    sync(device)
    seq_s = time.perf_counter() - t0
    rel = float(np.max(np.abs(batched[:nseq] - seq) / np.abs(seq)))
    check(rel <= QUARTET_RTOL, "batched and sequential quartet lnLs at real "
          f"width differ by rel {rel:.3g}")
    out = {"taxa": n, "patterns": int(sum(
        p.width for p in inst.alignment.partitions)),
        "sets": len(sets), "topologies": len(jobs),
        "batched_ms_per_topology": batched_s * 1e3 / len(jobs),
        "sequential_ms_per_topology": seq_s * 1e3 / nseq,
        "sequential_topologies": nseq, "peak_bytes": int(peak),
        "rel_batched_vs_sequential": rel}
    log(f"  {len(sets)} sets x 3 topologies at {out['patterns']} patterns: "
        f"batched {out['batched_ms_per_topology']:.2f} ms per topology, "
        f"{peak / 1e9:.2f} GB above the instance; sequential "
        f"{out['sequential_ms_per_topology']:.2f} ms per topology on "
        f"{nseq} of them (rel {rel:.3g} to the batched)")
    del inst, tree
    release_memory()
    return out


# -- phases 10 and 13: real size, chunk and whole tiers --------------------


def synthetic_alignment(ntaxa: int, parts: int, width: int, seed: int):
    """Correlated random DNA (a shared mutation walk per partition, ~2%
    gaps) as pattern-compressed partitions of `width` columns."""
    from examl_tpu_torch import datatypes
    from examl_tpu_torch.io.alignment import (AlignmentData, PartitionData,
                                              compress_patterns,
                                              empirical_frequencies)
    rng = np.random.default_rng(seed)
    dna = np.array([1, 2, 4, 8], np.uint8)
    out = []
    for g in range(parts):
        codes = np.empty((ntaxa, width), np.uint8)
        cur = rng.integers(0, 4, width)
        for t in range(ntaxa):
            flip = rng.random(width) < 0.15
            cur = np.where(flip, rng.integers(0, 4, width), cur)
            codes[t] = dna[cur]
        codes[rng.random((ntaxa, width)) < 0.02] = 15
        pats, wts = compress_patterns(codes)
        out.append(PartitionData(
            name=f"p{g}", datatype=datatypes.DNA, model_name="GTR",
            patterns=pats, weights=wts,
            empirical_freqs=empirical_frequencies(pats, wts, datatypes.DNA),
            use_empirical_freqs=True, optimize_freqs=False))
    return AlignmentData([f"t{i}" for i in range(ntaxa)], out)


def traversal_bytes(flat, ntips: int, patterns: int, R: int, K: int,
                    itemsize: int) -> int:
    """Modelled bytes of one full traversal (the JAX package's traffic
    model, obs/traffic.py): each entry writes one CLV row, each inner
    child is read once with its scaler row, each tip child reads 1-byte
    codes."""
    n = flat.n
    tips = int((flat.left <= ntips).sum() + (flat.right <= ntips).sum())
    clv_row = patterns * R * K * itemsize
    sc_row = patterns * 4
    inner_children = 2 * n - tips
    return (n + inner_children) * (clv_row + sc_row) + tips * patterns


def traversal_flops(flat, ntips: int, patterns: int, R: int, K: int) -> int:
    """Floating-point operations of one full traversal: 2*R*K*K per inner
    child per site (the P application) plus R*K products per entry."""
    tips = int((flat.left <= ntips).sum() + (flat.right <= ntips).sum())
    return (2 * flat.n - tips) * patterns * 2 * R * K * K \
        + flat.n * patterns * R * K


def chunk_flops(chunks, patterns: int, R: int, K: int) -> int:
    """Floating-point operations of a list of (kind, width) chunks, as
    traversal_flops counts them: 2*R*K*K per inner child (kind of them)
    and site, R*K products per entry and site."""
    return sum(int(w) * patterns * (kind * 2 * R * K * K + R * K)
               for kind, w in chunks)


def chunk_bytes(chunks, patterns: int, R: int, K: int, itemsize: int) -> int:
    """Bytes a list of (kind, width) chunks moves when every slot runs:
    each slot writes one CLV and scaler row, reads one per inner child
    (kind of them) and 1-byte codes per tip child.  Over the launch table
    (real widths) this is traversal_bytes; over the padded layout it
    counts the pads, replays and width padding too."""
    row = patterns * (R * K * itemsize + 4)
    return sum(int(w) * ((1 + kind) * row + (2 - kind) * patterns)
               for kind, w in chunks)


def real_setup(ntaxa: int, parts: int, width: int, seed: int) -> dict:
    """The real-size inputs both tiers share: alignment, per-partition
    models (rates, freqs, alpha) and branch lengths, from the seed."""
    t0 = time.perf_counter()
    ad = synthetic_alignment(ntaxa, parts, width, seed)
    rng = np.random.default_rng(seed + 1)
    params = []
    for _ in range(parts):
        rates = rng.uniform(0.3, 6.0, 6)
        rates[-1] = 1.0
        params.append((rates, rng.dirichlet(np.ones(4) * 5),
                       rng.uniform(0.2, 1.5)))
    zs = np.exp(-rng.exponential(0.08, 2 * ntaxa - 3))
    return {"ad": ad, "params": params, "zs": zs, "seed": seed,
            "ntaxa": ntaxa, "parts": parts,
            "patterns": int(sum(p.width for p in ad.partitions)),
            "alignment_s": time.perf_counter() - t0}


def real_instance(setup: dict, device, newview, dtype=None,
                  rate_model: str = "GAMMA", save_memory: bool = False,
                  clv_dtype=None, sharding=None):
    """The real-size instance on one tier (f32 unless `dtype` says; the
    pooled tier under save_memory, newview None; CLVs stored in
    `clv_dtype`; on one card or over `sharding`'s site shards), its
    models, and the seed's random tree with the set-up's branch lengths.
    Under PSR the models keep their rates and frequencies with one rate
    category."""
    import torch
    from examl_tpu_torch.instance import PhyloInstance
    from examl_tpu_torch.transfer import install_model_params
    inst = PhyloInstance(setup["ad"], dtype=dtype or torch.float32,
                         device=device, newview=newview,
                         rate_model=rate_model, save_memory=save_memory,
                         clv_dtype=clv_dtype, sharding=sharding)
    install_model_params(inst, setup["params"])
    tree = inst.random_tree(setup["seed"])
    for (p, _), z in zip(tree.all_branches(), setup["zs"]):
        p.z[:] = [float(z)]
    return inst, tree


def copy_lengths(src, dst) -> None:
    """Branch lengths of one tree onto another built the same way (the
    same random tree of the same seed: the same branch order)."""
    for (p, _), (q, _) in zip(src.all_branches(), dst.all_branches()):
        q.z[:] = list(p.z)


def timed_evaluates(inst, tree, device, reps: int):
    """One warm-up and `reps` timed full-traversal evaluates; returns
    (lnL, wall seconds per run)."""
    lnl0 = inst.evaluate(tree, full=True)
    sync(device)
    walls = []
    for _ in range(reps):
        t1 = time.perf_counter()
        lnl = inst.evaluate(tree, full=True)
        sync(device)
        walls.append(time.perf_counter() - t1)
    check(math.isfinite(lnl) and abs(lnl - lnl0) <= 1e-9 * abs(lnl0),
          f"repeated evaluate not stable: {lnl0} vs {lnl}")
    return lnl, walls


def bf16_ulp(x):
    """One bfloat16 ulp at |x| (8 significant bits), as float32."""
    import torch
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def compare_arenas(ck, cp, sk, sp, what: str):
    """Kernel rows against plain rows: scalers exactly equal (a site whose
    maximum sits on the 2^-E threshold could rescale in one version and
    not the other, as the FMA order differs; such a tie is reported as a
    failure with its site), CLVs within the f32 (f64) tolerance of each
    site's maximum; bfloat16 rows within one bfloat16 ulp of it (a float32
    sum in another order can round to the neighbouring bfloat16).  Returns
    (max_rel_err, max_abs_err, differing cells)."""
    import torch
    mism = (sk != sp).nonzero()
    check(mism.shape[0] == 0, f"{what}: {mism.shape[0]} scaler "
          f"mismatches, first at (row, block, lane) "
          f"{mism[0].tolist() if mism.shape[0] else None}")
    bf16 = ck.dtype == torch.bfloat16
    name = "float64" if ck.dtype == torch.float64 else "float32"
    wide = getattr(torch, name)
    ck, cp = ck.to(wide), cp.to(wide)
    smax = cp.abs().amax(dim=(3, 4), keepdim=True).clamp_min(
        torch.finfo(wide).tiny)
    diff = (ck - cp).abs()
    rel = float((diff / smax).max())
    if bf16:
        check(bool((diff <= bf16_ulp(smax)).all()), f"{what}: kernel vs "
              f"plain differ by more than one bfloat16 ulp of a site's max "
              f"(rel {rel:.3e})")
    else:
        check(rel <= RTOL[name], f"{what}: kernel vs plain rel err "
              f"{rel:.3e}")
    return rel, float(diff.max()), int((diff > 0).sum())


def traversal_bound(flat, setup: dict, eng, patterns=None) -> dict:
    """The least time of one full traversal of engine `eng` (f32 compute,
    rows of its arena's itemsize) over `patterns` real patterns (default:
    the whole set-up's)."""
    patterns = setup["patterns"] if patterns is None else patterns
    nbytes = traversal_bytes(flat, setup["ntaxa"], patterns, eng.R, eng.K,
                             eng.clv.element_size())
    flops = traversal_flops(flat, setup["ntaxa"], patterns, eng.R, eng.K)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    return {"bytes_per_traversal": nbytes, "flops_per_traversal": flops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def launch_breakdown(launch, args, clv, scaler, patterns: int, eng, device,
                     reps: int) -> list:
    """Kernel B1's time by kind and by real width: each class's rows as a
    table of their own through the instance's route (one dataflow launch,
    or one launch a row), from the same inputs, with the bytes and flops
    it moves.  A class's rows read rows outside the class from the arena
    as it stands.  `args` are chunk_apply_cuda's, the tip products
    prebuilt."""
    from examl_tpu_torch.ops import fastpath, newview_chunk
    rows = launch.tolist()
    lidx, ridx = args[4].cpu().numpy(), args[5].cpu().numpy()
    classes = [(f"kind {k}", lambda r, k=k: r[0] == k) for k in (0, 1, 2)]
    classes += [(f"{lo}-{hi} entries" if hi < 1 << 30 else f">={lo} entries",
                 lambda r, lo=lo, hi=hi: lo <= r[3] <= hi)
                for lo, hi in ((1, 1), (2, 4), (5, 16), (17, 1 << 30))]
    out = []
    for name, member in classes:
        sel = [i for i, r in enumerate(rows) if member(r)]
        if not sel:
            continue
        sub = np.ascontiguousarray(launch[sel])
        flow = fastpath.dataflow(sub, lidx, ridx, device)
        t = time_ms(lambda: newview_chunk.chunk_apply_cuda(
            clv, scaler, *args[:3], sub, *args[4:], flow), device, reps)
        chunks = [(rows[i][0], rows[i][3]) for i in sel]
        nbytes = chunk_bytes(chunks, patterns, eng.R, eng.K,
                             eng.clv.element_size())
        flops = chunk_flops(chunks, patterns, eng.R, eng.K)
        out.append({"class": name, "rows": len(sel), "bytes": nbytes,
                    "flops": flops, "ms": t,
                    "tb_per_s": nbytes / (t / 1e3) / 1e12,
                    "tflop_per_s": flops / (t / 1e3) / 1e12})
    return out


def host_and_card_ms(fn, device, reps: int) -> dict:
    """One call's host time (the enqueue: perf_counter around the call,
    no synchronisation, after a synchronised warm-up; mean of `reps`)
    against its card time (time_ms, CUDA events)."""
    host = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
    sync(device)
    return {"host_ms": float(np.mean(host)),
            "event_ms": time_ms(fn, device, reps)}


def route_turns(clv, scaler, args, flow, device, reps: int) -> dict:
    """B1 over one launch table by both routes in turns (per chunk,
    dataflow, dataflow, per chunk), each on an arena of its own shaped
    like clv, the tip products built in each call as chunk_apply builds
    them: each route's ms, the launches it makes, and whether the rows of
    both are bitwise equal.  `args` are chunk_apply's (the table, not the
    tip products), `flow` the table's Dataflow."""
    import torch
    from examl_tpu_torch.ops import newview_chunk as nc
    launch = nc.check_launch(args[3], clv.shape[0], args[4].shape[0])
    arenas = {q: (torch.zeros_like(clv), torch.zeros_like(scaler))
              for q in ("chunks", "flow")}

    def run(route):
        c, s = arenas[route]
        a = (args[0], nc.tip_products(args[8], args[1]), args[2], launch,
             *args[4:])
        if route == "flow":
            return nc._launch_flow(c, s, *a, flow)
        return nc._launch_chunks(c, s, *a)

    launches = {q: run(q) for q in arenas}
    sync(device)
    same = all(torch.equal(arenas["flow"][i], arenas["chunks"][i])
               for i in (0, 1))
    runs = {"chunks": [], "flow": []}
    for q in ("chunks", "flow", "flow", "chunks"):
        runs[q].append(time_ms(lambda: run(q), device, reps))
    del arenas
    return {"chunks_ms": float(np.mean(runs["chunks"])),
            "flow_ms": float(np.mean(runs["flow"])), "runs": runs,
            "launches": launches, "bitwise_equal": same}


def product_rate(clv, rows: int, device, reps: int) -> float:
    """The card's rate, TB/s, for an elementwise product of two sets of
    arena rows into a third (two reads and one write per value, B1's mix
    for inner/inner entries): a yardstick for B1's TB/s."""
    import torch
    half = rows // 2
    a, b = clv[:half], clv[half:2 * half]
    out = torch.empty_like(a)
    ms = time_ms(lambda: torch.mul(a, b, out=out), device, reps)
    return 3 * a.numel() * a.element_size() / (ms / 1e3) / 1e12


def log_profile(profile: dict, kernel: str) -> None:
    if profile["measured"]:
        log(f"  profiled evaluate: wall {profile['wall_ms']:.2f} ms, device "
            f"busy {profile['busy_ms']:.2f} ms (idle share "
            f"{profile['idle_share']:.3f}) in {profile['launches']} device "
            f"ops, {kernel} {profile[kernel.lower() + '_ms']:.2f} ms in the "
            f"trace ({profile[kernel.lower() + '_launches']} launched)")
        for r in profile["top"]:
            log(f"    {r['ms']:9.3f} ms  {r['calls']:5d}x  {r['name']}")
    else:
        log(f"  profiled evaluate: not measured ({profile['error']})")


def structure_host_ms(flat, ntaxa: int, device, reps: int) -> dict:
    """Host time of the fastpath structure of one new topology, which the
    engine builds once per topology it has not cached: the whole
    build_structure (layout, launch table, dataflow table, one transfer,
    synchronised) and its dataflow_table part alone, each the mean of
    `reps` calls after one warm-up."""
    from examl_tpu_torch.ops import fastpath
    layout, _, _, lidx, ridx = fastpath.structure_arrays(flat, ntaxa)[:5]
    launch = fastpath.launch_table(layout)

    def mean_ms(fn):
        fn()
        sync(device)
        runs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            sync(device)
            runs.append((time.perf_counter() - t0) * 1e3)
        return float(np.mean(runs))

    return {"table_rows": int(launch.shape[0]), "entries": flat.n,
            "build_structure_ms": mean_ms(
                lambda: fastpath.build_structure(flat, ntaxa, device)),
            "dataflow_table_ms": mean_ms(
                lambda: fastpath.dataflow_table(launch, lidx, ridx))}


def phase_real_size(device, setup: dict, reps: int):
    """The chunk tier at real size: evaluate, makenewz, kernel B1."""
    import torch
    from examl_tpu_torch.ops import fastpath, newview_chunk
    t0 = time.perf_counter()
    inst, tree = real_instance(setup, device, "chunk")
    eng = inst.engines[4]
    ntaxa, patterns = setup["ntaxa"], setup["patterns"]
    setup_s = setup["alignment_s"] + time.perf_counter() - t0
    log(f"  {ntaxa} taxa x {patterns} patterns in {setup['parts']} "
        f"partitions; arena {tuple(eng.clv.shape)} f32 "
        f"({eng.clv.numel() * 4 / 1e9:.2f} GB); set-up {setup_s:.1f} s")

    # What the card executes: the launch table against the padded layout.
    flat = tree.flat_full_traversal(tree.centroid_branch())
    st = eng._structure(flat)
    launch = st.launch
    padded = [(c.kind, c.width) for c in fastpath.iter_chunks(st.profile,
                                                              st.base)]
    layout = {
        "launches": int(launch.shape[0]), "slots": int(launch[:, 3].sum()),
        "padded_chunks": len(padded), "padded_slots": int(st.lidx.shape[0]),
        "bytes": chunk_bytes([(k, r) for k, _, _, r in launch.tolist()],
                             patterns, eng.R, eng.K, 4),
        "padded_bytes": chunk_bytes(padded, patterns, eng.R, eng.K, 4),
        "real_width_histogram": {str(w): int(c) for w, c in zip(
            *np.unique(launch[:, 3], return_counts=True))},
    }
    bound = traversal_bound(flat, setup, eng)
    check(layout["slots"] == flat.n, f"launch table writes {layout['slots']}"
          f" slots for {flat.n} entries")
    check(layout["bytes"] == bound["bytes_per_traversal"],
          f"launch-table bytes {layout['bytes']} vs traversal bytes "
          f"{bound['bytes_per_traversal']}")
    log(f"  launch table: {layout['launches']} launches writing "
        f"{layout['slots']} slots ({layout['bytes'] / 1e9:.2f} GB); padded "
        f"layout: {layout['padded_chunks']} chunks, {layout['padded_slots']} "
        f"slots ({layout['padded_bytes'] / 1e9:.2f} GB); real widths "
        f"{layout['real_width_histogram']}")
    # The host's share of a new topology: this tree and a caterpillar of
    # as many taxa (the most table rows a topology of this size gives).
    from examl_tpu_torch.tree.topology import Tree
    cat = Tree.from_newick(caterpillar_newick(ntaxa),
                           [f"t{i}" for i in range(ntaxa)], 1)
    structure = {"random": structure_host_ms(flat, ntaxa, device, reps),
                 "caterpillar": structure_host_ms(
                     cat.flat_full_traversal(cat.centroid_branch()), ntaxa,
                     device, reps)}
    for shape, r in structure.items():
        log(f"  new {shape} topology: build_structure "
            f"{r['build_structure_ms']:.3f} ms on the host, of which "
            f"dataflow_table {r['dataflow_table_ms']:.3f} ms "
            f"({r['table_rows']} table rows, {r['entries']} entries)")

    # The main path, one path at a time: the counts are set to 0 just
    # before each path and read just after it.  Full traversals (evaluate)
    # run the launch table through B1; makenewz's partial traversals run
    # the wave-scan tier in plain torch ops, so B1 is expected 0 times there.
    launches = {}
    reset_counts()
    lnl, walls = timed_evaluates(inst, tree, device, reps)
    launches["evaluate"] = read_counts()
    branches = tree.all_branches()
    picks = np.random.default_rng(setup["seed"] + 2).choice(
        len(branches), 8, replace=False)
    reset_counts()
    t1 = time.perf_counter()
    for i in picks:
        p, q = branches[int(i)]
        z = inst.makenewz(tree, p, q, list(p.z), maxiter=30)
        check(bool(np.all(np.isfinite(z))), f"makenewz gave {z}")
        p.z[:] = [float(v) for v in z]
    sync(device)
    nr_s = time.perf_counter() - t1
    launches["makenewz"] = read_counts()
    reset_counts()
    lnl_nr = inst.evaluate(tree, full=True)
    sync(device)
    after = read_counts()
    launches["evaluate"] = add_counts(launches["evaluate"], after)
    for path, counts in launches.items():
        check_tier(counts, "chunk", f"real-size chunk {path}")
    check(launches["makenewz"]["b1"] == 0,
          "makenewz's partial traversals launched B1")
    check(math.isfinite(lnl_nr) and lnl_nr >= lnl,
          f"lnL after makenewz {lnl_nr} vs {lnl}")
    log(f"  lnL {lnl!r}; after 8 makenewz {lnl_nr!r}; launches: "
        f"evaluate {launches['evaluate']}, makenewz {launches['makenewz']} "
        f"(partial traversals in torch ops)")

    # Kernel time against the plain version on one full traversal's launch
    # table, operands prebuilt, same inputs (these launches come after the
    # count was read).  The makenewz steps changed branch lengths, not the
    # topology, so the structure is the same.
    zl, zr = fastpath.refresh_z(st, flat, 1, eng.dtype, device)
    pmat = newview_chunk.chunk_operands(eng.models, zl, zr)
    ops_profile = device_breakdown(
        lambda: newview_chunk.chunk_operands(eng.models, zl, zr), device)
    args = (eng.tips.codes, eng.tips.table, eng.block_part_i32, launch,
            st.lidx, st.ridx, st.lcode, st.rcode, pmat, eng.scale_exp)
    u = newview_chunk.tip_products(pmat, eng.tips.table)
    kargs = (args[0], u) + args[2:]           # chunk_apply_cuda's operands
    clv_k = torch.zeros_like(eng.clv)
    sc_k = torch.zeros_like(eng.scaler)
    flow = newview_chunk.Dataflow(st.flow_rows, st.wait,
                                  newview_chunk.Ready())
    # B1's time is chunk_apply's: the tip products and the kernel.
    kernel_ms = time_ms(lambda: newview_chunk.chunk_apply(
        clv_k, sc_k, *args, flow), device, reps)
    host = host_and_card_ms(lambda: newview_chunk.chunk_apply(
        clv_k, sc_k, *args, flow), device, reps)
    tip_ms = time_ms(lambda: newview_chunk.tip_products(
        pmat, eng.tips.table), device, reps)
    clv_p = torch.zeros_like(eng.clv)
    sc_p = torch.zeros_like(eng.scaler)
    plain_ms = time_ms(lambda: newview_chunk.chunk_apply_plain(
        clv_p, sc_p, *args), device, max(1, reps // 2))
    rows = torch.as_tensor(np.sort(st.row_of[st.row_of >= 0]),
                           device=device)
    rel, abs_err, _ = compare_arenas(clv_k[rows], clv_p[rows], sc_k[rows],
                                     sc_p[rows], "chunk full traversal")
    # Once more from a fresh arena: a launch that read its predecessor's
    # rows too early would show here as an occasional mismatch.
    # Its launches are this traversal's: the count's difference around it.
    clv_k.zero_()
    sc_k.zero_()
    n0 = newview_chunk.LAUNCHES
    newview_chunk.chunk_apply(clv_k, sc_k, *args, flow)
    sync(device)
    per = newview_chunk.LAUNCHES - n0
    ev = launches["evaluate"]
    check(per == b1_per_table(eng, layout["launches"]),
          f"one traversal launched B1 {per} times on the "
          f"{newview_chunk.ROUTE[(eng.K, eng.clv.dtype)]} route for "
          f"{layout['launches']} table rows")
    check(ev["b1"] == ev["full_traversals"] * per > 0,
          f"evaluate: {ev['b1']} B1 launches for {ev['full_traversals']} "
          f"full traversals of {per} launches")
    rel2, abs2, _ = compare_arenas(clv_k[rows], clv_p[rows], sc_k[rows],
                                   sc_p[rows], "chunk full traversal, again")
    rel, abs_err = max(rel, rel2), max(abs_err, abs2)
    breakdown = launch_breakdown(launch, kargs, clv_k, sc_k, patterns, eng,
                                 device, reps)
    turns = route_turns(eng.clv, eng.scaler, args, flow, device, reps)
    check(turns["bitwise_equal"], "real-size DNA: the dataflow route's rows "
          "differ from the per-chunk route's")
    product_tb = product_rate(eng.clv, layout["slots"], device, reps)
    del clv_k, sc_k, clv_p, sc_p
    profile = device_breakdown(lambda: inst.evaluate(tree, full=True),
                               device)
    eval_ms = float(np.mean(walls) * 1e3)
    updates = flat.n * patterns * eng.R * eng.K
    report = {
        "ntaxa": ntaxa, "patterns": patterns, "partitions": setup["parts"],
        "lnl": lnl, "lnl_after_makenewz": lnl_nr,
        "evaluate_ms": eval_ms, "evaluate_ms_runs": [w * 1e3 for w in walls],
        "site_clv_updates_per_s": updates / (eval_ms / 1e3),
        "makenewz_8_s": nr_s, "layout": layout,
        "structure_host": structure,
        "launches_per_traversal": per, "host_vs_card": host,
        "route_turns": turns,
        "entries": flat.n, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "tip_products_ms": tip_ms,
        "achieved_tb_per_s": layout["bytes"] / (kernel_ms / 1e3) / 1e12,
        **bound, "max_rel_err": rel, "max_abs_err": abs_err,
        "launches": launches["evaluate"]["b1"], "launches_by_path": launches,
        "setup_s": setup_s, "profile": profile,
        "operand_build_profile": ops_profile, "launch_breakdown": breakdown,
        "product_tb_per_s": product_tb,
    }
    log(f"  chunk_apply: host {host['host_ms']:.3f} ms a call against "
        f"{host['event_ms']:.3f} ms on the card; routes in turns: per chunk "
        f"{turns['chunks_ms']:.3f} ms ({turns['launches']['chunks']} "
        f"launches), dataflow {turns['flow_ms']:.3f} ms "
        f"({turns['launches']['flow']} launch), rows bitwise equal")
    log(f"  evaluate {eval_ms:.2f} ms/full traversal (runs "
        f"{', '.join(f'{w * 1e3:.2f}' for w in walls)}; "
        f"{report['site_clv_updates_per_s']:.3e} site-CLV updates/s); "
        f"B1 {kernel_ms:.3f} ms (tip products {tip_ms:.3f} ms of it) in "
        f"{per} launch(es) for {layout['launches']} table rows "
        f"({report['achieved_tb_per_s']:.3f} TB/s of "
        f"{layout['bytes'] / 1e9:.2f} GB), plain {plain_ms:.3f} ms, bound "
        f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}); kernel vs plain "
        f"rel err {rel:.3e} (twice), scalers equal")
    for row in breakdown:
        log(f"  B1 {row['class']:>13s}: {row['rows']:3d} rows, "
            f"{row['bytes'] / 1e9:5.2f} GB, {row['ms']:.3f} ms as a table of "
            f"their own ({row['tb_per_s']:.3f} TB/s, {row['tflop_per_s']:.2f}"
            f" TFLOP/s)")
    log(f"  yardstick: elementwise product of arena rows (2 reads, 1 write) "
        f"{product_tb:.3f} TB/s")
    if ops_profile["measured"]:
        log(f"  operand build: {ops_profile['launches']} device ops, "
            f"{ops_profile['busy_ms']:.3f} ms busy, per traversal")
    log_profile(profile, "B1")
    return report, inst, tree


# -- phase 12: whole-tree gradients at real size -----------------------------


def grad_pass_bytes(flat, ntips: int, patterns: int, R: int, K: int,
                    itemsize: int) -> int:
    """Modelled bytes of one whole-tree gradient pass (the JAX package's
    obs/traffic.py `bytes_per_grad_pass`): the pre-order pass reads one
    outroot row and two child partials per entry (tips as 1-byte codes)
    and writes two outroot rows; the edge pass reads one outroot row and
    one down partial with its scaler per edge."""
    n = flat.n
    tips = int((flat.left <= ntips).sum() + (flat.right <= ntips).sum())
    clv_row = patterns * R * K * itemsize
    sc_row = patterns * 4
    inner_children = 2 * n - tips
    pre = (3 * n * clv_row + inner_children * (clv_row + sc_row)
           + tips * patterns)
    return pre + (2 * n + 1) * (2 * clv_row + sc_row)


def grad_pass_flops(flat, ntips: int, patterns: int, R: int, K: int) -> int:
    """Floating-point operations of one gradient pass: per entry P applied
    to the outroot partial and to each inner child (2*R*K*K per site) and
    two products; per edge the sumtable's two contractions and product and
    the three derivative sums."""
    n = flat.n
    tips = int((flat.left <= ntips).sum() + (flat.right <= ntips).sum())
    rk, rkk = R * K, 2 * R * K * K
    pre = (3 * n - tips) * patterns * rkk + 2 * n * patterns * rk
    edges = (2 * n + 1) * patterns * (2 * rkk + 2 * rk + 3 * 2 * rk)
    return pre + edges


def phase_real_gradients(device, setup: dict, inst, tree, reps: int):
    """Whole-tree gradients at real size on the chunk tier: one pass timed
    and profiled against its bound, its f32 d1 against an f64 instance of
    the same tree, then one gradient tree_evaluate (REAL_SMOOTH_FACTOR)
    re-evaluated on the whole tier."""
    import torch
    from examl_tpu_torch.optimize.branch import tree_evaluate
    from examl_tpu_torch.utils import z_slots
    eng = inst.engines[4]
    ntaxa, patterns = setup["ntaxa"], setup["patterns"]
    p = tree.centroid_branch()
    flat = tree.flat_full_traversal(p)
    root_z = z_slots(p.z, 1)
    launches = {}
    reset_counts()
    eng.run_traversal(flat, full=True)
    d1, d2 = eng.whole_tree_gradients(flat, root_z)
    sync(device)
    launches["traversal_and_pass"] = read_counts()
    check_tier(launches["traversal_and_pass"], "chunk",
               "real-size gradient pass")
    check(launches["traversal_and_pass"]["grad_passes"] == 1,
          "one gradient pass expected")
    E = 2 * ntaxa - 3
    check(d1.shape == d2.shape == (E, 1) and bool(np.isfinite(d1).all())
          and bool(np.isfinite(d2).all()), f"gradients {d1.shape} not finite")
    # The pass alone (the arena stays current: the pass only reads it).
    pass_ms = time_ms(lambda: eng.whole_tree_gradients(flat, root_z),
                      device, reps)
    profile = device_breakdown(
        lambda: eng.whole_tree_gradients(flat, root_z), device)
    nbytes = grad_pass_bytes(flat, ntaxa, patterns, eng.R, eng.K, 4)
    flops = grad_pass_flops(flat, ntaxa, patterns, eng.R, eng.K)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    tb_s = nbytes / (pass_ms / 1e3) / 1e12
    outroot = eng._outroot_arena()
    log(f"  outroot arena {tuple(outroot.shape)} f32 "
        f"({outroot.numel() * 4 / 1e9:.2f} GB)")
    log(f"  gradient pass: {pass_ms:.2f} ms for {E} edges "
        f"({nbytes / 1e9:.2f} GB modelled, {tb_s:.3f} TB/s); bound "
        f"{bound_ms:.2f} ms "
        f"({'bytes' if bytes_ms >= ops_ms else 'operations'}), "
        f"{bound_ms / pass_ms:.2f} of it")
    if profile["measured"]:
        log(f"  profiled pass: wall {profile['wall_ms']:.2f} ms, device busy "
            f"{profile['busy_ms']:.2f} ms (idle share "
            f"{profile['idle_share']:.3f}) in {profile['launches']} device "
            f"ops")
        for r in profile["top"]:
            log(f"    {r['ms']:9.3f} ms  {r['calls']:5d}x  {r['name']}")
    else:
        log(f"  profiled pass: not measured ({profile['error']})")

    # f32 against f64 on the same tree and branch lengths, every edge.
    torch.cuda.reset_peak_memory_stats(device)
    inst64, tree64 = real_instance(setup, device, "chunk", torch.float64)
    copy_lengths(tree, tree64)
    p64 = tree64.centroid_branch()
    flat64 = tree64.flat_full_traversal(p64)
    eng64 = inst64.engines[4]
    eng64.run_traversal(flat64, full=True)
    d1_64, _ = eng64.whole_tree_gradients(flat64, z_slots(p64.z, 1))
    sync(device)
    peak64 = torch.cuda.max_memory_allocated(device)
    del inst64, tree64, eng64
    release_memory()
    gap = float(np.abs(d1 - d1_64).max() / np.abs(d1_64).max())
    log(f"  f32 d1 against f64: max gap {gap:.3e} of max |d1| "
        f"({float(np.abs(d1_64).max()):.4e}); bound {GRAD_RTOL}; peak device "
        f"memory with both instances {peak64 / 1e9:.2f} GB")
    check(gap <= GRAD_RTOL, f"f32 gradients {gap:.3e} of max |d1| away "
          f"from f64")

    # One tree_evaluate by gradients, re-evaluated on the whole tier.
    before = inst.evaluate(tree, full=True)
    sync(device)
    reset_counts()
    t0 = time.perf_counter()
    after = tree_evaluate(inst, tree, REAL_SMOOTH_FACTOR)
    sync(device)
    smooth_s = time.perf_counter() - t0
    launches["tree_evaluate"] = counts = read_counts()
    check_tier(counts, "chunk", "real-size gradient tree_evaluate")
    check(counts["grad_passes"] == counts["grad_sweeps"] > 0,
          f"tree_evaluate: {counts['grad_sweeps']} sweeps, "
          f"{counts['grad_passes']} gradient passes")
    check(math.isfinite(after) and after > before,
          f"gradient tree_evaluate did not raise lnL: {before} -> {after}")
    whole_inst, whole_tree = real_instance(setup, device, "whole")
    copy_lengths(tree, whole_tree)
    reset_counts()
    whole_lnl = whole_inst.evaluate(whole_tree, full=True)
    sync(device)
    launches["whole_reevaluate"] = read_counts()
    check_tier(launches["whole_reevaluate"], "whole",
               "real-size whole re-evaluation")
    del whole_inst, whole_tree
    release_memory()
    check(abs(whole_lnl - after) <= 1e-6 * abs(after),
          f"smoothed tree re-evaluates to {whole_lnl} on the whole tier "
          f"against {after}")
    log(f"  tree_evaluate: lnL {before!r} -> {after!r} in {smooth_s:.2f} s; "
        f"{counts['grad_sweeps']} gradient sweeps, "
        f"{counts['full_traversals']} full traversals, B1 {counts['b1']} "
        f"launches for {counts['chunk_launch_rows']} launch-table rows; "
        f"whole tier re-evaluates to {whole_lnl!r}")
    return {"edges": E, "pass_ms": pass_ms, "bytes_per_pass": nbytes,
            "flops_per_pass": flops, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "achieved_tb_per_s": tb_s, "profile": profile,
            "d1_gap_f64": gap,
            "max_abs_d1": float(np.abs(d1_64).max()),
            "peak_bytes_with_f64": peak64,
            "lnl_before": before, "lnl_after": after,
            "whole_lnl": whole_lnl, "tree_evaluate_s": smooth_s,
            "sweeps": counts["grad_sweeps"], "launches_by_path": launches}


# -- phases 9 and 14: PSR, ref49 -f e through the CLI and at real size -------


class PsrClock:
    """Wall time of a PSR run's parts, taken around the functions it
    calls (each ends with a read-back, and the wrapper synchronizes): the
    engines' rate scans (one per grid chunk, with its width), branch-length
    smoothing, and the continuous category-rate refinement."""

    def __init__(self, device):
        from examl_tpu_torch.ops import engine
        from examl_tpu_torch.optimize import branch, model_opt
        self.s = {"rate_scan": 0.0, "smoothing": 0.0, "refine": 0.0}
        self.scans = []
        self._saved = []
        for obj, name, key in ((engine.LikelihoodEngine, "rate_scan",
                                "rate_scan"),
                               (branch, "smooth_tree", "smoothing"),
                               (model_opt, "refine_category_rates",
                                "refine")):
            fn = getattr(obj, name)
            self._saved.append((obj, name, fn))
            setattr(obj, name, self._timed(fn, key, device))

    def _timed(self, fn, key, device):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                sync(device)
                dt = time.perf_counter() - t
                self.s[key] += dt
                if key == "rate_scan":
                    self.scans.append((int(a[-1].shape[-1]), dt))
        return run

    def restore(self) -> None:
        for obj, name, fn in self._saved:
            setattr(obj, name, fn)


def model_file_categories(path: str) -> list:
    with open(path) as f:
        text = f.read()
    return [int(c) for c in re.findall(r"^categories: (\d+)$", text, re.M)]


def phase_ref49_psr(device, out_dir: str):
    """-m PSR -f e on ref49 through the port's CLI, f32 on the card; every
    traversal on the wave-scan tier (kernels B1 and B2 serve GAMMA)."""
    from examl_tpu_torch.instance import PhyloInstance
    from examl_tpu_torch.io.bytefile import read_bytefile
    aln = os.path.join(REF49, "aln49.binary")
    inst = PhyloInstance(read_bytefile(aln), device=device,
                         rate_model="PSR")
    with open(os.path.join(REF49, "TreeFile")) as f:
        start = inst.evaluate(inst.tree_from_newick(f.read()), full=True)
    del inst
    workdir = os.path.join(out_dir, "psr_ref49")
    clock = PsrClock(device)
    try:
        rc, wall, counts, info = run_cli(
            ["-s", aln, "-t", os.path.join(REF49, "TreeFile"), "-f", "e",
             "-m", "PSR"], device, workdir)
    finally:
        clock.restore()
    check(rc == 0, f"-m PSR -f e through the CLI returned {rc}")
    check(counts["b1"] == counts["b2"] == counts["full_traversals"] == 0,
          f"-m PSR ran a full-traversal kernel: {counts}")
    check(counts["grad_passes"] > 0, "-m PSR smoothed without gradients")
    final = float(re.search(r"Likelihood tree 0: (\S+)", info).group(1))
    floor = LNL_REF_PSR - PSR_MARGIN
    check(final >= start, f"-m PSR -f e ended at {final}, below its start "
          f"{start}")
    check(final >= floor, f"-m PSR -f e endpoint {final} below {floor}")
    cats = model_file_categories(os.path.join(workdir,
                                              "ExaML_modelFile.smoke"))
    check(len(cats) == 4 and all(1 <= c <= PSR_CATEGORIES for c in cats),
          f"ExaML_modelFile categories {cats}")
    parts = dict(clock.s)
    parts["brent_probes_and_rest"] = wall - parts["rate_scan"] \
        - parts["smoothing"]
    log(f"  -m PSR -f e (CLI, wave-scan tier, f32): start {start!r} -> "
        f"final {final!r} (floor {floor}); {wall:.1f} s: rate scans "
        f"{parts['rate_scan']:.1f} s ({len(clock.scans)} grid chunks), "
        f"smoothing {parts['smoothing']:.1f} s ({counts['grad_sweeps']} "
        f"gradient sweeps), Brent probes and the rest "
        f"{parts['brent_probes_and_rest']:.1f} s (of which the category "
        f"refinement {parts['refine']:.1f} s, its smoothing excluded); "
        f"{counts['partial_traversals']} wave-scan traversals; categories "
        f"per partition {cats}")
    return {"start_lnl": start, "final_lnl": final, "floor": floor,
            "wall_s": wall, "parts_s": parts, "rate_scan_chunks":
            len(clock.scans), "categories": cats, "launches": counts}


def phase_real_psr(device, setup: dict):
    """PSR at real size (the phase-10 data, f32, wave-scan tier): one
    gradient tree_evaluate (REAL_SMOOTH_FACTOR), then one categorization
    round.  The round runs
    on smoothed branches, as in `-f e`: from the unsmoothed random tree the
    first round's coarse rate grid loses lnL and is rejected."""
    import torch
    from examl_tpu_torch.optimize.branch import tree_evaluate
    from examl_tpu_torch.optimize.psr import optimize_rate_categories
    torch.cuda.reset_peak_memory_stats(device)
    inst, tree = real_instance(setup, device, "chunk", rate_model="PSR")
    eng = inst.engines[4]
    l0 = inst.evaluate(tree, full=True)
    sync(device)
    reset_counts()
    t0 = time.perf_counter()
    l1 = tree_evaluate(inst, tree, REAL_SMOOTH_FACTOR)
    sync(device)
    smooth_s = time.perf_counter() - t0
    smooth_counts = read_counts()
    check(smooth_counts["b1"] == smooth_counts["b2"] == 0
          and smooth_counts["grad_passes"] > 0,
          f"PSR tree_evaluate counts {smooth_counts}")
    check(math.isfinite(l1) and l1 > l0,
          f"PSR tree_evaluate did not raise lnL: {l0} -> {l1}")
    clock = PsrClock(device)
    reset_counts()
    t0 = time.perf_counter()
    try:
        l2 = optimize_rate_categories(inst, tree)
        sync(device)
    finally:
        clock.restore()
    round_s = time.perf_counter() - t0
    counts = read_counts()
    check(counts["b1"] == counts["b2"] == 0, f"PSR launched B1/B2: {counts}")
    check(math.isfinite(l2) and l2 >= l1,
          f"the categorization round lowered lnL: {l1} -> {l2}")
    num = den = 0.0
    for gid, part in enumerate(inst.alignment.partitions):
        w = np.asarray(part.weights, np.float64)
        num += float(w @ inst.per_site_rates[gid][inst.rate_category[gid]])
        den += float(w.sum())
    check(abs(num / den - 1.0) <= 1e-6, f"weighted mean site rate "
          f"{num / den}")
    cats = [len(r) for r in inst.per_site_rates]
    check(all(1 <= c <= PSR_CATEGORIES for c in cats),
          f"categories per partition {cats}")
    full_chunks = [dt for g, dt in clock.scans if g > 1]
    chunk_ms = (float(np.mean(full_chunks)) * 1e3 if full_chunks
                else float("nan"))
    peak = torch.cuda.max_memory_allocated(device)
    scan_bytes = eng.num_rows * eng.B * eng.lane * 8 * eng.K * 4
    log(f"  arena {tuple(eng.clv.shape)} ({eng.clv.numel() * 4 / 1e9:.2f} "
        f"GB), rate-scan arena for 8 rates {scan_bytes / 1e9:.2f} GB")
    log(f"  tree_evaluate by gradients: lnL "
        f"{l0!r} -> {l1!r} in {smooth_s:.2f} s, "
        f"{smooth_counts['grad_sweeps']} sweeps")
    log(f"  categorization round: lnL {l1!r} -> {l2!r} "
        f"({'accepted' if l2 > l1 else 'rejected'}) in {round_s:.2f} s, "
        f"{len(clock.scans)} rate scans (grid widths "
        f"{[g for g, _ in clock.scans]}), {chunk_ms:.1f} ms per grid chunk "
        f"of 8, scans {clock.s['rate_scan']:.2f} s; categories {cats}; "
        f"weighted mean rate {num / den!r}; peak device memory "
        f"{peak / 1e9:.2f} GB")
    del inst, tree
    release_memory()
    return {"lnl_start": l0, "lnl_after_smooth": l1, "lnl_after_round": l2,
            "round_accepted": l2 > l1, "round_s": round_s,
            "rate_scans": clock.scans, "rate_scan_s": clock.s["rate_scan"],
            "ms_per_grid_chunk": chunk_ms, "grid_chunks": len(full_chunks),
            "categories": cats, "mean_rate": num / den,
            "tree_evaluate_s": smooth_s,
            "sweeps": smooth_counts["grad_sweeps"], "peak_bytes": peak,
            "launches": {"tree_evaluate": smooth_counts, "round": counts}}

# -- phases 15 and 16: amino-acid and binary data ----------------------------


def state_columns(ntaxa: int, width: int, rng, states: int,
                  flip: float = 0.15) -> np.ndarray:
    """[ntaxa, width] state indices of correlated random columns: a shared
    walk over the taxa, each taxon changing a `flip` share of its
    predecessor's states."""
    out = np.empty((ntaxa, width), np.int64)
    cur = rng.integers(0, states, width)
    for t in range(ntaxa):
        change = rng.random(width) < flip
        cur = np.where(change, rng.integers(0, states, width), cur)
        out[t] = cur
    return out


def write_phylip(path: str, names, letters: str, cols: np.ndarray) -> None:
    table = np.frombuffer(letters.encode(), np.uint8)
    with open(path, "w") as f:
        f.write(f"{len(names)} {cols.shape[1]}\n")
        for name, row in zip(names, cols):
            f.write(f"{name} {table[row].tobytes().decode()}\n")


def phase_aa_cli(device, out_dir: str, seed: int):
    """-f e through the port's CLI on amino-acid and binary data, chunk
    tier, f32: AA_TAXA taxa, five amino-acid partitions of AA_CLI_WIDTH
    columns (WAG, LG+F, LG4M, LG4X, AUTO under --auto-prot ml) parsed by
    `cli.parse -m PROT` with a partition file, and one binary partition of
    BIN_CLI_WIDTH columns parsed by `cli.parse -m BIN`, merged into one
    byteFile.  The endpoint is re-evaluated on the whole tier from the
    run's last checkpoint."""
    from examl_tpu_torch.cli import parse
    from examl_tpu_torch.instance import PhyloInstance
    from examl_tpu_torch.io.alignment import AlignmentData
    from examl_tpu_torch.io.bytefile import read_bytefile, write_bytefile
    from examl_tpu_torch.search.checkpoint import CheckpointManager
    from examl_tpu_torch.tree.topology import Tree
    workdir = os.path.join(out_dir, "fe_aa")
    os.makedirs(workdir, exist_ok=True)

    def path(name):
        return os.path.join(workdir, name)

    rng = np.random.default_rng(seed + 3)
    names = [f"t{i}" for i in range(AA_TAXA)]
    models = ["WAG", "LGF", "LG4M", "LG4X", "AUTO"]
    write_phylip(path("aa.phy"), names, AA_LETTERS, state_columns(
        AA_TAXA, len(models) * AA_CLI_WIDTH, rng, 20))
    write_phylip(path("bin.phy"), names, "01", state_columns(
        AA_TAXA, BIN_CLI_WIDTH, rng, 2))
    with open(path("aa.model"), "w") as f:
        for i, m in enumerate(models):
            f.write(f"{m}, p_{m.lower()} = {i * AA_CLI_WIDTH + 1}-"
                    f"{(i + 1) * AA_CLI_WIDTH}\n")
    for argv in (["-s", path("aa.phy"), "-m", "PROT", "-q", path("aa.model"),
                  "-n", path("aa")],
                 ["-s", path("bin.phy"), "-m", "BIN", "-n", path("bin")]):
        rc = parse.main(argv)
        check(rc == 0, f"cli.parse {argv} returned {rc}")
    ad = read_bytefile(path("aa.binary"))
    bd = read_bytefile(path("bin.binary"))
    aln = path("aa_bin.binary")
    write_bytefile(aln, AlignmentData(ad.taxon_names,
                                      ad.partitions + bd.partitions))
    start_tree = path("start.nwk")
    with open(start_tree, "w") as f:
        f.write(Tree.random(names, seed, 1).to_newick(names) + "\n")
    inst = PhyloInstance(read_bytefile(aln), device=device)
    check(sorted(inst.engines) == [2, 20], f"buckets {sorted(inst.engines)}")
    with open(start_tree) as f:
        start = inst.evaluate(inst.tree_from_newick(f.read()), full=True)
    del inst
    rc, wall, counts, info = run_cli(
        ["-s", aln, "-t", start_tree, "-f", "e", "--auto-prot", "ml"],
        device, workdir)
    check(rc == 0, f"AA + BIN -f e through the CLI returned {rc}")
    check_tier(counts, "chunk", "AA + BIN -f e CLI")
    for K in (20, 2):
        check(counts["b1_by_K"].get(K, 0) > 0,
              f"AA + BIN -f e: no B1 launch at K = {K} ({counts})")
    final = float(re.search(r"Likelihood tree 0: (\S+)", info).group(1))
    check(final >= start, f"AA + BIN -f e ended at {final}, below its "
          f"start {start}")
    # The endpoint on the whole tier, from the run's last checkpoint.
    inst = PhyloInstance(read_bytefile(aln), device=device, newview="whole")
    with open(start_tree) as f:
        tree = inst.tree_from_newick(f.read())
    check(CheckpointManager(workdir, "smoke").restore(inst, tree)
          is not None, "AA + BIN -f e left no checkpoint")
    reset_counts()
    whole = inst.evaluate(tree, full=True)
    sync(device)
    whole_counts = read_counts()
    check_tier(whole_counts, "whole", "AA + BIN re-evaluation")
    for K in (20, 2):
        check(whole_counts["b2_by_K"].get(K, 0) > 0,
              f"AA + BIN re-evaluation: no B2 launch at K = {K}")
    check(abs(whole - final) <= 1e-6 * abs(final),
          f"AA + BIN endpoint re-evaluates to {whole} on the whole tier "
          f"against {final}")
    gid = models.index("AUTO")
    chosen, freqs = inst.auto_prot_models[gid], inst.auto_prot_freqs[gid]
    lg4x = inst.models[models.index("LG4X")]
    rates = [float(r) for r in lg4x.gamma_rates]
    weights = [float(w) for w in lg4x.rate_weights]
    del inst, tree
    with open(path("ExaML_modelFile.smoke")) as f:
        text = f.read()
    printed = re.findall(r"Substitution Matrix: (\S+)", text)
    check(printed == ["WAG", "LG", "LG4M", "LG4X", chosen],
          f"model file names {printed}, AUTO chose {chosen}")
    check("LG4X category rates:" in text
          and "LG4X category weights:" in text,
          "the model file lacks LG4X's rates and weights")
    log(f"  {AA_TAXA} taxa, 5 x {AA_CLI_WIDTH} AA + {BIN_CLI_WIDTH} binary "
        f"columns: lnL {start!r} -> {final!r} in {wall:.1f} s; whole tier "
        f"re-evaluates to {whole!r}")
    log(f"  AUTO chose {chosen} ({freqs} frequencies); LG4X category rates "
        f"{[round(r, 6) for r in rates]}, weights "
        f"{[round(w, 6) for w in weights]}")
    log(f"  {counts['full_traversals']} full traversals, "
        f"{counts['grad_sweeps']} gradient sweeps; B1 launches by K "
        f"{counts['b1_by_K']} for {counts['chunk_launch_rows']} launch-table "
        f"rows; the re-evaluation's B2 launches by K "
        f"{whole_counts['b2_by_K']}")
    return {"taxa": AA_TAXA, "aa_width": AA_CLI_WIDTH,
            "bin_width": BIN_CLI_WIDTH, "start_lnl": start,
            "final_lnl": final, "whole_lnl": whole, "wall_s": wall,
            "auto_choice": chosen, "auto_freqs": freqs,
            "lg4x_rates": rates, "lg4x_weights": weights,
            "launches": counts, "whole_launches": whole_counts}


def aa_setup(seed: int) -> dict:
    """The real-size amino-acid instance's inputs: AA_REAL_TAXA taxa, four
    amino-acid partitions of AA_REAL_WIDTH patterns (WAG, LG, LG4M, LG4X)
    and one binary partition of BIN_REAL_WIDTH patterns, correlated random
    columns from the seed; alphas, LG4X's rates and weights, and branch
    lengths from the seed too."""
    from examl_tpu_torch import datatypes
    from examl_tpu_torch.io.alignment import (AlignmentData, PartitionData,
                                              compress_patterns,
                                              empirical_frequencies)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 5)
    parts = []
    specs = [(m, datatypes.AA, AA_REAL_WIDTH) for m in AA_REAL_MODELS]
    specs.append(("BIN", datatypes.BINARY, BIN_REAL_WIDTH))
    for m, dt, width in specs:
        cols = state_columns(AA_REAL_TAXA, width, rng, dt.states)
        codes = (cols if dt is datatypes.AA else cols + 1).astype(np.uint8)
        pats, wts = compress_patterns(codes)
        parts.append(PartitionData(
            name=f"p_{m.lower()}", datatype=dt,
            model_name="GTR" if dt is datatypes.BINARY else m,
            patterns=pats, weights=wts,
            empirical_freqs=empirical_frequencies(pats, wts, dt),
            use_empirical_freqs=dt is datatypes.BINARY,
            optimize_freqs=False, lg4=m.startswith("LG4")))
    ad = AlignmentData([f"t{i}" for i in range(AA_REAL_TAXA)], parts)
    alphas = rng.uniform(0.3, 1.5, len(parts))
    zs = np.exp(-rng.exponential(0.08, 2 * AA_REAL_TAXA - 3))
    return {"ad": ad, "alphas": alphas, "zs": zs, "seed": seed,
            "ntaxa": AA_REAL_TAXA, "parts": len(parts),
            "patterns": int(sum(p.width for p in parts)),
            "alignment_s": time.perf_counter() - t0}


def aa_instance(setup: dict, device, newview: str, clv_dtype=None,
                sharding=None):
    """The real-size amino-acid + binary instance on one tier (f32, CLVs
    stored in `clv_dtype`; on one card or over `sharding`'s site shards)
    with the set-up's models and the seed's random tree."""
    from examl_tpu_torch.instance import PhyloInstance
    from examl_tpu_torch.models.gtr import with_alpha
    from examl_tpu_torch.models.lg4 import (LG4Params, lg4_with_alpha,
                                            lg4x_with_rates,
                                            lg4x_with_weights)
    import torch
    inst = PhyloInstance(setup["ad"], dtype=torch.float32, device=device,
                         newview=newview, clv_dtype=clv_dtype,
                         sharding=sharding)
    for gid, a in enumerate(setup["alphas"]):
        m = inst.models[gid]
        if isinstance(m, LG4Params):
            m = lg4_with_alpha(m, float(a))
            if m.is_lg4x:
                m = lg4x_with_weights(m, np.array([0.15, 0.35, 0.3, 0.2]))
                m = lg4x_with_rates(m, np.array([0.1, 0.5, 1.2, 2.8]))
        else:
            m = with_alpha(m, float(a))
        inst.models[gid] = m
    inst.push_models()
    tree = inst.random_tree(setup["seed"])
    for (p, _), z in zip(tree.all_branches(), setup["zs"]):
        p.z[:] = [float(z)]
    return inst, tree


def time_kernels(inst, tree, setup, device, tier: str, reps: int) -> dict:
    """Per engine (state count K) of a real-size instance: the tier's
    kernel on one full traversal, P prebuilt, through the entry point the
    engine calls (which builds the tip operand, timed also on its own),
    against its plain version on the same inputs (scalers equal, rows
    within the f32 tolerance of each site's max) and the traversal's
    bound."""
    import torch
    from examl_tpu_torch.ops import fastpath, newview_chunk, newview_whole
    flat = tree.flat_full_traversal(tree.centroid_branch())
    out = {}
    for K, eng in sorted(inst.engines.items()):
        st = eng._structure(flat)
        if tier == "chunk":
            zl, zr = fastpath.refresh_z(st, flat, 1, eng.dtype, device)
            pmat = newview_chunk.chunk_operands(eng.models, zl, zr)
            args = (eng.tips.codes, eng.tips.table, eng.block_part_i32,
                    st.launch, st.lidx, st.ridx, st.lcode, st.rcode, pmat,
                    eng.scale_exp)
            flow = newview_chunk.Dataflow(st.flow_rows, st.wait,
                                          newview_chunk.Ready())
            kernel, plain, tip = (
                lambda c, sc, *a: newview_chunk.chunk_apply(c, sc, *a, flow),
                newview_chunk.chunk_apply_plain, newview_chunk.tip_products)
            rows = torch.as_tensor(np.sort(st.row_of[st.row_of >= 0]),
                                   device=device)
        else:
            zl, zr = newview_whole.refresh_z(st, flat, 1)
            pmat = newview_whole.whole_operands(eng.models, zl, zr,
                                                eng.dtype, device)
            args = (eng.tips.codes, eng.tips.table, eng.block_part_i32,
                    st.meta, st.l_code, st.r_code, st.wave_start, pmat,
                    eng.scale_exp)
            kernel, plain, tip = (newview_whole.whole_apply,
                                  newview_whole.whole_apply_plain,
                                  newview_whole.tip_operand)
            rows = torch.arange(flat.n, device=device)
        clv_k = torch.zeros_like(eng.clv)
        sc_k = torch.zeros_like(eng.scaler)
        # One traversal's launches: the kernel's count around one call.
        counter = newview_chunk if tier == "chunk" else newview_whole
        n0 = counter.LAUNCHES
        kernel(clv_k, sc_k, *args)
        sync(device)
        per = counter.LAUNCHES - n0
        expect = (b1_per_table(eng, int(st.launch.shape[0]))
                  if tier == "chunk" else 1)
        check(per == expect, f"{tier} K={K}: {per} launches for one "
              f"traversal, expected {expect}")
        kernel_ms = time_ms(lambda: kernel(clv_k, sc_k, *args), device, reps)
        host = host_and_card_ms(lambda: kernel(clv_k, sc_k, *args), device,
                                reps)
        tip_ms = (time_ms(lambda: tip(pmat, eng.tips.table), device, reps)
                  if tier == "chunk" or eng.K >= 16 else None)
        clv_p = torch.zeros_like(eng.clv)
        sc_p = torch.zeros_like(eng.scaler)
        plain_ms = time_ms(lambda: plain(clv_p, sc_p, *args), device,
                           max(1, reps // 2))
        rel, abs_err, ndiff = compare_arenas(
            clv_k[rows], clv_p[rows], sc_k[rows], sc_p[rows],
            f"{tier} K={K} {str(eng.clv.dtype)[6:]} real size")
        patterns = int(sum(setup["ad"].partitions[g].width
                           for g in eng.bucket.part_ids))
        breakdown = turns = None
        if tier == "chunk":
            breakdown = launch_breakdown(
                st.launch, (args[0], tip(pmat, eng.tips.table)) + args[2:],
                clv_k, sc_k, patterns, eng, device, reps)
            turns = route_turns(eng.clv, eng.scaler, args, flow, device,
                                reps)
            check(turns["bitwise_equal"], f"K={K}: the dataflow route's "
                  "rows differ from the per-chunk route's")
        del clv_k, sc_k, clv_p, sc_p, pmat
        release_memory()
        bound = traversal_bound(flat, setup, eng, patterns)
        out[K] = {"patterns": patterns, "kernel_ms": kernel_ms,
                  "tip_products_ms": tip_ms, "host_vs_card": host,
                  "plain_ms": plain_ms, "max_rel_err": rel,
                  "max_abs_err": abs_err, "differing_cells": ndiff,
                  "launches_per_traversal": per, "arena_bytes":
                  eng.clv.numel() * eng.clv.element_size(), **bound,
                  "achieved_tb_per_s": bound["bytes_per_traversal"]
                  / (kernel_ms / 1e3) / 1e12,
                  "achieved_tflop_per_s": bound["flops_per_traversal"]
                  / (kernel_ms / 1e3) / 1e12}
        if tier == "chunk":
            out[K]["table_rows"] = int(st.launch.shape[0])
            out[K]["launch_breakdown"] = breakdown
            out[K]["route_turns"] = turns
        else:
            out[K]["grid_blocks"] = newview_whole.LAST_GRID
        log(f"  {tier} K={K:2d}: {patterns} patterns, arena "
            f"{out[K]['arena_bytes'] / 1e9:.2f} GB; kernel {kernel_ms:.3f} "
            f"ms per traversal (tip products "
            f"{'none' if tip_ms is None else f'{tip_ms:.3f} ms'} of it), "
            f"plain {plain_ms:.3f} ms, bound "
            f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}: "
            f"{bound['bytes_per_traversal'] / 1e9:.2f} GB, "
            f"{bound['flops_per_traversal'] / 1e12:.2f} TFLOP), "
            f"{bound['bound_ms'] / kernel_ms:.2f} of it; "
            f"{out[K]['achieved_tb_per_s']:.3f} TB/s, "
            f"{out[K]['achieved_tflop_per_s']:.2f} TFLOP/s; kernel vs plain "
            f"rel err {rel:.3e} ({ndiff} cells differ), scalers equal")
        log(f"    host {host['host_ms']:.3f} ms a call against "
            f"{host['event_ms']:.3f} ms on the card"
            + ("" if turns is None else
               f"; {out[K]['launches_per_traversal']} launch(es) for "
               f"{out[K]['table_rows']} table rows; routes in turns: per "
               f"chunk {turns['chunks_ms']:.3f} ms, dataflow "
               f"{turns['flow_ms']:.3f} ms, rows bitwise equal"))
        for row in breakdown or ():
            log(f"    B1 K={K:2d} {row['class']:>13s}: {row['rows']:3d} "
                f"rows, {row['bytes'] / 1e9:5.2f} GB, {row['ms']:.3f} ms as "
                f"a table of their own ({row['tb_per_s']:.3f} TB/s, "
                f"{row['tflop_per_s']:.2f} TFLOP/s)")
    return out


def phase_real_aa(device, seed: int, reps: int):
    """Amino-acid and binary data at real size, f32, on both tiers:
    evaluate (lnL, ms, site-CLV updates/s), each engine's kernel against
    its plain version and its bound, one whole-tree gradient pass (ms and
    peak memory), chunk against whole lnL, and one model-optimization
    pass (opt_alphas + opt_lg4x) on the whole tier with its ms per Brent
    probe."""
    import torch
    from examl_tpu_torch.optimize.model_opt import opt_alphas, opt_lg4x
    from examl_tpu_torch.utils import z_slots
    setup = aa_setup(seed)
    want = len(AA_REAL_MODELS) * AA_REAL_WIDTH + BIN_REAL_WIDTH
    check(setup["patterns"] == want, f"the real-size AA alignment "
          f"compressed to {setup['patterns']} patterns, not {want}")
    out = {"setup_s": setup["alignment_s"], "taxa": setup["ntaxa"],
           "patterns": setup["patterns"], "launches_by_path": {}}
    paths = out["launches_by_path"]
    for tier in ("chunk", "whole"):
        inst, tree = aa_instance(setup, device, tier)
        if tier == "chunk":
            log(f"  {setup['ntaxa']} taxa x {setup['patterns']} patterns "
                f"({len(AA_REAL_MODELS)} x {AA_REAL_WIDTH} amino-acid: "
                f"{', '.join(AA_REAL_MODELS)}; {BIN_REAL_WIDTH} binary); "
                f"set-up {setup['alignment_s']:.1f} s")
        reset_counts()
        lnl, walls = timed_evaluates(inst, tree, device, reps)
        paths[f"{tier}_evaluate"] = counts = read_counts()
        check_tier(counts, tier, f"real-size AA {tier} evaluate")
        key = "b1_by_K" if tier == "chunk" else "b2_by_K"
        check(all(counts[key].get(K, 0) > 0 for K in (20, 2)),
              f"real-size AA {tier} evaluate launches by K {counts[key]}")
        eval_ms = float(np.mean(walls) * 1e3)
        flat = tree.flat_full_traversal(tree.centroid_branch())
        updates = sum(flat.n * int(sum(setup["ad"].partitions[g].width
                                       for g in e.bucket.part_ids))
                      * e.R * e.K for e in inst.engines.values())
        out[tier] = {"lnl": lnl, "evaluate_ms": eval_ms,
                     "evaluate_ms_runs": [w * 1e3 for w in walls],
                     "site_clv_updates_per_s": updates / (eval_ms / 1e3)}
        log(f"  {tier}: lnL {lnl!r}; evaluate {eval_ms:.2f} ms per full "
            f"traversal ({out[tier]['site_clv_updates_per_s']:.3e} site-CLV "
            f"updates/s); launches by K {counts[key]}")
        out[tier]["profile"] = profile = device_breakdown(
            lambda: inst.evaluate(tree, full=True), device)
        log_profile(profile, "B1" if tier == "chunk" else "B2")
        out[tier]["kernels"] = time_kernels(inst, tree, setup, device, tier,
                                            reps)
        if tier == "chunk":
            # One whole-tree gradient pass on the amino-acid engine.
            eng = inst.engines[20]
            p = tree.centroid_branch()
            flat = tree.flat_full_traversal(p)
            torch.cuda.reset_peak_memory_stats(device)
            eng.run_traversal(flat, full=True)
            d1, d2 = eng.whole_tree_gradients(flat, z_slots(p.z, 1))
            check(bool(np.isfinite(d1).all() and np.isfinite(d2).all()),
                  "real-size AA gradients are not finite")
            grad_ms = time_ms(lambda: eng.whole_tree_gradients(
                flat, z_slots(p.z, 1)), device, 2)
            peak = torch.cuda.max_memory_allocated(device)
            out["gradient_pass_ms"] = grad_ms
            out["gradient_peak_bytes"] = peak
            log(f"  whole-tree gradient pass (K = 20, {flat.n} entries, "
                f"{2 * flat.n + 1} edges): {grad_ms:.1f} ms; peak device "
                f"memory {peak / 1e9:.2f} GB (outroot arena "
                f"{eng._outroot_arena().numel() * 4 / 1e9:.2f} GB)")
            chunk_lnl = lnl
        else:
            check(abs(lnl - chunk_lnl) <= 1e-6 * abs(chunk_lnl),
                  f"real-size AA whole-tier lnL {lnl} vs chunk {chunk_lnl}")
            out["chunk_whole_rel_diff"] = (lnl - chunk_lnl) / abs(chunk_lnl)
            before = inst.evaluate(tree, full=True)
            reset_counts()
            t0 = time.perf_counter()
            opt_alphas(inst, tree)
            opt_lg4x(inst, tree)
            sync(device)
            opt_s = time.perf_counter() - t0
            paths["opt_alphas_lg4x"] = counts = read_counts()
            check_tier(counts, "whole", "real-size AA opt_alphas + opt_lg4x")
            after = inst.likelihood
            check(after >= before - 1e-6 * abs(before),
                  f"opt_alphas + opt_lg4x lowered lnL: {before} -> {after}")
            probes = counts["full_traversals"]
            out["opt"] = {"lnl_before": before, "lnl_after": after,
                          "s": opt_s, "full_traversals": probes,
                          "ms_per_probe": opt_s * 1e3 / probes}
            log(f"  opt_alphas + opt_lg4x: lnL {before!r} -> {after!r} in "
                f"{opt_s:.2f} s, {probes} full traversals "
                f"({opt_s * 1e3 / probes:.2f} ms per Brent probe; B2 by K "
                f"{counts['b2_by_K']})")
        del inst, tree
        release_memory()
    log(f"  chunk vs whole lnL rel diff {out['chunk_whole_rel_diff']:.2e}")
    return out


# -- phase 11: the SPR scan at real size ------------------------------------


def phase_spr_scan(device, inst, tree):
    """The search's innermost step at real size, on both routes over the
    same pruned slots: the first SCAN_SLOTS inner slots of the SPR slot
    order that have subtrees to prune, lazy (radius 1-5), then one slot
    thorough, each by the sequential arm (`spr.rearrange`) and by the
    batched one (`spr.rearrange_batched`), with end_lh at +inf so that no
    move commits and the cutoff off so that both scan the same window.
    Both routes are warmed up on one pruned node first.  Every
    candidate's batched lnL is held against its sequential one (rel
    SCAN_RTOL), and each slot's best move must be the same on both routes
    (or, where they differ, tie within SCAN_RTOL in the sequential
    scores); the tree and its lnL must come back unchanged."""
    from examl_tpu_torch.ops import engine
    from examl_tpu_torch.search import batchscan, snapshots, spr
    lnl0 = inst.evaluate(tree, full=True)
    sync(device)
    before = snapshots.TreeSnapshot.capture(tree, lnl0)

    def deep(p) -> bool:
        return not tree.is_tip(p.number) and not (
            tree.is_tip(p.next.back.number)
            and tree.is_tip(p.next.next.back.number))

    slots = [p for p in spr.dfs_slot_order(tree) if deep(p)][:SCAN_SLOTS + 1]
    check(len(slots) == SCAN_SLOTS + 1, "too few inner slots to scan")
    # Entries of the partial traversals (wave-scan tier), counted around
    # the engine's own methods, and each candidate's lnL by (subtree root,
    # insertion slot), recorded around the two arms' scoring functions
    # (test_insert leaves the candidate's lnL in inst.likelihood).
    entries = [0]
    scores = {}
    run_scan = engine.LikelihoodEngine._run_scan
    scan_setup = engine.LikelihoodEngine._scan_setup
    test_insert = spr.test_insert
    run_plan, run_thorough = batchscan.run_plan, batchscan.run_plan_thorough

    def counted(self, ents):
        entries[0] += len(ents)
        return run_scan(self, ents)

    def counted_setup(self, plan):
        entries[0] += len(plan.down_entries) + len(plan.up_entries)
        return scan_setup(self, plan)

    def recorded_insert(inst_, tree_, ctx, p, q):
        out = test_insert(inst_, tree_, ctx, p, q)
        scores[(p.back.number, id(q))] = inst_.likelihood
        return out

    def record_plan(plan, lnls):
        for c, lnl in zip(plan.candidates, lnls):
            scores[(plan.s_num, id(c.q_slot))] = float(lnl)

    def recorded_plan(inst_, tree_, plan):
        lnls = run_plan(inst_, tree_, plan)
        record_plan(plan, lnls)
        return lnls

    def recorded_thorough(inst_, tree_, plan):
        lnls, es = run_thorough(inst_, tree_, plan)
        record_plan(plan, lnls)
        return lnls, es

    def scan(ps, thorough: bool, batched: bool) -> dict:
        ctx = spr.SprContext(inst, thorough=thorough, do_cutoff=False)
        ctx.start_lh = ctx.end_lh = math.inf
        scores.clear()
        reset_counts()
        entries[0] = 0
        best = []
        t0 = time.perf_counter()
        for p in ps:
            ctx.best_of_node = -math.inf
            if batched:
                spr.rearrange_batched(inst, tree, ctx, p, 1, 5,
                                      thorough=thorough)
            else:
                spr.rearrange(inst, tree, ctx, p, 1, 5)
            best.append((ctx.remove_node.back.number,
                         id(ctx.insert_node)))
        sync(device)
        wall = time.perf_counter() - t0
        counts = read_counts()
        n = counts["insertions_scored"]
        check(n > 0, "the scan scored no insertion")
        check(ctx.remove_node is not None and math.isfinite(ctx.best_of_node),
              "the scan recorded no best move")
        check(len(scores) == n, f"{n} insertions scored, {len(scores)} "
              "recorded")
        check((counts["scan_calls"] > 0) == batched,
              f"{counts['scan_calls']} batched scan calls")
        return {"slots": len(ps), "wall_s": wall, "insertions_scored": n,
                "ms_per_insertion": wall * 1e3 / n,
                "ms_per_pruned_node": wall * 1e3 / len(ps),
                "scan_calls": counts["scan_calls"],
                "partial_traversals": counts["partial_traversals"],
                "entries": entries[0], "entries_per_insertion":
                entries[0] / n, "best_of_node": ctx.best_of_node,
                "launches": counts, "scores": dict(scores), "best": best}

    def compare(seq: dict, bat: dict, name: str) -> float:
        s, b = seq.pop("scores"), bat.pop("scores")
        check(set(s) == set(b), f"{name}: the routes scored different "
              f"windows ({len(s)} and {len(b)} candidates)")
        rel = max(abs(b[k] - s[k]) / abs(s[k]) for k in s)
        check(rel <= SCAN_RTOL, f"{name}: batched and sequential lnLs differ "
              f"by rel {rel:.3g} (> {SCAN_RTOL})")
        check(abs(bat["best_of_node"] - seq["best_of_node"])
              <= SCAN_RTOL * abs(seq["best_of_node"]),
              f"{name}: best_of_node {bat['best_of_node']} batched, "
              f"{seq['best_of_node']} sequential")
        same = 0
        for ks, kb in zip(seq.pop("best"), bat.pop("best")):
            same += ks == kb
            check(ks == kb or abs(s[kb] - s[ks]) <= SCAN_RTOL * abs(s[ks]),
                  f"{name}: the batched route's best move (subtree "
                  f"{kb[0]}) has the sequential lnL {s[kb]!r}, the "
                  f"sequential best (subtree {ks[0]}) {s[ks]!r}")
        bat["same_best_move"] = seq["same_best_move"] = same
        return rel

    # One untimed lazy pruned node on each route first: the batched route's
    # first call grows the arena by its scan region and meets cold code
    # paths, which the timed slots should not carry.
    for fn in (spr.rearrange, spr.rearrange_batched):
        ctx = spr.SprContext(inst, thorough=False, do_cutoff=False)
        ctx.start_lh = ctx.end_lh = math.inf
        fn(inst, tree, ctx, slots[0], 1, 5)
    sync(device)
    engine.LikelihoodEngine._run_scan = counted
    engine.LikelihoodEngine._scan_setup = counted_setup
    spr.test_insert = recorded_insert
    batchscan.run_plan = recorded_plan
    batchscan.run_plan_thorough = recorded_thorough
    try:
        routes = {}
        for arm, ps in (("lazy", slots[:SCAN_SLOTS]),
                        ("thorough", slots[SCAN_SLOTS:])):
            seq = scan(ps, arm == "thorough", batched=False)
            bat = scan(ps, arm == "thorough", batched=True)
            rel = compare(seq, bat, arm)
            routes[arm] = {"sequential": seq, "batched": bat,
                           "max_rel_diff": rel,
                           "speedup_per_insertion":
                           seq["ms_per_insertion"] / bat["ms_per_insertion"]}
    finally:
        engine.LikelihoodEngine._run_scan = run_scan
        engine.LikelihoodEngine._scan_setup = scan_setup
        spr.test_insert = test_insert
        batchscan.run_plan, batchscan.run_plan_thorough = (run_plan,
                                                           run_thorough)
    # One pruned node profiled on each lazy route (radius 1-5), and the
    # thorough slot on the batched route at radius 1-1, one chunk of
    # candidates (at 1-5 its ~10^5 device ops take the profiler over a
    # minute to sum up).
    profiles = {}
    for route, fn, thorough, p, maxtrav in (
            ("sequential", spr.rearrange, False, slots[0], 5),
            ("batched", spr.rearrange_batched, False, slots[0], 5),
            ("batched thorough, radius 1-1", spr.rearrange_batched, True,
             slots[SCAN_SLOTS], 1)):
        ctx = spr.SprContext(inst, thorough=thorough, do_cutoff=False)
        ctx.start_lh = ctx.end_lh = math.inf
        kw = {"thorough": True} if thorough else {}
        n0 = spr.INSERTIONS_SCORED
        profiles[route] = device_breakdown(
            lambda: fn(inst, tree, ctx, p, 1, maxtrav, **kw), device)
        profiles[route]["insertions"] = spr.INSERTIONS_SCORED - n0
    after = snapshots.TreeSnapshot.capture(tree, lnl0)
    check(after.key == before.key, "the scan changed the topology")
    za = {tuple(sorted((u, v))): z for u, v, z in before.edges}
    zb = {tuple(sorted((u, v))): z for u, v, z in after.edges}
    check(za == zb, "the scan changed branch lengths")
    reset_counts()
    lnl1 = inst.evaluate(tree, full=True)
    sync(device)
    final_counts = read_counts()
    check(abs(lnl1 - lnl0) <= 1e-9 * abs(lnl0),
          f"lnL after the scan {lnl1} vs before {lnl0}")
    for arm, r in routes.items():
        for route in ("sequential", "batched"):
            x = r[route]
            check(x["launches"]["b1"] == x["launches"]["b2"] == 0,
                  f"{arm} {route} scan launched a full-traversal kernel")
            log(f"  {arm} {route}: {x['slots']} pruned slot(s), "
                f"{x['insertions_scored']} insertions scored in "
                f"{x['wall_s']:.2f} s ({x['ms_per_pruned_node']:.2f} ms per "
                f"pruned node, {x['ms_per_insertion']:.3f} ms per "
                f"insertion); {x['partial_traversals']} partial "
                f"traversals, {x['entries_per_insertion']:.2f} entries per "
                "insertion")
        log(f"  {arm}: batched {r['speedup_per_insertion']:.2f}x the "
            "sequential rate per insertion; largest rel lnL difference "
            f"{r['max_rel_diff']:.3g}; the same best move on "
            f"{r['batched']['same_best_move']} of {r['batched']['slots']} "
            "slot(s)")
    log(f"  tree and lnL unchanged ({lnl0!r} -> {lnl1!r})")
    for route, profile in profiles.items():
        if profile["measured"]:
            log(f"  profiled pruned node, {route}: "
                f"{profile['insertions']} insertions, wall "
                f"{profile['wall_ms']:.1f} ms, device busy "
                f"{profile['busy_ms']:.1f} ms (idle share "
                f"{profile['idle_share']:.3f}) in {profile['launches']} "
                "device ops")
            for r in profile["top"]:
                log(f"    {r['ms']:9.3f} ms  {r['calls']:5d}x  {r['name']}")
        else:
            log(f"  profiled pruned node, {route}: not measured "
                f"({profile['error']})")
    return {"lnl_before": lnl0, "lnl_after": lnl1, **routes,
            "profile": profiles, "evaluate_launches": final_counts}


def phase_real_whole(device, setup: dict, reps: int, chunk_lnl: float):
    """The whole tier at real size: evaluate against the chunk tier's lnL,
    kernel B2 against its plain version, one opt_rates + opt_alphas pass."""
    import torch
    from examl_tpu_torch.ops import newview_whole
    from examl_tpu_torch.optimize.model_opt import opt_alphas, opt_rates
    inst, tree = real_instance(setup, device, "whole")
    eng = inst.engines[4]
    launches = {}
    reset_counts()
    lnl, walls = timed_evaluates(inst, tree, device, reps)
    launches["evaluate"] = read_counts()
    check_tier(launches["evaluate"], "whole", "real-size whole evaluate")
    check(abs(lnl - chunk_lnl) <= 1e-6 * abs(chunk_lnl),
          f"whole-tier lnL {lnl} vs chunk-tier {chunk_lnl}")
    eval_ms = float(np.mean(walls) * 1e3)
    log(f"  lnL {lnl!r} (chunk tier {chunk_lnl!r}, rel diff "
        f"{(lnl - chunk_lnl) / abs(chunk_lnl):.2e}); evaluate "
        f"{eval_ms:.2f} ms/full traversal; launches {launches['evaluate']}")

    # Kernel B2 alone per traversal against the plain version, operands
    # prebuilt, same inputs (after the count was read).
    flat = tree.flat_full_traversal(tree.centroid_branch())
    st = eng._structure(flat)
    zl, zr = newview_whole.refresh_z(st, flat, 1)
    pmat = newview_whole.whole_operands(eng.models, zl, zr, eng.dtype, device)
    args = (eng.tips.codes, eng.tips.table, eng.block_part_i32, st.meta,
            st.l_code, st.r_code, st.wave_start, pmat, eng.scale_exp)
    clv_k = torch.zeros_like(eng.clv)
    sc_k = torch.zeros_like(eng.scaler)
    n0 = newview_whole.LAUNCHES
    newview_whole.whole_apply(clv_k, sc_k, *args)
    sync(device)
    per = newview_whole.LAUNCHES - n0
    check(per == 1, f"B2 launched {per} times for one traversal")
    kernel_ms = time_ms(lambda: newview_whole.whole_apply(
        clv_k, sc_k, *args), device, reps)
    clv_p = torch.zeros_like(eng.clv)
    sc_p = torch.zeros_like(eng.scaler)
    plain_ms = time_ms(lambda: newview_whole.whole_apply_plain(
        clv_p, sc_p, *args), device, max(1, reps // 2))
    n = flat.n
    rel, abs_err, _ = compare_arenas(clv_k[:n], clv_p[:n], sc_k[:n],
                                     sc_p[:n], "whole full traversal")
    # B2's cooperative launch alone under the profiler, beside the
    # evaluate's: whether the trace holds B2 at all (its time is the CUDA
    # events' kernel_ms either way).
    b2_probe = device_breakdown(
        lambda: newview_whole.whole_apply(clv_k, sc_k, *args), device)
    del clv_k, sc_k, clv_p, sc_p
    profile = device_breakdown(lambda: inst.evaluate(tree, full=True),
                               device)
    bound = traversal_bound(flat, setup, eng)
    log(f"  B2 {kernel_ms:.3f} ms (grid {newview_whole.LAST_GRID} blocks, "
        f"{int(st.wave_start.shape[0]) - 1} waves), plain {plain_ms:.3f} "
        f"ms, bound {bound['bound_ms']:.3f} ms ({bound['bound_by']}); "
        f"kernel vs plain rel err {rel:.3e}, scalers equal")
    log_profile(profile, "B2")
    if b2_probe["measured"]:
        log(f"  profiled B2 launch alone: {b2_probe['b2_launches']} launched, "
            f"{b2_probe['b2_ms']:.3f} ms of B2 in the trace, device busy "
            f"{b2_probe['busy_ms']:.3f} ms in {b2_probe['launches']} device "
            f"ops")
    else:
        log(f"  profiled B2 launch alone: no device time in the trace "
            f"({b2_probe['error']}; {b2_probe.get('b2_launches')} launched)")

    # One model-optimization pass: every Brent probe is push_models (host
    # eigensystems) + a full traversal through B2.
    host = [0.0]
    push = inst.push_models

    def timed_push(*a, **k):
        t = time.perf_counter()
        push(*a, **k)
        host[0] += time.perf_counter() - t

    inst.push_models = timed_push
    before = inst.evaluate(tree, full=True)
    reset_counts()
    t0 = time.perf_counter()
    opt_rates(inst, tree)
    opt_alphas(inst, tree)
    sync(device)
    opt_s = time.perf_counter() - t0
    launches["opt_rates_alphas"] = read_counts()
    check_tier(launches["opt_rates_alphas"], "whole",
               "real-size opt_rates + opt_alphas")
    after = inst.likelihood
    check(after >= before - 1e-9 * abs(before),
          f"opt_rates + opt_alphas decreased lnL: {before} -> {after}")
    full = launches["opt_rates_alphas"]["full_traversals"]
    log(f"  opt_rates + opt_alphas: lnL {before!r} -> {after!r}; {opt_s:.2f} "
        f"s, {full} full traversals ({opt_s * 1e3 / full:.2f} ms each, of "
        f"which push_models {host[0] * 1e3 / full:.2f} ms on the host)")
    return {
        "lnl": lnl, "chunk_lnl": chunk_lnl, "evaluate_ms": eval_ms,
        "evaluate_ms_runs": [w * 1e3 for w in walls],
        "site_clv_updates_per_s": n * setup["patterns"] * eng.R * eng.K
        / (eval_ms / 1e3),
        "entries": n, "waves": int(st.wave_start.shape[0]) - 1,
        "grid_blocks": newview_whole.LAST_GRID, "kernel_ms": kernel_ms,
        "launches_per_traversal": per,
        "plain_ms": plain_ms, **bound, "max_rel_err": rel,
        "max_abs_err": abs_err, "launches_by_path": launches,
        "profile": profile, "b2_probe": b2_probe,
        "opt_lnl_before": before,
        "opt_lnl_after": after, "opt_s": opt_s,
        "opt_full_traversals": full, "opt_ms_per_probe": opt_s * 1e3 / full,
        "opt_push_models_ms_per_probe": host[0] * 1e3 / full,
    }


# -- phase 19: SEV (-S) at real width ----------------------------------------


def subtree_tips(tree, s) -> frozenset:
    """Tip numbers of the subtree at slot s (away from s.back)."""
    out, stack = set(), [s]
    while stack:
        x = stack.pop()
        if tree.is_tip(x.number):
            out.add(x.number)
        else:
            stack += [x.next.back, x.next.next.back]
    return frozenset(out)


def informative_branches(tree, clades) -> list:
    """The inner branches (p, q) with some partition sequenced on both
    sides.  Along any other branch the lnL does not depend on z (every
    partition is all gap on one side: its CLV there is 1 under -S, ~1
    after rounding on the dense arena), so Newton-Raphson ends where
    rounding sends it, and such branches are not compared."""
    out = []
    for p, q in tree.all_branches():
        if tree.is_tip(p.number) or tree.is_tip(q.number):
            continue
        side = subtree_tips(tree, p)
        if any(c & side and c - side for c in clades):
            out.append((p, q))
    return out


def sev_setup(seed: int) -> dict:
    """The gappy real-size inputs: SEV_PARTS partitions of SEV_WIDTH
    columns on SEV_TAXA taxa, partition g sequenced (a correlated walk, as
    synthetic_alignment's) only for the taxa of one clade of the seed's
    random tree, drawn among the clades of SEV_CLADE taxa, and all gap for
    every other taxon — a supermatrix whose genes were each sequenced for
    one group; models and branch lengths from the seed, as real_setup's."""
    from examl_tpu_torch import datatypes
    from examl_tpu_torch.io.alignment import (AlignmentData, PartitionData,
                                              compress_patterns,
                                              empirical_frequencies)
    from examl_tpu_torch.tree.topology import Tree
    t0 = time.perf_counter()
    names = [f"t{i}" for i in range(SEV_TAXA)]
    tree = Tree.random(names, seed, 1)
    lo, hi = SEV_CLADE
    clades = sorted({t for p, q in tree.all_branches() for t in
                     (subtree_tips(tree, p), subtree_tips(tree, q))
                     if lo <= len(t) <= hi}, key=sorted)
    check(len(clades) > 0, f"the seed's tree has no clade of {lo}-{hi} taxa")
    rng = np.random.default_rng(seed + 2)
    pick = rng.choice(len(clades), SEV_PARTS,
                      replace=len(clades) < SEV_PARTS)
    dna = np.array([1, 2, 4, 8], np.uint8)
    parts, sizes = [], []
    for g, c in enumerate(pick):
        rows = np.asarray(sorted(clades[c]), np.int64) - 1
        codes = np.full((SEV_TAXA, SEV_WIDTH), 15, np.uint8)
        cur = rng.integers(0, 4, SEV_WIDTH)
        for t in rows:
            flip = rng.random(SEV_WIDTH) < 0.15
            cur = np.where(flip, rng.integers(0, 4, SEV_WIDTH), cur)
            codes[t] = dna[cur]
        pats, wts = compress_patterns(codes)
        parts.append(PartitionData(
            name=f"g{g}", datatype=datatypes.DNA, model_name="GTR",
            patterns=pats, weights=wts,
            empirical_freqs=empirical_frequencies(pats, wts, datatypes.DNA),
            use_empirical_freqs=True, optimize_freqs=False))
        sizes.append(len(rows))
    params = []
    prng = np.random.default_rng(seed + 1)
    for _ in range(SEV_PARTS):
        rates = prng.uniform(0.3, 6.0, 6)
        rates[-1] = 1.0
        params.append((rates, prng.dirichlet(np.ones(4) * 5),
                       prng.uniform(0.2, 1.5)))
    zs = np.exp(-prng.exponential(0.08, 2 * SEV_TAXA - 3))
    ad = AlignmentData(names, parts)
    return {"ad": ad, "params": params, "zs": zs, "seed": seed,
            "ntaxa": SEV_TAXA, "parts": SEV_PARTS, "clade_taxa": sizes,
            "clades": [clades[c] for c in pick],
            "patterns": int(sum(p.width for p in parts)),
            "alignment_s": time.perf_counter() - t0}


def phase_sev(device, seed: int, reps: int, keep: dict):
    """SEV memory saving at real width: one -S instance (the pooled tier)
    and one dense instance (the chunk tier, B1), both f32, on the gappy
    set-up's data and tree.  Each instance's path (built, evaluated,
    Newton-Raphson on SEV_NEWTON inner branches, a batched lazy scan of
    SEV_SCAN_SLOTS pruned nodes at radius 1-5 after one untimed warm-up
    node) reads the counts reset just before it.  Newton-Raphson runs on
    the first inner branches with data on both sides (along the others
    the lnL is flat in z; their count is reported).  The pooled lnL, the
    branch lengths and every candidate lnL are held to the dense
    instance's at rel SEV_RTOL, each slot's best move must be the same on
    both (or tie within SEV_RTOL), the saving above SEV_MIN_SAVING, the
    pool below the dense arena, and the -S path launches neither B1 nor
    B2.  The set-up goes into `keep` (phase 29 reads it)."""
    import torch
    from examl_tpu_torch.search import batchscan, spr
    setup = keep["sev"] = sev_setup(seed)
    release_memory()
    out = {"taxa": SEV_TAXA, "parts": SEV_PARTS,
           "patterns": setup["patterns"],
           "clade_taxa": setup["clade_taxa"]}
    scores = {}
    run_plan = batchscan.run_plan

    def recorded_plan(inst_, tree_, plan):
        lnls = run_plan(inst_, tree_, plan)
        for c, lnl in zip(plan.candidates, lnls):
            scores[(plan.s_num, c.q_slot.number,
                    c.q_slot.back.number)] = float(lnl)
        return lnls

    keep = []
    for name, kw in (("sev", {"newview": None, "save_memory": True}),
                     ("dense", {"newview": "chunk"})):
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        reset_counts()
        t0 = time.perf_counter()
        inst, tree = real_instance(setup, device, **kw)
        lnl, walls = timed_evaluates(inst, tree, device, reps)
        peak = torch.cuda.max_memory_allocated(device) - base
        build_s = time.perf_counter() - t0 - sum(walls)
        eng = inst.engines[4]
        r = {"lnl": lnl, "evaluate_ms": float(np.mean(walls) * 1e3),
             "evaluate_ms_runs": [w * 1e3 for w in walls],
             "peak_bytes": int(peak), "setup_s": build_s}
        if name == "sev":
            r["stats"] = eng.sev.stats()
            r["pool_bytes"] = (eng.sev.pool.numel()
                               * eng.sev.pool.element_size())
            r["profile"] = device_breakdown(
                lambda: inst.evaluate(tree, full=True), device)
        else:
            r["arena_bytes"] = eng.clv.numel() * eng.clv.element_size()
        branches = informative_branches(tree, setup["clades"])
        r["flat_branches"] = SEV_TAXA - 3 - len(branches)
        branches = branches[:SEV_NEWTON]
        t0 = time.perf_counter()
        r["z"] = [float(inst.makenewz(tree, p, q, p.z, maxiter=16)[0])
                  for p, q in branches]
        sync(device)
        r["makenewz_s"] = time.perf_counter() - t0

        def deep(p) -> bool:
            return not tree.is_tip(p.number) and not (
                tree.is_tip(p.next.back.number)
                and tree.is_tip(p.next.next.back.number))

        slots = [p for p in spr.dfs_slot_order(tree)
                 if deep(p)][:SEV_SCAN_SLOTS + 1]
        check(len(slots) == SEV_SCAN_SLOTS + 1, "too few inner slots")
        best = []
        batchscan.run_plan = recorded_plan
        try:
            for i, p in enumerate(slots):
                if i == 1:
                    sync(device)
                    scores.clear()
                    n0 = spr.INSERTIONS_SCORED
                    t0 = time.perf_counter()
                ctx = spr.SprContext(inst, thorough=False, do_cutoff=False)
                ctx.start_lh = ctx.end_lh = math.inf
                ctx.best_of_node = -math.inf
                spr.rearrange_batched(inst, tree, ctx, p, 1, 5)
                if i:
                    best.append((ctx.remove_node.back.number,
                                 ctx.insert_node.number,
                                 ctx.insert_node.back.number))
            sync(device)
            scan_s = time.perf_counter() - t0
        finally:
            batchscan.run_plan = run_plan
        n = spr.INSERTIONS_SCORED - n0
        check(n > 0 and len(scores) == n,
              f"{name}: {n} insertions scored, {len(scores)} recorded")
        counts = read_counts()
        if name == "sev":
            check(counts["b1"] == counts["b2"] == 0
                  and counts["full_traversals"] == 0,
                  f"the -S path launched a newview kernel: {counts}")
            check(counts["pooled_traversals"] > 0,
                  "the -S path ran no pooled traversal")
            r["pool_bytes_after_scan"] = (eng.sev.pool.numel()
                                          * eng.sev.pool.element_size())
            r["stats_after_scan"] = eng.sev.stats()
        else:
            check_tier(counts, "chunk", "phase 19 dense path")
            check(counts["pooled_traversals"] == 0,
                  "the dense path ran a pooled traversal")
        r.update(counts=counts, scan_s=scan_s, insertions=n,
                 ms_per_insertion=scan_s * 1e3 / n,
                 ms_per_pruned_node=scan_s * 1e3 / SEV_SCAN_SLOTS,
                 scores=dict(scores), best=best)
        out[name] = r
        keep.append((inst, tree))
    sev, dense = out["sev"], out["dense"]
    rel = abs(sev["lnl"] - dense["lnl"]) / abs(dense["lnl"])
    check(rel <= SEV_RTOL, f"pooled lnL {sev['lnl']} vs dense "
          f"{dense['lnl']} (rel {rel:.3g})")
    zrel = max(abs(a - b) / b for a, b in zip(sev["z"], dense["z"]))
    check(zrel <= SEV_RTOL, f"makenewz: pooled {sev['z']} vs dense "
          f"{dense['z']} (rel {zrel:.3g})")
    s, d = sev.pop("scores"), dense.pop("scores")
    check(set(s) == set(d), f"the instances scanned different windows "
          f"({len(s)} and {len(d)} candidates)")
    srel = max(abs(s[k] - d[k]) / abs(d[k]) for k in d)
    check(srel <= SEV_RTOL, f"pooled and dense candidate lnLs differ by rel "
          f"{srel:.3g}")
    same = 0
    for ks, kd in zip(sev.pop("best"), dense.pop("best")):
        same += ks == kd
        check(ks == kd or abs(d[ks] - d[kd]) <= SEV_RTOL * abs(d[kd]),
              f"the pooled scan's best move {ks} has the dense lnL "
              f"{d[ks]!r}, the dense best {kd} {d[kd]!r}")
    st = sev["stats"]
    check(st["saving_ratio"] > SEV_MIN_SAVING,
          f"SEV saving {st['saving_ratio']:.3f} <= {SEV_MIN_SAVING}")
    check(sev["pool_bytes"] < dense["arena_bytes"],
          f"pool {sev['pool_bytes']} B not below the dense arena "
          f"{dense['arena_bytes']} B")
    dense_cells_bytes = st["dense_cells"] * st["cell_bytes"]
    out.update(lnl_rel=rel, z_rel=zrel, candidates=len(d),
               candidate_rel=srel, same_best_move=same,
               dense_cells_bytes=dense_cells_bytes)
    del keep
    release_memory()
    prof = sev["profile"]
    log(f"  {SEV_TAXA} taxa x {setup['patterns']} patterns in {SEV_PARTS} "
        f"partitions, each sequenced for one clade of "
        f"{min(setup['clade_taxa'])}-{max(setup['clade_taxa'])} taxa")
    log(f"  pooled lnL {sev['lnl']!r}, dense (B1) {dense['lnl']!r}, rel "
        f"{rel:.2e}; makenewz on {SEV_NEWTON} branches rel {zrel:.2e} "
        f"({sev['flat_branches']} of {SEV_TAXA - 3} inner branches have no "
        "partition on both sides)")
    log(f"  SEV: {st['allocated_cells']} of {st['dense_cells']} cells "
        f"allocated (saving {st['saving_ratio']:.4f}); pool "
        f"{sev['pool_bytes'] / 1e9:.3f} GB against the dense arena "
        f"{dense['arena_bytes'] / 1e9:.3f} GB ({dense_cells_bytes / 1e9:.3f} "
        f"GB without slack); peak memory -S {sev['peak_bytes'] / 1e9:.3f} GB, "
        f"dense {dense['peak_bytes'] / 1e9:.3f} GB")
    log(f"  full traversal + evaluate: pooled {sev['evaluate_ms']:.2f} ms, "
        f"dense chunk tier {dense['evaluate_ms']:.2f} ms")
    if prof["measured"]:
        log(f"  profiled pooled evaluate: wall {prof['wall_ms']:.1f} ms, "
            f"device busy {prof['busy_ms']:.1f} ms (idle share "
            f"{prof['idle_share']:.3f}) in {prof['launches']} device ops")
        for row in prof["top"]:
            log(f"    {row['ms']:9.3f} ms  {row['calls']:5d}x  {row['name']}")
    else:
        log(f"  profiled pooled evaluate: not measured ({prof['error']})")
    log(f"  batched lazy scan, {SEV_SCAN_SLOTS} pruned nodes, {len(d)} "
        f"insertions: pooled {sev['ms_per_insertion']:.3f} ms per insertion "
        f"({sev['ms_per_pruned_node']:.1f} ms per node), dense "
        f"{dense['ms_per_insertion']:.3f} ms "
        f"({dense['ms_per_pruned_node']:.1f} ms); candidate rel {srel:.2e}; the same best move on {same} of "
        f"{SEV_SCAN_SLOTS}; pool after the scan "
        f"{sev['pool_bytes_after_scan'] / 1e9:.3f} GB")
    log(f"  counts -S {sev['counts']}")
    return out


# -- phase 20: -S through the CLI ---------------------------------------------


def sev_cli_alignment(seed: int):
    """The JAX package's tests/test_sev.py shape: SEV_CLI_TAXA taxa, SEV_CLI_
    GENES genes of SEV_CLI_WIDTH columns, gene g sequenced for its share of
    the taxa (a correlated walk, as synthetic_alignment's, where that
    module draws independent columns: without a signal the PSR model
    optimization runs to its round limit) and all gap for the rest."""
    from examl_tpu_torch.io.alignment import build_alignment_data
    from examl_tpu_torch.io.partitions import PartitionSpec
    rng = np.random.default_rng(seed)
    names = [f"t{i}" for i in range(SEV_CLI_TAXA)]
    per = SEV_CLI_TAXA // SEV_CLI_GENES
    seqs = ["" for _ in names]
    for g in range(SEV_CLI_GENES):
        cur = rng.integers(0, 4, SEV_CLI_WIDTH)
        for i in range(SEV_CLI_TAXA):
            if g * per <= i < (g + 1) * per:
                flip = rng.random(SEV_CLI_WIDTH) < 0.15
                cur = np.where(flip, rng.integers(0, 4, SEV_CLI_WIDTH), cur)
                seqs[i] += "".join("ACGT"[b] for b in cur)
            else:
                seqs[i] += "-" * SEV_CLI_WIDTH
    specs = [PartitionSpec(f"gene{g}", "DNA", "GTR",
                           np.arange(g * SEV_CLI_WIDTH,
                                     (g + 1) * SEV_CLI_WIDTH))
             for g in range(SEV_CLI_GENES)]
    return build_alignment_data(names, seqs, specs)


def sev_cli_start(names) -> str:
    """The start tree of phase 20: each gene's taxa a caterpillar clade
    (the JAX package's tests/test_sev.py gene-clade tree), the clades
    joined at the root."""
    per = len(names) // SEV_CLI_GENES
    clades = []
    for g in range(SEV_CLI_GENES):
        c = names[g * per]
        for t in names[g * per + 1:(g + 1) * per]:
            c = f"({c}:0.1,{t}:0.1)"
        clades.append(c + ":0.1")
    return "(" + ",".join(clades) + ");"


def sev_saving(info: str) -> float:
    """The saving on the info file's last SEV bucket line (fraction)."""
    lines = re.findall(r"^SEV bucket states=\d+: \d+ of \d+ CLV cells "
                       r"allocated \(([\d.]+)% saved\)$", info, re.M)
    check("  SEV (-S) pool active for this bucket" in info.splitlines()
          and len(lines) == 1, "the info file lacks the SEV lines")
    return float(lines[0]) / 100.0


def check_pooled(counts: dict, path: str) -> None:
    check(counts["b1"] == counts["b2"] == counts["full_traversals"] == 0,
          f"{path} launched a newview kernel: {counts}")
    check(counts["pooled_traversals"] > 0, f"{path}: no pooled traversal")


def phase_sev_cli(device, out_dir: str, seed: int):
    """-S through the port's CLI at small size, f32 on the card: -f d -i 5
    (the batched SPR scan over the pool), its endpoint re-evaluated on the
    dense chunk tier and its last checkpoint restored there and under -S
    (the pool's saving on the endpoint tree); -R -S from the last-but-one
    checkpoint; -m PSR -f e -S; -f q -S -r SEV_CLI_QUARTETS (the
    sequential scorer).  The saving asked of -m PSR, -f q and the endpoint
    tree is SEV_CLI_MIN_SAVING; -f d's info line also counts the scan
    region, dense by design, and is reported."""
    import shutil
    import torch
    from examl_tpu_torch.instance import PhyloInstance
    from examl_tpu_torch.io.bytefile import read_bytefile, write_bytefile
    from examl_tpu_torch.search.checkpoint import CheckpointManager
    ad = sev_cli_alignment(seed)
    aln = os.path.join(out_dir, "sev_aln.binary")
    write_bytefile(aln, ad)
    start = os.path.join(out_dir, "sev_start.nwk")
    with open(start, "w") as f:
        f.write(sev_cli_start(ad.taxon_names) + "\n")
    out = {"taxa": SEV_CLI_TAXA, "genes": SEV_CLI_GENES,
           "width": SEV_CLI_WIDTH}

    workdir = os.path.join(out_dir, "sev_fd")
    shutil.rmtree(workdir, ignore_errors=True)
    rc, wall, counts, info = run_cli(["-s", aln, "-t", start, "-i", "5",
                                      "-S"], device, workdir)
    check(rc == 0, f"-f d -S returned {rc}")
    check_pooled(counts, "-f d -S")
    check("SPR lazy-arm scan: batched" in info and counts["scan_calls"] > 0,
          "-f d -S on the card did not take the batched SPR scan")
    saving = sev_saving(info)
    logged = [float(line.split()[1]) for line in open(os.path.join(
        workdir, "ExaML_log.smoke")).read().splitlines()]
    final = float(re.search(r"Likelihood of best tree: (\S+)",
                            info).group(1))
    check(final >= logged[0], f"-f d -S ended at {final}, below its start "
          f"{logged[0]}")
    reset_counts()
    lnl_dense, _, _ = reevaluate(workdir, aln, torch.float32, device)
    dense_counts = read_counts()
    check_tier(dense_counts, "chunk", "-f d -S endpoint re-evaluated")
    check(abs(lnl_dense - final) <= SEV_RTOL * abs(final),
          f"-f d -S endpoint {final} re-evaluates to {lnl_dense} on the "
          "dense chunk tier")
    ckpts = read_checkpoints(workdir)
    inst = PhyloInstance(read_bytefile(aln), device=device)
    CheckpointManager(workdir, "smoke").restore(inst, inst.random_tree(0))
    import gzip
    with gzip.open(os.path.join(workdir, "ExaML_binaryCheckpoint.smoke."
                                f"ckpt_{max(ckpts)}.json.gz"), "rt") as f:
        ck_lnl = json.load(f)["tree"]["likelihood"]
    check(abs(inst.likelihood - ck_lnl) <= SEV_RTOL * abs(ck_lnl),
          f"last -S checkpoint (lnL {ck_lnl}) restores to "
          f"{inst.likelihood} on the dense chunk tier")
    # The pool's saving on the endpoint tree: the info line's ratio also
    # counts the batched scan's region, which is dense by design and at
    # this size holds more rows than the tree's nodes.
    sinst = PhyloInstance(read_bytefile(aln), device=device,
                          save_memory=True)
    CheckpointManager(workdir, "smoke").restore(sinst,
                                                sinst.random_tree(0))
    end_saving = sinst.engines[4].sev.stats()["saving_ratio"]
    check(end_saving > SEV_CLI_MIN_SAVING
          and abs(sinst.likelihood - ck_lnl) <= SEV_RTOL * abs(ck_lnl),
          f"last -S checkpoint restored under -S: lnL {sinst.likelihood} "
          f"(checkpoint {ck_lnl}), saving {end_saving:.3f}")
    del inst, sinst
    out["fd"] = {"wall_s": wall, "start_lnl": logged[0], "final_lnl": final,
                 "dense_reevaluated": lnl_dense,
                 "dense_reevaluate_launches": dense_counts,
                 "checkpoint_lnl": ck_lnl,
                 "saving_with_scan_region": saving,
                 "endpoint_saving": end_saving, "checkpoints": len(ckpts),
                 "launches": counts}
    log(f"  -f d -i 5 -S: lnL {logged[0]!r} -> {final!r} in {wall:.1f} s "
        f"(saving {saving:.3f} with the scan region, {end_saving:.3f} on "
        f"the endpoint tree; {counts['pooled_traversals']} pooled "
        f"traversals, {counts['scan_calls']} batched scan calls, "
        f"{counts['insertions_scored']} insertions); dense chunk tier "
        f"re-evaluates {lnl_dense!r}, last checkpoint {ck_lnl!r}")

    rdir = os.path.join(out_dir, "sev_restart")
    shutil.rmtree(rdir, ignore_errors=True)
    shutil.copytree(workdir, rdir)
    check(len(ckpts) >= 2, f"-f d -S wrote {len(ckpts)} checkpoints")
    kept = sorted(ckpts)[-2]
    for n in ckpts:
        if n > kept:
            os.remove(os.path.join(
                rdir, f"ExaML_binaryCheckpoint.smoke.ckpt_{n}.json.gz"))
    rc, rwall, rcounts, rinfo = run_cli(["-s", aln, "-t", start, "-i", "5",
                                         "-S", "-R"], device, rdir)
    check(rc == 0, f"-R -S returned {rc}")
    check_pooled(rcounts, "-R -S")
    rfinal = float(re.findall(r"Likelihood of best tree: (\S+)", rinfo)[-1])
    check(rfinal >= final - 0.5, f"-R -S ended at {rfinal}, below the "
          f"continuous run's {final} less 0.5")
    out["restart"] = {"checkpoint": kept, "final_lnl": rfinal,
                      "wall_s": rwall, "launches": rcounts}
    log(f"  -R -S from checkpoint {kept} ({ckpts[kept]}): {rfinal!r} in "
        f"{rwall:.1f} s")

    pdir = os.path.join(out_dir, "sev_psr")
    shutil.rmtree(pdir, ignore_errors=True)
    inst = PhyloInstance(read_bytefile(aln), device=device,
                         rate_model="PSR", save_memory=True)
    with open(start) as f:
        pstart = inst.evaluate(inst.tree_from_newick(f.read()), full=True)
    del inst
    rc, pwall, pcounts, pinfo = run_cli(["-s", aln, "-t", start, "-f", "e",
                                         "-m", "PSR", "-S"], device, pdir)
    check(rc == 0, f"-m PSR -f e -S returned {rc}")
    check_pooled(pcounts, "-m PSR -f e -S")
    check(pcounts["grad_passes"] == 0, "-S smoothed by gradient passes")
    pfinal = float(re.search(r"Likelihood tree 0: (\S+)", pinfo).group(1))
    check(pfinal >= pstart, f"-m PSR -f e -S ended at {pfinal}, below its "
          f"start {pstart}")
    cats = model_file_categories(os.path.join(pdir, "ExaML_modelFile.smoke"))
    check(len(cats) == SEV_CLI_GENES
          and all(1 <= c <= PSR_CATEGORIES for c in cats),
          f"-m PSR -f e -S categories {cats}")
    psaving = sev_saving(pinfo)
    check(psaving > SEV_CLI_MIN_SAVING, f"-m PSR -f e -S saved {psaving:.3f}")
    out["psr"] = {"start_lnl": pstart, "final_lnl": pfinal, "wall_s": pwall,
                  "categories": cats, "saving": psaving,
                  "launches": pcounts}
    log(f"  -m PSR -f e -S: {pstart!r} -> {pfinal!r} in {pwall:.1f} s, "
        f"categories {cats}, saving {psaving:.3f}")

    qdir = os.path.join(out_dir, "sev_fq")
    shutil.rmtree(qdir, ignore_errors=True)
    rc, qwall, qcounts, qinfo = run_cli(
        ["-s", aln, "-t", start, "-f", "q", "-S", "-r",
         str(SEV_CLI_QUARTETS)], device, qdir)
    check(rc == 0, f"-f q -S returned {rc}")
    check_pooled(qcounts, "-f q -S")
    check("quartet scoring: sequential" in qinfo
          and qcounts["quartet_jobs"] == 0,
          "-f q -S did not take the sequential scorer")
    with open(os.path.join(qdir, "ExaML_quartets.smoke")) as f:
        rows = [float(line.split(": ")[1]) for line in f if "|" in line]
    check(len(rows) == 3 * SEV_CLI_QUARTETS
          and all(math.isfinite(v) and v < 0 for v in rows),
          f"-f q -S wrote {len(rows)} rows, finite negative expected")
    qsaving = sev_saving(qinfo)
    check(qsaving > SEV_CLI_MIN_SAVING, f"-f q -S saved {qsaving:.3f}")
    out["quartets"] = {"rows": len(rows), "wall_s": qwall, "saving": qsaving,
                       "ms_per_topology": qwall * 1e3 / len(rows),
                       "launches": qcounts}
    log(f"  -f q -S -r {SEV_CLI_QUARTETS}: {len(rows)} rows in {qwall:.1f} s, "
        f"saving {qsaving:.3f}")
    return out

# -- phase 21: bfloat16 CLV storage -------------------------------------------


def bf16_real(inst, tree, setup: dict, ref_lnl: float, device, reps: int,
              what: str) -> dict:
    """A real-size instance with a bfloat16 arena on the chunk tier: the
    evaluate (its counts, lnL against the float32 arena's ref_lnl, ms),
    the arena's bytes against float32's, and each engine's kernel against
    its plain version and its bound (time_kernels)."""
    import torch
    reset_counts()
    lnl, walls = timed_evaluates(inst, tree, device, reps)
    counts = read_counts()
    check_tier(counts, "chunk", f"{what} bf16 evaluate")
    check(counts["b1_by_dtype"].get("bfloat16", 0) == counts["b1"] > 0,
          f"{what} bf16 evaluate: B1 launches by storage dtype "
          f"{counts['b1_by_dtype']}")
    check(all(e.clv.dtype == torch.bfloat16 for e in inst.engines.values()),
          f"{what}: an arena is not bfloat16")
    rel = (lnl - ref_lnl) / abs(ref_lnl)
    check(math.isfinite(lnl) and abs(rel) <= BF16_RTOL,
          f"{what} bf16 lnL {lnl} against float32 {ref_lnl} (rel {rel:.2e})")
    arena = sum(e.clv.numel() * e.clv.element_size()
                for e in inst.engines.values())
    eval_ms = float(np.mean(walls) * 1e3)
    log(f"  {what}: lnL {lnl!r} against float32 storage {ref_lnl!r} (gap "
        f"{lnl - ref_lnl:.4f}, rel {rel:.2e}); evaluate {eval_ms:.2f} ms "
        f"per full traversal; arena {arena / 1e9:.2f} GB against "
        f"{2 * arena / 1e9:.2f} GB in float32; launches by K "
        f"{counts['b1_by_K']}, by storage {counts['b1_by_dtype']}")
    kernels = time_kernels(inst, tree, setup, device, "chunk", reps)
    return {"lnl": lnl, "f32_lnl": ref_lnl, "lnl_gap": lnl - ref_lnl,
            "lnl_rel_gap": rel, "evaluate_ms": eval_ms,
            "evaluate_ms_runs": [w * 1e3 for w in walls],
            "arena_bytes": arena, "f32_arena_bytes": 2 * arena,
            "counts": counts, "kernels": kernels}


def kernel_turns(inst32, tree32, inst16, tree16, device, reps: int) -> dict:
    """B1 per full traversal on a float32 arena and on a bfloat16 one, in
    turns (float32, bfloat16, bfloat16, float32), per engine K: the same
    layout and P, through chunk_apply (tip products included)."""
    import torch
    from examl_tpu_torch.ops import fastpath, newview_chunk
    out = {}
    for K in sorted(inst32.engines):
        runs = {"float32": [], "bfloat16": []}
        ops = {}
        for name, inst, tree in (("float32", inst32, tree32),
                                 ("bfloat16", inst16, tree16)):
            eng = inst.engines[K]
            flat = tree.flat_full_traversal(tree.centroid_branch())
            st = eng._structure(flat)
            zl, zr = fastpath.refresh_z(st, flat, 1, eng.dtype, device)
            pmat = newview_chunk.chunk_operands(eng.models, zl, zr)
            ops[name] = (torch.zeros_like(eng.clv),
                         torch.zeros_like(eng.scaler), eng.tips.codes,
                         eng.tips.table, eng.block_part_i32, st.launch,
                         st.lidx, st.ridx, st.lcode, st.rcode, pmat,
                         eng.scale_exp,
                         newview_chunk.Dataflow(st.flow_rows, st.wait,
                                                newview_chunk.Ready()))
        for name in ("float32", "bfloat16", "bfloat16", "float32"):
            runs[name].append(time_ms(
                lambda: newview_chunk.chunk_apply(*ops[name]), device, reps))
        del ops
        out[K] = {k: float(np.mean(v)) for k, v in runs.items()}
        out[K]["runs"] = runs
        log(f"  B1 in turns, K={K:2d}: float32 arena "
            f"{out[K]['float32']:.3f} ms, bfloat16 {out[K]['bfloat16']:.3f}"
            f" ms per traversal (runs f32 {runs['float32']}, bf16 "
            f"{runs['bfloat16']})")
    return out


def phase_bf16(device, setup: dict, real: dict, real_aa: dict, fd: dict,
               out_dir: str, seed: int, reps: int, ptxas: dict) -> dict:
    """bfloat16 CLV storage (float32 compute): (a) each bfloat16 instance
    of B1 against its plain version (phase 3's cases: scalers equal,
    every cell within one bfloat16 ulp of its site's maximum, the
    differing cells counted); (b) the real-size DNA instance
    (phase 10's set-up) and the real-size amino-acid + binary one (phase
    16's) on the chunk tier against their float32 lnL, with B1's time,
    plain time and bound; (c) `-f d -i 5 --clv-dtype bf16` through the CLI
    on phase 7's alignment and start tree, its endpoint re-evaluated with
    float32 storage; (d) `-S -f e --clv-dtype bf16` on phase 20's
    alignment against the float32 `-S -f e`, no newview kernel launched,
    and a bfloat16 pool."""
    import shutil
    import torch
    from examl_tpu_torch.instance import PhyloInstance
    from examl_tpu_torch.io.bytefile import read_bytefile
    bf16 = torch.bfloat16
    out = {"cases": phase_kernel_vs_plain(device, CHECK_BLOCKS, CHECK_WIDTH,
                                          seed + 100, ("bfloat16",))}
    release_memory()
    out["ptxas"] = spills = bf16_spills(ptxas)
    for inst, r in sorted(spills.items()):
        log(f"  ptxas {inst}: {r.get('registers')} registers, "
            f"{r.get('spill_bytes')} bytes spilled")
    check(len(spills) == 12, f"ptxas reports {len(spills)} bfloat16 "
          "instances of B1, not 12 (3 kinds and the dataflow kernel at "
          "K = 4, 20, 2)")
    spilling = sorted(i for i, r in spills.items() if r.get("spill_bytes"))
    check(not spilling and all("spill_bytes" in r for r in spills.values()),
          f"bfloat16 instances of B1 spill or report no spill line: "
          f"{spilling or sorted(spills)}")

    inst, tree = real_instance(setup, device, "chunk", clv_dtype=bf16)
    out["dna"] = bf16_real(inst, tree, setup, real["lnl"], device, reps,
                           "real-size DNA")
    inst32, tree32 = real_instance(setup, device, "chunk")
    out["dna"]["turns"] = kernel_turns(inst32, tree32, inst, tree, device,
                                       reps)
    del inst, tree, inst32, tree32
    release_memory()
    aa = aa_setup(seed)
    inst, tree = aa_instance(aa, device, "chunk", clv_dtype=bf16)
    out["aa"] = bf16_real(inst, tree, aa, real_aa["chunk"]["lnl"], device,
                          reps, "real-size AA + BIN")
    check(all(out["aa"]["counts"]["b1_by_K"].get(K, 0) > 0
              for K in (20, 2)), "real-size AA + BIN bf16: launches by K "
          f"{out['aa']['counts']['b1_by_K']}")
    # The redesigned instances' targets (reported, not fatal): at least
    # half the bound per real-size traversal, the tip products included.
    out["targets"] = {}
    for K, w in ((20, "aa"), (2, "aa"), (4, "dna")):
        m = out[w]["kernels"][K]
        out["targets"][K] = t = {
            "ms": m["kernel_ms"], "bound_ms": m["bound_ms"],
            "share": m["bound_ms"] / m["kernel_ms"],
            "target_ms": 2 * m["bound_ms"],
            "met": m["kernel_ms"] <= 2 * m["bound_ms"]}
        log(f"  target bf16 K={K:2d}: {t['ms']:.3f} ms per traversal against "
            f"a {t['bound_ms']:.3f} ms bound ({t['share']:.2f} of it), "
            f"target {t['target_ms']:.3f} ms: "
            f"{'met' if t['met'] else 'missed'}")
    inst32, tree32 = aa_instance(aa, device, "chunk")
    out["aa"]["turns"] = kernel_turns(inst32, tree32, inst, tree, device,
                                      reps)
    del inst, tree, inst32, tree32
    release_memory()

    workdir = os.path.join(out_dir, "fd_bf16")
    shutil.rmtree(workdir, ignore_errors=True)
    rc, wall, counts, info = run_cli(
        ["-s", fd["aln"], "-t", fd["start_tree"], "-i", "5", "--clv-dtype",
         "bf16"], device, workdir)
    check(rc == 0, f"-f d --clv-dtype bf16 returned {rc}")
    check_tier(counts, "chunk", "-f d --clv-dtype bf16")
    check(counts["b1_by_dtype"].get("bfloat16", 0) == counts["b1"] > 0,
          f"-f d --clv-dtype bf16: B1 by storage {counts['b1_by_dtype']}")
    check("clv storage: bfloat16" in info, "-f d --clv-dtype bf16: the info "
          "file does not name bfloat16 storage")
    logged = [float(line.split()[1]) for line in open(os.path.join(
        workdir, "ExaML_log.smoke")).read().splitlines()]
    final = float(re.search(r"Likelihood of best tree: (\S+)",
                            info).group(1))
    check(final > logged[0], f"-f d --clv-dtype bf16 ended at {final}, not "
          f"above its start {logged[0]}")
    lnl32, _, _ = reevaluate(workdir, fd["aln"], torch.float32, device)
    check(abs(lnl32 - final) <= BF16_RTOL * abs(lnl32), f"-f d --clv-dtype "
          f"bf16 endpoint {final} re-evaluates to {lnl32} with float32 "
          "storage")
    out["cli_fd"] = {"wall_s": wall, "start_lnl": logged[0],
                     "final_lnl": final, "reevaluated_f32": lnl32,
                     "f32_run_final_lnl": fd["final_lnl"],
                     "f32_run_wall_s": fd["wall_s"], "counts": counts}
    log(f"  -f d -i 5 --clv-dtype bf16: lnL {logged[0]!r} -> {final!r} in "
        f"{wall:.1f} s (float32 storage: {fd['final_lnl']!r} in "
        f"{fd['wall_s']:.1f} s); endpoint re-evaluated with float32 storage "
        f"{lnl32!r} (gap {final - lnl32:.4f}, rel "
        f"{(final - lnl32) / abs(lnl32):.2e}); B1 {counts['b1']} launches, "
        f"{counts['scan_calls']} batched scan calls")

    aln = os.path.join(out_dir, "sev_aln.binary")
    start = os.path.join(out_dir, "sev_start.nwk")
    runs = {}
    for tag, extra in (("f32", []), ("bf16", ["--clv-dtype", "bf16"])):
        sdir = os.path.join(out_dir, f"sev_fe_{tag}")
        shutil.rmtree(sdir, ignore_errors=True)
        rc, swall, scounts, sinfo = run_cli(
            ["-s", aln, "-t", start, "-f", "e", "-S"] + extra, device, sdir)
        check(rc == 0, f"-S -f e {' '.join(extra)} returned {rc}")
        check_pooled(scounts, f"-S -f e {' '.join(extra)}")
        runs[tag] = {"final_lnl": float(re.search(
            r"Likelihood tree 0: (\S+)", sinfo).group(1)), "wall_s": swall,
            "saving": sev_saving(sinfo), "counts": scounts}
    check("clv storage: bfloat16" in sinfo, "-S -f e --clv-dtype bf16: the "
          "info file does not name bfloat16 storage")
    gap = runs["bf16"]["final_lnl"] - runs["f32"]["final_lnl"]
    check(abs(gap) <= BF16_RTOL * abs(runs["f32"]["final_lnl"]),
          f"-S -f e: bfloat16 storage ends at "
          f"{runs['bf16']['final_lnl']}, float32 at "
          f"{runs['f32']['final_lnl']}")
    sinst = PhyloInstance(read_bytefile(aln), dtype=torch.float32,
                          device=device, save_memory=True, clv_dtype=bf16)
    reset_counts()
    with open(start) as f:
        sinst.evaluate(sinst.tree_from_newick(f.read()), full=True)
    sync(device)
    check_pooled(read_counts(), "a -S instance with bfloat16 storage")
    check(sinst.engines[4].sev.pool.dtype == bf16, "the -S pool is "
          f"{sinst.engines[4].sev.pool.dtype}, not bfloat16")
    del sinst
    out["cli_sev_fe"] = {**runs, "gap": gap}
    log(f"  -S -f e: bfloat16 storage {runs['bf16']['final_lnl']!r} in "
        f"{runs['bf16']['wall_s']:.1f} s, float32 "
        f"{runs['f32']['final_lnl']!r} in {runs['f32']['wall_s']:.1f} s "
        f"(gap {gap:.4f}); savings {runs['bf16']['saving']:.3f} / "
        f"{runs['f32']['saving']:.3f}; no newview kernel launched; pool "
        "bfloat16")
    return out


# -- phase 22: site-parallel ranks --------------------------------------------


def site_digests(x, rows, chunk: int = 32) -> list:
    """A 64-bit digest of each of `rows` of x [rows, B, ...] (float32 or
    int32): the row's bits as int32 words, each times a fixed odd
    pseudo-random int64 weight of its position, summed modulo 2^64 (a sum
    of integers, so the same in any order).  Two rows of the same shape
    with one differing bit always differ in digest; rows differing in
    several places collide with probability about 2^-64.  The weights
    depend only on the position within the row, so a rank's window and
    the same block range of the one-process arena are compared directly."""
    import torch
    gen = torch.Generator(device=x.device)
    gen.manual_seed(SITE_DIGEST_SEED)
    w = torch.randint(-2 ** 62, 2 ** 62, tuple(x.shape[1:]), generator=gen,
                      device=x.device, dtype=torch.int64) | 1
    out = []
    for lo in range(0, rows.shape[0], chunk):
        v = x[rows[lo:lo + chunk]].contiguous().view(torch.int32).to(
            torch.int64)
        out += (v * w).flatten(1).sum(dim=1).tolist()
    return out


def site_instance(data, setup: dict, device, **kw):
    """The real-size f32 chunk-tier instance of `data` (the whole file or
    a rank's columns), the set-up's models, and its random tree with the
    set-up's branch lengths."""
    import torch
    from examl_tpu_torch.instance import PhyloInstance
    from examl_tpu_torch.transfer import install_model_params
    inst = PhyloInstance(data, dtype=torch.float32, device=device,
                         newview="chunk", **kw)
    install_model_params(inst, [(np.asarray(r), np.asarray(f), float(a))
                                for r, f, a in setup["params"]])
    return inst, site_tree(inst, setup)


def site_tree(inst, setup: dict):
    """The set-up's random tree with its branch lengths."""
    tree = inst.random_tree(setup["seed"])
    for (p, _), z in zip(tree.all_branches(), setup["zs"]):
        p.z[:] = [float(z)]
    return tree


def site_path(inst, tree, device, windows) -> dict:
    """The site-parallel main path, the same in the one process and on
    each rank: a full-traversal evaluate (kernel B1 on the chunk tier),
    the digests of the inner nodes' arena rows and scalers over each of
    `windows` (block ranges of this instance's arena), one makenewz, one
    whole-tree gradient pass and one batched lazy scan plan (which leaves
    its node pruned); the counts are those of the whole path."""
    from examl_tpu_torch.optimize.branch import tree_gradients
    from examl_tpu_torch.search import batchscan, spr
    import torch
    eng = inst.engines[4]
    ntaxa = inst.alignment.ntaxa
    reset_counts()
    lnl = inst.evaluate(tree, full=True)
    sync(device)
    rows = torch.as_tensor(eng.row_map[ntaxa + 1:], device=device)
    digests = [{"clv": site_digests(eng.clv[:, b0:b1], rows),
                "scaler": site_digests(eng.scaler[:, b0:b1], rows)}
               for b0, b1 in windows]
    p = tree.nodep[ntaxa + 3]
    z = inst.makenewz(tree, p, p.back, list(p.z), maxiter=30)
    _, d1, d2 = tree_gradients(inst, tree)
    ctx = spr.SprContext(inst, thorough=False, do_cutoff=False)
    s = next(tree.nodep[k] for k in tree.inner_numbers()
             if not tree.is_tip(tree.nodep[k].next.back.number)
             and not tree.is_tip(tree.nodep[k].next.next.back.number))
    q1, q2 = s.next.back, s.next.next.back
    spr.remove_node(inst, tree, ctx, s)
    plan = batchscan.plan_for_endpoints(inst, tree, s, q1, q2, 1, 5)
    cand = batchscan.run_plan(inst, tree, plan)
    sync(device)
    counts = read_counts()
    check_tier(counts, "chunk", "site-parallel path")
    return {"lnl": lnl, "pp": inst.per_partition_lnl.tolist(),
            "digests": digests, "nr_z": [float(v) for v in z],
            "d1": d1.ravel().tolist(), "d2": d2.ravel().tolist(),
            "candidates": [float(v) for v in cand], "counts": counts,
            "nr_branch": p.number}


def tail_alignment(K: int, blocks: int, seed: int):
    """TAIL_TAXA taxa of random K-state codes (DNA, amino acids or binary,
    ~2% gaps) in three partitions of `blocks` blocks together, the first
    straddling the middle (so both ranks of two hold part of it), each a
    few columns short of its blocks; patterns uncompressed."""
    from examl_tpu_torch.io.alignment import (AlignmentData, PartitionData,
                                              empirical_frequencies)
    rng = np.random.default_rng(seed)
    half = blocks // 2
    split = [half // 2 + 1, half - 1]
    split.append(blocks - sum(split))
    dt = datatype_of(K)
    states = {4: np.array([1, 2, 4, 8], np.uint8), 2: np.array(
        [1, 2], np.uint8), 20: np.arange(20, dtype=np.uint8)}[K]
    parts = []
    for g, nb in enumerate(split):
        W = nb * 128 - 3
        codes = states[rng.integers(0, K, (TAIL_TAXA, W))]
        codes[rng.random((TAIL_TAXA, W)) < 0.02] = dt.undetermined_code
        wts = np.ones(W, np.int64)
        parts.append(PartitionData(
            name=f"tail{g}", datatype=dt,
            model_name="WAG" if K == 20 else "GTR", patterns=codes,
            weights=wts, empirical_freqs=empirical_frequencies(codes, wts,
                                                               dt),
            use_empirical_freqs=K != 20, optimize_freqs=False))
    return AlignmentData([f"t{i}" for i in range(TAIL_TAXA)], parts)


def has_tail(blocks: int, tile) -> bool:
    """Whether `blocks` blocks of 128 sites end in a partial dataflow tile
    of B1 (tile = (units per tile, sites per unit))."""
    units, sites = tile
    return (blocks * (128 // sites)) % units != 0


def tail_blocks(b1_config: list) -> dict:
    """B1's dataflow tile (units per tile, sites per unit) per instance of
    TAIL_INSTANCES, and the smallest window of 9 to 64 blocks that ends in
    a partial tile of each instance that can have one (9 where none can:
    an instance whose tile is one unit of 128 sites never has a partial
    tile at block granularity)."""
    tiles = {f"{d} K={K}": (c["tile_units"], c["tile_sites"])
             for d, K in TAIL_INSTANCES for c in b1_config
             if (c["dtype"], c["K"], c["kind"]) == (d, K, 3)}
    possible = [t for t in tiles.values()
                if any(has_tail(B, t) for B in range(9, 65))]
    B = next((B for B in range(9, 65)
              if all(has_tail(B, t) for t in possible)), 9)
    return {"tiles": tiles, "window_blocks": B,
            "tail": {k: has_tail(B, t) for k, t in tiles.items()}}


def site_tail_check(path: str, storage: str, K: int, group, device,
                    seed: int) -> dict:
    """Kernel B1 (instance K, `storage` CLVs: float32 or bfloat16 with
    float32 compute) against its plain version on this rank's window of a
    tail alignment: the window's full traversal with random models and a
    random tree, both on the same operands; scalers equal and no
    differing cell."""
    import torch
    from examl_tpu_torch.instance import PhyloInstance
    from examl_tpu_torch.io.bytefile import read_bytefile_for_process
    from examl_tpu_torch.ops import fastpath, newview_chunk
    data = read_bytefile_for_process(path, group.rank, group.size)
    inst = PhyloInstance(data, dtype=torch.float32, device=device,
                         newview="chunk", clv_dtype=getattr(torch, storage),
                         local_window=(group.rank, group.size), group=group)
    eng = inst.engines[K]
    check(newview_chunk.ROUTE[(K, eng.clv.dtype)] == "flow",
          f"{storage} K={K} is not on B1's dataflow route")
    _, eng.models = random_models(eng.num_parts,
                                  np.random.default_rng(seed), eng.dtype,
                                  device, K=K)
    tree = inst.random_tree(seed)
    rng = np.random.default_rng(seed + 1)
    for p, _ in tree.all_branches():
        p.z[:] = [float(rng.uniform(0.05, 0.98))]
    flat = tree.flat_full_traversal(tree.centroid_branch())
    st = eng._structure(flat)
    zl, zr = fastpath.refresh_z(st, flat, 1, eng.dtype, device)
    pmat = newview_chunk.chunk_operands(eng.models, zl, zr)
    args = (eng.tips.codes, eng.tips.table, eng.block_part_i32, st.launch,
            st.lidx, st.ridx, st.lcode, st.rcode, pmat, eng.scale_exp)
    clv_k, sc_k = torch.zeros_like(eng.clv), torch.zeros_like(eng.scaler)
    clv_p, sc_p = torch.zeros_like(eng.clv), torch.zeros_like(eng.scaler)
    newview_chunk.chunk_apply(clv_k, sc_k, *args, newview_chunk.Dataflow(
        st.flow_rows, st.wait, newview_chunk.Ready()))
    newview_chunk.chunk_apply_plain(clv_p, sc_p, *args)
    sync(device)
    rows = torch.as_tensor(np.sort(st.row_of[st.row_of >= 0]),
                           device=device)
    rel, abs_err, differing = compare_arenas(
        clv_k[rows], clv_p[rows], sc_k[rows], sc_p[rows],
        f"site-parallel tail window {storage} K={K}")
    check(differing == 0, f"tail window {storage} K={K}: {differing} cells "
          "differ between B1 and its plain version")
    return {"instance": f"{storage} K={K}", "K": K, "blocks": eng.B,
            "block_offset": eng.bucket.block_offset,
            "max_abs_err": abs_err, "max_rel_err": rel,
            "differing_cells": differing, "rows": int(rows.shape[0])}


def median_ms(fn, n: int) -> float:
    walls = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t)
    return float(np.median(walls) * 1e3)


def site_rank_real(cfg: dict, group, device) -> dict:
    """The real-size rank: its sliced read, the site-parallel path, and
    (after the counts were read) the timings: kernel B1 over the window's
    launch table, one allreduce of the per-partition lnL, and one
    Newton-Raphson iteration's derivatives with and without their
    allreduce.  Every rank makes the same calls."""
    import torch
    from examl_tpu_torch.io.bytefile import read_bytefile_for_process
    from examl_tpu_torch.ops import fastpath, kernels, newview_chunk
    t0 = time.perf_counter()
    data = read_bytefile_for_process(cfg["aln"], group.rank, group.size)
    inst, tree = site_instance(data, cfg, device,
                               local_window=(group.rank, group.size),
                               group=group)
    eng = inst.engines[4]
    setup_s = time.perf_counter() - t0
    out = site_path(inst, tree, device, [(0, eng.B)])
    out.update(rank=group.rank, device=str(device), blocks=eng.B,
               block_offset=eng.bucket.block_offset,
               columns=sum(p.width for p in data.partitions),
               setup_s=setup_s)
    tree = site_tree(inst, cfg)
    flat = tree.flat_full_traversal(tree.centroid_branch())
    inst.evaluate(tree, full=True)
    st = eng._structure(flat)
    zl, zr = fastpath.refresh_z(st, flat, 1, eng.dtype, device)
    pmat = newview_chunk.chunk_operands(eng.models, zl, zr)
    flow = newview_chunk.Dataflow(st.flow_rows, st.wait, eng.ready)
    out["b1_ms"] = time_ms(lambda: newview_chunk.chunk_apply(
        eng.clv, eng.scaler, eng.tips.codes, eng.tips.table,
        eng.block_part_i32, st.launch, st.lidx, st.ridx, st.lcode,
        st.rcode, pmat, eng.scale_exp, flow), device, REPS)
    M = inst.num_parts
    group.allreduce(np.zeros(M))
    out["allreduce_ms"] = median_ms(lambda: group.allreduce(np.zeros(M)),
                                    SITE_ALLREDUCE_CALLS)
    p = tree.nodep[out["nr_branch"]]
    inst.new_view(tree, p)
    inst.new_view(tree, p.back)
    sumt = eng.make_sumtable(p.number, p.back.number)
    zt = eng._z(p.z)

    def derivatives():
        d1, d2 = kernels.nr_derivatives(eng.models, eng.block_part,
                                        eng.weights, sumt, zt, 1, None)
        return torch.stack([d1, d2]).cpu().numpy()

    derivatives()
    out["nr_iteration_ms"] = median_ms(derivatives, SITE_NR_CALLS)
    out["nr_iteration_allreduce_ms"] = median_ms(
        lambda: group.allreduce(derivatives()), SITE_NR_CALLS)
    return out


def site_child(mode: str, rank: int, port: int, arg: str) -> int:
    """One rank of phase 22, in a process of its own: `real` (the
    site-parallel main path at real size on this rank's sliced read, its
    timings, and the tail windows) or `cli` (the port's CLI with the
    launch flags).  Prints "SITE_RESULT {json}"."""
    import types
    from examl_tpu_torch.parallel import launch
    if mode == "cli":
        from examl_tpu_torch.cli import main as cli
        argv = json.loads(arg) + ["--coordinator", f"127.0.0.1:{port}",
                                  "--nprocs", str(SITE_RANKS),
                                  "--procid", str(rank)]
        reset_counts()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        wall = time.perf_counter() - t0
        print("SITE_RESULT " + json.dumps({"rc": rc, "wall_s": wall,
                                           "counts": read_counts()}),
              flush=True)
        return rc
    cfg = json.loads(arg)
    group = launch.init_distributed(types.SimpleNamespace(
        coordinator=f"127.0.0.1:{port}", nprocs=SITE_RANKS, procid=rank))
    try:
        device = launch.use_rank_device(rank)
        out = site_rank_real(cfg, group, device)
        release_memory()
        out["tails"] = [site_tail_check(cfg["tails"][str(K)], d, K, group,
                                        device, cfg["seed"] + K)
                        for d, K in TAIL_INSTANCES]
        out["collectives"] = group.collectives
    finally:
        launch.shutdown(group)
    print("SITE_RESULT " + json.dumps(out), flush=True)
    return 0


def free_ports(n: int) -> list:
    """n distinct free ports on 127.0.0.1, from below the kernel's usual
    ephemeral range (32768-60999), so that no client socket of a group's
    connections can take one before its rank 0 listens on it."""
    import socket
    rng = np.random.default_rng()
    out = []
    while len(out) < n:
        port = int(rng.integers(20000, 32000))
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        if port not in out:
            out.append(port)
    return out


def site_spawn(mode: str, arg: str, port: int) -> list:
    """SITE_RANKS processes of `site_child(mode, ...)` whose group meets
    at `port`, started now; call site_wait on the result."""
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "chip_smoke.py"),
         "--site-child", mode, "--site-rank", str(r), "--site-port",
         str(port), "--site-arg", arg], cwd=HERE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(SITE_RANKS)]


def site_wait(procs, what: str) -> list:
    """Each rank's SITE_RESULT; a rank that fails or outlives
    SITE_TIMEOUT_S fails the phase, and every rank is stopped."""
    out = []
    try:
        for r, p in enumerate(procs):
            try:
                o, e = p.communicate(timeout=SITE_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"{what}: rank {r} ran past "
                                   f"{SITE_TIMEOUT_S} s")
            res = [json.loads(line[12:]) for line in o.splitlines()
                   if line.startswith("SITE_RESULT ")]
            check(p.returncode == 0 and len(res) == 1,
                  f"{what}: rank {r} exited {p.returncode}: {e[-2000:]}")
            out.append(res[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def site_rel(a, b) -> float:
    """max |a - b| over max |b| (vectors whose entries pass through zero,
    such as the gradients of optimized branches, in one norm)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def phase_site_parallel(device, setup: dict, anchor_whole: dict, fd: dict,
                        b1_config: list, smi: str, seed: int,
                        keep: dict) -> dict:
    """Two ranks (processes) in a gloo group over 127.0.0.1 share the one
    card, rank r on cuda:(r mod device_count): the real-size DNA set-up
    as a byteFile, each rank reading only its columns, against the one
    process; B1 against its plain version on windows with a tail; and
    the CLI's ref49 -f e (whole tier) and -f d over two ranks.  The
    one-process instance and its tree go into `keep` (phase 29 reads
    its arena)."""
    import torch
    from examl_tpu_torch.io.bytefile import read_bytefile, write_bytefile
    from examl_tpu_torch.parallel.sharding import block_window
    t0 = time.perf_counter()
    work = os.path.join(HERE, "build", "site_parallel")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    aln = os.path.join(work, "real.binary")
    write_bytefile(aln, setup["ad"])
    tail = tail_blocks(b1_config)
    tails = {}
    for K in sorted({K for _, K in TAIL_INSTANCES}):
        tails[str(K)] = os.path.join(work, f"tail{K}.binary")
        write_bytefile(tails[str(K)], tail_alignment(
            K, SITE_RANKS * tail["window_blocks"], seed + K))
    cfg = {"aln": aln, "tails": tails, "seed": setup["seed"],
           "params": [[np.asarray(r).tolist(), np.asarray(f).tolist(),
                       float(a)] for r, f, a in setup["params"]],
           "zs": np.asarray(setup["zs"]).tolist()}
    fe_dir = os.path.join(work, "fe")
    fd_dir = os.path.join(work, "fd")
    fe = fd_ranks = real = []
    ports = free_ports(3)
    try:
        # The CLI pairs start first: host-bound, they overlap the rest.
        fe = site_spawn("cli", json.dumps([
            "-s", os.path.join(REF49, "aln49.binary"), "-t",
            os.path.join(REF49, "TreeFile"), "-n", "smoke", "-w", fe_dir,
            "-f", "e", "--newview", "whole"]), ports[0])
        fd_ranks = site_spawn("cli", json.dumps([
            "-s", fd["aln"], "-t", fd["start_tree"], "-n", "smoke", "-w",
            fd_dir, "-i", "5"]), ports[1])
        # The one process over the whole file, packed as two ranks pack;
        # its engine is freed before the ranks build theirs.
        inst, tree = site_instance(read_bytefile(aln), cfg, device,
                                   block_multiple=SITE_RANKS)
        B = inst.engines[4].B
        windows = [block_window(B, r, SITE_RANKS)
                   for r in range(SITE_RANKS)]
        one = site_path(inst, tree, device, windows)
        keep["one"] = (inst, site_tree(inst, cfg))
        del inst, tree
        real = site_spawn("real", json.dumps(cfg), ports[2])
        ranks = site_wait(real, "real-size ranks")
        fe_res = site_wait(fe, "ref49 -f e ranks")
        fd_res = site_wait(fd_ranks, "-f d ranks")
    finally:
        for p in fe + fd_ranks + real:
            if p.poll() is None:
                p.kill()
                p.wait()

    # Real size: the windows tile the one-process arena bit for bit.
    reduced = ["lnl", "pp", "nr_z", "d1", "d2", "candidates"]
    for r, res in enumerate(ranks):
        check(res["blocks"] == windows[r][1] - windows[r][0]
              and res["block_offset"] == windows[r][0],
              f"rank {r} holds blocks {res['block_offset']}+{res['blocks']}"
              f", not {windows[r]}")
        for part in ("clv", "scaler"):
            bad = int(np.sum(np.asarray(res["digests"][0][part], object)
                             != np.asarray(one["digests"][r][part],
                                           object)))
            check(bad == 0, f"rank {r}: {bad} inner-node {part} rows differ "
                  "from the one-process rows of its window")
        check(res["counts"]["b1"] > 0, f"rank {r} launched no B1")
    check(all(ranks[0][k] == ranks[1][k] for k in reduced),
          "the ranks' reduced values differ")
    check(ranks[0]["collectives"] == ranks[1]["collectives"],
          f"ranks issued {ranks[0]['collectives']} and "
          f"{ranks[1]['collectives']} collectives")
    check(sum(res["columns"] for res in ranks) == setup["patterns"]
          and max(res["columns"] for res in ranks) < setup["patterns"],
          "the ranks' reads do not tile the alignment")
    rel = {"lnl": site_rel(ranks[0]["pp"], one["pp"]),
           "nr_z": site_rel(ranks[0]["nr_z"], one["nr_z"]),
           "d1": site_rel(ranks[0]["d1"], one["d1"]),
           "d2": site_rel(ranks[0]["d2"], one["d2"]),
           "candidates": site_rel(ranks[0]["candidates"],
                                  one["candidates"])}
    check(abs(ranks[0]["lnl"] - one["lnl"]) <= 1e-9 * abs(one["lnl"])
          and rel["lnl"] <= 1e-9, f"lnL {ranks[0]['lnl']!r} vs one process "
          f"{one['lnl']!r} (per partition rel {rel['lnl']:.2e})")
    for k in ("nr_z", "d1", "d2"):
        check(rel[k] <= 1e-6, f"{k}: rel {rel[k]:.2e} against one process")
    check(rel["candidates"] <= 1e-8,
          f"candidate lnLs: rel {rel['candidates']:.2e} against one process")
    check(any(tail["tail"].values()), "no instance's window ends in a "
          f"partial tile ({tail['tiles']})")
    for res in ranks:
        for t in res["tails"]:
            check(t["blocks"] == tail["window_blocks"],
                  f"tail window {t['instance']}: {t['blocks']} blocks, "
                  f"expected {tail['window_blocks']}")

    # Through the CLI: -f e on ref49, whole tier.
    floor = LNL_REF_BINARY - MODOPT_EPSILON
    for r, res in enumerate(fe_res):
        check_tier(res["counts"], "whole", f"ref49 -f e rank {r}")
    with open(os.path.join(fe_dir, "ExaML_log.smoke")) as f:
        fe_lnl = float(f.read().split()[-1])
    check(fe_lnl >= floor, f"2-rank -f e endpoint {fe_lnl} below {floor}")
    fe_rel = abs(fe_lnl - anchor_whole["fe_final_lnl"]) / abs(fe_lnl)
    check(fe_rel <= 1e-6, f"2-rank -f e endpoint {fe_lnl!r} vs one process "
          f"{anchor_whole['fe_final_lnl']!r} (rel {fe_rel:.2e})")
    for d in (fe_dir, fd_dir):
        names = set(os.listdir(d))
        check({"ExaML_info.smoke", "ExaML_log.smoke",
               "ExaML_modelFile.smoke"} <= names,
              f"rank 0 wrote {sorted(names)} in {d}")
        stray = [n for n in os.listdir(os.path.join(d, ".proc1"))
                 if n.startswith("ExaML_")
                 and not n.startswith("ExaML_binaryCheckpoint.")]
        check(stray == [], f"rank 1 wrote {stray}")
    # -f d on phase 7's alignment: the result re-evaluated by one process.
    for r, res in enumerate(fd_res):
        check_tier(res["counts"], "chunk", f"-f d rank {r}")
    with open(os.path.join(fd_dir, "ExaML_info.smoke")) as f:
        fd_lnl = float(re.search(r"Likelihood of best tree: (\S+)",
                                 f.read()).group(1))
    lnl32, _, _ = reevaluate(fd_dir, fd["aln"], torch.float32, device)
    check(abs(lnl32 - fd_lnl) <= 1e-6 * abs(fd_lnl),
          f"2-rank -f d result re-evaluates to {lnl32} against its {fd_lnl}")
    release_memory()
    wall = time.perf_counter() - t0
    out = {"window_blocks": [res["blocks"] for res in ranks],
           "one_process": {k: one[k] for k in ("lnl", "counts")},
           "ranks": [{k: res[k] for k in (
               "rank", "device", "blocks", "block_offset", "columns",
               "setup_s", "lnl", "pp", "counts", "b1_ms", "allreduce_ms",
               "nr_iteration_ms", "nr_iteration_allreduce_ms",
               "collectives", "tails")} for res in ranks],
           "rel": rel, "tail_tiles": tail,
           "fe": {"lnl": fe_lnl, "rel_one_process": fe_rel,
                  "wall_s": [res["wall_s"] for res in fe_res],
                  "counts": [res["counts"] for res in fe_res]},
           "fd": {"lnl": fd_lnl, "reevaluated_f32": lnl32,
                  "wall_s": [res["wall_s"] for res in fd_res],
                  "counts": [res["counts"] for res in fd_res]},
           "wall_s": wall, "device": smi}
    for res in ranks:
        log(f"  rank {res['rank']} on {res['device']}: blocks "
            f"{res['block_offset']}..{res['block_offset'] + res['blocks'] - 1}"
            f" ({res['columns']} columns read); B1 {res['counts']['b1']} "
            f"launches on the path, {res['b1_ms']:.3f} ms per traversal of "
            f"its window; allreduce {res['allreduce_ms']:.3f} ms (median of "
            f"{SITE_ALLREDUCE_CALLS}); NR iteration "
            f"{res['nr_iteration_ms']:.3f} ms, "
            f"{res['nr_iteration_allreduce_ms']:.3f} ms with its "
            f"allreduce; {res['collectives']} collectives [{smi}]")
        for t in res["tails"]:
            units, sites = tail["tiles"][t["instance"]]
            log(f"    tail window {t['instance']}: {t['blocks']} blocks from "
                f"{t['block_offset']} (tiles of {units} x {sites} sites, "
                + ("a partial last tile" if tail["tail"][t["instance"]] else
                   "no partial tile possible")
                + f"): B1 vs plain {t['differing_cells']} differing cells, "
                "scalers equal")
    log(f"  windows bit for bit equal to the one-process arena rows; lnL "
        f"{ranks[0]['lnl']!r} vs {one['lnl']!r}; rel: per-partition lnL "
        f"{rel['lnl']:.2e}, NR z {rel['nr_z']:.2e}, d1 {rel['d1']:.2e}, d2 "
        f"{rel['d2']:.2e}, candidates {rel['candidates']:.2e}; both ranks "
        "bitwise equal")
    log(f"  CLI over 2 ranks: ref49 -f e --newview whole {fe_lnl!r} (one "
        f"process {anchor_whole['fe_final_lnl']!r}, rel {fe_rel:.2e}) in "
        f"{max(out['fe']['wall_s']):.1f} s; -f d -i 5 {fd_lnl!r}, "
        f"re-evaluated {lnl32!r}, in {max(out['fd']['wall_s']):.1f} s; "
        f"phase wall {wall:.1f} s [{smi}]")
    return out


# -- phase 23: the fleet ------------------------------------------------------


class FleetStop(RuntimeError):
    """Raised by phase 23's patched checkpoint to stop a fleet run after
    its first checkpoint, as a kill would."""


def fleet_trees(inst, seed: int, n: int):
    """n start jobs' random trees, from the jobs' derived seeds."""
    from examl_tpu_torch.fleet import seeds
    return [inst.random_tree(seeds.derive(seed, "start", k))
            for k in range(n)]


def arena_digests(x, rows) -> list:
    """site_digests of arena rows of any storage dtype (the row's bits
    read as int32 words first)."""
    import torch
    return site_digests(x if x.dtype == torch.int32 else
                        x.view(torch.int32), rows)


def fleet_rows(ev, eng, preps):
    """The stacked arena rows the inner nodes of each job write, as
    indices into its stacked arena, and into its own arena."""
    import torch
    Rj = eng.num_rows
    own = [torch.as_tensor(p.st.row_of[eng.ntips + 1:], device=eng.device)
           for p in preps]
    return [j * Rj + r for j, r in enumerate(own)], own


def fleet_split(ev, preps, lnl, device, label: str) -> dict:
    """The same batch with the free-memory margin raised so that only
    three jobs' stacked arenas fit: it runs in parts of three in queue
    order, with the same lnL bit for bit."""
    import torch
    from examl_tpu_torch.fleet import batch
    eng = ev.engines[0]
    per_job = eng.num_rows * eng.B * eng.lane * (
        eng.R * eng.K * eng.clv.element_size() + 4)
    release_memory()
    free, _ = torch.cuda.mem_get_info(device)
    free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(
        device)
    margin = batch.ARENA_MARGIN
    batch.ARENA_MARGIN = int(free - 3.5 * per_job)
    notes = []
    ev.log = notes.append
    try:
        reset_counts()
        parted = ev.eval_batch(preps)
        sync(device)
        counts = read_counts()
    finally:
        batch.ARENA_MARGIN = margin
        ev.log = lambda *_: None
    parts = -(-len(preps) // 3)
    check(np.array_equal(parted, lnl) and counts["fleet_tables"] == parts
          and len(notes) == 1, f"{label}: the batch in parts gave "
          f"{counts['fleet_tables']} tables ({parts} expected), lnL equal "
          f"{np.array_equal(parted, lnl)}, notes {notes}")
    log(f"  {label}: cut to fit the card's memory, the batch ran in {parts} "
        f"tables with the same lnL bit for bit ({notes[0]})")
    return {"parts": parts, "counts": counts, "note": notes[0]}


def fleet_tree_batch(inst, trees, setup: dict, device, label: str,
                     reps: int, time_b1: bool, keep=None) -> dict:
    """One batch of tree jobs through the BatchEvaluator (the main path:
    every engine's jobs in one launch table), against each job evaluated
    alone: per-row 64-bit digests of every job's slice of the stacked
    arena and scaler equal those of its own arena, and the per-partition
    lnL equal bit for bit.  With `time_b1`, the batch's B1 launch is timed
    (CUDA events, the stacked table built once) against J times the
    one-traversal bound, with the host time of building the table.
    `keep` (a dict) receives the prepared jobs and their lnL."""
    import torch
    from examl_tpu_torch.fleet import batch
    from examl_tpu_torch.ops import fastpath, newview_chunk
    ev = inst.batch_evaluator()
    J = len(trees)
    t0 = time.perf_counter()
    preps = [ev.prepare(t) for t in trees]
    prepare_ms = (time.perf_counter() - t0) * 1e3
    release_memory()
    sync(device)
    t0 = time.perf_counter()
    ev.eval_batch(preps)             # the first batch: arena allocation
    sync(device)
    first_wall = time.perf_counter() - t0
    reset_counts()
    sync(device)
    t0 = time.perf_counter()
    lnl = ev.eval_batch(preps)
    sync(device)
    wall = time.perf_counter() - t0
    counts = read_counts()
    check(np.isfinite(lnl).all() and lnl.shape == (J, len(inst.models)),
          f"{label}: batch lnL {lnl.shape} not finite")
    want = sum(newview_chunk.table_launches(
        e.K, e.storage_dtype, sum(len(p.st.launch) for p in preps))
        for e in inst.engines.values()) if device.type == "cuda" else 0
    check(counts["fleet_tables"] == len(inst.engines) and counts["b1"] ==
          want and counts["b2"] == 0 and counts["full_traversals"] == 0,
          f"{label}: {counts['b1']} B1 launches ({want} expected) over "
          f"{counts['fleet_tables']} stacked tables for "
          f"{len(inst.engines)} engines")
    out = {"jobs": J, "lnl": lnl.sum(axis=1).tolist(), "wall_s": wall,
           "first_wall_s": first_wall, "prepare_ms": prepare_ms,
           "counts": counts, "engines": {}}
    if time_b1 and device.type == "cuda":
        out["split"] = fleet_split(ev, preps, lnl, device, label)
    digests = []
    for eng in inst.engines.values():
        clv, scaler = ev._traverse(eng, preps)
        rows, _ = fleet_rows(ev, eng, preps)
        digests.append([(arena_digests(clv, r), site_digests(scaler, r))
                        for r in rows])
        e = {"K": eng.K, "storage": str(eng.storage_dtype).removeprefix(
                 "torch."),
             "arena_gb": (clv.numel() * clv.element_size()
                          + scaler.numel() * 4) / 1e9,
             "table_rows": int(sum(len(p.st.launch) for p in preps)),
             "launches": newview_chunk.table_launches(
                 eng.K, eng.storage_dtype,
                 sum(len(p.st.launch) for p in preps))}
        if time_b1:
            Rj = eng.num_rows
            t1 = time.perf_counter()
            table = fastpath.stack_tables([p.st for p in preps], Rj,
                                          eng.device)
            sync(device)
            e["stack_table_host_ms"] = (time.perf_counter() - t1) * 1e3
            zs = [fastpath.refresh_z_host(p.st, p.flat, ev.C)
                  for p in preps]
            z = torch.as_tensor(np.stack([
                np.concatenate([a for a, _ in zs]),
                np.concatenate([b for _, b in zs])]), dtype=eng.dtype,
                device=device)
            pmat = newview_chunk.chunk_operands(eng.models, z[0], z[1])
            u = newview_chunk.tip_products(pmat, eng.tips.table)
            flow = newview_chunk.Dataflow(table.flow_rows, table.wait,
                                          newview_chunk.Ready())
            e["b1_ms"] = time_ms(lambda: newview_chunk.chunk_apply_cuda(
                clv, scaler, eng.tips.codes, u, eng.block_part_i32,
                table.launch, table.lidx, table.ridx, table.lcode,
                table.rcode, pmat, eng.scale_exp, flow), device, reps)
            b = [traversal_bound(p.flat, setup, eng) for p in preps]
            nbytes = sum(x["bytes_per_traversal"] for x in b)
            flops = sum(x["flops_per_traversal"] for x in b)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / F32_FLOPS * 1e3
            e["bound_ms"] = max(bytes_ms, ops_ms)
            e["one_traversal_bound_ms"] = b[0]["bound_ms"]
            e["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
        del clv, scaler
        release_memory()
        out["engines"][str(eng.K)] = e
    walls, cold = [], []
    for j, tree in enumerate(trees):
        for runs in (cold, walls):   # the first builds the job's layout
            sync(device)
            t1 = time.perf_counter()
            inst.evaluate(tree, full=True)
            sync(device)
            runs.append(time.perf_counter() - t1)
        for (eng, dg) in zip(inst.engines.values(), digests):
            _, own = fleet_rows(ev, eng, [preps[j]])
            check(arena_digests(eng.clv, own[0]) == dg[j][0]
                  and site_digests(eng.scaler, own[0]) == dg[j][1],
                  f"{label}: job {j}'s stacked arena rows (K={eng.K}) differ "
                  "from its one-at-a-time arena")
        check(np.array_equal(inst.per_partition_lnl, lnl[j]),
              f"{label}: job {j}'s batch lnL {lnl[j].tolist()} is not its "
              f"one-at-a-time {inst.per_partition_lnl.tolist()}")
    if keep is not None:
        keep.update(preps=preps, lnl=lnl)
    out["one_at_a_time_s"] = walls
    out["one_at_a_time_total_s"] = float(sum(walls))
    out["one_at_a_time_cold_total_s"] = float(sum(cold))
    log(f"  {label}: {J} jobs, B1 {counts['b1']} launch(es) over "
        f"{counts['fleet_tables']} stacked table(s) ("
        + ", ".join(f"K={K}: {e['table_rows']} rows, {e['arena_gb']:.2f} "
                    f"GB" for K, e in out["engines"].items())
        + f"); batch wall {wall * 1e3:.1f} ms (the first {first_wall * 1e3:.1f}"
        f") against {J} evaluates {out['one_at_a_time_total_s'] * 1e3:.1f} "
        f"ms (the first of each {sum(cold) * 1e3:.1f}); every job's rows "
        "and lnL bit for bit as alone")
    for K, e in out["engines"].items():
        if "b1_ms" in e:
            log(f"  {label} K={K}: B1 {e['b1_ms']:.3f} ms for the batch "
                f"against {J} x {e['one_traversal_bound_ms']:.3f} = "
                f"{e['bound_ms']:.3f} ms bound ({e['bound_by']}); the "
                f"stacked table built in {e['stack_table_host_ms']:.1f} ms "
                f"of host time, the jobs prepared in {prepare_ms:.1f} ms")
    return out


def fleet_bootstrap(inst, tree, device, n: int) -> dict:
    """n bootstrap replicates as one weights batch (one CLV pass, one
    batched root reduction), replicates 0-3 against one-at-a-time
    evaluates with their weights swapped in."""
    from examl_tpu_torch.fleet import bootstrap, seeds
    from examl_tpu_torch.fleet.driver import FleetDriver
    reps = [bootstrap.bootstrap_weights(inst.alignment,
                                        seeds.derive(7, "bootstrap", k))
            for k in range(n)]
    ev = inst.batch_evaluator()
    ev.eval_weights_batch(tree, reps[:2])            # warm-up
    walls = []
    for k in range(3):            # the first call at n replicates, then
        if k == 1:                # two more; the counts of the last
            reset_counts()
        sync(device)
        t0 = time.perf_counter()
        lnl = ev.eval_weights_batch(tree, reps)
        sync(device)
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls[1:]))
    eng = inst.engines[4]
    t0 = time.perf_counter()
    bootstrap.packed_weights_batch(eng.bucket, reps)
    pack_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    check_tier(counts, "chunk", "bootstrap batch")
    check(counts["full_traversals"] == 2 and np.isfinite(lnl).all(),
          f"bootstrap batch: {counts['full_traversals']} CLV passes")
    seq = FleetDriver(inst)._sequential_weights(tree, reps[:4])
    rel = float(np.max(np.abs(lnl[:4] - seq) / np.abs(seq)))
    check(rel <= 1e-12, f"bootstrap replicates 0-3 rel {rel:.3e} against "
          "one-at-a-time evaluates")
    out = {"replicates": n, "wall_s": wall, "first_wall_s": walls[0],
           "ms_per_replicate": wall * 1e3 / n, "host_packing_ms": pack_ms,
           "bitwise_0_3": bool(np.array_equal(lnl[:4], seq)),
           "rel_0_3": rel, "counts": counts,
           "lnl_0_3": lnl[:4].sum(axis=1).tolist()}
    log(f"  bootstrap: {n} replicates in {wall * 1e3:.1f} ms, the median "
        f"of 2 calls after the first at {n} ({walls[0] * 1e3:.1f} ms) "
        f"({out['ms_per_replicate']:.3f} ms each, of which "
        f"{pack_ms / n:.3f} packing the weights on the host; one CLV pass "
        f"a call, B1 {counts['b1']} launch(es) in 2 calls); replicates 0-3 "
        + ("bit for bit" if out["bitwise_0_3"] else f"rel {rel:.2e}")
        + " as one at a time")
    return out


def fleet_table(path: str) -> dict:
    rows = {}
    for line in open(path):
        if line.startswith("#"):
            continue
        jid, kind, idx, seed, cyc, lnl, status, cause, att = line.split()
        rows[jid] = {"kind": kind, "seed": int(seed), "cycles": cyc,
                     "lnl": float(lnl), "status": status}
    return rows


def fleet_cli(device, out_dir: str, fd: dict, seed: int) -> dict:
    """-b, -N with smoothing cycles, --serve and -R through the CLI on
    phase 7's alignment, its start tree as -t."""
    import shutil
    import torch
    from examl_tpu_torch.fleet import driver
    from examl_tpu_torch.instance import PhyloInstance
    from examl_tpu_torch.io.bytefile import read_bytefile
    base = os.path.join(out_dir, "fleet")
    shutil.rmtree(base, ignore_errors=True)
    out = {}

    def run(name, argv):
        workdir = os.path.join(base, name)
        os.makedirs(workdir, exist_ok=True)
        rc, wall, counts, info = run_cli(["-s", fd["aln"]] + argv, device,
                                         workdir)
        check(rc == 0, f"fleet CLI {name} returned {rc}")
        check(counts["b2"] == 0 and (device.type != "cuda" or counts["b1"]
                                     >= max(1, counts["fleet_tables"])),
              f"fleet CLI {name}: B1 {counts['b1']} launches for "
              f"{counts['fleet_tables']} stacked tables, B2 {counts['b2']}")
        table = fleet_table(os.path.join(workdir, "ExaML_fleet.smoke"))
        out[name] = {"wall_s": wall, "counts": counts, "jobs": len(table),
                     "done": sum(r["status"] == "done"
                                 for r in table.values())}
        return workdir, table, info

    _, tb, _ = run("bootstrap", ["-t", fd["start_tree"], "-b", "8"])
    check(len(tb) == 8 and all(r["status"] == "done" for r in tb.values()),
          f"-b 8: {tb}")
    wd, tn, info = run("multistart", ["-N", "4", "--fleet-cycles", "2",
                                      "--fleet-batch", "2"])
    check(len(tn) == 4 and all(r["status"] == "done" and r["cycles"] ==
                               "2/2" for r in tn.values()), f"-N 4: {tn}")
    check(out["multistart"]["counts"]["fleet_tables"] >= 2,
          "-N 4 --fleet-batch 2 ran no stacked table a batch")
    # The best job's tree re-evaluated in a fresh one-process instance.
    trees = open(os.path.join(wd, "ExaML_fleetTrees.smoke")).read().split()
    best = max(range(4), key=lambda k: tn[f"start{k}"]["lnl"])
    inst = PhyloInstance(read_bytefile(fd["aln"]), dtype=torch.float32,
                         device=device)
    lnl = inst.evaluate(inst.tree_from_newick(trees[best]), full=True)
    want = tn[f"start{best}"]["lnl"]
    check(abs(lnl - want) <= 1e-6 * abs(want), f"best -N job start{best} "
          f"re-evaluates to {lnl} against its table's {want}")
    out["multistart"]["best_reevaluated"] = [want, lnl]
    jobs_file = os.path.join(base, "jobs.jsonl")
    with open(jobs_file, "w") as f:
        f.write(json.dumps({"kind": "eval", "newick": open(
            fd["start_tree"]).read().strip()}) + "\n")
        f.write('{"kind": "start"}\n{"kind": "bootstrap"}\n{"kind": \n'
                '{"op": "stop"}\n')
    _, ts, info = run("serve", ["-t", fd["start_tree"], "--serve",
                                jobs_file, "--serve-poll", "0"])
    check(sorted(ts) == ["bootstrap2", "eval0", "start1"]
          and all(r["status"] == "done" for r in ts.values())
          and "REJECTED at admission (malformed line: jobs file line 4"
          in info, f"--serve: {ts}")
    # -R: -N 6 --fleet-batch 2 stopped after its first checkpoint.
    argv = ["-N", "6", "--fleet-batch", "2"]
    workdir = os.path.join(base, "restart")
    os.makedirs(workdir, exist_ok=True)
    orig = driver.FleetDriver._checkpoint

    def stop_after_first(self):
        orig(self)
        raise FleetStop("stopped after the first checkpoint")

    driver.FleetDriver._checkpoint = stop_after_first
    try:
        run_cli(["-s", fd["aln"]] + argv, device, workdir)
        check(False, "the stopped -N 6 run did not stop")
    except FleetStop:
        pass
    finally:
        driver.FleetDriver._checkpoint = orig
    _, tr, info = run("restart", argv + ["-R"])
    check(len(tr) == 6 and all(r["status"] == "done" for r in tr.values())
          and "resumed job table — 2 of 6 jobs already done" in info
          and out["restart"]["counts"]["fleet_tables"] == 2,
          f"-R of the stopped -N 6 run: {tr}, "
          f"{out['restart']['counts']['fleet_tables']} tables")
    log("  CLI: " + "; ".join(
        f"{k} {v['done']}/{v['jobs']} done in {v['wall_s']:.1f} s (B1 "
        f"{v['counts']['b1']}, {v['counts']['fleet_tables']} tables)"
        for k, v in out.items())
        + f"; best -N tree re-evaluated {lnl!r} against {want!r}")
    return out


def index_add_sum(values, seg, num: int):
    """The segment sum as one `index_add_` (atomics on the card)."""
    import torch
    out = torch.zeros(values.shape[:-1] + (num,), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(values.dim() - 1, seg, values)


def masked_sum(values, seg, num: int):
    """The segment sum as one masked reduction over a [num, ..., S]
    temporary."""
    import torch
    mine = seg == torch.arange(num, device=seg.device)[:, None]
    mine = mine.reshape((num,) + (1,) * (values.dim() - 1) + mine.shape[1:])
    return torch.where(mine, values, 0).sum(dim=-1).movedim(0, -1)


def many_part_instance(setup: dict, device, per_partition: bool):
    """The MANY_PARTS set-up's f32 chunk-tier instance, with one branch
    slot per partition (-M) or one, and the seed's random tree."""
    import torch
    from examl_tpu_torch.instance import PhyloInstance
    from examl_tpu_torch.transfer import install_model_params
    inst = PhyloInstance(setup["ad"], dtype=torch.float32, device=device,
                         newview="chunk",
                         per_partition_branches=per_partition)
    install_model_params(inst, setup["params"])
    tree = inst.random_tree(setup["seed"])
    for (p, _), z in zip(tree.all_branches(), setup["zs"]):
        p.z[:] = [float(z)] * len(p.z)
    return inst, tree


def many_part_sums(device, seed: int, reps: int) -> dict:
    """Every site sum at MANY_PARTS partitions: the segment sum alone
    (both sums of a Newton-Raphson derivative, blocks to partitions to
    -M's branch slots) at SEGSUM_LANES lanes against index_add_ and the
    masked sum, its bits held to the CPU's and to one lane's; then with
    -M an evaluate, one Newton-Raphson iteration (derivatives and their
    read-back) and a whole-tree gradient pass; without -M one pruned
    node of the batched SPR scan on each arm (lazy, thorough)."""
    import torch
    from examl_tpu_torch.ops import kernels
    from examl_tpu_torch.search import spr
    from examl_tpu_torch.utils import z_slots
    t0 = time.perf_counter()
    setup = real_setup(MANY_TAXA, MANY_PARTS, MANY_WIDTH, seed)
    inst, tree = many_part_instance(setup, device, per_partition=True)
    eng = inst.engines[4]
    M, C = eng.num_parts, inst.num_branch_slots
    out = {"partitions": M, "blocks": eng.B, "slots": C,
           "patterns": setup["patterns"],
           "setup_s": time.perf_counter() - t0, "segment_sum_ms": {}}
    seg, slots = eng.block_part, eng.models.part_branch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for lanes in SEGSUM_LANES:
        v = torch.randn((lanes, eng.B), generator=gen, dtype=torch.float64,
                        device=device)
        ways = {}
        for name, fn in (("segment_reduce", kernels._segment_sum),
                         ("index_add", index_add_sum),
                         ("masked", masked_sum)):
            ways[name] = time_ms(lambda fn=fn: fn(fn(v, seg, M), slots, C),
                                 device, reps)
        got = kernels._segment_sum(kernels._segment_sum(v, seg, M), slots, C)
        cpu = kernels._segment_sum(kernels._segment_sum(
            v.cpu(), seg.cpu(), M), slots.cpu(), C)
        one = kernels._segment_sum(kernels._segment_sum(v[-1:], seg, M),
                                   slots, C)
        ref = index_add_sum(index_add_sum(v, seg, M), slots, C)
        check(torch.equal(got.cpu(), cpu), f"the segment sum at {lanes} "
              "lanes differs from the CPU's bits")
        check(torch.equal(got[-1:], one), f"the segment sum's last lane of "
              f"{lanes} differs from the same lane alone")
        check(torch.allclose(got, ref, rtol=1e-12, atol=1e-9),
              f"the segment sum at {lanes} lanes is not index_add_'s")
        out["segment_sum_ms"][str(lanes)] = ways
        log(f"  {M} partitions, {C} slots, {lanes} lane(s): both sums "
            + ", ".join(f"{k} {ms:.3f} ms" for k, ms in ways.items())
            + "; bits as the CPU's and as one lane alone")
    lnl, walls = timed_evaluates(inst, tree, device, reps)
    out["evaluate_ms"] = float(np.median(walls) * 1e3)
    profile = device_breakdown(lambda: inst.evaluate(tree, full=True),
                               device)
    if profile["measured"]:
        out["evaluate_profile"] = {k: profile[k] for k in (
            "wall_ms", "busy_ms", "idle_share", "launches", "top")}
        log(f"  -M: profiled evaluate: wall {profile['wall_ms']:.2f} ms, "
            f"device busy {profile['busy_ms']:.2f} ms (idle share "
            f"{profile['idle_share']:.3f}) in {profile['launches']} device "
            "ops")
        for r in profile["top"]:
            log(f"    {r['ms']:9.3f} ms  {r['calls']:5d}x  {r['name']}")
    else:
        log(f"  -M: profiled evaluate: not measured ({profile['error']})")
    p = tree.centroid_branch()
    inst.evaluate(tree, full=True)
    sumt = eng.make_sumtable(p.number, p.back.number)
    zt = eng._z(p.z)

    def derivatives():
        d1, d2 = kernels.nr_derivatives(eng.models, eng.block_part,
                                        eng.weights, sumt, zt, C, None)
        return torch.stack([d1, d2]).cpu().numpy()

    d = derivatives()
    check(d.shape == (2, C) and bool(np.isfinite(d).all()),
          f"NR derivatives {d.shape} not finite")
    out["nr_iteration_ms"] = median_ms(derivatives, MANY_NR_CALLS)
    flat = tree.flat_full_traversal(p)
    root_z = z_slots(p.z, C)
    eng.run_traversal(flat, full=True)
    d1, _ = eng.whole_tree_gradients(flat, root_z)
    check(d1.shape == (2 * MANY_TAXA - 3, C) and bool(np.isfinite(d1).all()),
          f"gradients {d1.shape} not finite")
    out["gradient_pass_ms"] = time_ms(
        lambda: eng.whole_tree_gradients(flat, root_z), device, 2)
    log(f"  -M: evaluate {out['evaluate_ms']:.2f} ms (lnL {lnl:.6f}), one "
        f"NR iteration {out['nr_iteration_ms']:.3f} ms, a gradient pass "
        f"{out['gradient_pass_ms']:.1f} ms")
    del inst, tree, eng, sumt, d1
    release_memory()
    inst, tree = many_part_instance(setup, device, per_partition=False)
    check(spr.thorough_batched_ok(inst), "the thorough arm is not batched")
    inst.evaluate(tree, full=True)
    slot = next(q for q in spr.dfs_slot_order(tree)
                if not tree.is_tip(q.number)
                and not tree.is_tip(q.next.back.number)
                and not tree.is_tip(q.next.next.back.number))
    out["scan"] = {}
    for arm in ("warm-up", "lazy", "thorough"):
        ctx = spr.SprContext(inst, thorough=arm == "thorough",
                             do_cutoff=False)
        ctx.start_lh = ctx.end_lh = math.inf
        ctx.best_of_node = -math.inf
        reset_counts()
        sync(device)
        t1 = time.perf_counter()
        spr.rearrange_batched(inst, tree, ctx, slot, 1, 5,
                              thorough=arm == "thorough")
        sync(device)
        wall = time.perf_counter() - t1
        n = read_counts()["insertions_scored"]
        check(n > 0 and math.isfinite(ctx.best_of_node),
              f"the {arm} scan scored nothing")
        if arm != "warm-up":
            out["scan"][arm] = {"insertions": n, "ms_per_insertion":
                                wall * 1e3 / n}
    log(f"  batched SPR scan, one pruned node: lazy "
        f"{out['scan']['lazy']['ms_per_insertion']:.3f} ms per insertion "
        f"({out['scan']['lazy']['insertions']}), thorough "
        f"{out['scan']['thorough']['ms_per_insertion']:.3f} "
        f"({out['scan']['thorough']['insertions']}); set-up "
        f"{out['setup_s']:.1f} s")
    del inst, tree
    release_memory()
    return out


def phase_fleet(device, setup: dict, fd: dict, out_dir: str, seed: int,
                reps: int, keep: dict) -> dict:
    """The fleet (-b, -N, --serve): a batch of FLEET_JOBS start jobs at real
    size (f32 and bf16 storage), FLEET_AA_JOBS on the AA + BIN set-up (f32
    and bf16), FLEET_GENE_JOBS per-gene trees, a real-size bootstrap
    batch, and the CLI.  `keep` receives the real-size f32 DNA instance,
    its prepared jobs and their lnL, for phase 28."""
    import torch
    out = {}
    inst, tree = real_instance(setup, device, "chunk")
    out["dna"] = fleet_tree_batch(inst, fleet_trees(inst, seed, FLEET_JOBS),
                                  setup, device, "DNA f32", reps, True, keep)
    out["bootstrap"] = fleet_bootstrap(inst, tree, device, FLEET_REPLICATES)
    keep["inst"] = inst
    del inst, tree
    release_memory()
    inst, _ = real_instance(setup, device, "chunk",
                            clv_dtype=torch.bfloat16)
    out["dna_bf16"] = fleet_tree_batch(
        inst, fleet_trees(inst, seed, FLEET_JOBS), setup, device,
        "DNA bf16", reps, True)
    del inst
    release_memory()
    aa = aa_setup(seed)
    for name, storage in (("aa", None), ("aa_bf16", torch.bfloat16)):
        inst, _ = aa_instance(aa, device, "chunk", clv_dtype=storage)
        out[name] = fleet_tree_batch(
            inst, fleet_trees(inst, seed, FLEET_AA_JOBS), aa, device,
            f"AA + BIN {'bf16' if storage else 'f32'}", reps, False)
        del inst
        release_memory()
    gene = real_setup(FLEET_GENE[0], 1, FLEET_GENE[1], seed)
    inst, _ = real_instance(gene, device, "chunk")
    out["gene"] = fleet_tree_batch(
        inst, fleet_trees(inst, seed, FLEET_GENE_JOBS), gene, device,
        f"{FLEET_GENE[0]}-taxon genes", reps, True)
    del inst
    release_memory()
    out["many_parts"] = many_part_sums(device, seed, reps)
    out["cli"] = fleet_cli(device, out_dir, fd, seed)
    return out


# -- phase 28: the fleet's tree axis --------------------------------------------


def lanes_round(lanes, parts):
    """One round: every lane's batch admitted, then launched, then each
    collected (the driver's `_dispatch_round` without its ladder)."""
    adms = [lane.admit(p) for lane, p in zip(lanes, parts)]
    pend = [lane.launch_eval(p, a) for lane, p, a in zip(lanes, parts, adms)]
    return np.concatenate([lane.collect(q) for lane, q in zip(lanes, pend)])


def lanes_turns(lanes, preps, lnl, device) -> dict:
    """The round of two lanes against the same batches one after another
    on one lane, in LANE_TURNS turns (the order alternating), each result
    bit for bit phase 23's."""
    cut = [preps[:LANE_BATCH], preps[LANE_BATCH:]]
    walls = {"two_lanes": [], "one_lane": []}

    def one_lane():
        return np.concatenate([lanes[0].eval_batch(p) for p in cut])

    runs = {"two_lanes": lambda: lanes_round(lanes, cut),
            "one_lane": one_lane}
    for turn in range(LANE_TURNS):
        for name in (("two_lanes", "one_lane") if turn % 2 == 0
                     else ("one_lane", "two_lanes")):
            sync(device)
            t0 = time.perf_counter()
            rows = runs[name]()
            sync(device)
            walls[name].append(time.perf_counter() - t0)
            check(np.array_equal(rows, lnl), f"lanes, {name} turn {turn}: "
                  "lnL differs from phase 23's")
    return walls


def phase_lanes(device, keep: dict, fd: dict, side_cli: dict,
                seed: int) -> dict:
    """Phase 28: the fleet's tree axis on the card.  (a) the driver over
    two lanes that share the card (`devices=[cuda:0, cuda:0]`: the
    primary evaluator and a DeviceShard, each its own stream and ready
    flags) on phase 23's FLEET_JOBS real-size start jobs as two batches of
    LANE_BATCH: every lnL bit for bit phase 23's, one dispatch and one B1
    launch per lane; then the round against one lane in turns.  (b) a
    MeshShard on a 1x2 fabric of the card twice over the same jobs as one
    batch: 4 + 4 jobs, bit for bit.  (c) a PSR fleet of LANE_PSR_JOBS on
    phase 7's alignment over two lanes, bit for bit one lane.  (d) the CLI
    (run beside phase 8)."""
    import torch
    from examl_tpu_torch import obs
    from examl_tpu_torch.fleet import jobs, shard
    from examl_tpu_torch.fleet.driver import FleetDriver
    from examl_tpu_torch.instance import PhyloInstance
    from examl_tpu_torch.io.bytefile import read_bytefile
    from examl_tpu_torch.parallel.sharding import (fabric_sharding,
                                                   make_fabric_mesh)
    inst, preps, lnl = keep["inst"], keep["preps"], keep["lnl"]
    J = len(preps)
    out = {}
    release_memory()
    # (a) the driver over two lanes sharing the card.
    notes = []
    obs.reset()
    reset_counts()
    sync(device)
    t0 = time.perf_counter()
    drv = FleetDriver(inst, batch_cap=LANE_BATCH, devices=[device, device],
                      log=notes.append)
    done = drv.run(jobs.make_jobs("start", J, seed))
    sync(device)
    wall = time.perf_counter() - t0
    counts = read_counts()
    c = obs.snapshot()["counters"]
    check(all(j.done and not j.failed for j in done)
          and [j.lnl for j in done] == [float(r.sum()) for r in lnl],
          "lanes (a): the two-lane fleet's lnL "
          f"{[j.lnl for j in done]} is not phase 23's "
          f"{[float(r.sum()) for r in lnl]}")
    per_lane = [c.get(f"fleet.device_dispatches.d{k}", 0) for k in (0, 1)]
    check(len(drv.shards) == 2 and per_lane == [1, 1]
          and counts["fleet_tables"] == 2 and counts["b1"] == 2
          * b1_per_table(inst.engines[4], sum(
              len(p.st.launch) for p in preps[:LANE_BATCH])),
          f"lanes (a): {len(drv.shards)} lanes, dispatches {per_lane}, "
          f"{counts['fleet_tables']} tables, B1 {counts['b1']} launches")
    lanes = drv.shards.shards
    streams = {id(lane.stream) for lane in lanes}
    flags = [id(r) for lane in lanes for r in lane._ready.values()]
    check((len(streams) == 2 or device.type != "cuda")
          and len(flags) == len(set(flags)),
          "lanes (a): the two lanes share a stream or ready flags")
    out["lanes"] = {"jobs": J, "wall_s": wall, "counts": counts,
                    "dispatches": per_lane, "note": [n for n in notes
                                                     if "lane" in n]}
    log(f"  (a) two lanes sharing {device} ({notes[-1] if notes else ''}): "
        f"{J} real-size jobs as 2 batches of {LANE_BATCH} in one round, "
        f"{wall:.2f} s through the driver, B1 {counts['b1']} launches over "
        f"{counts['fleet_tables']} tables, dispatches {per_lane}; every lnL "
        "bit for bit phase 23's")
    walls = lanes_turns(lanes, preps, lnl, device)
    out["turns"] = walls
    log("  (a) the round of both lanes against the two batches one after "
        f"another on one lane, {LANE_TURNS} turns: two lanes "
        + ", ".join(f"{w * 1e3:.1f}" for w in walls["two_lanes"])
        + " ms; one lane " + ", ".join(f"{w * 1e3:.1f}"
                                       for w in walls["one_lane"])
        + " ms; every result bit for bit phase 23's")
    del drv, lanes
    release_memory()
    # (b) a 1x2 fabric of the card twice.
    obs.reset()
    reset_counts()
    ms = shard.MeshShard(inst, fabric_sharding(make_fabric_mesh(
        1, 2, [device, device])))
    sync(device)
    t0 = time.perf_counter()
    rows = ms.eval_batch(preps)
    sync(device)
    mwall = time.perf_counter() - t0
    mcounts = read_counts()
    c = obs.snapshot()["counters"]
    slice_jobs = [c.get(f"fleet.mesh_slice_jobs.t{k}", 0) for k in (0, 1)]
    check(np.array_equal(rows, lnl), "lanes (b): the 1x2 fabric's lnL "
          "differs from phase 23's")
    check(slice_jobs == [J // 2, J - J // 2] and mcounts["b1"] == 2
          * b1_per_table(inst.engines[4], sum(
              len(p.st.launch) for p in preps[:J // 2]))
          and c.get("fleet.mesh_batches") == 1,
          f"lanes (b): slice jobs {slice_jobs}, B1 {mcounts['b1']}")
    out["mesh"] = {"wall_s": mwall, "counts": mcounts,
                   "slice_jobs": slice_jobs}
    log(f"  (b) MeshShard on a 1x2 fabric of [[{device}, {device}]]: one "
        f"batch of {J} cut {slice_jobs[0]}/{slice_jobs[1]}, {mwall * 1e3:.1f}"
        f" ms (the first batch on its slices), B1 {mcounts['b1']} launches; "
        "every lnL bit for bit phase 23's")
    del ms, rows
    release_memory()
    # (c) a PSR fleet over two lanes.
    data = read_bytefile(fd["aln"])
    psr = {}
    reset_counts()
    for name, devs in (("one_lane", 1), ("two_lanes", [device, device])):
        pinst = PhyloInstance(data, dtype=torch.float32, device=device,
                              rate_model="PSR")
        t0 = time.perf_counter()
        res = FleetDriver(pinst, batch_cap=LANE_PSR_JOBS // 2,
                          devices=devs).run(
            jobs.make_jobs("start", LANE_PSR_JOBS, seed))
        sync(device)
        psr[name] = {"lnl": [j.lnl for j in res],
                     "wall_s": time.perf_counter() - t0}
        check(all(j.done and not j.failed for j in res),
              f"lanes (c): PSR {name} left jobs undone")
    pcounts = read_counts()
    check(psr["one_lane"]["lnl"] == psr["two_lanes"]["lnl"]
          and pcounts["b1"] == 0 and pcounts["partial_traversals"]
          == 2 * LANE_PSR_JOBS,
          f"lanes (c): PSR two lanes {psr['two_lanes']['lnl']} against one "
          f"{psr['one_lane']['lnl']}; B1 {pcounts['b1']}, "
          f"{pcounts['partial_traversals']} wave-scan traversals")
    out["psr"] = dict(psr, counts=pcounts)
    log(f"  (c) PSR: {LANE_PSR_JOBS} start jobs on phase 7's alignment over "
        f"two lanes {psr['two_lanes']['wall_s']:.2f} s, one lane "
        f"{psr['one_lane']['wall_s']:.2f} s (first calls included); lnL bit "
        "for bit, no B1 launch")
    out["cli"] = side_cli
    return out


def lanes_cli(device, out_dir: str, fd: dict) -> dict:
    """Phase 28 (d), a side phase: -N LANE_CLI_JOBS plain, with
    --fleet-devices 0 (one lane a visible card) and with --mesh 1x1 on
    phase 7's alignment, their results equal; -N 4 --mesh 1x2 returns 1
    with the device arithmetic where fewer than two cards are visible."""
    import shutil
    import torch
    from examl_tpu_torch.fleet import quarantine
    base = os.path.join(out_dir, "lanes")
    shutil.rmtree(base, ignore_errors=True)
    out = {}
    ref = None
    for name, extra in (("plain", []), ("devices0", ["--fleet-devices", "0"]),
                        ("mesh1x1", ["--mesh", "1x1"])):
        workdir = os.path.join(base, name)
        os.makedirs(workdir, exist_ok=True)
        rc, wall, counts, info = run_cli(
            ["-s", fd["aln"], "-N", str(LANE_CLI_JOBS)] + extra, device,
            workdir)
        table = fleet_table(os.path.join(workdir, "ExaML_fleet.smoke"))
        lnls = {r["job_id"]: r["lnl"] for r in quarantine.read_records(
            os.path.join(workdir, "ExaML_fleetJournal.smoke"))}
        check(rc == 0 and len(table) == LANE_CLI_JOBS and all(
            r["status"] == "done" for r in table.values()),
            f"lanes CLI {name}: rc {rc}, table {table}")
        check(counts["fleet_tables"] > 0 and (
            device.type != "cuda" or counts["b1"] >= counts["fleet_tables"]),
              f"lanes CLI {name}: B1 {counts['b1']} for "
              f"{counts['fleet_tables']} tables")
        if ref is None:
            ref = (table, lnls)
        check(table == ref[0] and lnls == ref[1], f"lanes CLI {name}: "
              f"results differ from -N {LANE_CLI_JOBS}'s")
        out[name] = {"wall_s": wall, "counts": counts,
                     "lanes": info.count("device lane")}
    workdir = os.path.join(base, "mesh1x2")
    os.makedirs(workdir, exist_ok=True)
    rc, wall, counts, info = run_cli(["-s", fd["aln"], "-N", "4", "--mesh",
                                      "1x2"], device, workdir)
    if torch.cuda.device_count() < 2:
        check(rc == 1 and "ERROR: mesh 1x2 needs 2 devices" in info,
              f"lanes CLI --mesh 1x2 on one card: rc {rc}")
    else:
        check(rc == 0, f"lanes CLI --mesh 1x2: rc {rc}")
    out["mesh1x2"] = {"rc": rc, "wall_s": wall, "counts": counts,
                      "error": next((ln for ln in info.splitlines()
                                     if "ERROR" in ln), None)}
    log(f"  (d) CLI on phase 7's alignment: -N {LANE_CLI_JOBS} "
        + "; ".join(f"{k} {v['wall_s']:.1f} s (B1 {v['counts']['b1']})"
                    for k, v in out.items() if k != "mesh1x2")
        + " with equal results tables and journals; -N 4 --mesh 1x2 "
        f"returned {rc}: {out['mesh1x2']['error']}")
    return out


# -- phase 29: the site axis, site shards of one tree on the card -------------


def shard_mesh(device):
    """The SHARDS x 1 fabric of the card named SHARDS times: the site
    shards share it, each on its own thread and stream."""
    from examl_tpu_torch.parallel.sharding import (fabric_sharding,
                                                   make_fabric_mesh)
    return fabric_sharding(make_fabric_mesh(SHARDS, 1, [device] * SHARDS))


def check_sharded(counts: dict, tier: str, path: str) -> None:
    """A path of SHARDS site shards launches its tier's kernel once a shard
    for each full traversal (counted once, as one card counts it), the
    other kernel never; the pooled tier launches neither."""
    per = {"chunk": ("b1", "b2"), "whole": ("b2", "b1")}.get(tier)
    if per is None:
        check(counts["b1"] == counts["b2"] == 0
              and counts["pooled_traversals"] > 0,
              f"{path}: B1 {counts['b1']}, B2 {counts['b2']} launches for "
              f"{counts['pooled_traversals']} pooled traversals")
        return
    on, off = per
    check(counts[off] == 0 and counts[on] == SHARDS * counts[
        "full_traversals"] > 0, f"{path}: {counts[on]} {on.upper()} "
          f"launches ({off.upper()} {counts[off]}) for "
          f"{counts['full_traversals']} full traversals of {SHARDS} shards")


def shard_rows(inst, one, device, what: str) -> list:
    """Each shard's inner-node arena rows and scalers against the one-card
    instance's rows of the shard's block window (compare_arenas: scalers
    equal, rows within B1's tolerance), and whether they are the same
    bits (site_digests)."""
    import torch
    eng1 = one.engines[4]
    ntaxa = one.alignment.ntaxa
    rows1 = torch.as_tensor(eng1.row_map[ntaxa + 1:], device=device)
    out = []
    for r, e in enumerate(inst.engines[4].shards):
        b0, b1 = e.bucket.block_offset, e.bucket.block_offset + e.B
        rows = torch.as_tensor(e.row_map[ntaxa + 1:], device=device)
        worst = [0.0, 0.0, 0]
        for lo in range(0, rows.shape[0], 32):
            rel, err, n = compare_arenas(
                e.clv[rows[lo:lo + 32]], eng1.clv[rows1[lo:lo + 32], b0:b1],
                e.scaler[rows[lo:lo + 32]],
                eng1.scaler[rows1[lo:lo + 32], b0:b1], f"{what} shard {r}")
            worst = [max(worst[0], rel), max(worst[1], err), worst[2] + n]
        same = (site_digests(e.clv, rows)
                == site_digests(eng1.clv[:, b0:b1], rows1))
        out.append({"blocks": [b0, b1], "max_rel_err": worst[0],
                    "max_abs_err": worst[1], "differing_cells": worst[2],
                    "bitwise": bool(same)})
    return out


def sharded_instance(ad, setup: dict, device, **kw):
    """The real-size f32 instance of `ad` on the shard mesh of the card,
    the set-up's models and its random tree with the set-up's lengths."""
    import torch
    from examl_tpu_torch.instance import PhyloInstance
    from examl_tpu_torch.transfer import install_model_params
    inst = PhyloInstance(ad, dtype=torch.float32, device=device,
                         sharding=shard_mesh(device), **kw)
    install_model_params(inst, [(np.asarray(r), np.asarray(f), float(a))
                                for r, f, a in setup["params"]])
    return inst, site_tree(inst, setup)


def sharded_path(inst, tree, device, tier: str, what: str) -> dict:
    """One full evaluate of a sharded instance with its counts (read just
    after it), then SHARD_REPS timed ones."""
    reset_counts()
    lnl = inst.evaluate(tree, full=True)
    sync(device)
    counts = read_counts()
    check_sharded(counts, tier, what)
    again, walls = timed_evaluates(inst, tree, device, SHARD_REPS)
    check(again == lnl, f"{what}: lnL {again!r} after {lnl!r}")
    return {"lnl": lnl, "pp": inst.per_partition_lnl.tolist(),
            "counts": counts, "evaluate_ms": float(np.median(walls) * 1e3)}


def phase_site_axis(device, setup: dict, real: dict, real_whole: dict,
                    site: dict, keep: dict, sev: dict, bf16: dict,
                    smi: str) -> dict:
    """Phase 29: SHARDS site shards of one tree in this process on a
    SHARDS x 1 fabric of the card twice (parallel/shards.py).  (a) the
    real-size DNA set-up on the chunk tier: B1 once a shard, the lnL and
    per-partition lnL bit for bit phase 22's two gloo ranks over the same
    windows and within rel SHARD_RTOL of one card (phase 10), each
    shard's arena rows against the rows of its window of phase 22's
    one-process arena (`keep["one"]`, packed as the shards pack, on the
    alignment it read); then the whole tier, B2 once a
    shard, within SHARD_RTOL of phase 13; the evaluate's wall against one
    card's, a finding.  (c) -S on phase 19's gappy set (`keep["sev"]`):
    the pooled lnL
    within SHARD_RTOL of phase 19's dense lnL, no kernel, each shard's
    pool region.  (d) bfloat16 storage: B1's bf16 instance once a shard,
    within BF16_RTOL of the f32 lnL.  ((b) and (e) run as the side phases
    `site_ref49` and `site_cli`.)"""
    import torch
    t0 = time.perf_counter()
    one, tree1 = keep.pop("one")
    sev_in = keep.pop("sev")
    ad = one.alignment
    out = {"shards": SHARDS, "devices": [str(device)] * SHARDS,
           "device": smi}
    # (a) the chunk tier against one card and phase 22's ranks.
    lnl1, walls1 = timed_evaluates(one, tree1, device, SHARD_REPS)
    inst, tree = sharded_instance(ad, setup, device, newview="chunk")
    chunk = sharded_path(inst, tree, device, "chunk", "2x1 chunk tier")
    windows = shard_rows(inst, one, device, "2x1 chunk tier")
    del one, tree1, inst, tree
    release_memory()
    ranks = site["ranks"]
    check(chunk["lnl"] == ranks[0]["lnl"] and chunk["pp"] == ranks[0]["pp"],
          f"2x1 lnL {chunk['lnl']!r} {chunk['pp']} against phase 22's "
          f"ranks' {ranks[0]['lnl']!r} {ranks[0]['pp']}")
    rel = abs(chunk["lnl"] - real["lnl"]) / abs(real["lnl"])
    check(rel <= SHARD_RTOL, f"2x1 lnL {chunk['lnl']!r} against one card's "
          f"{real['lnl']!r} (rel {rel:.2e})")
    chunk.update(one_card_lnl=real["lnl"], rel_one_card=rel,
                 one_card_packed_lnl=lnl1, windows=windows,
                 one_card_evaluate_ms=float(np.median(walls1) * 1e3))
    out["chunk"] = chunk
    inst, tree = sharded_instance(ad, setup, device, newview="whole")
    whole = sharded_path(inst, tree, device, "whole", "2x1 whole tier")
    del inst, tree
    release_memory()
    whole["rel_one_card"] = abs(whole["lnl"] - real_whole["lnl"]) / abs(
        real_whole["lnl"])
    check(whole["rel_one_card"] <= SHARD_RTOL, f"2x1 whole-tier lnL "
          f"{whole['lnl']!r} against one card's {real_whole['lnl']!r}")
    out["whole"] = whole
    # (d) bfloat16 storage on the chunk tier.
    inst, tree = sharded_instance(ad, setup, device, newview="chunk",
                                  clv_dtype=torch.bfloat16)
    low = sharded_path(inst, tree, device, "chunk", "2x1 bf16")
    del inst, tree
    release_memory()
    check(low["counts"]["b1_by_dtype"].get("bfloat16", 0) == SHARDS,
          f"2x1 bf16: B1 launches by dtype {low['counts']['b1_by_dtype']}")
    low["rel_f32"] = abs(low["lnl"] - chunk["lnl"]) / abs(chunk["lnl"])
    low["rel_one_card_bf16"] = abs(low["lnl"] - bf16["dna"]["lnl"]) / abs(
        bf16["dna"]["lnl"])
    check(low["rel_f32"] <= BF16_RTOL, f"2x1 bf16 lnL {low['lnl']!r} against "
          f"f32 {chunk['lnl']!r} (rel {low['rel_f32']:.2e})")
    out["bf16"] = low
    # (c) -S on phase 19's gappy set.
    inst, tree = sharded_instance(sev_in["ad"], sev_in, device,
                                  save_memory=True)
    pooled = sharded_path(inst, tree, device, "pooled", "2x1 -S")
    dense_lnl = sev["dense"]["lnl"]
    pooled["rel_dense"] = abs(pooled["lnl"] - dense_lnl) / abs(dense_lnl)
    check(pooled["rel_dense"] <= SHARD_RTOL, f"2x1 -S lnL {pooled['lnl']!r} "
          f"against the dense one-card {dense_lnl!r}")
    pooled["regions"] = [{
        "pool_bytes": e.sev.pool.numel() * e.sev.pool.element_size(),
        "cap": e.sev.cap, **e.sev.stats()}
        for e in inst.engines[4].shards]
    check(len({r["cap"] for r in pooled["regions"]}) == 1,
          f"2x1 -S: region capacities {pooled['regions']}")
    del inst, tree
    release_memory()
    out["sev"] = pooled
    out["wall_s"] = time.perf_counter() - t0
    log(f"  (a) real size on {SHARDS}x1 of {device} twice: chunk tier lnL "
        f"{chunk['lnl']!r}, bit for bit phase 22's ranks, rel "
        f"{chunk['rel_one_card']:.2e} of one card; B1 "
        f"{chunk['counts']['b1']} launches for "
        f"{chunk['counts']['full_traversals']} full traversal(s)")
    for r, w in enumerate(windows):
        log(f"    shard {r}: blocks {w['blocks'][0]}..{w['blocks'][1] - 1}, "
            f"rows against one card's window: scalers equal, max rel err "
            f"{w['max_rel_err']:.2e}, "
            + ("bit for bit" if w["bitwise"] else
               f"{w['differing_cells']} differing cells"))
    log(f"    whole tier lnL {whole['lnl']!r}, rel "
        f"{whole['rel_one_card']:.2e} of one card; B2 "
        f"{whole['counts']['b2']} launches for "
        f"{whole['counts']['full_traversals']} full traversal(s)")
    log(f"    evaluate wall (median of {SHARD_REPS}; a finding, the shards "
        f"share one card): 2x1 chunk {chunk['evaluate_ms']:.2f} ms, whole "
        f"{whole['evaluate_ms']:.2f} ms; one card (packed as the shards) "
        f"{chunk['one_card_evaluate_ms']:.2f} ms [{smi}]")
    log(f"  (c) -S on phase 19's set: pooled lnL {pooled['lnl']!r}, rel "
        f"{pooled['rel_dense']:.2e} of the dense one-card lnL, no kernel; "
        "pool regions " + ", ".join(
            f"{r['pool_bytes'] / 1e9:.3f} GB ({r['allocated_cells']} of "
            f"{r['dense_cells']} cells)" for r in pooled["regions"])
        + f"; evaluate {pooled['evaluate_ms']:.1f} ms")
    log(f"  (d) bf16 storage: lnL {low['lnl']!r}, rel {low['rel_f32']:.2e} "
        f"of f32, rel {low['rel_one_card_bf16']:.2e} of phase 21's one "
        f"card; B1 bf16 {low['counts']['b1']} launches")
    return out


class CardTwice:
    """The CLI's visible cards named as the card SHARDS times, for a with
    block: `--mesh SHARDSx1` then builds its fabric on the one card."""

    def __init__(self, device):
        self.devices = [device] * SHARDS

    def __enter__(self):
        from examl_tpu_torch.parallel import sharding
        self.saved = sharding.visible_devices
        sharding.visible_devices = lambda: list(self.devices)
        return self

    def __exit__(self, *exc):
        from examl_tpu_torch.parallel import sharding
        sharding.visible_devices = self.saved
        return False


def site_ref49(device, out_dir: str) -> dict:
    """Phase 29 (b), a side phase: ref49 on a SHARDS x 1 fabric of the card
    twice.  The anchor (the reference's model) on both tiers within 2e-3
    of the reference binary; `-f e --newview whole --mesh SHARDSx1`
    through the CLI (CardTwice), its endpoint at least the reference's
    less modOpt's epsilon (and, checked in the main process, within
    SHARD_RTOL of phase 6's one-card endpoint); and PSR from phase 9's
    start (f32, the wave-scan tier, no
    kernel): an evaluate, a gradient tree_evaluate and one categorization
    round, each lnL within SHARD_RTOL of the same steps on one card.
    (The whole `-m PSR -f e` on 2x1 outruns the side phases' window: it
    runs alone under `--site-psr`, phase 9 on one card.)"""
    import shutil
    import torch
    from examl_tpu_torch.instance import PhyloInstance
    from examl_tpu_torch.io.bytefile import read_bytefile
    from examl_tpu_torch.optimize.branch import tree_evaluate
    from examl_tpu_torch.optimize.psr import optimize_rate_categories
    from examl_tpu_torch.transfer import install_model_params
    base = os.path.join(out_dir, "site_ref49")
    shutil.rmtree(base, ignore_errors=True)
    out = {"anchors": {}}
    aln = os.path.join(REF49, "aln49.binary")
    with open(os.path.join(REF49, "TreeFile")) as f:
        newick = f.read()
    params = refmodel().parse_model_file(os.path.join(REF49, "modelFile"))
    for tier in ("chunk", "whole"):
        reset_counts()
        inst = PhyloInstance(read_bytefile(aln), dtype=torch.float32,
                             device=device, newview=tier,
                             sharding=shard_mesh(device))
        install_model_params(inst, [(p.rates, p.freqs, p.alpha)
                                    for p in params])
        lnl = inst.evaluate(inst.tree_from_newick(newick), full=True)
        sync(device)
        counts = read_counts()
        check_sharded(counts, tier, f"ref49 2x1 {tier} anchor")
        check(abs(lnl - LNL_REF_BINARY) <= 2e-3, f"ref49 2x1 {tier} anchor "
              f"{lnl} against {LNL_REF_BINARY}")
        out["anchors"][tier] = {"lnl": lnl, "counts": counts}
        del inst
    workdir = os.path.join(base, "fe")
    os.makedirs(workdir)
    with CardTwice(device):
        rc, wall, counts, info = run_cli(
            ["-s", aln, "-t", os.path.join(REF49, "TreeFile"), "-f", "e",
             "--newview", "whole", "--mesh", f"{SHARDS}x1"], device, workdir)
    check(rc == 0, f"ref49 2x1 -f e returned {rc}")
    check(f"likelihood fabric {SHARDS}x1: {SHARDS} site shard(s)" in info,
          "ref49 2x1 -f e logged no fabric")
    check_sharded(counts, "whole", "ref49 2x1 -f e")
    with open(os.path.join(workdir, "ExaML_log.smoke")) as f:
        final = float(f.read().split()[-1])
    floor = LNL_REF_BINARY - MODOPT_EPSILON
    check(final >= floor, f"ref49 2x1 -f e endpoint {final} below {floor}")
    out["fe"] = {"final_lnl": final, "wall_s": wall, "counts": counts}
    psr = {}
    for name, kw in (("one", {}), ("2x1", {"sharding": shard_mesh(device)})):
        inst = PhyloInstance(read_bytefile(aln), dtype=torch.float32,
                             device=device, rate_model="PSR", **kw)
        tree = inst.tree_from_newick(newick)
        reset_counts()
        t0 = time.perf_counter()
        steps = [inst.evaluate(tree, full=True),
                 tree_evaluate(inst, tree, REAL_SMOOTH_FACTOR),
                 optimize_rate_categories(inst, tree)]
        sync(device)
        counts = read_counts()
        check(counts["b1"] == counts["b2"] == 0, f"ref49 PSR {name}: "
              f"{counts}")
        psr[name] = {"lnl": steps, "wall_s": time.perf_counter() - t0,
                     "categories": [len(r) for r in inst.per_site_rates]}
        del inst, tree
    psr["rel"] = max(abs(a - b) / abs(b) for a, b in zip(
        psr["2x1"]["lnl"], psr["one"]["lnl"]))
    check(psr["rel"] <= SHARD_RTOL, f"ref49 PSR on 2x1 {psr['2x1']['lnl']} "
          f"against one card {psr['one']['lnl']}")
    out["psr"] = psr
    log(f"  (b) ref49 on {SHARDS}x1 of the card twice: anchors chunk "
        f"{out['anchors']['chunk']['lnl']!r}, whole "
        f"{out['anchors']['whole']['lnl']!r} (reference {LNL_REF_BINARY}); "
        f"-f e --newview whole through the CLI {final!r} (floor {floor}) in "
        f"{wall:.1f} s, B2 {counts['b2']} launches for "
        f"{out['fe']['counts']['full_traversals']} full traversals")
    log(f"    PSR, evaluate / tree_evaluate / a categorization round: "
        f"{psr['2x1']['lnl']} in {psr['2x1']['wall_s']:.1f} s against one "
        f"card's {psr['one']['lnl']} in {psr['one']['wall_s']:.1f} s (rel "
        f"{psr['rel']:.2e}); categories {psr['2x1']['categories']} and "
        f"{psr['one']['categories']}")
    return out


def site_psr(device, out_dir: str) -> dict:
    """`--site-psr`: ref49 `-m PSR -f e` through the CLI from the initial
    model (phase 9's run), on one card and then with `--mesh SHARDSx1` on
    the card twice (CardTwice), one after the other: each endpoint at
    least PERF.md's PSR bound, no kernel launched, the 2x1 endpoint within
    SHARD_RTOL of one card's; each wall."""
    import shutil
    base = os.path.join(out_dir, "site_psr")
    shutil.rmtree(base, ignore_errors=True)
    argv = ["-s", os.path.join(REF49, "aln49.binary"), "-t",
            os.path.join(REF49, "TreeFile"), "-f", "e", "-m", "PSR"]
    floor = LNL_REF_PSR - PSR_MARGIN
    out = {"device": nvidia_smi_line(), "floor": floor}
    for name, extra in (("one", []), ("2x1", ["--mesh", f"{SHARDS}x1"])):
        workdir = os.path.join(base, name)
        os.makedirs(workdir)
        with (CardTwice(device) if extra else contextlib.nullcontext()):
            rc, wall, counts, info = run_cli(argv + extra, device, workdir)
        check(rc == 0, f"ref49 -m PSR -f e ({name}) returned {rc}")
        check(counts["b1"] == counts["b2"] == 0, f"ref49 PSR ({name}): "
              f"B1 {counts['b1']}, B2 {counts['b2']} launches")
        with open(os.path.join(workdir, "ExaML_log.smoke")) as f:
            final = float(f.read().split()[-1])
        check(final >= floor, f"ref49 -m PSR -f e ({name}) endpoint {final} "
              f"below {floor}")
        out[name] = {"final_lnl": final, "wall_s": wall,
                     "fabric": "likelihood fabric" in info}
        log(f"  ref49 -m PSR -f e ({name}): {final!r} in {wall:.1f} s")
    out["rel"] = abs(out["2x1"]["final_lnl"] - out["one"]["final_lnl"]) / abs(
        out["one"]["final_lnl"])
    check(out["2x1"]["fabric"] and out["rel"] <= SHARD_RTOL,
          f"ref49 -m PSR -f e on 2x1 {out['2x1']['final_lnl']!r} against one "
          f"card's {out['one']['final_lnl']!r}")
    return out


def site_cli(device, out_dir: str, fd: dict) -> dict:
    """Phase 29 (e) and phase 30 (f), a side phase: the CLI on the card as
    it is.  `--mesh SHARDSx1`, and a fleet's `-N 4 --mesh SHARDSx2`,
    return 1 with the device arithmetic where fewer cards are visible,
    and phase 7's `-f d` with no mesh logs no sharding and ends at phase
    7's lnL bit for bit."""
    import shutil
    import torch
    base = os.path.join(out_dir, "site_cli")
    shutil.rmtree(base, ignore_errors=True)
    out = {}
    workdir = os.path.join(base, "refused")
    os.makedirs(workdir)
    rc, _, _, info = run_cli(["-s", fd["aln"], "-t", fd["start_tree"], "-i",
                              "5", "--mesh", f"{SHARDS}x1"], device, workdir)
    if torch.cuda.device_count() < SHARDS:
        check(rc == 1 and f"ERROR: mesh {SHARDS}x1 needs {SHARDS} devices"
              in info, f"--mesh {SHARDS}x1 on one card: rc {rc}")
    out["refused"] = {"rc": rc, "error": next(
        (ln for ln in info.splitlines() if "ERROR" in ln), None)}
    # Phase 30 (f): a fleet over site shards, -N 4 on a 2x2 mesh.
    workdir = os.path.join(base, "refused_mesh")
    os.makedirs(workdir)
    rc, _, _, info = run_cli(["-s", fd["aln"], "-N", "4", "--mesh",
                              f"{SHARDS}x2"], device, workdir)
    if torch.cuda.device_count() < 2 * SHARDS:
        check(rc == 1 and f"ERROR: mesh {SHARDS}x2 needs {2 * SHARDS} "
              "devices" in info, f"-N 4 --mesh {SHARDS}x2 on one card: rc "
              f"{rc}")
    else:
        check(rc == 0, f"-N 4 --mesh {SHARDS}x2: rc {rc}")
    out["mesh"] = {"rc": rc, "error": next(
        (ln for ln in info.splitlines() if "ERROR" in ln), None)}
    workdir = os.path.join(base, "fd")
    os.makedirs(workdir)
    rc, wall, counts, info = run_cli(["-s", fd["aln"], "-t",
                                      fd["start_tree"], "-i", "5"], device,
                                     workdir)
    final = float(re.search(r"Likelihood of best tree: (\S+)",
                            info).group(1))
    if torch.cuda.device_count() < 2:
        check(rc == 0 and final == fd["final_lnl"] and not re.search(
            r"site axis sharded|likelihood fabric|site shard", info),
            f"-f d with no mesh on one card: rc {rc}, {final!r} against "
            f"phase 7's {fd['final_lnl']!r}")
        check_tier(counts, "chunk", "-f d with no mesh")
    out["fd"] = {"final_lnl": final, "wall_s": wall, "counts": counts}
    log(f"  (e) --mesh {SHARDS}x1 on the card as it is: rc "
        f"{out['refused']['rc']}, {out['refused']['error']}; phase 30 (f) "
        f"-N 4 --mesh {SHARDS}x2: rc {out['mesh']['rc']}, "
        f"{out['mesh']['error']}; -f d with no "
        f"mesh {final!r} (phase 7 {fd['final_lnl']!r}) in {wall:.1f} s, no "
        "sharding logged")
    return out


# -- phase 30: the fleet over site shards --------------------------------------


def mesh_fabric(device, t: int):
    """The SHARDS x t fabric of the card named SHARDS * t times."""
    from examl_tpu_torch.parallel.sharding import (fabric_sharding,
                                                   make_fabric_mesh)
    return fabric_sharding(make_fabric_mesh(SHARDS, t,
                                            [device] * (SHARDS * t)))


def mesh_sweeps(ev, preps, maxtimes: int) -> dict:
    """One smooth_batch on `ev`, with every sweep's (d1, d2) recorded."""
    sweeps = []
    grad = ev._grad_batch

    def recorded(jobs):
        d = grad(jobs)
        sweeps.append(d)
        return d
    ev._grad_batch = recorded
    try:
        t0 = time.perf_counter()
        converged = ev.smooth_batch(preps, maxtimes)
        wall = time.perf_counter() - t0
    finally:
        del ev._grad_batch
    return {"sweeps": sweeps, "converged": converged, "wall_s": wall,
            "z": np.array([[p.z[0] for p, _ in j.tree.all_branches()]
                           for j in preps])}


def mesh_batch(inst, trees, device, label: str, one_lnl) -> dict:
    """Tree jobs as one batch on the SHARDS x 2 MeshShard over the SHARDS x
    1 instance `inst` (the card named four times): the batch once (its
    arenas allocated), then with its counts: B1 once a lane and engine
    (one dataflow table each), each slice half the jobs; every job's
    per-partition lnL bit for bit its evaluate on `inst` and within
    SHARD_RTOL of one card's (`one_lnl`, per job); the same batch on the
    SHARDS x 1 evaluator, bit for bit."""
    from examl_tpu_torch import obs
    from examl_tpu_torch.fleet import shard
    ev22 = shard.MeshShard(inst, mesh_fabric(device, 2))
    ev21 = inst.batch_evaluator()
    J = len(trees)
    preps = [ev22.prepare(t) for t in trees]
    walls = {}
    for name, ev in (("2x2", ev22), ("2x1", ev21)):
        release_memory()
        sync(device)
        t0 = time.perf_counter()
        first = ev.eval_batch(preps)
        sync(device)
        walls[f"{name}_first_s"] = time.perf_counter() - t0
        obs.reset()
        reset_counts()
        sync(device)
        t0 = time.perf_counter()
        rows = ev.eval_batch(preps)
        sync(device)
        walls[f"{name}_s"] = time.perf_counter() - t0
        counts = read_counts()
        c = obs.snapshot()["counters"]
        check(np.array_equal(rows, first), f"{label} {name}: the second "
              "batch differs from the first")
        if name == "2x2":
            rows22, counts22 = rows, counts
            slice_jobs = [c.get(f"fleet.mesh_slice_jobs.t{k}", 0)
                          for k in (0, 1)]
        else:
            check(np.array_equal(rows, rows22), f"{label}: the 2x1 batch "
                  "differs from the 2x2 batch")
    half = -(-J // 2)
    want = sum(SHARDS * b1_per_table(e.shards[0], sum(
        len(p.st.launch) for p in part)) for e in inst.engines.values()
        for part in (preps[:half], preps[half:])) \
        if device.type == "cuda" else 0
    check(slice_jobs == [half, J - half] and counts22["b1"] == want
          and counts22["fleet_tables"] == 2 * SHARDS * len(inst.engines)
          and counts22["b2"] == 0, f"{label} 2x2: slice jobs {slice_jobs}, "
          f"B1 {counts22['b1']} ({want} expected), "
          f"{counts22['fleet_tables']} tables")
    for j, tree in enumerate(trees):
        inst.evaluate(tree, full=True)
        check(np.array_equal(inst.per_partition_lnl, rows22[j]),
              f"{label}: job {j}'s 2x2 row {rows22[j].tolist()} is not its "
              f"2x1 evaluate {inst.per_partition_lnl.tolist()}")
    rel = np.abs(rows22.sum(axis=1) - np.asarray(one_lnl)) / np.abs(
        np.asarray(one_lnl))
    check(float(rel.max()) <= SHARD_RTOL, f"{label}: rel {rel.max():.2e} "
          "of one card's batch rows")
    del ev22, ev21
    release_memory()
    return {"jobs": J, "slice_jobs": slice_jobs, "counts": counts22,
            "lnl": rows22.sum(axis=1).tolist(), "rel_one_card":
            float(rel.max()), **walls}


def phase_mesh(device, setup: dict, keep: dict, fleet: dict, lanes: dict,
               fd: dict, smi: str, seed: int) -> dict:
    """Phase 30: the fleet over site shards on a SHARDS x 2 fabric of the
    card named four times (fleet/shard.py: a MeshShard of two tree slices,
    each a SiteLanes of SHARDS shard lanes).  (a) phase 23's FLEET_JOBS
    real-size DNA start jobs as one batch (`mesh_batch`) over a SHARDS x 1
    instance of the set-up, the walls beside phase 28's 1x2 and phase 23's
    one lane; (b) phase 23's FLEET_AA_JOBS AA + BIN jobs, so (K = 20, 2);
    (c) batched smoothing of FLEET_GENE_JOBS gene trees on one card, 2x1
    and 2x2: the same sweeps, branches within SHARD_RTOL of one card, every
    sweep's d1/d2 bit for bit between 2x1 and 2x2; (d) FLEET_REPLICATES
    bootstrap weight batches on 2x2, bit for bit 2x1; (e) phase 28's PSR
    fleet of LANE_PSR_JOBS (wave-scan groups) through the driver on 2x2,
    bit for bit 2x1.  ((f) runs in the side phase `site_cli`.)"""
    import torch
    from examl_tpu_torch.fleet import bootstrap, jobs, seeds, shard
    from examl_tpu_torch.fleet.driver import FleetDriver
    from examl_tpu_torch.instance import PhyloInstance
    from examl_tpu_torch.io.bytefile import read_bytefile
    t0 = time.perf_counter()
    out = {"device": smi}
    # (a) the real-size DNA batch.
    inst, tree = real_instance(setup, device, "chunk",
                               sharding=mesh_fabric(device, 1))
    trees = [p.tree for p in keep["preps"]]
    out["dna"] = mesh_batch(inst, trees, device, "mesh DNA",
                            keep["lnl"].sum(axis=1))
    out["dna"].update(one_lane_s=fleet["dna"]["wall_s"],
                      mesh_1x2_s=lanes["mesh"]["wall_s"])
    # (d) bootstrap weights on the same instance.
    reps = [bootstrap.bootstrap_weights(inst.alignment,
                                        seeds.derive(7, "bootstrap", k))
            for k in range(FLEET_REPLICATES)]
    ev22 = shard.MeshShard(inst, mesh_fabric(device, 2))
    w = {}
    reset_counts()
    for name, ev in (("2x2", ev22), ("2x1", inst.batch_evaluator())):
        sync(device)
        t1 = time.perf_counter()
        w[name] = ev.eval_weights_batch(tree, reps)
        sync(device)
        w[f"{name}_s"] = time.perf_counter() - t1
    wcounts = read_counts()
    check(np.array_equal(w["2x2"], w["2x1"]) and np.isfinite(w["2x2"]).all()
          and wcounts["b1"] == (2 * SHARDS if device.type == "cuda"
                                 else 0), "mesh bootstrap: 2x2 "
          f"{w['2x2'][:2].tolist()} against 2x1 {w['2x1'][:2].tolist()}, "
          f"B1 {wcounts['b1']}")
    out["bootstrap"] = {"replicates": FLEET_REPLICATES, "counts": wcounts,
                        "wall_2x2_s": w["2x2_s"], "wall_2x1_s": w["2x1_s"]}
    del inst, tree, ev22, ev, w
    release_memory()
    # (b) the AA + BIN batch.
    aa = aa_setup(seed)
    inst, _ = aa_instance(aa, device, "chunk",
                          sharding=mesh_fabric(device, 1))
    out["aa"] = mesh_batch(inst, fleet_trees(inst, seed, FLEET_AA_JOBS),
                           device, "mesh AA + BIN", fleet["aa"]["lnl"])
    del inst, aa
    release_memory()
    # (c) batched smoothing of the gene trees.
    gene = real_setup(FLEET_GENE[0], 1, FLEET_GENE[1], seed)
    runs = {}
    for name, sharding in (("one", None), ("2x1", mesh_fabric(device, 1)),
                           ("2x2", mesh_fabric(device, 2))):
        ginst, _ = real_instance(gene, device, "chunk", sharding=sharding)
        ev = ginst.batch_evaluator()
        preps = [ev.prepare(t) for t in fleet_trees(ginst, seed,
                                                    FLEET_GENE_JOBS)]
        reset_counts()
        runs[name] = mesh_sweeps(ev, preps, MESH_SMOOTHINGS)
        runs[name]["counts"] = read_counts()
        del ginst, ev, preps
    n = {k: len(r["sweeps"]) for k, r in runs.items()}
    zrel = float(np.max(np.abs(runs["2x2"]["z"] - runs["one"]["z"])
                        / np.abs(runs["one"]["z"])))
    same = n["2x1"] == n["2x2"] and all(
        np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        for a, b in zip(runs["2x1"]["sweeps"], runs["2x2"]["sweeps"]))
    check(n["one"] == n["2x1"] == n["2x2"] and same and zrel <= SHARD_RTOL
          and np.array_equal(runs["2x1"]["z"], runs["2x2"]["z"]),
          f"mesh smoothing: sweeps {n}, d1/d2 2x1 = 2x2 {same}, branches "
          f"rel {zrel:.2e} of one card")
    out["smoothing"] = {"jobs": FLEET_GENE_JOBS, "sweeps": n, "z_rel": zrel,
                        "wall_s": {k: r["wall_s"] for k, r in runs.items()},
                        "counts": runs["2x2"]["counts"]}
    del runs
    release_memory()
    # (e) the PSR fleet through the driver.
    data = read_bytefile(fd["aln"])
    psr = {}
    reset_counts()
    for name, t in (("2x1", 1), ("2x2", 2)):
        pinst = PhyloInstance(data, dtype=torch.float32, device=device,
                              rate_model="PSR", sharding=mesh_fabric(device,
                                                                     t))
        t1 = time.perf_counter()
        res = FleetDriver(pinst, batch_cap=LANE_PSR_JOBS).run(
            jobs.make_jobs("start", LANE_PSR_JOBS, seed))
        sync(device)
        psr[name] = {"lnl": [j.lnl for j in res],
                     "wall_s": time.perf_counter() - t1}
        check(all(j.done and not j.failed for j in res),
              f"mesh PSR {name}: jobs left undone")
        del pinst
    pcounts = read_counts()
    check(psr["2x1"]["lnl"] == psr["2x2"]["lnl"] and pcounts["b1"] == 0
          and pcounts["partial_traversals"] == 2 * SHARDS * LANE_PSR_JOBS,
          f"mesh PSR: 2x2 {psr['2x2']['lnl']} against 2x1 "
          f"{psr['2x1']['lnl']}; B1 {pcounts['b1']}, "
          f"{pcounts['partial_traversals']} wave-scan traversals")
    out["psr"] = dict(psr, counts=pcounts)
    release_memory()
    out["wall_s"] = time.perf_counter() - t0
    for k in ("dna", "aa"):
        r = out[k]
        log(f"  ({'a' if k == 'dna' else 'b'}) {r['jobs']} {k.upper()} jobs "
            f"as one batch on 2x2 of {device} four times: slices "
            f"{r['slice_jobs'][0]}/{r['slice_jobs'][1]}, B1 "
            f"{r['counts']['b1']} launches over {r['counts']['fleet_tables']}"
            f" tables; every row bit for bit the 2x1 evaluate, rel "
            f"{r['rel_one_card']:.2e} of one card; batch {r['2x2_s'] * 1e3:.1f}"
            f" ms (first {r['2x2_first_s'] * 1e3:.1f}), 2x1 "
            f"{r['2x1_s'] * 1e3:.1f} ms (first {r['2x1_first_s'] * 1e3:.1f})"
            + (f"; one lane {r['one_lane_s'] * 1e3:.1f} ms (phase 23), 1x2 "
               f"{r['mesh_1x2_s'] * 1e3:.1f} ms (phase 28, its first batch)"
               if k == "dna" else "") + f" [{smi}]")
    sm = out["smoothing"]
    log(f"  (c) smooth_batch of {FLEET_GENE_JOBS} gene trees ({FLEET_GENE[0]}"
        f" taxa x {FLEET_GENE[1]} columns): {sm['sweeps']['2x2']} sweeps on "
        f"one card, 2x1 and 2x2, d1/d2 bit for bit 2x1 = 2x2, branches rel "
        f"{sm['z_rel']:.2e} of one card; "
        + ", ".join(f"{k} {v:.2f} s" for k, v in sm["wall_s"].items()))
    b = out["bootstrap"]
    log(f"  (d) {FLEET_REPLICATES} bootstrap replicates on 2x2 bit for bit "
        f"2x1: {b['wall_2x2_s'] * 1e3:.1f} ms against "
        f"{b['wall_2x1_s'] * 1e3:.1f} ms, B1 {b['counts']['b1']}")
    log(f"  (e) PSR: {LANE_PSR_JOBS} start jobs through the driver on 2x2 "
        f"{psr['2x2']['wall_s']:.2f} s, 2x1 {psr['2x1']['wall_s']:.2f} s "
        "(first calls included); lnL bit for bit, no B1 launch")
    return out


# -- phase 25: the run's instruments and in-process resilience ----------------


def balanced_trace(path: str) -> dict:
    """Span names and counts of one trace file (the port's reader), its
    B/E pairs held balanced per (thread, name)."""
    from examl_tpu_torch.obs import trace
    evs = trace.read_events(path)
    depth, names = {}, {}
    for e in evs:
        if e.get("ph") in ("B", "E"):
            k = (e["tid"], e["name"])
            depth[k] = depth.get(k, 0) + (1 if e["ph"] == "B" else -1)
            check(depth[k] >= 0, f"{path}: E before B for {e['name']}")
            if e["ph"] == "B":
                names[e["name"]] = names.get(e["name"], 0) + 1
    check(all(v == 0 for v in depth.values()),
          f"{path}: unbalanced spans {[k for k, v in depth.items() if v]}")
    return {"events": len(evs), "spans": names}


def instruments_cli(device, fd: dict, base: str) -> dict:
    """(a) -f d on phase 7's alignment with --metrics --ledger
    --trace-events, and -f e with --profile: the artifacts parse, the
    trace is balanced, the dispatch counter covers B1's launches, the
    card's peak memory covers the arena, and the profile holds B1."""
    import torch
    from examl_tpu_torch.obs import ledger
    out = {}
    art = os.path.join(base, "fd_obs")
    workdir = os.path.join(base, "fd")
    torch.cuda.reset_peak_memory_stats(device)
    rc, wall, counts, info = run_cli(
        ["-s", fd["aln"], "-t", fd["start_tree"], "-i", "5", "--metrics",
         os.path.join(art, "m.json"), "--ledger", os.path.join(art, "led"),
         "--trace-events", os.path.join(art, "tr")], device, workdir)
    check(rc == 0, f"-f d with the instruments returned {rc}")
    check_tier(counts, "chunk", "-f d CLI with the instruments")
    final = float(re.search(r"Likelihood of best tree: (\S+)",
                            info).group(1))
    check(abs(final - fd["final_lnl"]) <= 1e-6 * abs(fd["final_lnl"]),
          f"-f d with the instruments ended at {final!r}, without them "
          f"at {fd['final_lnl']!r}")
    with open(os.path.join(art, "m.json")) as f:
        snap = json.load(f)
    c, g = snap["counters"], snap["gauges"]
    check(c.get("engine.dispatch_count", 0) >= counts["b1"] > 0,
          f"engine.dispatch_count {c.get('engine.dispatch_count')} below "
          f"B1's {counts['b1']} launches")
    arena = max(v for k, v in g.items()
                if k.startswith("engine.clv_arena_bytes."))
    check(g.get("mem.device.0.peak", 0) >= arena > 0,
          f"mem.device.0.peak {g.get('mem.device.0.peak')} below the "
          f"arena's {arena} bytes")
    events = ledger.read_events(os.path.join(art, "led",
                                             "ledger.merged.jsonl"))
    seq = [(e["kind"], e.get("name"), e.get("status")) for e in events
           if e["kind"] in ("run", "phase")]
    check(seq[0] == ("run", None, "start") and seq[-1][0] == "run"
          and ("phase", "inference (-f d)", "end") in seq,
          f"ledger run/phase sequence {seq}")
    tr = balanced_trace(os.path.join(art, "tr", "trace.p0.jsonl"))
    check(any(n.startswith("engine:") for n in tr["spans"])
          and any(n.startswith("phase:") for n in tr["spans"]),
          f"trace spans {sorted(tr['spans'])[:20]}")
    check(os.path.exists(os.path.join(art, "tr", "summary.json")),
          "no trace summary.json")
    programs = snap.get("programs", [])
    check(any(r["family"] == "newview_chunk" for r in programs),
          f"no newview_chunk row in the program table ({programs[:2]})")
    out["fd"] = {"wall_s": wall, "final_lnl": final, "counts": counts,
                 "dispatch_count": c["engine.dispatch_count"],
                 "traffic_bytes": c.get("engine.traffic_bytes"),
                 "sched_cache": {k: c.get(f"engine.sched_cache.{k}", 0)
                                 for k in ("hit", "miss", "evictions")},
                 "peak_bytes": g.get("mem.device.0.peak"),
                 "arena_bytes": arena,
                 "trace_events": tr["events"],
                 "span_counts": dict(sorted(tr["spans"].items(),
                                            key=lambda kv: -kv[1])[:12]),
                 "ledger_events": len(events),
                 "program_rows": len(programs),
                 "programs": [{k: r.get(k) for k in (
                     "family", "key", "source", "registers", "spill_stores")}
                     for r in programs]}
    log(f"  -f d with --metrics/--ledger/--trace-events: {wall:.1f} s "
        f"(without {fd['wall_s']:.1f} s in phase 7), lnL {final!r}; "
        f"dispatch_count {c['engine.dispatch_count']} >= B1 "
        f"{counts['b1']}; peak {g.get('mem.device.0.peak', 0) / 1e6:.1f} MB >= "
        f"arena {arena / 1e6:.1f} MB; {tr['events']} trace events, "
        f"{len(events)} ledger events, {len(programs)} program rows")
    prof = os.path.join(base, "fe_profile")
    rc, wall, counts, info = run_cli(
        ["-s", fd["aln"], "-t", fd["start_tree"], "-f", "e", "--profile",
         prof], device, os.path.join(base, "fe"))
    check(rc == 0, f"-f e --profile returned {rc}")
    path = os.path.join(prof, "torch_trace.p0.json")
    with open(path) as f:
        text = f.read()
    b1 = text.count("newview_flow_kernel") + text.count(
        "newview_chunk_kernel")
    check(b1 > 0 and counts["b1"] > 0,
          f"the --profile trace ({len(text)} bytes) holds no kernel B1 "
          f"launch ({counts['b1']} counted)")
    out["fe_profile"] = {"wall_s": wall, "trace_bytes": len(text),
                         "b1_events": b1, "b1_launches": counts["b1"]}
    log(f"  -f e --profile: {wall:.1f} s, a {len(text) / 1e6:.1f} MB "
        f"Chrome trace with {b1} B1 kernel events for {counts['b1']} "
        "launches")
    return out


def instruments_evaluate(device, setup: dict, base: str) -> dict:
    """(b) the real-size DNA evaluate, median ms with every instrument
    off, with tracing and the ledger on, and under torch.profiler with
    its annotations, in turns (off, traced, profiled, profiled, traced,
    off; INSTR_BLOCK evaluates a block), and the host cost of one traced
    span alone; (c) `engine.nonfinite` on it: the wave-scan retry timed
    and its lnL held to the clean one."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from examl_tpu_torch import obs
    from examl_tpu_torch.obs import ledger, trace
    from examl_tpu_torch.resilience import faults
    inst, tree = real_instance(setup, device, "chunk")

    def walls(k):
        out = []
        for _ in range(k):
            sync(device)
            t0 = time.perf_counter()
            inst.evaluate(tree, full=True)
            sync(device)
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    clean = inst.evaluate(tree, full=True)
    runs = {"off": [], "traced": [], "profiled": []}
    events = spans = 0
    reset_counts()
    for i, mode in enumerate(("off", "traced", "profiled", "profiled",
                              "traced", "off")):
        if mode == "off":
            runs[mode] += walls(INSTR_BLOCK)
        elif mode == "traced":
            tdir = os.path.join(base, f"eval_trace{i}")
            shutil.rmtree(tdir, ignore_errors=True)
            trace.enable(tdir, procid=0)
            ledger.enable(tdir, proc=0)
            try:
                runs[mode] += walls(INSTR_BLOCK)
            finally:
                trace.finalize()
                ledger.finalize()
            tr = balanced_trace(os.path.join(tdir, "trace.p0.jsonl"))
            events += tr["events"]
            spans += sum(tr["spans"].values())
        else:
            obs.set_annotations(True)
            try:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]):
                    runs[mode] += walls(INSTR_BLOCK)
            finally:
                obs.set_annotations(False)
    counts = read_counts()
    n = 6 * INSTR_BLOCK
    check(counts["b1"] >= n and counts["full_traversals"] == n,
          f"{n} evaluates counted {counts['b1']} B1 launches, "
          f"{counts['full_traversals']} full traversals")
    # The host cost of one traced span (a B and an E line, each written
    # and flushed) against the shared no-op context when tracing is off.
    span_us = {}
    for mode in ("off", "traced"):
        tdir = os.path.join(base, "span_cost")
        if mode == "traced":
            trace.enable(tdir, procid=0)
        try:
            t0 = time.perf_counter()
            for _ in range(SPAN_COST_SPANS):
                with obs.span("engine:probe"):
                    pass
            span_us[mode] = (time.perf_counter() - t0) * 1e6 / \
                SPAN_COST_SPANS
        finally:
            trace.finalize()
    # The bookkeeping every evaluate does with the instruments off
    # (counters, the traffic model from the flat traversal, the no-op
    # spans, the traffic window, the fault seams), timed alone.
    eng = inst.engines[4]
    flat = tree.flat_full_traversal(tree.centroid_branch())

    def bookkeeping():
        obs.inc("engine.dispatch_count")
        obs.inc("engine.traversal_entries", flat.n)
        nbytes = eng._traversal_traffic_bytes(flat)
        with obs.device_span("engine:trav_eval"):
            with obs.device_span("newview:chunk_apply"):
                pass
        eng._record_traffic(nbytes, "chunk", wall_s=5e-3)
        faults.fire("engine.dispatch")
        faults.fire("engine.nonfinite")

    t0 = time.perf_counter()
    for _ in range(SPAN_COST_SPANS):
        bookkeeping()
    off_us = (time.perf_counter() - t0) * 1e6 / SPAN_COST_SPANS
    med = {k: float(np.median(v)) for k, v in runs.items()}
    out = {"median_ms": med, "walls_ms": runs, "evaluates": n,
           "b1_launches": counts["b1"],
           "trace_events_per_evaluate": events / (2 * INSTR_BLOCK),
           "spans_per_evaluate": spans / (2 * INSTR_BLOCK),
           "span_us": span_us, "bookkeeping_us_per_evaluate": off_us}
    log(f"  real-size evaluate in turns, median of {2 * INSTR_BLOCK} each: "
        f"{med['off']:.3f} ms instruments off, {med['traced']:.3f} ms "
        f"traced + ledger ({out['spans_per_evaluate']:.0f} spans an "
        f"evaluate), {med['profiled']:.3f} ms under torch.profiler; one "
        f"traced span {span_us['traced']:.1f} us on the host "
        f"({span_us['off']:.2f} us off); the always-on bookkeeping "
        f"{off_us:.1f} us an evaluate")
    prior = os.environ.get(faults.ENV_VAR)
    os.environ[faults.ENV_VAR] = "engine.nonfinite"
    faults.reset()
    obs.reset()
    try:
        reset_counts()
        sync(device)
        t0 = time.perf_counter()
        got = inst.evaluate(tree, full=True)
        sync(device)
        retry_ms = (time.perf_counter() - t0) * 1e3 - med["off"]
        counts = read_counts()
    finally:
        if prior is None:
            os.environ.pop(faults.ENV_VAR, None)
        else:
            os.environ[faults.ENV_VAR] = prior
        faults.reset()
    c = obs.snapshot_counters()
    check(c.get("engine.nonfinite_retries") == 1
          and c.get("engine.nonfinite_recovered") == 1,
          f"non-finite retry counters {c}")
    check(abs(got - clean) <= 1e-6 * abs(clean),
          f"the retried lnL {got!r} against the clean {clean!r}")
    check(counts["partial_traversals"] == 1 and counts["b1"] >= 1,
          f"the retry's counts {counts}: one wave-scan traversal expected "
          "after the B1 traversal")
    after = inst.evaluate(tree, full=True)
    check(after == clean, f"the evaluate after the retry gave {after!r}, "
          f"not the clean {clean!r} bit for bit")
    out["nonfinite"] = {"clean_lnl": clean, "retried_lnl": got,
                        "rel": abs(got - clean) / abs(clean),
                        "retry_ms": retry_ms}
    log(f"  engine.nonfinite: recovered on the wave-scan tier to "
        f"{got!r} (clean {clean!r}, rel {out['nonfinite']['rel']:.2e}); "
        f"the retry took {retry_ms:.1f} ms")
    del inst, tree
    release_memory()
    return out


def instruments_fleet(device, setup: dict, base: str, seed: int) -> dict:
    """(d) `mem.oom` and `mem.pressure` on phase 23's batch of FLEET_JOBS
    real-size start jobs: the injected OOM recovers by halving, the
    pressure clamp cuts the stacked arena into the parts effective_cap
    gives, and every job's lnL is bit for bit as alone."""
    import torch
    from examl_tpu_torch import obs
    from examl_tpu_torch.fleet import jobs, quarantine
    from examl_tpu_torch.fleet.driver import FleetDriver
    from examl_tpu_torch.obs import ledger, programs
    from examl_tpu_torch.resilience import faults
    inst, _ = real_instance(setup, device, "chunk")
    alone = {}
    for k, spec in enumerate(jobs.make_jobs("start", FLEET_JOBS, seed)):
        alone[spec.job_id] = inst.evaluate(inst.random_tree(seed=spec.seed),
                                           full=True)
    out = {}
    prior = os.environ.get(faults.ENV_VAR)
    sample_s = programs.MEM_SAMPLE_S
    programs.MEM_SAMPLE_S = 0.0
    try:
        for name in ("mem.oom", "mem.pressure"):
            spec = name
            if name == "mem.pressure":
                # A budget at 40 % of what is in use: effective_cap cuts
                # the batch of 8 to parts of about 3.
                release_memory()
                used = torch.cuda.memory_allocated(device)
                spec = f"mem.pressure:bytes={int(0.4 * used)}"
            os.environ[faults.ENV_VAR] = spec
            faults.reset()
            obs.reset()
            ldir = os.path.join(base, f"fleet_{name}")
            shutil.rmtree(ldir, ignore_errors=True)
            ledger.enable(ldir, proc=0)
            reset_counts()
            t0 = time.perf_counter()
            try:
                done = FleetDriver(
                    inst, batch_cap=FLEET_JOBS,
                    policy=quarantine.JobFaultPolicy(backoff_base=0.01)).run(
                        jobs.make_jobs("start", FLEET_JOBS, seed))
                sync(device)
            finally:
                ledger.finalize()
            wall = time.perf_counter() - t0
            counts = read_counts()
            c = obs.snapshot_counters()
            for j in done:
                check(j.done and not j.failed and j.lnl == alone[j.job_id],
                      f"{spec}: job {j.job_id} lnL {j.lnl!r} against "
                      f"{alone[j.job_id]!r} alone ({j.cause})")
            evs = ledger.read_dir(ldir)
            r = {"spec": spec, "wall_s": wall, "tables": counts["fleet_tables"],
                 "b1": counts["b1"]}
            if name == "mem.oom":
                check(c.get("mem.oom_events") == 1
                      and c.get("mem.oom_retries") == 1
                      and c.get("fleet.bisect_dispatches", 0) >= 2,
                      f"mem.oom: counters {c}")
                r["bisect_dispatches"] = c["fleet.bisect_dispatches"]
            else:
                cut = [e for e in evs if e["kind"] == "mem.cap_shrunk"]
                check(bool(cut), "mem.pressure: no mem.cap_shrunk event")
                eff = cut[0]["effective"]
                check(eff < FLEET_JOBS and counts["fleet_tables"] ==
                      -(-FLEET_JOBS // eff),
                      f"mem.pressure: effective cap {eff}, "
                      f"{counts['fleet_tables']} tables")
                r.update(effective_cap=eff, used_bytes=cut[0]["used_bytes"],
                         budget_bytes=cut[0]["budget_bytes"])
            out[name] = r
            log(f"  {spec}: {FLEET_JOBS} jobs in {counts['fleet_tables']} "
                f"stacked table(s), B1 {counts['b1']} launches, {wall:.1f} s; "
                "every job's lnL bit for bit as alone"
                + (f" (effective cap {r['effective_cap']})"
                   if "effective_cap" in r else
                   f" ({r['bisect_dispatches']} halving dispatches)"))
    finally:
        if prior is None:
            os.environ.pop(faults.ENV_VAR, None)
        else:
            os.environ[faults.ENV_VAR] = prior
        programs.MEM_SAMPLE_S = sample_s
        faults.reset()
    del inst
    release_memory()
    return out


def instruments_sigterm(device, fd: dict, base: str) -> dict:
    """(e) SIGTERM to a `-f d` run of the port's CLI in a process of its
    own, as soon as it published a checkpoint: EXIT_PREEMPTED, then -R
    ends within rel 1e-6 of the uninterrupted run (phase 7)."""
    import signal
    from examl_tpu_torch.resilience import exitcause
    workdir = os.path.join(base, "sigterm")
    shutil.rmtree(workdir, ignore_errors=True)
    argv = ["-s", fd["aln"], "-t", fd["start_tree"], "-i", "5", "-n",
            "smoke", "-w", workdir]
    code = (f"import sys; sys.path.insert(0, {HERE!r}); "
            "from examl_tpu_torch.cli.main import main; "
            f"sys.exit(main({argv!r}))")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=HERE,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    def published() -> bool:
        return os.path.isdir(workdir) and bool(read_checkpoints(workdir))

    try:
        while not published():
            check(proc.poll() is None and time.perf_counter() - t0 < 180,
                  f"the -f d process ended ({proc.poll()}) before its "
                  "first checkpoint")
            time.sleep(0.05)
        t_sig = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=180)
        stop_s = time.perf_counter() - t_sig
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    err = proc.stderr.read()
    check(rc == exitcause.EXIT_PREEMPTED,
          f"SIGTERM: the -f d process exited {rc} "
          f"{exitcause.exit_desc(rc)}, not {exitcause.EXIT_PREEMPTED}: "
          f"{err[-2000:]}")
    ckpts = read_checkpoints(workdir)
    rc2, wall, counts, info = run_cli(["-s", fd["aln"], "-t",
                                       fd["start_tree"], "-i", "5", "-R"],
                                      device, workdir)
    check(rc2 == 0, f"-R after the preemption returned {rc2}")
    final = float(re.search(r"Likelihood of best tree: (\S+)",
                            info).group(1))
    rel = abs(final - fd["final_lnl"]) / abs(fd["final_lnl"])
    check(rel <= 1e-6, f"-R after SIGTERM ended at {final!r}, the "
          f"uninterrupted run at {fd['final_lnl']!r}")
    out = {"rc": rc, "stop_s": stop_s, "checkpoints": len(ckpts),
           "states": sorted(set(ckpts.values())), "resume_wall_s": wall,
           "final_lnl": final, "rel": rel}
    log(f"  SIGTERM after {len(ckpts)} checkpoint(s): exit {rc} "
        f"(EXIT_PREEMPTED) {stop_s:.1f} s after the signal; -R ended at "
        f"{final!r} in {wall:.1f} s (uninterrupted {fd['final_lnl']!r}, "
        f"rel {rel:.1e})")
    return out


def phase_instruments(device, setup: dict, fd: dict, seed: int) -> dict:
    """Phase 25: obs/ and resilience/ on the card, (a) to (e)."""
    base = os.path.join(HERE, "build", "instruments")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    out = {}
    phase_t = {}
    for key, fn in (
            ("cli", lambda: instruments_cli(device, fd, base)),
            ("evaluate", lambda: instruments_evaluate(device, setup, base)),
            ("fleet", lambda: instruments_fleet(device, setup, base, seed)),
            ("sigterm", lambda: instruments_sigterm(device, fd, base))):
        t0 = time.perf_counter()
        out[key] = fn()
        phase_t[key] = time.perf_counter() - t0
    out["parts_s"] = phase_t
    return out



# -- phase 26: supervision ----------------------------------------------------

# The port's CLI as a user starts it: its own process, on the card.
CLI_CMD = [sys.executable, "-m", "examl_tpu_torch.cli.main"]


class SupRun:
    """One `python -m examl_tpu_torch.cli.main ARGV` process (a
    supervisor, or a leased rank), its output in WORKDIR/stdout.txt.
    `stop()` ends it and every process its ledger says it spawned (each
    child runs in a process group of its own)."""

    def __init__(self, argv, workdir: str, env=None):
        os.makedirs(workdir, exist_ok=True)
        self.workdir = workdir
        with open(os.path.join(workdir, "stdout.txt"), "a") as out:
            self.proc = subprocess.Popen(
                CLI_CMD + argv, cwd=HERE, stdout=out,
                stderr=subprocess.STDOUT,
                env=dict(os.environ, PYTHONPATH=HERE, **(env or {})))
        self.t0 = time.time()

    def wait(self, what: str, timeout: float = SUP_TIMEOUT_S) -> int:
        try:
            return self.proc.wait(timeout=max(1.0, self.t0 + timeout
                                              - time.time()))
        except subprocess.TimeoutExpired:
            self.stop()
            raise SmokeFailure(f"{what}: ran past {timeout:.0f} s")

    def tail(self) -> str:
        with open(os.path.join(self.workdir, "stdout.txt")) as f:
            return f.read()[-3000:]

    def stop(self) -> None:
        import signal
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        for ev in sup_events(self.workdir):
            if ev.get("kind") == "supervisor.spawn":
                try:
                    os.killpg(ev["pid"], signal.SIGKILL)
                except OSError:
                    pass


def sup_events(ledger_dir: str) -> list:
    """Every process's ledger events in `ledger_dir`, in time order."""
    from examl_tpu_torch.obs import ledger
    return ledger.read_dir(ledger_dir)


def sup_snapshot(workdir: str) -> dict:
    with open(os.path.join(workdir, "m.json")) as f:
        return json.load(f)


def sup_lnls(workdir: str) -> list:
    """The tree lnLs of a -f e run's newest checkpoint (JSON floats:
    exact)."""
    import gzip
    nums = [int(m.group(1)) for n in os.listdir(workdir)
            if (m := re.match(r"ExaML_binaryCheckpoint\.smoke\.ckpt_(\d+)"
                              r"\.json\.gz$", n))]
    with gzip.open(os.path.join(
            workdir, f"ExaML_binaryCheckpoint.smoke.ckpt_{max(nums)}"
            ".json.gz"), "rt") as f:
        return json.load(f)["extras"]["lnls"]


def sup_journal(workdir: str, done_only: bool = True) -> dict:
    """{job id: lnL} of every results journal of a fleet run."""
    from examl_tpu_torch.fleet import quarantine
    return {r["job_id"]: r["lnl"] for r in quarantine.read_all_journals(
        workdir, "smoke") if not (done_only and r.get("failed"))}


def sup_kernels(snap: dict, attempts=()) -> dict:
    """B1 and B2 launches a run's processes counted in their metrics:
    the final snapshot plus each killed attempt's last autoflush."""
    out = {}
    for fam in ("newview_chunk", "newview_whole"):
        key = f"kernel.{fam}.launches"
        out[fam] = snap.get("counters", {}).get(key, 0) + sum(
            (a.get("partial_counters") or {}).get(key, 0)
            for a in attempts)
    return out


def sup_check_b1(snap: dict, what: str, attempts=()) -> dict:
    k = sup_kernels(snap, attempts)
    check(k["newview_chunk"] > 0 and k["newview_whole"] == 0,
          f"{what}: B1 {k['newview_chunk']} launches, B2 "
          f"{k['newview_whole']} (every rung runs kernel B1)")
    return k


def sup_reference(device, argv, workdir: str, fleet: bool = False):
    """An unsupervised run in this process (the one-process reference),
    with the run's search beats recorded in order."""
    from examl_tpu_torch.resilience import heartbeat
    states = []
    orig = heartbeat.beat

    def counting(state="", payload=None):
        states.append(state)
        return orig(state, payload)

    heartbeat.beat = counting
    try:
        rc, wall, counts, info = run_cli(argv, device, workdir)
    finally:
        heartbeat.beat = orig
    check(rc == 0, f"reference run {argv} returned {rc}")
    if fleet:
        check(counts["b2"] == 0 and (device.type != "cuda" or counts["b1"]
                                     >= max(1, counts["fleet_tables"])),
              f"reference {workdir}: B1 {counts['b1']} launches for "
              f"{counts['fleet_tables']} stacked tables, B2 {counts['b2']}")
    else:
        check_tier(counts, "chunk", f"reference {workdir}")
    return states, counts, wall


def sup_argv(aln: str, workdir: str, *extra) -> list:
    return ["-s", aln, "-n", "smoke", "-w", workdir, "--metrics",
            os.path.join(workdir, "m.json")] + list(extra)


def sup_causes(snap: dict) -> list:
    return [a["cause"] for a in snap["resilience"]["attempts"]]


def supervision_recover(device, setup: dict, seed: int, smi: str) -> dict:
    """(a) and (f): a supervised -f e on SUP_TAXA taxa of the real-size
    DNA set-up at full width; its child SIGKILLed once the first
    checkpoint is published; the time to recover, split from the ledger;
    and, while the children run, the supervisor holds no CUDA context."""
    import signal
    from examl_tpu_torch.io.alignment import AlignmentData, PartitionData
    from examl_tpu_torch.io.bytefile import write_bytefile
    from examl_tpu_torch.resilience import exitcause
    from examl_tpu_torch.resilience import supervisor as sup
    from examl_tpu_torch.tree.topology import Tree
    base = os.path.join(HERE, "build", "supervision", "recover")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    ad = setup["ad"]
    names = ad.taxon_names[:SUP_TAXA]
    aln = os.path.join(base, "real_cut.binary")
    write_bytefile(aln, AlignmentData(names, [PartitionData(
        name=p.name, datatype=p.datatype, model_name=p.model_name,
        patterns=np.ascontiguousarray(p.patterns[:SUP_TAXA]),
        weights=p.weights, empirical_freqs=p.empirical_freqs,
        use_empirical_freqs=True, optimize_freqs=False)
        for p in ad.partitions]))
    tree = os.path.join(base, "start.nwk")
    with open(tree, "w") as f:
        f.write(Tree.random(names, seed, 1).to_newick(names) + "\n")
    work = os.path.join(base, "run")
    run = SupRun(sup_argv(aln, work, "-t", tree, "-f", "e", "--supervise",
                          "--supervise-backoff", "0.5"), work)
    seen, child_pids, maps_clean = set(), set(), []
    try:
        t_death = None
        while run.proc.poll() is None:
            check(time.time() - run.t0 < SUP_TIMEOUT_S,
                  "(a) the supervised -f e ran past its time")
            res = subprocess.run(
                ["nvidia-smi", "--query-compute-apps=pid",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60)
            check(res.returncode == 0, f"(f) nvidia-smi failed: "
                  f"{res.stderr.strip()}")
            seen |= {int(x) for x in res.stdout.split() if x.isdigit()}
            with open(f"/proc/{run.proc.pid}/maps") as f:
                maps = f.read()
            maps_clean.append("libcuda" not in maps
                              and "libtorch" not in maps)
            child_pids |= {ev["pid"] for ev in sup_events(work)
                           if ev.get("kind") == "supervisor.spawn"}
            if t_death is None and sup.checkpoint_glob(work, "smoke"):
                (child,) = child_pids
                os.kill(child, signal.SIGKILL)
                t_death = time.time()
            time.sleep(0.5)
        rc = run.wait("(a)")
    finally:
        run.stop()
    check(rc == 0, f"(a) the supervised -f e exited {rc}: {run.tail()}")
    check(t_death is not None, "(a) the child finished before its first "
          "checkpoint was published")
    check(run.proc.pid not in seen and all(maps_clean),
          f"(f) the supervisor (pid {run.proc.pid}) held a CUDA context: "
          f"nvidia-smi listed {sorted(seen)}; maps clean {maps_clean}")
    snap = sup_snapshot(work)
    att = snap["resilience"]["attempts"]
    check(sup_causes(snap) == [exitcause.CAUSE_OOM_KILL, exitcause.CAUSE_OK]
          and att[1]["resumed"], f"(a) attempts {att}")
    kernels = sup_check_b1(snap, "(a)", att)
    evs = sup_events(work)
    spawn = next(e for e in evs if e["kind"] == "supervisor.spawn"
                 and e.get("attempt") == 1)
    t_spawn = spawn["ts"] / 1e6
    mine = [e for e in evs if e.get("proc") == 0 and e["ts"] / 1e6
            > t_spawn]
    loads = [e for e in mine if e["kind"] == "extension.load"]
    check((loads or device.type != "cuda")
          and not any(e["built"] for e in loads)
          and not any(e["kind"] == "compile" for e in evs),
          f"(a) an attempt built an extension: {loads}")
    st = [e["ts"] / 1e6 for e in mine if e["kind"] == "phase"
          and e["name"].startswith("startup")]
    restore = next(e for e in mine if e["kind"] == "checkpoint.restore")
    t_restore = restore["ts"] / 1e6
    beat = next(e for e in mine if e["kind"] == "search.state"
                and e["ts"] / 1e6 >= t_restore
                and e["state"] not in ("PARSE", "PACK", "SCHEDULE"))
    marks = [("detection and backoff", t_death, t_spawn),
             ("process start, import torch, parse", t_spawn, st[0]),
             ("CUDA context, byteFile read and packing, engines", st[0],
              st[1]),
             ("to the restore", st[1], t_restore - restore["seconds"]),
             ("restore (extension loads inside)",
              t_restore - restore["seconds"], t_restore),
             ("first iteration, to its beat", t_restore,
              beat["ts"] / 1e6)]
    split = {name: b - a for name, a, b in marks}
    ext_s = sum(e["seconds"] for e in loads)
    total = beat["ts"] / 1e6 - t_death
    out = {"taxa": SUP_TAXA, "patterns": setup["patterns"],
           "recover_s": total, "split_s": split, "extension_load_s": ext_s,
           "extension_loads": [(e["family"], e["seconds"]) for e in loads],
           "first_beat_state": beat["state"], "attempts": att,
           "kernels": kernels, "nvidia_smi_pids": sorted(seen),
           "child_pids": sorted(child_pids),
           "children_listed": sorted(child_pids & seen),
           "supervisor_pid": run.proc.pid, "wall_s": time.time() - run.t0,
           "device": smi}
    log(f"  (a) -f e on {SUP_TAXA} taxa x {setup['patterns']} patterns, "
        f"supervised; child SIGKILLed at its first checkpoint; time to "
        f"recover {total:.2f} s to the first {beat['state']} beat: "
        + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
        + f" (extension loads {ext_s:.3f} s, none built); B1 "
        f"{kernels['newview_chunk']} launches; run wall "
        f"{out['wall_s']:.1f} s [{smi}]")
    log(f"  (f) supervisor pid {run.proc.pid}: never in nvidia-smi's "
        f"compute apps ({len(seen)} pids seen, the children's "
        f"{sorted(child_pids & seen) or 'not among them'}), no libcuda or "
        "libtorch in its maps")
    return out


def side_by_side(parts: dict) -> tuple:
    """Run each of `parts` ({name: fn}) in a thread of its own (their work
    is in subprocesses); ({name: result}, {name: wall s}); the first
    failure is raised once all have ended."""
    import threading
    out, errors, walls = {}, {}, {}

    def run(name, fn):
        t = time.perf_counter()
        try:
            out[name] = fn()
        except BaseException as exc:          # noqa: BLE001 — re-raised
            errors[name] = exc
        walls[name] = time.perf_counter() - t

    threads = [threading.Thread(target=run, args=item)
               for item in parts.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        name, exc = next(iter(errors.items()))
        raise SmokeFailure(f"{name}: {exc}")
    return out, walls


def supervision_single(device, fd: dict, base: str, seed: int) -> dict:
    """(b): (i)-(iii) of tests/test_torch_supervisor.py on phase 7's
    alignment, -f e over three trees, side by side; each fault lands at
    the first tree's end, so every resume starts at a tree boundary and
    the final lnLs are bit for bit the unsupervised run's."""
    import signal
    from examl_tpu_torch.resilience import exitcause
    aln, trees = fd["aln"], os.path.join(base, "trees.nwk")
    want = fd["sup_lnls"]
    k = fd["sup_first_tree_beats"]

    def supervised(name, *extra):
        work = os.path.join(base, name)
        run = SupRun(sup_argv(aln, work, "-t", trees, "-f", "e",
                              "--supervise", "--supervise-backoff", "0.5")
                     + list(extra), work)
        try:
            rc = run.wait(f"(b) {name}")
        finally:
            run.stop()
        check(rc == 0, f"(b) {name} exited {rc}: {run.tail()}")
        return work, sup_snapshot(work), time.time() - run.t0

    def kill():
        work, snap, wall = supervised("kill", "--inject-fault",
                                      f"search.kill:after={k}")
        att = snap["resilience"]["attempts"]
        check(sup_causes(snap) == [exitcause.CAUSE_OOM_KILL,
                                   exitcause.CAUSE_OK]
              and att[1]["resumed"] and sup_lnls(work) == want,
              f"(b)(i) attempts {att}, lnLs {sup_lnls(work)} against "
              f"{want}")
        return {"wall_s": wall, "kernels": sup_check_b1(snap, "(b)(i)",
                                                        att)}

    def stall():
        work, snap, wall = supervised(
            "stall", "--supervise-stall", str(SUP_STALL_S),
            "--inject-fault", f"heartbeat.stall:after={k}",
            "--inject-fault", f"search.kill:after={k + 1}:hang=600")
        att = snap["resilience"]["attempts"]
        evs = sup_events(work)
        kill = next(e for e in evs if e["kind"] == "supervisor.kill")
        spawns = [e for e in evs if e["kind"] == "supervisor.spawn"]
        check(sup_causes(snap) == [exitcause.CAUSE_HANG_KILL,
                                   exitcause.CAUSE_OK]
              and att[1]["pins"] == {"--newview": "chunk"}
              and spawns[1]["pins"] == ["--newview"]
              and kill["reason"] == "heartbeat-stall"
              and sup_lnls(work) == want,
              f"(b)(ii) attempts {att}, kill {kill}, lnLs "
              f"{sup_lnls(work)}")
        return {"wall_s": wall, "beat_age_at_kill_s": kill["beat_age_s"],
                "kill_to_respawn_s": (spawns[1]["ts"] - kill["ts"]) / 1e6,
                "kernels": sup_check_b1(snap, "(b)(ii)", att)}

    def sigterm():
        work = os.path.join(base, "term")
        argv = sup_argv(aln, work, "-t", trees, "-f", "e", "--supervise",
                        "--supervise-backoff", "0.5")
        run = SupRun(argv + ["--inject-fault",
                             f"search.kill:after={k}:hang=5"], work)
        try:
            while not os.path.exists(os.path.join(
                    work, "ExaML_binaryCheckpoint.smoke.ckpt_1.json.gz")):
                check(run.proc.poll() is None and time.time() - run.t0
                      < SUP_TIMEOUT_S, "(b)(iii) no first-tree checkpoint")
                time.sleep(0.05)
            t_sig = time.time()
            run.proc.send_signal(signal.SIGTERM)
            rc = run.wait("(b)(iii)")
        finally:
            run.stop()
        check(rc == exitcause.EXIT_PREEMPTED, f"(b)(iii) SIGTERM: the "
              f"supervisor exited {rc}: {run.tail()}")
        stop_s = time.time() - t_sig
        rerun = SupRun(argv, work)
        try:
            rc = rerun.wait("(b)(iii) rerun")
        finally:
            rerun.stop()
        snap = sup_snapshot(work)
        check(rc == 0 and snap["resilience"]["attempts"][0]["resumed"]
              and sup_lnls(work) == want,
              f"(b)(iii) rerun exited {rc}, lnLs {sup_lnls(work)}")
        return {"stop_s": stop_s,
                "kernels": sup_check_b1(snap, "(b)(iii)")}

    out, walls = side_by_side({"kill": kill, "stall": stall,
                               "sigterm": sigterm})
    out["parts_s"] = walls
    return out


def supervision_gang(device, fd: dict, base: str) -> dict:
    """(c): --launch 2, a real gloo gang on the one card: rank 1 killed as
    it stages the second tree's cycle; beside it, a gang whose second
    publish is killed (checkpoint.publish:signal=KILL), after which the
    restore falls back a cycle.  Both end within rel 1e-6 (f32, two
    ranks' site sums) of the one process."""
    from examl_tpu_torch.resilience import exitcause
    trees = os.path.join(base, "trees.nwk")
    want = fd["sup_lnls"]

    def gang(name, spec):
        work = os.path.join(base, name)
        run = SupRun(sup_argv(fd["aln"], work, "-t", trees, "-f", "e",
                              "--launch", "2", "--supervise-backoff", "0.5",
                              "--supervise-stall", "120", "--inject-fault",
                              spec), work)
        try:
            rc = run.wait(f"(c) {name}")
        finally:
            run.stop()
        check(rc == 0, f"(c) {name} exited {rc}: {run.tail()}")
        snap = sup_snapshot(work)
        att = snap["resilience"]["attempts"]
        got = sup_lnls(work)
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        check(len(att) == 2 and att[1]["cause"] == exitcause.CAUSE_OK
              and att[0]["cause"] == exitcause.CAUSE_OOM_KILL
              and att[1]["resumed"] and len(got) == len(want)
              and rel <= 1e-6, f"(c) {name}: attempts {att}, lnLs {got} "
              f"against {want} (rel {rel:.2e})")
        evs = sup_events(work)
        t_kill = next(e for e in evs if e["kind"] == "supervisor.kill")[
            "ts"] / 1e6
        back = [e["ts"] / 1e6 for e in evs if e["kind"] ==
                "checkpoint.restore" and e["ts"] / 1e6 > t_kill]
        check(len(back) == 2, f"(c) {name}: {len(back)} rank restores")
        gc = [e for e in evs if e["kind"] == "checkpoint.gc"]
        if name == "rank_kill":
            check(att[0]["rank"] == 1, f"(c) blamed rank {att[0]['rank']}")
        else:
            check(gc and snap["counters"].get(
                "checkpoint.partial_cycles_gced", 0) >= 1,
                f"(c) publish_kill: no partial cycle collected ({gc})")
        info = open(os.path.join(work, "ExaML_info.smoke")).read()
        return {"rel": rel, "blamed_rank": att[0]["rank"],
                "gang_restart_s": max(back) - t_kill,
                "restart_at": re.findall(r"restart at tree (\d+)", info),
                "collected_cycles": [e["cycles"] for e in gc],
                "kernels": sup_check_b1(snap, f"(c) {name}", att)}

    out, walls = side_by_side({
        "rank_kill": lambda: gang(
            "rank_kill", "checkpoint.write@rank=1:after=2:signal=KILL"),
        "publish_kill": lambda: gang(
            "publish_kill", "checkpoint.publish:after=2:signal=KILL")})
    out["parts_s"] = walls
    return out


def supervision_leased(device, real_aln: str, base: str,
                       want: dict) -> dict:
    """(d): phase 23's 8-job real-size DNA fleet as two leased ranks
    (--nprocs 2 --procid K, --fleet-lease-ttl SUP_TTL_S), rank 1 killed at
    its first batch: every job lands once, bit for bit as one process."""
    work = os.path.join(base, "leased")
    argv = sup_argv(real_aln, work, "-N", str(FLEET_JOBS), "--fleet-batch",
                    "2", "--fleet-lease-ttl", str(SUP_TTL_S), "--ledger",
                    work, "--inject-fault", "search.kill@rank=1:after=1",
                    "--inject-fault", "fleet.job.hang:job=start0:hang=2")
    ranks = [SupRun(argv + ["--nprocs", "2", "--procid", str(r)],
                    os.path.join(work, f"r{r}")) for r in range(2)]
    try:
        rcs = [r.wait(f"(d) rank {k}") for k, r in enumerate(ranks)]
    finally:
        for r in ranks:
            r.stop()
    check(rcs == [0, -9], f"(d) leased ranks exited {rcs}: "
          f"{ranks[0].tail()}")
    evs = sup_events(work)
    done = [e["job"] for e in evs if e["kind"] == "job.done"]
    got = sup_journal(work)
    check(sorted(done) == sorted(want) and got == want,
          f"(d) jobs done {sorted(done)}; lnLs {got} against {want}")
    death = next(e["ts"] / 1e6 for e in evs if e["kind"] == "fault"
                 and e.get("proc") == 1)
    reaps = [e for e in evs if e["kind"] == "lease.reap"]
    check(reaps and all(e["proc"] == 0 and e["from_rank"] == 1
                        for e in reaps), f"(d) reaps {reaps}")
    reaped = {e["job"] for e in reaps}
    done_t = {e["job"]: e["ts"] / 1e6 for e in evs if e["kind"] == "job.done"}
    cost = {j: done_t[j] - death for j in sorted(reaped)}
    return {"reaped": sorted(reaped), "death_to_reap_s": [
        e["ts"] / 1e6 - death for e in reaps], "death_to_done_s": cost,
        "done_by_rank": {str(p): sum(1 for e in evs if e["kind"] ==
                                     "job.done" and e["proc"] == p)
                         for p in (0, 1)},
        "kernels": sup_check_b1(sup_snapshot(work), "(d) rank 0")}


def supervision_deadline(device, fd: dict, base: str, want: dict) -> dict:
    """(e): -N 6 --fleet-batch 2 --fleet-job-deadline SUP_DEADLINE_S, start3
    hanging in every attempt: two fleet-job-stuck kills, no retry used
    (the budget is 0), start3 quarantined, the other jobs bit for bit."""
    from examl_tpu_torch.fleet import quarantine
    from examl_tpu_torch.resilience import exitcause
    work = os.path.join(base, "deadline")
    run = SupRun(sup_argv(fd["aln"], work, "-N", "6", "--fleet-batch", "2",
                          "--fleet-job-deadline", str(SUP_DEADLINE_S),
                          "--supervise", "--supervise-retries", "0",
                          "--supervise-backoff", "0.5", "--inject-fault",
                          "fleet.job.hang:job=start3:attempt=*"), work)
    try:
        rc = run.wait("(e)")
    finally:
        run.stop()
    snap = sup_snapshot(work)
    stuck = exitcause.CAUSE_FLEET_JOB_STUCK
    dead = quarantine.DeadLetters(os.path.join(
        work, "ExaML_fleetFailed.smoke")).read()
    check(rc == 0 and sup_causes(snap) == [stuck, stuck, exitcause.CAUSE_OK]
          and snap["resilience"]["fleet_hang_attempts"] == {"start2": 1,
                                                            "start3": 2}
          and [(d["job_id"], d["cause"]) for d in dead] == [("start3",
                                                             "hang")]
          and sup_journal(work) == {j: v for j, v in want.items()
                                    if j != "start3"},
          f"(e) rc {rc}, attempts {snap['resilience']['attempts']}, "
          f"dead letters {dead}, lnLs {sup_journal(work)}")
    evs = sup_events(work)
    kills = [e for e in evs if e["kind"] == "supervisor.kill"]
    return {"kills": len(kills), "wall_s": time.time() - run.t0,
            "kernels": sup_check_b1(snap, "(e)",
                                    snap["resilience"]["attempts"])}


def phase_supervision(device, setup: dict, fd: dict, seed: int,
                      smi: str) -> dict:
    """Phase 26: the supervisor, the gang checkpoint and the leased fleet
    ranks on the card.  (a) with (f) runs alone (its times are the
    recovery's); the one-process references run next in this process;
    then (b)-(e) side by side (their work is in subprocesses)."""
    from examl_tpu_torch.io.bytefile import read_bytefile
    from examl_tpu_torch.tree.topology import Tree
    t0 = time.perf_counter()
    out = {"recover": supervision_recover(device, setup, seed, smi)}
    base = os.path.join(HERE, "build", "supervision", "small")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    names = read_bytefile(fd["aln"]).taxon_names
    with open(os.path.join(base, "trees.nwk"), "w") as f:
        f.write(open(fd["start_tree"]).read().strip() + "\n")
        for k in (1, 2):
            f.write(Tree.random(names, seed + k, 1).to_newick(names) + "\n")
    ref = os.path.join(base, "ref_fe")
    states, _, _ = sup_reference(device, ["-s", fd["aln"], "-t",
                                          os.path.join(base, "trees.nwk"),
                                          "-f", "e"], ref)
    fd = dict(fd, sup_lnls=sup_lnls(ref),
              sup_first_tree_beats=states.index("TREE_EVAL") + 1)
    ref_n6 = os.path.join(base, "ref_n6")
    sup_reference(device, ["-s", fd["aln"], "-N", "6", "--fleet-batch", "2"],
                  ref_n6, fleet=True)
    real_aln = os.path.join(HERE, "build", "site_parallel", "real.binary")
    ref_n8 = os.path.join(base, "ref_n8")
    sup_reference(device, ["-s", real_aln, "-N", str(FLEET_JOBS),
                           "--fleet-batch", "2"], ref_n8, fleet=True)
    release_memory()
    out["references_s"] = (time.perf_counter() - t0
                           - out["recover"]["wall_s"])
    res, walls = side_by_side({
        "single": lambda: supervision_single(device, fd, base, seed),
        "gang": lambda: supervision_gang(device, fd, base),
        "leased": lambda: supervision_leased(
            device, real_aln, base, sup_journal(ref_n8)),
        "deadline": lambda: supervision_deadline(
            device, fd, base, sup_journal(ref_n6))})
    out.update(res)
    out["parts_s"] = walls
    out["wall_s"] = time.perf_counter() - t0
    s, g, d, e = (out[k] for k in ("single", "gang", "leased", "deadline"))
    log(f"  (b) on phase 7's alignment, -f e over 3 trees, lnLs bit for bit "
        f"as unsupervised: (i) search.kill resumed in "
        f"{s['kill']['wall_s']:.1f} s; (ii) stall window {SUP_STALL_S:.0f} s: "
        f"killed at beat age {s['stall']['beat_age_at_kill_s']} s, "
        f"respawned {s['stall']['kill_to_respawn_s']:.2f} s later on rung 1; "
        f"(iii) SIGTERM: exit 75 {s['sigterm']['stop_s']:.2f} s after the "
        "signal, the rerun resumed")
    log(f"  (c) --launch 2 (gloo): rank {g['rank_kill']['blamed_rank']} "
        f"killed, gang back (both ranks restored) "
        f"{g['rank_kill']['gang_restart_s']:.2f} s after the kill, rel "
        f"{g['rank_kill']['rel']:.1e}; checkpoint.publish kill: cycles "
        f"{g['publish_kill']['collected_cycles']} collected, back in "
        f"{g['publish_kill']['gang_restart_s']:.2f} s, rel "
        f"{g['publish_kill']['rel']:.1e}")
    log(f"  (d) {FLEET_JOBS} real-size jobs on two leased ranks (ttl "
        f"{SUP_TTL_S:.0f} s), rank 1 killed: jobs done by rank "
        f"{d['done_by_rank']}, {len(d['reaped'])} leases reaped "
        + ", ".join(f"{x:.2f}" for x in d["death_to_reap_s"])
        + " s after the death, their jobs done "
        + ", ".join(f"{j} {x:.2f}" for j, x in d["death_to_done_s"].items())
        + " s after; every job once, bit for bit")
    log(f"  (e) deadline {SUP_DEADLINE_S:.0f} s: {e['kills']} job-stuck kills,"
        f" start3 quarantined, no retry used, {e['wall_s']:.1f} s")
    kern = {"(a)": [out["recover"]["kernels"]],
            "(b)": [s[k]["kernels"] for k in ("kill", "stall", "sigterm")],
            "(c)": [g[k]["kernels"] for k in ("rank_kill", "publish_kill")],
            "(d)": [d["kernels"]], "(e)": [e["kernels"]]}
    b1 = {p: sum(k["newview_chunk"] for k in ks) for p, ks in kern.items()}
    out["b1_launches"] = b1
    out["b2_launches"] = sum(k["newview_whole"] for ks in kern.values()
                             for k in ks)
    log(f"  the children's launches (their --metrics snapshots, killed "
        f"attempts' last flushes included; a leased rank 1 writes none): "
        f"B1 {sum(b1.values())} ("
        + ", ".join(f"{p} {n}" for p, n in b1.items())
        + f"), B2 {out['b2_launches']}")
    log(f"  parts run side by side: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in walls.items())
        + f"; phase wall {out['wall_s']:.1f} s [{smi}]")
    return out


def bank_build(log_fn) -> tuple:
    """Phase 2's build, through the extension bank (part (a) of phase 27):
    both libraries in bank workers on the checkout's build directory (cold
    in a fresh checkout), each one's seconds recorded.  Returns (report,
    wall s)."""
    from examl_tpu_torch.ops import _build, bank
    t0 = time.perf_counter()
    report = bank.run_bank(argparse.Namespace(
        mode="d", model="GAMMA", save_memory=False, newview="whole",
        compile_timeout=BANK_BUILD_TIMEOUT_S), log=log_fn)
    wall = time.perf_counter() - t0
    check(sorted(report) == _build.sources()
          and all(r["status"] == "banked" for r in report.values()),
          f"the opening bank did not bank every library: {report}")
    return report, wall


def wedge_child() -> int:
    """The B1 wedge check's child (`--wedge-child`): one dataflow launch
    of kernel B1 over a one-row table whose entries wait on their own
    output rows, so the dependency can never become ready.  The operands
    are zeros (the entries never compute) and go straight to
    `chunk_apply_cuda`, so the launch comes as early as the process
    allows.  Prints the launch's wall time, then one JSON line with the
    outcome (a KernelError, another error, or none) and the seconds from
    the launch; a hang is the parent's timeout."""
    t_start = time.time()
    import torch
    from examl_tpu_torch.ops import newview_chunk
    device = torch.device("cuda", 0)
    dtype, K, R, M, C, L, B, W, ntips = (torch.float32, 4, 4, 1, 16, 128,
                                         64, 4, 4)
    check(newview_chunk.ROUTE[(K, dtype)] == "flow",
          "B1's f32 K = 4 instance is not on the dataflow route")
    base = 2 * W
    i32 = dict(dtype=torch.int32, device=device)
    clv = torch.zeros((base + W + 1, B, L, R, K), dtype=dtype,
                      device=device)
    flow = newview_chunk.Dataflow(
        torch.as_tensor([(2, base, 0, 0), (0, 0, 0, W)], **i32),
        torch.ones(W, **i32), newview_chunk.Ready())
    args = (clv, torch.zeros(clv.shape[:3], **i32),
            torch.zeros((ntips, B, L), dtype=torch.uint8, device=device),
            torch.zeros((W, 2, M, C, R, K), dtype=dtype, device=device),
            torch.zeros(B, **i32), np.asarray([(2, base, 0, W)], np.int32),
            torch.arange(base, base + W, **i32),     # its own output rows
            torch.arange(0, W, **i32), torch.zeros(W, **i32),
            torch.zeros(W, **i32),
            torch.zeros((W, 2, M, R, K, K), dtype=dtype, device=device), 32)
    print(json.dumps({"launch_at": time.time(),
                      "start_to_launch_s": time.time() - t_start}),
          flush=True)
    t0 = time.perf_counter()
    out = {"outcome": "returned"}
    try:
        newview_chunk.chunk_apply_cuda(*args, flow)
        torch.cuda.synchronize(device)
    except Exception as exc:                  # noqa: BLE001 — the outcome
        out = {"outcome": type(exc).__name__, "error": str(exc)[:300]}
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


def bank_wedge_check(base: str) -> dict:
    """The B1 wedge check (ROADMAP §C): `wedge_child` in a process of its
    own, killed with its group after WEDGE_CHECK_S seconds."""
    import signal
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, os.path.join(HERE,
                                                          "chip_smoke.py"),
                             "--wedge-child"], cwd=HERE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True,
                            env=dict(os.environ, PYTHONPATH=HERE))
    try:
        out, err = proc.communicate(timeout=WEDGE_CHECK_S)
        killed = False
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        killed = True
    t_end = time.time()
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    res = {"outcome": "hang" if killed else f"exit {proc.returncode}",
           "error": err[-300:]}
    for x in lines:
        res.update(x)
    if killed:
        res["outcome"] = "hang"
        if "launch_at" in res:
            res["seconds"] = t_end - res["launch_at"]
    res["killed"] = killed
    res["wall_s"] = time.perf_counter() - t0
    res["returncode"] = proc.returncode
    with open(os.path.join(base, "wedge.json"), "w") as f:
        json.dump(res, f)
    return res


def bank_run(argv, workdir: str, env=None, timeout: float = 300) -> dict:
    """One `python -m examl_tpu_torch.cli.main` run to its end (argv
    without -n/-w/--metrics): rc, wall, output, metrics snapshot."""
    os.makedirs(workdir, exist_ok=True)
    t0 = time.perf_counter()
    res = subprocess.run(
        CLI_CMD + argv + ["-n", "smoke", "-w", workdir, "--metrics",
                          os.path.join(workdir, "m.json")],
        cwd=HERE, capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, PYTHONPATH=HERE, **(env or {})))
    out = {"rc": res.returncode, "wall_s": time.perf_counter() - t0,
           "output": res.stdout[-3000:] + res.stderr[-3000:]}
    try:
        out["snap"] = sup_snapshot(workdir)
    except OSError:
        out["snap"] = {}
    return out


def bank_wedged(base: str, fd: dict) -> dict:
    """(b): -f e on the phase's alignment (ref49 until the script's time
    limit cut it) with --bank --compile-timeout BANK_TIMEOUT_S and
    compile.hang armed, on a cold relocated build directory: the B1
    worker is killed at the deadline, newview_chunk recorded as degraded,
    the run ends on --newview scan without a B1 launch; its lnL against
    the same run with --newview chunk (side by side).  The f64 check of
    its endpoint is `bank_f64`'s."""
    from examl_tpu_torch.ops import bank
    cold = os.path.join(base, "cold_b")
    argv = ["-s", fd["aln"], "-t", fd["start_tree"], "-f", "e"]
    res, walls = side_by_side({
        "bank": lambda: bank_run(argv + [
            "--bank", "--compile-timeout", str(BANK_TIMEOUT_S),
            "--inject-fault", "compile.hang"], os.path.join(base, "b_bank"),
            env={"EXAML_BUILD_DIR": cold}),
        "chunk": lambda: bank_run(argv + ["--newview", "chunk"],
                                  os.path.join(base, "b_chunk"))})
    b, c = res["bank"], res["chunk"]
    check(b["rc"] == 0 and c["rc"] == 0, f"(b) runs exited {b['rc']}, "
          f"{c['rc']}: {b['output'][-1500:]} {c['output'][-1500:]}")
    work = os.path.join(base, "b_bank")
    with open(os.path.join(work, "ExaML_info.smoke")) as f:
        info = f.read()
    counters = b["snap"]["counters"]
    bank_s = b["snap"]["timers"]["bank.wall_seconds"]["total_s"]
    man = bank.load_manifest(cold)
    check("ERROR: bank: CUDA library 'newview_chunk' timeout" in info
          and "newview: scan" in info
          and counters.get("bank.timeouts") == 1
          and counters.get("bank.fallbacks") == 1
          and bank.manifest_degraded_families(man) == {"newview_chunk"}
          and BANK_TIMEOUT_S <= bank_s < BANK_TIMEOUT_S + 2.5,
          f"(b) not degraded as expected: bank {bank_s} s, counters "
          f"{ {k: v for k, v in counters.items() if k.startswith('bank')} },"
          f" manifest {man}")
    b1 = counters.get("kernel.newview_chunk.launches", 0)
    c1 = c["snap"]["counters"].get("kernel.newview_chunk.launches", 0)
    check(b1 == 0 and c1 > 0, f"(b) B1 launches: scan {b1}, chunk {c1}")
    lnl = {k: float(open(os.path.join(base, d, "ExaML_log.smoke")).read()
                    .split()[-1]) for k, d in (("scan", "b_bank"),
                                               ("chunk", "b_chunk"))}
    rel = abs(lnl["scan"] - lnl["chunk"]) / abs(lnl["chunk"])
    check(rel <= 1e-6, f"(b) lnL scan {lnl['scan']!r}, chunk "
          f"{lnl['chunk']!r} (rel {rel:.2e})")
    return {"bank_s": bank_s, "deadline_s": BANK_TIMEOUT_S, "lnl": lnl,
            "rel": rel, "b1_launches": {"scan": b1, "chunk": c1},
            "walls_s": walls, "manifest": man["families"], "work": work}


def bank_f64(device, fd: dict, b: dict) -> float:
    """(b)'s endpoint in f64 on the card from the run's own files (its
    tree under its model), held to the lnL it logged (abs 2e-3, phase
    7's budget for its re-evaluations)."""
    import torch
    from examl_tpu_torch.instance import PhyloInstance
    from examl_tpu_torch.io.bytefile import read_bytefile
    from examl_tpu_torch.transfer import install_model_params
    inst = PhyloInstance(read_bytefile(fd["aln"]), dtype=torch.float64,
                         device=device, newview="scan")
    install_model_params(inst, [(p.rates, p.freqs, p.alpha) for p in
                                refmodel().parse_model_file(os.path.join(
                                    b["work"], "ExaML_modelFile.smoke"))])
    with open(os.path.join(b["work"], "ExaML_TreeFile.smoke")) as f:
        f64 = inst.evaluate(inst.tree_from_newick(f.read()), full=True)
    check(abs(f64 - b["lnl"]["scan"]) <= 2e-3,
          f"(b) f64 {f64!r} against the logged {b['lnl']['scan']!r}")
    return f64


def bank_truncated_copy(d: str, family: str):
    """A build directory `d` holding a copy of `family`'s library cut to
    half its bytes, with the library's manifest entry: (path, full
    size)."""
    from examl_tpu_torch.ops import _build, export_bank
    os.makedirs(d)
    src = _build._lib_path(family)
    dst = os.path.join(d, src.name)
    shutil.copyfile(src.with_suffix(".log"),
                    os.path.join(d, src.with_suffix(".log").name))
    entry = export_bank.read_manifest(src.parent)["exports"][src.name]
    with export_bank.updating_manifest(d) as doc:
        doc["exports"] = {src.name: entry}
    with open(src, "rb") as f:
        data = f.read()
    with open(dst, "wb") as f:
        f.write(data[:len(data) // 2])
    return dst, len(data)


def bank_quarantine(base: str, fd: dict, family: str) -> dict:
    """(c): a copy of `family`'s library, truncated, in a relocated build
    directory with its manifest entry: EXAML_EXPORT_BANK=require raises
    ExportBankRequired; on a second such copy, =on quarantines and
    rebuilds it and the run succeeds."""
    from examl_tpu_torch.ops import export_bank
    argv = ["-s", fd["aln"], "-t", fd["start_tree"], "-f", "e"] + (
        ["--newview", "whole"] if family == "newview_whole" else [])
    copies = {m: bank_truncated_copy(os.path.join(base, f"c_{m}_kernels"),
                                     family) for m in ("require", "on")}
    res, _ = side_by_side({m: (lambda m=m: bank_run(
        argv, os.path.join(base, f"c_{m}"),
        env={"EXAML_BUILD_DIR": os.path.dirname(copies[m][0]),
             "EXAML_EXPORT_BANK": m})) for m in copies})
    req, on = res["require"], res["on"]
    check(req["rc"] != 0 and "ExportBankRequired" in req["output"],
          f"(c) require: rc {req['rc']}: {req['output'][-1500:]}")
    dst, size = copies["on"]
    c = on["snap"].get("counters", {})
    launches = c.get(f"kernel.{family}.launches", 0)
    check(on["rc"] == 0 and c.get("bank.export.rejected.digest") == 1
          and c.get("bank.export.quarantined") == 1
          and c.get("engine.compile_count") == 1 and launches > 0
          and os.path.exists(dst + export_bank.QUARANTINE_SUFFIX)
          and os.path.getsize(dst) == size,
          f"(c) on: rc {on['rc']}, counters "
          f"{ {k: v for k, v in c.items() if 'bank' in k or 'compile' in k} }"
          f": {on['output'][-1500:]}")
    return {"family": family, "require_wall_s": req["wall_s"],
            "on_wall_s": on["wall_s"],
            "rebuild_s": c.get(f"engine.compile_seconds.{family}"),
            "launches": launches}


def bank_supervised(fd: dict, work: str) -> int:
    run = SupRun(sup_argv(fd["aln"], work, "-t", fd["start_tree"], "-f", "e",
                          "--supervise", "--supervise-backoff", "0.1",
                          "--inject-fault",
                          "compile.hang:signal=SEGV:attempt=*"), work)
    try:
        return run.wait("(d)")
    finally:
        run.stop()


def bank_rung3(fd: dict, base: str) -> dict:
    """(d): --supervise -f e with compile.hang:signal=SEGV on every
    attempt: each kernel rung crashes at its first B1 load, the run
    climbs rungs 1-3 and ends on rung 3 bit for bit as the unsupervised
    kernel-free run (a process of its own, side by side); no B1 launch
    on rung 3."""
    from examl_tpu_torch.resilience import exitcause
    from examl_tpu_torch.resilience import supervisor as sup
    work = os.path.join(base, "d_sup")
    ref = os.path.join(base, "d_ref")
    t0 = time.time()
    res, _ = side_by_side({
        "sup": lambda: bank_supervised(fd, work),
        "ref": lambda: bank_run(["-s", fd["aln"], "-t", fd["start_tree"],
                                 "-f", "e", "--newview", "scan",
                                 "--batch-scan", "off", "--grad-smooth",
                                 "off"], ref)})
    r = res["ref"]
    rk = r["snap"].get("counters", {})
    check(r["rc"] == 0 and not rk.get("kernel.newview_chunk.launches")
          and not rk.get("kernel.newview_whole.launches"),
          f"(d) reference: rc {r['rc']}: {r['output'][-1500:]}")
    ref_lnls = sup_lnls(ref)
    with open(os.path.join(work, "stdout.txt")) as f:
        tail = f.read()[-3000:]
    check(res["sup"] == 0, f"(d) the supervised -f e exited {res['sup']}: "
          f"{tail}")
    snap = sup_snapshot(work)
    att = snap["resilience"]["attempts"]
    check(sup_causes(snap) == [exitcause.CAUSE_CRASH] * 3
          + [exitcause.CAUSE_OK]
          and [a["degrade_level"] for a in att] == [0, 1, 2, 3]
          and att[-1]["pins"] == sup.DEGRADE_LADDER[3]
          and sup_lnls(work) == ref_lnls,
          f"(d) attempts {att}, lnLs {sup_lnls(work)} against {ref_lnls}")
    k = sup_kernels(snap)
    k_all = sup_kernels(snap, att)
    check(k["newview_chunk"] == 0 and k_all["newview_chunk"] == 0
          and k_all["newview_whole"] == 0,
          f"(d) B1/B2 launches: rung 3 {k}, all attempts {k_all}")
    return {"wall_s": time.time() - t0, "causes": sup_causes(snap),
            "attempt_s": [a["seconds"] for a in att], "kernels": k_all}


def phase_bank(device, bank_report: dict, bank_wall: float, smi: str,
               seed: int) -> dict:
    """Phase 27: the extension bank and the supervisor's last rung on the
    card.  (a) is the opening build (phase 2) through bank workers; then
    (b), (c), (d) and the B1 wedge check side by side (their work is in
    subprocesses) on a small alignment of this phase's own, and (b)'s
    endpoint checked in f64 here."""
    from examl_tpu_torch.io.bytefile import write_bytefile
    from examl_tpu_torch.tree.topology import Tree
    t0 = time.perf_counter()
    base = os.path.join(HERE, "build", "bank_smoke")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    ad = synthetic_alignment(FD_TAXA, PARTITIONS, BANK_WIDTH, seed)
    fd = {"aln": os.path.join(base, "aln.binary"),
          "start_tree": os.path.join(base, "start.nwk")}
    write_bytefile(fd["aln"], ad)
    with open(fd["start_tree"], "w") as f:
        f.write(Tree.random(ad.taxon_names, seed, 1).to_newick(
            ad.taxon_names) + "\n")
    cold = {f: {"seconds": r["seconds"], "built": r["built"]}
            for f, r in bank_report.items()}
    smaller = min(cold, key=lambda f: cold[f]["seconds"])
    log(f"  (a) the opening build through bank workers, {bank_wall:.1f} s: "
        + ", ".join(f"{f} {'built' if r['built'] else 'found built'} in "
                    f"{r['seconds']:.1f} s" for f, r in cold.items())
        + f" [{smi}]")
    res, walls = side_by_side({
        "wedged": lambda: bank_wedged(base, fd),
        "quarantine": lambda: bank_quarantine(base, fd, smaller),
        "rung3": lambda: bank_rung3(fd, base),
        "wedge_check": lambda: bank_wedge_check(base)})
    res["wedged"]["f64_lnl"] = bank_f64(device, fd, res["wedged"])
    out = dict(res, cold_build=cold, cold_wall_s=bank_wall, parts_s=walls,
               taxa=FD_TAXA, columns=PARTITIONS * BANK_WIDTH,
               wall_s=time.perf_counter() - t0)
    b, c, d, w = (res[k] for k in ("wedged", "quarantine", "rung3",
                                   "wedge_check"))
    log(f"  (b) -f e --bank --compile-timeout {BANK_TIMEOUT_S:g} with "
        f"compile.hang: the B1 worker killed, bank phase {b['bank_s']:.2f} s;"
        f" newview_chunk degraded in the manifest; ended on --newview scan "
        f"with {b['b1_launches']['scan']} B1 launches: lnL "
        f"{b['lnl']['scan']!r} against --newview chunk {b['lnl']['chunk']!r}"
        f" (rel {b['rel']:.2e}, {b['b1_launches']['chunk']} B1 launches), "
        f"f64 from its files {b['f64_lnl']!r}")
    log(f"  (c) {c['family']} truncated: require raised ExportBankRequired "
        f"({c['require_wall_s']:.1f} s); on quarantined and rebuilt it "
        f"({c['rebuild_s']:.1f} s of nvcc), the run {c['on_wall_s']:.1f} s "
        f"with {c['launches']} launches")
    log(f"  (d) --supervise with compile.hang:signal=SEGV on every attempt: "
        f"causes {d['causes']}, attempts "
        + ", ".join(f"{x:.1f}" for x in d["attempt_s"])
        + f" s; rung 3 bit for bit as unsupervised, B1 "
        f"{d['kernels']['newview_chunk']} launches, B2 "
        f"{d['kernels']['newview_whole']}")
    log(f"  B1 wedge check (a dataflow row waiting on its own rows): "
        f"{w['outcome']}" + (f" after {w['seconds']:.1f} s"
                             if "seconds" in w else "")
        + (f" ({w.get('error', '')[:120]})" if w.get("error") else "")
        + f"; wall {w['wall_s']:.1f} s")
    log(f"  parts run side by side on {FD_TAXA} taxa x {PARTITIONS} x "
        f"{BANK_WIDTH} columns: " + ", ".join(
            f"{k} {v:.1f} s" for k, v in walls.items())
        + f"; phase wall {out['wall_s']:.1f} s [{smi}]")
    return out


def host_ab_child(root: str, seed: int, device=None) -> dict:
    """One side of `--host-ab`: the port of the tree at `root` (this
    process imports its package) with every instrument off, the
    real-size DNA evaluate (median of HOST_AB_EVALUATES) and `-f d -i 5`
    through the CLI on phase 7's alignment, HOST_AB_FD_RUNS times."""
    import torch
    import examl_tpu_torch
    from examl_tpu_torch.io.bytefile import write_bytefile
    from examl_tpu_torch.ops import _build
    from examl_tpu_torch.tree.topology import Tree
    pkg = os.path.dirname(os.path.abspath(examl_tpu_torch.__file__))
    check(pkg == os.path.join(os.path.abspath(root), "examl_tpu_torch"),
          f"imported {pkg}, not the package of {root}")
    device = device or torch.device("cuda", 0)
    _build.build_all()
    setup = real_setup(TAXA, PARTITIONS, PART_WIDTH, seed)
    inst, tree = real_instance(setup, device, "chunk")
    for _ in range(3):
        inst.evaluate(tree, full=True)
    lnl, walls = timed_evaluates(inst, tree, device, HOST_AB_EVALUATES)
    del inst, tree
    release_memory()
    base = os.path.join(root, "build", "host_ab")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    ad = synthetic_alignment(FD_TAXA, PARTITIONS, FD_WIDTH, seed)
    aln = os.path.join(base, "fd_aln.binary")
    write_bytefile(aln, ad)
    start = os.path.join(base, "fd_start.nwk")
    with open(start, "w") as f:
        f.write(Tree.random(ad.taxon_names, seed, 1).to_newick(
            ad.taxon_names) + "\n")
    fd = []
    for i in range(HOST_AB_FD_RUNS):
        workdir = os.path.join(base, f"fd{i}")
        os.makedirs(workdir)
        rc, wall, _, info = run_cli(["-s", aln, "-t", start, "-i", "5"],
                                    device, workdir)
        check(rc == 0, f"-f d through the CLI returned {rc}")
        fd.append({"wall_s": wall, "lnl": float(re.search(
            r"Likelihood of best tree: (\S+)", info).group(1))})
    return {"root": root, "lnl": lnl,
            "evaluate_ms": [w * 1e3 for w in walls],
            "evaluate_median_ms": float(np.median(walls)) * 1e3, "fd": fd}


def host_ab(parent: str, seed: int) -> int:
    """`--host-ab PARENT`: the host cost of this tree's port against the
    port of the tree at PARENT (a `git archive` of the parent commit),
    with every instrument off, in turns (parent, this, this, parent),
    each side a child process of this script (`--host-ab-child`).
    Prints both sides and writes chiprun_out/host_ab.json."""
    parent = os.path.abspath(parent)
    check(os.path.isdir(os.path.join(parent, "examl_tpu_torch")),
          f"{parent} holds no examl_tpu_torch")
    smi = nvidia_smi_line()
    runs = []
    for root in (parent, HERE, HERE, parent):
        proc = subprocess.run(
            [sys.executable, os.path.join(HERE, "chip_smoke.py"),
             "--seed", str(seed), "--host-ab-child", root],
            capture_output=True, text=True, timeout=900)
        sys.stderr.write(proc.stderr[-4000:])
        check(proc.returncode == 0,
              f"--host-ab-child {root} exited {proc.returncode}")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        got["side"] = "parent" if root == parent else "change"
        runs.append(got)
        log(f"  {got['side']}: evaluate median "
            f"{got['evaluate_median_ms']:.3f} ms (min "
            f"{min(got['evaluate_ms']):.3f}, max "
            f"{max(got['evaluate_ms']):.3f}); -f d "
            + ", ".join(f"{r['wall_s']:.2f} s" for r in got["fd"])
            + f"; lnL {got['lnl']!r}, -f d {got['fd'][0]['lnl']!r}")
    summary = {}
    for side in ("parent", "change"):
        mine = [r for r in runs if r["side"] == side]
        summary[side] = {
            "evaluate_median_ms": [r["evaluate_median_ms"] for r in mine],
            "fd_wall_s": [f["wall_s"] for r in mine for f in r["fd"]],
            "lnl": sorted({r["lnl"] for r in mine}),
            "fd_lnl": sorted({f["lnl"] for r in mine for f in r["fd"]})}
    same = (summary["parent"]["lnl"] == summary["change"]["lnl"]
            and summary["parent"]["fd_lnl"] == summary["change"]["fd_lnl"])
    for side, v in summary.items():
        log(f"  {side}: evaluate medians "
            + ", ".join(f"{x:.3f}" for x in v["evaluate_median_ms"])
            + " ms; -f d walls "
            + ", ".join(f"{x:.2f}" for x in v["fd_wall_s"]) + " s")
    log(f"  lnLs the same on both sides: {same}")
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "host_ab.json"), "w") as f:
        json.dump({"card": smi, "runs": runs, "summary": summary,
                   "same_lnl": same}, f, indent=1)
    print(smi)
    return 0

def device_breakdown(fn, device, top: int = 8) -> dict:
    """Device time of one call of fn() by kernel, from torch.profiler:
    busy ms (sum of kernel self times), the wall ms of the call, the idle
    share, and the top kernels, beside the B1 and B2 launches the call
    counted (so that a kernel launched but missing from the trace shows).
    The profiler is untried on every machine, so a failure to trace is
    recorded as not measured."""
    from torch.profiler import ProfilerActivity, profile
    from examl_tpu_torch.ops import newview_chunk, newview_whole
    sync(device)
    n1, n2 = newview_chunk.LAUNCHES, newview_whole.LAUNCHES
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            sync(device)
            wall_ms = (time.perf_counter() - t0) * 1e3
        launched = {"b1_launches": newview_chunk.LAUNCHES - n1,
                    "b2_launches": newview_whole.LAUNCHES - n2}
        rows = []
        for e in prof.key_averages():
            # Device-side events only: an operator's row repeats the time
            # of the kernels it launched.
            if "CUDA" not in str(getattr(e, "device_type", "")):
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            if us > 0:
                rows.append((e.key, us / 1e3, e.count))
    except (RuntimeError, AttributeError) as exc:
        return {"measured": False, "error": f"{type(exc).__name__}: {exc}"}
    if not rows:
        return {"measured": False, "error": "no device time in the trace",
                **launched}
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    b1 = sum(r[1] for r in rows if "newview_chunk" in r[0])
    b2 = sum(r[1] for r in rows if "newview_whole" in r[0])
    return {"measured": True, "wall_ms": wall_ms, "busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "launches": sum(r[2] for r in rows), "b1_ms": b1, "b2_ms": b2,
            **launched, "top": [{"name": k[:120], "ms": ms, "calls": n}
                    for k, ms, n in rows[:top]]}


def kernel_b1_config(lane: int = 128) -> list:
    """Kernel B1's launch configuration per instance (storage dtype, K,
    kind 0..2 per chunk or 3 the dataflow kernel) at
    the engine's lane width and the data type's tip codes (16 DNA, 23
    amino-acid, 4 binary): sites per tile, ring stages, dynamic shared
    memory, threads per CTA and resident CTAs per SM, from the occupancy
    API."""
    import ctypes
    from examl_tpu_torch.ops import _build
    lib = _build.library("newview_chunk")
    out = []
    for storage, dtype in ((0, "float32"), (1, "float64"), (2, "bfloat16")):
        for K in STATES:
            codes = datatype_of(K).num_codes
            for kind in (0, 1, 2, 3):
                vals = (ctypes.c_int * 7)()
                err = lib.examl_newview_chunk_config(storage, 4, K, kind,
                                                     lane, codes, vals)
                check(err == 0, f"B1 {dtype} K={K} kind {kind} "
                      f"configuration failed: CUDA error {err} "
                      f"({_build.error_string(err)})")
                out.append({"dtype": dtype, "K": K, "codes": codes,
                            "kind": kind, "smem_bytes": vals[0],
                            "threads": vals[1], "ctas_per_sm": vals[2],
                            "sms": vals[3], "tile_sites": vals[4],
                            "stages": vals[5], "tile_units": vals[6]})
    return out


def ptxas_lines(text: str) -> list:
    """(instance, line) for every register and spill line of a -Xptxas -v
    report; the instance is the kernel's name and mangled template
    arguments, e.g. newview_flow_kernel:13__nv_bfloat16fLi4ELi20 for
    <__nv_bfloat16, float, 4, 20>."""
    out, inst = [], ""
    for line in text.splitlines():
        m = re.search(r"(newview_\w+?_kernel)I(\w*?)EEv", line)
        if "Compiling entry function" in line and m:
            inst = f"{m.group(1)}:{m.group(2)}"
        elif "registers" in line or "spill" in line:
            out.append((inst, line.strip()))
    return out


def bf16_spills(ptxas: dict) -> dict:
    """Each bfloat16-storage instance of B1 (both kernels): its registers
    and its spill stores and loads in bytes, from the ptxas report."""
    out = {}
    for inst, line in ptxas.get("newview_chunk", []):
        if "bfloat16" not in inst:
            continue
        r = out.setdefault(inst, {})
        m = re.search(r"Used (\d+) registers", line)
        if m:
            r["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            r["spill_bytes"] = int(m.group(1)) + int(m.group(2))
    return out


def kernels_line(real, real_whole, search, scan, grad, anchor_whole,
                 restart, aa_cli, real_aa, fq, sev, sev_cli, cases,
                 whole_cases, bf16, site, fleet, lanes, site_axis,
                 mesh) -> list:
    """The kernels line: each kernel's row, with its instances by K; B1's
    bfloat16-storage instances in a row of their own."""
    # Each kernel's launches on the main paths of this run, each path
    # counted from 0 just before it and read just after it: B1 on the
    # real-size evaluate path, -f d, the SPR scan's full evaluates and the
    # real-size gradient paths (the gradient pass's full traversal, the
    # gradient tree_evaluate), the amino-acid and binary -f e, the
    # real-size amino-acid evaluate and -f q's model optimization; B2 on
    # every whole-tier path, the -R restart, the re-evaluation of the
    # gradient-smoothed tree and of the amino-acid -f e endpoint and the
    # amino-acid model optimization included; B1 also on the dense
    # instance's path of phase 19 and the dense re-evaluation of phase
    # 20's -S endpoint; on phase 22's ranks: B1 on each rank's
    # real-size path and -f d, B2 on each rank's ref49 -f e; and B1 on
    # phase 23's fleet paths (each batch of tree jobs one stacked table an
    # engine, the bootstrap batch's CLV pass, the CLI's -b, -N, --serve
    # and -R runs; its bf16 batches in the bf16 row), and on phase 28's
    # (the two-lane fleet, the 1x2 fabric, the CLI runs); and on phase 29's
    # site shards (B1 and B2 once a shard on the real-size evaluate, B1's
    # bf16 instance, the ref49 anchors and B2 on its -f e through the CLI,
    # B1 on the -f d run with no mesh); and B1 on phase 30's fleet over site
    # shards (once a lane and engine a 2x2 batch, DNA and AA + BIN; the
    # weights batches' CLV passes; the smoothing sweeps).  The PSR and
    # -S paths launch neither (their traversals run on the wave-scan and
    # pooled tiers).  `by_K` splits
    # each kernel's row by instance: the launches by state count, and its
    # real-size time, plain time and bound (DNA from phases 10 and 13,
    # amino acids and binary from phase 16).
    grad_paths = grad["launches_by_path"]
    aa_paths = real_aa["launches_by_path"]
    b1_paths = [real["launches_by_path"]["evaluate"], search["launches"],
                scan["evaluate_launches"], grad_paths["traversal_and_pass"],
                grad_paths["tree_evaluate"], aa_cli["launches"],
                aa_paths["chunk_evaluate"], fq["launches"],
                sev["dense"]["counts"],
                sev_cli["fd"]["dense_reevaluate_launches"]]
    b2_paths = [anchor_whole["launches_anchors"], anchor_whole["fe_launches"],
                restart["launches"], grad_paths["whole_reevaluate"],
                *real_whole["launches_by_path"].values(),
                aa_cli["whole_launches"], aa_paths["whole_evaluate"],
                aa_paths["opt_alphas_lg4x"]]

    def by_int_k(counts):
        """A rank's counts as read_counts gives them (JSON made the keys
        of the by-K counts strings)."""
        return dict(counts, **{k: {int(K): n for K, n in counts[k].items()}
                               for k in ("b1_by_K", "b2_by_K")})

    b1_paths += [fleet[w]["counts"] for w in ("dna", "aa", "gene",
                                              "bootstrap")]
    b1_paths += [c["counts"] for c in fleet["cli"].values()]
    b1_paths += [lanes[k]["counts"] for k in ("lanes", "mesh", "psr")]
    b1_paths += [c["counts"] for c in lanes["cli"].values()]
    b1_paths += [by_int_k(r["counts"]) for r in site["ranks"]]
    b1_paths += [by_int_k(c) for c in site["fd"]["counts"]]
    b2_paths += [by_int_k(c) for c in site["fe"]["counts"]]
    ref49 = site_axis["ref49"]
    b1_paths += [site_axis["chunk"]["counts"],
                 ref49["anchors"]["chunk"]["counts"],
                 site_axis["cli"]["fd"]["counts"]]
    b2_paths += [site_axis["whole"]["counts"],
                 ref49["anchors"]["whole"]["counts"], ref49["fe"]["counts"]]
    b1_paths += [mesh[k]["counts"] for k in ("dna", "aa", "bootstrap",
                                             "smoothing")]

    def by_k(key, paths, dna, tier, checks):
        """Each instance's launches on the main paths, its real-size time
        (and the tip products' part of it) against its plain version and
        its bound, its largest error."""
        out = {}
        for K in STATES:
            m = dna if K == 4 else real_aa[tier]["kernels"][K]
            out[str(K)] = {
                "launches": sum(c[key].get(K, 0) for c in paths),
                "max_abs_err": max([m["max_abs_err"]] + [
                    c["max_abs_err"] for c in checks if c["K"] == K]),
                "launches_per_traversal": m["launches_per_traversal"],
                "ms": m["kernel_ms"],
                "tip_products_ms": m.get("tip_products_ms"),
                "plain_ms": m["plain_ms"],
                "bound_ms": m["bound_ms"], "bound_by": m["bound_by"]}
        return out

    b1_by_k = by_k("b1_by_K", b1_paths, real, "chunk", cases)
    b2_by_k = by_k("b2_by_K", b2_paths, real_whole, "whole", whole_cases)
    # The bfloat16 instances: launched on phase 21's real-size evaluates
    # and its -f d through the CLI; timed at real size there.
    bf_paths = [bf16["dna"]["counts"], bf16["aa"]["counts"],
                bf16["cli_fd"]["counts"], fleet["dna_bf16"]["counts"],
                fleet["aa_bf16"]["counts"], site_axis["bf16"]["counts"]]
    bf_by_k = {}
    for K in STATES:
        m = bf16["dna" if K == 4 else "aa"]["kernels"][K]
        bf_by_k[str(K)] = {
            "launches": sum(c["b1_by_K"].get(K, 0) for c in bf_paths),
            "max_abs_err": max([m["max_abs_err"]] + [
                c["max_abs_err"] for c in bf16["cases"] if c["K"] == K]),
            "differing_cells": m["differing_cells"],
            "launches_per_traversal": m["launches_per_traversal"],
            "ms": m["kernel_ms"], "tip_products_ms": m["tip_products_ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"]}
    for name, rows in (("B1", b1_by_k), ("B2", b2_by_k),
                       ("B1 bf16", bf_by_k)):
        for K, r in rows.items():
            check(r["launches"] > 0, f"{name} K={K}: no launch on the main "
                  "paths")
    return [{
        "name": "newview_chunk",
        "route": "cuda",
        "source": "examl_tpu_torch/csrc/newview_chunk.cu",
        "replaces": "examl_tpu/ops/pallas_newview.py:67",
        "launches": sum(c["b1"] for c in b1_paths),
        "max_abs_err": max(r["max_abs_err"] for r in b1_by_k.values()),
        "ms": real["kernel_ms"],
        "plain_ms": real["plain_ms"],
        "bound_ms": real["bound_ms"],
        "bound_by": real["bound_by"],
        "library_ms": None,
        "by_K": b1_by_k,
    }, {
        "name": "newview_whole",
        "route": "cuda",
        "source": "examl_tpu_torch/csrc/newview_whole.cu",
        "replaces": "examl_tpu/ops/pallas_whole.py:99",
        "launches": sum(c["b2"] for c in b2_paths),
        "max_abs_err": max(r["max_abs_err"] for r in b2_by_k.values()),
        "ms": real_whole["kernel_ms"],
        "plain_ms": real_whole["plain_ms"],
        "bound_ms": real_whole["bound_ms"],
        "bound_by": real_whole["bound_by"],
        "library_ms": None,
        "by_K": b2_by_k,
    }, {
        "name": "newview_chunk_bf16",
        "route": "cuda",
        "source": "examl_tpu_torch/csrc/newview_chunk.cu",
        "replaces": "examl_tpu/ops/pallas_newview.py:67",
        "launches": sum(c["b1_by_dtype"].get("bfloat16", 0)
                        for c in bf_paths),
        "max_abs_err": max(r["max_abs_err"] for r in bf_by_k.values()),
        "ms": bf_by_k["4"]["ms"],
        "plain_ms": bf_by_k["4"]["plain_ms"],
        "bound_ms": bf_by_k["4"]["bound_ms"],
        "bound_by": bf_by_k["4"]["bound_by"],
        "library_ms": None,
        "by_K": bf_by_k,
    }]


def nvidia_smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0 and res.stdout.strip() != "",
          f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    # One rank of phase 22 (started by the phase itself).
    ap.add_argument("--site-child", choices=["real", "cli"],
                    help=argparse.SUPPRESS)
    ap.add_argument("--site-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--site-port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--site-arg", help=argparse.SUPPRESS)
    # The host cost against another tree's port (see `host_ab`).
    ap.add_argument("--host-ab", metavar="PARENT")
    # ref49 -m PSR -f e on one card and on 2x1 of it, alone (`site_psr`).
    ap.add_argument("--site-psr", action="store_true")
    ap.add_argument("--host-ab-child", help=argparse.SUPPRESS)
    # The B1 wedge check's child (phase 27).
    ap.add_argument("--wedge-child", action="store_true",
                    help=argparse.SUPPRESS)
    # One of the side phases (started by the script itself).
    ap.add_argument("--side-child", choices=SIDE_PHASES,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.wedge_child:
        return wedge_child()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script runs "
              "on the card only", file=sys.stderr)
        return 2
    if args.host_ab_child:
        sys.path.insert(0, os.path.abspath(args.host_ab_child))
        print(json.dumps(host_ab_child(args.host_ab_child, args.seed)))
        return 0
    sys.path.insert(0, HERE)
    try:
        from examl_tpu_torch.ops import _build
    except ImportError as exc:
        print(f"chip_smoke: examl_tpu_torch not found beside this script "
              f"({exc})", file=sys.stderr)
        return 2
    if args.site_child:
        try:
            return site_child(args.site_child, args.site_rank,
                              args.site_port, args.site_arg)
        except SmokeFailure as exc:
            print(f"chip_smoke: rank {args.site_rank} FAILED: {exc}",
                  file=sys.stderr)
            return 1
    if args.host_ab:
        return host_ab(args.host_ab, args.seed)
    device = torch.device("cuda", 0)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    if args.site_psr:
        try:
            print(json.dumps({"site_psr": site_psr(device, out_dir)}))
        except SmokeFailure as exc:
            print(f"chip_smoke: --site-psr FAILED: {exc}", file=sys.stderr)
            return 1
        return 0
    if args.side_child:
        return side_child(args.side_child, out_dir, args.seed)
    t_start = time.perf_counter()
    phase_s = {}
    last = [time.perf_counter(), None]
    side_procs = {}

    def side_log(side: dict, name: str) -> dict:
        """Side phase `name`'s output, printed in its own place."""
        res, wall, text = side[name]
        log(text)
        log(f"  ran in a process of its own, joined before phase 10: "
            f"{wall:.1f} s from its start to its end")
        return res

    def phase(title: str) -> None:
        """Close the running phase (log its seconds) and open the next."""
        now = time.perf_counter()
        if last[1] is not None:
            phase_s[last[1]] = now - last[0]
            log(f"  ({now - last[0]:.1f} s)")
        last[:] = [now, title]
        log(f"[{PHASE_ORDER[len(phase_s)]}/{NPHASES}] {title}")

    try:
        phase("device")
        smi = nvidia_smi_line()
        log(f"  {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}")

        phase("build")
        bank_report, bank_wall = bank_build(log)
        log(f"  built {_build.sources()} in bank workers ({bank_wall:.1f} "
            "s)")
        ptxas = {name: ptxas_lines(_build.build_log(name))
                 for name in _build.sources()}
        for name, lines in ptxas.items():
            for inst, line in lines:
                log(f"  ptxas {name}<{inst}>: {line}")
        b1_config = kernel_b1_config()
        for c in b1_config:
            log(f"  B1 {c['dtype']} K={c['K']} ({c['codes']} codes) "
                + (f"kind {c['kind']}: {c['tile_sites']}-site tiles"
                   if c["kind"] < 3 else
                   f"dataflow: tiles of {c['tile_units']} x "
                   f"{c['tile_sites']} sites")
                + f", {c['stages']} "
                f"stages, {c['smem_bytes']} B dynamic shared memory, "
                f"{c['threads']} threads, {c['ctas_per_sm']} CTAs per SM x "
                f"{c['sms']} SMs")

        phase("kernel B1 vs plain: kinds 0/1/2, f32 and f64, real = 1, "
              "real < W, chained launches; whole traversals of every "
              "instance through its route, both routes in turns")
        cases = phase_kernel_vs_plain(device, CHECK_BLOCKS, CHECK_WIDTH,
                                      args.seed)
        b1_routes = phase_b1_routes(device, args.seed, REPS)

        phase("kernel B2 vs plain, random 512 and caterpillar 64, f32 and "
              "f64")
        whole_cases = phase_whole_vs_plain(device, WHOLE_CHECK_BLOCKS,
                                           args.seed)

        phase("ref49, chunk tier: anchors, makenewz, smooth_tree")
        anchor = phase_anchor(device)

        side_procs.update(side_spawn(SIDE_EARLY, out_dir, args.seed))
        log(f"  phases 9, 15 and 20 started in processes of their own, side "
            f"by side with phases 6-8 (pids "
            f"{[p.pid for p, _ in side_procs.values()]})")

        phase("ref49, whole tier: anchors, -f e through the CLI")
        anchor_whole = phase_ref49_whole(device, out_dir)

        phase("-f d through the CLI, chunk tier, batched SPR scan, f32")
        search = phase_search(device, out_dir, args.seed)

        phase("-R restart of -f d, whole tier")
        restart = phase_restart(device, out_dir, search)
        side_procs.update(side_spawn(SIDE_LATE, out_dir, args.seed, {
            "search": search, "bank_report": bank_report,
            "bank_wall": bank_wall, "smi": smi}))
        log(f"  phases 17 and 27 and phase 28's CLI part started in "
            f"processes of their own (pids "
            f"{[side_procs[n][0].pid for n in SIDE_LATE]})")

        phase("ref49 -m PSR -f e through the CLI, wave-scan tier, f32")
        side = side_wait(side_procs, out_dir)
        psr49 = side_log(side, "psr49")

        phase("real size, chunk tier")
        setup = real_setup(TAXA, PARTITIONS, PART_WIDTH, args.seed)
        real, real_inst, real_tree = phase_real_size(device, setup, REPS)

        phase("real size, SPR scan (lazy and thorough, sequential and "
              "batched)")
        scan = phase_spr_scan(device, real_inst, real_tree)

        phase("real size, whole-tree gradients and gradient smoothing")
        grad = phase_real_gradients(device, setup, real_inst, real_tree,
                                    REPS)
        del real_inst, real_tree
        release_memory()

        phase("real size, whole tier")
        real_whole = phase_real_whole(device, setup, REPS, real["lnl"])

        phase("real size, PSR: gradient smoothing, a categorization round")
        real_psr = phase_real_psr(device, setup)

        phase("AA + BIN -f e through the CLI (WAG, LG+F, LG4M, LG4X, "
              "AUTO), chunk tier, f32")
        aa_cli = side_log(side, "aa_cli")

        phase("real size, amino-acid and binary data, both tiers")
        real_aa = phase_real_aa(device, args.seed, REPS)

        phase("-f q through the CLI (batched and sequential scorers), "
              "chunk tier, f32")
        fq = side_log(side, "quartets")

        phase("real size, quartet scorers (batched and sequential), chunk "
              "tier, f32")
        real_fq = phase_real_quartets(device, setup, args.seed)

        phase("-S at real width: the SEV pool against the dense arena "
              "(pooled tier, chunk tier), f32")
        keep = {}
        sev = phase_sev(device, args.seed, SEV_REPS, keep)

        phase("-S through the CLI: -f d, -R, -m PSR -f e, -f q; f32")
        sev_cli = side_log(side, "sev_cli")

        phase("bfloat16 CLV storage: B1's bf16 instances vs plain, real "
              "size DNA and AA + BIN, -f d and -S -f e through the CLI")
        bf16 = phase_bf16(device, setup, real, real_aa, search, out_dir,
                          args.seed, REPS, ptxas)

        phase("site-parallel ranks: 2 processes in a gloo group on the "
              "card, real-size windows against one process, B1 on tail "
              "windows, ref49 -f e and -f d through the CLI")
        site = phase_site_parallel(device, setup, anchor_whole, search,
                                   b1_config, smi, args.seed, keep)

        phase("the site axis: 2 site shards of one tree in this process on "
              "a 2x1 fabric of the card twice, real size on B1 and B2 "
              "against phase 22's ranks and one card, -S, bf16; ref49 and "
              "the CLI beside phases 6-8")
        site_axis = phase_site_axis(device, setup, real, real_whole, site,
                                    keep, sev, bf16, smi)
        site_axis["ref49"] = side_log(side, "site_ref49")
        site_axis["cli"] = side_log(side, "site_cli")
        fe = site_axis["ref49"]["fe"]
        fe["rel_one_card"] = abs(fe["final_lnl"] - anchor_whole[
            "fe_final_lnl"]) / abs(anchor_whole["fe_final_lnl"])
        check(fe["rel_one_card"] <= SHARD_RTOL, f"ref49 -f e on 2x1 "
              f"{fe['final_lnl']!r} against phase 6's one card "
              f"{anchor_whole['fe_final_lnl']!r}")
        del keep
        release_memory()

        phase("fleet: a real-size batch of start jobs in one B1 launch "
              "(f32, bf16; AA + BIN), a bootstrap batch, -b/-N/--serve/-R "
              "through the CLI")
        release_memory()
        lanes_in = {}
        fleet = phase_fleet(device, setup, search, out_dir, args.seed, REPS,
                            lanes_in)

        phase("fleet lanes and the tree axis: two lanes sharing the card "
              "and a 1x2 fabric on phase 23's real-size jobs, a PSR fleet on "
              "two lanes, --fleet-devices 0 / --mesh 1x1 / --mesh 1x2 "
              "through the CLI")
        lanes = phase_lanes(device, lanes_in, search,
                            side_log(side, "lanes_cli"), args.seed)

        phase("the fleet over site shards: a 2x2 fabric of the card four "
              "times over phase 23's real-size DNA and AA + BIN jobs, "
              "batched smoothing, bootstrap weights and a PSR fleet against "
              "2x1 and one card")
        lanes_in.pop("inst")
        release_memory()
        mesh = phase_mesh(device, setup, lanes_in, fleet, lanes, search,
                          smi, args.seed)
        del lanes_in
        release_memory()

        phase("report")
        kernels = kernels_line(real, real_whole, search, scan, grad,
                               anchor_whole, restart, aa_cli, real_aa, fq,
                               sev, sev_cli, cases, whole_cases, bf16,
                               site, fleet, lanes, site_axis, mesh)

        phase("instruments on the card: -f d with --metrics/--ledger/"
              "--trace-events, -f e --profile, real-size evaluate off/"
              "traced/profiled, engine.nonfinite, mem.oom and mem.pressure "
              "on the fleet batch, SIGTERM then -R")
        release_memory()
        instruments = phase_instruments(device, setup, search, args.seed)

        phase("supervision: --supervise (a child SIGKILLed, the time to "
              "recover; kill, stall, SIGTERM), --launch 2 (a rank killed, "
              "a publish killed), leased ranks, a job deadline; the "
              "supervisor holds no CUDA context")
        release_memory()
        supervision = phase_supervision(device, setup, search, args.seed,
                                        smi)

        phase("extension bank: the opening build's seconds per library, a "
              "wedged build degraded to --newview scan, a truncated library "
              "under EXAML_EXPORT_BANK=require and on, the supervisor's "
              "rung 3, the B1 wedge check")
        bank_phase = side_log(side, "bank")
        phase_s[last[1]] = time.perf_counter() - last[0]
        log(f"  ({phase_s[last[1]]:.1f} s)")
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        side_stop(side_procs)

    report = {"device": smi, "phase_s": phase_s, "b1_config": b1_config,
              "kernel_cases": cases, "b1_routes": b1_routes,
              "whole_cases": whole_cases, "anchor": anchor,
              "anchor_whole": anchor_whole, "search": search,
              "restart": restart, "psr_ref49": psr49, "real_size": real,
              "spr_scan": scan, "real_size_gradients": grad,
              "real_size_whole": real_whole, "real_size_psr": real_psr,
              "aa_cli": aa_cli, "real_size_aa": real_aa, "quartets": fq,
              "real_size_quartets": real_fq, "sev": sev,
              "sev_cli": sev_cli, "bf16": bf16, "site_parallel": site,
              "fleet": fleet, "lanes": lanes, "site_axis": site_axis,
              "mesh": mesh,
              "instruments": instruments,
              "supervision": supervision, "bank": bank_phase,
              "ptxas": ptxas,
              "wall_s": time.perf_counter() - t_start}
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(json.dumps({"real_size": {k: real[k] for k in (
        "evaluate_ms", "site_clv_updates_per_s", "makenewz_8_s", "lnl",
        "layout", "entries", "kernel_ms", "achieved_tb_per_s",
        "launches_by_path", "setup_s")}}))
    log(json.dumps({"real_size_whole": {k: real_whole[k] for k in (
        "evaluate_ms", "site_clv_updates_per_s", "lnl", "entries", "waves",
        "grid_blocks", "launches_by_path", "opt_s", "opt_full_traversals",
        "opt_ms_per_probe", "opt_push_models_ms_per_probe")}}))
    log(json.dumps({"search": {k: search[k] for k in (
        "taxa", "patterns", "wall_s", "start_lnl", "final_lnl", "launches",
        "checkpoints", "fast_iterations", "thorough_iterations")},
        "restart": {k: restart[k] for k in (
            "state", "final_lnl", "wall_s", "launches")},
        "spr_scan": {k: {"max_rel_diff": scan[k]["max_rel_diff"], **{
            route: {m: scan[k][route][m] for m in (
                "insertions_scored", "ms_per_insertion",
                "ms_per_pruned_node", "entries_per_insertion")}
            for route in ("sequential", "batched")}}
            for k in ("lazy", "thorough")},
        "quartets": {k: fq[k] for k in (
            "rows", "wall_s", "batched_ms_per_topology",
            "sequential_ms_per_topology", "rel_vs_file",
            "rel_batched_vs_sequential")},
        "real_size_quartets": real_fq}))
    log(json.dumps({"real_size_gradients": {k: grad[k] for k in (
        "edges", "pass_ms", "bound_ms", "bound_by", "achieved_tb_per_s",
        "d1_gap_f64", "tree_evaluate_s", "sweeps", "lnl_before",
        "lnl_after")},
        "psr_ref49": {k: psr49[k] for k in (
            "start_lnl", "final_lnl", "wall_s", "parts_s", "categories")},
        "real_size_psr": {k: real_psr[k] for k in (
            "round_s", "ms_per_grid_chunk", "grid_chunks", "categories",
            "tree_evaluate_s", "sweeps", "peak_bytes")}}))
    log(json.dumps({"sev": {
        "taxa": sev["taxa"], "patterns": sev["patterns"],
        "saving_ratio": sev["sev"]["stats"]["saving_ratio"],
        "allocated_cells": sev["sev"]["stats"]["allocated_cells"],
        "dense_cells": sev["sev"]["stats"]["dense_cells"],
        "pool_bytes": sev["sev"]["pool_bytes"],
        "pool_bytes_after_scan": sev["sev"]["pool_bytes_after_scan"],
        "dense_arena_bytes": sev["dense"]["arena_bytes"],
        "peak_bytes": {k: sev[k]["peak_bytes"] for k in ("sev", "dense")},
        "evaluate_ms": {k: sev[k]["evaluate_ms"] for k in ("sev", "dense")},
        "ms_per_insertion": {k: sev[k]["ms_per_insertion"]
                             for k in ("sev", "dense")},
        "lnl_rel": sev["lnl_rel"], "z_rel": sev["z_rel"],
        "candidate_rel": sev["candidate_rel"],
        "same_best_move": sev["same_best_move"],
        "idle_share": sev["sev"]["profile"].get("idle_share"),
        "cli": {k: {m: v[m] for m in ("wall_s", "final_lnl") if m in v}
                for k, v in sev_cli.items() if isinstance(v, dict)}}}))
    log(json.dumps({"bf16": {
        "real_size": {w: {k: bf16[w][k] for k in (
            "lnl", "f32_lnl", "lnl_rel_gap", "evaluate_ms", "arena_bytes",
            "f32_arena_bytes")} for w in ("dna", "aa")},
        "kernel_ms": {K: {k: r[k] for k in ("ms", "tip_products_ms",
                                            "plain_ms", "bound_ms")}
                      for K, r in kernels[2]["by_K"].items()},
        "cli_fd": {k: bf16["cli_fd"][k] for k in (
            "wall_s", "start_lnl", "final_lnl", "reevaluated_f32",
            "f32_run_final_lnl")},
        "cli_sev_fe": {k: bf16["cli_sev_fe"][k]["final_lnl"]
                       for k in ("f32", "bf16")}}}))
    log(json.dumps({"fleet": {
        **{w: {k: fleet[w][k] for k in ("jobs", "wall_s", "first_wall_s",
                                         "one_at_a_time_total_s",
                                         "prepare_ms", "engines")}
           for w in ("dna", "dna_bf16", "aa", "aa_bf16", "gene")},
        "bootstrap": {k: fleet["bootstrap"][k] for k in (
            "replicates", "wall_s", "first_wall_s", "ms_per_replicate",
            "host_packing_ms", "bitwise_0_3", "rel_0_3")},
        "many_parts": fleet["many_parts"],
        "cli": {k: {m: v[m] for m in ("wall_s", "jobs", "done")}
                for k, v in fleet["cli"].items()}}}))
    log(json.dumps({"lanes": {
        "lanes_wall_s": lanes["lanes"]["wall_s"], "turns": lanes["turns"],
        "mesh": {k: lanes["mesh"][k] for k in ("wall_s", "slice_jobs")},
        "psr_wall_s": {k: lanes["psr"][k]["wall_s"]
                       for k in ("one_lane", "two_lanes")},
        "cli": {k: {m: v[m] for m in ("wall_s", "rc") if m in v}
                for k, v in lanes["cli"].items()}}}))
    log(json.dumps({"site_axis": {
        **{t: {k: site_axis[t][k] for k in ("lnl", "evaluate_ms")}
           for t in ("chunk", "whole", "bf16", "sev")},
        "one_card_evaluate_ms": site_axis["chunk"]["one_card_evaluate_ms"],
        "rel_one_card": {t: site_axis[t]["rel_one_card"]
                         for t in ("chunk", "whole")},
        "pool_bytes": [r["pool_bytes"] for r in site_axis["sev"]["regions"]],
        "fe_2x1": {m: site_axis["ref49"]["fe"][m]
                   for m in ("final_lnl", "wall_s")},
        "psr_2x1": site_axis["ref49"]["psr"],
        "fd_no_mesh": {m: site_axis["cli"]["fd"][m]
                       for m in ("final_lnl", "wall_s")},
        "wall_s": site_axis["wall_s"]}}))
    log(json.dumps({"mesh": {
        **{k: {m: mesh[k][m] for m in (
            "jobs", "slice_jobs", "2x2_s", "2x2_first_s", "2x1_s",
            "2x1_first_s", "rel_one_card")} for k in ("dna", "aa")},
        "smoothing": {m: mesh["smoothing"][m] for m in (
            "sweeps", "z_rel", "wall_s")},
        "bootstrap": {m: mesh["bootstrap"][m] for m in (
            "wall_2x2_s", "wall_2x1_s")},
        "psr_wall_s": {k: mesh["psr"][k]["wall_s"] for k in ("2x1", "2x2")},
        "wall_s": mesh["wall_s"]}}))
    log(json.dumps({"instruments": {
        "evaluate_median_ms": instruments["evaluate"]["median_ms"],
        "spans_per_evaluate": instruments["evaluate"]["spans_per_evaluate"],
        "nonfinite_retry_ms": instruments["evaluate"]["nonfinite"][
            "retry_ms"],
        "fd_wall_s": instruments["cli"]["fd"]["wall_s"],
        "fleet": instruments["fleet"], "sigterm": instruments["sigterm"],
        "parts_s": instruments["parts_s"]}}))
    log(json.dumps({"supervision": {
        "recover": {k: supervision["recover"][k] for k in (
            "taxa", "recover_s", "split_s", "extension_load_s",
            "first_beat_state", "wall_s")},
        "stall": supervision["single"]["stall"],
        "sigterm_stop_s": supervision["single"]["sigterm"]["stop_s"],
        "gang_restart_s": {k: supervision["gang"][k]["gang_restart_s"]
                           for k in ("rank_kill", "publish_kill")},
        "leased": {k: supervision["leased"][k] for k in (
            "death_to_reap_s", "death_to_done_s", "done_by_rank")},
        "parts_s": supervision["parts_s"],
        "wall_s": supervision["wall_s"]}}))
    log(json.dumps({"bank": {
        "cold_build": bank_phase["cold_build"],
        "cold_wall_s": bank_phase["cold_wall_s"],
        "wedged": {k: bank_phase["wedged"][k] for k in (
            "bank_s", "deadline_s", "lnl", "rel", "f64_lnl", "b1_launches")},
        "quarantine": bank_phase["quarantine"],
        "rung3": bank_phase["rung3"],
        "wedge_check": bank_phase["wedge_check"],
        "parts_s": bank_phase["parts_s"], "wall_s": bank_phase["wall_s"]}}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
