"""examl_tpu_torch.resilience — fault injection, in-process recovery and
the supervisor.

The port of `examl_tpu/resilience/`:

* `faults`    — registry of named, deterministic injection points armed
                via `EXAML_FAULTS` / `--inject-fault`, wired into the
                port's seams (engine dispatch, lnL boundary, checkpoint
                write, heartbeat, fleet dispatch, memory governor).
* `exitcause` — the exit-code taxonomy (EXIT_PREEMPTED, EXIT_ALLOC_OOM).
* `heartbeat` — per-iteration liveness file emitted by the search loop
                (`$EXAML_HEARTBEAT_FILE`), which ticks the metrics
                autoflush.
* `preempt`   — SIGTERM/SIGINT -> flag -> emergency checkpoint at the
                next checkpoint site -> clean resumable exit
                (EXIT_PREEMPTED).
* `memgov`    — the device-memory budget: admission, batch-cap shrink,
                and OOM classification with evict + halving recovery.
* `supervisor` — `--supervise` and `--launch N`: the run as killable
                children watched through their heartbeats, restarted from
                the newest (coordinated) checkpoint with capped retries,
                backoff and a degradation ladder that stays on kernel B1;
                leased fleet ranks restarted one at a time.

IMPORT CONTRACT: this `__init__` and the `exitcause`, `faults`,
`heartbeat` and `supervisor` modules import no torch: a supervising
parent imports them and must never load torch (it must never take the
card its child needs).
"""
