"""examl_tpu_torch.resilience — fault injection and in-process recovery.

The port of `examl_tpu/resilience/` without its supervisor:

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

IMPORT CONTRACT: this `__init__` and the `exitcause`/`faults` modules
are stdlib-only: a supervising parent imports them and must never load
torch (it must never take the card its child needs).
"""
