"""The one definition of "dispatch time": warm-up calls, then best-of-N
wall seconds around a blocking call, every repetition observed into the
metrics registry (the port of `examl_tpu/obs/timing.py`).

The callable must itself block until the device work is done: on the
card, end it with `torch.cuda.synchronize(device)`.  This module stays
torch-free so the obs package imports without a device.
"""

from __future__ import annotations

import time
from typing import Callable

from examl_tpu_torch.obs import ledger as _ledger
from examl_tpu_torch.obs import metrics as _metrics


def time_dispatch(call: Callable[[], object], *, reps: int = 1,
                  warmup: int = 1, name: str = "dispatch") -> float:
    """Best wall seconds of `reps` timed invocations of `call()` after
    `warmup` untimed ones.  EVERY timed repetition is observed into the
    registry timer `name` — with the timer's log-bucketed histogram
    that means the full rep distribution survives, not just the
    best-of-N headline — and the window's parameters land as one
    `dispatch.window` ledger event (reps/warmup/best/total) so a
    measurement is auditable from the run artifacts alone."""
    reg = _metrics.registry()
    for _ in range(warmup):
        call()
    best = None
    total = 0.0
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        call()
        dt = time.perf_counter() - t0
        reg.observe(name, dt)
        total += dt
        if best is None or dt < best:
            best = dt
    _ledger.event("dispatch.window", name=name, reps=max(1, reps),
                  warmup=warmup, best_s=round(best, 6),
                  total_s=round(total, 6))
    return best
