"""Per-device memory governor: admission control over one budget.

The port of `examl_tpu/resilience/memgov.py`, over the caching
allocator's counters (`torch.cuda.memory_stats` / `mem_get_info`, read
by obs/programs.py's `sample_memory` into `mem.device.<k>.*` gauges,
with the host resident set `mem.host.rss` on the CPU and the engines'
arena gauges as the floor).

The budget resolves as: `EXAML_MEM_BUDGET_BYTES` (absolute, wins) ->
`EXAML_MEM_BUDGET_FRACTION` x device limit -> DEFAULT_FRACTION
(headroom) x device limit -> unlimited when no device limit is known
(CPU).  The two knobs are read once, at the CLI boundary (`knobs_from_env`
-> `configure`); the governor itself takes them as arguments.  The
`mem.pressure` fault point (`bytes=N`) clamps the resolved budget for
chaos tests — sticky, so pressure persists for the life of the run.

Seams that consult it:

* the fleet drain's batch cap (`effective_cap`): under pressure the
  drain cuts smaller batches — occupancy shrinks instead of OOM;
* the fleet's stacked batch arenas (`admit_bytes`): counted denials,
  never a block; a lane's arena is reserved on its device from its
  admission to its launch (`reserve`), so the lanes of one round that
  share a card count each other's arenas.

The recovery half: `is_oom()` classifies a caught dispatch exception (a
`torch.cuda.OutOfMemoryError` or the injected `mem.oom` fault; never a
kernel or CUDA runtime error, which stay device faults that end the
run) -> `oom_event` (`mem.oom_events`); the fleet driver evicts
(`evict_engine`: the engines' layout caches, then
`torch.cuda.empty_cache()`, since the caching allocator still holds the
failed attempt's blocks) and re-dispatches through the quarantine
halving path (`mem.oom_retries`); repeated strikes raise
`MemoryBudgetExhausted`, which the CLI maps to
`exitcause.EXIT_ALLOC_OOM`.

Pure admission math (`resolve_budget`, `admit_math`, `eviction_order`,
`clamp_fraction`) takes plain ints and is the JAX package's, verbatim;
the gauge-reading conveniences degrade to "admit with counter"
(`mem.admission_unknown`) whenever an input is missing — the governor
must never turn absent telemetry into a blocked dispatch.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

from examl_tpu_torch.resilience import exitcause, faults

ENV_BUDGET_BYTES = "EXAML_MEM_BUDGET_BYTES"
ENV_BUDGET_FRACTION = "EXAML_MEM_BUDGET_FRACTION"

# Headroom default: a dispatch's transient buffers land on top of the
# steady arenas — 90 % of the device limit is the admission ceiling
# unless overridden.
DEFAULT_FRACTION = 0.90

# Fraction pins are clamped to this floor: a halving ladder must
# converge on "tiny but runnable", not zero.
MIN_FRACTION = 0.05

# Consecutive unrecovered OOM strikes before the governor stops
# shrinking and escalates as alloc-oom.
OOM_STRIKE_LIMIT = 3


class Knobs(NamedTuple):
    """The budget knobs as the CLI read them (raw strings or None)."""
    budget_bytes: Optional[str] = None
    fraction: Optional[str] = None


def knobs_from_env() -> Knobs:
    """Read EXAML_MEM_BUDGET_BYTES / _FRACTION — once, at the CLI
    boundary."""
    return Knobs(os.environ.get(ENV_BUDGET_BYTES) or None,
                 os.environ.get(ENV_BUDGET_FRACTION) or None)


_STATE = {"strikes": 0, "knobs": Knobs()}
# Bytes reserved per device (str) by admitted, not yet allocated arenas.
_RESERVED: Dict[str, int] = {}


class MemoryBudgetExhausted(RuntimeError):
    """Device allocator OOM that survived evict+shrink retries: the
    in-process ladder is out of moves.  The CLI maps this to
    `exitcause.EXIT_ALLOC_OOM`."""

    exit_code = exitcause.EXIT_ALLOC_OOM


def reset() -> None:
    """Clear strike state and the run's knobs (one CLI run = one
    escalation ladder)."""
    _STATE.update(strikes=0, knobs=Knobs())
    _RESERVED.clear()


def configure(knobs: Knobs) -> None:
    """Install the run's budget knobs (the CLI, once per run)."""
    _STATE["knobs"] = knobs


# -- pure admission math (no torch, no gauges: unit-testable) --------------


def clamp_fraction(frac: float) -> float:
    """Budget fractions live in [MIN_FRACTION, 1.0] — a pin ladder
    halves toward the floor, never to zero; >1 would admit more than
    the device holds."""
    return max(MIN_FRACTION, min(1.0, float(frac)))


def resolve_budget(limit_bytes: Optional[int],
                   budget_bytes_env: Optional[str] = None,
                   fraction_env: Optional[str] = None,
                   pressure_bytes: Optional[int] = None) -> Optional[int]:
    """The admission budget in bytes, or None for unlimited.

    Precedence: explicit `EXAML_MEM_BUDGET_BYTES` wins; else
    `EXAML_MEM_BUDGET_FRACTION` x device limit; else DEFAULT_FRACTION x
    device limit; no known device limit (CPU) -> unlimited.  A
    `mem.pressure` clamp applies LAST and can only lower the result (or
    impose one where none existed)."""
    budget: Optional[int] = None
    if budget_bytes_env:
        try:
            budget = max(0, int(budget_bytes_env))
        except ValueError:
            budget = None
    if budget is None and limit_bytes is not None and limit_bytes > 0:
        frac = DEFAULT_FRACTION
        if fraction_env:
            try:
                frac = clamp_fraction(float(fraction_env))
            except ValueError:
                frac = DEFAULT_FRACTION
        budget = int(limit_bytes * frac)
    if pressure_bytes is not None:
        budget = pressure_bytes if budget is None \
            else min(budget, pressure_bytes)
    return budget


def admit_math(predicted_bytes: Optional[int], used_bytes: int,
               budget_bytes: Optional[int]) -> Tuple[bool, Optional[int]]:
    """(admitted, remaining_after) for one allocation request.

    None budget -> always admitted (unlimited, remaining None); None
    prediction -> the CALLER must admit-with-counter (this returns the
    raw headroom so it can decide)."""
    if budget_bytes is None:
        return True, None
    remaining = budget_bytes - max(0, int(used_bytes))
    if predicted_bytes is None:
        return True, remaining
    return (int(predicted_bytes) <= remaining,
            remaining - int(predicted_bytes))


def eviction_order(entries: Iterable[Tuple[object, float]]) -> List[object]:
    """Coldest-first eviction ordering: entries are (key, last_use
    sequence/stamp); lower stamps evict first."""
    return [k for k, _ in sorted(entries, key=lambda kv: kv[1])]


# -- gauge-backed budget state (degrades to admit-with-counter) ------------


def _pressure_bytes() -> Optional[int]:
    """The chaos clamp: an armed sticky `mem.pressure` spec carries the
    budget in spec.arg (`bytes=N`)."""
    spec = faults.armed("mem.pressure")
    if spec is None or spec.arg is None:
        return None
    try:
        return int(spec.arg)
    except (TypeError, ValueError):
        return None


def _gauges() -> Dict[str, float]:
    from examl_tpu_torch import obs
    return obs.registry().snapshot_light().get("gauges", {})


def _device_limit(gauges: Dict[str, float]) -> Optional[int]:
    """Per-device admission limit: the SMALLEST device limit gauge."""
    limits = [int(v) for k, v in gauges.items()
              if k.startswith("mem.device.") and k.endswith(".limit")]
    return min(limits) if limits else None


def used_bytes(gauges: Optional[Dict[str, float]] = None) -> int:
    """Live per-device usage: the BUSIEST device's in_use gauge; CPU
    runs fall back to the host RSS (`mem.host.rss`), then to the sum of
    the engines' arena gauges — the floor the governor always knows."""
    g = _gauges() if gauges is None else gauges
    in_use = [int(v) for k, v in g.items()
              if k.startswith("mem.device.") and k.endswith(".in_use")]
    if in_use:
        return max(in_use)
    rss = g.get("mem.host.rss")
    if rss:
        return int(rss)
    return int(sum(v for k, v in g.items()
                   if k.startswith("engine.clv_arena_bytes.")))


def budget_bytes(gauges: Optional[Dict[str, float]] = None,
                 knobs: Optional[Knobs] = None) -> Optional[int]:
    """The resolved budget (knobs + device limit + pressure clamp), or
    None for unlimited.  Publishes the `mem.budget_bytes` gauge when a
    budget exists so report tools can render headroom."""
    g = _gauges() if gauges is None else gauges
    knobs = _STATE["knobs"] if knobs is None else knobs
    budget = resolve_budget(_device_limit(g), knobs.budget_bytes,
                            knobs.fraction, _pressure_bytes())
    if budget is not None:
        inc_gauge("mem.budget_bytes", budget)
    return budget


def _sample() -> None:
    """Refresh the live gauges (rate-limited by programs.MEM_SAMPLE_S) so
    admission reads telemetry no staler than the sample interval."""
    from examl_tpu_torch.obs import programs
    programs.sample_memory()


def reserve(device, nbytes: int) -> None:
    """Hold `nbytes` on `device` for an arena that is admitted but not yet
    allocated (a fleet lane's stacked arena between its admission and its
    launch): `reserved_bytes` counts it until `unreserve`.  Every lane of
    a round is admitted before any launches, so two lanes on one card
    that each read its free memory before the other allocates see each
    other here."""
    if nbytes > 0:
        key = str(device)
        _RESERVED[key] = _RESERVED.get(key, 0) + int(nbytes)


def unreserve(device, nbytes: int) -> None:
    if nbytes > 0:
        key = str(device)
        left = _RESERVED.get(key, 0) - int(nbytes)
        if left > 0:
            _RESERVED[key] = left
        else:
            _RESERVED.pop(key, None)


def reserved_bytes(device) -> int:
    """Bytes reserved on `device` by admitted arenas not yet allocated."""
    return _RESERVED.get(str(device), 0)


def admit_bytes(predicted: Optional[int], seam: str,
                knobs: Optional[Knobs] = None, device=None) -> bool:
    """One admission decision.  A missing prediction or missing budget
    admits (counting `mem.admission_unknown` for the former) — the
    governor turns absent telemetry into evidence, never into a
    blocked dispatch.  A denial only COUNTS here (`mem.admission_
    denials`); the seam owns its reaction (shrink, proceed).  With
    `device`, the arenas reserved there and not yet allocated count as
    used."""
    _sample()
    g = _gauges()
    budget = budget_bytes(g, knobs)
    if budget is None:
        return True
    if predicted is None:
        inc("mem.admission_unknown")
        return True
    used = used_bytes(g)
    if device is not None:
        used += reserved_bytes(device)
    ok, _ = admit_math(predicted, used, budget)
    if not ok:
        inc("mem.admission_denials")
        _ledger("mem.admission_denied", seam=seam,
                predicted_bytes=int(predicted), budget_bytes=budget)
    return ok


def effective_cap(cap: int, knobs: Optional[Knobs] = None) -> int:
    """The drain's batch cap under the governor: proportional shrink
    (budget/used, floor 1) when live usage exceeds the budget, the
    configured cap otherwise.  A cut is a counted admission denial —
    occupancy shrinks instead of OOM."""
    cap = max(1, int(cap))
    _sample()
    g = _gauges()
    budget = budget_bytes(g, knobs)
    if budget is None:
        return cap
    used = used_bytes(g)
    if used <= budget or used <= 0:
        return cap
    shrunk = max(1, int(cap * budget / used))
    if shrunk >= cap:
        shrunk = cap - 1 if cap > 1 else 1
    if shrunk < cap:
        inc("mem.admission_denials")
        _ledger("mem.cap_shrunk", cap=cap, effective=shrunk,
                used_bytes=used, budget_bytes=budget)
    return shrunk


# -- eviction (the engine's layout caches) ---------------------------------

_ENGINE_CACHES = ("_sched_cache", "_grad_structs")


def evict_engine(engine) -> int:
    """Drop one engine's topology-keyed layout caches and its outroot
    arena (all rebuilt on demand: the caches are content-keyed, so
    staleness is impossible), then hand the caching allocator's free
    blocks back to the card.  Returns the eviction count (also counted
    as `mem.evictions`)."""
    n = 0
    for attr in _ENGINE_CACHES:
        side = getattr(engine, attr, None)
        if side:
            n += len(side)
            side.clear()
    if getattr(engine, "_outroot", None) is not None:
        engine._outroot = None
        n += 1
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_available() \
            and torch.cuda.is_initialized():
        torch.cuda.empty_cache()
    if n:
        inc("mem.evictions", n)
        _ledger("mem.evicted", count=n)
    return n


# -- OOM classification + escalation ---------------------------------------


def is_oom(exc: Optional[BaseException]) -> bool:
    """Is this caught dispatch exception a device-allocator OOM?  A
    `torch.cuda.OutOfMemoryError`, or the injected `mem.oom` fault.
    Never a kernel that did not build or launch (`_build.KernelError`)
    nor a CUDA runtime error, whatever their text says: those are
    device faults that end the run."""
    if exc is None or not isinstance(exc, BaseException):
        return False
    if isinstance(exc, faults.FaultInjected):
        return "mem.oom" in str(exc)
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(exc, torch.cuda.OutOfMemoryError)


def oom_event(exc: BaseException, seam: str) -> None:
    """Record one classified OOM at a dispatch seam (`mem.oom_events`)
    and advance the strike ladder; past OOM_STRIKE_LIMIT consecutive
    unrecovered strikes raise MemoryBudgetExhausted."""
    _STATE["strikes"] += 1
    inc("mem.oom_events")
    _ledger("mem.oom", seam=seam, strikes=_STATE["strikes"],
            error=str(exc)[:200])
    if _STATE["strikes"] > OOM_STRIKE_LIMIT:
        raise MemoryBudgetExhausted(
            f"device allocator OOM at {seam} persisted through "
            f"{_STATE['strikes']} evict+shrink retries: {exc}") from exc


def oom_recovered() -> None:
    """A dispatch completed after an OOM: the evict+shrink ladder
    worked, so the strike counter resets (`mem.oom_retries` counts the
    recovery)."""
    if _STATE["strikes"]:
        _STATE["strikes"] = 0
        inc("mem.oom_retries")


# -- obs shims ---------------------------------------------------------------


def inc(name: str, v: float = 1) -> None:
    from examl_tpu_torch import obs
    obs.inc(name, v)


def inc_gauge(name: str, v: float) -> None:
    from examl_tpu_torch import obs
    obs.gauge(name, v)


def _ledger(event: str, **fields) -> None:
    from examl_tpu_torch import obs
    obs.ledger_event(event, **fields)
