"""Fleet job specs and the JSONL jobs-file format (`--serve`).

The port of `examl_tpu/fleet/jobs.py`: the same schema, seeds and
errors.

A jobs file is one JSON object per line:

    {"kind": "start"}                        # random tree from derived seed
    {"kind": "eval", "newick": "(a,(b,c));"} # evaluate a given tree
    {"kind": "bootstrap"}                    # weight replicate on -t tree
    {"op": "stop"}                           # drain the queue, then exit

Optional per-job fields: `id` (default `<kind><line>`), `seed`
(default: derived from the run's `-p` seed and the job's index via
fleet/seeds.py — the line index IS the replicate index, so appending
jobs never re-seeds earlier ones), `cycles` (evaluation/smoothing
rounds, default the driver's `--fleet-cycles`).

ADMISSION SCHEMA: unknown fields, unknown ops, non-integer /
negative / NaN seeds, and non-positive cycles are rejected at parse
time with the reason — a `--serve` loop reports them and keeps
serving.  Checks that need the instance (tree parses, taxa set matches
the alignment, bootstrap has a `-t` topology) run in
`quarantine.admission_error` at queue-join time.
"""

from __future__ import annotations

import json
import re
from dataclasses import asdict, dataclass, field
from typing import List, Optional, Tuple

KINDS = ("bootstrap", "start", "eval")
_ID_RE = re.compile(r"[A-Za-z0-9._\-]+")   # fullmatched: `$` would
                                           # accept a trailing newline

# Admission schema: every field a job object may carry.  An unknown
# field is rejected, not ignored — a producer typo ("cycle": 3,
# "newik": ...) silently dropping its intent is exactly the class of
# garbage a serving process must bounce at the door.
KNOWN_FIELDS = frozenset({"kind", "op", "id", "seed", "cycles", "newick"})

_MAX_SEED = 2 ** 63
_MAX_CYCLES = 1_000_000


def _check_int(value, name: str, lo: int, hi: int) -> int:
    """Admission-grade integer validation: bools, floats (json accepts
    NaN/Infinity!), negatives and absurd magnitudes are all rejected
    with the reason — `int(float('nan'))` raising deep in seed
    derivation is a crash, not admission control."""
    if isinstance(value, bool) or not isinstance(value, int):
        if isinstance(value, float) and float(value).is_integer():
            value = int(value)
        elif isinstance(value, str):
            try:
                value = int(value, 10)
            except ValueError:
                raise ValueError(
                    f"{name} must be an integer, got {value!r}")
        else:
            raise ValueError(f"{name} must be an integer, got {value!r}")
    if not lo <= value < hi:
        raise ValueError(f"{name} must be in [{lo}, {hi}), got {value}")
    return value


@dataclass
class JobSpec:
    job_id: str
    kind: str                      # bootstrap | start | eval
    index: int                     # replicate index (seed derivation)
    seed: int
    cycles: int = 1
    cycles_done: int = 0
    lnl: Optional[float] = None
    done: bool = False
    failed: bool = False
    newick: Optional[str] = None   # eval input / current start-job tree
    # Job-level fault domain state (fleet/quarantine.py): how many
    # attempts this job has burned (poison lnL, dispatch raise,
    # deadline kill — persisted through checkpoints so a supervised
    # restart keeps the ladder where it was), the quarantine cause, and
    # the last error message for the dead-letter record.
    attempts: int = 0
    cause: Optional[str] = None
    last_error: Optional[str] = None
    extra: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "JobSpec":
        known = {f for f in cls.__dataclass_fields__}  # noqa: C416
        return cls(**{k: v for k, v in d.items() if k in known})


def parse_jobs_lines(lines: List[str], parent_seed: int,
                     default_cycles: int = 1,
                     start_index: int = 0,
                     on_error=None) -> Tuple[List[JobSpec], bool]:
    """Parse jobs-file lines into specs; returns (jobs, stop_seen).
    Blank lines and `#` comments are skipped but still consume a line
    index (so appended files stay stable).  A malformed line raises
    ValueError naming its number — unless `on_error` is given, in
    which case the line is reported through it and SKIPPED (a serving
    loop must outlive one producer typo)."""
    from examl_tpu_torch.fleet import seeds
    out: List[JobSpec] = []
    stop = False

    def bad(msg: str) -> None:
        if on_error is None:
            raise ValueError(msg)
        on_error(msg)

    for off, raw in enumerate(lines):
        lineno = start_index + off
        text = raw.strip()
        if not text or text.startswith("#"):
            continue
        try:
            d = json.loads(text)
            if not isinstance(d, dict):
                raise ValueError(f"expected a JSON object, got "
                                 f"{type(d).__name__}")
            unknown = sorted(set(d) - KNOWN_FIELDS)
            if unknown:
                raise ValueError(
                    f"unknown field(s) {unknown} (allowed: "
                    + ", ".join(sorted(KNOWN_FIELDS)) + ")")
            if "op" in d:
                if d["op"] != "stop":
                    raise ValueError(f"unknown op {d['op']!r} "
                                     "(only \"stop\" is defined)")
                stop = True
                continue
            kind = d.get("kind")
            if kind not in KINDS:
                raise ValueError(f"kind must be one of {KINDS}, "
                                 f"got {kind!r}")
            if kind == "eval" and not d.get("newick"):
                raise ValueError("eval jobs need a 'newick' field")
            if d.get("newick") is not None \
                    and not isinstance(d["newick"], str):
                raise ValueError("newick must be a string")
            jid = str(d.get("id", f"{kind}{lineno}"))
            if not _ID_RE.fullmatch(jid):
                # The results table is space-delimited one-record-per-
                # line; an id with whitespace (or other non-token
                # chars) would corrupt it for every downstream reader.
                raise ValueError(f"id {jid!r} must match "
                                 "[A-Za-z0-9._-]+")
            seed = d.get("seed")
            if seed is None:
                seed = seeds.derive(parent_seed, kind, lineno)
            else:
                seed = _check_int(seed, "seed", 0, _MAX_SEED)
            # Bootstrap jobs are weights-only on a fixed topology:
            # extra cycles would re-run byte-identical evaluations, so
            # cycles normalizes to 1 (matching the -b CLI path).
            cycles = (1 if kind == "bootstrap"
                      else _check_int(d.get("cycles", default_cycles),
                                      "cycles", 1, _MAX_CYCLES))
            spec = JobSpec(job_id=jid, kind=kind, index=lineno,
                           seed=int(seed), cycles=cycles,
                           newick=d.get("newick"))
        except (ValueError, TypeError) as exc:
            bad(f"jobs file line {lineno + 1}: {exc}")
            continue
        out.append(spec)
    return out, stop


def make_jobs(kind: str, count: int, parent_seed: int,
              cycles: int = 1) -> List[JobSpec]:
    """The `-b K` / `-N K` job sets: K replicates with stable derived
    seeds (replicate k is the same analysis on every resume)."""
    from examl_tpu_torch.fleet import seeds
    assert kind in ("bootstrap", "start")
    return [JobSpec(job_id=f"{kind}{k}", kind=kind, index=k,
                    seed=seeds.derive(parent_seed, kind, k),
                    cycles=cycles)
            for k in range(count)]
