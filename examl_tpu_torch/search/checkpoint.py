"""Checkpoint / restart subsystem.

Reference semantics (ExaML `searchAlgo.c:1102-1750`, SURVEY §5.4):
checkpoints cover every long-running phase (REARR_SETTING / FAST_SPRS /
SLOW_SPRS / MOD_OPT), files are monotonically numbered and never
overwritten, and a restart refuses mismatched command-line flags
(`checkCommandLineArguments` :1383-1500).  State is serialized as
gzipped JSON: edge-list tree snapshots, raw model parameters
(rates/freqs/alpha; eigensystems are recomputed), search counters, and
the best-tree list.

The port of `examl_tpu/search/checkpoint.py`, with the same file names,
magic, version, sections and fingerprint keys, so a checkpoint written
by either package restores in the other.  The fingerprint's `nprocs` is
the run's world size (the gang's, when a supervisor spawned the ranks),
allowlisted on restore (ELASTIC_FP_KEYS) as in the JAX package, so a
checkpoint written by a run of two ranks restores in a run of one and
the other way round.  In a site-parallel run started by hand only rank 0
writes, and every rank restores from the shared file.

GANG RUNS (`--launch N`, resilience/supervisor.py) make a checkpoint
cycle a TWO-PHASE COMMIT: every rank fsyncs a staging record into the
shared workdir (rank 0 the full blob, the others small attest markers
stamped with the supervisor's attempt), and the published
`.ckpt_N.json.gz` appears, by one atomic rename of rank 0's fsynced
blob, only once EVERY rank of the current attempt has staged cycle N.  A
gang killed in the middle of a cycle never serves a checkpoint some rank
did not reach; the partial cycle is collected at restore
(`checkpoint.partial_cycles_gced`) and the restore falls back to the
newest complete one.  The `checkpoint.publish` fault seam sits between
the complete staging and the rename.

A partition's model entry holds its rates, frequencies and alpha (GTR or
an empirical protein matrix, with AUTO's current choice in
`auto_name`/`auto_freqs`, and under PSR the per-site rate state), or for
LG4M/LG4X its name, alpha, category rates and weights; a restore gives
back the frequencies bit for bit (`_exact_freqs`), so a run resumed at a
tree boundary goes on exactly as the uninterrupted one.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
import time
from dataclasses import replace
from typing import Optional

import numpy as np

from examl_tpu_torch import obs
from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.constants import FREQ_MIN
from examl_tpu_torch.models.gtr import build_model, eigen_gtr
from examl_tpu_torch.models.lg4 import LG4Params
from examl_tpu_torch.resilience import faults
from examl_tpu_torch.search.snapshots import TreeSnapshot
from examl_tpu_torch.transfer import lg4_from_params
from examl_tpu_torch.tree.topology import Tree

CKPT_VERSION = 1
CKPT_MAGIC = "examl-tpu-checkpoint"

# Fingerprint keys allowed to DIFFER between write and restore (the JAX
# package's elastic-resume allowlist); everything else must match.
ELASTIC_FP_KEYS = frozenset({"nprocs"})


def _world_size(inst: PhyloInstance) -> int:
    """The world size a fingerprint records: the gang's when a gang
    supervisor spawned this process (`EXAML_GANG_RANKS`, real and
    emulated gangs alike), else the process group's."""
    env = os.environ.get("EXAML_GANG_RANKS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return inst.group.size


def _gang_attempt() -> int:
    """The supervisor attempt this process belongs to: stage markers are
    stamped with it, so a dead attempt's leftovers can never complete a
    new attempt's cycle."""
    return faults._attempt()


class CorruptCheckpoint(ValueError):
    """A checkpoint file that cannot be parsed (truncated/corrupt gzip,
    invalid JSON, missing magic or required sections) — the restore
    fallback skips these; genuine config mismatches raise ValueError."""


def _fingerprint(inst: PhyloInstance) -> dict:
    """Alignment/flag identity that must match between run and restart."""
    al = inst.alignment
    return {
        "ntaxa": al.ntaxa,
        "partitions": [[p.name, p.states,
                        int(p.global_weight_sum
                            if p.global_weight_sum is not None
                            else np.sum(p.weights))]
                       for p in al.partitions],
        "ncat": inst.ncat,
        "use_median": inst.use_median,
        "per_partition_branches": inst.per_partition_branches,
        "rate_model": inst.rate_model,
        "nprocs": _world_size(inst),
    }


def _models_blob(inst: PhyloInstance) -> list:
    out = []
    for gid, m in enumerate(inst.models):
        if isinstance(m, LG4Params):
            out.append({"lg4": m.name, "alpha": float(m.alpha),
                        "gamma_rates": np.asarray(m.gamma_rates).tolist(),
                        "rate_weights": np.asarray(m.rate_weights).tolist()})
            continue
        d = {"rates": np.asarray(m.rates).tolist(),
             "freqs": np.asarray(m.freqs).tolist(),
             "alpha": float(m.alpha),
             "auto_name": inst.auto_prot_models.get(gid),
             "auto_freqs": inst.auto_prot_freqs.get(gid)}
        if inst.psr:
            # Per-site rate state: the categories, their rates, and
            # patrat, the un-snapped per-site scan optima (reference
            # patrat vs perSiteRates, `axml.h:585-600`).
            d["rate_category"] = inst.rate_category[gid].tolist()
            d["per_site_rates"] = inst.per_site_rates[gid].tolist()
            d["patrat"] = inst.patrat[gid].tolist()
        out.append(d)
    return out


def _exact_freqs(model, stored) -> object:
    """`model` with the checkpoint's frequencies bit for bit.  They were
    normalized once when the model was built, and `build_model`
    normalizes again, which can move them by an ulp: a run resumed at a
    tree boundary would then part from the uninterrupted run in the last
    bits.  Frequencies that are not already normalized stay as built."""
    stored = np.asarray(stored, dtype=np.float64)
    if np.array_equal(model.freqs, stored) or stored.min() < FREQ_MIN \
            or not np.allclose(model.freqs, stored, rtol=1e-12, atol=0):
        return model
    eign, ev, ei = eigen_gtr(model.rates, stored)
    return replace(model, freqs=stored, eign=eign, ev=ev, ei=ei)


def _restore_models(inst: PhyloInstance, blob: list) -> None:
    for gid, d in enumerate(blob):
        part = inst.alignment.partitions[gid]
        if d.get("lg4"):
            inst.models[gid] = lg4_from_params(d, inst.use_median)
            continue
        if d.get("auto_name"):
            inst.auto_prot_models[gid] = d["auto_name"]
        if d.get("auto_freqs"):
            inst.auto_prot_freqs[gid] = d["auto_freqs"]
        model = build_model(
            part.datatype, np.asarray(d["freqs"]),
            rates=np.asarray(d["rates"]), alpha=d["alpha"],
            ncat=inst.ncat, use_median=inst.use_median)
        inst.models[gid] = _exact_freqs(model, d["freqs"])
        if inst.psr and "rate_category" in d:
            # A section whose length is not the partition's pattern count
            # (the alignment's, also on a rank that read only its own
            # columns) was written for another alignment layout: refuse it.
            cat = np.asarray(d["rate_category"], dtype=np.int32)
            width = part.global_width if part.global_width is not None \
                else part.width
            if cat.size != width:
                raise ValueError(
                    f"checkpoint section models[{gid}].rate_category "
                    f"carries {cat.size} sites but partition "
                    f"'{part.name}' has {width} patterns")
            inst.rate_category[gid] = cat
            inst.per_site_rates[gid] = np.asarray(d["per_site_rates"])
            inst.patrat[gid] = np.asarray(
                d.get("patrat", inst.per_site_rates[gid][
                    inst.rate_category[gid]].tolist()))
    inst.push_models()
    if inst.psr:
        inst.push_site_rates()


class CheckpointManager:
    """Writes numbered checkpoint files and restores the newest one.

    Usage: mgr = CheckpointManager(workdir, run_id);
    compute_big_rapid(..., checkpoint_cb=lambda state, extras:
    mgr.write(state, extras, inst, tree)), and on restart
    resume = mgr.restore(inst, tree).
    """

    FILE_RE = re.compile(r"\.ckpt_(\d+)\.json\.gz$")
    STAGE_RE = re.compile(r"\.ckpt_(\d+)\.stage\.(blob|r\d+)$")

    def __init__(self, workdir: str, run_id: str,
                 keep_last: Optional[int] = None, log=print,
                 primary: bool = True, gang_rank: int = 0,
                 gang_size: int = 1):
        self.workdir = workdir
        self.run_id = run_id
        # keep_last: prune checkpoints older than the newest N after each
        # write (None = keep all, the search default mirroring the
        # reference's never-overwritten numbered files).  Modes that write
        # per work item (-f e over many trees) pass a small N so disk use
        # stays linear.
        self.keep_last = keep_last
        self.log = log
        # Only rank 0 of a site-parallel run writes (into the shared
        # workdir, which every rank restores from); the other ranks keep
        # the counter alone.
        self.primary = primary
        # Gang runs: `workdir` is the SHARED gang directory (lockstep
        # keeps the ranks' counters aligned), writes take the two-phase
        # stage/publish path, and only published cycles restore.
        self.gang_rank = int(gang_rank)
        self.gang_size = max(1, int(gang_size))
        os.makedirs(workdir, exist_ok=True)
        self.counter = self._max_existing() + 1

    def _pattern(self) -> str:
        return os.path.join(self.workdir,
                            f"ExaML_binaryCheckpoint.{self.run_id}"
                            ".ckpt_*.json.gz")

    def _stage_pattern(self) -> str:
        return os.path.join(self.workdir,
                            f"ExaML_binaryCheckpoint.{self.run_id}"
                            ".ckpt_*.stage.*")

    def _stage_blob(self, n: int) -> str:
        return os.path.join(self.workdir,
                            f"ExaML_binaryCheckpoint.{self.run_id}"
                            f".ckpt_{n}.stage.blob")

    def _stage_marker(self, n: int, rank: int) -> str:
        return os.path.join(self.workdir,
                            f"ExaML_binaryCheckpoint.{self.run_id}"
                            f".ckpt_{n}.stage.r{rank}")

    def _numbers(self) -> list:
        return [int(m.group(1)) for f in glob.glob(self._pattern())
                if (m := self.FILE_RE.search(f))]

    def _max_existing(self) -> int:
        return max(self._numbers(), default=-1)

    def path_for(self, n: int) -> str:
        return os.path.join(self.workdir,
                            f"ExaML_binaryCheckpoint.{self.run_id}"
                            f".ckpt_{n}.json.gz")

    # -- write --------------------------------------------------------------

    def _fsync_file(self, path: str) -> None:
        """fsync a CLOSED file (the gzip trailer is only written at close)
        before the rename, so a hard kill or power loss cannot publish a
        truncated file."""
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def _fsync_dir(self) -> None:
        try:                        # directory-entry durability: best
            dirfd = os.open(self.workdir, os.O_RDONLY)  # effort on
            try:                    # filesystems that reject dir fsync
                os.fsync(dirfd)
            finally:
                os.close(dirfd)
        except OSError:
            pass

    def write(self, state: str, extras: dict, inst: PhyloInstance,
              tree: Tree, tree_dict: Optional[dict] = None) -> str:
        """Publish checkpoint number `counter`: a tmp file, fsynced, then
        one atomic rename; an older checkpoint is never overwritten.
        tree_dict replaces the captured tree: quartet mode's live tree is
        a scaffold that an edge-list snapshot cannot represent, so it
        checkpoints the comprehensive model tree instead.  A gang manager
        (gang_size > 1) takes the two-phase path (`_write_gang`); on a
        rank other than 0 of a run started by hand nothing is written.
        The `checkpoint.write` fault seam sits between the tmp write and
        the publish (on every rank, as in the JAX package's gang path): a
        raise models a full disk, a `:signal=KILL` dying mid-write, and
        either way the previously published checkpoint stays intact."""
        if self.gang_size > 1:
            return self._write_gang(state, extras, inst, tree, tree_dict)
        path = self.path_for(self.counter)
        if not self.primary:
            faults.fire("checkpoint.write")
            self.counter += 1
            return path
        self._write_blob(path, self._blob(state, extras, inst, tree,
                                          tree_dict))
        self._fsync_dir()
        obs.ledger_event("checkpoint.publish", cycle=self.counter,
                         state=state)
        self.counter += 1
        self._prune()
        return path

    def _blob(self, state: str, extras: dict, inst: PhyloInstance,
              tree: Tree, tree_dict: Optional[dict]) -> dict:
        if tree_dict is None:
            tree_dict = TreeSnapshot.capture(
                tree, getattr(inst, "likelihood", 0.0),
                with_key=False).to_dict()
        return {
            "magic": CKPT_MAGIC,
            "version": CKPT_VERSION,
            "state": state,
            "counter": self.counter,
            "fingerprint": _fingerprint(inst),
            "models": _models_blob(inst),
            "tree": tree_dict,
            "extras": extras,
        }

    def _write_blob(self, path: str, blob: dict) -> None:
        """Gzip `blob` to a tmp beside `path`, fsync it, fire the
        `checkpoint.write` seam, then rename it to `path`."""
        tmp = path + ".tmp"
        try:
            with gzip.open(tmp, "wt") as f:
                json.dump(blob, f)
            self._fsync_file(tmp)
            faults.fire("checkpoint.write")
            os.replace(tmp, path)
        except (OSError, faults.FaultInjected):
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- gang two-phase commit ----------------------------------------------

    def _write_gang(self, state: str, extras: dict, inst: PhyloInstance,
                    tree: Tree, tree_dict: Optional[dict]) -> str:
        """Phase 1 of a gang checkpoint cycle: STAGE.  Rank 0 fsyncs the
        full blob to `.ckpt_N.stage.blob`; every rank then fsyncs its
        attest marker `.ckpt_N.stage.r<k>`, stamped with the attempt.
        Phase 2 (`_try_publish`) follows; the last rank to stage finds
        the set complete, so nobody blocks."""
        n = self.counter
        if self.gang_rank == 0:
            self._write_blob(self._stage_blob(n), self._blob(
                state, extras, inst, tree, tree_dict))
        else:
            faults.fire("checkpoint.write")
        marker = self._stage_marker(n, self.gang_rank)
        tmp = f"{marker}.tmp.{os.getpid()}"
        rec = {"rank": self.gang_rank, "cycle": n,
               "attempt": _gang_attempt(), "pid": os.getpid(),
               "t": time.time()}
        try:
            with open(tmp, "w") as f:
                json.dump(rec, f)
            self._fsync_file(tmp)
            os.replace(tmp, marker)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._fsync_dir()
        self.counter += 1
        self._try_publish(n)
        return self.path_for(n)

    def _read_marker(self, path: str) -> Optional[dict]:
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _try_publish(self, n: int) -> bool:
        """Phase 2: PUBLISH cycle `n` iff rank 0's blob and EVERY rank's
        current-attempt marker are staged.  Ranks stage a cycle once, so
        the last to stage sees the complete set; racing publishers are
        harmless (the rename has one winner, and the loser's
        FileNotFoundError means "already published")."""
        blob = self._stage_blob(n)
        if not os.path.exists(blob):
            return False
        attempt = _gang_attempt()
        for k in range(self.gang_size):
            rec = self._read_marker(self._stage_marker(n, k))
            if rec is None or rec.get("attempt") != attempt:
                return False
        # `checkpoint.publish:signal=KILL` models a gang that dies
        # between the two phases: restore falls back a cycle.
        faults.fire("checkpoint.publish")
        try:
            # The blob was fsynced when staged: this renames durable
            # bytes.
            os.replace(blob, self.path_for(n))
        except FileNotFoundError:
            return True               # a peer won the publish race
        self._fsync_dir()
        for k in range(self.gang_size):
            try:
                os.unlink(self._stage_marker(n, k))
            except OSError:
                pass
        obs.inc("checkpoint.gang_publishes")
        obs.ledger_event("checkpoint.publish", cycle=n,
                         rank=self.gang_rank, world=self.gang_size)
        self._prune()
        return True

    def gc_partial_cycles(self) -> int:
        """Remove every staging leftover (no cycle is in flight at
        restore time) and count the cycles that never published: the
        evidence of a gang killed mid-cycle
        (`checkpoint.partial_cycles_gced`).  Leftover markers of a
        published cycle (its publisher killed while unlinking) go
        silently: that cycle committed."""
        published = set(self._numbers())
        partial = set()
        for f in glob.glob(self._stage_pattern()):
            m = self.STAGE_RE.search(f)
            if m and int(m.group(1)) not in published:
                partial.add(int(m.group(1)))
            try:
                os.unlink(f)
            except OSError:
                pass
        if partial:
            obs.inc("checkpoint.partial_cycles_gced", len(partial))
            obs.ledger_event("checkpoint.gc", cycles=sorted(partial))
            self.log(f"garbage-collected {len(partial)} partially staged "
                     f"checkpoint cycle(s) {sorted(partial)} (a gang "
                     "killed mid-cycle); restoring the newest complete "
                     "cycle")
        return len(partial)

    def _prune(self) -> None:
        """Remove every on-disk index older than the newest keep_last (a
        crash between publish and prune, or a keep_last that shrank
        across a restart, leaves older files that this sweep catches).
        Staging leftovers age out on the same cutoff."""
        if self.keep_last is None:
            return
        cutoff = self.counter - self.keep_last
        for pattern, regex in ((self._pattern(), self.FILE_RE),
                               (self._stage_pattern(), self.STAGE_RE)):
            for f in glob.glob(pattern):
                m = regex.search(f)
                if m and int(m.group(1)) < cutoff:
                    try:
                        os.remove(f)
                    except FileNotFoundError:
                        pass

    def callback(self, inst: PhyloInstance, tree: Tree):
        def cb(state: str, extras: dict) -> None:
            self.write(state, extras, inst, tree)
        return cb

    # -- restore ------------------------------------------------------------

    def latest_path(self) -> Optional[str]:
        n = self._max_existing()
        return self.path_for(n) if n >= 0 else None

    def restore(self, inst: PhyloInstance, tree: Tree,
                path: Optional[str] = None) -> Optional[dict]:
        """Load the newest readable checkpoint into inst+tree; returns
        the resume blob for compute_big_rapid, or None if no (intact)
        checkpoint exists.

        A checkpoint that fails to parse is skipped with a logged warning
        and the next-newest numbered file is tried; an explicit `path`
        disables the fallback.  Raises ValueError on an incompatible run
        configuration (the reference aborts on mismatched restart
        flags)."""
        if path is not None:
            return self._restore_one(inst, tree, path)
        # Two-phase hygiene: sweep staging leftovers BEFORE choosing a
        # cycle, so a gang killed between stage and publish resumes from
        # the newest COMPLETE cycle.  Rank 0 only: the ranks restore at
        # independent moments, and a slow rank's restore must not unlink
        # a cycle a fast one has already re-staged.
        if self.gang_rank == 0:
            self.gc_partial_cycles()
        nums = sorted(self._numbers(), reverse=True)
        for n in nums:
            p = self.path_for(n)
            try:
                return self._restore_one(inst, tree, p)
            except CorruptCheckpoint as exc:
                obs.inc("checkpoint.corrupt_skipped")
                obs.ledger_event("checkpoint.corrupt_skipped", cycle=n,
                                 error=str(exc)[:200])
                self.log(f"checkpoint {p} unreadable ({exc}); falling back "
                         "to the next-newest checkpoint")
        if nums:
            self.log(f"all {len(nums)} checkpoint(s) for run "
                     f"'{self.run_id}' are unreadable; nothing to resume")
        return None

    def _restore_one(self, inst: PhyloInstance, tree: Tree,
                     path: str) -> dict:
        t0 = time.perf_counter()
        try:
            with gzip.open(path, "rt") as f:
                blob = json.load(f)
        except (OSError, EOFError, ValueError) as exc:
            # EOFError / gzip.BadGzipFile (an OSError): a truncated or
            # garbage gzip stream; ValueError covers json.JSONDecodeError.
            raise CorruptCheckpoint(f"{type(exc).__name__}: {exc}") \
                from exc
        if not isinstance(blob, dict) or blob.get("magic") != CKPT_MAGIC:
            raise CorruptCheckpoint(f"not an examl-tpu checkpoint: {path}")
        missing = [k for k in ("fingerprint", "models", "tree", "state")
                   if k not in blob]
        if missing:
            raise CorruptCheckpoint(
                f"checkpoint missing section(s) {missing}: {path}")
        if blob.get("version") != CKPT_VERSION:
            raise ValueError(f"checkpoint version {blob.get('version')} "
                             f"unsupported")
        fp_now = _fingerprint(inst)
        fp_ckpt = blob["fingerprint"]
        hard = [k for k in sorted(set(fp_now) | set(fp_ckpt))
                if k not in ELASTIC_FP_KEYS
                and not (k in fp_now and k in fp_ckpt
                         and fp_now[k] == fp_ckpt[k])]
        if hard:
            raise ValueError(
                "checkpoint was written for a different run configuration "
                f"(mismatched section(s) {hard}: checkpoint {fp_ckpt} vs "
                f"current {fp_now}); restart must use the same alignment, "
                "partitions, and model flags")
        _restore_models(inst, blob["models"])
        TreeSnapshot.from_dict(blob["tree"]).restore_into(tree)
        inst.evaluate(tree, full=True)
        obs.ledger_event("checkpoint.restore", cycle=blob.get("counter"),
                         state=blob["state"],
                         seconds=round(time.perf_counter() - t0, 4))
        return {"state": blob["state"], "extras": blob["extras"]}
