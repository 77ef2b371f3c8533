"""Process launch: the reference's MPI startup, one process per GPU.

ExaML starts as `mpirun -np N examl ...` (MPI_Init, rank discovery and
per-rank site assignment: `axml.c: main`, `communication.c:120-182`).
The port of `examl_tpu/parallel/launch.py` starts each rank by hand:

    python -m examl_tpu_torch.cli.main ... --coordinator HOST:PORT \\
        --nprocs N --procid K

Every rank joins one `torch.distributed` group (gloo, its rendezvous at
tcp://HOST:PORT), runs on `cuda:(K mod device_count)` and holds block
window K of the packed site axis (parallel/sharding.py).  No flags keep
the single-process path: `init_distributed` returns `sharding.SINGLE`
and starts nothing.

`--mesh SxT` / `EXAML_MESH` declares the (sites, tree) fabric of
parallel/sharding.py, and `select_sharding` turns the flags into it:
S site shards of one tree in this process (parallel/shards.py), the
fleet's tree axis over T cards (fleet/shard.py), or None for one card.
Without a mesh a run on the card shards its site axis over every
visible card when there are two or more, as the JAX package's does; a
rank of `--nprocs N > 1` keeps its one card.

This module imports torch only inside the functions that need it: the
CLI's parser takes its flags from here, and a supervising parent parses
the command line without loading torch.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

# Minutes a collective or the rendezvous waits for a peer before it
# raises.  A rank that died or raised closes its connections and its
# peers fail at once; this bounds the wait when a peer hangs instead.
GROUP_TIMEOUT_MINUTES = 10


def add_launch_args(parser) -> None:
    g = parser.add_argument_group("site-parallel launch")
    g.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="rendezvous address of the process group (rank "
                        "0 listens there)")
    g.add_argument("--nprocs", type=int, default=None,
                   help="number of ranks (processes) in the run")
    g.add_argument("--procid", type=int, default=None,
                   help="this process's rank, 0 <= procid < nprocs")
    g.add_argument("--single-device", action="store_true",
                   help="keep the run on one card even when several are "
                        "visible")
    g.add_argument("--mesh", dest="mesh", default=None, metavar="SxT",
                   help="declared (sites, tree) likelihood fabric: S site "
                        "shards per tree slice, T tree slices, on S*T "
                        "cards; Sx1 splits each tree's sites over S cards "
                        "in this process; T>1 requires a fleet mode "
                        "(-b/-N/--serve) and cuts each batch's jobs into T "
                        "slices, one launch table each on every card of "
                        "its slice (e.g. --mesh 2x2 on 4 cards).  "
                        "EXAML_MESH=SxT is the env equivalent (the flag "
                        "wins)")


def launch_requested(args) -> bool:
    return args.coordinator is not None or args.nprocs is not None


def check_launch_args(args) -> None:
    """Refuse flag combinations that cannot form a group (ValueError)."""
    if not launch_requested(args):
        if args.procid is not None:
            raise ValueError(
                "--procid requires --nprocs/--coordinator: without them "
                "this process would run as a second primary and clobber "
                "process 0's output files")
        return
    if args.nprocs is None or args.nprocs < 1:
        raise ValueError("--coordinator needs --nprocs N >= 1")
    if args.procid is None:
        if args.nprocs > 1:
            raise ValueError(f"--nprocs {args.nprocs} needs --procid K "
                             "on every rank")
    elif not 0 <= args.procid < args.nprocs:
        raise ValueError(f"--procid {args.procid} outside "
                         f"[0, {args.nprocs})")
    if args.nprocs > 1 and args.coordinator is None:
        raise ValueError(f"--nprocs {args.nprocs} needs --coordinator "
                         "HOST:PORT")


def init_distributed(args):
    """Join the run's process group when the flags ask for one; the world
    of one otherwise.  Raises when the group cannot form within
    GROUP_TIMEOUT_MINUTES: nothing carries on in one process."""
    from examl_tpu_torch.parallel.sharding import SINGLE, SiteGroup
    check_launch_args(args)
    if not launch_requested(args) or (args.nprocs == 1
                                      and args.coordinator is None):
        return SINGLE
    import torch.distributed as dist
    rank = args.procid or 0
    dist.init_process_group(
        "gloo", init_method=f"tcp://{args.coordinator}",
        world_size=args.nprocs, rank=rank,
        timeout=datetime.timedelta(minutes=GROUP_TIMEOUT_MINUTES))
    return SiteGroup(rank, args.nprocs, dist.group.WORLD)


def shutdown(group) -> None:
    """Leave the process group `init_distributed` joined (no-op for the
    world of one).  The group drops its handle too: a gloo group whose
    last reference dies only at interpreter exit can abort the process
    there ("terminate called without an active exception")."""
    import torch.distributed as dist
    if group.process_group is not None and dist.is_initialized():
        dist.destroy_process_group()
    group.process_group = None


def bank_barrier(args, group, report, log=lambda msg: None) -> None:
    """Line the ranks up after `--bank` (ops/bank.py; the JAX package's
    `bank_barrier`, the reference's MPI_Barrier after per-rank set-up).
    The ranks of one host share the build directory, and a build holds
    its library's lock file there, so each library is built once: here
    every rank first waits until no peer still holds the lock of a
    library it banked, then, in a process group, passes a barrier on the
    group's gloo channel before the first collective.  The ranks of an
    emulated gang and leased fleet ranks (no group) only wait for the
    locks.  A single process falls through."""
    from examl_tpu_torch.ops import _build
    ranked = (getattr(args, "_gang", None) is not None
              or getattr(args, "_fleet_rank", None) is not None)
    if group.size <= 1 and not ranked:
        return
    for fam, r in report.items():
        if r.get("status") == "banked":
            _build.await_build(fam, timeout=_build.compile_timeout())
    if group.size > 1:
        import torch.distributed as dist
        dist.barrier(group=group.process_group)
        log(f"bank: {group.size} ranks banked (barrier passed)")


def rank_device(rank: int, device=None):
    """The device of rank `rank`: `cuda:(rank mod device_count)` unless
    the caller names a device (`cpu`, or a card by index)."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch.cuda is "
                               "not available; pass device='cpu' to run "
                               "on the CPU")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def use_rank_device(rank: int, device=None):
    """`rank_device`, made the process's current card, so that kernels
    launched through ctypes run on it."""
    import torch
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def install_heartbeat(rank: int, log=lambda msg: None) -> Optional[str]:
    """Point this process's search-loop heartbeat at a PER-RANK file
    (resilience/heartbeat.py, `$EXAML_HEARTBEAT_FILE`): rank 0 keeps the
    configured path, rank k > 0 appends `.p<k>`, so one wedged rank is
    never masked by its peers' beats.  `rank` is the process group's
    rank, or the gang rank a supervisor exported (`EXAML_PROCID`) for a
    rank that joins no group."""
    from examl_tpu_torch.resilience import heartbeat

    base = os.environ.get(heartbeat.ENV_VAR)
    if not base:
        return None
    path = heartbeat.install(heartbeat.rank_path(base, rank))
    log(f"heartbeat -> {path}")
    return path


def enable_process_tracing(trace_dir: str,
                           log=lambda msg: None) -> Optional[str]:
    """Open this process's span-trace file under `trace_dir`, named by
    rank (`trace.p<rank>.jsonl`, the rank resolved from the process
    group that `init_distributed` joined) so the ranks never share a
    writer; rank 0 merges a cross-rank `summary.json` when it exits."""
    from examl_tpu_torch import obs

    try:
        path = obs.enable_tracing(trace_dir)
    except OSError as exc:
        log(f"trace events disabled ({exc})")
        return None
    log(f"trace events -> {path}")
    return path


def mesh_spec_requested(args) -> Optional[str]:
    """The raw SxT mesh spec in force, or None: the --mesh flag wins over
    EXAML_MESH."""
    flag = getattr(args, "mesh", None)
    if flag:
        return flag
    return os.environ.get("EXAML_MESH") or None


def select_sharding(args, save_memory: bool = False,
                    log=lambda msg: None, device=None):
    """The run's sharding, or None for one card.  A declared mesh
    (`--mesh SxT` / EXAML_MESH): None for 1x1, else the (sites, tree)
    fabric of parallel/sharding.py over the first S*T visible cards, the
    site axis outermost (S site shards of each tree, parallel/shards.py;
    T tree slices of the fleet's batches, fleet/shard.py; both at once
    for a fleet over site shards); a mesh the visible cards cannot hold
    raises ValueError ("... needs N devices ...").  Without a mesh: a
    1-D site mesh over every visible card when there are two or more
    (the JAX package's default; -S shards too: a pool region per card),
    None for a rank of `--nprocs N > 1` or of a supervised gang (each
    rank keeps its card) and for a run whose `device` is the CPU.
    --single-device gives None either way (the CLI refuses it with a
    mesh other than 1x1)."""
    from examl_tpu_torch.parallel.sharding import (fabric_sharding,
                                                   make_fabric_mesh,
                                                   make_mesh,
                                                   parse_mesh_spec,
                                                   site_sharding,
                                                   visible_devices)
    spec = mesh_spec_requested(args)
    if getattr(args, "single_device", False):
        return None
    if spec is not None:
        s, t = parse_mesh_spec(spec)
        if s == t == 1:
            return None
        sh = fabric_sharding(make_fabric_mesh(s, t))
        if save_memory:
            log(f"-S (SEV) sharded: per-device CLV pool regions over {s} "
                f"devices (mesh {s}x{t})")
        else:
            log(f"likelihood fabric {s}x{t}: {s} site shard(s) x {t} tree "
                f"slice(s) on " + ", ".join(
                    str(d) for d in sh.mesh.devices.flat))
        return sh
    if (getattr(args, "nprocs", None) or 1) > 1 or \
            getattr(args, "_gang", None) is not None:
        return None
    if device is not None:
        import torch
        if torch.device(device).type == "cpu":
            return None
    devices = visible_devices()
    if len(devices) <= 1:
        return None
    sh = site_sharding(make_mesh(devices))
    if save_memory:
        log(f"-S (SEV) sharded: per-device CLV pool regions over "
            f"{len(devices)} devices")
    else:
        log(f"site axis sharded over {len(devices)} devices (1 process): "
            + ", ".join(str(d) for d in devices))
    return sh
