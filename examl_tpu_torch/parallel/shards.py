"""The in-process site axis: the site shards of one tree in one process.

The port of the JAX package's single-process site sharding (GSPMD over a
`Mesh` whose site axis splits every tree's packed blocks over the
devices, `examl_tpu/parallel/sharding.py`), the reference's one parallel
strategy (SURVEY §0): every rank holds the whole tree and model and a
block window of the sites, and every site sum is one all-reduce.  A
PyTorch program has no partitioner, so the port runs S site shards as S
engines of each state bucket, one per card of the mesh's site axis,
each over its window (`packing.window_of`), each reducing its site sums
through a `ThreadSiteGroup` (parallel/sharding.py).  The engines' Newton-
Raphson loops reduce inside the loop, so every engine op of the shards
runs at once, each shard on a thread of its own:

* `ShardPool` — the threads.  Rank 0 runs on the caller's thread (its
  instruments on, under its card), ranks 1..S-1 on persistent worker
  threads, each with its card current, a CUDA stream of its own and its
  instruments quiet (obs: an op is counted, timed and traced once, as
  on one card; a kernel's launch count counts every shard).  A shard
  that raises aborts the shards' board, so no peer is left waiting in a
  collective, and the call raises the first error in rank order that is
  not the board's.
* `ShardedEngine` — one bucket's shard engines behind the engine's
  interface: an op named in `_BROADCAST` runs on every shard with the
  same arguments and returns rank 0's value (every shard holds the same
  bits: each reduced the same parts in rank order); a per-shard value
  (a sumtable) comes back as a `PerShard`, which the next op hands to
  each shard its own part of; `on_shards(fn)` runs any function of an
  engine on every shard.  Attributes that every shard shares read
  through; anything else raises, so nothing reads one shard's state as
  the bucket's.

The sums are in rank order on every shard, so an `Sx1` instance gives
the bits of S gloo ranks over the same windows (parallel/launch.py).
S shards share the host's interpreter: host-bound paths get no faster.

This module imports torch only inside the functions that need it.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, List, Optional, Sequence

from examl_tpu_torch import obs
from examl_tpu_torch.parallel.sharding import ShardBoard, ThreadSiteGroup

# Seconds a shard waits in a collective for a peer that neither arrives
# nor raises (the gloo group's GROUP_TIMEOUT_MINUTES).
BOARD_TIMEOUT_S = 600.0


class _Call:
    __slots__ = ("fn", "result", "error", "done")

    def __init__(self, fn):
        self.fn = fn
        self.result = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()


def _serve(rank: int, inbox, board: ShardBoard, dev, streams: list) -> None:
    """Worker `rank`'s loop: its card current, its own stream (published
    in `streams`), its instruments quiet; a call that raises aborts the
    board."""
    import torch
    obs.set_quiet(True)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        stream = torch.cuda.Stream(dev)
        torch.cuda.set_stream(stream)
        streams[rank] = stream
    while True:
        call = inbox.get()
        if call is None:
            return
        try:
            call.result = call.fn(rank)
        except BaseException as exc:         # noqa: BLE001 — re-raised
            call.error = exc
            board.abort()
        finally:
            call.fn = None
            call.done.set()
        del call


class ShardPool:
    """The threads of S site shards on `devices` (torch devices; one card
    may stand more than once), and their groups over one board."""

    def __init__(self, devices: Sequence, timeout: float = BOARD_TIMEOUT_S):
        import torch
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self.board = ShardBoard(self.size, timeout)
        self.groups = [ThreadSiteGroup(r, self.size, self.board)
                       for r in range(self.size)]
        self._inbox = [queue.SimpleQueue() for _ in range(self.size)]
        # Each worker's CUDA stream (None for rank 0, which runs on the
        # caller's, and on the CPU): the work a shard's ops queued there
        # is what a fleet lane over the shard waits for.
        self.streams: List = [None] * self.size
        self._threads = []
        for r in range(1, self.size):
            # The thread holds the pool's parts, not the pool: a pool
            # nothing else holds is collected and stops its threads.
            t = threading.Thread(
                target=_serve, args=(r, self._inbox[r], self.board,
                                     self.devices[r], self.streams),
                daemon=True, name=f"site-shard-{r}")
            t.start()
            self._threads.append(t)
        self._closed = False

    def run(self, fn: Callable[[int], object]) -> list:
        """[fn(0), ..., fn(S-1)], each on its shard's thread, all at once.
        Raises the first error in rank order that is not the board's
        (a peer's abort), once every shard has returned."""
        if self._closed:
            raise RuntimeError("the site shards' threads were closed")
        if threading.current_thread() in self._threads:
            raise RuntimeError("a site shard's op cannot start another")
        calls = [None] + [_Call(fn) for _ in range(1, self.size)]
        for r in range(1, self.size):
            self._inbox[r].put(calls[r])
        first = _Call(fn)
        try:
            first.result = self._on_rank0(fn)
        except BaseException as exc:         # noqa: BLE001 — re-raised
            first.error = exc
            self.board.abort()
        for c in calls[1:]:
            c.done.wait()
        calls[0] = first
        errors = [c.error for c in calls if c.error is not None]
        if errors:
            self.board.reset()
            own = [e for e in errors
                   if not isinstance(e, threading.BrokenBarrierError)]
            raise (own or errors)[0]
        return [c.result for c in calls]

    def _on_rank0(self, fn):
        import torch
        dev = self.devices[0]
        if dev.type != "cuda":
            return fn(0)
        with torch.cuda.device(dev):
            return fn(0)

    def close(self) -> None:
        """Stop the worker threads (idle ones; a running op finishes)."""
        if not self._closed:
            self._closed = True
            for r in range(1, self.size):
                self._inbox[r].put(None)

    def __del__(self):
        self.close()


class PerShard(list):
    """A value of each shard, in rank order (an op's result that lives on
    the shards' cards, such as a sumtable); an op given one hands each
    shard its own part."""


def _part(value, rank: int):
    return value[rank] if isinstance(value, PerShard) else value


def _merge(results: list):
    """Rank 0's value, or a PerShard of tensors that stay on their
    shards."""
    import torch
    first = results[0]
    if isinstance(first, torch.Tensor):
        return PerShard(results)
    return first


class ShardedEngine:
    """One state bucket's engines on the site shards (rank order), behind
    the engine interface the instance, the optimizers and the search
    call.  `bucket` is the global bucket; each shard's is its window."""

    # Ops that every shard runs with the same arguments (a PerShard
    # argument gives each its part) and whose host result every shard
    # holds alike.
    _BROADCAST = frozenset({
        "set_models", "run_traversal", "traverse_evaluate", "make_sumtable",
        "branch_derivatives", "newton_branch", "batched_scan",
        "batched_thorough", "rate_scan", "whole_tree_gradients"})
    # Attributes alike on every shard.
    _SHARED = frozenset({"device", "dtype", "K"})

    __slots__ = ("pool", "shards", "bucket")

    def __init__(self, pool: ShardPool, shards: List, bucket):
        self.pool = pool
        self.shards = list(shards)
        self.bucket = bucket
        # Rank 0 counts each op for all shards (the others run quiet), so
        # its traffic model covers the bucket's patterns, not its window's.
        shards[0]._patterns_true = int(sum(e._patterns_true for e in shards))

    def on_shards(self, fn, *args):
        """fn(shard engine, *args) on every shard at once; rank 0's result
        (a PerShard of tensors)."""
        return _merge(self.pool.run(
            lambda r: fn(self.shards[r], *(_part(a, r) for a in args))))

    def set_site_rates(self, rates) -> None:
        """Install the bucket's GLOBAL packed per-site rates [B, lane]
        (PSR): each shard takes its window's blocks."""
        def put(eng):
            b0 = eng.bucket.block_offset
            eng.set_site_rates(rates[b0:b0 + eng.B])
        self.on_shards(put)

    def __getattr__(self, name: str):
        if name in ShardedEngine._SHARED:
            return getattr(self.shards[0], name)
        if name in ShardedEngine._BROADCAST:
            def op(*args, **kw):
                return _merge(self.pool.run(lambda r: getattr(
                    self.shards[r], name)(
                        *(_part(a, r) for a in args),
                        **{k: _part(v, r) for k, v in kw.items()})))
            return op
        raise AttributeError(
            f"{name!r} of a site-sharded engine: each of its "
            f"{len(self.shards)} shards holds its own (read it from "
            "ShardedEngine.shards, or run a function on every shard with "
            "on_shards)")
