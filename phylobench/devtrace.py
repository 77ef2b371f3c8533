"""Device time of a traced sub-window, from torch.profiler's trace.

The sub-window is marked by one `phylobench:window` annotation; every
device event inside it (kernels, copies, sets) counts as busy time,
merged where events overlap.  Idle gaps are named by the most specific
host event that covers their middle.  Nothing is read on the CPU: a run
whose trace holds no device event reports no device number.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "phylobench:window"
TOP = 10
NAME = 160          # characters of a kernel's name kept


class DeviceTrace:
    def __init__(self, chips: int = 1):
        self.chips = chips
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.summary: Optional[dict] = None

    @contextlib.contextmanager
    def window(self):
        """Trace the body; the caller ends it on a step boundary."""
        self.prof.__enter__()
        try:
            with torch.profiler.record_function(WINDOW):
                yield
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        finally:
            self.prof.__exit__(None, None, None)
        self.summary = summarize(self.prof.profiler.kineto_results.events(),
                                 self.chips)


def _merge(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def summarize(events, chips: int = 1) -> dict:
    """busy_s (the mean over `chips` cards), window_s, device_ops (count,
    all cards), breakdown (op times summed over the cards; idle gaps
    where no card runs anything) of one trace."""
    win = None
    host: List[Tuple[int, int, str]] = []
    dev: List[Tuple[int, int, str]] = []
    card: List[int] = []
    for ev in events:
        s, e, name = ev.start_ns(), ev.end_ns(), ev.name()
        on_device = ev.device_type() == torch.autograd.DeviceType.CUDA
        if on_device:
            # The device timeline mirrors host annotations; they are not
            # work on the device.
            if not (ev.is_user_annotation() or name.startswith("phylobench:")):
                dev.append((s, e, name))
                card.append(ev.device_index())
        elif name == WINDOW:
            win = (s, e)
        else:
            host.append((s, e, name))
    if win is None:
        return {"busy_s": 0.0, "window_s": 0.0, "device_ops": 0,
                "breakdown": None}
    w0, w1 = win
    kept = [(max(s, w0), min(e, w1), n, c) for (s, e, n), c in zip(dev, card)
            if e > w0 and s < w1]
    dev = [(s, e, n) for s, e, n, _ in kept]
    busy_ns = sum(e - s for c in set(card) for s, e in
                  _merge([(s, e) for s, e, _, cc in kept if cc == c]))
    busy = _merge([(s, e) for s, e, _ in dev])
    by_name: Dict[str, int] = {}
    for s, e, n in dev:
        n = n[:NAME]
        by_name[n] = by_name.get(n, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    edges = [w0] + [x for se in busy for x in se] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:TOP]
    idle = []
    for length, start in gaps:
        mid = start + length // 2
        cover = [(e - s, n) for s, e, n in host if s <= mid <= e]
        idle.append([min(cover)[1][:NAME] if cover else "untraced host",
                     length / 1e9])
    return {"busy_s": busy_ns / 1e9 / chips, "window_s": (w1 - w0) / 1e9,
            "device_ops": len(dev),
            "breakdown": {"device_ops": [[n, t / 1e9] for n, t in ops],
                          "idle_gaps": idle} if dev else None}
