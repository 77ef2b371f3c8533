"""What every traffic mix shares.  A mix file (`traffic/<mix>.json`)
names its kind and its parameters; the kind's driver, found by name in
`traffic/<kind>.py` (its `DRIVER`), turns them into steps of the
program, records what the timed path answered and, after the window,
hands the reference a sample drawn from the seed to judge.  A new mix
of an existing kind is a data file; a new kind is a new driver file.
"""

from __future__ import annotations

import importlib.util
import time
from pathlib import Path
from typing import Callable, Dict, List

import torch

from phylobench.gen import Inputs
from phylobench.reference.likelihood import (Eigen, Reference, eigensystem,
                                             gtr_exchange, tip_table)

TRAFFIC = Path(__file__).resolve().parent / "traffic"


def load_kind(kind: str):
    """The driver class of a mix's `kind`, from `traffic/<kind>.py`."""
    spec = importlib.util.spec_from_file_location(
        "phylobench_kind_" + kind.replace(".", "_"), TRAFFIC / f"{kind}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.DRIVER


def sync(devices) -> None:
    for d in devices:
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


class Spans:
    """The benchmark's own host spans: seconds and counts by name."""

    def __init__(self, on: bool, devices):
        self.on = on
        self.devices = devices
        self.total: Dict[str, List[float]] = {}

    def run(self, name: str, fn: Callable, *args):
        if not self.on:
            return fn(*args)
        t = time.perf_counter()
        with torch.profiler.record_function("phylobench:" + name):
            out = fn(*args)
            sync(self.devices)
        acc = self.total.setdefault(name, [0.0, 0])
        acc[0] += time.perf_counter() - t
        acc[1] += 1
        return out


class Driver:
    """What every kind shares: the instance, its tree, the inputs."""

    def __init__(self, inputs: Inputs, inst, tree, mix: dict, spans: Spans):
        self.inputs = inputs
        self.inst = inst
        self.tree = tree
        self.mix = mix
        self.spans = spans
        self.steps = 0
        self.R = inst.ncat
        self.K = inputs.states

    def eigen(self, values: dict, gid: int = 0) -> Eigen:
        ex = (gtr_exchange(values["rates"][gid]) if "rates" in values
              else self.inputs.exchange)
        return eigensystem(ex, self.inputs.freqs)

    def reference(self, device) -> Reference:
        inp = self.inputs
        return Reference(inp.topo, inp.codes, inp.widths,
                         tip_table(inp.config["datatype"]), device,
                         ncat=self.R)

    def _models(self, values: dict) -> None:
        """Every partition's gamma shape (and GTR exchangeabilities) from
        `values`, the models pushed: a probe's model set-up."""
        from examl_tpu_torch.models.gtr import with_alpha, with_rates
        inst = self.inst
        for gid in range(inst.num_parts):
            m = with_alpha(inst.models[gid], values["alpha"][gid])
            if "rates" in values:
                m = with_rates(m, values["rates"][gid])
            inst.set_model(gid, m, push=False)
        inst.push_models()
