"""The `probe` kind: a closed loop of Brent probes, one in flight.

Each probe gives every partition the next gamma shape of a sequence
drawn from the seed (and, under GTR, five exchangeabilities), pushes the
models and runs one full-traversal `evaluate`: the calls the program's
model optimisation makes per probe.  Work: site-CLV updates, counted on
the benchmark's own tree.  The reference judges every partition's lnL
of a sample of the window's probes (the last among them).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from phylobench import work
from phylobench.gen import rng_for
from phylobench.mixes import Driver, rel_gap


class ProbeDriver(Driver):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        inp = self.inputs
        self.step_work = work.clv_updates(inp.topo, inp.patterns, self.R,
                                          self.K)
        entries, tips = work.full_traversal_counts(inp.topo)
        item = torch.empty((), dtype=self.inst.storage_dtype).element_size()
        self.step_least_s = work.least_seconds(
            work.traversal_bytes(entries, tips, inp.patterns, self.R, self.K,
                                 item),
            work.traversal_flops(entries, tips, inp.patterns, self.R,
                                 self.K), chips=self.inst.site_shards)
        self.answers: List[np.ndarray] = []

    def _probe(self, i: int, stream: int = 11) -> None:
        self.spans.run("push", self._models, self.inputs.probe(i, stream))
        self.spans.run("evaluate", self.inst.evaluate, self.tree, None, True)

    def warm(self) -> None:
        for i in range(int(self.mix["warm_steps"])):
            self._probe(i, stream=12)

    def step(self) -> int:
        self._probe(self.steps)
        self.answers.append(self.inst.per_partition_lnl.copy())
        self.steps += 1
        return self.step_work

    def checks(self, device) -> List[tuple]:
        """(name, value) of the numbers the reference judges."""
        n = len(self.answers)
        if not n:
            return [("lnl_rel_gap", float("inf")),
                    ("total_rel_gap", float("inf"))]
        rng = rng_for(self.inputs.seed, 21)
        k = min(n, int(self.mix["check_samples"]))
        picks = sorted(set(rng.choice(n, k, replace=False).tolist())
                       | {n - 1})
        ref = self.reference(device)
        worst = total = 0.0
        for i in picks:
            values = self.inputs.probe(i)
            want = ref.partition_lnl(self.eigen(values), values["alpha"])
            got = self.answers[i]
            worst = max(worst, float(np.max(np.abs(got - want)
                                             / np.abs(want))))
            total = max(total, rel_gap(float(got.sum()), float(want.sum())))
        return [("lnl_rel_gap", worst), ("total_rel_gap", total)]


DRIVER = ProbeDriver
