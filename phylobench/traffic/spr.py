"""The `spr` kind: a closed loop of lazy SPR prunes
(`search.spr.rearrange_batched`), one slot a step, the topology restored
after each prune, so that every pass over the prune order does the same
work.

The prune order is the program's slot order (every tip, then every inner
node depth first), sampled by the mix's `every` and `offset` so that a
pass fits inside the window, with tips and inner nodes taken in turn so
that any run of steps holds both.  Work: the insertions of each prune's
radius window, counted on the benchmark's own tree.

After the window every timed step is walked: each radius window it had
to scan must have come back as one scored plan with exactly the window's
candidates, and no other plan may have come; then the reference judges a
sample of the scores against the lnL of each regrafted tree.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Tuple

import numpy as np

from phylobench.gen import rng_for
from phylobench.mixes import Driver, rel_gap
from phylobench.portmap import node_map


def prune_order(topo, every: int, offset: int) -> List[Tuple[int, int]]:
    """Every `every`-th slot of the slot order from `offset`, tips and
    inner nodes in turn."""
    picked = topo.slot_order()[offset::every]
    tips = [s for s in picked if topo.is_tip(s[0])]
    inner = [s for s in picked if not topo.is_tip(s[0])]
    out = []
    for i in range(max(len(tips), len(inner))):
        out += tips[i:i + 1] + inner[i:i + 1]
    return out


class SprDriver(Driver):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        from examl_tpu_torch.search import batchscan, spr
        inp = self.inputs
        self.spr = spr
        self.mintrav = int(self.mix["mintrav"])
        self.maxtrav = min(int(self.mix["maxtrav"]), inp.topo.ntips - 3)
        self.values = inp.probe(0)
        self.to_port, self.from_port = node_map(inp.topo, self.tree)
        order = prune_order(inp.topo, int(self.mix.get("every", 1)),
                            int(self.mix.get("offset", 0)))
        self.slots = [self._port_slot(u, y) for u, y in order]
        self.windows = [inp.topo.prune_windows(s, self.mintrav, self.maxtrav)
                        for s in order]
        self.order = order
        self.ctx = spr.SprContext(self.inst)
        self.plans: List[tuple] = []
        self._orig_run_plan = batchscan.run_plan
        self._batchscan = batchscan
        batchscan.run_plan = self._recorded

    def close(self) -> None:
        self._batchscan.run_plan = self._orig_run_plan

    def _port_slot(self, u: int, y: int):
        node = self.tree.nodep[self.to_port[u]]
        for slot in self.tree.slots(node.number):
            if slot.back.number == self.to_port[y]:
                return slot
        raise ValueError(f"no slot of {u} faces {y}")

    def _recorded(self, inst, tree, plan):
        lnls = self._orig_run_plan(inst, tree, plan)
        self.plans.append((self.steps, plan.s_num,
                           [(c.q_slot.number, c.q_slot.back.number)
                            for c in plan.candidates],
                           np.array(lnls, dtype=np.float64)))
        return lnls

    def start(self) -> None:
        """The models and one full traversal, as the search starts."""
        self._models(self.values)
        self.inst.evaluate(self.tree, full=True)
        self.ctx.start_lh = self.ctx.end_lh = self.inst.likelihood

    def _prune(self, i: int) -> int:
        j = i % len(self.slots)
        self.ctx.best_of_node = self.spr.UNLIKELY
        self.spans.run("prune", self.spr.rearrange_batched, self.inst,
                       self.tree, self.ctx, self.slots[j], self.mintrav,
                       self.maxtrav)
        return sum(len(w[2]) for w in self.windows[j])

    def warm(self) -> None:
        """The prune of the order with the largest scan region first (it
        sizes the region once), then the first few of the order."""
        big = max(range(len(self.windows)),
                  key=lambda j: max([w[3] for w in self.windows[j]],
                                    default=0))
        for j in [big] + list(range(int(self.mix["warm_steps"]))):
            self._prune(j)
        self.plans.clear()

    def step(self) -> int:
        n = self._prune(self.steps)
        self.steps += 1
        return n

    def _by_window(self) -> Tuple[int, list]:
        """Walk every timed step: (mismatched candidates, the scored
        windows as (x, s, candidates, scores)).  A window with no plan
        counts its every candidate, a plan of no window each of its own
        (at least one)."""
        recorded: Dict[int, list] = {}
        for step, s_num, cands, lnls in self.plans:
            recorded.setdefault(step, []).append((s_num, cands, lnls))
        mismatched = sum(max(1, len(p[1])) for st, ps in recorded.items()
                         if st >= self.steps for p in ps)
        judged = []
        for step in range(self.steps):
            j = step % len(self.order)
            u, y = self.order[j]
            got: Dict[tuple, list] = {}
            for s_num, cands, lnls in recorded.get(step, []):
                s = self.from_port[s_num]
                x = y if s == u else u
                cs, ls = got.setdefault((x, s), ([], []))
                cs += [(self.from_port[a], self.from_port[b])
                       for a, b in cands]
                ls += lnls.tolist()
            for x, s, edges, _ in self.windows[j]:
                cs, ls = got.pop((x, s), ([], []))
                want, have = Counter(edges), Counter(cs)
                mismatched += sum(((want - have) + (have - want)).values())
                if cs:
                    judged.append((x, s, cs, np.array(ls)))
            mismatched += sum(max(1, len(cs)) for cs, _ in got.values())
        return mismatched, judged

    def checks(self, device) -> List[tuple]:
        """The candidates of every timed step's windows against the
        benchmark's own (count of mismatches, exact), and a sample of
        the scores against the reference's lnL of each regrafted tree
        (infinite where no plan was scored at all)."""
        topo = self.inputs.topo
        mismatched, judged = self._by_window()
        rng = rng_for(self.inputs.seed, 41)
        ref = self.reference(device)
        eig = self.eigen(self.values)
        alpha = self.values["alpha"]
        worst = 0.0 if judged else float("inf")
        for pi in sorted(rng.choice(len(judged),
                                    min(len(judged),
                                        int(self.mix["check_plans"])),
                                    replace=False).tolist()):
            x, s, got, lnls = judged[pi]
            a, b = [c for c in topo.adj[x] if c != s]
            t_join = ref.best_join(eig, float(alpha[0]), a, b, x)
            k = min(len(got), int(self.mix["check_candidates"]))
            for ci in rng.choice(len(got), k, replace=False).tolist():
                v, p = got[ci]
                # The lazy rule: both halves get sqrt(z), z = exp(-t),
                # inside ExaML's zmin and zmax.
                t_ins = -np.log(np.clip(np.sqrt(np.exp(-topo.t(v, p))),
                                        1e-15, 1 - 1e-6))
                tree = topo.regrafted(x, s, v, p, t_join, float(t_ins))
                want = float(ref.partition_lnl(eig, alpha, tree).sum())
                worst = max(worst, rel_gap(float(lnls[ci]), want))
        return [("plan_mismatches", float(mismatched)),
                ("lnl_rel_gap", worst)]


DRIVER = SprDriver
