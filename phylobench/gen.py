"""Inputs from the seed: the tree, the model, the alignment, the probes.

Everything a run feeds the program and the reference is made here, from
`--seed` and the configuration file alone.  The alignment is simulated
along the seed's tree on the device in a few large calls (a
`torch.Generator` on that device), then copied to the host once as the
program's input; the same seed on the same kind of device gives the
same inputs.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np
import torch

from phylobench.topo import Topology

HERE = Path(__file__).resolve().parent
DNA_STATES, AA_STATES = 4, 20
DNA_GAP, AA_GAP = 15, 22            # the all-states codes of each alphabet


def seed_words(seed: int) -> List[int]:
    """A seed of any size as 32-bit words (numpy's SeedSequence input)."""
    seed = abs(int(seed))
    words = []
    while True:
        words.append(seed & 0xFFFFFFFF)
        seed >>= 32
        if not seed:
            return words


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(seed_words(seed) + list(stream))


def lg_matrix():
    """(exchangeabilities [20, 20], frequencies [20]) of the frozen LG
    copy, from its PAML lower triangle."""
    d = json.loads((HERE / "reference" / "lg.json").read_text())
    R = np.zeros((AA_STATES, AA_STATES))
    rows = d["lower_triangle"]
    for i, row in enumerate(rows, start=1):
        R[i, :i] = row
    return R + R.T, np.asarray(d["freqs"], dtype=np.float64)


@dataclass
class Inputs:
    config: dict
    seed: int
    topo: Topology
    names: List[str]
    codes: np.ndarray           # [taxa, patterns] uint8, the program's codes
    widths: np.ndarray          # [partitions] patterns of each partition
    states: int
    freqs: np.ndarray           # [states] one frequency vector for all
    exchange: np.ndarray        # [states, states] LG, or the seed's GTR start

    @property
    def patterns(self) -> int:
        return int(self.codes.shape[1])

    @property
    def partitions(self) -> int:
        return int(self.widths.size)

    @property
    def free_rates(self) -> bool:
        """GTR partitions have free exchangeabilities; LG's are fixed."""
        return self.config["model"] == "GTR"

    def probe(self, i: int, stream: int = 11) -> dict:
        """Probe i's model values, inside Brent's bounds: a gamma shape
        for every partition and, under GTR, five free exchangeabilities
        (the sixth pinned at 1).  Warm-up probes draw from a stream of
        their own."""
        rng = rng_for(self.seed, stream, i)
        lo, hi = self.config["probe_alpha"]
        out = {"alpha": np.exp(rng.uniform(np.log(lo), np.log(hi),
                                           self.partitions))}
        if self.free_rates:
            lo, hi = self.config["probe_rates"]
            r = np.exp(rng.uniform(np.log(lo), np.log(hi),
                                   (self.partitions, 6)))
            r[:, 5] = 1.0
            out["rates"] = r
        return out


def gene_widths(total: int, parts: int, rng: np.random.Generator,
                least: int) -> np.ndarray:
    """`parts` widths of at least `least` that sum to `total`, spread as
    gene lengths are (log-normal)."""
    if parts == 1:
        return np.array([total], dtype=np.int64)
    w = rng.lognormal(0.0, 0.6, parts)
    w = least + np.floor(w / w.sum() * (total - least * parts)).astype(
        np.int64)
    w[np.argsort(-w)[: total - int(w.sum())]] += 1
    return w


def simulate(topo: Topology, states: int, freqs: np.ndarray, patterns: int,
             gap_share: float, site_alpha: float, gen: torch.Generator,
             device) -> torch.Tensor:
    """States [taxa, patterns] (int64, -1 for a gap) evolved along the
    tree from a root drawn from `freqs`: on each edge a site is redrawn
    from `freqs` with probability 1 - exp(-t * rate), its rate drawn
    once from a gamma of shape `site_alpha` and mean 1."""
    cdf = torch.as_tensor(np.cumsum(freqs), dtype=torch.float64,
                          device=device)
    cdf[-1] = 1.0

    def draw(n):
        u = torch.rand(n, generator=gen, dtype=torch.float64, device=device)
        return torch.searchsorted(cdf, u).clamp_(max=states - 1)

    shape = torch.full((patterns,), float(site_alpha), dtype=torch.float64,
                       device=device)
    # torch's gamma sampler takes no generator: rates come from normals
    # and uniforms of the seeded one (Marsaglia and Tsang, a >= 1 after
    # the usual boost for a < 1).
    rate = _gamma(shape, gen) / site_alpha
    root = topo.adj[0][0]
    seq = {root: draw(patterns)}
    order = list(reversed(topo.postorder(root)))        # parents first
    out = torch.empty((topo.ntips, patterns), dtype=torch.int64,
                      device=device)
    for v, par in order:
        p = 1.0 - torch.exp(-topo.t(v, par) * rate)
        u = torch.rand(patterns, generator=gen, dtype=torch.float64,
                       device=device)
        s = torch.where(u < p, draw(patterns), seq[par])
        if topo.is_tip(v):
            out[v] = s
        else:
            seq[v] = s
    gaps = torch.rand((topo.ntips, patterns), generator=gen,
                      dtype=torch.float64, device=device) < gap_share
    return out.masked_fill_(gaps, -1)


def _gamma(shape: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    a = shape
    boost = a < 1.0
    d = torch.where(boost, a + 1.0, a) - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros_like(a)
    todo = torch.ones_like(a, dtype=torch.bool)
    while bool(todo.any()):
        x = torch.randn(a.shape, generator=gen, dtype=a.dtype,
                        device=a.device)
        u = torch.rand(a.shape, generator=gen, dtype=a.dtype,
                       device=a.device)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u.clamp_min(1e-300))
                        < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp_min(1e-300)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    u = torch.rand(a.shape, generator=gen, dtype=a.dtype, device=a.device)
    return torch.where(boost, out * u.clamp_min(1e-300) ** (1.0 / a), out)


def make_inputs(config: dict, seed: int, device) -> Inputs:
    """The run's inputs from the seed (sizes as the configuration gives
    them; tests pass a configuration cut to a tiny size).  The tree's
    shape and the genes' widths come from the configuration's
    `shape_seed`, so that every seed does the same work; the seed draws
    the branch lengths, the order of the genes, the frequencies, the
    data and the probes."""
    rng = rng_for(seed, 1)
    shape = rng_for(int(config["shape_seed"]), 1)
    n = int(config["taxa"])
    topo = Topology.random(n, shape, rng, float(config["mean_branch_length"]))
    if config["datatype"] == "DNA":
        states = DNA_STATES
        freqs = rng.dirichlet(np.full(DNA_STATES, 5.0))
        exchange = None
    else:
        states = AA_STATES
        exchange, freqs = lg_matrix()
    widths = rng.permutation(gene_widths(
        int(config["patterns"]), int(config["partitions"]), shape,
        int(config.get("least_gene_width", 1))))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(2 ** 63)))
    sim = simulate(topo, states, freqs, int(config["patterns"]),
                   float(config["gap_share"]), float(config["sim_alpha"]),
                   gen, device)
    if states == DNA_STATES:
        bits = torch.tensor([1, 2, 4, 8], device=sim.device)
        codes = torch.where(sim < 0, DNA_GAP, bits[sim.clamp_min(0)])
    else:
        codes = torch.where(sim < 0, AA_GAP, sim)
    codes = codes.to(torch.uint8).cpu().numpy()
    del sim
    return Inputs(config=config, seed=seed, topo=topo,
                  names=[f"t{i}" for i in range(n)], codes=codes,
                  widths=widths, states=states, freqs=freqs,
                  exchange=exchange)
