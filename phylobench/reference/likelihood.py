"""The plain reference: Felsenstein's pruning in float64, in plain torch.

It works out everything again from the benchmark's own inputs (tree,
codes, exchangeabilities, frequencies, gamma shapes): the mean-rate-1
generator and its eigensystem, the discrete gamma's category means
(Yang 1994), every transition applied through the eigenbasis, a rescale
of every inner node's vector by its largest entry, and the site sums at
an inner root.  It imports nothing of the program and runs in blocks of
patterns, so that it fits beside what the program leaves.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from phylobench.topo import Topology

# Bytes of one [block, R, K] float64 vector.
BLOCK_BYTES = 1 << 27


def gamma_means(alpha: float, ncat: int = 4) -> np.ndarray:
    """Mean rate of each of `ncat` equal-probability bins of a gamma of
    shape alpha and mean 1."""
    from scipy import stats
    edges = stats.gamma.ppf(np.arange(1, ncat) / ncat, alpha, scale=1 / alpha)
    cuts = np.concatenate([[0.0], edges, [np.inf]])
    # E[X; X < c] for X ~ Gamma(a, 1/a) is P(Y < c) for Y ~ Gamma(a+1, 1/a).
    upper = stats.gamma.cdf(cuts, alpha + 1, scale=1 / alpha)
    return ncat * np.diff(upper)


@dataclass
class Eigen:
    freqs: np.ndarray       # [K]
    lam: np.ndarray         # [K] eigenvalues of Q (<= 0)
    ev: np.ndarray          # [K, K] P(t) = ev diag(exp(lam t)) ei
    ei: np.ndarray


def eigensystem(exchange: np.ndarray, freqs: np.ndarray) -> Eigen:
    """Of the reversible generator Q_ij = R_ij pi_j, scaled to one
    substitution per unit time, through its symmetric form."""
    freqs = np.asarray(freqs, np.float64) / np.sum(freqs)
    Q = exchange * freqs[None, :]
    np.fill_diagonal(Q, 0.0)
    np.fill_diagonal(Q, -Q.sum(axis=1))
    Q /= -np.dot(freqs, np.diag(Q))
    d = np.sqrt(freqs)
    A = d[:, None] * Q / d[None, :]
    lam, U = np.linalg.eigh((A + A.T) / 2)
    return Eigen(freqs, lam, U / d[:, None], U.T * d[None, :])


def gtr_exchange(rates6: np.ndarray) -> np.ndarray:
    """Symmetric 4x4 exchangeabilities from AC AG AT CG CT GT."""
    R = np.zeros((4, 4))
    R[np.triu_indices(4, 1)] = rates6
    return R + R.T


class Pruner:
    """Site log-likelihoods of one block of patterns under one eigensystem
    and per-pattern gamma rates."""

    def __init__(self, topo: Topology, eig: Eigen, codes: torch.Tensor,
                 table: torch.Tensor, rates: torch.Tensor):
        """codes [taxa, S] the block's codes, table [codes, K] float64
        their 0/1 states; rates [S, R] each pattern's category rates (its
        partition's)."""
        dev = codes.device
        self.topo = topo
        self.codes = codes
        self.table = table
        self.rates = rates
        self.lam = torch.as_tensor(eig.lam, device=dev)
        self.ev_t = torch.as_tensor(eig.ev.T.copy(), device=dev)
        self.ei_t = torch.as_tensor(eig.ei.T.copy(), device=dev)
        self.freqs = torch.as_tensor(eig.freqs, device=dev)

    def propagate(self, vec: torch.Tensor, t: float) -> torch.Tensor:
        """P(t r) vec for every pattern and rate: [S, R|1, K] -> [S, R, K]."""
        u = vec @ self.ei_t
        decay = torch.exp(self.lam * (self.rates[:, :, None] * t))
        return (u * decay) @ self.ev_t

    def side(self, v: int, away: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(vector [S, R|1, K], log scale [S]) of v's side away from
        `away`."""
        topo = self.topo
        held: Dict[int, torch.Tensor] = {}
        scale = torch.zeros(self.codes.shape[1], dtype=torch.float64,
                            device=self.codes.device)
        for u, par in topo.side_postorder(v, away):
            if topo.is_tip(u):
                held[u] = self.table[self.codes[u]][:, None, :]
                continue
            vec = None
            for c in topo.adj[u]:
                if c == par:
                    continue
                m = self.propagate(held.pop(c), topo.t(c, u))
                vec = m if vec is None else vec * m
            top = vec.amax(dim=(1, 2))
            vec /= top[:, None, None]
            scale += torch.log(top)
            held[u] = vec
        return held[v], scale

    def site_lnl(self, root: Optional[int] = None) -> torch.Tensor:
        """Log-likelihood of every pattern, the tree rooted at an inner
        node."""
        topo = self.topo
        root = topo.adj[0][0] if root is None else root
        vec, scale = None, 0.0
        for c in topo.adj[root]:
            side, sc = self.side(c, root)
            m = self.propagate(side, topo.t(c, root))
            vec = m if vec is None else vec * m
            scale = scale + sc
        lik = (vec * self.freqs).sum(-1).mean(-1)
        return torch.log(lik) + scale

    def join_terms(self, a: int, b: int, x: int):
        """The pieces of lnL(t) for a branch t joining a and b, with x
        pruned between them: per pattern and rate, the two sides in the
        eigenbasis, and the sides' log scales."""
        va, sa = self.side(a, x)
        vb, sb = self.side(b, x)
        left = (va * self.freqs) @ self.ev_t.T            # [S, R|1, K]
        right = vb @ self.ei_t                            # [S, R|1, K]
        return left * right, sa + sb

    def join_lnl(self, terms, t: float) -> float:
        prod, scale = terms
        decay = torch.exp(self.lam * (self.rates[:, :, None] * t))
        lik = (prod * decay).sum(-1).mean(-1)
        return float((torch.log(lik) + scale).sum())


class Reference:
    """The pruning over the whole alignment, in blocks of patterns."""

    def __init__(self, topo: Topology, codes: np.ndarray,
                 widths: np.ndarray, table: np.ndarray, device,
                 ncat: int = 4):
        """codes [taxa, S] the alignment's codes, widths the partitions'
        pattern counts in order, table [codes, K] each code's 0/1
        states."""
        self.topo = topo
        self.device = torch.device(device)
        self.table = torch.as_tensor(table, dtype=torch.float64,
                                     device=self.device)
        self.K = table.shape[1]
        self.ncat = ncat
        self.part = np.repeat(np.arange(widths.size), widths)
        self.M = int(widths.size)
        block = max(1, BLOCK_BYTES // (8 * ncat * self.K))
        S = codes.shape[1]
        # The codes stay on the device as bytes, block by block.
        self.blocks = [
            (torch.as_tensor(codes[:, s0:s0 + block], device=self.device),
             torch.as_tensor(self.part[s0:s0 + block], device=self.device))
            for s0 in range(0, S, block)]

    def _pruners(self, topo, eig, cat_rates):
        rates_all = torch.as_tensor(cat_rates, dtype=torch.float64,
                                    device=self.device)
        for codes, part in self.blocks:
            yield Pruner(topo, eig, codes.long(), self.table,
                         rates_all[part]), part

    def partition_lnl(self, eig: Eigen, alphas: np.ndarray,
                      topo: Optional[Topology] = None) -> np.ndarray:
        """lnL of every partition [M] on `topo` (the instance's tree by
        default) under one eigensystem and each partition's gamma
        shape."""
        cat = np.stack([gamma_means(a, self.ncat) for a in alphas])
        out = torch.zeros(self.M, dtype=torch.float64, device=self.device)
        for pr, part in self._pruners(topo or self.topo, eig, cat):
            out.index_add_(0, part, pr.site_lnl())
        return out.cpu().numpy()

    def best_join(self, eig: Eigen, alpha: float, a: int, b: int, x: int,
                  lo: float = 1e-6, hi: float = 34.5) -> float:
        """The length t of a branch joining a and b, x pruned, that
        maximises lnL (one partition): a grid in log t, then golden
        sections."""
        cat = gamma_means(alpha, self.ncat)[None, :]
        terms = [(pr, pr.join_terms(a, b, x))
                 for pr, _ in self._pruners(self.topo, eig, cat)]

        def f(logt):
            return sum(pr.join_lnl(tm, float(np.exp(logt)))
                       for pr, tm in terms)

        grid = np.linspace(np.log(lo), np.log(hi), 48)
        vals = [f(g) for g in grid]
        i = int(np.argmax(vals))
        a_, b_ = grid[max(i - 1, 0)], grid[min(i + 1, len(grid) - 1)]
        g = (np.sqrt(5) - 1) / 2
        c, d = b_ - g * (b_ - a_), a_ + g * (b_ - a_)
        fc, fd = f(c), f(d)
        for _ in range(80):
            if fc > fd:
                b_, d, fd = d, c, fc
                c = b_ - g * (b_ - a_)
                fc = f(c)
            else:
                a_, c, fc = c, d, fd
                d = a_ + g * (b_ - a_)
                fd = f(d)
        return float(np.exp((a_ + b_) / 2))


def tip_table(datatype: str) -> np.ndarray:
    """[codes, K] 0/1 states of every code: DNA codes are bit masks
    (A=1, C=2, G=4, T=8, 15 = any); amino-acid codes 0..19 are the
    states in ARNDCQEGHILKMFPSTWYV order, 20 = D or N, 21 = E or Q,
    22 = any."""
    if datatype == "DNA":
        return np.array([[(c >> s) & 1 for s in range(4)]
                         for c in range(16)], dtype=np.float64)
    t = np.zeros((23, 20))
    t[np.arange(20), np.arange(20)] = 1.0
    order = "ARNDCQEGHILKMFPSTWYV"
    t[20, [order.index("D"), order.index("N")]] = 1.0
    t[21, [order.index("E"), order.index("Q")]] = 1.0
    t[22] = 1.0
    return t

