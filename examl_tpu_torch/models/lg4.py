"""LG4M / LG4X: four amino-acid matrices, one per rate category.

Reference: `makeP_FlexLG4` (`newviewGenericSpecial.c:170-206`), the LG4
kernel variants, `optLG4X` + `optimizeWeights` + `scaleLG4X_EIGN`
(`optimizeModel.c:342-460, 1114-1132`), matrices from `initProtMat`
(`models.c`, LG4M/LG4X cases).  LG4M ties the four category rates to a
discrete gamma (alpha optimized as usual); LG4X frees both the four rates
and the four category weights, keeping the weighted mean rate at 1.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List

import numpy as np

from examl_tpu_torch.models import protein as protein_mod
from examl_tpu_torch.models.gamma import gamma_category_rates
from examl_tpu_torch.models.gtr import (eigen_gtr, sanitize_freqs,
                                        sanitize_rates)

LG4X_RATE_MIN = 1.0e-5      # reference optimizeModel.c LG4X_RATE_MIN/MAX
LG4X_RATE_MAX = 10.0


@dataclass(frozen=True)
class LG4Params:
    """Per-partition LG4 model: one eigensystem per rate category.

    Duck-type compatible with ModelParams where the optimizer and engine
    need it (ncat, alpha, gamma_rates); `rates`/`freqs` expose the
    category-0 values for generic reporting.
    """
    name: str                     # "LG4M" | "LG4X"
    states: int
    rates_list: tuple             # 4 x [190] exchangeabilities
    freqs_list: tuple             # 4 x [20]
    alpha: float
    gamma_rates: np.ndarray       # [4] category rates
    rate_weights: np.ndarray      # [4] category weights (sum 1)
    eign_list: tuple              # 4 x [20]
    ev_list: tuple                # 4 x [20, 20]
    ei_list: tuple                # 4 x [20, 20]
    use_median: bool = False

    @property
    def ncat(self) -> int:
        return len(self.gamma_rates)

    @property
    def rates(self) -> np.ndarray:
        return self.rates_list[0]

    @property
    def freqs(self) -> np.ndarray:
        return self.freqs_list[0]

    @property
    def is_lg4x(self) -> bool:
        return self.name == "LG4X"


def _eigens(rates_list, freqs_list):
    eigns, evs, eis = [], [], []
    for r, f in zip(rates_list, freqs_list):
        e, ev, ei = eigen_gtr(sanitize_rates(r), sanitize_freqs(f))
        eigns.append(e)
        evs.append(ev)
        eis.append(ei)
    return tuple(eigns), tuple(evs), tuple(eis)


def normalize_lg4x(gamma_rates: np.ndarray,
                   rate_weights: np.ndarray) -> np.ndarray:
    """Scale the free rates so the weighted mean rate is 1 (the role of
    the reference's `scaleLG4X_EIGN`)."""
    mean = float(rate_weights @ gamma_rates)
    return gamma_rates / mean


def build_lg4(name: str, alpha: float = 1.0,
              use_median: bool = False) -> LG4Params:
    rates_list, freqs_list = protein_mod.get_lg4(name)
    eigns, evs, eis = _eigens(rates_list, freqs_list)
    weights = np.full(4, 0.25)
    grates = gamma_category_rates(alpha, 4, use_median)
    if name.upper() == "LG4X":
        grates = normalize_lg4x(grates, weights)
    return LG4Params(
        name=name.upper(), states=20,
        rates_list=tuple(np.asarray(r) for r in rates_list),
        freqs_list=tuple(np.asarray(f) for f in freqs_list),
        alpha=alpha, gamma_rates=grates, rate_weights=weights,
        eign_list=eigns, ev_list=evs, ei_list=eis, use_median=use_median)


def lg4_with_alpha(m: LG4Params, alpha: float) -> LG4Params:
    """LG4M: category rates from the discrete gamma (reference ties LG4M
    to alpha like any GAMMA model)."""
    grates = gamma_category_rates(alpha, m.ncat, m.use_median)
    if m.is_lg4x:
        grates = normalize_lg4x(grates, m.rate_weights)
    return replace(m, alpha=float(alpha), gamma_rates=grates)


def lg4x_with_rates(m: LG4Params, rates: np.ndarray) -> LG4Params:
    rates = np.clip(np.asarray(rates, dtype=np.float64),
                    LG4X_RATE_MIN, LG4X_RATE_MAX)
    return replace(m, gamma_rates=normalize_lg4x(rates, m.rate_weights))


def lg4x_with_weights(m: LG4Params, weights: np.ndarray) -> LG4Params:
    weights = np.maximum(np.asarray(weights, dtype=np.float64), 1e-6)
    weights = weights / weights.sum()
    return replace(m, rate_weights=weights,
                   gamma_rates=normalize_lg4x(m.gamma_rates, weights))
