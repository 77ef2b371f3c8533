"""Discrete-gamma rate heterogeneity (Yang 1994).

Role of reference `makeGammaCats` (ExaML `models.c:3795-3850`): k equal-
probability categories of a Gamma(alpha, beta=alpha) distribution (mean 1),
category rate = mean (default) or median of its quantile bin.  Computed with
scipy's regularized incomplete-gamma functions instead of the reference's
hand-rolled PointChi2/IncompleteGamma routines.  The quantiles are
`gammaincinv(a, q) * (1 / a)`, which is what `scipy.stats.gamma.ppf(q, a,
scale=1/a)` computes, bit for bit, without importing `scipy.stats` (about
three seconds of every process start, a supervised restart's included).
"""

from __future__ import annotations

import numpy as np
from scipy.special import gammainc, gammaincinv


def gamma_category_rates(alpha: float, k: int = 4,
                         use_median: bool = False) -> np.ndarray:
    """[k] category rates, each category with probability 1/k, mean rate 1."""
    alpha = float(alpha)
    if use_median:
        # Median of each quantile bin, rescaled to mean 1 (Yang 1994 eq. 9).
        quantiles = (2.0 * np.arange(k) + 1.0) / (2.0 * k)
        rates = gammaincinv(alpha, quantiles) * (1.0 / alpha)
        rates = rates * k / rates.sum()
        return rates
    # Mean of each bin: with X ~ Gamma(a, scale 1/a), the partial expectation
    # E[X; X<=b] = F_{a+1}(b) where F is the CDF of Gamma(a+1, scale 1/a)
    # scaled by mean 1, so bin mean = k * (F_{a+1}(b_hi) - F_{a+1}(b_lo)).
    bounds = gammaincinv(alpha, np.arange(1, k) / k) * (1.0 / alpha)
    upper = np.concatenate([bounds * alpha, [np.inf]])   # in Gamma(a,1) units
    lower = np.concatenate([[0.0], bounds * alpha])
    partial = gammainc(alpha + 1.0, upper) - gammainc(alpha + 1.0, lower)
    return k * partial
