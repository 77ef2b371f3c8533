"""Vectorized 1-D bracketing + Brent minimization over parameter groups.

The TPU-shaped equivalent of the reference's `brakGeneric`/`brentGeneric`
(ExaML `optimizeModel.c:582-1114`): instead of masking converged linkage
groups out of a replicated scalar loop, all groups' trial parameters advance
together as vectors and every objective call evaluates the whole batch at
once (one device dispatch per Brent step for all partitions).

The objective `fn(x[G]) -> f[G]` must accept a full vector; frozen groups'
entries are simply ignored.  Minimization; callers pass f = -lnL.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

from examl_tpu_torch.constants import (BRAK_GOLD as GOLD, BRENT_ITMAX,
                                       BRENT_ZEPS as ZEPS)

CGOLD = 0.3819660               # golden-section fallback ratio
BRAK_MAXITER = 50


def _clamp(x, lo, hi):
    return np.minimum(np.maximum(x, lo), hi)


def bracket(x0: np.ndarray, lim_inf: np.ndarray, lim_sup: np.ndarray,
            fn: Callable[[np.ndarray], np.ndarray]):
    """Find per-group (a, b, c) with f(b) <= min(f(a), f(c)), clamped.

    Starts from (x0+0.1, x0-0.1) like the reference's optParamGeneric
    (`optimizeModel.c:1385-1407`) and expands downhill by golden steps.
    Groups whose minimum runs into a bound get a degenerate bracket at the
    bound (Brent then stays there).
    """
    a = _clamp(x0 + 0.1, lim_inf, lim_sup)
    b = _clamp(x0 - 0.1, lim_inf, lim_sup)
    # Degenerate start (x0 at/outside a bound clamps both probes together):
    # nudge b inward so the bracket search has a direction.
    degenerate = a == b
    b = np.where(degenerate, _clamp(b + 0.2, lim_inf, lim_sup), b)
    b = np.where(a == b, _clamp(a - 0.2, lim_inf, lim_sup), b)
    fa = fn(a)
    fb = fn(b)
    # Ensure downhill direction a -> b.
    swap = fb > fa
    a2 = np.where(swap, b, a)
    fa2 = np.where(swap, fb, fa)
    b = np.where(swap, a, b)
    fb = np.where(swap, fa, fb)
    a, fa = a2, fa2

    c = _clamp(b + GOLD * (b - a), lim_inf, lim_sup)
    fc = fn(c)
    done = fb <= fc
    for _ in range(BRAK_MAXITER):
        if done.all():
            break
        # Golden expansion past c for still-descending groups.
        u = _clamp(c + GOLD * (c - b), lim_inf, lim_sup)
        stuck = (u == c)                    # hit the bound
        fu = fn(u)
        a = np.where(done, a, b)
        fa = np.where(done, fa, fb)
        b = np.where(done, b, c)
        fb = np.where(done, fb, fc)
        c = np.where(done, c, u)
        fc = np.where(done, fc, fu)
        done = done | (fb <= fc) | stuck
    return a, b, c, fb


def brent(a: np.ndarray, b: np.ndarray, c: np.ndarray, fb: np.ndarray,
          tol: float, fn: Callable[[np.ndarray], np.ndarray]
          ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized Brent line minimization inside brackets (a, b, c)."""
    lo = np.minimum(a, c)
    hi = np.maximum(a, c)
    x = w = v = b.copy()
    fx = fw = fv = fb.copy()
    d = np.zeros_like(x)
    e = np.zeros_like(x)
    done = np.zeros(x.shape, dtype=bool)

    for _ in range(BRENT_ITMAX):
        xm = 0.5 * (lo + hi)
        tol1 = tol * np.abs(x) + ZEPS
        tol2 = 2.0 * tol1
        done = done | (np.abs(x - xm) <= tol2 - 0.5 * (hi - lo))
        if done.all():
            break
        # Parabolic fit through (x, fx), (w, fw), (v, fv).
        r = (x - w) * (fx - fv)
        q = (x - v) * (fx - fw)
        p = (x - v) * q - (x - w) * r
        q2 = 2.0 * (q - r)
        p = np.where(q2 > 0, -p, p)
        q2 = np.abs(q2)
        use_para = ((np.abs(p) < np.abs(0.5 * q2 * e))
                    & (p > q2 * (lo - x)) & (p < q2 * (hi - x)))
        with np.errstate(divide="ignore", invalid="ignore"):
            d_para = np.where(q2 != 0, p / np.where(q2 == 0, 1.0, q2), 0.0)
        e_gold = np.where(x >= xm, lo - x, hi - x)
        d_gold = CGOLD * e_gold
        e = np.where(use_para, d, e_gold)
        d = np.where(use_para, d_para, d_gold)
        u = np.where(np.abs(d) >= tol1, x + d,
                     x + np.where(d >= 0, tol1, -tol1))
        u = _clamp(u, lo, hi)
        fu = fn(np.where(done, x, u))
        fu = np.where(done, fx, fu)

        better = fu <= fx
        # Update bracket bounds.
        lo = np.where(done, lo, np.where(better, np.where(u >= x, x, lo),
                                         np.where(u < x, u, lo)))
        hi = np.where(done, hi, np.where(better, np.where(u >= x, hi, x),
                                         np.where(u < x, hi, u)))
        # Shift (v, w, x) bookkeeping.
        shift_vw = better
        v = np.where(done, v, np.where(shift_vw, w, np.where(
            (fu <= fw) | (w == x), w, np.where((fu <= fv) | (v == x) | (v == w),
                                               u, v))))
        fv = np.where(done, fv, np.where(shift_vw, fw, np.where(
            (fu <= fw) | (w == x), fw,
            np.where((fu <= fv) | (v == x) | (v == w), fu, fv))))
        w = np.where(done, w, np.where(shift_vw, x,
                                       np.where((fu <= fw) | (w == x), u, w)))
        fw = np.where(done, fw, np.where(shift_vw, fx,
                                         np.where((fu <= fw) | (w == x), fu, fw)))
        x = np.where(done, x, np.where(better, u, x))
        fx = np.where(done, fx, np.where(better, fu, fx))
    return x, fx


def minimize_vector(x0: np.ndarray, lim_inf: np.ndarray, lim_sup: np.ndarray,
                    fn: Callable[[np.ndarray], np.ndarray],
                    tol: float) -> Tuple[np.ndarray, np.ndarray]:
    """bracket + brent; returns (x_best[G], f_best[G])."""
    a, b, c, fb = bracket(x0, lim_inf, lim_sup, fn)
    return brent(a, b, c, fb, tol, fn)
