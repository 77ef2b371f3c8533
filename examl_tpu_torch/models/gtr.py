"""General time-reversible substitution models and their eigendecomposition.

Role of reference `initReversibleGTR`/`initGeneric` (ExaML
`models.c:3234-3587`): build the GTR generator Q from exchangeability rates
and stationary frequencies, normalize to mean rate 1 ("fracchange"), and
eigendecompose via the similarity transform
    A = D^{1/2} Q D^{-1/2}   (D = diag(freqs)),
which is symmetric for reversible Q, so `numpy.linalg.eigh` applies.
Transition matrices are then P(t) = EV diag(exp(-EIGN * t)) EI with
EV = D^{-1/2} U, EI = U^T D^{1/2}, EIGN the negated eigenvalues.

Branch lengths use the z = exp(-t) parameterization of the reference, so
P(z, r) = EV diag(exp(EIGN * r * log z)) EI for a rate multiplier r.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from examl_tpu_torch import obs
from examl_tpu_torch.constants import FREQ_MIN, RATE_MAX, RATE_MIN
from examl_tpu_torch.datatypes import DataType
from examl_tpu_torch.models.gamma import gamma_category_rates


@dataclass(frozen=True)
class ModelParams:
    """Per-partition model parameters (host copy; device gets stacked arrays)."""
    states: int
    rates: np.ndarray         # [states*(states-1)/2] exchangeabilities, last fixed 1.0
    freqs: np.ndarray         # [states] stationary frequencies
    alpha: float              # gamma shape
    gamma_rates: np.ndarray   # [ncat] category rate multipliers
    eign: np.ndarray          # [states] negated eigenvalues, eign[0] = 0
    ev: np.ndarray            # [states, states] right eigenvectors (columns)
    ei: np.ndarray            # [states, states] left eigenvectors (rows)
    use_median: bool = False

    @property
    def ncat(self) -> int:
        return len(self.gamma_rates)


def n_exchange(states: int) -> int:
    return states * (states - 1) // 2


def rates_to_matrix(rates: np.ndarray, states: int) -> np.ndarray:
    """Symmetric exchangeability matrix R with zero diagonal."""
    R = np.zeros((states, states))
    iu = np.triu_indices(states, 1)
    R[iu] = rates
    return R + R.T


def sanitize_freqs(freqs: np.ndarray) -> np.ndarray:
    """Clamp to FREQ_MIN and renormalize.  Applied ONCE when parameters are
    installed into a ModelParams so the eigendecomposition and the kernels
    (site likelihoods, sumtables) always see the same distribution."""
    freqs = np.maximum(np.asarray(freqs, dtype=np.float64), FREQ_MIN)
    return freqs / freqs.sum()


def sanitize_rates(rates: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(rates, dtype=np.float64), RATE_MIN, RATE_MAX)


def eigen_gtr(rates: np.ndarray, freqs: np.ndarray):
    """Returns (eign, EV, EI) of the mean-rate-1 reversible generator.

    eign >= 0 are the negated eigenvalues sorted so eign[0] = 0.
    Inputs are assumed sanitized (see sanitize_freqs/sanitize_rates).
    """
    states = len(freqs)
    freqs = sanitize_freqs(freqs)
    rates = sanitize_rates(rates)
    R = rates_to_matrix(rates, states)
    Q = R * freqs[None, :]
    np.fill_diagonal(Q, 0.0)
    np.fill_diagonal(Q, -Q.sum(axis=1))
    fracchange = float(freqs @ R @ freqs)    # mean substitution rate of Q
    Q = Q / fracchange

    sq = np.sqrt(freqs)
    A = (sq[:, None] * Q) / sq[None, :]      # symmetric similarity transform
    w, U = np.linalg.eigh((A + A.T) / 2.0)
    # eigh returns ascending eigenvalues; the zero eigenvalue is the largest.
    order = np.argsort(-w)
    w = w[order]
    U = U[:, order]
    eign = -w
    eign[0] = 0.0
    EV = U / sq[:, None]                      # right eigenvectors as columns
    EI = U.T * sq[None, :]                    # left eigenvectors as rows
    # Fix the stationary eigenvector sign/scale: EV[:,0] = 1, EI[0,:] = freqs.
    scale = EV[:, 0].mean()
    EV[:, 0] /= scale
    EI[0, :] *= scale
    return eign, EV, EI


def build_model(dt: DataType, freqs: np.ndarray,
                rates: np.ndarray | None = None,
                alpha: float = 1.0, ncat: int = 4,
                use_median: bool = False) -> ModelParams:
    states = dt.states
    if rates is None:
        rates = np.ones(n_exchange(states))
    rates = sanitize_rates(rates)
    freqs = sanitize_freqs(freqs)
    eign, ev, ei = eigen_gtr(rates, freqs)
    grates = gamma_category_rates(alpha, ncat, use_median)
    return ModelParams(states=states, rates=rates, freqs=freqs, alpha=alpha,
                       gamma_rates=grates, eign=eign, ev=ev, ei=ei,
                       use_median=use_median)


def with_rates(m: ModelParams, rates: np.ndarray) -> ModelParams:
    with obs.span("models:eigen"):
        rates = sanitize_rates(rates)
        eign, ev, ei = eigen_gtr(rates, m.freqs)
        return replace(m, rates=rates, eign=eign, ev=ev, ei=ei)


def with_freqs(m: ModelParams, freqs: np.ndarray) -> ModelParams:
    with obs.span("models:eigen"):
        freqs = sanitize_freqs(freqs)
        eign, ev, ei = eigen_gtr(m.rates, freqs)
        return replace(m, freqs=freqs, eign=eign, ev=ev, ei=ei)


def with_alpha(m: ModelParams, alpha: float) -> ModelParams:
    with obs.span("models:gamma_rates"):
        return replace(m, alpha=float(alpha),
                       gamma_rates=gamma_category_rates(alpha, m.ncat,
                                                        m.use_median))


def transition_matrix(m: ModelParams, t: float, rate: float = 1.0) -> np.ndarray:
    """Dense P(t) for testing: rows sum to 1."""
    return (m.ev * np.exp(-m.eign * rate * t)) @ m.ei
