"""Empirical amino-acid replacement models.

The 20-state counterparts of the reference's `initProtMat` tables (ExaML
`models.c:225-3066`): published exchangeability matrices + stationary
frequencies, stored as arrays in `_protein_data.npz` (generated by
`tools/extract_protein_matrices.py`).  Rates are upper-triangle row-major
over the ARNDCQEGHILKMFPSTWYV ordering, scaled so the maximum
exchangeability is 10.0 (reference AA_SCALE, `axml.h:143`).

LG4M/LG4X are sets of four matrices (one per gamma category); `get_lg4`
returns all four.  AUTO model selection lives in optimize/auto_protein.py.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import List, Tuple

import numpy as np

_DATA_PATH = os.path.join(os.path.dirname(__file__), "_protein_data.npz")

MATRICES = ["DAYHOFF", "DCMUT", "JTT", "MTREV", "WAG", "RTREV", "CPREV", "VT",
            "BLOSUM62", "MTMAM", "LG", "MTART", "MTZOA", "PMB", "HIVB", "HIVW",
            "JTTDCMUT", "FLU", "STMTREV"]
LG4_MODELS = ["LG4M", "LG4X"]

# Candidate set scanned by AUTO protein-model selection (reference
# `optimizeModel.c:2669-2900` tries all non-LG4, non-GTR matrices).
AUTO_CANDIDATES = MATRICES


@lru_cache(maxsize=1)
def _data():
    return np.load(_DATA_PATH)


def get_matrix(name: str) -> Tuple[np.ndarray, np.ndarray]:
    """(rates[190], freqs[20]) for an empirical model."""
    name = name.upper()
    if name in LG4_MODELS:
        raise ValueError(f"{name} is a 4-matrix model; use get_lg4()")
    if name not in MATRICES:
        raise ValueError(f"unknown protein model {name!r}")
    d = _data()
    return d[f"{name}_rates"].copy(), d[f"{name}_freqs"].copy()


def get_lg4(name: str) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """([rates[190]]*4, [freqs[20]]*4) for LG4M / LG4X."""
    name = name.upper()
    if name not in LG4_MODELS:
        raise ValueError(f"{name} is not an LG4 model")
    d = _data()
    return (list(d[f"{name}_rates"]), list(d[f"{name}_freqs"]))
