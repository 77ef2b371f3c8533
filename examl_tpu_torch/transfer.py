"""Carry parameters and engine state into the port from plain arrays.

`state_from_numpy` turns an engine's state, given as numpy arrays (the
fields of the model stack, the tip codes and indicator table, the block
->partition map and the pattern weights), into the port's tensors on a
device.  `install_model_params` loads per-partition model parameters
into a `PhyloInstance`, either as complete `ModelParams` field sets
(eigensystems carried exactly), as (rates, freqs, alpha) triples that
the port's own `build_model` turns into models (empirical protein
matrices included), or as LG4 sets (name, alpha, four category rates,
four weights).  `install_psr_state`
loads a PSR instance's per-site rate state (patrat, rate categories,
category rates).  With these, two implementations can be held on exactly
the same numbers; the tree travels as a Newick string with lengths.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Mapping, Sequence, Tuple, Union

import numpy as np
import torch

from examl_tpu_torch.models.gtr import ModelParams, build_model
from examl_tpu_torch.models.lg4 import LG4Params, build_lg4
from examl_tpu_torch.ops.kernels import DeviceModels, TipState, tip_state

MODEL_FIELDS = ("eign", "ev", "ei", "freqs", "gamma_rates", "rate_weights",
                "part_branch")


def state_from_numpy(arrays: Mapping[str, np.ndarray], device,
                     dtype: torch.dtype = torch.float64
                     ) -> Tuple[DeviceModels, TipState, torch.Tensor,
                                torch.Tensor]:
    """(DeviceModels, TipState, block_part, weights) on `device`.

    `arrays` holds the DeviceModels fields by name plus `codes`
    [ntips, B, lane], `table` [C, K], `block_part` [B] and `weights`
    [B, lane]."""
    def f(name):
        return torch.as_tensor(np.array(arrays[name]), dtype=dtype,
                               device=device)

    models = DeviceModels(
        **{k: f(k) for k in MODEL_FIELDS[:-1]},
        part_branch=torch.as_tensor(np.asarray(arrays["part_branch"],
                                               np.int64), device=device))
    tips = tip_state(torch.as_tensor(np.array(arrays["codes"], np.uint8),
                                     device=device), f("table"))
    block_part = torch.as_tensor(np.asarray(arrays["block_part"], np.int64),
                                 device=device)
    return models, tips, block_part, f("weights")


ParamSet = Union[ModelParams, LG4Params, Mapping[str, object],
                 Tuple[Sequence[float], Sequence[float], float]]


def lg4_from_params(params: Mapping[str, object],
                    use_median: bool = False) -> LG4Params:
    """An LG4 model from its name, alpha, four category rates and four
    category weights (`{"lg4": "LG4M" | "LG4X", "alpha": a, "gamma_rates":
    [4], "rate_weights": [4]}`, the checkpoint's LG4 section): the
    matrices come from the port's own protein data."""
    m = build_lg4(str(params["lg4"]), alpha=float(params["alpha"]),
                  use_median=use_median)
    return replace(m, gamma_rates=np.array(params["gamma_rates"],
                                           dtype=np.float64),
                   rate_weights=np.array(params["rate_weights"],
                                         dtype=np.float64))


def model_from_params(params: ParamSet, datatype, ncat: int = 4,
                      use_median: bool = False):
    """A port model from a ModelParams or LG4Params, a field mapping (an
    LG4 mapping as `lg4_from_params` takes it) or a (rates, freqs, alpha)
    triple (rates None keeps the all-ones GTR exchangeabilities; an
    empirical protein matrix travels as its rates and frequencies)."""
    if isinstance(params, (ModelParams, LG4Params)):
        return params
    if isinstance(params, Mapping):
        if params.get("lg4"):
            return lg4_from_params(params, use_median)
        fields = {k: (np.array(v, dtype=np.float64)
                      if isinstance(v, (np.ndarray, list, tuple)) else v)
                  for k, v in params.items()}
        return ModelParams(**fields)
    rates, freqs, alpha = params
    freqs = np.asarray(freqs, dtype=np.float64)
    return build_model(datatype, freqs / freqs.sum(),
                       rates=None if rates is None else np.asarray(rates),
                       alpha=1.0 if alpha is None else float(alpha),
                       ncat=ncat, use_median=use_median)


def install_model_params(inst, params: Sequence[ParamSet]) -> None:
    """Overwrite every partition's model of `inst` and push them."""
    if len(params) != inst.num_parts:
        raise ValueError(f"{len(params)} parameter sets for "
                         f"{inst.num_parts} partitions")
    for gid, (part, ps) in enumerate(zip(inst.alignment.partitions, params)):
        inst.models[gid] = model_from_params(ps, part.datatype, inst.ncat,
                                             inst.use_median)
    inst.push_models()


def install_psr_state(inst, patrat: Sequence[np.ndarray],
                      rate_category: Sequence[np.ndarray],
                      per_site_rates: Sequence[np.ndarray]) -> None:
    """Overwrite the per-site rate state of a PSR `inst`, one array per
    partition each (patrat [W] float, rate_category [W] int, category
    rates [ncat] float), and push the categorized rates."""
    if not inst.psr:
        raise ValueError("the instance was not built with rate_model='PSR'")
    for name, arrs in (("patrat", patrat), ("rate_category", rate_category),
                       ("per_site_rates", per_site_rates)):
        if len(arrs) != inst.num_parts:
            raise ValueError(f"{len(arrs)} {name} arrays for "
                             f"{inst.num_parts} partitions")
    for gid, part in enumerate(inst.alignment.partitions):
        cat = np.array(rate_category[gid], dtype=np.int32)
        rates = np.array(per_site_rates[gid], dtype=np.float64)
        pr = np.array(patrat[gid], dtype=np.float64)
        # The rate state is global, also on a rank that read only its
        # own columns.
        W = part.global_width if part.global_width is not None \
            else part.width
        if cat.shape != (W,) or pr.shape != (W,):
            raise ValueError(f"partition {gid} has {W} patterns")
        if cat.size and not 0 <= cat.min() <= cat.max() < rates.size:
            raise ValueError(f"partition {gid}: categories out of range")
        inst.patrat[gid] = pr
        inst.rate_category[gid] = cat
        inst.per_site_rates[gid] = rates
    inst.push_site_rates()
