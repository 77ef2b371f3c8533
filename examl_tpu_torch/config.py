"""Device, dtype and precision configuration of the port.

Importing this module pins IEEE float32 for cuBLAS and cuDNN: TF32 keeps a
10-bit mantissa, far outside the lnL budget (NUMERICS.md measured even
3-pass bf16 at 0.94 lnL on testData/140).
"""

from __future__ import annotations

import torch

from examl_tpu_torch.constants import CLV_STORAGE_NAMES

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another.  Asking for `cuda` without a card raises; nothing falls back
    to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def default_dtype(device: torch.device) -> torch.dtype:
    """Compute dtype: float64 on the CPU (reference-grade parity), float32
    on the card (the main path; root sums and NR derivatives still
    accumulate in float64)."""
    return torch.float64 if torch.device(device).type == "cpu" \
        else torch.float32


def scale_exponent(dtype: torch.dtype) -> int:
    """Rescale exponent E (threshold 2^-E, multiplier 2^E) of a compute
    dtype: 256 for float64 as the reference, 32 for float32, on every
    device.  bfloat16 CLV storage keeps its compute dtype's E (bfloat16 has
    float32's exponent range)."""
    return 256 if dtype == torch.float64 else 32


def clv_storage_dtype(compute: torch.dtype, requested=None) -> torch.dtype:
    """The dtype CLV arenas and SEV pools are stored in: the compute dtype
    for None / "same", bfloat16 for "bf16" / "bfloat16" / torch.bfloat16
    with float32 compute (the JAX package's EXAML_CLV_DTYPE=bf16,
    `examl_tpu/ops/engine.py:159-175`: compute stays float32, reads
    upcast after the load and writes round to nearest even after the
    rescale).  A bfloat16 request with any other compute dtype raises:
    unlike the JAX package, which ignores its environment switch there,
    the port's switch is an explicit argument."""
    if requested is None or requested == "same" or requested == compute:
        return compute
    if requested in ("bf16", "bfloat16", torch.bfloat16):
        if compute != torch.float32:
            raise ValueError(f"bfloat16 CLV storage needs float32 compute, "
                             f"not {compute}")
        return torch.bfloat16
    raise ValueError(f"CLV storage {requested!r}: expected one of "
                     f"{CLV_STORAGE_NAMES} or torch.bfloat16")
