"""Numeric constants of the likelihood engine and search.

Values mirror the reference's tuning constants (ExaML `axml.h:89-193`) so the
search dynamics and numerics are comparable; they are plain published
algorithmic constants, not code.
"""

# Branch lengths are parameterized as z = exp(-t) with t in expected
# substitutions per site (rate matrices are normalized to mean rate 1).
ZMIN = 1.0e-15          # max branch length ~ -log(zmin) ≈ 34.5
ZMAX = 1.0 - 1.0e-6     # min branch length 1e-6
DEFAULTZ = 0.9          # starting value for fresh branches
DELTAZ = 0.00001        # convergence test on z in branch-length updates

SMOOTHINGS = 32         # max smoothing passes through the tree
NEWTON_MAX_ITERS = 30   # max Newton-Raphson iterations per branch (ref `maxiter`)

# CLV underflow rescaling: multiply by 2^256 when all entries drop below
# 2^-256, and track the exponent in an integer scaler per (node, site).
TWO_TO_THE_256 = 1.15792089237316195423570985008687907853e77
MINLIKELIHOOD = 1.0 / TWO_TO_THE_256
LOG_MINLIKELIHOOD = -177.445678223345993274                     # log(2^-256)

UNLIKELY = -1.0e300     # lnL initializer

LIKELIHOOD_EPSILON = 1.0e-7

# Model-parameter bounds.
ALPHA_MIN = 0.02
ALPHA_MAX = 1000.0
RATE_MIN = 1.0e-7
RATE_MAX = 1.0e6
FREQ_MIN = 0.001

# Brent / bracketing (standard Numerical-Recipes-style constants).
BRENT_ITMAX = 100
BRENT_ZEPS = 1.0e-5
BRAK_GOLD = 1.618034
BRAK_GLIMIT = 100.0
BRAK_TINY = 1.0e-20

# Search tuning.
MAX_LOCAL_SMOOTHING_ITERATIONS = 10   # ref `iterations`
DEFAULT_RATEGORIES = 25               # PSR/CAT default category count
TPU_LANE = 128                        # site-block lane width (VPU lane count)

# Full-traversal tiers the CLI's --newview names (kernel B1 or B2), the
# tier every traversal takes under -S, and the CLV storage choices of
# --clv-dtype.  They live here, away from torch, because the CLI's parser
# is also the supervisor's, and a supervising parent never imports torch.
NEWVIEW_TIERS = ("chunk", "whole")
POOLED_TIER = "pooled"          # every traversal under save_memory (-S)
CLV_STORAGE_NAMES = ("same", "bf16")
