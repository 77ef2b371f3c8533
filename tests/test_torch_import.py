"""The port's package boundary: importing every module of examl_tpu_torch
pulls in neither JAX nor any module of examl_tpu, and leaves TF32 off; the
modules a supervising parent loads (the supervisor, the lease board, the
CLI's front and the extension bank its workers run) import no torch
either, and the instance no
`scipy.stats` (its discrete-gamma rates equal `scipy.stats`' bit for
bit)."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, json, pkgutil, sys
import examl_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(examl_tpu_torch.__path__,
                                              "examl_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import torch
print(json.dumps({
    "modules": mods,
    "leaked": sorted(k for k in sys.modules
                     if k == "jax" or k.startswith("jax.")
                     or k == "jaxlib" or k.startswith("jaxlib.")
                     or k == "examl_tpu" or k.startswith("examl_tpu.")),
    "tf32": [torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32],
}))
"""


def test_port_imports_no_jax_and_no_examl_tpu():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    for name in ("examl_tpu_torch.instance", "examl_tpu_torch.ops.engine",
                 "examl_tpu_torch.ops.newview_chunk",
                 "examl_tpu_torch.ops.newview_whole",
                 "examl_tpu_torch.ops.gradient",
                 "examl_tpu_torch.ops.bank",
                 "examl_tpu_torch.ops.export_bank",
                 "examl_tpu_torch.ops.sev",
                 "examl_tpu_torch.optimize.branch",
                 "examl_tpu_torch.optimize.brent",
                 "examl_tpu_torch.optimize.model_opt",
                 "examl_tpu_torch.optimize.psr",
                 "examl_tpu_torch.optimize.auto_protein",
                 "examl_tpu_torch.models.protein",
                 "examl_tpu_torch.models.lg4",
                 "examl_tpu_torch.cli.main",
                 "examl_tpu_torch.cli.fleet",
                 "examl_tpu_torch.fleet.batch",
                 "examl_tpu_torch.fleet.bootstrap",
                 "examl_tpu_torch.fleet.driver",
                 "examl_tpu_torch.fleet.jobs",
                 "examl_tpu_torch.fleet.quarantine",
                 "examl_tpu_torch.fleet.lease",
                 "examl_tpu_torch.fleet.seeds",
                 "examl_tpu_torch.resilience.supervisor",
                 "examl_tpu_torch.cli.parse",
                 "examl_tpu_torch.search.checkpoint",
                 "examl_tpu_torch.search.convergence",
                 "examl_tpu_torch.search.raxml_search",
                 "examl_tpu_torch.search.snapshots",
                 "examl_tpu_torch.search.spr",
                 "examl_tpu_torch.tree.constraint",
                 "examl_tpu_torch.transfer"):
        assert name in out["modules"]
    assert out["leaked"] == []
    assert out["tf32"] == [False, False]


# The supervisor's parent must never load torch (it would take the card
# its child needs), nor JAX or the JAX package.
TORCH_FREE = r"""
import json, sys
import examl_tpu_torch.cli.main
import examl_tpu_torch.resilience.supervisor
import examl_tpu_torch.fleet.lease
import examl_tpu_torch.ops.bank
import examl_tpu_torch.ops.export_bank
print(json.dumps(sorted(k for k in sys.modules
                        if k.split(".")[0] in ("torch", "jax", "jaxlib",
                                               "examl_tpu"))))
"""


def test_supervisor_lease_board_and_cli_front_import_no_torch():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", TORCH_FREE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_gamma_rates_need_no_scipy_stats():
    """The discrete-gamma rates are `scipy.stats.gamma`'s bit for bit, and
    the instance's import chain leaves `scipy.stats` out: importing it
    costs seconds of every process start, a supervised restart's
    included."""
    import numpy as np
    from scipy.special import gammainc
    from scipy.stats import gamma as gamma_dist
    from examl_tpu_torch.models.gamma import gamma_category_rates
    for alpha in np.geomspace(0.02, 1000.0, 300):
        for k in (4, 25):
            q = (2.0 * np.arange(k) + 1.0) / (2.0 * k)
            med = gamma_dist.ppf(q, a=alpha, scale=1.0 / alpha)
            assert np.array_equal(gamma_category_rates(alpha, k, True),
                                  med * k / med.sum())
            b = gamma_dist.ppf(np.arange(1, k) / k, a=alpha,
                               scale=1.0 / alpha)
            up = np.concatenate([b * alpha, [np.inf]])
            lo = np.concatenate([[0.0], b * alpha])
            assert np.array_equal(
                gamma_category_rates(alpha, k),
                k * (gammainc(alpha + 1.0, up) - gammainc(alpha + 1.0, lo)))
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c", "import sys, examl_tpu_torch.instance; "
         "print('scipy.stats' in sys.modules)"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "False"
