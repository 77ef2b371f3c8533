"""The port's package boundary: importing every module of examl_tpu_torch
pulls in neither JAX nor any module of examl_tpu, and leaves TF32 off."""

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
                 "examl_tpu_torch.fleet.seeds",
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
