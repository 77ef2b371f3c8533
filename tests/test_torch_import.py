"""The port's package boundary: importing every module of examl_tpu_torch
pulls in neither JAX nor any module of examl_tpu, and leaves TF32 off; the
modules a supervising parent loads (the supervisor, the lease board, the
CLI's front, parallel/launch.py, parallel/sharding.py and
parallel/shards.py, and the extension bank its workers run) import no
torch either (nor does the site shards' in-process group when it
reduces), and the instance no `scipy.stats` (its discrete-gamma rates
equal `scipy.stats`' bit for bit)."""

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
                 "examl_tpu_torch.fleet.shard",
                 "examl_tpu_torch.parallel.shards",
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


def test_parallel_launch_and_sharding_import_no_torch():
    """The CLI's parser takes the launch flags (--mesh, --single-device)
    from parallel/launch.py in a supervising parent too, and the bank
    stamps the declared fabric from parallel/sharding.py in its workers:
    neither loads torch at import, nor does parallel/shards.py."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c", "import json, sys; "
         "import examl_tpu_torch.parallel.launch, "
         "examl_tpu_torch.parallel.sharding, "
         "examl_tpu_torch.parallel.shards; print(json.dumps(sorted(k for "
         "k in sys.modules if k.split('.')[0] in ('torch', 'jax', "
         "'jaxlib', 'examl_tpu'))))"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


# Three site shards' groups on one board, each on a thread, reduce and
# gather without torch, JAX or the JAX package.
THREAD_GROUP = r"""
import json, sys, threading
import numpy as np
from examl_tpu_torch.parallel.sharding import ShardBoard, ThreadSiteGroup
board = ShardBoard(3, timeout=60)
groups = [ThreadSiteGroup(r, 3, board) for r in range(3)]
parts = [np.array([0.1, 1e16]) * (r + 1) + r for r in range(3)]
out = [None] * 3

def run(r):
    g = groups[r]
    out[r] = (g.allreduce(parts[r]).tolist(),
              g.allgather_blocks(np.full((1, 2), r)).tolist(),
              g.allmax(10 * r + 1), g.window(6), g.collectives)

ts = [threading.Thread(target=run, args=(r,)) for r in range(3)]
[t.start() for t in ts]
[t.join() for t in ts]
want = (parts[0] + parts[1] + parts[2]).tolist()
print(json.dumps({"out": out, "want": want, "leaked": sorted(
    k for k in sys.modules
    if k.split(".")[0] in ("torch", "jax", "jaxlib", "examl_tpu"))}))
"""


def test_thread_site_group_reduces_in_rank_order_without_torch():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", THREAD_GROUP], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["leaked"] == []
    for r, (total, blocks, mx, window, n) in enumerate(got["out"]):
        assert total == got["want"]           # the rank-ordered sum's bits
        assert blocks == [[0, 0], [1, 1], [2, 2]]
        assert (mx, window, n) == (21, [2 * r, 2 * r + 2], 3)


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
