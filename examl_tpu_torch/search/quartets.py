"""Quartet likelihood evaluation (-f q mode).

The port of `examl_tpu/search/quartets.py`.  Reference: `examl/quartets.c`
— `groupingParser` :69-172, `nniSmooth` :176-211, `quartetLikelihood`
:217-279, `computeAllThreeQuartets` :283-323, `computeQuartets` :349-616.
The model is first optimized on a comprehensive tree; every chosen 4-taxon
set is then scored under its three topologies, each with 5-branch NNI
smoothing, writing "t1 t2 | t3 t4: lnL" rows.  The sequential scorer
builds each quartet tree in place inside the full tree structure, reusing
two inner nodes as the quartet's internal edge (the remaining nodes stay
dangling, exactly as the reference does); the batched scorer
(search/quartets_batch.py) scores JOB_CHUNK topologies at once without
the tree.

Supports the reference's three flavors: all quartets, random subsampling
(-r), and grouped quartets (-Y file with four parenthesized taxon sets),
with periodic checkpointing every `checkpoint_interval` quartets (the
QUARTETS state, in the JAX package's checkpoint format).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from itertools import combinations, product
from typing import List, Optional, Sequence

import numpy as np

from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.optimize.branch import tree_evaluate, update_branch
from examl_tpu_torch.optimize.model_opt import mod_opt
from examl_tpu_torch.search import quartets_batch
from examl_tpu_torch.search.snapshots import TreeSnapshot
from examl_tpu_torch.tree.topology import Node, Tree, hookup

NNI_SMOOTHINGS = quartets_batch.NNI_SMOOTHINGS


@dataclass
class QuartetOptions:
    grouping_file: Optional[str] = None
    random_samples: int = 0
    seed: int = 12345
    epsilon: float = 0.1
    checkpoint_interval: int = 10000
    checkpoint_mgr: Optional[object] = None   # search.checkpoint manager
    resume: Optional[dict] = None


def parse_grouping_file(path: str,
                        taxon_names: Sequence[str]) -> List[List[int]]:
    """Four disjoint parenthesized taxon-name groups, e.g.
    "(a,b,c),(d,e),(f,g),(h)" (reference `groupingParser`)."""
    with open(path) as f:
        text = f.read()
    groups_txt = re.findall(r"\(([^()]*)\)", text)
    if len(groups_txt) != 4:
        raise ValueError(f"{path}: expected exactly 4 groups, "
                         f"found {len(groups_txt)}")
    index = {n: i + 1 for i, n in enumerate(taxon_names)}
    groups: List[List[int]] = []
    seen = set()
    for g in groups_txt:
        nums = []
        for name in (x.strip() for x in g.split(",") if x.strip()):
            if name not in index:
                raise ValueError(f"{path}: unknown taxon {name!r}")
            if name in seen:
                raise ValueError(f"{path}: taxon {name!r} in two groups")
            seen.add(name)
            nums.append(index[name])
        if not nums:
            raise ValueError(f"{path}: empty group")
        groups.append(nums)
    return groups


def _nni_smooth(inst: PhyloInstance, tree: Tree, p: Node,
                maxtimes: int) -> None:
    """Iteratively optimize the 5 branches of the quartet rooted at the
    inner edge (p, p.back) (reference `nniSmooth`)."""
    inst.partition_converged[:] = False
    while maxtimes > 0:
        maxtimes -= 1
        inst.partition_smoothed[:] = True
        for s in (p, p.next, p.next.next, p.back.next, p.back.next.next):
            update_branch(inst, tree, s)
        if inst.partition_smoothed.all():
            break
    inst.partition_smoothed[:] = False
    inst.partition_converged[:] = False


def quartet_likelihood(inst: PhyloInstance, tree: Tree, q1: Node, q2: Node,
                       p1: Node, p2: Node, p3: Node, p4: Node) -> float:
    """lnL of ((p1,p2),(p3,p4)) after NNI smoothing
    (reference `quartetLikelihood`)."""
    z = tree.default_z()
    hookup(q1, q2, z)
    hookup(q1.next, p1, tree.default_z())
    hookup(q1.next.next, p2, tree.default_z())
    hookup(q2.next, p3, tree.default_z())
    hookup(q2.next.next, p4, tree.default_z())
    inst.new_view(tree, q1)
    inst.new_view(tree, q2)
    _nni_smooth(inst, tree, q1, NNI_SMOOTHINGS)
    return inst.evaluate(tree, q2.next.next)


def _three_topologies(inst, tree, q1, q2, t1, t2, t3, t4, out) -> None:
    p1, p2, p3, p4 = (tree.nodep[t] for t in (t1, t2, t3, t4))
    for (a, b, c, d) in ((p1, p2, p3, p4), (p1, p3, p2, p4),
                         (p1, p4, p2, p3)):
        lnl = quartet_likelihood(inst, tree, q1, q2, a, b, c, d)
        out.write(f"{a.number} {b.number} | {c.number} {d.number}: "
                  f"{lnl:f}\n")


def _quartet_sets(inst: PhyloInstance, opts: QuartetOptions):
    """Yield 4-taxon index sets for the chosen flavor."""
    n = inst.alignment.ntaxa
    if opts.grouping_file:
        groups = parse_grouping_file(opts.grouping_file,
                                     inst.alignment.taxon_names)
        yield from product(*groups)
        return
    total = n * (n - 1) * (n - 2) * (n - 3) // 24
    if opts.random_samples and opts.random_samples < total:
        fraction = opts.random_samples / total
        rng = np.random.default_rng(opts.seed)
        produced = 0
        # Bernoulli subsampling over repeated full sweeps until the target
        # count is reached (reference RANDOM_QUARTETS loop).
        while produced < opts.random_samples:
            for q in combinations(range(1, n + 1), 4):
                if produced >= opts.random_samples:
                    return
                if rng.random() < fraction:
                    produced += 1
                    yield q
        return
    yield from combinations(range(1, n + 1), 4)


def compute_quartets(inst: PhyloInstance, tree: Tree, opts: QuartetOptions,
                     out_path: Optional[str], log=lambda m: None) -> int:
    """Optimize the model on `tree`, then score quartets into out_path
    (None: score without writing, a site-parallel rank other than 0).
    Returns the number of quartet sets evaluated
    (reference `computeQuartets`)."""
    start_counter = 0
    if opts.resume is not None:
        blob = opts.resume
        start_counter = int(blob["extras"]["quartet_counter"])
        pos = int(blob["extras"]["file_position"])
        if out_path is not None:
            if not os.path.exists(out_path):
                raise ValueError(
                    f"quartet checkpoint found but its output file "
                    f"{out_path} is missing; the checkpoint records a "
                    "resume position in that file, so restart fresh "
                    "(without -R) instead")
            with open(out_path, "r+") as f:
                f.truncate(pos)
        log(f"resuming quartets at set {start_counter}")
    else:
        inst.evaluate(tree, full=True)
        tree_evaluate(inst, tree, 1.0)
        mod_opt(inst, tree, opts.epsilon)
        log(f"model optimized on full tree, lnL {inst.likelihood:.6f}")
        if out_path is not None:
            with open(out_path, "w") as f:
                f.write("Taxon names and indices:\n\n")
                for i, name in enumerate(inst.alignment.taxon_names):
                    f.write(f"{name} {i + 1}\n")
                f.write("\n\n")
    # Snapshot the pristine comprehensive tree NOW: during the loop the
    # tree is a quartet scaffold that an edge-list snapshot cannot capture.
    base_tree_dict = TreeSnapshot.capture(
        tree, inst.likelihood, with_key=False).to_dict()

    n = inst.alignment.ntaxa
    q1 = tree.nodep[n + 1]
    q2 = tree.nodep[n + 2]

    use_batch = quartets_batch.batch_eligible(inst)
    log("quartet scoring: "
        + ("batched (quartets x topologies per batch)"
           if use_batch else "sequential"))
    buf: List[tuple] = []

    counter = 0
    with open(out_path if out_path is not None else os.devnull, "a") as f:

        def flush() -> None:
            """Score and write buffered sets (row-identical to the
            sequential scorer, reference output format)."""
            if not buf:
                return
            jobs = [j for s in buf
                    for j in quartets_batch.three_topology_jobs(*s)]
            lnls = quartets_batch.score_jobs(inst, jobs)
            k = 0
            for s in buf:
                for a, b, c, d in quartets_batch.three_topology_jobs(*s):
                    f.write(f"{a} {b} | {c} {d}: {lnls[k]:f}\n")
                    k += 1
            buf.clear()

        for t1, t2, t3, t4 in _quartet_sets(inst, opts):
            if counter >= start_counter:
                if (opts.checkpoint_mgr is not None
                        and counter != start_counter
                        and counter % opts.checkpoint_interval == 0):
                    flush()
                    f.flush()
                    opts.checkpoint_mgr.write(
                        "QUARTETS",
                        {"quartet_counter": counter,
                         "file_position": f.tell(),
                         "seed": opts.seed},
                        inst, tree, tree_dict=base_tree_dict)
                if use_batch:
                    buf.append((t1, t2, t3, t4))
                    if 3 * len(buf) >= quartets_batch.JOB_CHUNK:
                        flush()
                else:
                    _three_topologies(inst, tree, q1, q2, t1, t2, t3, t4,
                                      f)
            counter += 1
        flush()
    return counter
