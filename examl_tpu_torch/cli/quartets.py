"""Quartet evaluation mode (-f q) entry point.

Reference: `examl/quartets.c` (`computeQuartets` :349-616).  The evaluator
lives in examl_tpu_torch.search.quartets; this module adapts the CLI's
arguments (the port of `examl_tpu/cli/quartets.py`).
"""

from __future__ import annotations


def run_quartets(args, inst, files) -> int:
    from examl_tpu_torch.cli.main import checkpoint_manager
    from examl_tpu_torch.search.quartets import (QuartetOptions,
                                                 compute_quartets)

    mgr = checkpoint_manager(args, files)
    resume = None
    if args.restart:
        tree = inst.random_tree(seed=args.seed)     # overwritten by restore
        resume = mgr.restore(inst, tree)
        if resume is None or resume["state"] != "QUARTETS":
            files.info("no quartet checkpoint found; cannot restart")
            return 1
    else:
        if not args.tree_file:
            files.info("quartet mode requires a model/full tree via -t")
            return 1
        with open(args.tree_file) as f:
            tree = inst.tree_from_newick(f.read())
    opts = QuartetOptions(
        grouping_file=args.quartet_file,
        random_samples=args.quartet_samples,
        seed=args.seed,
        epsilon=args.epsilon,
        checkpoint_interval=args.quartet_ckpt_interval,
        checkpoint_mgr=mgr,
        resume=resume)
    out = files.quartets_path
    n = compute_quartets(inst, tree, opts, out if files.primary else None,
                         log=files.info)
    files.info(f"{n} quartets written to {out}")
    return 0
