"""Tree-evaluation entry point, the `-f e` / `-f E` mode of the reference
`examl` binary (`axml.c`: `get_args` :935-1302, `makeFileNames`
:1316-1357, `optimizeTrees` :2251-2356).

    python -m examl_tpu_torch.cli.main -s aln.binary -t trees -n RUN \\
        [-w DIR] [-f e|E] [-m GAMMA] [-M] [--newview chunk|whole]

For each tree of the `-t` file: evaluate, smooth the branch lengths, then
optimize the model (`mod_opt`); with `-f e` the trees after the first
only re-smooth their branch lengths.  Outputs in DIR: ExaML_info.RUN
(progress), ExaML_log.RUN ("seconds lnL" per tree), ExaML_TreeFile.RUN
(one newick per tree) and ExaML_modelFile.RUN (the final model, in the
reference's `printModelParams` layout).

`--newview` selects the full-traversal tier: `chunk` (kernel B1) or
`whole` (kernel B2, one launch per traversal).  `main` runs on the card
unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time
from typing import List

from examl_tpu_torch.constants import ZMAX, ZMIN
from examl_tpu_torch.ops.engine import NEWVIEW_TIERS

# State letters of the model file's "rate X <-> Y" and "freq pi(X)" lines.
_STATE_LETTERS = {"DNA": "ACGT", "AA": "ARNDCQEGHILKMFPSTWYV", "BIN": "01"}


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="examl_tpu_torch.cli.main",
        description="maximum-likelihood tree evaluation on the GPU")
    ap.add_argument("-s", dest="bytefile", required=True,
                    help="binary alignment file (byteFile)")
    ap.add_argument("-n", dest="run_id", required=True, help="run name")
    ap.add_argument("-t", dest="tree_file", required=True,
                    help="trees to evaluate (newick, one or more)")
    ap.add_argument("-m", dest="model", default="GAMMA", choices=["GAMMA"],
                    help="rate heterogeneity model")
    ap.add_argument("-f", dest="mode", default="e", choices=["e", "E"],
                    help="e: optimize the model on the first tree only; "
                         "E: optimize the model on every tree")
    ap.add_argument("-M", dest="per_partition_bl", action="store_true",
                    help="estimate per-partition branch lengths")
    ap.add_argument("-w", dest="workdir", default=".",
                    help="output directory")
    ap.add_argument("--newview", default="chunk", choices=NEWVIEW_TIERS,
                    help="full-traversal tier: chunk (kernel B1) or whole "
                         "(kernel B2)")
    return ap


class RunFiles:
    """Output files (reference `makeFileNames`/`printBothOpen`)."""

    def __init__(self, workdir: str, run_id: str):
        os.makedirs(workdir, exist_ok=True)
        pre = os.path.join(workdir, "ExaML_")
        self.info_path = f"{pre}info.{run_id}"
        self.log_path = f"{pre}log.{run_id}"
        self.model_path = f"{pre}modelFile.{run_id}"
        self.treefile_path = f"{pre}TreeFile.{run_id}"
        self.start_time = time.time()
        for p in (self.info_path, self.log_path):
            open(p, "w").close()

    def info(self, msg: str) -> None:
        print(msg)
        with open(self.info_path, "a") as f:
            f.write(msg + "\n")

    def log_lnl(self, lnl: float) -> None:
        with open(self.log_path, "a") as f:
            f.write(f"{time.time() - self.start_time:.6f} {lnl:.6f}\n")


def tree_length(tree, slot: int) -> float:
    """Sum of branch lengths -log z of one branch slot (the model rates
    are normalized to mean 1, so -log z is substitutions per site)."""
    return sum(-math.log(min(max(p.z[slot], ZMIN), ZMAX))
               for p, _ in tree.all_branches())


def write_model_params(path: str, inst, tree) -> None:
    """Final model parameters in the reference's layout
    (`printModelParams`, `axml.c:1733-1835`)."""
    with open(path, "w") as f:
        for gid, (part, m) in enumerate(
                zip(inst.alignment.partitions, inst.models)):
            name = part.datatype.name
            letters = _STATE_LETTERS[name]
            slot = gid if inst.per_partition_branches else 0
            f.write(f"\n\nModel Parameters of Partition {gid}, Name: "
                    f"{part.name}, Type of Data: {name}\n")
            f.write(f"alpha: {m.alpha:.6f}\n")
            f.write(f"Tree-Length: {tree_length(tree, slot):.6f}\n")
            pairs = [(a, b) for a in range(m.states)
                     for b in range(a + 1, m.states)]
            for (a, b), r in zip(pairs, m.rates):
                f.write(f"rate {letters[a]} <-> {letters[b]}: {r:.6f}\n")
            f.write("\n")
            for s, x in enumerate(m.freqs):
                f.write(f"freq pi({letters[s]}): {x:.6f}\n")
            f.write("\n")


def _read_trees(path: str) -> List[str]:
    with open(path) as f:
        text = f.read()
    return [t.strip() + ";" for t in text.split(";") if t.strip()]


def run_tree_evaluation(args, inst, files: RunFiles) -> int:
    """-f e / -f E: optimize model+branches on each tree in the file
    (reference `optimizeTrees`, `axml.c:2251-2356`)."""
    from examl_tpu_torch.optimize.branch import tree_evaluate
    from examl_tpu_torch.optimize.model_opt import mod_opt

    trees_txt = _read_trees(args.tree_file)
    if not trees_txt:
        files.info(f"no trees found in {args.tree_file}")
        return 1
    files.info(f"Found {len(trees_txt)} trees to evaluate")
    fast = args.mode == "e"
    results = []
    lnls = []
    for i, text in enumerate(trees_txt):
        tree = inst.tree_from_newick(text)
        inst.evaluate(tree, full=True)
        if fast and i > 0:
            tree_evaluate(inst, tree, 2.0)
        else:
            tree_evaluate(inst, tree, 1.0)
            mod_opt(inst, tree, 0.1)
        files.info(f"Likelihood tree {i}: {inst.likelihood:.6f}")
        files.log_lnl(inst.likelihood)
        results.append(tree.to_newick(inst.alignment.taxon_names))
        lnls.append(inst.likelihood)
    best = max(range(len(lnls)), key=lambda i: lnls[i])
    files.info(f"Evaluated {len(lnls)} trees; best is tree {best} "
               f"with likelihood {lnls[best]:.6f}")
    with open(files.treefile_path, "w") as f:
        f.write("\n".join(results) + "\n")
    write_model_params(files.model_path, inst, tree)
    return 0


def main(argv=None, device=None) -> int:
    """Run tree evaluation; `device` defaults to the card ("cuda")."""
    args = build_argparser().parse_args(argv)
    from examl_tpu_torch.instance import PhyloInstance
    from examl_tpu_torch.io.bytefile import read_bytefile

    files = RunFiles(args.workdir, args.run_id)
    files.info(f"alignment: {args.bytefile}  mode: -f {args.mode}  "
               f"model: {args.model}  newview: {args.newview}")
    try:
        data = read_bytefile(args.bytefile)
    except ValueError as exc:
        files.info(f"ERROR: {exc}")
        return 1
    files.info(f"{data.ntaxa} taxa, {data.total_patterns} patterns, "
               f"{len(data.partitions)} partitions")
    inst = PhyloInstance(data, device=device,
                         per_partition_branches=args.per_partition_bl,
                         newview=args.newview)
    files.info(f"device: {inst.device}  dtype: {inst.dtype}")
    return run_tree_evaluation(args, inst, files)


if __name__ == "__main__":
    sys.exit(main())
