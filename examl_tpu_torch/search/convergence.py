"""Robinson-Foulds search-convergence criterion (the reference's -D flag).

Reference: bipartition extraction + dual-slot hash table + relative RF
(`bipartitionList.c`: `bitVectorInitravSpecial` :472-539, `insertHashRF`
:385-470, `convergenceCriterion` :541-592) driven from the SPR loops
(`searchAlgo.c:2160-2220, 2438-2495`).  Rank 0 computed the RF and
broadcast it; here the bipartition sets are tiny host state (the tree is
replicated on every host, as in the reference) so no collective is needed.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Optional

from examl_tpu_torch.search.snapshots import topology_key
from examl_tpu_torch.tree.topology import Tree

Key = FrozenSet[FrozenSet[int]]


def relative_rf(a: Key, b: Key, ntips: int) -> float:
    """Relative Robinson-Foulds distance between two bipartition sets:
    |symmetric difference| / (2 (n - 3)), as `convergenceCriterion`."""
    return len(a ^ b) / (2.0 * (ntips - 3))


class RfConvergence:
    """Callable convergence_cb for compute_big_rapid: per search phase,
    compare each cycle's tree against the previous cycle's; signal
    convergence when the relative RF drops to <= threshold (1%)."""

    def __init__(self, ntips: int, threshold: float = 0.01,
                 log=lambda msg: None):
        self.ntips = ntips
        self.threshold = threshold
        self.log = log
        self._prev: Dict[str, Optional[Key]] = {}
        self.last_rrf: Optional[float] = None

    def to_blob(self) -> dict:
        """JSON-serializable previous-cycle bipartition sets, persisted in
        checkpoints so a -D restart does not lose a cycle of convergence
        evidence (the reference re-parses its stored newick strings for
        this, `restartHashTable.c:279-357`)."""
        return {phase: sorted(sorted(b) for b in key)
                for phase, key in self._prev.items() if key is not None}

    def load_blob(self, blob: dict) -> None:
        self._prev = {phase: frozenset(frozenset(b) for b in bips)
                      for phase, bips in blob.items()}

    def __call__(self, tree: Tree, phase: str, iteration: int) -> bool:
        key = topology_key(tree)
        prev = self._prev.get(phase)
        self._prev[phase] = key
        if iteration <= 0 or prev is None:
            return False
        rrf = relative_rf(prev, key, self.ntips)
        self.last_rrf = rrf
        self.log(f"RF convergence {phase} cycle {iteration - 1}->{iteration}"
                 f" relative RF {rrf:.4f}")
        return rrf <= self.threshold
