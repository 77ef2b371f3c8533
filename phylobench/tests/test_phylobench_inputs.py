"""The generators reproduce from the seed and give the stated sizes."""

import numpy as np
import pytest

from conftest import tiny
from phylobench import gen, run


@pytest.mark.parametrize("config", ["dna_birds48", "aa_kite144"])
def test_inputs_reproduce_from_the_seed(config):
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    cfg = run.config_of(bench, config)
    cfg.update(taxa=12, patterns=1500, partitions=min(cfg["partitions"], 9))
    seed = 2 ** 40 + 17                     # wider than 32 bits
    a = gen.make_inputs(cfg, seed, "cpu")
    b = gen.make_inputs(cfg, seed, "cpu")
    c = gen.make_inputs(cfg, seed + 1, "cpu")
    assert np.array_equal(a.codes, b.codes)
    assert a.topo.length == b.topo.length
    assert np.array_equal(a.widths, b.widths)
    assert not np.array_equal(a.codes, c.codes)
    assert a.topo.length != c.topo.length
    # One shape for every seed, and the same set of gene widths.
    assert a.topo.adj == c.topo.adj
    assert sorted(a.widths) == sorted(c.widths)
    assert a.codes.shape == (12, 1500) and a.codes.dtype == np.uint8
    assert int(a.widths.sum()) == 1500 and a.partitions == cfg["partitions"]
    assert a.topo.num_nodes == 2 * 12 - 2
    assert len(a.topo.edges()) == 2 * 12 - 3
    gap = gen.DNA_GAP if config == "dna_birds48" else gen.AA_GAP
    assert 0.005 < float(np.mean(a.codes == gap)) < 0.05
    p = a.probe(3)
    assert np.array_equal(p["alpha"], b.probe(3)["alpha"])
    lo, hi = cfg["probe_alpha"]
    assert np.all((p["alpha"] >= lo) & (p["alpha"] <= hi))


def test_stated_sizes_of_the_cells():
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    birds = run.config_of(bench, "dna_birds48")
    kite = run.config_of(bench, "aa_kite144")
    assert birds["patterns"] * birds["published"]["cards"] == \
        birds["published"]["patterns"]
    assert (kite["taxa"], kite["partitions"]) == (144, 739)
    w = gen.gene_widths(kite["patterns"], kite["partitions"],
                        gen.rng_for(kite["shape_seed"], 1), 20)
    assert int(w.sum()) == kite["patterns"] and int(w.min()) >= 20


def test_tiny_cut_keeps_every_other_key():
    cfg = tiny("birds48.probe")
    assert cfg["model"] == "GTR" and cfg["taxa"] == 9
