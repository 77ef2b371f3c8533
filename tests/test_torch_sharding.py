"""The site axis over ranks, in one process: the port's per-rank byteFile
windows and packing against the JAX package's, and the pieces of a
site-parallel run that need no process group.

* `read_bytefile_slice` / `read_bytefile_for_process` give JAX's
  partitions array for array (ref49, and an amino-acid + binary file with
  two state buckets), for every rank of 2 and 3;
* `pack_partitions_local` gives JAX's local buckets for 2, 3 and 4 ranks;
* the windows tile the global packing, `window_of` cuts the same window
  out of it, and the ranks' reads are disjoint and sum to the alignment;
* `selective_read_decision` answers as JAX's on every input;
* an instance on a rank's window (from a sliced read or cut from the
  whole read) holds the window's tensors, and its full traversal writes
  the same arena rows as the one-process instance's over that window;
* a rank's PSR state spans the alignment (installed, pushed as the
  window's rates, and through a checkpoint's model section);
* `SINGLE` returns its inputs unchanged, and the launch flags that
  cannot form a group are refused before anything runs.
"""

import itertools
import types

import numpy as np
import pytest
import torch

from examl_tpu.cli.main import selective_read_decision as jdecision
from examl_tpu.io import bytefile as jbytefile
from examl_tpu.parallel import packing as jpacking
from examl_tpu_torch.cli.main import main, selective_read_decision
from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.io import bytefile
from examl_tpu_torch.io.bytefile import read_bytefile, write_bytefile
from examl_tpu_torch.parallel import launch, packing
from examl_tpu_torch.parallel.sharding import (SINGLE, SiteGroup,
                                               block_window)
from examl_tpu_torch.transfer import install_model_params
from tests.refmodel import parse_model_file
from tests.test_torch_protein import _data

REF49 = "tests/fixtures/ref49/"
PART_FIELDS = ("patterns", "weights", "empirical_freqs")
PART_SCALARS = ("name", "model_name", "use_empirical_freqs",
                "optimize_freqs", "lg4", "auto", "global_width",
                "global_col_offset", "global_weight_sum")
BUCKET_ARRAYS = ("tip_codes", "weights", "site_part", "block_part",
                 "part_offsets", "part_widths")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mixed_file(tmp_path_factory):
    """An amino-acid + binary byteFile: two state buckets."""
    path = str(tmp_path_factory.mktemp("mixed") / "mixed.binary")
    write_bytefile(path, _data(False, ntaxa=10, width=300))
    return path


def _files(mixed_file):
    return {"ref49": REF49 + "aln49.binary", "mixed": mixed_file}


def _same_partitions(tparts, jparts):
    assert len(tparts) == len(jparts)
    for tp, jp in zip(tparts, jparts):
        for f in PART_FIELDS:
            np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))
        for f in PART_SCALARS:
            assert getattr(tp, f) == getattr(jp, f), f
        assert tp.datatype.name == jp.datatype.name


def _same_buckets(tb, jb):
    assert sorted(tb) == sorted(jb)
    for s in tb:
        for f in BUCKET_ARRAYS:
            np.testing.assert_array_equal(getattr(tb[s], f),
                                          getattr(jb[s], f), err_msg=f)
        for f in ("part_ids", "block_offset", "global_blocks", "lane"):
            assert getattr(tb[s], f) == getattr(jb[s], f), f


@pytest.mark.parametrize("name,nprocs", [("ref49", 2), ("ref49", 3),
                                         ("mixed", 2), ("mixed", 3)])
def test_slice_reads_match_jax(mixed_file, name, nprocs):
    path = _files(mixed_file)[name]
    for procid in range(nprocs):
        _same_partitions(
            bytefile.read_bytefile_for_process(path, procid, nprocs)
            .partitions,
            jbytefile.read_bytefile_for_process(path, procid, nprocs)
            .partitions)
    meta = bytefile.read_bytefile_meta(path)
    cols = {g: (pm.width // 3, pm.width // 3 + 7)
            for g, pm in enumerate(meta.parts) if g % 2 == 0}
    _same_partitions(bytefile.read_bytefile_slice(path, cols).partitions,
                     jbytefile.read_bytefile_slice(path, cols).partitions)


@pytest.mark.parametrize("nprocs", [2, 3, 4])
def test_pack_local_matches_jax(mixed_file, nprocs):
    for path in _files(mixed_file).values():
        for procid in range(nprocs):
            t = packing.pack_partitions_local(
                bytefile.read_bytefile_for_process(path, procid, nprocs)
                .partitions, procid, nprocs, block_multiple=nprocs)
            j = jpacking.pack_partitions_local(
                jbytefile.read_bytefile_for_process(path, procid, nprocs)
                .partitions, procid, nprocs, block_multiple=nprocs)
            _same_buckets(t, j)


@pytest.mark.parametrize("nprocs", [2, 3, 4])
def test_windows_tile_global_packing(mixed_file, nprocs):
    for path in _files(mixed_file).values():
        whole = read_bytefile(path)
        glob = packing.pack_partitions(whole.partitions,
                                       block_multiple=nprocs)
        reads = [bytefile.read_bytefile_for_process(path, r, nprocs)
                 for r in range(nprocs)]
        wins = [packing.pack_partitions_local(d.partitions, r, nprocs,
                                              block_multiple=nprocs)
                for r, d in enumerate(reads)]
        # The ranks read every column exactly once, each rank a strict
        # subset of the alignment.
        for gid, part in enumerate(whole.partitions):
            got = np.concatenate([d.partitions[gid].patterns
                                  for d in reads], axis=1)
            np.testing.assert_array_equal(got, part.patterns)
        loaded = [d.total_patterns for d in reads]
        assert sum(loaded) == whole.total_patterns
        assert max(loaded) < whole.total_patterns
        for s, g in glob.items():
            for f in ("tip_codes", "weights", "site_part", "block_part"):
                axis = 1 if f == "tip_codes" else 0
                np.testing.assert_array_equal(
                    np.concatenate([getattr(w[s], f) for w in wins],
                                   axis=axis), getattr(g, f), err_msg=f)
            for r, w in enumerate(wins):
                assert w[s].local_num_blocks * nprocs == g.num_blocks
                _same_buckets({s: packing.window_of(g, r, nprocs)},
                              {s: w[s]})


@pytest.mark.parametrize("model,is_bf,auto,nprocs,sev", list(
    itertools.product(["GAMMA", "PSR"], [True, False], [True, False],
                      [1, 2, 4], [False, True])))
def test_selective_read_decision_matches_jax(model, is_bf, auto, nprocs,
                                             sev):
    assert selective_read_decision(model, is_bf, auto, nprocs, sev) == \
        jdecision(model, is_bf, auto, nprocs, save_memory=sev)


def _ref49(data, **kw):
    inst = PhyloInstance(data, dtype=torch.float64, device="cpu", **kw)
    install_model_params(inst, [(p.rates, p.freqs, p.alpha) for p in
                                parse_model_file(REF49 + "modelFile")])
    with open(REF49 + "TreeFile") as f:
        return inst, inst.tree_from_newick(f.read())


@pytest.mark.parametrize("sliced", [True, False])
def test_window_instance_writes_the_window_rows(sliced):
    """No collective runs while an instance is built or traverses, so a
    rank's instance needs no process group here: its engine holds the
    window's tensors, and a full traversal writes the one-process arena's
    rows over the window (the same per-site arithmetic)."""
    path = REF49 + "aln49.binary"
    one, tree1 = _ref49(read_bytefile(path), block_multiple=2)
    (eng1,) = one.engines.values()
    eng1.run_traversal(tree1.flat_full_traversal(tree1.centroid_branch()),
                       full=True)
    for rank in range(2):
        group = SiteGroup(rank, 2, process_group="unused")
        data = (bytefile.read_bytefile_for_process(path, rank, 2) if sliced
                else read_bytefile(path))
        inst, tree = _ref49(data, group=group,
                            local_window=(rank, 2) if sliced else None)
        (eng,) = inst.engines.values()
        b0, b1 = group.window(eng1.B)
        assert (eng.B, eng.bucket.block_offset) == (b1 - b0, b0)
        assert eng.clv.shape[1] == eng.scaler.shape[1] == b1 - b0
        np.testing.assert_array_equal(eng.weights.numpy(),
                                      eng1.weights[b0:b1].numpy())
        np.testing.assert_array_equal(eng.tips.codes.numpy(),
                                      eng1.tips.codes[:, b0:b1].numpy())
        eng.run_traversal(tree.flat_full_traversal(tree.centroid_branch()),
                          full=True)
        np.testing.assert_array_equal(eng.row_map, eng1.row_map)
        rows = torch.as_tensor(eng.row_map[inst.alignment.ntaxa + 1:])
        np.testing.assert_allclose(eng.clv[rows].numpy(),
                                   eng1.clv[rows, b0:b1].numpy(),
                                   rtol=1e-14, atol=0)
        np.testing.assert_array_equal(eng.scaler[rows].numpy(),
                                      eng1.scaler[rows, b0:b1].numpy())


def test_window_instance_refuses_a_foreign_window():
    data = bytefile.read_bytefile_for_process(REF49 + "aln49.binary", 0, 2)
    with pytest.raises(ValueError, match="not rank 1 of 2"):
        PhyloInstance(data, dtype=torch.float64, device="cpu",
                      local_window=(0, 2),
                      group=SiteGroup(1, 2, process_group="unused"))


def test_single_group_returns_its_inputs():
    a = np.arange(6.0).reshape(3, 2)
    assert SINGLE.allreduce(a) is a
    assert SINGLE.allgather_blocks(a) is a
    assert (SINGLE.rank, SINGLE.size, SINGLE.collectives) == (0, 1, 0)
    assert SINGLE.window(12) == (0, 12)
    assert [block_window(12, r, 3) for r in range(3)] == \
        [(0, 4), (4, 8), (8, 12)]
    with pytest.raises(ValueError, match="do not divide"):
        block_window(10, 0, 3)
    with pytest.raises(ValueError, match="needs a process group"):
        SiteGroup(0, 2)


@pytest.mark.parametrize("flags,msg", [
    (["--procid", "1"], "--procid requires --nprocs"),
    (["--nprocs", "2", "--procid", "0"], "needs --coordinator"),
    (["--nprocs", "2", "--coordinator", "127.0.0.1:1"], "needs --procid"),
    (["--nprocs", "2", "--procid", "2", "--coordinator", "127.0.0.1:1"],
     "outside"),
    (["--coordinator", "127.0.0.1:1"], "needs --nprocs")])
def test_launch_flags_refused(tmp_path, capsys, flags, msg):
    argv = ["-s", REF49 + "aln49.binary", "-n", "X", "-w", str(tmp_path),
            "-t", REF49 + "TreeFile", "-f", "e"] + flags
    with pytest.raises(SystemExit) as exc:
        main(argv, device="cpu")
    assert exc.value.code == 2
    assert msg in capsys.readouterr().err
    assert list(tmp_path.iterdir()) == []
    args = types.SimpleNamespace(coordinator=None, nprocs=None, procid=None)
    assert launch.init_distributed(args) is SINGLE
    assert launch.rank_device(3, "cpu") == torch.device("cpu")


def test_psr_state_is_global_on_a_window():
    """A rank's PSR state spans the alignment's sites: installed, pushed
    (the window's rates only) and carried through a checkpoint's model
    section."""
    from examl_tpu_torch.search.checkpoint import (_models_blob,
                                                   _restore_models)
    from examl_tpu_torch.transfer import install_psr_state
    path = REF49 + "aln49.binary"
    one = PhyloInstance(read_bytefile(path), dtype=torch.float64,
                        device="cpu", rate_model="PSR", block_multiple=2)
    rng = np.random.default_rng(2)
    cats = [rng.integers(0, 3, p.width) for p in one.alignment.partitions]
    rates = [rng.uniform(0.5, 2.0, 3) for _ in cats]
    state = ([r[c] for r, c in zip(rates, cats)], cats, rates)
    install_psr_state(one, *state)
    (eng1,) = one.engines.values()
    for rank in range(2):
        inst = PhyloInstance(
            bytefile.read_bytefile_for_process(path, rank, 2),
            dtype=torch.float64, device="cpu", rate_model="PSR",
            local_window=(rank, 2),
            group=SiteGroup(rank, 2, process_group="unused"))
        install_psr_state(inst, *state)
        (eng,) = inst.engines.values()
        b0, b1 = inst.group.window(eng1.B)
        np.testing.assert_array_equal(eng.site_rates.numpy(),
                                      eng1.site_rates[b0:b1].numpy())
        blob = _models_blob(inst)
        inst.rate_category = [np.zeros_like(c) for c in cats]
        _restore_models(inst, blob)
        for a, b in zip(inst.rate_category, cats):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(eng.site_rates.numpy(),
                                      eng1.site_rates[b0:b1].numpy())
