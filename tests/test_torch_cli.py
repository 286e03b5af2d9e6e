"""The port's CLI, run configuration, checkpoints, execution order and
profiling hook, against the JAX package where it has the same function.

Checkpoints written by either package load in the other with equal arrays;
``execution_order`` and ``RunConfig.validate``'s messages equal the JAX
package's.  Everything runs on the CPU (``--device cpu``) on tiny graphs.
"""

import glob
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import approximated_personalized_pagerank_tpu as pj
from approximated_personalized_pagerank_tpu.config import RunConfig as JRunConfig
from approximated_personalized_pagerank_tpu.utils import checkpoint as jc
from approximated_personalized_pagerank_tpu.utils.synthetic import powerlaw_graph

import approximated_personalized_pagerank_tpu_torch as pt
from approximated_personalized_pagerank_tpu_torch.cli import main
from approximated_personalized_pagerank_tpu_torch.config import RunConfig
from approximated_personalized_pagerank_tpu_torch.utils.convert import graph_from_arrays
from approximated_personalized_pagerank_tpu_torch.utils.profiling import trace

jo = importlib.import_module("approximated_personalized_pagerank_tpu.utils.order")


@pytest.fixture
def tiny_csv(tmp_path):
    p = tmp_path / "tiny.csv"
    p.write_text("\n".join(f"{i},{(i + 1) % 8}" for i in range(8)) + "\n")
    return str(p)


# ------------------------------------------------------------------------ CLI
@pytest.mark.parametrize("engine", ["auto", "sparse"])
def test_cli_runs_on_tiny_graph(tmp_path, capsys, tiny_csv, engine):
    out_npz = str(tmp_path / "out.npz")
    rc = main(["--graph", tiny_csv, "--K", "3", "--L", "6", "--iterations", "10",
               "--test-nodes", "4", "--engine", engine, "--device", "cpu",
               "--save", out_npz])
    assert rc == 0
    captured = capsys.readouterr().out
    assert "nodes: 8 edges: 8" in captured
    assert "jaccard average" in captured
    loaded, keys = pt.load_baskets(out_npz, device="cpu")
    direct = pt.grank_baskets(pt.load_csv_graph(tiny_csv), 3, 6, 10, 0.85, 1e-4,
                              engine=engine, device="cpu")
    assert torch.equal(loaded.ids, direct.ids) and torch.equal(loaded.scores, direct.scores)
    np.testing.assert_array_equal(keys, np.arange(8))


def test_cli_mc_and_the_sharded_paths(tmp_path, capsys, tiny_csv):
    rc = main(["--graph", tiny_csv, "--algorithm", "mccompletepathv2", "--K", "3",
               "--L", "6", "--iterations", "50", "--seed", "1", "--no-eval",
               "--device", "cpu"])
    assert rc == 0 and "mccompletepathv2 run-time" in capsys.readouterr().out
    for extra in (["--algorithm", "grank_multi", "--n-shards", "2"], ["--n-shards", "2"]):
        with pytest.raises(NotImplementedError, match="queue A item 9"):
            main(["--graph", tiny_csv, "--device", "cpu"] + extra)
    with pytest.raises(ValueError, match="unknown merge algo 'pallas'"):
        main(["--graph", tiny_csv, "--merge-algo", "pallas", "--device", "cpu"])


def test_cli_profile_writes_a_trace(tmp_path, capsys, tiny_csv):
    prof = tmp_path / "prof"
    rc = main(["--graph", tiny_csv, "--K", "3", "--L", "6", "--no-eval",
               "--device", "cpu", "--profile", str(prof)])
    assert rc == 0 and "profiler trace written" in capsys.readouterr().out
    (path,) = glob.glob(str(prof / "ppr_trace_*.json"))
    with open(path) as f:
        assert '"traceEvents"' in f.read()
    with trace(None):  # no directory and no PPR_PROFILE_DIR: nothing written
        pass
    assert len(glob.glob(str(prof / "*"))) == 1


# ---------------------------------------------------------------- checkpoints
def _baskets(n, w, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, (n, w)).astype(np.int32)
    ids[rng.random((n, w)) < 0.3] = -1
    sc = np.where(ids >= 0, rng.random((n, w)), 0).astype(np.float32)
    return ids, sc


@pytest.mark.parametrize("adj,keys", [
    ({i: [(i + 1) % 6] for i in range(6)}, list(range(6))),
    ({"apple": ["pear"], "pear": ["plum"], "plum": ["apple"]}, ["apple", "pear", "plum"]),
    (None, None),
])
def test_checkpoint_roundtrip(tmp_path, adj, keys):
    g = pt.Graph.from_dict(adj if adj is not None else {0: [1], 1: []})
    ids, sc = _baskets(g.num_nodes, 4, 1)
    path = str(tmp_path / "b.npz")
    pt.save_baskets(path, pt.Baskets(torch.as_tensor(ids), torch.as_tensor(sc)),
                    g if adj is not None else None)
    loaded, got = pt.load_baskets(path, device="cpu")
    assert loaded.ids.device.type == "cpu" and loaded.ids.dtype == torch.int32
    np.testing.assert_array_equal(loaded.ids.numpy(), ids)
    np.testing.assert_array_equal(loaded.scores.numpy(), sc)
    assert (got is None) if keys is None else (list(got) == keys)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_loads_across_packages(tmp_path, writer):
    adj = {"a": ["b", "c"], "b": ["c"], "c": ["a"], "d": []}
    ids, sc = _baskets(4, 3, 2)
    path = str(tmp_path / "x.npz")
    if writer == "jax":
        jc.save_baskets(path, pj.Baskets(jnp.asarray(ids), jnp.asarray(sc)),
                        pj.Graph.from_dict(adj))
        loaded, keys = pt.load_baskets(path, device="cpu")
        got_ids, got_sc = loaded.ids.numpy(), loaded.scores.numpy()
    else:
        pt.save_baskets(path, pt.Baskets(torch.as_tensor(ids), torch.as_tensor(sc)),
                        pt.Graph.from_dict(adj))
        loaded, keys = jc.load_baskets(path)
        got_ids, got_sc = np.asarray(loaded.ids), np.asarray(loaded.scores)
    assert got_ids.dtype == np.int32 and got_sc.dtype == np.float32
    np.testing.assert_array_equal(got_ids, ids)
    np.testing.assert_array_equal(got_sc, sc)
    assert list(keys) == ["a", "b", "c", "d"]


def test_load_needs_a_card_unless_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device loads")
    path = str(tmp_path / "c.npz")
    pt.save_baskets(path, pt.Baskets(*(torch.as_tensor(x) for x in _baskets(3, 2, 3))))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.load_baskets(path)


# ------------------------------------------------------------ execution order
@pytest.mark.parametrize("name", ["chain", "diamond", "cycle", "powerlaw500"])
def test_execution_order_matches_jax(name):
    adj = {
        "chain": {0: [1], 1: [2], 2: [3], 3: []},
        "diamond": {0: [1], 1: [3], 2: [1], 3: []},
        "cycle": {i: [(i + 1) % 5, (i + 2) % 5] for i in range(5)},
    }.get(name)
    if adj is None:
        gj = powerlaw_graph(500, 4000, seed=3)
        gt = graph_from_arrays(gj.indptr, gj.indices)
    else:
        gj, gt = pj.Graph.from_dict(adj), pt.Graph.from_dict(adj)
    order = pt.execution_order(gt)
    assert order == jo.execution_order(gj)
    assert sorted(order) == list(range(gt.num_nodes))
    if name == "chain":
        assert order == [3, 2, 1, 0]  # the predecessor cascade unwinds it


# ------------------------------------------------------------------ RunConfig
BAD_CONFIGS = [
    dict(algorithm="pagerank"),
    dict(K=0),
    dict(L=0),
    dict(K=5, L=3),
    dict(iterations=0),
    dict(damping=1.5),
    dict(algorithm="grank_multi", n_shards=0),
    dict(n_shards=-1),
    dict(engine="mxu"),
]


def test_run_config_validation_matches_jax():
    for bad in BAD_CONFIGS:
        with pytest.raises(ValueError) as jerr:
            JRunConfig(**bad).validate()
        with pytest.raises(ValueError) as terr:
            RunConfig(**bad).validate()
        assert str(terr.value) == str(jerr.value), bad
    RunConfig().validate()
    RunConfig(algorithm="mccompletepathv2", merge_algo="kernel:512", device="cpu").validate()
    with pytest.raises(ValueError, match="unknown merge algo 'bitonic'"):
        RunConfig(merge_algo="bitonic").validate()


def test_sample_graph_path_is_the_jax_packages():
    assert pt.sample_graph_path() == pj.sample_graph_path()
    g = pt.load_csv_graph(pt.sample_graph_path())
    assert g.num_nodes == 2000 and g.num_edges > 10_000
