"""MCCompletePathV2 of the port (models/mccompletepathv2.py) against the
JAX package's sparse engine, plus the reference's own test tiers
(test/mccompletepathv2Test.cc, mirrored by tests/test_mccompletepathv2.py).

Whole runs compare at L >= |V|: no top-L cut happens anywhere, in the
walks' trace top-L or in the combine, so ties cannot propagate and the
runs must agree exactly in ids (the walks are bit for bit JAX's), with
scores within 1e-6 (the combine sums runs in another order).
"""

import numpy as np
import pytest
import torch

import approximated_personalized_pagerank_tpu as pj

import approximated_personalized_pagerank_tpu_torch as pt

SEED = 1234
DAMPING = 0.85


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tests run many tiny tensor ops, and the
    suite's parallel workers share the cores (spinning thread pools of
    several workers slow such ops by orders of magnitude)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _graph(seed, n=40):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 8, n)
    deg[:3] = 0  # dangling nodes
    src = np.repeat(np.arange(n), deg)
    return src, rng.integers(0, n, src.size), n


def _dicts(b):
    ids, sc = np.asarray(b.ids), np.asarray(b.scores)
    return [dict(zip(i[i >= 0].tolist(), s[i >= 0].tolist())) for i, s in zip(ids, sc)]


@pytest.mark.parametrize("algo_t,algo_j,choice", [
    ("sort", "sort", "uniform"),
    ("kernel", "bitonic", "uniform"),
    ("sort", "sort", "stratified"),
])
def test_untruncated_run_matches_jax(algo_t, algo_j, choice):
    src, dst, n = _graph(1)
    gj = pj.Graph.from_edges(src, dst, num_nodes=n)
    gt = pt.Graph.from_edges(src, dst, num_nodes=n)
    kw = dict(seed=3, return_info=True, successor_choice=choice)
    j, ji = pj.mccompletepathv2_baskets(gj, n, n, 200, DAMPING, engine="sparse",
                                        merge_algo=algo_j, **kw)
    t, ti = pt.mccompletepathv2_baskets(gt, n, n, 200, DAMPING, merge_algo=algo_t,
                                        engine="sparse", device="cpu", **kw)
    assert ti == ji
    assert t.ids.shape == (n, n) and t.ids.dtype == torch.int32
    dj, dt = _dicts(j), _dicts(t)
    for v, (a, b) in enumerate(zip(dj, dt)):
        assert set(a) == set(b), v
        assert max(abs(a[k] - b[k]) for k in a) <= 1e-6, v
    # rows sorted by descending score
    assert (torch.diff(t.scores, dim=1) <= 0).all()


def test_validation_messages():
    g = pt.Graph.from_dict({0: [1], 1: []})

    def run(*args, **kw):
        return pt.mccompletepathv2(g, *args, device="cpu", **kw)

    with pytest.raises(ValueError, match="K must be positive"):
        run(0, 3, 42, 0.5)
    with pytest.raises(ValueError, match="L must be positive"):
        run(1, 0, 42, 0.5)
    with pytest.raises(ValueError, match="K must be <= L"):
        run(5, 3, 42, 0.5)
    with pytest.raises(ValueError, match="iterations must be positive"):
        run(3, 3, 0, 0.5)
    with pytest.raises(ValueError, match=r"damping must be \[0,1\]"):
        run(3, 3, 42, 1.5)
    with pytest.raises(ValueError, match="combine_passes must be positive"):
        run(3, 3, 42, 0.5, combine_passes=0)
    with pytest.raises(ValueError, match="unknown successor_choice 'rotating'"):
        pt.mccompletepathv2_baskets(g, 3, 3, 42, 0.5, successor_choice="rotating",
                                    device="cpu")
    # the dense engine runs, and equals sparse here (L >= |V|: nothing is cut)
    dense = run(3, 3, 42, 0.5, engine="dense", seed=SEED)
    sparse = run(3, 3, 42, 0.5, engine="sparse", seed=SEED)
    assert dense.keys() == sparse.keys()
    for v in dense:
        assert dense[v] == pytest.approx(sparse[v], abs=1e-6)
    with pytest.raises(ValueError, match="unknown engine"):
        run(3, 3, 42, 0.5, engine="ring")


def test_empty_graph():
    g = pt.Graph.from_dict({})
    assert pt.mccompletepathv2(g, 3, 5, 10, DAMPING, engine="sparse", device="cpu") == {}
    b, info = pt.mccompletepathv2_baskets(g, 3, 5, 10, DAMPING, engine="sparse",
                                          device="cpu", return_info=True)
    assert b.ids.shape == (0, 3) and info == {"walk_steps": 0}


def test_edgeless_nodes_basket_is_one():
    # mccompletepathv2Test.cc:38-50: nodes with no edges end with {self: 1.0}
    g = pt.Graph.from_dict({i: [] for i in range(4)})
    res = pt.mccompletepathv2(g, 3, 5, 100, DAMPING, seed=SEED, engine="sparse",
                              device="cpu")
    for i in range(4):
        assert res[i] == pytest.approx({i: 1.0})


def test_deterministic_given_seed():
    g = pt.Graph.from_dict({0: [1, 2], 1: [2], 2: [0], 3: [0]})
    kw = dict(engine="sparse", device="cpu")
    a = pt.mccompletepathv2(g, 3, 6, 500, DAMPING, seed=77, **kw)
    b = pt.mccompletepathv2(g, 3, 6, 500, DAMPING, seed=77, **kw)
    c = pt.mccompletepathv2(g, 3, 6, 500, DAMPING, seed=78, **kw)
    assert a == b and a != c


def test_recall_band_vs_exact(rng):
    # tests/test_mccompletepathv2.py:74-84 (thesis p.18: L = 5-10x K,
    # R = 200-1000 gives good results)
    n = 60
    src = rng.integers(0, n, size=600)
    dst = rng.integers(0, n, size=600)
    g = pt.Graph.from_edges(src, dst, num_nodes=n)
    baskets = pt.mccompletepathv2_baskets(g, 10, 60, 1000, DAMPING, seed=SEED,
                                          engine="sparse", device="cpu")
    stats = pt.benchmark_algorithm(baskets, g, 40, True, seed=0, device="cpu")
    assert stats["jaccard average"] >= 0.75
    assert stats["kendall average"] >= 0.6


def test_cycle_scores_decrease_with_distance():
    n = 5
    g = pt.Graph.from_dict({i: [(i + 1) % n] for i in range(n)})
    res = pt.mccompletepathv2(g, n, n, 2000, DAMPING, seed=SEED, engine="sparse",
                              device="cpu")
    for src in range(n):
        vals = [res[src].get((src + d) % n, 0.0) for d in range(n)]
        assert all(vals[i] >= vals[i + 1] for i in range(n - 1))
        assert vals[0] > vals[-1]


def test_needs_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    g = pt.Graph.from_dict({0: [1], 1: [0]})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.mccompletepathv2_baskets(g, 1, 2, 10, DAMPING)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.walk_baskets(g, 2, 10, DAMPING)


# ------------------------------------------------------------ on the card
@pytest.mark.gpu
def test_card_run_matches_cpu_run():
    """The walks are bitwise equal on both devices; the combine's kernel
    and the CPU's plain version agree up to ties at the cut."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from approximated_personalized_pagerank_tpu_torch.utils.compare import topl_max_error

    src, dst, n = _graph(2, n=300)
    g = pt.Graph.from_edges(src, dst, num_nodes=n)
    a = pt.mccompletepathv2_baskets(g, 10, 40, 500, DAMPING, seed=1, device="cpu",
                                    merge_algo="kernel", engine="sparse")
    b = pt.mccompletepathv2_baskets(g, 10, 40, 500, DAMPING, seed=1, engine="sparse")
    topl_max_error(a.ids, a.scores, b.ids.cpu(), b.scores.cpu(), 1e-6)
