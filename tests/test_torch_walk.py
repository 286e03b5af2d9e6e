"""The port's Monte-Carlo walks (ops/walk.py) against the JAX package's.

The port draws JAX's threefry stream (utils/prng.py), so the walks are held
bit for bit: a chunk's trace, its abandoned walks, the counts engine's
normalized counts and the ``walk_baskets`` counters are equal, not merely
close.  The plan arithmetic that fixes the streams (slots, horizon, chunk
sizes) equals JAX's over a grid, up to a million nodes.  The top-L cut of
the visit counts is compared up to ties at the cut
(``utils/compare.py::topl_max_error``): integer visit counts tie often.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import approximated_personalized_pagerank_tpu as pj

import approximated_personalized_pagerank_tpu_torch as pt
from approximated_personalized_pagerank_tpu_torch.ops import walk as tw
from approximated_personalized_pagerank_tpu_torch.utils import prng
from approximated_personalized_pagerank_tpu_torch.utils.compare import topl_max_error

jw = importlib.import_module("approximated_personalized_pagerank_tpu.ops.walk")
j_common = importlib.import_module("approximated_personalized_pagerank_tpu.models.common")

ATOL = 1e-6
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


def _graph(seed=0, n=60):
    """Dangling nodes (0-4), a hub (node 5, 50 out-edges) and low-degree
    rest."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, 6, n)
    deg[:5] = 0
    deg[5] = 50
    src = np.repeat(np.arange(n), deg)
    dst = rng.integers(0, n, src.size)
    return (pj.Graph.from_edges(src, dst, num_nodes=n),
            pt.Graph.from_edges(src, dst, num_nodes=n))


def _jax_tables(gj):
    dg = j_common.device_graph(gj)
    return jnp.stack([dg.indptr[:-1], dg.out_degree], axis=-1), dg.indices


# ------------------------------------------------------------ plan arithmetic
@pytest.mark.parametrize("R,damping", [
    (1, 0.85), (10, 0.85), (200, 0.85), (1000, 0.85), (1000, 0.5),
    (300, 0.0), (300, 1.0), (50, 0.99), (5000, 0.7),
])
def test_plan_helpers_match_jax(R, damping):
    total = int(R * damping)
    for slots in (1, 8, 15, 16, 128):
        assert tw._horizon(total, slots, damping) == jw._horizon(total, slots, damping)
    for unroll in (4, 32):
        assert tw._pick_slots(total, damping, unroll) == jw._pick_slots(total, damping, unroll)
        for n in (40, 23132, 1_000_000):
            for chunk, slots in ((None, None), (16, 8)):
                assert tw._trace_plan(R, damping, chunk, slots, unroll, num_nodes=n) == \
                    jw._trace_plan(R, damping, chunk, slots, unroll, num_nodes=n)
                assert tw._walk_plan(n, R, damping, chunk, None, slots, unroll) == \
                    jw._walk_plan(n, R, damping, chunk, None, slots, unroll)
    assert tw.default_max_steps(damping) == jw.default_max_steps(damping)


@pytest.mark.parametrize("n,R,expect_chunk", [
    (40, 1000, 40), (23132, 1000, 512), (23132, 200, 512),
    (1_000_000, 1000, 9344), (1_000_000, 200, 32768),
    (4_800_000, 200, 32768),  # the north star's MC (its mc_l does not enter the plan)
])
def test_trace_chunk_sizes_match_jax(monkeypatch, n, R, expect_chunk):
    """JAX's generator, with its chunk walk and merge stubbed out, shows
    the chunk size and merge row chunk it walks with, and the first
    chunk's key."""
    seen = {}

    def fake_walk(start_deg, indices, sources, key, damping, total, slots,
                  macro_steps, unroll, stratified=False):
        seen.update(chunk=sources.shape[0], key=np.asarray(key).tolist(),
                    slots=slots, macro=macro_steps)
        c = sources.shape[0]
        return jnp.zeros((c, 1), jnp.int32), jnp.zeros((c,), jnp.int32)

    def fake_topl(trace, sources, r_total, L, row_chunk, algo=None):
        seen["row_chunk"] = row_chunk
        c = trace.shape[0]
        return jnp.zeros((c, L), jnp.int32), jnp.zeros((c, L), jnp.float32)

    monkeypatch.setattr(jw, "walk_trace_chunk", fake_walk)
    monkeypatch.setattr(jw, "_trace_topl", fake_topl)
    gj = pj.Graph.from_edges(np.array([0]), np.array([1]), num_nodes=n)
    next(jw.walk_trace_basket_chunks(gj, 200, R, DAMPING, seed=1))
    chunk, row_chunk, slots, _, macro, _ = tw._trace_chunks(n, R, DAMPING, None, None, 32)
    assert (chunk, row_chunk, slots, macro) == (
        seen["chunk"], seen["row_chunk"], seen["slots"], seen["macro"])
    assert chunk == expect_chunk
    assert list(prng.fold_in(prng.prng_key(1), 0)) == seen["key"]


def test_device_graph_matches_jax_and_is_cached():
    """The walker's CSR tables equal the JAX package's, and a graph uploads
    them once per device."""
    gj, gt = _graph(2)
    sd_j, ind_j = _jax_tables(gj)
    dg = gt.device_graph("cpu")
    assert dg.start_deg.dtype == dg.indices.dtype == torch.int64
    np.testing.assert_array_equal(dg.start_deg.numpy(), np.asarray(sd_j))
    np.testing.assert_array_equal(dg.indices.numpy(), np.asarray(ind_j))
    assert gt.device_graph(torch.device("cpu")) is dg


# ------------------------------------------------------------ one chunk
@pytest.mark.parametrize("stratified", [False, True])
@pytest.mark.parametrize("cut", [False, True])
def test_walk_trace_chunk_bitwise(stratified, cut):
    """A padded chunk (20 sources and 4 pad rows of source 0) of the graph
    with dangling nodes and a hub; ``cut`` gives too few macro steps, so
    walks are abandoned."""
    gj, gt = _graph(1)
    sd_j, ind_j = _jax_tables(gj)
    dg = gt.device_graph("cpu")
    R, slots, unroll = 300, 8, 4
    total = int(R * DAMPING)
    macro = 3 if cut else -(-tw._horizon(total, slots, DAMPING) // unroll)
    srcs = np.concatenate([np.arange(20), np.zeros(4, np.int64)])
    j_tr, j_ab = jw.walk_trace_chunk(
        sd_j, ind_j, jnp.asarray(srcs, jnp.int32),
        jax.random.fold_in(jax.random.PRNGKey(3), 40), jnp.float32(DAMPING),
        jnp.int32(total), slots, macro, unroll, stratified=stratified)
    t_tr, t_ab = tw.walk_trace_chunk(
        dg.start_deg, dg.indices, torch.as_tensor(srcs),
        prng.fold_in(prng.prng_key(3), 40),
        torch.tensor(DAMPING, dtype=torch.float32), total, slots, macro, unroll,
        stratified=stratified)
    assert t_tr.dtype == torch.int32 and t_tr.shape == j_tr.shape
    np.testing.assert_array_equal(t_tr.numpy(), np.asarray(j_tr))
    np.testing.assert_array_equal(t_ab.numpy(), np.asarray(j_ab))
    assert (int(t_ab.sum()) > 0) == cut
    assert (t_tr[:5] == -1).all()  # dangling sources never step


@pytest.mark.parametrize("stratified", [False, True])
def test_walk_counts_chunk_bitwise(stratified):
    gj, gt = _graph(2)
    sd_j, ind_j = _jax_tables(gj)
    dg = gt.device_graph("cpu")
    R, slots, unroll, n = 200, 8, 4, gt.num_nodes
    total = int(R * DAMPING)
    macro = -(-tw._horizon(total, slots, DAMPING) // unroll)
    srcs = np.arange(2, 18)
    j_c, j_ab = jw.walk_counts_chunk(
        sd_j, ind_j, jnp.asarray(srcs, jnp.int32),
        jax.random.fold_in(jax.random.PRNGKey(5), 2), jnp.float32(DAMPING),
        jnp.float32(R), jnp.int32(total), n, slots, macro, unroll,
        stratified=stratified)
    t_c, t_ab = tw.walk_counts_chunk(
        dg.start_deg, dg.indices, torch.as_tensor(srcs),
        prng.fold_in(prng.prng_key(5), 2),
        torch.tensor(DAMPING, dtype=torch.float32),
        torch.tensor(float(R)), total, n, slots, macro, unroll,
        stratified=stratified)
    np.testing.assert_array_equal(t_c.numpy().view(np.int32),
                                  np.asarray(j_c).view(np.int32))
    np.testing.assert_array_equal(t_ab.numpy(), np.asarray(j_ab))


def test_first_chunk_above_65536_nodes_bitwise():
    """Above 65,536 nodes the trace plan walks 32,768 sources a chunk (512
    at most below): the first chunk of a 70,000-node graph, at the plan's
    own chunk, slots and macro steps and with its own key, gives one trace
    and one count of abandoned walks in both packages."""
    n, R = 70_000, 4
    rng = np.random.default_rng(4)
    deg = rng.integers(0, 6, n)
    src = np.repeat(np.arange(n), deg)
    dst = rng.integers(0, n, src.size)
    gj = pj.Graph.from_edges(src, dst, num_nodes=n)
    gt = pt.Graph.from_edges(src, dst, num_nodes=n)
    chunk, _, slots, total, macro, _ = tw._trace_chunks(n, R, DAMPING, None, None, 32)
    assert chunk == 32_768
    assert jw._trace_plan(R, DAMPING, None, None, 32, num_nodes=n)[:4] == (
        chunk, slots, total, macro)
    sd_j, ind_j = _jax_tables(gj)
    dg = gt.device_graph("cpu")
    j_tr, j_ab = jw.walk_trace_chunk(
        sd_j, ind_j, jnp.arange(chunk, dtype=jnp.int32),
        jax.random.fold_in(jax.random.PRNGKey(1), 0), jnp.float32(DAMPING),
        jnp.int32(total), slots, macro, 32)
    t_tr, t_ab = tw.walk_trace_chunk(
        dg.start_deg, dg.indices, tw._chunk_sources(0, n, chunk, "cpu")[0],
        prng.fold_in(prng.prng_key(1), 0), torch.tensor(DAMPING, dtype=torch.float32),
        total, slots, macro, 32)
    np.testing.assert_array_equal(t_tr.numpy(), np.asarray(j_tr))
    np.testing.assert_array_equal(t_ab.numpy(), np.asarray(j_ab))
    assert (t_tr >= 0).sum() > chunk * total  # the chunk walked


# ------------------------------------------------------------ whole walks
def _rows(b):
    return [sorted((int(i), round(float(s), 6)) for i, s in zip(r, q) if i >= 0)
            for r, q in zip(np.asarray(b.ids), np.asarray(b.scores))]


@pytest.mark.parametrize("unroll", [32, 8])
def test_trace_equals_counts_in_port(unroll):
    """The two engines' visit multisets are equal, also at an ``unroll``
    other than the default, which the port forwards to the counts plan."""
    _, gt = _graph(3)
    kw = dict(seed=11, source_chunk=16, unroll=unroll)
    trace, counts = [], []
    for _, top, v, _a in tw.walk_trace_basket_chunks(gt, gt.num_nodes, 300, DAMPING,
                                                     device="cpu", **kw):
        trace.append((top, int(v)))
    for _, c, v, _a in tw.walk_count_chunks(gt, 300, DAMPING, device="cpu", **kw):
        ids = torch.where(c > 0, torch.arange(gt.num_nodes, dtype=torch.int32), -1)
        counts.append((pt.Baskets(ids, c), int(v)))
    assert [v for _, v in trace] == [v for _, v in counts]
    for (a, _), (b, _) in zip(trace, counts):
        assert _rows(a) == _rows(b)


@pytest.mark.parametrize("engine", ["trace", "counts"])
def test_walk_baskets_info_matches_jax(engine):
    gj, gt = _graph(4)
    kw = dict(seed=7, source_chunk=16, slots=8, return_info=True, engine=engine)
    jb, ji = jw.walk_baskets(gj, 12, 300, DAMPING, **kw)
    tb, ti = pt.walk_baskets(gt, 12, 300, DAMPING, device="cpu", **kw)
    assert ti == ji and ti["walk_steps"] > 0
    assert tb.ids.shape == (gt.num_nodes, 12)
    topl_max_error(np.asarray(jb.ids), np.asarray(jb.scores), tb.ids, tb.scores, ATOL)


@pytest.mark.parametrize("engine", ["trace", "counts"])
def test_walk_baskets_cut_ties_as_jax(engine):
    """Visit counts tie often at a cut below |V| (L=12 of 60 nodes, R=300).
    The port's sort pipeline cuts them as the JAX package's does (keep_top:
    equal counts to the lower column, on id-sorted rows the smaller id), so
    the baskets are equal to the bit, not merely up to ties."""
    gj, gt = _graph(4)
    kw = dict(seed=7, source_chunk=16, slots=8, engine=engine)
    jb = jw.walk_baskets(gj, 12, 300, DAMPING, **kw)
    tb = pt.walk_baskets(gt, 12, 300, DAMPING, device="cpu", merge_algo="sort", **kw)
    np.testing.assert_array_equal(tb.ids.numpy(), np.asarray(jb.ids))
    np.testing.assert_array_equal(tb.scores.numpy().view(np.int32),
                                  np.asarray(jb.scores).view(np.int32))


@pytest.mark.parametrize("algo", ["sort", "kernel"])
def test_trace_topl_matches_jax(algo):
    """The default chunking of a 60-node graph at R=1000 (one padded
    chunk), cut at L=8: the port's pipelines against JAX's default."""
    gj, gt = _graph(5)
    jb = jw.walk_baskets(gj, 8, 1000, DAMPING, seed=2)
    tb = pt.walk_baskets(gt, 8, 1000, DAMPING, seed=2, merge_algo=algo, device="cpu")
    topl_max_error(np.asarray(jb.ids), np.asarray(jb.scores), tb.ids, tb.scores, ATOL)


def test_dangling_and_edgeless_sources_are_unit_self():
    _, gt = _graph(6)
    b = pt.walk_baskets(gt, 4, 100, DAMPING, seed=0, device="cpu")
    assert b.ids[:5, 0].tolist() == list(range(5))
    assert torch.equal(b.scores[:5, 0], torch.ones(5))
    assert (b.ids[:5, 1:] == -1).all()
    g2 = pt.Graph.from_dict({0: [], 1: []})
    b2, info = pt.walk_baskets(g2, 2, 50, DAMPING, seed=0, device="cpu",
                               return_info=True)
    assert b2.ids[:, 0].tolist() == [0, 1] and torch.equal(b2.scores[:, 0], torch.ones(2))
    assert info == {"walk_steps": 0, "abandoned_walks": 0, "total_walks": 0}


def test_walks_deterministic_given_seed():
    _, gt = _graph(7)
    a = pt.walk_baskets(gt, 6, 200, DAMPING, seed=3, device="cpu")
    b = pt.walk_baskets(gt, 6, 200, DAMPING, seed=3, device="cpu")
    c = pt.walk_baskets(gt, 6, 200, DAMPING, seed=4, device="cpu")
    assert torch.equal(a.ids, b.ids) and torch.equal(a.scores, b.scores)
    assert not torch.equal(a.scores, c.scores)
    with pytest.raises(ValueError, match="unknown walk engine"):
        pt.walk_baskets(gt, 6, 200, DAMPING, engine="dense", device="cpu")


# ------------------------------------------------------------ on the card
@pytest.mark.gpu
def test_trace_chunk_equal_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    _, gt = _graph(8)
    out = []
    for dev in ("cpu", "cuda"):
        dg = gt.device_graph(dev)
        srcs = torch.arange(gt.num_nodes, device=dev)
        tr, ab = tw.walk_trace_chunk(
            dg.start_deg, dg.indices, srcs, prng.fold_in(prng.prng_key(1), 0),
            torch.tensor(DAMPING, device=dev), 850, 16, 14, 32)
        out.append((tr.cpu(), ab.cpu()))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
