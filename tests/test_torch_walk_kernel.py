"""The walk cohort kernel (``csrc/walk_cohort.cu``, ``ops/walk_kernel.py``)
against the plain loop of ``ops/walk.py::walk_trace_chunk``.

On the card (``gpu`` tests) the kernel's trace, abandoned walks and count of
macro steps walked equal the plain loop's (the CPU dispatch) bit for bit,
over graphs with dangling nodes, self-loops and degree-1 nodes, slot counts
1, 5 and 16, stratified first hops, a ``rows`` window, a horizon short
enough that walks are abandoned, and one source chunk of Eat's shape.

On the CPU: the kernel stops each row on its own once its walks are done;
that is the plain loop's trace only because rows never interact, which
splitting a chunk into one-row ``rows`` windows shows.  The CPU dispatch
runs the plain loop and counts no kernel chunk.

This file imports neither JAX nor the JAX package, so on a card's machine
it runs without the suite's ``conftest.py`` (which imports JAX)::

    python -m pytest --noconftest -o addopts= -m gpu tests/test_torch_walk_kernel.py
"""

import re

import numpy as np
import pytest
import torch

import approximated_personalized_pagerank_tpu_torch as pt
from approximated_personalized_pagerank_tpu_torch.ops import walk as tw
from approximated_personalized_pagerank_tpu_torch.ops import walk_kernel as wk
from approximated_personalized_pagerank_tpu_torch.ops.basket import SENTINEL
from approximated_personalized_pagerank_tpu_torch.utils import profiling, prng

DAMPING = 0.85
UNROLL = 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the plain loop runs many tiny tensor ops, and
    the suite's parallel workers share the cores.  The span buffer starts
    and ends empty."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.clear()
    yield
    profiling.clear()
    torch.set_num_threads(threads)


def _graph(seed: int, n: int = 80) -> pt.Graph:
    """Dangling nodes (0-4), degree-1 nodes (5-9, one a self-loop), a hub
    (node 10, 60 out-edges), self-loops sprinkled over the rest."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, 6, n)
    deg[:5] = 0
    deg[5:10] = 1
    deg[10] = 60
    src = np.repeat(np.arange(n), deg)
    dst = rng.integers(0, n, src.size)
    loops = rng.random(src.size) < 0.1
    dst[loops] = src[loops]
    dst[np.searchsorted(src, 7)] = 7
    return pt.Graph.from_edges(src, dst, num_nodes=n)


def _walk(dg, sources, key, total, slots, macro, unroll=UNROLL, stratified=False, rows=None):
    """``walk_trace_chunk`` on the tensors' device, recorded: (trace,
    abandoned, the span's counts)."""
    damping = torch.tensor(DAMPING, dtype=torch.float32, device=sources.device)
    with profiling.record():
        with profiling.span("mc.walks") as s:
            trace, abandoned = tw.walk_trace_chunk(
                dg.start_deg, dg.indices, sources, key, damping, total, slots, macro,
                unroll, stratified=stratified, rows=rows)
    return trace, abandoned, dict(s.counts)


# ------------------------------------------------------------ on the CPU
def test_kernel_constants_are_the_plain_versions():
    """The kernel source's threefry constants, SENTINEL and lane count are
    those of utils/prng.py, ops/basket.py and the wrapper."""
    with open(wk.KERNEL_SOURCE) as f:
        src = f.read()
    rot = re.search(r"kRot\[2\]\[4\] = \{\{([\d, ]+)\}, \{([\d, ]+)\}\}", src)
    assert tuple(tuple(int(x) for x in g.split(",")) for g in rot.groups()) == prng.ROTATIONS
    parity = re.search(r"KS_PARITY = (0x[0-9A-Fa-f]+)u", src).group(1)
    assert int(parity, 16) == prng.KS_PARITY
    assert int(re.search(r"SENTINEL = (-?\d+);", src).group(1)) == SENTINEL
    assert wk.MAX_SLOTS == 32


@pytest.mark.parametrize("slots,total,macro,stratified", [
    (5, 40, 2, False), (16, 200, 1, True), (1, 12, 3, False),
])
def test_one_row_windows_give_the_whole_chunk(slots, total, macro, stratified):
    """Rows never interact: each row walked alone, as a one-row ``rows``
    window of the chunk, gives its row of the whole chunk's trace and
    abandoned walks bitwise.  The horizons are short enough that some
    walks are abandoned."""
    g = _graph(3, n=40)
    dg = g.device_graph("cpu")
    sources = torch.arange(4, 16)
    key = prng.fold_in(prng.prng_key(2**31 + 77), 4)
    c = sources.shape[0]
    whole, ab, _ = _walk(dg, sources, key, total, slots, macro, unroll=8,
                         stratified=stratified)
    assert int(ab.sum()) > 0 and int((whole >= 0).sum()) > 0
    for r in range(c):
        tr, a, _ = _walk(dg, sources[r:r + 1], key, total, slots, macro, unroll=8,
                         stratified=stratified, rows=(r, c))
        assert torch.equal(tr[0], whole[r]) and torch.equal(a[0], ab[r])


def test_cpu_dispatch_takes_the_plain_loop():
    """A CPU chunk walks the plain loop: one ``mc.alive_wait`` a macro step
    walked (and one more that ends it), no kernel chunk counted, no launch,
    no library built or loaded."""
    g = _graph(4, n=30)
    dg = g.device_graph("cpu")
    launches = wk.walk_cohort.launches
    with profiling.record():
        with profiling.span("mc.walks") as s:
            tw.walk_trace_chunk(dg.start_deg, dg.indices, torch.arange(30),
                                prng.prng_key(5), torch.tensor(DAMPING), 20, 5, 6, 4)
    counts = dict(s.counts)
    waits = [x for x in profiling.recorded() if x.name == "mc.alive_wait"]
    assert counts["chunks"] == 1 and "walk_kernel_chunks" not in counts
    assert counts["macro_steps"] <= len(waits) <= counts["macro_steps"] + 1
    assert wk.walk_cohort.launches == launches and wk._LIB is None
    with pytest.raises(ValueError, match="CUDA device"):
        wk.walk_cohort(dg.start_deg, dg.indices, torch.arange(3), prng.prng_key(5),
                       torch.tensor(DAMPING), 20, 5, 6, 4)


# ------------------------------------------------------------ on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the walk kernel is CUDA and has no CPU mode")


def _kernel_equals_plain(g, sources, key, total, slots, macro, unroll=UNROLL,
                         stratified=False, rows=None):
    """Walk on the CPU (the plain loop) and the card (the kernel); assert
    equal bits, counts and one launch; return the plain loop's results."""
    want = _walk(g.device_graph("cpu"), sources, key, total, slots, macro, unroll,
                 stratified, rows)
    launches = wk.walk_cohort.launches
    got = _walk(g.device_graph("cuda"), sources.cuda(), key, total, slots, macro, unroll,
                stratified, rows)
    torch.cuda.synchronize()
    profiling.clear()
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int64
    assert torch.equal(got[0].cpu(), want[0]), "traces differ"
    assert torch.equal(got[1].cpu(), want[1]), "abandoned walks differ"
    assert got[2] == {**want[2], "walk_kernel_chunks": 1}
    assert wk.walk_cohort.launches == launches + 1
    return want


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("slots", [1, 5, 16])
@pytest.mark.parametrize("stratified", [False, True])
def test_kernel_equals_plain_loop(seed, slots, stratified):
    _card()
    g = _graph(seed)
    total = 170
    macro = -(-tw._horizon(total, slots, DAMPING) // UNROLL)
    key = prng.fold_in(prng.prng_key(2**32 - 1 - seed), 64)
    _kernel_equals_plain(g, torch.arange(g.num_nodes), key, total, slots, macro,
                         stratified=stratified)


@pytest.mark.gpu
@pytest.mark.parametrize("stratified", [False, True])
def test_kernel_rows_window(stratified):
    """Rows 24.. of a 200-row chunk under its key."""
    _card()
    g = _graph(5)
    _kernel_equals_plain(g, torch.arange(24, 74), prng.prng_key(9), 850, 16, 14,
                         stratified=stratified, rows=(24, 200))


@pytest.mark.gpu
@pytest.mark.parametrize("slots", [1, 5, 16])
def test_kernel_short_horizon_abandons(slots):
    _card()
    g = _graph(6)
    _, abandoned, counts = _kernel_equals_plain(g, torch.arange(g.num_nodes),
                                                prng.prng_key(11), 850, slots, 2, unroll=4)
    assert int(abandoned.sum()) > 0 and counts["macro_steps"] == 2


@pytest.mark.gpu
def test_kernel_on_eat_chunk():
    """Eat's second source chunk (512 rows) as MC(R=1000) walks it."""
    _card()
    eat = pt.load_eat_graph()
    chunk, _, slots, total, macro, _ = tw._trace_chunks(eat.num_nodes, 1000, DAMPING,
                                                        None, None, UNROLL)
    key = prng.fold_in(tw._root_key(2718281828), chunk)
    trace, _, counts = _kernel_equals_plain(eat, torch.arange(chunk, 2 * chunk), key,
                                            total, slots, macro)
    assert (chunk, slots) == (512, 16) and 0 < counts["macro_steps"] <= macro
    assert int((trace >= 0).sum()) > 0


@pytest.mark.gpu
def test_kernel_at_the_walk_suites_card_case():
    """``test_torch_walk.py::test_trace_chunk_equal_on_cuda``'s case (that
    file imports JAX, which a card's machine may lack): 60 nodes, dangling
    0-4, a 50-edge hub, 850 walks a source on 16 slots, 14 macro steps."""
    _card()
    rng = np.random.default_rng(8)
    deg = rng.integers(1, 6, 60)
    deg[:5] = 0
    deg[5] = 50
    src = np.repeat(np.arange(60), deg)
    g = pt.Graph.from_edges(src, rng.integers(0, 60, src.size), num_nodes=60)
    _kernel_equals_plain(g, torch.arange(60), prng.fold_in(prng.prng_key(1), 0), 850, 16, 14)


@pytest.mark.gpu
def test_kernel_refuses_what_it_cannot_take():
    _card()
    dg = _graph(7).device_graph("cuda")
    src = torch.arange(8, device="cuda")
    d = torch.tensor(DAMPING, device="cuda")
    args = (prng.prng_key(1), d, 100, 16, 2, 4)
    with pytest.raises(ValueError, match="1 to 32 slots"):
        wk.walk_cohort(dg.start_deg, dg.indices, src, prng.prng_key(1), d, 100, 33, 2, 4)
    with pytest.raises(TypeError, match="sources must be int64"):
        wk.walk_cohort(dg.start_deg, dg.indices, src.int(), *args)
    with pytest.raises(ValueError, match="sources must be contiguous"):
        wk.walk_cohort(dg.start_deg, dg.indices, torch.arange(16, device="cuda")[::2], *args)
    with pytest.raises(TypeError, match="damping must be a float32"):
        wk.walk_cohort(dg.start_deg, dg.indices, src, prng.prng_key(1), d.double(),
                       100, 16, 2, 4)
