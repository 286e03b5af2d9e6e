"""The port's native loader (native/ingest.cc) against its plain numpy
versions and the JAX package: the edge-list parse and the 2-colouring must
be byte-equal, and ``paths_ran`` must name the path that ran."""

import numpy as np
import pytest

import approximated_personalized_pagerank_tpu as pj
from approximated_personalized_pagerank_tpu.utils import synthetic as j_synth

import approximated_personalized_pagerank_tpu_torch as pt
from approximated_personalized_pagerank_tpu_torch.utils import io as tio
from approximated_personalized_pagerank_tpu_torch.utils import synthetic as t_synth

CSV_CASES = {
    "plain": b"1,2\n2,3\n1,2\n4294967296,1\n3,7\n",
    "crlf": b"1,2\r\n2,3\r\n-5,+6\r\n",
    "blank_lines": b"\n\n1,2\n\n\r\n3,4\n\n",
    "no_final_newline": b"10,20\n30,40",
    "spaces_and_tabs": b" 1 , 2\t\n3,\t4 \n",
    "empty": b"",
}


@pytest.fixture(scope="module")
def native():
    assert tio.native_available(), "the native loader did not build"
    return tio.load_native()


@pytest.mark.parametrize("name", sorted(CSV_CASES))
def test_native_parse_byte_equal_to_numpy(native, tmp_path, name):
    data = CSV_CASES[name]
    path = tmp_path / f"{name}.csv"
    path.write_bytes(data)
    src, dst = tio.parse_edge_csv(str(path))
    assert tio.paths_ran()["parse_edge_csv"] == "native"
    ref_src, ref_dst = tio._parse_bytes(data, str(path))
    assert src.dtype == ref_src.dtype == np.int64
    assert src.tobytes() == ref_src.tobytes() and dst.tobytes() == ref_dst.tobytes()


@pytest.mark.parametrize("data", [b"1,2\n3\n", b"7\n", b"1,2,3\r\n"])
def test_native_parse_odd_count_raises_as_numpy(native, tmp_path, data):
    path = tmp_path / "odd.csv"
    path.write_bytes(data)
    with pytest.raises(ValueError) as native_err:
        tio.parse_edge_csv(str(path))
    with pytest.raises(ValueError) as numpy_err:
        tio._parse_bytes(data, str(path))
    assert str(native_err.value) == str(numpy_err.value)
    assert "odd number of integers" in str(native_err.value)


@pytest.mark.parametrize("data", [b"1,x\n", b"1,2\n3.5,4\n", b"1,99999999999999999999\n"])
def test_native_parse_rejects_what_numpy_rejects(native, tmp_path, data):
    path = tmp_path / "bad.csv"
    path.write_bytes(data)
    with pytest.raises(ValueError, match="not an int64"):
        tio.parse_edge_csv(str(path))
    with pytest.raises((ValueError, OverflowError)):
        tio._parse_bytes(data, str(path))


def test_gz_stays_on_numpy_and_csv_graph_equals_jax(native, tmp_path):
    pt.load_eat_graph()
    assert tio.paths_ran()["parse_edge_csv"] == "numpy"
    path = tmp_path / "g.csv"
    path.write_bytes(CSV_CASES["plain"] + CSV_CASES["blank_lines"] + b"8,1\r\n1,8\r\n")
    gj, gt = pj.load_csv_graph(str(path)), pt.load_csv_graph(str(path))
    assert tio.paths_ran()["parse_edge_csv"] == "native"
    assert np.array_equal(gt.indptr, gj.indptr) and np.array_equal(gt.indices, gj.indices)
    assert gt.keys == gj.keys


def _many_components(rng):
    """Chains, stars and odd cycles in separate components, with
    dangling nodes that are only targets, and isolated ids."""
    src, dst = [], []
    base = 0
    for size in rng.integers(1, 12, 25):
        nodes = np.arange(base, base + size)
        kind = base % 3
        if kind == 0:  # chain, backwards edges too
            src += list(nodes[1:]) + list(nodes[:-1][::2])
            dst += list(nodes[:-1]) + list(nodes[1:][::2])
        elif kind == 1:  # star whose leaves dangle
            src += [nodes[0]] * (size - 1)
            dst += list(nodes[1:])
        else:  # an odd cycle
            src += list(nodes)
            dst += list(np.roll(nodes, 1))
        base += size + 2  # two isolated ids between components
    n = base + 40
    return np.asarray(src, np.int64), np.asarray(dst, np.int64), n


def _graphs(rng):
    src, dst, n = _many_components(rng)
    yield "many_components", pj.Graph.from_edges(src, dst, num_nodes=n), pt.Graph.from_edges(
        src, dst, num_nodes=n)
    for i, adj in enumerate(({}, {0: [], 1: []}, {0: [1, 2, 3], 1: [], 2: [], 3: []},
                             {i: [(i + 1) % 6] for i in range(6)})):
        yield f"small_{i}", pj.Graph.from_dict(adj), pt.Graph.from_dict(adj)
    s, d = rng.integers(0, 2000, 6000), rng.integers(0, 2000, 6000)
    yield "powerlaw", j_synth.powerlaw_graph(2000, 6000, seed=3, locality=0.8), \
        t_synth.powerlaw_graph(2000, 6000, seed=3, locality=0.8)
    yield "uniform_sparse", pj.Graph.from_edges(s[:900], d[:900], num_nodes=2000), \
        pt.Graph.from_edges(s[:900], d[:900], num_nodes=2000)


def test_native_colouring_byte_equal_to_numpy_and_jax(native, rng):
    for name, gj, gt in _graphs(rng):
        colour = gt.partition
        assert tio.paths_ran()["bfs_bipartition"] == "native", name
        assert colour.dtype == np.uint8, name
        assert colour.tobytes() == gt._bfs_bipartition().tobytes(), name
        assert colour.tobytes() == gj.partition.tobytes(), name
        assert set(np.unique(colour)) <= {0, 1}, name


def test_native_colouring_on_eat(native):
    gj, gt = pj.load_eat_graph(), pt.load_eat_graph()
    colour = gt.partition
    assert tio.paths_ran()["bfs_bipartition"] == "native"
    assert colour.tobytes() == gt._bfs_bipartition().tobytes()
    assert colour.tobytes() == gj.partition.tobytes()
