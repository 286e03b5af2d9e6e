"""One process of the port's multi-process ring test (spawned by
tests/test_torch_multiprocess.py, never collected).

Joins a gloo process group, holds 2 CPU shards of a mesh that spans every
process, runs the ring GRank over it, and checks its own rows against the
port's serial sparse run: ids as sets, scores within 1e-4, as
tests/multihost_worker.py checks the JAX package's.

Usage: python torch_multiprocess_worker.py <rank> <world_size> <port>
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from approximated_personalized_pagerank_tpu_torch import (
    Graph,
    grank_baskets,
    init_distributed,
    make_mesh,
)
from approximated_personalized_pagerank_tpu_torch.parallel.ring import ring_grank_baskets

rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
init_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo")
mesh = make_mesh(devices=[torch.device("cpu")] * 2)
assert mesh.n_shards == 2 * world and mesh.group is not None
assert [p for p, _ in mesh.shards] == [2 * rank, 2 * rank + 1]

# every process builds the same graph
rng = np.random.default_rng(3)
n, e = 512, 4096
graph = Graph.from_edges(rng.integers(0, n, e), rng.integers(0, n, e), num_nodes=n)
K, L, iters, damping, tol = 10, 20, 12, 0.85, 1e-4

out, info = ring_grank_baskets(graph, K, L, iters, damping, tol, mesh=mesh,
                               return_info=True)
ref = grank_baskets(graph, K, L, iters, damping, tol, engine="sparse", device="cpu")
start, stop = info["row_range"]
assert (start, stop) == mesh.row_range(n) and out.ids.shape == (stop - start, K)
for r in range(stop - start):
    got = {int(i): float(s) for i, s in zip(out.ids[r], out.scores[r]) if i >= 0}
    want = {int(i): float(s) for i, s in zip(ref.ids[start + r], ref.scores[start + r])
            if i >= 0}
    assert set(got) == set(want), (start + r, got, want)
    for k in got:
        assert abs(got[k] - want[k]) < 1e-4, (start + r, k, got[k], want[k])
assert info["iterations_ran"] == iters, info
dist.destroy_process_group()
print(f"proc {rank}: OK ({stop - start} rows verified)", flush=True)
