"""The merge kernel's rule for tied totals on the port's paths: the gather
entry, rows of 8192 and the MC trace top-L, held against the TPU kernel's.

As in ``test_torch_tie_rule.py``: dyadic scores, so every run sum is exact
and totals tie at the cut and among the survivors, and every comparison is
bitwise in ids, scores and order.  The TPU kernel runs in Pallas interpret
mode, and at W=8192 as its body's two steps after the sort in plain jnp
(interpret mode is slow there).  On the card: ``test_torch_tie_rule_cuda.py``.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from approximated_personalized_pagerank_tpu.ops import basket as jb
from approximated_personalized_pagerank_tpu.ops import merge as jm

import approximated_personalized_pagerank_tpu_torch as pt
from approximated_personalized_pagerank_tpu_torch.ops import merge_kernel as tk
from approximated_personalized_pagerank_tpu_torch.ops import walk as tw

from test_torch_tie_rule import jax_kernel_body
from test_torch_tie_rule_cuda import _assert_bitwise, _t, dyadic_scales, tied_baskets, tied_rows

jw = importlib.import_module("approximated_personalized_pagerank_tpu.ops.walk")

DAMPING = 0.85


# ------------------------------------------------------------ rows of 8192
@pytest.mark.parametrize("l_pad", [128, 512])
def test_plain_merge_is_the_kernel_body_at_8192(l_pad):
    ids, scores = tied_rows(np.random.default_rng(l_pad), 6, 8192)
    j_ids, j_sc = jax_kernel_body(ids, scores, l_pad)
    t_ids, t_sc = tk.merge_topl_plain(_t(ids), _t(scores), l_pad)
    _assert_bitwise(t_ids, t_sc, j_ids, j_sc)


# ------------------------------------------------------------ gather entry
# one program for both modes: their candidate matrices have one shape
_PALLAS_MERGE = jax.jit(functools.partial(jm._merge_rows, L=30, algo="pallas"))


@pytest.mark.parametrize("mode", ["grank", "mc_combine"])
def test_gather_plain_is_the_pallas_pipeline_on_tied_rows(mode):
    # D*Lb + 1 = 481 pads to 512
    ids, sc, succ, rows = tied_baskets(5, 400, 30, 12, 16, False)
    scale, self_sc, post = dyadic_scales(succ, mode)
    cand_ids, cand_sc, j_post = jm._bucket_candidates(
        jb.Baskets(jnp.asarray(ids), jnp.asarray(sc)), jnp.asarray(rows, dtype=jnp.int32),
        jnp.asarray(succ, dtype=jnp.int32), jnp.float32(0.5), mode)
    want = _PALLAS_MERGE(cand_ids, cand_sc)
    got = tk.gather_merge_topl(_t(ids), _t(sc), _t(succ), _t(rows), scale, self_sc, post,
                               30, 128)
    _assert_bitwise(got.ids, got.scores, want.ids, want.scores * j_post[:, None])


def test_gather_plain_is_the_kernel_body_on_grank_rows_of_8192():
    """Rows of 8192 (81 successors of GRank's layout, -1 tails, and the
    self entry): the candidates of ``_bucket_candidates``, padded as
    ``_merge_rows`` pads them, through the TPU kernel's body."""
    ids, sc, succ, rows = tied_baskets(6, 1500, 100, 6, 81, True)
    scale, self_sc, post = dyadic_scales(succ, "grank")
    cand_ids, cand_sc, j_post = jm._bucket_candidates(
        jb.Baskets(jnp.asarray(ids), jnp.asarray(sc)), jnp.asarray(rows, dtype=jnp.int32),
        jnp.asarray(succ, dtype=jnp.int32), jnp.float32(0.5), "grank")
    c_ids = np.asarray(cand_ids)
    c_ids = np.pad(np.where(c_ids < 0, tk.PAD_ID, c_ids), ((0, 0), (0, 8192 - c_ids.shape[1])),
                   constant_values=tk.PAD_ID)
    c_sc = np.pad(np.asarray(cand_sc), ((0, 0), (0, 8192 - cand_sc.shape[1])))
    j_ids, j_sc = jax_kernel_body(c_ids, c_sc, 128)
    got = tk.gather_merge_topl(_t(ids), _t(sc), _t(succ), _t(rows), scale, self_sc, post,
                               100, 128)
    _assert_bitwise(got.ids, got.scores, j_ids[:, :100], j_sc[:, :100] * np.asarray(j_post)[:, None])


# ---------------------------------------------------------- MC trace top-L
def test_trace_topl_kernel_pipeline_is_the_pallas_one():
    """One chunk of walks (the port's walker, bitwise JAX's): visit counts
    tie in nearly every row, at the cut (L=100 of ~200 visited ids) and
    among the survivors.  The port's ``_trace_topl`` through the kernel
    pipeline on the CPU against JAX's through the Pallas kernel."""
    rng = np.random.default_rng(11)
    n = 3000
    src = np.repeat(np.arange(n), rng.integers(1, 8, n))
    g = pt.Graph.from_edges(src, rng.integers(0, n, src.size), num_nodes=n)
    dg = g.device_graph("cpu")
    sources = torch.arange(0, 2000, 125, dtype=torch.int64)  # 16 sources
    r = 60
    trace, _ = tw.walk_trace_chunk(dg.start_deg, dg.indices, sources, tw.prng_key(9),
                                   torch.tensor(DAMPING), int(r * DAMPING), 8, 2, 32)
    assert trace.shape[1] + 1 == 513  # padded to 1024 in both pipelines
    got = tw._trace_topl(trace, sources, torch.tensor(float(r)), 100, 16, "kernel")
    want_ids, want_sc = jw._trace_topl(jnp.asarray(trace.numpy()),
                                       jnp.asarray(sources.numpy(), dtype=jnp.int32),
                                       jnp.float32(r), 100, 16, algo="pallas")
    assert int((np.asarray(want_ids) >= 0).sum(axis=1).min()) == 100  # cut inside the row
    _assert_bitwise(got.ids, got.scores, want_ids, want_sc)

