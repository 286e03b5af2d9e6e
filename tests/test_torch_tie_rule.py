"""The merge kernel's rule for tied totals, held against the TPU kernel's.

The JAX package's fused merge (``ops/pallas/merge_kernel.py``) sums each
run of equal ids into the run's last slot of the id-sorted row and cuts
with ``bitonic_prune_topk``, a network that compares scores alone: which of
equal totals survive, and their order, follow from each total's position
and the network's shape.  The port's kernel pipeline computes that same
function (``ops/merge_kernel.py``, module doc).  Every row here has dyadic
scores from three values (``test_torch_tie_rule_cuda.py``), so every run
sum is exact and totals tie at the cut and among the survivors; the
comparisons are bitwise in ids, scores and order.  Here the matrix entry's
plain version against the TPU kernel: in Pallas interpret mode once, and
at the other widths against the kernel's body in plain jnp (the same
function, which compiles in a fraction of interpret mode's time); and
``PPR_TORCH_MERGE_ALGO``.  The gather entry, rows of 8192 and the MC trace
top-L are in ``test_torch_tie_rule_paths.py``; the kernel against its
plain version on the card in ``test_torch_tie_rule_cuda.py``.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from approximated_personalized_pagerank_tpu.ops.bitonic import (
    bitonic_prune_topk,
    segmented_sum_sorted,
)
from approximated_personalized_pagerank_tpu.ops.pallas.merge_kernel import (
    fused_merge_topl as j_fused,
)

from approximated_personalized_pagerank_tpu_torch.ops import merge as tm
from approximated_personalized_pagerank_tpu_torch.ops import merge_kernel as tk

from test_torch_tie_rule_cuda import _assert_bitwise, _t, tied_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.partial(jax.jit, static_argnums=2)
def _body_after_sort(ids, scores, l_pad):
    return bitonic_prune_topk(*segmented_sum_sorted(ids, scores), l_pad)


def jax_kernel_body(ids, scores, l_pad):
    """The TPU kernel's body after its sort: rows sorted by id here (the
    order inside a run does not change an exact sum), then
    ``segmented_sum_sorted`` and ``bitonic_prune_topk`` in plain jnp."""
    order = np.argsort(ids, axis=1, kind="stable")
    s_ids = np.take_along_axis(ids, order, axis=1)
    s_sc = np.take_along_axis(scores, order, axis=1)
    out_ids, out_sc = _body_after_sort(jnp.asarray(s_ids), jnp.asarray(s_sc), l_pad)
    return np.asarray(out_ids), np.asarray(out_sc)


# ------------------------------------------------------------ matrix entry
@pytest.mark.parametrize("w,l_pad", [(256, 128), (256, 256), (512, 128), (512, 256),
                                     (1024, 128), (1024, 256)])
def test_plain_merge_is_the_pallas_kernel_on_tied_rows(w, l_pad):
    """The TPU kernel itself (Pallas interpret) at (256, 256), its body in
    jnp at the other shapes."""
    ids, scores = tied_rows(np.random.default_rng(w + l_pad), 4, w)
    if (w, l_pad) == (256, 256):
        j_ids, j_sc = j_fused(jnp.asarray(ids), jnp.asarray(scores), l_pad, interpret=True)
    else:
        j_ids, j_sc = jax_kernel_body(ids, scores, l_pad)
    t_ids, t_sc = tk.fused_merge_topl(_t(ids), _t(scores), l_pad)
    _assert_bitwise(t_ids, t_sc, j_ids, j_sc)


def test_negative_ids_are_dead_slots_at_the_tail():
    """A -1 candidate is PAD in the TPU kernel's row (``_merge_rows`` maps
    it there before the kernel): it shifts no total's position."""
    ids, scores = tied_rows(np.random.default_rng(3), 4, 512, pad=-1)
    j_ids, j_sc = jax_kernel_body(np.where(ids < 0, tk.PAD_ID, ids), scores, 128)
    t_ids, t_sc = tk.merge_topl_plain(_t(ids), _t(scores), 128)
    _assert_bitwise(t_ids, t_sc, j_ids, j_sc)


# ------------------------------------------------------ PPR_TORCH_MERGE_ALGO
def test_merge_algo_env_sets_the_default_pipeline(monkeypatch):
    """PPR_TORCH_MERGE_ALGO names the pipeline of a call that names none; a
    call that names one keeps it; unset, the device decides.  On CUDA it
    may name only the kernel, and the JAX package's PPR_MERGE_ALGO, whose
    values differ, does not reach the port."""
    monkeypatch.delenv(tm.MERGE_ALGO_ENV, raising=False)
    assert tm.resolve_merge_algo(None, torch.device("cpu")) == "sort"
    monkeypatch.setenv(tm.MERGE_ALGO_ENV, "sort")
    with pytest.raises(ValueError, match="off the CUDA kernel"):
        tm.resolve_merge_algo(None, torch.device("cuda"))
    assert tm.resolve_merge_algo("sort", torch.device("cuda")) == "sort"
    monkeypatch.setenv(tm.MERGE_ALGO_ENV, "bitonic")
    with pytest.raises(ValueError, match="unknown merge algo"):
        tm.resolve_merge_algo(None, torch.device("cpu"))
    env = dict(os.environ, PPR_TORCH_MERGE_ALGO="kernel:4096", PPR_MERGE_ALGO="pallas")
    code = ("import torch\n"
            "from approximated_personalized_pagerank_tpu_torch.ops import merge\n"
            "cpu = torch.device('cpu')\n"
            "print(merge.resolve_merge_algo(None, cpu), merge.resolve_merge_algo('sort', cpu))\n"
            "del merge.os.environ['PPR_TORCH_MERGE_ALGO']\n"
            "print(merge.resolve_merge_algo(None, cpu), "
            "merge.resolve_merge_algo(None, torch.device('cuda')))\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True,
                         text=True, check=True)
    assert out.stdout.split() == ["kernel:4096", "sort", "sort", "kernel"]
