"""The sort pipeline's run sums (ops/basket.py::run_sums): a log-step
segmented scan in elementwise ops, held on the CPU against the
``scatter_add_`` formula it replaced (kept here only, as the reference) and
on the card for equal bits across repeats, since it adds through no
atomics."""

import numpy as np
import pytest
import torch

from approximated_personalized_pagerank_tpu_torch.ops import basket as tb
from approximated_personalized_pagerank_tpu_torch.ops import merge as tm
from approximated_personalized_pagerank_tpu_torch.ops import merge_kernel as tk
from approximated_personalized_pagerank_tpu_torch.utils.compare import topl_max_error

ATOL = 1e-6


def scatter_add_combine(ids, scores):
    """The old ``combine_sorted_runs``: run totals through ``scatter_add_``."""
    run = tb.run_index(ids)
    totals = torch.zeros(ids.shape, dtype=torch.float32, device=ids.device)
    totals.scatter_add_(-1, run, scores.to(torch.float32))
    live = tb.run_ends(ids) & (ids >= 0)
    out_ids = torch.where(live, ids, torch.full_like(ids, tb.SENTINEL))
    return out_ids, torch.where(live, torch.gather(totals, -1, run), 0.0)


def scatter_add_merge_plain(ids, scores, l_pad):
    """The old ``merge_topl_plain``, compacting runs through ``scatter_add_``."""
    ids_s, sc_s = tb.sort_rows_by_id(ids, scores)
    run = tb.run_index(ids_s)
    run_ids = torch.full_like(ids_s, tk.PAD_ID).scatter_(-1, run, ids_s)
    run_sc = torch.zeros_like(sc_s).scatter_add_(-1, run, sc_s)
    live = (run_ids >= 0) & (run_ids != tk.PAD_ID)
    key = torch.where(live, run_sc, torch.full_like(run_sc, float("-inf")))
    top_key, top_pos = torch.topk(key, l_pad, dim=-1)
    top_live = top_key > float("-inf")
    out_ids = torch.where(top_live, torch.gather(run_ids, -1, top_pos), -1).to(torch.int32)
    return out_ids, torch.where(top_live, top_key, 0.0)


def candidates(rng, rows, w, id_hi, dead=-1, dead_share=0.2):
    """GRank-like candidate rows: ids drawn from ``id_hi`` values (so runs
    run long when ``id_hi`` is small), scores of at most unit mass a row,
    a share of dead slots."""
    ids = rng.integers(0, id_hi, (rows, w)).astype(np.int32)
    ids[rng.random((rows, w)) < dead_share] = dead
    sc = np.where(ids != dead, rng.random((rows, w)) / w, 0).astype(np.float32)
    return torch.as_tensor(ids), torch.as_tensor(sc)


@pytest.mark.parametrize("w,id_hi", [(1, 3), (2, 2), (3, 2), (201, 7), (201, 300),
                                     (1000, 10), (4097, 40)])
def test_run_sums_match_scatter_add(rng, w, id_hi):
    ids, sc = tb.sort_rows_by_id(*candidates(rng, 64, w, id_hi))
    runs = torch.unique_consecutive(ids[0], return_counts=True)[1]
    assert w < 4 or int(runs.max()) > 2  # runs longer than two terms
    new_ids, new_sc = tb.combine_sorted_runs(ids, sc)
    old_ids, old_sc = scatter_add_combine(ids, sc)
    assert torch.equal(new_ids, old_ids)
    assert float((new_sc - old_sc).abs().max()) <= ATOL


def test_run_sums_are_sequential_for_short_runs_and_free_of_position():
    ids = torch.tensor([[-1, 3, 3, 5, 9, 9, 9]], dtype=torch.int32)
    sc = torch.tensor([[0.0, 0.25, 0.5, 1.0, 0.125, 0.0625, 0.03125]])
    totals = tb.run_sums(ids, sc)
    assert totals[0, 2] == 0.75 and totals[0, 3] == 1.0
    assert totals[0, 6] == 0.125 + 0.0625 + 0.03125
    # a run's total does not depend on where the run sits in its row
    rng = np.random.default_rng(5)
    vals = torch.as_tensor(rng.random(37).astype(np.float32))
    totals = []
    for lead in (0, 1, 6, 21):
        row_ids = torch.cat([torch.arange(lead, dtype=torch.int32),
                             torch.full((37,), 100, dtype=torch.int32)])
        row_sc = torch.cat([torch.ones(lead), vals])
        totals.append(tb.run_sums(row_ids[None], row_sc[None])[0, -1])
    assert all(t.view(torch.int32) == totals[0].view(torch.int32) for t in totals)


@pytest.mark.parametrize("lists", [1, 2, 3, 5])
def test_bounded_scan_gives_the_full_scans_bits(rng, lists):
    """Rows joined from ``lists`` lists of distinct ids (as merge_bucket's
    successor baskets plus the self entry): the scan bounded by ``lists``
    gives the full-width scan's bits, and norm1_rows' one pass its value."""
    parts = [torch.as_tensor(np.stack([rng.permutation(60)[:40] for _ in range(30)]))
             for _ in range(lists)]
    ids = torch.cat(parts, dim=-1).to(torch.int32)
    sc = torch.as_tensor(rng.random(ids.shape).astype(np.float32)) / ids.shape[1]
    s_ids, s_sc = tb.sort_rows_by_id(ids, sc)
    full = tb.combine_sorted_runs(s_ids, s_sc)
    bounded = tb.combine_sorted_runs(s_ids, s_sc, max_run=lists)
    assert torch.equal(full[0], bounded[0])
    assert torch.equal(full[1].view(torch.int32), bounded[1].view(torch.int32))
    merged = tm._merge_rows(ids, sc, 20, "sort", lists=lists)
    assert torch.equal(merged.scores, tm._merge_rows(ids, sc, 20, "sort").scores)
    a = tb.Baskets(ids[:, :40], sc[:, :40])  # two baskets: distinct ids a row
    b = merged
    cat_ids, cat_sc = tb.sort_rows_by_id(torch.cat([a.ids, b.ids], -1),
                                         torch.cat([a.scores, -b.scores], -1))
    o_ids, o_diff = scatter_add_combine(cat_ids, cat_sc)
    assert torch.allclose(tb.norm1_rows(a, b),
                          torch.where(o_ids >= 0, o_diff.abs(), 0.0).sum(-1), atol=ATOL)


@pytest.mark.parametrize("w,id_hi,l_pad", [(256, 20, 128), (1024, 500, 128), (8192, 2000, 256)])
def test_merge_topl_plain_matches_scatter_add(rng, w, id_hi, l_pad):
    ids, sc = candidates(rng, 40, w, id_hi, dead=tk.PAD_ID)
    new = tk.merge_topl_plain(ids, sc, l_pad)
    old = scatter_add_merge_plain(ids, sc, l_pad)
    topl_max_error(new[0].numpy(), new[1].numpy(), old[0].numpy(), old[1].numpy(), ATOL)


def test_sort_pipeline_and_norm1_match_scatter_add(rng):
    ids, sc = candidates(rng, 50, 201, 60)
    new = tm._merge_rows(ids, sc, 100, "sort")
    s_ids, s_sc = tb.sort_rows_by_id(ids, sc)
    old = tb.keep_top(*scatter_add_combine(s_ids, s_sc), 100)
    topl_max_error(new.ids.numpy(), new.scores.numpy(), old.ids.numpy(), old.scores.numpy(),
                   ATOL)
    a = tb.keep_top(*tb.combine_sorted_runs(s_ids, s_sc), 100)
    b = tb.keep_top(*tb.combine_sorted_runs(*tb.sort_rows_by_id(*candidates(rng, 50, 201, 60))),
                    100)
    cat_ids, cat_sc = tb.sort_rows_by_id(torch.cat([a.ids, b.ids], -1),
                                         torch.cat([a.scores, -b.scores], -1))
    o_ids, o_diff = scatter_add_combine(cat_ids, cat_sc)
    old_l1 = torch.where(o_ids >= 0, o_diff.abs(), 0.0).sum(-1)
    assert float((tb.norm1_rows(a, b) - old_l1).abs().max()) <= ATOL


def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: repeat-run bits are a property of the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_run_sums_repeat_bitwise(rng):
    dev = cuda()
    ids, sc = candidates(rng, 64, 16384, 300)
    ids, sc = ids.to(dev), sc.to(dev)
    runs = [tm._merge_rows(ids, sc, 100, "kernel") for _ in range(3)]
    half = tb.Baskets(runs[0].ids[:32], runs[0].scores[:32])
    other = tb.Baskets(runs[0].ids[32:], runs[0].scores[32:])
    l1 = [tb.norm1_rows(half, other) for _ in range(3)]
    plain = [tk.merge_topl_plain(torch.where(ids < 0, tk.PAD_ID, ids)[:, :8192],
                                 sc[:, :8192], 256) for _ in range(3)]
    for r in (1, 2):
        assert torch.equal(runs[r].ids, runs[0].ids)
        assert torch.equal(runs[r].scores.view(torch.int32), runs[0].scores.view(torch.int32))
        assert torch.equal(l1[r].view(torch.int32), l1[0].view(torch.int32))
        assert torch.equal(plain[r][1].view(torch.int32), plain[0][1].view(torch.int32))
    cpu = tm._merge_rows(ids.cpu(), sc.cpu(), 100, "sort")
    topl_max_error(runs[0].ids.cpu().numpy(), runs[0].scores.cpu().numpy(),
                   cpu.ids.numpy(), cpu.scores.numpy(), ATOL)
