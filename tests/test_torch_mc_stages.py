"""``mc_tie_study.py stages`` and its ``compare``, on a 300-node graph.

The instrument runs MC stage by stage through each package's own
functions; each staged final must be its package's one-call result bit for
bit, and ``compare`` must report every stage of the pair port / jax-sort,
with the port's passes also run from the JAX run's input to them.  On one
shared input the two sort pipelines part only at ties and in the order of
sums.
"""

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("walk", "pass1", "pass2", "final")


def _study(out, *args):
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "mc_tie_study.py"), *args,
                          "--nodes", "300", "--out", str(out)],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    return res.stdout


def test_stages_and_compare(tmp_path):
    runs = {}
    for mode, extra in (("jax-sort", ()), ("port", ("--from", "jax-sort"))):
        _study(tmp_path, "stages", mode, *extra)
        with np.load(tmp_path / f"stages_300_{mode}_seed1.npz") as f:
            runs[mode] = json.loads(str(f["figures"]))
            assert f["final_ids"].shape == (300, 50)
            assert f["walk_ids"].shape == f["pass2_ids"].shape == (300, 100)
        assert runs[mode]["one_call_sha256"] == runs[mode]["sha256"]["final"]
    # the walks are bitwise JAX's, so the first stage's digests agree
    assert runs["port"]["sha256"]["walk"] == runs["jax-sort"]["sha256"]["walk"]

    report = json.loads(_study(tmp_path, "compare"))
    pair = report["port_vs_jax-sort"]
    assert set(pair) == set(STAGES) | {s + "_shared" for s in STAGES[1:]}
    assert pair["walk"]["identical_rows"] == 300
    for stage in STAGES[1:]:
        assert pair[stage + "_shared"]["rows_beyond_ties_and_sum_order"] == 0
        assert pair[stage + "_shared"]["max_abs_score_diff_shared_ids"] <= 2e-6
    for mode in runs:
        assert set(report["quality"][mode]) >= set(STAGES)
        assert 0.0 < report["quality"][mode]["final"]["jaccard"] <= 1.0
