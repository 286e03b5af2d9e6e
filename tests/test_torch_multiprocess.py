"""The port's ring across processes: 2 processes x 2 CPU shards over gloo
run one ring GRank; the rotation crosses the process boundary through
``torch.distributed`` point-to-point copies and the convergence max through
``all_reduce``.  Each process checks its own rows against a serial run
(tests/torch_multiprocess_worker.py), as tests/test_multihost.py does for
the JAX package.
"""

import os
import socket
import subprocess
import sys

WORKER = os.path.join(os.path.dirname(__file__), "torch_multiprocess_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_ring_matches_serial():
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen([sys.executable, WORKER, str(i), "2", str(port)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         env=env, cwd=repo)
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-4000:]}"
        assert f"proc {i}: OK" in out
