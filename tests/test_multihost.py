"""Multi-process distributed sweep (real jax.distributed over local gRPC).

Spawns 2 CPU-backend worker processes via tools/multihost_demo.py; each
joins the cluster, contributes one device to the global mesh, runs the
sharded sweep, and asserts the psum-merged physics.  This is the
multi-process integration test (SURVEY.md §5.8) — heavier than the in-process 8-device
mesh tests, so it runs a tiny workload.
"""

import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow  # spawns a 2-process jax.distributed cluster


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.timeout(600)
def test_two_process_distributed_sweep():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)  # one device per process
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "multihost_demo.py"),
         "--launch", "2", "--rays", "8192"],
        env=env, capture_output=True, text=True, timeout=560)
    assert out.returncode == 0, out.stderr[-2000:]
    stdout = out.stdout
    assert "[process 0/2]" in stdout and "[process 1/2]" in stdout
    # both processes print the same psum-merged hit count
    lines = [l for l in stdout.splitlines()
             if "hits=" in l and "binomial" not in l]
    hits = {l.split("hits=")[1].split()[0] for l in lines}
    assert len(hits) == 1, lines
    # and the same replicated binomial retrace map (across processes)
    blines = [l for l in stdout.splitlines() if "binomial_hits=" in l]
    assert len(blines) == 2, stdout
    bhits = {l.split("binomial_hits=")[1].split()[0] for l in blines}
    assert len(bhits) == 1, blines
