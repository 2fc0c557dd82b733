#!/usr/bin/env python
"""Multi-host (multi-process) distributed sweep demo.

Runs the sharded trace-once flux map across SEVERAL JAX PROCESSES joined via
``jax.distributed`` — the multi-node story the reference never had
(SURVEY.md §5.8).  Each process contributes its local devices to one global mesh; the
sweep code is unchanged (single-controller JAX).

Demo/CI usage (CPU, one virtual device per process):

    python tools/multihost_demo.py --launch 2

The demo pins every worker to the CPU.  A multi-process run on GPUs
gives each process its own card (a JAX process reserves most of a card's
memory, so two on one card fail); run one copy per card or host with the
coordinator address of process 0:

    python tools/multihost_demo.py --coordinator <host0>:9876 \
        --num-processes <H> --process-id <i>
"""

import argparse
import os
import subprocess
import sys


def worker(coordinator: str, num_processes: int, process_id: int,
           n_rays: int) -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
    # persistent compile cache — a fresh process pays full XLA compiles
    # otherwise (same directory as tests/conftest.py)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from altair_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    # bounded join: if the coordinator died (or lost the port race, see
    # launch()) fail this attempt in 120 s instead of jax's default 300 s
    # so the launcher's retry still fits the test's 560 s budget
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id,
                               initialization_timeout=120)

    from altair_tpu import DetectorGrid, SCENE_OPTIMIZE, SOURCE_OVERNIGHT, TraceConfig
    from altair_tpu.parallel import make_mesh, sharded_fluxmap

    mesh = make_mesh()
    scene = SCENE_OPTIMIZE.with_(max_bounces=512)
    grid = DetectorGrid(n_theta=6, n_phi=4)
    counts, n_exit = sharded_fluxmap(
        mesh, jax.random.key(0), scene, SOURCE_OVERNIGHT, grid, n_rays,
        TraceConfig(block_iters=16))
    # every process holds the same psum-merged result
    import numpy as np

    total = int(np.asarray(counts).sum())
    frac = int(n_exit) / n_rays
    print(f"[process {process_id}/{num_processes}] devices="
          f"{jax.device_count()} (local {jax.local_device_count()}) "
          f"hits={total} exit_frac={frac:.4f}", flush=True)
    assert 0.38 < frac < 0.47, frac

    # the sharded binomial retrace engine over the same cluster: shared
    # sample split across processes, one psum, replicated draws — every
    # process must hold the identical map
    from altair_tpu.parallel import sharded_retrace_binomial

    counts_b = sharded_retrace_binomial(
        mesh, jax.random.key(1), scene, SOURCE_OVERNIGHT, grid, 512,
        TraceConfig(block_iters=16), oversample=16)
    print(f"[process {process_id}/{num_processes}] binomial_hits="
          f"{int(np.asarray(counts_b).sum())}", flush=True)
    return 0


def _free_port() -> int:
    """OS-assigned free TCP port.  A fixed port made concurrent runs of
    the demo (e.g. two pytest processes on one box) collide on the
    coordinator bind; the small bind-then-release race that remains is
    covered by the retry in ``launch``."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(n_processes: int, n_rays: int, attempts: int = 2) -> int:
    """Spawn n worker processes on this machine (CPU backend).

    Cluster bring-up on a loaded 1-core host is timing-sensitive
    (coordinator bind + N gRPC joins racing arbitrary CPU load), so a
    failed attempt is retried once on a fresh port before reporting
    failure."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    rc = 1
    for attempt in range(attempts):
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--coordinator",
             f"localhost:{port}", "--num-processes", str(n_processes),
             "--process-id", str(i), "--rays", str(n_rays)],
            env=env) for i in range(n_processes)]
        rc = 0
        # one SHARED deadline for the attempt: sequential per-worker
        # timeouts would let N hung workers burn N*600 s while still
        # loading the 1-core box (ADVICE r4 + review r5 #4)
        import time

        deadline = time.monotonic() + 600
        for p in procs:
            try:
                rc |= p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc |= 1
        if rc != 0:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        if rc == 0:
            return 0
        print(f"[launch] attempt {attempt + 1}/{attempts} failed rc={rc}"
              + (", retrying on a fresh port" if attempt + 1 < attempts
                 else ""), flush=True)
    return rc


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--launch", type=int, default=None,
                    help="spawn N local worker processes (demo mode)")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--rays", type=int, default=16_384)
    args = ap.parse_args()
    if args.launch:
        return launch(args.launch, args.rays)
    return worker(args.coordinator, args.num_processes, args.process_id,
                  args.rays)


if __name__ == "__main__":
    sys.exit(main())
