#!/usr/bin/env python
"""Benchmark suite — re-runs every workload of the reference baseline table
(BASELINE.md / SURVEY.md §6) on the current backend and reports side-by-side.

Usage:  python benchmarks/run_all.py [--quick] [--json OUT.json]

Workloads:
  traceonce   100k rays + 180x90 map  (ref best total: 210.5 s)
  tracing     100k-ray tracing phase alone  (ref: 0.92-7.43 s)
  scoring     16,200-position scoring phase alone  (ref: 104-2,191 s)
  retrace     the full retrace sweep, 50k rays/position  (ref: 7,926 s;
              run at full scale only without --quick — 8.1e8 traces)
  exitfrac    exit-fraction invariants per port angle (validates physics)
  throughput  sustained trace throughput (rays/s, large batch)
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _util import atomic_json_dump  # noqa: E402

REF = {
    "traceonce_total_s": 210.5,
    "tracing_phase_s": 0.92,
    "scoring_phase_s": 103.9,
    "retrace_total_s": 7926.4,
    "throughput_rays_s": 1.0e5,
}

# Published peaks per device kind, for the roofline shares (NVIDIA's H100
# data sheet, SXM part, dense, at the full 700 W power limit; a card set
# below it cannot hold these under load, so report its power limit beside
# any share).  A device that is not listed gets no shares: a peak is never
# assumed.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "fp32_flops": 67e12,        # CUDA cores, outside the tensor cores
        "tf32_flops": 495e12,       # tensor cores
        "hbm_bytes_s": 3.35e12,
    },
}


def peaks_for(device_kind: str) -> dict | None:
    """The peak table row for ``device_kind``, or None if it is unknown."""
    return PEAKS.get(device_kind)


def roofline(scene, src, cfg, log, timeit, peaks):
    """MFU / roofline accounting for the two hot phases.

    FLOPs-per-bounce comes from XLA's own cost analysis of ONE compiled
    bounce step (no hand count to go stale); the lane-iteration rate is
    measured on a fixed-K loop so lane-iterations are exact (every lane
    computes every iteration in this SIMD design, dead or alive).
    """
    import jax
    import jax.numpy as jnp

    from altair_tpu.config import TraceConfig
    from altair_tpu.core.geometry import Vec3
    from altair_tpu.core.trace import make_bounce_step, trace_rays

    N = 1 << 20

    # ---- cost model of one bounce step -----------------------------------
    step = make_bounce_step(jax.random.key(0), scene, N, cfg)
    z = jnp.zeros((N,), cfg.dtype)
    carry = (Vec3(z, z, z), Vec3(z + 1.0, z, z), Vec3(z, z, z),
             jnp.zeros((N,), jnp.int32), jnp.zeros((N,), jnp.int32),
             jnp.zeros((N,), bool))
    compiled = jax.jit(lambda c: step(0, c)).lower(carry).compile()
    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    flops_per_bounce = float(ca.get("flops", 0.0)) / N
    transc_per_bounce = float(ca.get("transcendentals", 0.0)) / N
    bytes_per_bounce = float(ca.get("bytes accessed", 0.0)) / N
    log("flops_per_lane_bounce", round(flops_per_bounce, 1))
    log("transcendentals_per_lane_bounce", round(transc_per_bounce, 1))
    log("bytes_per_lane_bounce", round(bytes_per_bounce, 1))

    # ---- measured lane-iteration rate (fixed K iterations, exact count) --
    K = 256
    sc_k = scene.with_(max_bounces=K)
    cfg_k = TraceConfig(dtype=cfg.dtype, block_iters=K,
                        rng_impl=cfg.rng_impl)
    f = jax.jit(lambda k: trace_rays(k, sc_k, src, N, cfg_k).status.sum())
    t = timeit(f, jax.random.key(1), repeats=2)
    lane_iters_s = N * K / t
    flops_s = lane_iters_s * flops_per_bounce
    bytes_s = lane_iters_s * bytes_per_bounce
    log("trace_lane_iters_per_s", round(lane_iters_s))
    log("trace_achieved_flops_s", round(flops_s))
    if peaks:
        log("trace_fp32_share_pct", 100 * flops_s / peaks["fp32_flops"])
        log("trace_hbm_share_pct", 100 * bytes_s / peaks["hbm_bytes_s"])

    # ---- score phase ------------------------------------------------------
    from altair_tpu import DetectorGrid
    from altair_tpu.core.score import fluxmap_trace_once

    grid = DetectorGrid()
    n_score = 100_000
    res = jax.jit(lambda k: trace_rays(k, scene, src, n_score, cfg))(
        jax.random.key(2))
    jax.block_until_ready(res)
    fscore = jax.jit(lambda r: fluxmap_trace_once(r, grid).sum())
    ca2 = fscore.lower(res).compile().cost_analysis()
    ca2 = ca2[0] if isinstance(ca2, list) else ca2
    score_flops = float(ca2.get("flops", 0.0))
    t2 = timeit(fscore, res, repeats=3)
    log("score_flops", round(score_flops))
    log("score_achieved_flops_s", round(score_flops / t2))
    if peaks:
        # the scorer's products run at Precision.HIGHEST: full fp32
        log("score_fp32_share_pct",
            100 * score_flops / t2 / peaks["fp32_flops"])
    intensity = (flops_per_bounce / bytes_per_bounce
                 if bytes_per_bounce else float("nan"))
    log("trace_arith_intensity_flop_per_byte", round(intensity, 2))


def _readback(x):
    import jax
    import jax.numpy as jnp
    jax.block_until_ready(x)
    return float(jnp.asarray(jax.tree.leaves(x)[0]).ravel()[0])


def timeit(f, *args, repeats=3):
    _readback(f(*args))  # compile
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        _readback(f(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="skip the full-scale retrace sweep")
    ap.add_argument("--json", default=None)
    ap.add_argument("--max-bounces", type=int, default=4096)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from altair_tpu import (
        DetectorGrid, SCENE_OPTIMIZE, SOURCE_OVERNIGHT, TraceConfig)
    from altair_tpu.core.score import fluxmap_retrace, fluxmap_trace_once
    from altair_tpu.core.trace import trace_rays
    from altair_tpu.core.trace_waves import trace_rays_auto

    scene = SCENE_OPTIMIZE.with_(max_bounces=args.max_bounces)
    src = SOURCE_OVERNIGHT
    grid = DetectorGrid()
    cfg = TraceConfig()
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"no GPU: JAX's first device is {jax.devices()[0]}")
    dev = jax.devices()[0].device_kind
    out = {"device": dev, "platform": "gpu"}

    def log(k, v):
        out[k] = v
        print(f"[{k}] {v}", flush=True)
        if args.json:  # incremental: a timeout mid-run keeps prior rows
            atomic_json_dump(args.json, out)

    # -- trace-once total (the bench.py headline; production engine) -------
    f = jax.jit(lambda k: fluxmap_trace_once(
        trace_rays_auto(k, scene, src, 100_000, cfg), grid).sum())
    log("traceonce_total_s", timeit(f, jax.random.key(0)))

    # -- tracing phase alone (production engine dispatch) -------------------
    f = jax.jit(lambda k: trace_rays_auto(k, scene, src, 100_000, cfg)
                .status.sum())
    log("tracing_phase_s", timeit(f, jax.random.key(0)))

    # -- bounce-simulating engine (the GPU bounce kernel), for comparison ---
    cfg_sim = TraceConfig(engine="simulate")
    f = jax.jit(lambda k: trace_rays_auto(k, scene, src, 100_000, cfg_sim)
                .status.sum())
    log("tracing_phase_simulate_s", timeit(f, jax.random.key(0)))

    # -- XLA while-loop kernel tier, for comparison -------------------------
    f = jax.jit(lambda k: trace_rays(k, scene, src, 100_000, cfg)
                .status.sum())
    log("tracing_phase_xla_s", timeit(f, jax.random.key(0)))

    # -- scoring phase alone (fixed traced batch) --------------------------
    res = jax.jit(lambda k: trace_rays(k, scene, src, 100_000, cfg))(
        jax.random.key(1))
    jax.block_until_ready(res)
    f = jax.jit(lambda r: fluxmap_trace_once(r, grid).sum())
    log("scoring_phase_s", timeit(f, res))

    # -- compact-scoring variant (gathers the ~43k exits first; the scorer
    # the production trace-once driver actually dispatches) -----------------
    from altair_tpu.core.score import exit_capacity, fluxmap_trace_once_compact
    cap = exit_capacity(scene, 100_000)
    f = jax.jit(lambda r: fluxmap_trace_once_compact(r, grid, cap)[0].sum())
    log("scoring_phase_compact_s", timeit(f, res))

    # -- throughput (large batch) --------------------------------------------
    n_big = 16_000_000
    f = jax.jit(lambda k: trace_rays_auto(k, scene, src, n_big, cfg).status.sum())
    t = timeit(f, jax.random.key(2), repeats=2)
    log("throughput_rays_s", n_big / t)
    f = jax.jit(lambda k: trace_rays_auto(k, scene, src, n_big, cfg_sim)
                .status.sum())
    t = timeit(f, jax.random.key(2), repeats=2)
    log("throughput_simulate_rays_s", n_big / t)
    # the non-Lambertian PRODUCTION path (nonLambertianFlux.C:307-387):
    # MIXED_BRDF walls route through the bounce kernel + rim post-pass
    # with the 7-draw BRDF scatter in-kernel
    from altair_tpu.config import SurfaceModel
    sc_brdf = scene.with_(surface_model=SurfaceModel.MIXED_BRDF)
    f = jax.jit(lambda k: trace_rays_auto(k, sc_brdf, src, n_big, cfg)
                .status.sum())
    t = timeit(f, jax.random.key(2), repeats=2)
    log("throughput_brdf_rays_s", n_big / t)

    # -- roofline / MFU accounting ------------------------------------------
    roofline(scene, src, cfg, log, timeit, peaks_for(dev))

    # -- exit-fraction invariants ------------------------------------------
    fracs = {}
    for port, corpus in ((160.0, 0.748), (164.0, 0.655), (170.0, 0.425)):
        sc = scene.with_(theta_max_deg=port)
        r = jax.jit(lambda k, sc=sc: trace_rays(k, sc, src, 100_000, cfg)
                    .exited_port_mask(sc.exit_port_z).sum())(jax.random.key(3))
        fracs[str(int(port))] = {"ours": float(r) / 100_000, "corpus": corpus}
    out["exit_fractions"] = fracs

    # -- binomial retrace engine: the same 16,200-cell retrace-statistics
    # map from ONE shared 6.4M-ray sample + per-cell binomial draws
    # (1/128 = 0.8% excess variance; core/score.py:fluxmap_retrace_binomial)
    from altair_tpu.core.score import fluxmap_retrace_binomial
    f = jax.jit(lambda k: fluxmap_retrace_binomial(
        k, scene, src, grid, 50_000, cfg, oversample=128).sum())
    log("retrace_binomial_total_s", timeit(f, jax.random.key(5)))

    # -- full retrace sweep (8.1e8 traces, split into host-level calls) ------
    if not args.quick:
        import dataclasses
        from altair_tpu.core.score import grid_centers_normals
        rows_per_call = 10  # 10 theta rows x 90 phi x 50k = 4.5e7 rays/call
        sub_shape = dataclasses.replace(grid, n_theta=rows_per_call)
        C, Nrm = grid_centers_normals(grid, scene.exit_port_z)
        P_sub = rows_per_call * grid.n_phi
        # chunk 32 positions/scan step = 1.6M rays per device iteration
        # (chosen on an earlier build, not yet measured on the H100)
        run_sub = jax.jit(lambda k, c, n: fluxmap_retrace(
            k, scene, src, sub_shape, 50_000, cfg, pos_chunk=32,
            centers_normals=(c, n)).sum())
        # one compile serves every sub-grid (placement is dynamic)
        _readback(run_sub(jax.random.key(4), C[:P_sub], Nrm[:P_sub]))
        t0 = time.perf_counter()
        for i in range(grid.n_theta // rows_per_call):
            sl = slice(i * P_sub, (i + 1) * P_sub)
            _readback(run_sub(jax.random.fold_in(jax.random.key(4), i),
                              C[sl], Nrm[sl]))
            print(f"  retrace rows {i * rows_per_call}-"
                  f"{(i + 1) * rows_per_call - 1} done "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
        log("retrace_total_s", time.perf_counter() - t0)

    # -- report -------------------------------------------------------------
    print(f"\n== altair benchmarks on {dev} ==\n")
    rows = [
        ("trace-once total (100k rays, 180x90)", "traceonce_total_s"),
        ("tracing phase (100k rays)", "tracing_phase_s"),
        ("scoring phase (16,200 positions)", "scoring_phase_s"),
        ("retrace sweep (8.1e8 traces)", "retrace_total_s"),
        ("retrace map, binomial engine", "retrace_binomial_total_s"),
    ]
    for label, key in rows:
        if key not in out:
            continue
        ref = REF.get(key, REF["retrace_total_s"])
        ours = out[key]
        print(f"{label:42s} {ours:10.4f} s   ref {ref:10.1f} s   "
              f"x{ref / ours:,.0f}")
    print(f"{'sustained throughput':42s} {out['throughput_rays_s']:,.0f} "
          f"rays/s   ref {REF['throughput_rays_s']:,.0f}   "
          f"x{out['throughput_rays_s'] / REF['throughput_rays_s']:,.0f}")
    for port, v in out["exit_fractions"].items():
        print(f"exit fraction port {port}: {v['ours']:.4f} "
              f"(corpus {v['corpus']:.3f})")

    if args.json:
        atomic_json_dump(args.json, out)
        print(f"\nwrote {args.json}")


if __name__ == "__main__":
    main()
