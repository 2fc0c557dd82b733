#!/usr/bin/env python
"""Headline benchmark — the reference's own headline workload.

Workload: trace 100,000 rays through the production scene (port 170 deg,
reflectance 0.99, roughness 0.01, source (-60, 0, -75) cm, dir (5, 0, 0)) and
score the full 180x90 observer flux map — exactly the job of
``sweepDetectorTraceOnce`` (``fluxAtObserverFast.C:1068-1397``).

Baseline (BASELINE.md): the reference's best total for this exact config is
210.5 s on a 4-thread CPU (trace 0.92-7.4 s + scoring 104-2191 s); the
retrace variant of the same map took 7,926-14,774 s.  ``vs_baseline`` is the
speedup over the reference's BEST trace-once total (210.5 s).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
"""

import argparse
import json
import subprocess
import sys
import time


def _require_gpu():
    """The benchmark measures the GPU: any other backend is an error, with
    one machine-readable JSON line (no retry, no CPU fallback)."""
    import jax

    d = jax.devices()[0]
    if d.platform != "gpu":
        print(json.dumps({
            "metric": "fluxmap_traceonce_100k_180x90_wall",
            "value": None, "unit": "seconds", "vs_baseline": None,
            "error": "no_gpu", "platform": d.platform,
            "device_kind": d.device_kind,
        }))
        sys.exit(1)
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        card = f"nvidia-smi unavailable ({e})"
    sys.stderr.write(f"# card: {card}\n")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=100_000)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--rng", default="rbg", choices=["rbg", "threefry2x32"],
                    help="PRNG implementation (threefry is the strict "
                         "counter-based default elsewhere in the "
                         "framework)")
    ap.add_argument("--max-bounces", type=int, default=4096,
                    help="bounce cap; P(alive > 2000 bounces) < 1e-15 for "
                         "the production scene, so 4096 is exact in practice")
    ap.add_argument("--kmaps", type=int, default=16,
                    help="independent maps fused into ONE device call for "
                         "the amortized-per-map number (K maps per "
                         "dispatch amortize the per-call launch and "
                         "readback)")
    args = ap.parse_args()

    from altair_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    _require_gpu()

    import jax

    from altair_tpu import DetectorGrid, SCENE_OPTIMIZE, SOURCE_OVERNIGHT, TraceConfig
    from altair_tpu.core.score import exit_capacity, fluxmap_trace_once_compact
    from altair_tpu.core.trace_waves import trace_rays_auto as trace_rays

    source = SOURCE_OVERNIGHT
    grid = DetectorGrid()
    cfg = TraceConfig()

    def key(i):
        return jax.random.key(i, impl=args.rng)

    def measure(scene, engine="auto"):
        cap = exit_capacity(scene, args.rays)
        ecfg = TraceConfig(engine=engine)

        @jax.jit
        def fluxmap(k):
            res = trace_rays(k, scene, source, args.rays, ecfg)
            counts, overflow = fluxmap_trace_once_compact(
                res, grid, cap, scene.exit_port_z)
            n_exit = res.exited_port_mask(scene.exit_port_z).sum()
            return counts, n_exit, overflow

        # compile + one full warm execution (excluded, like the reference's
        # ACLiC build); int() forces a device->host readback
        counts, n_exit, overflow = fluxmap(key(0))
        int(n_exit)

        times = []
        for i in range(args.repeats):
            t0 = time.perf_counter()
            counts, n_exit, overflow = fluxmap(key(i + 1))
            # device->host readback inside the timed region
            int(n_exit)
            times.append(time.perf_counter() - t0)
            if int(overflow):
                raise RuntimeError(
                    f"exit-compaction overflow: {int(overflow)}")
        return min(times), times, float(n_exit) / args.rays, counts

    # default physics (exact shell rim, the corpus-exact mode) = headline;
    # simple mode (no rim) = the ceiling, reported alongside.
    # The default engine samples the trace outcome from its closed-form law
    # (core/trace_direct.py, distribution-exact for Lambertian walls); the
    # bounce-simulating engine (the GPU bounce kernel) is reported
    # alongside for the simulation-throughput story.
    scene = SCENE_OPTIMIZE.with_(max_bounces=args.max_bounces)
    wall, times, exit_frac, counts = measure(scene)
    wall_simple, times_s, exit_frac_s, _ = measure(
        scene.with_(exact_rim=False))
    wall_sim, times_k, exit_frac_k, _ = measure(scene, engine="simulate")

    # amortized per-map: K independent full maps (distinct keys) fused into
    # ONE device call — the repeat-runs workflow the reference ran as 3-10
    # separate overnight jobs per directory.
    def measure_kmaps(scene, k_maps):
        import jax.numpy as jnp

        cap = exit_capacity(scene, args.rays)
        ecfg = TraceConfig()

        @jax.jit
        def fluxmaps(k):
            def one(i):
                res = trace_rays(jax.random.fold_in(k, i), scene, source,
                                 args.rays, ecfg)
                counts, overflow = fluxmap_trace_once_compact(
                    res, grid, cap, scene.exit_port_z)
                n_exit = res.exited_port_mask(scene.exit_port_z).sum()
                return counts, n_exit, overflow
            return jax.lax.map(one, jnp.arange(k_maps))

        counts, n_exit, overflow = fluxmaps(key(0))
        int(n_exit.sum())          # compile + warm (forced readback)
        best = None
        for i in range(args.repeats):
            t0 = time.perf_counter()
            counts, n_exit, overflow = fluxmaps(key(i + 1))
            int(n_exit.sum())
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
            if int(overflow.sum()):
                raise RuntimeError("exit-compaction overflow")
        return best / k_maps, float(n_exit.sum()) / (k_maps * args.rays)

    wall_amort, exit_frac_a = measure_kmaps(scene, args.kmaps)

    # the binomial retrace engine: the FULL 16,200-cell retrace-statistics
    # map (reference: 7,926-14,774 s of 8.1e8 traces) from one shared
    # sample — reported alongside for the retrace story
    from altair_tpu.core.score import fluxmap_retrace_binomial

    fb = jax.jit(lambda k: fluxmap_retrace_binomial(
        k, scene, source, grid, 50_000, cfg, oversample=128))
    int(fb(key(0)).sum())  # compile + warm
    tb = []
    for i in range(args.repeats):
        t0 = time.perf_counter()
        int(fb(key(i + 1)).sum())
        tb.append(time.perf_counter() - t0)
    wall_binom = min(tb)
    retrace_baseline_s = 7926.4  # reference sweepDetector best, BASELINE.md

    sys.stderr.write(
        f"# device={jax.devices()[0].device_kind} times={times} "
        f"exit_frac={exit_frac:.4f} (corpus 0.423-0.428) "
        f"peak_frac={float(counts.max()) / args.rays:.5f} | "
        f"simple mode: times={times_s} exit_frac={exit_frac_s:.4f} | "
        f"simulate engine: times={times_k} exit_frac={exit_frac_k:.4f} | "
        f"amortized x{args.kmaps}: {wall_amort:.4f} s/map "
        f"exit_frac={exit_frac_a:.4f}\n")

    baseline_best_s = 210.5  # reference trace-once best total, BASELINE.md
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "fluxmap_traceonce_100k_180x90_wall",
        "value": round(wall, 6),
        "unit": "seconds",
        "vs_baseline": round(baseline_best_s / wall, 2),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "mode": "exact_rim",
        "engine": "direct",
        "amortized_per_map_value": round(wall_amort, 6),
        "amortized_k": args.kmaps,
        "amortized_vs_baseline": round(baseline_best_s / wall_amort, 2),
        "simple_mode_value": round(wall_simple, 6),
        "simple_mode_vs_baseline": round(baseline_best_s / wall_simple, 2),
        "simulate_engine_value": round(wall_sim, 6),
        "simulate_engine_vs_baseline": round(baseline_best_s / wall_sim, 2),
        "retrace_binomial_value": round(wall_binom, 6),
        "retrace_binomial_vs_baseline": round(
            retrace_baseline_s / wall_binom, 2),
    }))


if __name__ == "__main__":
    main()
