#!/usr/bin/env python
"""Smoke test of the flux-map path on an NVIDIA GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded sweeps only

One card, in order (each phase prints one line; any failure exits 1):

* card      ``nvidia-smi`` name and power limit (no card -> exit 1);
* cli       ``python -m altair_tpu.cli fluxmap`` (Lambertian, then
            ``--surface mixed``) as subprocesses, run before this process
            touches the card so that only one process holds it at a time;
* device    JAX's first device must be a GPU (no CPU fallback);
* flagship  ``sweep_detector_trace_once`` at 10^6 rays, direct engine with
            exact rim: exit fraction in the corpus band, 180x90 map, CSV in
            the reference dialect; warm wall time and compile time;
* scorer    Plucker ("mxu") vs exact per-pair scorer on those exits;
* retrace   binomial retrace map vs the trace-once map;
* simulate  the bounce kernel vs the plain ``trace_rays`` reference for all
            four wall laws (exit fraction, mean bounces, KS on exit cos);
* timing    rays/s of ``trace_rays_auto(engine="simulate")`` with the
            kernel against the XLA tiers (kernel switched off).

The last stdout line is one JSON object: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CORPUS_BAND = (0.423, 0.428)        # port-170 exit fraction (BASELINE.md)
HEADER_KEYS = ["Number of rays", "Detector dimensions", "Sphere inner radius",
               "Sphere outer radius", "Exit port angle", "Theta bins",
               "Phi bins", "Mirror reflectance", "Gaussian roughness",
               "Source position (x,y,z)", "Source direction (x,y,z)",
               "Max reflections"]


def report(name: str, ok: bool, detail: str) -> None:
    print(f"[{'ok' if ok else 'FAIL'}] {name}: {detail}", flush=True)
    if not ok:
        raise SystemExit(1)


def binom_sigma2(f1, n1, f2, n2):
    """Two-sample standard error of a difference of two fractions."""
    p = (f1 * n1 + f2 * n2) / (n1 + n2)
    return float(np.sqrt(p * (1 - p) * (1 / n1 + 1 / n2)))


# ---------------------------------------------------------------- phases

def phase_card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (FileNotFoundError, subprocess.TimeoutExpired) as e:
        report("card", False, f"nvidia-smi unavailable ({e}); no GPU")
    lines = out.stdout.strip().splitlines()
    report("card", out.returncode == 0 and bool(lines),
           " | ".join(lines) or out.stderr.strip())
    return lines[0]


def read_csv_map(folder: str):
    from altair_tpu.io import read_fluxmap

    paths = sorted(glob.glob(os.path.join(folder, "*.csv")))
    if len(paths) != 1:
        report("csv", False, f"expected one CSV in {folder}, got {paths}")
    with open(paths[0]) as fh:
        text = fh.read()
    missing = [k for k in HEADER_KEYS if f"# {k}:" not in text]
    theta, phi, frac, meta = read_fluxmap(paths[0])
    return paths[0], frac, missing, meta


def run_cli(name: str, extra: list[str], n_rays: int):
    """One CLI sweep in a child process; returns its exit fraction."""
    with tempfile.TemporaryDirectory() as out:
        cmd = [sys.executable, "-m", "altair_tpu.cli", "fluxmap",
               "--rays", str(n_rays), "--out", out, *extra]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=900)
        dt = time.perf_counter() - t0
        if r.returncode != 0:
            sys.stderr.write(r.stdout[-4000:] + r.stderr[-8000:])
            report(name, False, f"exit code {r.returncode}")
        line = [s for s in r.stdout.splitlines()
                if s.startswith("Total rays exiting port:")]
        n_exit = int(line[-1].split(":")[1].split()[0])
        path, frac, missing, _ = read_csv_map(out)
        ok = (not missing and frac.shape == (180 * 90,)
              and bool(np.isfinite(frac).all()))
        f = n_exit / n_rays
        report(name, ok, f"{' '.join(extra) or 'lambertian'}: exit fraction "
               f"{f:.5f}, {frac.size} cells, header keys "
               f"{'complete' if not missing else 'missing ' + str(missing)}"
               f", {dt:.1f} s including start-up and compile")
        return f


def phase_device(count: int):
    """JAX's devices: GPUs only, at least ``count`` of them (the run uses
    the first ``count``)."""
    import jax

    devs = jax.devices()
    d = devs[0]
    report("device", d.platform == "gpu" and len(devs) >= count,
           f"platform {d.platform}, kind {d.device_kind}, {len(devs)} "
           f"visible, {count} used")
    return devs


def phase_flagship(n_rays: int):
    from altair_tpu import SCENE_OPTIMIZE, SOURCE_OVERNIGHT
    from altair_tpu.sweep import sweep_detector_trace_once

    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        r = sweep_detector_trace_once(SCENE_OPTIMIZE, SOURCE_OVERNIGHT,
                                      n_rays=n_rays, save_folder=out,
                                      verbose=False)
        first = time.perf_counter() - t0
        path, frac, missing, meta = read_csv_map(out)
    warm = sweep_detector_trace_once(SCENE_OPTIMIZE, SOURCE_OVERNIGHT,
                                     n_rays=n_rays, seed=1, save_folder=None,
                                     verbose=False)
    f = r.n_exited / n_rays
    f2 = warm.n_exited / n_rays
    ok = (CORPUS_BAND[0] <= f <= CORPUS_BAND[1]
          and CORPUS_BAND[0] <= f2 <= CORPUS_BAND[1]
          and r.fluxmap.shape == (180, 90) and not missing
          and frac.size == 180 * 90
          and bool(np.isfinite(r.fluxmap).all())
          and float(np.abs(frac - r.fluxmap.ravel()).max()) <= 1e-6)
    report("flagship", ok,
           f"{n_rays} rays, exit fractions {f:.5f} / {f2:.5f} (band "
           f"{CORPUS_BAND[0]}-{CORPUS_BAND[1]}), map {r.fluxmap.shape}, "
           f"CSV header {'ok' if not missing else missing}; warm wall "
           f"{warm.total_time_s:.4f} s (trace {warm.trace_time_s:.4f} + "
           f"score {warm.score_time_s:.4f}); compile "
           f"{first - warm.total_time_s:.2f} s (first call {first:.2f} s "
           f"minus warm)")
    return r


def phase_scorer(n_rays: int):
    import jax

    from altair_tpu import SCENE_OPTIMIZE, SOURCE_OVERNIGHT, DetectorGrid
    from altair_tpu.config import TraceConfig, make_key
    from altair_tpu.core.score import exit_capacity, fluxmap_trace_once_compact
    from altair_tpu.core.trace_waves import trace_rays_auto

    scene, cfg, grid = SCENE_OPTIMIZE, TraceConfig(), DetectorGrid()
    cap = exit_capacity(scene, n_rays)

    @jax.jit
    def maps(k):
        res = trace_rays_auto(k, scene, SOURCE_OVERNIGHT, n_rays, cfg)
        out = [fluxmap_trace_once_compact(res, grid, cap, scene.exit_port_z,
                                          method=m) for m in ("mxu", "exact")]
        return out[0][0], out[1][0], out[0][1] + out[1][1]

    mxu, exact, ovf = jax.block_until_ready(maps(make_key(0, cfg)))
    mxu = np.asarray(mxu, np.int64)
    exact = np.asarray(exact, np.int64)
    d = mxu - exact
    rel = abs(int(d.sum())) / max(int(exact.sum()), 1)
    report("scorer", int(ovf) == 0 and np.abs(d).max() <= 3 and rel < 1e-4,
           f"mxu vs exact on the flagship exits (seed 0): max per-cell "
           f"|diff| {np.abs(d).max()} (limit 3), relative total diff "
           f"{rel:.3e} (limit 1e-4), {int((d != 0).sum())} cells differ")
    return mxu


def phase_retrace(once_counts, n_once: int, n_per: int = 50_000,
                  oversample: int = 128):
    import jax

    from altair_tpu import SCENE_OPTIMIZE, SOURCE_OVERNIGHT, DetectorGrid
    from altair_tpu.config import TraceConfig
    from altair_tpu.core.score import fluxmap_retrace_binomial

    f = jax.jit(lambda k: fluxmap_retrace_binomial(
        k, SCENE_OPTIMIZE, SOURCE_OVERNIGHT, DetectorGrid(), n_per,
        TraceConfig(), oversample=oversample))
    t0 = time.perf_counter()
    cells = np.asarray(jax.block_until_ready(f(jax.random.key(12))))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(f(jax.random.key(13)))
    warm = time.perf_counter() - t0
    once = once_counts / n_once
    retrace = cells / n_per
    # tests/test_score.py's per-bin bound: 3 binomial sigma + 0.003, held
    # by more than 95% of the cells
    sigma = np.sqrt(np.maximum(once, 1e-6) / n_per) * 3 + 0.003
    inside = float((np.abs(retrace - once) < sigma).mean())
    tot_once, tot_re = float(once.sum()), float(retrace.sum())
    rel = abs(tot_re - tot_once) / tot_once
    # totals: ~114 cell hits per ray, sd ~150, so the 10^6-ray trace-once
    # total has ~0.13% relative sd; 1% is about 7 combined sigma
    report("retrace", inside > 0.95 and rel < 0.01,
           f"binomial {n_per}/position x{oversample}: {inside:.4f} of cells "
           f"within 3 sigma + 0.003 of the trace-once map (need > 0.95); "
           f"totals {tot_re:.3f} vs {tot_once:.3f} cell-hits per ray, "
           f"relative diff {rel:.2e} (limit 1e-2); warm {warm:.4f} s, "
           f"first call {first:.2f} s")


def _sim_stats(res, z):
    mask = np.asarray(res.exited_port_mask(z))
    b = np.asarray(res.n_bounces, np.float64)
    return mask.mean(), b, -np.asarray(res.direction.z)[mask]


def phase_simulate(n: int = 1_000_000, cap: int = 4096):
    import jax
    from scipy.stats import ks_2samp

    from altair_tpu import SCENE_OPTIMIZE, SOURCE_OVERNIGHT
    from altair_tpu.config import SurfaceModel, TraceConfig
    from altair_tpu.core.trace import trace_rays
    from altair_tpu.core.trace_pallas import trace_rays_pallas_padded

    for m in SurfaceModel:
        sc = SCENE_OPTIMIZE.with_(max_bounces=cap, exact_rim=False,
                                  surface_model=m)
        rk = jax.jit(lambda k: trace_rays_pallas_padded(
            k, sc, SOURCE_OVERNIGHT, n))(jax.random.key(20))
        rx = jax.jit(lambda k: trace_rays(
            k, sc, SOURCE_OVERNIGHT, n, TraceConfig()))(jax.random.key(21))
        fk, bk, ck = _sim_stats(rk, sc.exit_port_z)
        fx, bx, cx = _sim_stats(rx, sc.exit_port_z)
        zf = abs(fk - fx) / binom_sigma2(fk, n, fx, n)
        zb = abs(bk.mean() - bx.mean()) / np.sqrt(bk.var() / n
                                                  + bx.var() / n)
        p = ks_2samp(ck, cx).pvalue
        report(f"simulate {m.name}", zf < 4 and zb < 4 and p > 1e-3,
               f"{n} rays, cap {cap}: exit {fk:.5f} vs {fx:.5f} "
               f"({zf:.2f} sigma), mean bounces {bk.mean():.3f} vs "
               f"{bx.mean():.3f} ({zb:.2f} sigma), KS on exit cos p={p:.3g}"
               f" (limits 4, 4, > 1e-3)")


def phase_cli_mixed_vs_reference(f_cli: float, n_cli: int,
                                 n: int = 1_000_000):
    """The CLI's mixed-wall exit fraction (kernel + deferred rim) against
    the plain XLA tracer with the in-loop exact rim."""
    import jax

    from altair_tpu import SCENE_OPTIMIZE, SOURCE_OVERNIGHT
    from altair_tpu.config import SurfaceModel, TraceConfig
    from altair_tpu.core.trace import trace_rays

    sc = SCENE_OPTIMIZE.with_(surface_model=SurfaceModel.MIXED_BRDF)
    rx = jax.jit(lambda k: trace_rays(k, sc, SOURCE_OVERNIGHT, n,
                                      TraceConfig()))(jax.random.key(22))
    fx = float(np.asarray(rx.exited_port_mask(sc.exit_port_z)).mean())
    z = abs(f_cli - fx) / binom_sigma2(f_cli, n_cli, fx, n)
    report("cli mixed vs reference", z < 4,
           f"CLI exit {f_cli:.5f} ({n_cli} rays) vs plain trace_rays with "
           f"in-loop exact rim {fx:.5f} ({n} rays): {z:.2f} sigma (limit 4)")


@contextlib.contextmanager
def kernel_off():
    """Route the simulate tier to the XLA tracers (the dispatch decides at
    trace time, so programs traced inside keep the XLA path)."""
    from altair_tpu.core import trace_pallas

    saved = trace_pallas._on_gpu
    trace_pallas._on_gpu = lambda: False
    try:
        yield
    finally:
        trace_pallas._on_gpu = saved


def _time(f, reps: int = 5):
    import jax

    ts = []
    for i in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(jax.random.key(100 + i)))
        ts.append(time.perf_counter() - t0)
    return min(ts)


def phase_timing(card: str):
    import jax

    from altair_tpu import SCENE_OPTIMIZE, SOURCE_OVERNIGHT
    from altair_tpu.config import SurfaceModel, TraceConfig
    from altair_tpu.core.trace_waves import trace_rays_auto

    cfg = TraceConfig(engine="simulate")
    rows = []
    for n, m in [(100_000, SurfaceModel.LAMBERTIAN),
                 (1 << 24, SurfaceModel.LAMBERTIAN),
                 (1 << 24, SurfaceModel.MIXED_BRDF)]:
        sc = SCENE_OPTIMIZE.with_(max_bounces=4096, surface_model=m)

        def build():
            @jax.jit
            def f(k):
                res = trace_rays_auto(k, sc, SOURCE_OVERNIGHT, n, cfg)
                return res.exited_port_mask(sc.exit_port_z).sum()
            return f

        f_on = build()
        e_on = int(f_on(jax.random.key(1)))
        with kernel_off():
            f_off = build()
            e_off = int(f_off(jax.random.key(2)))
        t_on, t_off = _time(f_on), _time(f_off)
        t_on = min(t_on, _time(f_on))
        t_off = min(t_off, _time(f_off))
        fo, ff = e_on / n, e_off / n
        z = abs(fo - ff) / binom_sigma2(fo, n, ff, n)
        rows.append((n, m.name, n / t_on, n / t_off))
        report(f"timing {m.name} {n}", z < 4,
               f"simulate tier, exact rim: kernel {n / t_on:.4e} rays/s "
               f"({t_on:.5f} s), XLA tiers {n / t_off:.4e} rays/s "
               f"({t_off:.5f} s), ratio {t_off / t_on:.2f}x; exit "
               f"{fo:.5f} vs {ff:.5f} ({z:.2f} sigma); {card}")
    keep = (rows[0][2] >= rows[0][3] and rows[1][2] > rows[1][3]
            and rows[2][2] > rows[2][3])
    print(f"kernel decision: {'keep' if keep else 'remove'} (faster at 16M "
          f"and not slower at 100k: {keep})", flush=True)


# ------------------------------------------------------------ four cards

def four_cards(devices):
    """The sharded sweeps on a 4-device mesh, each against the same
    program on a one-device mesh."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from altair_tpu import SCENE_OPTIMIZE, SOURCE_OVERNIGHT, DetectorGrid
    from altair_tpu.config import SurfaceModel, TraceConfig
    from altair_tpu.parallel import (
        make_mesh,
        sharded_fluxmap,
        sharded_retrace_binomial,
        sharded_scatter_retrace,
        sharded_trace,
    )
    from altair_tpu.parallel.mesh import _scatter_retrace_mesh_program

    n_rays, n_per, oversample, n_scatter = 1 << 22, 50_000, 128, 1 << 20
    grid = DetectorGrid()
    mesh4, mesh1 = make_mesh(devices[:4]), make_mesh(devices[:1])
    all4 = set(devices[:4])
    scene = SCENE_OPTIMIZE.with_(max_bounces=4096)
    cfg = TraceConfig()

    def spans4(x):
        return all(set(a.sharding.device_set) == all4
                   for a in jax.tree.leaves(x))

    def rep(x):
        return jax.device_put(x, NamedSharding(mesh4, P()))

    # key and source replicated on the mesh (the scene stays a concrete
    # Python pytree: the engine dispatch reads its values), ray-axis
    # outputs split over the 4 cards
    key4, src4 = rep(jax.random.key(0)), rep(SOURCE_OVERNIGHT)
    tr = sharded_trace(mesh4, key4, scene, src4, n_rays, cfg)
    shards = tr.status.addressable_shards
    ok = (spans4((key4, src4)) and spans4(tr)
          and sorted(s.data.shape[0] for s in shards) == [n_rays // 4] * 4
          and len({s.device for s in shards}) == 4)
    report("four-cards shardings", ok,
           f"inputs replicated on {len(all4)} devices; trace result split "
           f"{[s.data.shape[0] for s in shards]} over "
           f"{sorted(str(s.device) for s in shards)}")

    c4, e4 = sharded_fluxmap(mesh4, key4, scene, src4, grid, n_rays, cfg)
    c1, e1 = sharded_fluxmap(mesh1, jax.random.key(1), scene,
                             SOURCE_OVERNIGHT, grid, n_rays, cfg)
    f4, f1 = int(e4) / n_rays, int(e1) / n_rays
    z = abs(f4 - f1) / binom_sigma2(f4, n_rays, f1, n_rays)
    agree = cells_agree(c4, n_rays, c1, n_rays)
    report("four-cards sharded_fluxmap", z < 4 and agree > 0.99
           and spans4(c4),
           f"{n_rays} rays: exit {f4:.5f} (4 cards) vs {f1:.5f} (1 card), "
           f"{z:.2f} sigma (limit 4); {agree:.4f} of cells within 4 sigma "
           f"(need > 0.99); totals {_per(c4, n_rays)} vs "
           f"{_per(c1, n_rays)} cell-hits per ray")

    over = 1 + 1 / oversample
    b4 = sharded_retrace_binomial(mesh4, key4, scene, src4, grid, n_per,
                                  cfg, oversample=oversample)
    b1 = sharded_retrace_binomial(mesh1, jax.random.key(1), scene,
                                  SOURCE_OVERNIGHT, grid, n_per, cfg,
                                  oversample=oversample)
    agree = cells_agree(b4, n_per, b1, n_per, over, over)
    agree_once = cells_agree(b4, n_per, c1, n_rays, over, 1.0)
    report("four-cards sharded_retrace_binomial",
           agree > 0.99 and agree_once > 0.99 and spans4(b4),
           f"{n_per}/position x{oversample}: {agree:.4f} of cells within 4 "
           f"sigma of the 1-card map, {agree_once:.4f} of the 1-card "
           f"trace-once map (need > 0.99); totals {_per(b4, n_per)} vs "
           f"{_per(b1, n_per)} cell-hits per ray")

    # simple-mode mixed walls: the concrete scene keeps the bounce kernel
    # on the GPU backend inside shard_map (traced rim scenes take the XLA
    # in-loop rim kernel)
    sc = scene.with_(surface_model=SurfaceModel.MIXED_BRDF, exact_rim=False)
    sgrid = DetectorGrid(n_theta=45, n_phi=20, width=10.0, height=10.0)
    prog = _scatter_retrace_mesh_program(mesh4, sc, sgrid, n_scatter // 4,
                                         cfg, False)
    in_shard_map = "altair_bounce" in prog.lower(key4, sc, src4).as_text()
    m4 = sharded_scatter_retrace(mesh4, key4, sc, src4, sgrid,
                                 n_scatter, cfg)
    m1 = sharded_scatter_retrace(mesh1, jax.random.key(1), sc,
                                 SOURCE_OVERNIGHT, sgrid, n_scatter, cfg)
    agree = cells_agree(m4, n_scatter, m1, n_scatter)
    report("four-cards sharded_scatter_retrace",
           in_shard_map and agree > 0.99
           and spans4(m4),
           f"{n_scatter} rays, MIXED_BRDF walls: bounce kernel in the "
           f"shard_map program: {in_shard_map}; {agree:.4f} of cells within "
           f"4 sigma (need > 0.99); totals {_per(m4, n_scatter)} vs "
           f"{_per(m1, n_scatter)} cell-hits per ray")


def _per(counts, n):
    return f"{float(np.asarray(counts, np.int64).sum()) / n:.4f}"


def cells_agree(a, na, b, nb, va=1.0, vb=1.0):
    """Share of non-empty cells whose two hit fractions agree within 4
    sigma.  A cell's count is binomial in its own rays (``va``/``vb``
    inflate the variance: 1 + 1/oversample for binomial-retrace cells),
    whatever the correlation between cells; the share is the test because
    one ray hits many cells, so the map total has no simple error bar."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    m = (a + b) > 0
    var = a[m] * va / na ** 2 + b[m] * vb / nb ** 2
    z = np.abs(a[m] / na - b[m] / nb) / np.sqrt(var)
    return float((z < 4).mean())


# ------------------------------------------------------------------ main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded sweeps on 4 GPUs")
    args = ap.parse_args(argv)
    count = 4 if args.four_cards else 1

    card = phase_card()
    f_mixed = None
    if not args.four_cards:
        run_cli("cli", [], 100_000)
        f_mixed = run_cli("cli mixed", ["--surface", "mixed"], 100_000)

    from altair_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    devs = phase_device(count)
    if args.four_cards:
        four_cards(devs)
    else:
        n = 1_000_000
        phase_flagship(n)
        counts = phase_scorer(n)
        phase_retrace(counts, n)
        phase_simulate()
        phase_cli_mixed_vs_reference(f_mixed, 100_000)
        phase_timing(card)

    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
