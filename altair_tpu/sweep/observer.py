"""Observer flux-map sweeps — the production entry points.

Equivalents of the reference's sweep macros, same knobs, same CSV dialect,
same stdout protocol:

* ``sweep_detector_trace_once``  <- ``sweepDetectorTraceOnce``
  (``fluxAtObserverFast.C:1068-1397``): trace all rays once, score every
  grid position.  The 16,200-position scoring is a few matmuls, so the
  entire sweep is two device calls (trace, score).
* ``sweep_detector_retrace``     <- ``sweepDetector``
  (``fluxAtObserverOptimize.C:433-702``): fresh rays per position
  (statistically independent bins).  8.1x10^8 traces run as chunked device
  calls with immediate CSV flushing per chunk (crash-resume contract).
* ``sweep_detector_twofold``     <- ``sweepDetectorTwofold``
  (``fluxAtObserverFast.C:518-865``): one trace batch scores two antipodal
  detectors.  Subsumed by trace-once; provided for API parity as a
  thin wrapper that reuses one batch per antipodal position pair.
"""

from __future__ import annotations

import dataclasses
import os
import time

import jax
import numpy as np

from ..config import DetectorGrid, SphereScene, Source, TraceConfig, make_key, validate
from ..core.memo import memo_program
from ..core.score import fluxmap_retrace, fluxmap_trace_once
from ..core.trace_waves import trace_rays_auto as trace_rays
from ..io import (
    EtaTracker,
    FluxmapMetadata,
    FluxmapWriter,
    debug_stamp,
    fluxmap_filename,
    notify_bell,
)


@dataclasses.dataclass
class SweepResult:
    path: str | None
    fluxmap: np.ndarray          # [n_theta, n_phi] fractions
    n_exited: int
    n_rays: int
    trace_time_s: float
    score_time_s: float
    total_time_s: float


def _metadata(scene: SphereScene, source: Source, grid: DetectorGrid,
              n_rays: int, trace_once: bool) -> FluxmapMetadata:
    return FluxmapMetadata(
        n_rays=n_rays,
        detector_width_cm=grid.width,
        detector_height_cm=grid.height,
        inner_radius_cm=float(scene.inner_radius),
        outer_radius_cm=float(scene.outer_radius),
        exit_port_angle_deg=float(scene.theta_max_deg),
        n_theta=grid.n_theta,
        n_phi=grid.n_phi,
        reflectance=float(scene.reflectance),
        roughness=float(scene.roughness),
        source_pos_cm=(float(source.x), float(source.y), float(source.z)),
        source_dir=(float(source.dir_x), float(source.dir_y),
                    float(source.dir_z)),
        max_reflections=scene.max_bounces,
        trace_once=trace_once,
    )


# the sweep drivers build their jitted programs through memoized builders
# (core/memo.py): repeated sweeps with the same configuration — replicate
# runs, resumed runs, determinism tests — reuse the compiled program
# instead of paying the full compile again on every call


@memo_program
def _trace_once_programs(scene, source, n_rays, grid, cfg, cap):
    from ..core.score import fluxmap_trace_once_compact

    @jax.jit
    def run_trace(key):
        return trace_rays(key, scene, source, n_rays, cfg)

    @jax.jit
    def run_score(res):
        counts, overflow = fluxmap_trace_once_compact(
            res, grid, cap, scene.exit_port_z)
        n_exit = res.exited_port_mask(scene.exit_port_z).sum()
        return counts, n_exit, overflow

    return run_trace, run_score


@memo_program
def _replicates_program(scene, source, n_rays, grid, replicates, cfg, cap):
    from ..core.score import fluxmap_trace_once_compact

    @jax.jit
    def run(key):
        def one(i):
            res = trace_rays(jax.random.fold_in(key, i), scene, source,
                             n_rays, cfg)
            counts, overflow = fluxmap_trace_once_compact(
                res, grid, cap, scene.exit_port_z)
            return counts, overflow

        return jax.lax.map(one, jax.numpy.arange(replicates))

    return run


@memo_program
def _retrace_chunk_program(scene, source, sub_shape, n_rays_per_pos, cfg,
                           pos_chunk):
    return jax.jit(lambda key, c, n: fluxmap_retrace(
        key, scene, source, sub_shape, n_rays_per_pos, cfg,
        pos_chunk=pos_chunk, centers_normals=(c, n)))


@memo_program
def _binomial_map_program(scene, source, grid, n_rays_per_pos, cfg,
                          oversample):
    from ..core.score import fluxmap_retrace_binomial

    return jax.jit(lambda k: fluxmap_retrace_binomial(
        k, scene, source, grid, n_rays_per_pos, cfg, oversample))


@memo_program
def _twofold_pair_program(scene, source, grid, n_rays_per_pair, cfg):
    import jax.numpy as jnp

    from ..core.geometry import detector_position, line_hits_disk

    @jax.jit
    def pair_counts(key, theta, phi):
        res = trace_rays(key, scene, source, n_rays_per_pair, cfg)
        mask = res.exited_port_mask(scene.exit_port_z)
        out = []
        for p in (phi, phi + 180.0):
            c, n = detector_position(theta, p, grid.radius,
                                     scene.exit_port_z)
            hit = line_hits_disk(res.last_point, res.direction, c, n,
                                 grid.width / 2.0)
            out.append(jnp.sum(hit & mask, dtype=jnp.int32))
        return jnp.stack(out)

    return pair_counts


def sweep_detector_trace_once(
    scene: SphereScene,
    source: Source,
    *,
    n_rays: int = 100_000,
    grid: DetectorGrid = DetectorGrid(),
    seed: int = 0,
    cfg: TraceConfig = TraceConfig(),
    save_folder: str | None = "results",
    notify: bool = False,
    mesh=None,
    verbose: bool = True,
) -> SweepResult:
    """Trace once, score the whole grid.  Pass ``mesh`` (from
    ``altair_tpu.parallel.make_mesh``) to shard the ray axis over chips.

    Tracing and scoring run as two device calls so the footer reports both
    phases honestly, like the reference's TStopwatch pair
    (``fluxAtObserverFast.C:1374-1382``) — the phase boundary costs one
    extra dispatch, negligible against either phase.
    """
    validate(scene, source)
    t_setup0 = time.perf_counter()
    key = make_key(seed, cfg)

    if verbose:
        debug_stamp("Starting sweep setup")

    if mesh is not None:
        from ..parallel import sharded_score_traced, sharded_trace

        def run_trace(key):
            return sharded_trace(mesh, key, scene, source, n_rays, cfg)

        def run_score(res):
            counts, n_exit = sharded_score_traced(mesh, res, scene, grid)
            return counts, n_exit, jax.numpy.zeros((), jax.numpy.int32)
    else:
        from ..core.score import exit_capacity

        cap = exit_capacity(scene, n_rays)
        run_trace, run_score = _trace_once_programs(scene, source, n_rays,
                                                    grid, cfg, cap)

    if verbose:
        debug_stamp("Tracing all rays once")
    t0 = time.perf_counter()
    res = jax.block_until_ready(run_trace(key))
    t_trace = time.perf_counter() - t0
    if verbose:
        debug_stamp(f"Ray tracing completed in {t_trace:.4f} s")

    t1 = time.perf_counter()
    counts, n_exit, overflow = jax.block_until_ready(run_score(res))
    t_score = time.perf_counter() - t1
    if int(overflow):
        raise RuntimeError(
            f"exit-compaction overflow ({int(overflow)} rays unscored) — "
            "statistically impossible at the 6-sigma capacity; investigate")
    if verbose:
        debug_stamp(f"Detector sweep completed in {t_score:.4f} s")
        print(f"Total rays exiting port: {int(n_exit)} out of {n_rays}")

    fm = np.asarray(counts, dtype=np.float64) / n_rays
    total = time.perf_counter() - t_setup0

    path = None
    if save_folder is not None:
        meta = _metadata(scene, source, grid, n_rays, trace_once=True)
        fname = fluxmap_filename(
            n_rays, grid.n_theta, grid.n_phi,
            (float(source.x), float(source.y), float(source.z)),
            trace_once=True)
        with FluxmapWriter(os.path.join(save_folder, fname), meta) as w:
            w.write_map(np.asarray(grid.theta_centers()),
                        np.asarray(grid.phi_centers()), fm)
            w.write_footer(total, ray_time_s=t_trace, sweep_time_s=t_score,
                           exited=int(n_exit), n_rays=n_rays)
            path = w.path
        if verbose:
            print(f"\nFlux map data saved to '{path}'")
    if notify:
        notify_bell()
    return SweepResult(path, fm, int(n_exit), n_rays, t_trace, t_score,
                       total)


def fluxmap_replicates(
    scene: SphereScene,
    source: Source,
    *,
    n_rays: int = 100_000,
    grid: DetectorGrid = DetectorGrid(),
    replicates: int = 8,
    seed: int = 0,
    cfg: TraceConfig = TraceConfig(),
):
    """``replicates`` independent trace-once maps in ONE device call;
    returns ``(mean_fraction [n_theta, n_phi], sem [n_theta, n_phi])``.

    The one-call equivalent of the reference's repeat-runs workflow (3-10
    CSVs per directory averaged by ``flux_analysis.py:133-164``): the
    replicate axis is a ``lax.map`` over folded keys, the per-cell
    standard error of the mean comes from the replicate spread.  With
    ``cfg.qmc`` each replicate is an independent Sobol randomisation
    (digital shift / Owen seed), so the error bars measure the actual
    QMC accuracy — which binomial formulas would overestimate.
    """
    from ..core.score import exit_capacity

    if replicates < 2:
        raise ValueError("need >= 2 replicates for a standard error")
    validate(scene, source)
    key = make_key(seed, cfg)
    cap = exit_capacity(scene, n_rays)
    run = _replicates_program(scene, source, n_rays, grid, replicates, cfg,
                              cap)
    counts, overflow = run(key)
    if int(np.asarray(overflow).sum()):
        raise RuntimeError("exit-compaction overflow — statistically "
                           "impossible at the 6-sigma capacity; investigate")
    frac = np.asarray(counts, np.float64) / n_rays
    mean = frac.mean(axis=0)
    sem = frac.std(axis=0, ddof=1) / np.sqrt(replicates)
    return mean, sem


def sweep_detector_retrace(
    scene: SphereScene,
    source: Source,
    *,
    n_rays_per_pos: int = 50_000,
    grid: DetectorGrid = DetectorGrid(),
    seed: int = 0,
    cfg: TraceConfig = TraceConfig(),
    save_folder: str | None = "results",
    notify: bool = False,
    pos_chunk: int | None = None,
    verbose: bool = True,
    resume_path: str | None = None,
    engine: str = "simulate",
    oversample: int = 128,
    mesh=None,
) -> SweepResult:
    """Fresh rays for every detector position, chunked with per-chunk CSV
    flush (the overnight production path, crash-resilient like the
    reference's immediate-flush loop).  ``resume_path``: continue a partial
    CSV written by an earlier killed run (rows already present are skipped —
    the reference's manual resume contract, SURVEY.md §5.3/5.4).

    ``engine="simulate"`` (default) traces ``n_rays_per_pos`` fresh rays
    for every position — the exact law of ``sweepDetector``.
    ``engine="binomial"`` samples each cell from its per-position binomial
    law with the hit probability estimated from ONE shared
    ``oversample * n_rays_per_pos``-ray trace: marginal means exact,
    ``1/oversample`` relative excess variance (see
    ``fluxmap_retrace_binomial``) — the whole sweep is a single device
    call, so chunked flushing and ``resume_path`` do not apply.

    ``mesh``: shard the per-position ray batches over a device mesh
    (``parallel.sharded_retrace`` / ``sharded_retrace_binomial`` — counts
    add across chips, one psum).  The sharded simulate sweep runs the map
    as one program, so per-chunk flushing and ``resume_path`` do not
    apply."""
    validate(scene, source)
    if engine == "binomial":
        if resume_path is not None:
            raise ValueError(
                "engine='binomial' runs the whole map in one device call "
                "— there is no chunked flush to resume; drop resume_path "
                "(re-running is cheaper than the partial CSV)")
        return _retrace_binomial(scene, source, n_rays_per_pos, grid, seed,
                                 cfg, save_folder, notify, verbose,
                                 oversample, mesh)
    if engine != "simulate":
        raise ValueError(f"unknown retrace engine {engine!r}")
    if mesh is not None:
        if resume_path is not None:
            raise ValueError("mesh retrace runs the whole map as one "
                             "sharded program — no chunked flush to resume")
        return _retrace_sharded(scene, source, n_rays_per_pos, grid, seed,
                                cfg, save_folder, notify, verbose, mesh)
    t_all0 = time.perf_counter()
    key = make_key(seed, cfg)
    P = grid.n_positions
    if pos_chunk is None:
        # auto: ~1 theta row per chunk, largest row count that divides
        # n_theta (so chunks tile the grid exactly)
        rows_per_chunk = 1
        pos_chunk = grid.n_phi
    else:
        if P % pos_chunk:
            raise ValueError("pos_chunk must divide n_theta*n_phi")
        # Chunk along theta rows so each chunk is a contiguous sub-grid.
        if pos_chunk % grid.n_phi:
            raise ValueError("pos_chunk must be a multiple of n_phi "
                             "(chunking is by theta rows)")
        rows_per_chunk = pos_chunk // grid.n_phi
    n_chunks = P // pos_chunk

    # one compiled program serves every chunk: the sub-grid SHAPE is static,
    # the detector placement arrays are dynamic inputs
    from ..core.score import grid_centers_normals
    C_all, N_all = grid_centers_normals(grid, scene.exit_port_z)
    sub_shape = dataclasses.replace(grid, n_theta=rows_per_chunk)
    run = _retrace_chunk_program(scene, source, sub_shape, n_rays_per_pos,
                                 cfg, min(32, pos_chunk))

    th = np.asarray(grid.theta_centers())
    ph = np.asarray(grid.phi_centers())

    done_rows = 0
    writer = None
    fm = np.zeros((grid.n_theta, grid.n_phi))
    if resume_path is not None and os.path.exists(resume_path):
        from ..io import read_fluxmap
        theta_r, phi_r, frac_r, _ = read_fluxmap(resume_path)
        done_rows = len(theta_r) // grid.n_phi
        # align to the chunk boundary: a partial chunk's rows are redone
        # (re-emitting them would duplicate CSV rows otherwise)
        done_rows -= done_rows % rows_per_chunk
        fm[:done_rows] = frac_r[:done_rows * grid.n_phi].reshape(
            done_rows, grid.n_phi)
        writer = FluxmapWriter(resume_path, _metadata(
            scene, source, grid, n_rays_per_pos, trace_once=False),
            make_unique=True)  # rewrite under a fresh unique name
        writer.write_map(th[:done_rows], ph, fm[:done_rows])
        if verbose:
            print(f"Resuming after {done_rows} completed theta rows")

    if writer is None and save_folder is not None:
        meta = _metadata(scene, source, grid, n_rays_per_pos,
                         trace_once=False)
        fname = fluxmap_filename(
            n_rays_per_pos, grid.n_theta, grid.n_phi,
            (float(source.x), float(source.y), float(source.z)),
            trace_once=False)
        writer = FluxmapWriter(os.path.join(save_folder, fname), meta)

    eta = EtaTracker(total=n_chunks)
    eta.done = done_rows // rows_per_chunk
    t_trace = 0.0
    for ci in range(done_rows // rows_per_chunk, n_chunks):
        row0 = ci * rows_per_chunk
        sl = slice(row0 * grid.n_phi, (row0 + rows_per_chunk) * grid.n_phi)
        t0 = time.perf_counter()
        counts = jax.block_until_ready(
            run(jax.random.fold_in(key, ci), C_all[sl], N_all[sl]))
        t_trace += time.perf_counter() - t0
        fm[row0:row0 + rows_per_chunk] = (
            np.asarray(counts, np.float64) / n_rays_per_pos)
        if writer is not None:
            writer.write_map(th[row0:row0 + rows_per_chunk], ph,
                             fm[row0:row0 + rows_per_chunk])
        line = eta.tick()
        if verbose:
            print(f"Completed theta rows {row0}-{row0 + rows_per_chunk - 1}"
                  f" ({eta.percent:.1f}%)")
            if line:
                print("  " + line)

    total = time.perf_counter() - t_all0
    total_hits = int(round(fm.sum() * n_rays_per_pos))
    path = None
    if writer is not None:
        writer.write_footer(total, total_hits=total_hits,
                            n_total=n_rays_per_pos * P)
        path = writer.path
        writer.close()
        if verbose:
            print(f"\nFlux map data saved to '{path}'")
    if notify:
        notify_bell()
    return SweepResult(path, fm, -1, n_rays_per_pos, t_trace,
                       total - t_trace, total)


def _retrace_sharded(scene, source, n_rays_per_pos, grid, seed, cfg,
                     save_folder, notify, verbose, mesh):
    """``mesh`` body of the simulate-engine ``sweep_detector_retrace``:
    the whole honest retrace map as one sharded program (per-position ray
    batches split over chips, one psum), same CSV dialect and footer."""
    from ..parallel.mesh import sharded_retrace

    t_all0 = time.perf_counter()
    key = make_key(seed, cfg)
    if verbose:
        debug_stamp(f"Sharded retrace over {mesh.devices.size} devices")
    t0 = time.perf_counter()
    counts = np.asarray(jax.block_until_ready(
        sharded_retrace(mesh, key, scene, source, grid, n_rays_per_pos,
                        cfg)), np.float64)
    t_trace = time.perf_counter() - t0
    fm = counts / n_rays_per_pos

    total = time.perf_counter() - t_all0
    total_hits = int(round(counts.sum()))
    path = None
    if save_folder is not None:
        meta = _metadata(scene, source, grid, n_rays_per_pos,
                         trace_once=False)
        fname = fluxmap_filename(
            n_rays_per_pos, grid.n_theta, grid.n_phi,
            (float(source.x), float(source.y), float(source.z)),
            trace_once=False)
        with FluxmapWriter(os.path.join(save_folder, fname), meta) as w:
            w.write_map(np.asarray(grid.theta_centers()),
                        np.asarray(grid.phi_centers()), fm)
            w.write_footer(total, total_hits=total_hits,
                           n_total=n_rays_per_pos * grid.n_positions)
            path = w.path
        if verbose:
            print(f"\nFlux map data saved to '{path}'")
    if notify:
        notify_bell()
    return SweepResult(path, fm, -1, n_rays_per_pos, t_trace,
                       total - t_trace, total)


def _retrace_binomial(scene, source, n_rays_per_pos, grid, seed, cfg,
                      save_folder, notify, verbose, oversample, mesh=None):
    """The ``engine="binomial"`` body of ``sweep_detector_retrace``: one
    device call for the whole map, same CSV dialect and footer."""
    t_all0 = time.perf_counter()
    key = make_key(seed, cfg)
    if verbose:
        debug_stamp(f"Binomial retrace: sampling {oversample}x"
                    f"{n_rays_per_pos} shared rays")
    t0 = time.perf_counter()
    if mesh is not None:
        from ..parallel.mesh import sharded_retrace_binomial

        counts = np.asarray(jax.block_until_ready(
            sharded_retrace_binomial(mesh, key, scene, source, grid,
                                     n_rays_per_pos, cfg,
                                     oversample=oversample)), np.float64)
    else:
        run = _binomial_map_program(scene, source, grid, n_rays_per_pos,
                                    cfg, oversample)
        counts = np.asarray(jax.block_until_ready(run(key)), np.float64)
    t_trace = time.perf_counter() - t0
    if verbose:
        debug_stamp(f"Binomial retrace completed in {t_trace:.4f} s")
    fm = counts / n_rays_per_pos

    total = time.perf_counter() - t_all0
    total_hits = int(round(counts.sum()))
    path = None
    if save_folder is not None:
        meta = _metadata(scene, source, grid, n_rays_per_pos,
                         trace_once=False)
        fname = fluxmap_filename(
            n_rays_per_pos, grid.n_theta, grid.n_phi,
            (float(source.x), float(source.y), float(source.z)),
            trace_once=False)
        with FluxmapWriter(os.path.join(save_folder, fname), meta) as w:
            w.write_map(np.asarray(grid.theta_centers()),
                        np.asarray(grid.phi_centers()), fm)
            w.write_footer(total, total_hits=total_hits,
                           n_total=n_rays_per_pos * grid.n_positions)
            path = w.path
        if verbose:
            print(f"\nFlux map data saved to '{path}'")
    if notify:
        notify_bell()
    return SweepResult(path, fm, -1, n_rays_per_pos, t_trace,
                       total - t_trace, total)


def sweep_detector_twofold(
    scene: SphereScene,
    source: Source,
    *,
    n_rays_per_pair: int = 50_000,
    grid: DetectorGrid = DetectorGrid(),
    seed: int = 0,
    cfg: TraceConfig = TraceConfig(),
    save_folder: str | None = "results",
    notify: bool = False,
    verbose: bool = True,
    mesh=None,
) -> SweepResult:
    """Twofold reuse: one fresh batch per antipodal position pair
    (phi, phi+180) — halves the traced batches exactly like
    ``sweepDetectorTwofold`` (``fluxAtObserverFast.C:656-714``).

    Requires an even ``n_phi``.  Implemented as a retrace over the half-phi
    grid where each batch is scored against both mirror positions.
    ``mesh``: split each pair's batch over a device mesh
    (``parallel.sharded_twofold_pair``, one psum per pair).
    """
    if grid.n_phi % 2:
        raise ValueError("twofold needs an even n_phi")
    if abs((grid.phi_hi - grid.phi_lo) - 360.0) > 1e-9:
        raise ValueError(
            "twofold pairs detectors 180 deg apart, which maps onto the "
            "j + n_phi/2 column only for a full 360-degree phi span")
    if grid.n_positions > 1000:
        import warnings

        warnings.warn(
            "twofold re-traces a fresh batch per antipodal position pair "
            f"({grid.n_positions // 2} device calls) — it exists for "
            "methodology parity with sweepDetectorTwofold; use "
            "sweep_detector_trace_once for production maps",
            stacklevel=2)
    import jax.numpy as jnp

    t0_all = time.perf_counter()
    key = make_key(seed, cfg)
    th = np.asarray(grid.theta_centers())
    ph = np.asarray(grid.phi_centers())
    half = grid.n_phi // 2
    if mesh is not None:
        from ..parallel.mesh import sharded_twofold_pair

        def pair_counts(k, theta, phi):
            return sharded_twofold_pair(mesh, k, scene, source, grid,
                                        n_rays_per_pair, cfg, theta, phi)
    else:
        pair_counts = _twofold_pair_program(scene, source, grid,
                                            n_rays_per_pair, cfg)

    fm = np.zeros((grid.n_theta, grid.n_phi))
    eta = EtaTracker(total=grid.n_theta * half)
    t_trace = 0.0
    for i in range(grid.n_theta):
        for j in range(half):
            t0 = time.perf_counter()
            cnt = np.asarray(pair_counts(
                jax.random.fold_in(key, i * half + j),
                jnp.float32(th[i]), jnp.float32(ph[j])))
            t_trace += time.perf_counter() - t0
            fm[i, j] = cnt[0] / n_rays_per_pair
            fm[i, j + half] = cnt[1] / n_rays_per_pair
            eta.tick()
        if verbose:
            print(f"theta={th[i]:.2f} done ({eta.percent:.1f}%)")

    total = time.perf_counter() - t0_all
    path = None
    if save_folder is not None:
        meta = _metadata(scene, source, grid, n_rays_per_pair,
                         trace_once=False)
        fname = fluxmap_filename(
            n_rays_per_pair, grid.n_theta, grid.n_phi,
            (float(source.x), float(source.y), float(source.z)),
            trace_once=False)
        with FluxmapWriter(os.path.join(save_folder, fname), meta) as w:
            w.write_map(th, ph, fm)
            w.write_footer(total,
                           total_hits=int(round(fm.sum() * n_rays_per_pair)),
                           n_total=n_rays_per_pair * grid.n_positions)
            path = w.path
    if notify:
        notify_bell()
    return SweepResult(path, fm, -1, n_rays_per_pair, t_trace,
                       total - t_trace, total)
