"""SPMD execution over a device mesh — the distributed backend.

The reference's entire parallelism story is <=4 shared-memory threads inside
ROBAST (``fluxAtObserverOptimize.C:450-454``) plus overnight wall-clock
(SURVEY.md §2.3/§5.8).  Here the ray batch axis is sharded over a 1-D
``rays`` mesh axis with ``shard_map``; every card traces its shard
independently (tracing is embarrassingly parallel) and the ONLY
cross-device traffic is one ``psum`` of the (theta, phi) hit-count histogram
and the scalar counters at the end — a few hundred KB per sweep, which XLA
hands to NCCL over NVLink.  The cards of a host are joined all to all, so
the mesh follows the algorithm alone.

Multi-host: call ``init_distributed`` before ``make_mesh()`` and the same
code runs over every process's devices (single-controller JAX; one card per
process on the GPU).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import DetectorGrid, SphereScene, Source, TraceConfig
from ..core.score import exit_angle_histogram, fluxmap_retrace, fluxmap_trace_once
from ..core.trace import (
    EXITED,
    TraceResult,
    rim_deferred_capacity_shift,
    trace_rays_rim_deferred,
)
from ..core.trace import trace_rays as _trace_plain
from ..core.trace_waves import trace_rays_waves, waves_safe


WAVES_THRESHOLD = 262_144


# every sharded_* entry point builds its shard_map program through a
# memoized builder (core/memo.py) so identical calls reuse the compiled
# program; see that module's docstring for the rationale.  The programs
# are additionally jax.jit-wrapped: an EAGER shard_map call lowers and
# dispatches fragment-by-fragment (measured ~7x slower than the single
# fused compile even on the FIRST call, on the 8-device CPU mesh).
from ..core.memo import memo_program as _memo_program


def _pick_tracer(scene, n_local, cfg, waves_threshold=None):
    """Engine selection must happen on the CONCRETE scene (inside shard_map
    the scene leaves are tracers and waves_safe would always bail).  Same
    dispatch as ``trace_rays_auto``: rim-deferred for exact-rim scenes,
    wave compaction for large safe batches, composed when both apply."""
    if waves_threshold is None:
        waves_threshold = WAVES_THRESHOLD
    if cfg.keep_history:
        return _trace_plain
    from ..core.trace_direct import direct_applicable, trace_rays_direct

    if cfg.engine in ("auto", "direct") and direct_applicable(scene, cfg):
        if not scene.exact_rim:
            return trace_rays_direct
        shift = rim_deferred_capacity_shift(scene)
        if shift is not None:
            def rim_direct(k, sc, src, n, c):
                return trace_rays_rim_deferred(k, sc, src, n, c,
                                               capacity_shift=shift,
                                               main_tracer=trace_rays_direct
                                               )[0]

            return rim_direct
    from ..core.trace_pallas import pallas_applicable, trace_rays_fast

    if pallas_applicable(scene, cfg):
        return trace_rays_fast
    use_waves = n_local >= waves_threshold and waves_safe(scene)

    def wave(k, sc, src, n, c):
        return trace_rays_waves(k, sc, src, n, c)[0]

    shift = (rim_deferred_capacity_shift(scene) if scene.exact_rim
             else None)
    if shift is not None:
        main = wave if use_waves else None

        def rim(k, sc, src, n, c):
            return trace_rays_rim_deferred(k, sc, src, n, c,
                                           capacity_shift=shift,
                                           main_tracer=main)[0]

        return rim
    return wave if use_waves else _trace_plain

RAY_AXIS = "rays"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Multi-host bring-up: call once per process before ``make_mesh``.

    Thin wrapper over ``jax.distributed.initialize``; pass the coordinator
    address (``host:port``), the process count and this process's id —
    nothing in a plain GPU host tells JAX of a cluster.  After it returns,
    ``jax.devices()`` spans every process's cards and the same
    single-controller sweep code runs across them — the multi-node story
    the reference never had (its scaling was 'leave it overnight',
    SURVEY.md §5.8).
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def make_mesh(devices=None, axis_name: str = RAY_AXIS) -> Mesh:
    """1-D mesh over all (or the given) devices; the ray batch is the only
    sharded axis in this workload — pure data parallelism."""
    devices = jax.devices() if devices is None else devices
    return jax.make_mesh((len(devices),), (axis_name,), devices=devices)


def _per_shard_key(key, axis_name):
    """Statistically independent fold per shard (counter-based, so adding
    devices never replays another shard's stream)."""
    return jax.random.fold_in(key, jax.lax.axis_index(axis_name))


def sharded_fluxmap(
    mesh: Mesh,
    key: jax.Array,
    scene: SphereScene,
    source: Source,
    grid: DetectorGrid,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
    pos_chunk: int = 1080,
):
    """Trace ``n_rays`` (total, split evenly over the mesh) and score the
    full detector grid; returns (counts [n_theta, n_phi] int32, n_exited).

    The full trace-once sweep as ONE sharded kernel: per-chip trace ->
    per-chip partial histogram -> single ``psum``.
    """
    n_dev = mesh.devices.size
    if n_rays % n_dev:
        raise ValueError(f"n_rays={n_rays} must divide over {n_dev} devices")
    n_local = n_rays // n_dev
    run = _fluxmap_program(mesh, scene, grid, n_local, cfg, pos_chunk,
                           WAVES_THRESHOLD)
    return run(key, scene, source)


@_memo_program
def _fluxmap_program(mesh, scene, grid, n_local, cfg, pos_chunk,
                     waves_threshold):
    tracer = _pick_tracer(scene, n_local, cfg, waves_threshold)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), scene_spec(scene), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def run(key, scene, src):
        k = _per_shard_key(key, RAY_AXIS)
        res = tracer(k, scene, src, n_local, cfg)
        counts = fluxmap_trace_once(res, grid, scene.exit_port_z, pos_chunk)
        n_exit = jnp.sum(res.exited_port_mask(scene.exit_port_z),
                         dtype=jnp.int32)
        counts = jax.lax.psum(counts, RAY_AXIS)
        n_exit = jax.lax.psum(n_exit, RAY_AXIS)
        return counts, n_exit

    return jax.jit(run)


def sharded_exit_histogram(
    mesh: Mesh,
    key: jax.Array,
    scene: SphereScene,
    source: Source,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
    n_bins: int = 180,
):
    """Sharded equivalent of the exit angular-distribution run
    (``distributionSphereDetectorSweep.C``): per-chip trace + histogram,
    one ``psum``.  Returns (hist [n_bins] int32, n_exited)."""
    n_dev = mesh.devices.size
    if n_rays % n_dev:
        raise ValueError(f"n_rays={n_rays} must divide over {n_dev} devices")
    n_local = n_rays // n_dev
    run = _histogram_program(mesh, scene, n_local, cfg, n_bins,
                             WAVES_THRESHOLD)
    return run(key, scene, source)


@_memo_program
def _histogram_program(mesh, scene, n_local, cfg, n_bins, waves_threshold):
    tracer = _pick_tracer(scene, n_local, cfg, waves_threshold)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), scene_spec(scene), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def run(key, scene, src):
        k = _per_shard_key(key, RAY_AXIS)
        res = tracer(k, scene, src, n_local, cfg)
        hist = exit_angle_histogram(res, n_bins,
                                    exit_port_z=scene.exit_port_z)
        n_exit = jnp.sum(res.exited_port_mask(scene.exit_port_z),
                         dtype=jnp.int32)
        return (jax.lax.psum(hist, RAY_AXIS),
                jax.lax.psum(n_exit, RAY_AXIS))

    return jax.jit(run)


def scene_spec(scene: SphereScene):
    """Replicated PartitionSpec pytree matching the scene structure."""
    return jax.tree.map(lambda _: P(), scene)


def _result_spec():
    """Ray-axis-sharded PartitionSpec pytree for a history-free
    TraceResult."""
    from ..core.geometry import Vec3

    v = Vec3(P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS))
    return TraceResult(P(RAY_AXIS), v, v, v, P(RAY_AXIS), None, None)


def sharded_trace(
    mesh: Mesh,
    key: jax.Array,
    scene: SphereScene,
    source: Source,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
) -> TraceResult:
    """Trace ``n_rays`` split evenly over the mesh; returns a global
    ``TraceResult`` whose arrays are ray-axis-sharded across the devices
    (they stay device-resident for a following ``sharded_score_traced``).

    The trace/score split mirrors the reference's two timed phases
    (``fluxAtObserverFast.C:1144-1254``), letting the sweep driver report
    both honestly."""
    if cfg.keep_history:
        raise ValueError("history tracing is a single-device debug path")
    n_dev = mesh.devices.size
    if n_rays % n_dev:
        raise ValueError(f"n_rays={n_rays} must divide over {n_dev} devices")
    n_local = n_rays // n_dev
    run = _trace_program(mesh, scene, n_local, cfg, WAVES_THRESHOLD)
    return run(key, scene, source)


@_memo_program
def _trace_program(mesh, scene, n_local, cfg, waves_threshold):
    tracer = _pick_tracer(scene, n_local, cfg, waves_threshold)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), scene_spec(scene), P()),
        out_specs=_result_spec(),
        check_vma=False,
    )
    def run(key, scene, src):
        return tracer(_per_shard_key(key, RAY_AXIS), scene, src, n_local,
                      cfg)

    return jax.jit(run)


def sharded_score_traced(
    mesh: Mesh,
    result: TraceResult,
    scene: SphereScene,
    grid: DetectorGrid,
    pos_chunk: int = 1080,
):
    """Score an already-traced, ray-sharded batch (from ``sharded_trace``)
    against the detector grid: per-chip partial hit maps, one ``psum``.
    Returns (counts [n_theta, n_phi] int32, n_exited)."""
    run = _score_traced_program(mesh, scene, grid, pos_chunk)
    return run(result, scene)


@_memo_program
def _score_traced_program(mesh, scene, grid, pos_chunk):
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(_result_spec(), scene_spec(scene)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def run(res, scene):
        counts = fluxmap_trace_once(res, grid, scene.exit_port_z, pos_chunk)
        n_exit = jnp.sum(res.exited_port_mask(scene.exit_port_z),
                         dtype=jnp.int32)
        return (jax.lax.psum(counts, RAY_AXIS),
                jax.lax.psum(n_exit, RAY_AXIS))

    return jax.jit(run)


def _member_scenes(scenes: SphereScene):
    """Iterate the concrete member scenes of a stacked scene pytree
    (leading batch axis on every numeric leaf; static metadata scalar)."""
    import dataclasses
    import numbers

    n = jax.tree.leaves(scenes)[0].shape[0]
    for i in range(n):
        fields = {}
        for f in dataclasses.fields(scenes):
            v = getattr(scenes, f.name)
            if isinstance(v, (bool, numbers.Number, str)) or callable(v):
                fields[f.name] = v
            else:
                fields[f.name] = float(jnp.asarray(v)[i])
        yield dataclasses.replace(scenes, **fields)


def _param_sweep_tracer(scenes: SphereScene, cfg: TraceConfig):
    """Engine dispatch for a batched-scene sweep: the direct sampler (with
    the worst-member deferred-rim capacity) when every concrete member
    admits it, else the plain in-loop kernel.  Mirrors
    ``sweep.series._series_tracer`` for pre-stacked pytrees."""
    from ..core.trace_direct import direct_applicable, trace_rays_direct

    if cfg.keep_history or cfg.engine == "simulate" or \
            not direct_applicable(scenes, cfg):
        if cfg.engine == "direct":
            raise NotImplementedError(
                "engine='direct' requires a statically-Lambertian scene")
        return _trace_plain
    if not scenes.exact_rim:
        return trace_rays_direct
    try:
        shifts = [rim_deferred_capacity_shift(sc)
                  for sc in _member_scenes(scenes)]
    except (TypeError, jax.errors.TracerArrayConversionError):
        shifts = [None]  # traced members: capacity can't be planned
    if any(s is None for s in shifts):
        if cfg.engine == "direct":
            raise NotImplementedError(
                "engine='direct': a member's rim does not admit the "
                "deferred post-pass (thick rim band or traced params)")
        return _trace_plain
    shift = min(shifts)

    def rim_direct(k, sc, src, n, c):
        return trace_rays_rim_deferred(k, sc, src, n, c,
                                       capacity_shift=shift,
                                       main_tracer=trace_rays_direct)[0]

    return rim_direct


def sharded_param_sweep(
    mesh: Mesh,
    key: jax.Array,
    scenes: SphereScene,          # pytree with a leading batch axis
    source: Source,
    n_rays_per_scene: int,
    cfg: TraceConfig = TraceConfig(),
    grid: DetectorGrid | None = None,
    pos_chunk: int = 1080,
    sources: Source | None = None,
):
    """Scene-parameter sweep (the ``sweepSeries`` axis, SURVEY.md §2.3.5):
    lax.map over a batch of scenes (port angle / roughness / reflectance
    ...) with the ray axis sharded inside — the multi-chip equivalent of
    ``run_series_vmapped``.

    Returns per-scene exit counts ``[S]``; pass ``grid`` to also get the
    per-scene flux maps: ``(fluxmaps [S, n_theta, n_phi] counts, exits
    [S])``, psum-merged over the mesh exactly like ``sharded_fluxmap``.

    ``sources`` adds the SOURCE axis of ``sweepSeries`` (the srcX/Y/Z/
    dirXBase loops, ``fluxAtObserverOptimize.C:892-921``): a batched
    ``Source`` pytree (``sweep.series.stack_sources``) that replaces
    ``source``.  ``scenes`` may then be a plain (unbatched) scene —
    broadcast over the source members — or a batch of EQUAL length,
    zipped member-for-member with the sources.

    The reference ran these as sequential overnight for-loops
    (``fluxAtObserverOptimize.C:892-921``); here the parameter axis is just
    one more batch dimension.
    """
    n_dev = mesh.devices.size
    if n_rays_per_scene % n_dev:
        raise ValueError("n_rays_per_scene must divide over devices")
    n_local = n_rays_per_scene // n_dev

    if sources is not None:
        from ..config import validate
        from ..sweep.series import source_members

        n_src = jnp.asarray(sources.x).shape[0]
        if jnp.ndim(scenes.theta_max_deg) == 0:
            # plain scene: validate every source member against it, then
            # broadcast over the source axis (stack_scenes fills every
            # non-meta field to shape [n_src])
            from ..sweep.series import stack_scenes

            for s in source_members(sources):
                validate(scenes, s)
            scenes = stack_scenes(scenes, theta_max_deg=jnp.full(
                (n_src,), float(scenes.theta_max_deg), jnp.float32))
        else:
            if jax.tree.leaves(scenes)[0].shape[0] != n_src:
                raise ValueError(
                    f"scenes batch ({jax.tree.leaves(scenes)[0].shape[0]}) "
                    f"and sources batch ({n_src}) must have equal length — "
                    "the series zips them member-for-member")
            # zip path: validate each (scene, source) member PAIR with the
            # members' concrete values — validate() on the batched pytree
            # would silently no-op its radius check on the array
            # inner_radius (review r5 #1)
            for sc, s in zip(_member_scenes(scenes),
                             source_members(sources)):
                validate(sc, s)
        source = sources

    # the scene batch is traced inside the kernel, but the CONCRETE member
    # values are known right here — so the static engine facts (surface
    # model, worst-member rim capacity) are planned before batching,
    # exactly like sweep.series._series_tracer
    tracer = _param_sweep_tracer(scenes, cfg)

    scenes_spec = jax.tree.map(lambda _: P(), scenes)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), scenes_spec, P()),
        out_specs=P() if grid is None else (P(), P()),
        check_vma=False,
    )
    def run(key, scenes, src):
        k = _per_shard_key(key, RAY_AXIS)

        def one_scene(i, scene, src_i):
            res = tracer(jax.random.fold_in(k, i), scene, src_i, n_local,
                         cfg)
            n_exit = jnp.sum(res.exited_port_mask(scene.exit_port_z),
                             dtype=jnp.int32)
            if grid is None:
                return n_exit
            counts = fluxmap_trace_once(res, grid, scene.exit_port_z,
                                        pos_chunk)
            return counts, n_exit

        n_scenes = jax.tree.leaves(scenes)[0].shape[0]
        if sources is None:
            out = jax.lax.map(
                lambda args: one_scene(args[0], args[1], src),
                (jnp.arange(n_scenes), scenes))
        else:
            out = jax.lax.map(
                lambda args: one_scene(args[0], args[1], args[2]),
                (jnp.arange(n_scenes), scenes, src))
        return jax.tree.map(lambda x: jax.lax.psum(x, RAY_AXIS), out)

    # stacked scenes carry array leaves (unhashable), so this program is
    # not memoized — but the jit wrapper still matters: eager shard_map
    # dispatch lowers fragment-by-fragment (measured ~7x slower than one
    # fused compile even on the FIRST call)
    return jax.jit(run)(key, scenes, source)


def sharded_retrace(
    mesh: Mesh,
    key: jax.Array,
    scene: SphereScene,
    source: Source,
    grid: DetectorGrid,
    n_rays_per_pos: int,
    cfg: TraceConfig = TraceConfig(),
    pos_chunk: int | None = None,
):
    """Multi-chip honest retrace sweep (``sweepDetector``,
    ``fluxAtObserverOptimize.C:433-702``): each chip traces
    ``n_rays_per_pos / n_devices`` fresh rays for every detector position
    and scores them; partial hit-count maps merge with one ``psum``.
    Statistically identical to the single-chip ``fluxmap_retrace`` (each
    position's rays are independent across chips, so counts just add).

    Returns ``[n_theta, n_phi]`` hit counts out of ``n_rays_per_pos`` rays
    per position.
    """
    n_dev = mesh.devices.size
    if n_rays_per_pos % n_dev:
        raise ValueError("n_rays_per_pos must divide over devices")
    n_local = n_rays_per_pos // n_dev
    if pos_chunk is None:
        # per-DEVICE step size: same measured flat optimum as
        # core.score.fluxmap_retrace (16-45 positions, <2^22 rays/step)
        pos_chunk = max(1, min(32, (1 << 22) // max(n_local, 1)))
    run = _retrace_program(mesh, scene, grid, n_local, cfg, pos_chunk)
    return run(key, scene, source)


@_memo_program
def _retrace_program(mesh, scene, grid, n_local, cfg, pos_chunk):
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), scene_spec(scene), P()),
        out_specs=P(),
        check_vma=False,
    )
    def run(key, scene, src):
        k = _per_shard_key(key, RAY_AXIS)
        counts = fluxmap_retrace(k, scene, src, grid, n_local, cfg,
                                 pos_chunk=pos_chunk)
        return jax.lax.psum(counts, RAY_AXIS)

    return jax.jit(run)


def sharded_retrace_binomial(
    mesh: Mesh,
    key: jax.Array,
    scene: SphereScene,
    source: Source,
    grid: DetectorGrid,
    n_rays_per_pos: int,
    cfg: TraceConfig = TraceConfig(),
    oversample: int = 128,
    pos_chunk: int | None = None,
    qmc: bool = True,
    method: str = "mxu",
):
    """Multi-chip binomial retrace (docs/PARITY.md §9): each chip traces
    ``oversample * n_rays_per_pos / n_devices`` of the shared sample and
    scores its exit segments; one ``psum`` merges the hit counts into the
    global ``pi_hat``, and the per-cell binomial draws run replicated
    (same key on every chip -> identical draws, no second collective).

    Same error contract as ``fluxmap_retrace_binomial`` — the shared
    sample is simply sharded.  Returns ``[n_theta, n_phi]`` int32 counts.
    """
    import dataclasses

    from ..core.score import exit_capacity

    if oversample < 2:
        raise ValueError("oversample must be >= 2: the shared "
                         "sample must exceed the per-position count")
    n_dev = mesh.devices.size
    M = int(oversample) * int(n_rays_per_pos)
    if M % n_dev:
        raise ValueError("oversample * n_rays_per_pos must divide over "
                         "devices")
    m_local = M // n_dev
    if qmc and not cfg.qmc:
        # Sobol shared sample (core/qmc.py) — per-shard keys give each
        # chip an independent digital shift, so shards stay independent
        cfg = dataclasses.replace(cfg, qmc=1)
    cap = exit_capacity(scene, m_local)
    if pos_chunk is None:
        pos_chunk = max(8, min(1080, (1 << 28) // max(cap, 1)))
    run = _retrace_binomial_program(mesh, scene, grid, m_local, cfg, cap,
                                    pos_chunk, method, M, n_rays_per_pos,
                                    WAVES_THRESHOLD)
    return run(key, scene, source)


@_memo_program
def _retrace_binomial_program(mesh, scene, grid, m_local, cfg, cap,
                              pos_chunk, method, M, n_rays_per_pos,
                              waves_threshold):
    from ..core.score import (
        binomial_cells_from_counts, fluxmap_trace_once_compact)

    tracer = _pick_tracer(scene, m_local, cfg, waves_threshold)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), scene_spec(scene), P()),
        out_specs=P(),
        check_vma=False,
    )
    def run(key, scene, src):
        k_trace, k_draw = jax.random.split(jax.random.fold_in(key, 0x51))
        res = tracer(_per_shard_key(k_trace, RAY_AXIS), scene, src,
                     m_local, cfg)
        counts, overflow = fluxmap_trace_once_compact(
            res, grid, cap, scene.exit_port_z, pos_chunk, method)
        counts = jax.lax.psum(counts, RAY_AXIS)
        overflow = jax.lax.psum(overflow, RAY_AXIS)
        return binomial_cells_from_counts(k_draw, counts, overflow, M,
                                          n_rays_per_pos, grid.n_positions)

    return jax.jit(run)


def replicate(x, mesh: Mesh):
    """Put a host value on every device of the mesh (replicated)."""
    return jax.device_put(x, NamedSharding(mesh, P()))

def sharded_insphere(
    mesh: Mesh,
    key: jax.Array,
    scene: SphereScene,
    source: Source,
    centers,
    normals,
    disk_radius,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
    retrace: bool = False,
    pos_chunk: int | None = None,
):
    """Multi-chip in-sphere focal-disk sweep
    (``integratingSphereDetectorSweep.C:31-105``).

    ``centers`` / ``normals``: ``[P, 3]`` disk placements (from
    ``core.score.insphere_disk_position``), replicated to every chip.

    * ``retrace=False`` — ONE shared trace, ray axis sharded: each chip
      traces ``n_rays / n_devices`` rays, scores them against every disk,
      one ``psum`` merges the ``[P]`` hit counts.
    * ``retrace=True``  — fresh rays per position, reference methodology:
      each chip traces ``n_rays / n_devices`` rays for EVERY position
      (chunked ``pos_chunk`` positions per scan step like
      ``fluxmap_retrace``), counts just add across chips.

    Returns ``[P]`` int32 hit counts out of ``n_rays`` rays per position
    (retrace) / total (trace-once).
    """
    n_dev = mesh.devices.size
    if n_rays % n_dev:
        raise ValueError(f"n_rays={n_rays} must divide over {n_dev} devices")
    n_local = n_rays // n_dev
    centers = jnp.asarray(centers)
    normals = jnp.asarray(normals)
    n_pos = centers.shape[0]

    if not retrace:
        run_once = _insphere_once_program(
            mesh, scene, n_local, cfg, n_pos, float(disk_radius),
            WAVES_THRESHOLD)
        return run_once(key, scene, source, centers, normals)

    if pos_chunk is None:
        pos_chunk = max(1, min(32, (1 << 22) // max(n_local, 1)))
    chunk = min(pos_chunk, n_pos)
    n_chunks = -(-n_pos // chunk)
    pad = n_chunks * chunk - n_pos
    C = centers
    N = normals
    if pad:
        C = jnp.concatenate([C, jnp.zeros((pad, 3), C.dtype)])
        N = jnp.concatenate(
            [N, jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], N.dtype), (pad, 1))])
    run_retrace = _insphere_retrace_program(
        mesh, scene, n_local, cfg, n_pos, float(disk_radius), chunk,
        n_chunks, WAVES_THRESHOLD)
    return run_retrace(key, scene, source, C, N)


@_memo_program
def _insphere_once_program(mesh, scene, n_local, cfg, n_pos, disk_radius,
                           waves_threshold):
    from ..core.geometry import Vec3
    from ..core.score import hits_insphere_disk

    tracer = _pick_tracer(scene, n_local, cfg, waves_threshold)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), scene_spec(scene), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    def run_once(key, scene, src, C, N):
        res = tracer(_per_shard_key(key, RAY_AXIS), scene, src,
                     n_local, cfg)
        counts = jax.lax.map(
            lambda i: hits_insphere_disk(
                res, Vec3(C[i, 0], C[i, 1], C[i, 2]),
                Vec3(N[i, 0], N[i, 1], N[i, 2]), disk_radius),
            jnp.arange(n_pos))
        return jax.lax.psum(counts, RAY_AXIS)

    return jax.jit(run_once)


@_memo_program
def _insphere_retrace_program(mesh, scene, n_local, cfg, n_pos, disk_radius,
                              chunk, n_chunks, waves_threshold):
    from ..core.geometry import Vec3
    from ..core.score import insphere_disk_hit_mask

    tracer = _pick_tracer(scene, n_local, cfg, waves_threshold)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), scene_spec(scene), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    def run_retrace(key, scene, src, C, N):
        k_shard = _per_shard_key(key, RAY_AXIS)

        def one(carry, i):
            k = jax.random.fold_in(k_shard, i)
            res = tracer(k, scene, src, n_local * chunk, cfg)
            owner = jnp.arange(n_local * chunk) // n_local
            c = jax.lax.dynamic_slice_in_dim(C, i * chunk, chunk)
            nn = jax.lax.dynamic_slice_in_dim(N, i * chunk, chunk)
            cen = Vec3(c[owner, 0], c[owner, 1], c[owner, 2])
            nrm = Vec3(nn[owner, 0], nn[owner, 1], nn[owner, 2])
            ok = insphere_disk_hit_mask(res, cen, nrm, disk_radius)
            return carry, jnp.sum(ok.reshape(chunk, n_local), axis=1,
                                  dtype=jnp.int32)

        _, counts = jax.lax.scan(one, jnp.zeros((), jnp.int32),
                                 jnp.arange(n_chunks))
        return jax.lax.psum(counts.reshape(-1)[:n_pos], RAY_AXIS)

    return jax.jit(run_retrace)


def sharded_scatter_retrace(
    mesh: Mesh,
    key: jax.Array,
    scene: SphereScene,
    source: Source,
    grid,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
    only_rescatter_absorbed: bool = False,
):
    """Multi-chip two-stage scatter-retrace (``nonLambertianFlux.C:235-304``
    methodology; ``sweep/scatter_retrace.py``).

    Both stages are embarrassingly parallel over rays — trace, endpoint
    re-scatter and re-trace all stay chip-local; the only communication is
    one ``psum`` of the ``[n_theta, n_phi]`` hit map.  Returns int32 counts
    out of ``n_rays`` total.
    """
    n_dev = mesh.devices.size
    if n_rays % n_dev:
        raise ValueError(f"n_rays={n_rays} must divide over {n_dev} devices")
    run = _scatter_retrace_mesh_program(
        mesh, scene, grid, n_rays // n_dev, cfg,
        bool(only_rescatter_absorbed))
    return run(key, scene, source)


@_memo_program
def _scatter_retrace_mesh_program(mesh, scene, grid, n_local, cfg, only_abs):
    from ..core.score import fluxmap_trace_once
    from ..sweep.scatter_retrace import trace_scatter_retrace

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), scene_spec(scene), P()),
        out_specs=P(),
        check_vma=False,
    )
    def run(key, scene, src):
        k = _per_shard_key(key, RAY_AXIS)
        res = trace_scatter_retrace(k, scene, src, n_local, cfg, only_abs)
        counts = fluxmap_trace_once(res, grid, scene.exit_port_z)
        return jax.lax.psum(counts, RAY_AXIS)

    return jax.jit(run)


def sharded_distribution(
    mesh: Mesh,
    key: jax.Array,
    scene: SphereScene,
    source: Source,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
):
    """Multi-chip exit angular-distribution run
    (``distributionSphereDetectorSweep.C`` / ``sweep/distribution.py``).

    Histograms are psum-merged; the per-ray exit-direction payload (the
    ``3dRayLog.txt`` product) comes back SHARDED over the ray axis —
    device-local until the caller materialises it (``np.asarray``), so the
    gather rides the host readback the caller already pays.

    Returns ``(angle_hist [180], dz_hist [100], mask [n], dx, dy, dz)``.
    """
    n_dev = mesh.devices.size
    if n_rays % n_dev:
        raise ValueError(f"n_rays={n_rays} must divide over {n_dev} devices")
    run = _distribution_mesh_program(mesh, scene, n_rays // n_dev, cfg)
    return run(key, scene, source)


@_memo_program
def _distribution_mesh_program(mesh, scene, n_local, cfg):
    from ..core.score import (
        exit_angle_histogram, exit_directions, z_angle_histogram)

    tracer = _pick_tracer(scene, n_local, cfg, WAVES_THRESHOLD)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), scene_spec(scene), P()),
        out_specs=(P(), P(), P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS),
                   P(RAY_AXIS)),
        check_vma=False,
    )
    def run(key, scene, src):
        res = tracer(_per_shard_key(key, RAY_AXIS), scene, src, n_local, cfg)
        mask, dx, dy, dz = exit_directions(res, scene.exit_port_z)
        ang = jax.lax.psum(
            exit_angle_histogram(res, exit_port_z=scene.exit_port_z),
            RAY_AXIS)
        dzh = jax.lax.psum(z_angle_histogram(dz, mask), RAY_AXIS)
        return ang, dzh, mask, dx, dy, dz

    return jax.jit(run)


def sharded_twofold_pair(
    mesh: Mesh,
    key: jax.Array,
    scene: SphereScene,
    source: Source,
    grid,
    n_rays: int,
    cfg: TraceConfig,
    theta,
    phi,
):
    """Multi-chip twofold pair (``sweepDetectorTwofold``,
    ``fluxAtObserverFast.C:336-408``): one fresh batch split over chips,
    scored against the antipodal detector pair (theta, phi)/(theta,
    phi+180); one ``psum`` of the 2-vector of hit counts.  Driven per pair
    by ``sweep_detector_twofold(mesh=...)``.
    """
    n_dev = mesh.devices.size
    if n_rays % n_dev:
        raise ValueError(f"n_rays={n_rays} must divide over {n_dev} devices")
    run = _twofold_pair_mesh_program(mesh, scene, grid, n_rays // n_dev, cfg)
    return run(key, scene, source, jnp.float32(theta), jnp.float32(phi))


@_memo_program
def _twofold_pair_mesh_program(mesh, scene, grid, n_local, cfg):
    from ..core.geometry import detector_position, line_hits_disk

    tracer = _pick_tracer(scene, n_local, cfg, WAVES_THRESHOLD)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), scene_spec(scene), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    def run(key, scene, src, theta, phi):
        res = tracer(_per_shard_key(key, RAY_AXIS), scene, src, n_local, cfg)
        mask = res.exited_port_mask(scene.exit_port_z)
        out = []
        for p in (phi, phi + 180.0):
            c, n = detector_position(theta, p, grid.radius,
                                     scene.exit_port_z)
            hit = line_hits_disk(res.last_point, res.direction, c, n,
                                 grid.width / 2.0)
            out.append(jnp.sum(hit & mask, dtype=jnp.int32))
        return jax.lax.psum(jnp.stack(out), RAY_AXIS)

    return jax.jit(run)
