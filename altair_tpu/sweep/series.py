"""Sweep series — the reference's overnight for-loops as batched runs.

``sweepSeries`` (``fluxAtObserverOptimize.C:892-921``: port angles 163-178;
``fluxAtObserverFast.C:1641-1673``: 5 repeats at port 164; commented source-
direction series) are sequential overnight loops.  Here a series is either

* ``run_series`` — the faithful sequential driver (one CSV per member, same
  folder naming), or
* ``run_series_vmapped`` — the batched version: scene parameters become a
  batch axis (``vmap`` over the scene pytree), all members trace in one
  device call.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DetectorGrid, SphereScene, Source, TraceConfig
from ..core.memo import memo_program
from ..core.score import fluxmap_trace_once
from ..core.trace import trace_rays
from .observer import SweepResult, sweep_detector_trace_once


def series_folder(prefix: str, source: Source, tag) -> str:
    """Folder naming of sweepSeries (``fluxAtObserverFast.C:1648-1653``):
    ``{prefix}_{srcX}_{srcY}_{srcZ}_{tag}`` with int-truncated cm."""
    return (f"{prefix}_{int(float(source.x))}_{int(float(source.y))}_"
            f"{int(float(source.z))}_{int(tag)}")


def run_series(
    base_scene: SphereScene,
    source: Source,
    *,
    port_angles: Sequence[float] = (164.0,),
    sources: Sequence[Source] | None = None,
    repeats: int = 5,
    n_rays: int = 100_000,
    grid: DetectorGrid = DetectorGrid(),
    save_root: str | None = ".",
    prefix: str = "portAngleSweep",
    seed: int = 0,
    cfg: TraceConfig = TraceConfig(),
    verbose: bool = True,
) -> list[SweepResult]:
    """Sequential series of trace-once sweeps — one CSV per run, repeats
    accumulate with ``_1``, ``_2``, ... suffixes in the same folder exactly
    like the reference's repeat runs.  ``sources`` adds the source axis of
    ``sweepSeries`` (``fluxAtObserverOptimize.C:892-921``: the srcX loop):
    each member runs every ``port_angles`` x ``repeats`` combination, and
    the folder name carries its coordinates (``series_folder``) exactly
    like the reference's per-position directories."""
    out = []
    s = seed
    for src in (sources if sources is not None else [source]):
        for port in port_angles:
            scene = base_scene.with_(theta_max_deg=float(port))
            folder = (os.path.join(save_root,
                                   series_folder(prefix, src, port))
                      if save_root is not None else None)
            for r in range(repeats):
                res = sweep_detector_trace_once(
                    scene, src, n_rays=n_rays, grid=grid, seed=s,
                    cfg=cfg, save_folder=folder, verbose=verbose)
                out.append(res)
                s += 1
    if verbose:
        print("\n***** ALL SWEEP SERIES COMPLETE *****\n")
    return out


def stack_sources(base: Source, **param_arrays) -> Source:
    """Build a batched source pytree: each kwarg is an array over the
    series axis; remaining fields broadcast.  The batched counterpart of
    ``sweepSeries``'s source parameterisation (``fluxAtObserverOptimize.C:
    892-921`` srcX/srcY/srcZ/dirXBase loops and the commented source-
    direction series).  E.g.
    ``stack_sources(SOURCE_OVERNIGHT, x=jnp.arange(-80., -39., 10.))``."""
    if not param_arrays:
        raise ValueError("stack_sources needs at least one field array "
                         "(e.g. x=jnp.array([...])) to set the series "
                         "length")
    n = len(next(iter(param_arrays.values())))
    fields = {}
    for f in dataclasses.fields(base):
        v = param_arrays.get(f.name)
        if v is None:
            v = jnp.full((n,), float(getattr(base, f.name)), jnp.float32)
        else:
            v = jnp.asarray(v, jnp.float32)
            if v.shape != (n,):
                raise ValueError(f"source field {f.name}: expected shape "
                                 f"({n},), got {v.shape}")
        fields[f.name] = v
    return dataclasses.replace(base, **fields)


def source_members(sources: Source):
    """Iterate the concrete ``Source`` members of a batched source pytree."""
    if jnp.ndim(sources.x) != 1:
        raise TypeError(
            "sources must be a BATCHED Source pytree (leading series axis "
            "on every field — build one with stack_sources); got a plain "
            "Source / scalar fields")
    n = len(jnp.asarray(sources.x))
    for i in range(n):
        yield Source(*(float(jnp.asarray(getattr(sources, f.name))[i])
                       for f in dataclasses.fields(sources)))


def stack_scenes(base: SphereScene, **param_arrays) -> SphereScene:
    """Build a batched scene pytree: each kwarg is an array over the series
    axis; remaining fields broadcast.  E.g.
    ``stack_scenes(SCENE_OPTIMIZE, theta_max_deg=jnp.arange(163, 179))``."""
    n = len(next(iter(param_arrays.values())))
    # static metadata fields stay scalar (they are not vmappable)
    meta = {"surface_model", "max_bounces", "exact_rim"}
    fields = {}
    for f in dataclasses.fields(base):
        if f.name in meta:
            continue
        v = param_arrays.get(f.name)
        if v is None:
            v = jnp.full((n,), float(getattr(base, f.name)), jnp.float32)
        else:
            v = jnp.asarray(v, jnp.float32)
        fields[f.name] = v
    return dataclasses.replace(base, **fields)


def _series_tracer(base_scene: SphereScene, port_angles, cfg: TraceConfig):
    """Pick the per-member tracer for the batched series.

    Inside ``lax.map`` the scene's numeric fields are traced, which
    disables the static engine guards of ``trace_rays_auto`` — but the
    applicability facts are KNOWN here, because the concrete member list
    is: the surface model is static metadata, and the rim-deferral
    capacity (a static buffer shape) can be planned for the WORST member
    (smallest shift = largest buffer) before tracing.  Returns a
    ``(key, scene, source, n, cfg) -> TraceResult`` callable.
    """
    from ..core.trace import rim_deferred_capacity_shift, trace_rays_rim_deferred
    from ..core.trace_direct import direct_applicable, trace_rays_direct

    if not direct_applicable(base_scene, cfg) or cfg.engine == "simulate":
        if cfg.engine == "direct":
            raise NotImplementedError(
                "engine='direct' requires a statically-Lambertian scene")
        return trace_rays
    if not base_scene.exact_rim:
        return trace_rays_direct
    shifts = [rim_deferred_capacity_shift(
        base_scene.with_(theta_max_deg=float(p))) for p in port_angles]
    if any(s is None for s in shifts):
        if cfg.engine == "direct":
            raise NotImplementedError(
                "engine='direct': a member's rim does not admit the "
                "deferred post-pass (thick rim band)")
        return trace_rays  # a member needs the in-loop rim kernel
    shift = min(shifts)

    def tracer(key, scene, source, n, cfg):
        res, _ = trace_rays_rim_deferred(key, scene, source, n, cfg,
                                         capacity_shift=shift,
                                         main_tracer=trace_rays_direct)
        return res

    return tracer


@memo_program
def _series_program(base_scene, source, port_angles, n_rays, grid, cfg):
    from ..core.score import exit_capacity, fluxmap_trace_once_compact

    scenes = stack_scenes(
        base_scene, theta_max_deg=jnp.asarray(port_angles, jnp.float32))
    tracer = _series_tracer(base_scene, port_angles, cfg)
    cap = max(exit_capacity(base_scene.with_(theta_max_deg=float(p)), n_rays)
              for p in port_angles)

    @jax.jit
    def run(key):
        def one(i, scene):
            res = tracer(jax.random.fold_in(key, i), scene, source,
                         n_rays, cfg)
            counts, overflow = fluxmap_trace_once_compact(
                res, grid, cap, scene.exit_port_z)
            return (counts, res.exited_port_mask(scene.exit_port_z).sum(),
                    overflow)

        return jax.lax.map(
            lambda args: one(args[0], args[1]),
            (jnp.arange(len(port_angles)), scenes))

    return run


@memo_program
def _source_series_program(scene, n_members, n_rays, grid, cfg):
    """Batched-SOURCE series: one scene, ``lax.map`` over source members.
    The member VALUES are runtime jit arguments (only the member COUNT is
    in the memo key), so sweeping a different grid of source positions
    re-uses the compiled program — sources never affect engine planning
    (they only set the first flight), which is the single concrete
    scene's."""
    from ..core.score import exit_capacity, fluxmap_trace_once_compact

    tracer = _series_tracer(scene, [float(scene.theta_max_deg)], cfg)
    cap = exit_capacity(scene, n_rays)

    @jax.jit
    def run(key, sources):
        def one(i, src):
            res = tracer(jax.random.fold_in(key, i), scene, src,
                         n_rays, cfg)
            counts, overflow = fluxmap_trace_once_compact(
                res, grid, cap, scene.exit_port_z)
            return (counts, res.exited_port_mask(scene.exit_port_z).sum(),
                    overflow)

        return jax.lax.map(
            lambda args: one(args[0], args[1]),
            (jnp.arange(n_members), sources))

    return run


def run_series_vmapped(
    base_scene: SphereScene,
    source: Source = None,
    *,
    port_angles: Sequence[float] | None = None,
    sources: Source | None = None,
    n_rays: int = 100_000,
    grid: DetectorGrid = DetectorGrid(),
    seed: int = 0,
    cfg: TraceConfig = TraceConfig(),
):
    """All series members in one device call: ``vmap`` over the scene batch
    axis.  Returns (fluxmaps [S, n_theta, n_phi] counts, exits [S]).

    The batch axis is EITHER ``port_angles`` (scene-parameter series,
    ``source`` fixed) OR ``sources`` (a batched ``Source`` pytree from
    ``stack_sources`` — the srcX/Y/Z/dirXBase axis of ``sweepSeries``,
    ``fluxAtObserverOptimize.C:892-921``, scene fixed).

    Members dispatch to the same engines as the sequential path — the
    direct sampler (with the deferred-rim post-pass) for statically-
    Lambertian scenes — because the static applicability facts are
    computed from the concrete member list before batching
    (``_series_tracer``); scoring runs on the compacted exit subset sized
    for the widest-port member."""
    if (port_angles is None) == (sources is None):
        raise ValueError("pass exactly one of port_angles= (scene series) "
                         "or sources= (source series)")
    if sources is not None:
        from ..config import validate

        members = list(source_members(sources))
        for s in members:
            validate(base_scene, s)  # same fail-fast as the sequential path
        src32 = Source(*(jnp.asarray(getattr(sources, f.name), jnp.float32)
                         for f in dataclasses.fields(sources)))
        run = _source_series_program(base_scene, len(members), n_rays,
                                     grid, cfg)
        counts, exits, overflow = run(jax.random.key(seed), src32)
    else:
        run = _series_program(base_scene, source,
                              tuple(float(p) for p in port_angles),
                              n_rays, grid, cfg)
        counts, exits, overflow = run(jax.random.key(seed))
    if int(np.asarray(overflow).sum()):
        raise RuntimeError("exit-compaction overflow in series scoring — "
                           "statistically impossible at the 6-sigma "
                           "capacity; investigate")
    return np.asarray(counts), np.asarray(exits)
