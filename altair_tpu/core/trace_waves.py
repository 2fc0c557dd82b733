"""Wave-compaction tracer — dead-lane elimination for large batches.

The plain while-loop kernel (core/trace.py) keeps every lane busy until the
LAST ray dies: with per-bounce termination probability p ≈ 0.0175
(production scene) the loop runs ~ln(N)/p iterations while the mean ray only
needs 1/p ≈ 57 — a ~10x duty-cycle waste at N = 1M.

This variant traces in WAVES: a fixed block of iterations over the full
batch, then the survivors (~ (1-p)^iters of the batch) are compacted into a
4x-smaller buffer (static shapes — capacity checked, see ``n_overflow``)
and the next wave runs on that, recursively down to a small tail that
finishes with the exact while-loop kernel.  Total lane-iterations drop from
~ln(N)/p * N to ~wave_iters * N * 4/3, a ~6x reduction, at the cost of one
O(N) compaction (jnp.nonzero + gather) per wave.

Results are bit-compatible in DISTRIBUTION but not in stream with the plain
kernel (compaction reindexes lanes, so per-bounce draws differ) — same
caveat as any parallelism change in the reference (SURVEY.md §7).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import SphereScene, Source, TraceConfig
from .geometry import Vec3
from .trace import ABSORBED, RUNNING, SUSPENDED, TraceResult, make_bounce_step


def trace_rays_waves(
    key: jax.Array,
    scene: SphereScene,
    source: Source,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
    wave_iters: int = 256,
    shrink: int = 16,
    min_wave: int = 65536,
    first_wave_iters: int | None = None,
) -> tuple[TraceResult, jax.Array]:
    """Returns (TraceResult, n_overflow).  ``n_overflow`` is the number of
    rays that could not be carried into a compacted wave (suspended early);
    with the default 4x shrink it is zero except with astronomically
    unlikely survival fluctuations or reflectance ~1 scenes — for those use
    the plain kernel (`trace_rays`).
    """
    dtype = cfg.dtype
    shape = (n_rays,)
    pos = Vec3(
        jnp.broadcast_to(jnp.asarray(source.x, dtype), shape),
        jnp.broadcast_to(jnp.asarray(source.y, dtype), shape),
        jnp.broadcast_to(jnp.asarray(source.z, dtype), shape),
    )
    direction = Vec3(
        jnp.broadcast_to(jnp.asarray(source.dir_x, dtype), shape),
        jnp.broadcast_to(jnp.asarray(source.dir_y, dtype), shape),
        jnp.broadcast_to(jnp.asarray(source.dir_z, dtype), shape),
    ).normalized()
    state = (pos, direction, pos, jnp.zeros(shape, jnp.int32),
             jnp.zeros(shape, jnp.int32), jnp.zeros(shape, bool))
    return trace_waves_from_state(key, scene, state, cfg, wave_iters,
                                  shrink, min_wave, first_wave_iters)


def trace_waves_from_state(
    key: jax.Array,
    scene: SphereScene,
    state,
    cfg: TraceConfig = TraceConfig(),
    wave_iters: int = 256,
    shrink: int = 16,
    min_wave: int = 65536,
    first_wave_iters: int | None = None,
) -> tuple[TraceResult, jax.Array]:
    """Wave-compaction trace from an arbitrary mid-flight ray state
    ``(pos, direction, prev, status, bounces, in_gap)`` (the bounce-step
    carry).  Used directly by ``trace_rays_waves`` (source init) and by the
    deferred-rim continuation, whose large-batch tail would otherwise run
    uncompacted.

    ``first_wave_iters`` (None = ``wave_iters``) shortens only wave 0: a
    caller whose entry state is mostly DEAD lanes (the rim continuation's
    compaction buffer runs at ~1/2.8 occupancy) compacts the padding away
    after a few iterations instead of carrying it for a full wave — pick
    ``shrink`` so the first capacity ``n // shrink`` still covers the
    worst-case live count, since a short first wave kills far fewer lanes
    before the first compaction."""
    pos, direction, prev0, status0, bounces0, in_gap0 = state
    n_rays = pos.x.shape[0]
    shape = (n_rays,)

    # output buffers (original ray order)
    out_pos = pos
    out_dir = direction
    out_prev = prev0
    out_status = status0
    out_bounces = bounces0

    max_iters = int(scene.max_bounces)
    it0 = 0
    # wave over the full batch
    wkey = jax.random.fold_in(key, 0)
    step = make_bounce_step(wkey, scene, n_rays, cfg)
    carry = (pos, direction, prev0, status0, bounces0, in_gap0)
    iters = min(wave_iters if first_wave_iters is None
                else first_wave_iters, max_iters)
    carry = jax.lax.fori_loop(0, iters, step, carry)
    it0 += iters
    pos, direction, prev, status, bounces, in_gap = carry
    out_pos, out_dir, out_prev = pos, direction, prev
    out_status, out_bounces = status, bounces
    perm = jnp.arange(n_rays)

    m = n_rays
    wave = 1
    n_overflow = jnp.zeros((), jnp.int32)
    while m > min_wave and it0 < max_iters:
        m_next = max(min_wave, m // shrink)
        alive = status == RUNNING
        n_alive = jnp.sum(alive, dtype=jnp.int32)
        n_overflow = n_overflow + jnp.maximum(n_alive - m_next, 0)
        from .compact import nonzero_indices

        idx = nonzero_indices(alive, m_next, m)
        valid = idx < m

        def g(a):
            return jnp.where(valid, a[jnp.minimum(idx, m - 1)], 0)

        def gv(v: Vec3) -> Vec3:
            return Vec3(g(v.x), g(v.y), g(v.z))

        pos = gv(pos)
        direction = gv(direction)
        prev = gv(prev)
        bounces = g(bounces)
        in_gap = g(in_gap.astype(jnp.int32)).astype(bool)
        status = jnp.where(valid, RUNNING, ABSORBED).astype(jnp.int32)
        # invalid (padding) lanes get perm = n_rays so every later scatter
        # of their state is dropped out-of-bounds
        perm = jnp.where(valid, perm[jnp.minimum(idx, m - 1)], n_rays)

        wkey = jax.random.fold_in(key, wave)
        step = make_bounce_step(wkey, scene, m_next, cfg)
        iters = min(wave_iters, max_iters - it0)
        carry = (pos, direction, prev, status, bounces, in_gap)
        carry = jax.lax.fori_loop(0, iters, step, carry)
        it0 += iters
        pos, direction, prev, status, bounces, in_gap = carry

        # scatter this wave's state back into the output buffers
        sidx = perm  # padding lanes carry perm = n_rays -> dropped
        out_status = out_status.at[sidx].set(status, mode="drop")
        out_bounces = out_bounces.at[sidx].set(bounces, mode="drop")

        def sv(out: Vec3, new: Vec3) -> Vec3:
            return Vec3(out.x.at[sidx].set(new.x, mode="drop"),
                        out.y.at[sidx].set(new.y, mode="drop"),
                        out.z.at[sidx].set(new.z, mode="drop"))

        out_pos = sv(out_pos, pos)
        out_dir = sv(out_dir, direction)
        out_prev = sv(out_prev, prev)
        m = m_next
        wave += 1

    # tail: finish stragglers with the exact while loop on the small buffer
    if it0 < max_iters:
        wkey = jax.random.fold_in(key, 10_000 + wave)
        # cap the tail's bounce budget at the REMAINING iterations (the
        # step's internal guard compares its local index against the scene
        # cap, which restarts at 0 here)
        step = make_bounce_step(
            wkey, scene.with_(max_bounces=max_iters - it0), m, cfg)

        def cond(state):
            it, carry = state
            return (it < max_iters - it0) & jnp.any(carry[3] == RUNNING)

        def body(state):
            it, carry = state
            carry = jax.lax.fori_loop(
                0, 16, lambda j, c: step(it + j, c), carry)
            return it + 16, carry

        _, (pos, direction, prev, status, bounces, in_gap) = (
            jax.lax.while_loop(
                cond, body,
                (0, (pos, direction, prev, status, bounces, in_gap))))
        if m < n_rays:
            sidx = perm
            out_status = out_status.at[sidx].set(status, mode="drop")
            out_bounces = out_bounces.at[sidx].set(bounces, mode="drop")

            def sv2(out: Vec3, new: Vec3) -> Vec3:
                return Vec3(out.x.at[sidx].set(new.x, mode="drop"),
                            out.y.at[sidx].set(new.y, mode="drop"),
                            out.z.at[sidx].set(new.z, mode="drop"))

            out_pos = sv2(out_pos, pos)
            out_dir = sv2(out_dir, direction)
            out_prev = sv2(out_prev, prev)
        else:
            out_pos, out_dir, out_prev = pos, direction, prev
            out_status, out_bounces = status, bounces

    out_status = jnp.where(out_status == RUNNING, SUSPENDED, out_status)
    return TraceResult(out_status, out_pos, out_prev, out_dir,
                       out_bounces), n_overflow


def waves_safe(scene: SphereScene, wave_iters: int = 256,
               shrink: int = 16) -> bool:
    """True when the expected wave-survival fraction comfortably fits the
    compaction capacity (needs concrete scene parameters).  Survival per
    bounce = reflectance * (1 - p_port); capacity margin 2x."""
    import numbers

    if not all(isinstance(v, numbers.Number)
               for v in (scene.theta_max_deg, scene.reflectance)):
        return False
    from ..config import port_escape_probability

    s = float(scene.reflectance) * (1 - port_escape_probability(
        scene.theta_max_deg))
    return s ** wave_iters < 1 / (2 * shrink)


def trace_rays_auto(
    key: jax.Array,
    scene: SphereScene,
    source: Source,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
    waves_threshold: int = 262_144,
) -> TraceResult:
    """Engine dispatch. Composable fast paths, each with a provably-safe
    guard, falling back to the plain while-loop kernel:

    * statically-Lambertian scenes sample the trace outcome DIRECTLY from
      its closed-form law (``trace_rays_direct`` — the integrating-sphere
      uniform-form-factor identity makes this distribution-exact, no
      bounce loop at all); ``cfg.engine="simulate"`` opts out;
    * exact-rim scenes route through the rim-DEFERRED tracer (rim physics
      once per ray instead of once per lane-iteration; ~simple-mode cost);
    * the four static wall laws run the GPU bounce kernel
      (``trace_pallas``) on the GPU backend, with the rim post-pass
      around it for exact-rim scenes;
    * otherwise large batches run the wave-compaction tracer — as the
      rim-deferred main phase when both apply.

    Same TraceResult contract as ``trace_rays``."""
    from .trace import (
        rim_deferred_capacity_shift,
        trace_rays,
        trace_rays_rim_deferred,
    )

    if cfg.keep_history:
        if cfg.engine == "direct":
            raise ValueError("direct sampling has no path history")
        return trace_rays(key, scene, source, n_rays, cfg)

    from .trace_direct import direct_applicable, trace_rays_direct

    if cfg.engine in ("auto", "direct") and direct_applicable(scene, cfg):
        if not scene.exact_rim:
            return trace_rays_direct(key, scene, source, n_rays, cfg)
        shift = rim_deferred_capacity_shift(scene)
        if shift is not None:
            res, _ = trace_rays_rim_deferred(
                key, scene, source, n_rays, cfg, capacity_shift=shift,
                main_tracer=trace_rays_direct)
            return res
        # thick-rim / traced-parameter scenes need the in-loop rim kernel
        # for the main phase — fall through to the simulation engines
    if cfg.engine == "direct":
        raise NotImplementedError(
            "engine='direct' requires a statically-Lambertian scene whose "
            "rim (if exact_rim) admits the deferred post-pass")
    # the GPU bounce kernel first where it applies: each ray walks to its
    # end in registers with no device-memory carry traffic (PERF.md,
    # "Kernel decisions"); exact-rim scenes compose it with the deferred
    # rim post-pass inside trace_rays_fast.
    from .trace_pallas import pallas_applicable, trace_rays_fast

    if pallas_applicable(scene, cfg):
        return trace_rays_fast(key, scene, source, n_rays, cfg)
    use_waves = n_rays >= waves_threshold and waves_safe(scene)
    shift = rim_deferred_capacity_shift(scene) if scene.exact_rim else None
    if shift is not None:
        main = None
        if use_waves:
            def main(k, sc, so, n, c):
                return trace_rays_waves(k, sc, so, n, c)[0]
        res, _ = trace_rays_rim_deferred(key, scene, source, n_rays, cfg,
                                         capacity_shift=shift,
                                         main_tracer=main)
        return res
    # exact-rim scenes that can't be safely deferred (thick rim band /
    # traced params) run the in-loop rim kernel, inside waves when large
    if use_waves:
        return trace_rays_waves(key, scene, source, n_rays, cfg)[0]
    return trace_rays(key, scene, source, n_rays, cfg)
