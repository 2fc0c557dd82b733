"""The bounce kernel — the array-program replacement for
``AOpticsManager::TraceNonSequential`` (ROBAST's C++ trace loop, called at
``fluxAtObserver.C:202`` / ``fluxAtObserverOptimize.C:295``).

Instead of an object-per-ray state machine on <=4 CPU threads
(``fluxAtObserverOptimize.C:450-454``), the whole batch advances one bounce
per iteration of a ``lax.while_loop``: closed-form sphere intersection, port
test, reflectance roulette, scatter sample — all ``[N]``-vectorised.  Rays are structure-of-arrays (three ``[N]`` component arrays), statuses
are an ``[N]`` int vector (replacing ``ARayArray::GetStopped/GetExited``
partitioning with masks), and the loop exits as soon as every ray is dead.

The per-ray payload kept is exactly what every scorer in the reference uses:
the final segment (second-to-last point, last point, direction) — see
``RayEndpoint`` at ``fluxAtObserverFast.C:1156-1161`` — plus status and
bounce count.  Full path history is an opt-in bounded buffer for the visual
demo path only (``ARay::MakePolyLine3D`` parity).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SphereScene, Source, TraceConfig
from .geometry import Vec3, ray_box_exit_t, sphere_hit
from .sampling import scatter

# Ray status codes (ARay state machine, fluxAtObserverOptimize.C:271-273,
# fluxAtObserverFast.C:1504-1510).
RUNNING = 0     # still bouncing inside the sphere
EXITED = 1      # escaped through the port cap, flew to the world box
ABSORBED = 2    # killed by the reflectance roulette at a wall hit
SUSPENDED = 3   # hit the bounce limit (ray->Suspend() guard)


class TraceResult(NamedTuple):
    """SoA trace output for a batch of N rays."""

    status: jax.Array        # [N] int32, one of the codes above
    last_point: jax.Array    # Vec3 [N] — ARay::GetLastPoint
    seg_start: jax.Array     # Vec3 [N] — second-to-last point (segment start)
    direction: jax.Array     # Vec3 [N] — final unit direction
    n_bounces: jax.Array     # [N] int32 — wall interactions before death
    history: jax.Array | None = None        # [K, N, 3] optional path points
    history_len: jax.Array | None = None    # [N] int32 number of valid points

    def exited_port_mask(self, exit_port_z=-100.0):
        """The reference's exit test: last point z < exitPortZ
        (``fluxAtObserver.C:162-166``) — applied to geometric exits."""
        return (self.status == EXITED) & (self.last_point.z < exit_port_z)


class RimOverflow(NamedTuple):
    """Capacity diagnostics from ``trace_rays_rim_deferred``.

    ``total`` keeps the historical scalar contract (``int(ovf)`` still
    works): every lane the deferred-rim pass could not process, from any
    level.  ``grouped_drops`` separates the level-2 group-capacity drops
    of the grouped compaction (cushion ~1.25x) from plain clip-capacity
    excess (cushion ~2.8x), so an overflow's cause is distinguishable
    (ADVICE r3: folding them hid which capacity bound).
    """

    total: jax.Array          # [] int32 — all unprocessed clip lanes
    grouped_drops: jax.Array  # [] int32 — level-2 group-capacity drops only

    def __int__(self) -> int:
        return int(self.total)


def _source_rays(source: Source, n: int, dtype) -> tuple[Vec3, Vec3]:
    shape = (n,)
    pos = Vec3(
        jnp.broadcast_to(jnp.asarray(source.x, dtype), shape),
        jnp.broadcast_to(jnp.asarray(source.y, dtype), shape),
        jnp.broadcast_to(jnp.asarray(source.z, dtype), shape),
    )
    d = Vec3(
        jnp.broadcast_to(jnp.asarray(source.dir_x, dtype), shape),
        jnp.broadcast_to(jnp.asarray(source.dir_y, dtype), shape),
        jnp.broadcast_to(jnp.asarray(source.dir_z, dtype), shape),
    ).normalized()
    return pos, d


def make_bounce_step(key: jax.Array, scene: SphereScene, n_rays: int,
                     cfg: TraceConfig):
    """Build the shared per-iteration bounce step.

    carry = (pos: Vec3, direction: Vec3, prev: Vec3, status: [N] i32,
    bounces: [N] i32, in_gap: [N] bool); ``step(it, carry) -> carry``.

    Physics per iteration (one surface event per lane):

    * interior lanes: advance to the inner shell; port-cap test; with
      ``scene.exact_rim`` an escaping flight that clips the shell's conical
      rim face (theta == theta_max, r in [inner, outer] — the TGeoSphere
      theta-range boundary) reflects there (Lambertian + roulette, like any
      mirror surface in ROBAST) and the lane moves to the GAP region;
      otherwise escape to the world box / wall bounce / roulette absorption.
    * gap lanes (between the shell radii on the hole side): nearest of
      {rim cone (reflect), inner sphere (re-enter the interior through the
      cap), outer sphere (escape outward to the box)}.

    ~4.6% of escaping rays clip the rim at port 170 deg; modelling it moves
    the exit fractions from the top of the corpus ranges onto their centres
    (see docs/PARITY.md).

    Cost: one shared cone solve serves both the interior clip check and the
    gap propagation (per-lane origin select), and ONE scatter draw serves
    whichever surface the lane hit (the normal is selected per lane before
    sampling).  The single scatter is also the faithful ROBAST semantics:
    the border condition attaches to the whole shell volume, so the rim
    annulus face scatters by the same law as the spherical wall
    (``fluxAtObserverOptimize.C:208-210`` sets ONE condition for the volume).
    """
    from .geometry import cone_crossing_t, cone_face_normal, sphere_crossing_t

    dtype = cfg.dtype
    radius = jnp.asarray(scene.inner_radius, dtype)
    r_out = jnp.asarray(scene.outer_radius, dtype)
    theta_max = jnp.deg2rad(jnp.asarray(scene.theta_max_deg, dtype))
    cos_tm = jnp.cos(theta_max)
    cos_cap = radius * cos_tm
    reflectance = jnp.asarray(scene.reflectance, dtype)
    world_half = jnp.asarray(scene.world_half, dtype)
    exact_rim = bool(scene.exact_rim)
    max_iters = int(scene.max_bounces)
    INF = 1e30

    def step(it, carry):
        pos, direction, prev, status, bounces, in_gap = carry
        # `it < max_iters` keeps a partial trailing block of iterations from
        # overshooting the SetLimit bounce cap.
        active = (status == RUNNING) & (it < max_iters)

        k_it = jax.random.fold_in(key, it)
        k_surv, k_scat = jax.random.split(k_it)
        survive = (
            jax.random.uniform(k_surv, (n_rays,), dtype) < reflectance
        )

        # ---- interior physics (valid for ~in_gap lanes) -------------------
        q = sphere_hit(pos, direction, radius)
        escaped = q.z < cos_cap  # in_port_cap inlined (q is on the sphere)
        normal = q.scale(-1.0 / radius)
        t_box = ray_box_exit_t(pos, direction, world_half)
        box_pt = pos + direction.scale(t_box)

        if not exact_rim:
            new_dir = scatter(k_scat, scene.surface_model, direction, normal,
                              scene)
            new_status = jnp.where(
                escaped, EXITED, jnp.where(survive, RUNNING, ABSORBED)
            ).astype(jnp.int32)
            status = jnp.where(active, new_status, status)
            prev = Vec3.where(active, pos, prev)
            pos = Vec3.where(active, Vec3.where(escaped, box_pt, q), pos)
            direction = Vec3.where(active & ~escaped & survive, new_dir,
                                   direction)
            bounces = jnp.where(active & ~escaped, bounces + 1, bounces)
            return pos, direction, prev, status, bounces, in_gap

        # ---- rim handling --------------------------------------------------
        interior = active & ~in_gap
        gap = active & in_gap

        # ONE cone solve serves both rim interactions: escaping interior
        # flights clip-check from q, gap lanes propagate from pos
        o_cone = Vec3.where(in_gap, pos, q)
        s_rim = cone_crossing_t(o_cone, direction, cos_tm, radius, r_out, INF)
        rim_i = escaped & (s_rim < INF)
        rim_pt = o_cone + direction.scale(s_rim)

        # gap propagation: nearest of cone / inner sphere / outer sphere
        s_in = sphere_crossing_t(pos, direction, radius, INF)
        s_outs = sphere_crossing_t(pos, direction, r_out, INF)
        gap_cone = gap & (s_rim < s_in) & (s_rim < s_outs)
        gap_enter = gap & ~gap_cone & (s_in < s_outs)
        gap_exit = gap & ~gap_cone & ~gap_enter & (s_outs < INF)
        gap_stuck = gap & ~gap_cone & ~gap_enter & ~gap_exit
        enter_pt = pos + direction.scale(s_in)
        enter_pt = enter_pt.scale(radius * jax.lax.rsqrt(enter_pt.norm2()))

        rim_bounce = (interior & rim_i) | gap_cone
        exits = (interior & escaped & ~rim_i) | gap_exit
        wall = interior & ~escaped
        absorbed = ((rim_bounce | wall) & ~survive)

        # ONE scatter draw serves whichever surface the lane hit: the normal
        # is selected per lane (rim-face theta_hat vs inward sphere normal)
        # before sampling — same border condition for every face of the
        # shell volume, as in ROBAST.
        scat_normal = Vec3.where(rim_bounce, cone_face_normal(rim_pt), normal)
        new_dir = scatter(k_scat, scene.surface_model, direction, scat_normal,
                          scene)

        new_status = jnp.where(
            exits, EXITED,
            jnp.where(absorbed, ABSORBED,
                      jnp.where(gap_stuck, SUSPENDED, RUNNING))
        ).astype(jnp.int32)
        status = jnp.where(active, new_status, status)

        upd = active & ~gap_stuck
        prev = Vec3.where(upd, pos, prev)
        new_pos = Vec3.where(
            exits, box_pt,
            Vec3.where(rim_bounce, rim_pt,
                       Vec3.where(gap_enter, enter_pt, q)))
        pos = Vec3.where(upd, new_pos, pos)
        direction = Vec3.where(upd & (rim_bounce | wall) & survive, new_dir,
                               direction)
        bounces = jnp.where(upd & (rim_bounce | wall), bounces + 1, bounces)
        in_gap = jnp.where(
            active, (rim_bounce & survive) | (gap & ~gap_enter & ~exits
                                              & ~absorbed & ~gap_stuck),
            in_gap)
        return pos, direction, prev, status, bounces, in_gap

    return step


def _while_trace(step_fn, carry, max_iters: int, block: int):
    """Run ``step_fn(it, carry) -> carry`` until ``max_iters`` or all lanes
    dead (``carry[3]`` is the status vector).  A block of bounces runs
    between alive-checks to amortise the while_loop condition reduction
    (the one sync point in the kernel)."""

    def cond(state):
        it, c = state
        return (it < max_iters) & jnp.any(c[3] == RUNNING)

    def body(state):
        it, c = state
        c = jax.lax.fori_loop(0, block, lambda j, cc: step_fn(it + j, cc), c)
        return it + block, c

    return jax.lax.while_loop(cond, body, (0, carry))[1]


def trace_rays(
    key: jax.Array,
    scene: SphereScene,
    source: Source,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
) -> TraceResult:
    """Trace ``n_rays`` from ``source`` through ``scene`` to completion.

    Equivalent of filling an ``ARayArray`` and calling
    ``TraceNonSequential(rayArray)`` (``fluxAtObserverOptimize.C:286-295``),
    but the batch IS the parallelism — shard the call with ``shard_map`` over
    a device mesh for the multi-chip version (see ``altair_tpu.parallel``).

    jit-compatible; ``n_rays`` and ``cfg`` are static.
    """
    dtype = cfg.dtype
    pos, direction = _source_rays(source, n_rays, dtype)

    status0 = jnp.zeros((n_rays,), jnp.int32)
    bounces0 = jnp.zeros((n_rays,), jnp.int32)

    keep_hist = int(cfg.keep_history)
    if keep_hist:
        hist0 = jnp.zeros((keep_hist, n_rays, 3), dtype)
        hist0 = hist0.at[0].set(pos.stack())
        hlen0 = jnp.ones((n_rays,), jnp.int32)
    else:
        # history is dropped from the carry entirely (zero-size arrays
        # break sharding propagation under shard_map)
        hist0 = ()
        hlen0 = ()

    max_iters = int(scene.max_bounces)
    step = make_bounce_step(key, scene, n_rays, cfg)

    def bounce_once(it, carry):
        pos, direction, prev, status, bounces, in_gap, hist, hlen = carry
        rec = (status == RUNNING) & (it < max_iters)
        (pos, direction, prev, status, bounces, in_gap) = step(
            it, (pos, direction, prev, status, bounces, in_gap))

        if keep_hist:
            slot = jnp.minimum(hlen, keep_hist - 1)
            hist = hist.at[slot, jnp.arange(n_rays)].set(
                jnp.where(rec[:, None], pos.stack(),
                          hist[slot, jnp.arange(n_rays)])
            )
            hlen = jnp.where(rec, jnp.minimum(hlen + 1, keep_hist), hlen)
            return pos, direction, prev, status, bounces, in_gap, hist, hlen
        return pos, direction, prev, status, bounces, in_gap, (), ()

    block = max(1, min(int(cfg.block_iters), max_iters))
    prev0 = pos
    in_gap0 = jnp.zeros((n_rays,), bool)
    init = (pos, direction, prev0, status0, bounces0, in_gap0, hist0, hlen0)
    (pos, direction, prev, status, bounces, _, hist, hlen) = _while_trace(
        bounce_once, init, max_iters, block)

    # Rays still running after the cap are suspended (the reference's
    # ray->Suspend() guard at fluxAtObserverOptimize.C:271-273).
    status = jnp.where(status == RUNNING, SUSPENDED, status)

    return TraceResult(
        status=status,
        last_point=pos,
        seg_start=prev,
        direction=direction,
        n_bounces=bounces,
        history=hist if keep_hist else None,
        history_len=hlen if keep_hist else None,
    )


@partial(jax.jit, static_argnames=("n_rays", "cfg"))
def trace_rays_jit(key, scene, source, n_rays, cfg=TraceConfig()):
    return trace_rays(key, scene, source, n_rays, cfg)


# continuations at least this wide wave-compact their own bounce tail
_WAVES_CONTINUATION_MIN = 65536
# Wave schedule of the rim continuation for scenes WITHOUT a closed-form
# finish (non-Lambertian walls — the nonLambertianFlux.C production path).
# The clip buffer enters at ~1/2.8 occupancy, so a short first wave +
# early compaction was HYPOTHESIZED to trim dead padding before the long
# bounce tail; on an earlier build every shortened first wave lost
# throughput (the extra compaction pass cost more than the padded
# iterations it saved), so the schedule stays (None, 4) — not yet
# measured on the H100 (RIM_CONT_FIRST_WAVE=None means "same as
# RIM_CONT_WAVE_ITERS").
RIM_CONT_WAVE_ITERS = 96
RIM_CONT_SHRINK = 4
RIM_CONT_FIRST_WAVE: int | None = None
# hybrid-continuation tails at least this wide recurse into the hybrid
# instead of running the in-loop kernel to extinction (module constant so
# tests can lower it and exercise the recursive branch at small N)
HYBRID_RECURSE_MIN = 32768


def rim_deferred_capacity_shift(scene: SphereScene) -> int | None:
    """Plan the deferred-rim continuation capacity for a scene, or ``None``
    when deferral is unsafe/unprofitable and the in-loop rim kernel should
    be used instead.

    The clip-given-escape fraction scales with the rim band's angular width
    seen across the port: band = shell_thickness / (r_inner * sin(alpha)),
    alpha = 180 - theta_max (measured 0.046 at band 0.052 for the
    production shell — ratio ~0.89; bounded here by 1.2x band).  Expected
    clipped fraction = expected_exit_fraction * clip bound; the buffer gets
    a further 3x margin.  Scenes where that margin exceeds 1/4 of the batch
    (e.g. the 4.9 cm shell of integratingSphereDetectorSweep.C:119 at
    reflectance 1, where ~1/3 of escapers clip) return None — at that
    clip rate the in-loop kernel is cheaper anyway.  Traced (non-concrete)
    scene parameters also return None: the static capacity cannot be
    bounded.
    """
    import math
    import numbers

    vals = (scene.theta_max_deg, scene.reflectance, scene.inner_radius,
            scene.outer_radius)
    if not all(isinstance(v, numbers.Number) for v in vals):
        return None
    from ..config import expected_exit_fraction

    alpha = math.radians(180.0 - float(scene.theta_max_deg))
    band = ((float(scene.outer_radius) - float(scene.inner_radius))
            / (float(scene.inner_radius) * math.sin(alpha)))
    # measured clip-given-escape / band ratio is 0.89 at the production
    # shell; band itself (ratio 1.0) plus the 2.5x margin below keeps a
    # ~2.8x cushion over the measurement while halving the continuation
    # width vs a blanket 1.2x/3x bound (the width is live cost: the
    # continuation traces every buffered lane)
    clip = min(1.0, band)
    cap_frac = 2.5 * clip * expected_exit_fraction(scene.theta_max_deg,
                                                   scene.reflectance)
    if cap_frac > 0.25:
        return None
    shift = 2
    while shift < 6 and 1.0 / (1 << (shift + 1)) >= cap_frac:
        shift += 1
    return shift


def _compact_gather(mask, vecs, ints, capacity: int, n: int,
                    group_capacity: int | None = None):
    """Compact the lanes where ``mask`` holds into a ``capacity``-sized
    buffer with ONE packed row gather.

    Separate per-field gathers are random-access device-memory reads (on
    an earlier build several times slower than gathering the same
    bytes as contiguous rows; not yet measured on the H100) — so the
    fields are stacked into an ``[n, k]`` matrix first (cheap sequential
    writes) and gathered as rows.  ``ints`` ride along as floats; exact while their
    values fit the mantissa (bounce counts <= 50,000 << 2^24).

    ``group_capacity``: when set (sparse masks — the rim-clip set), the
    index build runs the two-level grouped compaction, whose level-2 rank
    + scatter touch only ``group_capacity * 8`` candidate lanes instead of
    all ``n`` (core/compact.py).  Lanes dropped by a group-capacity
    overflow are counted in the returned ``n_dropped`` (0 in practice —
    callers fold it into their overflow counter).

    Returns ``(idx, valid, vec_outs, int_outs, n_dropped)`` — ``idx`` for
    the scatter-back, ``valid`` the real-lane mask.
    """
    from .compact import nonzero_indices, nonzero_indices_grouped

    if group_capacity is not None and n >= (1 << 16):
        idx, n_dropped = nonzero_indices_grouped(mask, capacity, n,
                                                 group_capacity)
    else:
        idx = nonzero_indices(mask, capacity, n)
        n_dropped = jnp.zeros((), jnp.int32)
    valid = idx < n
    safe = jnp.minimum(idx, n - 1)
    # pack in the position dtype, but never below f32: int fields must
    # survive the round-trip exactly (counts <= 50,000 << 2^24), which a
    # low-precision cfg.dtype like bf16 would break
    pdt = vecs[0].x.dtype
    pack_dt = pdt if jnp.finfo(pdt).nmant >= 23 else jnp.float32
    cols = []
    for v in vecs:
        cols += [v.x.astype(pack_dt), v.y.astype(pack_dt),
                 v.z.astype(pack_dt)]
    cols += [a.astype(pack_dt) for a in ints]
    rows = jnp.stack(cols, 1)[safe]
    out_vecs = [Vec3(rows[:, 3 * i].astype(pdt),
                     rows[:, 3 * i + 1].astype(pdt),
                     rows[:, 3 * i + 2].astype(pdt))
                for i in range(len(vecs))]
    base = 3 * len(vecs)
    out_ints = [rows[:, base + j].astype(jnp.int32)
                for j in range(len(ints))]
    return idx, valid, out_vecs, out_ints, n_dropped


def _rim_continuation_hybrid(key, scene, carry, cfg, radius, r_out, cos_tm,
                             INF, depth: int = 0):
    """Finish the deferred-rim continuation buffer with the closed-form
    sampler where the chain law allows it.

    1. 16 in-loop exact-rim iterations at full buffer width: gap lanes
       propagate (cone / re-entry / outward escape), early roulette deaths
       resolve.  After the prefix nearly every survivor is a plain interior
       lane.
    2. Interior survivors (wall point + fresh Lambertian direction, or a
       re-entry mid-flight — both exactly the ``trace_direct_from_state``
       initial state) are completed in closed form.
    3. The sampled escape segments are rim-clip-tested (recursive clips,
       ~4.6% of these exits); clipped survivors take their first rim bounce
       and join any still-in-gap lanes in an ``m >> 3`` tail buffer.  A
       LARGE tail recurses into this same hybrid (its state has exactly
       the input shape: post-rim-bounce + in-gap lanes) — bounded at two
       extra levels, each 8x smaller; small or depth-capped tails run the
       in-loop kernel to extinction.  Without the recursion the tail's
       while-loop dominated the rim overhead at large N (~85 ms of a
       ~290 ms total at 16M rays).

    Returns ``(pos, dir, prev, status, bounces, n_overflow)`` for the
    m-buffer, suspension already applied.
    """
    from .geometry import cone_crossing_t, cone_face_normal
    from .sampling import scatter as scatter_fn
    from .trace_direct import trace_direct_from_state

    dtype = cfg.dtype
    m = carry[0].x.shape[0]
    max_iters = int(scene.max_bounces)
    k_pre, k_fin, k_rim2, k_tail = jax.random.split(key, 4)

    prefix = min(16, max_iters)
    step = make_bounce_step(k_pre, scene, m, cfg)
    carry = jax.lax.fori_loop(0, prefix, step, carry)
    pos, direction, prev, status, bounces, in_gap = carry

    # ---- closed-form finish for interior survivors ----------------------
    run_int = (status == RUNNING) & ~in_gap
    fin = trace_direct_from_state(k_fin, scene, pos, direction, bounces, cfg)
    status_o = jnp.where(run_int, fin.status, status)
    pos_o = Vec3.where(run_int, fin.last_point, pos)
    prev_o = Vec3.where(run_int, fin.seg_start, prev)
    dir_o = Vec3.where(run_int, fin.direction, direction)
    bounces_o = jnp.where(run_int, fin.n_bounces, bounces)

    # ---- recursive rim clips on the sampled escapes ---------------------
    fin_exit = run_int & (fin.status == EXITED)
    q2 = sphere_hit(fin.seg_start, fin.direction, radius)
    s2 = cone_crossing_t(q2, fin.direction, cos_tm, radius, r_out, INF)
    clip2 = fin_exit & (s2 < INF)
    rim_pt2 = q2 + fin.direction.scale(s2)
    k_surv2, k_scat2 = jax.random.split(k_rim2)
    survive2 = (jax.random.uniform(k_surv2, (m,), dtype)
                < jnp.asarray(scene.reflectance, dtype))
    d2 = scatter_fn(k_scat2, scene.surface_model, fin.direction,
                    cone_face_normal(rim_pt2), scene)

    # clipped-and-killed lanes die at the rim face
    dead2 = clip2 & ~survive2
    status_o = jnp.where(dead2, ABSORBED, status_o)
    pos_o = Vec3.where(dead2, rim_pt2, pos_o)
    bounces_o = jnp.where(clip2, fin.n_bounces + 1, bounces_o)

    # ---- in-loop tail: clipped survivors + lanes still in the gap -------
    still_gap = (status == RUNNING) & in_gap
    cont = (clip2 & survive2) | still_gap
    t_pos = Vec3.where(clip2, rim_pt2, pos)
    t_dir = Vec3.where(clip2, d2, direction)
    t_prev = Vec3.where(clip2, fin.seg_start, prev)
    t_bounces = jnp.where(clip2, fin.n_bounces + 1, bounces)

    m2 = min(m, max(256, m >> 3))
    n_overflow2 = jnp.maximum(jnp.sum(cont, dtype=jnp.int32) - m2, 0)
    # flat compaction: cont is DENSE relative to this buffer (~m/8 of m),
    # so the grouped level-2 width would equal m — no win over flat
    idx2, valid2, (g_pos, g_dir, g_prev), (g_bounces,), _ = _compact_gather(
        cont, [t_pos, t_dir, t_prev], [t_bounces], m2, m)
    carry2 = (g_pos, g_dir, g_prev,
              jnp.where(valid2, RUNNING, ABSORBED).astype(jnp.int32),
              g_bounces, valid2)
    if depth < 2 and m2 >= HYBRID_RECURSE_MIN:
        (pos2, dir2, prev2, status2, bounces2,
         ovf3) = _rim_continuation_hybrid(k_tail, scene, carry2, cfg,
                                          radius, r_out, cos_tm, INF,
                                          depth + 1)
        n_overflow2 = n_overflow2 + ovf3
    else:
        step2 = make_bounce_step(k_tail, scene, m2, cfg)
        block = max(1, min(int(cfg.block_iters), max_iters))
        pos2, dir2, prev2, status2, bounces2, _ = _while_trace(
            step2, carry2, max_iters, block)
        status2 = jnp.where(status2 == RUNNING, SUSPENDED, status2)

    sidx2 = jnp.where(valid2, idx2, m)

    def sv(out: Vec3, new: Vec3) -> Vec3:
        return Vec3(out.x.at[sidx2].set(new.x, mode="drop"),
                    out.y.at[sidx2].set(new.y, mode="drop"),
                    out.z.at[sidx2].set(new.z, mode="drop"))

    status_f = status_o.at[sidx2].set(status2, mode="drop")
    # tail-overflow still-gap lanes (counted in n_overflow2) cannot finish:
    # suspend them, mirroring the optimistic-EXITED contract for clips
    status_f = jnp.where(status_f == RUNNING, SUSPENDED, status_f)
    return (sv(pos_o, pos2), sv(dir_o, dir2), sv(prev_o, prev2),
            status_f,
            bounces_o.at[sidx2].set(bounces2, mode="drop"),
            n_overflow2)


def trace_rays_rim_deferred(
    key: jax.Array,
    scene: SphereScene,
    source: Source,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
    capacity_shift: int = 4,
    main_tracer=None,
) -> tuple[TraceResult, jax.Array]:
    """Exact-rim physics at (nearly) simple-mode cost.

    The in-loop rim mode pays the cone solve + gap machinery on EVERY
    lane-iteration although only ~2% of rays ever clip the rim (~4.6% of
    escapers at port 170 deg, docs/PARITY.md).  Here rim physics runs once
    per RAY instead of once per lane-iteration:

    1. main trace with ``exact_rim=False`` (cheap kernel; the escape flight
       survives as the cached final segment, so its cap-crossing point is
       recoverable);
    2. O(N) post-pass: recompute the cap crossing ``q = sphere_hit(seg_start,
       dir)`` of exited lanes and clip-test the escape flight against the
       rim cone (the TGeoSphere theta-boundary face,
       ``fluxAtObserverOptimize.C:204``);
    3. clipped lanes are compacted into an ``n_rays >> capacity_shift``
       buffer; the first rim bounce (roulette + surface-model scatter about
       the rim-face normal) is applied manually, then the full in-loop rim
       kernel finishes the survivors — gap propagation, interior re-entry
       chains and recursive rim clips included;
    4. continuation results are scattered back over the clipped lanes.

    Returns ``(TraceResult, RimOverflow)``.  ``RimOverflow.total`` counts
    clipped rays beyond the buffer (left as optimistic EXITED); with the
    default 16x capacity vs the ~2-4% expectation it is zero for every
    reference scene — same scalar contract as the wave tracer's overflow
    (``int()`` works).  ``RimOverflow.grouped_drops`` isolates level-2
    group-capacity drops so the tighter grouped-compaction bound is
    distinguishable from clip-capacity excess when nonzero.

    The continuation's bounce budget restarts at ``scene.max_bounces``
    (a clipped ray can therefore exceed the cap by up to one extra budget);
    with the reference cap of 50,000 vs ~57 mean bounces this never binds.
    Distribution-equivalent to in-loop rim mode, stream-different (fresh
    keys for the continuation).  Requires ``cfg.keep_history == 0`` — the
    visual-demo path records rim bounces in-loop via ``trace_rays``.
    """
    from .geometry import cone_crossing_t, cone_face_normal
    from .sampling import scatter as scatter_fn

    if cfg.keep_history:
        raise ValueError("rim-deferred tracing has no history buffer; "
                         "use trace_rays for the visual-demo path")
    if int(scene.max_bounces) >= 1 << 24:
        # _compact_gather rides int fields through the pack dtype's f32
        # mantissa; bounce counts must stay exactly representable
        raise ValueError("max_bounces >= 2^24 would corrupt bounce counts "
                         "in the deferred-rim pack; use the in-loop rim "
                         "kernel (exact_rim=True on the simulate engines)")
    dtype = cfg.dtype
    k_main, k_first, k_cont = jax.random.split(key, 3)
    main = main_tracer if main_tracer is not None else trace_rays
    res = main(k_main, scene.with_(exact_rim=False), source, n_rays, cfg)

    radius = jnp.asarray(scene.inner_radius, dtype)
    r_out = jnp.asarray(scene.outer_radius, dtype)
    cos_tm = jnp.cos(jnp.deg2rad(jnp.asarray(scene.theta_max_deg, dtype)))
    INF = 1e30

    # clip-test every exited lane's escape flight against the rim cone
    q = sphere_hit(res.seg_start, res.direction, radius)
    s_rim = cone_crossing_t(q, res.direction, cos_tm, radius, r_out, INF)
    clipped = (res.status == EXITED) & (s_rim < INF)
    rim_pt = q + res.direction.scale(s_rim)

    m = min(n_rays, max(256, n_rays >> capacity_shift))
    n_overflow = jnp.maximum(jnp.sum(clipped, dtype=jnp.int32) - m, 0)
    # Two-level (grouped) compaction: the clip set is sparse (~2-4% of
    # rays), so level 2 ranks/scatters only 8 * (m/2) candidate lanes
    # instead of all n_rays.  Group capacity m/2 covers the expected clip
    # count with >= 1.25x cushion (capacity m itself carries a ~2.8x
    # cushion, and clips rarely share an 8-lane group at these densities);
    # a group-capacity overflow is counted and raises upstream like any
    # capacity overflow.
    idx, valid, (c_pt, c_dir, c_prev), (c_b,), dropped = _compact_gather(
        clipped, [rim_pt, res.direction, res.seg_start], [res.n_bounces],
        m, n_rays, group_capacity=max(256, m >> 1))
    n_overflow = n_overflow + dropped  # RimOverflow keeps dropped separate too
    c_bounces = c_b + valid.astype(jnp.int32)

    # first rim bounce (the in-loop kernel's rim branch, applied once):
    # roulette + the scene's surface model about the rim-face normal
    k_surv, k_scat = jax.random.split(k_first)
    survive = (jax.random.uniform(k_surv, (m,), dtype)
               < jnp.asarray(scene.reflectance, dtype))
    d_scat = scatter_fn(k_scat, scene.surface_model, c_dir,
                        cone_face_normal(c_pt), scene)
    status0 = jnp.where(valid & survive, RUNNING, ABSORBED).astype(jnp.int32)
    c_dir = Vec3.where(survive, d_scat, c_dir)
    in_gap0 = valid & survive

    carry = (c_pt, c_dir, c_prev, status0, c_bounces, in_gap0)
    max_iters = int(scene.max_bounces)

    from .trace_direct import direct_applicable

    if cfg.engine in ("auto", "direct") and direct_applicable(scene, cfg):
        # HYBRID continuation (statically-Lambertian scenes): a short
        # in-loop prefix resolves the gap dynamics, interior survivors are
        # finished in closed form (trace_direct_from_state — exact, see
        # trace_direct.py), their re-clipped escapes plus any lanes still
        # in the gap run the full in-loop kernel in a 8x-smaller tail.
        # Replaces a full-width while-loop-to-extinction whose cost
        # dominated the rim overhead.
        (pos, direction, prev, status, bounces,
         n_overflow2) = _rim_continuation_hybrid(
            k_cont, scene, carry, cfg, radius, r_out, cos_tm, INF)
        n_overflow = n_overflow + n_overflow2
    elif m >= _WAVES_CONTINUATION_MIN:
        # large continuations wave-compact their own tail: after the gap
        # resolves (a few iterations) only re-entrant lanes survive, and an
        # uncompacted while-loop would run the full bounce tail at width m
        # — at large N that tail costs more than the waves-accelerated main
        # trace it follows.  Schedule tuned for this buffer's occupancy:
        # only ~1/2.5 of the lanes are real clips (capacity margin), so a
        # short first wave + aggressive shrink compacts early; shrink 4
        # keeps >=1.6x headroom even for worst-case (small-port) survival.
        from .trace_waves import trace_waves_from_state

        res_c, cont_ovf = trace_waves_from_state(
            k_cont, scene, carry, cfg,
            wave_iters=RIM_CONT_WAVE_ITERS, shrink=RIM_CONT_SHRINK,
            min_wave=16384, first_wave_iters=RIM_CONT_FIRST_WAVE)
        pos, direction, prev = (res_c.last_point, res_c.direction,
                                res_c.seg_start)
        status, bounces = res_c.status, res_c.n_bounces
        # an undersized tuned schedule (RIM_CONT_FIRST_WAVE/RIM_CONT_SHRINK)
        # suspends live clipped lanes at a compaction; fold that loss into
        # RimOverflow.total so the existing int(ovf)==0 checks catch it
        # deterministically instead of as a silent exit-fraction bias
        # (ADVICE r4, medium)
        n_overflow = n_overflow + cont_ovf
    else:
        step = make_bounce_step(k_cont, scene, m, cfg)
        block = max(1, min(int(cfg.block_iters), max_iters))
        pos, direction, prev, status, bounces, _ = _while_trace(
            step, carry, max_iters, block)
        status = jnp.where(status == RUNNING, SUSPENDED, status)

    # scatter the continuation's outcome back over the clipped lanes
    sidx = jnp.where(valid, idx, n_rays)

    def sv(out: Vec3, new: Vec3) -> Vec3:
        return Vec3(out.x.at[sidx].set(new.x, mode="drop"),
                    out.y.at[sidx].set(new.y, mode="drop"),
                    out.z.at[sidx].set(new.z, mode="drop"))

    return TraceResult(
        status=res.status.at[sidx].set(status, mode="drop"),
        last_point=sv(res.last_point, pos),
        seg_start=sv(res.seg_start, prev),
        direction=sv(res.direction, direction),
        n_bounces=res.n_bounces.at[sidx].set(bounces, mode="drop"),
    ), RimOverflow(total=n_overflow, grouped_drops=dropped)


def exit_count(result: TraceResult, exit_port_z=-100.0) -> jax.Array:
    """Number of rays whose last point passed the port-z test — the flux
    counter of ``makeIntegratingSphereNRays.C:74-78,93``."""
    return jnp.sum(result.exited_port_mask(exit_port_z))
