"""Two-stage scatter-retrace pipeline — the *current* ``nonLambertianFlux.C``
methodology (``:235-304``), distinct from putting the BRDF inside the bounce
loop (the archived macro / ``SurfaceModel`` wall models):

  1. trace each ray through the Lambertian sphere to completion,
  2. take its END POINT, compute the sphere normal there as
     ``endpoint.Unit()`` (the macro's simplification — note: the OUTWARD
     normal, and applied wherever the ray died, ``:254-259``),
  3. sample ONE custom-BRDF scatter of the original source direction about
     that normal (``gBRDF.SampleDirection(normal, incidentDir)`` uses the
     ray's INITIAL direction as incident, ``:244-247,262``),
  4. re-trace the scattered ray from the endpoint,
  5. score exit/detector on the SCATTERED ray (``:294-297``).

Faithful quirks preserved: the outward ``endpoint.Unit()`` normal, the
initial-direction incident vector, and re-tracing from endpoints that may
lie outside the sphere (exited rays' box endpoints) — flagged via
``only_rescatter_absorbed`` to optionally restrict stage 2 to endpoints on
the shell (the physically-meaningful subset).
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..core.memo import memo_program
from ..config import DetectorGrid, SphereScene, Source, TraceConfig
from ..core.geometry import Vec3
from ..core.sampling import mixed_brdf
from ..core.score import fluxmap_trace_once
from ..core.trace import EXITED, RUNNING, TraceResult
from ..core.trace_waves import trace_rays_auto as trace_rays


def _retrace_from(key, scene, pos: Vec3, direction: Vec3, n_rays, cfg):
    """Continue rays from arbitrary interior/on-shell points — the second
    ``TraceNonSequential`` call of the macro.  Runs the shared bounce step
    (incl. exact-rim handling) with a custom initial state."""
    from ..core.geometry import ray_box_exit_t
    from ..core.trace import make_bounce_step

    dtype = cfg.dtype
    radius = jnp.asarray(scene.inner_radius, dtype)
    world_half = jnp.asarray(scene.world_half, dtype)

    # endpoints on/inside the shell re-trace; far-outside endpoints (e.g.
    # the world-box last points of already-exited rays) fly straight on.
    # The 0.5 cm tolerance keeps on-sphere wall endpoints (|p| == r up to
    # fp error) on the traceable side.
    traceable = pos.norm2() < (radius + 0.5) * (radius + 0.5)
    status0 = jnp.where(traceable, RUNNING, EXITED).astype(jnp.int32)

    # outside starts: propagate straight to the box
    t_box0 = ray_box_exit_t(pos, direction, world_half)
    box0 = pos + direction.scale(t_box0)
    prev0 = pos
    pos = Vec3.where(traceable, pos, box0)

    max_iters = int(scene.max_bounces)
    block = max(1, min(32, max_iters))
    step = make_bounce_step(key, scene, n_rays, cfg)

    def cond(state):
        it, carry = state
        return (it < max_iters) & jnp.any(carry[3] == RUNNING)

    def body(state):
        it, carry = state
        carry = jax.lax.fori_loop(0, block,
                                  lambda j, c: step(it + j, c), carry)
        return it + block, carry

    bounces0 = jnp.zeros((n_rays,), jnp.int32)
    in_gap0 = jnp.zeros((n_rays,), bool)
    _, (pos, direction, prev, status, bounces, _) = jax.lax.while_loop(
        cond, body, (0, (pos, direction, prev0, status0, bounces0, in_gap0)))
    status = jnp.where(status == RUNNING, 3, status)
    return TraceResult(status, pos, prev, direction, bounces)


def trace_scatter_retrace(
    key: jax.Array,
    scene: SphereScene,
    source: Source,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
    only_rescatter_absorbed: bool = False,
) -> TraceResult:
    """The full two-stage pipeline; returns the SCATTERED rays' TraceResult
    (what the macro scores)."""
    k1, k2, k3 = jax.random.split(key, 3)
    first = trace_rays(k1, scene, source, n_rays, cfg)

    endpoint = first.last_point
    normal = endpoint.normalized()           # endpoint.Unit()  (:259)
    # trace-safe (the source may be a tracer inside shard_map programs)
    sdx = jnp.asarray(source.dir_x, cfg.dtype)
    sdy = jnp.asarray(source.dir_y, cfg.dtype)
    sdz = jnp.asarray(source.dir_z, cfg.dtype)
    dnorm = jnp.sqrt(sdx * sdx + sdy * sdy + sdz * sdz)
    incident = Vec3(
        jnp.broadcast_to(sdx / dnorm, (n_rays,)),
        jnp.broadcast_to(sdy / dnorm, (n_rays,)),
        jnp.broadcast_to(sdz / dnorm, (n_rays,)),
    )
    new_dir = mixed_brdf(k2, incident, normal, scene.specular_prob,
                         scene.diffuse_prob, scene.brdf_roughness)

    if only_rescatter_absorbed:
        on_shell = jnp.abs(endpoint.norm() - scene.inner_radius) < 1.0
        new_dir = Vec3.where(on_shell, new_dir, first.direction)

    return _retrace_from(k3, scene, endpoint, new_dir, n_rays, cfg)


@dataclasses.dataclass
class ScatterRetraceSweep:
    fluxmap: np.ndarray
    n_rays: int
    wall_time_s: float


@memo_program
def _scatter_retrace_program(scene, source, n_rays, grid, cfg):
    @jax.jit
    def run(key):
        res = trace_scatter_retrace(key, scene, source, n_rays, cfg)
        return fluxmap_trace_once(res, grid, scene.exit_port_z)

    return run


def sweep_scatter_retrace(
    scene: SphereScene,
    source: Source,
    *,
    n_rays: int = 100_000,
    grid: DetectorGrid = DetectorGrid(n_theta=45, n_phi=20, width=10.0,
                                      height=10.0),
    seed: int = 0,
    cfg: TraceConfig = TraceConfig(),
    mesh=None,
) -> ScatterRetraceSweep:
    """``sweepDetector`` of nonLambertianFlux.C (``:307-387``): 45x20 grid,
    10x10 cm detector, 100k rays, scored on the scattered rays.  One
    trace+rescatter+score device call instead of re-tracing per position.

    ``mesh``: shard the ray axis over a device mesh
    (``parallel.sharded_scatter_retrace`` — both stages chip-local, one
    histogram psum)."""
    t0 = time.perf_counter()
    if mesh is not None:
        from ..parallel.mesh import sharded_scatter_retrace

        counts = np.asarray(sharded_scatter_retrace(
            mesh, jax.random.key(seed), scene, source, grid, n_rays, cfg))
    else:
        run = _scatter_retrace_program(scene, source, n_rays, grid, cfg)
        counts = np.asarray(run(jax.random.key(seed)))
    return ScatterRetraceSweep(counts / n_rays, n_rays,
                               time.perf_counter() - t0)
