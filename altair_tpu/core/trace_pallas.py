"""Pallas bounce kernel for the GPU (Triton route) — the simulate tier's
hot loop.

The XLA tracers (core/trace.py, core/trace_waves.py) cannot keep loop state
on chip across ``lax.while_loop`` iterations: every bounce re-reads and
re-writes the ~12-array SoA ray state from device memory, draws threefry
bits in a separate pass, and every outer iteration pays a launch and a
predicate readback.  This kernel runs one ray per thread-lane from the
source to its death with the whole state in registers: a block of
``BLOCK`` rays is one Pallas program, the bounce loop is a
``lax.while_loop`` inside it, and the only device-memory traffic is the
final result store.

Blocks are independent and are scheduled onto the SMs as they free, so a
block's idle tail (its lanes wait for the block's longest walk) costs only
that block's SM slot, not the whole grid.  The loop checks "any lane
alive" once every ``CHECK_EVERY`` bounces (a block-wide int32 max), which
amortises the reduction and its barrier.

Random numbers come from an inline Threefry-2x32 (``_threefry2x32``/
``_sw_uniforms``): the key's two words as the cipher key and (lane, draw
counter) as the 64-bit counter, made of plain 32-bit integer ops, so the
same kernel code runs compiled on the card and in Pallas' generic
interpret mode on the CPU (the tests' path).  Streams differ from the XLA
tracers' (their counters are laid out differently); the physics is the
same law (SURVEY.md §7 on bit parity).

Supports all four static scatter laws — LAMBERTIAN, SPECULAR (roughened-
normal mirror), MIXED_BRDF and COS_N_LOBE (fixed-round masked rejection,
the archived macro's law).  Custom scatter callables run on the XLA
tracers.  Exact-rim physics composes as the deferred rim post-pass around
the kernel (``trace_rays_rim_deferred``), so the kernel itself stays
rim-free.  ``trace_rays_fast`` is the dispatch: the kernel on the GPU
backend, the XLA tracers everywhere else.  Outputs match ``TraceResult``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import SphereScene, Source, SurfaceModel, TraceConfig
from .geometry import Vec3
from .trace import ABSORBED, EXITED, RUNNING, SUSPENDED, TraceResult, trace_rays

# rays per Pallas program (one ray per thread-lane), warps per program and
# bounces between block-level all-dead checks.  Chosen on an H100 from
# 16M-ray sweeps (PERF.md, "Kernel decisions"): one-warp blocks have the
# shortest idle tail; 64- and 128-ray blocks ran 15-35% slower, 16-ray
# blocks idle half of each warp; the check interval moves < 5% over 4-32.
BLOCK = 32
NUM_WARPS = 1
CHECK_EVERY = 8

_INV24 = float(2.0 ** -24)

# Threefry-2x32 rotation schedule (Salmon et al. 2011, as in jax.random)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds: the counter-based block cipher behind
    ``jax.random``'s default PRNG, in plain uint32 add/xor/rotate ops.
    Key (k0, k1), counter (x0, x1) -> two independent uint32 words."""
    ks = (k0, k1, k0 ^ k1 ^ jnp.uint32(0x1BD11BDA))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << jnp.uint32(r)) | (x1 >> jnp.uint32(32 - r))
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + jnp.uint32(i + 1)
    return x0, x1


def _to_unit(h):
    """uint32 -> [0,1) f32, the top 24 bits as the mantissa.  After
    ``>> 8`` the value fits in 24 bits, so the int32 bitcast is
    value-preserving and the int32->f32 convert is exact."""
    return jax.lax.bitcast_convert_type(
        h >> jnp.uint32(8), jnp.int32).astype(jnp.float32) * _INV24


def _sw_uniforms(k0, k1, lane, it, n):
    """The ``n`` uniforms of bounce ``it`` of ray ``lane``.

    Each Threefry call takes the 64-bit counter (lane, it * calls + j)
    under the key's two words and gives two draws, so every (key, lane,
    bounce, draw) has its own counter: no two rays' streams overlap, and
    two keys give independent streams."""
    calls = -(-n // 2)
    base = it.astype(jnp.uint32) * jnp.uint32(calls)
    out = []
    for j in range(calls):
        out.extend(_threefry2x32(k0, k1, lane, base + jnp.uint32(j)))
    return [_to_unit(h) for h in out[:n]]


# fixed rejection rounds for the cos^n lobe (acceptance ~0.7 at the
# archived macro's (n=2, 60 deg): 12 rounds leave < 1e-6 unconverged —
# the XLA sampler (sampling.cos_n_lobe) uses the same first-accept scheme
_COS_N_ROUNDS = 12

# uniforms drawn per bounce (survive + the model's scatter draws)
_N_DRAWS = {
    SurfaceModel.LAMBERTIAN: 3,
    SurfaceModel.SPECULAR: 4,
    SurfaceModel.MIXED_BRDF: 7,
    SurfaceModel.COS_N_LOBE: 1 + 3 * _COS_N_ROUNDS,
}

_TWO_PI = 6.2831853071795864


def _from_local(ax, ay, az, st, ct, ph):
    """Unit direction at polar (st, ct), azimuth ph about unit axis
    (branchless Duff ONB — matches core.geometry/_from_local)."""
    f32 = jnp.float32
    sign = jnp.where(az >= 0, 1.0, -1.0).astype(f32)
    a = -1.0 / (sign + az)
    bb = ax * ay * a
    t1x = 1.0 + sign * ax * ax * a
    t1y = sign * bb
    t1z = -sign * ax
    t2x = bb
    t2y = sign + ay * ay * a
    t2z = -ay
    cp = jnp.cos(ph)
    sp = jnp.sin(ph)
    ox = st * (cp * t1x + sp * t2x) + ct * ax
    oy = st * (cp * t1y + sp * t2y) + ct * ay
    oz = st * (cp * t1z + sp * t2z) + ct * az
    inv = jax.lax.rsqrt(ox * ox + oy * oy + oz * oz)
    return ox * inv, oy * inv, oz * inv


def _gauss(ua, ub):
    """standard normal via Box-Muller (log(1-u) is safe: u < 1)."""
    return jnp.sqrt(-2.0 * jnp.log(1.0 - ua)) * jnp.cos(_TWO_PI * ub)


def _box_flight(mask, px, py, pz, dx, dy, dz, world_half):
    """Fly masked lanes from their current point to the world-box surface.

    Runs ONCE per ray in the kernel epilogue — the bounce loop stops
    escaped rays at the shell's cap crossing so the 3 divides here are not
    paid on every lane-bounce."""
    def axis_t(pc, dc):
        face = jnp.where(dc >= 0, world_half, -world_half)
        return jnp.where(dc == 0, jnp.inf, (face - pc) / dc)

    tb = jnp.minimum(axis_t(px, dx),
                     jnp.minimum(axis_t(py, dy), axis_t(pz, dz)))
    return (jnp.where(mask, px + dx * tb, px),
            jnp.where(mask, py + dy * tb, py),
            jnp.where(mask, pz + dz * tb, pz))


def _scatter_dir(model, m0, m1, draws, nx, ny, nz, dx, dy, dz):
    """The sampling.py scatter laws restated in plain vector ops.

    ``draws[0]`` is the survival roulette (consumed by the caller); the
    scatter consumes ``draws[1:]``.  ``(m0, m1)`` are the model's
    parameters (see ``_kernel_operands``).
    """
    f32 = jnp.float32
    if model == SurfaceModel.LAMBERTIAN:
        # cosine-weighted hemisphere about n  (sampling.cosine_hemisphere)
        u1, u2 = draws[1], draws[2]
        ct = jnp.sqrt(u1)
        st = jnp.sqrt(jnp.maximum(1.0 - u1, 0.0))
        return _from_local(nx, ny, nz, st, ct, _TWO_PI * u2)
    if model == SurfaceModel.SPECULAR:
        # mirror about a Gaussian-roughened normal, below-horizon flip
        # (sampling.specular_rough / rough_normal semantics)
        tilt = m0 * _gauss(draws[1], draws[2])
        nrx, nry, nrz = _from_local(nx, ny, nz, jnp.sin(tilt),
                                    jnp.cos(tilt), _TWO_PI * draws[3])
        dn = dx * nrx + dy * nry + dz * nrz
        ndx = dx - 2.0 * dn * nrx
        ndy = dy - 2.0 * dn * nry
        ndz = dz - 2.0 * dn * nrz
        below = ndx * nx + ndy * ny + ndz * nz
        flip = jnp.where(below < 0, 2.0 * below, 0.0)
        return ndx - flip * nx, ndy - flip * ny, ndz - flip * nz
    if model == SurfaceModel.MIXED_BRDF:
        # BRDF::SampleDirection (sampling.mixed_brdf): Bernoulli choice
        # of additively-tilted specular vs cosine diffuse
        p_spec, sigma_tilt = m0, m1
        ct = jnp.sqrt(draws[4])
        st = jnp.sqrt(jnp.maximum(1.0 - draws[4], 0.0))
        ddx, ddy, ddz = _from_local(nx, ny, nz, st, ct, _TWO_PI * draws[5])
        dn = dx * nx + dy * ny + dz * nz
        rx = dx - 2.0 * dn * nx
        ry = dy - 2.0 * dn * ny
        rz = dz - 2.0 * dn * nz
        theta = sigma_tilt * _gauss(draws[2], draws[3])
        sign = jnp.where(rz >= 0, 1.0, -1.0).astype(f32)
        a = -1.0 / (sign + rz)
        bb = rx * ry * a
        p1x = 1.0 + sign * rx * rx * a
        p1y = sign * bb
        p1z = -sign * rx
        p2x = bb
        p2y = sign + ry * ry * a
        p2z = -ry
        stt = jnp.sin(theta)
        phs = _TWO_PI * draws[6]
        cps = jnp.cos(phs)
        sps = jnp.sin(phs)
        sx = rx + stt * (cps * p1x + sps * p2x)
        sy = ry + stt * (cps * p1y + sps * p2y)
        sz = rz + stt * (cps * p1z + sps * p2z)
        inv = jax.lax.rsqrt(sx * sx + sy * sy + sz * sz)
        take_spec = draws[1] < p_spec
        return (jnp.where(take_spec, sx * inv, ddx),
                jnp.where(take_spec, sy * inv, ddy),
                jnp.where(take_spec, sz * inv, ddz))
    if model == SurfaceModel.COS_N_LOBE:
        # the archived macro's rejection sampler (nonLambertianFlux
        # copy.C:38-71 / sampling.cos_n_lobe): theta ~ U(0, max_angle)
        # (no sin-theta Jacobian), accept with |cos theta|^n; first
        # accepted proposal wins, stragglers take the last proposal.
        n_pow, max_ang = m0, m1
        theta = jnp.zeros_like(nx)
        phi = jnp.zeros_like(nx)
        accepted = jnp.zeros(nx.shape, jnp.bool_)
        for i in range(_COS_N_ROUNDS):
            th = max_ang * draws[1 + 3 * i]
            ph = _TWO_PI * draws[2 + 3 * i]
            ct = jnp.cos(th)
            p = jnp.exp(n_pow * jnp.log(jnp.maximum(jnp.abs(ct), 1e-30)))
            take = ~accepted
            theta = jnp.where(take, th, theta)
            phi = jnp.where(take, ph, phi)
            accepted = accepted | (take & (draws[3 + 3 * i] <= p))
        ox, oy, oz = _from_local(nx, ny, nz, jnp.sin(theta),
                                 jnp.cos(theta), phi)
        # hemisphere guard (copy.C:210-213): flip if below the surface
        below = ox * nx + oy * ny + oz * nz < 0
        sgn = jnp.where(below, -1.0, 1.0).astype(f32)
        return ox * sgn, oy * sgn, oz * sgn
    raise NotImplementedError(model)  # pragma: no cover


def _bounce_kernel(seed_ref, scene_ref, src_ref, status_ref,
                   lastx_ref, lasty_ref, lastz_ref, segx_ref, segy_ref,
                   segz_ref, dirx_ref, diry_ref, dirz_ref, bounces_ref,
                   *, model: SurfaceModel, block: int, check_every: int):
    """One block of ``block`` rays, full bounce loop.

    seed_ref (u32[2]): the key's two data words, the Threefry key.
    scene_ref (f32[8]): [inner_radius, cos_cap (= r*cos(theta_max)),
      reflectance, world_half, exit_port_z, max_bounces, m0, m1] where
      (m0, m1) are the static model's parameters (``_kernel_operands``).
    src_ref (f32[8]): [x, y, z, dx, dy, dz, 0, 0]  (dir normalised)
    """
    lane = (pl.program_id(0) * block
            + jax.lax.broadcasted_iota(jnp.int32, (block,), 0)
            ).astype(jnp.uint32)
    k0, k1 = seed_ref[0], seed_ref[1]

    radius = scene_ref[0]
    cos_cap = scene_ref[1]
    reflectance = scene_ref[2]
    world_half = scene_ref[3]
    max_bounces = scene_ref[5].astype(jnp.int32)
    m0 = scene_ref[6]
    m1 = scene_ref[7]
    inv_r = 1.0 / radius
    n_draws = _N_DRAWS[model]

    zf = jnp.zeros((block,), jnp.float32)
    px = src_ref[0] + zf
    py = src_ref[1] + zf
    pz = src_ref[2] + zf
    dx = src_ref[3] + zf
    dy = src_ref[4] + zf
    dz = src_ref[5] + zf
    zi = jnp.zeros((block,), jnp.int32)

    def bounce(it, carry):
        (status, px, py, pz, dx, dy, dz, prevx, prevy, prevz,
         bounces) = carry
        # `it < max_bounces` keeps the trailing partial check block from
        # overshooting the SetLimit bounce cap (same guard as trace.py)
        active = (status == RUNNING) & (it < max_bounces)

        # advance to the shell surface: t = -b + sqrt(b^2 - c)
        b = px * dx + py * dy + pz * dz
        c = px * px + py * py + pz * pz - radius * radius
        disc = jnp.maximum(b * b - c, 0.0)
        t = jnp.maximum(-b + jnp.sqrt(disc), 0.0)
        qx = px + dx * t
        qy = py + dy * t
        qz = pz + dz * t
        rn = radius * jax.lax.rsqrt(qx * qx + qy * qy + qz * qz)
        qx, qy, qz = qx * rn, qy * rn, qz * rn

        escaped = qz < cos_cap

        draws = _sw_uniforms(k0, k1, lane, it, n_draws)
        survive = draws[0] < reflectance

        # inward surface normal n = -q/r
        nx = -qx * inv_r
        ny = -qy * inv_r
        nz = -qz * inv_r
        ndx, ndy, ndz = _scatter_dir(model, m0, m1, draws,
                                     nx, ny, nz, dx, dy, dz)

        # escaped rays stop at the cap crossing q here; the flight to the
        # world box runs ONCE per ray in the epilogue
        new_status = jnp.where(
            escaped, EXITED, jnp.where(survive, RUNNING, ABSORBED)
        ).astype(jnp.int32)
        status = jnp.where(active, new_status, status)
        prevx = jnp.where(active, px, prevx)
        prevy = jnp.where(active, py, prevy)
        prevz = jnp.where(active, pz, prevz)
        px = jnp.where(active, qx, px)
        py = jnp.where(active, qy, py)
        pz = jnp.where(active, qz, pz)
        upd_dir = active & ~escaped & survive
        dx = jnp.where(upd_dir, ndx, dx)
        dy = jnp.where(upd_dir, ndy, dy)
        dz = jnp.where(upd_dir, ndz, dz)
        bounces = jnp.where(active & ~escaped, bounces + 1, bounces)
        return (status, px, py, pz, dx, dy, dz, prevx, prevy, prevz,
                bounces)

    def cond(state):
        it, carry = state
        alive = jnp.max(jnp.where(carry[0] == RUNNING, 1, 0))
        return (it < max_bounces) & (alive > 0)

    def body(state):
        it, carry = state
        carry = jax.lax.fori_loop(0, check_every,
                                  lambda j, c: bounce(it + j, c), carry)
        return it + check_every, carry

    init = (zi, px, py, pz, dx, dy, dz, px, py, pz, zi)
    _, (status, px, py, pz, dx, dy, dz, prevx, prevy, prevz,
        bounces) = jax.lax.while_loop(cond, body, (jnp.int32(0), init))

    # epilogue: exited lanes fly from the cap crossing to the world box
    px, py, pz = _box_flight(status == EXITED, px, py, pz, dx, dy, dz,
                             world_half)

    status_ref[...] = jnp.where(status == RUNNING, SUSPENDED, status)
    lastx_ref[...] = px
    lasty_ref[...] = py
    lastz_ref[...] = pz
    segx_ref[...] = prevx
    segy_ref[...] = prevy
    segz_ref[...] = prevz
    dirx_ref[...] = dx
    diry_ref[...] = dy
    dirz_ref[...] = dz
    bounces_ref[...] = bounces


def _model_supported(scene: SphereScene) -> bool:
    return (not callable(scene.surface_model)
            and SurfaceModel(scene.surface_model) in _N_DRAWS)


def _on_gpu() -> bool:
    return jax.default_backend() == "gpu"


def pallas_applicable(scene: SphereScene, cfg: TraceConfig) -> bool:
    """True when ``trace_rays_fast`` takes the kernel path (used by the
    engine dispatch in ``trace_rays_auto`` and ``parallel.mesh``)."""
    if not (_model_supported(scene) and _on_gpu()
            and int(cfg.keep_history) == 0 and cfg.dtype == jnp.float32):
        return False
    if scene.exact_rim:
        from .trace import rim_deferred_capacity_shift

        return rim_deferred_capacity_shift(scene) is not None
    return True


def trace_rays_pallas(
    key: jax.Array,
    scene: SphereScene,
    source: Source,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
    interpret: bool = False,
) -> TraceResult:
    """Raw kernel call.  ``n_rays`` must be a multiple of ``BLOCK``; use
    ``trace_rays_pallas_padded`` for any batch and ``trace_rays_fast`` for
    the dispatch with exact-rim composition (rim physics is applied as the
    deferred post-pass of ``trace_rays_rim_deferred``, so the kernel itself
    never needs the cone/gap machinery).

    ``interpret=True`` runs Pallas' generic interpreter (CPU tests); the
    dispatch never passes it.  Streams differ from the XLA tracers'
    (statistically equivalent; bit-parity between engines is impossible
    anyway, SURVEY.md §7 'hard parts').
    """
    block = BLOCK
    if n_rays <= 0 or n_rays % block:
        raise ValueError(
            f"n_rays ({n_rays}) must be a positive multiple of {block}")
    if not _model_supported(scene):
        raise NotImplementedError(
            "the kernel implements the four static scatter laws only")
    if scene.exact_rim:
        raise NotImplementedError(
            "the raw kernel traces simple-mode physics; exact-rim scenes go "
            "through trace_rays_fast (deferred rim post-pass)")

    seed, scene_vec, src_vec = _kernel_operands(key, scene, source)
    model = SurfaceModel(scene.surface_model)

    out_f32 = jax.ShapeDtypeStruct((n_rays,), jnp.float32)
    out_i32 = jax.ShapeDtypeStruct((n_rays,), jnp.int32)
    ray_spec = pl.BlockSpec((block,), lambda i: (i,))

    def whole(n):
        return pl.BlockSpec((n,), lambda i: (0,))

    outs = pl.pallas_call(
        partial(_bounce_kernel, model=model, block=block,
                check_every=CHECK_EVERY),
        out_shape=[out_i32] + [out_f32] * 9 + [out_i32],
        grid=(n_rays // block,),
        in_specs=[whole(2), whole(8), whole(8)],
        out_specs=[ray_spec] * 11,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="altair_bounce",
    )(seed, scene_vec, src_vec)

    (status, lastx, lasty, lastz, segx, segy, segz, dirx, diry, dirz,
     bounces) = outs
    return TraceResult(
        status=status,
        last_point=Vec3(lastx, lasty, lastz),
        seg_start=Vec3(segx, segy, segz),
        direction=Vec3(dirx, diry, dirz),
        n_bounces=bounces,
    )


def _kernel_operands(key, scene: SphereScene, source: Source):
    """(seed u32[2], scene_vec f32[8], src_vec f32[8]) kernel operands."""
    seed = jax.random.key_data(key).astype(jnp.uint32).ravel()[:2]
    theta_max = jnp.deg2rad(jnp.asarray(scene.theta_max_deg, jnp.float32))
    model = SurfaceModel(scene.surface_model)
    if model == SurfaceModel.SPECULAR:
        m0 = jnp.asarray(scene.roughness, jnp.float32)
        m1 = jnp.zeros((), jnp.float32)
    elif model == SurfaceModel.MIXED_BRDF:
        m0 = (jnp.asarray(scene.specular_prob, jnp.float32)
              / (jnp.asarray(scene.specular_prob, jnp.float32)
                 + jnp.asarray(scene.diffuse_prob, jnp.float32)))
        m1 = jnp.asarray(scene.brdf_roughness, jnp.float32) * (jnp.pi / 6.0)
    elif model == SurfaceModel.COS_N_LOBE:
        m0 = jnp.asarray(scene.cos_n, jnp.float32)
        m1 = jnp.deg2rad(jnp.asarray(scene.max_angle_deg, jnp.float32))
    else:
        m0 = jnp.zeros((), jnp.float32)
        m1 = jnp.zeros((), jnp.float32)
    scene_vec = jnp.stack([
        jnp.asarray(scene.inner_radius, jnp.float32),
        jnp.asarray(scene.inner_radius, jnp.float32) * jnp.cos(theta_max),
        jnp.asarray(scene.reflectance, jnp.float32),
        jnp.asarray(scene.world_half, jnp.float32),
        jnp.asarray(scene.exit_port_z, jnp.float32),
        jnp.asarray(float(scene.max_bounces), jnp.float32),
        m0, m1,
    ])
    dnorm = jnp.sqrt(
        jnp.asarray(source.dir_x, jnp.float32) ** 2
        + jnp.asarray(source.dir_y, jnp.float32) ** 2
        + jnp.asarray(source.dir_z, jnp.float32) ** 2)
    src_vec = jnp.stack([
        jnp.asarray(source.x, jnp.float32),
        jnp.asarray(source.y, jnp.float32),
        jnp.asarray(source.z, jnp.float32),
        jnp.asarray(source.dir_x, jnp.float32) / dnorm,
        jnp.asarray(source.dir_y, jnp.float32) / dnorm,
        jnp.asarray(source.dir_z, jnp.float32) / dnorm,
        jnp.zeros((), jnp.float32), jnp.zeros((), jnp.float32),
    ])
    return seed, scene_vec, src_vec


def trace_rays_pallas_padded(key, scene, source, n_rays, cfg=TraceConfig(),
                             interpret: bool = False) -> TraceResult:
    """Pad the batch up to a block multiple, trace, truncate."""
    padded = -(-n_rays // BLOCK) * BLOCK
    res = trace_rays_pallas(key, scene, source, padded, cfg,
                            interpret=interpret)
    if padded == n_rays:
        return res
    return jax.tree.map(lambda a: a[:n_rays], res)


def trace_rays_fast(
    key: jax.Array,
    scene: SphereScene,
    source: Source,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
) -> TraceResult:
    """Dispatch: the compiled kernel on the GPU backend for the four static
    scatter laws (padding the batch up to a block multiple and truncating
    the result), the XLA kernel otherwise.  Exact-rim scenes compose the
    kernel's main trace with the deferred rim post-pass — full rim physics
    without any in-kernel cone/gap support.  Never runs the interpreter."""
    if not pallas_applicable(scene.with_(exact_rim=False), cfg):
        return trace_rays(key, scene, source, n_rays, cfg)
    if scene.exact_rim:
        from .trace import rim_deferred_capacity_shift, trace_rays_rim_deferred

        shift = rim_deferred_capacity_shift(scene)
        if shift is None:
            # thick-rim / traced scene: the kernel has no in-loop rim path,
            # so the XLA rim kernel takes over
            return trace_rays(key, scene, source, n_rays, cfg)
        res, _ = trace_rays_rim_deferred(key, scene, source, n_rays, cfg,
                                         capacity_shift=shift,
                                         main_tracer=trace_rays_pallas_padded)
        return res
    return trace_rays_pallas_padded(key, scene, source, n_rays, cfg)
