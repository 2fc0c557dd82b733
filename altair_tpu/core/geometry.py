"""Analytic geometry primitives (array-program replacement for TGeo/ROBAST
navigation).

The reference delegates geometry to ROOT's TGeo engine (``TGeoSphere`` shell +
``TGeoBBox`` world + voxelised next-boundary search,
``fluxAtObserverOptimize.C:199-223``).  The scene is just one sphere shell
with a polar-cap port inside a box, so closed-form intersections replace the
navigator entirely — no BVH, no voxelization.

Layout: vectors are structure-of-arrays (``Vec3`` = three ``[N]`` component
arrays) so the ray batch axis is the contiguous, vectorised axis: three flat
``[N]`` arrays load and store coalesced, where an ``[N, 3]`` layout would
stride every component access.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Vec3(NamedTuple):
    """Structure-of-arrays 3-vector batch: three same-shaped arrays."""

    x: jax.Array
    y: jax.Array
    z: jax.Array

    # -- algebra ----------------------------------------------------------
    def __add__(self, o):
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    def scale(self, s):
        return Vec3(self.x * s, self.y * s, self.z * s)

    def dot(self, o):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o):
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def norm2(self):
        return self.dot(self)

    def norm(self):
        return jnp.sqrt(self.norm2())

    def normalized(self, eps: float = 0.0):
        inv = jax.lax.rsqrt(self.norm2() + eps)
        return self.scale(inv)

    @staticmethod
    def where(mask, a: "Vec3", b: "Vec3") -> "Vec3":
        return Vec3(
            jnp.where(mask, a.x, b.x),
            jnp.where(mask, a.y, b.y),
            jnp.where(mask, a.z, b.z),
        )

    @staticmethod
    def full(shape, xyz, dtype=jnp.float32) -> "Vec3":
        return Vec3(
            jnp.full(shape, xyz[0], dtype),
            jnp.full(shape, xyz[1], dtype),
            jnp.full(shape, xyz[2], dtype),
        )

    def astype(self, dtype):
        return Vec3(self.x.astype(dtype), self.y.astype(dtype), self.z.astype(dtype))

    def stack(self):
        """Materialise as a dense ``[..., 3]`` array (API boundary only)."""
        return jnp.stack([self.x, self.y, self.z], axis=-1)

    @staticmethod
    def from_dense(a) -> "Vec3":
        a = jnp.asarray(a)
        return Vec3(a[..., 0], a[..., 1], a[..., 2])


def orthonormal_basis(n: Vec3) -> tuple[Vec3, Vec3]:
    """Branchless orthonormal basis about unit vector ``n`` (Duff et al. 2017).

    Replaces ``TVector3::Orthogonal`` + ``Cross`` used by the reference's
    samplers (``nonLambertianFlux.C:185-186,196-197``).  Any fixed convention
    yields the same scatter *distribution* because the azimuth is uniform.
    """
    sign = jnp.where(n.z >= 0, 1.0, -1.0).astype(n.z.dtype)
    a = -1.0 / (sign + n.z)
    b = n.x * n.y * a
    u = Vec3(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x)
    v = Vec3(b, sign + n.y * n.y * a, -n.y)
    return u, v


def ray_sphere_exit_t(p: Vec3, d: Vec3, radius) -> jax.Array:
    """Distance along unit direction ``d`` from interior point ``p`` to the
    sphere ``|q| = radius``.

    Replaces the TGeo next-boundary search for the only surface in the scene
    (the inner shell surface at 100.1 cm, ``fluxAtObserverOptimize.C:204``).
    ``p`` strictly inside (or on, heading inward) guarantees one non-negative
    root: t = -b + sqrt(b^2 - c) with b = p.d, c = |p|^2 - r^2.
    """
    b = p.dot(d)
    c = p.norm2() - radius * radius
    disc = jnp.maximum(b * b - c, 0.0)
    return jnp.maximum(-b + jnp.sqrt(disc), 0.0)


def sphere_hit(p: Vec3, d: Vec3, radius) -> Vec3:
    """Hit point on the sphere, re-projected onto the exact radius.

    The re-projection caps fp32 drift over long bounce chains (up to 50 000
    bounces, ``fluxAtObserverOptimize.C:36``): after every bounce the point is
    snapped back to ``|q| = radius`` so error cannot accumulate.
    """
    t = ray_sphere_exit_t(p, d, radius)
    q = p + d.scale(t)
    return q.scale(radius * jax.lax.rsqrt(q.norm2()))


def in_port_cap(q: Vec3, radius, theta_max_rad) -> jax.Array:
    """True where sphere point ``q`` lies in the missing polar cap (the exit
    port): polar angle from +z beyond ``theta_max``.

    Matches the ``TGeoSphere("...", r0, r1, 0., thetaMax)`` port definition
    (``fluxAtObserverOptimize.C:204``): the shell exists for theta in
    [0, thetaMax]; the cap (thetaMax, 180] around -z is open.
    Implemented as z < r*cos(theta_max) — no acos needed.
    """
    return q.z < radius * jnp.cos(theta_max_rad)


def ray_box_exit_t(p: Vec3, d: Vec3, half) -> jax.Array:
    """Distance from interior point ``p`` along unit ``d`` to the world box
    surface (axis-aligned, half-width ``half``; ``fluxAtObserver.C:149``).

    A ray leaving through the port flies to the box; its end point there is
    the reference's ``GetLastPoint`` used by the exit test
    (``fluxAtObserver.C:162-166``).
    """

    def axis_t(pc, dc):
        # target face is +half where d>0, -half where d<0; d==0 -> +inf
        face = jnp.where(dc >= 0, half, -half)
        return jnp.where(dc == 0, jnp.inf, (face - pc) / dc)

    return jnp.minimum(
        axis_t(p.x, d.x), jnp.minimum(axis_t(p.y, d.y), axis_t(p.z, d.z))
    )


def cone_crossing_t(p: Vec3, d: Vec3, cos_theta_max, r_lo, r_hi,
                    inf: float = 1e30) -> jax.Array:
    """Smallest positive crossing of the port-rim cone (polar angle ==
    theta_max, z < 0 nappe) with radius within [r_lo, r_hi]; ``inf`` where
    none.

    The TGeoSphere shell's annular rim face (``fluxAtObserverOptimize.C:204``
    theta range) — escaping rays clipping it reflect in ROBAST.  Cone:
    z^2 = cos^2(theta_max) |q|^2 on the z<0 branch.
    """
    c2 = cos_theta_max * cos_theta_max
    dd = d.dot(d)
    A = d.z * d.z - c2 * dd
    B = 2.0 * (p.z * d.z - c2 * p.dot(d))
    C = p.z * p.z - c2 * p.norm2()
    safe_A = jnp.where(jnp.abs(A) < 1e-20, 1.0, A)
    disc = B * B - 4.0 * A * C
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    s_lin = jnp.where(jnp.abs(B) > 0, -C / jnp.where(B == 0, 1.0, B), inf)
    roots = [
        jnp.where(jnp.abs(A) < 1e-20, s_lin, (-B - sq) / (2.0 * safe_A)),
        jnp.where(jnp.abs(A) < 1e-20, inf, (-B + sq) / (2.0 * safe_A)),
    ]
    best = jnp.full_like(p.x, inf)
    for s in roots:
        q = p + d.scale(s)
        r = q.norm()
        ok = ((s > 1e-6) & (disc >= 0) & (q.z < 0)
              & (r >= r_lo - 1e-6) & (r <= r_hi + 1e-6))
        best = jnp.where(ok & (s < best), s, best)
    return best


def cone_face_normal(p: Vec3) -> Vec3:
    """Unit normal of the rim cone face pointing into the hole side
    (theta_hat, the increasing-polar-angle direction)."""
    r = p.norm()
    rho = jnp.sqrt(p.x * p.x + p.y * p.y)
    safe_rho = jnp.where(rho < 1e-12, 1.0, rho)
    nx = p.z / r * p.x / safe_rho
    ny = p.z / r * p.y / safe_rho
    nz = -rho / r
    # degenerate apex (rho ~ 0) cannot occur on the rim band; guard anyway
    return Vec3(jnp.where(rho < 1e-12, 1.0, nx),
                jnp.where(rho < 1e-12, 0.0, ny),
                jnp.where(rho < 1e-12, 0.0, nz))


def sphere_crossing_t(p: Vec3, d: Vec3, radius, inf: float = 1e30):
    """Smallest positive crossing of ``|q| = radius`` from anywhere (inside
    or outside); ``inf`` where none."""
    b = p.dot(d)
    c = p.norm2() - radius * radius
    disc = b * b - c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    s1 = -b - sq
    s2 = -b + sq
    out = jnp.where((disc >= 0) & (s1 > 1e-6), s1,
                    jnp.where((disc >= 0) & (s2 > 1e-6), s2, inf))
    return out


# ---------------------------------------------------------------------------
# Observer detector placement & disk test  (Detector struct,
# fluxAtObserver.C:31-107)
# ---------------------------------------------------------------------------

def detector_position(theta_deg, phi_deg, radius, exit_port_z=-100.0):
    """Detector centre + plane normal for spherical placement about the port.

    Faithful port of ``Detector::setPosition`` (``fluxAtObserver.C:49-68``),
    including its normal convention: with dvec = centre - port_centre, the
    stored normal is (-dvec.y, dvec.x, dvec.z)/|dvec| — i.e. the x/y
    components are swapped and sign-flipped rather than negated.  This is NOT
    the aim-at-port direction, but it is what generated every flux map in the
    reference corpus, so parity requires reproducing it exactly (the plane
    through the detector centre differs from the aimed one).  Use
    ``detector_position_aimed`` for the physically-aimed variant.

    Returns ``(center: Vec3, normal: Vec3)`` broadcast over the inputs.
    """
    th = jnp.deg2rad(theta_deg)
    ph = jnp.deg2rad(phi_deg)
    cx = radius * jnp.sin(th) * jnp.cos(ph)
    cy = radius * jnp.sin(th) * jnp.sin(ph)
    cz = exit_port_z - radius * jnp.cos(th)
    dx, dy, dz = cx, cy, cz - exit_port_z
    mag = jnp.sqrt(dx * dx + dy * dy + dz * dz)
    normal = Vec3(-dy / mag, dx / mag, dz / mag)   # fluxAtObserver.C:65-67
    return Vec3(cx, cy, cz), normal


def detector_position_aimed(theta_deg, phi_deg, radius, exit_port_z=-100.0):
    """Spherical placement with the normal actually aimed at the port centre
    (what ``setPosition``'s comment *says* it does)."""
    th = jnp.deg2rad(theta_deg)
    ph = jnp.deg2rad(phi_deg)
    cx = radius * jnp.sin(th) * jnp.cos(ph)
    cy = radius * jnp.sin(th) * jnp.sin(ph)
    cz = exit_port_z - radius * jnp.cos(th)
    dx, dy, dz = cx, cy, cz - exit_port_z
    mag = jnp.sqrt(dx * dx + dy * dy + dz * dz)
    return Vec3(cx, cy, cz), Vec3(-dx / mag, -dy / mag, -dz / mag)


def line_hits_disk(point: Vec3, direction: Vec3, center: Vec3, normal: Vec3,
                   disk_radius, parallel_eps: float = 1e-10) -> jax.Array:
    """The ``Detector::checkIntersection`` test (``fluxAtObserver.C:70-107``).

    Intersect the *infinite line* through ``point`` with direction
    ``direction`` (the reference never checks t >= 0) with the detector plane,
    then test the in-plane distance of the intersection from the centre
    against ``disk_radius`` (= width/2).  Rays parallel to the plane
    (|d.n| < 1e-10) never hit.
    """
    dot = direction.dot(normal)
    rel = point - center
    t = -rel.dot(normal) / jnp.where(dot == 0, 1.0, dot)
    hit_pt = point + direction.scale(t)
    r = hit_pt - center
    # |n x r|^2 == in-plane distance^2 (r lies in the plane)  C:100-104
    perp = normal.cross(r)
    r2 = perp.norm2()
    return (jnp.abs(dot) >= parallel_eps) & (r2 <= disk_radius * disk_radius)
