"""Scatter-law sampling (array-program replacement for ROBAST's border-surface
conditions and the macros' custom BRDFs).

Everything is a pure function of a counter-based key: ``jax.random`` threefry
keys folded per bounce replace the global-state ``gRandom`` / ``rand()`` of
the reference (``nonLambertianFlux.C:240``, ``nonLambertianFlux copy.C:49``),
making massively-parallel tracing reproducible.

Distributional notes (bit-level seed parity with TRandom is impossible;
parity is statistical — see tests/test_physics_parity.py):

* Lambertian: theta = acos(sqrt(u)) cosine-weighted about the inward normal —
  exactly the reference's diffuse sampler (``nonLambertianFlux.C:191-207``)
  and what ROBAST's ``EnableLambertian(true)`` does per bounce.  Gaussian
  roughness is IGNORED under Lambertian — settled empirically against the
  roughness-0.75 corpus (``results/detector_data_50000rays.csv``): the
  corpus profile equals the roughness-inert law, and every tilted-normal
  composition variant is quantitatively excluded (docs/PARITY.md §10,
  tests/test_corpus_roughness.py).
* Specular + Gaussian roughness: ROBAST ``SetGaussianRoughness(sigma)`` tilts
  the surface *normal* by a Gaussian angle before mirror reflection.
* Mixed BRDF: ``BRDF::SampleDirection`` (``nonLambertianFlux.C:162-169``) —
  Bernoulli(spec/(spec+diff)) choice of a *direction*-perturbed specular
  bounce (Gaussian tilt sigma = roughness*pi/6 applied additively, then
  renormalised — replicated exactly, including the additive-not-rotated
  construction at ``:187-188``) or cosine-weighted diffuse.
* cos^n lobe: the archived rejection sampler (``nonLambertianFlux
  copy.C:38-71``) proposes theta uniform on [0, max_angle] (no sin-theta
  Jacobian) and accepts with cos^n(theta); reproduced as a fixed-round masked
  rejection loop (vectorised, static trip count) with identical density.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .geometry import Vec3, orthonormal_basis

TWO_PI = 6.283185307179586


def _from_local(normal: Vec3, sin_t, cos_t, phi) -> Vec3:
    """Direction at polar angle (sin_t, cos_t) and azimuth phi about normal."""
    u, v = orthonormal_basis(normal)
    sp = jnp.sin(phi)
    cp = jnp.cos(phi)
    return (
        u.scale(sin_t * cp) + v.scale(sin_t * sp) + normal.scale(cos_t)
    ).normalized()


def cosine_hemisphere(key, normal: Vec3) -> Vec3:
    """Cosine-weighted hemisphere about ``normal``.

    theta = acos(sqrt(u1)) => pdf(theta) ∝ cos(theta) sin(theta); matches
    ``BRDF::SampleDiffuse`` (``nonLambertianFlux.C:191-207``) and ROBAST's
    Lambertian re-emission.
    """
    k1, k2 = jax.random.split(key)
    shape = normal.x.shape
    u1 = jax.random.uniform(k1, shape, normal.x.dtype)
    u2 = jax.random.uniform(k2, shape, normal.x.dtype)
    cos_t = jnp.sqrt(u1)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - u1, 0.0))
    return _from_local(normal, sin_t, cos_t, TWO_PI * u2)


def specular_reflect(incident: Vec3, normal: Vec3) -> Vec3:
    """Mirror reflection  r = d - 2 (d.n) n  (``nonLambertianFlux.C:174``)."""
    return incident - normal.scale(2.0 * incident.dot(normal))


def gaussian_tilt(key, direction: Vec3, sigma) -> Vec3:
    """Additively perturb a unit ``direction`` by a Gaussian angular tilt.

    Exactly the construction of ``BRDF::SampleSpecular``
    (``nonLambertianFlux.C:178-188``): theta ~ N(0, sigma), phi ~ U(0, 2pi),
    result = direction + sin(theta) (cos(phi) p1 + sin(phi) p2), renormalised.
    (Note: additive, not a rotation — |result| < 1 before renormalisation;
    replicated for parity.)
    """
    k1, k2 = jax.random.split(key)
    shape = direction.x.shape
    theta = sigma * jax.random.normal(k1, shape, direction.x.dtype)
    phi = TWO_PI * jax.random.uniform(k2, shape, direction.x.dtype)
    p1, p2 = orthonormal_basis(direction)
    st = jnp.sin(theta)
    out = direction + p1.scale(st * jnp.cos(phi)) + p2.scale(st * jnp.sin(phi))
    return out.normalized()


def rough_normal(key, normal: Vec3, sigma) -> Vec3:
    """ROBAST ``SetGaussianRoughness``: tilt the surface normal by a Gaussian
    angle of std ``sigma`` (radians) at uniform azimuth before reflecting."""
    k1, k2 = jax.random.split(key)
    shape = normal.x.shape
    theta = sigma * jax.random.normal(k1, shape, normal.x.dtype)
    phi = TWO_PI * jax.random.uniform(k2, shape, normal.x.dtype)
    return _from_local(normal, jnp.sin(theta), jnp.cos(theta), phi)


def specular_rough(key, incident: Vec3, normal: Vec3, sigma) -> Vec3:
    """Specular bounce about a Gaussian-roughened normal; the result is
    flipped back into the inward hemisphere if the tilt drove it below the
    horizon (ROBAST redraws; a flip is the branch-free equivalent with the
    same support and near-identical density for the small sigmas used)."""
    n_r = rough_normal(key, normal, sigma)
    out = specular_reflect(incident, n_r)
    below = out.dot(normal) < 0
    return Vec3.where(below, out - normal.scale(2.0 * out.dot(normal)), out)


def mixed_brdf(key, incident: Vec3, normal: Vec3, specular_prob, diffuse_prob,
               roughness) -> Vec3:
    """``BRDF::SampleDirection`` (``nonLambertianFlux.C:162-169``).

    The constructor renormalises spec/diff to sum to 1
    (``nonLambertianFlux.C:155-158``); the Gaussian tilt sigma is
    roughness * pi/6 (max ~30 deg at roughness 1, ``:178``).
    """
    k_sel, k_spec, k_diff = jax.random.split(key, 3)
    p_spec = specular_prob / (specular_prob + diffuse_prob)
    shape = normal.x.shape
    take_spec = jax.random.uniform(k_sel, shape, normal.x.dtype) < p_spec
    spec = gaussian_tilt(k_spec, specular_reflect(incident, normal),
                         roughness * (jnp.pi / 6.0))
    diff = cosine_hemisphere(k_diff, normal)
    return Vec3.where(take_spec, spec, diff)


def cos_n_lobe(key, normal: Vec3, n, max_angle_rad, rounds: int = 16) -> Vec3:
    """Rejection-sampled cos^n lobe about ``normal``.

    Same target density as ``generateScatteredDirection``
    (``nonLambertianFlux copy.C:38-71``): proposal theta ~ U(0, max_angle)
    (linear in theta — no solid-angle weighting), phi ~ U(0, 2pi), accept with
    probability |cos theta|^n.  The C++ loops until acceptance; here a fixed
    ``rounds`` masked loop keeps shapes static.  Acceptance per round is
    ~0.7 for (n=2, 60 deg), so 16 rounds leave < 1e-8 unconverged lanes; those
    fall back to the last proposal (distributional error is negligible).
    """
    shape = normal.x.shape
    dt = normal.x.dtype

    def body(i, carry):
        theta_acc, phi_acc, accepted = carry
        ki = jax.random.fold_in(key, i)
        k1, k2, k3 = jax.random.split(ki, 3)
        theta = max_angle_rad * jax.random.uniform(k1, shape, dt)
        phi = TWO_PI * jax.random.uniform(k2, shape, dt)
        p = jnp.abs(jnp.cos(theta)) ** n
        ok = jax.random.uniform(k3, shape, dt) <= p
        take = ~accepted  # first proposal wins; later rounds fill stragglers
        theta_acc = jnp.where(take, theta, theta_acc)
        phi_acc = jnp.where(take, phi, phi_acc)
        return theta_acc, phi_acc, accepted | (take & ok)

    # Seed with a round-0 proposal marked unaccepted.
    init = (jnp.zeros(shape, dt), jnp.zeros(shape, dt),
            jnp.zeros(shape, bool))
    theta, phi, _ = jax.lax.fori_loop(0, rounds, body, init)
    out = _from_local(normal, jnp.sin(theta), jnp.cos(theta), phi)
    # Hemisphere guard (copy.C:210-213): flip if below the surface.
    below = out.dot(normal) < 0
    return Vec3.where(below, -out, out)


def scatter(key, model, incident: Vec3, normal: Vec3, scene) -> Vec3:
    """Dispatch on the (static) surface model.

    ``model`` is a Python-level ``SurfaceModel`` so each scene compiles a
    specialised kernel (the reference's per-macro ACLiC builds); a custom
    callable with signature ``(key, incident, normal, scene) -> Vec3`` may be
    passed instead — the archived macro's user-overridable ``Reflection()``
    hook (``nonLambertianFlux copy.C:187-220``) as a pure function.
    """
    from ..config import SurfaceModel  # local import to avoid cycle

    if callable(model) and not isinstance(model, SurfaceModel):
        return model(key, incident, normal, scene)
    model = SurfaceModel(model)
    if model == SurfaceModel.LAMBERTIAN:
        return cosine_hemisphere(key, normal)
    if model == SurfaceModel.SPECULAR:
        return specular_rough(key, incident, normal, scene.roughness)
    if model == SurfaceModel.MIXED_BRDF:
        return mixed_brdf(key, incident, normal, scene.specular_prob,
                          scene.diffuse_prob, scene.brdf_roughness)
    if model == SurfaceModel.COS_N_LOBE:
        return cos_n_lobe(key, normal, scene.cos_n,
                          jnp.deg2rad(scene.max_angle_deg))
    raise ValueError(f"unknown surface model: {model}")
