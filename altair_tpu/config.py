"""Configuration dataclasses (registered as JAX pytrees).

The reference has no config system: every parameter is a file-scope ``const``
(``fluxAtObserverOptimize.C:35-41``) or a default-argument pack on the sweep
entry points (``fluxAtObserverOptimize.C:433-435``).  Here every reference
constant becomes a named field with the reference default, and the whole scene
is a pytree so parameter sweeps (port angle, source position, roughness,
...) can be ``vmap``-ed / sharded over a batch axis.

Numeric fields are *data* (traceable/vmappable); discrete choices (surface
model, max bounce count) are *metadata* (static, trigger recompilation when
changed — the XLA analogue of re-running ACLiC).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any

import jax
import jax.numpy as jnp

from .units import cm


class SurfaceModel(enum.IntEnum):
    """Wall scatter law of the integrating sphere.

    LAMBERTIAN      — ``ABorderSurfaceCondition::EnableLambertian(true)``
                      (``fluxAtObserver.C:155``): cosine-weighted re-emission
                      about the inward surface normal.  ``roughness`` is
                      ignored under this model (ROBAST behaviour, settled
                      against the roughness-0.75 corpus — docs/PARITY.md
                      §10); the field is kept for CSV-metadata parity.
    SPECULAR        — mirror reflection about the surface normal, with the
                      normal tilted by a Gaussian roughness angle (ROBAST
                      ``SetGaussianRoughness`` semantics,
                      ``fluxAtObserver.C:156``).
    MIXED_BRDF      — the ``BRDF`` class of ``nonLambertianFlux.C:147-208``:
                      with probability `specular_prob` a specular bounce whose
                      direction is perturbed by a Gaussian angular tilt of
                      sigma = roughness*pi/6, else cosine-weighted diffuse.
    COS_N_LOBE      — the archived ``NonLambertianSurface::Reflection``
                      (``nonLambertianFlux copy.C:187-220``): direction drawn
                      uniformly in theta on [0, max_angle] about the normal and
                      accepted with probability cos(theta)^n.
    """

    LAMBERTIAN = 0
    SPECULAR = 1
    MIXED_BRDF = 2
    COS_N_LOBE = 3


def _register(cls, data_fields, meta_fields):
    jax.tree_util.register_dataclass(cls, data_fields=data_fields, meta_fields=meta_fields)
    return cls


@dataclasses.dataclass(frozen=True)
class SphereScene:
    """The integrating-sphere scene.

    Mirrors ``setupOpticsManager`` (``fluxAtObserverOptimize.C:192-230``):
    spherical shell of inner radius `inner_radius`, polar range
    [0, `theta_max_deg`] (the missing cap around the -z axis is the exit
    port), wall reflectance `reflectance`, Gaussian surface roughness
    `roughness`, inside a world box of half-width `world_half`.

    Instead of a geometry engine + voxelization the intersections are closed
    form; `outer_radius` is carried for CSV-metadata parity only.
    """

    inner_radius: Any = 100.1 * cm     # fluxAtObserverOptimize.C:38
    outer_radius: Any = 101.0 * cm     # fluxAtObserverOptimize.C:39
    theta_max_deg: Any = 170.0         # fluxAtObserverOptimize.C:35
    reflectance: Any = 0.99            # fluxAtObserverOptimize.C:40
    roughness: Any = 0.01              # fluxAtObserverOptimize.C:41
    world_half: Any = 300.0 * cm       # fluxAtObserverOptimize.C:199
    exit_port_z: Any = -100.0 * cm     # fluxAtObserver.C:236 (exitPortZ)
    # MIXED_BRDF parameters (nonLambertianFlux.C:211  gBRDF(0.3, 0.4, 0.6)):
    specular_prob: Any = 0.4           # renormalised spec/(spec+diff) at use
    diffuse_prob: Any = 0.6
    brdf_roughness: Any = 0.3
    # COS_N_LOBE parameters (nonLambertianFlux copy.C:31-44):
    cos_n: Any = 2.0
    max_angle_deg: Any = 60.0
    # --- static metadata ---
    surface_model: SurfaceModel = SurfaceModel.LAMBERTIAN
    max_bounces: int = 50000           # MAX_REFLECTIONS, fluxAtObserverOptimize.C:36
    exact_rim: bool = True             # model the shell's conical rim face
                                       # (TGeoSphere theta-range boundary):
                                       # ~4.6% of escaping rays clip it and
                                       # reflect in ROBAST; required for
                                       # corpus-exact exit fractions

    @property
    def theta_max_rad(self):
        return self.theta_max_deg * math.pi / 180.0

    def with_(self, **kw) -> "SphereScene":
        return dataclasses.replace(self, **kw)


_register(
    SphereScene,
    data_fields=[
        "inner_radius", "outer_radius", "theta_max_deg", "reflectance",
        "roughness", "world_half", "exit_port_z", "specular_prob",
        "diffuse_prob", "brdf_roughness", "cos_n", "max_angle_deg",
    ],
    meta_fields=["surface_model", "max_bounces", "exact_rim"],
)


@dataclasses.dataclass(frozen=True)
class Source:
    """Point source with a fixed emission direction.

    All reference macros shoot every ray from one point with one direction
    (``fluxAtObserver.C:193-201``: pos (-60, 0, -80) cm, dir (5, 2, 0),
    660 nm; ``fluxAtObserverOptimize.C:433-435`` parameterises it).
    Direction need not be normalised (the reference passes raw (5,2,0)).
    """

    x: Any = -60.0 * cm
    y: Any = 0.0 * cm
    z: Any = -80.0 * cm
    dir_x: Any = 5.0
    dir_y: Any = 2.0
    dir_z: Any = 0.0
    wavelength_nm: Any = 660.0

    def with_(self, **kw) -> "Source":
        return dataclasses.replace(self, **kw)


_register(
    Source,
    data_fields=["x", "y", "z", "dir_x", "dir_y", "dir_z", "wavelength_nm"],
    meta_fields=[],
)


@dataclasses.dataclass(frozen=True)
class DetectorGrid:
    """The observer detector sweep grid.

    ``sweepDetector`` (``fluxAtObserverOptimize.C:459-461,542-555``):
    180 theta bins on [0, 90) deg x 90 phi bins on [0, 360) deg, detector
    centres at bin midpoints, placed `radius` from the port centre
    (0, 0, exit_port_z); square detector of `width` x `height` whose
    acceptance is a disk of radius width/2 (``fluxAtObserver.C:106``).
    """

    n_theta: int = 180
    n_phi: int = 90
    theta_lo: float = 0.0
    theta_hi: float = 90.0
    phi_lo: float = 0.0
    phi_hi: float = 360.0
    radius: float = 100.0 * cm        # fluxAtObserverOptimize.C:555
    width: float = 40.0 * cm          # fluxAtObserverOptimize.C:495
    height: float = 40.0 * cm

    @property
    def n_positions(self) -> int:
        return self.n_theta * self.n_phi

    def theta_centers(self):
        step = (self.theta_hi - self.theta_lo) / self.n_theta
        return self.theta_lo + (jnp.arange(self.n_theta, dtype=jnp.float32) + 0.5) * step

    def phi_centers(self):
        step = (self.phi_hi - self.phi_lo) / self.n_phi
        return self.phi_lo + (jnp.arange(self.n_phi, dtype=jnp.float32) + 0.5) * step


_register(DetectorGrid, data_fields=[], meta_fields=[
    "n_theta", "n_phi", "theta_lo", "theta_hi", "phi_lo", "phi_hi",
    "radius", "width", "height",
])


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Execution configuration of the trace kernel (all static).

    `max_bounces` on the scene caps the physical bounce count (the reference's
    ``SetLimit`` / suspend guard, ``fluxAtObserverOptimize.C:271-273``);
    `block_iters` controls how many bounce iterations run between alive-count
    checks of the ``while_loop`` (amortises the host-visible reduction).

    `engine` selects the trace engine used by ``trace_rays_auto``:

    * ``"auto"``   — closed-form direct sampling for statically-Lambertian
      scenes (distribution-exact, see ``core/trace_direct.py``), simulation
      kernels otherwise;
    * ``"simulate"`` — always simulate the bounce chain (the Pallas bounce
      kernel on the GPU backend, XLA while-loop/waves elsewhere);
    * ``"direct"`` — require the direct sampler (error if inapplicable).
    """

    dtype: Any = jnp.float32
    block_iters: int = 32
    rng_impl: str = "threefry2x32"   # threefry is the counter-based
                                     # reproducible default (used via
                                     # make_key()); "rbg" is the option
    keep_history: int = 0            # >0: record up to N path points (viz only)
    engine: str = "auto"             # "auto" | "simulate" | "direct"
    qmc: int = 0                     # 1: digitally-shifted Sobol draws in
                                     # the direct sampler; 2: Owen-scrambled
                                     # (better on discontinuous observables).
                                     # Better-than-1/sqrt(N) accuracy on
                                     # smooth observables — core/qmc.py


_register(TraceConfig, data_fields=[], meta_fields=[
    "dtype", "block_iters", "rng_impl", "keep_history", "engine", "qmc",
])


# Per-macro presets, so each reference entry point has a one-liner equivalent.
# fluxAtObserver.C:147-160 — reflectance defaults to 1.0 (no SetReflectance),
# roughness 0.5, limit 10000, world half 200 cm.
SCENE_V1 = SphereScene(reflectance=1.0, roughness=0.5, world_half=200.0 * cm,
                       max_bounces=10000)
# fluxAtObserverOptimize.C / fluxAtObserverFast.C production scene.
SCENE_OPTIMIZE = SphereScene()
# makeIntegratingSphere*.C / distributionSphereDetectorSweep.C demo scene.
SCENE_DEMO = SCENE_V1
# integratingSphereDetectorSweep.C:119 — outer radius 105 cm variant.
SCENE_INSPHERE = SphereScene(reflectance=1.0, roughness=0.5,
                             outer_radius=105.0 * cm,
                             world_half=200.0 * cm, max_bounces=10000)

def validate(scene: SphereScene, source: Source) -> None:
    """Fail-fast sanity checks the reference never did (it let TGeo produce
    silent nonsense for exterior sources / zero directions).

    Only callable with concrete (non-traced) values — call it at the driver
    layer, not inside jit.
    """
    import numbers

    def _concrete(v):
        return isinstance(v, numbers.Number)

    if all(_concrete(v) for v in (source.x, source.y, source.z,
                                  scene.inner_radius)):
        r2 = float(source.x) ** 2 + float(source.y) ** 2 + float(source.z) ** 2
        if r2 >= float(scene.inner_radius) ** 2:
            raise ValueError(
                f"source at radius {math.sqrt(r2):.2f} lies outside the "
                f"sphere (inner radius {float(scene.inner_radius)}); the "
                "trace kernel assumes an interior source")
    if all(_concrete(v) for v in (source.dir_x, source.dir_y, source.dir_z)):
        d2 = (float(source.dir_x) ** 2 + float(source.dir_y) ** 2
              + float(source.dir_z) ** 2)
        if d2 == 0.0:
            raise ValueError("source direction must be non-zero")
    if _concrete(scene.theta_max_deg) and not (
            90.0 < float(scene.theta_max_deg) < 180.0):
        raise ValueError(
            "theta_max_deg must be in (90, 180) — the port cap must be a "
            "proper cap around -z")
    if _concrete(scene.reflectance) and not (
            0.0 <= float(scene.reflectance) <= 1.0):
        raise ValueError("reflectance must be a probability")


def port_escape_probability(port_angle_deg) -> float:
    """Cap-area fraction of a port whose shell spans [0, port_angle]:
    p = (1 - cos(180 - port_angle)) / 2 — the per-bounce escape probability
    of a Lambertian sphere (uniform irradiance).  Shared by the analysis
    oracles, the compaction capacity bound and the wave-engine safety check.
    """
    return (1 - math.cos(math.radians(180 - float(port_angle_deg)))) / 2


def expected_exit_fraction(port_angle_deg, reflectance) -> float:
    """Closed-form exit fraction p/(p + 1 - rho) of the roulette random walk
    (no-rim model — a slight overestimate once the shell rim is modelled,
    which makes it a safe upper bound for capacity sizing)."""
    p = port_escape_probability(port_angle_deg)
    denom = p + (1 - float(reflectance))
    return 1.0 if denom <= 0 else p / denom


def make_key(seed: int, cfg: TraceConfig) -> "jax.Array":
    """Seed -> PRNG key honouring ``cfg.rng_impl`` (the sweep drivers route
    their seeds through this)."""
    return jax.random.key(seed, impl=cfg.rng_impl)


SOURCE_V1 = Source()                                   # (-60,0,-80), (5,2,0)
SOURCE_DEMO = Source(dir_y=0.0, wavelength_nm=400.0)   # (-60,0,-80), (5,0,0)
SOURCE_OVERNIGHT = Source(z=-75.0 * cm, dir_y=0.0)     # sweepSeries variants
