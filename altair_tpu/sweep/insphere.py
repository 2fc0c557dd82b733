"""In-geometry detector-disk sweep — ``integratingSphereDetectorSweep.C``.

The reference rebuilds the TGeo geometry for every disk position and
re-traces 100k rays per position (``:31-105``), detecting hits by scanning
the ray node history for a node named "detector" (``:134-143``).  Because
the disk sits OUTSIDE the sphere (placed at r=200 cm from the origin,
``:145-172``) it cannot shadow the interior physics, so one traced batch
scored against every disk position is exactly equivalent — but the
per-position re-trace is also provided (``retrace=True``) for bit-faithful
methodology parity.

Output: ``detector_sweep3.txt`` dialect — ``Theta(deg)\\tPhi(deg)\\t
HitFraction`` rows over theta in [-thetaMax, thetaMax] (step dtheta) x
phi in {0, 180}.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SphereScene, Source, TraceConfig
from ..core.memo import memo_program
from ..core.score import hits_insphere_disk, insphere_disk_position
# engine dispatch: the disk lives outside the sphere, so ANY engine's
# final-segment contract feeds hits_insphere_disk (the corpus scene's
# thick shell keeps it on the in-loop rim kernel; thin-shell user scenes
# get the direct sampler / GPU bounce-kernel tiers)
from ..core.trace_waves import trace_rays_auto as trace_rays


@dataclasses.dataclass
class InsphereSweepResult:
    thetas: np.ndarray         # flattened sweep order (theta-major)
    phis: np.ndarray
    fractions: np.ndarray
    n_rays: int
    wall_time_s: float


@memo_program
def _insphere_retrace_program(scene, source, disk_radius, n_rays, cfg,
                              chunk, n_chunks, P):
    from ..core.geometry import Vec3
    from ..core.score import insphere_disk_hit_mask

    @jax.jit
    def all_chunks(key, Cd, Nd):
        def one(carry, i):
            k = jax.random.fold_in(key, i)
            res = trace_rays(k, scene, source, n_rays * chunk, cfg)
            owner = jnp.arange(n_rays * chunk) // n_rays
            c = jax.lax.dynamic_slice_in_dim(Cd, i * chunk, chunk)
            nn = jax.lax.dynamic_slice_in_dim(Nd, i * chunk, chunk)
            cen = Vec3(c[owner, 0], c[owner, 1], c[owner, 2])
            nrm = Vec3(nn[owner, 0], nn[owner, 1], nn[owner, 2])
            ok = insphere_disk_hit_mask(res, cen, nrm, disk_radius)
            return carry, jnp.sum(ok.reshape(chunk, n_rays), axis=1,
                                  dtype=jnp.int32)

        _, counts = jax.lax.scan(one, jnp.zeros((), jnp.int32),
                                 jnp.arange(n_chunks))
        return counts.reshape(-1)[:P]

    return all_chunks


@memo_program
def _insphere_once_program(scene, source, disk_radius, n_rays, cfg, n_pos):
    from ..core.geometry import Vec3

    @jax.jit
    def allpos(key, Cd, Nd):
        res = trace_rays(key, scene, source, n_rays, cfg)
        return jax.lax.map(
            lambda i: hits_insphere_disk(
                res, Vec3(Cd[i, 0], Cd[i, 1], Cd[i, 2]),
                Vec3(Nd[i, 0], Nd[i, 1], Nd[i, 2]), disk_radius),
            jnp.arange(n_pos))

    return allpos


def sweep_insphere_detector(
    scene: SphereScene,
    source: Source,
    *,
    disk_radius: float = 5.0,
    n_rays: int = 100_000,
    dtheta: float = 0.5,
    theta_max: float = 45.0,
    dphi: float = 180.0,
    placement_radius: float = 200.0,
    seed: int = 0,
    cfg: TraceConfig = TraceConfig(),
    retrace: bool = False,
    pos_chunk: int | None = None,
    save_path: str | None = "detector_sweep3.txt",
    aimed: bool = False,
    mesh=None,
) -> InsphereSweepResult:
    """Sweep the focal-surface disk over theta in [-theta_max, theta_max]
    (inclusive, like the reference's ``theta <= thetaMax`` loop) x
    phi in [0, 360) step dphi.  Defaults replicate
    ``integratingSphereDetectorSweep():119-129`` (100k rays, dtheta 0.5,
    theta 45, disk r=5 cm).  ``aimed``: use the aim-at-port disk normal
    instead of the reference's faithful (phi-independent, tilted) one —
    see ``insphere_disk_position``.  ``mesh``: a 1-D device mesh (from
    ``altair_tpu.parallel.make_mesh``) shards the ray axis over chips for
    BOTH methodologies (``parallel.sharded_insphere``); one ``psum``
    merges the per-chip counts.  ``pos_chunk``: disk positions batched
    per device call on the retrace paths (None = 8 single-chip, or the
    measured per-device default of ``sharded_insphere`` under a mesh);
    an explicit value is honored on both routes."""
    t0 = time.perf_counter()
    thetas = np.arange(-theta_max, theta_max + dtheta / 2, dtheta)
    phis = np.arange(0.0, 360.0, dphi)
    key = jax.random.key(seed)

    # disk centres/normals for all positions
    tt = np.repeat(thetas, len(phis))
    pp = np.tile(phis, len(thetas))
    centers, normals = insphere_disk_position(
        jnp.asarray(tt, jnp.float32), jnp.asarray(pp, jnp.float32),
        placement_radius, scene.exit_port_z, aimed=aimed)

    if mesh is not None:
        from ..parallel import sharded_insphere

        Cd = jnp.stack([centers.x, centers.y, centers.z], 1)
        Nd = jnp.stack([normals.x, normals.y, normals.z], 1)
        counts = sharded_insphere(mesh, key, scene, source, Cd, Nd,
                                  disk_radius, n_rays, cfg,
                                  retrace=retrace, pos_chunk=pos_chunk)
        frac = np.asarray(counts, np.float64) / n_rays
    elif retrace:
        # Fresh rays per position, BATCHED: ``pos_chunk`` disk positions
        # trace together per device call (rays partitioned chunk-wise among
        # positions, like core.score.fluxmap_retrace) instead of the
        # reference's one-geometry-rebuild-per-position loop
        # (integratingSphereDetectorSweep.C:31-105).  Positions are
        # statistically independent under the pseudorandom engines
        # (disjoint lanes, key folded per chunk); with cfg.qmc the direct
        # sampler gives every position in a chunk the same Sobol block, so
        # chunk-mates are stratified-correlated — means stay unbiased and
        # per-position errors only shrink, but they are not independent.
        P = len(tt)
        chunk = min(8 if pos_chunk is None else pos_chunk, P)
        n_chunks = -(-P // chunk)
        pad = n_chunks * chunk - P
        Cd = jnp.stack([centers.x, centers.y, centers.z], 1)
        Nd = jnp.stack([normals.x, normals.y, normals.z], 1)
        if pad:
            Cd = jnp.concatenate([Cd, jnp.zeros((pad, 3), Cd.dtype)])
            padn = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], Nd.dtype),
                            (pad, 1))
            Nd = jnp.concatenate([Nd, padn])
        all_chunks = _insphere_retrace_program(
            scene, source, float(disk_radius), n_rays, cfg, chunk,
            n_chunks, P)
        frac = np.asarray(all_chunks(key, Cd, Nd), np.float64) / n_rays
    else:
        Cd = jnp.stack([centers.x, centers.y, centers.z], 1)
        Nd = jnp.stack([normals.x, normals.y, normals.z], 1)
        allpos = _insphere_once_program(
            scene, source, float(disk_radius), n_rays, cfg, len(tt))
        frac = np.asarray(allpos(key, Cd, Nd)) / n_rays

    wall = time.perf_counter() - t0
    if save_path:
        with open(save_path, "w") as fh:
            fh.write("Theta(deg)\tPhi(deg)\tHitFraction\n")
            for th, ph_, fr in zip(tt, pp, frac):
                fh.write(f"{_fmt(th)}\t{_fmt(ph_)}\t{_fmt(fr)}\n")
    return InsphereSweepResult(tt, pp, frac, n_rays, wall)


def _fmt(v: float) -> str:
    """C++ default ostream float formatting (6 significant digits,
    trailing-zero free) used by the reference's ``outFile << theta``."""
    s = f"{v:.6g}"
    return s


def read_detector_sweep(path: str):
    """Parse the ``detector_sweep*.txt`` dialect back."""
    rows = []
    with open(path) as fh:
        header = fh.readline()
        assert "Theta" in header
        for line in fh:
            parts = line.split()
            if len(parts) >= 3:
                rows.append([float(p) for p in parts[:3]])
    a = np.asarray(rows)
    return a[:, 0], a[:, 1], a[:, 2]
