"""Detector readout — the array-program replacement for the reference's
scoring loops.

The reference's fast path caches every exiting ray's final segment and tests
16,200 detector positions against them in a scalar C++ double loop
(``fluxAtObserverFast.C:1269-1341``, ~10^9 plane/disk tests, 104-2191 s).
Here the same test is a few small-K matmuls plus a fused elementwise mask —
the whole sweep collapses to one device program, chunked over positions to
bound the ``[N, P_chunk]`` working set.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import DetectorGrid, SphereScene, Source, SurfaceModel, TraceConfig
from .geometry import Vec3, detector_position, line_hits_disk
from .trace import EXITED, TraceResult
from .trace_waves import trace_rays_auto as trace_rays

PARALLEL_EPS = 1e-10  # fluxAtObserver.C:78


def grid_centers_normals(grid: DetectorGrid, exit_port_z=-100.0):
    """All P = n_theta*n_phi detector centres/normals as ``[P, 3]`` arrays,
    theta-major like the reference's sweep loops
    (``fluxAtObserverOptimize.C:542-555``)."""
    th = grid.theta_centers()
    ph = grid.phi_centers()
    th2 = jnp.repeat(th, grid.n_phi)
    ph2 = jnp.tile(ph, (grid.n_theta,))
    c, n = detector_position(th2, ph2, grid.radius, exit_port_z)
    return c.stack(), n.stack()


def _hits_block(E, D, rowmask, C, Nrm, half_w):
    """Hit counts of every (ray, position) pair for one position block.

    E, D: ``[N, 3]`` exit points / directions;  rowmask: ``[N]`` bool;
    C, Nrm: ``[P, 3]`` centres / normals.  Returns ``[P]`` int32 counts.

    Implements ``Detector::checkIntersection`` (``fluxAtObserver.C:70-107``)
    pairwise: infinite-line/plane intersection, in-plane distance <= width/2,
    parallel rays (|d.n| < 1e-10) excluded.  All pair terms are matmuls.
    """
    f32 = jnp.float32
    E = E.astype(f32)
    D = D.astype(f32)
    C = C.astype(f32)
    Nrm = Nrm.astype(f32)

    # Precision.HIGHEST is LOAD-BEARING: a lower matmul precision rounds
    # the f32 inputs (bf16 or TF32 keep 8-10 mantissa bits), and the
    # expanded r^2 below subtracts O(|E|^2) pair terms — input rounding of
    # ~0.1-0.4% of 519-cm box points turns t and r^2 into garbage for a
    # position-dependent subset of pairs (seen as up to +40% spurious hits
    # per detector row on a bf16-default device).
    HI = jax.lax.Precision.HIGHEST
    dn = jax.lax.dot_general(  # [N,P]  d . n_p
        D, Nrm, (((1,), (1,)), ((), ())), preferred_element_type=f32,
        precision=HI)
    en = jax.lax.dot_general(  # [N,P]  e . n_p
        E, Nrm, (((1,), (1,)), ((), ())), preferred_element_type=f32,
        precision=HI)
    ec = jax.lax.dot_general(  # [N,P]  e . c_p
        E, C, (((1,), (1,)), ((), ())), preferred_element_type=f32,
        precision=HI)
    dc = jax.lax.dot_general(  # [N,P]  d . c_p
        D, C, (((1,), (1,)), ((), ())), preferred_element_type=f32,
        precision=HI)

    cn = jnp.sum(C * Nrm, axis=1)          # [P]  c_p . n_p
    c2 = jnp.sum(C * C, axis=1)            # [P]  |c_p|^2
    e2 = jnp.sum(E * E, axis=1)            # [N]
    ed = jnp.sum(E * D, axis=1)            # [N]  e . d

    safe_dn = jnp.where(dn == 0, 1.0, dn)
    t = -(en - cn[None, :]) / safe_dn      # [N,P] line-plane distance
    # |e + t d - c|^2 with |d| = 1:
    r2 = (e2[:, None] + c2[None, :] - 2.0 * ec) + t * (2.0 * (ed[:, None] - dc) + t)
    hit = (jnp.abs(dn) >= PARALLEL_EPS) & (r2 <= half_w * half_w)
    hit &= rowmask[:, None]
    return jnp.sum(hit, axis=0, dtype=jnp.int32)


def _plucker_weights(C, Nrm, half_w):
    """Per-position 21-vector of quadratic-form weights for the Plucker
    scorer.

    The disk test multiplied through by b^2 (b = d.n) is
    ``|V|^2 <= R^2 b^2`` with ``V = b (rel x n) - a (d x n)`` — and V is
    LINEAR in the ray's Plucker coordinates r = (m, d), m = p x d:

        V = (I - n n^T) m + B d,   B = -(c x n) n^T - (c.n) [n]_x

    so the whole test is ``r^T M r <= 0`` with the symmetric 6x6

        M = [[I - n n^T,  B       ],
             [B^T,        B^T B - R^2 n n^T]]

    (the mm-block uses A^T A = A since A is a projector, and A B = B since
    both columns spaces of B are already orthogonal to n).  Returns the
    ``[P, 21]`` upper-triangle weights (off-diagonals doubled) that turn
    the pair test into ONE ``[N, 21] x [21, P]`` matmul.
    """
    f32 = jnp.float32
    C = C.astype(f32)
    Nrm = Nrm.astype(f32)
    P = C.shape[0]
    eye = jnp.eye(3, dtype=f32)
    HI = jax.lax.Precision.HIGHEST  # see _hits_block
    nnT = jnp.einsum("pi,pj->pij", Nrm, Nrm, precision=HI)
    A = eye[None] - nnT                                    # [P,3,3]
    cxn = jnp.cross(C, Nrm)                                # [P,3]
    cn = jnp.sum(C * Nrm, axis=1)                          # [P]
    # cross-product matrix [n]_x (so that [n]_x v = n x v)
    zeros = jnp.zeros((P,), f32)
    nx, ny, nz = Nrm[:, 0], Nrm[:, 1], Nrm[:, 2]
    n_x = jnp.stack([
        jnp.stack([zeros, -nz, ny], axis=-1),
        jnp.stack([nz, zeros, -nx], axis=-1),
        jnp.stack([-ny, nx, zeros], axis=-1),
    ], axis=-2)                                            # [P,3,3]
    B = (-jnp.einsum("pi,pj->pij", cxn, Nrm, precision=HI)
         - cn[:, None, None] * n_x)                        # [P,3,3]
    BtB = jnp.einsum("pki,pkj->pij", B, B, precision=HI)
    M = jnp.concatenate([
        jnp.concatenate([A, B], axis=2),
        jnp.concatenate([jnp.swapaxes(B, 1, 2),
                         BtB - (half_w * half_w) * nnT], axis=2),
    ], axis=1)                                             # [P,6,6]
    iu0, iu1 = jnp.triu_indices(6)
    w = M[:, iu0, iu1]
    # double the off-diagonal weights (each pair r_i r_j appears twice)
    return jnp.where((iu0 != iu1)[None, :], 2.0 * w, w)    # [P,21]


def _plucker_features(E, D):
    """``[N, 21]`` upper-triangle products of r = (m, d), m = E x D (any
    point on the line gives the same moment)."""
    f32 = jnp.float32
    E = E.astype(f32)
    D = D.astype(f32)
    r6 = jnp.concatenate([jnp.cross(E, D), D], axis=1)     # [N,6]
    iu0, iu1 = jnp.triu_indices(6)
    return r6[:, iu0] * r6[:, iu1]                         # [N,21]


def _hits_block_mxu(Phi, D, rowmask, W, Nrm):
    """Plucker pair test for one position block: one [N,21]x[21,P] matmul
    for the disk condition plus the K=3 parallel guard.  Same semantics as
    ``_hits_block`` (infinite line, |d.n| >= 1e-10), multiplied through by
    b^2 so there is no division."""
    f32 = jnp.float32
    # HIGHEST on s is LOAD-BEARING: rounded inputs break the cancellation-
    # sensitive quadratic form (see _hits_block), and no cheaper scheme
    # survives the form's degeneracy at small b (s = b^2 (dist^2 - R^2)).
    s = jax.lax.dot_general(   # [N,P]  r^T M_p r
        Phi, W, (((1,), (1,)), ((), ())), preferred_element_type=f32,
        precision=jax.lax.Precision.HIGHEST)
    # The parallel guard is a K=3 product: HIGHEST costs little, and one
    # precision everywhere keeps the guard's error an f32 rounding on
    # every device, so only pairs with |d.n| at f32 noise can flip — the
    # same edge population the mxu-vs-exact equivalence already tolerates.
    dn = jax.lax.dot_general(  # [N,P]  d . n_p
        D.astype(f32), Nrm.astype(f32), (((1,), (1,)), ((), ())),
        preferred_element_type=f32, precision=jax.lax.Precision.HIGHEST)
    hit = (s <= 0.0) & (jnp.abs(dn) >= PARALLEL_EPS) & rowmask[:, None]
    return jnp.sum(hit, axis=0, dtype=jnp.int32)


def _score_grid(E, D, rowmask, grid: DetectorGrid, exit_port_z, pos_chunk,
                method: str = "mxu"):
    """Chunked [rays x positions] scoring core shared by the trace-once
    scorers.

    ``method="mxu"`` (default) runs the Plucker-quadratic single-matmul
    test (``_hits_block_mxu``); ``"exact"`` runs the direct per-pair
    plane/disk arithmetic (``_hits_block``).  The two differ only in fp32
    rounding at the disk edge (the mxu form is the exact test multiplied
    through by (d.n)^2); equivalence is pinned by tests/test_score.py.
    """
    C, Nrm = grid_centers_normals(grid, exit_port_z)
    P = grid.n_positions
    chunk = min(pos_chunk, P)
    n_chunks = -(-P // chunk)
    pad = n_chunks * chunk - P
    if pad:
        C = jnp.concatenate([C, jnp.zeros((pad, 3), C.dtype)])
        # pad normals with +z so padded positions are valid-but-missed
        padn = jnp.tile(jnp.array([[0.0, 0.0, 1.0]], Nrm.dtype), (pad, 1))
        Nrm = jnp.concatenate([Nrm, padn])
    half_w = grid.width / 2.0

    if method == "mxu":
        # Anchor the Plucker frame at the port centre: translation-
        # invariant test, but the moment features shrink ~34x (exit lines
        # pass within the ~17.5 cm port aperture of the anchor) so f32
        # rounding at the disk edge is strictly smaller than in world
        # coordinates.
        anchor = jnp.array([0.0, 0.0, exit_port_z], jnp.float32)
        W = _plucker_weights(C - anchor[None, :], Nrm, half_w)
        # subtract in E's own dtype THEN cast: for float64 traces the
        # anchoring cancellation happens at full precision, so the f32
        # features carry the small relative-coordinate values exactly
        # (ADVICE r3: cast-then-subtract forfeited that win)
        E_rel = (E - anchor.astype(E.dtype)[None, :]).astype(jnp.float32)
        Phi = _plucker_features(E_rel, D)
        Wb = W.reshape(n_chunks, chunk, 21)
        Nb = Nrm.reshape(n_chunks, chunk, 3)

        def one_chunk(args):
            w, n = args
            return _hits_block_mxu(Phi, D, rowmask, w, n)

        counts = jax.lax.map(one_chunk, (Wb, Nb)).reshape(-1)[:P]
        return counts.reshape(grid.n_theta, grid.n_phi)

    Cb = C.reshape(n_chunks, chunk, 3)
    Nb = Nrm.reshape(n_chunks, chunk, 3)

    def one_chunk(args):
        c, n = args
        return _hits_block(E, D, rowmask, c, n, half_w)

    counts = jax.lax.map(one_chunk, (Cb, Nb)).reshape(-1)[:P]
    return counts.reshape(grid.n_theta, grid.n_phi)


def fluxmap_trace_once(
    result: TraceResult,
    grid: DetectorGrid,
    exit_port_z=-100.0,
    pos_chunk: int = 1080,
    method: str = "mxu",
) -> jax.Array:
    """The trace-once flux map: ``[n_theta, n_phi]`` hit COUNTS from a traced
    batch (``sweepDetectorTraceOnce``, ``fluxAtObserverFast.C:1068-1341``).

    Divide by the traced ray count for the reference's ``fraction`` column.
    Counts (not fractions) are returned so sharded partial maps can be
    ``psum``-merged exactly.
    """
    mask = result.exited_port_mask(exit_port_z)
    E = result.last_point.stack()
    D = result.direction.stack()
    return _score_grid(E, D, mask, grid, exit_port_z, pos_chunk, method)


def exit_capacity(scene: SphereScene, n_rays: int, sigmas: float = 6.0,
                  margin: float = 1.05) -> int:
    """Static upper bound on the exit count for compaction: expected
    exit fraction p/(p + 1-rho) plus ``sigmas`` binomial deviations and a
    relative margin.  Requires concrete scene parameters.

    The closed-form estimate is the LAMBERTIAN roulette-walk law; other
    scatter models (a near-specular chain can funnel almost every ray out
    the port) get no compaction bound — the full batch is returned, which
    disables the shrink but can never overflow."""
    import math

    from ..config import expected_exit_fraction

    if callable(scene.surface_model) or \
            SurfaceModel(scene.surface_model) != SurfaceModel.LAMBERTIAN:
        return n_rays
    p = expected_exit_fraction(scene.theta_max_deg, scene.reflectance)
    cap = p * n_rays * margin + sigmas * math.sqrt(
        max(p * (1 - p) * n_rays, 1.0))
    return min(n_rays, int(-(-cap // 8) * 8))


def fluxmap_trace_once_compact(
    result: TraceResult,
    grid: DetectorGrid,
    capacity: int,
    exit_port_z=-100.0,
    pos_chunk: int = 1080,
    method: str = "mxu",
):
    """Trace-once scoring over the COMPACTED exit subset: gathers the
    (typically ~43%) exiting rays into a ``capacity``-sized buffer before
    the [rays x positions] test, cutting the scoring work proportionally.

    Returns ``(counts, n_overflow)``; ``n_overflow > 0`` means ``capacity``
    was exceeded and that many exit rays went UNSCORED — size capacity with
    ``exit_capacity`` (a >=6-sigma bound) and treat nonzero overflow as an
    error at the call site.
    """
    mask = result.exited_port_mask(exit_port_z)
    n = mask.shape[0]
    from .compact import nonzero_indices

    idx = nonzero_indices(mask, capacity, n)
    valid = idx < n
    take = jnp.minimum(idx, n - 1)
    E = result.last_point.stack()[take]
    D = result.direction.stack()[take]
    n_overflow = jnp.sum(mask, dtype=jnp.int32) - jnp.sum(
        valid, dtype=jnp.int32)
    counts = _score_grid(E, D, valid, grid, exit_port_z, pos_chunk, method)
    return counts, n_overflow


def hits_single_detector(result: TraceResult, center: Vec3, normal: Vec3,
                         half_width, exit_port_z=-100.0) -> jax.Array:
    """Hit count for one detector position (the per-position scoring of
    ``traceRaysParallel``, ``fluxAtObserverOptimize.C:298-327``)."""
    mask = result.exited_port_mask(exit_port_z)
    hit = line_hits_disk(result.last_point, result.direction, center, normal,
                         half_width, PARALLEL_EPS)
    return jnp.sum(hit & mask, dtype=jnp.int32)


def fluxmap_retrace(
    key: jax.Array,
    scene: SphereScene,
    source: Source,
    grid: DetectorGrid,
    n_per_pos: int,
    cfg: TraceConfig = TraceConfig(),
    pos_chunk: int | None = None,
    centers_normals=None,
) -> jax.Array:
    """The honest retrace sweep: fresh rays for every detector position
    (``sweepDetector``, ``fluxAtObserverOptimize.C:433-702`` — 8.1x10^8
    traces per map).  Statistically identical to trace-once in expectation but
    with independent noise per position; kept for cross-method consistency
    checks (SURVEY.md §4.3).  Returns ``[n_theta, n_phi]`` hit counts.

    ``pos_chunk=None`` picks 32 positions per scan step, capped so a step
    stays under 2^22 rays (chosen on an earlier build, not yet
    measured on the H100).

    ``centers_normals``: optional explicit ``([P,3], [P,3])`` detector
    placement override — pass DYNAMIC arrays here to reuse one compiled
    program across sub-grids whose static shape matches (a sub-grid with
    different static theta bounds would otherwise recompile).
    """
    if pos_chunk is None:
        pos_chunk = max(1, min(32, (1 << 22) // max(n_per_pos, 1)))
    if centers_normals is not None:
        C, Nrm = centers_normals
    else:
        C, Nrm = grid_centers_normals(grid, scene.exit_port_z)
    P = grid.n_positions
    chunk = min(pos_chunk, P)
    n_chunks = -(-P // chunk)
    pad = n_chunks * chunk - P
    if pad:
        C = jnp.concatenate([C, jnp.zeros((pad, 3), C.dtype)])
        padn = jnp.tile(jnp.array([[0.0, 0.0, 1.0]], Nrm.dtype), (pad, 1))
        Nrm = jnp.concatenate([Nrm, padn])
    half_w = grid.width / 2.0

    def one_chunk(carry, i):
        # A fresh, independent batch per position chunk: key folded on the
        # chunk index, rays partitioned chunk-wise among positions.
        k = jax.random.fold_in(key, i)
        res = trace_rays(k, scene, source, n_per_pos * chunk, cfg)
        mask = res.exited_port_mask(scene.exit_port_z)
        # ray j belongs to position i*chunk + j // n_per_pos
        owner = jnp.arange(n_per_pos * chunk) // n_per_pos
        c = Vec3.from_dense(jax.lax.dynamic_slice_in_dim(C, i * chunk, chunk))
        n = Vec3.from_dense(jax.lax.dynamic_slice_in_dim(Nrm, i * chunk, chunk))
        cen = Vec3(c.x[owner], c.y[owner], c.z[owner])
        nrm = Vec3(n.x[owner], n.y[owner], n.z[owner])
        hit = line_hits_disk(res.last_point, res.direction, cen, nrm,
                             half_w, PARALLEL_EPS) & mask
        return carry, jnp.sum(
            hit.reshape(chunk, n_per_pos), axis=1, dtype=jnp.int32)

    _, counts = jax.lax.scan(one_chunk, jnp.zeros((), jnp.int32),
                             jnp.arange(n_chunks))
    return counts.reshape(-1)[:P].reshape(grid.n_theta, grid.n_phi)


def fluxmap_retrace_binomial(
    key: jax.Array,
    scene: SphereScene,
    source: Source,
    grid: DetectorGrid,
    n_per_pos: int,
    cfg: TraceConfig = TraceConfig(),
    oversample: int = 128,
    pos_chunk: int | None = None,
    method: str = "mxu",
    qmc: bool = True,
):
    """Retrace-statistics flux map sampled from the per-position binomial
    law instead of 8.1x10^8 independent traces.

    The exact retrace cell (``sweepDetector``,
    ``fluxAtObserverOptimize.C:433-702``) is ``Binomial(n, pi_p)`` with
    ``pi_p`` = P(a fresh ray's final segment hits the disk at position p),
    independent across positions.  ``pi_p`` has no closed form, but ONE
    shared sample estimates every cell's probability at once:

    1. trace ``M = oversample * n_per_pos`` fresh rays through the full
       physics (whatever engine ``trace_rays_auto`` dispatches — exact-rim
       post-pass included);
    2. score the compacted exit segments against all P positions (the
       Plucker matmul) -> hit counts ``X_p``; ``pi_hat_p = X_p / M``
       is unbiased with ``Var = pi_p (1 - pi_p) / M``;
    3. draw ``Y_p ~ Binomial(n_per_pos, pi_hat_p)`` independently per
       position (exact sampler: inversion / transformed rejection).

    Error budget (the docstring contract, pinned by
    ``tests/test_retrace_binomial.py``): marginally ``E[Y_p] = n pi_p``
    exactly, and

        Var(Y_p) = E[n pi_hat (1 - pi_hat)] + n^2 Var(pi_hat)
                 ~= n pi (1 - pi) * (1 + n / M)

    i.e. the relative excess variance over the true retrace cell is
    ``n / M = 1 / oversample`` (0.8% at the default 128), and the
    cross-cell correlation induced by the shared ``pi_hat`` sample is of
    the same ``1/oversample`` order (the true retrace has exactly 0).
    The simulating sweep (``fluxmap_retrace``) remains the exact-law
    default; this engine is the production fast path when ~1% excess
    variance is acceptable — it replaces ~10^9 traces with ``M`` of them.

    ``qmc=True`` (default) draws the SHARED sample with the Sobol option
    where the direct engine applies (see ``core/qmc.py``): pi_hat's error
    only shrinks (stratification, marginals exactly uniform), so the
    stated 1/oversample excess-variance contract becomes conservative
    while the per-cell binomial draws stay independent.

    Returns ``[n_theta, n_phi]`` int32 hit counts (cells <= n_per_pos).
    """
    import dataclasses

    if oversample < 2:
        raise ValueError("oversample must be >= 2: the shared "
                         "sample must exceed the per-position count")
    M = int(oversample) * int(n_per_pos)
    cap = exit_capacity(scene, M)
    if pos_chunk is None:
        # 256 positions/chunk (chosen on an earlier build, not yet
        # measured on the H100); cap the [cap, pos_chunk] f32 block at
        # ~3 GB for small-memory safety
        pos_chunk = max(8, min(256, (3 << 28) // max(cap, 1)))
    if qmc and not cfg.qmc:
        cfg = dataclasses.replace(cfg, qmc=1)
    k_trace, k_draw = jax.random.split(jax.random.fold_in(key, 0x51))
    res = trace_rays(k_trace, scene, source, M, cfg)
    counts_M, overflow = fluxmap_trace_once_compact(
        res, grid, cap, scene.exit_port_z, pos_chunk, method)
    return binomial_cells_from_counts(k_draw, counts_M, overflow, M,
                                      n_per_pos, grid.n_positions)


def binomial_cells_from_counts(k_draw, counts_M, overflow, M: int,
                               n_per_pos: int, n_positions: int):
    """The draw stage shared by the single-chip and sharded binomial
    retrace engines: counts from the shared M-ray sample -> pi_hat ->
    independent Binomial(n, pi_hat) per cell.

    ``overflow``: unscored exits beyond the compaction capacity — a
    >=6-sigma-impossible event (``exit_capacity``); bump pi_hat by it
    spread over the cells so the estimate stays conservative rather than
    silently low."""
    pi_hat = (counts_M.astype(jnp.float32)
              + overflow.astype(jnp.float32) / n_positions) / M
    draws = jax.random.binomial(k_draw, float(n_per_pos),
                                jnp.clip(pi_hat, 0.0, 1.0))
    return jnp.nan_to_num(draws).astype(jnp.int32)


# ---------------------------------------------------------------------------
# Exit-direction histograms (distributionSphereDetectorSweep.C, 3dRayLog)
# ---------------------------------------------------------------------------

def exit_angle_histogram(result: TraceResult, n_bins: int = 180,
                         lo: float = -90.0, hi: float = 90.0,
                         exit_port_z=-100.0) -> jax.Array:
    """Signed exit-angle histogram of port-exiting rays, 180 bins on
    [-90, 90] — the ``distributionSphereDetectorSweep.C:80-99`` observable.

    theta = sign(dx) * (180 - acos(dz)) deg: the angle from the -z port
    axis, signed by the x-direction.  (The reference macro fills
    sign(dx)*acos(dz), whose values exceed 90 deg for every downward ray and
    land in ROOT's overflow bin; its companion ``3drayanalysis.py:16``
    subtracts 180 deg — that corrected port-axis convention is what the
    cosine self-check (fit at ``:115-118``) needs, and what is implemented
    here.)  A Lambertian sphere port must produce a cos(theta) profile.
    """
    mask = result.exited_port_mask(exit_port_z)
    d = result.direction.normalized()
    theta = jnp.sign(d.x) * (
        180.0 - jnp.rad2deg(jnp.arccos(jnp.clip(d.z, -1.0, 1.0))))
    idx = jnp.clip(((theta - lo) / (hi - lo) * n_bins).astype(jnp.int32),
                   0, n_bins - 1)
    in_range = (theta >= lo) & (theta < hi) & mask & jnp.isfinite(theta)
    return jnp.zeros((n_bins,), jnp.int32).at[idx].add(
        in_range.astype(jnp.int32))


def exit_directions(result: TraceResult, exit_port_z=-100.0):
    """(mask, dx, dy, dz) of exiting rays — the ``3dRayLog.txt`` payload
    (``# dx dy dz`` of 100k exit directions, see ``3drayanalysis.py:5``)."""
    mask = result.exited_port_mask(exit_port_z)
    d = result.direction.normalized()
    return mask, d.x, d.y, d.z


def z_angle_histogram(dz, mask, n_bins: int = 100):
    """The cos-z binned ``angular_dist.txt`` payload: 100 bins over dz."""
    idx = jnp.clip(((dz + 1.0) / 2.0 * n_bins).astype(jnp.int32), 0, n_bins - 1)
    return jnp.zeros((n_bins,), jnp.int32).at[idx].add(mask.astype(jnp.int32))


# ---------------------------------------------------------------------------
# In-sphere focal-surface disk (integratingSphereDetectorSweep.C)
# ---------------------------------------------------------------------------

def insphere_disk_position(theta_deg, phi_deg, radius=200.0,
                           exit_port_z=-100.0, aimed: bool = False):
    """Disk placement of ``addDetectorDisk``
    (``integratingSphereDetectorSweep.C:145-172``): centre at spherical
    coords about the ORIGIN (r=200 cm, theta from -z).

    The normal reproduces the macro's actual rotation: ``rot->RotateZ(
    rotPhi); rot->RotateY(rotTheta)`` — but ROOT's ``TGeoRotation::Rotate*``
    LEFT-multiplies (master-frame rotations), so the composed matrix is
    ``R_y(rotTheta) @ R_z(rotPhi)`` and the tube axis lands at
    ``(sin rotTheta, 0, cos rotTheta)`` with ``rotTheta = -atan2(
    hypot(dx, dy), dz)`` — INDEPENDENT of phi.  The disks are therefore
    aimed at the port only on the phi = 0 / theta > 0 ray of the sweep and
    tilted everywhere else; the retained ``detector_sweep*.txt`` corpus was
    produced with these tilted disks (pinned by tests/test_insphere_parity
    .py: the faithful normal matches the corpus theta-profile at
    correlation 0.99 / scale 1.01, the 'aimed' one is 30% too wide).
    ``aimed=True`` gives the aim-at-port normal the macro's comment
    describes."""
    th = jnp.deg2rad(theta_deg)
    ph = jnp.deg2rad(phi_deg)
    cx = radius * jnp.sin(th) * jnp.cos(ph)
    cy = radius * jnp.sin(th) * jnp.sin(ph)
    cz = -radius * jnp.cos(th)
    d = Vec3(0.0 - cx, 0.0 - cy, exit_port_z - cz)
    if aimed:
        return Vec3(cx, cy, cz), d.normalized()
    rot_theta = -jnp.arctan2(jnp.sqrt(d.x * d.x + d.y * d.y), d.z)
    normal = Vec3(jnp.sin(rot_theta), jnp.zeros_like(rot_theta),
                  jnp.cos(rot_theta))
    return Vec3(cx, cy, cz), normal


def insphere_disk_hit_mask(result: TraceResult, center: Vec3, normal: Vec3,
                           disk_radius) -> jax.Array:
    """Per-ray bool: the final segment hits the focal-surface disk.

    ``center``/``normal`` broadcast — pass scalars for one disk or
    per-ray Vec3 arrays for a batched sweep (the chunked retrace path of
    ``sweep_insphere_detector`` gathers a disk per ray).  The disk
    participates in the geometry (absorbs the ray), so unlike the
    observer test the intersection must lie FORWARD on the final segment
    (t >= 0).  Because the disk sits outside the sphere (r=200 > shell
    radii), it can only intercept port-exiting rays — a forward segment
    test is exactly equivalent to the reference's node-history scan
    (``integratingSphereDetectorSweep.C:134-143``)."""
    p = result.seg_start
    d = result.direction
    dot = d.dot(normal)
    rel = p - center
    t = -rel.dot(normal) / jnp.where(dot == 0, 1.0, dot)
    hit_pt = p + d.scale(t)
    r2 = (hit_pt - center).norm2()
    exited = result.status == EXITED
    return (jnp.abs(dot) >= PARALLEL_EPS) & (t >= 0) & \
        (r2 <= disk_radius * disk_radius) & exited


def hits_insphere_disk(result: TraceResult, center: Vec3, normal: Vec3,
                       disk_radius) -> jax.Array:
    """Hit count for one disk position (see ``insphere_disk_hit_mask``)."""
    return jnp.sum(insphere_disk_hit_mask(result, center, normal,
                                          disk_radius), dtype=jnp.int32)
