"""Scoring layer: trace-once matmul scorer vs direct per-position tests,
exit histograms, in-sphere disk (SURVEY.md §7.4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.optimize import curve_fit

from altair_tpu import DetectorGrid, SCENE_OPTIMIZE, SOURCE_OVERNIGHT
from altair_tpu.core import score
from altair_tpu.core.geometry import Vec3, detector_position
from altair_tpu.core.trace import EXITED, trace_rays_jit

N = 20_000
SCENE = SCENE_OPTIMIZE.with_(max_bounces=4096)


@pytest.fixture(scope="module")
def result():
    return trace_rays_jit(jax.random.key(0), SCENE, SOURCE_OVERNIGHT, N)


@pytest.fixture(scope="module")
def small_grid():
    return DetectorGrid(n_theta=18, n_phi=9)


@pytest.fixture(scope="module")
def fluxmap(result, small_grid):
    return np.asarray(score.fluxmap_trace_once(result, small_grid))


class TestTraceOnceScorer:
    def test_matches_direct_per_position(self, result, small_grid, fluxmap):
        th = np.asarray(small_grid.theta_centers())
        ph = np.asarray(small_grid.phi_centers())
        for ti, pj in [(0, 0), (5, 3), (9, 8), (17, 4)]:
            c, n = detector_position(jnp.float32(th[ti]), jnp.float32(ph[pj]),
                                     small_grid.radius)
            direct = int(score.hits_single_detector(
                result, c, n, small_grid.width / 2))
            assert fluxmap[ti, pj] == direct, (ti, pj)

    def test_chunking_invariance(self, result, small_grid, fluxmap):
        for chunk in (7, 54, 1000):
            fm = np.asarray(score.fluxmap_trace_once(result, small_grid,
                                                     pos_chunk=chunk))
            np.testing.assert_array_equal(fm, fluxmap)

    def test_cosine_theta_profile(self, result):
        """theta-profile of the flux map fits a*cos(b*theta)+c with
        b ~ 1 and good R^2 — the reference's analysis self-check
        (flux_analysis.py:204-242)."""
        grid = DetectorGrid(n_theta=45, n_phi=18)
        fm = np.asarray(score.fluxmap_trace_once(result, grid)) / N
        prof = fm.mean(axis=1)
        th = np.asarray(grid.theta_centers())

        def f(x, a, b, c):
            return a * np.cos(np.deg2rad(b * x)) + c

        popt, _ = curve_fit(f, th, prof, p0=[prof.max(), 1.0, 0.0])
        resid = prof - f(th, *popt)
        r2 = 1 - (resid**2).sum() / ((prof - prof.mean())**2).sum()
        assert r2 > 0.98, (popt, r2)
        # The finite detector (40 cm at 100 cm) and near-field port geometry
        # steepen the profile: the reference corpus itself fits b ~ 1.9-2.2
        # (computed from results_overnight_03_31 / trace_once data), not 1.
        assert 1.5 < popt[1] < 2.8

    def test_phi_symmetry(self, result):
        """Source dir (5,0,0) lies in the xz-plane => map symmetric in phi
        about that plane, and nearly phi-uniform (Lambertian sphere)."""
        grid = DetectorGrid(n_theta=9, n_phi=18)
        fm = np.asarray(score.fluxmap_trace_once(result, grid)) / N
        spread = fm.std(axis=1) / np.maximum(fm.mean(axis=1), 1e-9)
        assert (spread[:5] < 0.2).all()  # low-theta rows are phi-uniform


@pytest.mark.slow
class TestRetraceConsistency:
    def test_retrace_matches_trace_once(self):
        """Cross-method consistency (SURVEY.md §4.3): the retrace sweep and
        the trace-once map agree within MC error."""
        grid = DetectorGrid(n_theta=6, n_phi=4)
        res = trace_rays_jit(jax.random.key(1), SCENE, SOURCE_OVERNIGHT,
                             40_000)
        once = np.asarray(score.fluxmap_trace_once(res, grid)) / 40_000
        retrace = np.asarray(score.fluxmap_retrace(
            jax.random.key(2), SCENE, SOURCE_OVERNIGHT, grid,
            n_per_pos=4_000, pos_chunk=4)) / 4_000
        # 3-sigma MC bound per bin (binomial)
        sigma = np.sqrt(np.maximum(once, 1e-6) / 4_000) * 3 + 0.003
        assert (np.abs(retrace - once) < sigma).mean() > 0.95


class TestExitHistograms:
    def test_lambertian_fit(self, result):
        """Signed-angle exit histogram follows the Lambertian port law
        a*cos(theta)*|sin(theta)| (radiance cos(theta) times the solid-angle
        Jacobian sin(theta) — the shape of the reference's retained
        z_distribution.png / 3drayanalysis.py output)."""
        hist = np.asarray(score.exit_angle_histogram(result))
        centers = -90 + (np.arange(180) + 0.5) * 1.0

        def f(x, a):
            t = np.deg2rad(x)
            return a * np.cos(t) * np.abs(np.sin(t))

        popt, _ = curve_fit(f, centers, hist, p0=[hist.max() * 2])
        resid = hist - f(centers, *popt)
        r2 = 1 - (resid**2).sum() / ((hist - hist.mean())**2).sum()
        # the finite port adds a physical grazing tail at |theta| -> 90
        # (visible in the reference's 3dRayLog too), so the ideal-law fit
        # tops out around R^2 ~ 0.9 in this angle space
        assert r2 > 0.85, r2

    def test_dz_histogram_lambertian(self, result):
        """In dz space the Lambertian port law is exact: content ∝ |dz|.
        The reference's own angular_dist.txt fits A*|dz| with R^2 = 0.997."""
        _, _, _, dz = score.exit_directions(result)
        mask = result.exited_port_mask()
        hist = np.asarray(score.z_angle_histogram(dz, mask))
        centers = -1 + (np.arange(100) + 0.5) * 0.02
        m = centers < 0

        def f(x, A):
            return A * np.abs(x)

        popt, _ = curve_fit(f, centers[m], hist[m], p0=[hist.max()])
        resid = hist[m] - f(centers[m], *popt)
        r2 = 1 - (resid**2).sum() / ((hist[m] - hist[m].mean())**2).sum()
        # 0.997 for the reference's 100k-exit sample; our 8.5k-exit sample
        # carries ~3x the Poisson noise
        assert r2 > 0.96, r2

    def test_total_matches_exits(self, result):
        hist = np.asarray(score.exit_angle_histogram(result))
        st = np.asarray(result.status)
        zx = np.asarray(result.last_point.z)
        n_exit = ((st == EXITED) & (zx < -100.0)).sum()
        assert hist.sum() <= n_exit
        assert hist.sum() > 0.95 * n_exit  # |theta|>90 overflow is tiny

    def test_direction_log_payload(self, result):
        mask, dx, dy, dz = score.exit_directions(result)
        m = np.asarray(mask)
        d = np.stack([np.asarray(dx)[m], np.asarray(dy)[m],
                      np.asarray(dz)[m]], 1)
        np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-5)
        assert (d[:, 2] < 0).all()


class TestInsphereDisk:
    def test_on_axis_disk_sees_flux(self, result):
        c, n = score.insphere_disk_position(jnp.float32(0.0),
                                            jnp.float32(0.0))
        assert np.isclose(float(c.z), -200.0)
        hits = int(score.hits_insphere_disk(result, c, n, 5.0))
        assert hits > 0

    def test_off_axis_less_than_on_axis(self, result):
        c0, n0 = score.insphere_disk_position(jnp.float32(0.0),
                                              jnp.float32(0.0))
        c45, n45 = score.insphere_disk_position(jnp.float32(44.0),
                                                jnp.float32(0.0))
        h0 = int(score.hits_insphere_disk(result, c0, n0, 5.0))
        h45 = int(score.hits_insphere_disk(result, c45, n45, 5.0))
        assert h45 < h0

    def test_behind_port_plane_no_flux(self, result):
        # theta=90 puts the disk in the port plane's sky — nearly no flux
        c, n = score.insphere_disk_position(jnp.float32(90.0),
                                            jnp.float32(0.0))
        h = int(score.hits_insphere_disk(result, c, n, 5.0))
        assert h < 5


class TestCompactScorer:
    def test_exact_match_and_capacity(self, result):
        # method="exact" is bit-stable across batch shapes, so compaction
        # must reproduce the full map EXACTLY (the mxu matmul re-associates
        # fp32 adds per tile shape — its compact-vs-full check lives in
        # TestMxuScorer with an edge tolerance)
        grid = DetectorGrid(n_theta=12, n_phi=6)
        full = np.asarray(score.fluxmap_trace_once(result, grid,
                                                   method="exact"))
        cap = score.exit_capacity(SCENE, N)
        assert cap < N  # compaction actually shrinks the problem
        compact, ovf = jax.jit(
            lambda r: score.fluxmap_trace_once_compact(
                r, grid, cap, method="exact"))(result)
        assert int(ovf) == 0
        np.testing.assert_array_equal(full, np.asarray(compact))

    def test_overflow_reported(self, result):
        grid = DetectorGrid(n_theta=2, n_phi=2)
        tiny_cap = 128
        _, ovf = jax.jit(
            lambda r: score.fluxmap_trace_once_compact(r, grid, tiny_cap))(
                result)
        n_exit = int(result.exited_port_mask().sum())
        assert int(ovf) == n_exit - tiny_cap

    def test_capacity_bounds(self):
        # rho=1: everything exits -> capacity == n
        from altair_tpu import SCENE_V1
        assert score.exit_capacity(SCENE_V1, 1000) == 1000
        cap170 = score.exit_capacity(SCENE, 100_000)
        assert 43_000 < cap170 < 50_000

    def test_capacity_non_lambertian_no_shrink(self):
        """The closed-form capacity estimate is the LAMBERTIAN walk law; a
        near-specular chain can funnel ~every ray out the port, so other
        models must get the full batch (review finding: the binomial
        engine silently smeared the overflow otherwise)."""
        from altair_tpu.config import SurfaceModel
        for m in (SurfaceModel.SPECULAR, SurfaceModel.MIXED_BRDF,
                  SurfaceModel.COS_N_LOBE):
            assert score.exit_capacity(
                SCENE.with_(surface_model=m), 100_000) == 100_000
        assert score.exit_capacity(
            SCENE.with_(surface_model=lambda *a: None), 1000) == 1000


class TestMxuScorer:
    """The Plucker-quadratic MXU scorer vs the exact per-pair arithmetic.

    The mxu form is the same test multiplied through by (d.n)^2, so the two
    can only disagree by fp32 rounding for pairs ON the disk edge —
    measured 536 flipped pairs of 7.6e8 at 200k rays (2e-6 of total hits).
    """

    def test_matches_exact_scorer(self, result):
        grid = DetectorGrid(n_theta=45, n_phi=30)
        mxu = np.asarray(score.fluxmap_trace_once(result, grid,
                                                  method="mxu")).astype(np.int64)
        exact = np.asarray(score.fluxmap_trace_once(result, grid,
                                                    method="exact")).astype(np.int64)
        diff = mxu - exact
        # per-position flips stay at the edge-rounding scale
        assert np.abs(diff).max() <= 3, (np.abs(diff).max(),)
        assert abs(diff.sum()) / max(exact.sum(), 1) < 1e-4
        assert (diff != 0).mean() < 0.1

    def test_compact_scorer_mxu_path(self, result):
        grid = DetectorGrid(n_theta=12, n_phi=6)
        cap = score.exit_capacity(SCENE, N)
        full = np.asarray(score.fluxmap_trace_once(result, grid,
                                                   method="mxu"))
        compact, ovf = jax.jit(lambda r: score.fluxmap_trace_once_compact(
            r, grid, cap, method="mxu"))(result)
        assert int(ovf) == 0
        # fp32 matmul accumulation re-associates per tile shape, so the
        # compacted batch can flip edge pairs by a count or two
        assert np.abs(np.asarray(compact).astype(np.int64)
                      - full.astype(np.int64)).max() <= 2


class TestParallelGuard:
    def test_guard_matches_exact_on_near_parallel_pairs(self):
        """The Plucker scorer's K=3 parallel guard (Precision.HIGHEST)
        excludes exactly the pairs the exact scorer excludes: with the disk
        condition forced true in both, only |d.n| >= 1e-10 decides."""
        delta = np.array([0.0, 1e-9, 1e-7, 1e-5, 1e-3])
        D = np.stack([np.ones_like(delta), np.zeros_like(delta), delta], 1)
        D = jnp.asarray(D / np.linalg.norm(D, axis=1, keepdims=True),
                        jnp.float32)
        E = jnp.zeros_like(D).at[:, 2].set(-150.0)
        Nrm = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]], jnp.float32)
        C = jnp.zeros((2, 3), jnp.float32)
        rowmask = jnp.ones((5,), bool)
        iu0, iu1 = np.triu_indices(6)
        # s = -(dx^2 + dy^2 + dz^2) = -1 < 0: the disk test always passes
        W = jnp.asarray(np.where((iu0 == iu1) & (iu0 >= 3), -1.0, 0.0),
                        jnp.float32)[None].repeat(2, 0)
        Phi = score._plucker_features(E, D)
        guard_mxu = np.asarray(score._hits_block_mxu(Phi, D, rowmask, W,
                                                     Nrm))
        guard_exact = np.asarray(score._hits_block(E, D, rowmask, C, Nrm,
                                                   1e15))
        np.testing.assert_array_equal(guard_mxu, guard_exact)
        np.testing.assert_array_equal(guard_mxu, [4, 4])
