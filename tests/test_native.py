"""Native C++ engine tier vs the JAX path — two independent implementations
of the same physics must agree statistically (trace) and exactly (scorer,
given identical segments)."""

import subprocess

import numpy as np
import pytest

from altair_tpu import DetectorGrid, SCENE_OPTIMIZE, SOURCE_OVERNIGHT, native

pytestmark = pytest.mark.skipif(
    not native.available(),
    reason="native library not built (make -C native)")

SCENE = SCENE_OPTIMIZE.with_(max_bounces=4096)


@pytest.fixture(scope="module")
def nres():
    return native.trace_rays_native(SCENE, SOURCE_OVERNIGHT, 50_000, seed=7)


class TestNativeTrace:
    def test_exit_fraction_matches_corpus(self, nres):
        frac = nres.n_exited / 50_000
        assert 0.415 < frac < 0.44, frac

    def test_statuses_and_geometry(self, nres):
        assert set(np.unique(nres.status)) <= {1, 2}
        absorbed = nres.last_point[nres.status == 2]
        r = np.linalg.norm(absorbed, axis=1)
        # wall absorptions at r = 100.1; rim-face absorptions in the band
        assert (r > 100.1 - 1e-6).all() and (r < 101.0 + 1e-6).all()
        assert (np.abs(r - 100.1) < 1e-6).mean() > 0.95
        exited = nres.last_point[nres.status == 1]
        assert (np.abs(exited).max(axis=1) > 299.0).all()  # on the world box

    def test_bounce_statistics(self, nres):
        mean = nres.n_bounces.mean()
        assert 50 < mean < 65

    def test_deterministic(self):
        a = native.trace_rays_native(SCENE, SOURCE_OVERNIGHT, 2_000, seed=3)
        b = native.trace_rays_native(SCENE, SOURCE_OVERNIGHT, 2_000, seed=3)
        np.testing.assert_array_equal(a.last_point, b.last_point)

    def test_direct_sampler_matches_bounce_loop(self):
        """The compiled closed-form sampler vs the compiled bounce loop:
        two independent fp64 implementations (neither shares code OR the
        chain-law derivation with the JAX path) must agree on every
        marginal — the strongest cross-check of the direct engine's math
        (docs/PARITY.md §8)."""
        from scipy.stats import ks_2samp

        scene = SCENE.with_(exact_rim=False)
        n = 100_000
        sim = native.trace_rays_native(scene, SOURCE_OVERNIGHT, n, seed=11)
        direct = native.trace_rays_native_direct(scene, SOURCE_OVERNIGHT, n,
                                                 seed=13)
        f_sim, f_dir = sim.n_exited / n, direct.n_exited / n
        sem = np.sqrt(0.43 * 0.57 / n)
        assert abs(f_sim - f_dir) < 5 * sem, (f_sim, f_dir)
        ex_s, ex_d = sim.status == 1, direct.status == 1
        # exit-direction z and segment-start z marginals
        k1 = ks_2samp(sim.direction[ex_s, 2], direct.direction[ex_d, 2])
        k2 = ks_2samp(sim.seg_start[ex_s, 2], direct.seg_start[ex_d, 2])
        assert k1.pvalue > 1e-3, k1
        assert k2.pvalue > 1e-3, k2
        # bounce-count distribution (integer KS: compare via means + tails)
        assert abs(sim.n_bounces.mean() - direct.n_bounces.mean()) < 1.0
        q_s = np.quantile(sim.n_bounces, [0.5, 0.9, 0.99])
        q_d = np.quantile(direct.n_bounces, [0.5, 0.9, 0.99])
        assert (np.abs(q_s - q_d) <= np.maximum(3, 0.06 * q_s)).all(), (
            q_s, q_d)

    def test_direct_sampler_matches_jax_direct(self):
        """Native direct sampler vs the JAX direct sampler — same law,
        fully independent implementations."""
        import jax

        from altair_tpu import TraceConfig
        from altair_tpu.core.trace_direct import trace_rays_direct

        scene = SCENE.with_(exact_rim=False)
        n = 100_000
        nat = native.trace_rays_native_direct(scene, SOURCE_OVERNIGHT, n,
                                              seed=17)
        jres = trace_rays_direct(jax.random.key(19), scene, SOURCE_OVERNIGHT,
                                 n, TraceConfig())
        f_n = nat.n_exited / n
        f_j = float(jres.exited_port_mask(scene.exit_port_z).mean())
        assert abs(f_n - f_j) < 5 * np.sqrt(0.43 * 0.57 / n), (f_n, f_j)
        assert abs(nat.n_bounces.mean() - float(np.asarray(
            jres.n_bounces).mean())) < 1.0

    def test_agrees_with_jax_profile(self, nres):
        """Flux-map theta profile from the native path within MC error of
        the JAX path (and of the golden retrace corpus)."""
        grid = DetectorGrid(n_theta=18, n_phi=9)
        fm = native.fluxmap_trace_once_native(nres, grid) / 50_000
        prof = fm.mean(axis=1)
        # coarse profile vs the retrace corpus shape (each coarse bin is a
        # SINGLE detector position, so per-bin MC spread is larger than on
        # the 180x90 grid)
        assert abs(prof[0] - 0.0152) < 0.002
        assert abs(prof[9] - 0.0055) < 0.0015
        assert prof[17] < 0.0008


class TestNativeScorer:
    def test_exact_match_with_jax_scorer(self, nres):
        """Given the SAME segments, the native scorer and the JAX matmul
        scorer must agree bin-for-bin exactly (same test, fp64 vs fp32 —
        tolerance 0 on counts away from the rim, tiny slack for boundary
        flips)."""
        import jax.numpy as jnp

        from altair_tpu.core.score import fluxmap_trace_once
        from altair_tpu.core.trace import TraceResult
        from altair_tpu.core.geometry import Vec3

        grid = DetectorGrid(n_theta=12, n_phi=6)
        native_fm = native.fluxmap_trace_once_native(nres, grid)

        res = TraceResult(
            status=jnp.asarray(nres.status),
            last_point=Vec3.from_dense(jnp.asarray(nres.last_point,
                                                   jnp.float32)),
            seg_start=Vec3.from_dense(jnp.asarray(nres.seg_start,
                                                  jnp.float32)),
            direction=Vec3.from_dense(jnp.asarray(nres.direction,
                                                  jnp.float32)),
            n_bounces=jnp.asarray(nres.n_bounces),
        )
        jax_fm = np.asarray(fluxmap_trace_once(res, grid))
        # fp32 rim flips: allow <=0.2% relative disagreement per bin
        diff = np.abs(jax_fm - native_fm)
        assert (diff <= np.maximum(2, 0.002 * native_fm)).all(), diff.max()

    def test_detector_grid_matches_reference_quirk(self):
        from altair_tpu.core.score import grid_centers_normals

        grid = DetectorGrid(n_theta=5, n_phi=4)
        cn, nn = native.detector_grid_native(grid)
        C, N = grid_centers_normals(grid)
        np.testing.assert_allclose(cn, np.asarray(C), atol=1e-4)
        np.testing.assert_allclose(nn, np.asarray(N), atol=1e-6)


def test_library_builds_from_source(tmp_path):
    """The library is never committed: ``native/`` must build it (what
    ``native._load`` does at first use)."""
    import ctypes
    import os
    import shutil

    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native")
    for name in ("Makefile", "altair_native.cpp"):
        shutil.copy(os.path.join(src, name), tmp_path / name)
    subprocess.run(["make", "-C", str(tmp_path), "LIB=libtest.so"],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(tmp_path / "libtest.so"))
    assert lib.altair_num_threads() >= 1
