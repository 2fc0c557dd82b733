"""The GPU bounce kernel (Pallas, Triton route), tested on the CPU.

The kernel runs here in Pallas' generic interpret mode — the same kernel
code, RNG included, that the card compiles — so its geometry and physics
are under test.  The dispatch, padding and stream rules are tested around
it, and ``TestTritonLowering`` lowers the kernel for the CUDA platform to
prove the Triton route accepts every primitive it uses.  The compiled
kernel itself is exercised on the card by ``tests/test_gpu.py`` and
``chip_smoke.py``.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from altair_tpu import SCENE_OPTIMIZE, SOURCE_OVERNIGHT, TraceConfig
from altair_tpu.config import SurfaceModel
from altair_tpu.core import trace_pallas
from altair_tpu.core.trace import exit_count, trace_rays
from altair_tpu.core.trace_pallas import (
    BLOCK,
    _sw_uniforms,
    _threefry2x32,
    pallas_applicable,
    trace_rays_fast,
    trace_rays_pallas,
    trace_rays_pallas_padded,
)

# cap 64 keeps the interpreter fast; both engines truncate identically so
# the statistics stay comparable
SCENE = SCENE_OPTIMIZE.with_(max_bounces=64, exact_rim=False)
CFG = TraceConfig()
N = 16_384


@pytest.fixture(scope="module")
def pallas_result():
    return trace_rays_pallas(jax.random.key(0), SCENE, SOURCE_OVERNIGHT, N,
                             CFG, interpret=True)


@pytest.fixture(scope="module")
def xla_result():
    return trace_rays(jax.random.key(1), SCENE, SOURCE_OVERNIGHT, N, CFG)


class TestPallasPhysics:
    def test_exit_fraction_matches_xla(self, pallas_result, xla_result):
        f_p = int(exit_count(pallas_result)) / N
        f_x = int(exit_count(xla_result)) / N
        sigma = np.sqrt(f_x * (1 - f_x) / N) * np.sqrt(2)
        assert abs(f_p - f_x) < 4 * sigma, (f_p, f_x)

    def test_bounce_distribution_matches_xla(self, pallas_result, xla_result):
        b_p = np.asarray(pallas_result.n_bounces, np.float64)
        b_x = np.asarray(xla_result.n_bounces, np.float64)
        se = np.sqrt(b_x.var() / N) * np.sqrt(2)
        assert abs(b_p.mean() - b_x.mean()) < 4 * se, (b_p.mean(), b_x.mean())

    def test_exit_points_beyond_port(self, pallas_result):
        st = np.asarray(pallas_result.status)
        z = np.asarray(pallas_result.last_point.z)
        assert (z[st == 1] < -100.0).all()  # every exit passed the port plane

    def test_exit_angle_profile_matches_xla(self, pallas_result, xla_result):
        """Mean exit-direction cosine about the port axis must agree with
        the XLA kernel (≈2/3 up to the finite-port correction — the
        distributionSphereDetectorSweep.C observable)."""

        def mean_mu(res):
            mask = np.asarray(res.exited_port_mask())
            return (float((-np.asarray(res.direction.z)[mask]).mean()),
                    int(mask.sum()))

        mu_p, n_p = mean_mu(pallas_result)
        mu_x, n_x = mean_mu(xla_result)
        se = np.sqrt(1 / 18 / min(n_p, n_x)) * np.sqrt(2)  # var(mu) = 1/18
        assert abs(mu_p - mu_x) < 4 * se, (mu_p, mu_x)
        assert abs(mu_p - 2.0 / 3.0) < 0.05  # ballpark of the ideal law

    def test_absorbed_on_shell(self, pallas_result):
        st = np.asarray(pallas_result.status)
        p = np.asarray(pallas_result.last_point.stack())[st == 2]
        r = np.linalg.norm(p, axis=1)
        np.testing.assert_allclose(r, 100.1, atol=1e-2)


class TestPallasRimComposition:
    def test_exact_rim_via_deferred_postpass(self):
        """The kernel's main trace + the deferred rim continuation (what
        trace_rays_fast runs on the card) must agree with the XLA rim
        kernel."""
        from altair_tpu.core.trace import (
            rim_deferred_capacity_shift,
            trace_rays_rim_deferred,
        )

        scene = SCENE.with_(exact_rim=True)
        res, _ = trace_rays_rim_deferred(
            jax.random.key(2), scene, SOURCE_OVERNIGHT, N, CFG,
            capacity_shift=rim_deferred_capacity_shift(scene),
            main_tracer=partial(trace_rays_pallas_padded, interpret=True))
        ref = trace_rays(jax.random.key(3), scene, SOURCE_OVERNIGHT, N, CFG)
        f_p = int(exit_count(res)) / N
        f_x = int(exit_count(ref)) / N
        sigma = np.sqrt(f_x * (1 - f_x) / N) * np.sqrt(2)
        assert abs(f_p - f_x) < 4 * sigma, (f_p, f_x)
        # the rim must have done something: some absorptions sit in the
        # shell band beyond the inner radius (rim-face kills)
        st = np.asarray(res.status)
        r = np.linalg.norm(np.asarray(res.last_point.stack())[st == 2],
                           axis=1)
        assert (r > 100.1 + 1e-3).any()


class TestPallasGuards:
    def test_block_multiple_required(self):
        with pytest.raises(ValueError):
            trace_rays_pallas(jax.random.key(0), SCENE, SOURCE_OVERNIGHT,
                              BLOCK + 1, CFG)

    def test_raw_kernel_rejects_exact_rim(self):
        with pytest.raises(NotImplementedError):
            trace_rays_pallas(jax.random.key(0),
                              SCENE.with_(exact_rim=True),
                              SOURCE_OVERNIGHT, BLOCK, CFG)

    def test_custom_callable_falls_back_to_xla(self, monkeypatch):
        """User scatter callables have no kernel lowering — the dispatch
        must route them to the XLA kernel even on the GPU backend."""
        from altair_tpu.core.sampling import cosine_hemisphere

        def custom(key, incident, normal, scene):
            return cosine_hemisphere(key, normal)

        monkeypatch.setattr(trace_pallas, "_on_gpu", lambda: True)
        scene = SCENE.with_(surface_model=custom)
        assert not pallas_applicable(scene, CFG)
        res = trace_rays_fast(jax.random.key(0), scene, SOURCE_OVERNIGHT,
                              1000, CFG)
        assert res.status.shape == (1000,)


class TestPadding:
    """trace_rays_pallas_padded: any batch size, truncated to n_rays."""

    @pytest.mark.parametrize("n", [1000, 5])
    def test_shapes_and_statuses(self, n):
        res = trace_rays_pallas_padded(jax.random.key(0), SCENE,
                                       SOURCE_OVERNIGHT, n, CFG,
                                       interpret=True)
        for a in jax.tree.leaves(res):
            assert a.shape == (n,)
        st = np.asarray(res.status)
        assert ((st >= 1) & (st <= 3)).all()

    def test_truncation_keeps_the_padded_prefix(self):
        n = 3 * BLOCK + 7
        cut = trace_rays_pallas_padded(jax.random.key(4), SCENE,
                                       SOURCE_OVERNIGHT, n, CFG,
                                       interpret=True)
        full = trace_rays_pallas(jax.random.key(4), SCENE, SOURCE_OVERNIGHT,
                                 4 * BLOCK, CFG, interpret=True)
        for a, b in zip(jax.tree.leaves(cut), jax.tree.leaves(full)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b)[:n])


class TestDispatch:
    def test_cpu_backend_runs_xla(self):
        """Off the GPU the dispatch is the plain XLA tracer: bit-identical
        to trace_rays with the same key."""
        assert not pallas_applicable(SCENE, CFG)
        res = trace_rays_fast(jax.random.key(5), SCENE, SOURCE_OVERNIGHT,
                              2048, CFG)
        ref = trace_rays(jax.random.key(5), SCENE, SOURCE_OVERNIGHT, 2048,
                         CFG)
        np.testing.assert_array_equal(np.asarray(res.n_bounces),
                                      np.asarray(ref.n_bounces))

    def test_gpu_backend_picks_compiled_kernel(self, monkeypatch):
        """On the GPU backend the kernel is chosen, never interpret mode."""
        calls = []

        def fake(key, scene, source, n_rays, cfg, interpret=False):
            calls.append(interpret)
            return trace_rays(key, scene, source, n_rays, cfg)

        monkeypatch.setattr(trace_pallas, "_on_gpu", lambda: True)
        monkeypatch.setattr(trace_pallas, "trace_rays_pallas", fake)
        for scene in (SCENE, SCENE.with_(exact_rim=True)):
            assert pallas_applicable(scene, CFG)
            trace_rays_fast(jax.random.key(0), scene, SOURCE_OVERNIGHT,
                            1000, CFG)
        assert calls and not any(calls)

    @pytest.mark.parametrize("cfg", [TraceConfig(keep_history=4),
                                     TraceConfig(dtype=jnp.float64)])
    def test_kernel_declines_history_and_f64(self, monkeypatch, cfg):
        monkeypatch.setattr(trace_pallas, "_on_gpu", lambda: True)
        assert not pallas_applicable(SCENE, cfg)

    def test_auto_dispatch_reaches_kernel_on_gpu(self, monkeypatch):
        """trace_rays_auto(engine='simulate') routes to trace_rays_fast
        when the kernel applies."""
        from altair_tpu.core import trace_waves

        seen = []
        monkeypatch.setattr(trace_pallas, "_on_gpu", lambda: True)
        monkeypatch.setattr(
            trace_pallas, "trace_rays_fast",
            lambda *a: seen.append(a[3]) or trace_rays(*a))
        trace_waves.trace_rays_auto(
            jax.random.key(0), SCENE, SOURCE_OVERNIGHT, 512,
            TraceConfig(engine="simulate"))
        assert seen == [512]


class TestStreams:
    def test_same_key_identical(self, pallas_result):
        again = trace_rays_pallas(jax.random.key(0), SCENE, SOURCE_OVERNIGHT,
                                  N, CFG, interpret=True)
        for a, b in zip(jax.tree.leaves(again),
                        jax.tree.leaves(pallas_result)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_different_keys_are_not_lane_permutations(self, pallas_result):
        """key(0) and key(1) differ only in one low data bit: their lane
        streams must be different walks, not the same walks on swapped
        lanes (the sorted bounce counts would then coincide)."""
        other = trace_rays_pallas(jax.random.key(1), SCENE, SOURCE_OVERNIGHT,
                                  N, CFG, interpret=True)
        a = np.asarray(pallas_result.n_bounces)
        b = np.asarray(other.n_bounces)
        assert (a != b).mean() > 0.5
        assert not np.array_equal(np.sort(a), np.sort(b))

    def test_lanes_are_not_shifts_of_each_other(self):
        """Every (lane, bounce, draw) has its own 64-bit counter, so no
        lane's stream is a shifted copy of another's: no two places in
        65536 lanes x 64 draws share a pair of consecutive draws (~0.03
        expected by chance; a single 32-bit counter per draw, lane base +
        draw index, shares ~2000 here)."""
        pairs = _consecutive_pairs(_draw_table(0, 0))
        assert np.unique(pairs).size == pairs.size

    def test_streams_of_two_keys_are_disjoint(self):
        """key(0) and key(1) differ in one key bit: their streams share no
        pair of consecutive draws anywhere."""
        a = _consecutive_pairs(_draw_table(0, 0))
        b = _consecutive_pairs(_draw_table(0, 1))
        assert np.intersect1d(a, b).size == 0


def _draw_table(k0, k1, lanes=1 << 16, bounces=32):
    """u32-valued draws (x 2^24) of ``lanes`` rays over ``bounces``
    two-draw bounces, one row per lane."""
    lane = jnp.arange(lanes, dtype=jnp.uint32)[:, None]
    it = jnp.arange(bounces, dtype=jnp.uint32)[None, :]
    u0, u1 = _sw_uniforms(jnp.uint32(k0), jnp.uint32(k1), lane, it, 2)
    u = np.stack([np.asarray(u0), np.asarray(u1)], axis=-1)
    return (u.reshape(lanes, -1) * (1 << 24)).astype(np.int64)


def _consecutive_pairs(u):
    return ((u[:, :-1] << 24) | u[:, 1:]).ravel()


class TestPallasNonLambertian:
    """SPECULAR, MIXED_BRDF and COS_N_LOBE in the kernel vs the XLA
    scatter laws — interpret mode, identical caps, statistical
    agreement."""

    @pytest.mark.parametrize("model_name",
                             ["SPECULAR", "MIXED_BRDF", "COS_N_LOBE"])
    def test_exit_stats_match_xla(self, model_name):
        scene = SCENE.with_(surface_model=SurfaceModel[model_name])
        res_p = trace_rays_pallas(jax.random.key(4), scene, SOURCE_OVERNIGHT,
                                  N, CFG, interpret=True)
        res_x = trace_rays(jax.random.key(5), scene, SOURCE_OVERNIGHT,
                           N, CFG)
        f_p = int(exit_count(res_p)) / N
        f_x = int(exit_count(res_x)) / N
        sigma = np.sqrt(max(f_x, 1e-3) * (1 - min(f_x, 0.999)) / N)
        assert abs(f_p - f_x) < 5 * sigma * np.sqrt(2), (model_name, f_p,
                                                         f_x)
        b_p = np.asarray(res_p.n_bounces, np.float64)
        b_x = np.asarray(res_x.n_bounces, np.float64)
        se = np.sqrt(b_x.var() / N) * np.sqrt(2)
        assert abs(b_p.mean() - b_x.mean()) < 5 * se, (model_name,
                                                       b_p.mean(),
                                                       b_x.mean())

    def test_specular_exit_direction_profile(self):
        """A specular chamber preserves strong directionality: the exit
        z-direction distribution must agree between kernels (moments)."""
        scene = SCENE.with_(surface_model=SurfaceModel.SPECULAR)
        res_p = trace_rays_pallas(jax.random.key(6), scene, SOURCE_OVERNIGHT,
                                  N, CFG, interpret=True)
        res_x = trace_rays(jax.random.key(7), scene, SOURCE_OVERNIGHT,
                           N, CFG)

        def mu(res):
            m = np.asarray(res.exited_port_mask())
            return np.asarray(res.direction.z)[m], int(m.sum())

        dz_p, n_p = mu(res_p)
        dz_x, n_x = mu(res_x)
        assert n_p > 100 and n_x > 100
        se = np.sqrt(dz_x.var() / min(n_p, n_x)) * np.sqrt(2)
        assert abs(dz_p.mean() - dz_x.mean()) < 5 * se, (dz_p.mean(),
                                                         dz_x.mean())


class TestTritonLowering:
    """Lower the compiled kernel for the CUDA platform (no card needed):
    every primitive must have a Triton-route lowering rule, and the
    program must carry the kernel as a Triton custom call."""

    @pytest.mark.parametrize("model", list(SurfaceModel))
    def test_kernel_lowers_for_cuda(self, model):
        scene = SCENE.with_(surface_model=model, max_bounces=4096)
        text = jax.jit(lambda k: trace_rays_pallas(
            k, scene, SOURCE_OVERNIGHT, 4 * BLOCK)).trace(
                jax.random.key(0)).lower(
                    lowering_platforms=("cuda",)).as_text()
        assert "__gpu$xla.gpu.triton" in text
        assert "altair_bounce" in text


class TestSwUniform:
    # Random123's known-answer vectors for Threefry-2x32, 20 rounds
    @pytest.mark.parametrize("key,ctr,expected", [
        ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
        ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
         (0x1CB996FC, 0xBB002BE7)),
        ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
         (0xC4923A9C, 0x483DF7A0)),
    ])
    def test_threefry_known_answers(self, key, ctr, expected):
        out = _threefry2x32(*(jnp.uint32(v) for v in key + ctr))
        assert tuple(int(w) for w in out) == expected

    def test_distribution_moments(self):
        """The kernel's draws must be a credible U[0,1): moments and range
        checked outside the kernel (plain jnp ops)."""
        lane = jnp.arange(1 << 14, dtype=jnp.uint32)
        draws = np.stack([
            np.asarray(u) for u in _sw_uniforms(
                jnp.uint32(0xDEADBEEF), jnp.uint32(7), lane, jnp.int32(3), 8)
        ])
        assert draws.min() >= 0.0 and draws.max() < 1.0
        assert abs(draws.mean() - 0.5) < 0.005
        assert abs(draws.std() - np.sqrt(1 / 12)) < 0.005
        # draws at different counters are decorrelated
        c = np.corrcoef(draws[0], draws[1])[0, 1]
        assert abs(c) < 0.05
