"""On-card pins of the compiled bounce kernel — the ``gpu`` tier.

The CPU suite runs the kernel in Pallas' interpret mode
(``test_pallas.py``); these tests run the compiled Triton kernel on an
NVIDIA GPU and compare it with the XLA tracers.  They skip on any other
backend.  On a machine with a card (``--noconftest`` keeps the suite's
CPU-forcing ``conftest.py`` out):

    python -m pytest tests/test_gpu.py --noconftest -q

``chip_smoke.py`` runs the same comparisons at 10^6 rays as part of its
one-card check.
"""

import numpy as np
import pytest

import jax

from altair_tpu import SCENE_OPTIMIZE, SOURCE_OVERNIGHT, TraceConfig
from altair_tpu.config import SurfaceModel

pytestmark = pytest.mark.gpu

# simple-mode scene for the raw kernel (the rim post-pass is XLA code
# validated elsewhere); bounce cap 4096 is exact in practice for rho=0.99
SCENE = SCENE_OPTIMIZE.with_(max_bounces=4096, exact_rim=False)
CFG = TraceConfig()
N = 131_072


@pytest.fixture(scope="module", autouse=True)
def _gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (the compiled Triton kernel)")


def _exit_frac(res, n=N):
    return int(np.asarray(res.exited_port_mask(SCENE.exit_port_z)).sum()) / n


@pytest.mark.parametrize("model", list(SurfaceModel))
def test_kernel_matches_xla(model):
    from scipy.stats import ks_2samp

    from altair_tpu.core.trace import trace_rays
    from altair_tpu.core.trace_pallas import trace_rays_pallas

    sc = SCENE.with_(surface_model=model)
    rk = jax.jit(lambda k: trace_rays_pallas(k, sc, SOURCE_OVERNIGHT, N))(
        jax.random.key(2))
    rx = jax.jit(lambda k: trace_rays(k, sc, SOURCE_OVERNIGHT, N, CFG))(
        jax.random.key(1))
    fk, fx = _exit_frac(rk), _exit_frac(rx)
    sigma = np.sqrt(fx * (1 - fx) / N) * np.sqrt(2)
    assert abs(fk - fx) < 5 * sigma, (fk, fx)
    bk = np.asarray(rk.n_bounces, np.float64)
    bx = np.asarray(rx.n_bounces, np.float64)
    assert abs(bk.mean() - bx.mean()) < 5 * np.sqrt(
        (bk.var() + bx.var()) / N)

    def cos_exit(res):
        m = np.asarray(res.exited_port_mask(SCENE.exit_port_z))
        return -np.asarray(res.direction.z)[m]

    assert ks_2samp(cos_exit(rk), cos_exit(rx)).pvalue > 1e-3


def test_simulate_dispatch_exact_rim_band():
    """trace_rays_auto(engine='simulate') on the production exact-rim
    scene (kernel + deferred rim post-pass) stays in the corpus band."""
    from altair_tpu.core.trace_waves import trace_rays_auto

    scene = SCENE_OPTIMIZE.with_(max_bounces=4096)
    res = jax.jit(lambda k: trace_rays_auto(
        k, scene, SOURCE_OVERNIGHT, N, TraceConfig(engine="simulate")))(
            jax.random.key(4))
    assert 0.418 <= _exit_frac(res) <= 0.433
