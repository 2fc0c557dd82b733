"""altair_tpu — Monte-Carlo integrating-sphere photon tracer in JAX, run on
NVIDIA GPUs.

A brand-new JAX/XLA framework with the capabilities of the ALTAIR
integrating-sphere raytracing study (reference: bdagnillo/altair-raytracing —
ROOT/ROBAST C++ macros + Python analysis).  See SURVEY.md at the repo root
for the reference's structural analysis this build follows.
"""

from .config import (  # noqa: F401
    SCENE_DEMO,
    SCENE_INSPHERE,
    SCENE_OPTIMIZE,
    SCENE_V1,
    SOURCE_DEMO,
    SOURCE_OVERNIGHT,
    SOURCE_V1,
    DetectorGrid,
    SphereScene,
    Source,
    SurfaceModel,
    TraceConfig,
)
from .core import TraceResult, Vec3, exit_count, trace_rays, trace_rays_jit  # noqa: F401

__version__ = "0.1.0"
