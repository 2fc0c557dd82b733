"""Test harness configuration.

Forces the CPU backend with 8 virtual devices so the sharding/multi-chip
tests run anywhere (SURVEY.md §4.6: the fake multi-chip backend).  The
config is forced after jax import but before backend initialisation (this
file is imported before any test module).  Tests that need a GPU are
marked ``gpu`` and skip here; ``chip_smoke.py`` runs the path they cover
on the card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)

# Free compiled programs between test modules: a single pytest process
# accumulates hundreds of live XLA:CPU executables across the suite, and
# past ~250 programs the NEXT compilation segfaults inside
# backend_compile_and_load (deterministic at tests/test_trace_direct.py::
# test_recursive_hybrid_consistent_across_buffer_sizes when quick+medium
# run combined; each tier alone is fine).  Dropping caches per module
# bounds the live-executable count; with the persistent compile cache
# below, cross-module re-uses come back as cheap AOT loads.
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    yield
    jax.clear_caches()
    from altair_tpu.core.memo import clear_memo

    clear_memo()


# Persistent XLA compilation cache: suite runtime is dominated by CPU
# compiles, and the cache key is the optimized HLO, so code changes
# invalidate exactly the programs they touch.  JAX_COMPILATION_CACHE_DIR
# wins when set; otherwise the fixed in-checkout directory
# (altair_tpu/compile_cache.py).  Same-machine AOT loads may log a benign
# feature-mismatch E-line; correctness is unaffected.
from altair_tpu.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
