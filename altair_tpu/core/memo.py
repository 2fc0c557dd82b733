"""Compiled-program memoization for driver-layer entry points.

Driver functions (sweep drivers, the mesh layer) build their jitted
closures inside the call, so every invocation hands JAX a NEW Python
callable and the jit cache — keyed on function identity — misses:
back-to-back identical sweeps re-trace and re-COMPILE the full program
(tens of seconds for the direct+deferred-rim engine).  Memoizing the BUILDER on its
static configuration restores the once-per-config compile the reference
got from ACLiC caching its compiled macro ``.so`` (SURVEY.md §2.2).

Keys rely on the frozen-dataclass hashes of scene/source/cfg/grid (all
hashable when their fields are Python numbers) and on
``jax.sharding.Mesh``'s hash; unhashable keys (stacked scenes with array
leaves, explicit array placements, callable scatter hooks with ad-hoc
state) fall back to building fresh — correctness never depends on a
cache hit.
"""

from __future__ import annotations

import functools
import os

__all__ = ["memo_program", "clear_memo", "MEMO_CAPACITY"]

_REGISTRY = []

# Per-builder LRU bound.  Cached programs pin live compiled executables,
# and XLA:CPU deterministically crashes past ~250 live executables in one
# process (tests/conftest.py) — an unbounded cache in a long-lived sweep
# service would walk into that.  16 distinct configurations per driver
# covers every workflow in the repo (sweeps reuse ONE program across rows);
# ALTAIR_MEMO_CAPACITY overrides for unusual many-config services.
MEMO_CAPACITY = int(os.environ.get("ALTAIR_MEMO_CAPACITY", 16))


def memo_program(builder):
    """Memoize ``builder(*static_args)`` on its (hashable) arguments,
    keeping at most ``MEMO_CAPACITY`` programs per builder (LRU)."""
    cache = {}

    @functools.wraps(builder)
    def get(*key):
        try:
            hit = cache.get(key)
        except TypeError:            # unhashable static: no caching
            return builder(*key)
        if hit is None:
            hit = builder(*key)
            while len(cache) >= max(1, MEMO_CAPACITY):
                cache.pop(next(iter(cache)))   # evict least-recent
            cache[key] = hit
        else:
            # refresh recency (dict preserves insertion order)
            del cache[key]
            cache[key] = hit
        return hit

    get.cache = cache
    _REGISTRY.append(cache)
    return get


def clear_memo():
    """Drop every memoized program (their jitted closures pin compiled
    executables; long-lived processes — the test suite — clear between
    workloads to bound live-executable count)."""
    for cache in _REGISTRY:
        cache.clear()
