"""Stream-compaction primitives.

``jnp.nonzero(mask, size=m)`` sits on the deferred-rim pipeline at large N
(XLA lowers it through a full-width cumsum plus an index build).  The
replacement here computes the same first-``size`` indices with a BLOCKED
prefix sum (cumsum along the 1024-lane minor axis of an ``[n/1024, 1024]``
reshape plus a tiny cumsum over block totals) and one int32 scatter whose
indices are strictly increasing (each masked lane's exclusive global
prefix count) — bit-identical output (``tests/test_compact.py``).  It was
the faster form on an earlier build; on the H100 it is not yet
measured against ``jnp.nonzero``.
"""

from __future__ import annotations

import jax.numpy as jnp

_BLOCK = 1024


def _exclusive_ranks(mask):
    """Exclusive prefix count of a boolean vector (each lane's rank among
    the masked lanes), via the blocked cumsum when the vector is large."""
    n = mask.shape[0]
    m32 = mask.astype(jnp.int32)
    if n < 4 * _BLOCK:
        return jnp.cumsum(m32) - m32
    pad = (-n) % _BLOCK
    mp = jnp.concatenate([m32, jnp.zeros((pad,), jnp.int32)]) if pad else m32
    cb = mp.reshape(-1, _BLOCK)
    intra = jnp.cumsum(cb, axis=1)              # inclusive, per block
    tot = intra[:, -1]
    off = jnp.cumsum(tot) - tot                 # exclusive block offsets
    pos = (intra - cb + off[:, None]).reshape(-1)
    return pos[:n] if pad else pos


def nonzero_indices(mask, size: int, fill: int):
    """First ``size`` indices where ``mask`` is True, ascending, padded
    with ``fill`` — exactly ``jnp.nonzero(mask, size=size,
    fill_value=fill)[0]``, via blocked-cumsum + ordered scatter."""
    mask = mask.astype(bool)   # integer masks > 1 would corrupt the ranks
    n = mask.shape[0]
    if n < 4 * _BLOCK:
        return jnp.nonzero(mask, size=size, fill_value=fill)[0]
    # beyond-capacity lanes and unmasked lanes land out of bounds -> drop.
    # No unique/sorted scatter hints: the index vector interleaves the
    # ascending masked-lane positions with the duplicate out-of-bounds
    # `size` for every unmasked lane, so those hints would be UB.
    pos = jnp.where(mask, _exclusive_ranks(mask), size)
    return jnp.full((size,), fill, jnp.int32).at[pos].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop")


def nonzero_indices_grouped(mask, size: int, fill: int, group_capacity: int,
                            group: int = 8):
    """Two-level ``nonzero_indices`` for SPARSE masks.

    The flat version's cost is dominated by a full-width int32 scatter
    (on an earlier build; not yet measured on the H100).  Here the
    lanes are
    grouped by ``group``; level 1 compacts the ``n/group`` group-any flags
    into the first ``group_capacity`` group indices (an 8x-smaller rank +
    scatter), level 2 row-gathers the selected groups' lanes and ranks
    only those ``group_capacity * group`` candidates.

    Returns ``(idx, n_dropped)``:

    * ``idx`` — identical to ``nonzero_indices(mask, size, fill)`` whenever
      ``n_dropped == 0``;
    * ``n_dropped`` — masked lanes lost because MORE than
      ``group_capacity`` groups contain a masked lane (callers fold it
      into their overflow counter; with ``group_capacity >= size`` it can
      be non-zero only when the flat version would overflow ``size`` too).
    """
    mask = mask.astype(bool)
    n = mask.shape[0]
    pad = (-n) % group
    mp = (jnp.concatenate([mask, jnp.zeros((pad,), bool)]) if pad else mask)
    m2 = mp.reshape(-1, group)                             # [ng, group]
    ng = m2.shape[0]
    group_capacity = min(group_capacity, ng)
    gidx = nonzero_indices(m2.any(axis=1), group_capacity, ng)
    gvalid = gidx < ng
    gsafe = jnp.minimum(gidx, ng - 1)
    sub = m2[gsafe] & gvalid[:, None]                      # [gc, group]
    lanes = (gsafe * group)[:, None] + jnp.arange(group, dtype=jnp.int32)
    flat_m = sub.reshape(-1)
    flat_l = lanes.reshape(-1)
    pos = jnp.where(flat_m, _exclusive_ranks(flat_m), size)
    idx = jnp.full((size,), fill, jnp.int32).at[pos].set(
        flat_l, mode="drop")
    n_dropped = (mask.sum(dtype=jnp.int32)
                 - flat_m.sum(dtype=jnp.int32))
    return idx, n_dropped
