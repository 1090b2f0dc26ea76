"""Segment reductions replacing the reference's atomic region statistics.

The reference updates R1/R2 counters with ``atomicAdd``/``atomicExch`` from
every rollout thread (KGMT.cu:392-410, 460-478) — a racy surface it never
sanitizes. Here the same histogram is a scatter-add, which XLA lowers to a
deterministic segmented reduction; "availability" flags become a
scatter-max (idempotent OR). Cells indexed -1 (out of grid) are dropped — the
reference instead performs out-of-bounds atomics (UB; SURVEY.md §2.4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def masked_bincount(indices: Array, valid: Array, num: int) -> Array:
    """Count valid entries per cell. indices int32 [B] (may contain -1),
    valid bool [B], returns int32 [num]."""
    ok = valid & (indices >= 0)
    safe = jnp.where(ok, indices, num)  # out-of-bounds -> dropped
    return jnp.zeros(num, jnp.int32).at[safe].add(ok.astype(jnp.int32), mode="drop")


def masked_multi_bincount(indices: Array, vals: Array, num: int) -> Array:
    """Histogram several integer columns in ONE scatter-add.

    indices int32 [B] (may contain -1 = dropped); vals int32 [B, C] column
    values to accumulate per cell. Returns int32 [num, C]. One scatter kernel
    instead of C, for per-cell (touched, valid) counter pairs.
    """
    ok = indices >= 0
    safe = jnp.where(ok, indices, num)
    return jnp.zeros((num, vals.shape[-1]), jnp.int32).at[safe].add(
        vals * ok[:, None].astype(vals.dtype), mode="drop"
    )


def scatter_or(flags: Array, indices: Array, valid: Array) -> Array:
    """OR ``valid`` into int flags at ``indices`` (replaces atomicExch(...,1)).

    flags int32 [num]; indices int32 [B] (may contain -1); valid bool [B].
    """
    num = flags.shape[0]
    ok = valid & (indices >= 0)
    safe = jnp.where(ok, indices, num)
    return flags.at[safe].max(ok.astype(flags.dtype), mode="drop")
