"""Varying-manual-axes (VMA) annotation helpers for shard_map'd code.

shard_map's static safety check (``check_vma=True``, the default) types every
value with the set of mesh axes it VARIES over. Control-flow carries must
keep one consistent type: a ``while_loop``/``scan`` carry seeded with a
replicated constant (``jnp.zeros`` etc.) whose body output is varying fails
the check. The fix is an explicit ``jax.lax.pcast(..., to="varying")`` on the
init value — these helpers apply it pytree-wide and only to the leaves that
need it (pcast rejects varying->varying). Used by the sharded-tree planner
(parallel/sharded_tree.py, planners/kgmt.py) so the check can stay ON.
Outside shard_map every vma set is empty and all
helpers are no-ops, so shared code paths (ops/rollout.py) can call them
unconditionally.
"""

from __future__ import annotations

import jax


def vma_of(x) -> frozenset:
    """The mesh axes ``x`` varies over (empty outside shard_map)."""
    return frozenset(getattr(jax.typeof(x), "vma", frozenset()))


def pvary_to(tree, axes):
    """Promote every leaf of ``tree`` to vary over ``axes`` (leaves already
    varying over an axis are left alone for that axis)."""
    axes = frozenset(axes)

    def promote(leaf):
        missing = axes - vma_of(leaf)
        if not missing:
            return leaf
        return jax.lax.pcast(leaf, tuple(sorted(missing)), to="varying")

    return jax.tree.map(promote, tree)


def pvary_like(tree, *refs, extra_axes=()):
    """Promote every leaf of ``tree`` to vary over the UNION of the axes the
    reference values vary over (plus ``extra_axes``) — e.g. a scan carry
    init that must match a body output computed from those references. In a
    multi-axis mesh a carry can be varying over SEVERAL axes at once (a
    scenario-sharded problem whose tree is sharded over a second axis), so
    the target is always the full union, not one named axis."""
    axes: frozenset = frozenset(extra_axes)
    for r in refs:
        for leaf in jax.tree.leaves(r):
            axes = axes | vma_of(leaf)
    return pvary_to(tree, axes) if axes else tree
