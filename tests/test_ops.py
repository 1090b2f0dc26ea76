"""Compaction and segment-reduction unit tests (replacements for thrust scans
and CUDA atomics — SURVEY.md §2.3 P2/P3)."""

import jax
import jax.numpy as jnp
import numpy as np

from cudasbmp_jax.ops.compaction import compact_indices
from cudasbmp_jax.ops.segments import masked_bincount, scatter_or


def test_compact_indices_basic():
    mask = jnp.array([False, True, False, True, True, False])
    idx, count = compact_indices(mask)
    assert int(count) == 3
    np.testing.assert_array_equal(np.array(idx)[:3], [1, 3, 4])


def test_compact_indices_empty_and_full():
    idx, count = compact_indices(jnp.zeros(8, bool))
    assert int(count) == 0
    idx, count = compact_indices(jnp.ones(8, bool))
    assert int(count) == 8
    np.testing.assert_array_equal(np.array(idx), np.arange(8))


def test_compact_indices_random(rng):
    mask = rng.random(1000) < 0.3
    idx, count = compact_indices(jnp.asarray(mask))
    want = np.nonzero(mask)[0]
    assert int(count) == len(want)
    np.testing.assert_array_equal(np.array(idx)[: len(want)], want)


def test_compact_under_jit():
    @jax.jit
    def f(mask):
        return compact_indices(mask)

    idx, count = f(jnp.array([True, False, True]))
    assert int(count) == 2
    np.testing.assert_array_equal(np.array(idx)[:2], [0, 2])


def test_masked_bincount_drops_negative_and_invalid():
    indices = jnp.array([0, 1, 1, -1, 2, 2])
    valid = jnp.array([True, True, True, True, False, True])
    counts = masked_bincount(indices, valid, 4)
    np.testing.assert_array_equal(np.array(counts), [1, 2, 1, 0])


def test_masked_bincount_vs_numpy(rng):
    n = 64
    indices = rng.integers(-1, n, size=5000)
    valid = rng.random(5000) < 0.7
    got = np.array(masked_bincount(jnp.asarray(indices), jnp.asarray(valid), n))
    want = np.bincount(indices[valid & (indices >= 0)], minlength=n)
    np.testing.assert_array_equal(got, want)


def test_masked_multi_bincount_matches_separate(rng):
    """The packed 2-column histogram equals per-column masked_bincounts."""
    from cudasbmp_jax.ops.segments import masked_multi_bincount

    n = 64
    indices = rng.integers(-1, n, size=5000)
    active = rng.random(5000) < 0.9
    valid = active & (rng.random(5000) < 0.6)
    vals = jnp.stack([jnp.asarray(active, jnp.int32),
                      jnp.asarray(valid, jnp.int32)], axis=-1)
    d = np.array(masked_multi_bincount(jnp.asarray(indices), vals, n))
    np.testing.assert_array_equal(
        d[:, 0], np.array(masked_bincount(jnp.asarray(indices),
                                          jnp.asarray(active), n)))
    np.testing.assert_array_equal(
        d[:, 1], np.array(masked_bincount(jnp.asarray(indices),
                                          jnp.asarray(valid), n)))


def test_scatter_or():
    flags = jnp.array([0, 1, 0, 0], jnp.int32)
    out = scatter_or(flags, jnp.array([2, -1, 0]), jnp.array([True, True, False]))
    np.testing.assert_array_equal(np.array(out), [0, 1, 1, 0])
