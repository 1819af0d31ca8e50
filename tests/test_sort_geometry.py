"""Sort correctness at tile and block boundaries, against the native oracle.

Sizes sit one below, at and one above powers of two and their multiples
(2^11, the 2^17-element block and three such blocks), where any tiled
implementation — XLA's own sort kernels, CUB's radix-sort tiles, or a future
hand-written kernel — changes its number of tiles or leaves a partial one.
Each size runs five key layouts that stress the scatter of a radix pass
differently: random keys (short runs everywhere), all-equal keys (one run per
pass), presorted and reverse-sorted keys (range-correlated runs), and keys
with exactly 16 distinct values that hit all 16 values of every 4-bit digit.
Values carry the input position, so exact equality with the oracle checks
stability too.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from glu_tpu import radix_sort, radix_sort_multi
from glu_tpu.native import get_oracle

SIZES = [2047, 2048, 2049, 131071, 131072, 131073, 3 * 131072 - 1, 3 * 131072 + 1]
LAYOUTS = ["random", "all_equal", "presorted", "reverse", "sixteen_digits"]


def _keys(layout: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if layout == "random":
        return rng.integers(0, 1 << 32, n, dtype=np.uint32)
    if layout == "all_equal":
        return np.full(n, 0xCAFEBABE, dtype=np.uint32)
    if layout == "presorted":
        return np.sort(rng.integers(0, 1 << 32, n, dtype=np.uint32))
    if layout == "reverse":
        return np.sort(rng.integers(0, 1 << 32, n, dtype=np.uint32))[::-1].copy()
    # d * 0x11111111 repeats digit d in all eight 4-bit positions
    return (rng.integers(0, 16, n, dtype=np.uint32) * np.uint32(0x11111111)).astype(np.uint32)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n", SIZES)
def test_sort_geometry(n, layout, call_mode):
    keys = _keys(layout, n, seed=n)
    vals = np.arange(n, dtype=np.uint32)
    got_k, got_v = call_mode(radix_sort, jnp.asarray(keys), jnp.asarray(vals))
    want_k, want_v = get_oracle().radix_sort_kv(keys, vals)
    np.testing.assert_array_equal(np.asarray(got_k), want_k)
    np.testing.assert_array_equal(np.asarray(got_v), want_v)


@pytest.mark.parametrize("num_steps", [1, 3])
@pytest.mark.parametrize("n", [2049, 131073])
def test_sort_geometry_partial_steps(n, num_steps, call_mode):
    # after k passes the pairs are stably sorted by the low 4k key bits
    keys = _keys("random", n, seed=n + num_steps)
    vals = np.arange(n, dtype=np.uint32)
    got_k, got_v = call_mode(
        radix_sort, jnp.asarray(keys), jnp.asarray(vals), num_steps=num_steps
    )
    want_k, want_v = get_oracle().radix_sort_kv(keys, vals, num_steps=num_steps)
    np.testing.assert_array_equal(np.asarray(got_k), want_k)
    np.testing.assert_array_equal(np.asarray(got_v), want_v)


@pytest.mark.parametrize("num_payloads", [0, 2, 3])
def test_sort_geometry_payloads(num_payloads, call_mode):
    # N payload streams permuted identically at a size one below a block
    n = 131071
    rng = np.random.default_rng(41 + num_payloads)
    keys = _keys("sixteen_digits", n, seed=num_payloads)
    payloads = tuple(
        rng.integers(0, 1 << 32, n, dtype=np.uint32) for _ in range(num_payloads)
    )
    got_k, got_ps = call_mode(
        radix_sort_multi, jnp.asarray(keys), tuple(jnp.asarray(p) for p in payloads)
    )
    want_k, perm = get_oracle().radix_sort_kv(keys, np.arange(n, dtype=np.uint32))
    np.testing.assert_array_equal(np.asarray(got_k), want_k)
    assert len(got_ps) == num_payloads
    for p, g in zip(payloads, got_ps):
        np.testing.assert_array_equal(np.asarray(g), p[perm])
