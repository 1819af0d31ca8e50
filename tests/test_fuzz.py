"""Seeded randomized sort/scan/reduce-vs-oracle fuzz.

The fixed-size suites mirror the reference's tests; this adds breadth:
random lengths (including awkward paddings near tile/block boundaries),
random key distributions, random partial num_steps, random partition
counts — every case checked against the native C++ oracle (itself
verified in test_native_oracle.py). Seeds are fixed, so failures are
reproducible by trial number.
"""

import numpy as np
import pytest

from glu_tpu import (
    ReduceOperator,
    exclusive_scan,
    radix_sort,
    reduce,
)
from glu_tpu.native import get_oracle

import jax.numpy as jnp

_OPS = ["sum", "mul", "min", "max"]
_ENUM = {
    "sum": ReduceOperator.SUM,
    "mul": ReduceOperator.MUL,
    "min": ReduceOperator.MIN,
    "max": ReduceOperator.MAX,
}


def _keys(rng, n):
    """Random keys from a randomly chosen distribution."""
    kind = rng.integers(0, 5)
    if kind == 0:
        return rng.integers(0, 1 << 32, n, dtype=np.uint32)
    if kind == 1:  # low entropy
        return rng.integers(0, max(int(rng.integers(1, 8)), 1), n, dtype=np.uint32)
    if kind == 2:  # pre-sorted
        return np.sort(rng.integers(0, 1 << 32, n, dtype=np.uint32))
    if kind == 3:  # reverse-sorted
        return np.sort(rng.integers(0, 1 << 32, n, dtype=np.uint32))[::-1].copy()
    return np.full(n, rng.integers(0, 1 << 32), dtype=np.uint32)  # constant


@pytest.mark.parametrize("trial", range(12))
def test_fuzz_sort(trial, call_mode):
    rng = np.random.default_rng(1000 + trial)
    n = int(rng.integers(1, 8193))
    steps = int(rng.integers(1, 9))
    k = _keys(rng, n)
    v = np.arange(n, dtype=np.uint32)
    gk, gv = call_mode(radix_sort, jnp.asarray(k), jnp.asarray(v), num_steps=steps)
    ek, ev = get_oracle().radix_sort_kv(k, v, num_steps=steps)
    np.testing.assert_array_equal(np.asarray(gk), ek)
    np.testing.assert_array_equal(np.asarray(gv), ev)


@pytest.mark.parametrize("trial", range(8))
def test_fuzz_scan(trial, call_mode):
    rng = np.random.default_rng(2000 + trial)
    parts = int(rng.choice([1, 1, 2, 3, 8, 17]))
    part_len = int(rng.integers(1, 4097))
    n = parts * part_len
    op = _OPS[int(rng.integers(0, 4))]
    x = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    got = np.asarray(call_mode(exclusive_scan, jnp.asarray(x), num_partitions=parts, op=_ENUM[op]))
    exp = get_oracle().exclusive_scan_op(x, parts, op)
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("trial", range(6))
def test_fuzz_reduce(trial, call_mode):
    rng = np.random.default_rng(3000 + trial)
    n = int(rng.integers(1, 100_001))
    op = _OPS[int(rng.integers(0, 4))]
    x = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    got = np.asarray(call_mode(reduce, jnp.asarray(x), op=_ENUM[op]))
    exp = get_oracle().reduce_u32(x, op)
    assert got == exp, (n, op)


@pytest.mark.parametrize("trial", range(8))
def test_fuzz_sort_multi(trial, call_mode):
    """Multi-stream sort fuzz: 0-3 payload streams permuted identically,
    random lengths/distributions/steps, vs the oracle's kv permutation."""
    from glu_tpu import radix_sort_multi

    rng = np.random.default_rng(5000 + trial)
    n = int(rng.integers(1, 8193))
    steps = int(rng.integers(1, 9))
    ns = int(rng.integers(0, 4))
    k = _keys(rng, n)
    payloads = tuple(
        rng.integers(0, 1 << 32, n, dtype=np.uint32) for _ in range(ns)
    )
    gk, gvs = call_mode(
        radix_sort_multi, jnp.asarray(k), tuple(jnp.asarray(p) for p in payloads),
        num_steps=steps,
    )
    idx = np.arange(n, dtype=np.uint32)
    ek, perm = get_oracle().radix_sort_kv(k, idx, num_steps=steps)
    np.testing.assert_array_equal(np.asarray(gk), ek)
    assert len(gvs) == ns
    for p, g in zip(payloads, gvs):
        np.testing.assert_array_equal(np.asarray(g), p[perm])


@pytest.mark.parametrize("trial", range(6))
def test_fuzz_dist_chunked(trial):
    """Chunked-pipeline distributed sort fuzz on the 8-device CPU mesh:
    random chunk counts and key distributions vs numpy stable argsort."""
    import jax

    from glu_tpu.parallel import distributed_radix_sort, make_sort_mesh

    rng = np.random.default_rng(7000 + trial)
    d = min(8, len(jax.devices()))  # a GPU run may have fewer devices
    per = int(rng.integers(1, 5)) * 256
    chunks = int(rng.choice([1, 2, 4]))
    n = d * per
    k = _keys(rng, n)
    v = np.arange(n, dtype=np.uint32)
    mesh = make_sort_mesh(jax.devices()[:d])
    sh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("shards"))
    ok, ov, counts, overflow = distributed_radix_sort(
        jax.device_put(jnp.asarray(k), sh),
        jax.device_put(jnp.asarray(v), sh),
        mesh,
        pipeline_chunks=chunks,
    )
    assert int(np.asarray(overflow)[0]) == 0
    ok, ov, counts = map(np.asarray, (ok, ov, counts))
    padded = ok.shape[0] // d
    gk = np.concatenate([ok[i * padded : i * padded + counts[i]] for i in range(d)])
    gv = np.concatenate([ov[i * padded : i * padded + counts[i]] for i in range(d)])
    order = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(gk, k[order])
    np.testing.assert_array_equal(gv, order.astype(np.uint32))


def _check_compact_order(k, v, positions, gk, gv):
    """Result must be the stable sort by the compact key of `positions`."""
    comp = np.zeros(k.size, np.uint64)
    for j, p in enumerate(positions):
        comp |= ((k.astype(np.uint64) >> p) & 1) << np.uint64(j)
    order = np.argsort(comp, kind="stable")
    np.testing.assert_array_equal(np.asarray(gk), k[order])
    np.testing.assert_array_equal(np.asarray(gv), v[order])


@pytest.mark.parametrize("trial", range(0, 10, 2))
def test_fuzz_adaptive_bits(trial, call_mode):
    """Random explicit bit subsets (contiguous and sparse, size 1..32)
    against a host oracle of the compact key — breadth for the bit-pruned
    path beyond the fixed cases in test_adaptive_sort."""
    rng = np.random.default_rng(4000 + trial)
    n = int(rng.integers(2, 8193))
    nbits = int(rng.integers(1, 33))
    positions = tuple(sorted(rng.choice(32, size=nbits, replace=False).tolist()))
    k = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    v = np.arange(n, dtype=np.uint32)
    gk, gv = call_mode(radix_sort, jnp.asarray(k), jnp.asarray(v), bits=positions)
    _check_compact_order(k, v, positions, gk, gv)


@pytest.mark.parametrize("trial", range(1, 10, 2))
def test_fuzz_adaptive_bits_auto(trial):
    """bits="auto" on randomly masked keys (random constant bits, random
    values): the detected set must prune exactly the constant bits."""
    rng = np.random.default_rng(4000 + trial)
    n = int(rng.integers(2, 8193))
    mask = np.uint32(rng.integers(0, 1 << 32, dtype=np.uint64))
    base = np.uint32(rng.integers(0, 1 << 32, dtype=np.uint64)) & ~mask
    k = (rng.integers(0, 1 << 32, n, dtype=np.uint32) & mask) | base
    positions = tuple(b for b in range(32) if (int(mask) >> b) & 1)
    v = np.arange(n, dtype=np.uint32)
    gk, gv = radix_sort(jnp.asarray(k), jnp.asarray(v), bits="auto")
    _check_compact_order(k, v, positions, gk, gv)


@pytest.mark.parametrize("trial", range(8))
def test_fuzz_segmented_offsets(trial, call_mode):
    """Random ragged boundary arrays — random segment counts, duplicate
    boundaries (empty segments), boundary-at-0/n edge shapes, random key
    entropy — against a per-segment stable argsort oracle."""
    rng = np.random.default_rng(7000 + trial)
    n = int(rng.integers(2, 6000))
    s = int(rng.integers(1, 40))
    cuts = np.sort(rng.integers(0, n + 1, s - 1)).astype(np.int32)
    offs = np.concatenate([[0], cuts, [n]]).astype(np.int32)
    lo = int(rng.integers(1, 1 << 32))
    k = rng.integers(0, lo, n, dtype=np.uint32)  # random entropy incl. dups
    v = np.arange(n, dtype=np.uint32)
    from glu_tpu import radix_sort_segmented

    gk, gv = call_mode(
        radix_sort_segmented, jnp.asarray(k), jnp.asarray(v), offsets=jnp.asarray(offs)
    )
    gk, gv = np.asarray(gk), np.asarray(gv)
    for i in range(len(offs) - 1):
        seg = slice(int(offs[i]), int(offs[i + 1]))
        order = np.argsort(k[seg], kind="stable") + int(offs[i])
        np.testing.assert_array_equal(gk[seg], k[order])
        np.testing.assert_array_equal(gv[seg], order.astype(np.uint32))
