"""Radix sort tests — mirrors reference test/radix_sort_tests.cpp
(check_permutation + check_sorted over the same size classes) and closes the
gaps SURVEY §4 flags: the reference never checks values or stability
(radix_sort_tests.cpp note: vals zero-filled); here values carry the original
index so stability and the key/value pairing are both asserted, and
pre-sorted / reverse-sorted / low-entropy inputs (BASELINE.json configs) are
exercised."""

import jax.numpy as jnp
import numpy as np
import pytest

from glu_tpu import DeviceBuffer, RadixSort, radix_sort, radix_sort_keys


def check_permutation(original: np.ndarray, result: np.ndarray):
    # analog of reference check_permutation (radix_sort_tests.cpp:20-43):
    # value-histogram equality
    a, b = np.sort(original), np.sort(result)
    np.testing.assert_array_equal(a, b)


def check_sorted(keys: np.ndarray):
    # analog of reference check_sorted (radix_sort_tests.cpp:45-51)
    assert np.all(keys[:-1] <= keys[1:])


def check_stable_pairs(in_keys: np.ndarray, out_keys: np.ndarray, out_vals: np.ndarray):
    """Full contract: out equals a stable sort of (key, index) pairs."""
    order = np.argsort(in_keys, kind="stable")
    np.testing.assert_array_equal(out_keys, in_keys[order])
    np.testing.assert_array_equal(out_vals, order.astype(np.uint32))


def _run_sort(keys: np.ndarray, call_mode, num_steps: int = 0):
    vals = np.arange(keys.size, dtype=np.uint32)
    out_k, out_v = call_mode(
        radix_sort, jnp.asarray(keys), jnp.asarray(vals), num_steps=num_steps
    )
    return np.asarray(out_k), np.asarray(out_v)


@pytest.mark.parametrize("size", [128, 256, 512, 1024])
def test_sort_small_pow2(size, call_mode, seeded_rng):
    # analog of RadixSort-128-256-512-1024 (radix_sort_tests.cpp:88-110)
    rng = seeded_rng(1)
    keys = rng.sample_int_vector(size, 0, 0xFFFFFFFE)
    out_k, out_v = _run_sort(keys, call_mode)
    check_permutation(keys, out_k)
    check_sorted(out_k)
    check_stable_pairs(keys, out_k, out_v)


def test_sort_low_entropy(call_mode, seeded_rng):
    # analog of RadixSort-2048 (radix_sort_tests.cpp:112-134): keys in [0,10)
    # — duplicate-heavy, the stability stress case
    rng = seeded_rng(2)
    keys = rng.sample_int_vector(2048, 0, 9)
    out_k, out_v = _run_sort(keys, call_mode)
    check_sorted(out_k)
    check_stable_pairs(keys, out_k, out_v)


@pytest.mark.parametrize("size", [10993, 16447, 20771, 33377, 47487])
def test_sort_odd_sizes(size, call_mode, seeded_rng):
    # analog of RadixSort-multiple-sizes (radix_sort_tests.cpp:136-158):
    # odd non-power-of-2 sizes, full-range keys
    rng = seeded_rng(size)
    keys = rng.sample_int_vector(size, 0, 0xFFFFFFFE)
    out_k, out_v = _run_sort(keys, call_mode)
    check_permutation(keys, out_k)
    check_sorted(out_k)
    check_stable_pairs(keys, out_k, out_v)


@pytest.mark.parametrize("kind", ["presorted", "reverse", "constant"])
def test_sort_adversarial_orders(kind, call_mode):
    # BASELINE.json configs: pre-sorted, reverse, low-entropy
    n = 8192
    if kind == "presorted":
        keys = np.arange(n, dtype=np.uint32)
    elif kind == "reverse":
        keys = np.arange(n, dtype=np.uint32)[::-1].copy()
    else:
        keys = np.full(n, 0xDEADBEEF, dtype=np.uint32)
    out_k, out_v = _run_sort(keys, call_mode)
    check_sorted(out_k)
    check_stable_pairs(keys, out_k, out_v)


@pytest.mark.parametrize("num_steps", [1, 2, 4, 7])
def test_sort_partial_steps(num_steps, call_mode, seeded_rng):
    # the reference's num_steps debugging affordance (RadixSort.hpp:273,332):
    # after k passes, pairs are stably sorted by the low 4k key bits
    rng = seeded_rng(7)
    keys = rng.sample_int_vector(4096, 0, 0xFFFFFFFE)
    out_k, out_v = _run_sort(keys, call_mode, num_steps)
    mask = np.uint32((1 << (4 * num_steps)) - 1)
    order = np.argsort(keys & mask, kind="stable")
    np.testing.assert_array_equal(out_k, keys[order])
    np.testing.assert_array_equal(out_v, order.astype(np.uint32))


def test_sort_tiny_counts(call_mode):
    # count <= 1 early-exits (reference RadixSort.hpp:278-279)
    k0, v0 = call_mode(radix_sort, jnp.zeros(0, jnp.uint32), jnp.zeros(0, jnp.uint32))
    assert k0.shape == (0,)
    k1, v1 = call_mode(
        radix_sort, jnp.array([5], jnp.uint32), jnp.array([9], jnp.uint32)
    )
    assert int(k1[0]) == 5 and int(v1[0]) == 9
    k2, v2 = _run_sort(np.array([2, 1], dtype=np.uint32), call_mode)
    np.testing.assert_array_equal(k2, [1, 2])
    np.testing.assert_array_equal(v2, [1, 0])


def test_sort_keys_only(call_mode, seeded_rng):
    rng = seeded_rng(11)
    keys = rng.sample_int_vector(5000, 0, 0xFFFFFFFE)
    out = np.asarray(call_mode(radix_sort_keys, jnp.asarray(keys)))
    check_permutation(keys, out)
    check_sorted(out)


def test_sort_extreme_keys(call_mode):
    # keys at the u32 extremes, all 8 digit positions exercised
    keys = np.array(
        [0xFFFFFFFF, 0, 0x80000000, 0x7FFFFFFF, 1, 0xFFFFFFFE, 0x00010000, 0xF0F0F0F0],
        dtype=np.uint32,
    )
    out_k, out_v = _run_sort(keys, call_mode)
    check_sorted(out_k)
    check_stable_pairs(keys, out_k, out_v)


def test_sort_class_in_place(seeded_rng):
    # reference call shape: RadixSort()(key_buffer, val_buffer, count)
    # sorts in place via ping-pong landing back in the user's buffers
    rng = seeded_rng(3)
    keys = rng.sample_int_vector(3000, 0, 0xFFFFFFFE)
    vals = np.arange(3000, dtype=np.uint32)
    kbuf, vbuf = DeviceBuffer(keys), DeviceBuffer(vals)
    sorter = RadixSort()
    sorter.prepare_internal_buffers(3000)
    sorter(kbuf, vbuf, 3000)
    check_stable_pairs(keys, kbuf.get_data(), vbuf.get_data())


def test_sort_class_count_subset(seeded_rng):
    # sorting only the first `count` pairs of larger buffers
    rng = seeded_rng(4)
    keys = rng.sample_int_vector(100, 0, 1000)
    vals = np.arange(100, dtype=np.uint32)
    kbuf, vbuf = DeviceBuffer(keys), DeviceBuffer(vals)
    RadixSort()(kbuf, vbuf, 60)
    check_stable_pairs(keys[:60], kbuf.get_data()[:60], vbuf.get_data()[:60])
    np.testing.assert_array_equal(kbuf.get_data()[60:], keys[60:])


def test_sort_f32_keys(call_mode, seeded_rng):
    # beyond-reference extension: f32 keys via the order-preserving u32
    # bijection (negatives, zeros, infs all in IEEE total order)
    from glu_tpu import radix_sort_f32

    rng = seeded_rng(21)
    keys = np.concatenate([
        rng.rng.uniform(-1e9, 1e9, 4000).astype(np.float32),
        np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45], dtype=np.float32),
    ])
    vals = np.arange(keys.size, dtype=np.uint32)
    out_k, out_v = call_mode(radix_sort_f32, jnp.asarray(keys), jnp.asarray(vals))
    out_k, out_v = np.asarray(out_k), np.asarray(out_v)
    # oracle in IEEE-754 TOTAL order (numpy argsort treats -0.0 == +0.0;
    # the documented contract is total order, where -0.0 < +0.0): apply the
    # same monotone bijection and stably sort the u32 images
    u = keys.view(np.uint32)
    tot = np.where(u >> 31 == 1, u ^ np.uint32(0xFFFFFFFF), u ^ np.uint32(0x80000000))
    order = np.argsort(tot, kind="stable")
    np.testing.assert_array_equal(out_k.view(np.uint32), keys[order].view(np.uint32))
    np.testing.assert_array_equal(out_v, order.astype(np.uint32))


def test_sort_i32_keys(call_mode, seeded_rng):
    # beyond-reference extension: signed i32 keys via the order-preserving
    # sign-bit flip (INT32_MIN .. INT32_MAX in signed order)
    from glu_tpu import radix_sort_i32

    rng = seeded_rng(55)
    keys = np.concatenate([
        rng.rng.integers(-(1 << 31), 1 << 31, 4000).astype(np.int32),
        np.array([0, -1, 1, -(1 << 31), (1 << 31) - 1], dtype=np.int32),
    ])
    keys[::11] = keys[1]  # duplicates (stability must break ties by index)
    vals = np.arange(keys.size, dtype=np.uint32)
    out_k, out_v = call_mode(radix_sort_i32, jnp.asarray(keys), jnp.asarray(vals))
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(out_k), keys[order])
    np.testing.assert_array_equal(np.asarray(out_v), order.astype(np.uint32))


def test_sort_i32_descending(call_mode, seeded_rng):
    from glu_tpu import radix_sort_i32

    rng = seeded_rng(56)
    keys = rng.rng.integers(-1000, 1000, 3000).astype(np.int32)
    vals = np.arange(keys.size, dtype=np.uint32)
    out_k, out_v = call_mode(
        radix_sort_i32, jnp.asarray(keys), jnp.asarray(vals), descending=True
    )
    order = np.argsort(-keys.astype(np.int64), kind="stable")
    np.testing.assert_array_equal(np.asarray(out_k), keys[order])
    np.testing.assert_array_equal(np.asarray(out_v), order.astype(np.uint32))


def test_sort_u64_parts(call_mode, seeded_rng):
    # beyond-reference extension: 64-bit keys as (hi, lo) u32 halves via two
    # chained stable 32-bit sorts (LSD composition)
    from glu_tpu import radix_sort_u64_parts

    rng = seeded_rng(31)
    n = 5000
    hi = rng.sample_int_vector(n, 0, 2**32 - 1)
    # duplicate-heavy high words so the low-word pass's stability matters
    hi[: n // 2] = hi[0]
    lo = rng.sample_int_vector(n, 0, 2**32 - 1)
    vals = np.arange(n, dtype=np.uint32)
    oh, ol, ov = call_mode(
        radix_sort_u64_parts, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(vals)
    )
    oh, ol, ov = np.asarray(oh), np.asarray(ol), np.asarray(ov)
    full = hi.astype(np.uint64) << np.uint64(32) | lo.astype(np.uint64)
    order = np.argsort(full, kind="stable")
    np.testing.assert_array_equal(oh, hi[order])
    np.testing.assert_array_equal(ol, lo[order])
    np.testing.assert_array_equal(ov, order.astype(np.uint32))


def test_sort_u64(call_mode, seeded_rng):
    # u64 dtype form (conftest enables x64 by default; without it use
    # radix_sort_u64_parts)
    import jax

    if not jax.config.jax_enable_x64:
        pytest.skip("u64 dtype requires jax_enable_x64")
    from glu_tpu import radix_sort_u64

    rng = seeded_rng(32)
    n = 3000
    keys = (
        rng.sample_int_vector(n, 0, 2**32 - 1).astype(np.uint64) << np.uint64(32)
    ) | rng.sample_int_vector(n, 0, 2**32 - 1).astype(np.uint64)
    keys[n // 2 :] = keys[: n - n // 2]  # duplicates across the array
    vals = np.arange(n, dtype=np.uint32)
    out_k, out_v = call_mode(radix_sort_u64, jnp.asarray(keys), jnp.asarray(vals))
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(out_k), keys[order])
    np.testing.assert_array_equal(np.asarray(out_v), order.astype(np.uint32))


def test_sort_descending(call_mode, seeded_rng):
    rng = seeded_rng(33)
    keys = rng.sample_int_vector(4000, 0, 100)  # duplicate-heavy: stability visible
    vals = np.arange(keys.size, dtype=np.uint32)
    out_k, out_v = call_mode(
        radix_sort, jnp.asarray(keys), jnp.asarray(vals), descending=True
    )
    out_k, out_v = np.asarray(out_k), np.asarray(out_v)
    # stable descending oracle: stable-argsort of complemented keys
    order = np.argsort(~keys, kind="stable")
    np.testing.assert_array_equal(out_k, keys[order])
    np.testing.assert_array_equal(out_v, order.astype(np.uint32))


def test_sort_f32_descending(call_mode, seeded_rng):
    from glu_tpu import radix_sort_f32

    rng = seeded_rng(34)
    keys = rng.rng.uniform(-100, 100, 3000).astype(np.float32)
    keys[::7] = keys[0]  # duplicates
    vals = np.arange(keys.size, dtype=np.uint32)
    out_k, out_v = call_mode(
        radix_sort_f32, jnp.asarray(keys), jnp.asarray(vals), descending=True
    )
    u = keys.view(np.uint32)
    tot = np.where(u >> 31 == 1, u ^ np.uint32(0xFFFFFFFF), u ^ np.uint32(0x80000000))
    order = np.argsort(~tot, kind="stable")
    np.testing.assert_array_equal(np.asarray(out_k).view(np.uint32), keys[order].view(np.uint32))
    np.testing.assert_array_equal(np.asarray(out_v), order.astype(np.uint32))


def test_sort_descending_rejects_partial():
    from glu_tpu.utils.errors import GluArgumentError

    with pytest.raises(GluArgumentError):
        radix_sort(
            jnp.zeros(8, jnp.uint32), jnp.zeros(8, jnp.uint32), 2, descending=True
        )


@pytest.mark.parametrize("num_partitions", [1, 4, 13, 100])
def test_sort_segmented(num_partitions, call_mode, seeded_rng):
    # beyond-reference extension: per-segment stable sort (the sort-side
    # analog of the scan's partition batching, BlellochScan.hpp:125-138),
    # composed as full key sort + partial-pass segment-id sort
    from glu_tpu import radix_sort_segmented

    rng = seeded_rng(47)
    part = 520
    n = part * num_partitions
    keys = rng.sample_int_vector(n, 0, 2**32 - 1)
    keys[: n // 3] = keys[0]  # duplicates so stability matters
    vals = np.arange(n, dtype=np.uint32)
    out_k, out_v = call_mode(
        radix_sort_segmented, jnp.asarray(keys), jnp.asarray(vals),
        num_partitions=num_partitions,
    )
    out_k, out_v = np.asarray(out_k), np.asarray(out_v)
    for s in range(num_partitions):
        seg = slice(s * part, (s + 1) * part)
        order = np.argsort(keys[seg], kind="stable") + s * part
        np.testing.assert_array_equal(out_k[seg], keys[order])
        np.testing.assert_array_equal(out_v[seg], order.astype(np.uint32))


def test_sort_segmented_rejects_bad_partitions():
    from glu_tpu import radix_sort_segmented
    from glu_tpu.utils.errors import GluArgumentError

    with pytest.raises(GluArgumentError):
        radix_sort_segmented(
            jnp.zeros(10, jnp.uint32), jnp.zeros(10, jnp.uint32), 3
        )


def _check_segmented_offsets(keys, vals, offs, call_mode):
    from glu_tpu import radix_sort_segmented

    out_k, out_v = call_mode(
        radix_sort_segmented, jnp.asarray(keys), jnp.asarray(vals), offsets=jnp.asarray(offs)
    )
    out_k, out_v = np.asarray(out_k), np.asarray(out_v)
    for s in range(len(offs) - 1):
        seg = slice(int(offs[s]), int(offs[s + 1]))
        order = np.argsort(keys[seg], kind="stable") + int(offs[s])
        np.testing.assert_array_equal(out_k[seg], keys[order])
        np.testing.assert_array_equal(out_v[seg], vals[order])


@pytest.mark.parametrize("num_segments", [1, 2, 7, 64, 300])
def test_sort_segmented_offsets_ragged(num_segments, call_mode, seeded_rng):
    # variable-length segments (CUB begin/end-offsets style) — the form
    # real ragged workloads use; the reference has no segmented sort at all
    rng = seeded_rng(53 + num_segments)
    n = 4000
    cuts = np.sort(rng.sample_int_vector(num_segments - 1, 0, n).astype(np.int64))
    offs = np.concatenate([[0], cuts, [n]]).astype(np.int32)
    keys = rng.sample_int_vector(n, 0, 2**32 - 1)
    keys[: n // 3] = keys[0]  # duplicates so stability matters
    vals = np.arange(n, dtype=np.uint32)
    _check_segmented_offsets(keys, vals, offs, call_mode)


def test_sort_segmented_offsets_empty_and_singleton(call_mode, seeded_rng):
    # adversarial boundaries: empty first/middle/last segments, singletons,
    # and one segment holding most of the data
    rng = seeded_rng(99)
    n = 1500
    offs = np.array([0, 0, 1, 1, 1, 2, 700, 700, 1499, 1500, 1500], np.int32)
    keys = rng.sample_int_vector(n, 0, 1000)  # low entropy: cross-segment dups
    vals = np.arange(n, dtype=np.uint32)
    _check_segmented_offsets(keys, vals, offs, call_mode)


def test_sort_segmented_offsets_contract_errors(call_mode):
    from glu_tpu import radix_sort_segmented
    from glu_tpu.utils.errors import GluArgumentError

    k = jnp.zeros(10, jnp.uint32)
    v = jnp.zeros(10, jnp.uint32)
    with pytest.raises(GluArgumentError):  # offsets[0] != 0
        call_mode(radix_sort_segmented, k, v, offsets=jnp.array([1, 10], jnp.int32))
    with pytest.raises(GluArgumentError):  # offsets[-1] != n
        call_mode(radix_sort_segmented, k, v, offsets=jnp.array([0, 9], jnp.int32))
    with pytest.raises(GluArgumentError):  # decreasing
        call_mode(
            radix_sort_segmented, k, v, offsets=jnp.array([0, 7, 3, 10], jnp.int32)
        )
    with pytest.raises(GluArgumentError):  # both forms given
        call_mode(
            radix_sort_segmented, k, v, num_partitions=2,
            offsets=jnp.array([0, 10], jnp.int32),
        )


def test_sort_segmented_offsets_matches_equal_partitions(call_mode, seeded_rng):
    # the offsets form with equal boundaries must reproduce the
    # num_partitions form exactly
    from glu_tpu import radix_sort_segmented

    rng = seeded_rng(123)
    n, p = 2048, 8
    keys = rng.sample_int_vector(n, 0, 5000)
    vals = np.arange(n, dtype=np.uint32)
    a_k, a_v = call_mode(
        radix_sort_segmented, jnp.asarray(keys), jnp.asarray(vals), num_partitions=p
    )
    offs = np.arange(0, n + 1, n // p, dtype=np.int32)
    b_k, b_v = call_mode(
        radix_sort_segmented, jnp.asarray(keys), jnp.asarray(vals), offsets=jnp.asarray(offs)
    )
    np.testing.assert_array_equal(np.asarray(a_k), np.asarray(b_k))
    np.testing.assert_array_equal(np.asarray(a_v), np.asarray(b_v))
