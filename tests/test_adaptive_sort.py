"""Entropy-adaptive bit-pruned radix sort (`bits=` / varying_key_bits).

An extension beyond the reference (which always runs all 8 passes or a
caller-fixed num_steps, reference glu/RadixSort.hpp:273): constant key bits
never change relative order under a stable sort, so the sort may process
only the varying bits — ceil(v/4) passes instead of 8 — and the result is
still the exact stable full sort. `bits="auto"` detects the varying set with
one device OR/AND reduction; an explicit bit-position sequence generalizes
CUB-style begin_bit/end_bit to arbitrary (even non-contiguous) bit sets.

Oracle: numpy stable argsort of the compact key formed by the requested
bits, so stability and bit-significance order are both checked.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from glu_tpu import (
    GluError,
    radix_sort,
    radix_sort_f32,
    radix_sort_i32,
    radix_sort_keys,
    radix_sort_multi,
    radix_sort_u64_parts,
    varying_key_bits,
)


def _masked_order(keys: np.ndarray, positions) -> np.ndarray:
    """Stable order by the compact key formed by `positions` (LSB-first)."""
    comp = np.zeros(keys.size, np.uint64)
    for j, p in enumerate(positions):
        comp |= ((keys.astype(np.uint64) >> p) & 1) << np.uint64(j)
    return np.argsort(comp, kind="stable")


def test_varying_key_bits():
    k = jnp.asarray(np.array([0b1010, 0b0010, 0b1000], np.uint32))
    assert varying_key_bits(k) == (1, 3)
    assert varying_key_bits(jnp.asarray(np.array([7, 7, 7], np.uint32))) == ()
    assert varying_key_bits(jnp.asarray(np.array([5], np.uint32))) == ()
    full = varying_key_bits(jnp.asarray(np.array([0, 0xFFFFFFFF], np.uint32)))
    assert full == tuple(range(32))


@pytest.mark.parametrize("size", [100, 4096, 20000])
def test_auto_low_entropy_equals_full(seeded_rng, size):
    # %10 keys: only bits 0..3 vary -> a single 4-bit pass
    keys = seeded_rng(size).sample_int_vector(size, 0, 0xFFFFFFFE) % np.uint32(10)
    vals = np.arange(size, dtype=np.uint32)
    out_k, out_v = radix_sort(jnp.asarray(keys), jnp.asarray(vals), bits="auto"
    )
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(out_k), keys[order])
    np.testing.assert_array_equal(np.asarray(out_v), order.astype(np.uint32))


@pytest.mark.parametrize(
    "positions",
    [(0,), (31,), (1, 5, 17, 30, 31), (4, 5, 6, 7, 8, 9, 10, 11, 12), tuple(range(32))],
)
def test_explicit_bits_match_masked_oracle(call_mode, seeded_rng, positions):
    size = 6000
    keys = seeded_rng(size + len(positions)).sample_int_vector(size, 0, 0xFFFFFFFE)
    vals = np.arange(size, dtype=np.uint32)
    out_k, out_v = call_mode(
        radix_sort, jnp.asarray(keys), jnp.asarray(vals), bits=positions
    )
    order = _masked_order(keys, positions)
    np.testing.assert_array_equal(np.asarray(out_k), keys[order])
    np.testing.assert_array_equal(np.asarray(out_v), order.astype(np.uint32))


def test_bit_significance_is_sequence_order(call_mode):
    # (8, 0): bit 8 is LEAST significant -> order by bit0 first, bit8 breaks ties
    keys = np.array([0x100, 0x000, 0x101, 0x001], np.uint32)
    vals = np.arange(4, dtype=np.uint32)
    out_k, out_v = call_mode(
        radix_sort, jnp.asarray(keys), jnp.asarray(vals), bits=(8, 0)
    )
    order = _masked_order(keys, (8, 0))
    np.testing.assert_array_equal(np.asarray(out_k), keys[order])
    np.testing.assert_array_equal(np.asarray(out_v), order.astype(np.uint32))


def test_auto_all_equal_is_identity(call_mode):
    keys = np.full(777, 42, np.uint32)
    vals = np.arange(777, dtype=np.uint32)
    out_k, out_v = radix_sort(jnp.asarray(keys), jnp.asarray(vals), bits="auto"
    )
    np.testing.assert_array_equal(np.asarray(out_k), keys)
    np.testing.assert_array_equal(np.asarray(out_v), vals)


def test_auto_descending(seeded_rng):
    keys = seeded_rng(11).sample_int_vector(5000, 0, 99)
    vals = np.arange(5000, dtype=np.uint32)
    out_k, out_v = radix_sort(jnp.asarray(keys), jnp.asarray(vals),
        bits="auto", descending=True,
    )
    order = np.argsort(~keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(out_k), keys[order])
    np.testing.assert_array_equal(np.asarray(out_v), order.astype(np.uint32))


def test_auto_keys_only_and_multi(seeded_rng):
    # 9 varying, non-contiguous bits -> 3 passes (last pass 1 bit wide)
    mask = np.uint32(0b1011010011010)
    keys = seeded_rng(12).sample_int_vector(8000, 0, 0xFFFFFFFE) & mask
    out = radix_sort_keys(jnp.asarray(keys), bits="auto")
    np.testing.assert_array_equal(np.asarray(out), np.sort(keys))

    vals = np.arange(8000, dtype=np.uint32)
    out_k, (v1, v2) = radix_sort_multi(
        jnp.asarray(keys), [jnp.asarray(vals), jnp.asarray(vals * 3)], bits="auto"
    )
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(out_k), keys[order])
    np.testing.assert_array_equal(np.asarray(v1), order.astype(np.uint32))
    np.testing.assert_array_equal(np.asarray(v2), (order * 3).astype(np.uint32))


def test_auto_f32_i32(seeded_rng):
    rng = seeded_rng(13)
    kf = rng.sample_int_vector(3000, 0, 255).astype(np.float32)
    of, vf = radix_sort_f32(jnp.asarray(kf), jnp.arange(3000, dtype=jnp.uint32), bits="auto",
    )
    order = np.argsort(kf, kind="stable")
    np.testing.assert_array_equal(np.asarray(of), kf[order])
    np.testing.assert_array_equal(np.asarray(vf), order.astype(np.uint32))

    ki = (rng.sample_int_vector(3000, 0, 199).astype(np.int64) - 100).astype(np.int32)
    oi, vi = radix_sort_i32(jnp.asarray(ki), jnp.arange(3000, dtype=jnp.uint32), bits="auto",
    )
    order = np.argsort(ki, kind="stable")
    np.testing.assert_array_equal(np.asarray(oi), ki[order])
    np.testing.assert_array_equal(np.asarray(vi), order.astype(np.uint32))


def test_auto_u64_parts_per_word(seeded_rng):
    # hi word spans 3 bits, lo word full range: hi sort prunes to 1 pass
    rng = seeded_rng(14)
    hi = rng.sample_int_vector(4000, 0, 7)
    lo = rng.sample_int_vector(4000, 0, 0xFFFFFFFE)
    vals = np.arange(4000, dtype=np.uint32)
    oh, ol, ov = radix_sort_u64_parts(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(vals), bits="auto"
    )
    full = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    order = np.argsort(full, kind="stable")
    np.testing.assert_array_equal(np.asarray(oh), hi[order])
    np.testing.assert_array_equal(np.asarray(ol), lo[order])
    np.testing.assert_array_equal(np.asarray(ov), order.astype(np.uint32))


def test_bits_rejects_bad_arguments(seeded_rng):
    keys = jnp.asarray(seeded_rng(15).sample_int_vector(64, 0, 100))
    vals = jnp.arange(64, dtype=jnp.uint32)
    with pytest.raises(GluError):
        radix_sort(keys, vals, bits=(0, 0))  # duplicate
    with pytest.raises(GluError):
        radix_sort(keys, vals, bits=(32,))  # out of range
    with pytest.raises(GluError):
        radix_sort(keys, vals, bits="yes")  # unknown string
    with pytest.raises(GluError):
        radix_sort(keys, vals, 3, bits="auto")  # partial num_steps + bits
    with pytest.raises(GluError):
        radix_sort_u64_parts(keys, keys, vals, bits=(0, 1))  # explicit on u64


def test_adaptive_low_bits_and_sparse_positions(seeded_rng):
    """bits="auto" on keys whose low 6 bits vary (one full 4-bit digit plus
    a 2-bit remainder), and an explicit sparse 5-position set."""
    size = 6000
    keys = seeded_rng(16).sample_int_vector(size, 0, 0xFFFFFFFE) & np.uint32(0x3F)
    vals = np.arange(size, dtype=np.uint32)
    out_k, out_v = radix_sort(jnp.asarray(keys), jnp.asarray(vals), bits="auto")
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(out_k), keys[order])
    np.testing.assert_array_equal(np.asarray(out_v), order.astype(np.uint32))
    pos = (0, 3, 9, 17, 31)
    keys = seeded_rng(17).sample_int_vector(size, 0, 0xFFFFFFFE)
    out_k, out_v = radix_sort(
        jnp.asarray(keys), jnp.asarray(np.arange(size, dtype=np.uint32)), bits=pos
    )
    order = _masked_order(keys, pos)
    np.testing.assert_array_equal(np.asarray(out_k), keys[order])
    np.testing.assert_array_equal(np.asarray(out_v), order.astype(np.uint32))


# -------------------------- distributed adaptive sorts (8-dev CPU mesh) ----

def _dist_run_adaptive(keys, bits, **kw):
    import jax
    from glu_tpu.parallel import distributed_radix_sort, make_sort_mesh

    nd = min(8, len(jax.devices()))
    mesh = make_sort_mesh(jax.devices()[:nd])
    spec = jax.sharding.PartitionSpec("shards")
    sharding = jax.sharding.NamedSharding(mesh, spec)
    vals = np.arange(keys.size, dtype=np.uint32)
    k = jax.device_put(jnp.asarray(keys), sharding)
    v = jax.device_put(jnp.asarray(vals), sharding)
    out_k, out_v, counts, overflow = distributed_radix_sort(
        k, v, mesh, bits=bits, **kw
    )
    assert int(np.asarray(overflow)[0]) == 0
    out_k, out_v, counts = np.asarray(out_k), np.asarray(out_v), np.asarray(counts)
    per = out_k.shape[0] // nd
    gk = np.concatenate([out_k[d * per : d * per + counts[d]] for d in range(nd)])
    gv = np.concatenate([out_v[d * per : d * per + counts[d]] for d in range(nd)])
    return gk, gv


@pytest.mark.parametrize("bits", ["auto", tuple(range(6))])
def test_dist_sort_adaptive_low_entropy(seeded_rng, bits):
    keys = seeded_rng(21).sample_int_vector(8 * 2048, 0, 0xFFFFFFFE) % np.uint32(10)
    gk, gv = _dist_run_adaptive(keys, bits)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(gk, keys[order])
    np.testing.assert_array_equal(gv, order.astype(np.uint32))


def test_dist_sort_adaptive_descending_and_chunked(seeded_rng):
    keys = seeded_rng(22).sample_int_vector(8 * 2048, 0, 999)
    gk, gv = _dist_run_adaptive(keys, "auto", descending=True, pipeline_chunks=2)
    order = np.argsort(~keys, kind="stable")
    np.testing.assert_array_equal(gk, keys[order])
    np.testing.assert_array_equal(gv, order.astype(np.uint32))


def test_dist_sort_u64_adaptive(seeded_rng):
    import jax
    from glu_tpu.parallel import distributed_radix_sort_u64_parts, make_sort_mesh

    rng = seeded_rng(23)
    n = 8 * 1024
    hi = rng.sample_int_vector(n, 0, 7)
    lo = rng.sample_int_vector(n, 0, 0xFFFF)
    vals = np.arange(n, dtype=np.uint32)
    nd = min(8, len(jax.devices()))
    mesh = make_sort_mesh(jax.devices()[:nd])
    spec = jax.sharding.PartitionSpec("shards")
    sharding = jax.sharding.NamedSharding(mesh, spec)
    oh, ol, ov, counts, overflow = distributed_radix_sort_u64_parts(
        jax.device_put(jnp.asarray(hi), sharding),
        jax.device_put(jnp.asarray(lo), sharding),
        jax.device_put(jnp.asarray(vals), sharding),
        mesh, bits="auto",
    )
    assert int(np.asarray(overflow)[0]) == 0
    oh, ol, ov, counts = map(np.asarray, (oh, ol, ov, counts))
    per = oh.shape[0] // nd
    gh = np.concatenate([oh[d * per : d * per + counts[d]] for d in range(nd)])
    gl = np.concatenate([ol[d * per : d * per + counts[d]] for d in range(nd)])
    gv = np.concatenate([ov[d * per : d * per + counts[d]] for d in range(nd)])
    full = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    order = np.argsort(full, kind="stable")
    np.testing.assert_array_equal(gh, hi[order])
    np.testing.assert_array_equal(gl, lo[order])
    np.testing.assert_array_equal(gv, order.astype(np.uint32))


def test_u64_parts_explicit_bit_pair(call_mode, seeded_rng):
    """The trace-safe (hi_positions, lo_positions) form the dist layer uses."""
    rng = seeded_rng(24)
    hi = rng.sample_int_vector(3000, 0, 7)
    lo = rng.sample_int_vector(3000, 0, 0xFFFF)
    vals = np.arange(3000, dtype=np.uint32)
    oh, ol, ov = call_mode(
        radix_sort_u64_parts, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(vals),
        bits=((0, 1, 2), tuple(range(16))),
    )
    full = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    order = np.argsort(full, kind="stable")
    np.testing.assert_array_equal(np.asarray(oh), hi[order])
    np.testing.assert_array_equal(np.asarray(ov), order.astype(np.uint32))


def test_radix_argsort(seeded_rng):
    from glu_tpu import radix_argsort

    keys = seeded_rng(30).sample_int_vector(5000, 0, 999)
    ok_, order = radix_argsort(jnp.asarray(keys))
    o = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(order), o.astype(np.uint32))
    np.testing.assert_array_equal(np.asarray(ok_), keys[o])
    # descending + adaptive compose
    ok_, order = radix_argsort(jnp.asarray(keys), descending=True, bits="auto"
    )
    o = np.argsort(~keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(order), o.astype(np.uint32))


def test_segmented_adaptive(seeded_rng):
    from glu_tpu import radix_sort_segmented

    keys = seeded_rng(31).sample_int_vector(4096, 0, 99)
    vals = np.arange(4096, dtype=np.uint32)
    out_k, out_v = radix_sort_segmented(jnp.asarray(keys), jnp.asarray(vals), 16, bits="auto"
    )
    ek, ev = [], []
    for s in range(16):
        seg = slice(s * 256, (s + 1) * 256)
        o = np.argsort(keys[seg], kind="stable")
        ek.append(keys[seg][o])
        ev.append(vals[seg][o])
    np.testing.assert_array_equal(np.asarray(out_k), np.concatenate(ek))
    np.testing.assert_array_equal(np.asarray(out_v), np.concatenate(ev))
