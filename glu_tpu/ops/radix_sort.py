"""Stable LSD radix sort of u32 key / u32 value pairs (4-bit digits, 8 passes).

A JAX re-design of reference glu/RadixSort.hpp:186-354. The reference's
per-pass pipeline is: per-1024-block digit histogram via global atomicAdd
(kernel at RadixSort.hpp:33-57), a 16-partition Blelloch scan of the
[digit][block] count table (:311), then a reorder kernel that serially runs
16 shared-memory block scans to compute stable in-block ranks and scatters
each key/value to digit_base + block_base + rank (:142-182), ping-ponging
between the user's buffers and scratch (:286-320).

Here the whole pass loop is ONE stable `jax.lax.sort` on the requested key
bits (see _sort_xla: stable LSD passes compose to exactly that permutation).
On a GPU, XLA hands a full-width sort of one key with at most one payload to
CUB's device radix sort, which runs the same histogram -> scan -> scatter
pipeline per digit as the reference; the SSBO ping-pong (:286) becomes XLA
buffer donation.

Contract parity: stable; u32 keys with optional u32 values (mandatory in the
reference, README.md:88-89); `num_steps` runs a partial sort for debugging
(RadixSort.hpp:273,332) — after k passes the pairs are stably sorted by the
low 4k key bits; count <= 1 early-exits (:278-279).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils.buffers import DeviceBuffer
from ..utils.errors import check_argument

RADIX_BITS = 4  # digit width (reference RadixSort.hpp:303: u_radix_shift = step << 2)
NUM_PASSES = 32 // RADIX_BITS  # 8 passes over u32 keys


def _sort_xla(keys: jax.Array, values, positions):
    """Portable whole-sort by the key bits at `positions` (static tuple,
    LSB-first significance) — ONE stable platform sort on the compacted
    bit sequence.

    Semantics parity with the LSD pass loop (reference RadixSort.hpp:289-333):
    k stable LSD passes over digits d0..d{k-1} ARE a stable sort by the
    concatenated value d{k-1}..d0, so compacting the requested bits into one
    composite word and running a single stable `jax.lax.sort` produces the
    identical permutation — including partial `num_steps` sorts (low 4k bits
    only) and arbitrary bit-pruned sequences. `values` is a tuple of
    payload arrays permuted identically (extra sort operands).
    """
    cover = tuple(range(len(positions)))
    if positions == cover and len(positions) >= 32:
        # full-width sort: the composite IS the key — drop the redundant
        # operand, which keeps a key/value sort within XLA's two-operand
        # radix-sort form
        outs = jax.lax.sort((keys,) + tuple(values), num_keys=1, is_stable=True)
        return outs[0], tuple(outs[1:])
    if positions == cover:
        # contiguous low bits: composite == masked key
        composite = keys & jnp.uint32((1 << len(positions)) - 1)
    else:
        composite = jnp.zeros_like(keys)
        for j, p in enumerate(positions):
            composite = composite | (((keys >> jnp.uint32(p)) & jnp.uint32(1)) << jnp.uint32(j))
    outs = jax.lax.sort((composite, keys) + tuple(values), num_keys=1, is_stable=True)
    return outs[1], tuple(outs[2:])


@partial(
    jax.jit,
    static_argnames=("num_steps", "bit_positions"),
    donate_argnums=(0, 1),
)
def _radix_sort_streams(keys, values, num_steps: int, bit_positions=None):
    """Core jitted entry: u32 keys + a TUPLE of u32 payload streams permuted
    identically (extra operands of the one sort). Donates all inputs (the
    SSBO ping-pong analog, reference RadixSort.hpp:286).

    bit_positions (static tuple, LSB-first) restricts the sort to those key
    bits — the bit-pruned path under the adaptive sorts. None = the full
    contiguous bits 0..4*num_steps-1 (the reference contract)."""
    if bit_positions is None:
        positions = tuple(range(num_steps * RADIX_BITS))
    else:
        positions = tuple(int(b) for b in bit_positions)
    if not positions:
        return keys, tuple(values)
    return _sort_xla(keys, values, positions)


def _radix_sort_kv(keys, values, num_steps: int, bit_positions=None):
    out_k, out_vs = _radix_sort_streams(keys, (values,), num_steps, bit_positions)
    return out_k, out_vs[0]


def _radix_sort_k(keys, num_steps: int, bit_positions=None):
    out_k, _ = _radix_sort_streams(keys, (), num_steps, bit_positions)
    return out_k


def _norm_steps(num_steps) -> int:
    steps = NUM_PASSES if num_steps in (0, None) else int(num_steps)
    check_argument(0 < steps <= NUM_PASSES, "num_steps must be in 1..%d or 0 for all", NUM_PASSES)
    return steps


@jax.jit
def _bit_envelope(keys):
    """Device-side varying-bit mask: OR(keys) ^ AND(keys) — bit b is set iff
    keys disagree at b. One fused read of the array (XLA or/and
    reductions)."""
    ors = jax.lax.reduce(keys, jnp.uint32(0), jax.lax.bitwise_or, (0,))
    ands = jax.lax.reduce(keys, jnp.uint32(0xFFFFFFFF), jax.lax.bitwise_and, (0,))
    return ors ^ ands


@jax.jit
def _bit_envelope_minmax(keys):
    """Portable fallback for _bit_envelope: 32 per-bit max/min reductions
    (one fused array read). XLA:CPU does not implement the cross-device
    AllReduce(or/and) the fast form lowers to on a sharded array, but
    max/min collectives exist on every backend."""
    ors = jnp.uint32(0)
    ands = jnp.uint32(0)
    for b in range(32):
        bit = (keys >> jnp.uint32(b)) & jnp.uint32(1)
        ors = ors | (jnp.max(bit) << jnp.uint32(b))
        ands = ands | (jnp.min(bit) << jnp.uint32(b))
    return ors ^ ands


def _envelope_fn(keys):
    devs = getattr(keys, "devices", None)
    multi_cpu = False
    if callable(devs):
        ds = devs()
        multi_cpu = len(ds) > 1 and all(d.platform == "cpu" for d in ds)
    return _bit_envelope_minmax if multi_cpu else _bit_envelope


def varying_key_bits(keys: jax.Array) -> tuple:
    """Positions (ascending) of the key bits that actually VARY across
    `keys` — the bit set a stable radix sort must process; constant bits
    never change relative order. One device reduction + a 4-byte host
    fetch (synchronizes; not usable under an enclosing jit). Feed the
    result to radix_sort(..., bits=...) — or pass bits=\"auto\" to fuse the
    two steps — to sort in ceil(len(bits)/4) passes instead of 8. An
    entropy-adaptive extension beyond the reference (which always runs all
    8 passes or a caller-fixed num_steps, RadixSort.hpp:273)."""
    check_argument(keys.ndim == 1, "keys must be 1-D")
    check_argument(keys.dtype == jnp.uint32, "keys must be uint32, got %s", keys.dtype)
    if keys.shape[0] <= 1:
        return ()
    mask = int(_envelope_fn(keys)(keys))
    return tuple(b for b in range(32) if (mask >> b) & 1)


def _norm_bits(bits, keys, num_steps):
    """Resolve the `bits` parameter: None -> None (full contract path),
    \"auto\" -> detect varying bits on the device (host sync), iterable ->
    validated static tuple. Mutually exclusive with a partial num_steps."""
    if bits is None:
        return None
    check_argument(
        num_steps in (0, None, NUM_PASSES),
        "bits cannot be combined with a partial num_steps",
    )
    if isinstance(bits, str):
        check_argument(bits == "auto", 'bits must be None, "auto", or bit positions')
        return varying_key_bits(keys)
    positions = tuple(int(b) for b in bits)
    for p in positions:
        check_argument(0 <= p < 32, "bit positions must be in 0..31, got %d", p)
    check_argument(len(set(positions)) == len(positions), "bit positions must be distinct")
    return positions


def radix_sort(
    keys: jax.Array,
    values: jax.Array,
    num_steps: int = 0,
    *,
    descending: bool = False,
    bits=None,
):
    """Stably sort (keys, values) pairs by key. Returns (sorted_keys, permuted_values).

    keys, values: u32 arrays of equal length. num_steps=0 runs the full
    8-pass sort; num_steps=k returns the state after k LSD passes (stably
    sorted by the low 4k key bits) — the reference's debugging affordance
    (RadixSort.hpp:273,332). descending=True sorts keys high-to-low (still
    stable; an extension beyond the reference) via complemented keys, and
    requires the full sort (num_steps=0). Inputs are donated: treat them as
    consumed.

    bits (extension beyond the reference): \"auto\" detects the key bits
    that actually vary (one extra device reduction + 4-byte host sync) and
    sorts ONLY those — an exact, stable full sort in ceil(v/4) passes
    instead of 8 when v bits vary (e.g. low-entropy or small-range keys).
    An explicit iterable of bit positions (LSB-first significance, distinct,
    in 0..31) sorts by exactly that bit sequence — the generalization of
    CUB's begin_bit/end_bit; the result is a full sort iff the set covers
    every varying bit. Incompatible with a partial num_steps.
    """
    check_argument(keys.ndim == 1 and values.ndim == 1, "keys/values must be 1-D")
    check_argument(keys.shape == values.shape, "keys/values length mismatch")
    check_argument(keys.dtype == jnp.uint32, "keys must be uint32, got %s", keys.dtype)
    check_argument(values.dtype == jnp.uint32, "values must be uint32, got %s", values.dtype)
    check_argument(
        not (descending and num_steps not in (0, None, NUM_PASSES)),
        "descending requires the full sort (num_steps=0)",
    )
    if keys.shape[0] <= 1:  # already sorted x) (reference :278-279)
        return keys, values
    steps = _norm_steps(num_steps)
    if descending:
        keys = ~keys  # complement preserves the varying-bit set
    positions = _norm_bits(bits, keys, num_steps)
    out_k, out_v = _radix_sort_kv(keys, values, steps, positions)
    if descending:
        out_k = ~out_k
    return out_k, out_v


def radix_sort_keys(
    keys: jax.Array, num_steps: int = 0, *, bits=None
):
    """Stably sort keys only (the reference mandates values, README.md:88-89;
    keys-only is a natural extension with the same kernels). See radix_sort
    for the `bits` bit-pruning extension."""
    check_argument(keys.ndim == 1, "keys must be 1-D")
    check_argument(keys.dtype == jnp.uint32, "keys must be uint32, got %s", keys.dtype)
    if keys.shape[0] <= 1:
        return keys
    steps = _norm_steps(num_steps)
    positions = _norm_bits(bits, keys, num_steps)
    return _radix_sort_k(keys, steps, positions)


def radix_sort_multi(
    keys: jax.Array,
    payloads,
    num_steps: int = 0,
    *,
    bits=None,
):
    """Stably sort u32 keys with ANY number of u32 payload streams permuted
    identically — the N-stream generalization of the reference's mandatory
    (key, value) contract (README.md:88-89). Returns
    (sorted_keys, tuple_of_permuted_payloads).

    All payloads ride as extra operands of ONE stable sort — the building
    block under the distributed layer's bucket partition.
    Inputs are donated: treat them as consumed.
    """
    payloads = tuple(payloads)
    check_argument(keys.ndim == 1, "keys must be 1-D")
    check_argument(keys.dtype == jnp.uint32, "keys must be uint32, got %s", keys.dtype)
    for i, v in enumerate(payloads):
        check_argument(v.ndim == 1, "payload %d must be 1-D", i)
        check_argument(v.shape == keys.shape, "payload %d length mismatch", i)
        check_argument(v.dtype == jnp.uint32, "payload %d must be uint32, got %s", i, v.dtype)
    if keys.shape[0] <= 1:
        return keys, payloads
    steps = _norm_steps(num_steps)
    positions = _norm_bits(bits, keys, num_steps)
    return _radix_sort_streams(keys, payloads, steps, positions)


def radix_argsort(
    keys: jax.Array,
    *,
    descending: bool = False,
    bits=None,
):
    """Stable argsort of u32 keys: returns (sorted_keys, order) where
    `order` is the u32 permutation such that sorted_keys == keys[order] —
    the iota-payload composition every \"give me the permutation\" caller
    otherwise writes by hand (the reference has no argsort; its mandatory
    value payload IS the user's own iota in its stability test,
    test/radix_sort_tests.cpp:111-141). Supports descending= and the
    bits= pruning extension. `keys` is donated: treat it as consumed."""
    check_argument(keys.ndim == 1, "keys must be 1-D")
    check_argument(keys.dtype == jnp.uint32, "keys must be uint32, got %s", keys.dtype)
    n = keys.shape[0]
    check_argument(n < (1 << 32), "argsort indices exceed uint32")
    if n <= 1:
        return keys, jnp.arange(n, dtype=jnp.uint32)
    return radix_sort(
        keys, jnp.arange(n, dtype=jnp.uint32), descending=descending, bits=bits,
    )


def _word_composite(word, positions):
    """(composite-or-None, is_identity) for one 32-bit word under the
    pruned bit positions (None = full width)."""
    if positions is None or positions == tuple(range(32)):
        return word, True
    if not positions:
        return None, False  # constant word: contributes no ordering
    cover = tuple(range(len(positions)))
    if positions == cover:
        return word & jnp.uint32((1 << len(positions)) - 1), False
    comp = jnp.zeros_like(word)
    for j, p in enumerate(positions):
        comp = comp | (((word >> jnp.uint32(p)) & jnp.uint32(1)) << jnp.uint32(j))
    return comp, False


@partial(jax.jit, static_argnames=("pos_hi", "pos_lo"))
def _u64_sort_xla(hi, lo, values, pos_hi, pos_lo):
    """One stable multi-key platform sort for (hi, lo) 64-bit keys with
    optional per-word bit pruning: sort keys are the (compacted) hi then lo
    words; hi/lo/values ride as extra operands when compacted."""
    comp_hi, id_hi = _word_composite(hi, pos_hi)
    comp_lo, id_lo = _word_composite(lo, pos_lo)
    sort_keys = [k for k in (comp_hi, comp_lo) if k is not None]
    if not sort_keys:
        return hi, lo, values  # no varying bits: identity permutation
    if id_hi and id_lo:
        outs = jax.lax.sort((hi, lo, values), num_keys=2, is_stable=True)
        return outs[0], outs[1], outs[2]
    operands = tuple(sort_keys) + (hi, lo, values)
    outs = jax.lax.sort(operands, num_keys=len(sort_keys), is_stable=True)
    return outs[-3], outs[-2], outs[-1]


def radix_sort_u64_parts(
    keys_hi: jax.Array,
    keys_lo: jax.Array,
    values: jax.Array,
    *,
    bits=None,
):
    """Stably sort by a 64-bit key given as (hi, lo) u32 halves — a
    multi-word-key extension beyond the reference (u32 only,
    README.md:88-89). Returns (sorted_hi, sorted_lo, permuted_values).

    One stable two-key sort over (hi, lo, value) — the same permutation as
    the LSD composition (a stable sort by the low word, then by the high
    word). The caller's arrays are not donated. bits=\"auto\" prunes constant key
    bits PER WORD (see radix_sort); explicit positions must be given as a PAIR
    (hi_positions, lo_positions) — the trace-safe form the distributed
    layer threads through shard_map (\"auto\" host-syncs and cannot run
    under an enclosing trace)."""
    check_argument(
        keys_hi.ndim == 1 and keys_lo.ndim == 1 and values.ndim == 1,
        "keys_hi/keys_lo/values must be 1-D",
    )
    check_argument(
        keys_hi.shape == keys_lo.shape == values.shape, "keys/values length mismatch"
    )
    for name, a in (("keys_hi", keys_hi), ("keys_lo", keys_lo), ("values", values)):
        check_argument(a.dtype == jnp.uint32, "%s must be uint32, got %s", name, a.dtype)
    n = keys_hi.shape[0]
    if n <= 1:
        return keys_hi, keys_lo, values
    if bits is None or isinstance(bits, str):
        pos_lo = _norm_bits(bits, keys_lo, 0)
        pos_hi = _norm_bits(bits, keys_hi, 0)
    else:
        pair = tuple(bits)
        check_argument(
            len(pair) == 2 and not any(isinstance(p, (int, str)) for p in pair),
            "u64 explicit bits must be a (hi_positions, lo_positions) pair",
        )
        pos_hi = _norm_bits(tuple(pair[0]), keys_hi, 0)
        pos_lo = _norm_bits(tuple(pair[1]), keys_lo, 0)
    return _u64_sort_xla(keys_hi, keys_lo, values, pos_hi, pos_lo)


def radix_sort_segmented(
    keys: jax.Array,
    values: jax.Array,
    num_partitions: int = 1,
    *,
    offsets=None,
    bits=None,
):
    """Stably sort (keys, values) independently within adjacent segments —
    the sort-side analog of the scan's partition batching (reference
    BlellochScan.hpp:125-138; the reference has no segmented sort).
    Returns (sorted_keys, permuted_values).

    Segments are given EITHER as `num_partitions` equal-length pieces OR as
    `offsets` — a 1-D array of S+1 nondecreasing boundaries (CUB
    begin/end-offsets style: segment s is [offsets[s], offsets[s+1]),
    offsets[0] == 0, offsets[-1] == len(keys); empty segments allowed).
    The two forms are mutually exclusive.

    One stable two-key sort: primary key the segment id, secondary key the
    (optionally bit-pruned, see radix_sort) sort key. Equal-length segment
    ids come from an index division; offsets segment ids are built by
    scatter + cumsum on the original layout.
    """
    check_argument(keys.ndim == 1 and values.ndim == 1, "keys/values must be 1-D")
    check_argument(keys.shape == values.shape, "keys/values length mismatch")
    check_argument(keys.dtype == jnp.uint32, "keys must be uint32, got %s", keys.dtype)
    check_argument(values.dtype == jnp.uint32, "values must be uint32, got %s", values.dtype)
    n = keys.shape[0]
    if offsets is not None:
        check_argument(
            num_partitions in (1, None), "offsets and num_partitions are mutually exclusive"
        )
        return _radix_sort_segmented_offsets(keys, values, offsets, bits)
    p = int(num_partitions)
    check_argument(p >= 1, "num_partitions must be >= 1")
    check_argument(n % p == 0, "count (%d) must divide into %d partitions", n, p)
    if p == 1:
        return radix_sort(keys, values, bits=bits)
    if n <= 1:
        return keys, values
    positions = _norm_bits(bits, keys, 0)
    seg = jnp.arange(n, dtype=jnp.uint32) // jnp.uint32(n // p)
    return _segmented_sort_xla(seg, keys, values, positions)


@partial(jax.jit, static_argnames=("positions",))
def _segmented_sort_xla(seg, keys, values, positions):
    """One stable two-key platform sort realizing the segmented contract:
    primary key = segment id (segments are adjacent and ascending, so
    grouping them in order IS the segment layout), secondary key = the
    (optionally bit-compacted) sort key, stable for the in-segment
    contract. `positions` as in _sort_xla (None = full width)."""
    if positions is None or positions == tuple(range(32)):
        outs = jax.lax.sort((seg, keys, values), num_keys=2, is_stable=True)
        return outs[1], outs[2]
    cover = tuple(range(len(positions)))
    if positions == cover:
        comp = keys & jnp.uint32((1 << len(positions)) - 1)
    else:
        comp = jnp.zeros_like(keys)
        for j, p in enumerate(positions):
            comp = comp | (((keys >> jnp.uint32(p)) & jnp.uint32(1)) << jnp.uint32(j))
    outs = jax.lax.sort((seg, comp, keys, values), num_keys=2, is_stable=True)
    return outs[2], outs[3]


def _radix_sort_segmented_offsets(keys, values, offsets, bits):
    """Variable-length segmented sort (see radix_sort_segmented): segment
    ids are built on the original layout (scatter + cumsum, O(n)).
    Trace-safe (the boundaries may be traced values; only their COUNT is
    static)."""
    from ._segments import validate_offsets

    n = keys.shape[0]
    offs, num_segments = validate_offsets(offsets, n)
    if num_segments == 1:
        return radix_sort(keys, values, bits=bits)
    if n <= 1:
        return keys, values
    positions = _norm_bits(bits, keys, 0)
    # seg id of element i = number of interior boundaries <= i: scatter one
    # increment per boundary + cumsum. Duplicate boundaries accumulate, so
    # empty segments skip their id; a trailing offsets[s] == n scatters out
    # of bounds and drops.
    marks = jnp.zeros(n, jnp.uint32).at[offs[1:-1]].add(jnp.uint32(1), mode="drop")
    seg_orig = jnp.cumsum(marks, dtype=jnp.uint32)
    return _segmented_sort_xla(seg_orig, keys, values, positions)


def radix_sort_u64(
    keys: jax.Array,
    values: jax.Array,
    *,
    bits=None,
):
    """Stably sort (u64 key, u32 value) pairs via their (hi, lo) u32 halves
    (see radix_sort_u64_parts, including bits=\"auto\" per-word bit
    pruning). Requires jax_enable_x64 for the uint64 dtype; use
    radix_sort_u64_parts in 32-bit mode."""
    check_argument(keys.ndim == 1 and values.ndim == 1, "keys/values must be 1-D")
    check_argument(keys.shape == values.shape, "keys/values length mismatch")
    check_argument(keys.dtype == jnp.uint64, "keys must be uint64, got %s", keys.dtype)
    check_argument(values.dtype == jnp.uint32, "values must be uint32, got %s", values.dtype)
    if keys.shape[0] <= 1:
        return keys, values
    hi = (keys >> jnp.uint64(32)).astype(jnp.uint32)
    lo = (keys & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    oh, ol, ov = radix_sort_u64_parts(hi, lo, values, bits=bits)
    out_k = (oh.astype(jnp.uint64) << jnp.uint64(32)) | ol.astype(jnp.uint64)
    return out_k, ov


def _f32_to_sortable_u32(x: jax.Array) -> jax.Array:
    """Order-preserving bijection f32 -> u32 (IEEE-754 total order trick):
    flip all bits of negatives, flip only the sign bit of non-negatives."""
    u = jax.lax.bitcast_convert_type(x, jnp.uint32)
    mask = jnp.where(u >> 31 == 1, jnp.uint32(0xFFFFFFFF), jnp.uint32(0x80000000))
    return u ^ mask


def _sortable_u32_to_f32(u: jax.Array) -> jax.Array:
    mask = jnp.where(u >> 31 == 0, jnp.uint32(0xFFFFFFFF), jnp.uint32(0x80000000))
    return jax.lax.bitcast_convert_type(u ^ mask, jnp.float32)


def radix_sort_f32(
    keys: jax.Array,
    values: jax.Array,
    *,
    descending: bool = False,
    bits=None,
):
    """Stably sort (f32 key, u32 value) pairs — an extension beyond the
    reference, which supports u32 keys only (reference README.md:88-89).

    Keys ride the same u32 sort through the standard order-preserving
    bit transform (negatives fully flipped, positives sign-flipped), which
    realizes IEEE-754 total order: -inf < ... < -0.0 < +0.0 < ... < +inf,
    with NaNs at the extremes by sign bit. bits=\"auto\" prunes the bits of
    the TRANSFORMED keys that are constant across the input (see
    radix_sort); explicit positions refer to transformed-key bits.
    """
    check_argument(keys.ndim == 1 and values.ndim == 1, "keys/values must be 1-D")
    check_argument(keys.shape == values.shape, "keys/values length mismatch")
    check_argument(keys.dtype == jnp.float32, "keys must be float32, got %s", keys.dtype)
    check_argument(values.dtype == jnp.uint32, "values must be uint32, got %s", values.dtype)
    if keys.shape[0] <= 1:
        return keys, values
    ku = _f32_to_sortable_u32(keys)
    if descending:
        ku = ~ku
    positions = _norm_bits(bits, ku, 0)
    ku, out_v = _radix_sort_kv(ku, values, NUM_PASSES, positions)
    if descending:
        ku = ~ku
    return _sortable_u32_to_f32(ku), out_v


def radix_sort_i32(
    keys: jax.Array,
    values: jax.Array,
    *,
    descending: bool = False,
    bits=None,
):
    """Stably sort (i32 key, u32 value) pairs — an extension beyond the
    reference, which supports u32 keys only (reference README.md:88-89).

    Signed order rides the u32 sort through the standard sign-bit flip
    (an order-preserving bijection i32 -> u32: INT32_MIN maps to 0,
    INT32_MAX to UINT32_MAX).
    """
    check_argument(keys.ndim == 1 and values.ndim == 1, "keys/values must be 1-D")
    check_argument(keys.shape == values.shape, "keys/values length mismatch")
    check_argument(keys.dtype == jnp.int32, "keys must be int32, got %s", keys.dtype)
    check_argument(values.dtype == jnp.uint32, "values must be uint32, got %s", values.dtype)
    if keys.shape[0] <= 1:
        return keys, values
    ku = _i32_to_sortable_u32(keys)
    if descending:
        ku = ~ku
    positions = _norm_bits(bits, ku, 0)
    ku, out_v = _radix_sort_kv(ku, values, NUM_PASSES, positions)
    if descending:
        ku = ~ku
    return _sortable_u32_to_i32(ku), out_v


def _i32_to_sortable_u32(x: jax.Array) -> jax.Array:
    """Order-preserving bijection i32 -> u32 (sign-bit flip)."""
    return jax.lax.bitcast_convert_type(x, jnp.uint32) ^ jnp.uint32(0x80000000)


def _sortable_u32_to_i32(u: jax.Array) -> jax.Array:
    return jax.lax.bitcast_convert_type(u ^ jnp.uint32(0x80000000), jnp.int32)


class RadixSort:
    """Radix sort operator object (reference glu/RadixSort.hpp:186-354).

    `RadixSort()(key_buffer, val_buffer, count, num_steps=0)` sorts the first
    `count` pairs in place (DeviceBuffer form) or returns sorted arrays.
    `prepare_internal_buffers(count)` pre-compiles/pre-allocates for a size so
    the first timed call is warm — the analog of the reference's lazy scratch
    growth (:237-271) + the benchmark's explicit pre-warm
    (test/radix_sort_tests.cpp:187).
    """

    def __init__(self):
        self._warm: set = set()

    def prepare_internal_buffers(self, count: int) -> None:
        if count <= 1 or count in self._warm:
            return
        k = jnp.zeros(count, dtype=jnp.uint32)
        v = jnp.zeros(count, dtype=jnp.uint32)
        jax.block_until_ready(_radix_sort_kv(k, v, NUM_PASSES))
        self._warm.add(count)

    def __call__(
        self,
        key_buffer: DeviceBuffer | jax.Array,
        val_buffer: DeviceBuffer | jax.Array,
        count: int,
        num_steps: int = 0,
    ):
        check_argument(key_buffer is not None, "Invalid key buffer")
        check_argument(val_buffer is not None, "Invalid value buffer")
        kdata = key_buffer.data if isinstance(key_buffer, DeviceBuffer) else key_buffer
        vdata = val_buffer.data if isinstance(val_buffer, DeviceBuffer) else val_buffer
        check_argument(count <= kdata.shape[0], "count exceeds key buffer size")
        check_argument(count <= vdata.shape[0], "count exceeds value buffer size")
        if count <= 1:
            return kdata[:count], vdata[:count]
        # radix_sort donates its inputs (the SSBO ping-pong analog); the class
        # form keeps the caller's buffer alive, so hand it copies.
        out_k, out_v = radix_sort(
            jnp.copy(kdata[:count]), jnp.copy(vdata[:count]), num_steps
        )
        if isinstance(key_buffer, DeviceBuffer):
            key_buffer.data = key_buffer.data.at[:count].set(out_k)
            out_k = key_buffer.data[:count]
        if isinstance(val_buffer, DeviceBuffer):
            val_buffer.data = val_buffer.data.at[:count].set(out_v)
            out_v = val_buffer.data[:count]
        return out_k, out_v
