"""Distributed stable radix sort over a device mesh.

No analog exists in the reference (single-GPU, SURVEY.md §2.3); this
implements BASELINE.json's north-star capability:

  1. splitter sampling: each device samples local keys, all-gathers the
     samples, and takes quantiles as D-1 splitters (skew handling:
     splitters adapt to the key distribution, unlike fixed-range bits);
  2. bucket partition: each device stably groups its shard by destination
     bucket with ONE stable partial multi-stream sort keyed on the bucket
     id, which moves every payload as an extra sort operand; per-bucket
     offsets fall out of a searchsorted on the sorted bucket ids;
  3. ONE all-to-all bucket exchange (cheaper than the per-pass exchange
     sketched in BASELINE.json: 1x data volume instead of 8x); the padded
     layout is produced by per-bucket `lax.dynamic_slice` block copies;
  4. received blocks are compacted to the front with ascending
     `lax.dynamic_update_slice` block copies, then sorted once with the
     single-device sort. Pads are 0xFFFFFFFF fills positioned AFTER every real
     element, so the stable sort leaves them as a tail even when real keys
     equal 0xFFFFFFFF — no sentinel comparison, no positional bookkeeping.

Stability: blocks are exchanged in source-device order, each block preserves
source order (step 2 is a stable sort), the compaction preserves block
order, and the final local sort is stable — so ties keep global input order
end-to-end under the lexicographic (key, global index) splitter order.

Result: device d holds keys in [splitter_{d-1}, splitter_d), sorted, in the
first `count` slots of its padded shard (pads at the tail hold 0xFFFFFFFF).

Every stage operates on a LIST of u32 payload arrays permuted identically,
so one pipeline serves u32 keys (keys, values), f32 keys (bijected u32),
and 64-bit keys ((hi, lo, values) with lexicographic splitters and chained
32-bit local sorts); descending order is complemented keys throughout.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.radix_sort import (
    _norm_bits,
    radix_sort,
    radix_sort_multi,
    radix_sort_u64_parts,
)
from ..utils.errors import check_argument

_PAD_KEY = 0xFFFFFFFF


def make_sort_mesh(devices=None, axis_name: str = "shards"):
    """Build a 1-D mesh over the given (default: all) devices. The library
    does not own the runtime — callers with an existing mesh pass it
    directly to distributed_radix_sort."""
    devices = jax.devices() if devices is None else devices
    return jax.make_mesh((len(devices),), (axis_name,), devices=devices)


def _sample_splitters(keys, axis_name: str, num_devices: int, num_samples: int):
    """Per-device strided (key, global index) samples -> all-gather -> global
    quantile splitters in LEXICOGRAPHIC (key, index) order.

    The index tiebreak makes every sampled element distinct, so quantiles
    split duplicate-heavy distributions (all-equal keys included) into
    balanced buckets — a key-only splitter would send every tied key to one
    device. Returns (splitter_keys, splitter_indices)."""
    n = keys.shape[0]
    me = jax.lax.axis_index(axis_name)
    # ceil-stride so samples SPAN the whole shard: a floor stride of 1 on
    # shards with n in (num_samples, 2*num_samples) would sample only a
    # prefix, biasing splitters on sorted/structured shards
    stride = -(-n // num_samples)
    take = min(num_samples, -(-n // stride))
    local_samples = jax.lax.dynamic_slice(keys[::stride], (0,), (take,))
    # global index of local element i is me*n + i (device-major == stable
    # global input order)
    local_idx = (me * n + jnp.arange(take, dtype=jnp.uint32) * stride).astype(jnp.uint32)
    all_samples = jax.lax.all_gather(local_samples, axis_name, tiled=True)
    all_idx = jax.lax.all_gather(local_idx, axis_name, tiled=True)
    sk, si = jax.lax.sort((all_samples, all_idx), num_keys=2)
    m = sk.shape[0]
    # splitter i = quantile (i+1)/D; bucket i takes pairs in [s_{i-1}, s_i)
    q = (jnp.arange(1, num_devices, dtype=jnp.int32) * m) // num_devices
    return sk[q], si[q]


def _bucket_of(keys, axis_name: str, splitter_keys, splitter_idx):
    """Destination bucket of each local element under lexicographic
    (key, global index) order: the count of splitters <= (key, index).

    Unrolled over the D-1 splitters (D is static and small) so XLA fuses all
    comparisons into one elementwise pass over the shard — no (D-1, n)
    comparison matrix is ever materialized."""
    n = keys.shape[0]
    me = jax.lax.axis_index(axis_name)
    gidx = (me * n + jnp.arange(n, dtype=jnp.uint32)).astype(jnp.uint32)
    bucket = jnp.zeros(n, dtype=jnp.int32)
    for i in range(splitter_keys.shape[0]):
        le = (splitter_keys[i] < keys) | (
            (splitter_keys[i] == keys) & (splitter_idx[i] <= gidx)
        )
        bucket = bucket + le.astype(jnp.int32)
    return bucket


def _sample_splitters64(hi, lo, axis_name: str, num_devices: int, num_samples: int):
    """64-bit analog of _sample_splitters: quantiles in lexicographic
    (hi, lo, global index) order. Returns (s_hi, s_lo, s_idx)."""
    n = hi.shape[0]
    me = jax.lax.axis_index(axis_name)
    # ceil-stride spanning the shard (see _sample_splitters)
    stride = -(-n // num_samples)
    take = min(num_samples, -(-n // stride))
    local_hi = jax.lax.dynamic_slice(hi[::stride], (0,), (take,))
    local_lo = jax.lax.dynamic_slice(lo[::stride], (0,), (take,))
    local_idx = (me * n + jnp.arange(take, dtype=jnp.uint32) * stride).astype(jnp.uint32)
    all_hi = jax.lax.all_gather(local_hi, axis_name, tiled=True)
    all_lo = jax.lax.all_gather(local_lo, axis_name, tiled=True)
    all_idx = jax.lax.all_gather(local_idx, axis_name, tiled=True)
    shi, slo, sidx = jax.lax.sort((all_hi, all_lo, all_idx), num_keys=3)
    m = shi.shape[0]
    q = (jnp.arange(1, num_devices, dtype=jnp.int32) * m) // num_devices
    return shi[q], slo[q], sidx[q]


def _bucket_of64(hi, lo, axis_name: str, s_hi, s_lo, s_idx):
    """Destination bucket under lexicographic (hi, lo, global index) order:
    the count of splitters <= (hi, lo, index). Same unrolled-comparison
    fusion as _bucket_of."""
    n = hi.shape[0]
    me = jax.lax.axis_index(axis_name)
    gidx = (me * n + jnp.arange(n, dtype=jnp.uint32)).astype(jnp.uint32)
    bucket = jnp.zeros(n, dtype=jnp.int32)
    for i in range(s_hi.shape[0]):
        le = (s_hi[i] < hi) | (
            (s_hi[i] == hi)
            & ((s_lo[i] < lo) | ((s_lo[i] == lo) & (s_idx[i] <= gidx)))
        )
        bucket = bucket + le.astype(jnp.int32)
    return bucket


def _resolve_chunks(pipeline_chunks, num_devices: int, local_n: int) -> int:
    """Resolve pipeline_chunks="auto": 2 chunks on D >= 2 when the shard
    divides evenly (overlap the exchange under the partition work), else 1.
    Explicit ints are validated and honored."""
    if pipeline_chunks == "auto":
        return 2 if (num_devices > 1 and local_n % 2 == 0 and local_n >= 2) else 1
    chunks = int(pipeline_chunks)
    check_argument(chunks >= 1, "pipeline_chunks must be >= 1")
    check_argument(
        local_n % chunks == 0,
        "local shard length %d not divisible by pipeline_chunks=%d",
        local_n, chunks,
    )
    return chunks


def _partition_by_bucket(bucket, arrays, num_devices: int):
    """Stable grouping of the local shard by destination bucket.

    ONE stable partial multi-stream sort keyed on the bucket ids moves every
    payload array as an extra operand of the same sort. Offsets come from a
    binary search over the sorted bucket ids. Returns
    (arrays, counts, offsets) with buckets contiguous in ascending order."""
    n = bucket.shape[0]
    if num_devices == 1:
        return arrays, jnp.full((1,), n, jnp.int32), jnp.zeros((1,), jnp.int32)
    # sort by EXACTLY the bucket-id bits
    nbits = max(int(num_devices - 1).bit_length(), 1)
    sb, outs = radix_sort_multi(
        bucket.astype(jnp.uint32), tuple(arrays), bits=tuple(range(nbits))
    )
    offsets = jnp.searchsorted(
        sb, jnp.arange(num_devices, dtype=jnp.uint32), side="left"
    ).astype(jnp.int32)
    ends = jnp.concatenate([offsets[1:], jnp.full((1,), n, jnp.int32)])
    counts = ends - offsets
    return list(outs), counts, offsets


def _spread_to_padded(arrays, fills, counts, offsets, num_devices: int, capacity: int):
    """Bucket-contiguous arrays -> (D, capacity) padded blocks via one
    `lax.dynamic_slice` (a contiguous block copy) per bucket per array. Inputs are
    extended by `capacity` fill elements so no slice ever clamps (a clamped
    start would misalign the block against its validity mask). Returns
    (padded arrays, sent counts, overflow flag)."""
    j = jnp.arange(capacity, dtype=jnp.int32)
    sent = jnp.minimum(counts, capacity)
    padded = []
    for a, fill in zip(arrays, fills):
        f = jnp.full((capacity,), fill, dtype=jnp.uint32)
        ext = jnp.concatenate([a, f])
        rows = []
        for b in range(num_devices):
            ab = jax.lax.dynamic_slice(ext, (offsets[b],), (capacity,))
            rows.append(jnp.where(j < sent[b], ab, f))
        padded.append(jnp.stack(rows))
    overflow = jnp.any(counts > capacity)
    return padded, sent, overflow


def _compact_blocks(received, fills, recv_counts, num_devices: int, total_slots: int):
    """(D, capacity) received blocks -> front-compacted [total_slots] arrays
    via ascending `lax.dynamic_update_slice` (contiguous block copies). Block b lands
    at the running count of blocks < b; each write's pad tail is overwritten
    by the next block, and every slot >= total holds the fill value
    (0xFFFFFFFF for key words) — positionally AFTER all real elements, so a
    stable sort keeps real 0xFFFFFFFF keys ahead of the pads.

    total_slots may be SMALLER than D*capacity (the receiver-side sort
    budget). Each write is a FULL capacity-wide block (static shape), so the
    staging buffer gets `capacity` extra slack slots: whenever the counts fit
    the budget, roff[b] <= total_slots and every write lands in bounds
    un-clamped (a clamped start would slide the block over its predecessors).
    The slack is sliced off before the sort; if the counts exceed the budget
    the caller's overflow flag discards the attempt, so clamp corruption in
    that case is harmless."""
    capacity = received[0].shape[1]
    roff = jnp.cumsum(recv_counts) - recv_counts
    outs = []
    for r, fill in zip(received, fills):
        out = jnp.full((total_slots + capacity,), fill, dtype=jnp.uint32)
        for b in range(num_devices):
            out = jax.lax.dynamic_update_slice(out, r[b], (roff[b],))
        outs.append(out[:total_slots])
    return outs, jnp.sum(recv_counts)


def _exchange_and_sort(arrays, fills, counts, offsets, local_sort, *,
                       axis_name, num_devices, capacity, recv_capacity):
    """Padded bucket exchange + front compaction + stable local sort.
    `arrays` are bucket-contiguous; `local_sort` maps the
    compacted array tuple to the sorted tuple (pads — fill values positioned
    after every real element — must sort as a stable tail). Returns
    (sorted arrays with canonical fill beyond `count`, count, overflow).

    `recv_capacity` is the receiver-side sort budget — DECOUPLED from the
    per-(src,dst) block `capacity`: sampled splitters keep the per-device
    received total near local_n even when block-level skew (pre-sorted
    inputs) forces a large block capacity, so the final local sort — the
    dominant cost — runs at ~1.25x the real data instead of the exchange's
    worst-case padding (which previously taxed EVERY config ~2x)."""
    padded, sent, overflow = _spread_to_padded(
        arrays, fills, counts, offsets, num_devices, capacity
    )
    # ONE padded bucket exchange; blocks arrive in source order.
    received = [jax.lax.all_to_all(p, axis_name, 0, 0) for p in padded]
    recv_counts = jax.lax.all_to_all(sent.reshape(num_devices, 1), axis_name, 0, 0)
    compacted, count = _compact_blocks(
        received, fills, recv_counts.reshape(-1), num_devices, recv_capacity
    )
    overflow = overflow | (count > recv_capacity)
    out = list(local_sort(*compacted))
    pos = jnp.arange(recv_capacity, dtype=jnp.int32)
    # overwrite pad-tail key words with the canonical fill for a clean contract
    for i, fill in enumerate(fills):
        if fill == _PAD_KEY:
            out[i] = jnp.where(pos < count, out[i], jnp.uint32(_PAD_KEY))
    return out, count, overflow


def _exchange_and_sort_chunked(
    keys_etc, fills, bucket, local_sort, *, axis_name, num_devices, capacity,
    recv_capacity, num_chunks
):
    """Overlapped (chunked) form of partition + exchange + sort (SURVEY §7
    step 7 / BASELINE north star: "overlap exchange with compute").

    The local shard is cut into `num_chunks` adjacent chunks; each chunk is
    partitioned and exchanged INDEPENDENTLY. Chunk c's all_to_all depends
    only on chunk c's partition, so XLA's latency-hiding scheduler is free
    to run chunk c+1's partition (sort work) underneath chunk c's
    transfer — the sequential path serializes them by construction. The
    final local sort is the unavoidable barrier (it needs every received
    element); what the pipeline hides is the partition + exchange-staging
    work of all chunks after the first.

    Ordering/stability: global order is (key, global index); source s's
    chunk c covers smaller indices than its chunk c+1, so received blocks
    are compacted in (source-major, chunk-minor) order, one
    dynamic_update_slice per (s, c) block. Overflow semantics match the
    sequential path: the per-(src,dst) chunk capacity is
    `capacity`/num_chunks-scaled by the caller, and the receiver budget
    check is the same recv_capacity clamp.
    """
    n = keys_etc[0].shape[0]
    nl = n // num_chunks
    received_chunks = []
    sent_chunks = []
    overflow = jnp.zeros((), jnp.bool_)
    for c in range(num_chunks):
        b_c = jax.lax.dynamic_slice(bucket, (c * nl,), (nl,))
        arrs_c = [jax.lax.dynamic_slice(a, (c * nl,), (nl,)) for a in keys_etc]
        arrs_c, counts_c, offs_c = _partition_by_bucket(b_c, arrs_c, num_devices)
        padded_c, sent_c, ovf_c = _spread_to_padded(
            arrs_c, fills, counts_c, offs_c, num_devices, capacity
        )
        received_chunks.append(
            [jax.lax.all_to_all(p, axis_name, 0, 0) for p in padded_c]
        )
        sent_chunks.append(
            jax.lax.all_to_all(sent_c.reshape(num_devices, 1), axis_name, 0, 0).reshape(-1)
        )
        overflow = overflow | ovf_c
    # (s-major, c-minor) placement offsets from the (C, D src) recv counts
    rc = jnp.stack(sent_chunks)                                  # (C, D src)
    flat = rc.T.reshape(-1)                                      # (D*C,) in (s, c) order
    roff = jnp.cumsum(flat) - flat
    count = jnp.sum(flat)
    compacted = []
    for i, fill in enumerate(fills):
        out = jnp.full((recv_capacity + capacity,), fill, dtype=jnp.uint32)
        for s in range(num_devices):
            for c in range(num_chunks):
                out = jax.lax.dynamic_update_slice(
                    out, received_chunks[c][i][s], (roff[s * num_chunks + c],)
                )
        compacted.append(out[:recv_capacity])
    overflow = overflow | (count > recv_capacity)
    out = list(local_sort(*compacted))
    pos = jnp.arange(recv_capacity, dtype=jnp.int32)
    for i, fill in enumerate(fills):
        if fill == _PAD_KEY:
            out[i] = jnp.where(pos < count, out[i], jnp.uint32(_PAD_KEY))
    return out, count, overflow


def _dist_sort_shard(
    keys, values, *, axis_name, num_devices, capacity, recv_capacity,
    num_samples, num_chunks=1, bit_positions=None
):
    """Per-shard body (runs under shard_map; keys/values are the local shard).
    bit_positions: static varying-bit tuple detected HOST-side on the global
    array (bits="auto") — the local sorts prune to it; the 0xFFFFFFFF pad
    keys are all-ones at every position, so they keep the maximal compact
    digit and stay the exact tail, as in the full-width sort."""
    if num_devices == 1:
        # exact fast path: a 1-device mesh has nothing to sample, bucket, or
        # exchange — the composition IS the local sort
        n = keys.shape[0]
        out_k, out_v = radix_sort(keys, values, bits=bit_positions)
        return (
            out_k, out_v,
            jnp.full((1,), n, jnp.int32),
            jnp.zeros((1,), jnp.int32),
        )
    sk, si = _sample_splitters(keys, axis_name, num_devices, num_samples)
    bucket = _bucket_of(keys, axis_name, sk, si)
    if num_chunks > 1 and num_devices > 1:
        out, count, overflow = _exchange_and_sort_chunked(
            [keys, values], [_PAD_KEY, 0], bucket,
            lambda k, v: radix_sort(k, v, bits=bit_positions),
            axis_name=axis_name, num_devices=num_devices, capacity=capacity,
            recv_capacity=recv_capacity, num_chunks=num_chunks,
        )
        any_overflow = jax.lax.pmax(overflow.astype(jnp.int32), axis_name)
        return out[0], out[1], count[None], any_overflow[None]
    arrays, counts, offsets = _partition_by_bucket(
        bucket, [keys, values], num_devices
    )
    out, count, overflow = _exchange_and_sort(
        arrays,
        [_PAD_KEY, 0],
        counts,
        offsets,
        lambda k, v: radix_sort(k, v, bits=bit_positions),
        axis_name=axis_name,
        num_devices=num_devices,
        capacity=capacity,
        recv_capacity=recv_capacity,
    )
    any_overflow = jax.lax.pmax(overflow.astype(jnp.int32), axis_name)
    return out[0], out[1], count[None], any_overflow[None]


def _dist_sort_shard64(
    hi, lo, values, *, axis_name, num_devices, capacity, recv_capacity,
    num_samples, num_chunks=1, bit_positions=None
):
    """Per-shard body for 64-bit keys given as (hi, lo) u32 halves.
    bit_positions: ((hi_positions, lo_positions)) pair or None — see
    _dist_sort_shard."""
    if num_devices == 1:
        n = hi.shape[0]
        oh, ol, ov = radix_sort_u64_parts(hi, lo, values, bits=bit_positions)
        return (
            oh, ol, ov,
            jnp.full((1,), n, jnp.int32),
            jnp.zeros((1,), jnp.int32),
        )
    shi, slo, sidx = _sample_splitters64(hi, lo, axis_name, num_devices, num_samples)
    bucket = _bucket_of64(hi, lo, axis_name, shi, slo, sidx)
    if num_chunks > 1 and num_devices > 1:
        out, count, overflow = _exchange_and_sort_chunked(
            [hi, lo, values], [_PAD_KEY, _PAD_KEY, 0], bucket,
            lambda h, l, v: radix_sort_u64_parts(h, l, v, bits=bit_positions),
            axis_name=axis_name, num_devices=num_devices, capacity=capacity,
            recv_capacity=recv_capacity, num_chunks=num_chunks,
        )
        any_overflow = jax.lax.pmax(overflow.astype(jnp.int32), axis_name)
        return out[0], out[1], out[2], count[None], any_overflow[None]
    arrays, counts, offsets = _partition_by_bucket(
        bucket, [hi, lo, values], num_devices
    )
    out, count, overflow = _exchange_and_sort(
        arrays,
        [_PAD_KEY, _PAD_KEY, 0],
        counts,
        offsets,
        lambda h, l, v: radix_sort_u64_parts(h, l, v, bits=bit_positions),
        axis_name=axis_name,
        num_devices=num_devices,
        capacity=capacity,
        recv_capacity=recv_capacity,
    )
    any_overflow = jax.lax.pmax(overflow.astype(jnp.int32), axis_name)
    return out[0], out[1], out[2], count[None], any_overflow[None]


def _attempt_capacities(mult, capacity_factor, recv_capacity_factor,
                        local_n: int, num_devices: int):
    """(per-block capacity, receiver sort budget) for one attempt at retry
    multiplier `mult`.

    D == 1 is EXACT: nothing is exchanged, so the single block is the shard
    itself — no padding, no overflow possible, and the local sort runs at
    1.0x the data (this is the d=1 composition-overhead fix: the padded
    budget previously made every d=1 call sort capacity_factor x n).

    For D >= 2: per-block capacity is capacity_factor*local_n/D clamped to
    local_n (a source holds only local_n elements, so local_n always fits
    any block); the receiver budget is recv_capacity_factor*local_n clamped
    to D*local_n (the whole input). Both clamps make the retry doubling
    terminate at a configuration that fits ANY distribution."""
    if num_devices == 1:
        return local_n, local_n
    cf = min(capacity_factor * mult, float(num_devices))
    capacity = min(int(np.ceil(cf * local_n / num_devices)), local_n)
    rf = min(recv_capacity_factor * mult, float(num_devices))
    recv_capacity = max(int(np.ceil(rf * local_n)), capacity)
    return capacity, recv_capacity


def distributed_radix_sort(
    keys: jax.Array,
    values: jax.Array,
    mesh: jax.sharding.Mesh,
    *,
    axis_name: str = "shards",
    capacity_factor: float = 2.0,
    recv_capacity_factor: float = 1.05,
    num_samples: int = 8192,
    max_retries: int = 3,
    descending: bool = False,
    pipeline_chunks="auto",
    bits=None,
):
    """Globally sort sharded u32 (key, value) pairs across `mesh`.

    keys/values: arrays sharded (or shardable) along axis 0 over the mesh's
    `axis_name` axis; length divisible by the device count.

    Returns (keys, values, counts, overflow): keys/values are sharded
    [D * padded] arrays — device d's shard holds the d-th global key range,
    sorted and stable, in its first counts[d] slots; overflow is nonzero only
    if the capacity factors doubled `max_retries` times still could not hold
    the key skew (results are then incomplete — the overflowed elements were
    dropped; pass larger factors or max_retries).

    descending=True sorts high-to-low (device 0 holds the LARGEST keys),
    stable, via complemented keys — same scheme as the single-device sort
    (ops/radix_sort.py); pad slots then hold 0x00000000 instead of
    0xFFFFFFFF (still positionally after every real element).

    The bucket exchange is a dense all_to_all with per-(src,dst) block
    capacity capacity_factor*n_local/D: range-correlated inputs like
    pre-sorted data concentrate whole shards into single blocks and can
    need capacity_factor up to D, which the lossless retry below reaches.

    recv_capacity_factor bounds the RECEIVER side: each device's final local
    sort — the dominant cost — runs over recv_capacity_factor*n_local slots,
    so it is the largest efficiency knob at scale. With the default 8192
    samples per device the index-tiebroken splitters keep received totals
    close to n_local across uniform/zipf/low-entropy/presorted inputs, and
    the lossless retry covers the tail; block-level skew is absorbed by the
    per-block capacity, not the sort length. With one device
    both factors are ignored and the sort is exact (n_local slots, no
    exchange).

    pipeline_chunks cuts each shard into that many adjacent chunks,
    partitioned and exchanged independently so XLA's latency-hiding
    scheduler can overlap chunk c's exchange with chunk c+1's partition
    work (SURVEY §7 step 7; the final local sort remains the barrier).
    "auto" (the default) uses 2 chunks on D >= 2 meshes when the shard
    length divides evenly, 1 otherwise; explicit values require the local
    shard length divisible by pipeline_chunks. The per-(src,dst) block
    capacity applies PER CHUNK, so block-level skew tolerance scales with
    capacity_factor exactly as in the sequential path (chunked blocks are
    1/pipeline_chunks the size).

    Overflow handling is LOSSLESS for max_retries > 0: inputs are never
    donated, so when an attempt reports overflow the sort is simply re-run
    with both factors doubled (a fresh XLA program; the failed attempt's
    outputs are discarded). The device-side drop only ever reaches the caller
    on the final attempt. Each retry costs one host round trip for the flag
    fetch.

    bits: entropy-adaptive bit pruning (see ops.radix_sort.radix_sort).
    "auto" detects the GLOBAL varying-bit set with one reduction over the
    sharded array (host sync) and every device's local sorts prune to it —
    the final local sort is the dominant cost of the pipeline, so the win
    follows the single-device one. Splitters and
    bucket ranges are unaffected (they order by the full key).
    """
    num_devices = mesh.shape[axis_name]
    check_argument(keys.ndim == 1 and values.ndim == 1, "keys/values must be 1-D")
    check_argument(keys.dtype == jnp.uint32, "keys must be uint32, got %s", keys.dtype)
    check_argument(values.dtype == jnp.uint32, "values must be uint32, got %s", values.dtype)
    check_argument(keys.shape == values.shape, "keys/values length mismatch")
    check_argument(
        keys.shape[0] % num_devices == 0,
        "global length %d not divisible by %d devices",
        keys.shape[0],
        num_devices,
    )
    local_n = keys.shape[0] // num_devices
    chunks = _resolve_chunks(pipeline_chunks, num_devices, local_n)
    if descending:
        keys = ~keys  # bitwise NOT reverses u32 order; stability is preserved
    bit_positions = _norm_bits(bits, keys, 0)  # "auto" reduces over the GLOBAL array

    def attempt(mult: float):
        # the chunked pipeline only engages on real meshes (the shard body
        # falls back to the sequential path at D == 1, so capacities must be
        # sized for it — a per-chunk block capacity at D == 1 would overflow
        # unconditionally)
        eff_chunks = chunks if num_devices > 1 else 1
        capacity, recv_capacity = _attempt_capacities(
            mult, capacity_factor, recv_capacity_factor,
            local_n // eff_chunks, num_devices
        )
        if eff_chunks > 1:
            # _attempt_capacities sized the per-chunk block; the receiver
            # budget spans the WHOLE shard
            _, recv_capacity = _attempt_capacities(
                mult, capacity_factor, recv_capacity_factor, local_n, num_devices
            )
        fn = _dist_fn_u32(
            mesh, axis_name, num_devices, capacity, recv_capacity,
            min(num_samples, local_n), chunks,
            bit_positions,
        )
        return fn(keys, values)

    out = _run_attempts(attempt, max_retries)
    if descending:
        out = (~out[0], out[1], out[2], out[3])
    return out


@lru_cache(maxsize=128)
def _dist_fn_u32(mesh, axis_name, num_devices, capacity, recv_capacity,
                 num_samples, num_chunks=1,
                 bit_positions=None):
    """Cached jitted shard_map program for the u32 pipeline. A fresh
    partial + jax.jit per call has a new function identity, so jit's own
    cache never hits and EVERY invocation would recompile the whole
    program. Keyed on everything the traced program closes over; jax.jit under the
    cached identity then reuses the executable across calls and shapes hit
    its own aval cache."""
    spec = jax.sharding.PartitionSpec(axis_name)
    body = partial(
        _dist_sort_shard,
        axis_name=axis_name,
        num_devices=num_devices,
        capacity=capacity,
        recv_capacity=recv_capacity,
        num_samples=num_samples,
        num_chunks=num_chunks,
        bit_positions=bit_positions,
    )
    return jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(spec, spec),
            out_specs=(spec, spec, spec, spec),
            check_vma=False,
        )
    )


@lru_cache(maxsize=128)
def _dist_fn_u64(mesh, axis_name, num_devices, capacity, recv_capacity,
                 num_samples, num_chunks=1,
                 bit_positions=None):
    """Cached jitted shard_map program for the (hi, lo) 64-bit pipeline."""
    spec = jax.sharding.PartitionSpec(axis_name)
    body = partial(
        _dist_sort_shard64,
        axis_name=axis_name,
        num_devices=num_devices,
        capacity=capacity,
        recv_capacity=recv_capacity,
        num_samples=num_samples,
        num_chunks=num_chunks,
        bit_positions=bit_positions,
    )
    return jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(spec, spec, spec),
            out_specs=(spec, spec, spec, spec, spec),
            check_vma=False,
        )
    )


def _run_attempts(attempt, max_retries: int):
    """Lossless overflow retry loop: double both capacity factors until the
    exchange AND the receiver budget fit (overflow is the last output). The
    FINAL allowed retry jumps straight to the guaranteed-fit clamp
    (_attempt_capacities caps at local_n per block, D*local_n receiver —
    enough for ANY distribution), so any max_retries >= 1 terminates with a
    complete result even when log2-doubling from the starting factors could
    not reach the clamp (e.g. recv_capacity_factor=1.25 on a D >= 16 mesh)."""
    mult = 1.0
    out = attempt(mult)
    for i in range(max_retries):
        if not np.any(np.asarray(out[-1])):
            break
        mult = float("inf") if i == max_retries - 1 else mult * 2.0
        out = attempt(mult)
    return out


def distributed_radix_sort_f32(
    keys: jax.Array,
    values: jax.Array,
    mesh: jax.sharding.Mesh,
    *,
    descending: bool = False,
    **kwargs,
):
    """Globally sort sharded f32 (key, value) pairs across `mesh`, via the
    same order-preserving f32<->u32 bijection as the single-chip
    radix_sort_f32 (IEEE-754 total order: -NaN < -inf < ... < +inf < +NaN).
    The bijection is monotonic, so splitter sampling, bucket ranges, and the
    per-device output ranges all carry over unchanged.

    Same contract as distributed_radix_sort, except keys are float32 and pad
    slots (positions >= counts[d]) decode to NaN.
    """
    check_argument(keys.dtype == jnp.float32, "keys must be float32, got %s", keys.dtype)
    from ..ops.radix_sort import _f32_to_sortable_u32, _sortable_u32_to_f32

    out = distributed_radix_sort(
        _f32_to_sortable_u32(keys), values, mesh, descending=descending, **kwargs
    )
    return (_sortable_u32_to_f32(out[0]), out[1], out[2], out[3])


def distributed_radix_sort_i32(
    keys: jax.Array,
    values: jax.Array,
    mesh: jax.sharding.Mesh,
    *,
    descending: bool = False,
    **kwargs,
):
    """Globally sort sharded i32 (key, value) pairs across `mesh`, via the
    same order-preserving sign-bit flip as the single-chip radix_sort_i32.
    The bijection is monotonic, so splitter sampling, bucket ranges, and the
    per-device output ranges all carry over unchanged.

    Same contract as distributed_radix_sort, except keys are int32 and pad
    slots (positions >= counts[d]) decode to INT32_MAX.
    """
    check_argument(keys.dtype == jnp.int32, "keys must be int32, got %s", keys.dtype)
    from ..ops.radix_sort import _i32_to_sortable_u32, _sortable_u32_to_i32

    out = distributed_radix_sort(
        _i32_to_sortable_u32(keys), values, mesh, descending=descending, **kwargs
    )
    return (_sortable_u32_to_i32(out[0]), out[1], out[2], out[3])


def distributed_radix_sort_u64_parts(
    keys_hi: jax.Array,
    keys_lo: jax.Array,
    values: jax.Array,
    mesh: jax.sharding.Mesh,
    *,
    axis_name: str = "shards",
    capacity_factor: float = 2.0,
    recv_capacity_factor: float = 1.05,
    num_samples: int = 8192,
    max_retries: int = 3,
    descending: bool = False,
    pipeline_chunks="auto",
    bits=None,
):
    """Globally sort sharded 64-bit keys given as (hi, lo) u32 halves, with
    u32 values, across `mesh` — the distributed form of the single-chip
    radix_sort_u64_parts (multi-word keys; beyond the reference's u32-only
    contract, README.md:88-89).

    Same pipeline as distributed_radix_sort with (hi, lo, value) payloads:
    splitters and buckets use lexicographic (hi, lo, global index) order, the
    bucket partition runs one stable partial sort per payload, and the local
    sort is the chained 32-bit LSD composition. Returns
    (hi, lo, values, counts, overflow); pad slots hold hi = lo = 0xFFFFFFFF
    (0x00000000 when descending). bits="auto" prunes constant bits PER
    WORD, detected host-side on the global (hi, lo) arrays (see
    distributed_radix_sort).
    """
    num_devices = mesh.shape[axis_name]
    for name, a in (("keys_hi", keys_hi), ("keys_lo", keys_lo), ("values", values)):
        check_argument(a.ndim == 1, "%s must be 1-D", name)
        check_argument(a.dtype == jnp.uint32, "%s must be uint32, got %s", name, a.dtype)
    check_argument(
        keys_hi.shape == keys_lo.shape == values.shape, "keys/values length mismatch"
    )
    check_argument(
        keys_hi.shape[0] % num_devices == 0,
        "global length %d not divisible by %d devices",
        keys_hi.shape[0],
        num_devices,
    )
    local_n = keys_hi.shape[0] // num_devices
    chunks = _resolve_chunks(pipeline_chunks, num_devices, local_n)
    if descending:
        keys_hi, keys_lo = ~keys_hi, ~keys_lo  # complementing both words reverses u64 order
    check_argument(bits in (None, "auto"), 'distributed u64 sorts accept only bits=None or "auto"')
    bit_positions = None
    if bits == "auto":
        bit_positions = (_norm_bits(bits, keys_hi, 0), _norm_bits(bits, keys_lo, 0))

    def attempt(mult: float):
        eff_chunks = chunks if num_devices > 1 else 1
        capacity, recv_capacity = _attempt_capacities(
            mult, capacity_factor, recv_capacity_factor,
            local_n // eff_chunks, num_devices
        )
        if eff_chunks > 1:
            _, recv_capacity = _attempt_capacities(
                mult, capacity_factor, recv_capacity_factor, local_n, num_devices
            )
        fn = _dist_fn_u64(
            mesh, axis_name, num_devices, capacity, recv_capacity,
            min(num_samples, local_n), chunks,
            bit_positions,
        )
        return fn(keys_hi, keys_lo, values)

    out = _run_attempts(attempt, max_retries)
    if descending:
        out = (~out[0], ~out[1], out[2], out[3], out[4])
    return out


def distributed_radix_sort_u64(
    keys: jax.Array,
    values: jax.Array,
    mesh: jax.sharding.Mesh,
    **kwargs,
):
    """Globally sort sharded (u64 key, u32 value) pairs across `mesh` via
    distributed_radix_sort_u64_parts. Requires jax_enable_x64 for the uint64
    dtype; use the _parts form in 32-bit mode. Returns
    (keys, values, counts, overflow)."""
    check_argument(keys.ndim == 1, "keys must be 1-D")
    check_argument(keys.dtype == jnp.uint64, "keys must be uint64, got %s", keys.dtype)
    hi = (keys >> jnp.uint64(32)).astype(jnp.uint32)
    lo = (keys & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    oh, ol, ov, counts, overflow = distributed_radix_sort_u64_parts(
        hi, lo, values, mesh, **kwargs
    )
    out_k = (oh.astype(jnp.uint64) << jnp.uint64(32)) | ol.astype(jnp.uint64)
    return out_k, ov, counts, overflow
