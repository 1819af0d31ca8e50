"""Unit tests of the padded bucket exchange's block layout.

`_spread_to_padded` cuts a bucket-contiguous shard into (D, capacity)
blocks and `_compact_blocks` packs received blocks to the front; between
them sits one all_to_all, which a numpy transpose models here. The chunked
pipeline is run whole under shard_map on the CPU mesh with an identity in
place of the local sort, so its (source-major, chunk-minor) placement is
checked against a numpy model of the same layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from glu_tpu.parallel.dist_sort import (
    _PAD_KEY,
    _compact_blocks,
    _exchange_and_sort_chunked,
    _spread_to_padded,
    make_sort_mesh,
)


def _random_counts(rng, D, local_n, skew):
    """(D, D) matrix: row s splits source s's local_n elements over D buckets."""
    counts = np.zeros((D, D), dtype=np.int32)
    for s in range(D):
        if skew == "uniform":
            cuts = np.sort(rng.integers(0, local_n + 1, D - 1))
        elif skew == "one-hot":  # whole shard to one destination
            cuts = np.where(np.arange(D - 1) < int(rng.integers(0, D)), 0, local_n)
        else:  # "empty-heavy": most blocks empty
            cuts = np.sort(rng.choice([0, local_n], size=D - 1, p=[0.7, 0.3]))
        counts[s] = np.diff(np.concatenate([[0], cuts, [local_n]]))
    return counts


def _exchange(operands, counts, capacity, total_slots, fill):
    """Spread every source, model the all_to_all, compact every receiver.
    Returns (per-receiver buffers, per-receiver totals, per-source overflow)."""
    D = len(operands)
    offsets = np.cumsum(counts, axis=1) - counts
    spread = [
        _spread_to_padded([jnp.asarray(operands[s])], [fill], jnp.asarray(counts[s]),
                          jnp.asarray(offsets[s]), D, capacity)
        for s in range(D)
    ]
    outs, totals = [], []
    for d in range(D):
        received = jnp.stack([spread[s][0][0][d] for s in range(D)])
        recv_counts = jnp.stack([spread[s][1][d] for s in range(D)])
        (out,), total = _compact_blocks([received], [fill], recv_counts, D, total_slots)
        outs.append(np.asarray(out))
        totals.append(int(total))
    return outs, totals, [bool(sp[2]) for sp in spread], offsets


def _packed(blocks, total_slots, fill):
    out = np.full(total_slots, fill, dtype=np.uint32)
    flat = np.concatenate(blocks) if blocks else np.zeros(0, np.uint32)
    out[: flat.size] = flat
    return out


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("skew", ["uniform", "one-hot", "empty-heavy"])
def test_padded_exchange_packs_blocks_in_source_order(D, skew):
    rng = np.random.default_rng(D * 100 + len(skew))
    local_n = 97
    for _ in range(3):
        counts = _random_counts(rng, D, local_n, skew)
        operands = [rng.integers(0, 1 << 32, local_n, dtype=np.uint32) for _ in range(D)]
        # a block capacity of local_n and a receiver budget of D*local_n fit
        # any split: nothing may overflow and every block lands whole
        outs, totals, overflow, offsets = _exchange(
            operands, counts, local_n, D * local_n, _PAD_KEY
        )
        assert not any(overflow)
        for d in range(D):
            blocks = [operands[s][offsets[s, d]: offsets[s, d] + counts[s, d]]
                      for s in range(D)]
            assert totals[d] == counts[:, d].sum()
            np.testing.assert_array_equal(outs[d], _packed(blocks, D * local_n, _PAD_KEY))


@pytest.mark.parametrize("D", [2, 4, 8])
def test_padded_exchange_reports_block_overflow(D):
    """A block larger than the capacity raises the sender's overflow flag;
    receivers whose totals still fit the budget get the exact packed layout
    of what was sent."""
    rng = np.random.default_rng(D)
    local_n = 64
    capacity = local_n // D + 3
    for trial in range(6):
        counts = _random_counts(rng, D, local_n, "one-hot" if trial % 2 else "uniform")
        operands = [rng.integers(0, 1 << 32, local_n, dtype=np.uint32) for _ in range(D)]
        budget = int(1.25 * local_n)
        outs, totals, overflow, offsets = _exchange(operands, counts, capacity, budget, 0)
        assert overflow == [bool((counts[s] > capacity).any()) for s in range(D)]
        sent = np.minimum(counts, capacity)
        for d in range(D):
            assert totals[d] == sent[:, d].sum()
            if totals[d] <= budget:
                blocks = [operands[s][offsets[s, d]: offsets[s, d] + sent[s, d]]
                          for s in range(D)]
                np.testing.assert_array_equal(outs[d], _packed(blocks, budget, 0))


@pytest.mark.parametrize("D,C", [(2, 2), (4, 2), (4, 4), (8, 3)])
def test_chunked_exchange_is_source_major_chunk_minor(D, C):
    """Source s's chunk c holds smaller global indices than its chunk c+1, so
    each receiver must hold the blocks in (source, chunk) order; pads past
    the count hold the key fill."""
    rng = np.random.default_rng(D * 10 + C)
    chunk_n = 48
    local_n = C * chunk_n
    keys = rng.integers(0, 1 << 32, D * local_n, dtype=np.uint32)
    vals = np.arange(D * local_n, dtype=np.uint32)
    bucket = rng.integers(0, D, D * local_n).astype(np.int32)
    mesh = make_sort_mesh(jax.devices()[:D])
    spec = jax.sharding.PartitionSpec("shards")
    recv = D * local_n

    def body(k, v, b):
        out, count, overflow = _exchange_and_sort_chunked(
            [k, v], [_PAD_KEY, 0], b, lambda *a: a, axis_name="shards",
            num_devices=D, capacity=chunk_n, recv_capacity=recv, num_chunks=C,
        )
        return out[0], out[1], count[None], overflow[None]

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec, spec, spec),
                               out_specs=(spec,) * 4, check_vma=False))
    ok, ov, count, overflow = map(np.asarray, fn(keys, vals, bucket))
    assert not overflow.any()
    for d in range(D):
        idx = [
            np.flatnonzero(bucket[s * local_n + c * chunk_n: s * local_n + (c + 1) * chunk_n] == d)
            + s * local_n + c * chunk_n
            for s in range(D) for c in range(C)
        ]
        want = np.concatenate(idx)
        assert count[d] == want.size
        np.testing.assert_array_equal(ok[d * recv:(d + 1) * recv],
                                      _packed([keys[want]], recv, _PAD_KEY))
        np.testing.assert_array_equal(ov[d * recv:(d + 1) * recv], _packed([want], recv, 0))
