"""Distributed reduce and exclusive scan over a device mesh.

Completes the multi-device layer across all three primitives (the sort
lives in dist_sort.py; the reference itself is single-GPU, SURVEY.md §2.3).
Both compose the single-chip operators under `jax.shard_map`:

  - reduce: local reduce per shard, then a tiny all-gather of the D partial
    results combined on every device (uniform across all four operators —
    XLA has no pprod, and for D scalars the gather+fold costs nothing);
  - exclusive scan: local exclusive scan per shard, an all-gather of the D
    shard totals, and an exclusive fold of the totals below this device's
    mesh index — the classic scan-of-scans decomposition, with the level-2
    scan running on D scalars.

Both support sum/mul/min/max via the shared ReduceOperator enum, matching
the single-chip surfaces.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.reduce import ReduceOperator, combine_fn, identity_for, reduce
from ..ops.scan import exclusive_scan
from ..utils.errors import check_argument


def _check_1d_sharded(x, mesh, axis_name):
    num_devices = mesh.shape[axis_name]
    check_argument(x.ndim == 1, "expected a 1-D array, got shape %s", x.shape)
    check_argument(
        x.shape[0] % num_devices == 0,
        "global length %d not divisible by %d devices",
        x.shape[0],
        num_devices,
    )
    return num_devices


def distributed_reduce(
    x: jax.Array,
    mesh: jax.sharding.Mesh,
    op: ReduceOperator = ReduceOperator.SUM,
    *,
    axis_name: str = "shards",
) -> jax.Array:
    """Reduce a sharded 1-D array to one global scalar (replicated on every
    device). Wrapping u32 sum/mul semantics match the single-chip reduce."""
    _check_1d_sharded(x, mesh, axis_name)
    check_argument(isinstance(op, ReduceOperator), "Invalid operator: %s", op)
    combine = combine_fn(op)
    spec = jax.sharding.PartitionSpec(axis_name)

    def body(xs):
        local = reduce(xs, op)
        partials = jax.lax.all_gather(local, axis_name)  # (D,) tiny
        total = partials[0]
        for d in range(1, partials.shape[0]):
            total = combine(total, partials[d])
        return total[None]

    fn = jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(spec,),
            out_specs=jax.sharding.PartitionSpec(),
            check_vma=False,
        )
    )
    return fn(x)[0]


def distributed_exclusive_scan(
    x: jax.Array,
    mesh: jax.sharding.Mesh,
    op: ReduceOperator = ReduceOperator.SUM,
    *,
    axis_name: str = "shards",
) -> jax.Array:
    """Exclusive prefix scan of a sharded 1-D array under `op`, sharded the
    same way on output: element i receives op-fold of elements [0, i) in
    GLOBAL order (device-major shards, matching the dist sort's index
    convention)."""
    num_devices = _check_1d_sharded(x, mesh, axis_name)
    check_argument(isinstance(op, ReduceOperator), "Invalid operator: %s", op)
    combine = combine_fn(op)
    spec = jax.sharding.PartitionSpec(axis_name)

    def body(xs):
        local_exc = exclusive_scan(xs, 1, op)
        # shard total = op(exclusive[-1], x[-1]) — avoids a second reduction
        local_tot = combine(local_exc[-1], xs[-1])
        totals = jax.lax.all_gather(local_tot, axis_name)  # (D,) tiny
        me = jax.lax.axis_index(axis_name)
        prefix = jnp.full((), identity_for(op, xs.dtype), xs.dtype)
        for d in range(num_devices - 1):
            prefix = jnp.where(d < me, combine(prefix, totals[d]), prefix)
        return combine(local_exc, prefix)

    fn = jax.jit(
        jax.shard_map(
            body, mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False
        )
    )
    return fn(x)


def distributed_inclusive_scan(
    x: jax.Array,
    mesh: jax.sharding.Mesh,
    op: ReduceOperator = ReduceOperator.SUM,
    *,
    axis_name: str = "shards",
) -> jax.Array:
    """Inclusive variant: `op(exclusive, x)` elementwise (exact for every
    operator, wrapping arithmetic included)."""
    exc = distributed_exclusive_scan(x, mesh, op, axis_name=axis_name)
    return combine_fn(op)(exc, x)
