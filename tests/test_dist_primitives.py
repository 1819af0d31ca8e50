"""Distributed reduce/scan tests on the 8-virtual-device CPU mesh —
the multi-device layer across the remaining two primitives (the sort's
tests live in test_dist_sort.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from glu_tpu import ReduceOperator
from glu_tpu.native import get_oracle
from glu_tpu.parallel import (
    distributed_exclusive_scan,
    distributed_inclusive_scan,
    distributed_reduce,
    make_sort_mesh,
)

_OPS = {
    "sum": ReduceOperator.SUM,
    "mul": ReduceOperator.MUL,
    "min": ReduceOperator.MIN,
    "max": ReduceOperator.MAX,
}


def _sharded(x, mesh):
    sh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("shards"))
    return jax.device_put(jnp.asarray(x), sh)


@pytest.mark.parametrize("opname", list(_OPS))
def test_dist_reduce(opname, call_mode, seeded_rng):
    mesh = make_sort_mesh(jax.devices()[:8])
    rng = seeded_rng(20)
    x = rng.sample_int_vector(8 * 4096, 0, 0xFFFFFFFE)
    if opname == "mul":
        x = (x | 1).astype(np.uint32)
    got = np.asarray(
        call_mode(distributed_reduce, _sharded(x, mesh), mesh=mesh, op=_OPS[opname])
    )
    assert got == get_oracle().reduce_u32(x, opname)


@pytest.mark.parametrize("opname", list(_OPS))
def test_dist_exclusive_scan(opname, call_mode, seeded_rng):
    mesh = make_sort_mesh(jax.devices()[:8])
    rng = seeded_rng(21)
    x = rng.sample_int_vector(8 * 2048, 0, 0xFFFFFFFE)
    got = np.asarray(
        call_mode(distributed_exclusive_scan, _sharded(x, mesh), mesh=mesh, op=_OPS[opname])
    )
    np.testing.assert_array_equal(got, get_oracle().exclusive_scan_op(x, 1, opname))


def test_dist_inclusive_scan(call_mode, seeded_rng):
    mesh = make_sort_mesh(jax.devices()[:8])
    rng = seeded_rng(22)
    x = rng.sample_int_vector(8 * 1024, 0, 0xFFFFFFFE)
    got = np.asarray(
        call_mode(distributed_inclusive_scan, _sharded(x, mesh), mesh=mesh)
    )
    np.testing.assert_array_equal(got, np.cumsum(x, dtype=np.uint32))


def test_dist_scan_two_devices(seeded_rng):
    # D=2: the exclusive total-fold loop has exactly one step
    mesh = make_sort_mesh(jax.devices()[:2])
    rng = seeded_rng(23)
    x = rng.sample_int_vector(2 * 512, 0, 100)
    got = np.asarray(distributed_exclusive_scan(_sharded(x, mesh), mesh))
    np.testing.assert_array_equal(got, get_oracle().exclusive_scan(x))
