"""Reduce tests — mirrors reference test/reduce_tests.cpp (same structure:
seeded random input -> run operator -> compare with a host oracle), plus the
gaps SURVEY §4 flags: negative ints, all four operators at every size, and
vector types under every operator."""

import jax.numpy as jnp
import numpy as np
import pytest

from glu_tpu import DataType, DeviceBuffer, Reduce, ReduceOperator, reduce

OPS = [ReduceOperator.SUM, ReduceOperator.MUL, ReduceOperator.MIN, ReduceOperator.MAX]

_NP_OP = {
    ReduceOperator.SUM: np.sum,
    ReduceOperator.MUL: np.prod,
    ReduceOperator.MIN: np.min,
    ReduceOperator.MAX: np.max,
}


def _oracle(x: np.ndarray, op: ReduceOperator) -> np.ndarray:
    return _NP_OP[op](x, axis=0, dtype=x.dtype) if op in (ReduceOperator.SUM, ReduceOperator.MUL) else _NP_OP[op](x, axis=0)


@pytest.mark.parametrize("op", OPS)
def test_reduce_simple_uint(op, call_mode):
    # analog of Reduce-simple-uint (reference test/reduce_tests.cpp:14-52)
    data = np.arange(1, 101, dtype=np.uint32)
    got = call_mode(reduce, jnp.asarray(data), op=op)
    assert np.asarray(got) == _oracle(data, op)


@pytest.mark.parametrize(
    "data_type",
    [
        DataType.FLOAT, DataType.DOUBLE, DataType.INT, DataType.UINT,
        DataType.VEC2, DataType.VEC4, DataType.DVEC2, DataType.DVEC4,
        DataType.UVEC2, DataType.UVEC4, DataType.IVEC2, DataType.IVEC4,
    ],
)
@pytest.mark.parametrize("op", OPS)
def test_reduce_all_types(data_type, op, call_mode, seeded_rng):
    # analog of Reduce-all (reference test/reduce_tests.cpp:54-145), widened
    # to every (dtype, op) pair including negatives for signed types
    from glu_tpu import dtype_info

    info = dtype_info(data_type)
    rng = seeded_rng(3)
    n = 64
    shape = (n,) + info.element_shape()
    if jnp.issubdtype(info.dtype, jnp.floating):
        host = rng.rng.uniform(0.5, 1.5, size=shape)
    elif info.dtype == jnp.int32:
        host = rng.rng.integers(-3, 4, size=shape)
    else:
        host = rng.rng.integers(1, 3, size=shape)
    host = host.astype(np.dtype(info.dtype.name))
    got = np.asarray(call_mode(reduce, jnp.asarray(host), op=op))
    want = _oracle(host, op)
    if jnp.issubdtype(info.dtype, jnp.floating):
        # float tolerance, as the reference uses WithinAbs (reduce_tests.cpp:72)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [32, 1024, 4096, 131072])
def test_reduce_fitting_sizes(size, call_mode, seeded_rng):
    # analog of Reduce-subgroup-fitting-size (reference reduce_tests.cpp:147-164)
    rng = seeded_rng(1)
    data = rng.sample_int_vector(size, 0, 100)
    got = call_mode(reduce, jnp.asarray(data), op=ReduceOperator.SUM)
    assert np.uint32(np.asarray(got)) == np.sum(data, dtype=np.uint32)


@pytest.mark.parametrize("size", [1, 31, 93, 201, 693, 2087, 7358, 88289, 345897])
@pytest.mark.parametrize("op", OPS)
def test_reduce_non_fitting_sizes(size, op, call_mode, seeded_rng):
    # analog of Reduce-subgroup-non-fitting-size (reference reduce_tests.cpp:166-183):
    # adversarial non-power-of-2 sizes must not read padding as data
    rng = seeded_rng(size)
    lo = 1 if op == ReduceOperator.MUL else 0
    data = rng.sample_int_vector(size, lo, 1 if op == ReduceOperator.MUL else 1000)
    got = np.asarray(call_mode(reduce, jnp.asarray(data), op=op))
    assert np.uint32(got) == _oracle(data, op)


def test_reduce_sum_wraps_mod_2_32(call_mode):
    # u32 sums wrap exactly like GLSL uint arithmetic
    data = np.full(16, 0xF0000000, dtype=np.uint32)
    got = call_mode(reduce, jnp.asarray(data), op=ReduceOperator.SUM)
    assert np.uint32(np.asarray(got)) == np.uint32((16 * 0xF0000000) % (1 << 32))


def test_reduce_class_writes_index_0():
    # class form leaves the result at buffer[0] (reference Reduce.hpp:131-134)
    buf = DeviceBuffer(np.arange(1, 11, dtype=np.uint32))
    op = Reduce(DataType.UINT, ReduceOperator.SUM)
    result = op(buf, 10)
    assert int(result) == 55
    assert buf.get_data()[0] == 55


def test_reduce_count_subset():
    # reducing only the first `count` elements, as the reference's
    # operator()(buffer, count) does
    buf = DeviceBuffer(np.arange(1, 11, dtype=np.uint32))
    op = Reduce(DataType.UINT, ReduceOperator.SUM)
    assert int(op(buf, 4)) == 10


def _segred_oracle(data, offs):
    return np.array(
        [np.uint32(data[offs[s] : offs[s + 1]].astype(np.uint64).sum() & 0xFFFFFFFF)
         for s in range(len(offs) - 1)],
        dtype=np.uint32,
    )


def test_segmented_reduce(call_mode, seeded_rng):
    from glu_tpu import segmented_reduce

    rng = seeded_rng(73)
    n = 3000
    offs = np.array([0, 0, 5, 5, 700, 701, 2999, 3000, 3000], np.int32)
    data = rng.sample_int_vector(n, 0, 2**32 - 1)
    out = np.asarray(
        call_mode(segmented_reduce, jnp.asarray(data), jnp.asarray(offs))
    )
    np.testing.assert_array_equal(out, _segred_oracle(data, offs))


@pytest.mark.parametrize("trial", range(4))
def test_segmented_reduce_fuzz(trial, call_mode, seeded_rng):
    from glu_tpu import segmented_reduce

    rng = seeded_rng(800 + trial)
    n = int(rng.rng.integers(1, 4000))
    s = int(rng.rng.integers(1, 25))
    cuts = np.sort(rng.rng.integers(0, n + 1, s - 1)).astype(np.int32)
    offs = np.concatenate([[0], cuts, [n]]).astype(np.int32)
    data = rng.sample_int_vector(n, 0, 2**32 - 1)
    out = np.asarray(
        call_mode(segmented_reduce, jnp.asarray(data), jnp.asarray(offs))
    )
    np.testing.assert_array_equal(out, _segred_oracle(data, offs))


def test_segmented_reduce_contract(call_mode):
    from glu_tpu import ReduceOperator, segmented_reduce
    from glu_tpu.utils.errors import GluArgumentError

    x = jnp.arange(10, dtype=jnp.uint32)
    with pytest.raises(GluArgumentError):  # bad bounds
        call_mode(segmented_reduce, x, offsets=jnp.array([0, 9], jnp.int32))
    with pytest.raises(GluArgumentError):  # 2-D input
        call_mode(
            segmented_reduce, jnp.ones((8, 2), jnp.uint32), offsets=jnp.array([0, 8], jnp.int32)
        )


@pytest.mark.parametrize(
    "op,acc",
    [
        (ReduceOperator.SUM, np.add), (ReduceOperator.MUL, np.multiply),
        (ReduceOperator.MIN, np.minimum), (ReduceOperator.MAX, np.maximum),
    ],
)
@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32])
def test_segmented_reduce_all_ops(op, acc, dtype, call_mode, seeded_rng):
    """segmented_reduce under ALL FOUR operators and float dtypes; empty
    segments reduce to the operator identity."""
    from glu_tpu import segmented_reduce
    from glu_tpu.ops.reduce import identity_for

    rng = seeded_rng(600 + op.value)
    n = 257
    if np.issubdtype(dtype, np.floating):
        data = rng.rng.uniform(0.5, 1.5, size=n).astype(dtype)
    elif dtype == np.int32:
        data = rng.rng.integers(-3, 4, size=n).astype(dtype)
    else:
        data = rng.rng.integers(1, 3, size=n).astype(dtype)
    cuts = np.sort(rng.rng.integers(0, n + 1, size=9))
    offs = np.concatenate([[0], cuts, [n]]).astype(np.int32)
    got = np.asarray(
        call_mode(segmented_reduce, jnp.asarray(data), jnp.asarray(offs), op=op)
    )
    ident = identity_for(op, dtype)
    want = np.array(
        [
            acc.reduce(data[offs[s]:offs[s + 1]]) if offs[s + 1] > offs[s] else ident
            for s in range(len(offs) - 1)
        ],
        dtype=dtype,
    )
    if np.issubdtype(dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    else:
        np.testing.assert_array_equal(got, want)
