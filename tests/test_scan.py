"""Blelloch scan tests — mirrors reference test/blelloch_scan_tests.cpp
(exclusive_scan oracle, exact equality, partition batches) plus gaps: non-
power-of-2 lengths (functional form), u32 wraparound, int dtype, and the
non-sum operators (mul/min/max — the reference hardcodes `+`,
BlellochScan.hpp:99-100)."""

import jax.numpy as jnp
import numpy as np
import pytest

from glu_tpu import (
    BlellochScan,
    DataType,
    DeviceBuffer,
    ReduceOperator,
    exclusive_scan,
    inclusive_scan,
)
from glu_tpu.ops.reduce import identity_for
from glu_tpu.utils.errors import GluArgumentError

_UFUNCS = {
    ReduceOperator.SUM: np.add,
    ReduceOperator.MUL: np.multiply,
    ReduceOperator.MIN: np.minimum,
    ReduceOperator.MAX: np.maximum,
}


def _oracle(x: np.ndarray, num_partitions: int = 1) -> np.ndarray:
    part = x.size // num_partitions
    seg = x.reshape(num_partitions, part)
    inc = np.cumsum(seg, axis=1, dtype=x.dtype)
    return (inc - seg).reshape(x.size)


def _oracle_op(
    x: np.ndarray, op: ReduceOperator, num_partitions: int = 1, inclusive: bool = False
) -> np.ndarray:
    seg = x.reshape(num_partitions, x.size // num_partitions)
    inc = _UFUNCS[op].accumulate(seg, axis=1).astype(x.dtype)
    if inclusive:
        return inc.reshape(x.size)
    first = np.full((num_partitions, 1), identity_for(op, x.dtype), x.dtype)
    return np.concatenate([first, inc[:, :-1]], axis=1).reshape(x.size)


@pytest.mark.parametrize("size", [1024, 4096, 65536, 1 << 20])
def test_scan_multiple_sizes(size, call_mode, seeded_rng):
    # analog of BlellochScan-multiple-sizes (reference blelloch_scan_tests.cpp:28-46):
    # power-of-2 sizes 1K..1M, exact (bitwise) equality
    rng = seeded_rng(size)
    data = rng.sample_int_vector(size, 0, 1000)
    got = np.asarray(call_mode(exclusive_scan, jnp.asarray(data)))
    np.testing.assert_array_equal(got, _oracle(data))


@pytest.mark.parametrize("num_partitions", [1, 32, 100, 1000])
def test_scan_multiple_partitions(num_partitions, call_mode, seeded_rng):
    # analog of BlellochScan-multiple-partitions (blelloch_scan_tests.cpp:48-82):
    # 1024-element partitions scanned independently in one batched call
    part = 1024
    rng = seeded_rng(num_partitions)
    data = rng.sample_int_vector(part * num_partitions, 0, 100)
    got = np.asarray(call_mode(exclusive_scan, jnp.asarray(data), num_partitions=num_partitions))
    np.testing.assert_array_equal(got, _oracle(data, num_partitions))


@pytest.mark.parametrize("size", [1, 5, 100, 1000, 12345, 99999])
def test_scan_non_power_of_2(size, call_mode, seeded_rng):
    # the reference requires power-of-2 (BlellochScan.hpp:134, with a TODO to
    # lift it) — the functional form lifts it; verify padding never leaks
    rng = seeded_rng(size)
    data = rng.sample_int_vector(size, 0, 1000)
    got = np.asarray(call_mode(exclusive_scan, jnp.asarray(data)))
    np.testing.assert_array_equal(got, _oracle(data))


def test_scan_wraps_mod_2_32(call_mode):
    data = np.full(1024, 0x80000001, dtype=np.uint32)
    got = np.asarray(call_mode(exclusive_scan, jnp.asarray(data)))
    np.testing.assert_array_equal(got, _oracle(data))


def test_scan_int32(call_mode):
    data = np.array([3, -1, 4, -1, 5, -9, 2, 6] * 4, dtype=np.int32)
    got = np.asarray(call_mode(exclusive_scan, jnp.asarray(data)))
    np.testing.assert_array_equal(got, _oracle(data))


def test_scan_class_requires_power_of_2():
    # parity with reference check at BlellochScan.hpp:134
    scan = BlellochScan(DataType.UINT)
    buf = DeviceBuffer(np.arange(100, dtype=np.uint32))
    with pytest.raises(GluArgumentError):
        scan(buf, 100)


def test_scan_class_in_place():
    scan = BlellochScan(DataType.UINT)
    data = np.arange(1, 17, dtype=np.uint32)
    buf = DeviceBuffer(data)
    scan(buf, 16)
    np.testing.assert_array_equal(buf.get_data(), _oracle(data))


_NON_SUM = [ReduceOperator.MUL, ReduceOperator.MIN, ReduceOperator.MAX]


@pytest.mark.parametrize("op", _NON_SUM)
@pytest.mark.parametrize("size", [1, 100, 1024, 12345, 99999])
def test_scan_ops_u32(op, size, call_mode, seeded_rng):
    # mul/min/max exclusive scans (reference hardcodes `+`); sizes cross the
    # non-pow-2 padding and the multi-block carry chain (99999 -> 2 blocks)
    rng = seeded_rng(size * 10 + op.value)
    data = rng.sample_int_vector(size, 0, 0xFFFFFFFF)
    if op == ReduceOperator.MUL:
        data = (data | 1).astype(np.uint32)  # odd factors: u32 products wrap, stay nonzero
    got = np.asarray(call_mode(exclusive_scan, jnp.asarray(data), op=op))
    np.testing.assert_array_equal(got, _oracle_op(data, op))


@pytest.mark.parametrize("op", _NON_SUM)
@pytest.mark.parametrize("num_partitions", [4, 100])
def test_scan_ops_partitions(op, num_partitions, call_mode, seeded_rng):
    # the carry must reset to the op identity at every partition boundary
    part = 512
    rng = seeded_rng(num_partitions + op.value)
    data = rng.sample_int_vector(part * num_partitions, 0, 0xFFFFFFFF)
    got = np.asarray(
        call_mode(exclusive_scan, jnp.asarray(data), num_partitions=num_partitions, op=op)
    )
    np.testing.assert_array_equal(got, _oracle_op(data, op, num_partitions))


@pytest.mark.parametrize("op", [ReduceOperator.MIN, ReduceOperator.SUM])
def test_scan_partitions_multiblock(op, call_mode, seeded_rng):
    # partition length 131072 = exactly 2 x 512-row blocks: the carry must
    # chain across blocks WITHIN a partition and reset at the boundary
    part = 512 * 128 * 2
    rng = seeded_rng(42 + op.value)
    data = rng.sample_int_vector(part * 2, 0, 0xFFFFFFFF)
    got = np.asarray(call_mode(exclusive_scan, jnp.asarray(data), num_partitions=2, op=op))
    np.testing.assert_array_equal(got, _oracle_op(data, op, 2))


@pytest.mark.parametrize("op", [ReduceOperator.MIN, ReduceOperator.MAX])
def test_scan_ops_int32_negatives(op, call_mode):
    data = np.array([3, -1, 4, -1, 5, -9, 2, 6, -2147483648, 2147483647] * 200, dtype=np.int32)
    got = np.asarray(call_mode(exclusive_scan, jnp.asarray(data), op=op))
    np.testing.assert_array_equal(got, _oracle_op(data, op))


@pytest.mark.parametrize("op", [ReduceOperator.MIN, ReduceOperator.MAX])
def test_scan_ops_f32(op, call_mode, seeded_rng):
    rng = seeded_rng(7 + op.value)
    data = (
        rng.sample_int_vector(5000, 0, 2_000_000).astype(np.int64) - 1_000_000
    ).astype(np.float32)
    got = np.asarray(call_mode(exclusive_scan, jnp.asarray(data), op=op))
    np.testing.assert_array_equal(got, _oracle_op(data, op))


def test_scan_mul_wraps_mod_2_32(call_mode):
    data = np.full(4096, 0x80000003, dtype=np.uint32)
    got = np.asarray(call_mode(exclusive_scan, jnp.asarray(data), op=ReduceOperator.MUL))
    np.testing.assert_array_equal(got, _oracle_op(data, ReduceOperator.MUL))


@pytest.mark.parametrize("op", list(_UFUNCS))
def test_inclusive_scan(op, call_mode, seeded_rng):
    rng = seeded_rng(op.value)
    data = rng.sample_int_vector(10000, 0, 0xFFFFFFFF)
    got = np.asarray(call_mode(inclusive_scan, jnp.asarray(data), op=op))
    np.testing.assert_array_equal(got, _oracle_op(data, op, inclusive=True))


def test_scan_class_operator():
    # class form with a non-default operator (superset of the reference ctor)
    scan = BlellochScan(DataType.UINT, ReduceOperator.MAX)
    data = np.array([5, 3, 9, 1, 7, 2, 8, 4] * 2, dtype=np.uint32)
    buf = DeviceBuffer(data)
    scan(buf, 16)
    np.testing.assert_array_equal(buf.get_data(), _oracle_op(data, ReduceOperator.MAX))


def test_scan_rejects_bad_operator():
    with pytest.raises(GluArgumentError):
        exclusive_scan(jnp.arange(8, dtype=jnp.uint32), op="sum")


def test_scan_class_partitions_subset():
    # scanning count*num_partitions elements of a larger buffer, as
    # RadixSort does with its [16][num_blocks_pow2] table (RadixSort.hpp:311)
    scan = BlellochScan(DataType.UINT)
    data = np.arange(64, dtype=np.uint32)
    buf = DeviceBuffer(data)
    scan(buf, 8, 4)  # scans first 32 elements as 4 partitions of 8
    np.testing.assert_array_equal(buf.get_data()[:32], _oracle(data[:32], 4))
    np.testing.assert_array_equal(buf.get_data()[32:], data[32:])


def _seg_oracle(data, offs, inclusive):
    out = np.zeros_like(data)
    for s in range(len(offs) - 1):
        seg = data[offs[s] : offs[s + 1]]
        c = np.cumsum(seg.astype(np.uint64)).astype(data.dtype)
        out[offs[s] : offs[s + 1]] = c if inclusive else np.concatenate([[data.dtype.type(0)], c[:-1]])
    return out


@pytest.mark.parametrize("inclusive", [False, True])
def test_scan_segmented_offsets(inclusive, call_mode, seeded_rng):
    # ragged segmented scan (offsets form) — variable-length segments incl.
    # empty first/middle/last ones, vs a per-segment numpy oracle
    from glu_tpu import exclusive_scan as ex, inclusive_scan as inc

    rng = seeded_rng(61)
    n = 3000
    offs = np.array([0, 0, 5, 5, 700, 701, 2999, 3000, 3000], np.int32)
    data = rng.sample_int_vector(n, 0, 2**32 - 1)
    fn = inc if inclusive else ex
    out = np.asarray(call_mode(fn, jnp.asarray(data), offsets=jnp.asarray(offs)))
    np.testing.assert_array_equal(out, _seg_oracle(data, offs, inclusive))


@pytest.mark.parametrize("trial", range(4))
def test_scan_segmented_offsets_fuzz(trial, call_mode, seeded_rng):
    from glu_tpu import exclusive_scan as ex

    rng = seeded_rng(600 + trial)
    n = int(rng.rng.integers(1, 5000))
    s = int(rng.rng.integers(1, 30))
    cuts = np.sort(rng.rng.integers(0, n + 1, s - 1)).astype(np.int32)
    offs = np.concatenate([[0], cuts, [n]]).astype(np.int32)
    data = rng.sample_int_vector(n, 0, 2**32 - 1)
    out = np.asarray(call_mode(ex, jnp.asarray(data), offsets=jnp.asarray(offs)))
    np.testing.assert_array_equal(out, _seg_oracle(data, offs, False))


def test_scan_segmented_offsets_contract(call_mode):
    from glu_tpu import exclusive_scan as ex

    x = jnp.arange(10, dtype=jnp.uint32)
    with pytest.raises(GluArgumentError):  # bad boundary
        call_mode(ex, x, offsets=jnp.array([1, 10], jnp.int32))
    with pytest.raises(GluArgumentError):  # combined with partitions
        call_mode(ex, x, num_partitions=2, offsets=jnp.array([0, 10], jnp.int32))
    with pytest.raises(GluArgumentError):  # vector input
        call_mode(ex, jnp.ones((8, 2), jnp.uint32), offsets=jnp.array([0, 8], jnp.int32))


_RAGGED_OPS = [
    (ReduceOperator.SUM, np.add),
    (ReduceOperator.MUL, np.multiply),
    (ReduceOperator.MIN, np.minimum),
    (ReduceOperator.MAX, np.maximum),
]


def _ragged_oracle(data, offs, acc, ident, inclusive):
    want = np.empty_like(data)
    for s in range(len(offs) - 1):
        run = np.array(ident, dtype=data.dtype)
        for i in range(offs[s], offs[s + 1]):
            if not inclusive:
                want[i] = run
            run = acc(run, data[i])
            if inclusive:
                want[i] = run
    return want


@pytest.mark.parametrize("op,acc", _RAGGED_OPS)
@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32])
@pytest.mark.parametrize("inclusive", [False, True])
def test_scan_segmented_offsets_all_ops(op, acc, dtype, inclusive, call_mode, seeded_rng):
    """Ragged (offsets=) scans under ALL FOUR operators and float
    dtypes — min/max/mul ride the flagged-combine segmented scan, integer
    SUM the O(n) subtract composition. Fuzzed vs a python
    oracle including empty segments."""
    from glu_tpu import exclusive_scan, inclusive_scan
    from glu_tpu.ops.reduce import identity_for as ident_for

    rng = seeded_rng(500 + op.value)
    n = 300
    if np.issubdtype(dtype, np.floating):
        data = rng.rng.uniform(0.5, 1.5, size=n).astype(dtype)
    elif dtype == np.int32:
        data = rng.rng.integers(-3, 4, size=n).astype(dtype)
    else:
        data = rng.rng.integers(1, 3, size=n).astype(dtype)
    cuts = np.sort(rng.rng.integers(0, n + 1, size=7))
    offs = np.concatenate([[0], cuts, [n]]).astype(np.int32)  # incl. empties
    fn = inclusive_scan if inclusive else exclusive_scan
    got = np.asarray(call_mode(fn, jnp.asarray(data), op=op, offsets=jnp.asarray(offs)))
    want = _ragged_oracle(data, offs, acc, ident_for(op, dtype), inclusive)
    if np.issubdtype(dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "data_type",
    [
        DataType.FLOAT, DataType.DOUBLE, DataType.INT, DataType.UINT,
        DataType.VEC2, DataType.VEC4, DataType.DVEC2, DataType.DVEC4,
        DataType.UVEC2, DataType.UVEC4, DataType.IVEC2, DataType.IVEC4,
    ],
)
@pytest.mark.parametrize(
    "op",
    [ReduceOperator.SUM, ReduceOperator.MUL, ReduceOperator.MIN, ReduceOperator.MAX],
)
def test_scan_all_types(data_type, op, call_mode, seeded_rng):
    """Scan dtype battery, mirroring test_reduce_all_types: every
    (DataType, op) pair through exclusive_scan, vectors per component
    (reference BlellochScan ctor accepts any DataType,
    BlellochScan.hpp:96-102; this build actually exercises them)."""
    from glu_tpu import dtype_info

    info = dtype_info(data_type)
    rng = seeded_rng(9)
    n = 64
    shape = (n,) + info.element_shape()
    if jnp.issubdtype(info.dtype, jnp.floating):
        host = rng.rng.uniform(0.5, 1.5, size=shape)
    elif info.dtype == jnp.int32:
        host = rng.rng.integers(-3, 4, size=shape)
    else:
        host = rng.rng.integers(1, 3, size=shape)
    host = host.astype(np.dtype(info.dtype.name))
    got = np.asarray(call_mode(exclusive_scan, jnp.asarray(host), num_partitions=2, op=op))
    # numpy oracle: per-partition, per-component exclusive scan
    acc = {
        ReduceOperator.SUM: np.add, ReduceOperator.MUL: np.multiply,
        ReduceOperator.MIN: np.minimum, ReduceOperator.MAX: np.maximum,
    }[op]
    ident = identity_for(op, info.dtype)
    want = np.empty_like(host)
    part = n // 2
    for p in range(2):
        run = np.full(shape[1:], ident, dtype=host.dtype)
        for i in range(part):
            want[p * part + i] = run
            run = acc(run, host[p * part + i])
    if jnp.issubdtype(info.dtype, jnp.floating):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("data_type", [DataType.UVEC2, DataType.VEC4])
def test_blelloch_scan_class_vector(data_type, seeded_rng):
    from glu_tpu import dtype_info

    info = dtype_info(data_type)
    rng = seeded_rng(11)
    n = 32
    host = rng.rng.integers(0, 9, size=(n, info.components)).astype(
        np.dtype(info.dtype.name)
    )
    scan = BlellochScan(data_type)
    got = np.asarray(scan(jnp.asarray(host), n))
    want = np.cumsum(host, axis=0, dtype=host.dtype) - host
    np.testing.assert_array_equal(got, want)
    # wrong trailing shape rejected
    with pytest.raises(GluArgumentError):
        scan(jnp.asarray(host[:, :1]), n)


def test_scan_inclusive_vector(call_mode, seeded_rng):
    rng = seeded_rng(12)
    host = rng.rng.integers(0, 9, size=(24, 4)).astype(np.uint32)
    got = np.asarray(call_mode(inclusive_scan, jnp.asarray(host)))
    np.testing.assert_array_equal(got, np.cumsum(host, axis=0, dtype=np.uint32))


def test_scan_offsets_rejects_vector():
    with pytest.raises(GluArgumentError):
        exclusive_scan(jnp.ones((8, 2), jnp.uint32), offsets=jnp.array([0, 8]))
