"""Parallel Reduce (sum / mul / min / max).

A JAX re-design of reference glu/Reduce.hpp. The reference runs a radix-32
subgroup tree: ceil(log32 N) dispatches, each lane reducing 32 strided
elements in place (Reduce.hpp:121-134, kernel at :24-37). Here the whole
tree is one XLA reduction, which the compiler fuses and tiles for the device
— no host round trips, no destructive in-place partials.

Differences from the reference (deliberate):
  - not destructive: input is untouched; the result is returned (the
    reference overwrites the buffer and leaves the answer at data[0],
    Reduce.hpp:131-134);
  - any N >= 1 with no per-lane bounds checks (Reduce.hpp:28): XLA
    handles the ragged tail;
  - class form `Reduce(dtype, op)(buffer, count)` preserves the reference's
    call shape, writing the result to buffer[0] as the reference does.
"""

from __future__ import annotations

import enum
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.buffers import DeviceBuffer
from ..utils.dtypes import DataType, check_dtype_supported
from ..utils.errors import check_argument


class ReduceOperator(enum.Enum):
    """Reduction operators (reference glu/Reduce.hpp:42-48)."""

    SUM = 0
    MUL = 1
    MIN = 2
    MAX = 3


_OP_NAMES = {
    ReduceOperator.SUM: "sum",
    ReduceOperator.MUL: "mul",
    ReduceOperator.MIN: "min",
    ReduceOperator.MAX: "max",
}


def identity_for(op: ReduceOperator, dtype) -> np.generic:
    """Identity element of `op` for `dtype`: what an empty segment reduces
    to and what seeds each partition of an exclusive scan."""
    dtype = jnp.dtype(dtype)
    if op == ReduceOperator.SUM:
        return dtype.type(0)
    if op == ReduceOperator.MUL:
        return dtype.type(1)
    if op == ReduceOperator.MIN:
        if jnp.issubdtype(dtype, jnp.floating):
            return dtype.type(np.inf)
        return dtype.type(np.iinfo(dtype).max)
    if op == ReduceOperator.MAX:
        if jnp.issubdtype(dtype, jnp.floating):
            return dtype.type(-np.inf)
        return dtype.type(np.iinfo(dtype).min)
    raise ValueError(f"invalid op {op}")


def combine_fn(op: ReduceOperator):
    """Binary combiner for an operator (associative + commutative)."""
    return {
        ReduceOperator.SUM: jnp.add,
        ReduceOperator.MUL: jnp.multiply,
        ReduceOperator.MIN: jnp.minimum,
        ReduceOperator.MAX: jnp.maximum,
    }[op]


@partial(jax.jit, static_argnames=("op",))
def _reduce_impl(x: jax.Array, op: ReduceOperator) -> jax.Array:
    # XLA builds the reduction tree. The accumulator
    # dtype is pinned to the input dtype so u32 sums wrap mod 2^32 exactly
    # like the reference's GLSL uint arithmetic (no silent x64 promotion).
    if op == ReduceOperator.SUM:
        return jnp.sum(x, axis=0, dtype=x.dtype)
    if op == ReduceOperator.MUL:
        return jnp.prod(x, axis=0, dtype=x.dtype)
    if op == ReduceOperator.MIN:
        return jnp.min(x, axis=0)
    return jnp.max(x, axis=0)


def reduce(x: jax.Array, op: ReduceOperator = ReduceOperator.SUM) -> jax.Array:
    """Reduce x along axis 0. x: (N,) scalar stream or (N, C) vector stream.

    Any N >= 1 (the reference supports non-power-of-2 via bounds checks).
    Returns a scalar (or (C,) for vectors).
    """
    check_argument(x.ndim in (1, 2), "reduce expects (N,) or (N, C) input, got shape %s", x.shape)
    check_argument(x.shape[0] >= 1, "reduce requires count >= 1")
    return _reduce_impl(x, op)


def segmented_reduce(
    x: jax.Array,
    offsets,
    op: ReduceOperator = ReduceOperator.SUM,
) -> jax.Array:
    """Per-segment reduction over VARIABLE-length adjacent segments (CUB
    DeviceSegmentedReduce-style begin/end `offsets`: S+1 nondecreasing
    boundaries, empty segments allowed and reduce to the operator identity —
    0 for SUM, 1 for MUL, +/-inf or the integer extremes for MIN/MAX).
    Returns an (S,) array of segment reductions — an extension beyond the
    reference (whose reduce is whole-array only, Reduce.hpp:121-134).

    Integer SUM: segment sums are boundary differences of ONE global
    inclusive scan (exact in the wrapping mod-2^w ring), costing a single
    scan pass + an (S+1)-sized gather — no per-element gathers and no
    per-segment dispatches. Every other (op, dtype) — min/max/mul and
    float sums — rides the flagged-combine segmented scan (scan.py::
    _flagged_scan, exact for non-invertible operators) and picks each
    segment's last inclusive value (an S-sized gather).
    """
    check_argument(isinstance(op, ReduceOperator), "Invalid operator: %s", op)
    check_argument(x.ndim == 1, "segmented_reduce expects a 1-D array, got shape %s", x.shape)
    from ._segments import validate_offsets

    n = x.shape[0]
    offs, num_segments = validate_offsets(offsets, n)
    ident = identity_for(op, x.dtype)
    if n == 0:
        return jnp.full((num_segments,), ident, x.dtype)
    oi = offs.astype(jnp.int32)
    if op != ReduceOperator.SUM or not jnp.issubdtype(x.dtype, jnp.integer):
        from .scan import _flagged_scan, _segment_start_flags

        flags = _segment_start_flags(offs, n)
        incl = _flagged_scan(x, flags, op, inclusive=True)
        ends = jnp.maximum(oi[1:] - 1, 0)
        return jnp.where(oi[1:] > oi[:-1], incl[ends], jnp.full((), ident, x.dtype))
    from .scan import inclusive_scan

    incl = inclusive_scan(x, op=op)
    # prefix value BEFORE each boundary: 0 at boundary 0, incl[o-1] else
    pref = jnp.where(oi > 0, incl[jnp.maximum(oi - 1, 0)], jnp.zeros((), x.dtype))
    return pref[1:] - pref[:-1]


class Reduce:
    """Constructor-specialized reduce operator (reference glu/Reduce.hpp:51-136).

    `Reduce(DataType.UINT, ReduceOperator.SUM)(buffer, count)` reduces the
    first `count` elements of a DeviceBuffer and, like the reference, leaves
    the result at buffer[0] (Reduce.hpp:131-134). Unlike the reference the
    rest of the buffer is NOT clobbered with partials. Returns the result.
    """

    def __init__(self, data_type: DataType, operator: ReduceOperator):
        self.info = check_dtype_supported(data_type)
        check_argument(isinstance(operator, ReduceOperator), "Invalid operator: %s", operator)
        self.data_type = data_type
        self.operator = operator

    def __call__(self, buffer: DeviceBuffer | jax.Array, count: int):
        data = buffer.data if isinstance(buffer, DeviceBuffer) else buffer
        check_argument(count >= 1, "Count must be >= 1")
        check_argument(count <= data.shape[0], "count %d exceeds buffer size %d", count, data.shape[0])
        result = reduce(data[:count], self.operator)
        if isinstance(buffer, DeviceBuffer):
            buffer.data = buffer.data.at[0].set(result)
        return result
