"""Blelloch exclusive prefix scan (sum), with batched adjacent partitions.

A JAX re-design of reference glu/BlellochScan.hpp. The reference runs
2*log2(N) host-synchronized dispatches (upsweep then downsweep, one per tree
level, with a full glMemoryBarrier between each — BlellochScan.hpp:142-190).
Here the whole scan is one XLA program (`jnp.cumsum` / `lax.cummin` etc.
over a partition axis) with no host round trip between tree levels.

The reference's `num_partitions` batch mode (grid-y = partition,
BlellochScan.hpp:125-138) — really a segmented scan over adjacent
equal-length segments — maps to a leading partition axis here, and is what
the radix sort uses for its [16][num_blocks] offset table (RadixSort.hpp:311).

Parity notes:
  - default operator is `+` with identity 0, as in the reference (OPERATION/
    IDENTITY hardcoded at BlellochScan.hpp:99-100 despite the dtype arg) —
    but the op is a parameter here (sum/mul/min/max, sharing the reduce
    operator enum), resolving the reference's hardcoded-op limitation;
  - the class form requires power-of-2 partition length, matching the
    reference's check (BlellochScan.hpp:134); the functional form lifts that
    restriction (the reference's own TODO) via internal padding;
  - u32 sums wrap mod 2^32 exactly as the GLSL uint arithmetic does.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils.buffers import DeviceBuffer
from ..utils.dtypes import DataType, check_dtype_supported
from ..utils.errors import check_argument
from ..utils.math import is_power_of_2
from .reduce import ReduceOperator, combine_fn, identity_for


@partial(jax.jit, static_argnames=("num_partitions", "op"))
def _scan_impl(x: jax.Array, num_partitions: int, op: ReduceOperator) -> jax.Array:
    if x.ndim == 2:
        # vector dtypes: per-component scan over the trailing axis — parity
        # with the reference ctor accepting any DataType
        # (BlellochScan.hpp:96-102)
        per_comp = jax.vmap(lambda col: _scan_flat(col, num_partitions, op))(x.T)
        return per_comp.T
    return _scan_flat(x, num_partitions, op)


def _scan_flat(x: jax.Array, num_partitions: int, op: ReduceOperator) -> jax.Array:
    n = x.shape[0]
    seg = x.reshape(num_partitions, n // num_partitions)
    # accumulator dtype pinned to the input dtype so u32 sums/products wrap
    # mod 2^32 exactly like the reference's GLSL uint arithmetic
    if op == ReduceOperator.SUM:
        inc = jnp.cumsum(seg, axis=1, dtype=x.dtype)
        return (inc - seg).reshape(n)
    if op == ReduceOperator.MUL:
        inc = jnp.cumprod(seg, axis=1, dtype=x.dtype)
    elif op == ReduceOperator.MIN:
        inc = jax.lax.cummin(seg, axis=1)
    else:
        inc = jax.lax.cummax(seg, axis=1)
    # non-invertible ops: exclusive = inclusive shifted right one slot with
    # the identity seeding each partition's slot 0
    first = jnp.full((num_partitions, 1), identity_for(op, x.dtype), x.dtype)
    return jnp.concatenate([first, inc[:, :-1]], axis=1).reshape(n)


def _check_scan_args(x: jax.Array, num_partitions: int, op) -> None:
    check_argument(
        x.ndim in (1, 2),
        "scan expects (N,) or (N, C) input (vector dtypes scan per component), got shape %s",
        x.shape,
    )
    check_argument(num_partitions >= 1, "num_partitions must be >= 1")
    check_argument(
        x.shape[0] % num_partitions == 0,
        "size %d not divisible by num_partitions %d",
        x.shape[0],
        num_partitions,
    )
    check_argument(isinstance(op, ReduceOperator), "Invalid operator: %s", op)


def _segment_start_flags(offs, n):
    """Bool start-of-segment flags from validated offsets: scatter one mark
    per interior boundary (duplicates accumulate — empty segments collapse
    to the same start; a mark COUNT > 0 is still just a start). Element 0
    always starts a segment."""
    marks = jnp.zeros(n, jnp.int32).at[offs[1:-1]].add(1, mode="drop")
    return (marks > 0).at[0].set(True)


def _flagged_scan(x, flags, op, inclusive: bool):
    """Ragged scan under ANY operator via the classic segmented-scan lift
    (Blelloch 1990): `op` on (start_flag, value) pairs —
    (af,av) . (bf,bv) = (af|bf, bv if bf else op(av,bv)) — is associative,
    so one `jax.lax.associative_scan` realizes every segment's inclusive
    scan in log-depth combine passes. The exclusive form shifts one slot
    right and seeds segment starts with the identity. O(n log n) work —
    the price of non-invertible operators; the integer-SUM path below stays
    the O(n) subtract composition."""
    comb = combine_fn(op)

    def fc(a, b):
        af, av = a
        bf, bv = b
        return (af | bf, jnp.where(bf, bv, comb(av, bv)))

    _, incl = jax.lax.associative_scan(fc, (flags, x))
    if inclusive:
        return incl
    ident = jnp.full((1,), identity_for(op, x.dtype), x.dtype)
    shifted = jnp.concatenate([ident, incl[:-1]])
    return jnp.where(flags, ident[0], shifted)


def _segmented_scan_offsets(x, offsets, op, inclusive: bool):
    """Ragged segmented scan (offsets form). Integer SUM takes the O(n)
    fast path: one GLOBAL scan, then subtract each element's segment-base
    prefix: gather the S segment-start prefix values (an S-sized gather),
    difference them, scatter the increments at the boundaries, and cumsum
    back into a step function. Exact in the wrapping integer ring (mod-2^w
    subtraction inverts mod-2^w addition).

    Every other (op, dtype) — min/max/mul, and float sums — takes the
    flagged-combine path (_flagged_scan): exact for all of them (no inverse
    needed), generalizing the reference's hardcoded uint `+`
    (BlellochScan.hpp:99-100) to the full operator set."""
    check_argument(x.ndim == 1, "offsets= expects a 1-D array, got shape %s", x.shape)
    check_argument(isinstance(op, ReduceOperator), "Invalid operator: %s", op)
    from ._segments import validate_offsets

    n = x.shape[0]
    offs, _ = validate_offsets(offsets, n)
    if n == 0:
        return x
    if op != ReduceOperator.SUM or not jnp.issubdtype(x.dtype, jnp.integer):
        flags = _segment_start_flags(offs, n)
        return _flagged_scan(x, flags, op, inclusive)
    b = _scan_impl(x, 1, op)  # global exclusive
    starts = jnp.minimum(offs[:-1].astype(jnp.int32), n - 1)
    vals = b[starts]  # (S,) scalars — a tiny gather
    incs = jnp.diff(vals, prepend=jnp.zeros((1,), b.dtype).astype(vals.dtype))
    sparse = jnp.zeros(n, b.dtype).at[offs[:-1]].add(incs.astype(b.dtype), mode="drop")
    base = jnp.cumsum(sparse, dtype=b.dtype)
    out = b - base
    return combine_fn(op)(out, x) if inclusive else out


def exclusive_scan(
    x: jax.Array,
    num_partitions: int = 1,
    op: ReduceOperator = ReduceOperator.SUM,
    *,
    offsets=None,
) -> jax.Array:
    """Exclusive prefix scan of x under `op` (default sum), independently over
    `num_partitions` adjacent equal-length partitions. Returns a new array
    (not in-place).

    x: (N,) scalar stream or (N, C) vector stream (per-component scan, the
    trailing-axis layout of the vec2/vec4 DataTypes — parity with the
    reference ctor accepting any DataType, BlellochScan.hpp:96-102), with N
    divisible by num_partitions. Any partition length >= 1 (power-of-2 NOT
    required — the reference's restriction is lifted).

    offsets (extension): S+1 nondecreasing segment boundaries (CUB
    begin/end style; empty segments allowed) scan each VARIABLE-length
    segment independently — the ragged generalization of the reference's
    equal-partition batching (BlellochScan.hpp:125-138). All four
    operators: integer SUM takes an O(n) global-scan + exact mod-2^w
    segment-base subtraction; min/max/mul and float sums take the classic
    flagged-combine segmented scan (exact, O(n log n)). 1-D only; mutually
    exclusive with num_partitions > 1.
    """
    _check_scan_args(x, num_partitions, op)
    if offsets is not None:
        check_argument(
            num_partitions in (1, None), "offsets and num_partitions are mutually exclusive"
        )
        return _segmented_scan_offsets(x, offsets, op, inclusive=False)
    return _scan_impl(x, num_partitions, op)


def inclusive_scan(
    x: jax.Array,
    num_partitions: int = 1,
    op: ReduceOperator = ReduceOperator.SUM,
    *,
    offsets=None,
) -> jax.Array:
    """Inclusive prefix scan: `out[i] = op(x[j] for j <= i)` within each
    partition. Derived as `op(exclusive, x)` elementwise — exact for every
    operator (wrapping uint32 sums/products included). See exclusive_scan
    for the ragged `offsets=` form."""
    _check_scan_args(x, num_partitions, op)
    if offsets is not None:
        check_argument(
            num_partitions in (1, None), "offsets and num_partitions are mutually exclusive"
        )
        return _segmented_scan_offsets(x, offsets, op, inclusive=True)
    exc = _scan_impl(x, num_partitions, op)
    return combine_fn(op)(exc, x)


class BlellochScan:
    """Constructor-specialized scan operator (reference glu/BlellochScan.hpp:80-191).

    `BlellochScan(DataType.UINT)(buffer, count, num_partitions)` scans the
    first count*num_partitions elements in place (buffer form) and returns
    the scanned array. Enforces the reference's power-of-2 `count` check
    (BlellochScan.hpp:134). The optional `operator` (default SUM, the
    reference's hardcoded op) extends the class form to mul/min/max.
    Vector DataTypes (VEC2/VEC4 etc.) take (N, C) trailing-component
    buffers and scan per component — the reference ctor accepts any
    DataType (BlellochScan.hpp:96-102).
    """

    def __init__(self, data_type: DataType, operator: ReduceOperator = ReduceOperator.SUM):
        self.info = check_dtype_supported(data_type)
        check_argument(isinstance(operator, ReduceOperator), "Invalid operator: %s", operator)
        self.data_type = data_type
        self.operator = operator

    def __call__(
        self,
        buffer: DeviceBuffer | jax.Array,
        count: int,
        num_partitions: int = 1,
    ):
        data = buffer.data if isinstance(buffer, DeviceBuffer) else buffer
        check_argument(count >= 1, "Count must be >= 1")
        check_argument(is_power_of_2(count), "Count must be a power of 2 (got %d)", count)
        if self.info.components > 1:
            check_argument(
                data.ndim == 2 and data.shape[1] == self.info.components,
                "%s buffers carry components in the trailing axis (N, %d), got shape %s",
                self.info.name, self.info.components, data.shape,
            )
        total = count * num_partitions
        check_argument(
            total <= data.shape[0], "count*num_partitions %d exceeds buffer size %d", total, data.shape[0]
        )
        result = exclusive_scan(data[:total], num_partitions, self.operator)
        if isinstance(buffer, DeviceBuffer):
            buffer.data = buffer.data.at[:total].set(result)
            return buffer.data[:total]
        return result
