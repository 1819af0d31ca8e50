"""glu_tpu single-file distribution — GENERATED by generate.py, do not edit.

Copy this one file into your project and `import glu_tpu_single as glu`.
Equivalent of the reference's dist/*.hpp amalgamated headers
(reference generate.py, dist/, README.md:19-30).
"""

from __future__ import annotations


# ======================================================================
# inlined from glu_tpu/utils/errors.py
# ======================================================================

"""Fail-fast error checks.

JAX analog of reference glu/errors.hpp:8-18 (GLU_CHECK_STATE,
GLU_CHECK_ARGUMENT, GLU_FAIL). The reference prints to stderr and exits the
process; in a Python/JAX host we raise typed exceptions instead, which is the
idiomatic fail-fast for a library that does not own the process.
"""



class GluError(RuntimeError):
    """Base error for glu_tpu precondition violations."""


class GluStateError(GluError):
    """An internal state invariant was violated (analog of GLU_CHECK_STATE)."""


class GluArgumentError(GluError, ValueError):
    """A user-supplied argument was invalid (analog of GLU_CHECK_ARGUMENT)."""


def fail(fmt: str, *args) -> None:
    """Unconditional failure (analog of GLU_FAIL, reference glu/errors.hpp:17)."""
    raise GluError(fmt % args if args else fmt)


def check_state(cond: bool, fmt: str = "state check failed", *args) -> None:
    """Analog of GLU_CHECK_STATE (reference glu/errors.hpp:8-11)."""
    if not cond:
        raise GluStateError(fmt % args if args else fmt)


def check_argument(cond: bool, fmt: str = "invalid argument", *args) -> None:
    """Analog of GLU_CHECK_ARGUMENT (reference glu/errors.hpp:12-15)."""
    if not cond:
        raise GluArgumentError(fmt % args if args else fmt)

# ======================================================================
# inlined from glu_tpu/utils/math.py
# ======================================================================

"""Integer math helpers.

JAX analog of reference glu/gl_utils.hpp:267-302 (div_ceil,
is_power_of_2, next_power_of_2, log32_floor/ceil). Python ints are unbounded
so the bit-smearing implementation of next_power_of_2 is replaced with
bit_length arithmetic; semantics match the reference for all uint64 inputs.
"""



def div_ceil(num: int, den: int) -> int:
    """Ceiling division (reference gl_utils.hpp:286-289)."""
    return -(-num // den)


def is_power_of_2(n: int) -> bool:
    """True for 1, 2, 4, ... (reference gl_utils.hpp:291-294)."""
    return n > 0 and (n & (n - 1)) == 0


def next_power_of_2(n: int) -> int:
    """Smallest power of two >= n (reference gl_utils.hpp:296-302)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def log2_floor(n: int) -> int:
    """floor(log2(n)) for n >= 1."""
    if n < 1:
        raise ValueError("log2_floor requires n >= 1")
    return n.bit_length() - 1


def log2_ceil(n: int) -> int:
    """ceil(log2(n)) for n >= 1."""
    if n < 1:
        raise ValueError("log2_ceil requires n >= 1")
    return (n - 1).bit_length()


def log32_floor(n: int) -> int:
    """floor(log32(n)) — depth of a radix-32 reduction tree (reference gl_utils.hpp:267-277)."""
    return log2_floor(n) // 5


def log32_ceil(n: int) -> int:
    """ceil(log32(n)) (reference gl_utils.hpp:279-284)."""
    return div_ceil(log2_ceil(n), 5)

# ======================================================================
# inlined from glu_tpu/utils/dtypes.py
# ======================================================================

"""Element type registry.

JAX analog of reference glu/data_types.hpp:8-44: the same 12 logical
element types (float/double/int/uint scalars and their vec2/vec4 variants).

Where the reference maps each DataType to a GLSL type name for `#define`
injection into shader source (to_glsl_type_str, data_types.hpp:24-44), we map
each DataType to a JAX dtype plus a number of *components*. Vector types are
represented as arrays with a trailing component axis of size 2 or 4, so every
op vectorizes across the components.

Doubles: DataType.DOUBLE / DVEC* need 64-bit floats, which JAX holds only
with jax_enable_x64; without it they are rejected with a clear error rather
than silently truncated to float32.
"""


import enum
from dataclasses import dataclass

import jax
import jax.numpy as jnp



class DataType(enum.Enum):
    """The 12 GLU element types (reference glu/data_types.hpp:8-22)."""

    FLOAT = 0
    DOUBLE = 1
    INT = 2
    UINT = 3
    VEC2 = 4
    VEC4 = 5
    DVEC2 = 6
    DVEC4 = 7
    UVEC2 = 8
    UVEC4 = 9
    IVEC2 = 10
    IVEC4 = 11


@dataclass(frozen=True)
class DTypeInfo:
    """Resolved layout of a DataType: base JAX dtype + component count."""

    data_type: DataType
    dtype: jnp.dtype
    components: int  # 1 for scalars; trailing axis size for vec2/vec4
    name: str

    @property
    def is_vector(self) -> bool:
        return self.components > 1

    @property
    def itemsize(self) -> int:
        return jnp.dtype(self.dtype).itemsize * self.components

    def element_shape(self) -> tuple:
        """Trailing shape of one element: () for scalars, (2,)/(4,) for vectors."""
        return () if self.components == 1 else (self.components,)


_REGISTRY = {
    DataType.FLOAT: ("float", jnp.float32, 1),
    DataType.DOUBLE: ("double", jnp.float64, 1),
    DataType.INT: ("int", jnp.int32, 1),
    DataType.UINT: ("uint", jnp.uint32, 1),
    DataType.VEC2: ("vec2", jnp.float32, 2),
    DataType.VEC4: ("vec4", jnp.float32, 4),
    DataType.DVEC2: ("dvec2", jnp.float64, 2),
    DataType.DVEC4: ("dvec4", jnp.float64, 4),
    DataType.UVEC2: ("uvec2", jnp.uint32, 2),
    DataType.UVEC4: ("uvec4", jnp.uint32, 4),
    DataType.IVEC2: ("ivec2", jnp.int32, 2),
    DataType.IVEC4: ("ivec4", jnp.int32, 4),
}


def dtype_info(data_type: DataType) -> DTypeInfo:
    """Resolve a DataType to its layout info."""
    check_argument(data_type in _REGISTRY, "Invalid data type: %s", data_type)
    name, dt, comps = _REGISTRY[data_type]
    return DTypeInfo(data_type=data_type, dtype=jnp.dtype(dt), components=comps, name=name)


def to_jnp_dtype(data_type: DataType) -> jnp.dtype:
    """Base JAX dtype for a DataType."""
    return dtype_info(data_type).dtype


def to_type_str(data_type: DataType) -> str:
    """Human name for a DataType (analog of to_glsl_type_str, data_types.hpp:24-44)."""
    return dtype_info(data_type).name


def supports_float64() -> bool:
    """True when the active JAX config/backend can hold real f64 values."""
    return bool(jax.config.read("jax_enable_x64"))


def check_dtype_supported(data_type: DataType) -> DTypeInfo:
    """Resolve a DataType, rejecting f64 types when x64 is unavailable."""
    info = dtype_info(data_type)
    if info.dtype == jnp.float64 and not supports_float64():
        check_argument(
            False,
            "%s requires 64-bit floats; enable jax_enable_x64",
            info.name,
        )
    return info

# ======================================================================
# inlined from glu_tpu/utils/timing.py
# ======================================================================

"""Device timing.

JAX analog of reference glu/gl_utils.hpp:249-265
(measure_gl_elapsed_time: a GL_TIME_ELAPSED query around a callback) and
test/util/StopWatch.hpp: wall-clock around a fully synchronized dispatch,
ended by `jax.block_until_ready` on every output. For deeper traces,
`jax.profiler` is the analog of RenderDoc capture and is exposed via
`trace()`.
"""


import contextlib
import time
from typing import Callable

import jax


def measure_elapsed_time(callback: Callable[[], object]) -> tuple[int, object]:
    """Run `callback`, returning (elapsed nanoseconds, result).

    The result (any pytree of jax.Arrays) is blocked on before the clock
    stops, so the measurement covers device execution — the analog of the
    reference's GL timer query (gl_utils.hpp:249-265), which also measures
    device time for the whole callback.
    """
    start = time.perf_counter_ns()
    result = jax.block_until_ready(callback())
    elapsed = time.perf_counter_ns() - start
    return elapsed, result


def ns_to_human_string(ns: float) -> str:
    """Autoscaling time formatter (reference test/util/StopWatch.hpp:11-32)."""
    if ns >= 1e9:
        return f"{ns / 1e9:.3f} s"
    if ns >= 1e6:
        return f"{ns / 1e6:.3f} ms"
    if ns >= 1e3:
        return f"{ns / 1e3:.3f} us"
    return f"{ns:.0f} ns"


class StopWatch:
    """Wall-clock stopwatch (reference test/util/StopWatch.hpp:34-59)."""

    def __init__(self):
        self._start = time.perf_counter_ns()

    def restart(self) -> None:
        self._start = time.perf_counter_ns()

    def elapsed_ns(self) -> int:
        return time.perf_counter_ns() - self._start

    def elapsed_human(self) -> str:
        return ns_to_human_string(self.elapsed_ns())


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context — the RenderDoc-capture analog
    (the reference links renderdoc_app.h but never invokes it; we wire the
    equivalent through so it is actually usable)."""
    with jax.profiler.trace(log_dir):
        yield log_dir

# ======================================================================
# inlined from glu_tpu/utils/buffers.py
# ======================================================================

"""Device buffer wrapper.

JAX analog of reference glu/gl_utils.hpp:146-246 (ShaderStorageBuffer)
and copy_buffer (gl_utils.hpp:13-22). JAX arrays are immutable, so the SSBO's
mutable realloc/clear/write surface becomes a thin handle that swaps its
underlying `jax.Array`; operator classes accept either raw arrays (functional
path, preferred) or DeviceBuffer handles (API-parity path mirroring how the
reference mutates SSBOs in place).

Where the reference relies on `glBufferStorage` realloc + device-device copy
to grow scratch (ShaderStorageBuffer::resize, gl_utils.hpp:194-212), the JAX
analog is pad/slice on device — XLA keeps it in device memory.
"""


from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np



def copy_buffer(src: jax.Array, dst_size: Optional[int] = None) -> jax.Array:
    """Device-device copy (reference gl_utils.hpp:13-22). Optionally resizes."""
    out = jnp.copy(src)
    if dst_size is not None and dst_size != src.shape[0]:
        out = _resized(out, dst_size)
    return out


def _resized(data: jax.Array, size: int) -> jax.Array:
    if size <= data.shape[0]:
        return data[:size]
    pad = [(0, size - data.shape[0])] + [(0, 0)] * (data.ndim - 1)
    return jnp.pad(data, pad)


class DeviceBuffer:
    """A growable device array handle (reference ShaderStorageBuffer,
    gl_utils.hpp:146-246).

    size/resize/clear/write_data/get_data mirror the SSBO surface; `data`
    exposes the current jax.Array for use with the functional ops.
    """

    def __init__(self, init=None, *, size: int = 0, dtype=jnp.uint32):
        if init is not None:
            self._data = jnp.asarray(init)
        else:
            self._data = jnp.zeros((size,), dtype=dtype)

    @property
    def data(self) -> jax.Array:
        return self._data

    @data.setter
    def data(self, value) -> None:
        self._data = jnp.asarray(value)

    @property
    def size(self) -> int:
        """Element count (the reference tracks bytes; elements are the natural
        unit for typed arrays)."""
        return int(self._data.shape[0])

    @property
    def dtype(self):
        return self._data.dtype

    def resize(self, size: int, keep_data: bool = False) -> None:
        """Grow/shrink, optionally preserving contents
        (reference gl_utils.hpp:194-212)."""
        check_argument(size >= 0, "Invalid size: %d", size)
        if size == self.size:
            return
        if keep_data:
            self._data = _resized(self._data, size)
        else:
            self._data = jnp.zeros((size,) + self._data.shape[1:], dtype=self._data.dtype)

    def clear(self, value=0) -> None:
        """Fill with a constant (reference gl_utils.hpp:215-219, which clears
        via GL_R32UI fill)."""
        self._data = jnp.full_like(self._data, value)

    def write_data(self, host_data) -> None:
        """Upload host data starting at offset 0 (reference gl_utils.hpp:222-227)."""
        arr = jnp.asarray(host_data)
        check_argument(
            arr.shape[0] <= self.size,
            "write of %d elements exceeds buffer size %d",
            arr.shape[0],
            self.size,
        )
        if arr.shape[0] == self.size:
            self._data = arr.astype(self._data.dtype)
        else:
            self._data = self._data.at[: arr.shape[0]].set(arr.astype(self._data.dtype))

    def get_data(self, count: Optional[int] = None) -> np.ndarray:
        """Read back to host (reference gl_utils.hpp:230-238)."""
        data = self._data if count is None else self._data[:count]
        return np.asarray(jax.device_get(data))

# ======================================================================
# inlined from glu_tpu/utils/debug.py
# ======================================================================

"""Host-side debug printers.

JAX analog of reference glu/gl_utils.hpp:304-329 (print_stl_container,
print_buffer, print_buffer_hex): dump any container / device array in decimal
or hex for eyeballing intermediate state (e.g. a partially-executed sort via
`num_steps`).
"""


import sys

import numpy as np


def print_container(values, *, name: str = "", file=sys.stdout) -> None:
    """Print an iterable of values on one line (reference gl_utils.hpp:304-312)."""
    if name:
        print(f"{name}: ", end="", file=file)
    print(" ".join(str(v) for v in values), file=file)


def print_buffer(buffer, count: int | None = None, *, name: str = "", file=sys.stdout) -> None:
    """Print a device array / DeviceBuffer in decimal (reference gl_utils.hpp:314-321)."""
    data = getattr(buffer, "data", buffer)
    host = np.asarray(data if count is None else data[:count])
    print_container(host.reshape(host.shape[0], -1).squeeze().tolist(), name=name, file=file)


def print_buffer_hex(buffer, count: int | None = None, *, name: str = "", file=sys.stdout) -> None:
    """Print a device array / DeviceBuffer in hex (reference gl_utils.hpp:323-329)."""
    data = getattr(buffer, "data", buffer)
    host = np.asarray(data if count is None else data[:count])
    flat = host.reshape(-1)
    print_container([hex(int(v)) for v in flat], name=name, file=file)

# ======================================================================
# inlined from glu_tpu/ops/_segments.py
# ======================================================================

"""Shared validation for CUB-style segment boundary arrays.

The ragged (offsets=) forms of the sort, scan, and reduce all take the
same contract: S+1 nondecreasing integer boundaries with offsets[0] == 0
and offsets[-1] == n, empty segments allowed. Validation happens on the
host when the array is concrete; traced boundary arrays skip it (only
their COUNT is static), keeping every form trace-safe.
"""


import jax
import jax.numpy as jnp



def validate_offsets(offsets, n: int):
    """Returns (offsets as a jnp array, num_segments)."""
    offs = jnp.asarray(offsets)
    check_argument(offs.ndim == 1, "offsets must be 1-D")
    check_argument(
        jnp.issubdtype(offs.dtype, jnp.integer), "offsets must be integers, got %s", offs.dtype
    )
    num_segments = offs.shape[0] - 1
    check_argument(num_segments >= 1, "offsets needs at least 2 entries")
    if not isinstance(offs, jax.core.Tracer):  # concrete: validate the contract
        import numpy as np

        h = np.asarray(offs)
        check_argument(int(h[0]) == 0, "offsets[0] must be 0, got %d", int(h[0]))
        check_argument(
            int(h[-1]) == n, "offsets[-1] (%d) must equal the array length (%d)", int(h[-1]), n
        )
        check_argument(bool((h[1:] >= h[:-1]).all()), "offsets must be nondecreasing")
    return offs, num_segments

# ======================================================================
# inlined from glu_tpu/ops/reference.py
# ======================================================================

"""Golden reference implementations in plain jnp.

These are the oracles the kernels are tested against — the analog of the
reference test suite's STL oracles (std::accumulate, std::exclusive_scan,
std::stable_sort; reference test/reduce_tests.cpp:147-164,
test/blelloch_scan_tests.cpp:28-46, test/radix_sort_tests.cpp:20-51). They
are deliberately the simplest correct expression of each op's contract.
"""


import jax
import jax.numpy as jnp


def ref_reduce(x: jax.Array, op: str) -> jax.Array:
    """Reduce along axis 0 with `op` in {sum, mul, min, max}.

    Matches reference Reduce semantics (glu/Reduce.hpp:42-48): the result for
    a (N,) array is a scalar; for (N, C) vector arrays it is the per-component
    (C,) reduction.
    """
    if op == "sum":
        return jnp.sum(x, axis=0, dtype=x.dtype)
    if op == "mul":
        return jnp.prod(x, axis=0, dtype=x.dtype)
    return {"min": jnp.min, "max": jnp.max}[op](x, axis=0)


def ref_exclusive_scan(x: jax.Array, num_partitions: int = 1) -> jax.Array:
    """Exclusive prefix sum over `num_partitions` adjacent equal partitions.

    Matches reference BlellochScan semantics (glu/BlellochScan.hpp:125-138):
    partition p of length L = x.size/num_partitions is scanned independently;
    sums wrap naturally in the array dtype (u32 mod 2^32).
    """
    n = x.shape[0]
    part = n // num_partitions
    seg = x.reshape(num_partitions, part)
    inc = jnp.cumsum(seg, axis=1, dtype=x.dtype)
    exc = inc - seg
    return exc.reshape(n)


def ref_radix_sort(keys: jax.Array, values: jax.Array, num_steps: int = 0):
    """Stable sort of u32 (key, value) pairs by the low 4*num_steps key bits.

    num_steps=0 means a full 8-pass sort (reference glu/RadixSort.hpp:289,332:
    the loop breaks at `step == num_steps || step == 8`). A partial sort's
    observable state equals a stable sort by the masked low bits — LSD passes
    never look at higher bits.
    """
    steps = 8 if num_steps in (0, None) else min(int(num_steps), 8)
    if steps == 0:
        return keys, values
    mask = jnp.uint32((1 << (4 * steps)) - 1) if steps < 8 else jnp.uint32(0xFFFFFFFF)
    sort_key = keys & mask
    _, out_k, out_v = jax.lax.sort((sort_key, keys, values), is_stable=True, num_keys=1)
    return out_k, out_v

# ======================================================================
# inlined from glu_tpu/ops/reduce.py
# ======================================================================

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


import enum
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np



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

    n = x.shape[0]
    offs, num_segments = validate_offsets(offsets, n)
    ident = identity_for(op, x.dtype)
    if n == 0:
        return jnp.full((num_segments,), ident, x.dtype)
    oi = offs.astype(jnp.int32)
    if op != ReduceOperator.SUM or not jnp.issubdtype(x.dtype, jnp.integer):

        flags = _segment_start_flags(offs, n)
        incl = _flagged_scan(x, flags, op, inclusive=True)
        ends = jnp.maximum(oi[1:] - 1, 0)
        return jnp.where(oi[1:] > oi[:-1], incl[ends], jnp.full((), ident, x.dtype))

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

# ======================================================================
# inlined from glu_tpu/ops/scan.py
# ======================================================================

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


from functools import partial

import jax
import jax.numpy as jnp



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

# ======================================================================
# inlined from glu_tpu/ops/radix_sort.py
# ======================================================================

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


from functools import partial

import jax
import jax.numpy as jnp


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

# ======================================================================
# inlined from glu_tpu/parallel/dist_sort.py
# ======================================================================

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


from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np


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

# ======================================================================
# inlined from glu_tpu/parallel/dist_primitives.py
# ======================================================================

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


import jax
import jax.numpy as jnp



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
