"""glu_tpu — data-parallel primitives in JAX: reduce, Blelloch scan, stable LSD radix sort.

A JAX/XLA library with the capabilities of the reference
library loryruta/gl-radix-sort ("GLU", /root/reference): parallel Reduce
(sum/mul/min/max over GLU's 12 scalar/vector element types,
reference glu/data_types.hpp:8-22), Blelloch exclusive prefix scan with
batched adjacent partitions (reference glu/BlellochScan.hpp:80-191), and a
stable LSD radix sort over u32 key-value pairs, 4-bit digits x 8 passes with
partial-pass debugging (reference glu/RadixSort.hpp:186-354) — re-designed
as plain jnp/lax programs (XLA program boundaries instead of
glMemoryBarrier, donated device buffers instead of SSBO ping-pong) and
extended with a distributed sort, scan and reduce over a
`jax.sharding.Mesh`.

The library does not own the JAX runtime or mesh — like the reference does
not own a GL context (reference test/main.cpp:64-89), the caller brings
arrays (and optionally a mesh).
"""

from .utils.dtypes import DataType, dtype_info, to_jnp_dtype, to_type_str
from .utils.errors import GluError, check_argument, check_state, fail
from .utils.math import (
    div_ceil,
    is_power_of_2,
    log2_ceil,
    log2_floor,
    log32_ceil,
    log32_floor,
    next_power_of_2,
)
from .utils.buffers import DeviceBuffer, copy_buffer
from .utils.timing import measure_elapsed_time
from .ops.reduce import Reduce, ReduceOperator, reduce, segmented_reduce
from .ops.scan import BlellochScan, exclusive_scan, inclusive_scan
from .ops.radix_sort import (
    RadixSort,
    radix_argsort,
    radix_sort,
    radix_sort_f32,
    radix_sort_i32,
    radix_sort_keys,
    radix_sort_multi,
    radix_sort_segmented,
    radix_sort_u64,
    radix_sort_u64_parts,
    varying_key_bits,
)

__version__ = "0.1.0"

__all__ = [
    "DataType",
    "dtype_info",
    "to_jnp_dtype",
    "to_type_str",
    "GluError",
    "check_argument",
    "check_state",
    "fail",
    "div_ceil",
    "is_power_of_2",
    "log2_ceil",
    "log2_floor",
    "log32_ceil",
    "log32_floor",
    "next_power_of_2",
    "DeviceBuffer",
    "copy_buffer",
    "measure_elapsed_time",
    "Reduce",
    "ReduceOperator",
    "reduce",
    "segmented_reduce",
    "BlellochScan",
    "exclusive_scan",
    "inclusive_scan",
    "RadixSort",
    "radix_sort",
    "radix_sort_f32",
    "radix_sort_i32",
    "radix_sort_keys",
    "radix_sort_multi",
    "radix_sort_segmented",
    "radix_sort_u64",
    "radix_sort_u64_parts",
    "radix_argsort",
    "varying_key_bits",
]
