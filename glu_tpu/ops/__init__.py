"""Operator layer (L3 analog of reference glu/Reduce.hpp, BlellochScan.hpp, RadixSort.hpp).

Each operator has:
  - a functional entry point (`reduce`, `exclusive_scan`, `radix_sort`) — the
    idiomatic JAX surface: pure, jittable, donation-friendly;
  - a class (`Reduce`, `BlellochScan`, `RadixSort`) mirroring the reference's
    constructor-specialized operator objects (specialization keyed by
    dtype/op, with jit caching playing the role of the reference's
    shader-#define codegen, reference glu/Reduce.hpp:68-99);
  - one implementation: plain jnp/lax code that XLA compiles for the
    device.
"""

from .reduce import Reduce, ReduceOperator, reduce, segmented_reduce
from .scan import BlellochScan, exclusive_scan, inclusive_scan
from .radix_sort import (
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
