"""Multi-device / multi-host layer.

The reference is single-process single-GPU (SURVEY.md §2.3); this layer is
the new capability required by BASELINE.json's north star: sorting sharded
key/value arrays across a device mesh with sampled-splitter partitioning, a
single all-to-all bucket exchange, and stable local sorts —
composed from the same single-chip kernels via `jax.shard_map`. Reduce and
scan get the same treatment (dist_primitives.py), so every primitive in
the library has a mesh-scale form.
"""

from .dist_primitives import (
    distributed_exclusive_scan,
    distributed_inclusive_scan,
    distributed_reduce,
)
from .dist_sort import (
    distributed_radix_sort,
    distributed_radix_sort_f32,
    distributed_radix_sort_i32,
    distributed_radix_sort_u64,
    distributed_radix_sort_u64_parts,
    make_sort_mesh,
)

__all__ = [
    "distributed_exclusive_scan",
    "distributed_inclusive_scan",
    "distributed_reduce",
    "distributed_radix_sort",
    "distributed_radix_sort_f32",
    "distributed_radix_sort_i32",
    "distributed_radix_sort_u64",
    "distributed_radix_sort_u64_parts",
    "make_sort_mesh",
]
