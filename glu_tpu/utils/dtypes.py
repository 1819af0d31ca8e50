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

from __future__ import annotations

import enum
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from .errors import check_argument


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
