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

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .errors import check_argument


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
