"""Test fixture layer.

The reference's fixture is a hidden GLFW window providing one shared GL 4.6
context (test/main.cpp:64-89). Ours is a JAX CPU platform with 8 virtual
devices — so single-device ops AND the multi-device sharded paths are
testable without accelerators (SURVEY.md §4:
xla_force_host_platform_device_count) — and x64 enabled so
DataType.DOUBLE/DVEC* are exercisable like the reference's double/dvec2/dvec4
test sections (test/reduce_tests.cpp:54-145).

The platform is a default: JAX_PLATFORMS set by the caller wins. Tests that
need a GPU carry the `gpu` marker and skip elsewhere; on a GPU machine run
them with `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

# a plugin may have imported jax before this file ran; the env vars above are
# then too late, so set the same values through jax.config as well
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", os.environ["JAX_ENABLE_X64"] == "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


class SeededRandom:
    """Seeded RNG mirroring the reference's test/util/Random.hpp:15-38
    (minstd_rand + modulo sampling). We use PCG64 — the *seeding discipline*
    (fixed seeds per case) is what matters for reproducibility, not the
    generator family."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.Generator(np.random.PCG64(seed))

    def sample_int_vector(self, count: int, min_v: int, max_v: int) -> np.ndarray:
        """Uniform u32 samples in [min_v, max_v] (reference Random.hpp:29-37)."""
        return self.rng.integers(min_v, max_v + 1, size=count, dtype=np.uint32)

    def sample_float_vector(self, count: int, min_v: float, max_v: float) -> np.ndarray:
        return self.rng.uniform(min_v, max_v, size=count).astype(np.float32)


@pytest.fixture
def seeded_rng():
    return SeededRandom


def _eager(fn, *args, **kwargs):
    return fn(*args, **kwargs)


def _in_jit(fn, *args, **kwargs):
    return jax.jit(lambda *a: fn(*a, **kwargs))(*args)


@pytest.fixture(params=["eager", "jit"])
def call_mode(request):
    """Run each op test's public call as written ("eager") and inside an
    enclosing jax.jit ("jit"): the trace-safety that parallel/ relies on when
    it composes the sorts under shard_map, and that users rely on when they
    embed an op in their own jitted program. Positional (array) arguments
    are traced; keyword arguments are closed over as constants."""
    return _eager if request.param == "eager" else _in_jit


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip `gpu`-marked tests unless JAX's default device is a GPU."""
    if request.node.get_closest_marker("gpu") and jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; `python chip_smoke.py` covers this path on the card")
