"""Amalgamation checks — analog of the reference's compile-only dist tests
(test/generated/*.cpp, test/CMakeLists.txt:7-10): the generated single file
must import standalone, produce identical results to the package, and the
COMMITTED dist/ artifact must match fresh generate.py output byte-for-byte
(drift guard — the reference tests its shipped artifact, not a rebuild)."""

import pathlib
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

ROOT = pathlib.Path(__file__).parent.parent


@pytest.fixture(scope="module")
def single_dir(tmp_path_factory):
    """Run generate.py against a pristine copy of the sources in a temp dir,
    so the committed dist/ file is never overwritten by the test run."""
    work = tmp_path_factory.mktemp("amalgam")
    shutil.copytree(ROOT / "glu_tpu", work / "glu_tpu")
    shutil.copy(ROOT / "generate.py", work / "generate.py")
    subprocess.run([sys.executable, str(work / "generate.py")], check=True, cwd=work)
    return work / "dist"


@pytest.fixture(scope="module")
def single_module(single_dir):
    sys.path.insert(0, str(single_dir))
    try:
        import glu_tpu_single as single  # noqa: PLC0415

        yield single
    finally:
        sys.path.remove(str(single_dir))


def test_committed_dist_matches_sources(single_dir):
    """Drift guard: a commit that changes glu_tpu/ without re-running
    generate.py (and committing dist/) fails here."""
    committed = (ROOT / "dist" / "glu_tpu_single.py").read_text()
    fresh = (single_dir / "glu_tpu_single.py").read_text()
    assert committed == fresh, (
        "dist/glu_tpu_single.py is stale — run `python generate.py` and commit the result"
    )


def test_single_file_ops_match_package(single_module, seeded_rng):
    rng = seeded_rng(1)
    data = rng.sample_int_vector(4096, 0, 1000)

    got_sum = single_module.reduce(jnp.asarray(data), single_module.ReduceOperator.SUM)
    assert np.uint32(np.asarray(got_sum)) == data.sum(dtype=np.uint32)

    got_scan = np.asarray(single_module.exclusive_scan(jnp.asarray(data)))
    inc = np.cumsum(data, dtype=np.uint32)
    np.testing.assert_array_equal(got_scan, inc - data)

    keys = rng.sample_int_vector(5000, 0, 0xFFFFFFFE)
    vals = np.arange(keys.size, dtype=np.uint32)
    ok, ov = single_module.radix_sort(jnp.asarray(keys), jnp.asarray(vals))
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(ok), keys[order])
    np.testing.assert_array_equal(np.asarray(ov), order.astype(np.uint32))


def test_single_file_has_full_surface(single_module):
    import glu_tpu
    import glu_tpu.parallel

    for name in [
        "DataType", "ReduceOperator", "Reduce", "BlellochScan", "RadixSort",
        "reduce", "exclusive_scan", "radix_sort", "radix_sort_keys",
        "DeviceBuffer", "distributed_radix_sort",
    ]:
        assert hasattr(single_module, name), name
    # the single file must ship the ENTIRE public API (the reference
    # amalgamates everything it ships, reference generate.py:34-37): every
    # name exported by the package and its parallel layer
    for name in getattr(glu_tpu, "__all__", []):
        assert hasattr(single_module, name), f"package export missing: {name}"
    for name in glu_tpu.parallel.__all__:
        assert hasattr(single_module, name), f"parallel export missing: {name}"


def test_single_file_ragged_paths_functional(single_module, seeded_rng):
    """The ragged (offsets=) forms lazily import ops/_segments inside their
    function bodies, so a module missing from generate.py's MODULES list
    passes the surface/import tests and only crashes at CALL time (this
    exact bug shipped briefly in round 4). Exercise every offsets= entry
    point end to end from the amalgamation."""
    rng = seeded_rng(77)
    n = 3000
    cuts = np.sort(rng.sample_int_vector(7, 0, n).astype(np.int64))
    offs = np.concatenate([[0], cuts, [n]]).astype(np.int32)
    k = rng.sample_int_vector(n, 0, 2**32 - 1)
    v = np.arange(n, dtype=np.uint32)

    ok, _ = single_module.radix_sort_segmented(
        jnp.asarray(k), jnp.asarray(v), offsets=jnp.asarray(offs)
    )
    for s in range(len(offs) - 1):
        seg = slice(int(offs[s]), int(offs[s + 1]))
        np.testing.assert_array_equal(np.asarray(ok)[seg], np.sort(k[seg], kind="stable"))

    got = np.asarray(
        single_module.exclusive_scan(jnp.asarray(k), offsets=jnp.asarray(offs))
    )
    exp = np.zeros_like(k)
    for s in range(len(offs) - 1):
        seg = k[offs[s] : offs[s + 1]]
        c = np.cumsum(seg.astype(np.uint64)).astype(np.uint32)
        exp[offs[s] : offs[s + 1]] = np.concatenate([[np.uint32(0)], c[:-1]])
    np.testing.assert_array_equal(got, exp)

    sums = np.asarray(
        single_module.segmented_reduce(jnp.asarray(k), jnp.asarray(offs))
    )
    exp_sums = np.array(
        [np.uint32(k[offs[s] : offs[s + 1]].astype(np.uint64).sum() & 0xFFFFFFFF)
         for s in range(len(offs) - 1)],
        np.uint32,
    )
    np.testing.assert_array_equal(sums, exp_sums)
