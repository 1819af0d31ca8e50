"""Distributed sort tests on the 8-virtual-device CPU mesh (SURVEY.md §4:
the xla_force_host_platform_device_count trick makes multi-device logic
testable without a pod).

All tests run at the DEFAULT capacity_factor=2.0: index-tiebroken splitters
keep buckets balanced for duplicate-heavy keys, and range-correlated inputs
(pre-sorted/reverse) overflow the padded exchange's per-block capacity and
recover losslessly through the host-side doubling retry."""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from glu_tpu.parallel import (
    distributed_radix_sort,
    distributed_radix_sort_f32,
    distributed_radix_sort_i32,
    distributed_radix_sort_u64,
    distributed_radix_sort_u64_parts,
    make_sort_mesh,
)
from glu_tpu.utils.errors import GluArgumentError

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _global_result(out_k, out_v, counts, num_devices):
    """Concatenate the real prefix of every shard in device order."""
    out_k, out_v, counts = np.asarray(out_k), np.asarray(out_v), np.asarray(counts)
    per = out_k.shape[0] // num_devices
    ks, vs = [], []
    for d in range(num_devices):
        c = int(counts[d])
        ks.append(np.asarray(out_k[d * per : d * per + c]))
        vs.append(np.asarray(out_v[d * per : d * per + c]))
    return np.concatenate(ks), np.concatenate(vs)


def _run(keys: np.ndarray, num_devices=8, **kw):
    # a platform with fewer devices exercises the same program at the
    # available mesh size
    num_devices = min(num_devices, len(jax.devices()))
    mesh = make_sort_mesh(jax.devices()[:num_devices])
    vals = np.arange(keys.size, dtype=np.uint32)
    spec = jax.sharding.PartitionSpec("shards")
    sharding = jax.sharding.NamedSharding(mesh, spec)
    k = jax.device_put(jnp.asarray(keys), sharding)
    v = jax.device_put(jnp.asarray(vals), sharding)
    out_k, out_v, counts, overflow = distributed_radix_sort(k, v, mesh, **kw)
    assert int(np.asarray(overflow)[0]) == 0, "capacity overflow after retries"
    gk, gv = _global_result(out_k, out_v, np.asarray(counts), num_devices)
    assert gk.size == keys.size
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(gk, keys[order])
    np.testing.assert_array_equal(gv, order.astype(np.uint32))


@pytest.mark.parametrize("per_device", [2048, 512])
def test_dist_sort_uniform(per_device, seeded_rng):
    # 512 per device: fewer elements than the default splitter samples
    rng = seeded_rng(1 if per_device == 2048 else 6)
    _run(rng.sample_int_vector(8 * per_device, 0, 0xFFFFFFFE))


@pytest.mark.parametrize("max_key", [9, 3])
def test_dist_sort_low_entropy(max_key, seeded_rng):
    # duplicate-heavy: index-tiebroken splitters must split the tied keys
    # evenly (a key-only splitter collapses all of them onto one device)
    rng = seeded_rng(2 if max_key == 9 else 7)
    _run(rng.sample_int_vector(8 * 1024, 0, max_key))


def test_dist_sort_constant_keys():
    # the extreme duplicate case: every key identical
    _run(np.full(8 * 1024, 0xABCD1234, dtype=np.uint32))


def test_dist_sort_skewed(seeded_rng):
    # BASELINE.json config: skewed key distribution — sampled splitters must
    # adapt; zipf-ish mass on tiny keys
    rng = seeded_rng(3)
    n = 8 * 2048
    z = rng.rng.zipf(1.3, size=n).astype(np.uint32)
    _run(z)


def test_dist_sort_presorted_and_reverse():
    # range-correlated inputs concentrate each shard into one destination
    # block; the padded exchange overflows at factor 2 and the host retry
    # doubles capacity until it fits (lossless — inputs are not donated)
    n = 8 * 1024
    _run(np.arange(n, dtype=np.uint32))
    _run(np.arange(n, dtype=np.uint32)[::-1].copy())


def test_dist_sort_max_keys(seeded_rng):
    # real 0xFFFFFFFF keys must not be confused with padding
    rng = seeded_rng(4)
    keys = rng.sample_int_vector(8 * 512, 0xFFFFFFF0, 0xFFFFFFFF)
    _run(keys)


def test_dist_sort_two_devices(seeded_rng):
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 devices")
    rng = seeded_rng(5)
    _run(rng.sample_int_vector(2 * 4096, 0, 1 << 20), num_devices=2)


def test_dist_sort_overflow_reported(seeded_rng):
    # with retries disabled, pathological skew must REPORT overflow rather
    # than silently dropping data
    if len(jax.devices()) < 2:
        pytest.skip("overflow requires an exchange (D >= 2)")
    mesh = make_sort_mesh(jax.devices()[:8])
    keys = jnp.asarray(np.arange(8 * 1024, dtype=np.uint32))
    vals = jnp.arange(8 * 1024, dtype=jnp.uint32)
    spec = jax.sharding.PartitionSpec("shards")
    sharding = jax.sharding.NamedSharding(mesh, spec)
    out = distributed_radix_sort(
        jax.device_put(keys, sharding), jax.device_put(vals, sharding), mesh,
        capacity_factor=1.0, max_retries=0,
    )
    assert int(np.asarray(out[3])[0]) == 1


def test_dist_sort_descending(seeded_rng):
    # high-to-low across the mesh: device 0 holds the LARGEST keys; stable
    mesh = make_sort_mesh(jax.devices()[:8])
    rng = seeded_rng(8)
    keys = rng.sample_int_vector(8 * 1024, 0, 50)  # heavy ties: checks stability
    vals = np.arange(keys.size, dtype=np.uint32)
    spec = jax.sharding.PartitionSpec("shards")
    sharding = jax.sharding.NamedSharding(mesh, spec)
    out_k, out_v, counts, overflow = distributed_radix_sort(
        jax.device_put(jnp.asarray(keys), sharding),
        jax.device_put(jnp.asarray(vals), sharding),
        mesh,
        descending=True,
    )
    assert int(np.asarray(overflow)[0]) == 0
    gk, gv = _global_result(out_k, out_v, np.asarray(counts), mesh.shape["shards"])
    order = np.argsort(~keys, kind="stable")  # descending, ties in input order
    np.testing.assert_array_equal(gk, keys[order])
    np.testing.assert_array_equal(gv, order.astype(np.uint32))


def test_dist_sort_i32(seeded_rng):
    # signed i32 keys via the order-preserving sign-bit flip; stable on ties
    mesh = make_sort_mesh(jax.devices()[:8])
    rng = seeded_rng(23)
    keys = (rng.sample_int_vector(8 * 1024, 0, 2_000_000).astype(np.int64) - 1_000_000).astype(
        np.int32
    )
    keys[:3] = [-(1 << 31), (1 << 31) - 1, 0]
    vals = np.arange(keys.size, dtype=np.uint32)
    spec = jax.sharding.PartitionSpec("shards")
    sharding = jax.sharding.NamedSharding(mesh, spec)
    out_k, out_v, counts, overflow = distributed_radix_sort_i32(
        jax.device_put(jnp.asarray(keys), sharding),
        jax.device_put(jnp.asarray(vals), sharding),
        mesh,
    )
    assert int(np.asarray(overflow)[0]) == 0
    gk, gv = _global_result(out_k, out_v, np.asarray(counts), mesh.shape["shards"])
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(gk, keys[order])
    np.testing.assert_array_equal(gv, order.astype(np.uint32))


def test_dist_sort_f32(seeded_rng):
    # f32 keys incl. negatives, -0.0/+0.0, and infinities, via the
    # order-preserving bijection; stable on ties
    mesh = make_sort_mesh(jax.devices()[:8])
    rng = seeded_rng(9)
    keys = (rng.sample_int_vector(8 * 1024, 0, 2_000_000).astype(np.int64) - 1_000_000).astype(
        np.float32
    ) / 997.0
    keys[:4] = [np.inf, -np.inf, 0.0, -0.0]
    vals = np.arange(keys.size, dtype=np.uint32)
    spec = jax.sharding.PartitionSpec("shards")
    sharding = jax.sharding.NamedSharding(mesh, spec)
    out_k, out_v, counts, overflow = distributed_radix_sort_f32(
        jax.device_put(jnp.asarray(keys), sharding),
        jax.device_put(jnp.asarray(vals), sharding),
        mesh,
    )
    assert int(np.asarray(overflow)[0]) == 0
    gk, gv = _global_result(out_k, out_v, np.asarray(counts), mesh.shape["shards"])
    # IEEE total order == numpy ascending sort for these finite/inf inputs;
    # -0.0 sorts before +0.0 in the bijection, matching stable argsort of the
    # u32-mapped keys
    u = (keys.view(np.uint32) ^ np.where(keys.view(np.uint32) >> 31 == 1, 0xFFFFFFFF, 0x80000000).astype(np.uint32))
    order = np.argsort(u, kind="stable")
    np.testing.assert_array_equal(gk.view(np.uint32), keys[order].view(np.uint32))
    np.testing.assert_array_equal(gv, order.astype(np.uint32))


@pytest.mark.parametrize("hi_max", [3, 0xFFFFFFFF])
def test_dist_sort_u64_parts(hi_max, seeded_rng):
    # 64-bit keys as (hi, lo) halves: hi words drawn from a small set make
    # the lo word break ties; full-range hi words spread over all buckets.
    # Stability checked via the value permutation
    mesh = make_sort_mesh(jax.devices()[:8])
    rng = seeded_rng(10 if hi_max == 3 else 12)
    n = 8 * 1024
    hi = rng.sample_int_vector(n, 0, hi_max)
    lo = rng.sample_int_vector(n, 0, 0xFFFFFFFF)
    vals = np.arange(n, dtype=np.uint32)
    spec = jax.sharding.PartitionSpec("shards")
    sh = jax.sharding.NamedSharding(mesh, spec)
    oh, ol, ov, counts, overflow = distributed_radix_sort_u64_parts(
        jax.device_put(jnp.asarray(hi), sh),
        jax.device_put(jnp.asarray(lo), sh),
        jax.device_put(jnp.asarray(vals), sh),
        mesh,
    )
    assert int(np.asarray(overflow)[0]) == 0
    gh, gv = _global_result(oh, ov, np.asarray(counts), mesh.shape["shards"])
    gl, _ = _global_result(ol, ov, np.asarray(counts), mesh.shape["shards"])
    k64 = (hi.astype(np.uint64) << 32) | lo.astype(np.uint64)
    order = np.argsort(k64, kind="stable")
    np.testing.assert_array_equal(gh, hi[order])
    np.testing.assert_array_equal(gl, lo[order])
    np.testing.assert_array_equal(gv, order.astype(np.uint32))


def test_dist_sort_u64_descending(seeded_rng):
    if not jax.config.jax_enable_x64:
        pytest.skip("u64 dtype requires jax_enable_x64")
    mesh = make_sort_mesh(jax.devices()[:4])
    rng = seeded_rng(11)
    n = 4 * 512
    keys = (rng.sample_int_vector(n, 0, 0xFFFFFFFF).astype(np.uint64) << 32) | rng.sample_int_vector(
        n, 0, 0xFFFFFFFF
    ).astype(np.uint64)
    vals = np.arange(n, dtype=np.uint32)
    spec = jax.sharding.PartitionSpec("shards")
    sh = jax.sharding.NamedSharding(mesh, spec)
    ok, ov, counts, overflow = distributed_radix_sort_u64(
        jax.device_put(jnp.asarray(keys), sh),
        jax.device_put(jnp.asarray(vals), sh),
        mesh,
        descending=True,
    )
    assert int(np.asarray(overflow)[0]) == 0
    gk, gv = _global_result(ok, ov, np.asarray(counts), mesh.shape["shards"])
    order = np.argsort(~keys, kind="stable")
    np.testing.assert_array_equal(gk, keys[order])
    np.testing.assert_array_equal(gv, order.astype(np.uint32))


@pytest.mark.gpu
def test_dist_sort_on_gpus(seeded_rng):
    # the bucket exchange across every local GPU; chip_smoke.py --four runs
    # the same path at 2^30 pairs
    ndev = len(jax.devices())
    mesh = make_sort_mesh(jax.devices())
    rng = seeded_rng(13)
    keys = rng.sample_int_vector(ndev * 4096, 0, 0xFFFFFFFE)
    vals = np.arange(keys.size, dtype=np.uint32)
    sh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("shards"))
    out_k, out_v, counts, overflow = distributed_radix_sort(
        jax.device_put(jnp.asarray(keys), sh),
        jax.device_put(jnp.asarray(vals), sh),
        mesh,
    )
    assert int(np.asarray(overflow)[0]) == 0
    gk, gv = _global_result(out_k, out_v, np.asarray(counts), ndev)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(gk, keys[order])
    np.testing.assert_array_equal(gv, order.astype(np.uint32))


def test_dist_sort_rejects_bad_dtypes():
    mesh = make_sort_mesh(jax.devices()[:2])
    k = jnp.arange(16, dtype=jnp.int32)
    v = jnp.arange(16, dtype=jnp.uint32)
    with pytest.raises(GluArgumentError):
        distributed_radix_sort(k, v, mesh)
    with pytest.raises(GluArgumentError):
        distributed_radix_sort_f32(k.astype(jnp.float32), v.astype(jnp.int32), mesh)
    with pytest.raises(GluArgumentError):
        distributed_radix_sort_f32(k, v, mesh)


def test_graft_entry_compiles():
    sys.path.insert(0, str(ROOT))
    import __graft_entry__ as ge

    fn, args = ge.entry()
    assert jax.jit(fn).lower(*args).compile() is not None


def test_graft_dryrun_multichip():
    sys.path.insert(0, str(ROOT))
    import __graft_entry__ as ge

    ge.dryrun_multichip(min(8, len(jax.devices())))


@pytest.mark.parametrize("chunks,per_device", [(4, 2048), (2, 1024)])
def test_dist_sort_pipeline_chunks(chunks, per_device, seeded_rng):
    # chunked overlap pipeline (padded path): per-chunk partitions +
    # independent exchanges + (src-major, chunk-minor) compaction
    rng = seeded_rng(71 if chunks == 4 else 79)
    _run(rng.sample_int_vector(8 * per_device, 0, 0xFFFFFFFE), pipeline_chunks=chunks)


def test_dist_sort_pipeline_chunks_skewed(seeded_rng):
    # zipf-ish skew + chunking: chunk-level blocks are 1/4 size, so skew
    # tolerance must come from the same lossless doubling retry
    rng = seeded_rng(73)
    raw = rng.sample_int_vector(8 * 2048, 0, 0xFFFFFFFE)
    keys = (raw % np.uint32(1 << 8)).astype(np.uint32) * np.uint32(3)
    _run(keys, pipeline_chunks=4)


def test_dist_sort_pipeline_chunks_presorted():
    # range-correlated input concentrates whole chunks into single blocks:
    # exercises chunked overflow + retry
    _run(np.arange(8 * 2048, dtype=np.uint32), pipeline_chunks=2)


def test_dist_sort_pipeline_chunks_u64(seeded_rng):
    # chunked pipeline through the 3-payload (hi, lo, value) body
    rng = seeded_rng(83)
    n = 8 * 1024
    hi = rng.sample_int_vector(n, 0, 3)
    lo = rng.sample_int_vector(n, 0, 0xFFFFFFFE)
    vals = np.arange(n, dtype=np.uint32)
    mesh = make_sort_mesh(jax.devices()[: min(8, len(jax.devices()))])
    D = mesh.shape["shards"]
    spec = jax.sharding.PartitionSpec("shards")
    sharding = jax.sharding.NamedSharding(mesh, spec)
    oh, ol, ov, counts, overflow = distributed_radix_sort_u64_parts(
        jax.device_put(jnp.asarray(hi), sharding),
        jax.device_put(jnp.asarray(lo), sharding),
        jax.device_put(jnp.asarray(vals), sharding),
        mesh,
        pipeline_chunks=2,
    )
    assert int(np.asarray(overflow)[0]) == 0
    key64 = (hi.astype(np.uint64) << 32) | lo
    order = np.argsort(key64, kind="stable")
    oh, ol, ov, counts = map(np.asarray, (oh, ol, ov, counts))
    per = oh.shape[0] // D
    gh, gl, gv = [], [], []
    for d in range(D):
        c = int(counts[d])
        gh.append(oh[d * per : d * per + c])
        gl.append(ol[d * per : d * per + c])
        gv.append(ov[d * per : d * per + c])
    np.testing.assert_array_equal(np.concatenate(gh), hi[order])
    np.testing.assert_array_equal(np.concatenate(gl), lo[order])
    np.testing.assert_array_equal(np.concatenate(gv), vals[order].astype(np.uint32))


def test_dist_sort_pipeline_chunks_bad_divisibility():
    mesh = make_sort_mesh(jax.devices()[:8])
    k = jnp.zeros(8 * 100, jnp.uint32)
    v = jnp.zeros(8 * 100, jnp.uint32)
    with pytest.raises(GluArgumentError):
        distributed_radix_sort(k, v, mesh, pipeline_chunks=3)


def test_default_resolvers():
    """pipeline_chunks="auto" takes 2 on D >= 2 when the shard divides,
    else 1; explicit values must divide the shard."""
    from glu_tpu.parallel.dist_sort import _resolve_chunks

    assert _resolve_chunks("auto", 2, 4096) == 2
    assert _resolve_chunks("auto", 1, 4096) == 1   # d=1: exact fast path
    assert _resolve_chunks("auto", 8, 4097) == 1   # not divisible
    assert _resolve_chunks(4, 8, 4096) == 4
    with pytest.raises(GluArgumentError):
        _resolve_chunks(3, 8, 4096)
    with pytest.raises(GluArgumentError):
        _resolve_chunks(0, 8, 4096)
