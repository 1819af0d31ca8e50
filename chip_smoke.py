#!/usr/bin/env python
"""Smoke test of glu_tpu on an NVIDIA GPU, through the public API only.

    python chip_smoke.py           # one card: the phases below
    python chip_smoke.py --four    # four cards: the distributed path only

Phases on one card, each checked against a plain host reference:

  sort_kv      radix_sort of 2^28 seeded uniform u32 key/value pairs, against
               the native stable radix sort (glu_tpu/native). Values are the
               input positions, so exact equality checks stability too.
  scan_reduce  exclusive_scan and reduce(SUM), reduce(MIN) of 2^28 u32,
               against the native oracle (u32 sums wrap mod 2^32).
  sort_forms   at 2^24: radix_sort_keys, radix_argsort, descending=True,
               radix_sort_f32 (with +-0, +-inf, +-NaN), radix_sort_i32,
               radix_sort_u64_parts, radix_sort_multi with 2 payloads,
               radix_sort_segmented (16 equal parts; 4096 ragged offsets) and
               bits="auto" on keys % 1000, against NumPy stable sorts.
  ragged_scan  at 2^24: exclusive_scan(offsets=..., op=MIN) and
               segmented_reduce on u32 (SUM, MAX) and on f32 (SUM), against
               NumPy.

`--four` runs distributed_reduce, distributed_exclusive_scan and
distributed_radix_sort on 2^30 u32 pairs (2^28 per card, Pareto-tailed
"zipf" keys), against the native oracle.
It checks that each card holds its own shard before and after the sort and
prints each card's peak memory.

Integer results must match exactly. The f32 segment sums are compared with a
float64 reference at rtol=1e-4, because the device adds in another order than
the host. No phase runs a matrix product, so TF32 never arises.

Each phase prints one JSON line with its name, n, compile_s (first call minus
the median warm call, i.e. tracing and compilation) and warm_s (median of the
warm calls, each ended by jax.block_until_ready). Any mismatch raises and the
script exits non-zero. The last line, printed only when every phase passed,
is {"ok": true, "device": {...}}. When JAX's default device is not a GPU the
script exits non-zero before any phase and prints no result.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import time

import jax
import jax.numpy as jnp
import numpy as np

import glu_tpu as glu
from glu_tpu.native import get_oracle, have_native
from glu_tpu.utils.compile_cache import use_compile_cache

ROOT = pathlib.Path(__file__).resolve().parent


def require_gpu():
    """JAX's devices, if the default one is a GPU; else exit non-zero."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU, but JAX's default device is "
            f"{devices[0].platform} ({devices[0].device_kind})"
        )
    return devices


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def _check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: mismatch in {what}")


def _equal(got, want, what: str) -> None:
    _check(np.array_equal(np.asarray(got), np.asarray(want)), what)


def _timed(fn, make_args, reps: int = 3):
    """(result, compile_s, warm_s) of fn(*make_args()). make_args builds
    fresh inputs for every call (the sorts donate theirs); building them is
    not timed."""
    args = jax.block_until_ready(make_args())
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    warm = []
    for _ in range(reps):
        args = jax.block_until_ready(make_args())
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        warm.append(time.perf_counter() - t0)
    w = statistics.median(warm)
    return out, first - w, w


def _record(rec: dict, name: str, compile_s: float, warm_s: float) -> None:
    rec[name] = {"compile_s": compile_s, "warm_s": warm_s}


def _totals(rec: dict) -> dict:
    """Add the phase's compile_s and warm_s: the sums over its parts."""
    parts = [v for v in rec.values() if isinstance(v, dict)]
    rec["compile_s"] = sum(p["compile_s"] for p in parts)
    rec["warm_s"] = sum(p["warm_s"] for p in parts)
    return rec


def phase_sort_kv(n: int = 1 << 28, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    vals = np.arange(n, dtype=np.uint32)
    dk, dv = jnp.asarray(keys), jnp.asarray(vals)
    (ok, ov), c, w = _timed(glu.radix_sort, lambda: (jnp.copy(dk), jnp.copy(dv)))
    ek, ev = get_oracle().radix_sort_kv(keys, vals)
    _equal(ok, ek, "sort_kv keys")
    _equal(ov, ev, "sort_kv values")
    return {"phase": "sort_kv", "n": n, "compile_s": c, "warm_s": w,
            "keys_per_s": n / w, "native_oracle": have_native()}


def phase_scan_reduce(n: int = 1 << 28, seed: int = 1) -> dict:
    x = np.random.default_rng(seed).integers(0, 1 << 32, n, dtype=np.uint32)
    dx = jnp.asarray(x)
    oracle = get_oracle()
    rec = {"phase": "scan_reduce", "n": n}
    got, c, w = _timed(glu.exclusive_scan, lambda: (dx,))
    _equal(got, oracle.exclusive_scan(x), "exclusive_scan")
    _record(rec, "exclusive_scan", c, w)
    for op, name in ((glu.ReduceOperator.SUM, "sum"), (glu.ReduceOperator.MIN, "min")):
        got, c, w = _timed(lambda a, op=op: glu.reduce(a, op), lambda: (dx,))
        _check(np.uint32(np.asarray(got)) == oracle.reduce_u32(x, name), f"reduce {name}")
        _record(rec, f"reduce_{name}", c, w)
    return _totals(rec)


def _f32_total_order(x: np.ndarray) -> np.ndarray:
    """IEEE-754 total order as u32 (the bijection radix_sort_f32 documents)."""
    u = x.view(np.uint32)
    return np.where(u >> 31 == 1, ~u, u | np.uint32(0x80000000)).astype(np.uint32)


def _ragged_offsets(rng, n: int, segments: int) -> np.ndarray:
    cuts = np.sort(rng.integers(0, n + 1, segments - 1))
    return np.concatenate([[0], cuts, [n]]).astype(np.int32)


def phase_sort_forms(n: int = 1 << 24, seed: int = 2) -> dict:
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    small = keys % np.uint32(1000)
    vals = np.arange(n, dtype=np.uint32)
    dk, ds, dv = jnp.asarray(keys), jnp.asarray(small), jnp.asarray(vals)
    rec = {"phase": "sort_forms", "n": n}
    order = np.argsort(keys, kind="stable")

    got, c, w = _timed(glu.radix_sort_keys, lambda: (jnp.copy(dk),))
    _equal(got, keys[order], "radix_sort_keys")
    _record(rec, "radix_sort_keys", c, w)

    (sk, perm), c, w = _timed(glu.radix_argsort, lambda: (jnp.copy(dk),))
    _equal(perm, order.astype(np.uint32), "radix_argsort order")
    _equal(sk, keys[order], "radix_argsort keys")
    _record(rec, "radix_argsort", c, w)

    (ok, ov), c, w = _timed(
        lambda k, v: glu.radix_sort(k, v, descending=True),
        lambda: (jnp.copy(ds), jnp.copy(dv)),
    )
    o = np.argsort(~small, kind="stable")
    _equal(ok, small[o], "descending keys")
    _equal(ov, o.astype(np.uint32), "descending values")
    _record(rec, "descending", c, w)

    kf = rng.uniform(-1e6, 1e6, n).astype(np.float32)
    specials = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000,
                         0x7FC00000, 0xFFC00000], np.uint32).view(np.float32)
    kf[rng.choice(n, size=6 * 64, replace=False)] = np.repeat(specials, 64)
    dkf = jnp.asarray(kf)
    (ok, ov), c, w = _timed(glu.radix_sort_f32, lambda: (dkf, jnp.copy(dv)))
    o = np.argsort(_f32_total_order(kf), kind="stable")
    _equal(np.asarray(ok).view(np.uint32), kf[o].view(np.uint32), "radix_sort_f32 keys")
    _equal(ov, o.astype(np.uint32), "radix_sort_f32 values")
    _record(rec, "radix_sort_f32", c, w)

    ki = keys.view(np.int32)
    dki = jnp.asarray(ki)
    (ok, ov), c, w = _timed(glu.radix_sort_i32, lambda: (dki, jnp.copy(dv)))
    o = np.argsort(ki, kind="stable")
    _equal(ok, ki[o], "radix_sort_i32 keys")
    _equal(ov, o.astype(np.uint32), "radix_sort_i32 values")
    _record(rec, "radix_sort_i32", c, w)

    hi = small  # few distinct high words: the low word breaks most ties
    (oh, ol, ov), c, w = _timed(glu.radix_sort_u64_parts, lambda: (ds, dk, dv))
    o = np.argsort((hi.astype(np.uint64) << np.uint64(32)) | keys, kind="stable")
    _equal(oh, hi[o], "radix_sort_u64_parts hi")
    _equal(ol, keys[o], "radix_sort_u64_parts lo")
    _equal(ov, o.astype(np.uint32), "radix_sort_u64_parts values")
    _record(rec, "radix_sort_u64_parts", c, w)

    p2 = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    dp2 = jnp.asarray(p2)
    (ok, (o1, o2)), c, w = _timed(
        glu.radix_sort_multi, lambda: (jnp.copy(ds), (jnp.copy(dv), jnp.copy(dp2)))
    )
    o = np.argsort(small, kind="stable")
    _equal(ok, small[o], "radix_sort_multi keys")
    _equal(o1, o.astype(np.uint32), "radix_sort_multi payload 0")
    _equal(o2, p2[o], "radix_sort_multi payload 1")
    _record(rec, "radix_sort_multi", c, w)

    parts = 16
    (ok, ov), c, w = _timed(
        lambda k, v: glu.radix_sort_segmented(k, v, parts), lambda: (ds, dv)
    )
    o = np.lexsort((small, np.arange(n) // (n // parts)))
    _equal(ok, small[o], "radix_sort_segmented parts keys")
    _equal(ov, o.astype(np.uint32), "radix_sort_segmented parts values")
    _record(rec, "radix_sort_segmented_16", c, w)

    offs = _ragged_offsets(rng, n, 4096)
    doffs = jnp.asarray(offs)
    (ok, ov), c, w = _timed(
        lambda k, v: glu.radix_sort_segmented(k, v, offsets=doffs), lambda: (ds, dv)
    )
    o = np.lexsort((small, np.repeat(np.arange(offs.size - 1), np.diff(offs))))
    _equal(ok, small[o], "radix_sort_segmented offsets keys")
    _equal(ov, o.astype(np.uint32), "radix_sort_segmented offsets values")
    _record(rec, "radix_sort_segmented_offsets_4096", c, w)

    (ok, ov), c, w = _timed(
        lambda k, v: glu.radix_sort(k, v, bits="auto"), lambda: (jnp.copy(ds), jnp.copy(dv))
    )
    o = np.argsort(small, kind="stable")
    _equal(ok, small[o], "bits=auto keys")
    _equal(ov, o.astype(np.uint32), "bits=auto values")
    _record(rec, "bits_auto", c, w)
    return _totals(rec)


def phase_ragged_scan(n: int = 1 << 24, seed: int = 3, segments: int = 4096) -> dict:
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    xf = rng.uniform(0.5, 1.5, n).astype(np.float32)
    offs = _ragged_offsets(rng, n, segments)
    dx, dxf, doffs = jnp.asarray(x), jnp.asarray(xf), jnp.asarray(offs)
    bounds = list(zip(offs[:-1].tolist(), offs[1:].tolist()))
    rec = {"phase": "ragged_scan", "n": n, "segments": segments}
    MIN, SUM, MAX = glu.ReduceOperator.MIN, glu.ReduceOperator.SUM, glu.ReduceOperator.MAX

    got, c, w = _timed(lambda a: glu.exclusive_scan(a, op=MIN, offsets=doffs), lambda: (dx,))
    want = np.empty_like(x)
    for a, b in bounds:
        if b > a:
            want[a] = np.uint32(0xFFFFFFFF)
            want[a + 1:b] = np.minimum.accumulate(x[a:b])[:-1]
    _equal(got, want, "exclusive_scan offsets MIN")
    _record(rec, "exclusive_scan_min", c, w)

    got, c, w = _timed(lambda a: glu.segmented_reduce(a, doffs, SUM), lambda: (dx,))
    cs = np.concatenate([np.zeros(1, np.uint64), np.cumsum(x, dtype=np.uint64)])
    want = ((cs[offs[1:]] - cs[offs[:-1]]) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    _equal(got, want, "segmented_reduce u32 SUM")
    _record(rec, "segmented_reduce_sum_u32", c, w)

    got, c, w = _timed(lambda a: glu.segmented_reduce(a, doffs, MAX), lambda: (dx,))
    want = np.array([x[a:b].max() if b > a else 0 for a, b in bounds], np.uint32)
    _equal(got, want, "segmented_reduce u32 MAX")
    _record(rec, "segmented_reduce_max_u32", c, w)

    got, c, w = _timed(lambda a: glu.segmented_reduce(a, doffs, SUM), lambda: (dxf,))
    cs = np.concatenate([[0.0], np.cumsum(xf, dtype=np.float64)])
    want = cs[offs[1:]] - cs[offs[:-1]]
    _check(np.allclose(np.asarray(got, np.float64), want, rtol=1e-4, atol=0.0),
           "segmented_reduce f32 SUM")
    _record(rec, "segmented_reduce_sum_f32", c, w)
    return _totals(rec)


def _zipf_u32(rng, n: int) -> np.ndarray:
    """Pareto inverse CDF with the tail of zipf(s=1.3): P(X > k) ~ k^-0.3."""
    u = rng.uniform(2.0**-24, 1.0, n).astype(np.float32)
    x = np.power(u, np.float32(-1.0 / 0.3))
    return np.minimum(x, np.float32(2**32 - 256)).astype(np.uint32)


def _shard_devices(a) -> list:
    return [s.device for s in a.addressable_shards]


def phase_four(devices, n: int = 1 << 30, seed: int = 4):
    """The distributed path on a 1-D mesh over `devices`. Yields one record
    for distributed_reduce + distributed_exclusive_scan, then one for
    distributed_radix_sort."""
    from glu_tpu.parallel import (
        distributed_exclusive_scan,
        distributed_radix_sort,
        distributed_reduce,
        make_sort_mesh,
    )

    mesh = make_sort_mesh(devices)
    d = len(devices)
    sharding = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("shards"))
    keys = _zipf_u32(np.random.default_rng(seed), n)
    vals = np.arange(n, dtype=np.uint32)
    dk = jax.device_put(keys, sharding)
    dv = jax.device_put(vals, sharding)
    _check(sorted(map(str, _shard_devices(dk))) == sorted(map(str, devices)),
           "input shards: one per card")
    oracle = get_oracle()

    def peak():
        return [(dev.memory_stats() or {}).get("peak_bytes_in_use") for dev in devices]

    total, c1, w1 = _timed(lambda a: distributed_reduce(a, mesh), lambda: (dk,))
    _check(np.uint32(np.asarray(total)) == oracle.reduce_u32(keys, "sum"), "distributed_reduce")
    exc, c2, w2 = _timed(lambda a: distributed_exclusive_scan(a, mesh), lambda: (dk,))
    _equal(exc, oracle.exclusive_scan(keys), "distributed_exclusive_scan")
    del exc
    rec = {"phase": "dist_reduce_scan", "n": n, "devices": d}
    _record(rec, "reduce", c1, w1)
    _record(rec, "exclusive_scan", c2, w2)
    yield dict(_totals(rec), peak_bytes_in_use=peak())

    (ok, ov, counts, overflow), c, w = _timed(
        lambda k, v: distributed_radix_sort(k, v, mesh), lambda: (dk, dv), reps=2
    )
    _check(int(np.asarray(overflow)[0]) == 0, "distributed_radix_sort overflow")
    _check(sorted(map(str, _shard_devices(ok))) == sorted(map(str, devices)),
           "output shards: one per card")
    counts = np.asarray(counts)
    per = ok.shape[0] // d
    hk, hv = np.asarray(ok), np.asarray(ov)
    del ok, ov
    ek, ev = oracle.radix_sort_kv(keys, vals)
    _equal(np.concatenate([hk[i * per: i * per + counts[i]] for i in range(d)]), ek,
           "distributed_radix_sort keys")
    _equal(np.concatenate([hv[i * per: i * per + counts[i]] for i in range(d)]), ev,
           "distributed_radix_sort values")
    yield {
        "phase": "dist_sort", "n": n, "devices": d,
        "compile_s": c, "warm_s": w, "keys_per_s": n / w,
        "counts": counts.tolist(), "peak_bytes_in_use": peak(),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the distributed path on four cards")
    args = ap.parse_args(argv)
    devices = require_gpu()
    print(f"card: {card_info()}", flush=True)
    print(f"compile cache: {use_compile_cache(ROOT / '.jax_cache')}", flush=True)
    if args.four:
        if len(devices) < 4:
            raise SystemExit(f"chip_smoke: --four needs 4 GPUs, found {len(devices)}")
        for rec in phase_four(devices[:4]):
            print(json.dumps(rec), flush=True)
    else:
        for phase in (phase_sort_kv, phase_scan_reduce, phase_sort_forms, phase_ragged_scan):
            print(json.dumps(phase()), flush=True)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
