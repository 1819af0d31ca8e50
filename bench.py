#!/usr/bin/env python
"""Benchmark harness.

Default metric: sorted u32 key-value pairs per second at 268,435,456 pairs,
next to the reference's 53.5 M keys/s on an RTX 2060 SUPER (reference
README.md:133; 5.022 s elapsed). Each mode prints JSON lines that name the
device they ran on; `--table` prints the reference's size ladder
(README.md:100-133) for reduce/scan/sort with derived throughputs, and
`--kernels` times the primitives against a device copy of the same bytes and
lists the kernels a profiler trace saw.

Method parity: like the reference (GL timer query around one invocation on
warm buffers, test/radix_sort_tests.cpp:160-193), we time a warm invocation
ended by `jax.block_until_ready`, after an untimed warm-up call that triggers
compilation and allocation (the analog of prepare_internal_buffers
pre-warming, radix_sort_tests.cpp:187). Run it as the only JAX process on
the device.
"""

import argparse
import json
import pathlib
import statistics
import time

import jax
import jax.numpy as jnp

from glu_tpu import ReduceOperator, exclusive_scan, radix_sort, radix_sort_keys, reduce
from glu_tpu.utils.compile_cache import use_compile_cache

BASELINE_SORT_268M_KEYS_PER_S = 53.5e6  # reference README.md:133 (268M pairs / 5.022 s)


def _emit(rec: dict) -> None:
    dev = jax.devices()[0]
    rec.update(platform=dev.platform, device_kind=dev.device_kind,
               device_count=len(jax.devices()))
    print(json.dumps(rec), flush=True)


def _rand_u32(n, seed=0):
    key = jax.random.key(seed)
    return jax.random.bits(key, (n,), dtype=jnp.uint32)


def _warm_runs(fn, make_args, reps=3):
    """Wall times of `reps` warm calls fn(*make_args()), each ended by
    block_until_ready. make_args builds fresh (donatable) inputs outside the
    timed region; one untimed warm-up call compiles first."""
    jax.block_until_ready(fn(*make_args()))
    runs = []
    for _ in range(reps):
        args = jax.block_until_ready(make_args())
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        runs.append(time.perf_counter() - t0)
    return runs


def _time_best(fn, make_args, reps=3):
    """Best-of-reps warm wall time (see _warm_runs)."""
    return min(_warm_runs(fn, make_args, reps))


def bench_sort(n, reps=3, bits=None):
    keys = _rand_u32(n, 1)
    vals = jnp.arange(n, dtype=jnp.uint32)
    return _time_best(
        lambda k, v: radix_sort(k, v, bits=bits),
        lambda: (jnp.copy(keys), jnp.copy(vals)), reps,
    )


def bench_sort_keys(n, reps=3):
    """Keys-only sort (no value payload — beyond the reference's mandatory
    key+value contract, README.md:88-89)."""
    keys = _rand_u32(n, 1)
    return _time_best(radix_sort_keys, lambda: (jnp.copy(keys),), reps)


def bench_segmented(n, num_segments=4096, reps=3):
    """Variable-length segmented sort (offsets form): S random ragged
    segments over n pairs."""
    from glu_tpu import radix_sort_segmented

    keys = _rand_u32(n, 1)
    vals = jnp.arange(n, dtype=jnp.uint32)
    cuts = jnp.sort(_rand_u32(num_segments - 1, 4) % jnp.uint32(n))
    offs = jnp.concatenate(
        [jnp.zeros(1, jnp.uint32), cuts, jnp.full((1,), n, jnp.uint32)]
    ).astype(jnp.int32)
    best = _time_best(
        lambda k, v: radix_sort_segmented(k, v, offsets=offs),
        lambda: (jnp.copy(keys), jnp.copy(vals)), reps,
    )
    _emit({
        "metric": f"radix_sort_segmented_keys_per_sec_n{n}_s{num_segments}",
        "value": n / best,
        "unit": "keys/s",
        "segments": num_segments,
        "vs_kv_baseline": n / best / BASELINE_SORT_268M_KEYS_PER_S,
    })


def bench_u64(n, reps=3):
    """64-bit key + u32 value sort ((hi, lo) halves form — no x64 needed)."""
    from glu_tpu import radix_sort_u64_parts

    hi = _rand_u32(n, 1)
    lo = _rand_u32(n, 2)
    vals = jnp.arange(n, dtype=jnp.uint32)
    # inputs are not donated, so the same arrays serve every call
    best = _time_best(radix_sort_u64_parts, lambda: (hi, lo, vals), reps)
    _emit({
        "metric": f"radix_sort_u64kv_keys_per_sec_n{n}",
        "value": n / best,
        "unit": "keys/s",
        "vs_kv_baseline": n / best / BASELINE_SORT_268M_KEYS_PER_S,
    })


def bench_reduce(n, reps=3):
    data = _rand_u32(n, 2)
    return _time_best(lambda x: reduce(x, ReduceOperator.SUM), lambda: (data,), reps)


def bench_scan(n, reps=3):
    data = _rand_u32(n, 3)
    return _time_best(exclusive_scan, lambda: (data,), reps)


def _fmt_ms(s):
    return f"{s * 1e3:10.3f} ms"


def full_table():
    """The reference's size ladder (README.md:100-133)."""
    sizes = [2**k for k in [10, 14, 16, 17, 19, 20, 24, 26, 27, 28]]
    dev = jax.devices()[0]
    print(f"# device={dev.platform} {dev.device_kind}")
    print("## Reduce (u32 sum)")
    for n in sizes:
        t = bench_reduce(n)
        print(f"{n:>12} {_fmt_ms(t)}  {n * 4 / t / 1e9:8.1f} GB/s read")
    print("## BlellochScan (u32 exclusive sum)")
    for n in sizes:
        t = bench_scan(n)
        print(f"{n:>12} {_fmt_ms(t)}  {n * 4 / t / 1e9:8.1f} GB/s in-size")
    print("## RadixSort (u32 key+value, 8 passes)")
    for n in sizes:
        t = bench_sort(n)
        print(f"{n:>12} {_fmt_ms(t)}  {n / t / 1e6:8.1f} M keys/s")


def _device_kernels(trace_dir, top=4):
    """(total, largest) device time of the newest trace under trace_dir:
    the sum of every event on the device planes' stream lines, and the
    `top` kernel names by their summed time."""
    from jax.profiler import ProfileData

    files = sorted(pathlib.Path(trace_dir).glob("plugins/profile/*/*.xplane.pb"))
    per = {}
    for plane in ProfileData.from_file(str(files[-1])).planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                per[ev.name] = per.get(ev.name, 0.0) + ev.duration_ns
    return sum(per.values()), sorted(per.items(), key=lambda kv: -kv[1])[:top]


def kernel_table(n_big, n_forms, trace_dir=None, reps=5):
    """Each primitive at its plain XLA lowering: median warm time, rate and,
    with trace_dir, the kernels a profiler trace of one call saw. The copy
    row (x + 1: one read and one write of n u32) is the bandwidth yardstick
    for the scan and the reduce; the sort forms at n_forms give ns/key next
    to the two-operand full-width sort."""
    from glu_tpu import (
        radix_argsort,
        radix_sort_multi,
        radix_sort_segmented,
        radix_sort_u64_parts,
    )

    big = _rand_u32(n_big, 1)
    iota_big = jnp.arange(n_big, dtype=jnp.uint32)
    keys = _rand_u32(n_forms, 2)
    hi = _rand_u32(n_forms, 3)
    iota = jnp.arange(n_forms, dtype=jnp.uint32)
    offs = jnp.concatenate([
        jnp.zeros(1, jnp.int32),
        jnp.sort(_rand_u32(4095, 4) % jnp.uint32(n_forms)).astype(jnp.int32),
        jnp.full((1,), n_forms, jnp.int32),
    ])
    add_one = jax.jit(lambda x: x + jnp.uint32(1))
    rows = [
        # (name, n, fn, make_args, bytes the op must move at least once)
        ("copy_x_plus_1", n_big, add_one, lambda: (big,), 8 * n_big),
        ("exclusive_scan", n_big, exclusive_scan, lambda: (big,), 8 * n_big),
        ("reduce_sum", n_big, lambda x: reduce(x, ReduceOperator.SUM), lambda: (big,), 4 * n_big),
        ("radix_sort_kv", n_big, radix_sort,
         lambda: (jnp.copy(big), jnp.copy(iota_big)), 16 * n_big),
        ("form_kv_2op", n_forms, radix_sort,
         lambda: (jnp.copy(keys), jnp.copy(iota)), None),
        ("form_keys_1op", n_forms, radix_sort_keys, lambda: (jnp.copy(keys),), None),
        ("form_argsort", n_forms, radix_argsort, lambda: (jnp.copy(keys),), None),
        ("form_kv_bits12_3op", n_forms,
         lambda k, v: radix_sort(k, v, bits=tuple(range(12))),
         lambda: (jnp.copy(keys), jnp.copy(iota)), None),
        ("form_multi_2payload_3op", n_forms, radix_sort_multi,
         lambda: (jnp.copy(keys), (jnp.copy(iota), jnp.copy(hi))), None),
        ("form_u64_parts_numkeys2", n_forms, radix_sort_u64_parts,
         lambda: (hi, keys, iota), None),
        ("form_segmented16_numkeys2", n_forms,
         lambda k, v: radix_sort_segmented(k, v, 16), lambda: (keys, iota), None),
        ("form_segmented_offsets4096_numkeys2", n_forms,
         lambda k, v: radix_sort_segmented(k, v, offsets=offs), lambda: (keys, iota), None),
    ]
    for name, n, fn, make_args, nbytes in rows:
        ts = _warm_runs(fn, make_args, reps)
        t = statistics.median(ts)
        rec = {"kernel_row": name, "n": n, "median_s": t, "runs_s": ts,
               "ns_per_key": t / n * 1e9}
        if nbytes is not None:
            rec["bytes_per_s"] = nbytes / t
        if trace_dir is not None:
            d = pathlib.Path(trace_dir) / name
            args = jax.block_until_ready(make_args())
            with jax.profiler.trace(str(d)):
                jax.block_until_ready(fn(*args))
            rec["device_ns"], rec["top_kernels_ns"] = _device_kernels(d)
        _emit(rec)


def bench_dist(n, reps=2, capacity_factor=1.5, pipeline_chunks="auto"):
    """Distributed sort throughput + scaling efficiency over all local
    devices."""
    from glu_tpu.parallel import distributed_radix_sort, make_sort_mesh

    devices = jax.devices()
    d = len(devices)
    n = (n // d) * d
    keys = _rand_u32(n, 5)
    vals = jnp.arange(n, dtype=jnp.uint32)
    mesh = make_sort_mesh(devices)
    spec = jax.sharding.PartitionSpec("shards")
    sharding = jax.sharding.NamedSharding(mesh, spec)
    keys = jax.device_put(keys, sharding)
    vals = jax.device_put(vals, sharding)

    def run(k, v):
        return distributed_radix_sort(
            k, v, mesh, capacity_factor=capacity_factor,
            pipeline_chunks=pipeline_chunks,
        )

    best = _time_best(run, lambda: (keys, vals), reps)
    single = bench_sort(n // d, reps=reps)  # one-device reference
    eff = (n / best) / (d * (n // d) / single)
    _emit({
        "metric": f"dist_sort_keys_per_sec_n{n}_d{d}",
        "value": n / best,
        "unit": "keys/s",
        "devices": d,
        "pipeline_chunks": pipeline_chunks,
        "scaling_efficiency_vs_1dev": eff,
    })


def _make_dist_keys(n, dist, seed=9):
    if dist == "uniform":
        return _rand_u32(n, seed)
    if dist == "presorted":
        return jnp.arange(n, dtype=jnp.uint32)
    if dist == "reverse":
        # NOT jnp.arange(n, 0, -1): a negative-step arange materializes on
        # the HOST and its transfer would land inside the timed region
        return jnp.uint32(n) - jnp.arange(n, dtype=jnp.uint32)
    if dist == "lowentropy":
        return _rand_u32(n, seed) % jnp.uint32(10)
    if dist == "zipf":
        # device-side zipf(s=1.3) equivalent via the Pareto inverse CDF:
        # survival P(X>k) ~ k^-(s-1), the same tail law np.random.zipf(1.3)
        # draws, without a host transfer. Heavy skew at EVERY digit level.
        u = jax.random.uniform(
            jax.random.key(seed), (n,), jnp.float32, minval=2.0**-24, maxval=1.0
        )
        x = jnp.power(u, jnp.float32(-1.0 / 0.3))
        return jnp.minimum(x, jnp.float32(2**32 - 256)).astype(jnp.uint32)
    raise ValueError(dist)


@jax.jit
def _device_verify(in_keys, out_k, out_v):
    """Device-side sort verification, so a 268M-pair check needs no host
    copy: sortedness, permutation (sum/xor/sum-of-squares checksums mod
    2^32), and stability (values ascending within equal-key runs, valid
    because the values are iota)."""
    sorted_ok = jnp.all(out_k[1:] >= out_k[:-1])

    def chks(x):
        # order-independent multiset checksums mod 2^32
        return (
            jnp.sum(x, dtype=jnp.uint32),
            jnp.sum(x * x, dtype=jnp.uint32),
            jnp.sum(x * jnp.uint32(0x9E3779B9) ^ (x >> 16), dtype=jnp.uint32),
        )

    perm_ok = jnp.all(jnp.array([a == b for a, b in zip(chks(in_keys), chks(out_k))]))
    vperm_ok = jnp.all(
        jnp.array(
            [
                a == b
                for a, b in zip(
                    chks(jnp.arange(in_keys.shape[0], dtype=jnp.uint32)), chks(out_v)
                )
            ]
        )
    )
    stable_ok = jnp.all(jnp.where(out_k[1:] == out_k[:-1], out_v[1:] > out_v[:-1], True))
    # pairing checksum: multiset of nonlinear (key, value) combines must match
    # the input's (key, iota) multiset — catches values swapped between
    # positions holding different keys, which the independent multiset checks
    # above would miss
    iota = jnp.arange(in_keys.shape[0], dtype=jnp.uint32)
    mix = lambda k, v: (k * jnp.uint32(0x9E3779B9)) ^ v
    pair_ok = jnp.all(
        jnp.array([a == b for a, b in zip(chks(mix(in_keys, iota)), chks(mix(out_k, out_v)))])
    )
    return sorted_ok & perm_ok & vperm_ok & stable_ok & pair_ok


def run_checks(n, bits=None):
    """BASELINE.json config battery: sorts across uniform, pre-sorted,
    reverse, low-entropy, and zipf-skewed keys, verified on-device.

    One untimed warm-up sort + verify first: every distribution shares the
    same shapes, so this pays ALL compiles (sort program + verifier) before
    any timed row. With bits=\"auto\" (the adaptive battery) each
    distribution compiles a DIFFERENT pass program, so every distribution
    gets its own untimed warm-up; the timed region still includes the
    varying-bit detection (one reduction + a 4-byte host fetch) — the price
    a real caller pays."""
    wk = _rand_u32(n, 11)
    wv = jnp.arange(n, dtype=jnp.uint32)
    ok_w, ov_w = radix_sort(jnp.copy(wk), wv, bits=bits)
    bool(_device_verify(wk, ok_w, ov_w))
    del wk, wv, ok_w, ov_w

    for dist in ("uniform", "presorted", "reverse", "lowentropy", "zipf"):
        keys = _make_dist_keys(n, dist)
        vals = jnp.arange(n, dtype=jnp.uint32)
        if bits is not None:  # per-distribution pass program: warm it first
            ok_w, ov_w = radix_sort(jnp.copy(keys), jnp.copy(vals), bits=bits)
            bool(_device_verify(keys, ok_w, ov_w))
            del ok_w, ov_w
        k, v = jax.block_until_ready((jnp.copy(keys), jnp.copy(vals)))
        t0 = time.perf_counter()
        out_k, out_v = jax.block_until_ready(radix_sort(k, v, bits=bits))
        dt = time.perf_counter() - t0
        ok = bool(_device_verify(keys, out_k, out_v))
        rec = {"check": dist, "n": n, "ok": ok, "keys_per_s": n / dt}
        if bits is not None:
            rec["bits"] = bits
        _emit(rec)
        if not ok:
            raise SystemExit(f"device verification FAILED for {dist} at n={n}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=268_435_456)
    ap.add_argument("--table", action="store_true", help="print the full reference size ladder")
    ap.add_argument("--kernels", action="store_true",
                    help="time each primitive against a device copy of the same bytes "
                         "(at --n) and the sort forms (at min(--n, 2^24))")
    ap.add_argument("--trace-dir", default=None,
                    help="with --kernels: trace one call of each row here; report "
                         "its total device time and its largest kernels")
    ap.add_argument("--dist", action="store_true", help="distributed sort over all local devices")
    ap.add_argument("--pipeline-chunks", default="auto",
                    type=lambda v: v if v == "auto" else int(v),
                    help="chunked overlap pipeline for --dist (exchange of chunk c "
                         "overlaps partition of chunk c+1 on real meshes)")
    ap.add_argument("--keys-only", action="store_true",
                    help="benchmark radix_sort_keys (no value payload)")
    ap.add_argument("--segmented", type=int, default=0, metavar="S",
                    help="benchmark the variable-length segmented sort with S random segments")
    ap.add_argument("--u64", action="store_true",
                    help="benchmark the 64-bit key sort (radix_sort_u64_parts)")
    ap.add_argument("--check", action="store_true",
                    help="run the BASELINE config battery (uniform/presorted/reverse/"
                         "lowentropy/zipf) with on-device verification")
    ap.add_argument("--adaptive", action="store_true",
                    help="sort with bits=\"auto\" (entropy-adaptive bit pruning; "
                         "detection cost included in the timed region)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu-mesh", type=int, default=0, metavar="N",
                    help="run on an N-virtual-device CPU mesh (a dry run of --dist "
                         "without accelerators; its numbers say nothing of a device)")
    args = ap.parse_args()

    if args.cpu_mesh:
        import os

        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={args.cpu_mesh}"
            ).strip()
        jax.config.update("jax_platforms", "cpu")
    use_compile_cache(pathlib.Path(__file__).resolve().parent / ".jax_cache")

    if args.table:
        full_table()
        return
    if args.kernels:
        kernel_table(args.n, min(args.n, 1 << 24), args.trace_dir, reps=max(args.reps, 3))
        return
    if args.dist:
        bench_dist(args.n, reps=args.reps, pipeline_chunks=args.pipeline_chunks)
        return
    if args.check:
        run_checks(args.n, bits="auto" if args.adaptive else None)
        return
    if args.segmented:
        bench_segmented(args.n, num_segments=args.segmented, reps=args.reps)
        return
    if args.u64:
        bench_u64(args.n, reps=args.reps)
        return

    n = args.n
    if args.keys_only:
        elapsed = bench_sort_keys(n, reps=args.reps)
        # the reference has no keys-only mode (pairs are mandatory,
        # README.md:88-89); the ratio below divides by its KEY+VALUE rate and
        # is a cross-workload comparison — named accordingly, not vs_baseline
        _emit({
            "metric": f"radix_sort_keysonly_keys_per_sec_n{n}",
            "value": n / elapsed,
            "unit": "keys/s",
            "vs_kv_baseline": n / elapsed / BASELINE_SORT_268M_KEYS_PER_S,
        })
        return

    elapsed = bench_sort(n, reps=args.reps, bits="auto" if args.adaptive else None)
    tag = "_adaptive" if args.adaptive else ""
    _emit({
        "metric": f"radix_sort_u32kv{tag}_keys_per_sec_n{n}",
        "value": n / elapsed,
        "unit": "keys/s",
        "vs_baseline": n / elapsed / BASELINE_SORT_268M_KEYS_PER_S,
    })


if __name__ == "__main__":
    main()
