"""Wide-mesh distributed sort: D > 16 devices.

The bucket partition sorts by more than 4 bucket-id bits once D > 16, and
the splitter/offset machinery runs
with 31 splitters — a path the 8-device conftest mesh never executes. The
device count is fixed per process (XLA_FLAGS at backend init), so this
runs in a SUBPROCESS with a 32-device CPU mesh.

The default pipeline_chunks="auto" resolves to 2 on D >= 2, so the u32
case below ALSO covers the chunked (src-major, chunk-minor) compaction at a
device count whose bucket ids need more than 4 bits; the u64 case pins the
sequential path explicitly.
"""

import json
import os
import subprocess
import sys

import pytest

_SCRIPT = r"""
import os
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=32"
)
import json
import jax
jax.config.update("jax_platforms", "cpu")
import sys
sys.path.insert(0, %(repo)r)
import jax.numpy as jnp
import numpy as np
from glu_tpu.parallel import distributed_radix_sort, make_sort_mesh

D = 32
n = D * 2048
rng = np.random.default_rng(7)
k = rng.integers(0, 1 << 32, n, dtype=np.uint32)
v = np.arange(n, dtype=np.uint32)
mesh = make_sort_mesh()
assert mesh.shape["shards"] == D, mesh.shape
sh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("shards"))
ok, ov, counts, overflow = distributed_radix_sort(
    jax.device_put(jnp.asarray(k), sh), jax.device_put(jnp.asarray(v), sh), mesh,
)
assert int(np.asarray(overflow)[0]) == 0
counts = np.asarray(counts)
ok, ov = np.asarray(ok), np.asarray(ov)
padded = ok.shape[0] // D
gk = np.concatenate([ok[i * padded : i * padded + counts[i]] for i in range(D)])
gv = np.concatenate([ov[i * padded : i * padded + counts[i]] for i in range(D)])
order = np.argsort(k, kind="stable")
assert (gk == k[order]).all()
assert (gv == order.astype(np.uint32)).all()

# 64-bit keys through the same wide mesh (lexicographic splitters,
# 4-payload partition, chained local sorts)
from glu_tpu.parallel import distributed_radix_sort_u64_parts
hi = rng.integers(0, 1 << 32, n, dtype=np.uint32)
lo = rng.integers(0, 1 << 32, n, dtype=np.uint32)
oh, ol, ov2, counts2, overflow2 = distributed_radix_sort_u64_parts(
    jax.device_put(jnp.asarray(hi), sh), jax.device_put(jnp.asarray(lo), sh),
    jax.device_put(jnp.asarray(v), sh), mesh, pipeline_chunks=1,
)
assert int(np.asarray(overflow2)[0]) == 0
counts2 = np.asarray(counts2)
oh, ol, ov2 = np.asarray(oh), np.asarray(ol), np.asarray(ov2)
padded2 = oh.shape[0] // D
gh = np.concatenate([oh[i * padded2 : i * padded2 + counts2[i]] for i in range(D)])
gl = np.concatenate([ol[i * padded2 : i * padded2 + counts2[i]] for i in range(D)])
g2 = np.concatenate([ov2[i * padded2 : i * padded2 + counts2[i]] for i in range(D)])
full = (hi.astype(np.uint64) << np.uint64(32)) | lo
order64 = np.argsort(full, kind="stable")
assert (gh == hi[order64]).all() and (gl == lo[order64]).all()
assert (g2 == order64.astype(np.uint32)).all()
print(json.dumps({"ok": True, "devices": D, "n": n}))
"""


def test_dist_sort_32_devices():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT % {"repo": repo}],
        capture_output=True,
        text=True,
        timeout=600,
        env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["ok"] and rec["devices"] == 32
