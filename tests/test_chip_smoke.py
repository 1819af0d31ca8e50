"""chip_smoke.py and the compile-cache helper, off the card.

The script's phases run here at small sizes on the CPU platform (their
comparison logic is what is under test); the script itself must refuse a
machine without a GPU and print no result there.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from glu_tpu.utils import compile_cache  # noqa: E402


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu()
    assert e.value.code not in (0, None)


def test_script_exits_nonzero_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize(
    "phase", ["phase_sort_kv", "phase_scan_reduce", "phase_sort_forms", "phase_ragged_scan"]
)
def test_phase_small(phase):
    rec = getattr(chip_smoke, phase)(n=1 << 14)
    assert rec["phase"] == phase[len("phase_"):]
    assert rec["n"] == 1 << 14
    assert rec["warm_s"] > 0
    json.dumps(rec)


def test_phase_four_padded_on_cpu_mesh():
    recs = list(chip_smoke.phase_four(jax.devices()[:4], n=1 << 14))
    assert [r["phase"] for r in recs] == ["dist_reduce_scan", "dist_sort"]
    assert sum(recs[1]["counts"]) == 1 << 14


def test_phase_detects_a_wrong_result(monkeypatch):
    # a sort that drops stability must fail the phase, not pass silently
    real_sort = chip_smoke.glu.radix_sort

    def unstable(keys, values):
        return real_sort(keys, values[::-1])

    monkeypatch.setattr(chip_smoke.glu, "radix_sort", unstable)
    with pytest.raises(RuntimeError, match="sort_kv"):
        chip_smoke.phase_sort_kv(n=1 << 12)


def test_compile_cache_env_set_is_left_alone(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "from_env"))
    assert compile_cache.use_compile_cache(tmp_path / "fixed") == str(tmp_path / "from_env")
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_env_unset_uses_fixed_path(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        assert compile_cache.use_compile_cache(tmp_path / "fixed") == str(tmp_path / "fixed")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "fixed")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
