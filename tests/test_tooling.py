"""Run-time plumbing: compile-cache placement, the benchmark's peak table,
and chip_smoke.py's refusal to report without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of applying them."""
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    return calls


def test_cache_default_dir(monkeypatch, config_updates):
    from hot_mpm.utils import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.enable_compilation_cache()
    assert path == os.path.join(REPO, ".jax_cache") == cache.DEFAULT_DIR
    assert config_updates["jax_compilation_cache_dir"] == path


def test_cache_honours_env_dir(monkeypatch, config_updates, tmp_path):
    from hot_mpm.utils import cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_compilation_cache() == str(tmp_path)
    # JAX reads the variable itself; no directory is set in code
    assert "jax_compilation_cache_dir" not in config_updates


def test_bench_peak_known_kind():
    import bench

    assert bench.peak_hbm("NVIDIA H100 80GB HBM3") == 3.35e12


def test_bench_peak_unknown_kind_raises():
    import bench

    with pytest.raises(KeyError, match="no peak bandwidth"):
        bench.peak_hbm("cpu")


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_gpu(tmp_path, where):
    """On the CPU, and as a lone file outside a checkout, chip_smoke.py
    exits non-zero and prints no ok line."""
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, timeout=300, cwd=tmp_path, env=env)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
