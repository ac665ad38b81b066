"""Entry points that need a GPU refuse to run without one, and the
persistent compile cache goes where its helper says."""

import importlib.util
import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [[], ["--cards", "4"]])
def test_chip_smoke_main_fails_on_cpu(argv, capsys):
    smoke = _load_chip_smoke()
    with pytest.raises(SystemExit) as exc:
        smoke.main(argv)
    assert exc.value.code not in (0, None)
    assert "needs an NVIDIA GPU" in str(exc.value.code)
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository the script cannot pass."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_bench_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_compile_cache_respects_env(monkeypatch, tmp_path):
    from fmm_bem_tpu.utils.compile_cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets nothing
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_into_checkout(monkeypatch):
    from fmm_bem_tpu.utils.compile_cache import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        # a fixed path: calling again gives the same directory
        assert enable_compile_cache() == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
