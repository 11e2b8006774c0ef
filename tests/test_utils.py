"""Compile-cache resolution and the chip smoke test's refusal off the GPU."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest

from qkd_ldpc_tpu import utils

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def config_calls(monkeypatch):
    """Record jax.config.update calls instead of applying them (enabling
    a cache for the whole test process is what the suite avoids)."""
    import jax

    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    return calls


def test_cache_honours_jax_compilation_cache_dir(monkeypatch, config_calls,
                                                 tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: JAX reads it itself and the program
    sets no other directory."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("QKD_LDPC_NO_COMPILE_CACHE", raising=False)
    assert utils.enable_compilation_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in config_calls


def test_cache_default_is_fixed_path_in_checkout(monkeypatch, config_calls):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("QKD_LDPC_NO_COMPILE_CACHE", raising=False)
    got = utils.enable_compilation_cache()
    assert got == utils.DEFAULT_CACHE_DIR == str(ROOT / ".jax_cache")
    assert config_calls["jax_compilation_cache_dir"] == got
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()
    assert utils.enable_compilation_cache() == got  # stable across calls


def test_cache_opt_out(monkeypatch, config_calls):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setenv("QKD_LDPC_NO_COMPILE_CACHE", "1")
    assert utils.enable_compilation_cache() is None
    assert config_calls == {}


def test_chip_smoke_refuses_cpu():
    """Without a GPU the smoke test exits non-zero and prints no result."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "not on a GPU" in out.stderr


def test_chip_smoke_out_dir_guard(tmp_path):
    """--out is cleared only when chip_smoke.py made it; a foreign
    non-empty directory is refused and left as it was."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    new = tmp_path / "new"
    smoke.fresh_out_dir(str(new))
    (new / "old.csv").write_text("x")
    smoke.fresh_out_dir(str(new))  # its own: emptied, marker rewritten
    assert sorted(p.name for p in new.iterdir()) == [smoke._OUT_MARK]

    foreign = tmp_path / "foreign"
    foreign.mkdir()
    (foreign / "keep.txt").write_text("x")
    with pytest.raises(SystemExit, match="not made by chip_smoke.py"):
        smoke.fresh_out_dir(str(foreign))
    assert (foreign / "keep.txt").read_text() == "x"
