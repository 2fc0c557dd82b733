"""Entry points around the device: the compile-cache location, the refusal
of a non-GPU backend by the measuring scripts, and the peak table."""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import pytest

from altair_tpu import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestCompileCache:
    def test_env_variable_is_honoured(self, monkeypatch, tmp_path):
        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        # JAX reads the variable itself: nothing is overridden
        assert jax.config.jax_compilation_cache_dir == before

    def test_default_is_fixed_and_inside_the_checkout(self, monkeypatch):
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        path = compile_cache.default_cache_dir()
        assert path == compile_cache.default_cache_dir()
        assert path == os.path.join(REPO, ".jax_cache")
        with open(os.path.join(REPO, ".gitignore")) as fh:
            assert ".jax_cache/" in fh.read().split()


def _run_without_gpu(script):
    # an empty PATH hides nvidia-smi; JAX is held to the CPU
    env = dict(os.environ, JAX_PLATFORMS="cpu", PATH="")
    return subprocess.run([sys.executable, os.path.join(REPO, script)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)


class TestRefuseNonGpu:
    def test_chip_smoke_exits_nonzero(self):
        r = _run_without_gpu("chip_smoke.py")
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout

    def test_chip_smoke_refuses_cpu_backend_with_a_card_listed(
            self, monkeypatch, tmp_path, capsys):
        """nvidia-smi answers, but JAX holds the CPU: the device phase
        must fail the run and print no result line."""
        smi = tmp_path / "nvidia-smi"
        smi.write_text("#!/bin/sh\necho 'Test Card, 700.00 W'\n")
        smi.chmod(0o755)
        monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}"
                           f"{os.environ.get('PATH', '')}")
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
        chip_smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(chip_smoke)
        # the CLI phases are subprocess sweeps; the refusal comes after them
        monkeypatch.setattr(chip_smoke, "run_cli", lambda *a: 0.425)
        with pytest.raises(SystemExit) as e:
            chip_smoke.main([])
        assert e.value.code == 1
        out = capsys.readouterr().out
        assert "[ok] card: Test Card, 700.00 W" in out
        assert "[FAIL] device: platform cpu" in out
        assert '"ok": true' not in out

    def test_bench_exits_nonzero_with_error_line(self):
        r = _run_without_gpu("bench.py")
        assert r.returncode == 1
        row = json.loads(r.stdout.strip().splitlines()[-1])
        assert row["error"] == "no_gpu" and row["value"] is None


class TestPeakTable:
    def test_unknown_device_kind_gets_no_peak(self):
        spec = importlib.util.spec_from_file_location(
            "run_all", os.path.join(REPO, "benchmarks", "run_all.py"))
        run_all = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(run_all)
        assert run_all.peaks_for("Some Accelerator 9000") is None
        h100 = run_all.peaks_for("NVIDIA H100 80GB HBM3")
        assert h100 == {"fp32_flops": 67e12, "tf32_flops": 495e12,
                        "hbm_bytes_s": 3.35e12}
