"""``chip_smoke.py``, ``bench.py`` and the compile-cache helper, on the CPU.

Every smoke phase runs here at a tiny size (the chip runs them at full
width); ``main`` refuses a non-GPU backend, ``--four-cards`` selects only
its phase, and a failed check ends the run without the result line.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

import chip_smoke
from two_pass_lanczos_tpu.utils import compile_cache, determinism

REPO = Path(__file__).resolve().parents[1]

TINY = {
    "phase_matvec": dict(arcs=(2000, 5000), sparse_arcs=2000),
    "phase_replay": dict(arcs=2000, k=20),
    "phase_headline": dict(arcs=2000, k=20, big_arcs=5000, big_k=10),
    "phase_f32": dict(arcs=5000, nodes=100, k=10),
    "phase_four_cards": dict(arcs=3000, k=10, n_devices=4),
}


@pytest.mark.parametrize("name", sorted(TINY))
def test_phase_passes_at_tiny_size(name):
    results = getattr(chip_smoke, name)(**TINY[name])
    assert results
    for r in results:
        assert r["ok"], r


def test_accuracy_phase_at_tiny_size():
    """The accuracy phase against reference errors computed here at the
    same tiny size: every ratio is 1 up to the floor."""
    import numpy as np

    import two_pass_lanczos_tpu as tpl
    from two_pass_lanczos_tpu.models.synthetic import create_diagonal_problem

    n, ks = 300, (10, 20)
    published = {}
    for fn in ("inv", "exp"):
        solver = tpl.make_inv_solver() if fn == "inv" else tpl.make_exp_solver()
        f_scalar = (lambda lam: 1.0 / lam) if fn == "inv" else np.exp
        for sc in ("well", "ill"):
            op, eigs = create_diagonal_problem(n, f"{sc}-conditioned", fn)
            b = np.random.default_rng(42).standard_normal(n)
            truth = f_scalar(eigs) * b
            published[(fn, sc)] = {
                k: tuple(chip_smoke._rel(run(op, b, k, solver), truth)
                         for run in (tpl.lanczos, tpl.lanczos_two_pass))
                for k in ks}
    results = chip_smoke.phase_accuracy(n=n, ks=ks, published=published)
    assert len(results) == 2 * 2 * len(ks) * 2
    for r in results:
        assert r["ok"], r


def test_published_errors_read_the_results_csvs():
    errs = chip_smoke.published_errors("inv", "well")
    assert set(errs) >= {100, 200}
    assert all(len(v) == 2 for v in errs.values())


def test_main_refuses_a_cpu_backend(monkeypatch, capsys, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jax.default_backend() == "cpu"
    assert chip_smoke.main([]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "not a GPU" in err


def _fake_gpu(monkeypatch, tmp_path, outcome=True):
    ran = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "fake card, 0 W")

    def run(phases, card):
        ran.extend(p.__name__ for p in phases)
        return outcome

    monkeypatch.setattr(chip_smoke, "run_phases", run)
    return ran


@pytest.mark.parametrize("four", [False, True])
def test_main_selects_phases(monkeypatch, capsys, tmp_path, four):
    ran = _fake_gpu(monkeypatch, tmp_path)
    assert chip_smoke.main(["--four-cards"] if four else []) == 0
    if four:
        assert ran == ["phase_four_cards"]
    else:
        assert ran == [p.__name__ for p in chip_smoke.PHASES]
        assert "phase_four_cards" not in ran
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "fake card, 0 W"
    last = json.loads(out[-1])
    assert last == {"ok": True, "device": {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind, "count": len(jax.devices())}}


def test_main_failed_check_prints_no_result(monkeypatch, capsys, tmp_path):
    _fake_gpu(monkeypatch, tmp_path, outcome=False)
    assert chip_smoke.main([]) == 1
    out = capsys.readouterr().out
    assert '"ok": true' not in out


def test_run_phases_reports_each_check(capsys):
    def good():
        return [dict(check="a", value=0.0, tol=1.0, ok=True, seconds=0.5)]

    def bad():
        return [dict(check="b", value=2.0, tol=1.0, ok=False)]

    assert chip_smoke.run_phases((good,), "card") is True
    assert chip_smoke.run_phases((good, bad), "card") is False
    out = capsys.readouterr().out
    assert "[ok] good: a" in out and "[FAIL] bad: b" in out
    assert "wall on card" in out


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_respects_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


FLAG = determinism.FUSION_AUTOTUNER_FLAG


@pytest.mark.parametrize("before, after, added", [
    ("", f"--{FLAG}=false", True),
    ("--xla_dump_to=/tmp/d", f"--xla_dump_to=/tmp/d --{FLAG}=false", True),
    (f"--{FLAG}=true", f"--{FLAG}=true", False),
], ids=["unset", "other_flags", "user_choice_kept"])
def test_pin_fusion_emitters(before, after, added):
    env = {"XLA_FLAGS": before} if before else {}
    assert determinism.pin_fusion_emitters(env) is added
    assert env["XLA_FLAGS"] == after


def test_import_pins_fusion_emitters():
    """Importing the package turns the autotuner off before any backend
    starts."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-c", "import os, two_pass_lanczos_tpu, jax.numpy as jnp;"
         "print(float(jnp.ones(3).sum())); print(os.environ['XLA_FLAGS'])"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["3.0", f"--{FLAG}=false"]


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_scripts_exit_nonzero_without_a_gpu(script, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    proc = subprocess.run([sys.executable, script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory without the package, the script fails."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
