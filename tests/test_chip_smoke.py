"""chip_smoke.py phases at tiny size on the CPU, its refusals, and the
compile-cache helper the entry points share.

The phases are the same functions the GPU run calls at full size; here
they run on tiny systems so their control flow, checks and printed
numbers are exercised without a card. main() and bench.py refuse the CPU.
"""

import os
import shutil
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from maniac_tpu import load_system  # noqa: E402
from maniac_tpu.systems import make_zif_like, tiny_system  # noqa: E402
from maniac_tpu.utils import compile_cache  # noqa: E402

SHAPES = ("flagship", "mixed", "resv", "tricl")


def _tiny(shape, dtype=jnp.float32):
    def load():
        with tempfile.TemporaryDirectory() as tmp:
            deck, data, inc, res = tiny_system(tmp, shape)
            return load_system(deck, data, inc, dtype=dtype, capacity=16,
                               reservoir_file=res)
    return load


def _no_ok_line(out: str) -> bool:
    return '"ok"' not in out


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) != 0
    assert _no_ok_line(capsys.readouterr().out)


def test_main_refuses_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert _no_ok_line(r.stdout)


def test_bench_refuses_cpu(capsys):
    assert bench.main() != 0
    assert _no_ok_line(capsys.readouterr().out)


def test_bench_precision_evidence():
    """The post-timing check bench.py puts in its result line: one-hot
    reads exact and rigid O-H kept, here on a short run."""
    hw = bench.precision_evidence(blocks=1, replicas=2, steps=50)
    assert hw["ok"] and hw["onehot_err"] == 0.0
    assert hw["rigid_dOH_A"] < hw["rigid_tol_A"]


def test_phase_compile_fit(capsys):
    out = chip_smoke.phase_compile_fit({s: _tiny(s) for s in SHAPES},
                                       replicas=4, steps=8)
    assert set(out) == set(SHAPES)
    text = capsys.readouterr().out
    assert text.count("memory_analysis=") == len(SHAPES)
    assert all(r["need"] > 0 for r in out.values())


def test_phase_flagship(tmp_path, capsys):
    out = chip_smoke.phase_flagship(_tiny("flagship"), replicas=4, steps=8,
                                    blocks=2, trace_dir=str(tmp_path))
    assert out["rate"] > 0 and out["resync_s"] > 0
    assert "bring-up reading" in capsys.readouterr().out


def test_phase_cli(tmp_path):
    out = chip_smoke.phase_cli(
        lambda d: make_zif_like(d, n_cells=2, a=5.66, atoms_per_cell=4,
                                n_water=4, cutoff=5.0, tol=1e-3, nb_block=2,
                                nb_step=8),
        replicas=4, outdir=str(tmp_path / "out"))
    assert out["rc"] == 0


def test_phase_correctness(capsys):
    out = chip_smoke.phase_correctness(
        _tiny("flagship", jnp.float64), probe_blocks=1, probe_steps=50,
        probe_replicas=2, f64_steps=50, f64_blocks=2)
    assert out["onehot"] == 0.0
    assert out["drift_K"] <= chip_smoke.DRIFT_TOL_K
    assert out["oracle_kcal"] <= chip_smoke.ORACLE_TOL_KCAL
    assert out["f32_rel"] <= chip_smoke.F32_REL_TOL
    assert "tolerance" in capsys.readouterr().out


def test_phase_four_cards():
    assert len(jax.devices()) >= 4
    out = chip_smoke.phase_four_cards(_tiny("flagship"), per_card=2,
                                      steps=8, blocks=1)
    assert out["dpos"] <= chip_smoke.SHARD_POS_TOL


def test_compile_cache_env_set_sets_nothing(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/nonexistent-cache")
    assert compile_cache.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


@pytest.mark.parametrize("preset", [False, True])
def test_compile_cache_unset_uses_checkout_or_preset(monkeypatch, tmp_path,
                                                     preset):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir",
                          str(tmp_path) if preset else None)
        got = compile_cache.enable_compile_cache()
        if preset:
            assert got is None
            assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        else:
            assert got == os.path.join(REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
