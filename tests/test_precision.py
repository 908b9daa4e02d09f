"""Precision envelope tests: per-move dE in f32 vs exact f64.

BASELINE.json's 1e-6 kcal/mol per-move dE bar applies to the f64 engine
(identical formulas to the reference, evaluated in f64; absolute anchors in
tests/test_oracle.py). scripts/delta_e_report.py measures what the f32
path costs; this test pins that envelope so precision regressions are
caught. Measured on 2026-08-16: max 8.5e-5, mean 3.3e-5 kcal/mol over the
flagship chemistry (recorded in BASELINE.md).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))


def test_f32_per_move_delta_e_envelope():
    from delta_e_report import measure
    rep = measure(n_steps=200, seed=3, verbose=False)
    assert rep["accepted_moves"] > 20
    assert rep["max_abs_dE_err_kcalmol"] < 5e-4, rep
    assert rep["mean_abs_dE_err_kcalmol"] < 1e-4, rep


def test_f64_per_move_delta_e_exact(tmp_path):
    """The f64 engine's per-move dE matches a from-scratch f64 recompute to
    ~1e-9 kcal/mol (far below the 1e-6 bar) - this is the invariant the
    whole consistency suite rides on, asserted here at flagship chemistry."""
    import jax
    import jax.numpy as jnp

    from maniac_tpu import load_system
    from maniac_tpu.constants import KB_KCALMOL
    from maniac_tpu.mc.moves import mc_step
    from maniac_tpu.physics.energy import system_energy
    from maniac_tpu.system import E_TOT
    from maniac_tpu.systems import make_zif_like

    make_zif_like(str(tmp_path), n_cells=3, a=5.66, n_water=8, fugacity=50.0)
    sysm = load_system(f"{tmp_path}/input.maniac",
                       f"{tmp_path}/topology.data",
                       f"{tmp_path}/parameters.inc", dtype=jnp.float64,
                       capacity=32)
    spec, st = sysm.spec, sysm.state
    step = jax.jit(lambda s, k: mc_step(spec, s, k))
    efull = jax.jit(lambda s: system_energy(spec, s)[0][E_TOT])
    keys = jax.random.split(jax.random.PRNGKey(5), 80)
    e_prev_run = float(st.energy[E_TOT])
    e_prev_full = float(efull(st))
    worst = 0.0
    n_acc = 0
    for k in keys:
        st = step(st, k)
        e_run = float(st.energy[E_TOT])
        if e_run != e_prev_run:
            e_full = float(efull(st))
            worst = max(worst, abs((e_run - e_prev_run)
                                   - (e_full - e_prev_full)))
            e_prev_full = e_full
            n_acc += 1
        e_prev_run = e_run
    assert n_acc > 10
    assert worst * KB_KCALMOL < 1e-6, worst * KB_KCALMOL


def test_highest_matmul_precision_pin():
    """Importing the engine pins full-f32 matmul products (positions flow
    through dots; a TF32/bf16 product would deform rigid molecules)."""
    import jax

    import maniac_tpu  # noqa: F401
    assert jax.config.jax_default_matmul_precision == "highest"


def test_onehot_probe_exact_on_xla():
    """hwprobe stage 1: one-hot matmul reads are bit-exact."""
    from maniac_tpu.utils.hwprobe import probe_onehot_exact
    ok, err = probe_onehot_exact()
    assert ok and err == 0.0
