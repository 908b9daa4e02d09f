#!/usr/bin/env python
"""Quantify per-move dE precision: float32 engine vs float64 ground truth.

BASELINE.json sets a per-move dE parity bar of 1e-6 kcal/mol vs the Fortran
reference. The float64 engine meets it by construction (identical formulas
evaluated in f64; the absolute anchors live in tests/test_oracle.py). The
GPU flagship runs float32, so this script measures what f32 actually costs:
it advances an f32 chain on the flagship system and, for every accepted
move, compares the engine's running dE against an exact f64 recomputation
of the total energy before/after the move.

Run on CPU (the precision oracle backend):
    JAX_PLATFORMS=cpu python scripts/delta_e_report.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import tempfile

import jax.numpy as jnp
import numpy as np


def measure(n_steps: int = 400, seed: int = 0, verbose: bool = True):
    from maniac_tpu import load_system
    from maniac_tpu.constants import KB_KCALMOL
    from maniac_tpu.mc.moves import mc_step
    from maniac_tpu.physics.energy import system_energy
    from maniac_tpu.system import E_TOT
    from maniac_tpu.systems import make_zif_like

    with tempfile.TemporaryDirectory() as tmp:
        make_zif_like(tmp, n_cells=4, a=5.66, n_water=16, fugacity=50.0)
        sys32 = load_system(f"{tmp}/input.maniac", f"{tmp}/topology.data",
                            f"{tmp}/parameters.inc", dtype=jnp.float32,
                            capacity=64)
        sys64 = load_system(f"{tmp}/input.maniac", f"{tmp}/topology.data",
                            f"{tmp}/parameters.inc", dtype=jnp.float64,
                            capacity=64)
    spec32, spec64 = sys32.spec, sys64.spec
    st = sys32.state

    def cast64(s32):
        """f32 state -> f64 state (exact: f32 values embed in f64)."""
        return sys64.state.replace(
            com=s32.com.astype(jnp.float64),
            pos=s32.pos.astype(jnp.float64),
            n_mol=s32.n_mol)

    step = jax.jit(lambda s, k: mc_step(spec32, s, k))
    e64 = jax.jit(lambda s: system_energy(spec64, s)[0][E_TOT])

    keys = jax.random.split(jax.random.PRNGKey(seed), n_steps)
    errs = []
    e64_prev = float(e64(cast64(st)))
    e32_prev = float(st.energy[E_TOT])
    n_acc = 0
    for i in range(n_steps):
        st = step(st, keys[i])
        e32_now = float(st.energy[E_TOT])
        if e32_now != e32_prev:  # accepted move
            e64_now = float(e64(cast64(st)))
            de32 = e32_now - e32_prev
            de64 = e64_now - e64_prev
            errs.append(abs(de32 - de64))
            e64_prev = e64_now
            n_acc += 1
        e32_prev = e32_now

    errs = np.asarray(errs) * KB_KCALMOL
    report = {
        "accepted_moves": n_acc,
        "max_abs_dE_err_kcalmol": float(errs.max()),
        "mean_abs_dE_err_kcalmol": float(errs.mean()),
        "p99_abs_dE_err_kcalmol": float(np.percentile(errs, 99)),
    }
    if verbose:
        print("# per-move dE error, f32 engine vs exact f64 recompute "
              "(flagship chemistry, kcal/mol)")
        for k, v in report.items():
            print(f"{k:28s} {v:.3e}" if isinstance(v, float) else
                  f"{k:28s} {v}")
        print("# BASELINE.json bar (f64 vs Fortran): 1e-6 kcal/mol - met by")
        print("# the f64 engine by construction; f32 trades ~1e-4 kcal/mol")
        print("# per-move precision of f32 throughput runs (drift bounded by")
        print("# per-block amplitude resynthesis, DIVERGENCES.md #13).")
    return report


if __name__ == "__main__":
    measure()
