#!/usr/bin/env python
"""External validation anchor (b): SPC/E water Widom mu_ex at 298 K.

Runs literature-parameter SPC/E water (systems.make_spce_box) in NVT
(translation/rotation moves only) at 0.997 g/cm^3 and measures the Widom
excess chemical potential. Published SPC/E values with Ewald
electrostatics cluster at -28..-30.5 kJ/mol = -6.7..-7.3 kcal/mol
(Hermans/Pathiaseril/Anderson JACS 110 (1988) 5982 report ~-29.3 kJ/mol
by TI; Quintana & Haymet CPL 189 (1992) and later Widom studies agree
within ~1 kJ/mol; our no-LJ-tail reference semantics adds ~+0.2
kcal/mol). PASS band used here: -7.5 .. -6.3 kcal/mol.

Usage (CPU ~15 min at the default sizes):
    python scripts/validate_spce.py [--replicas 64] [--blocks 30]
                                    [--steps 2000] [--trials 256]
                                    [--waters 128] [--dtype f32]
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicas", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=30)
    ap.add_argument("--eq-blocks", type=int, default=150)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--trials", type=int, default=256)
    ap.add_argument("--waters", type=int, default=128)
    ap.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    ap.add_argument("--platform", default=None)
    args = ap.parse_args()

    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
    import jax
    import jax.numpy as jnp
    import numpy as np

    from maniac_tpu import load_system
    from maniac_tpu.mc.widom import mu_excess_K, widom_block
    from maniac_tpu.parallel.replicas import replicate, run_block_replicated
    from maniac_tpu.systems import make_spce_box

    KB_KCALMOL = 0.0019872041
    dtype = jnp.float32 if args.dtype == "f32" else jnp.float64

    with tempfile.TemporaryDirectory() as tmp:
        make_spce_box(tmp, n_water=args.waters, density=0.997, temp=298.0,
                      cutoff=9.0 if args.waters >= 200 else 7.0, tol=1e-5,
                      probs=(0.5, 0.5, 0.0, 0.0), tstep=0.25, rstep=0.4,
                      recal=True)
        sysm = load_system(f"{tmp}/input.maniac", f"{tmp}/topology.data",
                           f"{tmp}/parameters.inc", dtype=dtype)
    spec, state = sysm.spec, sysm.state
    print(f"# SPC/E N={args.waters} L={float(spec.box_diag[0]):.3f} A "
          f"rho=0.997 g/cm3 T=298 K dev={jax.devices()[0]}")

    states = replicate(spec, state, args.replicas)
    t0 = time.time()
    KB = KB_KCALMOL
    for b in range(args.eq_blocks):
        states = run_block_replicated(spec, states, args.steps, True)
        if (b + 1) % max(1, args.eq_blocks // 10) == 0:
            # U/N convergence check: liquid SPC/E sits near -11 kcal/mol
            from maniac_tpu.system import E_TOT
            u_n = (np.asarray(states.energy[:, E_TOT],
                              dtype=np.float64).mean() * KB / args.waters)
            print(f"# eq block {b + 1:4d}: U/N = {u_n:7.3f} kcal/mol",
                  flush=True)
    print(f"# equilibrated {args.eq_blocks}x{args.steps} steps x "
          f"{args.replicas} replicas in {time.time() - t0:.1f} s")

    wb = jax.jit(jax.vmap(lambda st, k: widom_block(spec, st, args.trials,
                                                    k)))
    key = jax.random.PRNGKey(2024)
    b_rep = []
    for b in range(args.blocks):
        states = run_block_replicated(spec, states, args.steps, False)
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, args.replicas)
        # widom_block returns ln B (overflow-safe); convert in f64
        b_rep.append(np.exp(np.asarray(wb(states, keys),
                                       dtype=np.float64))[:, 0])
        mu_run = mu_excess_K(np.mean(b_rep), float(spec.temp_K)) * KB_KCALMOL
        print(f"block {b + 1:3d}: running mu_ex = {mu_run:8.3f} kcal/mol")
    per_rep = np.stack(b_rep).mean(axis=0)              # (replicas,)
    B = per_rep.mean()
    sem = per_rep.std(ddof=1) / np.sqrt(per_rep.size)
    mu = mu_excess_K(B, float(spec.temp_K)) * KB_KCALMOL
    dmu = (KB_KCALMOL * float(spec.temp_K)) * sem / B
    ok = -7.5 <= mu <= -6.3
    print(f"mu_ex = {mu:.3f} +- {dmu:.3f} kcal/mol "
          f"(published SPC/E band -7.3..-6.7; PASS band -7.5..-6.3)")
    print(f"RESULT: {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
