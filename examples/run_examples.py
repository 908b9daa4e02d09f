#!/usr/bin/env python
"""Named example launcher - the rebuild's analog of the reference's run.sh
(reference: /root/reference/run.sh:4-96 enumerates SLIT/ZIF8/MFI/LJ-gas/
H2O-gas cases bound to the mc-topology submodule, which is not available
here). Each case generates its own topology/deck/coefficients and runs the
full CLI end to end.

    python examples/run_examples.py            # list cases
    python examples/run_examples.py H2O-gas    # run one case
    python examples/run_examples.py all        # run everything (CPU ok)
"""

import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from maniac_tpu import systems  # noqa: E402

CASES = {
    # name: (builder, builder kwargs, CLI extras)
    "H2O-gas": (systems.make_water_box,
                dict(n_water=8, L=14.0, cutoff=6.0, tol=1e-6, nb_block=5,
                     nb_step=500, probs=(0.5, 0.5, 0.0, 0.0)), []),
    "H2O-gcmc": (systems.make_water_box,
                 dict(n_water=8, L=14.0, cutoff=5.5, tol=1e-5, nb_block=5,
                      nb_step=500, probs=(0.3, 0.3, 0.4, 0.0),
                      fugacity=2000.0, recal=True), ["--widom", "32"]),
    "LJ-gas": (systems.make_lj_gas,
               dict(n=32, L=18.0, cutoff=6.0, tol=1e-4, nb_block=5,
                    nb_step=500, probs=(0.4, 0.0, 0.6, 0.0), fugacity=5.0),
               []),
    "LJ-swap": (systems.make_lj_gas,
                dict(n=24, L=16.0, two_species=True, cutoff=6.0, tol=1e-4,
                     nb_block=5, nb_step=400, probs=(0.2, 0.0, 0.3, 0.5),
                     fug_a=3.0, fug_b=3.0), []),
    "NaCl": (systems.make_nacl,
             dict(n_cells=2, cutoff=5.6, tol=1e-6, nb_block=2, nb_step=100,
                  probs=(1.0, 0.0, 0.0, 0.0)), []),
    "ZIF8-H2O": (systems.make_zif_like,
                 dict(n_cells=4, a=5.66, n_water=16, fugacity=30.0,
                      nb_block=3, nb_step=300), ["--capacity", "64"]),
    "DIPOLE-triclinic": (systems.make_triclinic_water,
                         dict(n_water=6, L=14.0, tilt=(2.0, 1.2, 0.8),
                              cutoff=5.5, tol=1e-5, nb_block=3, nb_step=300,
                              probs=(0.4, 0.3, 0.3, 0.0), fugacity=1000.0),
                         []),
    # analogs of the remaining reference run.sh cases (run.sh:4-96)
    "SLIT": (systems.make_slit_pore,
             dict(n_water=8, nb_block=3, nb_step=300, fugacity=80.0),
             ["--capacity", "24", "--profile", "16"]),
    "MFI-CO2": (systems.make_mfi_co2,
                dict(n_co2=8, nb_block=3, nb_step=300, fugacity=40.0),
                ["--capacity", "32"]),
    "CH4O-H2O": (systems.make_fw_ch4o_h2o,
                 dict(n_water=6, n_meoh=6, nb_block=3, nb_step=300),
                 ["--capacity", "24"]),
}


def run_isotherm() -> int:
    """One compiled program = a full adsorption isotherm: vmapped replicas
    with per-replica chemical potentials (maniac_tpu.parallel.replicas).
    Prints fugacity -> <N> for the ZIF-like flagship chemistry."""
    import jax.numpy as jnp
    import numpy as np

    from maniac_tpu import load_system
    from maniac_tpu.parallel.replicas import (perturb_activity, replicate,
                                              run_block_sweep)

    tmp = tempfile.mkdtemp(prefix="maniac-isotherm-")
    systems.make_zif_like(tmp, n_cells=3, a=5.66, n_water=4, fugacity=10.0)
    sysm = load_system(f"{tmp}/input.maniac", f"{tmp}/topology.data",
                       f"{tmp}/parameters.inc", capacity=64)
    spec, state = sysm.spec, sysm.state
    scale = np.array([0.25, 1.0, 4.0, 16.0])
    base = np.asarray(spec.type_activity)[None, :] * scale[:, None]
    spec_sweep = perturb_activity(spec, jnp.asarray(base))
    states = replicate(spec, state, len(scale))
    states = run_block_sweep(spec_sweep, states, 2000, False)  # burn-in
    counts = np.zeros(len(scale))
    for _ in range(10):
        states = run_block_sweep(spec_sweep, states, 200, False)
        counts += np.asarray(states.n_mol)[:, 1]
    print("== isotherm (fugacity scale -> <N waters>):")
    for s, n in zip(scale, counts / 10):
        print(f"   {s:6.2f}x -> {n:7.2f}")
    return 0


def run_case(name: str) -> int:
    builder, kw, extra = CASES[name]
    tmp = tempfile.mkdtemp(prefix=f"maniac-{name}-")
    builder(tmp, **kw)
    out = os.path.join(tmp, "outputs/")
    cmd = [sys.executable, "-m", "maniac_tpu.cli",
           "-i", f"{tmp}/input.maniac", "-d", f"{tmp}/topology.data",
           "-p", f"{tmp}/parameters.inc", "-o", out] + extra
    print(f"== {name}: {' '.join(cmd)}")
    rc = subprocess.call(cmd, cwd=REPO)
    log = os.path.join(out, "log.maniac")
    ok = rc == 0 and os.path.exists(log) \
        and "Simulation Completed" in open(log).read()
    print(f"== {name}: {'OK' if ok else 'FAILED'} (outputs in {out})")
    return 0 if ok else 1


def main() -> int:
    from maniac_tpu.utils.mapguard import ensure_map_headroom

    ensure_map_headroom()
    if len(sys.argv) < 2:
        print("cases:", " ".join(CASES), "isotherm")
        return 0
    names = list(CASES) if sys.argv[1] == "all" else sys.argv[1:]
    if names == ["isotherm"]:
        return run_isotherm()
    # this process never touches the device while a child runs: each CLI
    # case is a child, and so is the isotherm when other cases follow it
    # (a JAX process reserves most of an accelerator's memory)
    rc = 0
    for n in names:
        rc = max(rc, subprocess.call([sys.executable, __file__, n])
                 if n == "isotherm" else run_case(n))
    return rc


if __name__ == "__main__":
    sys.exit(main())
