"""Triclinic-box coverage: the 27-image minimum-image path and the
triclinic reciprocal lattice, end to end.

The reference ships a DIPOLE-orthorhombic validation case (run.sh:88-96)
but nothing exercises its triclinic branch either; here we pin:
* tilt -> 0 agreement with the orthorhombic code path,
* structure factors vs a direct brute-force sum on a tilted cell,
* the bookkeeping == recompute invariant over a full move mix,
* parameter invariance of the Coulomb total on the tilted cell.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np

from maniac_tpu import load_system
from maniac_tpu.constants import COULOMB_K, KB_KCALMOL
from maniac_tpu.mc.moves import mc_step
from maniac_tpu.physics.energy import (active_site_mask, site_positions,
                                       system_energy)
from maniac_tpu.system import E_RECIP, E_TOT

from fixtures import make_triclinic_water


def _load(outdir, **kw):
    return load_system(f"{outdir}/input.maniac", f"{outdir}/topology.data",
                       f"{outdir}/parameters.inc", **kw)


def test_zero_tilt_matches_orthorhombic(tmp_path):
    """A triclinic box with a tiny tilt must reproduce the orthorhombic
    energies (both converged: the triclinic k-list uses the physical-|k|
    cutoff while the ortho path keeps the reference's integer rule, so
    they only coincide once the Ewald split is converged)."""
    d2 = tmp_path / "tri"
    make_triclinic_water(str(d2), n_water=8, L=14.0, tilt=(1e-4, 1e-4, 1e-4),
                         cutoff=5.0, tol=1e-8, seed=7)
    s2 = _load(str(d2))
    assert s2.spec.is_triclinic
    e2 = float(s2.state.energy[E_TOT])
    # same coordinates through the ortho code path: strip the (~0) tilt
    import shutil
    d3 = tmp_path / "tri0"
    shutil.copytree(str(d2), str(d3))
    lines = open(d3 / "topology.data").read().splitlines(keepends=True)
    lines = [ln for ln in lines if "xy xz yz" not in ln]
    open(d3 / "topology.data", "w").writelines(lines)
    s3 = _load(str(d3))
    assert not s3.spec.is_triclinic
    e3 = float(s3.state.energy[E_TOT])
    assert abs(e2 - e3) * KB_KCALMOL < 2e-3, (e2, e3)


def test_triclinic_total_vs_oracle(tmp_path):
    """Absolute anchor: engine Coulomb total on a genuinely tilted cell vs
    the general-cell brute-force oracle, to the reference's 0.01 kcal/mol
    LAMMPS-parity bar."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "scripts"))
    from oracle import intramolecular_coulomb, periodic_coulomb

    from maniac_tpu.system import E_COUL, E_INTRA, E_SELF

    make_triclinic_water(str(tmp_path), n_water=8, L=14.0,
                         tilt=(2.0, 1.2, 0.8), cutoff=5.5, tol=1e-8)
    sysm = _load(str(tmp_path))
    spec, state = sysm.spec, sysm.state
    pos = np.asarray(site_positions(spec, state))
    act = np.asarray(active_site_mask(spec, state.n_mol))
    pos = pos[act]
    q = np.asarray(spec.site_q)[act]
    mol = np.asarray(spec.site_mol)[act]
    H = np.asarray(spec.H)
    ref = (periodic_coulomb(pos, q, H, alpha=0.6, n_images=3, kmax=28,
                            coulomb_k=COULOMB_K)
           - intramolecular_coulomb(pos, q, mol, H, coulomb_k=COULOMB_K))
    e = np.asarray(state.energy)
    got = e[E_RECIP] + e[E_COUL] + e[E_SELF] + e[E_INTRA]
    assert abs(got - ref) * KB_KCALMOL < 0.01, (got, ref)


def test_triclinic_recip_brute_force(tmp_path):
    """Structure factors on a genuinely tilted cell vs a direct numpy sum
    (validates the triclinic reciprocal lattice convention)."""
    make_triclinic_water(str(tmp_path), n_water=4, L=12.0,
                         tilt=(2.5, 1.5, 1.0), cutoff=5.0, tol=1e-4)
    sysm = _load(str(tmp_path))
    spec, state = sysm.spec, sysm.state
    pos = np.asarray(site_positions(spec, state))
    act = np.asarray(active_site_mask(spec, state.n_mol))
    q = np.asarray(spec.site_q) * act
    k = np.asarray(spec.k_cart)
    live = np.asarray(spec.k_live)
    theta = pos @ k.T
    re = (q @ np.cos(theta)) * live
    im = (q @ np.sin(theta)) * live
    np.testing.assert_allclose(np.asarray(state.amp_re).ravel(), re,
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(state.amp_im).ravel(), im,
                               atol=1e-9)
    w = np.asarray(spec.k_weights).ravel()
    e_recip = (w * (re ** 2 + im ** 2)).sum() * COULOMB_K \
        * 2 * math.pi / float(spec.volume)
    np.testing.assert_allclose(float(state.energy[E_RECIP]), e_recip,
                               rtol=1e-12)


def test_triclinic_move_consistency(tmp_path):
    """bookkeeping == recompute through the full move mix on a tilted box
    (27-image minimum-image path)."""
    make_triclinic_water(str(tmp_path), n_water=6, L=14.0,
                         tilt=(2.0, 1.2, 0.8), cutoff=5.0, tol=1e-4,
                         probs=(0.3, 0.2, 0.5, 0.0), fugacity=5000.0)
    sysm = _load(str(tmp_path))
    spec, state = sysm.spec, sysm.state
    step = jax.jit(lambda st, k: mc_step(spec, st, k))
    keys = jax.random.split(jax.random.PRNGKey(2), 60)
    for i in range(60):
        state = step(state, keys[i])
        if i % 15 == 14:
            e, amp_re, amp_im = system_energy(spec, state)
            assert float(jnp.abs(state.energy[E_TOT] - e[E_TOT])) < 1e-7
            assert float(jnp.max(jnp.abs(state.amp_re - amp_re))) < 1e-8
    c = np.asarray(state.counters)
    assert c.sum() > 0 and c[1].sum() > 0  # trials and accepts happened


def test_triclinic_coulomb_parameter_invariance(tmp_path):
    """Total Coulomb energy independent of the Ewald split on a tilted
    cell (at converged tolerances; the DL_POLY-style heuristic's intrinsic
    truncation converges slowly - see DIVERGENCES.md)."""
    from maniac_tpu.system import E_COUL, E_INTRA, E_SELF
    vals = []
    for i, (rc, tol) in enumerate([(5.5, 1e-7), (5.0, 1e-8)]):
        d = tmp_path / str(i)
        make_triclinic_water(str(d), n_water=8, L=14.0, tilt=(2.0, 1.2, 0.8),
                             cutoff=rc, tol=tol)
        sysm = _load(str(d))
        e = np.asarray(sysm.state.energy)
        vals.append((e[E_RECIP] + e[E_COUL] + e[E_SELF] + e[E_INTRA])
                    * KB_KCALMOL)
    assert abs(vals[0] - vals[1]) < 0.01, vals
