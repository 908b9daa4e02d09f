"""Absolute physics validation of the energy engine.

The Fortran oracle cannot be built in this environment (no gfortran), so
correctness is anchored to analytic results instead:

* NaCl Madelung constant (1.7475645946...) from the full Ewald machinery
* isolated-molecule limit: one water in a big box -> bare intramolecular
  Coulomb + LJ energy
* invariance of the total energy under (cutoff, tolerance) changes
* internal cross-checks: single-molecule path vs full-system path
"""

import math

import jax
import jax.numpy as jnp
import numpy as np

from maniac_tpu import load_system
from maniac_tpu.constants import COULOMB_K, KB_KCALMOL
from maniac_tpu.physics.energy import (active_site_mask,
                                        pair_energy_footprint,
                                        site_positions)
from maniac_tpu.system import E_COUL, E_INTRA, E_LJ, E_RECIP, E_SELF, E_TOT

from fixtures import make_nacl, make_water_box

MADELUNG = 1.747564594633


def _load(outdir, **kw):
    return load_system(f"{outdir}/input.maniac", f"{outdir}/topology.data",
                       f"{outdir}/parameters.inc", **kw)


def test_madelung_constant(tmp_path):
    a = 5.6402
    make_nacl(str(tmp_path), n_cells=2, a=a, cutoff=5.6, tol=1e-7)
    sysm = _load(str(tmp_path))
    e = np.asarray(sysm.state.energy)
    n_formula = 4 * 2 ** 3
    r0 = a / 2
    e_coul_total = e[E_RECIP] + e[E_COUL] + e[E_SELF]
    expected = -n_formula * MADELUNG * COULOMB_K / r0
    assert abs(e[E_LJ]) < 1e-10
    np.testing.assert_allclose(e_coul_total, expected, rtol=2e-6)


def test_single_water_isolated_limit(tmp_path):
    """One rigid molecule alone in a big box has ~zero total energy.

    MANIAC's convention fully excludes intramolecular electrostatics: the
    (erfc(ar)-1)/r correction cancels the erf(ar)/r that the reciprocal sum
    contributes for intramolecular pairs, so recip + self + intra -> 0 up to
    periodic-image effects. (This is why the reference needs no bonded energy
    terms at all.)"""
    make_water_box(str(tmp_path), n_water=1, L=25.0, cutoff=10.0, tol=1e-6)
    sysm = _load(str(tmp_path))
    e = np.asarray(sysm.state.energy)
    assert abs(e[E_LJ]) < 1e-12 and abs(e[E_COUL]) < 1e-12
    # the three Ewald pieces are individually large...
    assert abs(e[E_SELF]) * KB_KCALMOL > 100.0
    # ...but cancel down to dipole-image size: mu ~ 0.45 e.A for this
    # geometry gives mu^2 * C / L^3 ~ 2 K of periodic dipole-lattice energy.
    assert abs(e[E_TOT]) < 10.0  # Kelvin


def test_parameter_invariance(tmp_path):
    """The total COULOMB energy must be (nearly) independent of the Ewald
    split (cutoff & tolerance). The LJ part legitimately depends on the
    cutoff - MANIAC applies a hard LJ truncation with no tail correction."""
    coul = []
    for i, (rc, tol) in enumerate([(7.0, 1e-6), (6.5, 1e-7), (6.0, 1e-7)]):
        d = tmp_path / str(i)
        make_water_box(str(d), n_water=8, L=14.0, cutoff=rc, tol=tol)
        sysm = _load(str(d))
        e = np.asarray(sysm.state.energy)
        coul.append((e[E_RECIP] + e[E_COUL] + e[E_SELF] + e[E_INTRA])
                    * KB_KCALMOL)
    # note: the reference's DL_POLY-style heuristic converges slowly; at
    # tol=1e-5 the reciprocal truncation error is ~0.07 kcal/mol.
    assert abs(coul[0] - coul[1]) < 0.005
    assert abs(coul[2] - coul[1]) < 0.005


def test_single_mol_path_matches_full_path(tmp_path):
    """sum over molecules of the per-move pair kernel == 2x full pair sum."""
    make_water_box(str(tmp_path), n_water=8, L=14.0)
    sysm = _load(str(tmp_path))
    spec, state = sysm.spec, sysm.state
    pos = site_positions(spec, state)
    mask = active_site_mask(spec, state.n_mol)
    n = int(state.n_mol[0])
    A = spec.A_list[0]
    e_lj_sum = 0.0
    e_c_sum = 0.0
    for m in range(n):
        slot = m
        start = m * A
        P = pos[start:start + A][None]
        q = spec.site_q[start:start + A][None]
        cls = spec.site_cls[start:start + A][None]
        mm = jnp.ones((1, A), bool)
        e_lj, e_c = pair_energy_footprint(spec, pos, mask, P, q, cls, mm,
                                          jnp.int32(slot), jnp.int32(slot))
        e_lj_sum += float(e_lj[0])
        e_c_sum += float(e_c[0])
    e = np.asarray(state.energy)
    np.testing.assert_allclose(e_lj_sum / 2, e[E_LJ], rtol=1e-10, atol=1e-8)
    np.testing.assert_allclose(e_c_sum / 2, e[E_COUL], rtol=1e-10, atol=1e-8)


def test_recip_brute_force(tmp_path):
    """Structure factors vs a direct dumb numpy sum."""
    make_water_box(str(tmp_path), n_water=4, L=12.0, cutoff=5.0, tol=1e-4)
    sysm = _load(str(tmp_path))
    spec, state = sysm.spec, sysm.state
    pos = np.asarray(site_positions(spec, state))
    act = np.asarray(active_site_mask(spec, state.n_mol))
    q = np.asarray(spec.site_q) * act
    k = np.asarray(spec.k_cart)
    live = np.asarray(spec.k_live)  # dense-grid padding entries carry 0
    theta = pos @ k.T
    re = (q @ np.cos(theta)) * live
    im = (q @ np.sin(theta)) * live
    np.testing.assert_allclose(np.asarray(state.amp_re).ravel(), re,
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(state.amp_im).ravel(), im,
                               atol=1e-9)
    w = np.asarray(spec.k_weights).ravel()  # form folded; 0 off-ellipsoid
    e_recip = (w * (re ** 2 + im ** 2)).sum() * COULOMB_K \
        * 2 * math.pi / float(spec.volume)
    np.testing.assert_allclose(float(state.energy[E_RECIP]), e_recip,
                               rtol=1e-12)


def test_intra_matches_direct(tmp_path):
    make_water_box(str(tmp_path), n_water=2, L=14.0)
    sysm = _load(str(tmp_path))
    spec, state = sysm.spec, sysm.state
    alpha = float(spec.alpha)
    from scipy.special import erfc
    total = 0.0
    pos = np.asarray(site_positions(spec, state))
    q = np.asarray(spec.site_q)
    for m in range(2):
        p = pos[m * 4:(m + 1) * 4]
        qq = q[m * 4:(m + 1) * 4]
        for i in range(4):
            for j in range(i + 1, 4):
                r = np.linalg.norm(p[i] - p[j])
                total += qq[i] * qq[j] * (erfc(alpha * r) - 1.0) / r
    total *= COULOMB_K
    np.testing.assert_allclose(float(state.energy[E_INTRA]), total, rtol=1e-10)


def test_amp_delta_separable_matches_direct(tmp_path):
    """Separable one-hot phase expansion == direct cos/sin over (A,K)."""
    import jax
    from maniac_tpu.physics.energy import amp_delta, amp_delta_direct
    make_water_box(str(tmp_path), n_water=4, L=12.0, cutoff=5.0, tol=1e-5)
    sysm = _load(str(tmp_path))
    spec = sysm.spec
    key = jax.random.PRNGKey(3)
    pos = jax.random.uniform(key, (2, 4, 3), dtype=spec.dtype) * 12.0 - 6.0
    q = jnp.asarray([[0.0, 0.5, 0.5, -1.0], [0.3, -0.3, 0.1, -0.1]],
                    dtype=spec.dtype)
    mask = jnp.asarray([[True, True, True, False], [True, True, True, True]])
    signs = jnp.asarray([-1.0, 1.0], dtype=spec.dtype)
    d1 = amp_delta(spec, pos, q, mask, signs)
    d2 = amp_delta_direct(spec, pos, q, mask, signs)
    np.testing.assert_allclose(d1[0], d2[0], atol=5e-12)
    np.testing.assert_allclose(d1[1], d2[1], atol=5e-12)


def test_alpha_override_invariance(tmp_path):
    """ewald_alpha (deck extension) re-balances the Ewald split;
    the converged Coulomb total must be invariant."""
    totals = []
    for i, alpha in enumerate((0.0, 0.45, 0.6)):   # 0 = reference formula
        d = tmp_path / str(i)
        make_water_box(str(d), n_water=8, L=14.0, cutoff=6.5, tol=1e-7)
        if alpha:
            with open(d / "input.maniac", "a") as f:
                f.write(f"ewald_alpha {alpha}\n")
        sysm = _load(str(d))
        if alpha:
            assert abs(float(sysm.spec.alpha) - alpha) < 1e-12
        e = np.asarray(sysm.state.energy)
        totals.append((e[E_RECIP] + e[E_COUL] + e[E_SELF] + e[E_INTRA])
                      * KB_KCALMOL)
    assert abs(totals[1] - totals[0]) < 0.01, totals
    assert abs(totals[2] - totals[0]) < 0.01, totals
