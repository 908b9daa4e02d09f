"""Tabulated pair potentials (reference: src/tabulated_utils.f90).

The reference carries linear-interpolation tables for erfc(alpha r)/r,
r^6 and r^12 but compiles them out (use_table=.false.,
src/parameters.f90:41-42, with a "make it an input parameter" TODO).
Here ``use_table`` IS a deck keyword. These tests pin:

* the LookupTabulated semantics (f[0] at r<=0, ZERO beyond the grid -
  i.e. tabulated Coulomb gains an implicit cutoff at real_space_cutoff,
  src/tabulated_utils.f90:104-117),
* the tabulated pair energy against an independent numpy brute force,
* the bookkeeping == recompute invariant under GCMC moves, and
* that a forced framework split is refused with tables on.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from maniac_tpu import load_system
from maniac_tpu.constants import COULOMB_K
from maniac_tpu.io.deck import parse_deck
from maniac_tpu.physics.energy import tab_lookup
from maniac_tpu.system import E_COUL, E_LJ
from maniac_tpu.utils.errors import ManiacError

from fixtures import make_water_box


def _load(outdir, **kw):
    return load_system(f"{outdir}/input.maniac", f"{outdir}/topology.data",
                       f"{outdir}/parameters.inc", **kw)


def _np_lookup(table, dx, r):
    """Independent numpy re-statement of LookupTabulated."""
    n = len(table) - 1
    out = np.zeros_like(r)
    for idx, rr in np.ndenumerate(r):
        if rr <= 0.0:
            out[idx] = table[0]
        elif rr >= n * dx:
            out[idx] = 0.0
        else:
            i = int(rr / dx)
            t = (rr - i * dx) / dx
            out[idx] = (1.0 - t) * table[i] + t * table[i + 1]
    return out


def test_lookup_semantics():
    table = jnp.asarray(np.array([1.0, 3.0, 2.0, 5.0]))
    dx = 0.5
    r = jnp.asarray(np.array([-1.0, 0.0, 0.25, 0.5, 1.2, 1.5, 99.0]))
    got = np.asarray(tab_lookup(table, dx, r))
    want = np.array([1.0, 1.0, 2.0, 3.0, 2.0 + 0.4 * 3.0, 0.0, 0.0])
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_tabulated_pair_energy_vs_bruteforce(tmp_path):
    make_water_box(str(tmp_path), n_water=8, L=14.0, cutoff=6.0, tol=1e-4,
                   probs=(1.0, 0.0, 0.0, 0.0), use_table="true",
                   tabulated_points=2000)
    sysm = _load(str(tmp_path))
    spec, state = sysm.spec, sysm.state
    assert spec.use_table and not spec.fw_split

    pos = np.asarray(state.pos.T)
    q = np.asarray(spec.site_q)
    cls = np.asarray(spec.site_cls)
    mol = np.asarray(spec.site_mol)
    # n_mol has R+1 entries with the pad type pinned at 0, so this covers
    # pad sites (site_type == R) too
    live = np.asarray(spec.site_midx) < np.asarray(state.n_mol)[
        np.asarray(spec.site_type)]
    eps_cls = np.asarray(spec.eps_cls)
    sig_cls = np.asarray(spec.sig_cls)
    L = 14.0
    cutoff = float(spec.cutoff)
    dx = float(spec.tab_dx)
    t_erfc = np.asarray(spec.tab_erfc)
    t_r6 = np.asarray(spec.tab_r6)
    t_r12 = np.asarray(spec.tab_r12)

    idx = np.where(live)[0]
    e_lj = 0.0
    e_c = 0.0
    for a in idx:
        for b in idx:
            if b <= a or mol[a] == mol[b]:
                continue
            d = pos[a] - pos[b]
            d -= L * np.round(d / L)
            r = float(np.linalg.norm(d))
            ra = np.array([r])
            if r < cutoff:
                sig = sig_cls[cls[a], cls[b]]
                epsv = eps_cls[cls[a], cls[b]]
                if epsv != 0.0:
                    den6 = _np_lookup(t_r6, dx, ra)[0]
                    den12 = _np_lookup(t_r12, dx, ra)[0]
                    e_lj += 4.0 * epsv * (sig**12 / den12 - sig**6 / den6)
            e_c += q[a] * q[b] * _np_lookup(t_erfc, dx, ra)[0]
    e_c *= COULOMB_K

    np.testing.assert_allclose(float(state.energy[E_LJ]), e_lj,
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(float(state.energy[E_COUL]), e_c,
                               rtol=1e-9, atol=1e-9)


def test_tabulated_gcmc_consistency(tmp_path):
    from maniac_tpu.mc.moves import mc_step
    from maniac_tpu.physics.energy import system_energy
    from maniac_tpu.system import E_TOT

    make_water_box(str(tmp_path), n_water=8, L=14.0, cutoff=5.0, tol=1e-4,
                   probs=(0.3, 0.2, 0.5, 0.0), fugacity=5000.0,
                   use_table="true")
    sysm = _load(str(tmp_path))
    spec, state = sysm.spec, sysm.state
    step = jax.jit(lambda st, k: mc_step(spec, st, k))
    keys = jax.random.split(jax.random.PRNGKey(3), 60)
    for i in range(60):
        state = step(state, keys[i])
    e, amp_re, _ = system_energy(spec, state)
    assert float(jnp.abs(state.energy[E_TOT] - e[E_TOT])) < 1e-7
    assert float(jnp.max(jnp.abs(state.amp_re - amp_re))) < 1e-7
    c = np.asarray(state.counters)
    assert c[0].sum() == 60 and c[1].sum() > 0


def test_use_table_rejects_forced_framework_split(tmp_path):
    make_water_box(str(tmp_path), n_water=4, L=12.0, cutoff=5.0, tol=1e-3,
                   use_table="true", framework_split="on")
    with pytest.raises(ManiacError):
        parse_deck(f"{tmp_path}/input.maniac")
