"""Guest<->guest honest Coulomb cutoff (DIVERGENCES.md #22).

The reference sums the damped real-space term erfc(alpha r)/r over ALL
pairs with no cutoff (src/energy_utils.f90:374-442). With `guest_split`
on (the default) we truncate mobile pairs at gg_rcut = 4.4/alpha where
erfc < 5e-10. These tests pin:
  * spec gating (deck keyword, env override, tabulated exclusion, the
    automatic radius and its `gg_rcut` override),
  * that the gate actually bites (totals differ from the plain engine)
    while staying under the 1e-6 kcal/mol BASELINE parity bar, per move
    and on totals,
  * the bookkeeping==recompute invariant with the gate on.

The fixture box (L=24, ewald_alpha 0.5 -> gg_rcut 8.8 A) guarantees many
live pairs beyond the cutoff, so none of this passes vacuously.
"""

import jax
import jax.numpy as jnp
import numpy as np

from maniac_tpu import load_system
from maniac_tpu.constants import ERFC_DECAY
from maniac_tpu.mc.driver import run_block
from maniac_tpu.mc.moves import mc_step
from maniac_tpu.physics.energy import system_energy
from maniac_tpu.system import E_TOT
from maniac_tpu.systems import make_water_box

KCAL_PER_K = 1.0 / 503.2189


def _load(outdir, **kw):
    return load_system(f"{outdir}/input.maniac", f"{outdir}/topology.data",
                       f"{outdir}/parameters.inc", **kw)


def _fixture(tmp_path, **kw):
    kw.setdefault("ewald_alpha", 0.5)
    kw.setdefault("fugacity", 40000.0)
    kw.setdefault("probs", (0.3, 0.2, 0.5, 0.0))
    make_water_box(str(tmp_path), n_water=24, L=24.0, cutoff=8.0, **kw)
    return str(tmp_path)


def test_spec_gating(tmp_path, monkeypatch):
    out = _fixture(tmp_path)
    sysm = _load(out, dtype=jnp.float64, capacity=32)
    assert sysm.spec.gg_cut
    np.testing.assert_allclose(sysm.spec.gg_rcut, ERFC_DECAY / 0.5)

    monkeypatch.setenv("MANIAC_GGSPLIT", "0")
    assert not _load(out, dtype=jnp.float64, capacity=32).spec.gg_cut
    monkeypatch.delenv("MANIAC_GGSPLIT")

    out2 = _fixture(tmp_path / "off", guest_split="off")
    assert not _load(out2, dtype=jnp.float64, capacity=32).spec.gg_cut

    out3 = _fixture(tmp_path / "rc", gg_rcut=7.25)
    assert _load(out3, dtype=jnp.float64, capacity=32).spec.gg_rcut == 7.25

    # tabulated potentials carry their own implicit cutoff (#18)
    out4 = _fixture(tmp_path / "tab", use_table="true")
    assert not _load(out4, dtype=jnp.float64, capacity=32).spec.gg_cut


def test_split_vs_plain_total_and_per_move(tmp_path, monkeypatch):
    out = _fixture(tmp_path)
    sysm = _load(out, dtype=jnp.float64, capacity=32)
    monkeypatch.setenv("MANIAC_GGSPLIT", "0")
    plain = _load(out, dtype=jnp.float64, capacity=32)
    monkeypatch.delenv("MANIAC_GGSPLIT")
    assert sysm.spec.gg_cut and not plain.spec.gg_cut

    # the gate must BITE (pairs beyond 8.8 A exist in a 24 A box) yet stay
    # under the parity bar
    e_s = float(sysm.state.energy[E_TOT])
    e_p = float(plain.state.energy[E_TOT])
    assert e_s != e_p, "cutoff excluded no pairs - vacuous fixture"
    assert abs(e_s - e_p) * KCAL_PER_K < 1e-6 * max(
        1.0, int(sysm.state.n_mol[0]))

    # identical uniforms -> same move sequence on both engines; per-move dE
    # must agree to the BASELINE parity bar, so decisions stay in lockstep
    keys = jax.random.split(jax.random.PRNGKey(9), 60)
    st_s, st_p = sysm.state, plain.state
    step_s = jax.jit(lambda st, k: mc_step(sysm.spec, st, k))
    step_p = jax.jit(lambda st, k: mc_step(plain.spec, st, k))
    for k in keys:
        e0_s, e0_p = float(st_s.energy[E_TOT]), float(st_p.energy[E_TOT])
        st_s, st_p = step_s(st_s, k), step_p(st_p, k)
        de_s = float(st_s.energy[E_TOT]) - e0_s
        de_p = float(st_p.energy[E_TOT]) - e0_p
        assert abs(de_s - de_p) * KCAL_PER_K < 1e-6
    assert int(st_s.n_mol[0]) == int(st_p.n_mol[0])
    np.testing.assert_array_equal(np.asarray(st_s.pos), np.asarray(st_p.pos))


def test_bookkeeping_matches_recompute_under_ggsplit(tmp_path):
    out = _fixture(tmp_path)
    sysm = _load(out, dtype=jnp.float64, capacity=32)
    spec, state = sysm.spec, sysm.state
    assert spec.gg_cut
    for _ in range(3):
        state = run_block(spec, state, 40, False)
        e, amp_re, amp_im = system_energy(spec, state)
        assert float(jnp.abs(state.energy[E_TOT] - e[E_TOT])) < 1e-7
        assert float(jnp.max(jnp.abs(state.amp_re - amp_re))) < 1e-7
