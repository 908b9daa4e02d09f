"""Static-framework split (physics/fwsplit.py): accuracy and consistency.

The split rewrites ONLY the guest<->framework real-space Coulomb term as a
short-ranged erfc(alpha2) pass plus a precomputed far-field grid. These
tests pin:
  * the far-field grid against a direct brute-force D(r) evaluation,
  * per-move dE of the split engine vs the plain (reference-semantics)
    engine at the <=1e-6 kcal/mol BASELINE bar,
  * the bookkeeping==recompute invariant under the split.
"""

import jax
import jax.numpy as jnp
import numpy as np
from scipy.special import erfc as serfc

from maniac_tpu import load_system
from maniac_tpu.constants import COULOMB_K
from maniac_tpu.mc.driver import run_block
from maniac_tpu.mc.moves import mc_step
from maniac_tpu.physics.energy import fw_far_energy, system_energy
from maniac_tpu.system import E_TOT
from maniac_tpu.systems import make_zif_like

KCAL_PER_K = 1.0 / 503.2189


def _load(outdir, **kw):
    return load_system(f"{outdir}/input.maniac", f"{outdir}/topology.data",
                       f"{outdir}/parameters.inc", **kw)


def _fixture(tmp_path, **kw):
    make_zif_like(str(tmp_path), n_cells=4, a=5.66, n_water=10,
                  fugacity=50.0, cutoff=6.0, **kw)
    return str(tmp_path)


def test_eligibility_and_layout(tmp_path):
    out = _fixture(tmp_path)
    sysm = _load(out, dtype=jnp.float64, capacity=16)
    spec = sysm.spec
    assert spec.fw_split
    assert spec.guest_base % 128 == 0
    assert spec.S_frozen <= spec.guest_base
    # frozen prefix really is frozen: no active type's sites precede it
    st = np.asarray(spec.site_type[:spec.S_frozen])
    assert not np.any(np.asarray(spec.type_active)[st[st < spec.R]])


def test_far_field_grid_vs_direct(tmp_path):
    out = _fixture(tmp_path)
    sysm = _load(out, dtype=jnp.float64, capacity=16)
    spec, state = sysm.spec, sysm.state
    fq = np.asarray(spec.site_q)[: spec.S_frozen]
    fpos = np.asarray(state.pos).T[: spec.S_frozen]
    a, a2 = float(spec.alpha), float(spec.alpha2)
    L = np.asarray(spec.box_diag)
    rng = np.random.default_rng(3)
    for p in rng.uniform(-10, 10, (6, 3)):
        d = fpos - p
        d -= L * np.round(d / L)
        r = np.linalg.norm(d, axis=1)
        d_direct = float(np.sum(fq * (serfc(a * r) - serfc(a2 * r)) / r)
                         * COULOMB_K)
        d_grid = float(fw_far_energy(spec, jnp.asarray(p)[None, :],
                                     jnp.ones(1)))
        assert abs(d_direct - d_grid) * KCAL_PER_K < 1e-6


def test_split_vs_plain_total_and_per_move(tmp_path, monkeypatch):
    out = _fixture(tmp_path)
    sysm = _load(out, dtype=jnp.float64, capacity=16)
    monkeypatch.setenv("MANIAC_FWSPLIT", "0")
    plain = _load(out, dtype=jnp.float64, capacity=16)
    monkeypatch.delenv("MANIAC_FWSPLIT")
    assert sysm.spec.fw_split and not plain.spec.fw_split

    e_s = float(sysm.state.energy[E_TOT])
    e_p = float(plain.state.energy[E_TOT])
    assert abs(e_s - e_p) * KCAL_PER_K < 1e-6 * max(
        1.0, np.asarray(sysm.state.n_mol)[1])

    # identical uniforms -> same move sequence on both engines; per-move
    # dE (energy deltas of the running totals) must agree to the BASELINE
    # parity bar. With dE agreement at ~1e-7 kcal/mol the accept decisions
    # match, so populations and positions stay in lockstep.
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
    assert int(st_s.n_mol[1]) == int(st_p.n_mol[1])
    np.testing.assert_array_equal(np.asarray(st_s.pos), np.asarray(st_p.pos))


def test_bookkeeping_matches_recompute_under_split(tmp_path):
    out = _fixture(tmp_path)
    sysm = _load(out, dtype=jnp.float64, capacity=16)
    spec, state = sysm.spec, sysm.state
    assert spec.fw_split
    for i in range(4):
        state = run_block(spec, state, 40, False)
        e, amp_re, amp_im = system_energy(spec, state)
        assert float(jnp.abs(state.energy[E_TOT] - e[E_TOT])) < 1e-7
        assert float(jnp.max(jnp.abs(state.amp_re - amp_re))) < 1e-7


def test_two_active_species_with_framework(tmp_path, monkeypatch):
    """Framework + water + dimer: exercises the split with n_active=2 -
    swap moves and guest site ranges with a dead gap between the two type
    blocks. Pins split-vs-plain per-move dE (f64)."""
    from maniac_tpu.systems import make_framework_mixed
    make_framework_mixed(str(tmp_path))
    out = str(tmp_path)

    sysm = _load(out, dtype=jnp.float64, capacity=12)
    monkeypatch.setenv("MANIAC_FWSPLIT", "0")
    plain = _load(out, dtype=jnp.float64, capacity=12)
    monkeypatch.delenv("MANIAC_FWSPLIT")
    assert sysm.spec.fw_split and sysm.spec.n_active == 2
    keys = jax.random.split(jax.random.PRNGKey(3), 36)
    st_s, st_p = sysm.state, plain.state
    step_s = jax.jit(lambda st, k: mc_step(sysm.spec, st, k))
    step_p = jax.jit(lambda st, k: mc_step(plain.spec, st, k))
    for k in keys:
        e0_s, e0_p = float(st_s.energy[E_TOT]), float(st_p.energy[E_TOT])
        st_s, st_p = step_s(st_s, k), step_p(st_p, k)
        de_s = float(st_s.energy[E_TOT]) - e0_s
        de_p = float(st_p.energy[E_TOT]) - e0_p
        assert abs(de_s - de_p) * KCAL_PER_K < 1e-6
    np.testing.assert_array_equal(np.asarray(st_s.pos), np.asarray(st_p.pos))


def test_two_frozen_types_slit_pore(tmp_path, monkeypatch):
    """TWO inactive residue types (slit-pore walls): the frozen prefix must
    end at the aligned end of the LAST frozen region, not at the raw frozen
    site count (ADVICE r1 high - the raw sum classified the second wall's
    sites as mobile while they also sat in the far-field grid, double
    counting them)."""
    from maniac_tpu.systems import make_slit_pore
    make_slit_pore(str(tmp_path))
    out = str(tmp_path)
    sysm = _load(out, dtype=jnp.float64, capacity=16)
    spec = sysm.spec
    assert spec.fw_split
    # wall regions: 50 sites each, 128-aligned -> frozen prefix ends at
    # 128 + 50, NOT at 100
    assert spec.site_base_list[1] == 128
    assert spec.S_frozen == 128 + 50
    assert spec.guest_base == 256
    # every live frozen site is inside the prefix; no active site is
    st = np.asarray(spec.site_type)
    live_frozen = np.where((st < spec.R)
                           & ~np.asarray(spec.type_active)[np.minimum(st, spec.R - 1)]
                           & (st < spec.R))[0]
    assert live_frozen.max() < spec.S_frozen
    act_sites = np.where((st < spec.R)
                         & np.asarray(spec.type_active)[np.minimum(st, spec.R - 1)])[0]
    assert act_sites.min() >= spec.guest_base

    # the real gate: split vs plain per-move dE parity (fails before the fix)
    monkeypatch.setenv("MANIAC_FWSPLIT", "0")
    plain = _load(out, dtype=jnp.float64, capacity=16)
    monkeypatch.delenv("MANIAC_FWSPLIT")
    assert not plain.spec.fw_split
    e_s = float(sysm.state.energy[E_TOT])
    e_p = float(plain.state.energy[E_TOT])
    assert abs(e_s - e_p) * KCAL_PER_K < 1e-5
    keys = jax.random.split(jax.random.PRNGKey(11), 30)
    st_s, st_p = sysm.state, plain.state
    step_s = jax.jit(lambda st, k: mc_step(sysm.spec, st, k))
    step_p = jax.jit(lambda st, k: mc_step(plain.spec, st, k))
    for k in keys:
        e0_s, e0_p = float(st_s.energy[E_TOT]), float(st_p.energy[E_TOT])
        st_s, st_p = step_s(st_s, k), step_p(st_p, k)
        de_s = float(st_s.energy[E_TOT]) - e0_s
        de_p = float(st_p.energy[E_TOT]) - e0_p
        assert abs(de_s - de_p) * KCAL_PER_K < 1e-6
    # bookkeeping == recompute under the split
    stt = run_block(sysm.spec, st_s, 30, False)
    e, amp_re, _ = system_energy(sysm.spec, stt)
    assert float(jnp.abs(stt.energy[E_TOT] - e[E_TOT])) < 1e-7


def test_number_conservation_physics(tmp_path):
    """<N> must be split-invariant: run the same chain with and without the
    split and compare mean occupancy loosely (they are not the same chain
    once f32/ordering noise decorrelates them, so this is a smoke check that
    the split engine equilibrates to a sane occupancy, not a strict test -
    the strict dE test above is the real gate)."""
    out = _fixture(tmp_path)
    sysm = _load(out, dtype=jnp.float64, capacity=24)
    spec, state = sysm.spec, sysm.state
    ns = []
    for _ in range(6):
        state = run_block(spec, state, 100, False)
        ns.append(int(state.n_mol[1]))
    assert 0 < np.mean(ns) < 24
