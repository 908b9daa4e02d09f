"""The replicated block program against the single-chain program, over
every execution regime the engine serves.

run_block_replicated vmaps block_body over the replica axis; run_block
runs one chain. With the same keys both must take the same decisions,
and the bookkeeping must equal a from-scratch recompute (f64). The f32
per-block resynthesis, vmapped over the replicas, must reproduce the
per-replica resynthesis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from maniac_tpu import load_system
from maniac_tpu.mc.driver import (drift_report, resync_amplitudes,
                                  resync_amplitudes_replicated, run_block)
from maniac_tpu.physics.energy import recip_energy
from maniac_tpu.parallel.replicas import replicate, run_block_replicated
from maniac_tpu.system import E_RECIP, E_TOT
from maniac_tpu import systems

B = 4


def _fw_split(d):
    systems.make_zif_like(d, n_cells=4, a=5.66, n_water=10, fugacity=50.0,
                          cutoff=6.0)
    return 16, None


def _pure_water(d):
    systems.make_water_box(d, n_water=8, L=14.0, cutoff=5.0, tol=1e-4,
                           probs=(0.3, 0.2, 0.5, 0.0), fugacity=20000.0)
    return 16, None


def _triclinic(d):
    systems.make_triclinic_water(d, n_water=8, L=14.0, tilt=(2.0, 1.2, 0.8),
                                 cutoff=5.0, tol=1e-4,
                                 probs=(0.3, 0.2, 0.5, 0.0),
                                 fugacity=20000.0)
    return 16, None


def _two_species_swap(d):
    systems.make_framework_mixed(d)
    return 12, None


def _reservoir(d):
    systems.make_water_box(d, n_water=8, L=14.0, cutoff=5.0, tol=1e-4,
                           probs=(0.3, 0.2, 0.5, 0.0), fugacity=20000.0)
    return 16, systems.make_water_reservoir(d, n_water=12)


def _guest_split(d):
    systems.make_water_box(d, n_water=24, L=24.0, cutoff=8.0,
                           ewald_alpha=0.5, fugacity=40000.0,
                           probs=(0.3, 0.2, 0.5, 0.0))
    return 32, None


def _capacity_overflow(d):
    systems.make_water_box(d, n_water=8, L=14.0, cutoff=5.0, tol=1e-4,
                           probs=(0.1, 0.0, 0.9, 0.0), fugacity=5e5)
    return 10, None


def _chunk_boundary(d):
    # populations around N = 31..33 straddle a 128-site column boundary
    systems.make_water_box(d, n_water=31, L=22.0, cutoff=7.0, tol=1e-4,
                           probs=(0.2, 0.1, 0.7, 0.0), fugacity=30000.0)
    return 40, None


def _mixed_sizes(d):
    systems.make_mixed_sizes(d, n_water=6, n_dimer=6, L=16.0, cutoff=6.0,
                             tol=1e-4, probs=(0.2, 0.1, 0.3, 0.4),
                             fug_w=500.0, fug_d=500.0)
    return None, None


REGIMES = {
    "framework_split": (_fw_split, lambda s: s.fw_split and s.n_active == 1),
    "pure_water": (_pure_water, lambda s: not s.fw_split and s.R == 1),
    "triclinic": (_triclinic, lambda s: s.is_triclinic),
    "two_species_swap": (_two_species_swap,
                         lambda s: s.fw_split and s.n_active == 2),
    "reservoir": (_reservoir, lambda s: s.has_reservoir),
    "guest_split": (_guest_split, lambda s: s.gg_cut and not s.fw_split),
    "capacity_overflow": (_capacity_overflow, lambda s: s.cap_list[0] == 10),
    "chunk_boundary": (_chunk_boundary,
                       lambda s: s.cap_list[-1] * s.A_list[-1] > 128),
    "mixed_sizes": (_mixed_sizes,
                    lambda s: len(set(s.A_list)) > 1 and s.n_active == 2),
}


def _load(tmp_path, regime, dtype):
    build, check = REGIMES[regime]
    d = str(tmp_path)
    capacity, res = build(d)
    sysm = load_system(f"{d}/input.maniac", f"{d}/topology.data",
                       f"{d}/parameters.inc", reservoir_file=res,
                       capacity=capacity, dtype=dtype)
    assert check(sysm.spec), regime
    return sysm


def _row(states, b):
    return jax.tree_util.tree_map(lambda x: x[b], states)


@pytest.mark.parametrize("regime", list(REGIMES))
def test_replicated_block_matches_single_chain(tmp_path, regime):
    sysm = _load(tmp_path, regime, jnp.float64)
    spec = sysm.spec
    states = replicate(spec, sysm.state, B)
    out = run_block_replicated(spec, states, 40, False)
    for b in range(B):
        one = run_block(spec, _row(states, b), 40, False)
        got = _row(out, b)
        np.testing.assert_array_equal(np.asarray(got.n_mol),
                                      np.asarray(one.n_mol))
        np.testing.assert_array_equal(np.asarray(got.counters),
                                      np.asarray(one.counters))
        np.testing.assert_array_equal(np.asarray(got.extras),
                                      np.asarray(one.extras))
        np.testing.assert_allclose(np.asarray(got.pos), np.asarray(one.pos),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(np.asarray(got.energy),
                                   np.asarray(one.energy), rtol=1e-10,
                                   atol=1e-7)
        assert drift_report(spec, got)["drift_K"] < 1e-6
    assert np.asarray(out.counters)[:, 0].sum() > 0
    if regime == "capacity_overflow":
        assert np.all(np.asarray(out.n_mol)[:, 0] <= 10)
        assert np.asarray(out.extras)[:, 0].sum() > 0


@pytest.mark.parametrize("regime", list(REGIMES))
def test_replicated_resync_matches_per_replica(tmp_path, regime):
    """The f32 replicated resynthesis (the vmapped body run_block_replicated
    fuses into its tail) reproduces resync_amplitudes run on each replica
    alone, keeps positions and the non-reciprocal running energy, and
    leaves E_RECIP equal to recip_energy of the new amplitudes."""
    sysm = _load(tmp_path, regime, jnp.float32)
    spec = sysm.spec
    states = run_block_replicated(spec, replicate(spec, sysm.state, B), 20,
                                  False)
    out = resync_amplitudes_replicated(spec, states)
    scale = float(np.abs(np.asarray(out.amp_re)).max()) + 1.0
    for b in range(B):
        before = _row(states, b)
        one = resync_amplitudes(spec, before)
        got = _row(out, b)
        for leaf in ("amp_re", "amp_im"):
            np.testing.assert_allclose(np.asarray(getattr(got, leaf)),
                                       np.asarray(getattr(one, leaf)),
                                       rtol=0, atol=1e-5 * scale)
        e_got = float(got.energy[E_RECIP])
        e_one = float(one.energy[E_RECIP])
        assert abs(e_got - e_one) <= 1e-4 * max(1.0, abs(e_one))
        e_amp = float(recip_energy(spec, got.amp_re, got.amp_im))
        assert abs(e_got - e_amp) <= 1e-4 * max(1.0, abs(e_amp))
        rest_got = float(got.energy[E_TOT] - got.energy[E_RECIP])
        rest_before = float(before.energy[E_TOT] - before.energy[E_RECIP])
        assert abs(rest_got - rest_before) <= 1e-4 * max(1.0,
                                                         abs(rest_before))
        np.testing.assert_array_equal(np.asarray(got.pos),
                                      np.asarray(before.pos))
        np.testing.assert_array_equal(np.asarray(got.n_mol),
                                      np.asarray(before.n_mol))
