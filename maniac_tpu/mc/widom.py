"""Widom test-particle insertion: excess chemical potential diagnostic.

The reference has no Widom analog; this is an extension for
GCMC users (enable with ``--widom N``). Each trial evaluates the energy
of a GHOST insertion - the exact "new side" of the engine's unified
insertion move (mc/moves.py ``_core_xla``; reference insertion
energetics: src/create_molecule.f90:118-129 + src/monte_carlo_utils.f90:
184-226) - without ever touching the chain state, so the estimator is
consistent with the acceptance energetics to machine precision:

    dU = E_pair(ghost) + E_recip(A+dA) - E_recip(A) + E_self + E_intra

and the per-species Widom factor over n trials is

    B  = < exp(-dU / T) >            (1 for an ideal gas)
    mu_ex = -kB T ln B               (excess chemical potential)

Averaged over GCMC configurations this is the standard fluctuating-N
Widom estimator; it doubles as a Henry-regime adsorption probe
(K_H proportional to B at low loading). Runs on the plain XLA energy
path once per block per reported replica - a handful of
``pair_energy_footprint`` calls, outside the block program - and
draws its randomness from a ``fold_in`` of the replica key, so enabling
it never perturbs trajectories.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..physics.energy import (active_site_mask, amp_delta, intra_energy,
                              pair_energy_footprint, recip_energy_delta,
                              site_positions)
from ..system import SimState, SystemSpec
from .moves import _uniform_rotation


def widom_delta_u(spec: SystemSpec, state: SimState, u, t_ins):
    """dU (Kelvin) of one ghost insertion of residue type ``t_ins``.

    u: (6,) uniforms - u[0:3] fractional COM coordinates, u[3:6] the
    uniform-rotation draw. The trial geometry is the static rigid
    template with a uniform random orientation, matching the engine's
    templated insertion move (DIVERGENCES.md #4); reservoir systems use
    the same template here (the reservoir holds copies of it).
    """
    fdt = spec.dtype
    A_act = spec.A_act
    Rm = _uniform_rotation(u[3:6], fdt)
    off = spec.type_template_off[t_ins] @ Rm.T            # (A_act, 3)
    com = spec.bounds[:, 0] + spec.H @ u[0:3]
    P = (com + off)[None]                                 # (1, A_act, 3)
    mask = (jnp.arange(A_act) < spec.type_A[t_ins])[None]
    q = spec.type_q_rows[t_ins][None]
    cls = spec.type_cls_rows[t_ins][None]
    # sentinel Mtot+1 excludes no molecule: unlike a real insertion the
    # ghost never occupies a slot, so every live molecule interacts
    no_mol = jnp.int32(spec.Mtot + 1)
    e_lj, e_coul = pair_energy_footprint(
        spec, site_positions(spec, state),
        active_site_mask(spec, state.n_mol), P, q, cls, mask,
        no_mol, no_mol)
    d_re, d_im = amp_delta(spec, P, q, mask, jnp.ones((1,), fdt))
    e_recip_d = recip_energy_delta(spec, state.amp_re, state.amp_im,
                                   d_re, d_im)
    return (e_lj[0] + e_coul[0] + e_recip_d
            + spec.type_self_energy[t_ins]
            + intra_energy(spec, P[0], q[0], mask[0]))


@partial(jax.jit, static_argnums=(2,))
def widom_block(spec: SystemSpec, state: SimState, n_trials: int, key):
    """Per-active-species LOG Widom factor ln< exp(-dU/T) > over n_trials
    ghost insertions of one configuration. Returns (n_active,).

    Computed max-shifted (logsumexp) so a single deeply-attractive trial
    - exp(-dU/T) overflows f32 once -dU/T > 88, which a not-yet-
    equilibrated dense liquid can produce - degrades the estimate instead
    of poisoning the whole average with inf. Hosts convert to B in f64
    (np.exp overflows only past ln B = 709)."""
    u = jax.random.uniform(key, (n_trials, spec.n_active, 6),
                           dtype=spec.dtype)

    def one(u1, i):
        du = widom_delta_u(spec, state, u1, spec.active_type_ids[i])
        return -du / spec.temp_K

    idx = jnp.arange(spec.n_active)
    x = jax.vmap(lambda urow: jax.vmap(one)(urow, idx))(u)  # (n, n_active)
    m = jnp.max(x, axis=0)
    return m + jnp.log(jnp.mean(jnp.exp(x - m[None, :]), axis=0))


def widom_factor(log_B):
    """Widom factor B from widom_block's log estimate (host-side, f64)."""
    import numpy as np
    return np.exp(np.asarray(log_B, dtype=np.float64))


def mu_excess_K(B_mean, temp_K):
    """mu_ex in Kelvin from a Widom factor (host-side; inf if B == 0)."""
    import numpy as np
    B_mean = np.asarray(B_mean, dtype=np.float64)
    with np.errstate(divide="ignore"):
        return -float(temp_K) * np.log(B_mean)
