"""MC driver: on-device step scan, per-block recalibration, host-side loop.

The reference runs nb_block x nb_step with per-block step-size recalibration
and file output (reference: src/monte_carlo.f90:26-88 MonteCarloLoop,
src/monte_carlo_utils.f90:99-130 AdjustMoveStepSizes). Here one *block* is a
single jitted lax.scan over nb_step steps followed by an in-device
recalibration; the host loop only does I/O between blocks.

Recalibration divergence (intended-behavior fix, documented): the reference's
shrink condition `acc - 0.40 < 0.05` fires whenever the grow condition
doesn't (the tolerance band is dead code), and its rotation shrink branch
computes min(angle*1.95, MIN_ROTATION_ANGLE), pinning the angle to the
minimum (src/monte_carlo_utils.f90:108-127). We implement the symmetric rule
the constants clearly intend: grow 5% above target+tol, shrink 5% below
target-tol, clamped to [min,max].
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..constants import (MAX_ROTATION_ANGLE, MAX_TRANSLATION_STEP,
                         MIN_ROTATION_ANGLE, MIN_TRANSLATION_STEP,
                         MIN_TRIALS_FOR_RECALIBRATION, TARGET_ACCEPTANCE,
                         TOL_ACCEPTANCE, TYPE_ROTATION, TYPE_TRANSLATION)
from ..physics.energy import (active_site_mask, full_amplitudes,
                              recip_energy, site_positions, system_energy)
from ..system import E_RECIP, E_TOT, SimState, SystemSpec


def initialize_state(spec: SystemSpec, state: SimState) -> SimState:
    """Full energy + structure factors from scratch (startup; also used as
    the per-block drift audit / amplitude resync)."""
    e, amp_re, amp_im = system_energy(spec, state)
    return state.replace(amp_re=amp_re, amp_im=amp_im, energy=e)


def _recalibrate(state: SimState, recalibrate: bool, dtype) -> SimState:
    if not recalibrate:
        return state
    def adjust(step, trials, accepts, lo, hi):
        acc = accepts.astype(dtype) / jnp.maximum(trials, 1).astype(dtype)
        grown = jnp.minimum(step * 1.05, hi)
        shrunk = jnp.maximum(step * 0.95, lo)
        new = jnp.where(acc - TARGET_ACCEPTANCE > TOL_ACCEPTANCE, grown,
               jnp.where(acc - TARGET_ACCEPTANCE < -TOL_ACCEPTANCE, shrunk,
                         step))
        return jnp.where(trials > MIN_TRIALS_FOR_RECALIBRATION, new, step)

    trans = adjust(state.trans_step,
                   state.counters[0, TYPE_TRANSLATION],
                   state.counters[1, TYPE_TRANSLATION],
                   MIN_TRANSLATION_STEP, MAX_TRANSLATION_STEP)
    rot = adjust(state.rot_step,
                 state.counters[0, TYPE_ROTATION],
                 state.counters[1, TYPE_ROTATION],
                 MIN_ROTATION_ANGLE, MAX_ROTATION_ANGLE)
    return state.replace(trans_step=trans, rot_step=rot)


def run_steps(spec: SystemSpec, state: SimState, n_steps: int) -> SimState:
    """lax.scan over n_steps MC steps; the whole chain stays on device.

    All uniforms for the block come from ONE threefry invocation instead
    of one key split per step."""
    from .moves import N_UNIFORMS, mc_step_u
    key, sub = jax.random.split(state.key)
    uniforms = jax.random.uniform(sub, (n_steps, N_UNIFORMS),
                                  dtype=spec.dtype)
    state = state.replace(key=key)

    def body(st, u):
        return mc_step_u(spec, st, u), None

    state, _ = jax.lax.scan(body, state, uniforms)
    return state


def block_body(spec: SystemSpec, state: SimState, n_steps: int,
               recalibrate: bool) -> SimState:
    """One block: n_steps MC steps + step-size recalibration. Unjitted body,
    shared by the single-chain and vmapped-replica paths."""
    state = run_steps(spec, state, n_steps)
    return _recalibrate(state, recalibrate, spec.dtype)


@partial(jax.jit, static_argnums=(2, 3))
def run_block(spec: SystemSpec, state: SimState, n_steps: int,
              recalibrate: bool) -> SimState:
    return block_body(spec, state, n_steps, recalibrate)


@partial(jax.jit, static_argnums=(2,))
def resync(spec: SystemSpec, state: SimState, full: bool = True) -> SimState:
    """Recompute structure factors (and the full energy) from positions."""
    return initialize_state(spec, state)


def resync_amplitudes_body(spec: SystemSpec, state: SimState) -> SimState:
    """Re-synthesize structure factors (and E_RECIP) from positions, leaving
    the other energy components running. This is the per-block float32 drift
    bound: the incremental A(k) updates accumulate rounding forever
    (reference mutates them unbounded, src/ewald_energy.f90:241-256), so f32
    runs resynthesize at block granularity (DIVERGENCES.md #13)."""
    pos = site_positions(spec, state)
    active = active_site_mask(spec, state.n_mol)
    amp_re, amp_im = full_amplitudes(spec, pos, active)
    e_recip = recip_energy(spec, amp_re, amp_im)
    e = state.energy
    e = e.at[E_TOT].add(e_recip - e[E_RECIP])
    e = e.at[E_RECIP].set(e_recip)
    return state.replace(amp_re=amp_re, amp_im=amp_im, energy=e)


@jax.jit
def resync_amplitudes(spec: SystemSpec, state: SimState) -> SimState:
    return resync_amplitudes_body(spec, state)


@jax.jit
def refresh_reported_energy(spec: SystemSpec, states: SimState) -> SimState:
    """Exact energy components for the REPORTED replica (row 0 of a
    batched state): the reference's energy.dat is a fresh value every
    block (src/write_utils.f90:94-188), while f32 running totals wander
    by O(100 K) (DIVERGENCES.md #13). One from-scratch recompute for ONE
    replica per block replaces row 0's energy AND its amplitudes (so the
    bookkeeping invariant E_RECIP == recip_energy(amp) keeps holding for
    that replica). The chain itself never reads the non-recip components,
    so the trajectory is unperturbed."""
    st0 = jax.tree_util.tree_map(lambda x: x[0], states)
    st0 = initialize_state(spec, st0)
    return states.replace(
        energy=states.energy.at[0].set(st0.energy),
        amp_re=states.amp_re.at[0].set(st0.amp_re),
        amp_im=states.amp_im.at[0].set(st0.amp_im))


def resync_replicated_body(spec: SystemSpec, states: SimState) -> SimState:
    """Trace-time body of the replicated resync (shared by the standalone
    jit below and run_block_replicated's fused tail): the per-replica
    resynthesis vmapped over the batch. Its temporaries grow with the
    batch; chip_smoke.py's compile phase prints them per regime."""
    return jax.vmap(lambda s: resync_amplitudes_body(spec, s))(states)


@jax.jit
def resync_amplitudes_replicated(spec: SystemSpec,
                                 states: SimState) -> SimState:
    return resync_replicated_body(spec, states)


def drift_report(spec: SystemSpec, state: SimState) -> dict:
    """Audit: running energy/amplitudes vs full recompute (host-side)."""
    e, amp_re, amp_im = system_energy(spec, state)
    return {
        "e_total_running": float(state.energy[E_TOT]),
        "e_total_fresh": float(e[E_TOT]),
        "drift_K": float(abs(state.energy[E_TOT] - e[E_TOT])),
        "amp_drift": float(jnp.max(jnp.abs(state.amp_re - amp_re)
                                   + jnp.abs(state.amp_im - amp_im))),
        "recip_running": float(state.energy[E_RECIP]),
        "recip_fresh": float(recip_energy(spec, amp_re, amp_im)),
    }
