"""Batched replica chains: vmap within a chip, sharding across chips.

The Metropolis chain is inherently sequential, so device throughput comes from
running many independent replicas (and/or chemical-potential state points)
in parallel: the batched unified move step keeps every replica on the same
program regardless of which move type each replica drew (see
maniac_tpu.mc.moves). The reference is a single serial chain
(SURVEY.md section 2.18); replicas are this rebuild's parallelism model.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..mc.driver import block_body, initialize_state
from ..system import SimState, SystemSpec


def replicate(spec: SystemSpec, state: SimState, n_replicas: int,
              base_seed: int | None = None) -> SimState:
    """Broadcast one initialized state into n_replicas independent chains
    with decorrelated PRNG keys.

    Runs host-side (numpy): broadcasting is a pure layout op, and the
    numpy leaves let the first block dispatch (or an explicit device_put /
    sharding) move the whole batch to the device in one transfer. Key
    streams are threefry and backend-independent."""
    import numpy as np

    key0 = state.key if base_seed is None else jax.random.PRNGKey(base_seed)
    keys = np.asarray(jax.random.split(key0, n_replicas))
    batched = jax.tree_util.tree_map(
        lambda x: np.broadcast_to(np.asarray(x),
                                  (n_replicas,) + np.shape(x)), state)
    return batched.replace(key=keys)


def perturb_activity(spec: SystemSpec, activities) -> SystemSpec:
    """Per-replica chemical potentials for isotherm sweeps: returns a spec
    whose type_activity has a leading replica axis (used with vmapped specs).
    activities: (n_replicas, R)."""
    import dataclasses
    return dataclasses.replace(spec, type_activity=jnp.asarray(
        activities, dtype=spec.dtype))


@partial(jax.jit, static_argnums=(2, 3, 4))
def run_block_replicated(spec: SystemSpec, states: SimState, n_steps: int,
                         recalibrate: bool, resync: bool = False) -> SimState:
    """One block over all replicas. All replicas advance in lockstep in one
    fused program; with sharded inputs XLA partitions the batch across the
    mesh with zero collectives (chains are independent). resync=True
    appends the per-block amplitude resynthesis to the same program."""
    from ..mc.driver import resync_replicated_body
    out = jax.vmap(
        lambda st: block_body(spec, st, n_steps, recalibrate))(states)
    if resync:
        out = resync_replicated_body(spec, out)
    return out


@partial(jax.jit, static_argnums=(2, 3, 4))
def run_block_sweep(spec: SystemSpec, states: SimState, n_steps: int,
                    recalibrate: bool, resync: bool = False) -> SimState:
    """Like run_block_replicated but with a per-replica activity axis on the
    spec (chemical-potential sweep: one isotherm in one program);
    resync=True appends the per-block f32 amplitude resynthesis like
    run_block_replicated."""
    from ..mc.driver import resync_replicated_body
    out = jax.vmap(
        lambda act, st: block_body(
            _with_activity(spec, act), st, n_steps, recalibrate),
        in_axes=(0, 0))(spec.type_activity, states)
    if resync:
        out = resync_replicated_body(
            _with_activity(spec, spec.type_activity[0]), out)
    return out


def _with_activity(spec: SystemSpec, act) -> SystemSpec:
    import dataclasses
    return dataclasses.replace(spec, type_activity=act)


def initialize_replicated(spec: SystemSpec, states: SimState) -> SimState:
    return jax.vmap(lambda st: initialize_state(spec, st))(states)
