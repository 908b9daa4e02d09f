"""Multi-chip scaling: replica sharding over a device mesh.

Independent Metropolis chains need NO inter-chip communication during the
scan; the only collectives are diagnostic reductions (isotherm averages).
So the multi-chip design is: shard the replica axis of the batched SimState
over the mesh ('dp'), jit the same vmapped block, and let XLA partition -
the per-replica program is identical, so the partitioned program runs with
zero inter-device traffic in steady state. Cross-replica observables use
jnp means (lowered to all-reduces over the mesh).

The reference has no parallelism of any kind (SURVEY.md section 2.18); this
module is the analog mandated there.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..system import SimState, SystemSpec
from .replicas import run_block_replicated


def make_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    """A 1-D replica mesh over the first n_devices devices (the chains
    are independent, so the mesh follows the replica axis alone)."""
    devices = np.asarray(jax.devices())
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, (axis,))


def shard_replicas(mesh: Mesh, states: SimState, axis: str = "dp") -> SimState:
    """Place the batched state with the replica axis sharded over the mesh.
    Leaves are sharded on dim 0; everything else replicated."""
    def put(x):
        spec = P(axis, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))
    return jax.tree_util.tree_map(put, states)


def replicate_spec(mesh: Mesh, spec: SystemSpec) -> SystemSpec:
    """Replicate all static tables across the mesh (weights-style layout)."""
    import dataclasses
    sharding = NamedSharding(mesh, P())

    def put(x):
        return jax.device_put(x, sharding)

    data = {f: put(getattr(spec, f)) for f in _data_fields(spec)}
    return dataclasses.replace(spec, **data)


def _data_fields(spec) -> list:
    import dataclasses
    out = []
    for f in dataclasses.fields(spec):
        v = getattr(spec, f.name)
        if isinstance(v, jax.Array):
            out.append(f.name)
    return out


def run_block_sharded(mesh: Mesh, spec: SystemSpec, states: SimState,
                      n_steps: int, recalibrate: bool,
                      resync: bool = False) -> SimState:
    """One block over mesh-sharded replicas. The vmapped program's batch axis
    is already sharded via the input placement; jit propagates it. resync
    fuses the per-block amplitude resynthesis into the same program (still
    collective-free: replicas are independent)."""
    with mesh:
        return run_block_replicated(spec, states, n_steps, recalibrate,
                                    resync)


def gather_mean_population(states: SimState, R: int) -> jnp.ndarray:
    """Cross-replica mean occupancy per residue type; an all-reduce over the
    mesh when states are sharded."""
    return jnp.mean(states.n_mol[:, :R].astype(jnp.float32), axis=0)


@partial(jax.jit, static_argnums=(1, 2))
def gather_replica_stats(states: SimState, R: int, e_tot: int):
    """Per-block cross-replica observables, reduced ON DEVICE so only
    2R+2 scalars cross the host link per block: mean and std of N per
    residue type, and mean/std of the running total energy.

    The per-block cross-replica <N> series is THE adsorption observable
    (reference writes a single-chain series, src/write_utils.f90:94-188;
    with B independent replicas the cross-replica mean converges B times
    faster). Under a sharded batch axis the means lower to mesh
    all-reduces. The energy columns use the RUNNING totals (f32 drift
    envelope: DIVERGENCES.md #13) - replica 0's exact refresh covers
    energy.dat, not this diagnostic."""
    acc = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    n = states.n_mol[:, :R].astype(acc)
    mean_n = jnp.mean(n, axis=0)
    std_n = jnp.std(n, axis=0)
    e = states.energy[:, e_tot].astype(acc)
    return mean_n, std_n, jnp.mean(e), jnp.std(e)


def shard_replicas_global(mesh: Mesh, states: SimState,
                          axis: str = "dp") -> SimState:
    """Multi-host variant of shard_replicas: build the GLOBAL batched state
    from per-process host data. Every process calls replicate() with the
    same (spec, state, B) - the result is deterministic - and each wraps
    only its addressable shards via jax.make_array_from_callback, so no
    host ever materializes device memory it does not own and no cross-host
    transfer happens at startup. On a single process this degenerates to
    shard_replicas semantics (fully-addressable sharding)."""
    def put(x):
        spec = P(axis, *([None] * (x.ndim - 1)))
        sharding = NamedSharding(mesh, spec)
        host = np.asarray(x)
        return jax.make_array_from_callback(host.shape, sharding,
                                            lambda idx, h=host: h[idx])
    return jax.tree_util.tree_map(put, states)
