#!/usr/bin/env python
"""Multi-host launcher: one process per host, replica axis sharded over
ALL devices of all hosts.

Independent Metropolis chains need no inter-chip communication, so the
multi-host design is the single-host design at a bigger mesh: every
process builds the same (spec, state) deterministically, the global
batched state is assembled shard-by-shard (each host wraps only the
replicas it owns - maniac_tpu.parallel.mesh.shard_replicas_global), and
the per-block program runs collective-free; the only cross-host traffic is the
per-block diagnostic reduction (cross-replica mean N / energy).

Run ON EACH HOST (one process per host, all of its GPUs):

    python tools/launch_multihost.py \
        --coordinator <host0-ip>:8476 --num-processes <H> --process-id <i> \
        -i input.maniac -d topology.data -p parameters.inc \
        [--replicas-per-device 64] [--blocks 10] [--steps 1000]

Single-process smoke test (8 virtual CPU devices, exercised by
tests/test_cli_and_parallel.py::test_multihost_launcher_smoke):

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tools/launch_multihost.py --num-processes 1 \
        -i ... -d ... -p ...
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (required if "
                         "--num-processes > 1)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("-i", dest="deck", required=True)
    ap.add_argument("-d", dest="data", required=True)
    ap.add_argument("-p", dest="params", required=True)
    ap.add_argument("-r", dest="reservoir", default=None)
    ap.add_argument("--replicas-per-device", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=10)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--capacity", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--platform", default=None,
                    help="force a jax platform (e.g. cpu)")
    args = ap.parse_args(argv)

    import jax

    from maniac_tpu.utils.compile_cache import enable_compile_cache

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    enable_compile_cache()
    if args.num_processes > 1:
        if not args.coordinator:
            ap.error("--coordinator is required for multi-process runs")
        jax.distributed.initialize(coordinator_address=args.coordinator,
                                   num_processes=args.num_processes,
                                   process_id=args.process_id)

    import jax.numpy as jnp

    from maniac_tpu import load_system
    from maniac_tpu.parallel.mesh import (gather_replica_stats, make_mesh,
                                          replicate_spec, run_block_sharded,
                                          shard_replicas_global)
    from maniac_tpu.parallel.replicas import replicate
    from maniac_tpu.system import E_TOT
    from maniac_tpu.utils.devinfo import device_label

    n_dev = len(jax.devices())
    B = args.replicas_per_device * n_dev
    lead = args.process_id == 0

    def say(msg):
        if lead:
            print(msg, flush=True)

    say(f"# {args.num_processes} process(es), {n_dev} global devices, "
        f"B={B} replicas")

    # identical on every process (deterministic from the input files)
    sysm = load_system(args.deck, args.data, args.params,
                       reservoir_file=args.reservoir, dtype=jnp.float32,
                       capacity=args.capacity, seed=args.seed)
    spec, state = sysm.spec, sysm.state

    mesh = make_mesh()  # all global devices
    states = shard_replicas_global(mesh, replicate(spec, state, B))
    spec_r = replicate_spec(mesh, spec)

    t0 = time.perf_counter()
    for b in range(1, args.blocks + 1):
        states = run_block_sharded(mesh, spec_r, states, args.steps, True)
        mean_n, std_n, mean_e, std_e = gather_replica_stats(
            states, spec.R, E_TOT)
        # jnp.mean over the sharded axis -> one all-reduce (the only
        # cross-host traffic); transfer 2R+2 scalars to host 0
        say(f"block {b:4d}: <N>={[f'{float(v):.3f}' for v in mean_n]} "
            f"+- {[f'{float(v):.3f}' for v in std_n]}  "
            f"<E>={float(mean_e):.2f} K +- {float(std_e):.2f}")
    dt = time.perf_counter() - t0
    say(f"# {args.blocks * args.steps * B / dt / 1e6:.3f} M aggregate "
        f"steps/s over {dt:.1f} s on {device_label()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
