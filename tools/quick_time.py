#!/usr/bin/env python
"""Quick timing of the block program and the replicated resync at bench
scale on the default device.

    PROF_SYSTEM=zif PROF_B=1024 PROF_STEPS=50 python tools/quick_time.py

Every printed number carries the device and card it was measured on; on
a CPU the numbers time XLA's CPU backend, not a device.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax


def timeit(fn, *args, n=5, warmup=1):
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def main():
    import jax.numpy as jnp

    import bench
    from maniac_tpu.mc.driver import resync_amplitudes_replicated
    from maniac_tpu.parallel.replicas import replicate, run_block_replicated
    from maniac_tpu.utils.compile_cache import enable_compile_cache
    from maniac_tpu.utils.devinfo import device_label

    B = int(os.environ.get("PROF_B", "1024"))
    NS = int(os.environ.get("PROF_STEPS", "50"))
    system = os.environ.get("PROF_SYSTEM", "zif")
    enable_compile_cache()
    sysm = bench.load_regime(system, jnp.float32)
    spec = sysm.spec
    states = jax.device_put(replicate(spec, sysm.state, B))
    dev = device_label()
    print(f"# system={system} B={B} S={spec.S} K={spec.K} "
          f"kmax={spec.kmax_xyz} device={dev}")

    t = timeit(lambda s: run_block_replicated(spec, s, NS, False), states)
    print(f"scan{NS}: {t / NS * 1e3:8.3f} ms/step  "
          f"({B * NS / t / 1e6:.3f} M steps/s) on {dev}")

    t = timeit(lambda s: resync_amplitudes_replicated(spec, s), states, n=3)
    print(f"resync:  {t * 1e3:8.3f} ms/block on {dev}")


if __name__ == "__main__":
    main()
