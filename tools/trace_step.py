#!/usr/bin/env python
"""Capture a jax.profiler trace of one flagship block and print the top
device operations by total time, with the device busy share of the
window (maniac_tpu/utils/devtrace.py reduces the trace).

    PROF_B=1024 PROF_STEPS=50 python tools/trace_step.py [outdir]

The trace stays in outdir (default chiprun_out/trace_step) for a viewer.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax


def main():
    import jax.numpy as jnp

    import bench
    from maniac_tpu.parallel.replicas import replicate, run_block_replicated
    from maniac_tpu.utils.compile_cache import enable_compile_cache
    from maniac_tpu.utils.devinfo import device_label
    from maniac_tpu.utils.devtrace import device_summary

    B = int(os.environ.get("PROF_B", "1024"))
    NS = int(os.environ.get("PROF_STEPS", "50"))
    outdir = (sys.argv[1] if len(sys.argv) > 1 else
              os.path.join(os.path.dirname(os.path.dirname(
                  os.path.abspath(__file__))), "chiprun_out", "trace_step"))
    enable_compile_cache()
    sysm = bench.load_regime("zif", jnp.float32)
    spec = sysm.spec
    states = jax.device_put(replicate(spec, sysm.state, B))

    def run(st):
        return jax.block_until_ready(
            run_block_replicated(spec, st, NS, False, True))

    states = run(states)  # compile
    with jax.profiler.trace(outdir):
        states = run(states)

    summ = device_summary(outdir, top=40)
    print(f"# device={device_label()} B={B} steps={NS} trace={outdir}")
    print(f"# window {summ['window_ms']:.3f} ms, device busy "
          f"{summ['busy_ms']:.3f} ms ({summ['busy_share']:.3f})")
    for name, ms, n in summ["top"]:
        print(f"{ms:10.3f} ms  x{n:<6d} {name[:110]}")


if __name__ == "__main__":
    main()
