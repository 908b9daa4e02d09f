#!/usr/bin/env python
"""Dump the compiled HLO of the flagship block program and grep it.

    PROF_B=1024 HLO_GREP='fusion|while' python tools/dump_hlo.py [out.txt]

The HLO is what XLA compiled for the default device, which the first
line names.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax.numpy as jnp

    import bench
    from maniac_tpu.parallel.replicas import replicate, run_block_replicated
    from maniac_tpu.utils.devinfo import device_label

    B = int(os.environ.get("PROF_B", "1024"))
    NS = 50
    out = sys.argv[1] if len(sys.argv) > 1 else "step_hlo.txt"
    sysm = bench.load_regime("zif", jnp.float32)
    spec = sysm.spec
    states = replicate(spec, sysm.state, B)
    txt = run_block_replicated.lower(spec, states, NS, False,
                                     True).compile().as_text()
    with open(out, "w") as f:
        f.write(txt)
    print(f"# device={device_label()} B={B} steps={NS} -> {out}")
    pats = os.environ.get("HLO_GREP", "custom-call|all-reduce").split("|")
    for line in txt.splitlines():
        if any(p in line for p in pats):
            print(line.strip()[:400])


if __name__ == "__main__":
    main()
