#!/usr/bin/env python
"""Hardware matmul-precision probe + rigid-geometry drift check (CLI).

The probe logic lives in maniac_tpu/utils/hwprobe.py (its module
docstring documents the failure modes and stages); chip_smoke.py runs
the same stages on the card. This CLI is the standalone entry point.

Usage: python tools/precision_probe.py [--blocks 8]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=8)
    args = ap.parse_args()

    from maniac_tpu.utils.compile_cache import enable_compile_cache
    from maniac_tpu.utils.devinfo import device_label
    from maniac_tpu.utils.hwprobe import (RIGID_TOL, probe_onehot_exact,
                                          probe_rigid_geometry)

    enable_compile_cache()
    print(f"# device: {device_label()}")
    ok1, e1 = probe_onehot_exact()
    print(f"stage 1: one-hot read error {e1:.3e} (must be 0):",
          "PASS" if ok1 else
          "FAIL (reduced-precision matmul live - is "
          "jax_default_matmul_precision set?)")
    ok2, d2 = probe_rigid_geometry(args.blocks)
    print(f"stage 2: {args.blocks}x2000 NVT blocks, max |d(O-H)| = "
          f"{d2:.3e} A (< {RIGID_TOL:g}):",
          "PASS" if ok2 else "FAIL (rigid geometry deforming)")
    ok = ok1 and ok2
    print("RESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
