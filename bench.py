#!/usr/bin/env python
"""Headline benchmark: aggregate GCMC step throughput on one GPU on the
ZIF-8-scale water-adsorption system (BASELINE.json flagship config), with
vmapped replica chains.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"hw_precision", "device": {"platform", "kind", "count"}}. Per-phase timings
and the card's name and power limit go to stderr. Exits non-zero without
printing a result when JAX finds no GPU: a CPU number is not a device
number.

After timing, the run re-proves on the device it measured that matmul
products are full f32 (utils/hwprobe.py stages 1 and 2: one-hot reads
exact, rigid O-H kept); "hw_precision" carries both readings, and a failed
probe makes the exit code non-zero.

The reference publishes no throughput numbers (BASELINE.md), so vs_baseline
is measured against the north-star target of 1e6 GCMC steps/sec/chip.

Env knobs: MANIAC_BENCH_REPLICAS / STEPS / BLOCKS / DTYPE / CAPACITY /
SYSTEM. MANIAC_BENCH_SYSTEM selects the workload:

  zif     (default) ZIF-8-scale framework + water, single active species
  mixed   framework + water + dimer, TWO active species incl. swap moves
  resv    water GCMC with a RESERVOIR (geometry sampling + push/pop)
  tricl   triclinic water box (27-image min-image)
  bigS    reference-capacity envelope: ~2000 live waters, capacity 2500
          (the reference's static cap is 5000/type, src/parameters.f90:8)
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

TARGET_STEPS_PER_SEC = 1.0e6

#: bench regime -> (builder name, builder kwargs, default capacity,
#: reservoir builder kwargs or None). chip_smoke.py compiles the same set.
REGIMES = {
    "zif": ("make_zif_like",
            dict(n_cells=6, a=5.66, n_water=32, fugacity=30.0), 192, None),
    "mixed": ("make_framework_mixed",
              dict(n_cells=6, a=5.66, n_water=24, n_dimer=12, cutoff=8.5,
                   tol=1e-5, probs=(0.25, 0.15, 0.4, 0.2)), 192, None),
    "resv": ("make_water_box",
             dict(n_water=48, L=24.0, cutoff=8.0, tol=1e-5,
                  probs=(0.3, 0.2, 0.5, 0.0), fugacity=4000.0), 192,
             dict(n_water=96, L=24.0)),
    "tricl": ("make_triclinic_water",
              dict(n_water=24, L=22.0, tilt=(2.0, 1.2, 0.8), cutoff=7.0,
                   tol=1e-5, probs=(0.3, 0.2, 0.5, 0.0), fugacity=4000.0),
              192, None),
    "bigS": ("make_water_box",
             dict(n_water=2000, L=40.0, cutoff=8.5, tol=1e-5,
                  probs=(0.3, 0.2, 0.5, 0.0), fugacity=4000.0), 2500, None),
}


def load_regime(system: str, dtype, capacity: int | None = None):
    """Build one bench regime's deck in a temporary directory and load it
    (the cold setup a user pays). Returns the LoadedSystem."""
    from maniac_tpu import load_system
    from maniac_tpu import systems

    if system not in REGIMES:
        raise SystemExit(f"unknown bench system {system!r}; "
                         f"choose from {sorted(REGIMES)}")
    builder, kw, cap_default, res_kw = REGIMES[system]
    with tempfile.TemporaryDirectory() as tmp:
        getattr(systems, builder)(tmp, **kw)
        res_file = (systems.make_water_reservoir(tmp, **res_kw)
                    if res_kw is not None else None)
        return load_system(f"{tmp}/input.maniac", f"{tmp}/topology.data",
                           f"{tmp}/parameters.inc", dtype=dtype,
                           capacity=capacity or cap_default,
                           reservoir_file=res_file)


def precision_evidence(blocks: int = 4, replicas: int = 8,
                       steps: int = 2000) -> dict:
    """hwprobe stages 1 and 2 on the default device (their own f32
    programs, run after timing so their compiles stay out of it)."""
    from maniac_tpu.utils.hwprobe import (RIGID_TOL, probe_onehot_exact,
                                          probe_rigid_geometry)

    ok1, err = probe_onehot_exact()
    ok2, dev = probe_rigid_geometry(blocks, replicas, steps)
    return {"ok": bool(ok1 and ok2), "onehot_err": err,
            "rigid_dOH_A": dev, "rigid_tol_A": RIGID_TOL}


def main() -> int:
    import jax

    from maniac_tpu.utils.compile_cache import enable_compile_cache
    from maniac_tpu.utils.devinfo import card_info, device_info

    dev = device_info()
    if dev["platform"] != "gpu":
        sys.stderr.write(f"bench.py measures a GPU; JAX found "
                         f"{dev['platform']}/{dev['kind']}\n")
        return 1
    enable_compile_cache()

    import jax.numpy as jnp
    import numpy as np

    system = os.environ.get("MANIAC_BENCH_SYSTEM", "zif")
    replicas = int(os.environ.get("MANIAC_BENCH_REPLICAS", "1024"))
    steps_per_block = int(os.environ.get("MANIAC_BENCH_STEPS", "400"))
    n_blocks = int(os.environ.get("MANIAC_BENCH_BLOCKS", "3"))
    capacity = int(os.environ.get("MANIAC_BENCH_CAPACITY", "0")) or None
    dtype_name = os.environ.get("MANIAC_BENCH_DTYPE", "f32")
    if dtype_name == "f64":
        jax.config.update("jax_enable_x64", True)
    dtype = jnp.float64 if dtype_name == "f64" else jnp.float32

    from maniac_tpu.parallel.replicas import replicate, run_block_replicated

    t_setup = time.perf_counter()
    sysm = load_regime(system, dtype, capacity)
    spec = sysm.spec
    states = jax.device_put(replicate(spec, sysm.state, replicas))
    jax.block_until_ready(states)
    t_setup = time.perf_counter() - t_setup

    resync = dtype_name != "f64"  # f32 runs bound amplitude drift per block

    def one_block(st):
        return run_block_replicated(spec, st, steps_per_block, False, resync)

    # compile + warmup (excluded from timing)
    t_compile = time.perf_counter()
    states = jax.block_until_ready(one_block(states))
    t_compile = time.perf_counter() - t_compile

    t0 = time.perf_counter()
    for _ in range(n_blocks):
        states = one_block(states)
    jax.block_until_ready(states)
    elapsed = time.perf_counter() - t0

    total_steps = replicas * steps_per_block * n_blocks
    rate = total_steps / elapsed
    sys.stderr.write(
        f"# device={dev['platform']}/{dev['kind']} x{dev['count']} "
        f"card={card_info()}\n"
        f"# system={system} dtype={dtype_name} replicas={replicas} "
        f"S={spec.S} K={spec.K}\n"
        f"# phases: cold setup={t_setup:.2f}s compile+first block="
        f"{t_compile:.2f}s block={elapsed / n_blocks * 1e3:.3f}ms "
        f"({steps_per_block} steps, resync fused={resync})\n"
        f"# steps={total_steps:,} elapsed={elapsed:.3f}s mean_N="
        f"{float(np.asarray(states.n_mol)[:, :spec.R].sum(1).mean()):.1f}\n")

    t0 = time.perf_counter()
    hw = precision_evidence()
    sys.stderr.write(f"# hw_precision={hw} "
                     f"[{time.perf_counter() - t0:.1f}s]\n")

    metric = ("gcmc_steps_per_sec_per_chip_zif8_h2o" if system == "zif"
              else f"gcmc_steps_per_sec_per_chip_{system}")
    print(json.dumps({
        "metric": metric,
        "value": rate,
        "unit": "MC steps/s/chip",
        "vs_baseline": rate / TARGET_STEPS_PER_SEC,
        "hw_precision": hw,
        "device": dev,
    }))
    return 0 if hw["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
