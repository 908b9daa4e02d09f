#!/usr/bin/env python
"""Smoke run of the GCMC engine on one GPU, through the entry points a
user calls, at the flagship's full size.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # the replica-sharded path on 4 cards

Phases (one process; any failure raises and exits non-zero):

1. device   - JAX must find a GPU; otherwise exit 1 with no result line.
2. compile  - the fused f32 block program (resync on) of each bench regime
              (bench.REGIMES: zif, mixed, resv, tricl, bigS) at 1024
              replicas: memory_analysis, one block run, peak bytes.
3. flagship - load_system -> replicate -> run_block_replicated on the
              ZIF-8-scale system: block time, resync time, a short
              profiler window with the top device operations.
4. cli      - maniac_tpu.cli.main in-process on a deck from the same
              builder; log.maniac must end with "Simulation Completed".
5. correct  - f32 precision probes (one-hot reads exact, rigid O-H kept),
              then x64: f64 bookkeeping == recompute on the flagship,
              f64 total vs the independent numpy oracle (scripts/oracle.py)
              after a GCMC block, and f32 vs f64 totals of one
              configuration.

Earlier lines carry the card's name and power limit, seconds per phase,
memory per regime and every correctness number beside its tolerance.
The last line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Each phase is a function taking the system size, so the CPU tests run
them at tiny size; main() itself refuses anything but a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

#: f64 bookkeeping vs from-scratch recompute on the card (K)
DRIFT_TOL_K = 1e-6
#: absolute-energy gate vs the oracle (the reference's LAMMPS bar). The
#: engine's real-space sum is minimum-image (the reference's semantics),
#: the oracle's is the exact lattice sum; their gap grows with the pair
#: count, so the oracle system is capped at 10 waters (~0.007 kcal/mol)
ORACLE_TOL_KCAL = 0.01
#: relative |E_f32 - E_f64| / |E_f64| of one configuration's from-scratch
#: total: f32 rounding (6e-8) of Coulomb, reciprocal and self components
#: 10-100x larger than the total they cancel to, summed over all pairs
F32_REL_TOL = 1e-4
#: replicas 0..B-1 of the sharded run vs the one-card run (A)
SHARD_POS_TOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def _now() -> float:
    return time.perf_counter()


def _peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats()
    return stats.get("peak_bytes_in_use") if stats else None


def _gb(x) -> str:
    return "n/a" if x is None else f"{x / 1e9:.3f} GB"


def _check_states(spec, states, replicas: int) -> None:
    import numpy as np
    pos = np.asarray(states.pos)
    assert pos.shape == (replicas, 3, spec.S), pos.shape
    assert np.isfinite(pos).all(), "non-finite positions"
    assert np.isfinite(np.asarray(states.energy)).all(), \
        "non-finite energies"
    n = np.asarray(states.n_mol)[:, :spec.R]
    assert (n >= 0).all() and (n <= np.asarray(spec.cap_list)).all(), \
        "populations outside [0, capacity]"


def phase_compile_fit(loaders: dict, replicas: int, steps: int) -> dict:
    """Compile the fused f32 block (resync on) for each regime, print its
    memory_analysis, run one block and check the need fits the device."""
    import jax

    from maniac_tpu.parallel.replicas import replicate, run_block_replicated

    from maniac_tpu.utils.devinfo import device_bytes_limit

    limit = device_bytes_limit()
    out = {}
    for name, load in loaders.items():
        t0 = _now()
        sysm = load()
        spec = sysm.spec
        states = jax.device_put(replicate(spec, sysm.state, replicas))
        jax.block_until_ready(states)
        t_setup = _now() - t0
        t0 = _now()
        compiled = run_block_replicated.lower(
            spec, states, steps, False, True).compile()
        t_compile = _now() - t0
        ma = compiled.memory_analysis()
        need = (ma.argument_size_in_bytes + ma.output_size_in_bytes
                + ma.temp_size_in_bytes - ma.alias_size_in_bytes)
        log(f"[compile] {name}: memory_analysis={ma}")
        t0 = _now()
        st = jax.block_until_ready(compiled(spec, states))
        t_run = _now() - t0
        _check_states(spec, st, replicas)
        peak = _peak_bytes()
        log(f"[compile] {name}: S={spec.S} K={spec.K} B={replicas} "
            f"setup={t_setup:.2f}s compile={t_compile:.2f}s "
            f"block({steps} steps)={t_run:.3f}s args="
            f"{_gb(ma.argument_size_in_bytes)} temp="
            f"{_gb(ma.temp_size_in_bytes)} need={_gb(need)} "
            f"limit={_gb(limit)} peak_bytes_in_use={_gb(peak)}")
        assert limit is None or need <= limit, f"{name} does not fit"
        out[name] = dict(S=spec.S, need=need, peak=peak,
                         compile_s=t_compile)
        del st, states, compiled
    return out


def phase_flagship(load, replicas: int, steps: int, blocks: int,
                   trace_dir: str) -> dict:
    """The library path users drive: load_system -> replicate ->
    run_block_replicated(..., resync=True), timed, then one profiled
    block reduced to the top device operations."""
    import jax

    from maniac_tpu.mc.driver import resync_amplitudes_replicated
    from maniac_tpu.parallel.replicas import replicate, run_block_replicated
    from maniac_tpu.utils.devtrace import device_summary

    t0 = _now()
    sysm = load()
    spec = sysm.spec
    states = jax.device_put(replicate(spec, sysm.state, replicas))
    jax.block_until_ready(states)
    t_setup = _now() - t0

    def block(st):
        return run_block_replicated(spec, st, steps, False, True)

    t0 = _now()
    states = jax.block_until_ready(block(states))
    t_first = _now() - t0
    t0 = _now()
    for _ in range(blocks):
        states = block(states)
    jax.block_until_ready(states)
    t_block = (_now() - t0) / blocks
    _check_states(spec, states, replicas)

    jax.block_until_ready(resync_amplitudes_replicated(spec, states))
    t0 = _now()
    jax.block_until_ready(resync_amplitudes_replicated(spec, states))
    t_resync = _now() - t0

    with jax.profiler.trace(trace_dir):
        states = jax.block_until_ready(block(states))
    summ = device_summary(trace_dir, top=12)
    rate = replicas * steps / t_block
    log(f"[flagship] S={spec.S} K={spec.K} B={replicas} steps/block={steps} "
        f"setup={t_setup:.2f}s compile+first block={t_first:.2f}s "
        f"block={t_block:.4f}s resync alone={t_resync:.4f}s")
    log(f"[flagship] bring-up reading, not a benchmark: {rate:.1f} MC "
        f"steps/s (fused block incl. resync)")
    log(f"[flagship] profiled block: window={summ['window_ms']:.3f}ms "
        f"device busy={summ['busy_ms']:.3f}ms "
        f"({summ['busy_share']:.3f}); planes={summ['device_planes']}")
    for name, ms, n in summ["top"]:
        log(f"[flagship]   {ms:10.3f} ms  x{n:<6d} {name[:100]}")
    return dict(rate=rate, block_s=t_block, resync_s=t_resync,
                setup_s=t_setup, first_s=t_first, trace=summ)


def phase_cli(build, replicas: int, outdir: str) -> dict:
    """The CLI entry point, in this process (a child would need the card
    this process holds). `build(dir)` writes input.maniac, topology.data
    and parameters.inc."""
    from maniac_tpu import cli

    with tempfile.TemporaryDirectory() as tmp:
        build(tmp)
        t0 = _now()
        rc = cli.main(["-i", f"{tmp}/input.maniac",
                       "-d", f"{tmp}/topology.data",
                       "-p", f"{tmp}/parameters.inc",
                       "-o", outdir, "--replicas", str(replicas)])
        dt = _now() - t0
    with open(os.path.join(outdir, "log.maniac")) as f:
        text = f.read()
    # the banner opens the log's last box: only its closing border follows
    at = text.rfind("Simulation Completed")
    done = at >= 0 and text.count("+---", at) == 1
    log(f"[cli] rc={rc} replicas={replicas} wall={dt:.2f}s "
        f"completed_banner={done}")
    assert rc == 0, f"cli returned {rc}"
    assert done, "log.maniac does not end with Simulation Completed"
    return dict(rc=rc, wall_s=dt)


def phase_correctness(flagship_f64, probe_blocks: int, probe_steps: int,
                      probe_replicas: int, f64_steps: int,
                      f64_blocks: int) -> dict:
    """On-card correctness against the plain references. f32 probes run
    first; x64 is enabled for the rest of the process."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from maniac_tpu.utils.hwprobe import (RIGID_TOL, probe_onehot_exact,
                                          probe_rigid_geometry)

    ok1, e1 = probe_onehot_exact()
    log(f"[correct] f32 one-hot read error={e1:.3e} (tolerance 0)")
    ok2, dev = probe_rigid_geometry(probe_blocks, probe_replicas,
                                    probe_steps)
    log(f"[correct] f32 rigid geometry: {probe_blocks}x{probe_steps} NVT "
        f"steps x{probe_replicas} replicas, max |d(O-H)|={dev:.3e} A "
        f"(tolerance {RIGID_TOL:g})")
    assert ok1, "one-hot matmul reads are not exact"
    assert ok2, "rigid geometry deformed"

    jax.config.update("jax_enable_x64", True)
    from maniac_tpu import load_system
    from maniac_tpu.constants import COULOMB_K, KB_KCALMOL
    from maniac_tpu.mc.driver import drift_report, resync, run_block
    from maniac_tpu.physics.energy import system_energy
    from maniac_tpu.system import E_TOT
    from maniac_tpu.systems import make_water_box

    sysm = flagship_f64()
    spec, st = sysm.spec, sysm.state
    for _ in range(f64_blocks):
        st = run_block(spec, st, f64_steps, False)
    rep = drift_report(spec, st)
    acc = int(np.asarray(st.counters)[1].sum())
    log(f"[correct] f64 flagship {f64_blocks}x{f64_steps} steps "
        f"({acc} accepted): drift_K={rep['drift_K']:.3e} "
        f"(tolerance {DRIFT_TOL_K:g}) amp_drift={rep['amp_drift']:.3e}")
    assert rep["drift_K"] <= DRIFT_TOL_K, rep

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from oracle import oracle_total

    with tempfile.TemporaryDirectory() as tmp:
        make_water_box(tmp, n_water=8, L=14.0, cutoff=6.0, tol=1e-6,
                       probs=(0.3, 0.2, 0.5, 0.0), fugacity=30.0)
        paths = (f"{tmp}/input.maniac", f"{tmp}/topology.data",
                 f"{tmp}/parameters.inc")
        s64 = load_system(*paths, dtype=jnp.float64, capacity=10)
        s32 = load_system(*paths, dtype=jnp.float32, capacity=10)
    spec, st = s64.spec, run_block(s64.spec, s64.state, 100, False)
    e_fresh = float(system_energy(spec, st)[0][E_TOT])
    e_run = float(st.energy[E_TOT])
    pos = np.asarray(st.pos, np.float64).T
    active = np.asarray(spec.site_midx) < np.asarray(
        st.n_mol)[np.asarray(spec.site_type)]
    cls = np.asarray(spec.site_cls)[active]
    ref = oracle_total(pos[active], np.asarray(spec.site_q)[active],
                       np.asarray(spec.site_mol)[active], 14.0,
                       np.asarray(spec.eps_cls)[np.ix_(cls, cls)],
                       np.asarray(spec.sig_cls)[np.ix_(cls, cls)],
                       cutoff=6.0, alpha=0.45, n_images=3, kmax=24,
                       coulomb_k=COULOMB_K)
    d_fresh = abs(e_fresh - ref) * KB_KCALMOL
    d_run = abs(e_run - ref) * KB_KCALMOL
    log(f"[correct] oracle after an f64 GCMC block (N="
        f"{int(np.asarray(st.n_mol)[0])}): |E_fresh-E_oracle|={d_fresh:.3e} "
        f"|E_running-E_oracle|={d_run:.3e} kcal/mol "
        f"(tolerance {ORACLE_TOL_KCAL:g})")
    assert max(d_fresh, d_run) <= ORACLE_TOL_KCAL

    f32 = jnp.float32
    st32 = s32.state.replace(pos=jnp.asarray(st.pos, f32),
                             com=jnp.asarray(st.com, f32),
                             n_mol=jnp.asarray(st.n_mol))
    e32 = float(resync(s32.spec, st32).energy[E_TOT])
    rel = abs(e32 - e_fresh) / abs(e_fresh)
    log(f"[correct] f32 vs f64 from-scratch total of one configuration: "
        f"E32={e32:.6f} E64={e_fresh:.6f} K rel={rel:.3e} "
        f"(tolerance {F32_REL_TOL:g})")
    assert rel <= F32_REL_TOL
    return dict(onehot=e1, rigid=dev, drift_K=rep["drift_K"],
                oracle_kcal=max(d_fresh, d_run), f32_rel=rel)


def phase_four_cards(load, per_card: int, steps: int, blocks: int,
                     n_cards: int = 4) -> dict:
    """run_block_sharded over an n_cards mesh (per_card replicas each)
    against the one-card program on replicas 0..per_card-1 (the same
    per-device shapes)."""
    import jax
    import numpy as np

    from maniac_tpu.parallel.mesh import (make_mesh, replicate_spec,
                                          run_block_sharded, shard_replicas)
    from maniac_tpu.parallel.replicas import replicate, run_block_replicated

    assert len(jax.devices()) >= n_cards, jax.devices()
    sysm = load()
    spec = sysm.spec
    host = replicate(spec, sysm.state, n_cards * per_card)
    mesh = make_mesh(n_cards)
    spec_m = replicate_spec(mesh, spec)
    sharded = shard_replicas(mesh, host)
    with mesh:
        hlo = run_block_replicated.lower(spec_m, sharded, steps, False,
                                         True).compile().as_text()
    colls = [op for op in ("all-reduce", "all-gather", "all-to-all",
                           "collective-permute", "reduce-scatter")
             if op in hlo]
    log(f"[four-cards] collectives in the compiled block: {colls or 'none'}")
    assert not colls, colls

    def run_sharded(st):
        return run_block_sharded(mesh, spec_m, st, steps, False, True)

    def timed(fn, st):
        st = jax.block_until_ready(fn(st))
        t0 = _now()
        for _ in range(blocks):
            st = fn(st)
        jax.block_until_ready(st)
        return st, (_now() - t0) / blocks

    t0 = _now()
    jax.block_until_ready(run_sharded(sharded))
    t_c4 = _now() - t0
    out4, t4 = timed(run_sharded, sharded)

    dev0 = jax.devices()[0]
    spec_1 = jax.device_put(spec, dev0)
    one = jax.device_put(jax.tree_util.tree_map(lambda x: x[:per_card],
                                                host), dev0)

    def run_one(st):
        return run_block_replicated(spec_1, st, steps, False, True)

    t0 = _now()
    jax.block_until_ready(run_one(one))
    t_c1 = _now() - t0
    out1, t1 = timed(run_one, one)

    # same starting states and keys on both sides, same number of blocks
    head = jax.tree_util.tree_map(lambda x: np.asarray(x)[:per_card], out4)
    n_eq = np.array_equal(head.n_mol, np.asarray(out1.n_mol))
    c_eq = np.array_equal(head.counters, np.asarray(out1.counters))
    dpos = float(np.abs(head.pos - np.asarray(out1.pos)).max())
    r4 = n_cards * per_card * steps / t4
    r1 = per_card * steps / t1
    log(f"[four-cards] B={n_cards * per_card} ({per_card}/card) "
        f"steps/block={steps} compile+first: {n_cards} cards "
        f"{t_c4:.2f}s, 1 card {t_c1:.2f}s; block {n_cards} cards "
        f"{t4:.4f}s, 1 card {t1:.4f}s")
    log(f"[four-cards] replicas 0..{per_card - 1}: populations equal={n_eq} "
        f"counters equal={c_eq} max|dpos|={dpos:.3e} A "
        f"(tolerance {SHARD_POS_TOL:g})")
    log(f"[four-cards] bring-up reading: {r4:.1f} steps/s on {n_cards} "
        f"cards vs {r1:.1f} on 1 card (x{r4 / r1:.3f})")
    assert n_eq and c_eq and dpos <= SHARD_POS_TOL
    return dict(rate4=r4, rate1=r1, dpos=dpos)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the replica-sharded path on 4 cards "
                         "and the one-card program it is compared with")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(REPO, "maniac_tpu")):
        sys.stderr.write("chip_smoke.py must run from a checkout of the "
                         "repository\n")
        return 2
    sys.path.insert(0, REPO)
    import jax

    from maniac_tpu.utils.devinfo import card_info, device_info

    dev = device_info()
    if dev["platform"] != "gpu":
        sys.stderr.write(f"chip_smoke.py needs a GPU; JAX found "
                         f"{dev['platform']}/{dev['kind']}\n")
        return 1

    import jax.numpy as jnp

    import bench
    from maniac_tpu.systems import make_zif_like
    from maniac_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    log(f"# device: {dev['platform']}/{dev['kind']} x{dev['count']} "
        f"jax {jax.__version__} compile cache: "
        f"{cache or os.environ.get('JAX_COMPILATION_CACHE_DIR') or 'config'}")
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    t_all = _now()
    replicas, steps = 1024, 400

    def flagship(dtype=jnp.float32):
        return lambda: bench.load_regime("zif", dtype)

    if args.four_cards:
        t0 = _now()
        phase_four_cards(flagship(), replicas, steps, blocks=2)
        log(f"# phase four-cards: {_now() - t0:.1f}s")
    else:
        t0 = _now()
        phase_compile_fit(
            {name: (lambda n=name: bench.load_regime(n, jnp.float32))
             for name in bench.REGIMES}, replicas, steps)
        log(f"# phase compile: {_now() - t0:.1f}s")
        t0 = _now()
        phase_flagship(flagship(), replicas, steps, blocks=3,
                       trace_dir=os.path.join(out_dir, "trace"))
        log(f"# phase flagship: {_now() - t0:.1f}s")
        t0 = _now()
        phase_cli(lambda d: make_zif_like(d, n_cells=6, a=5.66, n_water=32,
                                          fugacity=30.0, nb_block=3,
                                          nb_step=steps),
                  replicas, os.path.join(out_dir, "cli"))
        log(f"# phase cli: {_now() - t0:.1f}s")
        t0 = _now()
        phase_correctness(flagship(jnp.float64), probe_blocks=8,
                          probe_steps=2000, probe_replicas=8,
                          f64_steps=400, f64_blocks=3)
        log(f"# phase correct: {_now() - t0:.1f}s")
    log(f"# total: {_now() - t_all:.1f}s")
    log(card_info())
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
