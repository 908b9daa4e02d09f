"""Command-line entry point, flag-compatible with the reference binary.

Usage (reference: src/cli_utils.f90:10-27):

    maniac -i input.maniac -d topology.data -p parameters.inc
           [-r reservoir.data] [-o outputs/]

Extensions:
    --replicas N     vmapped independent chains (population/energy series of
                     replica 0 are written; a replica summary goes to the log)
    --dtype f32|f64  engine precision (f64 default on CPU, f32 on an
                     accelerator)
    --capacity N     per-active-type molecule capacity override
    --platform P     jax platform override (e.g. cpu, gpu)
    --audit          per-block energy-drift audit (full recompute)
    --widom N        N Widom ghost insertions per block per active species:
                     excess chemical potential diagnostic -> widom.dat
    --profile BINS   per-block COM density histogram along --profile-axis
                     (default z) per active species -> profile_<RES>.dat
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="maniac-tpu",
        description="GCMC molecular simulation (JAX)")
    p.add_argument("-i", dest="input", required=True, help=".maniac input deck")
    p.add_argument("-d", dest="data", required=True, help="LAMMPS data file")
    p.add_argument("-p", dest="params", required=True, help="pair-coeff include file")
    p.add_argument("-r", dest="reservoir", default=None, help="reservoir data file")
    p.add_argument("-o", dest="outdir", default="outputs/", help="output directory")
    p.add_argument("--replicas", type=int, default=1)
    p.add_argument("--dtype", choices=["f32", "f64"], default=None)
    p.add_argument("--capacity", type=int, default=None)
    p.add_argument("--platform", default=None)
    p.add_argument("--audit", action="store_true")
    p.add_argument("--widom", type=int, default=0, metavar="N",
                   help="N Widom ghost insertions per block per active "
                        "species (excess chemical potential -> widom.dat)")
    p.add_argument("--profile", type=int, default=0, metavar="BINS",
                   help="per-block COM density histogram with BINS bins "
                        "per active species -> profile_<RES>.dat")
    p.add_argument("--profile-axis", choices=["x", "y", "z"], default="z")
    p.add_argument("--isotherm", default=None, metavar="F1,F2,...",
                   help="adsorption-isotherm sweep: run every listed "
                        "fugacity (atm, applied to each active species "
                        "scaled from its deck fugacity) as parallel state "
                        "points in ONE compiled program, --replicas chains "
                        "per point -> isotherm_<RES>.dat series + "
                        "isotherm.dat summary (the reference needs one "
                        "full run per fugacity, run.sh)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--checkpoint", default=None,
                   help="write a full checkpoint (.npz) every block")
    p.add_argument("--resume", default=None,
                   help="resume from a checkpoint written by --checkpoint")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    from .utils.mapguard import ensure_map_headroom

    ensure_map_headroom()

    import jax

    from .utils.compile_cache import enable_compile_cache

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    enable_compile_cache()
    on_accelerator = any(d.platform != "cpu" for d in jax.devices())
    dtype_name = args.dtype or ("f32" if on_accelerator else "f64")
    if dtype_name == "f64":
        jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp

    from .utils.errors import ManiacError
    from .utils.logger import Logger

    outdir = args.outdir if args.outdir.endswith("/") else args.outdir + "/"
    os.makedirs(outdir, exist_ok=True)
    logger = Logger(os.path.join(outdir, "log.maniac"))

    try:
        return _run(args, outdir, logger,
                    jnp.float64 if dtype_name == "f64" else jnp.float32)
    except ManiacError as e:
        return e.exit_code
    except FileNotFoundError as e:
        logger.log("-" * 50)
        logger.log("FATAL ERROR:")
        logger.log(f"File not found: {e.filename}")
        logger.log("Simulation will now terminate.")
        logger.log("-" * 50)
        return 1
    finally:
        logger.close()


def _run(args, outdir: str, logger, dtype) -> int:
    import jax
    import numpy as np

    from . import __version__
    from .api import load_system
    from .io.writers import OutputWriter, snapshot
    from .system import E_TOT
    from .mc.driver import (drift_report, refresh_reported_energy, resync,
                            run_block)
    from .parallel.replicas import replicate, run_block_replicated
    from .utils.errors import ManiacError

    logger.banner(f"MANIAC-TPU v{__version__}",
                  f"backend: {jax.devices()[0].platform} | dtype: "
                  f"{np.dtype(dtype).name} | replicas: {args.replicas}")

    for path, label in ((args.input, "Input"), (args.data, "Data"),
                        (args.params, "Parameter")):
        if not os.path.exists(path):
            logger.abort(f"{label} file not found: {path}", 1)
    if args.reservoir and not os.path.exists(args.reservoir):
        logger.abort(f"Reservoir file not found: {args.reservoir}", 1)

    t0 = time.time()
    sysm = load_system(args.input, args.data, args.params,
                       reservoir_file=args.reservoir,
                       capacity=args.capacity, dtype=dtype, logger=logger,
                       seed=args.seed)
    deck, spec = sysm.deck, sysm.spec
    state = sysm.state

    if args.isotherm:
        return _run_isotherm(args, outdir, logger, sysm, t0)

    start_block = 0
    if args.resume:
        from .io.checkpoint import load_checkpoint
        state, start_block = load_checkpoint(args.resume, spec)
        logger.info(f"Resumed from {args.resume} at block {start_block}")

    replicated = args.replicas > 1
    if replicated and state.pos.ndim == 2:
        state = replicate(spec, state, args.replicas)

    writer = OutputWriter(outdir, deck, sysm.parsed, logger)
    rep0 = 0 if replicated else None

    def res_snap():
        if not spec.has_reservoir:
            return None
        return snapshot(spec, state, rep0, reservoir=True)

    res_box = sysm.reservoir.box if sysm.reservoir else None
    logger.banner("Started Monte Carlo Loop")
    snap0 = snapshot(spec, state, rep0)
    writer.update_files(snap0, 0, append=False,
                        reservoir_snap=res_snap(), reservoir_box=res_box)
    if args.profile > 0:
        writer.write_profile(snap0, 0, args.profile, args.profile_axis)

    total_steps = 0
    if args.widom > 0:
        from .mc.widom import widom_block
        widom_names = [res.name for res in deck.residues if res.active]
        widom_sum = np.zeros(len(widom_names))
        widom_blocks = 0
    for block in range(start_block + 1, deck.nb_block + 1):
        f32 = spec.dtype == np.float32
        if replicated:
            # f32: the amplitude resync is fused into the block program;
            # it bounds incremental A(k) drift at block granularity
            # (DIVERGENCES #13)
            state = run_block_replicated(spec, state, deck.nb_step,
                                         deck.recalibrate_moves, f32)
        else:
            state = run_block(spec, state, deck.nb_step,
                              deck.recalibrate_moves)
        if f32:
            # make the REPORTED energy rows exact: the reference's
            # energy.dat is a fresh value every block
            # (src/write_utils.f90:94-188), so f32 runs fold one
            # from-scratch recompute into the per-block output path
            # (replica 0 only when replicated)
            if replicated:
                state = refresh_reported_energy(spec, state)
            else:
                state = resync(spec, state)
        total_steps += deck.nb_step * args.replicas
        snap = snapshot(spec, state, rep0)
        writer.print_status(snap, block)
        writer.update_files(snap, block, append=True,
                            reservoir_snap=res_snap(), reservoir_box=res_box)
        if replicated:
            # cross-replica per-block series (replicas.dat): reduced on
            # device, 2R+2 scalars over the host link per block
            from .parallel.mesh import gather_replica_stats
            mean_n, std_n, mean_e, std_e = gather_replica_stats(
                state, spec.R, E_TOT)
            act_names = [res.name for res in deck.residues if res.active]
            act_ids = [r for r, res in enumerate(deck.residues) if res.active]
            writer.write_replicas(
                block, act_names, np.asarray(mean_n)[act_ids],
                np.asarray(std_n)[act_ids], float(mean_e), float(std_e))
        if args.profile > 0:
            writer.write_profile(snap, block, args.profile,
                                 args.profile_axis)
        if args.widom > 0:
            # ghost insertions on the reported replica's CURRENT (exact,
            # post-refresh) configuration; the chain's own state.key is
            # never advanced here, so enabling the diagnostic never perturbs
            # trajectories. The fixed tag fold keeps the diagnostic draws
            # practically independent of the chain's split() stream (a bare
            # fold_in(key, block) shares threefry counter blocks with
            # split(key, n) subkeys)
            st0 = (jax.tree_util.tree_map(lambda x: x[0], state)
                   if replicated else state)
            wkey = jax.random.fold_in(
                jax.random.fold_in(st0.key, 0x5749444F), block)
            # widom_block returns ln B (overflow-safe); convert in f64
            B_blk = np.exp(np.asarray(widom_block(spec, st0, args.widom,
                                                  wkey), dtype=np.float64))
            widom_sum += B_blk
            widom_blocks += 1
            writer.write_widom(block, widom_names, B_blk,
                               widom_sum / widom_blocks, float(spec.temp_K))
        if args.audit and not replicated:
            rep = drift_report(spec, state)
            logger.log(f"  audit: |E_running - E_fresh| = "
                       f"{rep['drift_K']:.3e} K")
        if args.checkpoint:
            from .io.checkpoint import save_checkpoint
            save_checkpoint(args.checkpoint, spec, state, block)

    elapsed = time.time() - t0
    snap = snapshot(spec, state, rep0)
    if int(np.asarray(state.extras).reshape(-1, 4)[..., 0].sum()) > 0:
        logger.warn("Some insertions were rejected because the molecule "
                    "capacity was reached; consider --capacity.")
    if replicated:
        n = np.asarray(state.n_mol)[:, : spec.R]
        for r, res in enumerate(deck.residues):
            if res.active:
                logger.log(f"  replica <N({res.name})> = {n[:, r].mean():.3f}"
                           f" +- {n[:, r].std():.3f}")
    if deck.nb_block * deck.nb_step > 0:
        rate = total_steps / max(elapsed, 1e-9)
        logger.log(f"  throughput: {rate:,.0f} MC steps/s "
                   f"({total_steps:,} steps in {elapsed:.2f} s)")
    writer.final_report(snap, deck.nb_block)
    return 0


def _run_isotherm(args, outdir: str, logger, sysm, t0: float) -> int:
    """Adsorption-isotherm sweep: every listed fugacity is a batch of
    replica chains with its own per-replica activity (one compiled program
    for the whole isotherm, parallel/replicas.run_block_sweep). The
    reference produces an isotherm by one full serial run per fugacity
    (run.sh:4-96); this is the batched equivalent."""
    import jax.numpy as jnp
    import numpy as np

    from .io.writers import OutputWriter
    from .parallel.replicas import (perturb_activity, replicate,
                                    run_block_sweep)

    deck, spec, state = sysm.deck, sysm.spec, sysm.state
    try:
        fugs = [float(t) for t in args.isotherm.split(",") if t]
    except ValueError:
        logger.abort(f"--isotherm expects comma-separated fugacities "
                     f"(atm), got: {args.isotherm}", 1)
    if not fugs or any(f <= 0 for f in fugs):
        logger.abort("--isotherm fugacities must be positive", 1)
    act_ids = [r for r, res in enumerate(deck.residues) if res.active]
    act_names = [deck.residues[r].name for r in act_ids]
    if not act_ids:
        logger.abort("--isotherm needs at least one active species", 1)
    for flag, name in ((args.resume, "--resume"),
                       (args.checkpoint, "--checkpoint"),
                       (args.widom, "--widom"),
                       (args.audit, "--audit"), (args.profile, "--profile")):
        if flag:
            logger.warn(f"{name} is ignored in --isotherm mode (the sweep "
                        f"is a self-contained batched program)")

    reps = max(1, args.replicas)
    npts = len(fugs)
    B = npts * reps
    # per-point activities: scale each active species' deck-derived
    # activity by f_point / f_deck (activity is proportional to fugacity)
    base = np.asarray(spec.type_activity, dtype=np.float64)
    acts = np.broadcast_to(base, (B, base.shape[0])).copy()
    for i, f_ in enumerate(fugs):
        for r in act_ids:
            scale = f_ / deck.residues[r].fugacity
            acts[i * reps:(i + 1) * reps, r] = base[r] * scale
    spec_sweep = perturb_activity(spec, jnp.asarray(acts, dtype=spec.dtype))
    states = replicate(spec, state, B)

    writer = OutputWriter(outdir, deck, sysm.parsed, logger)
    logger.banner("Started Monte Carlo Loop (isotherm sweep)",
                  f"{npts} fugacity points x {reps} replicas = {B} chains")
    f32 = spec.dtype == np.float32
    half = deck.nb_block // 2
    from .system import E_TOT
    prod_n = []                       # per-block (npts, reps, n_active)
    prod_e = []                       # per-block (npts, reps) total energy
    for block in range(1, deck.nb_block + 1):
        states = run_block_sweep(spec_sweep, states, deck.nb_step,
                                 deck.recalibrate_moves, f32)
        n = np.asarray(states.n_mol)[:, act_ids].reshape(npts, reps,
                                                         len(act_ids))
        mean_n = n.mean(axis=1)       # (npts, n_active)
        writer.write_isotherm(block, act_names, fugs, mean_n)
        if block > half:
            prod_n.append(n)
            prod_e.append(np.asarray(states.energy, dtype=np.float64)
                          [:, E_TOT].reshape(npts, reps))
        logger.log("  block {:5d}: ".format(block) + "  ".join(
            f"{name}@{f_:g}atm <N>={mean_n[i, j]:.2f}"
            for j, name in enumerate(act_names)
            for i, f_ in enumerate(fugs)))
    prod = np.concatenate(prod_n, axis=1)  # (npts, blocks*reps, n_active)
    e_s = np.concatenate(prod_e, axis=1)   # (npts, blocks*reps)
    # isosteric heat from cross-chain fluctuations (Nicholson & Parsonage):
    # q_st = k_B T - cov(E, N)/var(N), engine energies in Kelvin. For an
    # ideal gas cov = 0 -> q_st = RT exactly (tested). Multi-species rows
    # use the same formula per species' N (partial-q_st approximation).
    from .constants import KB_KCALMOL
    qst = np.full((npts, len(act_ids)), np.nan)
    for j in range(len(act_ids)):
        for i in range(npts):
            var = prod[i, :, j].var()
            if var > 1e-12:
                cov = np.cov(e_s[i], prod[i, :, j], bias=True)[0, 1]
                qst[i, j] = (spec.temp_K - cov / var) * KB_KCALMOL
    writer.write_isotherm_summary(act_names, fugs, prod.mean(axis=1),
                                  prod.std(axis=1), qst)
    logger.banner("Isotherm summary (production half)")
    for j, name in enumerate(act_names):
        for i, f_ in enumerate(fugs):
            logger.log(f"  {name} @ {f_:g} atm: <N> = "
                       f"{prod[i, :, j].mean():.3f} "
                       f"+- {prod[i, :, j].std():.3f}"
                       f"  qst = {qst[i, j]:.3f} kcal/mol")
    elapsed = time.time() - t0
    total = deck.nb_block * deck.nb_step * B
    logger.log(f"  throughput: {total / max(elapsed, 1e-9):,.0f} MC steps/s "
               f"({total:,} steps in {elapsed:.2f} s)")
    logger.banner("Simulation Completed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
