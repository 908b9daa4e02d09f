"""End-to-end CLI contract + vmapped replicas + mesh-sharded replicas."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from maniac_tpu.cli import main as cli_main
from maniac_tpu.parallel.mesh import (gather_mean_population, make_mesh,
                                      replicate_spec, run_block_sharded,
                                      shard_replicas)
from maniac_tpu.parallel.replicas import replicate, run_block_replicated
from maniac_tpu import load_system

from fixtures import make_lj_gas, make_water_box


def test_cli_end_to_end(tmp_path):
    d = make_water_box(str(tmp_path / "sys"), n_water=8, L=14.0, cutoff=5.0,
                       tol=1e-4, probs=(0.3, 0.3, 0.4, 0.0), fugacity=500.0,
                       nb_block=2, nb_step=50, recal=True)
    out = str(tmp_path / "outputs")
    rc = cli_main(["-i", f"{d}/input.maniac", "-d", f"{d}/topology.data",
                   "-p", f"{d}/parameters.inc", "-o", out,
                   "--platform", "cpu", "--dtype", "f64", "--audit"])
    assert rc == 0
    log = open(f"{out}/log.maniac").read()
    # the black-box contract greps (reference: tests/readers/*/run-test.sh)
    assert "Simulation Completed" in log
    assert "TotEng" in log
    # awk contract: line after last TotEng, second field is the energy
    lines = log.splitlines()
    idx = max(i for i, l in enumerate(lines) if "TotEng" in l)
    val = lines[idx + 1].lstrip("| ").split()[1]
    float(val)
    for f in ("energy.dat", "moves.dat", "number_wat.dat",
              "trajectory.lammpstrj", "topology.data"):
        assert os.path.exists(f"{out}/{f}"), f
    # energy.dat has 2+1 rows (block 0 + 2 blocks)
    rows = [l for l in open(f"{out}/energy.dat") if not l.startswith("#")]
    assert len(rows) == 3


def test_cli_error_contract(tmp_path):
    d = make_water_box(str(tmp_path / "sys"))
    bad = str(tmp_path / "bad.maniac")
    text = open(f"{d}/input.maniac").read().replace("nb_block 1\n", "")
    open(bad, "w").write(text)
    out = str(tmp_path / "outputs")
    rc = cli_main(["-i", bad, "-d", f"{d}/topology.data",
                   "-p", f"{d}/parameters.inc", "-o", out,
                   "--platform", "cpu"])
    assert rc != 0
    log = open(f"{out}/log.maniac").read()
    assert "ERROR" in log or "Error" in log


def test_cli_restart_roundtrip(tmp_path):
    """topology.data written by us must be loadable as a -d input."""
    d = make_water_box(str(tmp_path / "sys"), n_water=8, L=14.0, cutoff=5.0,
                       tol=1e-4, probs=(0.5, 0.5, 0.0, 0.0), nb_block=1,
                       nb_step=30)
    out = str(tmp_path / "out1")
    assert cli_main(["-i", f"{d}/input.maniac", "-d", f"{d}/topology.data",
                     "-p", f"{d}/parameters.inc", "-o", out,
                     "--platform", "cpu", "--dtype", "f64"]) == 0
    out2 = str(tmp_path / "out2")
    assert cli_main(["-i", f"{d}/input.maniac", "-d", f"{out}/topology.data",
                     "-p", f"{d}/parameters.inc", "-o", out2,
                     "--platform", "cpu", "--dtype", "f64"]) == 0
    assert "Simulation Completed" in open(f"{out2}/log.maniac").read()


@pytest.fixture(scope="module")
def lj_system(tmp_path_factory):
    d = make_lj_gas(str(tmp_path_factory.mktemp("lj")), n=16, L=16.0,
                    probs=(0.5, 0.0, 0.5, 0.0), fugacity=60.0,
                    cutoff=6.0, tol=1e-3)
    return load_system(f"{d}/input.maniac", f"{d}/topology.data",
                       f"{d}/parameters.inc")


def test_vmapped_replicas(lj_system):
    spec, state = lj_system.spec, lj_system.state
    B = 8
    states = replicate(spec, state, B)
    states = run_block_replicated(spec, states, 100, False)
    n = np.asarray(states.n_mol)[:, 0]
    assert n.shape == (B,)
    # chains must decorrelate (different RNG streams)
    assert len(np.unique(np.asarray(states.energy)[:, 5])) > 1
    # each replica's bookkeeping must individually hold
    from maniac_tpu.physics.energy import system_energy
    for b in (0, B - 1):
        one = jax.tree_util.tree_map(lambda x: x[b], states)
        e, _, _ = system_energy(spec, one)
        assert abs(float(one.energy[5] - e[5])) < 1e-7


def test_mesh_sharded_replicas(lj_system):
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    spec, state = lj_system.spec, lj_system.state
    mesh = make_mesh(8)
    states = replicate(spec, state, 16)
    states = shard_replicas(mesh, states)
    spec_r = replicate_spec(mesh, spec)
    states = run_block_sharded(mesh, spec_r, states, 60, False)
    mean_n = np.asarray(gather_mean_population(states, spec.R))
    assert mean_n.shape == (spec.R,)
    assert np.all(mean_n >= 0)
    # sharding preserved through the block
    shardings = {str(x.sharding) for x in jax.tree_util.tree_leaves(states)}
    assert any("dp" in s for s in shardings)


@pytest.mark.parametrize("shape", ["lj", "flagship", "mixed", "resv",
                                   "tricl"])
def test_sharded_block_hlo_has_no_collectives(lj_system, tmp_path, shape):
    """Pin the SURVEY section 2.18 / docs/architecture.md design claim
    mechanically - for EVERY distinct execution regime (LJ gas, framework
    flagship, mixed-species swap, reservoir, triclinic): the compiled
    steady-state sharded block program contains NO cross-replica
    collectives (independent chains shard with zero ICI traffic); the only
    collective lives in the diagnostic reduction (gather_mean_population),
    which must still lower to an all-reduce."""
    if shape == "lj":
        spec, state = lj_system.spec, lj_system.state
    else:
        from maniac_tpu.systems import tiny_system
        deck, data, inc, res = tiny_system(str(tmp_path), shape)
        sysm = load_system(deck, data, inc, capacity=16,
                           reservoir_file=res)
        spec, state = sysm.spec, sysm.state
    mesh = make_mesh(8)
    states = shard_replicas(mesh, replicate(spec, state, 16))
    spec_r = replicate_spec(mesh, spec)
    with mesh:
        txt = jax.jit(run_block_replicated, static_argnums=(2, 3)).lower(
            spec_r, states, 10, False).compile().as_text()
    for op in ("all-reduce", "all-gather", "collective-permute",
               "all-to-all", "reduce-scatter"):
        assert op not in txt, f"steady-state block program contains {op}"
    with mesh:
        txt2 = jax.jit(gather_mean_population, static_argnums=(1,)).lower(
            states, spec.R).compile().as_text()
    assert "all-reduce" in txt2


def test_sharded_fused_resync_hlo_has_no_collectives(tmp_path):
    """The f32 block with its per-block amplitude resync fused into the
    tail (resync=True, what bench.py and the CLI run) stays
    collective-free when the replica axis is sharded: the vmapped
    resynthesis is per replica like the steps before it."""
    from maniac_tpu.systems import tiny_system
    deck, data, inc, res = tiny_system(str(tmp_path), "flagship")
    sysm = load_system(deck, data, inc, capacity=16, reservoir_file=res,
                       dtype=jnp.float32)
    spec = sysm.spec
    mesh = make_mesh(8)
    states = shard_replicas(mesh, replicate(spec, sysm.state, 16))
    spec_r = replicate_spec(mesh, spec)
    with mesh:
        txt = run_block_replicated.lower(spec_r, states, 4, False,
                                         True).compile().as_text()
    for op in ("all-reduce", "all-gather", "collective-permute",
               "all-to-all", "reduce-scatter"):
        assert op not in txt, f"fused resync program contains {op}"


def test_isotherm_sweep(tmp_path):
    """Per-replica chemical potentials: one compiled program produces a full
    adsorption isotherm. On an ideal gas <N> = activity * V per replica, so
    the sweep's population means must scale with the activities."""
    import jax.numpy as jnp

    from maniac_tpu.parallel.replicas import (perturb_activity,
                                              run_block_sweep)

    d = make_lj_gas(str(tmp_path), n=8, L=16.0, probs=(0.0, 0.0, 1.0, 0.0),
                    fugacity=100.0, cutoff=6.0, tol=1e-3)
    # ideal gas: zero out the LJ
    open(f"{d}/parameters.inc", "w").write("pair_coeff 1 1 0.0 0.0\n")
    sysm = load_system(f"{d}/input.maniac", f"{d}/topology.data",
                       f"{d}/parameters.inc")
    spec, state = sysm.spec, sysm.state

    B = 4
    base = float(spec.type_activity[0])
    scale = np.array([0.5, 1.0, 2.0, 4.0])
    acts = jnp.asarray((base * scale)[:, None])            # (B, R)
    spec_sweep = perturb_activity(spec, acts)
    states = replicate(spec, state, B)

    states = run_block_sweep(spec_sweep, states, 2000, False)  # burn-in
    counts = np.zeros(B)
    n_samp = 30
    for _ in range(n_samp):
        states = run_block_sweep(spec_sweep, states, 150, False)
        counts += np.asarray(states.n_mol)[:, 0]
    mean_n = counts / n_samp
    expected = base * scale * float(spec.volume)
    # Poisson statistics with ~n_samp correlated samples: generous bars
    for b in range(B):
        tol = max(5 * np.sqrt(expected[b] / 8), 0.35 * expected[b])
        assert abs(mean_n[b] - expected[b]) < tol, (b, mean_n, expected)
    # monotone in activity
    assert mean_n[0] < mean_n[1] < mean_n[2] < mean_n[3]


def test_cli_isotherm_mode(tmp_path):
    """--isotherm f1,f2,... runs every fugacity as parallel state points in
    one program and writes isotherm_<RES>.dat series + isotherm.dat summary
    with occupancy increasing in fugacity (VERDICT r4 #7)."""
    d = make_lj_gas(str(tmp_path / "sys"), n=4, L=16.0,
                    probs=(0.0, 0.0, 1.0, 0.0), fugacity=100.0, cutoff=6.0,
                    tol=1e-3, nb_block=8, nb_step=400)
    # ideal gas: zero LJ makes <N> = activity * V exactly
    open(f"{d}/parameters.inc", "w").write("pair_coeff 1 1 0.0 0.0\n")
    out = str(tmp_path / "outputs")
    rc = cli_main(["-i", f"{d}/input.maniac", "-d", f"{d}/topology.data",
                   "-p", f"{d}/parameters.inc", "-o", out,
                   "--platform", "cpu", "--dtype", "f64",
                   "--isotherm", "50,400", "--replicas", "2"])
    assert rc == 0
    log = open(f"{out}/log.maniac").read()
    assert "Isotherm summary" in log and "Simulation Completed" in log
    series = [l for l in open(f"{out}/isotherm_lj.dat")
              if not l.startswith("#")]
    assert len(series) == 8 and len(series[0].split()) == 3
    rows = [l.split() for l in open(f"{out}/isotherm.dat")
            if not l.startswith("#")]
    assert [r[0] for r in rows] == ["lj", "lj"]
    f_vals = [float(r[1]) for r in rows]
    n_vals = [float(r[2]) for r in rows]
    assert f_vals == [50.0, 400.0]
    # 8x the fugacity must raise the ideal-gas occupancy decisively
    assert n_vals[1] > 2.0 * n_vals[0] > 0.0, rows
    # fluctuation isosteric heat: exactly RT for an ideal gas (E == 0,
    # cov(E, N) == 0 -> qst = k_B T = 0.5962 kcal/mol at 300 K)
    q_vals = [float(r[4]) for r in rows]
    for q in q_vals:
        assert abs(q - 0.5962) < 0.01, q_vals


def test_cli_isotherm_f32_resync(tmp_path):
    """--isotherm at f32 exercises run_block_sweep's fused per-block
    amplitude resync (the CLI passes resync=True for f32 engines);
    the sweep must run and write the summary."""
    d = make_lj_gas(str(tmp_path / "sys"), n=4, L=16.0,
                    probs=(0.0, 0.0, 1.0, 0.0), fugacity=100.0, cutoff=6.0,
                    tol=1e-3, nb_block=3, nb_step=100)
    out = str(tmp_path / "outputs")
    rc = cli_main(["-i", f"{d}/input.maniac", "-d", f"{d}/topology.data",
                   "-p", f"{d}/parameters.inc", "-o", out,
                   "--platform", "cpu", "--dtype", "f32",
                   "--isotherm", "100", "--replicas", "2"])
    assert rc == 0
    rows = [l for l in open(f"{out}/isotherm.dat") if not l.startswith("#")]
    assert len(rows) == 1 and float(rows[0].split()[2]) >= 0.0


def test_cli_replicas_dat_contract(tmp_path):
    """--replicas N>1 must write replicas.dat: one row per block with
    cross-replica mean +- std of N per active species and of the running
    total energy (the batched analog of number_<RES>.dat's series,
    reference src/write_utils.f90:94-188). Format contract: header names
    every active species; per-block rows parse; std columns are
    non-negative; the mean-N column agrees with the final log summary's
    replica statistics to the reported precision."""
    d = make_water_box(str(tmp_path / "sys"), n_water=8, L=14.0, cutoff=5.0,
                       tol=1e-4, probs=(0.3, 0.3, 0.4, 0.0), fugacity=500.0,
                       nb_block=3, nb_step=40, recal=False)
    out = str(tmp_path / "outputs")
    rc = cli_main(["-i", f"{d}/input.maniac", "-d", f"{d}/topology.data",
                   "-p", f"{d}/parameters.inc", "-o", out,
                   "--platform", "cpu", "--dtype", "f64", "--replicas", "4"])
    assert rc == 0
    path = f"{out}/replicas.dat"
    assert os.path.exists(path)
    lines = open(path).read().splitlines()
    assert lines[0].startswith("#") and "<N(wat)>" in lines[0] \
        and "std(N(wat))" in lines[0] and "<E_tot>" in lines[0]
    rows = [l.split() for l in lines[1:]]
    assert len(rows) == 3                                  # one per block
    for i, r in enumerate(rows):
        assert int(r[0]) == i + 1
        mean_n, std_n, mean_e, std_e = map(float, r[1:5])
        assert mean_n >= 0.0 and std_n >= 0.0 and std_e >= 0.0
        assert np.isfinite(mean_e)
    # single-replica runs must NOT write the file
    out1 = str(tmp_path / "outputs1")
    rc = cli_main(["-i", f"{d}/input.maniac", "-d", f"{d}/topology.data",
                   "-p", f"{d}/parameters.inc", "-o", out1,
                   "--platform", "cpu", "--dtype", "f64"])
    assert rc == 0
    assert not os.path.exists(f"{out1}/replicas.dat")


def test_multihost_launcher_smoke(tmp_path):
    """tools/launch_multihost.py single-process smoke: the multi-host
    entry point (jax.distributed wiring skipped at num-processes 1) must
    assemble the global sharded state via shard_replicas_global over the
    8 virtual devices and run real blocks."""
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "launch_multihost", os.path.join(root, "tools",
                                         "launch_multihost.py"))
    lmh = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lmh)

    d = make_lj_gas(str(tmp_path), n=8, L=16.0, probs=(0.4, 0.0, 0.6, 0.0),
                    fugacity=50.0, cutoff=6.0, tol=1e-3)
    assert len(jax.devices()) >= 8
    rc = lmh.main(["--num-processes", "1",
                   "-i", f"{d}/input.maniac", "-d", f"{d}/topology.data",
                   "-p", f"{d}/parameters.inc",
                   "--replicas-per-device", "2", "--blocks", "2",
                   "--steps", "40"])
    assert rc == 0


def _launch_proc(root, d, extra, n_dev, tmp_path, tag):
    import subprocess
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_dev}"
    # each subprocess compiles its own programs; share the suite's
    # persistent cache so the 3 launches compile the block program once
    env.setdefault("JAX_COMPILATION_CACHE_DIR",
                   os.path.expanduser("~/.cache/maniac-jax-tests"))
    out = open(str(tmp_path / f"{tag}.log"), "w")
    return subprocess.Popen(
        ["python", os.path.join(root, "tools", "launch_multihost.py"),
         "--platform", "cpu",
         "-i", f"{d}/input.maniac", "-d", f"{d}/topology.data",
         "-p", f"{d}/parameters.inc",
         "--replicas-per-device", "2", "--blocks", "2", "--steps", "40",
         "--seed", "77"] + extra,
        env=env, stdout=out, stderr=subprocess.STDOUT, cwd=root), out


def _block_rows(path):
    import re
    rows = []
    for line in open(path):
        if line.startswith("block"):
            rows.append([float(x) for x in re.findall(r"-?\d+\.\d+", line)])
    return rows


@pytest.mark.slow
def test_multihost_two_processes(tmp_path):
    """REAL 2-process launch (VERDICT r4 #5): jax.distributed over a
    localhost coordinator, 2 processes x 4 virtual CPU devices = the same
    8 global devices as the single-process smoke. Both hosts must
    assemble their shards, advance all blocks, and the cross-host
    diagnostic reduction (the only DCN traffic) must agree with a
    single-process run of the identical global computation. This is the
    class of test the single-process smoke cannot see (round-3 advisor
    caught a global-vs-local-devices bug only a real multi-process run
    exercises)."""
    import socket

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    d = make_lj_gas(str(tmp_path / "sys"), n=8, L=16.0,
                    probs=(0.4, 0.0, 0.6, 0.0), fugacity=50.0, cutoff=6.0,
                    tol=1e-3)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = ["--coordinator", f"127.0.0.1:{port}", "--num-processes", "2"]

    p_ref, f_ref = _launch_proc(root, d, ["--num-processes", "1"], 8,
                                tmp_path, "ref")
    assert p_ref.wait(timeout=600) == 0, open(str(tmp_path / "ref.log")).read()
    f_ref.close()

    p0, f0 = _launch_proc(root, d, coord + ["--process-id", "0"], 4,
                          tmp_path, "p0")
    p1, f1 = _launch_proc(root, d, coord + ["--process-id", "1"], 4,
                          tmp_path, "p1")
    rc0, rc1 = p0.wait(timeout=600), p1.wait(timeout=600)
    f0.close(), f1.close()
    log0 = open(str(tmp_path / "p0.log")).read()
    assert rc0 == 0 and rc1 == 0, log0 + open(str(tmp_path / "p1.log")).read()
    assert "2 process(es), 8 global devices, B=16" in log0, log0

    ref_rows = _block_rows(str(tmp_path / "ref.log"))
    two_rows = _block_rows(str(tmp_path / "p0.log"))
    assert len(ref_rows) == len(two_rows) == 2
    # identical global computation, different sharding: per-replica
    # trajectories are deterministic, only the reduction order differs
    for r, t in zip(ref_rows, two_rows):
        np.testing.assert_allclose(r, t, rtol=1e-4, atol=1e-3)
