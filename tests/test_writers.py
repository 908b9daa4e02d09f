"""Output-file format contracts (reference: src/write_utils.f90).

The reference's CI greps these files (tests/integration/energy/*/run-test.sh
awks TotEng out of log.maniac); these tests pin the column/format contracts
including the divergences we chose (full 11-column moves.dat, actual block
numbers as trajectory timesteps - DIVERGENCES.md #3/#15)."""

import pytest

from maniac_tpu.cli import main as cli_main

from fixtures import make_water_box


@pytest.fixture(scope="module")
def _run(tmp_path_factory):
    """One shared CLI run: the four format-contract tests below parse
    different output files of the SAME run, so run it once (4 identical
    CLI runs also reproducibly tripped a jaxlib-0.9 CPU segfault in the
    4th identical XLA compile at the tail of a full-suite process)."""
    tmp_path = tmp_path_factory.mktemp("writers")
    d = make_water_box(str(tmp_path / "sys"), n_water=8, L=14.0, cutoff=5.0,
                       tol=1e-4, probs=(0.3, 0.3, 0.4, 0.0), fugacity=800.0,
                       nb_block=3, nb_step=40)
    out = str(tmp_path / "outputs")
    assert cli_main(["-i", f"{d}/input.maniac", "-d", f"{d}/topology.data",
                     "-p", f"{d}/parameters.inc", "-o", out,
                     "--platform", "cpu", "--dtype", "f64"]) == 0
    return out


def test_energy_dat_columns(_run):
    out = _run
    rows = [l.split() for l in open(f"{out}/energy.dat")
            if not l.startswith("#")]
    assert len(rows) == 4                      # block 0 + 3 blocks
    for r in rows:
        assert len(r) == 7                     # block + 6 components
        vals = list(map(float, r))
        # total == recip + lj + coul + self + intra (kcal/mol; the file
        # prints 6 decimals, so the identity holds to print precision)
        assert abs(vals[1] - sum(vals[2:7])) < 5e-6, r


def test_moves_dat_full_eleven_columns(_run):
    out = _run
    lines = open(f"{out}/moves.dat").read().splitlines()
    header = lines[0]
    for col in ("Trial_Trans", "Trans_Moves", "Trial_Create", "Create_Moves",
                "Trial_Delete", "Delete_Moves", "Trial_Rotate",
                "Rotate_Moves", "Trial_Swap", "Swap_Moves"):
        assert col in header
    rows = [l.split() for l in lines[1:] if l.strip()]
    assert all(len(r) == 11 for r in rows)
    last = list(map(int, rows[-1]))
    # counters are cumulative and monotone; accepted <= trials per type
    for t_col, a_col in ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10)):
        assert last[a_col] <= last[t_col]
    assert last[1] + last[3] + last[5] + last[7] + last[9] > 0


def test_trajectory_timesteps_and_counts(_run):
    out = _run
    text = open(f"{out}/trajectory.lammpstrj").read().splitlines()
    steps = [int(text[i + 1]) for i, l in enumerate(text)
             if l.startswith("ITEM: TIMESTEP")]
    assert steps == [0, 1, 2, 3]   # actual block ids (DIVERGENCES.md #15)
    counts = [int(text[i + 1]) for i, l in enumerate(text)
              if l.startswith("ITEM: NUMBER OF ATOMS")]
    n_rows = [l for l in text if l.startswith("ITEM: ATOMS")]
    assert len(counts) == 4 and len(n_rows) == 4
    # atom counts match the number_<RES>.dat series (4 sites per water)
    series = [int(l.split()[1]) for l in open(f"{out}/number_wat.dat")
              if not l.startswith("#")]
    assert counts == [4 * n for n in series]


def test_log_status_rows_parse(_run):
    out = _run
    log = open(f"{out}/log.maniac").read().splitlines()
    idx = [i for i, l in enumerate(log) if "TotEng" in l]
    assert len(idx) >= 3
    for i in idx[:3]:
        fields = log[i + 1].split()
        int(fields[0])                      # Step
        for f in fields[1:5]:
            float(f)                        # TotEng E_vdwl E_coul E_long


def test_f32_energy_rows_exact(tmp_path):
    """f32 runs must report EXACT energies every block like the
    reference (src/write_utils.f90:94-188), not the wandering f32 running
    totals (DIVERGENCES.md #13): the final energy.dat row must match a
    from-scratch f64 recompute of the written restart configuration."""
    import jax.numpy as jnp

    from maniac_tpu import load_system
    from maniac_tpu.constants import KB_KCALMOL
    from maniac_tpu.system import E_TOT

    d = make_water_box(str(tmp_path / "sys"), n_water=8, L=14.0, cutoff=5.0,
                       tol=1e-4, probs=(0.3, 0.2, 0.5, 0.0), fugacity=8000.0,
                       nb_block=3, nb_step=120)
    out = str(tmp_path / "outputs")
    assert cli_main(["-i", f"{d}/input.maniac", "-d", f"{d}/topology.data",
                     "-p", f"{d}/parameters.inc", "-o", out,
                     "--platform", "cpu", "--dtype", "f32"]) == 0
    rows = [list(map(float, l.split())) for l in open(f"{out}/energy.dat")
            if not l.startswith("#")]
    last_tot = rows[-1][1]
    # topology.data is the final configuration; recompute its energy in f64
    sys2 = load_system(f"{d}/input.maniac", f"{out}/topology.data",
                       f"{d}/parameters.inc", dtype=jnp.float64)
    e_fresh = float(sys2.state.energy[E_TOT]) * KB_KCALMOL
    # restart file prints 10-decimal positions; f32 recompute noise ~1e-3
    assert abs(last_tot - e_fresh) < 5e-3, (last_tot, e_fresh)
