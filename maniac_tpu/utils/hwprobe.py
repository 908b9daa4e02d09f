"""Hardware matmul-precision evidence, importable (chip_smoke.py runs it on
the card; tools/precision_probe.py is the standalone CLI).

The CPU test suite is blind to a whole class of accelerator-only
corruption: a matmul that rounds its f32 inputs (TF32 on NVIDIA tensor
cores keeps 10 mantissa bits) quantizes POSITIONS, because this engine
reads and writes them through dots (one-hot footprint reads, expansions,
phase contractions; CLAUDE.md invariant #3). maniac_tpu/__init__.py pins
jax_default_matmul_precision="highest"; these probes verify, on the
device actually executing, that the pin is intact:

stage 1  one-hot reads through an XLA dot must be EXACT under the
         engine's import-time config. Detects the global pin being lost.
stage 2  rigid molecules must stay rigid on the default path: a short
         SPC/E NVT block sequence, then max |d(O-H)| must sit at f32
         rounding scale (~1e-6 A random walk). Detects a lower-precision
         dot injected anywhere positions flow.
"""

from __future__ import annotations

import tempfile

#: stage 2 bound on max |d(O-H)| - 1 A| (A): f32 rounding random-walks
#: at ~1e-6; a reduced-precision product deforms by 1e-3..1e-1
RIGID_TOL = 1e-4


def probe_onehot_exact() -> tuple[bool, float]:
    """Stage 1: one-hot matmul reads must be bit-exact. Returns
    (ok, max abs error)."""
    import maniac_tpu  # noqa: F401  (applies the engine's precision pin)
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.default_rng(0)
    x = rng.uniform(-20, 20, (8, 256)).astype(np.float32)
    oh = np.zeros((256, 8), np.float32)
    for j in range(8):
        oh[100 + j, j] = 1.0
    want = np.stack([x[:, 100 + j] for j in range(8)], 1).astype(np.float64)

    got = np.asarray(jnp.dot(jnp.asarray(x), jnp.asarray(oh),
                             preferred_element_type=jnp.float32), np.float64)
    err = float(np.abs(got - want).max())
    return err == 0.0, err


def probe_rigid_geometry(blocks: int = 8, replicas: int = 8,
                         steps: int = 2000) -> tuple[bool, float]:
    """Stage 2: rigid-geometry drift after f32 NVT blocks. Returns
    (ok, max |d(O-H)| deviation in A)."""
    import jax.numpy as jnp
    import numpy as np

    from .. import load_system
    from ..parallel.replicas import replicate, run_block_replicated
    from ..systems import make_spce_box

    with tempfile.TemporaryDirectory() as tmp:
        make_spce_box(tmp, n_water=64, density=0.997, temp=298.0,
                      cutoff=6.0, tol=1e-5, probs=(0.5, 0.5, 0.0, 0.0),
                      tstep=0.25, rstep=0.4, recal=True, seed=20260820)
        sysm = load_system(f"{tmp}/input.maniac", f"{tmp}/topology.data",
                           f"{tmp}/parameters.inc", dtype=jnp.float32,
                           capacity=96)
    spec, state = sysm.spec, sysm.state
    states = replicate(spec, state, replicas)
    for _ in range(blocks):
        states = run_block_replicated(spec, states, steps, True)
    pos = np.asarray(states.pos, np.float64)                # (B, 3, S)
    n = int(np.asarray(states.n_mol)[:, 0].min())
    oh = pos[:, :, [3 * m + h for m in range(n) for h in (1, 2)]]
    oo = pos[:, :, [3 * m for m in range(n) for _ in (1, 2)]]
    dev = float(np.abs(np.linalg.norm(oh - oo, axis=1) - 1.0).max())
    return dev < RIGID_TOL, dev
