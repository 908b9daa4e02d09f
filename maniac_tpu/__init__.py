"""maniac-tpu: a grand-canonical Monte Carlo framework in JAX.

A from-scratch rebuild of the capabilities of maniac-mc/maniac-mc (serial
Fortran-90 GCMC): LAMMPS-style topology input, lj/cut/coul/long interactions
with full Ewald summation, and Metropolis translation / rotation / insertion
/ deletion / swap moves over rigid molecules - redesigned as pure functional
state transitions over fixed-capacity padded arrays, scanned and vmapped on
device.
"""

# single-source version: the VERSION file at the repo root (analog of the
# reference's version.txt + docs templating, /root/reference/version.txt,
# docs/source/conf.py release=). Falls back if the package is used
# detached from its checkout.
import os as _os

try:
    with open(_os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), "VERSION")) as _f:
        __version__ = _f.read().strip()
except OSError:  # pragma: no cover - detached install
    __version__ = "0.5.0"

import jax as _jax

# This engine moves POSITIONS through matmuls (footprint one-hot reads,
# per-replica expansions, phase/energy contractions; CLAUDE.md invariant
# #3). A reduced-precision product - TF32 on NVIDIA tensor cores rounds
# f32 inputs to 10 mantissa bits - quantizes the geometry itself: every
# accepted rotation re-reads sites through a dot and rewrites them, so
# rigid molecules deform a little on every accept. "highest" gives true
# f32 products on every backend; the hardware check is
# maniac_tpu/utils/hwprobe.py stage 1 (one-hot reads must be exact) and
# stage 2 (rigid O-H distances must hold). Never pass an explicit lower
# precision to a dot that touches positions or energies.
_jax.config.update("jax_default_matmul_precision", "highest")

from .api import LoadedSystem, load_system                     # noqa: F401
from .system import SimState, SystemSpec                       # noqa: F401
from .mc.driver import drift_report, initialize_state, run_block  # noqa: F401
