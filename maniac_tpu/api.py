"""High-level loading API: files -> (SystemSpec, SimState).

Mirrors the reference's startup sequence (reference: src/main.f90:15-27):
ReadInput -> ReadSystemData -> ReadParameters -> PrepareSimulationParameters
-> ComputeSystemEnergy.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp

from .ewald import EwaldSetup, log_ewald_parameters, setup_ewald
from .io.deck import InputDeck, log_input_summary, parse_deck
from .io.lammps_data import ParsedSystem, parse_lammps_data
from .io.pair_coeffs import parse_pair_coeffs
from .mc.driver import resync
from .system import SimState, SystemSpec, build_spec_and_state
from .utils.logger import Logger, default_logger


@dataclass
class LoadedSystem:
    deck: InputDeck
    parsed: ParsedSystem
    reservoir: ParsedSystem | None
    ewald: EwaldSetup
    spec: SystemSpec
    state: SimState


def load_system(input_file: str, data_file: str, params_file: str,
                reservoir_file: str | None = None,
                capacity: int | None = None,
                dtype=jnp.float64,
                logger: Logger | None = None,
                compute_initial_energy: bool = True,
                seed: int | None = None) -> LoadedSystem:
    logger = logger or default_logger()

    deck = parse_deck(input_file, logger)
    if seed is not None:
        deck.seed = seed
    log_input_summary(deck, input_file, logger)

    parsed = parse_lammps_data(data_file, deck, logger, is_primary=True)
    _log_data_summary(parsed, data_file, deck, logger)
    reservoir = None
    if reservoir_file:
        reservoir = parse_lammps_data(reservoir_file, deck, logger,
                                      is_primary=False)
        _check_consistency(parsed, reservoir, logger)

    eps, sig = parse_pair_coeffs(params_file, parsed, logger)

    ewald = setup_ewald(parsed.box, deck.real_space_cutoff,
                        deck.ewald_tolerance, logger,
                        alpha_override=deck.ewald_alpha)
    log_ewald_parameters(ewald, logger)

    spec, state = build_spec_and_state(deck, parsed, eps, sig, ewald,
                                       reservoir=reservoir,
                                       capacity=capacity, dtype=dtype)
    if compute_initial_energy:
        state = resync(spec, state)
    return LoadedSystem(deck=deck, parsed=parsed, reservoir=reservoir,
                        ewald=ewald, spec=spec, state=state)


def _log_data_summary(parsed: ParsedSystem, path: str, deck: InputDeck,
                      logger: Logger) -> None:
    logger.log("")
    logger.log("====== Import data file ======")
    logger.log(f"Reading file {path}")
    logger.log("")
    logger.log(f"Number of atoms: {parsed.num_atoms}")
    logger.log(f"Number of type of residues: {deck.n_residue_types}")
    logger.log(f"Number of type of atoms: {parsed.num_atomtypes}")
    for r, res in enumerate(deck.residues):
        if parsed.n_mol[r]:
            kind = "Active" if res.active else "Inactive"
            logger.log(f"{kind} residue {res.name} found in the data file: "
                       f"{parsed.n_mol[r]}")
    logger.log("")
    logger.log("Simulation box (rows):")
    H = parsed.box.matrix
    for i in range(3):
        logger.log(f"{H[i, 0]:12.6f}{H[i, 1]:12.6f}{H[i, 2]:12.6f}")
    logger.log("")
    logger.log(f"Cell volume (A^3): {parsed.box.volume:20.4f}")


def _check_consistency(primary: ParsedSystem, reservoir: ParsedSystem,
                       logger: Logger) -> None:
    """Warn on primary-vs-reservoir mass mismatches
    (reference: src/check_utils.f90:57-88)."""
    import numpy as np
    for r in range(len(primary.atom_masses)):
        a = primary.atom_masses[r]
        b = reservoir.atom_masses[r]
        if a.shape == b.shape and np.any(np.abs(a - b) > 1e-6):
            logger.warn("Reservoir and system mass don't match.")
