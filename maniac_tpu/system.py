"""SystemSpec (static) and SimState (dynamic pytree) construction.

Array-first data model, replacing the reference's global mutable module state
(reference: src/simulation_state.f90). All simulation state lives in two
objects:

* ``SystemSpec`` - frozen, trace-time constant arrays + hashable metadata:
  topology templates, LJ class tables, box, k-vectors, capacities.
* ``SimState`` - a flat pytree of arrays that every MC step maps to a new
  SimState. Rollback disappears: a rejected move just keeps the old state.

Layout: all molecules of all residue types live in ONE flat site array.
Residue type r occupies a contiguous region of ``cap_r * A_r`` site slots and
``cap_r`` molecule slots; active types get padded capacity so insertions are
in-place writes. A site "class" is the (residue type, atom slot) pair; LJ
parameters are dense class-pair tables, so the per-move energy pass is a
single masked dense computation with no per-type unrolling.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from scipy.special import erfc as erfc_np

from .constants import (ATM_TO_PA, A3_TO_M3, COULOMB_K, KB_JK, SMALL, SQRTPI)
from .ewald import EwaldSetup
from .io.deck import InputDeck
from .io.lammps_data import ParsedSystem

# energy component indices (internal unit: Kelvin)
E_RECIP, E_LJ, E_COUL, E_SELF, E_INTRA, E_TOT = range(6)
# counter indices: counters[0] = trials, counters[1] = accepts, per move type
N_MOVE_TYPES = 5
C_OVERFLOW = 0  # index into extras


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@partial(jax.tree_util.register_dataclass,
         data_fields=["H", "Hinv", "bounds", "box_diag", "volume",
                      "k_cart", "k_weights", "k_live", "ex_sel", "ey_sel",
                      "two_pi_Hinv",
                      "alpha", "cutoff", "temp_K",
                      "site_q", "site_cls", "site_type", "site_mol",
                      "site_midx",
                      "mol_type", "mol_midx", "mol_site_start",
                      "eps_cls", "sig_cls", "eps_site", "sig2_site",
                      "type_A", "type_cap", "type_site_base", "type_mol_base",
                      "type_active", "type_activity", "type_self_energy",
                      "type_template_off", "type_q_rows", "type_cls_rows",
                      "active_type_ids",
                      "p_cum", "image_shifts",
                      "res_type_site_base", "res_type_mol_base", "res_cap",
                      "res_H", "res_bounds_lo",
                      "c2_re", "c2_im",
                      "ex2_sel", "ey2_sel", "alpha2", "rcut2", "fw_d0",
                      "fw_amp_re", "fw_amp_im",
                      "tab_erfc", "tab_r6", "tab_r12", "tab_dx"],
         meta_fields=["R", "A_list", "cap_list", "active_list", "A_act",
                      "n_active", "S", "Mtot", "K", "box_kind", "is_triclinic",
                      "dtype_name", "has_reservoir", "res_cap_list",
                      "kmax_xyz", "amp_shape",
                      "fw_split", "S_frozen", "guest_base",
                      "kmax2_xyz", "amp2_shape",
                      "site_base_list",
                      "use_table", "gg_cut", "gg_rcut"])
@dataclass(frozen=True)
class SystemSpec:
    # box
    H: jnp.ndarray            # (3,3) cell vectors as columns
    Hinv: jnp.ndarray         # (3,3)
    bounds: jnp.ndarray       # (3,2)
    box_diag: jnp.ndarray     # (3,) diagonal lengths (ortho path)
    volume: jnp.ndarray       # scalar
    # ewald: DENSE half-space k-grid in a 2-D (JzP, JxyP) layout - rows are
    # signed jz (padded to 8), cols are jx*Jy + jy (padded to 128).
    # Invalid modes (outside the reference's normalized ellipsoid, the
    # origin, padding) carry weight 0, so amplitudes are a pure separable
    # outer product of per-axis phase tables: two static expansion matmuls
    # (ex_sel/ey_sel) + one (JzP, N)@(N, JxyP) contraction, with no
    # gathers, one-hots over a k-list, or reshapes anywhere (replaces the
    # reference's explicit k-vector list, src/ewald_kvectors.f90:44-87).
    k_cart: jnp.ndarray       # (K,3) cartesian k, flattened (0 rows = pad)
    k_weights: jnp.ndarray    # (JzP, JxyP) form * W(k); 0 invalid/pad
    k_live: jnp.ndarray       # (K,) 1.0 for real grid points, 0 for padding
    ex_sel: jnp.ndarray       # (Jx, JxyP) static 0/1 jx-expansion
    ey_sel: jnp.ndarray       # (Jy, JxyP) static 0/1 jy-expansion
    two_pi_Hinv: jnp.ndarray  # (3,3): theta = two_pi_Hinv @ r
    alpha: jnp.ndarray        # scalar
    cutoff: jnp.ndarray       # scalar
    temp_K: jnp.ndarray       # scalar
    # flat site tables (padded; pad entries have q=0, cls=C, type=R, mol=Mtot)
    site_q: jnp.ndarray       # (S,)
    site_cls: jnp.ndarray     # (S,) int32
    site_type: jnp.ndarray    # (S,) int32
    site_mol: jnp.ndarray     # (S,) int32 global molecule slot
    site_midx: jnp.ndarray    # (S,) int32 molecule index within its type
    # molecule tables
    mol_type: jnp.ndarray     # (Mtot,) int32
    mol_midx: jnp.ndarray     # (Mtot,) int32
    mol_site_start: jnp.ndarray  # (Mtot,) int32
    # LJ class tables, shape (C+1, C+1); row/col C are zero padding
    eps_cls: jnp.ndarray
    sig_cls: jnp.ndarray
    # class -> flat-site expansions (C+1, S): one contiguous row gather per
    # footprint atom replaces the two-level (class, class) gather in the
    # per-move pair pass; sig2_site stores sigma^2
    eps_site: jnp.ndarray
    sig2_site: jnp.ndarray
    # per-residue-type tables (length R, padded with 0 where needed)
    type_A: jnp.ndarray       # (R,) int32 atoms per molecule
    type_cap: jnp.ndarray     # (R,) int32 capacity
    type_site_base: jnp.ndarray  # (R,) int32
    type_mol_base: jnp.ndarray   # (R,) int32
    type_active: jnp.ndarray     # (R,) bool
    type_activity: jnp.ndarray   # (R,) fugacity converted to activity (1/A^3)
    type_self_energy: jnp.ndarray  # (R,) Ewald self energy per molecule (K)
    # (R, A_act, 3) rigid-geometry template per type: insertion source when no
    # reservoir is attached (fixes the reference's stale-slot insertion,
    # src/create_molecule.f90:188-195 - see DIVERGENCES.md)
    type_template_off: jnp.ndarray
    # (R, A_act) per-type site charges / LJ classes: every molecule of a
    # type shares them, so footprint charge/class lookups are one (R,)-row
    # pick instead of a dynamic slice (= gather) into the (S,) site arrays
    type_q_rows: jnp.ndarray
    type_cls_rows: jnp.ndarray     # int32
    active_type_ids: jnp.ndarray   # (n_active,) int32
    # move probability cumulative thresholds [trans, +rot, +indel, +swap]
    p_cum: jnp.ndarray        # (4,)
    image_shifts: jnp.ndarray  # (27,3) lattice image shifts (triclinic path)
    # reservoir layout (dummies when has_reservoir is False)
    res_type_site_base: jnp.ndarray  # (R,) int32
    res_type_mol_base: jnp.ndarray   # (R,) int32
    res_cap: jnp.ndarray             # (R,) int32
    res_H: jnp.ndarray               # (3,3)
    res_bounds_lo: jnp.ndarray       # (3,)
    # static-framework split tables (physics/fwsplit.py; inert dummies when
    # fw_split is False). The framework never moves, so its far-field
    # Coulomb response is a precomputed coefficient grid contracted against
    # footprint phase tables.
    c2_re: jnp.ndarray        # (Jz2P, Jxy2P) far-field coefficients (K)
    c2_im: jnp.ndarray
    ex2_sel: jnp.ndarray      # (Jx2, Jxy2P)
    ey2_sel: jnp.ndarray      # (Jy2, Jxy2P)
    alpha2: jnp.ndarray       # scalar short-range split parameter
    rcut2: jnp.ndarray        # scalar short-range cutoff
    fw_d0: jnp.ndarray        # k=0 far-field term per unit guest charge (K)
    fw_amp_re: jnp.ndarray    # (JzP, JxyP) constant framework amplitudes
    fw_amp_im: jnp.ndarray
    # Tabulated pair potentials (opt-in; reference src/tabulated_utils.f90).
    # (P+1,) uniform grids over [0, cutoff] with spacing tab_dx; lookups are
    # linearly interpolated and return 0 beyond the grid, which gives the
    # tabulated Coulomb an implicit real-space cutoff the direct path does
    # not have (reference LookupTabulated, src/tabulated_utils.f90:92-117).
    # Size-2 inert dummies when use_table is False.
    tab_erfc: jnp.ndarray     # erfc(alpha r)/r; f(0) = 2 alpha/sqrt(pi)
    tab_r6: jnp.ndarray       # r^6 (f(0) = 0)
    tab_r12: jnp.ndarray      # r^12 (f(0) = 0)
    tab_dx: jnp.ndarray       # scalar grid spacing
    # --- static metadata ---
    R: int
    A_list: tuple
    cap_list: tuple
    active_list: tuple        # per-type bool, python-static
    A_act: int                # max atoms over ACTIVE types (move footprint)
    n_active: int
    S: int
    Mtot: int
    K: int
    box_kind: int
    is_triclinic: bool
    dtype_name: str
    has_reservoir: bool
    res_cap_list: tuple
    kmax_xyz: tuple           # (kx, ky, kz)
    amp_shape: tuple          # (JzP, JxyP): 2-D dense-grid layout
    fw_split: bool            # static-framework split enabled
    S_frozen: int             # frozen-site prefix length (unaligned)
    guest_base: int           # first mutable site column (128-aligned)
    kmax2_xyz: tuple
    amp2_shape: tuple         # (Jz2P, Jxy2P)
    site_base_list: tuple     # static per-type site bases (128-aligned)
    use_table: bool           # tabulated pair potentials
    # guest<->guest honest Coulomb cutoff (DIVERGENCES.md #22): when
    # gg_cut, the real-space erfc(alpha r)/r between MOBILE sites is
    # truncated at gg_rcut = ERFC_DECAY/alpha (tail < 1e-6 kcal/mol).
    # Python floats: trace-time constants baked into the program.
    gg_cut: bool
    gg_rcut: float

    @property
    def dtype(self):
        return jnp.dtype(self.dtype_name)


@partial(jax.tree_util.register_dataclass,
         data_fields=["com", "pos", "n_mol", "amp_re", "amp_im",
                      "energy", "counters", "extras",
                      "trans_step", "rot_step", "key",
                      "res_com", "res_offset", "res_n"],
         meta_fields=[])
@dataclass
class SimState:
    com: jnp.ndarray          # (3, Mtot+1) transposed; last col = pad molecule
    # ABSOLUTE site positions, TRANSPOSED: (3, S). The reference stores COM +
    # per-site offsets (src/simulation_state.f90:115-116); storing absolute
    # positions makes the hot energy paths gather-free, and the (3, S)
    # layout keeps the site axis contiguous (the minor dimension) in every
    # elementwise pass. Offsets are derived as pos - com where needed.
    pos: jnp.ndarray
    n_mol: jnp.ndarray        # (R+1,) int32; last entry 0 (pad type)
    amp_re: jnp.ndarray       # (K,)
    amp_im: jnp.ndarray       # (K,)
    energy: jnp.ndarray       # (6,) Kelvin: recip, lj, coul, self, intra, tot
    counters: jnp.ndarray     # (2, 5) int32: [trials, accepts] x move type
    extras: jnp.ndarray       # (4,) int32: overflow rejections, ...
    trans_step: jnp.ndarray   # scalar
    rot_step: jnp.ndarray     # scalar
    key: jnp.ndarray          # PRNG key
    # reservoir (same flat layout, or size-0 arrays when absent)
    res_com: jnp.ndarray
    res_offset: jnp.ndarray
    res_n: jnp.ndarray

    def replace(self, **kw) -> "SimState":
        import dataclasses
        return dataclasses.replace(self, **kw)


def convert_fugacity(fugacity_atm: float, temp_K: float) -> float:
    """atm -> activity in A^-3 (reference: src/prepare_utils.f90:48-73)."""
    return fugacity_atm * ATM_TO_PA * A3_TO_M3 / (KB_JK * temp_K)


def _default_capacity(n_init: int, requested: int | None) -> int:
    if requested is not None:
        return max(requested, n_init)
    return max(_round_up(2 * n_init + 64, 64), 256)


def build_spec_and_state(deck: InputDeck, parsed: ParsedSystem,
                         eps, sig, ewald: EwaldSetup,
                         reservoir: ParsedSystem | None = None,
                         capacity: int | None = None,
                         dtype=jnp.float64) -> tuple[SystemSpec, SimState]:
    """Assemble the device-side system description from parsed inputs."""
    R = deck.n_residue_types
    A_list = tuple(int(r.nb_atoms) for r in deck.residues)
    active = [bool(r.active) for r in deck.residues]
    cap_list = tuple(
        _default_capacity(parsed.n_mol[r], capacity) if active[r]
        else max(parsed.n_mol[r], 1)
        for r in range(R))
    A_act = max((A_list[r] for r in range(R) if active[r]), default=1)

    Mtot = sum(cap_list)
    # per-type site regions are 128-aligned, so the mutable (guest) column
    # range starts on an aligned column (pad columns between types carry
    # the same inert values as the tail padding)
    base_list = []
    s_acc = 0
    for r in range(R):
        base_list.append(s_acc)
        s_acc = _round_up(s_acc + cap_list[r] * A_list[r], 128)
    S = _round_up(s_acc + A_act, 128)
    K = int(np.prod(ewald.grid2_shape))  # dense grid size (valid modes: see
    # ewald.num_kvectors, logged for parity with the reference)
    fdt = np.dtype(dtype)

    # ---- class tables -------------------------------------------------
    class_base = np.zeros(R + 1, dtype=np.int64)
    for r in range(R):
        class_base[r + 1] = class_base[r] + A_list[r]
    C = int(class_base[R])
    eps_cls = np.zeros((C + 1, C + 1))
    sig_cls = np.zeros((C + 1, C + 1))
    for i in range(R):
        for j in range(R):
            eps_cls[class_base[i]:class_base[i + 1],
                    class_base[j]:class_base[j + 1]] = eps[i][j]
            sig_cls[class_base[i]:class_base[i + 1],
                    class_base[j]:class_base[j + 1]] = sig[i][j]

    # ---- flat site / molecule tables ----------------------------------
    site_q = np.zeros(S)
    site_cls = np.full(S, C, dtype=np.int32)
    site_type = np.full(S, R, dtype=np.int32)
    site_mol = np.full(S, Mtot, dtype=np.int32)
    site_midx = np.full(S, 2**30, dtype=np.int32)
    mol_type = np.zeros(Mtot, dtype=np.int32)
    mol_midx = np.zeros(Mtot, dtype=np.int32)
    mol_site_start = np.zeros(Mtot, dtype=np.int32)
    type_site_base = np.zeros(R, dtype=np.int32)
    type_mol_base = np.zeros(R, dtype=np.int32)

    com0 = np.zeros((Mtot + 1, 3))
    offset0 = np.zeros((S, 3))

    m = 0
    for r in range(R):
        s = base_list[r]
        type_site_base[r] = s
        type_mol_base[r] = m
        A = A_list[r]
        q_template = parsed.atom_charges[r]
        for mi in range(cap_list[r]):
            mol_type[m] = r
            mol_midx[m] = mi
            mol_site_start[m] = s
            site_q[s:s + A] = q_template
            site_cls[s:s + A] = np.arange(class_base[r], class_base[r + 1])
            site_type[s:s + A] = r
            site_mol[s:s + A] = m
            site_midx[s:s + A] = mi
            if mi < parsed.n_mol[r]:
                com0[m] = parsed.mol_com[r][mi]
                offset0[s:s + A] = parsed.mol_com[r][mi] + parsed.site_offset[r][mi]
            m += 1
            s += A

    # ---- per-type constants --------------------------------------------
    temp_K = deck.temp_K
    activity = np.zeros(R)
    for r, res in enumerate(deck.residues):
        if res.active:
            activity[r] = convert_fugacity(res.fugacity, temp_K)
    self_e = np.zeros(R)
    for r in range(R):
        q = parsed.atom_charges[r]
        q = np.where(np.abs(q) < 1e-10, 0.0, q)
        self_e[r] = -ewald.alpha / SQRTPI * np.sum(q * q) * COULOMB_K

    # per-type charge / LJ-class rows for footprint lookups
    type_q_rows = np.zeros((R, A_act))
    type_cls_rows = np.full((R, A_act), C, dtype=np.int32)
    for r in range(R):
        A = min(A_list[r], A_act)
        type_q_rows[r, :A] = parsed.atom_charges[r][:A]
        type_cls_rows[r, :A] = np.arange(class_base[r], class_base[r] + A)

    # rigid-geometry insertion templates: first molecule of the initial
    # configuration, else first reservoir molecule; active multi-site types
    # with no geometry source anywhere get a collapsed (all-zero) template,
    # matching the information available to the reference
    template_off = np.zeros((R, A_act, 3))
    for r in range(R):
        A = min(A_list[r], A_act)
        if parsed.n_mol[r] > 0:
            template_off[r, :A] = parsed.site_offset[r][0][:A]
        elif reservoir is not None and reservoir.n_mol[r] > 0:
            template_off[r, :A] = reservoir.site_offset[r][0][:A]

    active_ids = np.asarray([r for r in range(R) if active[r]], dtype=np.int32)
    p = deck.proba
    p_cum = np.cumsum([p.translation, p.rotation, p.insertion_deletion, p.swap])

    box = parsed.box
    rng = np.array([-1.0, 0.0, 1.0])
    grid = np.stack(np.meshgrid(rng, rng, rng, indexing="ij"), -1).reshape(27, 3)
    image_shifts = grid @ box.matrix.T

    # ---- reservoir -------------------------------------------------------
    has_res = reservoir is not None
    res_cap_list = tuple(
        (_default_capacity(reservoir.n_mol[r], capacity) if active[r] else 1)
        for r in range(R)) if has_res else tuple(1 for _ in range(R))
    (res_com, res_offset, res_n, res_site_base,
     res_mol_base) = _build_reservoir_arrays(
        reservoir, A_list, res_cap_list, R, A_act)
    res_H = reservoir.box.matrix if has_res else box.matrix
    res_lo = reservoir.box.bounds[:, 0] if has_res else box.bounds[:, 0]

    # ---- class -> site expansions for the per-move pair pass ------------
    eps_site = eps_cls[:, site_cls]       # (C+1, S)
    sig_site = sig_cls[:, site_cls]
    sig2_site = sig_site * sig_site

    # ---- static-framework split (physics/fwsplit.py) --------------------
    import os
    mol_rad = 0.0
    for r in range(R):
        if not active[r]:
            continue
        A = A_list[r]
        mol_rad = max(mol_rad, float(np.max(
            np.linalg.norm(template_off[r, :A], axis=1), initial=0.0)))
        for src_sys in (parsed, reservoir):
            if src_sys is not None and src_sys.n_mol[r]:
                offs = np.asarray(src_sys.site_offset[r])
                mol_rad = max(mol_rad, float(
                    np.max(np.linalg.norm(offs, axis=-1))))
    fw_mode = getattr(deck, "framework_split", "auto")
    use_table = bool(getattr(deck, "use_table", False))
    if use_table:
        # Tables replace the direct pair math wholesale (reference
        # semantics, src/energy_utils.f90:209-252); the split's
        # erfc(alpha2 r) short form has no table, so the two are exclusive
        # (deck validation aborts on framework_split "on" + use_table).
        fw_mode = "off"
    env_fw = os.environ.get("MANIAC_FWSPLIT", "")
    if env_fw == "0":
        fw_mode = "off"
    elif env_fw == "1" and fw_mode == "auto":
        fw_mode = "on"
    from .physics.fwsplit import FwSplitSetup, build_fwsplit
    fws = build_fwsplit(
        box, float(ewald.alpha), float(ewald.real_space_cutoff),
        kmax_xyz=tuple(int(k) for k in ewald.kmax),
        amp_shape=tuple(ewald.grid2_shape),
        R=R, active_list=active, A_list=A_list, cap_list=cap_list,
        n_mol_init=parsed.n_mol, type_site_base=type_site_base,
        site_q=site_q, pos0=offset0,
        mol_radius=mol_rad,
        enabled=fw_mode,
        alpha2=getattr(deck, "fw_alpha2", 0.0),
        rcut2=getattr(deck, "fw_rcut2", 0.0))
    if fw_mode == "on" and not fws.enabled:
        raise ValueError(f"framework_split on but ineligible: {fws.reason}")

    # ---- guest<->guest honest Coulomb cutoff (DIVERGENCES.md #22) --------
    # The reference sums the damped real-space Coulomb erfc(alpha r)/r over
    # ALL pairs with no cutoff (src/energy_utils.f90:374-442). Beyond
    # r = ERFC_DECAY/alpha the kernel is below ~5e-10, so truncating there
    # changes the total by < 1e-6 kcal/mol while making the guest pair pass
    # short-ranged - the prerequisite for the slab-window layout (the
    # guest-side analog of the framework split). Default on; "off" (deck
    # `guest_split off` / MANIAC_GGSPLIT=0) restores exact reference
    # semantics. Tabulated mode has its own implicit cutoff (table
    # returns 0 beyond the grid), so the gate is redundant there.
    from .constants import ERFC_DECAY
    gg_mode = getattr(deck, "guest_split", "auto")
    env_gg = os.environ.get("MANIAC_GGSPLIT", "")
    if env_gg == "0":
        gg_mode = "off"
    elif env_gg == "1" and gg_mode == "auto":
        gg_mode = "on"
    gg_cut = gg_mode in ("auto", "on") and not use_table
    gg_rcut = float(getattr(deck, "gg_rcut", 0.0) or 0.0)
    if not gg_rcut:
        gg_rcut = ERFC_DECAY / float(ewald.alpha)
    if not fws.enabled:  # inert dummies keep the pytree shape cheap
        fws = FwSplitSetup(
            False, fws.reason,
            c2_re=np.zeros((8, 128)), c2_im=np.zeros((8, 128)),
            ex2_sel=np.zeros((1, 128)), ey2_sel=np.zeros((1, 128)),
            kmax2=(0, 0, 0), amp2_shape=(8, 128),
            amp_fw_re=np.zeros(ewald.grid2_shape),
            amp_fw_im=np.zeros(ewald.grid2_shape),
            guest_base=0, S_frozen=0)

    # ---- tabulated pair potentials (opt-in) ------------------------------
    # Uniform P+1-point grids over [0, cutoff], built in f64 exactly as the
    # reference does (src/tabulated_utils.f90:21-88): erfc(alpha r)/r with
    # the r=0 entry pinned to 2 alpha/sqrt(pi), and plain r^6 / r^12 with
    # 0 at r=0.
    if use_table:
        P = int(getattr(deck, "tabulated_points", 5000))
        tab_dx = float(ewald.real_space_cutoff) / P
        r_grid = np.arange(P + 1) * tab_dx
        with np.errstate(divide="ignore", invalid="ignore"):
            tab_erfc = np.where(
                r_grid < SMALL, 2.0 * ewald.alpha / SQRTPI,
                erfc_np(ewald.alpha * r_grid) / np.maximum(r_grid, 1e-300))
        tab_r6 = np.where(r_grid < SMALL, 0.0, r_grid ** 6)
        tab_r12 = np.where(r_grid < SMALL, 0.0, r_grid ** 12)
    else:
        tab_dx = 1.0
        tab_erfc = np.zeros(2)
        tab_r6 = np.zeros(2)
        tab_r12 = np.zeros(2)

    f = lambda x: jnp.asarray(x, dtype=fdt)
    spec = SystemSpec(
        H=f(box.matrix), Hinv=f(box.reciprocal), bounds=f(box.bounds),
        box_diag=f(np.diag(box.matrix)), volume=f(box.volume),
        k_cart=f(ewald.dense_cart), k_weights=f(ewald.dense_weights),
        k_live=f(ewald.dense_live),
        ex_sel=f(ewald.ex_sel), ey_sel=f(ewald.ey_sel),
        two_pi_Hinv=f(2.0 * np.pi * box.reciprocal),
        alpha=f(ewald.alpha),
        cutoff=f(ewald.real_space_cutoff), temp_K=f(temp_K),
        site_q=f(site_q), site_cls=jnp.asarray(site_cls),
        site_type=jnp.asarray(site_type), site_mol=jnp.asarray(site_mol),
        site_midx=jnp.asarray(site_midx),
        mol_type=jnp.asarray(mol_type), mol_midx=jnp.asarray(mol_midx),
        mol_site_start=jnp.asarray(mol_site_start),
        eps_cls=f(eps_cls), sig_cls=f(sig_cls),
        eps_site=f(eps_site), sig2_site=f(sig2_site),
        type_A=jnp.asarray(np.asarray(A_list), dtype=jnp.int32),
        type_cap=jnp.asarray(np.asarray(cap_list), dtype=jnp.int32),
        type_site_base=jnp.asarray(type_site_base),
        type_mol_base=jnp.asarray(type_mol_base),
        type_active=jnp.asarray(np.asarray(active)),
        type_activity=f(activity), type_self_energy=f(self_e),
        type_template_off=f(template_off),
        type_q_rows=f(type_q_rows),
        type_cls_rows=jnp.asarray(type_cls_rows),
        active_type_ids=jnp.asarray(active_ids),
        p_cum=f(p_cum), image_shifts=f(image_shifts),
        res_type_site_base=jnp.asarray(res_site_base),
        res_type_mol_base=jnp.asarray(res_mol_base),
        res_cap=jnp.asarray(np.asarray(res_cap_list), dtype=jnp.int32),
        res_H=f(res_H), res_bounds_lo=f(res_lo),
        c2_re=f(fws.c2_re), c2_im=f(fws.c2_im),
        ex2_sel=f(fws.ex2_sel), ey2_sel=f(fws.ey2_sel),
        alpha2=f(fws.alpha2), rcut2=f(fws.rcut2), fw_d0=f(fws.d0),
        fw_amp_re=f(fws.amp_fw_re), fw_amp_im=f(fws.amp_fw_im),
        tab_erfc=f(tab_erfc), tab_r6=f(tab_r6), tab_r12=f(tab_r12),
        tab_dx=f(tab_dx),
        R=R, A_list=A_list, cap_list=cap_list,
        active_list=tuple(active), A_act=A_act,
        n_active=len(active_ids), S=S, Mtot=Mtot, K=K,
        box_kind=box.kind, is_triclinic=box.is_triclinic,
        dtype_name=fdt.name, has_reservoir=has_res,
        res_cap_list=res_cap_list,
        kmax_xyz=tuple(int(k) for k in ewald.kmax),
        amp_shape=tuple(ewald.grid2_shape),
        fw_split=bool(fws.enabled), S_frozen=int(fws.S_frozen),
        guest_base=int(fws.guest_base),
        kmax2_xyz=tuple(fws.kmax2), amp2_shape=tuple(fws.amp2_shape),
        site_base_list=tuple(base_list),
        use_table=use_table, gg_cut=bool(gg_cut), gg_rcut=float(gg_rcut))

    n_mol0 = np.zeros(R + 1, dtype=np.int32)
    n_mol0[:R] = parsed.n_mol
    seed = deck.seed if deck.seed else 0
    state = SimState(
        com=f(com0.T), pos=f(offset0.T), n_mol=jnp.asarray(n_mol0),
        amp_re=jnp.zeros(ewald.grid2_shape, dtype=fdt),
        amp_im=jnp.zeros(ewald.grid2_shape, dtype=fdt),
        energy=jnp.zeros(6, dtype=fdt),
        counters=jnp.zeros((2, N_MOVE_TYPES), dtype=jnp.int32),
        extras=jnp.zeros(4, dtype=jnp.int32),
        trans_step=f(deck.translation_step), rot_step=f(deck.rotation_step_angle),
        key=jax.random.PRNGKey(seed),
        res_com=f(res_com), res_offset=f(res_offset),
        res_n=jnp.asarray(res_n))
    return spec, state


def _build_reservoir_arrays(reservoir: ParsedSystem | None, A_list,
                            res_cap_list, R, A_act):
    Mres = sum(res_cap_list)
    Sres = sum(res_cap_list[r] * A_list[r] for r in range(R)) + A_act
    com = np.zeros((Mres + 1, 3))
    off = np.zeros((Sres, 3))
    n = np.zeros(R + 1, dtype=np.int32)
    site_base = np.zeros(R, dtype=np.int32)
    mol_base = np.zeros(R, dtype=np.int32)
    s = 0
    m = 0
    for r in range(R):
        site_base[r] = s
        mol_base[r] = m
        A = A_list[r]
        for mi in range(res_cap_list[r]):
            if reservoir is not None and mi < reservoir.n_mol[r]:
                com[m] = reservoir.mol_com[r][mi]
                off[s:s + A] = reservoir.site_offset[r][mi]
            m += 1
            s += A
        if reservoir is not None:
            n[r] = reservoir.n_mol[r]
    return com, off, n, site_base, mol_base
