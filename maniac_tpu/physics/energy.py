"""Jittable energy engine: LJ + real-space Ewald + reciprocal + corrections.

Physics matches the reference exactly (see per-function citations); the
implementation is masked dense array math over the flat site layout so the
same code path serves single moves, full-system audits, vmapped replicas and
sharded meshes.

Semantics preserved from the reference:
* LJ has a hard real-space cutoff; the damped Coulomb erfc(alpha r)/r term is
  summed over ALL pairs with no cutoff (reference quirk, both in
  src/energy_utils.f90:225-255 CoulombEnergy and :374-442 single-mol path).
* Intramolecular correction (erfc(alpha r)-1)/r applies only to ACTIVE
  residue types (reference: src/energy_utils.f90:55-81).
* Self energy: -alpha/sqrt(pi) sum(q^2) per molecule, all types
  (reference: src/energy_utils.f90:307-368).
* Reciprocal: E = C * 2*pi/V * sum_k f_k W_k |A(k)|^2 over the half-space
  k-list with symmetry form factors (reference: src/ewald_energy.f90:105-147).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import erfc

from ..constants import COULOMB_K, SMALL, TWOPI
from ..system import E_COUL, E_INTRA, E_LJ, E_RECIP, E_SELF, E_TOT, SystemSpec
from .pbc import min_image_dist2

_R2_FLOOR = 1e-18


def site_positions(spec: SystemSpec, state) -> jnp.ndarray:
    """Absolute site positions (S,3). The state stores them transposed
    (3,S) for lane efficiency (see SimState.pos); cold paths (full
    recompute, resync, audits) go through this transpose, the hot step
    reads state.pos directly."""
    return state.pos.T


def active_site_mask(spec: SystemSpec, n_mol) -> jnp.ndarray:
    """(S,) bool: site belongs to an existing molecule (pad rows excluded)."""
    return spec.site_midx < n_mol[spec.site_type]


def tab_lookup(table, dx, r):
    """Linear interpolation with the reference's LookupTabulated semantics
    (src/tabulated_utils.f90:92-117): r <= 0 returns f[0], r beyond the
    grid returns 0, otherwise lerp between the bracketing grid points.

    The per-pair table gather is kept for reference parity, not speed:
    the direct formulas are cheaper on every backend."""
    n = table.shape[0] - 1
    x = r / dx
    i = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, n - 1)
    t = x - i.astype(r.dtype)
    f1 = jnp.take(table, i, axis=0)
    f2 = jnp.take(table, i + 1, axis=0)
    val = (1.0 - t) * f1 + t * f2
    val = jnp.where(r >= n * dx, jnp.zeros_like(val), val)
    return jnp.where(r <= 0.0, table[0], val)


def _tab_lj(spec: SystemSpec, eps, sig2, r):
    """Tabulated LJ: sigma^6 / interp(r^6) and sigma^12 / interp(r^12)
    (reference LennardJonesEnergy, src/energy_utils.f90:190-219). The
    interpolated denominators are floored to dodge the r ~ 0 pole on
    masked/padded pairs (the reference never evaluates those)."""
    sig6 = sig2 * sig2 * sig2
    den6 = jnp.maximum(tab_lookup(spec.tab_r6, spec.tab_dx, r), _R2_FLOOR)
    den12 = jnp.maximum(tab_lookup(spec.tab_r12, spec.tab_dx, r), _R2_FLOOR)
    return 4.0 * eps * (sig6 * sig6 / den12 - sig6 / den6)


def pair_energy_footprint(spec: SystemSpec, others_pos, others_mask,
                          mov_pos, mov_q, mov_cls, mov_mask,
                          exclude_mol_a, exclude_mol_b):
    """LJ + real-space Coulomb of footprint molecules vs all other sites.

    mov_pos: (B, A, 3); mov_q/mov_cls/mov_mask: (B, A). Returns
    (e_lj[B], e_coul[B]) in Kelvin. Pairs with sites whose molecule slot is
    exclude_mol_a or exclude_mol_b are skipped (self-molecule exclusion, and
    the removed molecule during swap moves).

    Mirrors ComputePairInteractionEnergy_singlemol
    (reference: src/energy_utils.f90:374-442).
    """
    delta = others_pos[None, None, :, :] - mov_pos[:, :, None, :]  # (B,A,S,3)
    r2 = min_image_dist2(delta, spec)                              # (B,A,S)
    r2 = jnp.maximum(r2, _R2_FLOOR)

    keep = (others_mask
            & (spec.site_mol != exclude_mol_a)
            & (spec.site_mol != exclude_mol_b))                    # (S,)
    mask = keep[None, None, :] & mov_mask[:, :, None]              # (B,A,S)

    # LJ (cutoff applies); class->site tables give one contiguous row gather
    # per footprint atom instead of a (class,class) double gather
    eps = jnp.take(spec.eps_site, mov_cls, axis=0)                 # (B,A,S)
    sig2 = jnp.take(spec.sig2_site, mov_cls, axis=0)
    inv_r2 = 1.0 / r2
    inv_r = jnp.sqrt(inv_r2)
    r = r2 * inv_r
    if spec.use_table:
        lj = _tab_lj(spec, eps, sig2, r)
    else:
        sr2 = sig2 * inv_r2
        sr6 = sr2 * sr2 * sr2
        lj = 4.0 * eps * (sr6 * sr6 - sr6)
    lj_mask = mask & (r2 < spec.cutoff * spec.cutoff)
    e_lj = jnp.sum(jnp.where(lj_mask, lj, 0.0), axis=(1, 2))

    # damped Coulomb (no cutoff vs mobile sites; reference quirk). With the
    # static-framework split (physics/fwsplit.py) frozen columns instead get
    # the short-ranged erfc(alpha2 r)/r (cut at rcut2) and the far-field
    # grid term D(r) per footprint atom - same total to the measured split
    # accuracy, identical in the per-move and full-recompute paths.
    qq = mov_q[:, :, None] * spec.site_q[None, None, :]
    if spec.use_table:
        # tabulated mode: the table returns 0 beyond the grid, so Coulomb
        # inherits an implicit cutoff at real_space_cutoff (reference
        # CoulombEnergy via LookupTabulated, src/energy_utils.f90:246-252)
        coul = qq * tab_lookup(spec.tab_erfc, spec.tab_dx, r)
        e_coul = jnp.sum(jnp.where(mask, coul, 0.0), axis=(1, 2)) * COULOMB_K
        return e_lj, e_coul
    # guest<->guest honest cutoff (DIVERGENCES.md #22): the mobile-pair
    # damped term is < 5e-10 beyond gg_rcut = ERFC_DECAY/alpha, so the
    # gate changes the total by < 1e-6 kcal/mol while making the guest
    # pass short-ranged (prerequisite of the slab windows)
    def gg_gate(coul_a):
        if not spec.gg_cut:
            return coul_a
        return coul_a * (r2 < spec.gg_rcut * spec.gg_rcut)

    if spec.fw_split:
        frozen = (jnp.arange(spec.S) < spec.S_frozen)[None, None, :]
        coul_short = (qq * erfc(spec.alpha2 * r) * inv_r
                      * (r2 < spec.rcut2 * spec.rcut2))
        coul = jnp.where(frozen, coul_short,
                         gg_gate(qq * erfc(spec.alpha * r) * inv_r))
        e_coul = jnp.sum(jnp.where(mask, coul, 0.0), axis=(1, 2))
        w = mov_q * mov_mask
        e_far = jax.vmap(lambda p, wb: fw_far_energy(spec, p, wb))(
            mov_pos, w.astype(mov_pos.dtype))
        e_coul = e_coul * COULOMB_K + e_far
    else:
        coul = gg_gate(qq * erfc(spec.alpha * r) * inv_r)
        e_coul = jnp.sum(jnp.where(mask, coul, 0.0), axis=(1, 2)) * COULOMB_K
    return e_lj, e_coul


def intra_energy(spec: SystemSpec, pos, q, mask):
    """Intramolecular Ewald correction sum_{i<j} q_i q_j (erfc(a r)-1)/r.

    pos: (..., A, 3). Reference:
    ComputeIntraResidueRealCoulombEnergySingleMol
    (src/ewald_energy.f90:371-411); uses minimum-image distances.
    """
    delta = pos[..., None, :, :] - pos[..., :, None, :]            # (...,A,A,3)
    r2 = jnp.maximum(min_image_dist2(delta, spec), _R2_FLOOR)
    r = jnp.sqrt(r2)
    qq = q[..., None, :] * q[..., :, None]
    pair_mask = mask[..., None, :] & mask[..., :, None]
    A = pos.shape[-2]
    iu = jnp.triu(jnp.ones((A, A), bool), k=1)
    pair_mask = pair_mask & iu & (r2 > SMALL * SMALL)
    e = qq * (erfc(spec.alpha * r) - 1.0) / r
    return jnp.sum(jnp.where(pair_mask, e, 0.0), axis=(-1, -2)) * COULOMB_K


def footprint_phases(spec: SystemSpec, pos):
    """theta(k) = k . r for footprint positions; pos (..., A, 3) -> (..., A, K).

    One matmul replaces the reference's cached per-atom 1-D phase-factor
    tables and their save/restore copies (src/ewald_phase.f90:90-183)."""
    return pos @ spec.k_cart.T


def amp_delta_direct(spec: SystemSpec, pos, q, mask, signs):
    """Reference-style direct structure-factor update: cos/sin over the full
    (A, K) phase matrix. Kept as the precision oracle for amp_delta.
    Padding entries of the dense grid (k_live == 0) are zeroed to match
    the separable path; returns (JzP, JxyP) arrays."""
    theta = footprint_phases(spec, pos)                  # (B,A,K)
    w = (q * mask) [..., None] * signs[:, None, None]    # (B,A,1)
    d_re = jnp.sum(w * jnp.cos(theta), axis=(0, 1)) * spec.k_live
    d_im = jnp.sum(w * jnp.sin(theta), axis=(0, 1)) * spec.k_live
    return d_re.reshape(spec.amp_shape), d_im.reshape(spec.amp_shape)


def _axis_phase_tables(spec: SystemSpec, theta, kmax_xyz=None):
    """Per-axis complex phase power tables over the dense-grid index ranges.

    theta: (N, 3) phase angles 2*pi*frac(r). Returns
    ((px_re, px_im), (py_re, py_im), (pz_re, pz_im)) with shapes
    (N, kx+1), (N, 2ky+1), (N, 2kz+1); the signed y/z tables run jy=-ky..ky
    in dense-grid order (negative j = complex conjugate of |j|).

    One cos/sin per atom per axis; powers by repeated complex multiply
    (the reference caches equivalent tables per molecule slot and copies
    them for rollback, src/ewald_phase.f90:90-183 - we recompute)."""
    kx, ky, kz = kmax_xyz if kmax_xyz is not None else spec.kmax_xyz
    kmax = max(kx, ky, kz)
    c1, s1 = jnp.cos(theta), jnp.sin(theta)               # (N, 3)

    res = [jnp.ones_like(c1)]
    ims = [jnp.zeros_like(s1)]
    for _ in range(kmax):
        re, im = res[-1], ims[-1]
        res.append(re * c1 - im * s1)
        ims.append(re * s1 + im * c1)

    def signed(ax, k):
        pos_re = [res[j][:, ax] for j in range(k + 1)]
        pos_im = [ims[j][:, ax] for j in range(k + 1)]
        neg_re = [res[j][:, ax] for j in range(k, 0, -1)]
        neg_im = [-ims[j][:, ax] for j in range(k, 0, -1)]
        return (jnp.stack(neg_re + pos_re, axis=1),
                jnp.stack(neg_im + pos_im, axis=1))

    px = (jnp.stack([res[j][:, 0] for j in range(kx + 1)], axis=1),
          jnp.stack([ims[j][:, 0] for j in range(kx + 1)], axis=1))
    return px, signed(1, ky), signed(2, kz)


def _separable_amp(spec: SystemSpec, theta, w, grid=None):
    """A[jz, jxy] = sum_n w_n e^{i(jx tx + jy ty + jz tz)} on the 2-D dense
    grid (JzP, JxyP). theta: (N,3), w: (N,). Two static expansion matmuls
    plus one (JzP, N)@(N, JxyP) contraction - no gathers, no one-hot
    k-selectors, no (N, K) transcendentals, and no reshapes or transposed
    layouts anywhere.

    grid: optional (kmax_xyz, ex_sel, ey_sel, JzP) overriding the main
    k-grid - used for the static-framework far-field grid (fwsplit)."""
    if grid is None:
        grid = (spec.kmax_xyz, spec.ex_sel, spec.ey_sel, spec.amp_shape[0])
    kmax_xyz, ex_sel, ey_sel, JzP = grid
    (px_re, px_im), (py_re, py_im), (pz_re, pz_im) = \
        _axis_phase_tables(spec, theta, kmax_xyz)
    px_re = px_re * w[:, None]
    px_im = px_im * w[:, None]
    xe_re = px_re @ ex_sel                                 # (N, JxyP)
    xe_im = px_im @ ex_sel
    ye_re = py_re @ ey_sel
    ye_im = py_im @ ey_sel
    t_re = xe_re * ye_re - xe_im * ye_im
    t_im = xe_re * ye_im + xe_im * ye_re
    pad = JzP - pz_re.shape[1]
    pzT_re = jnp.pad(pz_re, ((0, 0), (0, pad))).T          # (JzP, N)
    pzT_im = jnp.pad(pz_im, ((0, 0), (0, pad))).T
    d_re = pzT_re @ t_re - pzT_im @ t_im                   # (JzP, JxyP)
    d_im = pzT_re @ t_im + pzT_im @ t_re
    return d_re, d_im


def fw_far_energy(spec: SystemSpec, pos, w):
    """Static-framework far-field Coulomb energy sum_i w_i D(r_i) in Kelvin
    (physics/fwsplit.py): contract the guest phase amplitude on the alpha2
    grid against the precomputed framework coefficient grid. pos: (N, 3),
    w: (N,) charge * mask weights."""
    grid2 = (spec.kmax2_xyz, spec.ex2_sel, spec.ey2_sel, spec.amp2_shape[0])
    theta = pos @ spec.two_pi_Hinv.T
    d_re, d_im = _separable_amp(spec, theta, w, grid=grid2)
    return (jnp.sum(spec.c2_re * d_re + spec.c2_im * d_im)
            + spec.fw_d0 * jnp.sum(w))


def amp_delta(spec: SystemSpec, pos, q, mask, signs):
    """Structure-factor update dA(k) = sum_b s_b sum_a q e^{i k.r_ba}.

    pos: (B,A,3), q/mask: (B,A), signs: (B,) in {-1,0,+1}. Returns
    (d_re, d_im) shaped (JzP, JxyP) on the dense grid. Same update as the
    reference's
    incremental A(k) (ComputeRecipEnergySingleMol,
    src/ewald_energy.f90:240-256) with its deletion branch fixed (the
    reference passes is_creation for deletions,
    src/monte_carlo_utils.f90:308 - a sign/identity bug we do not
    replicate).

    Separable evaluation: the phase factor is separable, so the dense-grid
    delta is an outer product of per-axis power tables contracted over the
    footprint atoms - O(A * Jx*Jy*Jz) matmul FLOPs, ~6 transcendentals per
    atom, zero k-list gathers (see _separable_amp)."""
    B, A = q.shape
    theta = (pos @ spec.two_pi_Hinv.T).reshape(B * A, 3)
    w = ((q * mask) * signs[:, None]).reshape(B * A)
    return _separable_amp(spec, theta, w)


def recip_energy(spec: SystemSpec, amp_re, amp_im):
    """E_recip = C * 2*pi/V * sum_k f_k W_k |A_k|^2 (Kelvin); the form
    factor is folded into k_weights (invalid dense modes carry weight 0)."""
    amp2 = amp_re * amp_re + amp_im * amp_im
    return (jnp.sum(spec.k_weights * amp2)
            * COULOMB_K * TWOPI / spec.volume)


def recip_energy_delta(spec: SystemSpec, amp_re, amp_im, d_re, d_im):
    """E_recip(A + d) - E_recip(A) without re-summing |A|^2:
    sum_k w_k (2 A.d + |d|^2), scaled."""
    cross = (2.0 * (amp_re * d_re + amp_im * d_im)
             + d_re * d_re + d_im * d_im)
    return (jnp.sum(spec.k_weights * cross)
            * COULOMB_K * TWOPI / spec.volume)


# ---------------------------------------------------------------------------
# full-system recompute (startup + drift audits)
# ---------------------------------------------------------------------------

def _chunk_for(S: int) -> int:
    """Site-axis chunk for full recomputes: the largest multiple of 8 up
    to 1024 that divides S. Bigger chunks = fewer, larger contractions in
    full_amplitudes (and larger (chunk, JxyP) temporaries); the chunk is
    a contraction dimension so any divisor works."""
    best = 8
    for c in range(8, 1025, 8):
        if S % c == 0:
            best = c
    return best


def full_amplitudes(spec: SystemSpec, pos, active):
    """A(k) = sum_s q_s e^{i k.r_s} over all active sites on the dense grid,
    chunked over S (separable per-axis tables + one contraction per chunk -
    no (S, K) phase matrix is ever materialized).

    With the static-framework split the frozen prefix contributes a
    CONSTANT amplitude (spec.fw_amp_re/_im, synthesized once in f64 at
    setup); only the mutable guest columns are re-synthesized here."""
    if spec.fw_split:
        lo, S = spec.guest_base, spec.S
        init = (spec.fw_amp_re.astype(pos.dtype),
                spec.fw_amp_im.astype(pos.dtype))
    else:
        lo, S = 0, spec.S
        init = (jnp.zeros(spec.amp_shape, dtype=pos.dtype),
                jnp.zeros(spec.amp_shape, dtype=pos.dtype))
    n = S - lo
    qm = jnp.where(active[lo:], spec.site_q[lo:], 0.0)
    theta = pos[lo:] @ spec.two_pi_Hinv.T               # (n, 3)
    chunk = _chunk_for(n)
    theta_c = theta.reshape(n // chunk, chunk, 3)
    q_c = qm.reshape(n // chunk, chunk)

    def body(carry, xs):
        re, im = carry
        t, q = xs
        d_re, d_im = _separable_amp(spec, t, q)
        return (re + d_re, im + d_im), None

    (re, im), _ = jax.lax.scan(body, init, (theta_c, q_c))
    return re, im


def full_pair_energy(spec: SystemSpec, pos, active):
    """Total LJ + real-space Coulomb over unordered inter-molecular pairs,
    chunked over rows (reference: ComputePairwiseEnergy,
    src/energy_utils.f90:83-187)."""
    S = spec.S
    chunk = _chunk_for(S)
    pos_c = pos.reshape(S // chunk, chunk, 3)

    idx = jnp.arange(spec.S).reshape(S // chunk, chunk)

    def body(carry, xs):
        e_lj, e_c = carry
        p_chunk, i_chunk = xs
        delta = pos[None, :, :] - p_chunk[:, None, :]   # (chunk, S, 3)
        r2 = jnp.maximum(min_image_dist2(delta, spec), _R2_FLOOR)
        cls_i = spec.site_cls[i_chunk]                  # (chunk,)
        mask = (active[i_chunk][:, None] & active[None, :]
                & (spec.site_mol[i_chunk][:, None] != spec.site_mol[None, :]))
        eps = jnp.take(jnp.take(spec.eps_cls, cls_i, axis=0),
                       spec.site_cls, axis=-1)          # (chunk, S)
        sig = jnp.take(jnp.take(spec.sig_cls, cls_i, axis=0),
                       spec.site_cls, axis=-1)
        r = jnp.sqrt(r2)
        if spec.use_table:
            lj = _tab_lj(spec, eps, sig * sig, r)
        else:
            sr2 = (sig * sig) / r2
            sr6 = sr2 * sr2 * sr2
            lj = 4.0 * eps * (sr6 * sr6 - sr6)
        lj_mask = mask & (r2 < spec.cutoff * spec.cutoff)
        e_lj = e_lj + jnp.sum(jnp.where(lj_mask, lj, 0.0))
        qq = spec.site_q[i_chunk][:, None] * spec.site_q[None, :]
        if spec.use_table:
            coul = qq * tab_lookup(spec.tab_erfc, spec.tab_dx, r)
        else:
            coul = qq * erfc(spec.alpha * r) / r
            if spec.gg_cut:
                # mobile-pair honest cutoff (DIVERGENCES.md #22); frozen
                # cross pairs are overridden by the split term below
                coul = coul * (r2 < spec.gg_rcut * spec.gg_rcut)
        if spec.fw_split:
            # frozen<->mobile cross pairs use the short-ranged split term;
            # the far-field remainder is added once outside the scan
            one_frozen = ((i_chunk < spec.S_frozen)[:, None]
                          ^ (jnp.arange(S) < spec.S_frozen)[None, :])
            coul_short = (qq * erfc(spec.alpha2 * r) / r
                          * (r2 < spec.rcut2 * spec.rcut2))
            coul = jnp.where(one_frozen, coul_short, coul)
        e_c = e_c + jnp.sum(jnp.where(mask, coul, 0.0))
        return (e_lj, e_c), None

    zero = jnp.zeros((), dtype=pos.dtype)
    (e_lj, e_c), _ = jax.lax.scan(body, (zero, zero), (pos_c, idx))
    e_c = 0.5 * e_c * COULOMB_K
    if spec.fw_split:
        w = jnp.where(active & (jnp.arange(S) >= spec.S_frozen),
                      spec.site_q, 0.0)
        e_c = e_c + fw_far_energy(spec, pos, w)
    return 0.5 * e_lj, e_c


def full_intra_energy(spec: SystemSpec, state, pos):
    """Sum of intramolecular corrections over ACTIVE types only."""
    total = jnp.zeros((), dtype=pos.dtype)
    for r in range(spec.R):
        cap, A = spec.cap_list[r], spec.A_list[r]
        if not spec.active_list[r]:
            continue
        base = spec.site_base_list[r]
        region = cap * A
        p = pos[base:base + region].reshape(cap, A, 3)
        q = spec.site_q[base:base + region].reshape(cap, A)
        mask = jnp.ones((cap, A), bool)
        e_mol = intra_energy(spec, p, q, mask)          # (cap,)
        mol_mask = jnp.arange(cap) < state.n_mol[r]
        total = total + jnp.sum(jnp.where(mol_mask, e_mol, 0.0))
    return total


def system_energy(spec: SystemSpec, state):
    """Full from-scratch energy + fresh structure factors
    (reference: ComputeSystemEnergy, src/energy_utils.f90:18-35).
    Returns (energy[6], amp_re, amp_im)."""
    pos = site_positions(spec, state)
    active = active_site_mask(spec, state.n_mol)
    e_lj, e_coul = full_pair_energy(spec, pos, active)
    amp_re, amp_im = full_amplitudes(spec, pos, active)
    e_recip = recip_energy(spec, amp_re, amp_im)
    e_self = jnp.sum(spec.type_self_energy
                     * state.n_mol[: spec.R].astype(pos.dtype))
    e_intra = full_intra_energy(spec, state, pos)
    e = jnp.zeros(6, dtype=pos.dtype)
    e = e.at[E_RECIP].set(e_recip)
    e = e.at[E_LJ].set(e_lj)
    e = e.at[E_COUL].set(e_coul)
    e = e.at[E_SELF].set(e_self)
    e = e.at[E_INTRA].set(e_intra)
    e = e.at[E_TOT].set(e_recip + e_lj + e_coul + e_self + e_intra)
    return e, amp_re, amp_im
