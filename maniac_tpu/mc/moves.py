"""The Metropolis MC step as a pure function (SimState, key) -> SimState.

Design: instead of the reference's five separate move subroutines with
save/rollback of global state (reference: src/translation.f90, src/rotation.f90,
src/create_molecule.f90, src/delete_molecule.f90, src/monte_carlo.f90:40-77),
every move is ONE unified "remove a footprint + insert a footprint"
computation with 0/1 weights:

  move         removed footprint        inserted footprint
  -----------  -----------------------  --------------------------------
  translation  molecule (t, m)          same molecule, displaced COM
  rotation     molecule (t, m)          same molecule, rotated offsets
  creation     (none, weight 0)         template geometry at random pos
  deletion     molecule (t, m)          (none, weight 0)
  swap         molecule (t_a, m)        template of t_b at the same COM

This keeps the per-step work identical across move types - one packed
(old|new footprint, S) pair pass plus one separable structure-factor
contraction - so vmapped replicas never diverge. Rejection needs no
rollback: the old state is simply selected. The same code serves every
backend, precision and box shape.

The swap move is actually implemented here (the reference declares it,
parses its probability and has its acceptance formula
src/monte_carlo_utils.f90:228-268, but never dispatches it -
src/monte_carlo.f90:60 lets swap probability mass fall through to
insertion/deletion).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import (PROB_CREATE_DELETE, TWOPI, TYPE_CREATION,
                         TYPE_DELETION, TYPE_ROTATION, TYPE_SWAP,
                         TYPE_TRANSLATION)
from ..system import E_RECIP, N_MOVE_TYPES, SimState, SystemSpec
from ..physics.energy import (active_site_mask, amp_delta, intra_energy,
                              pair_energy_footprint, recip_energy_delta,
                              site_positions)
from ..physics.pbc import wrap_into_box


def _axis_rotation(axis, theta, dtype):
    """3x3 rotation about axis 0/1/2 (reference: src/helper_utils.f90:39-77),
    built branch-free from the three axis matrices."""
    c, s = jnp.cos(theta), jnp.sin(theta)
    one = jnp.ones((), dtype)
    zero = jnp.zeros((), dtype)
    rx = jnp.array([[one, zero, zero], [zero, c, -s], [zero, s, c]])
    ry = jnp.array([[c, zero, s], [zero, one, zero], [-s, zero, c]])
    rz = jnp.array([[c, -s, zero], [s, c, zero], [zero, zero, one]])
    return jnp.stack([rx, ry, rz])[axis]


def _place_rows(rel, in_mask, rows, base):
    """Scatter-free write of rows[a] (A, 3) into base (S, 3) where
    rel == a and in_mask: A_act unrolled fused selects, one elementwise pass
    over (S, 3), no (S, A) one-hot materialization. (Reservoir layout.)"""
    out = base
    for a in range(rows.shape[0]):
        out = jnp.where(((rel == a) & in_mask)[:, None], rows[a], out)
    return out


def _place_cols(rel, in_mask, cols, base):
    """Transposed-layout variant: write cols[:, a] (3, A) into base (3, S)
    where rel == a and in_mask - the site axis stays on the vector lanes."""
    out = base
    for a in range(cols.shape[1]):
        out = jnp.where(((rel == a) & in_mask)[None, :], cols[:, a:a + 1], out)
    return out


def _uniform_rotation(u, dtype):
    """Uniform SO(3) rotation matrix (Shoemake quaternion from 3 uniforms).

    Used for template-based insertions without a reservoir: the reference's
    single-random-axis full rotation of molecule 1's *current* geometry
    (src/create_molecule.f90:195-204) does not sample orientations uniformly;
    with a static template it would never leave a one-parameter family, so we
    propose a genuinely uniform orientation instead (see DIVERGENCES.md)."""
    a, b = jnp.sqrt(1.0 - u[0]), jnp.sqrt(u[0])
    t2, t3 = TWOPI * u[1], TWOPI * u[2]
    w, x = a * jnp.sin(t2), a * jnp.cos(t2)
    y, z = b * jnp.sin(t3), b * jnp.cos(t3)
    return jnp.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], dtype=dtype)


N_UNIFORMS = 21  # uniforms consumed per MC step (see mc_step_u)


def _uint(u, n):
    """floor(u * n) as a uniform int in [0, n) (clamped against u*n
    rounding up to n in f32)."""
    return jnp.minimum((u * n.astype(u.dtype)).astype(jnp.int32),
                       n.astype(jnp.int32) - 1)


def mc_step(spec: SystemSpec, state: SimState, key) -> SimState:
    """One MC trial from a PRNG key (single-step API; the block driver
    pre-draws all uniforms for a whole block in ONE threefry call -
    per-step key splitting measured as a large fraction of the step)."""
    u = jax.random.uniform(key, (N_UNIFORMS,), dtype=spec.dtype)
    return mc_step_u(spec, state, u)


def mc_step_u(spec: SystemSpec, state: SimState, u) -> SimState:
    """One MC trial from a row of uniforms: proposal glue, the energy core,
    then bookkeeping."""
    pre = _propose(spec, state, u)
    core = _core(spec, state, pre)
    return _bookkeep(spec, state, u, pre, core)


def _propose(spec: SystemSpec, state: SimState, u) -> dict:
    """Everything up to the energy core: move/type/molecule draws, footprint
    extraction (one-hot matmuls), proposal geometry, intra/self terms and
    the acceptance prefactor. Returns the dict consumed by _core and by
    _bookkeep."""
    fdt = spec.dtype
    u_move = u[0]
    u_cd = u[1]
    u_acc = u[2]
    u_disp = u[3:6] - 0.5
    u_frac = u[6:9]
    axis = _uint(u[10], jnp.int32(3))
    u_angle = u[9]

    # ---- move class selection (reference: src/monte_carlo.f90:50-75) ----
    is_trans = u_move <= spec.p_cum[0]
    is_rot = (~is_trans) & (u_move <= spec.p_cum[1])
    is_indel = (~is_trans) & (~is_rot) & (u_move <= spec.p_cum[2])
    can_swap = spec.n_active >= 2
    is_swap = (~is_trans) & (~is_rot) & (~is_indel) & can_swap
    is_create = is_indel & (u_cd <= PROB_CREATE_DELETE)
    is_delete = is_indel & (~is_create)
    move = jnp.where(is_create, TYPE_CREATION,
            jnp.where(is_delete, TYPE_DELETION,
             jnp.where(is_trans, TYPE_TRANSLATION,
              jnp.where(is_rot, TYPE_ROTATION, TYPE_SWAP))))

    insert_like = is_create | is_swap      # inserts a new molecule
    remove_like = is_delete | is_swap      # removes an existing molecule
    w_old = is_trans | is_rot | is_delete | is_swap
    w_new = is_trans | is_rot | is_create | is_swap

    # ---- pick residue types & molecule -----------------------------------
    i1 = _uint(u[11], jnp.int32(spec.n_active))
    t1 = spec.active_type_ids[i1]
    if spec.n_active >= 2:
        di = 1 + _uint(u[12], jnp.int32(spec.n_active - 1))
        i2 = (i1 + di) % spec.n_active
        t2 = spec.active_type_ids[i2]
    else:
        i2 = i1
        t2 = t1
    t_old = t1
    t_new = jnp.where(is_swap, t2, t1)

    n_old_count = state.n_mol[t_old]
    n_new_count = state.n_mol[t_new]
    m_old = _uint(u[13], jnp.maximum(n_old_count, 1))

    A_old = spec.type_A[t_old]
    A_new = spec.type_A[t_new]

    # a swap draw with <2 active species should never occur: deck
    # validation folds swap_proba into insertion/deletion in that case
    # (DIVERGENCES.md #23, matching the reference's fall-through dispatch,
    # src/monte_carlo.f90:60). Dropping the draw here is defense in depth
    # for specs built outside the deck path.
    if can_swap:
        dead_draw = jnp.zeros((), bool)
    else:
        dead_draw = (~is_trans) & (~is_rot) & (~is_indel)
    valid = jnp.where(is_create, True,
             jnp.where(is_rot, (n_old_count > 0) & (A_old > 1),
                       n_old_count > 0)) & (~dead_draw)
    if spec.has_reservoir:
        # insertion geometry is sampled from the reservoir; an empty
        # reservoir blocks insertions of that species (the reference would
        # read a stale molecule slot here, src/create_molecule.f90:188-189)
        valid = valid & (~insert_like | (state.res_n[t_new] > 0))
    cap_blocked = insert_like & (n_new_count >= spec.type_cap[t_new])

    # ---- gather footprints -------------------------------------------------
    A_act = spec.A_act
    mol_slot_old = spec.type_mol_base[t_old] + m_old
    site_start_old = spec.type_site_base[t_old] + m_old * A_old
    slot_new = jnp.where(insert_like,
                         spec.type_mol_base[t_new]
                         + jnp.minimum(n_new_count, spec.type_cap[t_new] - 1),
                         mol_slot_old)
    site_start_new = spec.mol_site_start[slot_new]

    # footprint extraction via one-hot matmuls in pos's NATIVE layout:
    # per-replica dynamic slices lower to gathers whose layout constraint
    # can force XLA to re-lay-out the whole (B, 3, S) array every step.
    # Positions flow through these dots, so they need full f32 products
    # (the "highest" pin in maniac_tpu/__init__.py)
    a_iota = jnp.arange(A_act, dtype=jnp.int32)
    # with the framework split, moving molecules live only in the guest
    # column suffix - the one-hot build and read shrink accordingly
    gb = spec.guest_base if spec.fw_split else 0
    s_iota = gb + jnp.arange(spec.S - gb, dtype=jnp.int32)
    last_idx = jnp.maximum(n_old_count - 1, 0)
    start_last = spec.type_site_base[t_old] + last_idx * A_old
    oh2 = jnp.concatenate([
        ((s_iota[:, None] - site_start_old) == a_iota[None, :]),
        ((s_iota[:, None] - start_last) == a_iota[None, :])],
        axis=1).astype(fdt)                                 # (S-gb, 2*A_act)
    cols2 = state.pos[:, gb:] @ oh2                         # (3, 2*A_act)
    P_old = cols2[:, :A_act].T                              # (A_act, 3)
    last_cols = cols2[:, A_act:]                            # (3, A_act)

    q_old = spec.type_q_rows[t_old]
    cls_old = spec.type_cls_rows[t_old]
    mask_old = jnp.arange(A_act) < A_old
    # com reads via one-hot matmul too (same gather/layout rationale)
    slot_last = spec.type_mol_base[t_old] + last_idx
    m_iota = jnp.arange(spec.Mtot + 1, dtype=jnp.int32)
    ohc = jnp.stack([(m_iota == mol_slot_old),
                     (m_iota == slot_last)], axis=1).astype(fdt)
    comcols = state.com @ ohc                               # (3, 2)
    com_old = comcols[:, 0]
    com_last = comcols[:, 1]
    off_old = P_old - com_old

    # geometry source for the inserted footprint: the moved molecule itself
    # (translation/rotation); for creation/swap, a random reservoir molecule
    # (no extra rotation) when -r was given, else molecule 0 of t_new with a
    # full random rotation (reference: src/create_molecule.f90:166-207).
    q_new = spec.type_q_rows[t_new]     # == q_old unless swap/create
    cls_new = spec.type_cls_rows[t_new]
    mask_new = jnp.arange(A_act) < A_new

    if spec.has_reservoir:
        res_pick = _uint(u[14], jnp.maximum(state.res_n[t_new], 1))
        res_src = spec.res_type_site_base[t_new] + res_pick * A_new
        off_src = jnp.where(
            insert_like,
            jax.lax.dynamic_slice_in_dim(state.res_offset, res_src, A_act, 0),
            off_old)
        # reservoir geometry is used as-is (reference convention)
        theta = jnp.where(is_rot, (u_angle - 0.5) * state.rot_step, 0.0)
        Rm = _axis_rotation(axis, theta, fdt)
    else:
        res_pick = jnp.zeros((), jnp.int32)
        # insertion source: the static per-type rigid template with a uniform
        # random orientation (not molecule 0's live offsets - fixes the
        # reference's stale-slot insertion and its N=0 collapse)
        off_src = jnp.where(insert_like, spec.type_template_off[t_new],
                            off_old)
        theta = jnp.where(is_rot, (u_angle - 0.5) * state.rot_step, 0.0)
        Rm = jnp.where(insert_like, _uniform_rotation(u[15:18], fdt),
                       _axis_rotation(axis, theta, fdt))
    new_off = off_src @ Rm.T

    com_trans = wrap_into_box(com_old + u_disp * state.trans_step, spec)
    com_insert = spec.bounds[:, 0] + spec.H @ u_frac
    com_new = jnp.where(is_trans, com_trans,
               jnp.where(is_create, com_insert, com_old))
    P_new = com_new + new_off

    # ---- energies -----------------------------------------------------------
    ex_a = jnp.where(w_old, mol_slot_old, spec.Mtot + 1)
    ex_b = slot_new

    i_old = jnp.where(remove_like & valid,
                      intra_energy(spec, P_old, q_old, mask_old), 0.0)
    i_new = jnp.where(insert_like,
                      intra_energy(spec, P_new, q_new, mask_new), 0.0)
    s_old = jnp.where(remove_like, spec.type_self_energy[t_old], 0.0)
    s_new = jnp.where(insert_like, spec.type_self_energy[t_new], 0.0)

    # the running E_RECIP component IS recip_energy(amp) by the bookkeeping
    # invariant; the delta form needs one O(K) pass instead of re-summing
    # |A|^2 for old AND new
    e_recip_old = state.energy[E_RECIP]

    # ---- acceptance prefactor (reference: src/monte_carlo_utils.f90:184-226)
    V = spec.volume
    nf = n_new_count.astype(fdt)
    no = n_old_count.astype(fdt)
    pref = jnp.where(insert_like,
                     spec.type_activity[t_new] * V / (nf + 1.0), 1.0)
    pref = pref * jnp.where(remove_like,
                            no / (spec.type_activity[t_old] * V), 1.0)
    gate = valid & (~cap_blocked)

    m2 = jnp.stack([mask_old & w_old, mask_new & w_new])
    return dict(
        u_acc=u_acc, insert_like=insert_like, remove_like=remove_like,
        w_old=w_old, w_new=w_new, valid=valid, cap_blocked=cap_blocked,
        gate=gate, move=move, t_old=t_old, t_new=t_new,
        A_old=A_old, A_new=A_new, mol_slot_old=mol_slot_old,
        slot_new=slot_new, m_iota=m_iota,
        site_start_old=site_start_old, site_start_new=site_start_new,
        ex_a=ex_a, ex_b=ex_b, P_old=P_old, P_new=P_new, q_old=q_old,
        q_new=q_new, cls_old=cls_old, cls_new=cls_new, mask_old=mask_old,
        mask_new=mask_new, m2=m2, last_cols=last_cols, com_new=com_new,
        com_last=com_last, off_old=off_old, res_pick=res_pick,
        i_old=i_old, i_new=i_new, s_old=s_old, s_new=s_new,
        e_recip_old=e_recip_old, pref=pref)


def _core(spec: SystemSpec, state: SimState, pre: dict) -> dict:
    """Energy core: footprint pair pass, structure-factor delta, Metropolis
    test and the position/amplitude update."""
    fdt = spec.dtype
    P = jnp.stack([pre["P_old"], pre["P_new"]])
    q2 = jnp.stack([pre["q_old"], pre["q_new"]])
    cls2 = jnp.stack([pre["cls_old"], pre["cls_new"]])
    m2 = pre["m2"]
    e_lj, e_coul = pair_energy_footprint(
        spec, site_positions(spec, state),
        active_site_mask(spec, state.n_mol), P, q2, cls2, m2,
        pre["ex_a"], pre["ex_b"])

    signs = jnp.stack([-pre["w_old"].astype(fdt), pre["w_new"].astype(fdt)])
    d_re, d_im = amp_delta(spec, P, q2, m2, signs)
    e_recip_old = pre["e_recip_old"]
    e_other_old = e_lj[0] + e_coul[0] + pre["s_old"] + pre["i_old"]
    e_other_new = e_lj[1] + e_coul[1] + pre["s_new"] + pre["i_new"]
    e_recip_new = e_recip_old + recip_energy_delta(
        spec, state.amp_re, state.amp_im, d_re, d_im)
    delta_e = (e_other_new + e_recip_new) - (e_other_old + e_recip_old)
    p_acc = jnp.minimum(1.0, pre["pref"] * jnp.exp(-delta_e / spec.temp_K))
    acc = pre["gate"] & (pre["u_acc"] <= p_acc)
    accf = acc.astype(fdt)

    # ---- state update (functional; reject = keep old) --------------------
    # All writes are pure arithmetic selects: (S, A_act) one-hot matmuls
    # would materialize (B, S, A_act) temporaries, while unrolled per-row
    # selects fuse into one elementwise pass over (B, 3, S) and keep the
    # write path free of per-replica scatters.
    s_idx = jnp.arange(spec.S, dtype=jnp.int32)
    rel_new = s_idx - pre["site_start_new"]
    rel_old = s_idx - pre["site_start_old"]
    do_write = acc & pre["w_new"]
    do_compact = acc & pre["remove_like"]
    in_new = do_write & (rel_new >= 0) & (rel_new < pre["A_new"])     # (S,)
    in_old = do_compact & (rel_old >= 0) & (rel_old < pre["A_old"])
    # compaction first, then the written molecule (new rows win, same
    # precedence as the previous nested-where; regions only coexist in
    # swap moves, where they are disjoint since t_old != t_new)
    pos = _place_cols(rel_old, in_old, pre["last_cols"], state.pos)
    pos = _place_cols(rel_new, in_new, pre["P_new"].T, pos)

    amp_re = state.amp_re + accf * d_re
    amp_im = state.amp_im + accf * d_im
    return dict(pos=pos, amp_re=amp_re, amp_im=amp_im, acc=acc, accf=accf,
                e_recip_new=e_recip_new, delta_e=delta_e, e_lj=e_lj,
                e_coul=e_coul)


def _bookkeep(spec: SystemSpec, state: SimState, u, pre: dict,
              core: dict) -> SimState:
    """COM/population/energy/counter updates + reservoir bookkeeping."""
    acc = core["acc"]
    accf = core["accf"]
    e_lj, e_coul = core["e_lj"], core["e_coul"]
    insert_like, remove_like = pre["insert_like"], pre["remove_like"]
    t_old, t_new = pre["t_old"], pre["t_new"]
    m_iota = pre["m_iota"]

    do_write = acc & pre["w_new"]
    do_compact = acc & remove_like
    com = jnp.where((do_write & (m_iota == pre["slot_new"]))[None, :],
                    pre["com_new"][:, None],
                    jnp.where(
                        (do_compact
                         & (m_iota == pre["mol_slot_old"]))[None, :],
                        pre["com_last"][:, None], state.com))

    r_idx = jnp.arange(spec.R + 1, dtype=jnp.int32)
    n_mol = (state.n_mol
             + jnp.where(acc & insert_like & (r_idx == t_new), 1, 0)
             - jnp.where(acc & remove_like & (r_idx == t_old), 1, 0))

    comp_delta = jnp.stack([
        jnp.where(acc, core["e_recip_new"] - state.energy[E_RECIP], 0.0),
        accf * (e_lj[1] - e_lj[0]),
        accf * (e_coul[1] - e_coul[0]),
        accf * (pre["s_new"] - pre["s_old"]),
        accf * (pre["i_new"] - pre["i_old"]),
        accf * core["delta_e"],
    ])
    e = state.energy + comp_delta

    mv_idx = jnp.arange(N_MOVE_TYPES, dtype=jnp.int32)
    oh_move = (mv_idx == pre["move"])
    counters = state.counters + jnp.stack([
        jnp.where(oh_move & pre["valid"], 1, 0),
        jnp.where(oh_move & acc, 1, 0)]).astype(jnp.int32)
    x_idx = jnp.arange(4, dtype=jnp.int32)
    extras = state.extras + jnp.where(
        (x_idx == 0) & pre["valid"] & pre["cap_blocked"], 1,
        0).astype(jnp.int32)

    new_state = state.replace(com=com, pos=core["pos"], n_mol=n_mol,
                              amp_re=core["amp_re"], amp_im=core["amp_im"],
                              energy=e, counters=counters, extras=extras)
    if spec.has_reservoir:
        new_state = _update_reservoir(
            spec, state, new_state, acc, insert_like, remove_like,
            t_old, t_new, pre["A_old"], pre["A_new"], spec.A_act,
            pre["res_pick"], pre["off_old"], pre["mask_old"], u[18:21])
    return new_state


def _update_reservoir(spec, old_state, state, acc, insert_like, remove_like,
                      t_old, t_new, A_old, A_new, A_act, res_pick, off_old,
                      mask_old, u3):
    """Reservoir bookkeeping on accepted insertions/deletions/swaps
    (reference: src/create_molecule.f90:117-129 pop-on-insert,
    src/delete_molecule.f90:148-166 push-on-delete).

    Pop: the sampled reservoir molecule is replaced by the reservoir's last
    molecule of that type. Push: the removed molecule's offsets are stored at
    a random position in the reservoir box. A full reservoir drops the
    pushed molecule (counted in extras[1]); the reference would write out of
    bounds there."""
    fdt = spec.dtype
    res_off0 = state.res_offset
    res_com0 = state.res_com
    res_n = state.res_n
    Sres = res_off0.shape[0]
    Mres = res_com0.shape[0]

    def slice_res(arr, start):
        return jax.lax.dynamic_slice_in_dim(arr, start, A_act, axis=0)

    # scatter-free writes (same rationale as in mc_step)
    s_idx = jnp.arange(Sres, dtype=jnp.int32)
    m_idx = jnp.arange(Mres, dtype=jnp.int32)

    # --- pop sampled molecule on accepted insertion ----------------------
    do_pop = acc & insert_like
    last = jnp.maximum(res_n[t_new] - 1, 0)
    pop_slot = spec.res_type_mol_base[t_new] + res_pick
    last_slot = spec.res_type_mol_base[t_new] + last
    pop_start = spec.res_type_site_base[t_new] + res_pick * A_new
    last_start = spec.res_type_site_base[t_new] + last * A_new
    last_rows = slice_res(res_off0, last_start)

    # --- push removed molecule on accepted deletion ------------------------
    full = res_n[t_old] >= spec.res_cap[t_old]
    do_push = acc & remove_like & (~full)
    push_idx = jnp.minimum(res_n[t_old], spec.res_cap[t_old] - 1)
    push_slot = spec.res_type_mol_base[t_old] + push_idx
    push_start = spec.res_type_site_base[t_old] + push_idx * A_old
    res_pos = spec.res_H @ (u3 - 0.5)  # centered placement (ref convention)

    rel_pop = s_idx - pop_start
    rel_push = s_idx - push_start
    in_pop = do_pop & (rel_pop >= 0) & (rel_pop < A_new)
    in_push = do_push & (rel_push >= 0) & (rel_push < A_old)
    res_off = _place_rows(rel_push, in_push, off_old, res_off0)
    res_off = _place_rows(rel_pop, in_pop, last_rows, res_off)

    res_com = jnp.where((do_pop & (m_idx == pop_slot))[:, None],
                        res_com0[last_slot],
                        jnp.where((do_push & (m_idx == push_slot))[:, None],
                                  res_pos, res_com0))

    r_idx = jnp.arange(res_n.shape[0], dtype=jnp.int32)
    res_n = (res_n
             - jnp.where(do_pop & (r_idx == t_new), 1, 0)
             + jnp.where(do_push & (r_idx == t_old), 1, 0))
    x_idx = jnp.arange(4, dtype=jnp.int32)
    extras = state.extras + jnp.where(
        (x_idx == 1) & acc & remove_like & full, 1, 0).astype(jnp.int32)

    return state.replace(res_com=res_com, res_offset=res_off, res_n=res_n,
                         extras=extras)
