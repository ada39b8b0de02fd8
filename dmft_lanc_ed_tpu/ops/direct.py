"""Matrix-free (direct) sector matvec.

JAX re-design of ED_HAMILTONIAN_DIRECT_HxV.f90 + direct/*.f90
(ED_SPARSE_H=F): instead of storing ELL hop tables, the connectivity of each
single-particle hop term is recomputed on device from bit operations on the
sector's state masks each matvec — trading FLOPs (popcount + binary search)
for memory, exactly the reference's stored-vs-direct dial. It is also the
second independent implementation of the hot operator, preserving the
reference's built-in cross-validation (SURVEY.md §4.5): tests assert
stored == direct on random vectors.

Device-side per term (pos_create, pos_destroy, amp):
  applicable sources: bit_d set, bit_c clear      (Jcondition)
  target mask      = state XOR (bit_c | bit_d)
  target row       = vectorized binary search over the sorted basis
  JW sign          = parity of occupied levels below each position
and the application is the same contiguous row-gather shape as the stored
backend (output-row formulation).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..bath import Bath, bath_levels
from ..config import EDConfig
from ..hamiltonian import _electron_diag_factors
from ..sectors import Sector, bath_stride


def _popcount32(x: jnp.ndarray) -> jnp.ndarray:
    x = x.astype(jnp.uint32)
    x = x - ((x >> 1) & jnp.uint32(0x55555555))
    x = (x & jnp.uint32(0x33333333)) + ((x >> 2) & jnp.uint32(0x33333333))
    x = (x + (x >> 4)) & jnp.uint32(0x0F0F0F0F)
    return ((x * jnp.uint32(0x01010101)) >> 24).astype(jnp.int32)


def _jw_sign(states: jnp.ndarray, pos: jnp.ndarray) -> jnp.ndarray:
    """(-1)^(#occupied below pos); pos is a scalar (traced)."""
    below = states & ((jnp.int32(1) << pos) - 1)
    return 1 - 2 * (_popcount32(below) & 1)


def _searchsorted(sorted_states: jnp.ndarray, queries: jnp.ndarray
                  ) -> jnp.ndarray:
    return jnp.searchsorted(sorted_states, queries).astype(jnp.int32)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class DirectSectorOp:
    """Matrix-free sector operator: states + term lists only.

    The electron diagonal is stored FACTORED (separable per-spin pieces +
    the rank-norb opposite-spin bilinear), never as a full [dd, du] array:
    diag[i, j] = diag_dw[i] + diag_up[j] + (diag_a @ diag_b.T)[i, j]. That
    keeps the op's device payload O(dim_dw + dim_up) — the direct backend's
    whole point (the reference recomputes diagonal terms per state,
    ED_HAMILTONIAN_DIRECT_HxV.f90 / direct/HxV_local.f90)."""
    states_up: jnp.ndarray        # [du] int32 sorted masks
    states_dw: jnp.ndarray        # [dd] int32
    diag_up: jnp.ndarray          # [du] separable up piece (+ Hartree const)
    diag_dw: jnp.ndarray          # [dd] separable dw piece
    diag_a: jnp.ndarray           # [dd, R] bilinear factor (n_dw_imp @ W.T)
    diag_b: jnp.ndarray           # [du, R] bilinear factor (n_up_imp)
    up_c: jnp.ndarray             # [Tu] int32 creation positions
    up_d: jnp.ndarray             # [Tu] destruction positions
    up_a: jnp.ndarray             # [Tu] amplitudes
    dw_c: jnp.ndarray
    dw_d: jnp.ndarray
    dw_a: jnp.ndarray
    # non-local Jx/Jp tensor-product hops (direct/HxV_non_local.f90):
    # term t = amp_t * (c^+_{uc} c_{ud})_up (x) (c^+_{dc} c_{dd})_dw
    nd_up_c: Optional[jnp.ndarray] = None   # [T] int32
    nd_up_d: Optional[jnp.ndarray] = None
    nd_dw_c: Optional[jnp.ndarray] = None
    nd_dw_d: Optional[jnp.ndarray] = None
    nd_a: Optional[jnp.ndarray] = None      # [T]
    # phonons (direct/HxV_eph.f90): occupancies recomputed from bits
    ph_w0: Optional[jnp.ndarray] = None     # scalar
    ph_g: Optional[jnp.ndarray] = None      # [norb] e-ph couplings
    ph_n: Optional[jnp.ndarray] = None      # [DimPh] = arange(DimPh)

    @property
    def dim_up(self) -> int:
        return self.states_up.shape[0]

    @property
    def dim_dw(self) -> int:
        return self.states_dw.shape[0]

    @property
    def dim_ph(self) -> int:
        return 1 if self.ph_n is None else self.ph_n.shape[0]

    @property
    def nnz(self) -> int:
        """Entries applied per matvec (the matrix-free kernel touches every
        row once per term, masks included): observability analogue of the
        stored backend's nonzero count (kernel_stats nnz/s)."""
        dim = self.dim_ph * self.dim_dw * self.dim_up
        terms = 1 + self.up_c.shape[0] + self.dw_c.shape[0]
        if self.nd_a is not None:
            terms += self.nd_a.shape[0]
        if self.ph_n is not None:
            terms += 2          # phonon ladder + e-ph factorized term
        return dim * terms


def _collect_terms(cfg: EDConfig, spin: int, hloc, diag_hybr, hbath
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(pos_c, pos_d, amp) for all single-particle hops of one spin."""
    s = spin if cfg.nspin == 2 else 0
    cc, dd_, aa = [], [], []

    def add(c, d, a):
        if a != 0.0:
            cc.append(c)
            dd_.append(d)
            aa.append(a)

    for a in range(cfg.norb):
        for b in range(cfg.norb):
            if a != b:
                add(a, b, float(hloc[s, s, a, b]))
    if cfg.bath_type == "replica" and hbath is not None:
        for k in range(cfg.nbath):
            for a in range(cfg.norb):
                for b in range(cfg.norb):
                    ia, ib = bath_stride(cfg, a, k), bath_stride(cfg, b, k)
                    if ia != ib:
                        add(ia, ib, float(hbath[s, s, a, b, k]))
    for a in range(cfg.norb):
        for k in range(cfg.nbath):
            ia = bath_stride(cfg, a, k)
            v = float(diag_hybr[s, a, k])
            add(ia, a, v)
            add(a, ia, v)
    if not cc:
        cc, dd_, aa = [0], [0], [0.0]
    return (np.array(cc, np.int32), np.array(dd_, np.int32),
            np.array(aa, np.float64))


def build_direct_op(cfg: EDConfig, sec: Sector, hloc: np.ndarray, bath: Bath,
                    h_basis: Optional[np.ndarray] = None,
                    dtype=None) -> DirectSectorOp:
    """Assemble the matrix-free operator (directMatVec preparation).

    Works for both QN schemes: in orbital-resolved mode (ed_total_ud=F,
    reference *_orbs code paths, ED_HAMILTONIAN_DIRECT_HxV.f90:96-178 +
    direct/Orbs/*.f90) the sector basis is already materialized as sorted
    composite full-Ns masks (sectors.SectorTable._composite_states), so the
    same bit-op connectivity + JW signs apply unchanged; channel-preserving
    hops (hybridization, intra-channel replica) are exactly the terms that
    survive the sector constraint, and channel-violating ones are rejected
    at setup (hloc off-diagonal validation)."""
    dtype = dtype or jnp.dtype(cfg.ed_dtype)
    bath_diag, diag_hybr, hbath = bath_levels(cfg, bath, h_basis)
    hloc = np.asarray(hloc, dtype=np.float64)
    e_up, e_dw, a_dw, b_up = _electron_diag_factors(cfg, sec, hloc, bath_diag)
    uc, ud, ua = _collect_terms(cfg, 0, hloc, diag_hybr, hbath)
    dc, dd_, da = _collect_terms(cfg, 1, hloc, diag_hybr, hbath)

    # non-local Jx/Jp term list (same term generation as the stored builder,
    # ED_HAMILTONIAN_SPARSE_HxV stored/H_non_local.f90, but positional only)
    nuc, nud, ndc, ndd, nda = [], [], [], [], []
    if cfg.norb > 1:
        for a in range(cfg.norb):
            for b in range(cfg.norb):
                if a == b:
                    continue
                if cfg.jx != 0.0:       # Jx (c+_a c_b)_up (c+_b c_a)_dw
                    nuc.append(a); nud.append(b)
                    ndc.append(b); ndd.append(a)
                    nda.append(cfg.jx)
                if cfg.jp != 0.0:       # Jp (c+_a c_b)_up (c+_a c_b)_dw
                    nuc.append(a); nud.append(b)
                    ndc.append(a); ndd.append(b)
                    nda.append(cfg.jp)
    nd_kw = {}
    if nuc:
        nd_kw = dict(nd_up_c=jnp.asarray(np.array(nuc, np.int32)),
                     nd_up_d=jnp.asarray(np.array(nud, np.int32)),
                     nd_dw_c=jnp.asarray(np.array(ndc, np.int32)),
                     nd_dw_d=jnp.asarray(np.array(ndd, np.int32)),
                     nd_a=jnp.asarray(np.array(nda), dtype=dtype))

    ph_kw = {}
    if cfg.dim_ph > 1:
        ph_kw = dict(ph_w0=jnp.asarray(cfg.w0_ph, dtype=dtype),
                     ph_g=jnp.asarray(np.array(cfg.g_ph[:cfg.norb]),
                                      dtype=dtype),
                     ph_n=jnp.arange(cfg.dim_ph, dtype=dtype))

    return DirectSectorOp(
        states_up=jnp.asarray(sec.states_up[0].astype(np.int32)),
        states_dw=jnp.asarray(sec.states_dw[0].astype(np.int32)),
        diag_up=jnp.asarray(e_up, dtype=dtype),
        diag_dw=jnp.asarray(e_dw, dtype=dtype),
        diag_a=jnp.asarray(a_dw, dtype=dtype),
        diag_b=jnp.asarray(b_up, dtype=dtype),
        up_c=jnp.asarray(uc), up_d=jnp.asarray(ud),
        up_a=jnp.asarray(ua, dtype=dtype),
        dw_c=jnp.asarray(dc), dw_d=jnp.asarray(dd_),
        dw_a=jnp.asarray(da, dtype=dtype), **nd_kw, **ph_kw)


def _apply_direct_factor(states, pos_c, pos_d, amps, v, out):
    """out[..., i, :] += sum_t amp_t sign_t(i) v[..., src_t(i), :].

    Output-row form: output state must have bit_c occupied, bit_d empty
    (post-hop); the source state is output XOR mask. Signs follow the
    reference's c-then-cdg composition evaluated on the source state.
    """
    def body(t, acc):
        c = pos_c[t]
        d = pos_d[t]
        amp = amps[t]
        bit_c = jnp.int32(1) << c
        bit_d = jnp.int32(1) << d
        mask = bit_c | bit_d
        ok = ((states & bit_c) != 0) & ((states & bit_d) == 0) & (c != d)
        src_state = states ^ mask
        src = _searchsorted(states, src_state)
        src = jnp.where(ok, src, 0)
        sg1 = _jw_sign(src_state, d)                 # c_d on source
        sg2 = _jw_sign(src_state ^ bit_d, c)         # cdg_c after removal
        w = jnp.where(ok, amp * (sg1 * sg2).astype(acc.dtype), 0.0)
        return acc + w[:, None] * v[..., src, :]
    return jax.lax.fori_loop(0, pos_c.shape[0], body, out)


def _row_gather_map(states, c, d):
    """Output-row gather map of one hop c^+_c c_d over one species basis.

    Returns (src, w): row i receives w[i] * x[src[i]] (w = 0 where the hop
    does not apply); signs follow the same c-then-cdg source-state
    convention as `_apply_direct_factor`.
    """
    bit_c = jnp.int32(1) << c
    bit_d = jnp.int32(1) << d
    mask = bit_c | bit_d
    ok = ((states & bit_c) != 0) & ((states & bit_d) == 0) & (c != d)
    src_state = states ^ mask
    src = jnp.where(ok, _searchsorted(states, src_state), 0)
    sg = _jw_sign(src_state, d) * _jw_sign(src_state ^ bit_d, c)
    return src, jnp.where(ok, sg, 0)


def diag_mul(op: DirectSectorOp, v: jnp.ndarray) -> jnp.ndarray:
    """diag ⊙ v from the factored diagonal, without materializing a stored
    [dd, du] array: the separable broadcast plus R (= norb, static) fused
    elementwise rank-1 passes. XLA fuses the whole thing into one kernel."""
    y = (op.diag_dw[:, None] + op.diag_up[None, :]) * v
    for r in range(op.diag_a.shape[1]):
        y = y + op.diag_a[:, r][:, None] * (op.diag_b[:, r][None, :] * v)
    return y


def direct_diag(op: DirectSectorOp) -> jnp.ndarray:
    """Materialized [dd, du] electron diagonal (preconditioner/oracle use
    only — O(dim) transient, never stored on the op)."""
    return (op.diag_dw[:, None] + op.diag_up[None, :]
            + op.diag_a @ op.diag_b.T)


def apply_direct(op: DirectSectorOp, v: jnp.ndarray) -> jnp.ndarray:
    """y = H v, computing the hop connectivity on the fly.

    v shaped [DimDw, DimUp] or [DimPh, DimDw, DimUp] (phonon blocks).
    """
    y = diag_mul(op, v)
    y = _apply_direct_factor(op.states_dw, op.dw_c, op.dw_d, op.dw_a, v, y)
    vt = jnp.swapaxes(v, -1, -2)
    yt = _apply_direct_factor(op.states_up, op.up_c, op.up_d, op.up_a, vt,
                              jnp.zeros_like(vt))
    y = y + jnp.swapaxes(yt, -1, -2)

    if op.nd_a is not None:
        def nd_body(t, acc):
            src_u, w_u = _row_gather_map(op.states_up, op.nd_up_c[t],
                                         op.nd_up_d[t])
            src_d, w_d = _row_gather_map(op.states_dw, op.nd_dw_c[t],
                                         op.nd_dw_d[t])
            tmp = v[..., src_u] * w_u.astype(acc.dtype)
            return acc + op.nd_a[t] * (tmp[..., src_d, :]
                                       * w_d.astype(acc.dtype)[:, None])
        y = jax.lax.fori_loop(0, op.nd_a.shape[0], nd_body, y)

    if op.ph_n is not None:
        # phonon diagonal w0 * n_ph
        y = y + (op.ph_w0 * op.ph_n)[:, None, None] * v
        # e-ph: y[p] += (X ev)[p], ev = [sum_a g_a (n_a - 1)] v with the
        # impurity occupancies recomputed from the low norb bits
        norb = op.ph_g.shape[0]
        occ_bits = jnp.arange(norb, dtype=jnp.int32)
        gu = (((op.states_up[:, None] >> occ_bits) & 1).astype(op.ph_g.dtype)
              @ op.ph_g)                                  # [du]
        gd = (((op.states_dw[:, None] >> occ_bits) & 1).astype(op.ph_g.dtype)
              @ op.ph_g)                                  # [dd]
        eph_el = gu[None, :] + gd[:, None] - op.ph_g.sum()
        ev = eph_el[None] * v                             # [P, dd, du]
        coef = jnp.sqrt(op.ph_n[1:])[:, None, None]       # sqrt(1..P-1)
        y = y.at[:-1].add(coef * ev[1:])                  # b
        y = y.at[1:].add(coef * ev[:-1])                  # b^+
    return y


def matvec_direct_flat(op: DirectSectorOp, v_flat: jnp.ndarray) -> jnp.ndarray:
    if op.ph_n is not None:
        v = v_flat.reshape(op.dim_ph, op.dim_dw, op.dim_up)
    else:
        v = v_flat.reshape(op.dim_dw, op.dim_up)
    return apply_direct(op, v).reshape(-1)
