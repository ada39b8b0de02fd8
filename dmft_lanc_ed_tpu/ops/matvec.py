"""Sector Hamiltonian matvec backends.

JAX replacement of the SpMV engine (spMatVec_main,
ED_HAMILTONIAN_SPARSE_HxV.f90:391-485). The sector vector is a dense array
``v[DimPh, DimDw, DimUp]`` (phonon blocks outermost, up index fastest — the
same linear order as the reference's ``i = iup + idw*DimUp + iph*DimUp*DimDw``).

The ELL tables are applied **one ELL slot at a time as full row-gathers**
— ``y += vals[:,k] * v[cols[:,k], :]`` — with the up-spin factor applied in
the transposed layout so its gather is also a major-axis row gather: each
gather moves whole contiguous rows, and no [DimDw, DimUp, K] intermediate
is materialized (as the einsum-over-[N,K]-gather form would). K (max
entries/row) is ~2*Nbath — a static trip count. Its speed on the H100
against the dense backend is in PERF.md.

All functions are pure and jit-compatible with static shapes.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..hamiltonian import SectorHamiltonian


def _apply_factor_rows(cols, vals, v, out):
    """out += sum_k vals[:,k] * v[..., cols[:,k], :] (row-gather per slot).

    cols/vals: [N, K]; v/out: [..., N, M]. Gathers are along the
    second-to-last axis (contiguous rows of length M).
    """
    colsT = cols.T                        # [K, N]
    valsT = vals.T

    def body(k, acc):
        idx = colsT[k]
        w = valsT[k]
        return acc + w[:, None] * v[..., idx, :]

    return jax.lax.fori_loop(0, colsT.shape[0], body, out)


def apply_h(h: SectorHamiltonian, v: jnp.ndarray) -> jnp.ndarray:
    """y = H v for one sector. v shaped [DimDw, DimUp] or [DimPh, DimDw, DimUp]."""
    # tables are host numpy (see SectorHamiltonian); when `h` is closed over
    # rather than passed as a jit argument they must become jnp constants
    # here, or tracer-indexed gathers below hit numpy. No-op for tracers.
    h = jax.tree_util.tree_map(jnp.asarray, h)
    has_ph = h.ph_diag is not None
    y = h.diag * v
    # dw hops: row gathers in the native layout
    y = _apply_factor_rows(h.dw_cols, h.dw_vals, v, y)
    # up hops: row gathers in the transposed layout
    vt = jnp.swapaxes(v, -1, -2)          # [..., DimUp, DimDw]
    yt = _apply_factor_rows(h.up_cols, h.up_vals, vt,
                            jnp.zeros_like(vt))
    y = y + jnp.swapaxes(yt, -1, -2)
    if h.nd_up_src is not None:
        # sum_t B_t (x) A_t : each factor is a gather map
        def one_term(up_src, up_val, dw_src, dw_val):
            tmp = v[..., up_src] * up_val            # gather along up axis
            return tmp[..., dw_src, :] * dw_val[:, None]
        contrib = jax.vmap(one_term, in_axes=(0, 0, 0, 0), out_axes=0)(
            h.nd_up_src, h.nd_up_val, h.nd_dw_src, h.nd_dw_val)
        y = y + contrib.sum(axis=0)
    if has_ph:
        y = y + h.ph_diag[:, None, None] * v
        # e-ph: y[p] += X[p,q] * (eph_el * v[q])
        ev = h.eph_el[None] * v                      # [DimPh, DimDw, DimUp]
        y = y + jnp.einsum("pq,qdu->pdu", h.eph_x, ev)
    return y


@partial(jax.jit, static_argnames=())
def apply_h_jit(h: SectorHamiltonian, v: jnp.ndarray) -> jnp.ndarray:
    return apply_h(h, v)


def matvec_flat(h: SectorHamiltonian, v_flat: jnp.ndarray) -> jnp.ndarray:
    """Flat-vector interface (reference linear index order)."""
    if h.ph_diag is not None:
        v = v_flat.reshape(h.dim_ph, h.dim_dw, h.dim_up)
    else:
        v = v_flat.reshape(h.dim_dw, h.dim_up)
    return apply_h(h, v).reshape(-1)


def make_matvec(h: SectorHamiltonian):
    """Closure `mv(v_flat) -> H v_flat`, jitted once per sector shape."""
    @jax.jit
    def mv(v_flat):
        return matvec_flat(h, v_flat)
    return mv
