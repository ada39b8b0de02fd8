"""Dense tensor-product matvec backend — the matmul formulation.

JAX re-design of the hot sector SpMV (reference hot loop:
spMatVec_main / spMatVec_mpi_main, ED_HAMILTONIAN_SPARSE_HxV.f90:391-485,
568-694). The reference streams CSR rows; the ELL backend (ops/matvec.py)
streams row-gathers. This backend removes gathers entirely by exploiting
the tensor-product structure

    H = 1_dw (x) H_up + H_dw (x) 1_up + D (+ phonon/e-ph/non-local terms):

the one-spin hop factors are tiny (DimUp x DimUp, a few MB) so the sector
matvec over V[DimDw, DimUp] becomes two *dense matmuls*

    Y = D . V  +  V @ H_up  +  H_dw @ V          (H_up/H_dw symmetric)

plus small batched matmuls for the phonon / e-ph / Jx-Jp tensor products.
The dense factors spend 2*dim*(DimUp+DimDw) FLOPs on a matvec whose
nonzeros are ~dim*Ns, but a matmul runs on the GPU's FP64 tensor cores
with no gathers; on the H100 it is the faster stored form (PERF.md).

Two precision modes:

- f64 (``matvec_dense_flat``): exact; BLAS dgemm on the CPU, FP64 tensor
  cores on the GPU.
- mixed (``matvec_dense_mixed_flat``): factors and vector cast to f32,
  matmuls with ``precision=HIGHEST`` (f32-true products, f32
  accumulation), diagonal applied in f64. Relative matvec error ~1e-7;
  the ground-state path recovers f64 eigenvalues via the Rayleigh-Ritz
  polish in :func:`..ops.lanczos.refine_eigenpairs`.

All applies accept the natural-shape vector ([DimDw, DimUp] or
[DimPh, DimDw, DimUp]) via :func:`matvec_dense` — this is the form the
SPMD-sharded production path uses (dw axis sharded over the mesh; XLA
partitions V@H_up locally and turns H_dw@V into a reduce-scatter, the
collective analogue of the reference's vector_transpose_MPI sandwich).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..bath import Bath
from ..config import EDConfig
from ..hamiltonian import SectorHamiltonian, build_sector_hamiltonian
from ..sectors import Sector

_HIGHEST = jax.lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class DenseSectorOp:
    """Dense tensor-product factors of one sector Hamiltonian."""
    diag: jnp.ndarray                      # [DimDw, DimUp] f64
    hup: jnp.ndarray                       # [DimUp, DimUp] f64 (symmetric)
    hdw: jnp.ndarray                       # [DimDw, DimDw] f64 (symmetric)
    hup32: jnp.ndarray                     # f32 copies for the mixed path
    hdw32: jnp.ndarray
    # non-local Jx/Jp tensor products sum_t B_t (x) A_t (dense, stacked)
    nd_a: Optional[jnp.ndarray] = None     # [T, DimUp, DimUp] f64
    nd_b: Optional[jnp.ndarray] = None     # [T, DimDw, DimDw] f64
    nd_a32: Optional[jnp.ndarray] = None
    nd_b32: Optional[jnp.ndarray] = None
    # phonons
    ph_diag: Optional[jnp.ndarray] = None  # [DimPh] f64
    eph_el: Optional[jnp.ndarray] = None   # [DimDw, DimUp] f64
    eph_x: Optional[jnp.ndarray] = None    # [DimPh, DimPh] f64
    # static: true operator nonzeros (metadata, not a pytree leaf)
    nnz_count: int = field(default=0, metadata=dict(static=True))

    @property
    def dim_up(self) -> int:
        return self.diag.shape[1]

    @property
    def dim_dw(self) -> int:
        return self.diag.shape[0]

    @property
    def dim_ph(self) -> int:
        return 1 if self.ph_diag is None else self.ph_diag.shape[0]

    @property
    def dim(self) -> int:
        return self.dim_up * self.dim_dw * self.dim_ph

    @property
    def nnz(self) -> int:
        """True operator nonzeros applied per matvec (for nnz/s metrics)."""
        return self.nnz_count


def _densify_ell(cols: np.ndarray, vals: np.ndarray, n: int) -> np.ndarray:
    h = np.zeros((n, n))
    for k in range(cols.shape[1]):
        np.add.at(h, (np.arange(n), cols[:, k]), vals[:, k])
    return h


def densify(h: SectorHamiltonian, to_device: bool = True) -> DenseSectorOp:
    """SectorHamiltonian (ELL factors) -> dense tensor-product factors.

    ``to_device=False`` keeps every field as host numpy — the batched
    bucket path pads/transposes/stacks on host and pushes ONE stacked
    array per field (the per-field device round trips were 18.5 s of the
    bethe9 warm diag; round-5 fix)."""
    du, dd = h.dim_up, h.dim_dw
    put = jnp.asarray if to_device else np.asarray
    hup = _densify_ell(np.asarray(h.up_cols), np.asarray(h.up_vals, np.float64), du)
    hdw = _densify_ell(np.asarray(h.dw_cols), np.asarray(h.dw_vals, np.float64), dd)
    kw = {}
    if h.nd_up_src is not None:
        t_cnt = h.nd_up_src.shape[0]
        nd_a = np.zeros((t_cnt, du, du))
        nd_b = np.zeros((t_cnt, dd, dd))
        for t in range(t_cnt):
            nd_a[t, np.arange(du), np.asarray(h.nd_up_src[t])] = \
                np.asarray(h.nd_up_val[t], np.float64)
            nd_b[t, np.arange(dd), np.asarray(h.nd_dw_src[t])] = \
                np.asarray(h.nd_dw_val[t], np.float64)
        kw.update(nd_a=put(nd_a), nd_b=put(nd_b),
                  nd_a32=put(np.asarray(nd_a, np.float32)),
                  nd_b32=put(np.asarray(nd_b, np.float32)))
    if h.ph_diag is not None:
        kw.update(ph_diag=put(np.asarray(h.ph_diag, np.float64)),
                  eph_el=put(np.asarray(h.eph_el, np.float64)),
                  eph_x=put(np.asarray(h.eph_x, np.float64)))
    return DenseSectorOp(
        diag=put(np.asarray(h.diag, np.float64)),
        hup=put(hup), hdw=put(hdw),
        hup32=put(np.asarray(hup, np.float32)),
        hdw32=put(np.asarray(hdw, np.float32)),
        nnz_count=h.nnz, **kw)


def build_dense_op(cfg: EDConfig, sec: Sector, hloc: np.ndarray, bath: Bath,
                   h_basis: Optional[np.ndarray] = None,
                   to_device: bool = True) -> DenseSectorOp:
    h = build_sector_hamiltonian(cfg, sec, hloc, bath, h_basis=h_basis,
                                 dtype=jnp.float64)
    return densify(h, to_device=to_device)


# --------------------------------------------------------------------------
# applies (natural shape)
# --------------------------------------------------------------------------
def _apply_dense(op: DenseSectorOp, v: jnp.ndarray, hup, hdw, nd_a, nd_b,
                 precision) -> jnp.ndarray:
    """Shared body: matmul terms at `precision` in hup.dtype, diagonal and
    phonon-diagonal terms in the vector's own dtype (f64)."""
    vc = v.astype(hup.dtype)
    # up hops: contract the last axis; hup symmetric so no transpose needed
    y32 = jnp.matmul(vc, hup, precision=precision)
    # dw hops: contract the dw axis (second-to-last)
    if v.ndim == 3:
        ydw = jnp.tensordot(hdw, vc, axes=[[1], [1]], precision=precision)
        y32 = y32 + jnp.moveaxis(ydw, 0, 1)      # [dd,dp,du] -> [dp,dd,du]
    else:
        y32 = y32 + jnp.matmul(hdw, vc, precision=precision)
    if nd_a is not None:
        # sum_t B_t @ V @ A_t^T  — batched matmuls
        va = jnp.einsum("...du,tau->t...da", vc, nd_a, precision=precision)
        y32 = y32 + jnp.einsum("tde,t...ea->...da", nd_b, va,
                               precision=precision)
    y = op.diag * v + y32.astype(v.dtype)
    if op.ph_diag is not None:
        y = y + op.ph_diag[:, None, None].astype(v.dtype) * v
        ev = op.eph_el[None].astype(hup.dtype) * vc
        y = y + jnp.einsum("pq,qdu->pdu", op.eph_x.astype(hup.dtype), ev,
                           precision=precision).astype(v.dtype)
    return y


def matvec_dense(op: DenseSectorOp, v: jnp.ndarray) -> jnp.ndarray:
    """f64-exact dense matvec on the natural-shape vector."""
    return _apply_dense(op, v, op.hup, op.hdw, op.nd_a, op.nd_b, _HIGHEST)


def matvec_dense_mixed(op: DenseSectorOp, v: jnp.ndarray) -> jnp.ndarray:
    """Mixed-precision: f32 matmuls at HIGHEST (~f32-true products)."""
    return _apply_dense(op, v, op.hup32, op.hdw32, op.nd_a32, op.nd_b32,
                        _HIGHEST)


# --------------------------------------------------------------------------
# flat-vector interfaces (reference linear index order)
# --------------------------------------------------------------------------
def _reshape(op: DenseSectorOp, v_flat: jnp.ndarray) -> jnp.ndarray:
    if op.ph_diag is not None:
        return v_flat.reshape(op.dim_ph, op.dim_dw, op.dim_up)
    return v_flat.reshape(op.dim_dw, op.dim_up)


def matvec_dense_flat(op: DenseSectorOp, v_flat: jnp.ndarray) -> jnp.ndarray:
    return matvec_dense(op, _reshape(op, v_flat)).reshape(-1)


def matvec_dense_mixed_flat(op: DenseSectorOp, v_flat: jnp.ndarray
                            ) -> jnp.ndarray:
    return matvec_dense_mixed(op, _reshape(op, v_flat)).reshape(-1)

