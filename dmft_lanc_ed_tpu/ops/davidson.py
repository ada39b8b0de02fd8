"""Davidson eigensolver (lanc_method=dvdson).

JAX replacement of the reference's DVDSON path (`sp_dvdson_eigh`,
ED_DIAG.f90:189-204; SF_SP_LINALG dvdson): expansion vectors are
*diagonally preconditioned residuals* t = r / (theta - D) instead of the
Lanczos recurrence — the classic Davidson trade: one extra elementwise pass
per iteration buys much faster convergence when the diagonal dominates
(large-U ED sectors, where the interaction diagonal spreads the spectrum).

Structure mirrors :func:`..ops.lanczos.lanczos_ground_state` (host-driven
outer loop, fixed-shape jitted device steps, thick restart with the lowest
Ritz vectors, locking by spectral order) so the two solvers are drop-in
interchangeable and cross-validated in tests, including on degenerate
ground states.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_EPS = 1e-30


@partial(jax.jit, static_argnames=("op_apply",), donate_argnums=(1, 2, 3))
def _dav_insert(op, basis, hbasis, t_mat, k, v_new, op_apply: Callable):
    """CGS2-orthonormalize v_new against basis rows < k (rows >= k are
    zero), insert at row k, apply H, and record the projected column.

    Returns (basis, hbasis, t_mat, beta) where beta is the norm of the
    orthogonalized direction (0 => v_new was linearly dependent)."""
    def proj(b, w):
        return jnp.tensordot(b, w, axes=w.ndim)

    v = v_new
    v = v - jnp.tensordot(proj(basis, v), basis, axes=1)
    v = v - jnp.tensordot(proj(basis, v), basis, axes=1)
    beta = jnp.linalg.norm(v)
    ok = beta > 1e-14
    v = jnp.where(ok, v / jnp.where(ok, beta, 1.0), 0.0)
    basis = jax.lax.dynamic_update_index_in_dim(basis, v, k, 0)
    w = op_apply(op, v).reshape(v.shape)
    hbasis = jax.lax.dynamic_update_index_in_dim(hbasis, w, k, 0)
    col = proj(basis, w)                       # rows > k are zero
    t_mat = jax.lax.dynamic_update_slice(t_mat, col[:, None], (0, k))
    t_mat = jax.lax.dynamic_update_slice(t_mat, col[None, :], (k, 0))
    return basis, hbasis, t_mat, jnp.where(ok, beta, 0.0)


@jax.jit
def _dav_residual(basis, hbasis, s, theta, diag, eta):
    """Ritz vector x = s.B, residual r = s.HB - theta x, preconditioned
    expansion t = r / (theta - D) (Davidson), with |theta - D| floored at
    eta to keep the preconditioner bounded near-diagonal entries."""
    x = jnp.tensordot(s, basis, axes=1)
    r = jnp.tensordot(s, hbasis, axes=1) - theta * x
    rnorm = jnp.linalg.norm(r)
    denom = theta - diag
    denom = jnp.where(jnp.abs(denom) < eta,
                      jnp.where(denom < 0, -eta, eta), denom)
    return x, r / denom, rnorm


@jax.jit
def _dav_restart(basis, hbasis, s_keep):
    """Thick restart: rotate the kept Ritz pairs into the leading rows."""
    nb = jnp.tensordot(s_keep, basis, axes=1)
    nh = jnp.tensordot(s_keep, hbasis, axes=1)
    l = s_keep.shape[0]
    m = basis.shape[0]
    pad = ((0, m - l),) + ((0, 0),) * (basis.ndim - 1)
    return jnp.pad(nb, pad), jnp.pad(nh, pad)


def op_diag_flat(op) -> jnp.ndarray:
    """Flat diagonal of a sector operator (the DVDSON preconditioner).

    Handles every backend op: ELL SectorHamiltonian / DenseSectorOp (with
    their separate phonon diagonal), DirectSectorOp (factored diagonal +
    phonon ladder diagonal w0*n), BlockSparseSectorOp (natural-order diag)."""
    if hasattr(op, "diag_a"):                    # DirectSectorOp (factored)
        from .direct import direct_diag
        d = direct_diag(op)
    else:
        d = jnp.asarray(op.diag)
    if d.ndim == 3:                              # already [P, dd, du]
        return d.reshape(-1)
    ph = getattr(op, "ph_diag", None)
    if ph is not None:                           # ell/dense phonon sectors
        return (jnp.asarray(ph)[:, None, None] + d[None]).reshape(-1)
    ph_n = getattr(op, "ph_n", None)
    if ph_n is not None:                         # direct phonon sectors
        return (op.ph_w0 * jnp.asarray(ph_n)[:, None, None]
                + d[None]).reshape(-1)
    return d.reshape(-1)


def davidson_ground_state(
    op,
    op_apply: Callable,
    dim: int,
    neigen: int,
    diag,
    ncv: Optional[int] = None,
    tol: float = 1e-14,
    max_iter: int = 3000,
    seed: int = 17,
    dtype=jnp.float64,
    v0: Optional[jnp.ndarray] = None,
    vshape: Optional[Tuple[int, ...]] = None,
    sharding=None,
    polish_apply: Optional[Callable] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Lowest `neigen` eigenpairs by preconditioned Davidson.

    Same contract as :func:`..ops.lanczos.lanczos_ground_state`, plus
    ``diag``: the operator's diagonal in the vector's natural shape (the
    preconditioner, sp_dvdson's ADIAG argument).

    Returns (energies [k], vectors [k, dim] flat) ascending."""
    vshape = tuple(vshape) if vshape is not None else (dim,)
    neigen = min(neigen, dim)
    m = min(ncv or max(2 * neigen + 16, 24), dim)
    l_keep = min(max(2 * neigen, neigen + 4), max(m - 2, 1))
    key = jax.random.PRNGKey(seed)
    diag = jnp.asarray(diag, dtype).reshape(vshape)
    eta = 1e-3 * float(jnp.max(jnp.abs(diag)) + 1.0)

    def put(x):
        return jax.device_put(x, sharding) if sharding is not None else x

    if v0 is None:
        key, sub = jax.random.split(key)
        v0 = jax.random.normal(sub, vshape, dtype)
    else:
        v0 = jnp.reshape(jnp.asarray(v0, dtype), vshape)
    v_next = put(v0 / jnp.linalg.norm(v0))

    basis = put(jnp.zeros((m,) + vshape, dtype))
    hbasis = put(jnp.zeros((m,) + vshape, dtype))
    t_mat = jnp.zeros((m, m), dtype)
    k = 0
    from ..utils.observability import kernel_stats
    for it in range(max_iter):
        basis, hbasis, t_mat, beta = _dav_insert(
            op, basis, hbasis, t_mat, k, v_next, op_apply)
        kernel_stats.record(1, getattr(op, "nnz", 0))
        if float(beta) == 0.0:
            # linearly dependent expansion — fresh random direction
            key, sub = jax.random.split(key)
            v_next = put(jax.random.normal(sub, vshape, dtype))
            continue
        k += 1
        tm = np.asarray(t_mat)[:k, :k]
        theta_np, s_np = np.linalg.eigh(0.5 * (tm + tm.T))
        s_pad = np.zeros((m,), np.float64)
        # converged prefix in spectral order (locking)
        n_conv = 0
        x_low = None
        for j in range(min(k, neigen + 1)):
            s_pad[:k] = s_np[:, j]
            x, t_pre, rnorm = _dav_residual(
                basis, hbasis, jnp.asarray(s_pad, dtype), theta_np[j],
                diag, eta)
            if j == n_conv and float(rnorm) <= tol * max(
                    abs(theta_np[j]), 1.0):
                n_conv += 1
                continue
            x_low = (x, t_pre)
            break
        if n_conv >= neigen and k >= neigen:
            s = jnp.asarray(s_np[:, :neigen], dtype)
            vecs = jnp.tensordot(s.T, basis[:k], axes=1)
            vals = theta_np[:neigen]
            if polish_apply is not None:
                from .lanczos import refine_eigenpairs
                vals, vecs = refine_eigenpairs(op, polish_apply, vecs,
                                               sharding=sharding)
            vecs_flat = np.asarray(vecs).reshape(neigen, -1)
            order = np.argsort(vals)
            return np.asarray(vals)[order], vecs_flat[order]

        if k >= m:
            # thick restart with the lowest l_keep Ritz pairs
            l = min(l_keep, k - 1)
            s_keep = jnp.asarray(s_np[:, :l].T, dtype)
            basis, hbasis = _dav_restart(basis, hbasis, s_keep)
            t_mat = jnp.zeros((m, m), dtype)
            t_mat = t_mat.at[jnp.arange(l), jnp.arange(l)].set(
                jnp.asarray(theta_np[:l], dtype))
            k = l
        v_next = x_low[1] if x_low is not None else None
        if v_next is None:
            key, sub = jax.random.split(key)
            v_next = put(jax.random.normal(sub, vshape, dtype))
    raise RuntimeError(
        f"davidson_ground_state: no convergence after {max_iter} "
        f"iterations ({n_conv}/{neigen} converged, dim={dim})")
