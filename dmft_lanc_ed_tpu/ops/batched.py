"""Batched small-sector diagonalization.

The reference scans sectors strictly sequentially (ED_DIAG.f90:58-278); at
nbath=9 that is ~121 dispatch+solve round trips, most over sectors with only
1e2-1e4 states — far too small to occupy the device individually. Here
sectors whose padded dense factors share a shape bucket are *stacked* and
solved by one vmapped thick-restart Lanczos: every Krylov step is a single
batched matmul over [B, DimDw_p, DimUp_p] vectors, so the scan cost collapses from
sum-of-dispatches to a handful of bucket solves.

Mechanics:
- each sector's :class:`~.dense.DenseSectorOp` is zero-padded on both hop
  axes to the bucket shape; padded rows form an exactly decoupled invariant
  subspace whose diagonal is shifted by +PAD_SHIFT (the same construction as
  the sharded path's communicator-shrink replacement,
  ``parallel.production.pad_dense_op``), and start vectors carry exact-zero
  pad components, so the physical spectrum is computed exactly;
- the stacked operator is a single pytree with a leading batch axis; the
  thick-restart basis builder (:func:`.lanczos._build_basis_rr`) is vmapped
  over it unchanged;
- restart control (Ritz extraction, residual tests) runs per element on
  host; the bucket iterates until every element converged. Elements that
  fail to converge inside the bucket budget are returned unsolved and fall
  back to the serial path (rare: clustered spectra).
"""
from __future__ import annotations

import logging
from functools import partial
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .dense import DenseSectorOp, matvec_dense, matvec_dense_mixed
from .lanczos import _build_basis_rr, _ritz, refine_eigenpairs

log = logging.getLogger("dmft_lanc_ed_tpu")

PAD_SHIFT = 1.0e3
B_FIXED = 8        # chunked batch size (one vmapped executable per shape)
_PREFIX_PIN = 1.0e12   # projected-diagonal pin for empty prefix slots


def _pow2_at_least(n: int, floor: int = 16) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def bucket_key(op: DenseSectorOp) -> Tuple:
    """Shape-bucket key: padded hop dims + aux-term structure.

    Buckets stay RECTANGULAR (square-merging was measured to inflate the
    warm solve 2.3x at nbath=9 — very rectangular sectors pay up to 16x
    matvec work); the executable count is controlled instead by a FIXED
    chunked batch size and a single pinned prefix-size variant, so the
    key set is one per distinct padded shape (round-5 cold-diag fix)."""
    du_p = _pow2_at_least(op.dim_up, floor=64)
    dd_p = _pow2_at_least(op.dim_dw, floor=64)
    nd_t = 0 if op.nd_a is None else op.nd_a.shape[0]
    return (du_p, dd_p, op.dim_ph, nd_t)


def pad_dense_op_2d(op: DenseSectorOp, du_p: int, dd_p: int) -> DenseSectorOp:
    """Zero-pad both hop axes to (du_p, dd_p); pad diagonal += PAD_SHIFT.

    Padding runs on HOST numpy: eager jnp.pad compiles one tiny executable
    per distinct (source, target) shape pair — dozens across a sector
    scan."""
    du, dd = op.dim_up, op.dim_dw
    pu, pd = du_p - du, dd_p - dd
    if pu == 0 and pd == 0:
        return op

    dev = hasattr(op.diag, "devices")        # jnp array -> stay on device

    def hpad(x, widths):
        out = np.pad(np.asarray(x), widths)
        return jnp.asarray(out) if dev else out

    kw = {}
    if op.nd_a is not None:
        kw.update(
            nd_a=hpad(op.nd_a, ((0, 0), (0, pu), (0, pu))),
            nd_a32=hpad(op.nd_a32, ((0, 0), (0, pu), (0, pu))),
            nd_b=hpad(op.nd_b, ((0, 0), (0, pd), (0, pd))),
            nd_b32=hpad(op.nd_b32, ((0, 0), (0, pd), (0, pd))))
    if op.ph_diag is not None:
        kw.update(ph_diag=op.ph_diag, eph_x=op.eph_x,
                  eph_el=hpad(op.eph_el, ((0, pd), (0, pu))))
    diag = np.pad(np.asarray(op.diag), ((0, pd), (0, pu)))
    if pd:
        diag[dd:, :] += PAD_SHIFT
    if pu:
        diag[:dd, du:] += PAD_SHIFT
    return DenseSectorOp(
        diag=jnp.asarray(diag) if dev else diag,
        hup=hpad(op.hup, ((0, pu), (0, pu))),
        hup32=hpad(op.hup32, ((0, pu), (0, pu))),
        hdw=hpad(op.hdw, ((0, pd), (0, pd))),
        hdw32=hpad(op.hdw32, ((0, pd), (0, pd))),
        nnz_count=op.nnz_count, **kw)


_OP_FIELDS = ("diag", "hup", "hdw", "hup32", "hdw32", "nd_a", "nd_b",
              "nd_a32", "nd_b32", "ph_diag", "eph_el", "eph_x")


def stack_ops(ops: Sequence[DenseSectorOp]) -> DenseSectorOp:
    """Stack same-shape ops into one pytree with a leading batch axis."""
    def st(f):
        vals = [getattr(o, f) for o in ops]
        if vals[0] is None:
            return None
        return jnp.asarray(np.stack([np.asarray(v) for v in vals]))
    return DenseSectorOp(nnz_count=sum(o.nnz_count for o in ops),
                         **{f: st(f) for f in _OP_FIELDS})


def _slice_op(stacked: DenseSectorOp, b: int) -> DenseSectorOp:
    fields = {f: (None if getattr(stacked, f) is None
                  else getattr(stacked, f)[b]) for f in _OP_FIELDS}
    return DenseSectorOp(nnz_count=stacked.nnz_count, **fields)


_APPLY = {"f64": matvec_dense, "mixed": matvec_dense_mixed}


@partial(jax.jit, static_argnames=("m", "l", "op_apply", "fast_proj"))
def _bucket_restart(stacked, basis_prev, s_keep, theta0, v_start, m: int,
                    l: int, op_apply, fast_proj: bool = False):
    """One thick restart of the whole bucket in ONE dispatch: the Ritz
    prefix is combined from the PREVIOUS basis inside the jit (s_keep is a
    small host array shipped with the call), and the per-element
    tridiagonal + residual coupling come back as ONE packed array, one
    host round trip per restart instead of ~5."""
    prefix = jnp.einsum("bml,bm...->bl...", s_keep, basis_prev)

    def one(op_b, prefix_b, theta_b, v_b):
        return _build_basis_rr(op_b, prefix_b, theta_b, v_b, m, l, op_apply,
                               fast_proj=fast_proj)

    res = jax.vmap(one)(stacked, prefix, theta0, v_start)
    b = res.t_mat.shape[0]
    packed = jnp.concatenate([res.t_mat.reshape(b, -1),
                              res.beta_last[:, None]], axis=1)
    return res.v_basis, res.v_next, packed


@jax.jit
def _rotate_element(s_cols, basis, i):
    """Ritz rotation of element i of the stacked basis — ONE executable
    per bucket shape (a python-int index would bake a distinct constant
    per element and compile per element; round-5 compile-count fix)."""
    basis_i = jax.lax.dynamic_index_in_dim(basis, i, 0, keepdims=False)
    return jnp.tensordot(s_cols.T, basis_i, axes=1)


def _take_op(stacked: "DenseSectorOp", i) -> "DenseSectorOp":
    """Element i of a stacked op via runtime-index takes (shape-keyed
    executables, unlike python-int slicing)."""
    idx = jnp.asarray(i)
    fields = {f: (None if getattr(stacked, f) is None
                  else jnp.take(getattr(stacked, f), idx, axis=0))
              for f in _OP_FIELDS}
    return DenseSectorOp(nnz_count=stacked.nnz_count, **fields)


def transpose_op(op: DenseSectorOp) -> DenseSectorOp:
    """Spin-flip-transposed operator: solving H^T over transposed vectors.

    (diag o V + V hup + hdw V + sum_t B_t V A_t^T)^T
      = diag^T o V^T + V^T hdw + hup V^T + sum_t A_t V^T B_t^T
    (hup/hdw symmetric), so the roles just swap. Used to canonicalize the
    bucket orientation: a sector and its (ndw, nup) mirror then share ONE
    vmapped executable instead of compiling transposed twins (round-5
    cold-diag fix). Eigenvectors come back transposed; the caller swaps
    the axes."""
    dev = hasattr(op.diag, "devices")

    def t(x):
        out = np.ascontiguousarray(np.asarray(x).T)
        return jnp.asarray(out) if dev else out

    kw = {}
    if op.nd_a is not None:
        kw.update(nd_a=op.nd_b, nd_b=op.nd_a,
                  nd_a32=op.nd_b32, nd_b32=op.nd_a32)
    if op.ph_diag is not None:
        kw.update(ph_diag=op.ph_diag, eph_x=op.eph_x, eph_el=t(op.eph_el))
    return DenseSectorOp(
        diag=t(op.diag),
        hup=op.hdw, hdw=op.hup, hup32=op.hdw32, hdw32=op.hup32,
        nnz_count=op.nnz_count, **kw)


def _batched_apply(precision: str) -> Callable:
    base = _APPLY[precision]
    return jax.vmap(base)


def _pad_vec(v_flat: np.ndarray, op: DenseSectorOp, du_p: int, dd_p: int,
             dim_ph: int) -> np.ndarray:
    """Flat sector vector -> padded natural shape with exact-zero pad."""
    du, dd = op.dim_up, op.dim_dw
    if dim_ph > 1:
        v = v_flat.reshape(dim_ph, dd, du)
        return np.pad(v, ((0, 0), (0, dd_p - dd), (0, du_p - du)))
    v = v_flat.reshape(dd, du)
    return np.pad(v, ((0, dd_p - dd), (0, du_p - du)))


def _unpad_vec(v_nd: np.ndarray, op: DenseSectorOp) -> np.ndarray:
    du, dd = op.dim_up, op.dim_dw
    if v_nd.ndim == 3:
        return np.asarray(v_nd)[:, :dd, :du].reshape(-1)
    return np.asarray(v_nd)[:dd, :du].reshape(-1)


def lanczos_ground_state_bucket(
    ops: Sequence[DenseSectorOp],
    neigen: int,
    tol: float,
    precision: str = "f64",
    ncv: Optional[int] = None,
    max_restarts: int = 60,
    seed: int = 17,
    dtype=jnp.float64,
) -> List[Optional[Tuple[np.ndarray, np.ndarray]]]:
    """Solve a shape bucket of sectors in one vmapped thick-restart Lanczos.

    Returns per-sector (evals [k], evecs [k, dim] flat, unpadded) or None
    for elements that did not converge within the bucket budget.
    """
    nb = len(ops)
    # pad the batch to the fixed chunk size (or the next pow2 above it)
    # with copies of the last op (dummy elements, results ignored) so the
    # vmapped executables key on (bucket, B) with B from a tiny set
    b = B_FIXED
    while b < nb:
        b *= 2
    ops = list(ops) + [ops[-1]] * (b - nb)
    du_p, dd_p, dim_ph, _ = bucket_key(ops[0])
    padded = [pad_dense_op_2d(o, du_p, dd_p) for o in ops]
    stacked = stack_ops(padded)
    vshape = (dim_ph, dd_p, du_p) if dim_ph > 1 else (dd_p, du_p)
    dims = [o.dim for o in ops]
    max_dim = max(dims)
    neigen = min(neigen, min(dims))
    m = ncv or max(2 * neigen + 16, 32)
    m = min(m, min(dims))
    l_keep = min(max(2 * neigen, neigen + 4), max(m - 4, 1))
    apply_nd = _APPLY[precision]
    rng = np.random.default_rng(seed)

    # start vectors: random in the physical block, exact zero in the pad
    # (normalized on host — no per-bucket norm executables)
    v0h = np.stack([
        _pad_vec(rng.standard_normal(o.dim), o, du_p, dd_p, dim_ph)
        for o in ops])
    v0h /= np.sqrt((v0h.reshape(b, -1) ** 2).sum(axis=1)).reshape(
        (b,) + (1,) * len(vshape))
    v0 = jnp.asarray(v0h, dtype)

    from ..utils.observability import kernel_stats
    # the prefix block is ALWAYS l_fix slots wide (one executable per
    # bucket shape instead of an l=0 first-restart variant): empty slots
    # hold exact-zero rows (projections are no-ops) with their projected
    # diagonal pinned at +_PREFIX_PIN so they sort above every physical
    # Ritz value. Each restart is ONE fused dispatch (_bucket_restart:
    # prefix combination inside the jit, tridiagonal + residual coupling
    # back as one packed pull).
    l_fix = min(l_keep, m - 2)
    l = l_fix
    s_keep = np.zeros((b, m, l_fix))
    new_theta = np.full((b, l_fix), _PREFIX_PIN)
    basis = jnp.zeros((b, m) + vshape, dtype)    # unused on the 1st restart
    done: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for restart in range(max_restarts):
        basis, v_next, packed = _bucket_restart(
            stacked, basis, jnp.asarray(s_keep, dtype),
            jnp.asarray(new_theta, dtype), v0, m, l, apply_nd,
            fast_proj=(precision != "f64"))
        kernel_stats.record(b * (m - l), stacked.nnz_count // max(b, 1))
        packed_np = np.asarray(packed, np.float64)
        t_np = packed_np[:, :-1].reshape(b, m, m)
        beta_np = packed_np[:, -1]
        l_next = l_fix
        s_keep = np.zeros((b, m, l_next))
        new_theta = np.zeros((b, l_next))
        all_done = True
        for i in range(b):
            if i >= nb:
                continue               # pow2 pad dummy (copy of the last op)
            theta_i, s_i = _ritz(t_np[i], m)
            s_keep[i] = s_i[:, :l_next]
            new_theta[i] = theta_i[:l_next]
            if i in done:
                continue
            resid = np.abs(beta_np[i] * s_i[m - 1, :])
            n_conv = 0
            while (n_conv < m and
                   resid[n_conv] <= tol * max(abs(theta_i[n_conv]), 1.0)):
                n_conv += 1
            if n_conv >= neigen:
                s = jnp.asarray(s_i[:, :neigen])
                vecs = _rotate_element(s, basis, jnp.asarray(i))
                vals = theta_i[:neigen]
                if precision != "f64":
                    # mixed-apply floor eta ~ 3e-6: the standard
                    # self-tuning polish pins the values in <= 3 rounds
                    # (an f32 BASIS would need a residual-guarded loop
                    # here — measured 25 s/solve — which is why the basis
                    # stays f64; see diag._solve_batched_sectors)
                    vals, vecs = refine_eigenpairs(
                        _take_op(stacked, i), matvec_dense, vecs)
                order = np.argsort(vals)
                vecs_h = np.asarray(vecs)
                flat = np.stack([_unpad_vec(vecs_h[k], ops[i])
                                 for k in order])
                done[i] = (np.asarray(vals)[order], flat)
            else:
                all_done = False
        if all_done:
            break
        # thick restart for every element (converged ones ride along);
        # s_keep/new_theta ship with the next _bucket_restart dispatch
        v0 = v_next
        # exhausted chains restart from fresh random physical directions
        dead = beta_np <= 0.0
        if dead.any():
            v0 = np.array(v0)            # writable host copy
            for i in np.nonzero(dead)[0]:
                vi = _pad_vec(rng.standard_normal(ops[i].dim), ops[i],
                              du_p, dd_p, dim_ph)
                v0[i] = vi / np.linalg.norm(vi)
            v0 = jnp.asarray(v0)
    else:
        log.warning("batched bucket (%d sectors, shape %sx%s): %d/%d "
                    "unconverged after %d restarts — serial fallback",
                    nb, du_p, dd_p, nb - len(done), nb, max_restarts)
    return [done.get(i) for i in range(nb)]
