"""Krylov eigensolvers.

JAX replacement of the reference's P-ARPACK / plain-Lanczos layer
(SF_SP_LINALG `sp_eigh` / `sp_lanc_eigh` / `sp_lanc_tridiag`, used from
ED_DIAG.f90:151-204 and ED_GF_NORMAL.f90:224-238). Two pieces:

- :func:`lanczos_tridiag` — plain 3-term recurrence producing the (alpha,
  beta) tridiagonal for the Green's-function continued fraction; a single
  ``lax.scan`` of the sector matvec, no reorthogonalization (same numerics as
  the reference's GF path).

- :func:`lanczos_ground_state` — lowest eigenpairs via restarted Lanczos with
  *full* reorthogonalization (CGS2) and locking/deflation of converged Ritz
  vectors. This replaces ARPACK's implicitly-restarted Arnoldi: full reorth +
  explicit deflation gives the same robust degenerate-ground-state detection
  (gs_threshold semantics) in a form that is one fixed-shape jitted scan per
  restart — XLA-friendly, no reverse-communication host round-trips per
  matvec.

Operators are passed as ``(op, op_apply)`` where ``op`` is a pytree (e.g.
:class:`~dmft_lanc_ed_tpu.hamiltonian.SectorHamiltonian`) and ``op_apply`` a
module-level function ``op_apply(op, v_flat) -> H v_flat``. Keeping the apply
function at module scope (stable hash) lets jit cache one executable per
sector *shape* instead of per sector.

All routines run in the configured dtype (float64 by default: the reference
demands lanc_tolerance-level orthogonality).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_EPS = 1e-30
_HIGHEST = jax.lax.Precision.HIGHEST


# --------------------------------------------------------------------------
# plain tridiagonalization (GF path)
# --------------------------------------------------------------------------
@partial(jax.jit, static_argnames=("m", "op_apply"))
def lanczos_tridiag(op, v0: jnp.ndarray, m: int, op_apply: Callable
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """m-step Lanczos tridiagonalization from normalized v0.

    Returns (alphas[m], betas[m]) with betas[0] == 0 and betas[i] the
    subdiagonal coupling step i-1 <-> i — exactly the (alanc, blanc) layout
    consumed by add_to_lanczos_* in the reference (diag=alanc,
    subdiag(2:)=blanc(2:), ED_GF_NORMAL.f90:633-637). After an invariant
    subspace is exhausted (beta=0) the chain zeros out, contributing only
    zero-weight poles.
    """
    def step(carry, _):
        v_prev, v, beta = carry
        w = op_apply(op, v) - beta * v_prev
        alpha = jnp.vdot(v, w).real.astype(v.dtype)
        w = w - alpha * v
        beta_new = jnp.linalg.norm(w)
        ok = beta_new > _EPS
        v_new = jnp.where(ok, w / jnp.where(ok, beta_new, 1.0), 0.0)
        beta_new = jnp.where(ok, beta_new, 0.0)
        alive = jnp.linalg.norm(v) > 0.5   # v is unit or exactly zero
        alpha = jnp.where(alive, alpha, 0.0)
        return (v, v_new, beta_new), (alpha, beta_new)

    (_, _, _), (alphas, betas) = jax.lax.scan(
        step, (jnp.zeros_like(v0), v0, jnp.array(0.0, v0.dtype)), None, length=m)
    betas = jnp.concatenate([jnp.zeros((1,), v0.dtype), betas[:-1]])
    return alphas, betas


@partial(jax.jit, static_argnames=("m", "op_apply"))
def lanczos_tridiag_batched(op, v0_batch: jnp.ndarray, m: int,
                            op_apply: Callable
                            ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched tridiagonalization: v0_batch [B, dim] -> (alphas, betas) [B, m].

    One vmapped scan drives B independent Krylov chains through the same
    sector operator — the GF builder batches every excitation that lands in
    the same target sector (replacing the reference's sequential per-orbital
    loops, ED_GF_NORMAL.f90:36-107) so the matvec streams the factor tables
    once for B vectors.
    """
    def one(v0):
        def step(carry, _):
            v_prev, v, beta = carry
            w = op_apply(op, v) - beta * v_prev
            alpha = jnp.vdot(v, w).real.astype(v.dtype)
            w = w - alpha * v
            beta_new = jnp.linalg.norm(w)
            ok = beta_new > _EPS
            v_new = jnp.where(ok, w / jnp.where(ok, beta_new, 1.0), 0.0)
            beta_new = jnp.where(ok, beta_new, 0.0)
            alive = jnp.linalg.norm(v) > 0.5
            alpha = jnp.where(alive, alpha, 0.0)
            return (v, v_new, beta_new), (alpha, beta_new)
        (_, _, _), (alphas, betas) = jax.lax.scan(
            step, (jnp.zeros_like(v0), v0, jnp.array(0.0, v0.dtype)),
            None, length=m)
        betas = jnp.concatenate([jnp.zeros((1,), v0.dtype), betas[:-1]])
        return alphas, betas
    return jax.vmap(one)(v0_batch)


def tridiag_eigh(alphas, betas) -> Tuple[np.ndarray, np.ndarray]:
    """Eigendecomposition of the Lanczos tridiagonal.

    Runs on host (LAPACK, like the reference's `eigh` on (alanc, blanc),
    ED_GF_NORMAL.f90:637): the matrix is tiny (m x m), and a device eigh
    would be one more compile per chain length for no gain.
    """
    a = np.asarray(alphas)
    b = np.asarray(betas)
    t = np.diag(a) + np.diag(b[1:], 1) + np.diag(b[1:], -1)
    return np.linalg.eigh(t)


# --------------------------------------------------------------------------
# ground-state solver: thick-restart Lanczos (Rayleigh-Ritz restarted)
# --------------------------------------------------------------------------
class _BasisResult(NamedTuple):
    v_basis: jnp.ndarray    # [m, *vshape]
    t_mat: jnp.ndarray      # [m, m] projected matrix (upper triangle valid)
    beta_last: jnp.ndarray  # coupling out of the last vector (residual norm)
    v_next: jnp.ndarray     # normalized residual direction (or zeros)


def _proj(basis: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """[k] coefficients <basis_j, w> for nd-shaped vectors."""
    return jnp.tensordot(basis, w, axes=w.ndim)


def _comb(coeff: jnp.ndarray, basis: jnp.ndarray) -> jnp.ndarray:
    """sum_j coeff_j basis_j (nd-shaped)."""
    return jnp.tensordot(coeff, basis, axes=1)


@partial(jax.jit, static_argnames=("m", "l", "op_apply", "fast_proj"))
def _build_basis_rr(op, prefix, theta0, v_start, m: int, l: int,
                    op_apply: Callable,
                    fast_proj: bool = False) -> _BasisResult:
    """Extend an l-vector Ritz prefix to an m-vector orthonormal basis.

    Thick-restart Lanczos with CGS2 full reorthogonalization: the prefix rows
    are Ritz vectors of the previous restart (so the projected matrix is
    diag(theta0) on the prefix block — standard TRLan); the remaining m-l
    vectors are built by the Lanczos recurrence with full reorth, and the
    projected matrix T[j,i] = <v_j, H v_i> is recorded from the first-pass
    orthogonalization coefficients. Replaces ARPACK's implicit restarts
    (sp_eigh, ED_DIAG.f90:151-171) with a fixed-shape jitted loop.

    ``fast_proj`` runs the CGS2 projection/combination matmuls on an f32
    shadow of the basis at HIGHEST precision while the vectors and norms
    stay f64. The orthogonality floor becomes ~1e-7 — the same scale as
    the mixed-precision matvec noise the tolerance floor (3e-6) and the
    f64 Rayleigh-Ritz polish already absorb. Only enabled by callers whose
    apply is itself mixed precision (the batched bucket solver).
    """
    dtype = v_start.dtype
    vshape = v_start.shape
    vb = jnp.zeros((m,) + vshape, dtype)
    t_mat = jnp.zeros((m, m), dtype)
    if l:
        vb = vb.at[:l].set(prefix)
        t_mat = t_mat.at[jnp.arange(l), jnp.arange(l)].set(theta0)

    use32 = fast_proj and dtype == jnp.float64
    vb32 = vb.astype(jnp.float32) if use32 else None

    def cgs_pass(vb, vb32, w):
        """One classical GS pass; returns (coefficients, w_orthogonal)."""
        if use32:
            c32 = jnp.tensordot(vb32, w.astype(jnp.float32),
                                axes=w.ndim, precision=_HIGHEST)
            corr = jnp.tensordot(c32, vb32, axes=1, precision=_HIGHEST)
            return c32.astype(dtype), w - corr.astype(dtype)
        c = _proj(vb, w)
        return c, w - _comb(c, vb)

    # orthonormalize the start vector against the prefix (CGS2)
    _, v = cgs_pass(vb, vb32, v_start)
    _, v = cgs_pass(vb, vb32, v)
    v = v / jnp.maximum(jnp.linalg.norm(v), _EPS)

    def body(i, carry):
        vb, vb32, t_mat, v, _ = carry
        vb = jax.lax.dynamic_update_index_in_dim(vb, v, i, 0)
        if use32:
            vb32 = jax.lax.dynamic_update_index_in_dim(
                vb32, v.astype(jnp.float32), i, 0)
        # cast to the basis dtype: a mixed apply promotes through its f64
        # diagonal even when the basis runs f32
        w = op_apply(op, v).astype(v.dtype)
        c1, w = cgs_pass(vb, vb32, w)   # rows > i are zero -> c1 zero there
        t_mat = jax.lax.dynamic_update_slice(t_mat, c1[:, None], (0, i))
        _, w = cgs_pass(vb, vb32, w)    # second CGS pass
        beta = jnp.linalg.norm(w)
        ok = beta > 1e-14
        v_new = jnp.where(ok, w / jnp.where(ok, beta, 1.0), 0.0)
        beta = jnp.where(ok, beta, 0.0)
        return vb, vb32, t_mat, v_new, beta

    if not use32:
        vb32 = jnp.zeros((1,), dtype)   # loop-carry placeholder
    init = (vb, vb32, t_mat, v, jnp.array(0.0, dtype))
    vb, _, t_mat, v_next, beta_last = jax.lax.fori_loop(l, m, body, init)
    return _BasisResult(vb, t_mat, beta_last, v_next)


def _ritz(t_mat: np.ndarray, m: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host eigendecomposition of the (upper-triangle-valid) projected T."""
    t = np.triu(t_mat[:m, :m])
    t = t + np.triu(t, 1).T
    return np.linalg.eigh(t)


def lanczos_ground_state(
    op,
    op_apply: Callable,
    dim: int,
    neigen: int,
    ncv: Optional[int] = None,
    tol: float = 1e-14,
    max_restarts: int = 400,
    seed: int = 17,
    dtype=jnp.float64,
    v0: Optional[jnp.ndarray] = None,
    vshape: Optional[Tuple[int, ...]] = None,
    sharding=None,
    polish_apply: Optional[Callable] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Lowest `neigen` eigenpairs of the operator. Replaces ARPACK `sp_eigh`.

    Vectors live in their natural shape `vshape` (default flat ``(dim,)``) so
    the same solver runs serial or SPMD-sharded: pass a
    ``jax.sharding.NamedSharding`` for the vector layout (e.g. dw-sharded
    [DimDw, DimUp]) and XLA inserts the psum/reduce-scatter collectives in
    the projections — the P-ARPACK distributed-reduction analogue.

    With ``polish_apply`` (an f64-exact apply), eigenpairs from a
    mixed-precision run are refined by :func:`refine_eigenpairs`.

    Returns (energies [k], vectors [k, dim] flat) ascending, k == neigen.
    """
    vshape = tuple(vshape) if vshape is not None else (dim,)
    neigen = min(neigen, dim)
    m = ncv or max(2 * neigen + 16, 32)
    m = min(m, dim)
    l_keep = min(max(2 * neigen, neigen + 4), max(m - 4, 1))
    key = jax.random.PRNGKey(seed)

    def put(x):
        return jax.device_put(x, sharding) if sharding is not None else x

    if v0 is None:
        key, sub = jax.random.split(key)
        v0 = jax.random.normal(sub, vshape, dtype)
    else:
        v0 = jnp.reshape(v0, vshape)
    v0 = put(v0 / jnp.linalg.norm(v0))

    from ..utils.observability import kernel_stats
    prefix = jnp.zeros((0,) + vshape, dtype)
    theta0 = jnp.zeros((0,), dtype)
    l = 0
    stall = 0
    n_conv_prev = 0
    for restart in range(max_restarts):
        res = _build_basis_rr(op, prefix, theta0, v0, m, l, op_apply)
        kernel_stats.record(m - l, getattr(op, "nnz", 0))
        theta_np, s_np = _ritz(np.asarray(res.t_mat), m)
        resid = np.abs(float(res.beta_last) * s_np[m - 1, :])
        # converged prefix count (keep spectral order)
        n_conv = 0
        while (n_conv < m and
               resid[n_conv] <= tol * max(abs(theta_np[n_conv]), 1.0)):
            n_conv += 1
        if n_conv >= neigen:
            s = jnp.asarray(s_np[:, :neigen])
            vecs = jnp.tensordot(s.T, res.v_basis, axes=1)  # [k, *vshape]
            vals = theta_np[:neigen]
            if polish_apply is not None:
                vals, vecs = refine_eigenpairs(op, polish_apply, vecs,
                                               sharding=sharding)
            vecs_flat = np.asarray(vecs).reshape(neigen, -1)
            order = np.argsort(vals)
            return np.asarray(vals)[order], vecs_flat[order]

        # thick restart: keep the lowest l_keep Ritz pairs + the residual
        l = min(l_keep, m - 2)
        s = jnp.asarray(s_np[:, :l])
        prefix = jnp.tensordot(s.T, res.v_basis, axes=1)
        theta0 = jnp.asarray(theta_np[:l], dtype)
        if float(res.beta_last) > 0.0:
            v0 = res.v_next
        else:
            # invariant subspace exhausted — fresh random direction
            key, sub = jax.random.split(key)
            v0 = put(jax.random.normal(sub, vshape, dtype))
        # adaptive basis growth for clustered/slow spectra
        stall = 0 if n_conv > n_conv_prev else stall + 1
        n_conv_prev = n_conv
        m_cap = min(dim, max(4 * (ncv or 32), 256))
        if stall >= 20 and m < m_cap:
            m = min(m_cap, 2 * m)
            l_keep = min(max(2 * neigen, neigen + 4), max(m - 4, 1))
            stall = 0
    raise RuntimeError(
        f"lanczos_ground_state: no convergence after {max_restarts} restarts "
        f"({n_conv_prev}/{neigen} converged, dim={dim})")


def refine_eigenpairs(op, op_apply: Callable, vecs: jnp.ndarray,
                      steps: int = 2, sharding=None, max_rounds: int = 3
                      ) -> Tuple[np.ndarray, jnp.ndarray]:
    """f64 Rayleigh-Ritz polish of approximate eigenpairs (self-tuning:
    repeats the block-Krylov refinement until the Ritz values stabilize to
    1e-13 relative or ``max_rounds`` — each round squares the subspace
    error, so a 1e-5-accurate mixed-precision start reaches f64 in two
    rounds).

    Builds the block Krylov space [V, HV, ..., H^steps V] with the exact
    apply, orthonormalizes it by modified Gram-Schmidt with full
    reorthogonalization (two passes), and solves the small projected
    eigenproblem. An input eigenvector with error eta returns with
    eigenvalue error O(eta^2) (Rayleigh quotient) or better — this is how
    mixed-precision Lanczos recovers f64-accurate spectra.

    Numerical note (round-3 fix): the previous Gram-whitening construction
    amplified f64 Gram noise through the near-singular unnormalized power
    basis (dynamic range ||H||^(2*steps)), producing spurious *below-
    minimum* Ritz values at the 1e-9 level on the 854k bench sector. MGS
    with reorthogonalization keeps the projected problem orthonormal to
    machine precision regardless of the basis conditioning.
    """
    vals_prev = None
    for _ in range(max_rounds):
        vals, vecs = _refine_once(op, op_apply, vecs, steps)
        if vals_prev is not None and np.all(
                np.abs(vals - vals_prev) <= 1e-13 *
                np.maximum(np.abs(vals), 1.0)):
            break
        vals_prev = vals
    return vals, vecs


_DROP_PIN = 1.0e12     # projected-diagonal pin for rank-dropped directions


@partial(jax.jit, static_argnames=("steps", "op_apply"))
def _refine_project(op, vecs, steps: int, op_apply: Callable):
    """Device half 1 of the polish: block power basis + CGS2 + projection.

    ONE dispatch: eager per-vector loops with float() syncs would cost
    ~40 host round trips per polish. Numerically identical to the loop it replaces: candidates are
    orthogonalized by two classical GS passes against every previously
    accepted vector; a candidate whose orthogonal remainder falls below
    1e-10 of its own norm is rank-dropped — here its slot becomes an
    exact-zero row (projecting against it is a no-op) and its projected
    diagonal is pinned at +_DROP_PIN so it can never appear among the
    lowest-k Ritz pairs. H is applied to ORTHONORMALIZED vectors only
    (the round-3 Gram-whitening bug stays fixed: the basis never carries
    the ||H||^(2 steps) dynamic range).

    Returns (b_mat [r, *vshape], a_mat [r, r], ok [r]) with
    r = (steps+1)*k.
    """
    vecs = jnp.asarray(vecs, jnp.float64)   # f32-chain starts promote here
    k = vecs.shape[0]
    vshape = vecs.shape[1:]
    axes = tuple(range(len(vshape)))

    rows, oks, h_of_row = [], [], {}

    def cgs2(w):
        for _ in range(2):
            for b in rows:
                w = w - jnp.tensordot(b, w, axes=[axes, axes]) * b
        return w

    def accept(cand):
        cand_nrm = jnp.linalg.norm(cand)
        w = cgs2(cand)
        nrm = jnp.linalg.norm(w)
        ok = nrm > 1e-10 * jnp.maximum(cand_nrm, 1.0)
        b = jnp.where(ok, w / jnp.where(ok, nrm, 1.0), jnp.zeros_like(w))
        rows.append(b)
        oks.append(ok)
        return len(rows) - 1

    frontier = [accept(vecs[j]) for j in range(k)]
    for step in range(steps):
        nxt = []
        for idx in frontier:
            hv = op_apply(op, rows[idx]).reshape(vshape)
            h_of_row[idx] = hv        # H b computed once, reused for A
            nxt.append(accept(hv))
        frontier = nxt
    r = len(rows)
    for i in range(r):                # last-level rows still need H b
        if i not in h_of_row:
            h_of_row[i] = op_apply(op, rows[i]).reshape(vshape)

    b_mat = jnp.stack(rows)
    hb = jnp.stack([h_of_row[i] for i in range(r)])
    okv = jnp.stack(oks)
    full_axes = tuple(a + 1 for a in axes)
    a_mat = jnp.tensordot(b_mat, hb, axes=[full_axes, full_axes])
    a_mat = 0.5 * (a_mat + a_mat.T)
    a_mat = jnp.where(okv[:, None] & okv[None, :], a_mat, 0.0) \
        + jnp.diag(jnp.where(okv, 0.0, _DROP_PIN))
    return b_mat, a_mat, okv


@jax.jit
def _refine_combine(s_cols, b_mat):
    """Device half 2: Ritz rotation + renormalization (one dispatch).

    The norm is clamped away from zero: if rank-drop left fewer valid
    basis rows than requested pairs, the lowest-k Ritz columns can include
    a _DROP_PIN direction whose rotated vector is exactly zero — the clamp
    keeps it a (useless but finite) zero vector instead of NaN; the caller
    detects the case from the pinned eigenvalue (ADVICE r4)."""
    k = s_cols.shape[1]
    nd = b_mat.ndim - 1
    vecs_out = jnp.tensordot(s_cols.T, b_mat, axes=1)
    nrm = jnp.sqrt(jnp.sum(vecs_out.reshape(k, -1) ** 2, axis=1))
    nrm = jnp.maximum(nrm, jnp.asarray(1e-200, nrm.dtype))
    return vecs_out / nrm.reshape((k,) + (1,) * nd)


def _refine_once(op, op_apply: Callable, vecs: jnp.ndarray, steps: int
                 ) -> Tuple[np.ndarray, jnp.ndarray]:
    k = vecs.shape[0]
    b_mat, a_mat, _ = _refine_project(op, jnp.asarray(vecs, jnp.float64),
                                      steps, op_apply)
    vals, s = np.linalg.eigh(np.asarray(a_mat))   # tiny r x r, host LAPACK
    if vals[k - 1] >= 0.5 * _DROP_PIN:
        # degenerate projected basis: fewer valid directions than requested
        # pairs — surface it instead of returning a silent zero vector
        import logging
        logging.getLogger("dmft_lanc_ed_tpu").warning(
            "refine_eigenpairs: rank-dropped basis leaves < %d valid "
            "directions (pinned Ritz value present); results truncated", k)
    vecs_out = _refine_combine(jnp.asarray(s[:, :k]), b_mat)
    return vals[:k], vecs_out
