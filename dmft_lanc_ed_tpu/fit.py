"""Chi^2 bath fitting.

JAX re-design of ED_FIT_CHI2.f90 + ED_FIT_CHI2/fitgf_*.f90: the
reference hand-derives dDelta/d(eps,V) gradients and runs a Fortran77 CG;
here the Anderson functions are pure JAX, so the exact gradient of

    chi2(theta) = (1/Ldelta) sum_n |F(iw_n) - F_And(iw_n; theta)|^cg_pow / W_n

comes from `jax.grad`, and the minimizer is L-BFGS-B driven by a jitted
value-and-grad. Weight W_n = 1, n, or w_n per cg_weight
(ED_FIT_CHI2.f90:406-418); cg_scheme selects the fitted function: "delta"
fits Delta(z), "weiss" fits G0and(z) (ED_INPUT_VARS cg_scheme).

Fit granularity matches the reference dispatch (ED_FIT_CHI2.f90:88-99):
- normal : independent (spin, orbital) fits over (e_k, V_k)       [2 Nbath]
- hybrid : per-spin joint fit over (e_k, V_{a k})                 [(1+Norb) Nbath]
- replica: joint fit over (V_p, lambda_{p m}) with all orbital
  components entering chi2 (fitgf_replica)
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from scipy.optimize import minimize as _scipy_minimize

from .bath import Bath, pack_bath, unpack_bath
from .bath_functions import delta_bath, g0and_bath
from .config import EDConfig
from .solver import matsubara_grid
from .utils import on_host


def _cabs_pow(x: jnp.ndarray, p: int) -> jnp.ndarray:
    """|x|^p for complex x, differentiable at 0 for even p."""
    a2 = x.real ** 2 + x.imag ** 2
    return a2 if p == 2 else a2 ** (p / 2.0)


def _fit_weight(cfg: EDConfig, wm: np.ndarray) -> np.ndarray:
    if cfg.cg_weight == 2:
        return np.arange(1, len(wm) + 1, dtype=np.float64)
    if cfg.cg_weight == 3:
        return wm.copy()
    return np.ones(len(wm))


def _target_fn(cfg: EDConfig):
    """Function (bath, hloc, z) -> fitted quantity, per cg_scheme."""
    if cfg.cg_scheme == "delta":
        return lambda bath, hloc, z, h_basis: delta_bath(cfg, bath, z, h_basis)
    return lambda bath, hloc, z, h_basis: g0and_bath(cfg, hloc, bath, z,
                                                     h_basis)


@on_host
def chi2_fitgf(cfg: EDConfig, target: np.ndarray, bath_array: np.ndarray,
               hloc: np.ndarray, ispin: Optional[int] = None,
               h_basis: Optional[np.ndarray] = None,
               outdir: Optional[str] = None,
               suffix: str = "") -> np.ndarray:
    """Fit the bath to the Weiss field / hybridization (ed_chi2_fitgf).

    target: [nspin, nspin, norb, norb, Lmats] Weiss or Delta on the
    fermionic Matsubara grid. Returns the updated packed bath array.

    When ``outdir`` is given, writes the reference's fit diagnostics:
    ``chi2fit_results*<suffix>.ed`` (appended chi^2 | iterations per fit,
    fitgf_normal_normal.f90:147-152) and ``fit_{weiss,delta}*<suffix>.ed``
    (target vs fitted function, :186-205). ``suffix`` is the per-site
    ``ed_file_suffix`` analogue (e.g. ``_ineq0001``).
    """
    wm_full = matsubara_grid(cfg)
    lfit = min(cfg.lfit, target.shape[-1], len(wm_full))
    wm = wm_full[:lfit]
    z = jnp.asarray(1j * wm)
    wgt = jnp.asarray(_fit_weight(cfg, wm))
    spins = [ispin] if ispin is not None else list(range(cfg.nspin))

    nsym = h_basis.shape[0] if h_basis is not None else None
    bath = unpack_bath(cfg, bath_array, nsym=nsym)
    fn = _target_fn(cfg)
    hloc_j = jnp.asarray(hloc)
    h_basis_j = jnp.asarray(h_basis) if h_basis is not None else None
    # (file-suffix, chi, niter) per independent minimization
    fit_log: List[Tuple[str, float, int]] = []

    if cfg.bath_type == "normal":
        e = np.asarray(bath.e).copy()
        v = np.asarray(bath.v).copy()
        for s in spins:
            for a in range(cfg.norb):
                tgt = jnp.asarray(target[s, s, a, a, :lfit])

                def chi2(theta, s=s, a=a, tgt=tgt):
                    ek = theta[:cfg.nbath]
                    vk = theta[cfg.nbath:]
                    d = (vk[None, :] ** 2
                         / (z[:, None] - ek[None, :])).sum(-1)
                    if cfg.cg_scheme == "weiss":
                        d = 1.0 / (z + cfg.xmu - hloc_j[s, s, a, a] - d)
                    r = _cabs_pow(tgt - d, cfg.cg_pow)
                    return (r / wgt).sum() / lfit

                theta0 = np.concatenate([e[s, a], v[s, a]])
                theta, chi, nit = _minimize(cfg, chi2, theta0)
                fit_log.append((f"_orb{a + 1}_s{s + 1}{suffix}", chi, nit))
                e[s, a] = theta[:cfg.nbath]
                v[s, a] = np.abs(theta[cfg.nbath:])
        new_bath = Bath(e=e, v=v)

    elif cfg.bath_type == "hybrid":
        e = np.asarray(bath.e).copy()
        v = np.asarray(bath.v).copy()
        nb, no = cfg.nbath, cfg.norb
        for s in spins:
            tgt = jnp.asarray(target[s, s, :, :, :lfit])

            def chi2(theta, s=s, tgt=tgt):
                ek = theta[:nb]
                vk = theta[nb:].reshape(no, nb)
                denom = 1.0 / (z[:, None] - ek[None, :])       # [L, nb]
                d = jnp.einsum("ak,bk,lk->abl", vk, vk, denom)
                if cfg.cg_scheme == "weiss":
                    zmat = (z + cfg.xmu)[None, None, :] \
                        * jnp.eye(no, dtype=jnp.complex128)[:, :, None]
                    ig0 = zmat - hloc_j[s, s][:, :, None] - d
                    d = jnp.linalg.inv(ig0.transpose(2, 0, 1)).transpose(1, 2, 0)
                r = _cabs_pow(tgt - d, cfg.cg_pow)
                return (r / wgt[None, None, :]).sum() / lfit

            theta0 = np.concatenate([e[s, 0], v[s].reshape(-1)])
            theta, chi, nit = _minimize(cfg, chi2, theta0)
            fit_log.append((f"_ALLorb_s{s + 1}{suffix}", chi, nit))
            e[s, 0] = theta[:nb]
            v[s] = np.abs(theta[nb:].reshape(no, nb))
        new_bath = Bath(e=e, v=v)

    else:  # replica
        nb = cfg.nbath
        lam0 = np.asarray(bath.lam)
        v0 = np.asarray(bath.v_rep)
        nsym = lam0.shape[1]
        tgt = jnp.asarray(target[..., :lfit])

        def chi2(theta):
            v_r = theta[:nb * cfg.nspin].reshape(nb, cfg.nspin)
            lam = theta[nb * cfg.nspin:].reshape(nb, nsym)
            b = Bath(lam=lam, v_rep=v_r)
            d = fn(b, hloc_j, z, h_basis_j)
            r = _cabs_pow(tgt - d, cfg.cg_pow)
            return (r / wgt).sum() / lfit

        theta0 = np.concatenate([v0.reshape(-1), lam0.reshape(-1)])
        theta, chi, nit = _minimize(cfg, chi2, theta0)
        fit_log.append((suffix, chi, nit))
        v_r = np.abs(theta[:nb * cfg.nspin].reshape(nb, cfg.nspin))
        lam = theta[nb * cfg.nspin:].reshape(nb, nsym)
        new_bath = Bath(lam=lam, v_rep=v_r)

    if outdir is not None:
        for file_sfx, chi, nit in fit_log:
            _write_chi2_results(outdir, file_sfx, chi, nit)
        fgand = np.asarray(fn(new_bath, hloc_j, z, h_basis_j))
        _write_fit_functions(cfg, outdir, suffix, wm,
                             np.asarray(target[..., :lfit]), fgand, spins)
    return pack_bath(cfg, new_bath)


def _write_fit_functions(cfg: EDConfig, outdir: str, suffix: str,
                         wm: np.ndarray, fg: np.ndarray, fgand: np.ndarray,
                         spins) -> None:
    """Per-channel fit_{weiss,delta} files, matching the reference's
    per-bath-type suffix conventions (fitgf_normal_normal.f90:186-205,
    fitgf_hybrid_normal.f90:197-217, fitgf_replica.f90:182-207)."""
    if cfg.bath_type == "normal":
        for s in spins:
            for a in range(cfg.norb):
                _write_fit_function(cfg, outdir, f"_orb{a + 1}_s{s + 1}{suffix}",
                                    wm, fg[s, s, a, a], fgand[s, s, a, a])
    elif cfg.bath_type == "hybrid":
        for s in spins:
            for a in range(cfg.norb):
                for b in range(a, cfg.norb):
                    _write_fit_function(cfg, outdir,
                                        f"_l{a + 1}_m{b + 1}{suffix}",
                                        wm, fg[s, s, a, b], fgand[s, s, a, b])
    else:  # replica: every (spin-diagonal) component
        for s in range(cfg.nspin):
            for a in range(cfg.norb):
                for b in range(cfg.norb):
                    _write_fit_function(
                        cfg, outdir,
                        f"_l{a + 1}_m{b + 1}_s{s + 1}_r{s + 1}{suffix}",
                        wm, fg[s, s, a, b], fgand[s, s, a, b])


class _StopWatcher:
    """Reference fmin_cg stopping conditions (SF_OPTIMIZE istop semantics,
    surfaced as CG_STOP, ED_INPUT_VARS.f90:196):

        C1 = |F_{n-1} - F_n|   < ftol * (1 + F_n)
        C2 = ||x_{n-1} - x_n|| < ftol * (1 + ||x_n||)

    cg_stop = 0 -> C1.AND.C2, 1 -> C1, 2 -> C2. Implemented as a scipy
    callback that terminates the optimizer (StopIteration); this also fixes
    cg_method=1, where the reference ftol is a *function-value* tolerance,
    not scipy CG's gradient-norm gtol."""

    def __init__(self, fun_value, ftol: float, istop: int):
        self.fv = fun_value
        self.ftol = ftol
        self.istop = istop
        self.prev_x: Optional[np.ndarray] = None
        self.prev_f: Optional[float] = None
        self.nit = 0

    def __call__(self, xk, *_):
        xk = np.asarray(xk, dtype=np.float64)
        fk = self.fv(xk)
        self.nit += 1
        stop = False
        if self.prev_x is not None:
            c1 = abs(self.prev_f - fk) < self.ftol * (1.0 + abs(fk))
            c2 = (np.linalg.norm(self.prev_x - xk)
                  < self.ftol * (1.0 + np.linalg.norm(xk)))
            stop = {0: c1 and c2, 1: c1, 2: c2}.get(self.istop, c1 and c2)
        self.prev_x, self.prev_f = xk, fk
        if stop:
            raise StopIteration


def _minimize(cfg: EDConfig, chi2_fn,
              theta0: np.ndarray) -> Tuple[np.ndarray, float, int]:
    """Quasi-Newton descent on the chi2 (replaces fmin_cg/fmin_cgminimize).

    Reference dials honored (ED_FIT_CHI2.f90:84-141, ED_INPUT_VARS.f90:196-202):
    - cg_method: 0 -> L-BFGS-B (the default, supersedes the NR CG),
                 1 -> scipy nonlinear CG (the fmin_cgminimize analogue;
                 cg_minimize_ver picks Krauth/Lichtenstein variants in the
                 reference — both map onto the same scipy CG here)
    - cg_grad:   0 -> exact gradient via jax autodiff (the reference's
                 hand-derived analytic dDelta/dtheta chain rule comes for
                 free), 1 -> numerical finite-difference gradient with step
                 cg_minimize_hh (the reference's hh_par)
    - cg_stop / cg_ftol: C1/C2 relative tolerances via :class:`_StopWatcher`

    Returns (theta, chi2, niter).
    """
    numeric = cfg.cg_grad != 0
    f = jax.jit(lambda t: chi2_fn(jnp.asarray(t)))
    fval = lambda t: float(f(jnp.asarray(t)))
    if numeric:
        fun, jac = fval, None
    else:
        vg = jax.jit(jax.value_and_grad(
            lambda t: chi2_fn(jnp.asarray(t))))

        def fun(t):
            val, grad = vg(jnp.asarray(t))
            return float(val), np.asarray(grad, dtype=np.float64)
        jac = True

    watcher = _StopWatcher(fval, cfg.cg_ftol, cfg.cg_stop)
    if cfg.cg_method == 1:
        options = {"maxiter": cfg.cg_niter, "gtol": 1e-12}
        if numeric:
            options["eps"] = cfg.cg_minimize_hh
        res = _scipy_minimize(fun, theta0, jac=jac, method="CG",
                              callback=watcher, options=options)
    else:
        options = {"maxiter": cfg.cg_niter, "ftol": cfg.cg_ftol * 1e-3,
                   "gtol": 1e-12}
        if numeric:
            options["eps"] = cfg.cg_minimize_hh
        res = _scipy_minimize(fun, theta0, jac=jac, method="L-BFGS-B",
                              callback=watcher, options=options)
    theta = np.asarray(res.x)
    nit = int(getattr(res, "nit", watcher.nit) or watcher.nit)
    return theta, fval(theta), nit


def _write_chi2_results(outdir: str, suffix: str, chi: float,
                        niter: int) -> None:
    """chi2fit_results<suffix>.ed append record (fitgf_normal_normal.f90:147)."""
    with open(os.path.join(outdir, f"chi2fit_results{suffix}.ed"), "a") as fh:
        fh.write(f"{chi:18.9E} {niter:5d}\n")


def _write_fit_function(cfg: EDConfig, outdir: str, suffix: str,
                        wm: np.ndarray, fg_ch: np.ndarray,
                        fgand_ch: np.ndarray) -> None:
    """fit_{weiss,delta}<suffix>.ed: 5F24.15 columns
    (x, Im fg, Im fgand, Re fg, Re fgand) — fitgf_normal_normal.f90:186-205."""
    name = "fit_weiss" if cfg.cg_scheme == "weiss" else "fit_delta"
    with open(os.path.join(outdir, f"{name}{suffix}.ed"), "w") as fh:
        for x, g, ga in zip(wm, fg_ch, fgand_ch):
            fh.write(f"{x:24.15F}{g.imag:24.15F}{ga.imag:24.15F}"
                     f"{g.real:24.15F}{ga.real:24.15F}\n")


def replica_chi2_fitgf(cfg: EDConfig, target: np.ndarray,
                       bath_array: np.ndarray, hloc: np.ndarray,
                       h_basis: np.ndarray) -> np.ndarray:
    """Convenience alias matching the reference's fitgf_replica entry."""
    return chi2_fitgf(cfg, target, bath_array, hloc, h_basis=h_basis)
