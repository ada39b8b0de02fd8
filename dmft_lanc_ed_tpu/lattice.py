"""Inequivalent-sites (real-space / lattice) solver API.

Re-design of the reference's lattice driver layer (`ed_solve_lattice[_mpi]`,
ED_MAIN.f90:373-674): N inequivalent impurity problems with per-site baths,
per-site local Hamiltonians and optional per-site interaction overrides. The
reference round-robins sites over MPI ranks and AllReduces [Nlat, ...]
arrays; here each site solve is a device-accelerated EDSolver and the site
loop runs on host (site-level device parallelism — the reference's
inter-site embarrassing parallelism — maps onto multiple GPUs via one
process per device or, later, vmapped batched sectors).

Also carries the per-site chi2 fit loop (ed_chi2_fitgf lattice overload,
ED_FIT_CHI2.f90:151-240) and per-site adaptive diag state persistence
(neigen_sectorii, ED_MAIN.f90:614-621).
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .config import EDConfig
from .fit import chi2_fitgf
from .solver import EDSolver, SolveResult

log = logging.getLogger("dmft_lanc_ed_tpu")


@dataclass
class LatticeResult:
    results: List[SolveResult]

    def _stack(self, attr):
        return np.stack([getattr(r, attr) for r in self.results])

    @property
    def sigma_mats(self):      # [nlat, nspin, nspin, norb, norb, L]
        return self._stack("sigma_mats")

    @property
    def sigma_real(self):
        return self._stack("sigma_real")

    @property
    def g_mats(self):
        return self._stack("g_mats")

    @property
    def dens(self):
        return np.stack([r.observables.dens for r in self.results])

    @property
    def docc(self):
        return np.stack([r.observables.docc for r in self.results])

    @property
    def mag(self):
        return np.stack([r.observables.mag for r in self.results])


@dataclass
class LatticeArrays:
    """Merged per-site result arrays of a multi-host lattice solve
    (the AllReduce'd [Nlat, ...] arrays of ED_MAIN.f90:603-672)."""
    sigma_mats: np.ndarray     # [nlat, nspin, nspin, norb, norb, Lmats]
    sigma_real: np.ndarray
    g_mats: np.ndarray
    dens: np.ndarray           # [nlat, norb]
    docc: np.ndarray
    mag: np.ndarray
    egs: np.ndarray            # [nlat]


class LatticeSolver:
    """N-site impurity solver bank (`ed_init_solver` lattice overload)."""

    def __init__(self, cfg: EDConfig, nlat: int,
                 hloc: Optional[np.ndarray] = None,
                 uloc_ii: Optional[np.ndarray] = None,
                 ust_ii: Optional[np.ndarray] = None,
                 jh_ii: Optional[np.ndarray] = None,
                 h_basis=None, lambda_imp=None):
        """hloc: [nlat, nspin, nspin, norb, norb]; per-site interaction
        overrides (Uloc_ii [nlat, norb], Ust_ii [nlat], Jh_ii [nlat] —
        ED_MAIN.f90:377-379,458-460)."""
        self.cfg = cfg
        self.nlat = nlat
        self.solvers: List[EDSolver] = []
        for i in range(nlat):
            over = {}
            if uloc_ii is not None:
                over["uloc"] = tuple(uloc_ii[i])
            if ust_ii is not None:
                over["ust"] = float(ust_ii[i])
            if jh_ii is not None:
                over["jh"] = float(jh_ii[i])
            cfg_i = cfg.replace(**over) if over else cfg
            hloc_i = None if hloc is None else hloc[i]
            self.solvers.append(
                EDSolver(cfg_i, hloc_i, h_basis=h_basis,
                         lambda_imp=lambda_imp))

    def init_baths(self) -> np.ndarray:
        """[nlat, nb] initial packed baths."""
        return np.stack([s.init_bath() for s in self.solvers])

    def solve(self, baths: np.ndarray,
              devices: Optional[list] = None) -> LatticeResult:
        """Solve all sites; `devices` round-robins sites over chips.

        The reference distributes inequivalent sites over MPI ranks
        (do ilat=1+MPI_ID,Nsites,MPI_SIZE, ED_MAIN.f90:603); here site i's
        compute is placed on devices[i % ndev] via jax.default_device, the
        single-controller analogue — async dispatch overlaps device work
        across sites until each site's host-side reduction.
        """
        import jax
        results = []
        for i, solver in enumerate(self.solvers):
            log.info("lattice site %d/%d", i + 1, self.nlat)
            if devices:
                with jax.default_device(devices[i % len(devices)]):
                    results.append(solver.solve(baths[i]))
            else:
                results.append(solver.solve(baths[i]))
        return LatticeResult(results)

    def solve_multihost(self, baths: np.ndarray) -> "LatticeArrays":
        """Multi-host (multi-process) lattice solve: each process solves its
        round-robin subset of sites on its local devices and the per-site
        result arrays are AllReduce-merged across hosts — the
        ed_solve_lattice_mpi protocol (ED_MAIN.f90:603-672) over the JAX
        multi-controller runtime (see parallel/multihost.py). Call
        parallel.multihost.init_multihost first on every process.

        Returns merged [nlat, ...] arrays, identical on every process; the
        rich per-site SolveResult objects of the locally solved sites stay
        available as ``self.local_results``."""
        from .parallel.multihost import allreduce_sites, my_sites
        mine = list(my_sites(self.nlat))
        self.local_results = {}
        for i in mine:
            log.info("lattice site %d/%d (this process)", i + 1, self.nlat)
            self.local_results[i] = self.solvers[i].solve(baths[i])
        r0 = self.local_results[mine[0]] if mine else None

        def merge(get, shape, dtype=np.float64):
            return allreduce_sites(
                {i: get(r) for i, r in self.local_results.items()},
                self.nlat, shape, dtype)

        cfg = self.cfg
        gl = (cfg.nspin, cfg.nspin, cfg.norb, cfg.norb)
        lm = np.asarray(r0.sigma_mats).shape[-1] if r0 is not None \
            else cfg.lmats
        lr = np.asarray(r0.sigma_real).shape[-1] if r0 is not None \
            else cfg.lreal
        return LatticeArrays(
            sigma_mats=merge(lambda r: r.sigma_mats, gl + (lm,),
                             np.complex128),
            sigma_real=merge(lambda r: r.sigma_real, gl + (lr,),
                             np.complex128),
            g_mats=merge(lambda r: r.g_mats, gl + (lm,), np.complex128),
            dens=merge(lambda r: r.observables.dens, (cfg.norb,)),
            docc=merge(lambda r: r.observables.docc, (cfg.norb,)),
            mag=merge(lambda r: r.observables.mag, (cfg.norb,)),
            egs=merge(lambda r: np.float64(r.observables.egs), ()))

    def fit_baths_multihost(self, weiss: np.ndarray, baths: np.ndarray,
                            ispin: Optional[int] = None) -> np.ndarray:
        """Per-site chi2 fit distributed over processes, AllReduce-merged
        (ED_FIT_CHI2.f90:215-240)."""
        from .parallel.multihost import allreduce_sites, my_sites
        local = {}
        for i in my_sites(self.nlat):
            local[i] = chi2_fitgf(self.solvers[i].cfg, weiss[i], baths[i],
                                  self.solvers[i].hloc, ispin=ispin,
                                  h_basis=self.solvers[i].h_basis)
        return allreduce_sites(local, self.nlat, baths.shape[1:])

    def fit_baths(self, weiss: np.ndarray, baths: np.ndarray,
                  ispin: Optional[int] = None,
                  outdir: Optional[str] = None) -> np.ndarray:
        """Per-site chi2 fit; weiss: [nlat, nspin, nspin, norb, norb, L].

        With ``outdir``, fit diagnostics carry the reference's per-site
        suffix ``_ineq<NNNN>`` (ineq_site_suffix + site_indx_padding,
        ED_MAIN.f90:455)."""
        out = np.empty_like(baths)
        for i, solver in enumerate(self.solvers):
            out[i] = chi2_fitgf(solver.cfg, weiss[i], baths[i], solver.hloc,
                                ispin=ispin, h_basis=solver.h_basis,
                                outdir=outdir, suffix=f"_ineq{i + 1:04d}")
        return out
