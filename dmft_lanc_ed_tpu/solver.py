"""Solver orchestration — the `ed_init_solver` / `ed_solve` API.

JAX re-design of ED_MAIN.f90: where the reference mutates global module
state and exposes getter subroutines, this solver is a class holding immutable
config + tables, and `solve` returns a :class:`SolveResult` pytree-of-arrays.
The call sequence inside `solve` mirrors ed_solve_single (ED_MAIN.f90:259-302):

    set bath -> diagonalize_impurity -> build GF (+ chi) -> observables
             -> local_energy -> Dyson self-energy

Frequency grids match allocate_grids (ED_AUX_FUNX.f90:278-304):
wm = pi/beta (2n+1), wr = linspace(wini, wfin), tau = [0, beta].
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import jax.numpy as jnp
import numpy as np

from .bath import init_bath, pack_bath, unpack_bath
from .bath_functions import g0and_bath
from .utils import host_device
from .config import EDConfig
from .diag import DiagState, diagonalize_impurity
from .eigenspace import StateList
from .gf import GFData, HCache, build_gf_full, build_gf_normal, build_sigma
from .observables import (Observables, local_energy_impurity,
                          observables_impurity, zimp_simp)
from .sectors import SectorTable

log = logging.getLogger("dmft_lanc_ed_tpu")


def matsubara_grid(cfg: EDConfig) -> np.ndarray:
    n = np.arange(cfg.lmats)
    return np.pi / cfg.beta * (2 * n + 1)


def bosonic_grid(cfg: EDConfig) -> np.ndarray:
    n = np.arange(cfg.lmats)
    return np.pi / cfg.beta * (2 * n)


def real_grid(cfg: EDConfig) -> np.ndarray:
    return np.linspace(cfg.wini, cfg.wfin, cfg.lreal)


def tau_grid(cfg: EDConfig) -> np.ndarray:
    return np.linspace(0.0, cfg.beta, cfg.ltau)


@dataclass
class SolveResult:
    """Everything one impurity solve produces (the ED_IO getter surface)."""
    sigma_mats: np.ndarray      # [nspin,nspin,norb,norb,Lmats]
    sigma_real: np.ndarray
    g_mats: np.ndarray
    g_real: np.ndarray
    g0_mats: np.ndarray
    g0_real: np.ndarray
    observables: Observables
    state_list: StateList
    gf: GFData
    chi_spin: Optional[Dict] = None
    chi_dens: Optional[Dict] = None
    gf_phonon: Optional[object] = None
    timings: Dict[str, float] = field(default_factory=dict)


class EDSolver:
    """One impurity solver instance (`ed_init_solver` + `ed_solve`)."""

    def __init__(self, cfg: EDConfig, hloc: Optional[np.ndarray] = None,
                 h_basis: Optional[np.ndarray] = None,
                 lambda_imp: Optional[np.ndarray] = None):
        self.cfg = cfg
        self.table = SectorTable(cfg)
        nso = (cfg.nspin, cfg.nspin, cfg.norb, cfg.norb)
        self.hloc = np.zeros(nso) if hloc is None else np.asarray(
            hloc, dtype=np.float64)
        self.h_basis = h_basis          # replica symmetry basis
        self.lambda_imp = lambda_imp
        self.diag_state = DiagState(
            lanc_nstates_total=cfg.lanc_nstates_total)
        self.wm = matsubara_grid(cfg)
        self.wr = real_grid(cfg)
        self.last_result: Optional[SolveResult] = None

    # -- checkpoint/restart (reference .restart file protocol) -------------
    def restore(self, workdir: str = ".", suffix: str = "") -> Optional[np.ndarray]:
        """Re-seed solver state from a reference-style restart directory:
        hamiltonian.restart (bath), state_list (spectrum shape /
        neigen_sector), sectors_list.restart (sector restriction hints).
        Returns the restored packed bath or None."""
        from . import io as edio
        ctl = edio.read_state_list_restart(self.cfg, outdir=workdir,
                                           suffix=suffix)
        if ctl is not None:
            self.diag_state = ctl
        return edio.read_bath_restart(self.cfg, outdir=workdir, suffix=suffix)

    # -- reference-style initialization ------------------------------------
    def init_bath(self) -> np.ndarray:
        """Default bath guess as packed user array (ed_init_solver output)."""
        bath = init_bath(self.cfg, lambda_imp=self.lambda_imp,
                         h_basis=self.h_basis)
        return pack_bath(self.cfg, bath)

    # -- the solve ---------------------------------------------------------
    def solve(self, bath) -> SolveResult:
        cfg = self.cfg
        t_all = time.perf_counter()
        if isinstance(bath, np.ndarray) or np.ndim(bath) == 1:
            nsym = self.h_basis.shape[0] if self.h_basis is not None else None
            bath = unpack_bath(cfg, np.asarray(bath), nsym=nsym)

        from .utils.observability import kernel_stats
        kernel_stats.reset()
        timings = {}
        t0 = time.perf_counter()
        state_list = diagonalize_impurity(cfg, self.table, self.hloc, bath,
                                          self.diag_state,
                                          h_basis=self.h_basis)
        timings["diag"] = time.perf_counter() - t0
        log.info("diag: %d states, Egs=%.12f (%.2fs)", state_list.size,
                 state_list.emin, timings["diag"])

        t0 = time.perf_counter()
        hcache = HCache(cfg, self.table, self.hloc, bath,
                        h_basis=self.h_basis)
        if cfg.ed_diag_type == "full":
            gf = build_gf_full(cfg, self.table, state_list)
        else:
            gf = build_gf_normal(cfg, self.table, hcache, state_list)
        timings["gf"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        obs = observables_impurity(cfg, self.table, state_list)
        local_energy_impurity(cfg, self.table, state_list, self.hloc, obs)
        timings["observables"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        zmats = 1j * self.wm
        zreal = self.wr + 1j * cfg.eps
        sigma_mats, g_mats = build_sigma(cfg, self.hloc, bath, gf, zmats,
                                         self.h_basis)
        sigma_real, g_real = build_sigma(cfg, self.hloc, bath, gf, zreal,
                                         self.h_basis)
        with host_device():   # tiny fixed-grid math; no device round trip
            g0_mats = np.asarray(g0and_bath(cfg, self.hloc, bath,
                                            jnp.asarray(zmats), self.h_basis))
            g0_real = np.asarray(g0and_bath(cfg, self.hloc, bath,
                                            jnp.asarray(zreal), self.h_basis))
        timings["sigma"] = time.perf_counter() - t0

        obs.zimp, obs.simp = zimp_simp(cfg, sigma_mats, self.wm)

        chi_spin = chi_dens = gf_ph = None
        if cfg.chipair_flag or cfg.chiexct_flag:
            log.warning("chipair/chiexct susceptibilities are disabled in "
                        "the reference live tree (ED_GREENS_FUNCTIONS.f90:"
                        "85-89) and not computed here")
        if cfg.chispin_flag or cfg.chidens_flag or cfg.dim_ph > 1:
            from . import chi as chi_mod
            full = cfg.ed_diag_type == "full"
            if cfg.chispin_flag:
                chi_spin = (chi_mod.full_build_chi_spin(cfg, self.table,
                                                        state_list) if full
                            else chi_mod.build_chi_spin(cfg, self.table,
                                                        hcache, state_list))
            if cfg.chidens_flag:
                chi_dens = (chi_mod.full_build_chi_dens(cfg, self.table,
                                                        state_list) if full
                            else chi_mod.build_chi_dens(cfg, self.table,
                                                        hcache, state_list))
            if cfg.dim_ph > 1:
                gf_ph = (chi_mod.full_build_gf_phonon(cfg, self.table,
                                                      state_list) if full
                         else chi_mod.build_gf_phonon(cfg, self.table,
                                                      hcache, state_list))

        timings["total"] = time.perf_counter() - t_all
        kernel_stats.seconds = timings["diag"] + timings["gf"]
        timings.update({f"kernel_{k}": v
                        for k, v in kernel_stats.summary().items()})
        result = SolveResult(
            sigma_mats=sigma_mats, sigma_real=sigma_real,
            g_mats=g_mats, g_real=g_real,
            g0_mats=g0_mats, g0_real=g0_real,
            observables=obs, state_list=state_list, gf=gf,
            chi_spin=chi_spin, chi_dens=chi_dens, gf_phonon=gf_ph,
            timings=timings)
        self.last_result = result
        return result

    # -- getters (ED_IO surface) -------------------------------------------
    def get_sigma_matsubara(self):
        return self.last_result.sigma_mats

    def get_sigma_realaxis(self):
        return self.last_result.sigma_real

    def get_gimp_matsubara(self):
        return self.last_result.g_mats

    def get_gimp_realaxis(self):
        return self.last_result.g_real

    def get_g0imp_matsubara(self):
        return self.last_result.g0_mats

    def get_dens(self):
        return self.last_result.observables.dens

    def get_docc(self):
        return self.last_result.observables.docc

    def get_mag(self):
        return self.last_result.observables.mag

    def get_eimp(self):
        o = self.last_result.observables
        return np.array([o.epot, o.eint, o.ehartree, o.eknot])

    def get_doubles(self):
        o = self.last_result.observables
        return np.array([o.dust, o.dund, o.dse, o.dph])

    def get_imp_dm(self):
        return self.last_result.observables.imp_dm
