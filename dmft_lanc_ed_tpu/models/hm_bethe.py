"""Hubbard model on the Bethe lattice — the designated example workload.

Re-designed driver for drivers/edn_hm_bethe.f90 (the reference README's
example and CMake default target): N-band Hubbard with semicircular DOS,
full DMFT self-consistency with chi2 bath fitting, linear or Broyden mixing,
optional fixed-density mu search, and the exact Bethe shortcut
Delta = (D/2)^2 G (betheSC flag).

Usage:
    python -m dmft_lanc_ed_tpu.models.hm_bethe [inputfile] [NAME=value ...]
or programmatically:  run_dmft(cfg, wband=1.0) -> DMFTResult
"""
from __future__ import annotations

import ast

import logging
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..config import EDConfig, read_input
from ..dmft import (BroydenMixer, ConvergenceCheck, DensitySearch,
                    LinearMixer, bethe_bands, gloc_dos, kinetic_energy_dos,
                    self_consistency)
from ..fit import chi2_fitgf
from ..solver import EDSolver, matsubara_grid

log = logging.getLogger("dmft_lanc_ed_tpu")


@dataclass
class DMFTResult:
    converged: bool
    iterations: int
    error: float
    dens: np.ndarray
    docc: np.ndarray
    xmu: float
    sigma_mats: np.ndarray
    sigma_real: np.ndarray
    g_mats: np.ndarray
    weiss: np.ndarray
    bath: np.ndarray
    ekin: float = 0.0
    observables: object = None
    history: List[Dict] = field(default_factory=list)


def run_dmft(cfg: EDConfig, wband=1.0, h0=None, wmixing: float = 0.5,
             bethe_sc: bool = False, broyden: bool = False,
             n_energies: int = 500, bath0: Optional[np.ndarray] = None,
             verbose: bool = True) -> DMFTResult:
    """Full DMFT loop (edn_hm_bethe.f90:104-167 behavior)."""
    norb = cfg.norb
    ebands, dbands, h0v = bethe_bands(norb, wband, h0, n_energies)
    hloc = np.zeros((cfg.nspin, cfg.nspin, norb, norb))
    for s in range(cfg.nspin):
        hloc[s, s] = np.diag(h0v[:norb])

    solver = EDSolver(cfg, hloc)
    bath = solver.init_bath() if bath0 is None else np.asarray(bath0).copy()
    wm = matsubara_grid(cfg)
    z = 1j * wm

    mixer = BroydenMixer(wmixing) if broyden else LinearMixer(wmixing)
    conv = ConvergenceCheck(cfg.dmft_error, cfg.nsuccess, cfg.nloop)
    musearch = DensitySearch(cfg.nread, cfg.nerr, cfg.ndelta) \
        if cfg.nread != 0.0 else None
    xmu = cfg.xmu
    history: List[Dict] = []
    converged = False
    weiss = None
    res = None

    for iloop in range(1, cfg.nloop + 1):
        t0 = time.perf_counter()
        if xmu != solver.cfg.xmu:
            solver = EDSolver(cfg.replace(xmu=xmu), hloc)
        res = solver.solve(bath)
        gloc = gloc_dos(ebands, dbands, h0v, res.sigma_mats, z, xmu=xmu)
        wb = wband if bethe_sc else None
        weiss = self_consistency(gloc, res.sigma_mats, hloc, z,
                                 sctype=cfg.cg_scheme, xmu=xmu, wbands=wb)
        bath = chi2_fitgf(solver.cfg, weiss, bath, hloc)
        bath = mixer(bath)

        gtest = np.mean([weiss[0, 0, a, a] for a in range(norb)], axis=0)
        converged = conv(gtest)
        if musearch is not None:
            xmu, converged = musearch.update(
                xmu, float(res.observables.dens.sum()), converged)
        entry = dict(iloop=iloop, error=conv.error,
                     dens=res.observables.dens.copy(),
                     docc=res.observables.docc.copy(),
                     egs=res.observables.egs, xmu=xmu,
                     time=time.perf_counter() - t0,
                     timings=dict(res.timings))
        history.append(entry)
        if verbose:
            log.info("DMFT loop %02d: err=%.3e dens=%s docc=%s (%.1fs)",
                     iloop, conv.error, np.round(entry["dens"], 6),
                     np.round(entry["docc"], 6), entry["time"])
        if converged and conv.error < cfg.dmft_error:
            break

    ekin = kinetic_energy_dos(ebands, dbands, h0v, res.sigma_mats, wm,
                              cfg.beta, xmu=xmu)
    return DMFTResult(
        converged=converged, iterations=len(history), error=conv.error,
        dens=res.observables.dens, docc=res.observables.docc, xmu=xmu,
        sigma_mats=res.sigma_mats, sigma_real=res.sigma_real,
        g_mats=res.g_mats, weiss=weiss, bath=bath, ekin=ekin,
        observables=res.observables, history=history)


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s", datefmt="%H:%M:%S")
    argv = argv if argv is not None else sys.argv[1:]
    path = None
    overrides = {}
    extra = {}
    for arg in argv:
        if "=" in arg:
            k, v = arg.split("=", 1)
            k = k.lower()
            if k in ("wband", "wmixing"):
                extra[k] = float(v)
            elif k in ("bethe_sc", "broyden"):
                extra[k] = v.lower() in ("t", "true", "1")
            else:
                try:
                    overrides[k] = ast.literal_eval(v)
                except Exception:
                    overrides[k] = v
        else:
            path = arg
    cfg = read_input(path, **overrides)
    result = run_dmft(cfg, **extra)
    print(f"converged={result.converged} iterations={result.iterations} "
          f"error={result.error:.3e}")
    print(f"dens={result.dens} docc={result.docc} ekin={result.ekin:.6f}")
    return result


if __name__ == "__main__":
    main()
