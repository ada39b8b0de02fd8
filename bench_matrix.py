"""End-to-end DMFT benchmark matrix, one process on one device.

Runs two DMFT iterations (solve + chi2 fit; the first cold, the second
warm) per configuration and prints one JSON line per configuration and
backend with the wall times and the solver's phase split (diag / gf /
observables / sigma):

  bethe4      1-orbital Bethe, nbath=4   (~4k-state sectors)
  bethe9      1-orbital Bethe, nbath=9   (~63k-state sectors, 121 sectors)
  hund2b      2-band Hubbard + Hund, square lattice, normal bath
  bhz_replica BHZ 2D topological, replica bath
  gs854k      ground-state solve of the 853,776-state sector (nbath=11)

Usage: python bench_matrix.py [config ...] [--backends auto,ell,...]
(default: every config under ed_backend=auto). A backend "dense-mixed"
runs ed_backend=dense with ed_precision=mixed. Every line names the
platform, device kind and device count it ran on, and the card's name and
power limit.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def backend_kw(backend: str) -> dict:
    """EDConfig keywords of a backend name ("dense-mixed" sets both)."""
    if backend == "dense-mixed":
        return {"ed_backend": "dense", "ed_precision": "mixed"}
    return {"ed_backend": backend}


def _phases(res):
    t = res.timings
    return {k: round(t[k], 4) for k in
            ("diag", "gf", "observables", "sigma", "total") if k in t}


def _one_iteration(cfg, hloc, solver_cls, fit_fn, weiss_of):
    """Two solve+fit iterations; returns timings of the warm second one."""
    from dmft_lanc_ed_tpu.solver import matsubara_grid
    solver = solver_cls(cfg, hloc)
    bath = solver.init_bath()
    wm = matsubara_grid(cfg)
    out = {}
    for it in ("cold", "warm"):
        t0 = time.perf_counter()
        res = solver.solve(bath)
        t_solve = time.perf_counter() - t0
        weiss = weiss_of(res, 1j * wm)
        t1 = time.perf_counter()
        bath = fit_fn(cfg, weiss, bath, hloc)
        t_fit = time.perf_counter() - t1
        out[it] = dict(solve_s=round(t_solve, 3), fit_s=round(t_fit, 3),
                       loop_s=round(time.perf_counter() - t0, 3),
                       phases=_phases(res))
    out["egs"] = float(res.observables.egs)
    out["dens"] = [float(x) for x in res.observables.dens]
    return out


def bench_bethe(nbath, kw):
    from dmft_lanc_ed_tpu.config import EDConfig
    from dmft_lanc_ed_tpu.dmft import bethe_bands, gloc_dos, self_consistency
    from dmft_lanc_ed_tpu.fit import chi2_fitgf
    from dmft_lanc_ed_tpu.solver import EDSolver

    cfg = EDConfig(norb=1, nbath=nbath, uloc=(2.0,), beta=100.0,
                   lmats=1024, lfit=256, lreal=64, cg_scheme="weiss", **kw)
    ebands, dbands, h0 = bethe_bands(1, 1.0)
    hloc = np.zeros((1, 1, 1, 1))

    def weiss_of(res, z):
        gloc = gloc_dos(ebands, dbands, h0, res.sigma_mats, z)
        return self_consistency(gloc, res.sigma_mats, hloc, z,
                                sctype=cfg.cg_scheme)
    return _one_iteration(cfg, hloc, EDSolver, chi2_fitgf, weiss_of)


def bench_hund2b(kw):
    from dmft_lanc_ed_tpu.config import EDConfig
    from dmft_lanc_ed_tpu.dmft import self_consistency
    from dmft_lanc_ed_tpu.dmft.gloc import gloc_hk
    from dmft_lanc_ed_tpu.dmft.hk import hk_square, hloc_from_hk
    from dmft_lanc_ed_tpu.fit import chi2_fitgf
    from dmft_lanc_ed_tpu.solver import EDSolver

    cfg = EDConfig(norb=2, nspin=1, nbath=2, uloc=(2.0, 2.0), ust=1.2,
                   jh=0.4, jx=0.4, jp=0.4, beta=100.0, lmats=1024,
                   lfit=256, lreal=64, cg_scheme="weiss", **kw)
    hk = hk_square(16, 2, t=0.25)
    hloc = hloc_from_hk(hk, 1, 2)

    def weiss_of(res, z):
        gloc = gloc_hk(hk, res.sigma_mats, z)
        return self_consistency(gloc, res.sigma_mats, hloc, z,
                                sctype=cfg.cg_scheme)
    return _one_iteration(cfg, hloc, EDSolver, chi2_fitgf, weiss_of)


def bench_bhz_replica(kw):
    from dmft_lanc_ed_tpu.config import EDConfig
    from dmft_lanc_ed_tpu.dmft import self_consistency
    from dmft_lanc_ed_tpu.dmft.gloc import gloc_hk
    from dmft_lanc_ed_tpu.dmft.hk import hk_bhz_2d, hloc_from_hk
    from dmft_lanc_ed_tpu.fit import chi2_fitgf
    from dmft_lanc_ed_tpu.hloc import decompose_hloc
    from dmft_lanc_ed_tpu.solver import EDSolver

    cfg = EDConfig(norb=2, nspin=2, nbath=4, uloc=(2.0, 2.0), ust=1.0,
                   beta=100.0, lmats=1024, lfit=256, lreal=64,
                   bath_type="replica", cg_scheme="weiss",
                   lanc_dim_threshold=2048, **kw)
    hk = hk_bhz_2d(16, m0=1.0, lam=0.3, t=0.5)
    hloc = hloc_from_hk(hk, 2, 2)
    h_basis, lam_imp = decompose_hloc(cfg, hloc)

    class _Solver:
        def __init__(self, cfg, hloc):
            from dmft_lanc_ed_tpu.solver import EDSolver
            self._s = EDSolver(cfg, hloc, h_basis=h_basis,
                               lambda_imp=lam_imp)
            self.init_bath = self._s.init_bath
            self.solve = self._s.solve

    def fit_fn(cfg, weiss, bath, hloc):
        return chi2_fitgf(cfg, weiss, bath, hloc, h_basis=h_basis)

    def weiss_of(res, z):
        gloc = gloc_hk(hk, res.sigma_mats, z)
        return self_consistency(gloc, res.sigma_mats, hloc, z,
                                sctype=cfg.cg_scheme)
    return _one_iteration(cfg, hloc, _Solver, fit_fn, weiss_of)


def bench_gs854k(kw):
    """Warm and cold ground-state solve of the 853,776-state sector
    (nbath=11, sector (6,6)) through the solver's large-sector path, the
    path the four DMFT configurations above never reach (their largest
    sector is 63.5k, under ed_batch_dim_max)."""
    from dmft_lanc_ed_tpu.bath import init_bath
    from dmft_lanc_ed_tpu.config import EDConfig
    from dmft_lanc_ed_tpu.diag import solve_sector
    from dmft_lanc_ed_tpu.sectors import SectorTable, qn

    cfg = EDConfig(norb=1, nbath=11, uloc=(2.0,), **kw)
    sec = SectorTable(cfg).sector(qn(6, 6))
    bath = init_bath(cfg)
    hloc = np.zeros((1, 1, 1, 1))
    out = {"dim": sec.dim}
    for it in ("cold", "warm"):
        t0 = time.perf_counter()
        e, _ = solve_sector(cfg, sec, hloc, bath, cfg.lanc_nstates_sector)
        out[f"{it}_s"] = round(time.perf_counter() - t0, 3)
    out["egs"] = float(e[0])
    return out


BENCHES = {
    "bethe4": lambda kw: bench_bethe(4, kw),
    "bethe9": lambda kw: bench_bethe(9, kw),
    "hund2b": bench_hund2b,
    "bhz_replica": bench_bhz_replica,
    "gs854k": bench_gs854k,
}


def main(argv=None):
    ap = argparse.ArgumentParser(description="DMFT benchmark matrix")
    ap.add_argument("configs", nargs="*", help=f"any of {list(BENCHES)}")
    ap.add_argument("--backends", default="auto",
                    help="comma-separated ed_backend values (dense-mixed "
                         "= dense at ed_precision=mixed)")
    args = ap.parse_args(argv)
    unknown = set(args.configs) - set(BENCHES)
    if unknown:
        ap.error(f"unknown configs {sorted(unknown)}")
    import jax
    from dmft_lanc_ed_tpu.utils.observability import nvidia_smi
    dev = jax.devices()[0]
    where = {"platform": dev.platform, "device_kind": dev.device_kind,
             "device_count": len(jax.devices()), "nvidia_smi": nvidia_smi()}
    log(f"device: {where}")
    for name in args.configs or list(BENCHES):
        for backend in args.backends.split(","):
            log(f"=== {name} [{backend}]")
            t0 = time.perf_counter()
            entry = BENCHES[name](backend_kw(backend))
            entry.update(where, config=name, backend=backend,
                         bench_wall_s=round(time.perf_counter() - t0, 1))
            print(json.dumps(entry), flush=True)


if __name__ == "__main__":
    main()
