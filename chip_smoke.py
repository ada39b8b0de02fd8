"""Smoke test of the ED/DMFT main path on one NVIDIA GPU.

    python chip_smoke.py          # one GPU: dmft, large and gpu-tests phases
    python chip_smoke.py --four   # four GPUs: the dw-sharded large solve only

Everything runs in this one process, so no second process ever opens a
card. The phases drive the solver through the entry points a user calls:

- ``dmft``: ``models.hm_bethe.run_dmft``, one-orbital Bethe lattice,
  nbath=9, U=2, beta=100, lmats=1024, two DMFT iterations; then the first
  solve again under the default backend and under ``ed_backend="ell"`` (an
  f64 gather path with no matmul, so no TF32 can reach it), compared.
- ``large``: one ``EDSolver.solve`` at nbath=11, T=0: 45 sectors above the
  batched-bucket limit, the largest 853,776 states. Egs is checked against
  host ARPACK (scipy ``eigsh``) on the half-filled sector and against the
  ``ell`` backend; G(iw_n) against the ``ell`` solve.
- ``gpu-tests``: the tests marked ``gpu`` (tests/test_gpu.py), in-process.
- ``four`` (``--four`` only): the ``large`` solve on a 4-device mesh with
  ``ed_shard_min_dimdw=4``, compared with the one-card solve, with each
  card's peak memory printed to show the vectors are split four ways.

The times printed are smoke times of a single run, not a benchmark. The
last line of standard output is one JSON object,
``{"ok": ..., "device": {"platform", "kind", "count"}}``. With no GPU, or
without the package beside this file, the script exits non-zero and prints
no such line; a failed phase prints ``"ok": false`` and exits 1.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# tolerances: f64 sums taken in another order (other backend, other
# device, other mesh) agree to roundoff amplified by the Krylov chains
TOL_EGS = 1e-10
TOL_DENS = 1e-8
TOL_G = 1e-7


def phases_for(four: bool):
    """The phases one run makes: ``--four`` runs only the four-card path."""
    return ["four"] if four else ["dmft", "large", "gpu-tests"]


def result_line(ok: bool, platform: str, kind: str, count: int) -> str:
    """The last line of standard output."""
    return json.dumps({"ok": bool(ok), "device": {
        "platform": platform, "kind": kind, "count": int(count)}})


def say(*a):
    print(*a, flush=True)


def check(checks, name, value, limit):
    ok = bool(np.isfinite(value) and value < limit)
    checks.append(ok)
    say(f"  check {name}: {value:.3e} < {limit:.0e} "
        f"{'ok' if ok else 'FAILED'}")


def _fmt_timings(t):
    return ", ".join(f"{k} {t[k]:.3f}s" for k in
                     ("diag", "gf", "observables", "sigma", "total") if k in t)


def _bethe_cfg(nbath, **kw):
    from dmft_lanc_ed_tpu.config import EDConfig
    return EDConfig(norb=1, nbath=nbath, uloc=(2.0,), **kw)


def _solve(cfg, bath):
    from dmft_lanc_ed_tpu.solver import EDSolver
    return EDSolver(cfg, np.zeros((1, 1, 1, 1))).solve(bath)


def _init_bath(cfg):
    from dmft_lanc_ed_tpu.solver import EDSolver
    return EDSolver(cfg, np.zeros((1, 1, 1, 1))).init_bath()


def compare(checks, res, ref, label):
    """Egs, density, double occupancy and G(iw_n) of two solves."""
    check(checks, f"{label} |dEgs|",
          abs(res.state_list.emin - ref.state_list.emin), TOL_EGS)
    check(checks, f"{label} max|d dens|",
          np.abs(res.observables.dens - ref.observables.dens).max(), TOL_DENS)
    check(checks, f"{label} max|d docc|",
          np.abs(res.observables.docc - ref.observables.docc).max(), TOL_DENS)
    check(checks, f"{label} max|dG(iw)|",
          np.abs(res.g_mats - ref.g_mats).max(), TOL_G)


def phase_dmft(nbath=9, lmats=1024, nloop=2, **cfg_kw):
    from dmft_lanc_ed_tpu.models.hm_bethe import run_dmft
    checks = []
    cfg = _bethe_cfg(nbath, beta=100.0, lmats=lmats, nloop=nloop, **cfg_kw)
    t0 = time.perf_counter()
    out = run_dmft(cfg, verbose=False)
    say(f"  run_dmft: {out.iterations} iterations in "
        f"{time.perf_counter() - t0:.3f}s (smoke times, not a benchmark)")
    for i, h in enumerate(out.history):
        say(f"  iteration {i + 1} ({'cold' if i == 0 else 'warm'}): "
            f"{h['time']:.3f}s; {_fmt_timings(h['timings'])}")
    bath0 = _init_bath(cfg)
    res = _solve(cfg, bath0)
    say(f"  first solve again (warm): {_fmt_timings(res.timings)}")
    check(checks, "|dEgs| vs DMFT iteration 1",
          abs(res.observables.egs - out.history[0]["egs"]), TOL_EGS)
    ref = _solve(cfg.replace(ed_backend="ell"), bath0)
    say(f"  ell reference solve: {_fmt_timings(ref.timings)}")
    compare(checks, res, ref, "default vs ell")
    return all(checks)


def arpack_egs(cfg):
    """Host ARPACK ground-state energy of the half-filled sector."""
    import scipy.sparse.linalg as spl
    from dmft_lanc_ed_tpu.bath import init_bath
    from dmft_lanc_ed_tpu.hamiltonian import (build_sector_hamiltonian,
                                              sparse_hamiltonian)
    from dmft_lanc_ed_tpu.sectors import SectorTable, qn
    half = cfg.ns // 2
    sec = SectorTable(cfg).sector(qn(half, half))
    h = build_sector_hamiltonian(cfg, sec, np.zeros((1, 1, 1, 1)),
                                 init_bath(cfg))
    e = spl.eigsh(sparse_hamiltonian(h), k=1, which="SA", tol=1e-13,
                  return_eigenvectors=False)
    return float(e[0]), sec.dim


def peak_bytes(devices):
    """Peak bytes in use per device (None where the runtime keeps none)."""
    return [(d.memory_stats() or {}).get("peak_bytes_in_use")
            for d in devices]


def phase_large(nbath=11, **cfg_kw):
    import jax
    checks = []
    cfg = _bethe_cfg(nbath, **cfg_kw)
    bath0 = _init_bath(cfg)
    t0 = time.perf_counter()
    res = _solve(cfg, bath0)
    say(f"  solve (cold): {time.perf_counter() - t0:.3f}s; "
        f"{_fmt_timings(res.timings)}")
    say(f"  peak bytes in use: {peak_bytes(jax.devices()[:1])[0]}")
    t0 = time.perf_counter()
    e_ref, dim = arpack_egs(cfg)
    say(f"  host ARPACK, sector dim {dim}: Egs {e_ref:.12f} "
        f"({time.perf_counter() - t0:.1f}s)")
    check(checks, "|dEgs| vs host ARPACK", abs(res.state_list.emin - e_ref),
          TOL_EGS)
    ref = _solve(cfg.replace(ed_backend="ell"), bath0)
    say(f"  ell reference solve: {_fmt_timings(ref.timings)}")
    check(checks, "ell |dEgs| vs host ARPACK",
          abs(ref.state_list.emin - e_ref), TOL_EGS)
    compare(checks, res, ref, "default vs ell")
    return all(checks)


def phase_four(nbath=11, ndev=4, **cfg_kw):
    """The dw-sharded solve on ``ndev`` devices against the one-device
    solve; returns whether every check passed."""
    import jax
    checks = []
    cfg1 = _bethe_cfg(nbath, **cfg_kw)
    cfg4 = cfg1.replace(mesh_shape=(ndev,), ed_shard_min_dimdw=ndev)
    bath0 = _init_bath(cfg1)
    t0 = time.perf_counter()
    res4 = _solve(cfg4, bath0)
    say(f"  {ndev}-device sharded solve: {time.perf_counter() - t0:.3f}s; "
        f"{_fmt_timings(res4.timings)}")
    peaks = peak_bytes(jax.devices()[:ndev])
    say(f"  peak bytes in use per device: {peaks}")
    if all(p is not None for p in peaks):
        # a mesh that leaves the vectors on device 0 shows up here
        check(checks, "1 - min/max peak bytes over the mesh",
              1.0 - min(peaks) / max(peaks), 0.75)
    t0 = time.perf_counter()
    res1 = _solve(cfg1, bath0)
    say(f"  one-device solve: {time.perf_counter() - t0:.3f}s; "
        f"{_fmt_timings(res1.timings)}")
    compare(checks, res4, res1, f"{ndev} devices vs one")
    return all(checks)


def phase_gpu_tests():
    import pytest
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_gpu.py")])
    say(f"  pytest -m gpu: exit code {int(rc)}")
    return int(rc) == 0


PHASES = {"dmft": phase_dmft, "large": phase_large,
          "gpu-tests": phase_gpu_tests, "four": phase_four}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded solve")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    try:
        import dmft_lanc_ed_tpu
        from dmft_lanc_ed_tpu import compile_cache, native
        from dmft_lanc_ed_tpu.utils.observability import nvidia_smi
    except ImportError as e:
        print(f"chip_smoke: the dmft_lanc_ed_tpu package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 2
    import jax
    devs = jax.devices()
    dev = devs[0]
    need = 4 if args.four else 1
    say(f"platform {dev.platform}, device_kind {dev.device_kind}, "
        f"count {len(devs)}")
    if dev.platform != "gpu" or len(devs) < need:
        print(f"chip_smoke: needs {need} GPU(s); JAX found {len(devs)} "
              f"{dev.platform} device(s)", file=sys.stderr)
        return 1
    say(f"nvidia-smi: {nvidia_smi()}")
    say(f"jax {jax.__version__}, package {dmft_lanc_ed_tpu.__file__}")
    say(f"compile cache: {jax.config.jax_compilation_cache_dir} "
        f"(rule: {compile_cache.cache_dir(os.environ, 'gpu')})")
    say(f"native library: {'loaded' if native.load() else 'not loaded'}")
    ok = True
    for name in phases_for(args.four):
        say(f"=== phase {name}")
        t0 = time.perf_counter()
        try:
            passed = PHASES[name]()
        except Exception:
            traceback.print_exc()
            passed = False
        ok = ok and passed
        say(f"=== phase {name}: {'ok' if passed else 'FAILED'} "
            f"({time.perf_counter() - t0:.1f}s)")
    say(result_line(ok, dev.platform, dev.device_kind, len(devs)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
