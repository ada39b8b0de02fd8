"""Benchmark of the large-sector kernels on one GPU, per matvec backend.

The workload is the half-filled sector of the one-orbital Bethe impurity at
nbath=11: sector (6,6), 924 x 924 = 853,776 states (``BENCH_NBATH`` cuts it
down for smoke runs of this script). For each XLA backend

  ell          f64 row-gather over the ELL factor tables
  dense        f64 dense tensor-product factors (matmuls)
  dense_mixed  f32 matmuls at HIGHEST + f64 diagonal, f64 polish

it times, in this one process:

  matvec  one sector matvec (a jitted chain of CHAIN matvecs, best of REPS)
  gf8     8 GF continued-fraction chains of lanc_ngfiter=200 steps
          (``lanczos_tridiag_batched``, the GF/chi path)
  gs      the ground-state solve of the sector as the solver runs it
          (``diag.solve_sector``: thick-restart Lanczos, polish where the
          matvec is not f64), cold (with compilation) and warm

and gates each ground state against host ARPACK (scipy ``eigsh`` on the
assembled CSR): |dE| < 1e-10. Each matvec time is set against two floors
of the card, from the peak table below: the HBM floor (one f64 read and
one write of the vector, 16 bytes per state) and the matmul floor of the
dense form (2 dim (dim_up + dim_dw) FLOPs at the matmul unit's peak for
that precision).

Prints one JSON line on stdout with the platform, device kind, device
count, the card's name and power limit, and every number; progress goes
to stderr. With no GPU it fails, unless ``BENCH_CPU=1`` asks for a CPU run
on purpose, which then reports ``"platform": "cpu"`` and no floors.
"""
import json
import os
import sys
import time

import numpy as np

NBATH = int(os.environ.get("BENCH_NBATH", "11"))
GATE_TOL = 1e-10
CHAIN = 100
REPS = 5
NGF = 8

# Published peaks, keyed by jax device_kind. NVIDIA H100 SXM5 data sheet,
# dense rates without sparsity, at the 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_s": 3.35e12,
        "fp64_tensor_flops": 67e12,
        "fp32_flops": 67e12,
        "tf32_tensor_flops": 495e12,
    },
}
# the matmul unit each dense precision runs on
_MATMUL_PEAK = {"dense": "fp64_tensor_flops", "dense_mixed": "fp32_flops"}


def peaks(device_kind: str) -> dict:
    """Peak rates of the device; an unknown device is an error."""
    if device_kind not in PEAKS:
        raise KeyError(f"no peak rates for device_kind {device_kind!r}; "
                       f"known: {sorted(PEAKS)}")
    return PEAKS[device_kind]


def floors(dim: int, dim_up: int, dim_dw: int, pk: dict) -> dict:
    """Least seconds per matvec: HBM-bound and matmul-bound."""
    out = {"hbm_s": 16.0 * dim / pk["hbm_bytes_s"]}
    flops = 2.0 * dim * (dim_up + dim_dw)
    for name, key in _MATMUL_PEAK.items():
        out[f"{name}_matmul_s"] = flops / pk[key]
    return out


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _best(fn, reps=REPS):
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def time_matvec(jax, op, apply, v0, scale):
    """Seconds per matvec: a chain of CHAIN matvecs in one jit, each output
    scaled by a constant (fused into the matvec) so values stay bounded."""
    @jax.jit
    def chain(op, v):
        return jax.lax.fori_loop(0, CHAIN, lambda _, x: apply(op, x) * scale,
                                 v)
    chain(op, v0).block_until_ready()
    return _best(lambda: chain(op, v0).block_until_ready()) / CHAIN


def main():
    import jax
    if os.environ.get("BENCH_CPU"):
        jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax.numpy as jnp
    import scipy.sparse.linalg as spl
    from dmft_lanc_ed_tpu.bath import init_bath
    from dmft_lanc_ed_tpu.config import EDConfig
    from dmft_lanc_ed_tpu.diag import solve_sector
    from dmft_lanc_ed_tpu.hamiltonian import (build_sector_hamiltonian,
                                              sparse_hamiltonian)
    from dmft_lanc_ed_tpu.ops.factory import make_sector_op
    from dmft_lanc_ed_tpu.ops.lanczos import lanczos_tridiag_batched
    from dmft_lanc_ed_tpu.sectors import SectorTable, qn
    from dmft_lanc_ed_tpu.utils.observability import kernel_stats, nvidia_smi

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not os.environ.get("BENCH_CPU"):
        log(f"bench: needs a GPU, found {dev.platform} (BENCH_CPU=1 runs on "
            "the CPU on purpose)")
        return 1
    out = {"platform": dev.platform, "device_kind": dev.device_kind,
           "device_count": len(jax.devices()), "nvidia_smi": nvidia_smi(),
           "jax": jax.__version__}
    pk = peaks(dev.device_kind) if dev.platform == "gpu" else None
    log(f"device: {out}")

    cfg = EDConfig(norb=1, nbath=NBATH, uloc=(2.0,))
    half = cfg.ns // 2
    sec = SectorTable(cfg).sector(qn(half, half))
    hloc = np.zeros((1, 1, 1, 1))
    bath = init_bath(cfg)
    h = build_sector_hamiltonian(cfg, sec, hloc, bath)
    out.update(dim=sec.dim, dim_up=sec.dim_up, dim_dw=sec.dim_dw, nnz=h.nnz)
    if pk:
        out["floors"] = floors(sec.dim, sec.dim_up, sec.dim_dw, pk)
    t0 = time.perf_counter()
    hs = sparse_hamiltonian(h)
    e_ref = float(spl.eigsh(hs, k=1, which="SA", tol=1e-13,
                            return_eigenvectors=False)[0])
    out["e_arpack"] = e_ref
    log(f"sector {sec.dim} ({sec.dim_dw}x{sec.dim_up}), host ARPACK "
        f"E={e_ref:.12f} ({time.perf_counter() - t0:.1f}s)")
    scale = 1.0 / float(abs(hs).sum(axis=1).max())     # Gershgorin bound
    rng = np.random.default_rng(0)
    v0 = rng.standard_normal(sec.dim)
    v0 /= np.linalg.norm(v0)
    vb = rng.standard_normal((NGF, sec.dim))
    vb /= np.linalg.norm(vb, axis=1, keepdims=True)

    out["backends"] = {}
    for name, backend, prec in [("ell", "ell", "f64"),
                                ("dense", "dense", "f64"),
                                ("dense_mixed", "dense", "mixed")]:
        c = cfg.replace(ed_backend=backend, ed_precision=prec)
        op, apply = make_sector_op(c, sec, hloc, bath)
        r = {}
        r["matvec_s"] = time_matvec(jax, op, apply, jnp.asarray(v0), scale)
        # the chain's f64 accuracy: one matvec against the host CSR
        y = np.asarray(jax.jit(apply)(op, jnp.asarray(v0)))
        r["matvec_rel_err"] = float(np.linalg.norm(y - hs @ v0)
                                    / np.linalg.norm(hs @ v0))
        vbd = jnp.asarray(vb)

        def gf8():
            jax.block_until_ready(lanczos_tridiag_batched(
                op, vbd, cfg.lanc_ngfiter, apply))
        gf8()
        r["gf8_s"] = _best(gf8, reps=2)
        r["gs_gate_ok"] = False
        try:
            for it in ("cold", "warm"):
                kernel_stats.reset()
                t0 = time.perf_counter()
                e, _ = solve_sector(c, sec, hloc, bath,
                                    cfg.lanc_nstates_sector)
                r[f"gs_{it}_s"] = time.perf_counter() - t0
            r["gs_matvecs"] = kernel_stats.matvecs
            r["gs_abs_de"] = abs(float(e[0]) - e_ref)
            r["gs_gate_ok"] = r["gs_abs_de"] < GATE_TOL
        except RuntimeError as err:          # no Lanczos convergence
            r["gs_error"] = str(err)
        if pk:
            f = out["floors"]
            r["matvec_vs_hbm_floor"] = r["matvec_s"] / f["hbm_s"]
            if name in _MATMUL_PEAK:
                r["matvec_vs_matmul_floor"] = (r["matvec_s"]
                                               / f[f"{name}_matmul_s"])
        log(f"{name}: {json.dumps(r)}")
        out["backends"][name] = r
    print(json.dumps(out))
    failed = [k for k, r in out["backends"].items() if not r["gs_gate_ok"]]
    if failed:
        log(f"bench: energy gate failed for {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
