"""Sector-operator factory: one signature, multiple backends.

The reference binds `spHtimesV_p` to stored/direct variants at sector setup
(ED_HAMILTONIAN.f90:139-166); here `make_sector_op` returns (op_pytree,
apply_fn) chosen by cfg.ed_backend / cfg.ed_sparse_h / cfg.ed_precision:

- "ell" (stored)  : tensor-product ELL factors, row-gather matvec
- "dense"         : dense tensor-product factors, matmul matvec (the GPU
                    default; honors ed_precision f64/mixed)
- "direct"        : matrix-free, connectivity from bit ops on device
- "auto"          : per platform (see :func:`resolve_backend`)
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from ..bath import Bath
from ..config import EDConfig
from ..hamiltonian import build_sector_hamiltonian
from ..sectors import Sector
from .dense import build_dense_op, matvec_dense_flat, matvec_dense_mixed_flat
from .direct import build_direct_op, matvec_direct_flat
from .matvec import matvec_flat

PLATFORMS = ("cpu", "gpu")

_DENSE_APPLY = {"f64": matvec_dense_flat,
                "mixed": matvec_dense_mixed_flat}


def polish_apply(op_apply: Callable) -> Optional[Callable]:
    """The f64-exact apply that polishes eigenpairs found with a mixed-
    precision apply, or None when the production apply is already exact."""
    return matvec_dense_flat if op_apply is matvec_dense_mixed_flat else None


def platform() -> str:
    """The JAX default platform, one of :data:`PLATFORMS`. Any other
    platform raises: the defaults below were chosen by measurement on these
    two, and an untested one gets no silent default."""
    import jax
    p = jax.default_backend()
    if p not in PLATFORMS:
        raise RuntimeError(f"unsupported JAX platform {p!r}; this solver "
                           f"has defaults for {PLATFORMS} only")
    return p


def resolve_backend(cfg: EDConfig) -> str:
    """ed_backend="auto" resolves per platform. ed_sparse_h=F dials the
    matrix-free direct backend, as in the reference (ED_INPUT_VARS.f90:151).
    Stored factors then run as

    - "gpu": dense tensor-product factors in f64 — two matmuls per matvec
      on the FP64 tensor cores, no gathers (timings in PERF.md);
    - "cpu": the ELL row-gather, where sparse streaming wins and dense f64
      matmuls spend O(dim^1.5) FLOPs on zeros."""
    backend = cfg.ed_backend
    if backend == "auto":
        if not cfg.ed_sparse_h:
            return "direct"
        return {"gpu": "dense", "cpu": "ell"}[platform()]
    return backend


def resolve_precision(cfg: EDConfig) -> str:
    """ed_precision="auto": exact f64 on both platforms. The GPU runs f64
    matmuls on its FP64 tensor cores; the f32 "mixed" mode is slower per
    matvec there, compiles more and needs a Rayleigh-Ritz polish
    (PERF.md)."""
    prec = cfg.ed_precision
    if prec == "auto":
        platform()              # an unsupported platform raises
        return "f64"
    return prec


def make_sector_op(cfg: EDConfig, sec: Sector, hloc: np.ndarray, bath: Bath,
                   h_basis: Optional[np.ndarray] = None
                   ) -> Tuple[object, Callable]:
    backend = resolve_backend(cfg)
    if backend == "dense":
        op = build_dense_op(cfg, sec, hloc, bath, h_basis=h_basis)
        return op, _DENSE_APPLY[resolve_precision(cfg)]
    if backend == "direct":
        op = build_direct_op(cfg, sec, hloc, bath, h_basis=h_basis)
        return op, matvec_direct_flat
    if backend != "ell":
        raise ValueError(f"unknown ed_backend {cfg.ed_backend!r}")
    op = build_sector_hamiltonian(cfg, sec, hloc, bath, h_basis=h_basis)
    return op, matvec_flat
