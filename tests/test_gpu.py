"""Tests that only mean something on an NVIDIA GPU (marker ``gpu``).

They skip elsewhere through the ``gpu_device`` fixture, and run on a GPU
machine with ``python -m pytest -m gpu tests/`` (``chip_smoke.py`` runs
them too). The references are host computations or the CPU device of the
same process.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spl

from dmft_lanc_ed_tpu.bath import init_bath
from dmft_lanc_ed_tpu.config import EDConfig
from dmft_lanc_ed_tpu.hamiltonian import (build_sector_hamiltonian,
                                          sparse_hamiltonian)
from dmft_lanc_ed_tpu.ops.dense import (densify, matvec_dense_flat,
                                        matvec_dense_mixed_flat)
from dmft_lanc_ed_tpu.ops.factory import resolve_backend, resolve_precision
from dmft_lanc_ed_tpu.ops.lanczos import lanczos_ground_state
from dmft_lanc_ed_tpu.sectors import SectorTable, qn
from dmft_lanc_ed_tpu.solver import EDSolver

pytestmark = pytest.mark.gpu

HLOC = np.zeros((1, 1, 1, 1))


def _sector(nbath):
    cfg = EDConfig(norb=1, nbath=nbath, uloc=(2.0,))
    half = cfg.ns // 2
    sec = SectorTable(cfg).sector(qn(half, half))
    return cfg, sec, build_sector_hamiltonian(cfg, sec, HLOC, init_bath(cfg))


def test_default_solve_matches_cpu_ell(gpu_device):
    """The default GPU path (dense, f64) against the ELL backend on the
    host CPU device of the same process, at nbath=7."""
    cfg = EDConfig(norb=1, nbath=7, uloc=(2.0,), beta=100.0, lmats=256)
    assert (resolve_backend(cfg), resolve_precision(cfg)) == ("dense", "f64")
    solver = EDSolver(cfg, HLOC)
    bath = solver.init_bath()
    res = solver.solve(bath)
    with jax.default_device(jax.devices("cpu")[0]):
        ref = EDSolver(cfg.replace(ed_backend="ell"), HLOC).solve(bath)
    assert abs(res.state_list.emin - ref.state_list.emin) < 1e-10
    np.testing.assert_allclose(res.observables.dens, ref.observables.dens,
                               atol=1e-8)
    np.testing.assert_allclose(res.g_mats, ref.g_mats, atol=1e-7)


def test_dense_f64_matvec_is_exact(gpu_device):
    """The f64 dense matvec on the card agrees with the host CSR to f64
    roundoff: no TF32 or other reduced-precision matmul reaches it."""
    _, sec, h = _sector(9)
    rng = np.random.default_rng(0)
    v = rng.standard_normal(sec.dim)
    y = np.asarray(jax.jit(matvec_dense_flat)(densify(h), jnp.asarray(v)))
    y_ref = sparse_hamiltonian(h) @ v
    assert np.linalg.norm(y - y_ref) < 1e-13 * np.linalg.norm(y_ref)


def test_reduced_precision_energy_gate(gpu_device):
    """ed_precision=mixed on the card: Lanczos in the f32 matvec plus the
    f64 Rayleigh-Ritz polish reaches host ARPACK to 1e-10 on a
    63,504-state sector. (The removed "fast" mode, f32 at
    Precision.HIGH, missed this gate on the H100 by 2.9e-9.)"""
    _, sec, h = _sector(9)
    e_ref = spl.eigsh(sparse_hamiltonian(h), k=1, which="SA", tol=1e-13,
                      return_eigenvectors=False)[0]
    e, _ = lanczos_ground_state(densify(h), matvec_dense_mixed_flat,
                                sec.dim, 1, ncv=48, tol=3e-6,
                                polish_apply=matvec_dense_flat)
    assert abs(e[0] - e_ref) < 1e-10
