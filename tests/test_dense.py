"""Dense tensor-product (matmul) backend: equality with ELL/oracle, mixed
precision + polish, and factory dispatch of the ed_backend/ed_precision
dials (reference stored-vs-direct oracle discipline, ED_INPUT_VARS.f90:151)."""
import jax.numpy as jnp
import numpy as np
import pytest

import dmft_lanc_ed_tpu as ed
from dmft_lanc_ed_tpu.bath import init_bath
from dmft_lanc_ed_tpu.hamiltonian import (build_sector_hamiltonian,
                                          dense_hamiltonian)
from dmft_lanc_ed_tpu.ops.dense import (DenseSectorOp, build_dense_op,
                                        matvec_dense_flat,
                                        matvec_dense_mixed_flat)
from dmft_lanc_ed_tpu.ops.factory import make_sector_op
from dmft_lanc_ed_tpu.ops.lanczos import lanczos_ground_state
from dmft_lanc_ed_tpu.ops.matvec import matvec_flat
from dmft_lanc_ed_tpu.sectors import SectorTable, qn


def _setup(**kw):
    cfg = ed.read_input(None, **kw)
    table = SectorTable(cfg)
    bath = init_bath(cfg)
    rng = np.random.RandomState(0)
    hloc = rng.randn(cfg.nspin, cfg.nspin, cfg.norb, cfg.norb) * 0.1
    hloc = hloc + hloc.transpose(0, 1, 3, 2)
    return cfg, table, bath, hloc


@pytest.mark.parametrize("kw,sqn", [
    (dict(norb=1, nbath=5, uloc=(2.0,)), ((3,), (3,))),
    (dict(norb=2, nbath=2, uloc=(2.0, 1.5), ust=0.8, jh=0.2,
          jx=0.2, jp=0.2), ((3,), (3,))),
    (dict(norb=1, nbath=3, uloc=(2.0,), nph=2, g_ph=(0.3,),
          w0_ph=1.0), ((2,), (2,))),
])
def test_dense_equals_ell_and_oracle(kw, sqn):
    cfg, table, bath, hloc = _setup(**kw)
    sec = table.sector(sqn)
    h = build_sector_hamiltonian(cfg, sec, hloc, bath)
    dop = build_dense_op(cfg, sec, hloc, bath)
    v = np.random.RandomState(1).randn(sec.dim)
    y_oracle = dense_hamiltonian(h) @ v
    y_ell = np.asarray(matvec_flat(h, jnp.asarray(v)))
    y_dense = np.asarray(matvec_dense_flat(dop, jnp.asarray(v)))
    scale = np.abs(y_oracle).max()
    assert np.abs(y_ell - y_oracle).max() < 1e-12 * scale
    assert np.abs(y_dense - y_oracle).max() < 1e-12 * scale
    # mixed: f32 matmuls, bounded relative error
    y_mixed = np.asarray(matvec_dense_mixed_flat(dop, jnp.asarray(v)))
    assert np.abs(y_mixed - y_oracle).max() < 1e-5 * scale
    assert dop.nnz == h.nnz > 0


def test_mixed_precision_lanczos_with_polish():
    cfg, table, bath, hloc = _setup(norb=1, nbath=6, uloc=(2.0,))
    sec = table.sector(qn(3, 3))
    dop = build_dense_op(cfg, sec, hloc, bath)
    w = np.linalg.eigvalsh(
        dense_hamiltonian(build_sector_hamiltonian(cfg, sec, hloc, bath)))
    evals, evecs = lanczos_ground_state(
        dop, matvec_dense_mixed_flat, sec.dim, neigen=2, tol=3e-6,
        polish_apply=matvec_dense_flat)
    assert np.abs(evals - w[:2]).max() < 1e-10
    # polished ground state must be a genuine eigenvector
    hv = np.asarray(matvec_dense_flat(dop, jnp.asarray(evecs[0])))
    assert np.linalg.norm(hv - evals[0] * evecs[0]) < 1e-6


def test_factory_dispatch_dense():
    cfg, table, bath, hloc = _setup(norb=1, nbath=4, uloc=(2.0,))
    sec = table.sector(qn(2, 2))
    for prec, apply_expected in [("f64", matvec_dense_flat),
                                 ("mixed", matvec_dense_mixed_flat)]:
        c = cfg.replace(ed_backend="dense", ed_precision=prec)
        op, apply_fn = make_sector_op(c, sec, hloc, bath)
        assert isinstance(op, DenseSectorOp)
        assert apply_fn is apply_expected
    with pytest.raises(ValueError, match="fast"):
        cfg.replace(ed_precision="fast")


def test_full_solve_dense_backend_matches_ell():
    """End-to-end: EDSolver with ed_backend=dense reproduces the ELL GS
    energy, GF, and observables."""
    kw = dict(norb=1, nbath=4, uloc=(2.0,), lmats=64, lreal=16,
              lanc_dim_threshold=4)
    cfg_e, table, bath, hloc = _setup(**kw)
    cfg_d = cfg_e.replace(ed_backend="dense")
    res = {}
    for name, cfg in [("ell", cfg_e), ("dense", cfg_d)]:
        solver = ed.EDSolver(cfg, hloc=hloc[..., :1, :1] * 0)
        res[name] = solver.solve(solver.init_bath())
    assert abs(res["ell"].state_list.emin - res["dense"].state_list.emin) < 1e-10
    np.testing.assert_allclose(res["dense"].g_mats, res["ell"].g_mats,
                               atol=1e-8)
    np.testing.assert_allclose(res["dense"].observables.dens,
                               res["ell"].observables.dens, atol=1e-9)


def test_full_solve_mixed_precision_close():
    """Mixed precision + polish: physics agrees with f64 to physical tol."""
    kw = dict(norb=1, nbath=4, uloc=(2.0,), lmats=64, lreal=16,
              lanc_dim_threshold=4)
    cfg_e, table, bath, hloc = _setup(**kw)
    cfg_m = cfg_e.replace(ed_backend="dense", ed_precision="mixed")
    res = {}
    for name, cfg in [("f64", cfg_e), ("mixed", cfg_m)]:
        solver = ed.EDSolver(cfg, hloc=None)
        res[name] = solver.solve(solver.init_bath())
    assert abs(res["f64"].state_list.emin - res["mixed"].state_list.emin) < 1e-9
    np.testing.assert_allclose(res["mixed"].g_mats, res["f64"].g_mats,
                               atol=5e-5)
    np.testing.assert_allclose(res["mixed"].observables.dens,
                               res["f64"].observables.dens, atol=1e-6)
