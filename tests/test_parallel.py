"""Sharded-vs-serial equality tests on the virtual 8-device CPU mesh.

The JAX analogue of the reference's serial-vs-MPI driver cross-checks
(SURVEY.md §4.2): same sector, same vector, dw-sharded matvec must equal the
single-device matvec to f64 roundoff.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dmft_lanc_ed_tpu.config import EDConfig
from dmft_lanc_ed_tpu.sectors import SectorTable, qn
from dmft_lanc_ed_tpu.bath import Bath, init_bath
from dmft_lanc_ed_tpu.hamiltonian import build_sector_hamiltonian
from dmft_lanc_ed_tpu.ops.matvec import matvec_flat
from dmft_lanc_ed_tpu.ops.lanczos import lanczos_tridiag
from dmft_lanc_ed_tpu.parallel import make_mesh, ShardedLanczos

RNG = np.random.default_rng(7)


def _setup(cfg, sqn, seed=0):
    rng = np.random.default_rng(seed)
    norb_e = cfg.norb if cfg.bath_type == "normal" else 1
    bath = Bath(e=jnp.asarray(rng.normal(size=(cfg.nspin, norb_e, cfg.nbath))),
                v=jnp.asarray(rng.normal(size=(cfg.nspin, cfg.norb, cfg.nbath)) * .5))
    tab = SectorTable(cfg)
    sec = tab.sector(sqn)
    hloc = rng.normal(size=(cfg.nspin, cfg.nspin, cfg.norb, cfg.norb)) * 0.2
    hloc = (hloc + hloc.transpose(0, 1, 3, 2)) / 2
    h = build_sector_hamiltonian(cfg, sec, hloc, bath)
    return sec, h


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_sharded_matvec_matches_serial(ndev):
    cfg = EDConfig(norb=1, nbath=5, uloc=(1.7,))    # ns=6, sector dims 15-20
    sec, h = _setup(cfg, qn(3, 3))
    mesh = make_mesh(ndev)
    sl = ShardedLanczos(h, mesh)
    v = RNG.normal(size=(sec.dim_dw, sec.dim_up))
    vp = sl.pad_vec(jnp.asarray(v), sec.dim_dw, sec.dim_up)
    y_sharded = np.asarray(sl.mv(vp))[:sec.dim_dw, :sec.dim_up]
    y_serial = np.asarray(
        matvec_flat(h, jnp.asarray(v.reshape(-1)))).reshape(
            sec.dim_dw, sec.dim_up)
    np.testing.assert_allclose(y_sharded, y_serial, atol=1e-13)


def test_sharded_matvec_nonlocal_terms():
    cfg = EDConfig(norb=2, nbath=1, uloc=(1.0, 1.0), ust=0.4, jh=0.1,
                   jx=0.2, jp=0.2)
    sec, h = _setup(cfg, qn(2, 2))
    assert h.nd_up_src is not None
    mesh = make_mesh(4)
    sl = ShardedLanczos(h, mesh)
    v = RNG.normal(size=(sec.dim_dw, sec.dim_up))
    vp = sl.pad_vec(jnp.asarray(v), sec.dim_dw, sec.dim_up)
    y_sharded = np.asarray(sl.mv(vp))[:sec.dim_dw, :sec.dim_up]
    y_serial = np.asarray(
        matvec_flat(h, jnp.asarray(v.reshape(-1)))).reshape(
            sec.dim_dw, sec.dim_up)
    np.testing.assert_allclose(y_sharded, y_serial, atol=1e-13)


def test_sharded_lanczos_tridiag_matches_serial():
    cfg = EDConfig(norb=1, nbath=5, uloc=(2.2,))
    sec, h = _setup(cfg, qn(3, 2))
    mesh = make_mesh(8)
    sl = ShardedLanczos(h, mesh)
    v0 = RNG.normal(size=(sec.dim_dw, sec.dim_up))
    v0 /= np.linalg.norm(v0)
    m = 30
    a_sh, b_sh = sl.tridiag(sl.pad_vec(jnp.asarray(v0), sec.dim_dw,
                                       sec.dim_up), m)
    a_se, b_se = lanczos_tridiag(h, jnp.asarray(v0.reshape(-1)), m,
                                 matvec_flat)
    np.testing.assert_allclose(np.asarray(a_sh), np.asarray(a_se), atol=1e-10)
    np.testing.assert_allclose(np.asarray(b_sh), np.asarray(b_se), atol=1e-10)


def test_padding_region_is_invariant():
    """The padded region is an invariant subspace: vectors supported on the
    physical [DimDw, DimUp] block stay there under the padded matvec, and the
    physical block of the padded matvec equals the unpadded one."""
    from dmft_lanc_ed_tpu.parallel.matvec import pad_sector_hamiltonian
    cfg = EDConfig(norb=1, nbath=4, uloc=(1.3,))
    sec, h = _setup(cfg, qn(2, 3))
    hp = pad_sector_hamiltonian(h, 8)
    dd, du = sec.dim_dw, sec.dim_up
    ddp, dup = hp.diag.shape
    v = np.zeros((ddp, dup))
    v[:dd, :du] = RNG.normal(size=(dd, du))
    from dmft_lanc_ed_tpu.ops.matvec import apply_h
    y = np.asarray(apply_h(hp, jnp.asarray(v)))
    assert np.all(y[dd:, :] == 0.0) and np.all(y[:, du:] == 0.0)
    y0 = np.asarray(apply_h(h, jnp.asarray(v[:dd, :du])))
    np.testing.assert_allclose(y[:dd, :du], y0, atol=1e-13)


def test_lattice_sites_distributed_over_devices():
    """Per-device inequivalent-site distribution (ED_MAIN round-robin
    analogue) must match the single-device site loop exactly."""
    import jax
    import numpy as np
    from dmft_lanc_ed_tpu.config import EDConfig
    from dmft_lanc_ed_tpu.lattice import LatticeSolver

    cfg = EDConfig(norb=1, nbath=3, uloc=(2.0,), beta=20.0, lmats=64,
                   lreal=32)
    hloc = np.zeros((3, 1, 1, 1, 1))
    hloc[1, 0, 0, 0, 0] = 0.3
    hloc[2, 0, 0, 0, 0] = -0.2
    lat = LatticeSolver(cfg, 3, hloc=hloc)
    baths = lat.init_baths()
    res_serial = lat.solve(baths)
    lat2 = LatticeSolver(cfg, 3, hloc=hloc)
    res_dist = lat2.solve(baths, devices=jax.devices())
    np.testing.assert_allclose(res_dist.dens, res_serial.dens, atol=1e-12)
    np.testing.assert_allclose(res_dist.sigma_mats, res_serial.sigma_mats,
                               atol=1e-10)
