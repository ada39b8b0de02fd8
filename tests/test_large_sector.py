"""The large-sector path: sectors above ``ed_batch_dim_max`` run one by one
through ``lanczos_ground_state``, and GF/chi chains on their target sectors
through ``lanczos_tridiag_batched``, in f64 on every backend.

The GPU's defaults (dense f64 factors, pow2-bucketed GF operators) are
selected here on the CPU by reporting the platform as "gpu"; a small
``ed_batch_dim_max`` sends every Krylov sector down the large-sector path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dmft_lanc_ed_tpu as ed
from dmft_lanc_ed_tpu.bath import unpack_bath
from dmft_lanc_ed_tpu.hamiltonian import dense_hamiltonian
from dmft_lanc_ed_tpu.ops.batched import _pow2_at_least, pad_dense_op_2d
from dmft_lanc_ed_tpu.ops.dense import densify, matvec_dense_flat
from dmft_lanc_ed_tpu.ops.lanczos import lanczos_tridiag_batched, tridiag_eigh
from dmft_lanc_ed_tpu.ops.matvec import matvec_flat
from fock_oracle import anderson_hamiltonian

LARGE = dict(ed_batch_dim_max=0, lanc_dim_threshold=8)


@pytest.fixture
def gpu_defaults(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


def _solve(cfg):
    hloc = np.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb))
    solver = ed.EDSolver(cfg, hloc)
    bath = solver.init_bath()
    return solver.solve(bath), unpack_bath(cfg, bath), hloc


def _oracle_egs(cfg, bath, hloc):
    """Full-Fock ground state (independent JW construction); phonon
    problems, which the Fock oracle does not build, take the minimum of
    host eigh over the assembled sector matrices instead."""
    if cfg.nph == 0:
        h = anderson_hamiltonian(cfg, hloc, np.asarray(bath.e),
                                 np.asarray(bath.v))
        return float(np.linalg.eigvalsh(h)[0])
    table = ed.SectorTable(cfg)
    return min(float(np.linalg.eigvalsh(dense_hamiltonian(
        ed.build_sector_hamiltonian(cfg, table.sector(q), hloc, bath)))[0])
        for q in table.all_qns())


@pytest.mark.parametrize("kw", [
    dict(norb=1, nbath=3, uloc=(2.0,)),
    dict(norb=2, nbath=1, uloc=(1.6, 1.6), ust=0.7, jh=0.2, jx=0.2, jp=0.2),
    dict(norb=1, nbath=2, uloc=(1.5,), nph=2, g_ph=(0.3,), w0_ph=0.6),
], ids=["1orb", "2orb-jxjp", "phonon"])
def test_large_sector_path_dense_f64_matches_ell_and_oracle(gpu_defaults,
                                                            kw):
    cfg = ed.read_input(None, lmats=64, lreal=16, **LARGE, **kw)
    assert ed.ops.factory.resolve_backend(cfg) == "dense"
    res, bath, hloc = _solve(cfg)
    ref, _, _ = _solve(cfg.replace(ed_backend="ell"))
    e0 = _oracle_egs(cfg, bath, hloc)
    assert abs(res.state_list.emin - e0) < 1e-9
    assert abs(ref.state_list.emin - e0) < 1e-9
    np.testing.assert_allclose(res.g_mats, ref.g_mats, atol=1e-8)
    np.testing.assert_allclose(res.observables.dens, ref.observables.dens,
                               atol=1e-9)


def _sector_h(nbath=5, nup=3, ndw=2):
    cfg = ed.read_input(None, norb=1, nbath=nbath, uloc=(2.0,))
    sec = ed.SectorTable(cfg).sector(ed.qn(nup, ndw))
    return ed.build_sector_hamiltonian(cfg, sec, np.zeros((1, 1, 1, 1)),
                                       ed.init_bath(cfg))


@pytest.mark.parametrize("backend", ["dense-bucketed", "ell"])
def test_gf_chain_batch_matches_dense_resolvent(backend):
    """A batch of 3 excitations (zero-padded to 8 dead chains) through
    ``lanczos_tridiag_batched`` gives continued fractions equal to the exact
    resolvent <v|(z - H)^-1|v> of the dense sector matrix, with the GPU's
    pow2-bucketed dense operator and with the ELL operator."""
    h = _sector_h()
    dim = h.dim_up * h.dim_dw
    rng = np.random.default_rng(11)
    vs = rng.standard_normal((3, dim))
    vs /= np.linalg.norm(vs, axis=1, keepdims=True)
    v0 = np.concatenate([vs, np.zeros((5, dim))])
    m = 200
    if backend == "ell":
        a_b, b_b = lanczos_tridiag_batched(h, jnp.asarray(v0), m,
                                           matvec_flat)
    else:
        op = densify(h)
        du_p, dd_p = _pow2_at_least(op.dim_up), _pow2_at_least(op.dim_dw)
        assert (du_p, dd_p) != (op.dim_up, op.dim_dw)
        padded = pad_dense_op_2d(op, du_p, dd_p)
        vp = np.pad(v0.reshape(8, op.dim_dw, op.dim_up),
                    ((0, 0), (0, dd_p - op.dim_dw), (0, du_p - op.dim_up)))
        a_b, b_b = lanczos_tridiag_batched(
            padded, jnp.asarray(vp.reshape(8, -1)), m, matvec_dense_flat)
    a_b, b_b = np.asarray(a_b), np.asarray(b_b)
    assert np.all(a_b[3:] == 0.0)          # dead chains stay dead
    w, u = np.linalg.eigh(dense_hamiltonian(h))
    z = 1j * np.linspace(0.3, 4.0, 40) + 0.3
    for i in range(3):
        theta, s = tridiag_eigh(a_b[i], b_b[i])
        g = ((s[0] ** 2)[None, :] / (z[:, None] - theta[None, :])).sum(1)
        amp2 = (u.T @ vs[i]) ** 2
        g_ref = (amp2[None, :] / (z[:, None] - w[None, :])).sum(1)
        np.testing.assert_allclose(g, g_ref, atol=1e-9)


def test_gf_and_chi_on_large_target_sectors_match_oracle(gpu_defaults):
    """Full solve with spin chi at finite T: every target sector runs the
    large-sector chain path; G and chi match the ELL solve and the
    full-Fock Lehmann chi."""
    from test_chi import lehmann_chi_oracle
    beta = 10.0
    cfg = ed.read_input(None, norb=1, nbath=2, uloc=(1.7,), beta=beta,
                        lmats=16, lreal=11, ltau=20, wini=-3.0, wfin=3.0,
                        ed_finite_temp=True, lanc_nstates_total=4096,
                        lanc_nstates_sector=4096, chispin_flag=True,
                        xmu=0.3, **LARGE)
    res, bath, hloc = _solve(cfg)
    ref, _, _ = _solve(cfg.replace(ed_backend="ell"))
    np.testing.assert_allclose(res.g_mats, ref.g_mats, atol=1e-8)
    h = anderson_hamiltonian(cfg, hloc, np.asarray(bath.e),
                             np.asarray(bath.v))
    states = np.arange(1 << (2 * cfg.ns))
    sz = 0.5 * (((states >> 0) & 1) - ((states >> cfg.ns) & 1))
    vm = 2.0 * np.arange(cfg.lmats) * np.pi / beta
    tau = np.linspace(0.0, beta, cfg.ltau + 1)
    wr = np.linspace(cfg.wini, cfg.wfin, cfg.lreal)
    ref_iv, ref_tau, _ = lehmann_chi_oracle(h, sz, beta, vm, tau, wr,
                                            cfg.eps)
    chi = res.chi_spin[(0, 0)]
    np.testing.assert_allclose(chi.matsubara(beta, vm), ref_iv, atol=1e-8)
    np.testing.assert_allclose(chi.imtime(tau), ref_tau, atol=1e-8)


def test_solver_mesh_raises_without_enough_devices():
    from dmft_lanc_ed_tpu.parallel.production import solver_mesh
    n = len(jax.devices()) + 1
    with pytest.raises(RuntimeError, match=f"requests {n} devices"):
        solver_mesh(ed.read_input(None, mesh_shape=(n,)))
    assert solver_mesh(ed.read_input(None, mesh_shape=(1,))) is None
