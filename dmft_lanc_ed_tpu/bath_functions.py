"""Analytic Anderson bath functions Delta(z), G0(z), G0^-1(z).

JAX re-design of ED_BATH_FUNCTIONS.f90:25-195: pure jnp functions of
(config, hloc, bath, z). Being jax-pure they are `vmap`-batched over
frequencies and — crucially — differentiable: the chi2 bath fit gets its
gradients from `jax.grad` instead of the reference's hand-derived
dDelta/deps, dDelta/dV chain rules (ED_FIT_CHI2/fitgf_normal_normal.f90:531-565).

All return arrays shaped [nspin, nspin, norb, norb, L] (reference layout).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from .bath import Bath
from .config import EDConfig


def _nn2so(m: jnp.ndarray, nspin: int, norb: int) -> jnp.ndarray:
    """[nspin,nspin,norb,norb] -> [nspin*norb, nspin*norb]."""
    return m.transpose(0, 2, 1, 3).reshape(nspin * norb, nspin * norb)


def _so2nn(m: jnp.ndarray, nspin: int, norb: int) -> jnp.ndarray:
    return m.reshape(nspin, norb, nspin, norb).transpose(0, 2, 1, 3)


def delta_bath(cfg: EDConfig, bath: Bath, z: jnp.ndarray,
               h_basis: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Hybridization function Delta(z) (delta_bath_array)."""
    nspin, norb = cfg.nspin, cfg.norb
    z = jnp.asarray(z, jnp.complex128)
    L = z.shape[0]
    out = jnp.zeros((nspin, nspin, norb, norb, L), jnp.complex128)
    if cfg.bath_type == "normal":
        # Delta_aa = sum_k V_ak^2 / (z - e_ak)
        e = bath.e[..., None, :]          # [ns, norb, 1, nb]
        v = bath.v[..., None, :]
        d = (v * v / (z[None, None, :, None] - e)).sum(-1)  # [ns, norb, L]
        for s in range(nspin):
            out = out.at[s, s, jnp.arange(norb), jnp.arange(norb), :].set(d[s])
        return out
    if cfg.bath_type == "hybrid":
        # Delta_ab = sum_k V_ak V_bk / (z - e_k)
        e = bath.e[:, 0, :]               # [ns, nb]
        v = bath.v                        # [ns, norb, nb]
        denom = z[None, :, None] - e[:, None, :]            # [ns, L, nb]
        d = jnp.einsum("sak,sbk,slk->sabl", v, v, 1.0 / denom)
        for s in range(nspin):
            out = out.at[s, s].set(d[s])
        return out
    # replica: Delta = sum_p V_p^2 [ (z - H_p)^-1 ]
    basis = jnp.asarray(h_basis, jnp.float64)   # [nsym, ns, ns, no, no]
    hp = jnp.einsum("pm,mijkl->pijkl", bath.lam, basis)   # [nb, ns,ns,no,no]
    nso = nspin * norb
    hp_so = jax.vmap(lambda m: _nn2so(m, nspin, norb))(hp)  # [nb, nso, nso]
    eye = jnp.eye(nso, dtype=jnp.complex128)

    def per_freq(zi):
        inv = jnp.linalg.inv(zi * eye[None] - hp_so)        # [nb, nso, nso]
        inv_nn = jax.vmap(lambda m: _so2nn(m, nspin, norb))(inv)
        w = (bath.v_rep ** 2)                                # [nb, ns]
        acc = jnp.zeros((nspin, nspin, norb, norb), jnp.complex128)
        for s in range(nspin):
            acc = acc.at[s, s].add(
                jnp.einsum("b,bkl->kl", w[:, s], inv_nn[:, s, s]))
        return acc

    d = jax.vmap(per_freq, out_axes=-1)(z)     # [ns,ns,no,no,L]
    return d


def invg0_bath(cfg: EDConfig, hloc: jnp.ndarray, bath: Bath, z: jnp.ndarray,
               h_basis: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """G0^-1(z) = (z + mu) - Hloc - Delta(z)  (invg0_bath_array)."""
    nspin, norb = cfg.nspin, cfg.norb
    z = jnp.asarray(z, jnp.complex128)
    delta = delta_bath(cfg, bath, z, h_basis)
    hloc = jnp.asarray(hloc, jnp.complex128)
    out = -delta
    zshift = z + cfg.xmu
    if cfg.bath_type == "normal":
        for s in range(nspin):
            idx = jnp.arange(norb)
            out = out.at[s, s, idx, idx, :].add(
                zshift[None, :] - hloc[s, s, idx, idx][:, None])
        return out
    for s in range(nspin):
        eye = jnp.eye(norb, dtype=jnp.complex128)
        out = out.at[s, s].add(zshift[None, None, :] * eye[:, :, None]
                               - hloc[s, s][:, :, None])
    return out


def g0and_bath(cfg: EDConfig, hloc: jnp.ndarray, bath: Bath, z: jnp.ndarray,
               h_basis: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Non-interacting impurity GF G0and(z) (g0and_bath_array)."""
    nspin, norb = cfg.nspin, cfg.norb
    ig0 = invg0_bath(cfg, hloc, bath, z, h_basis)
    if cfg.bath_type == "normal":
        out = jnp.zeros_like(ig0)
        idx = jnp.arange(norb)
        for s in range(nspin):
            out = out.at[s, s, idx, idx, :].set(1.0 / ig0[s, s, idx, idx, :])
        return out
    # hybrid/replica: per-frequency Norb x Norb inverse, spin diagonal
    out = jnp.zeros_like(ig0)
    for s in range(nspin):
        block = ig0[s, s].transpose(2, 0, 1)          # [L, no, no]
        out = out.at[s, s].set(jnp.linalg.inv(block).transpose(1, 2, 0))
    return out
