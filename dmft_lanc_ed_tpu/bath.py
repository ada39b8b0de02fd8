"""Effective-bath layer.

JAX re-design of ED_BATH.f90 + ED_BATH/dmft_aux.f90: the bath is an
immutable pytree (registered dataclass) rather than a global struct; pack/
unpack to the flat user array keeps the exact reference memory layout
(set/get_dmft_bath, ED_BATH/dmft_aux.f90:340-496) so user code and restart
files interoperate.

Bath topologies (bath_type, ED_INPUT_VARS.f90:205):
- normal : Nbath levels per (spin, orbital); e[nspin, norb, nbath], v same.
- hybrid : Nbath shared levels; e[nspin, 1, nbath], v[nspin, norb, nbath].
- replica: Nbath replicas of the impurity local Hamiltonian, each
  parameterized by lambda over a shared symmetry basis; v[nbath, nspin],
  lambda[nbath, nsym].
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import numpy as np

from .config import EDConfig


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Bath:
    """Effective bath parameters (one of e/v used depending on bath_type).

    - e: [nspin, norb_e, nbath] bath level energies (norb_e=1 for hybrid)
    - v: [nspin, norb, nbath] hybridization amplitudes
    - lam: [nbath, nsym] replica symmetry-basis coefficients (replica only)
    - v_rep: [nbath, nspin] replica hybridizations (replica only)

    Host numpy on the user/solver path (these arrays are tiny, and every
    device round trip would be a fresh transfer); the
    chi2 fit builds tracer-valued instances for jax.grad (fit.py), which
    the dataclass holds untouched.
    """
    e: Optional[np.ndarray] = None
    v: Optional[np.ndarray] = None
    lam: Optional[np.ndarray] = None
    v_rep: Optional[np.ndarray] = None


# --------------------------------------------------------------------------
# dimensioning (get_bath_dimension, ED_BATH.f90:152-227)
# --------------------------------------------------------------------------
def bath_dimension(cfg: EDConfig, nsym: Optional[int] = None) -> int:
    if cfg.bath_type == "normal":
        return 2 * cfg.nspin * cfg.norb * cfg.nbath
    if cfg.bath_type == "hybrid":
        return cfg.nspin * cfg.nbath + cfg.nspin * cfg.norb * cfg.nbath
    # replica: per bath: [N_dec] + [v per spin] + [lambda(1..nsym)]
    if nsym is None:
        raise ValueError("replica bath_dimension requires nsym")
    return cfg.nbath + cfg.nbath * (cfg.nspin + nsym)


# --------------------------------------------------------------------------
# initialization (init_dmft_bath, ED_BATH/dmft_aux.f90:91-155)
# --------------------------------------------------------------------------
def init_bath(cfg: EDConfig, lambda_imp: Optional[np.ndarray] = None,
              h_basis: Optional[np.ndarray] = None) -> Bath:
    """Default bath guess: spread levels in [-hwband, hwband], V=max(0.1,1/sqrt(Nb))."""
    nb, norb, nspin = cfg.nbath, cfg.norb, cfg.nspin
    hw = cfg.hwband
    if cfg.bath_type in ("normal", "hybrid"):
        e1 = np.zeros(nb)
        if nb == 1:
            e1[0] = 0.0
        else:
            e1[0], e1[-1] = -hw, hw
            nh = nb // 2
            if nb % 2 == 0 and nb >= 4:
                de = hw / max(nh - 1, 1)
                e1[nh - 1], e1[nh] = -0.1, 0.1
                for i in range(1, nh - 1):
                    e1[i] = -hw + i * de
                    e1[nb - 1 - i] = hw - i * de
            elif nb % 2 == 1 and nb >= 3:
                de = hw / nh
                e1[nh] = 0.0
                for i in range(1, nh):
                    e1[i] = -hw + i * de
                    e1[nb - 1 - i] = hw - i * de
        norb_e = norb if cfg.bath_type == "normal" else 1
        e = np.broadcast_to(e1, (nspin, norb_e, nb)).copy()
        v = np.full((nspin, norb, nb), max(0.1, 1.0 / np.sqrt(nb)))
        return Bath(e=np.asarray(e), v=np.asarray(v))
    # replica
    if lambda_imp is None or h_basis is None:
        raise ValueError("replica init requires lambda_imp and h_basis")
    nsym = len(lambda_imp)
    if nb > 1:
        rescale = np.linspace(hw / nb, hw, nb)
    else:
        rescale = np.array([0.0])
    lam = np.zeros((nb, nsym))
    for ib in range(nb):
        for isym in range(nsym):
            # diagonal basis elements scale with the replica index; off-diagonal
            # ones start at the impurity value (init_dmft_bath replica branch)
            bso = _to_so(np.asarray(h_basis[isym]), cfg)
            if np.allclose(bso - np.diag(np.diag(bso)), 0.0):
                lam[ib, isym] = rescale[ib] * lambda_imp[isym]
            else:
                lam[ib, isym] = lambda_imp[isym]
    v_rep = np.full((nb, nspin), max(0.1, 1.0 / np.sqrt(nb)))
    return Bath(lam=np.asarray(lam), v_rep=np.asarray(v_rep))


def _to_so(h_nn: np.ndarray, cfg: EDConfig) -> np.ndarray:
    """[nspin,nspin,norb,norb] -> [nspin*norb, nspin*norb] (nn2so reshape)."""
    h = np.asarray(h_nn)
    if h.ndim == 2:
        return h
    nspin, norb = cfg.nspin, cfg.norb
    out = np.zeros((nspin * norb, nspin * norb), dtype=h.dtype)
    for s1 in range(nspin):
        for s2 in range(nspin):
            out[s1 * norb:(s1 + 1) * norb, s2 * norb:(s2 + 1) * norb] = h[s1, s2]
    return out


# --------------------------------------------------------------------------
# pack/unpack: flat user array <-> Bath (set/get_dmft_bath)
# --------------------------------------------------------------------------
def pack_bath(cfg: EDConfig, bath: Bath) -> np.ndarray:
    """Bath -> flat array, exact reference ordering (get_dmft_bath)."""
    if cfg.bath_type in ("normal", "hybrid"):
        e = np.asarray(bath.e)
        v = np.asarray(bath.v)
        # layout: all e by (spin, orb, k) then all v; index = k + orb*Nb + spin*Nb*Norb
        return np.concatenate([e.reshape(-1), v.reshape(-1)])
    lam = np.asarray(bath.lam)
    v = np.asarray(bath.v_rep)
    nb, nsym = lam.shape
    parts = [np.full(nb, float(nsym))]
    for ib in range(nb):
        parts.append(v[ib])
        parts.append(lam[ib])
    return np.concatenate(parts)


def unpack_bath(cfg: EDConfig, arr: np.ndarray, nsym: Optional[int] = None) -> Bath:
    """Flat array -> Bath (set_dmft_bath)."""
    arr = np.asarray(arr, dtype=np.float64)
    nb, norb, nspin = cfg.nbath, cfg.norb, cfg.nspin
    if cfg.bath_type == "normal":
        n = nspin * norb * nb
        e = arr[:n].reshape(nspin, norb, nb)
        v = arr[n:2 * n].reshape(nspin, norb, nb)
        return Bath(e=np.asarray(e), v=np.asarray(v))
    if cfg.bath_type == "hybrid":
        ne = nspin * nb
        e = arr[:ne].reshape(nspin, 1, nb)
        v = arr[ne:ne + nspin * norb * nb].reshape(nspin, norb, nb)
        return Bath(e=np.asarray(e), v=np.asarray(v))
    # replica
    ndec = int(round(arr[0]))
    if nsym is not None and nsym != ndec:
        raise ValueError(f"replica bath N_dec mismatch: {ndec} vs {nsym}")
    stride = nb
    v = np.zeros((nb, nspin))
    lam = np.zeros((nb, ndec))
    for ib in range(nb):
        v[ib] = arr[stride:stride + nspin]
        stride += nspin
        lam[ib] = arr[stride:stride + ndec]
        stride += ndec
    return Bath(lam=np.asarray(lam), v_rep=np.asarray(v))


# --------------------------------------------------------------------------
# user bath symmetrization ops (ED_BATH/user_aux.f90:21-231)
# --------------------------------------------------------------------------
def break_symmetry_bath(cfg: EDConfig, arr: np.ndarray, field: float,
                        sign: float = 1.0) -> np.ndarray:
    """Shift up/dw bath levels by ±sign*field (magnetic seed)."""
    bath = unpack_bath(cfg, arr)
    e = np.asarray(bath.e).copy()
    e[0] += sign * field
    if cfg.nspin == 2:
        e[1] -= sign * field
    return pack_bath(cfg, Bath(e=np.asarray(e), v=bath.v))


def spin_symmetrize_bath(cfg: EDConfig, arr: np.ndarray) -> np.ndarray:
    bath = unpack_bath(cfg, arr)
    if cfg.nspin == 1:
        return arr
    e = np.asarray(bath.e).copy()
    v = np.asarray(bath.v).copy()
    e[1] = e[0]
    v[1] = v[0]
    return pack_bath(cfg, Bath(e=np.asarray(e), v=np.asarray(v)))


def orb_symmetrize_bath(cfg: EDConfig, arr: np.ndarray) -> np.ndarray:
    """Average bath over orbitals (orb_symmetrize_bath)."""
    bath = unpack_bath(cfg, arr)
    e = np.asarray(bath.e)
    v = np.asarray(bath.v)
    e = np.broadcast_to(e.mean(axis=1, keepdims=True), e.shape).copy()
    v = np.broadcast_to(v.mean(axis=1, keepdims=True), v.shape).copy()
    return pack_bath(cfg, Bath(e=np.asarray(e), v=np.asarray(v)))


def orb_equality_bath(cfg: EDConfig, arr: np.ndarray, iorb: int = 0) -> np.ndarray:
    """Copy orbital iorb's bath onto every orbital (orb_equality_bath)."""
    bath = unpack_bath(cfg, arr)
    e = np.asarray(bath.e).copy()
    v = np.asarray(bath.v).copy()
    if cfg.bath_type == "normal":
        e[:] = e[:, iorb:iorb + 1, :]
    v[:] = v[:, iorb:iorb + 1, :]
    return pack_bath(cfg, Bath(e=np.asarray(e), v=np.asarray(v)))


def ph_symmetrize_bath(cfg: EDConfig, arr: np.ndarray) -> np.ndarray:
    """Particle-hole symmetrize bath levels (ph_symmetrize_bath)."""
    bath = unpack_bath(cfg, arr)
    e = np.asarray(bath.e).copy()
    v = np.asarray(bath.v).copy()
    nb = cfg.nbath
    for i in range(nb // 2):
        e[..., nb - 1 - i] = -e[..., i]
        v[..., nb - 1 - i] = v[..., i]
    if nb % 2 == 1:
        e[..., nb // 2] = 0.0
    return pack_bath(cfg, Bath(e=np.asarray(e), v=np.asarray(v)))


# --------------------------------------------------------------------------
# bath -> single-particle couplings used by the Hamiltonian builder
# --------------------------------------------------------------------------
def bath_levels(cfg: EDConfig, bath: Bath,
                h_basis: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Return (bath_diag, diag_hybr, hbath) as numpy arrays.

    - bath_diag[nspin, norb_e, nbath]: on-site bath energies (diagonal part)
    - diag_hybr[nspin, norb, nbath]: hybridization amplitudes
    - hbath[nspin, nspin, norb, norb, nbath] (replica only): full replica
      Hamiltonian per bath from lambda/h_basis, off-diagonal part used for
      intra-replica hopping; its diagonal feeds bath_diag.
    """
    nspin, norb, nb = cfg.nspin, cfg.norb, cfg.nbath
    if cfg.bath_type in ("normal", "hybrid"):
        return np.asarray(bath.e), np.asarray(bath.v), None
    lam = np.asarray(bath.lam)
    basis = np.asarray(h_basis)  # [nsym, nspin, nspin, norb, norb]
    hbath = np.einsum("bs,sijkl->ijklb", lam, basis)
    bath_diag = np.zeros((nspin, norb, nb))
    for s in range(nspin):
        for a in range(norb):
            bath_diag[s, a, :] = hbath[s, s, a, a, :]
    v = np.asarray(bath.v_rep)  # [nbath, nspin]
    diag_hybr = np.zeros((nspin, norb, nb))
    for s in range(nspin):
        diag_hybr[s, :, :] = v[:, s][None, :]
    return bath_diag, diag_hybr, hbath


def ph_trans_bath(cfg: EDConfig, arr: np.ndarray) -> np.ndarray:
    """Particle-hole transform the bath: e_k -> -e_k, order reversed
    (ph_trans_bath, ED_BATH/user_aux.f90)."""
    bath = unpack_bath(cfg, arr)
    e = -np.asarray(bath.e)[..., ::-1].copy()
    v = np.asarray(bath.v)[..., ::-1].copy()
    return pack_bath(cfg, Bath(e=np.asarray(e), v=np.asarray(v)))


def get_bath_component(cfg: EDConfig, arr: np.ndarray, itype: str
                       ) -> np.ndarray:
    """Extract the 'e' or 'v' block as [nspin, norb(or 1), nbath]
    (get_bath_component, ED_BATH/user_ctrl.f90)."""
    bath = unpack_bath(cfg, arr)
    if itype == "e":
        return np.asarray(bath.e).copy()
    if itype == "v":
        return np.asarray(bath.v).copy()
    raise ValueError("itype must be 'e' or 'v'")


def set_bath_component(cfg: EDConfig, arr: np.ndarray, itype: str,
                       value: np.ndarray) -> np.ndarray:
    """Replace the 'e' or 'v' block (set_bath_component)."""
    bath = unpack_bath(cfg, arr)
    e = np.asarray(bath.e).copy()
    v = np.asarray(bath.v).copy()
    if itype == "e":
        e[:] = value
    elif itype == "v":
        v[:] = value
    else:
        raise ValueError("itype must be 'e' or 'v'")
    return pack_bath(cfg, Bath(e=np.asarray(e), v=np.asarray(v)))


def copy_bath_component(cfg: EDConfig, arr_from: np.ndarray,
                        arr_to: np.ndarray, itype: str) -> np.ndarray:
    """Copy one component block between packed baths (copy_component)."""
    return set_bath_component(cfg, arr_to, itype,
                              get_bath_component(cfg, arr_from, itype))
