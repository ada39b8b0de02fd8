"""Sector-scan diagonalization driver.

JAX re-design of ED_DIAG.f90 (`diagonalize_impurity` / `ed_diag_d` /
`ed_full_d`): scans the (Nup, Ndw) sectors, picks dense LAPACK for small
dimensions (the reference's `lanc_dim_threshold` logic — which doubles as a
continuous dense-vs-Krylov cross-validation) and restarted-Lanczos for large
ones, then collects states into a :class:`~dmft_lanc_ed_tpu.eigenspace.StateList`:
ground-state window at T=0 (gs_threshold semantics, ED_DIAG.f90:251-263),
capacity-limited list at finite T, with `ed_post_diag`-style adaptive
per-sector eigencounts (ED_DIAG.f90:471-605).

Dense path runs on host LAPACK (same as the reference); Krylov path runs the
jitted device matvec.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .bath import Bath
from .config import EDConfig
from .eigenspace import EigenState, StateList
from .hamiltonian import build_sector_hamiltonian, dense_hamiltonian
from .ops.factory import (make_sector_op, polish_apply,
                          resolve_backend, resolve_precision)
from .ops.lanczos import lanczos_ground_state
from .sectors import SectorQN, SectorTable

log = logging.getLogger("dmft_lanc_ed_tpu")


def _lanc_tol(cfg: EDConfig) -> float:
    """Krylov residual tolerance honoring the matvec noise floor: mixed
    precision matvecs carry ~1e-7 relative error, below which the Lanczos
    residual stagnates — the f64 Rayleigh-Ritz polish recovers the
    remaining digits afterwards."""
    floor = {"f64": 1e-14, "mixed": 3e-6}
    prec = (resolve_precision(cfg) if resolve_backend(cfg) == "dense"
            else "f64")
    return max(cfg.lanc_tolerance, floor[prec])


@dataclass
class DiagState:
    """Cross-iteration diagonalization control state (neigen adaptation)."""
    neigen_sector: Dict[SectorQN, int] = field(default_factory=dict)
    lanc_nstates_total: int = 1
    sector_hint: Optional[List[SectorQN]] = None   # restart restriction


def _scan_sectors(cfg: EDConfig, table: SectorTable,
                  ctl: DiagState) -> List[SectorQN]:
    qns = table.all_qns()
    if cfg.ed_twin:
        qns = [s for s in qns if all(u >= d for u, d in zip(s[0], s[1]))]
    if cfg.ed_sectors and ctl.sector_hint:
        shift = cfg.ed_sectors_shift
        keep = []
        for s in qns:
            for h in ctl.sector_hint:
                if (max(abs(a - b) for a, b in zip(s[0], h[0])) <= shift and
                        max(abs(a - b) for a, b in zip(s[1], h[1])) <= shift):
                    keep.append(s)
                    break
        qns = keep
    return qns


def _sector_neigen(cfg: EDConfig, ctl: DiagState, sqn, dim: int) -> int:
    if cfg.finite_t:
        return min(dim, ctl.neigen_sector.get(sqn, cfg.lanc_nstates_sector))
    return min(dim, cfg.lanc_nstates_sector)


def _solve_batched_sectors(cfg: EDConfig, table: SectorTable, hloc, bath,
                           ctl: DiagState, h_basis, mesh, qns) -> Dict:
    """Pre-solve small Krylov sectors in vmapped shape buckets
    (ops.batched); returns {sqn: (evals, evecs)} for solved sectors."""
    from .ops.batched import (_pow2_at_least, bucket_key,
                              lanczos_ground_state_bucket)
    from .ops.dense import build_dense_op
    from .parallel.production import should_shard

    prelim: Dict = {}
    for sqn in qns:
        dim = table.dim(sqn)
        neigen = _sector_neigen(cfg, ctl, sqn, dim)
        if not dim > max(cfg.lanc_dim_threshold, neigen):
            continue                       # dense path
        if dim > cfg.ed_batch_dim_max:
            continue                       # large: serial/sharded path
        sec = table.sector(sqn)
        if should_shard(cfg, mesh, sec.dim_dw, dim):
            continue
        ncv = max(min(dim, cfg.lanc_ncv_factor * neigen + cfg.lanc_ncv_add),
                  2 * neigen + 16)
        if dim < ncv:
            continue                       # basis would exhaust the sector
        # orientation-canonical grouping: (nup, ndw) and its mirror share
        # one bucket (the op is transposed below via batched.transpose_op)
        key = tuple(sorted((_pow2_at_least(sec.dim_up, floor=64),
                            _pow2_at_least(sec.dim_dw, floor=64))))
        prelim.setdefault(key, []).append((sqn, sec, neigen))

    results: Dict = {}
    for key, members in prelim.items():
        # build ops, split by exact bucket key (nd/ph structure).
        # Singletons batch too (b pow2-padded inside the bucket solver):
        # keeping them OUT of the bucket path sends each to the serial
        # per-sector solver, a fresh executable set per sector.
        exact: Dict = {}
        transposed: set = set()
        for sqn, sec, neigen in members:
            # host-resident fields: pad/transpose/stack stay on host and
            # push one stacked array per field, not one transfer per
            # sector and field
            op = build_dense_op(cfg, sec, hloc, bath, h_basis=h_basis,
                                to_device=False)
            if _pow2_at_least(op.dim_up, floor=64) \
                    > _pow2_at_least(op.dim_dw, floor=64):
                from .ops.batched import transpose_op
                op = transpose_op(op)
                transposed.add(sqn)
            exact.setdefault(bucket_key(op), []).append((sqn, op, neigen))
        for bkey, group in exact.items():
            # fixed-size chunks: every chunk of a shape reuses ONE vmapped
            # executable (b padded to B_FIXED / pow2 above it) instead of
            # compiling per group size
            from .ops.batched import B_FIXED
            for c0 in range(0, len(group), B_FIXED):
                chunk = group[c0:c0 + B_FIXED]
                neigen = max(g[2] for g in chunk)
                dims = [g[1].dim for g in chunk]
                # deeper basis than the serial default: fewer thick
                # restarts for ~m^2 more CGS2 work per restart (the depth
                # is not re-tuned on the H100)
                ncv = max(min(min(dims),
                              max(48, cfg.lanc_ncv_factor * neigen
                                  + cfg.lanc_ncv_add)),
                          2 * neigen + 16)
                ncv = min(ncv, min(dims))
                # f64 basis: f32 Ritz prefixes cannot hold the deflated
                # subspace (the restart count grows several-fold and Egs
                # misses ~1e-9 even after the polish)
                sols = lanczos_ground_state_bucket(
                    [g[1] for g in chunk], neigen, tol=_lanc_tol(cfg),
                    precision=resolve_precision(cfg), ncv=ncv,
                    dtype=jnp.dtype(cfg.ed_dtype))
                n_ok = sum(s is not None for s in sols)
                log.info("batched bucket %s: %d sectors, neigen=%d, "
                         "%d solved", bkey[:2], len(chunk), neigen, n_ok)
                for (sqn, c_op, _), sol in zip(chunk, sols):
                    if sol is None:
                        continue
                    vals, flat = sol
                    if sqn in transposed:
                        # vectors come back in the transposed layout
                        # [.., du, dd]; swap to the natural order
                        sec_t = table.sector(sqn)
                        k = flat.shape[0]
                        v3 = flat.reshape(k, sec_t.dim_ph, sec_t.dim_up,
                                          sec_t.dim_dw)
                        flat = np.swapaxes(v3, 2, 3).reshape(k, -1)
                    results[sqn] = (vals, flat)
    return results


def solve_sector(cfg: EDConfig, sec, hloc, bath: Bath, neigen: int,
                 h_basis: Optional[np.ndarray] = None):
    """Lowest ``neigen`` eigenpairs of one sector on one device: the
    large-sector path (every Krylov sector above ``ed_batch_dim_max``, and
    all of them under the ell/direct backends)."""
    dim = sec.dim
    op, op_apply = make_sector_op(cfg, sec, hloc, bath, h_basis=h_basis)
    ncv = min(dim, cfg.lanc_ncv_factor * neigen + cfg.lanc_ncv_add)
    ncv = min(max(ncv, 2 * neigen + 16), dim)
    polish = polish_apply(op_apply)
    if cfg.lanc_method == "dvdson":
        # real Davidson with diagonal preconditioning
        # (sp_dvdson_eigh, ED_DIAG.f90:189-204)
        from .ops.davidson import davidson_ground_state, op_diag_flat
        return davidson_ground_state(
            op, op_apply, dim, neigen, op_diag_flat(op), ncv=ncv,
            tol=_lanc_tol(cfg), dtype=jnp.dtype(cfg.ed_dtype),
            polish_apply=polish)
    return lanczos_ground_state(
        op, op_apply, dim, neigen, ncv=ncv, tol=_lanc_tol(cfg),
        dtype=jnp.dtype(cfg.ed_dtype), polish_apply=polish)


def diagonalize_impurity(cfg: EDConfig, table: SectorTable, hloc: np.ndarray,
                         bath: Bath, ctl: Optional[DiagState] = None,
                         h_basis: Optional[np.ndarray] = None) -> StateList:
    """One full spectrum determination (diagonalize_impurity, ED_DIAG.f90:22)."""
    ctl = ctl or DiagState(lanc_nstates_total=cfg.lanc_nstates_total)
    finite_t = cfg.finite_t
    state_list = StateList(
        max_size=ctl.lanc_nstates_total if finite_t else None)

    if cfg.ed_diag_type == "full":
        return _diag_full(cfg, table, hloc, bath, h_basis)

    from .parallel.production import should_shard, solver_mesh
    mesh = solver_mesh(cfg)

    qns = _scan_sectors(cfg, table, ctl)
    batch_results: Dict = {}
    if cfg.ed_batch_sectors and resolve_backend(cfg) not in ("ell", "direct"):
        batch_results = _solve_batched_sectors(cfg, table, hloc, bath, ctl,
                                               h_basis, mesh, qns)

    oldzero = np.inf
    diag_log = []
    sector_tops = []
    for sqn in qns:
        dim = table.dim(sqn)
        neigen = _sector_neigen(cfg, ctl, sqn, dim)
        sec = table.sector(sqn)

        lanc_solve = dim > max(cfg.lanc_dim_threshold, neigen)
        if sqn in batch_results:
            evals, evecs = batch_results[sqn]
            evals, evecs = evals[:neigen], evecs[:neigen]
        elif lanc_solve and should_shard(cfg, mesh, sec.dim_dw, dim):
            # production dw-sharded solve (reference: P-ARPACK over the
            # MPI Dw-split, ED_DIAG.f90:151-171) on the dense/direct
            # backend per resolve_backend
            from .parallel.production import shard_sector_op
            ncv = min(dim, cfg.lanc_ncv_factor * neigen + cfg.lanc_ncv_add)
            ncv = max(ncv, 2 * neigen + 16)
            sop = shard_sector_op(cfg, sec, hloc, bath, h_basis, mesh)
            # start vector with exact-zero pad rows (the pad subspace
            # is invariant; see parallel.production.pad_dense_op)
            v0 = sop.pad_flat(jax.random.normal(
                jax.random.PRNGKey(17), (dim,), jnp.dtype(cfg.ed_dtype)))
            evals, evecs_pad = lanczos_ground_state(
                sop.op, sop.apply_nd, int(np.prod(sop.vshape)), neigen,
                ncv=min(ncv, dim), tol=_lanc_tol(cfg),
                dtype=jnp.dtype(cfg.ed_dtype), v0=v0,
                vshape=sop.vshape, sharding=sop.sharding,
                polish_apply=(None if sop.exact_nd is sop.apply_nd
                              or resolve_precision(cfg) == "f64"
                              else sop.exact_nd))
            evecs = np.stack([sop.unpad_flat(v) for v in evecs_pad])
        elif lanc_solve:
            evals, evecs = solve_sector(cfg, sec, hloc, bath, neigen,
                                        h_basis=h_basis)
        else:
            h = build_sector_hamiltonian(cfg, sec, hloc, bath,
                                         h_basis=h_basis)
            dense = dense_hamiltonian(h)
            w, v = np.linalg.eigh(dense)
            evals, evecs = w[:neigen], v[:, :neigen].T

        diag_log.append((sqn, np.asarray(evals).copy(), lanc_solve))
        # clean-cut bookkeeping: a sector solved for fewer states than its
        # dimension may hide uncomputed levels above its top computed energy
        sector_tops.append((sqn, float(np.max(evals)) if len(evals) else
                            -np.inf, len(evals) >= dim))
        # twin reconstruction: the spin-flipped sector's eigenvector is the
        # [dw, up] transpose of this one (flip_state/twin_sector_order
        # analogue, trivial in our tensor-product layout)
        twin_qn = table.twin(sqn) if cfg.ed_twin and sqn != table.twin(sqn) \
            else None

        def twin_vec(vec_flat):
            # host transpose: avoids compiling one tiny device executable
            # per sector shape
            v3 = np.asarray(vec_flat).reshape(sec.dim_ph, sec.dim_dw,
                                              sec.dim_up)
            return jnp.asarray(np.swapaxes(v3, 1, 2).reshape(-1))

        for k in range(len(evals)):
            e = float(evals[k])
            vec = jnp.asarray(evecs[k])
            adds = [(sqn, vec)]
            if twin_qn is not None:
                adds.append((twin_qn, twin_vec(vec)))
            for qn_i, vec_i in adds:
                if finite_t:
                    state_list.add(EigenState(qn_i, e, vec_i,
                                              twin=qn_i != sqn))
                else:
                    # T=0 ground-state window (ED_DIAG.f90:251-263)
                    if e < oldzero - 10.0 * cfg.gs_threshold:
                        oldzero = e
                        state_list = StateList(max_size=None)
                        state_list.add(EigenState(qn_i, e, vec_i,
                                                  twin=qn_i != sqn))
                    elif abs(e - oldzero) <= cfg.gs_threshold:
                        oldzero = min(oldzero, e)
                        state_list.add(EigenState(qn_i, e, vec_i,
                                                  twin=qn_i != sqn))
    state_list.diag_log = diag_log
    if finite_t and state_list.size:
        # energy-cut cleanliness: the one-sided chi accumulation assumes the
        # state list covers *every* eigenstate below emax. A sector whose
        # top computed energy sits below emax (without being fully solved)
        # may hide uncomputed levels below the cut (ADVICE r2: unconverged
        # neigen_sector on early iterations).
        tol = 1e-8 * max(1.0, state_list.emax - state_list.emin)
        unclean = [sqn for sqn, top, full in sector_tops
                   if not full and top < state_list.emax - tol]
        state_list.clean_cut = not unclean
        if unclean:
            log.info("diag: state list is not a clean energy cut (sectors "
                     "%s top out below emax); chi reverse-weighting may "
                     "over-count until neigen_sector adapts", unclean[:4])
    _post_diag(cfg, state_list, ctl)
    return state_list


def _diag_full(cfg: EDConfig, table: SectorTable, hloc, bath,
               h_basis) -> StateList:
    """Full diagonalization over every sector (ed_full_d, ED_DIAG.f90:287-398).

    Stores *all* eigenpairs; the observables/GF layers then use exact
    Boltzmann sums. Dense path is host LAPACK per sector.
    """
    state_list = StateList(max_size=None)
    for sqn in table.all_qns():
        sec = table.sector(sqn)
        h = build_sector_hamiltonian(cfg, sec, hloc, bath, h_basis=h_basis)
        w, v = np.linalg.eigh(dense_hamiltonian(h))
        for k in range(len(w)):
            state_list.add(EigenState(sqn, float(w[k]), jnp.asarray(v[:, k])))
    return state_list


def _post_diag(cfg: EDConfig, state_list: StateList, ctl: DiagState) -> None:
    """Adaptive spectrum sizing (ed_post_diag, ED_DIAG.f90:471-605)."""
    if not cfg.finite_t or state_list.size == 0:
        if not cfg.finite_t:
            ctl.sector_hint = state_list.sectors_contributing()
        return
    # per-sector neigen from the number of retained states + one step margin
    counts: Dict[SectorQN, int] = {}
    for s in state_list.states:
        counts[s.qn] = counts.get(s.qn, 0) + 1
    for sqn, c in counts.items():
        ctl.neigen_sector[sqn] = c + 1
    # grow/shrink total spectrum until the Boltzmann tail is below cutoff
    egs, emax = state_list.emin, state_list.emax
    tail = np.exp(-cfg.beta * (emax - egs))
    if tail > cfg.cutoff and state_list.max_size is not None \
            and state_list.size >= state_list.max_size:
        ctl.lanc_nstates_total += cfg.lanc_nstates_step
        log.info("post_diag: growing lanc_nstates_total -> %d (tail %.2e)",
                 ctl.lanc_nstates_total, tail)
    elif tail < cfg.cutoff and state_list.size > 2 * cfg.lanc_nstates_step:
        # trim states beyond the cutoff
        e_cut = egs - np.log(cfg.cutoff) / cfg.beta
        keep = [s for s in state_list.states if s.e <= e_cut]
        if len(keep) < state_list.size:
            ctl.lanc_nstates_total = max(len(keep), 1)
