"""Impurity Green's functions and self-energy.

JAX re-design of the dynamical-response layer (ED_GF_NORMAL.f90,
ED_GF_SHARED.f90, ED_GREENS_FUNCTIONS.f90). Differences from the reference
that are deliberate re-architecture, not behavior changes:

- GFs are stored as **pole/weight data** (the reference's `GFmatrix` concept,
  ED_VARS_GLOBAL.f90:87-96) and evaluated on any frequency grid in one
  broadcast — the reference's per-frequency accumulation loops
  (ED_GF_NORMAL.f90:638-653) become a single [Npoles, L] rational-sum kernel.
- Excitation vectors c|psi>, c^+|psi> are built on HOST by injective fancy
  assignment over the precomputed sector maps (replacing the master-only
  loop + binary_search of ED_GF_NORMAL.f90:184-216); chains transfer them
  to the device once per batch.
- The Krylov tridiagonalization is the jitted scan of
  :func:`~dmft_lanc_ed_tpu.ops.lanczos.lanczos_tridiag`; the tiny tridiagonal
  eigenproblem runs on host LAPACK (same as the reference's `eigh`).

Conventions identical to the reference:
  pole contribution  peso/(z - isign*(lambda_j - E_i)),
  peso = norm2 * Z(1,j)^2 * boltzmann/Z  (add_to_lanczos_gf_normal).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from .bath import Bath
from .bath_functions import invg0_bath
from .utils import host_device
from .config import EDConfig
from .eigenspace import StateList
from .ops.lanczos import (lanczos_tridiag, lanczos_tridiag_batched, tridiag_eigh)
from .sectors import Sector, SectorQN, SectorTable, op_map

Channel = Tuple[int, int, int]   # (ispin, iorb, jorb)


@dataclass
class GFPoles:
    """Rational representation sum_k w_k / (z - p_k) of one GF channel."""
    weights: np.ndarray = field(default_factory=lambda: np.zeros(0))
    poles: np.ndarray = field(default_factory=lambda: np.zeros(0))

    def add(self, w: np.ndarray, p: np.ndarray) -> None:
        self.weights = np.concatenate([self.weights, w])
        self.poles = np.concatenate([self.poles, p])

    def __call__(self, z: np.ndarray) -> np.ndarray:
        # Host numpy on purpose: pole arrays are tiny and every distinct
        # pole count is a fresh shape — routing this through the device
        # means a recompile + transfer per sector/channel.
        if len(self.weights) == 0:
            return np.zeros(len(z), dtype=np.complex128)
        zz = np.asarray(z, np.complex128)
        w = np.asarray(self.weights, np.complex128)
        p = np.asarray(self.poles)
        return (w[None, :] / (zz[:, None] - p[None, :])).sum(-1)


@dataclass
class GFData:
    """All GF channels of one solve."""
    channels: Dict[Channel, GFPoles] = field(default_factory=dict)

    def get(self, c: Channel) -> GFPoles:
        if c not in self.channels:
            self.channels[c] = GFPoles()
        return self.channels[c]

    def evaluate(self, cfg: EDConfig, z: np.ndarray) -> np.ndarray:
        """[nspin, nspin, norb, norb, L] on the given frequency points."""
        out = np.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb, len(z)),
                       dtype=np.complex128)
        for (s, a, b), gp in self.channels.items():
            out[s, s, a, b] = gp(z)
        return out


# --------------------------------------------------------------------------
# excitation vectors: apply c / c^+ mapping between sectors, on device
# --------------------------------------------------------------------------
def apply_op(cfg: EDConfig, sec_from: Sector, sec_to: Sector, vec,
             iorb: int, ispin: int, create: bool) -> np.ndarray:
    """vvinit = c^{(+)}_{iorb, ispin} |vec>, mapped into sector `sec_to`.

    vec: flat in sector_from linear order; returns flat in sector_to order
    (ED_GF_NORMAL.f90:184-216 / 259-290 behavior). Runs on HOST: the c/cdg
    map is injective so the scatter is a fancy assignment over numpy
    arrays — the device version compiled a fresh gather/scatter executable
    per (source, target) sector-shape pair, and a sector scan queues
    hundreds of distinct pairs (the round-4 cold-GF wall's tail). The
    Krylov chains downstream transfer the start vectors once per batch.
    """
    du_f, dd_f, dp = sec_from.dim_up, sec_from.dim_dw, sec_from.dim_ph
    du_t, dd_t = sec_to.dim_up, sec_to.dim_dw
    v = np.asarray(vec).reshape(dp, dd_f, du_f)
    if ispin == 0:
        idx, sgn = op_map(sec_from.states_up[0], sec_to.states_up[0],
                          iorb, create)
        m = idx >= 0
        out = np.zeros((dp, dd_t, du_t), v.dtype)
        out[:, :, idx[m]] = v[:, :, m] * sgn[m].astype(v.dtype)[None, None]
    else:
        idx, sgn = op_map(sec_from.states_dw[0], sec_to.states_dw[0],
                          iorb, create)
        m = idx >= 0
        out = np.zeros((dp, dd_t, du_f), v.dtype)
        out[:, idx[m], :] = v[:, m, :] \
            * sgn[m].astype(v.dtype)[None, :, None]
    return out.reshape(-1)


# --------------------------------------------------------------------------
# Lanczos GF builder
# --------------------------------------------------------------------------
@dataclass
class BucketedOp:
    """2D pow2-padded sector operator for GF/chi Krylov chains.

    A chain started from a zero-padded vector has alphas/betas IDENTICAL to
    the unpadded chain (the pad rows form an exactly invariant, PAD_SHIFT-ed
    subspace — ops/batched.pad_dense_op_2d), and nothing but the
    tridiagonal ever leaves a GF chain — so chains can run at the bucket
    shape and XLA executables specialize per pow2 bucket instead of per
    distinct target sector. This is the cold-compile control: every distinct
    executable is one more compile in the first solve."""
    inner: object                 # padded DenseSectorOp
    apply: object                 # flat apply over the PADDED dim
    dim_ph: int
    dd: int
    du: int
    dd_p: int
    du_p: int

    @property
    def nnz(self) -> int:
        return self.inner.nnz

    @property
    def dim_pad(self) -> int:
        return self.dim_ph * self.dd_p * self.du_p

    def pad_flat(self, v) -> jnp.ndarray:
        """Host numpy pad (one device push): the eager jnp pad compiles a
        fresh executable per (batch, bucket) key."""
        lead = (self.dim_ph,) if self.dim_ph > 1 else ()
        v = np.asarray(v).reshape(lead + (self.dd, self.du))
        pad = ((0, 0),) * len(lead) + ((0, self.dd_p - self.dd),
                                       (0, self.du_p - self.du))
        return jnp.asarray(np.pad(v, pad).reshape(-1))

    def pad_batch(self, vb) -> jnp.ndarray:
        """[B, dim] -> padded [B, dim_pad] on host (see pad_flat)."""
        vb = np.asarray(vb)
        b = vb.shape[0]
        lead = (self.dim_ph,) if self.dim_ph > 1 else ()
        v = vb.reshape((b,) + lead + (self.dd, self.du))
        pad = ((0, 0),) * (1 + len(lead)) + ((0, self.dd_p - self.dd),
                                             (0, self.du_p - self.du))
        return jnp.asarray(np.pad(v, pad).reshape(b, -1))


def unwrap_op(op):
    """(inner_op, pad_flat, pad_batch) — identity passthrough for plain ops."""
    if isinstance(op, BucketedOp):
        return op.inner, op.pad_flat, op.pad_batch
    return op, None, None


class HCache:
    """Per-solve cache of sector operators (build once per sector); returns
    (op, apply_fn) pairs from the backend factory — pow2-bucketed
    (:class:`BucketedOp`) where cfg.ed_gf_bucket applies — and dw-sharded
    dense ops for large target sectors when cfg.mesh_shape is set (the GF
    tridiag then runs on scattered vectors, ED_GF_NORMAL.f90:224-238
    analogue)."""

    def __init__(self, cfg: EDConfig, table: SectorTable, hloc, bath: Bath,
                 h_basis=None):
        from .ops.factory import make_sector_op, platform
        from .parallel.production import shard_sector_op, solver_mesh
        self.cfg = cfg
        self._make = lambda sec: make_sector_op(
            cfg, sec, hloc, bath, h_basis=h_basis)
        self._build_sharded = lambda sec, mesh: shard_sector_op(
            cfg, sec, hloc, bath, h_basis, mesh)
        self.table = table
        self.mesh = solver_mesh(cfg)
        # "auto" buckets on the GPU, where each distinct chain shape is a
        # compile; the CPU compiles fast and runs the unpadded dims
        self.bucket = (cfg.ed_gf_bucket == "on"
                       or (cfg.ed_gf_bucket == "auto"
                           and platform() == "gpu"))
        self._cache: Dict[SectorQN, tuple] = {}
        self._sharded: Dict[SectorQN, object] = {}

    def _build(self, sec):
        from .ops.batched import _pow2_at_least, pad_dense_op_2d
        from .ops.dense import DenseSectorOp
        op, apply = self._make(sec)
        if self.bucket and isinstance(op, DenseSectorOp):
            du_p = _pow2_at_least(op.dim_up)
            dd_p = _pow2_at_least(op.dim_dw)
            if (du_p, dd_p) != (op.dim_up, op.dim_dw):
                padded = pad_dense_op_2d(op, du_p, dd_p)
                return (BucketedOp(inner=padded, apply=apply,
                                   dim_ph=op.dim_ph, dd=op.dim_dw,
                                   du=op.dim_up, dd_p=dd_p, du_p=du_p),
                        apply)
        return op, apply

    def __call__(self, sqn: SectorQN):
        if sqn not in self._cache:
            self._cache[sqn] = self._build(self.table.sector(sqn))
        return self._cache[sqn]

    def sharded(self, sqn: SectorQN):
        """ShardedSectorOp for the sector, or None when unsharded."""
        from .parallel.production import should_shard
        sec = self.table.sector(sqn)
        if not should_shard(self.cfg, self.mesh, sec.dim_dw, sec.dim):
            return None
        if sqn not in self._sharded:
            self._sharded[sqn] = self._build_sharded(sec, self.mesh)
        return self._sharded[sqn]


def _one_excitation(cfg: EDConfig, table: SectorTable, hcache: HCache,
                    state_vec: jnp.ndarray, state_e: float, sqn: SectorQN,
                    iorb: int, ispin: int, create: bool,
                    peso_bz: float, gf: GFPoles,
                    op_vec: Optional[jnp.ndarray] = None,
                    jqn_override: Optional[SectorQN] = None) -> None:
    """One ADD/REMOVE branch: excite, tridiagonalize, accumulate poles.

    Unbatched form, kept for API parity; the solver path batches through
    :class:`_ExcBatcher`."""
    isign = +1 if create else -1
    iud = iorb if table.ns_ud > 1 else 0
    jqn = jqn_override or (table.cdg_sector(sqn, iud, ispin) if create
                           else table.c_sector(sqn, iud, ispin))
    if jqn is None:
        return
    sec_i = table.sector(sqn)
    sec_j = table.sector(jqn)
    vv = np.asarray(op_vec) if op_vec is not None else apply_op(
        cfg, sec_i, sec_j, state_vec, iorb, ispin, create)
    norm2 = float(np.vdot(vv, vv).real)
    if norm2 < 1e-28:
        return
    vv = jnp.asarray(vv / np.sqrt(norm2))
    op, op_apply = hcache(jqn)
    op, pad_flat, _ = unwrap_op(op)
    if pad_flat is not None:
        vv = pad_flat(vv)
    m = min(vv.shape[0], cfg.lanc_ngfiter)
    from .utils.observability import kernel_stats
    kernel_stats.record(m, getattr(op, "nnz", 0))
    alphas, betas = lanczos_tridiag(op, vv, m, op_apply)
    theta, s = tridiag_eigh(alphas, betas)
    weights = norm2 * peso_bz * (s[0, :] ** 2)
    poles = isign * (theta - state_e)
    keep = np.abs(weights) > 1e-30
    gf.add(weights[keep], poles[keep])


class _ExcBatcher:
    """Collects excitation vectors by target sector, then runs them through
    one vmapped Lanczos scan per sector (batched continued fractions): the
    matvec streams each sector's factor tables once for the whole batch,
    replacing the reference's sequential per-orbital/per-state GF loops."""

    def __init__(self, cfg: EDConfig, hcache: HCache, max_bytes=1 << 27):
        self.cfg = cfg
        self.hcache = hcache
        self.groups: Dict[SectorQN, List] = {}
        self.max_bytes = max_bytes

    def add(self, jqn: SectorQN, vv: jnp.ndarray, norm2: float,
            state_e: float, isign: int, peso: float, gf: GFPoles) -> None:
        self.groups.setdefault(jqn, []).append(
            (vv, norm2, state_e, isign, peso, gf))

    @staticmethod
    def _accumulate(chunk, a_np, b_np) -> None:
        """Tridiagonals -> continued-fraction poles (add_to_lanczos_gf)."""
        for t, a, b in zip(chunk, a_np, b_np):
            _, norm2, state_e, isign, peso, gf = t
            theta, s = tridiag_eigh(a, b)
            weights = norm2 * peso * (s[0, :] ** 2)
            poles = isign * (theta - state_e)
            keep = np.abs(weights) > 1e-30
            gf.add(weights[keep], poles[keep])

    def run(self) -> None:
        import logging
        log = logging.getLogger("dmft_lanc_ed_tpu")
        from .utils.observability import kernel_stats
        for jqn, tasks in self.groups.items():
            log.debug("gf batch: sector %s, %d excitations, dim %d",
                      jqn, len(tasks), tasks[0][0].shape[0])
            sop = self.hcache.sharded(jqn)
            pad_batch = None
            if sop is not None:
                op, op_apply = sop.op, sop.apply_nd
            else:
                op, op_apply = self.hcache(jqn)
                op, _, pad_batch = unwrap_op(op)
            dim = tasks[0][0].shape[0]
            # bucketed ops use the bucket dim for the chain length so every
            # sector in a bucket shares one executable; the extra steps of
            # a small sector's chain break down benignly (beta=0, zero-
            # weight poles — see ops/lanczos.lanczos_tridiag)
            m_dim = dim if pad_batch is None else op.dim
            m = min(m_dim, self.cfg.lanc_ngfiter)
            # largest power of two within the byte budget, so the pow2
            # batch padding below never exceeds it (ADVICE r2)
            cap = max(1, self.max_bytes // max(dim * 8, 1))
            bmax = 1 << (cap.bit_length() - 1)
            for i0 in range(0, len(tasks), bmax):
                chunk = tasks[i0:i0 + bmax]
                # pad the batch with zero vectors (dead Krylov chains,
                # masked out below) to a power of two with a FIXED floor
                # of 8, so executables key on a stable batch size: the
                # state-list size fluctuates across DMFT iterations (GS
                # degeneracy changes) and every fresh (bucket, pow2-B)
                # pair would be a new compile mid-loop
                bpad = 8
                while bpad < len(chunk):
                    bpad *= 2
                bpad = min(bpad, bmax)
                if sop is not None:
                    vs = np.stack([np.asarray(t[0]) for t in chunk])
                    if bpad > len(chunk):
                        vs = np.concatenate(
                            [vs, np.zeros((bpad - len(chunk), dim))])
                    v0 = sop.pad_flat_batch(vs)
                else:
                    v0 = np.stack([np.asarray(t[0]) for t in chunk])
                    if bpad > len(chunk):
                        v0 = np.concatenate(
                            [v0, np.zeros((bpad - len(chunk), dim),
                                          v0.dtype)])
                    v0 = (pad_batch(v0) if pad_batch is not None
                          else jnp.asarray(v0))
                kernel_stats.record(m * len(chunk), getattr(op, "nnz", 0))
                a_b, b_b = lanczos_tridiag_batched(op, v0, m, op_apply)
                self._accumulate(chunk, np.asarray(a_b)[:len(chunk)],
                                 np.asarray(b_b)[:len(chunk)])
        self.groups.clear()


def _queue_excitation(cfg, table, batcher: _ExcBatcher, st, iorb, ispin,
                      create, peso, gf: GFPoles,
                      op_vec=None, jqn_override=None) -> None:
    isign = +1 if create else -1
    iud = iorb if table.ns_ud > 1 else 0
    jqn = jqn_override or (table.cdg_sector(st.qn, iud, ispin) if create
                           else table.c_sector(st.qn, iud, ispin))
    if jqn is None:
        return
    sec_i = table.sector(st.qn)
    sec_j = table.sector(jqn)
    vv = np.asarray(op_vec) if op_vec is not None else apply_op(
        cfg, sec_i, sec_j, st.vec, iorb, ispin, create)
    norm2 = float(np.vdot(vv, vv).real)
    if norm2 < 1e-28:
        return
    batcher.add(jqn, vv / np.sqrt(norm2), norm2, st.e, isign, peso, gf)


def build_gf_normal(cfg: EDConfig, table: SectorTable, hcache: HCache,
                    state_list: StateList) -> GFData:
    """Diagonal (and optional off-diagonal) electron GF (build_gf_normal),
    batched by target sector."""
    gf = GFData()
    weights, zeta = state_list.boltzmann_weights(cfg.beta, cfg.finite_t)
    offdiag = cfg.ed_solve_offdiag_gf or cfg.bath_type != "normal"
    batcher = _ExcBatcher(cfg, hcache)

    for w_s, st in zip(weights, state_list.states):
        if cfg.finite_t and cfg.beta * (st.e - state_list.emin) >= 200:
            continue
        peso = w_s / zeta
        for ispin in range(cfg.nspin):
            for iorb in range(cfg.norb):
                ch = gf.get((ispin, iorb, iorb))
                _queue_excitation(cfg, table, batcher, st, iorb, ispin,
                                  True, peso, ch)
                _queue_excitation(cfg, table, batcher, st, iorb, ispin,
                                  False, peso, ch)
        if offdiag:
            _queue_gf_offdiag(cfg, table, batcher, st, peso, gf)
    batcher.run()
    if offdiag:
        _recombine_offdiag(cfg, gf)
    return gf


def _queue_gf_offdiag(cfg, table, batcher, st, peso, gf: GFData) -> None:
    """Mixed-operator channels (c_a + c_b)|psi> for a != b
    (ED_GF_NORMAL.f90:347-588)."""
    sec_i = table.sector(st.qn)
    for ispin in range(cfg.nspin):
        for a in range(cfg.norb):
            for b in range(a + 1, cfg.norb):
                ch = gf.get((ispin, a, b))
                jqn = table.cdg_sector(st.qn, 0, ispin)
                if jqn is not None:
                    sec_j = table.sector(jqn)
                    vv = (apply_op(cfg, sec_i, sec_j, st.vec, a, ispin, True)
                          + apply_op(cfg, sec_i, sec_j, st.vec, b, ispin,
                                     True))
                    _queue_excitation(cfg, table, batcher, st, a, ispin,
                                      True, peso, ch, op_vec=vv,
                                      jqn_override=jqn)
                jqn = table.c_sector(st.qn, 0, ispin)
                if jqn is not None:
                    sec_j = table.sector(jqn)
                    vv = (apply_op(cfg, sec_i, sec_j, st.vec, a, ispin, False)
                          + apply_op(cfg, sec_i, sec_j, st.vec, b, ispin,
                                     False))
                    _queue_excitation(cfg, table, batcher, st, a, ispin,
                                      False, peso, ch, op_vec=vv,
                                      jqn_override=jqn)


def _recombine_offdiag(cfg: EDConfig, gf: GFData) -> None:
    """G_ab <- 1/2 (G_mix - G_aa - G_bb) pole-wise (ED_GF_NORMAL.f90:82-98)."""
    for ispin in range(cfg.nspin):
        for a in range(cfg.norb):
            for b in range(a + 1, cfg.norb):
                mix = gf.channels.get((ispin, a, b))
                if mix is None:
                    continue
                gaa = gf.get((ispin, a, a))
                gbb = gf.get((ispin, b, b))
                new = GFPoles()
                new.add(0.5 * mix.weights, mix.poles)
                new.add(-0.5 * gaa.weights, gaa.poles)
                new.add(-0.5 * gbb.weights, gbb.poles)
                gf.channels[(ispin, a, b)] = new
                gf.channels[(ispin, b, a)] = new   # symmetric


# --------------------------------------------------------------------------
# full-ED (Lehmann) GF for ed_diag_type == "full"
# --------------------------------------------------------------------------
def build_gf_full(cfg: EDConfig, table: SectorTable,
                  state_list: StateList) -> GFData:
    """Exact Lehmann sum over the full spectrum (full_build_gf_normal).

    G_aa(z) = 1/Z sum_{i,j} |<j| c^+_a |i>|^2 (e^{-bEi} + e^{-bEj})
              / (z - (Ej - Ei)).
    """
    gf = GFData()
    beta = cfg.beta
    offdiag = cfg.ed_solve_offdiag_gf or cfg.bath_type != "normal"
    # group by sector
    by_sector: Dict[SectorQN, List] = {}
    for st in state_list.states:
        by_sector.setdefault(st.qn, []).append(st)
    e0 = state_list.emin
    zeta = sum(np.exp(-beta * (st.e - e0)) for st in state_list.states)
    for ispin in range(cfg.nspin):
        accum: Dict[Tuple[int, int], list] = {}
        for sqn, states_i in by_sector.items():
            if table.ns_ud == 1:
                jqn = table.cdg_sector(sqn, 0, ispin)
                if jqn is None or jqn not in by_sector:
                    continue
                sec_i, sec_j = table.sector(sqn), table.sector(jqn)
                vecs_i = jnp.stack([s.vec for s in states_i])
                vecs_j = jnp.stack([s.vec for s in by_sector[jqn]])
                amps = {}
                for a in range(cfg.norb):
                    mapped = jnp.stack([
                        apply_op(cfg, sec_i, sec_j, v, a, ispin, True)
                        for v in vecs_i])                  # [Ni, dim_j]
                    amps[a] = np.asarray(vecs_j @ mapped.T)  # [Nj, Ni]
                ei = np.array([s.e for s in states_i])
                ej = np.array([s.e for s in by_sector[jqn]])
                wb = (np.exp(-beta * (ei[None, :] - e0))
                      + np.exp(-beta * (ej[:, None] - e0)))
                p = ej[:, None] - ei[None, :]
                for a in range(cfg.norb):
                    for b in range(cfg.norb):
                        if a != b and not offdiag:
                            continue
                        w = amps[a] * amps[b] * wb / zeta
                        keep = np.abs(w) > cfg.cutoff * 1e-3
                        accum.setdefault((a, b), []).append(
                            (w[keep], p[keep]))
            else:
                # orbital-resolved: each orbital has its own target sector
                for a in range(cfg.norb):
                    jqn = table.cdg_sector(sqn, a, ispin)
                    if jqn is None or jqn not in by_sector:
                        continue
                    sec_i, sec_j = table.sector(sqn), table.sector(jqn)
                    vecs_i = jnp.stack([s.vec for s in states_i])
                    vecs_j = jnp.stack([s.vec for s in by_sector[jqn]])
                    mapped = jnp.stack([
                        apply_op(cfg, sec_i, sec_j, v, a, ispin, True)
                        for v in vecs_i])
                    amp = np.asarray(vecs_j @ mapped.T)
                    ei = np.array([s.e for s in states_i])
                    ej = np.array([s.e for s in by_sector[jqn]])
                    wb = (np.exp(-beta * (ei[None, :] - e0))
                          + np.exp(-beta * (ej[:, None] - e0)))
                    w = (amp ** 2) * wb / zeta
                    p = ej[:, None] - ei[None, :]
                    keep = np.abs(w) > cfg.cutoff * 1e-3
                    accum.setdefault((a, a), []).append((w[keep], p[keep]))
        for (a, b), lst in accum.items():
            ch = gf.get((ispin, a, b))
            ch.add(np.concatenate([x[0] for x in lst]),
                   np.concatenate([x[1] for x in lst]))
    return gf


# --------------------------------------------------------------------------
# Dyson: self-energy (build_sigma_normal, ED_GF_NORMAL.f90:935-1002)
# --------------------------------------------------------------------------
def build_sigma(cfg: EDConfig, hloc, bath: Bath, gf: GFData, z: np.ndarray,
                h_basis=None) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (Sigma, G) on the given frequency points, reference layout."""
    g = gf.evaluate(cfg, z)
    with host_device():   # tiny fixed-grid math; no device round trip
        ig0 = np.asarray(invg0_bath(cfg, hloc, bath, jnp.asarray(z), h_basis))
    sigma = np.zeros_like(g)
    if cfg.bath_type == "normal" and not cfg.ed_solve_offdiag_gf:
        for s in range(cfg.nspin):
            for a in range(cfg.norb):
                sigma[s, s, a, a] = ig0[s, s, a, a] - 1.0 / g[s, s, a, a]
    else:
        for s in range(cfg.nspin):
            blk = g[s, s].transpose(2, 0, 1)          # [L, no, no]
            inv = np.linalg.inv(blk).transpose(1, 2, 0)
            sigma[s, s] = ig0[s, s] - inv
    return sigma, g
