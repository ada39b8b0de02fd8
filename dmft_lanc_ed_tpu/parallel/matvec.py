"""Sharded sector matvec + Lanczos over a device mesh.

JAX re-design of the reference's intra-sector parallelism
(SURVEY.md §2 parallelism list): the MPI "Dw-split" row decomposition with
its `vector_transpose_MPI` AllToAllV sandwich (ED_HAMILTONIAN_COMMON.f90:53-118,
ED_HAMILTONIAN_SPARSE_HxV.f90:568-694) becomes a `shard_map` over a 1-D mesh:

  V is [DimDw, DimUp] sharded over the "dw" axis.
  - diagonal + up-hop: shard-local (up index is contiguous per shard)
  - dw-hop: lax.all_to_all transposes to an up-sharded layout
    [DimDw, DimUp/n], the dw ELL factor is applied fully locally, and a
    second all_to_all transposes back — exactly the reference's
    transpose -> local SpMV -> transpose-back, riding XLA collectives instead of MPI.
  - Lanczos dot products / norms: jnp.vdot on the sharded arrays (XLA
    inserts the psum), replacing P-ARPACK's internal reductions.

The communicator-shrink edge case (DimDw < nranks) is replaced by zero
padding: pad_sector_hamiltonian pads DimDw and DimUp to mesh multiples with
exact-zero rows, which are invariant under the matvec and invisible to dots.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..hamiltonian import SectorHamiltonian
from .mesh import pad_to_multiple


def pad_sector_hamiltonian(h: SectorHamiltonian, n: int) -> SectorHamiltonian:
    """Zero-pad DimDw and DimUp to multiples of the mesh size n."""
    dd, du = h.dim_dw, h.dim_up
    ddp, dup = pad_to_multiple(dd, n), pad_to_multiple(du, n)
    if ddp == dd and dup == du:
        return h
    pad2 = lambda a, r, c: jnp.pad(a, ((0, r), (0, c)))
    diag = pad2(h.diag, ddp - dd, dup - du)
    up_cols = jnp.pad(h.up_cols, ((0, dup - du), (0, 0)))
    up_vals = jnp.pad(h.up_vals, ((0, dup - du), (0, 0)))
    dw_cols = jnp.pad(h.dw_cols, ((0, ddp - dd), (0, 0)))
    dw_vals = jnp.pad(h.dw_vals, ((0, ddp - dd), (0, 0)))
    kw = {}
    if h.nd_up_src is not None:
        kw.update(
            nd_up_src=jnp.pad(h.nd_up_src, ((0, 0), (0, dup - du))),
            nd_up_val=jnp.pad(h.nd_up_val, ((0, 0), (0, dup - du))),
            nd_dw_src=jnp.pad(h.nd_dw_src, ((0, 0), (0, ddp - dd))),
            nd_dw_val=jnp.pad(h.nd_dw_val, ((0, 0), (0, ddp - dd))))
    if h.ph_diag is not None:
        kw.update(ph_diag=h.ph_diag,
                  eph_el=pad2(h.eph_el, ddp - dd, dup - du),
                  eph_x=h.eph_x)
    return SectorHamiltonian(diag=diag, up_cols=up_cols, up_vals=up_vals,
                             dw_cols=dw_cols, dw_vals=dw_vals, **kw)


def shard_hamiltonian(h: SectorHamiltonian, mesh: Mesh
                      ) -> SectorHamiltonian:
    """Pad and place the factors with dw-sharded layout on the mesh."""
    n = mesh.devices.size
    h = pad_sector_hamiltonian(h, n)
    ax = mesh.axis_names[0]
    row = NamedSharding(mesh, P(ax, None))     # [DimDw, ...] sharded rows
    rep = NamedSharding(mesh, P())
    put = jax.device_put
    kw = {}
    if h.nd_up_src is not None:
        kw.update(nd_up_src=put(h.nd_up_src, rep),
                  nd_up_val=put(h.nd_up_val, rep),
                  nd_dw_src=put(h.nd_dw_src, rep),
                  nd_dw_val=put(h.nd_dw_val, rep))
    if h.ph_diag is not None:
        kw.update(ph_diag=put(h.ph_diag, rep),
                  eph_el=put(h.eph_el, row),
                  eph_x=put(h.eph_x, rep))
    return SectorHamiltonian(
        diag=put(h.diag, row),
        up_cols=put(h.up_cols, rep), up_vals=put(h.up_vals, rep),
        dw_cols=put(h.dw_cols, rep), dw_vals=put(h.dw_vals, rep), **kw)


def _matvec_block(h: SectorHamiltonian, v: jnp.ndarray, axis: str,
                  n: int) -> jnp.ndarray:
    """Per-shard body: v is the local [DimDw/n, DimUp] block (2D; phonon
    sectors currently run on the replicated path)."""
    from ..ops.matvec import _apply_factor_rows
    dw_l, dup = v.shape
    # local terms: diagonal + up hops (up index fully local per shard,
    # applied as row gathers in the locally-transposed layout)
    y = h.diag * v
    vt_loc = v.T                              # [DimUp, dw_l]
    yt_loc = _apply_factor_rows(h.up_cols, h.up_vals, vt_loc,
                                jnp.zeros_like(vt_loc))
    y = y + yt_loc.T
    # dw hops via the all_to_all transpose (vector_transpose_MPI analogue):
    # [dw_l, DimUp] --a2a--> [DimDw, DimUp/n]: full dw, local up slice
    vt = jax.lax.all_to_all(v, axis, split_axis=1, concat_axis=0, tiled=True)
    yt = _apply_factor_rows(h.dw_cols, h.dw_vals, vt, jnp.zeros_like(vt))
    # transpose back: [DimDw, up_l] --a2a--> [dw_l, DimUp]
    yb = jax.lax.all_to_all(yt, axis, split_axis=0, concat_axis=1, tiled=True)
    y = y + yb
    # non-local (Jx/Jp) tensor-product terms: the reference falls back to
    # full vector replication here (allgather_vector_MPI,
    # ED_HAMILTONIAN_SPARSE_HxV.f90:674-692) — same strategy
    if h.nd_up_src is not None:
        i = jax.lax.axis_index(axis)
        vfull = jax.lax.all_gather(v, axis, axis=0, tiled=True)  # [DimDw, DimUp]

        def body(t, acc):
            tmp = vfull[:, h.nd_up_src[t]] * h.nd_up_val[t]
            contrib = tmp[h.nd_dw_src[t], :] * h.nd_dw_val[t][:, None]
            return acc + contrib

        acc = jax.lax.fori_loop(0, h.nd_up_src.shape[0], body,
                                jnp.zeros_like(vfull))
        y = y + jax.lax.dynamic_slice_in_dim(acc, i * dw_l, dw_l, 0)
    return y


def sharded_matvec(h_sharded: SectorHamiltonian, mesh: Mesh):
    """Build the jitted dw-sharded matvec closure for one (padded) sector."""
    ax = mesh.axis_names[0]
    n = mesh.devices.size

    @jax.jit
    def mv(v):
        return jax.shard_map(
            partial(_matvec_block, axis=ax, n=n),
            mesh=mesh,
            in_specs=(_h_specs(h_sharded, ax), P(ax, None)),
            out_specs=P(ax, None),
        )(h_sharded, v)
    return mv


def _h_specs(h: SectorHamiltonian, ax: str):
    """PartitionSpecs matching shard_hamiltonian's placement."""
    kw = dict(diag=P(ax, None), up_cols=P(), up_vals=P(),
              dw_cols=P(), dw_vals=P())
    none = SectorHamiltonian.__dataclass_fields__
    specs = {k: None for k in none}
    specs.update(kw)
    if h.nd_up_src is not None:
        specs.update(nd_up_src=P(), nd_up_val=P(),
                     nd_dw_src=P(), nd_dw_val=P())
    if h.ph_diag is not None:
        specs.update(ph_diag=P(), eph_el=P(ax, None), eph_x=P())
    return SectorHamiltonian(**{
        k: specs[k] for k in none})


class ShardedLanczos:
    """Lanczos tridiagonalization driving the sharded matvec.

    Dot products on dw-sharded [DimDw, DimUp] arrays — XLA inserts the psum
    over the mesh (the P-ARPACK global-reduction analogue).
    """

    def __init__(self, h: SectorHamiltonian, mesh: Mesh):
        if h.ph_diag is not None:
            raise NotImplementedError(
                "phonon sectors use the replicated matvec path for now")
        self.mesh = mesh
        self.n = mesh.devices.size
        self.h = shard_hamiltonian(h, mesh)
        self.mv = sharded_matvec(self.h, mesh)
        self.shape = self.h.diag.shape

    def pad_vec(self, v: jnp.ndarray, dim_dw: int, dim_up: int) -> jnp.ndarray:
        v2 = v.reshape(dim_dw, dim_up)
        ddp, dup = self.shape
        v2 = jnp.pad(v2, ((0, ddp - dim_dw), (0, dup - dim_up)))
        ax = self.mesh.axis_names[0]
        return jax.device_put(v2, NamedSharding(self.mesh, P(ax, None)))

    def tridiag(self, v0: jnp.ndarray, m: int):
        """(alphas, betas) like ops.lanczos.lanczos_tridiag."""
        @partial(jax.jit, static_argnames=("steps",))
        def run(v0, steps: int):
            def step(carry, _):
                v_prev, v, beta = carry
                w = self.mv(v) - beta * v_prev
                alpha = jnp.vdot(v, w).real
                w = w - alpha * v
                beta_new = jnp.linalg.norm(w)
                ok = beta_new > 1e-30
                v_new = jnp.where(ok, w / jnp.where(ok, beta_new, 1.0), 0.0)
                alive = jnp.linalg.norm(v) > 0.5
                alpha = jnp.where(alive, alpha, 0.0)
                beta_new = jnp.where(ok, beta_new, 0.0)
                return (v, v_new, beta_new), (alpha, beta_new)
            (_, _, _), (alphas, betas) = jax.lax.scan(
                step, (jnp.zeros_like(v0), v0, jnp.array(0.0, v0.dtype)),
                None, length=steps)
            betas = jnp.concatenate([jnp.zeros((1,), v0.dtype), betas[:-1]])
            return alphas, betas
        return run(v0, m)
