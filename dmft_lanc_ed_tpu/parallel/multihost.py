"""Multi-host (multi-process) inter-site parallelism.

JAX re-design of the reference's lattice MPI distribution
(`ed_solve_lattice_mpi`, ED_MAIN.f90:603-672): inequivalent impurity sites
are round-robined over MPI ranks (``do ilat=1+MPI_ID, Nsites, MPI_SIZE``),
each rank solves its subset, and the per-site result arrays — zeroed on the
ranks that did not solve them — are merged with MPI_AllReduce(SUM). The
bath-fit loop merges the same way (ED_FIT_CHI2.f90:215-240).

Here the same protocol rides the JAX multi-controller runtime:

- :func:`init_multihost` wraps ``jax.distributed.initialize`` (one process
  per host; the coordinator address, process count and process id are
  passed explicitly);
- :func:`my_sites` is the round-robin assignment;
- :func:`allreduce_sites` is the zero-fill + global-sum merge, implemented
  as a ``process_allgather`` over hosts followed by a sum over the process
  axis — semantically identical to the reference's AllReduce.

Intra-site (dw-axis) sharding composes underneath: each process solves its
sites on its local devices via :mod:`.production`.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence

import numpy as np

log = logging.getLogger("dmft_lanc_ed_tpu")


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   platform: Optional[str] = None) -> int:
    """Initialize the multi-controller runtime; returns this process' id.

    Pass all three of ``coordinator_address`` (``host:port``),
    ``num_processes`` and ``process_id``: nothing in a plain GPU or CPU
    launch tells JAX of a cluster. ``platform`` pins the JAX platform
    (e.g. ``"cpu"`` for test rigs) before the runtime starts."""
    import jax
    if platform:
        jax.config.update("jax_platforms", platform)
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    log.info("multihost: process %d/%d, %d local / %d global devices",
             jax.process_index(), jax.process_count(),
             jax.local_device_count(), jax.device_count())
    return jax.process_index()


def process_info() -> tuple:
    """(process_id, process_count) — (0, 1) when not distributed."""
    import jax
    try:
        return jax.process_index(), jax.process_count()
    except RuntimeError:
        return 0, 1


def my_sites(nlat: int) -> range:
    """Round-robin site assignment of this process (ED_MAIN.f90:603)."""
    pid, nproc = process_info()
    return range(pid, nlat, nproc)


def allreduce_sites(local: Dict[int, np.ndarray], nlat: int,
                    template_shape: Sequence[int],
                    dtype=np.float64) -> np.ndarray:
    """Merge per-site arrays across processes (zero-fill + sum AllReduce).

    ``local`` maps site index -> this process' result array (shape
    ``template_shape``). Returns the dense [nlat, *template_shape] array,
    identical on every process. Single-process: plain assembly."""
    full = np.zeros((nlat,) + tuple(template_shape), dtype)
    for i, arr in local.items():
        full[i] = np.asarray(arr, dtype)
    _, nproc = process_info()
    if nproc == 1:
        return full
    from jax.experimental import multihost_utils
    gathered = np.asarray(multihost_utils.process_allgather(full))
    return gathered.sum(axis=0)
