"""Tracing / profiling / observability.

Replaces the reference's SF_TIMER wall-clock timers + matvec iteration
counter + sp_spy_matrix gnuplot dumps (SURVEY.md §5.1) with:

- :class:`Timer` — nested phase timers (the timings dict on SolveResult)
- :class:`KernelStats` — global matvec/nnz counters, giving Lanczos iters/s
  and nnz/s summaries per solve (the `iter` counter analogue)
- :func:`profile_trace` — context manager around `jax.profiler` for full
  XLA traces viewable in TensorBoard/Perfetto
- :func:`spy_matrix` — sector-factor sparsity pattern as a portable bitmap
  (sp_spy_matrix analogue, no gnuplot needed)
"""
from __future__ import annotations

import contextlib
import subprocess
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass
class KernelStats:
    """Global counters for the hot kernels (reset per solve)."""
    matvecs: int = 0
    nnz_applied: int = 0
    seconds: float = 0.0

    def record(self, n_matvecs: int, nnz_per_mv: int, seconds: float = 0.0):
        self.matvecs += n_matvecs
        self.nnz_applied += n_matvecs * nnz_per_mv
        self.seconds += seconds

    def reset(self):
        self.matvecs = 0
        self.nnz_applied = 0
        self.seconds = 0.0

    def summary(self) -> Dict[str, float]:
        out = dict(matvecs=self.matvecs, nnz_applied=self.nnz_applied)
        if self.seconds > 0:
            out["matvecs_per_s"] = self.matvecs / self.seconds
            out["nnz_per_s"] = self.nnz_applied / self.seconds
        return out


kernel_stats = KernelStats()


class Timer:
    """Nested phase timing: with Timer.phase('diag'): ..."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + \
                time.perf_counter() - t0


def nvidia_smi() -> str:
    """The cards' names and power limits, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them. A child process that never touches JAX reads them, so it opens no
    card. Every timing taken on a GPU is reported beside this line."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip() or f"nvidia-smi rc={r.returncode}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """jax.profiler trace if a logdir is given, else no-op."""
    if not logdir:
        yield
        return
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def spy_matrix(cols: np.ndarray, vals: np.ndarray, n: int, path: str) -> None:
    """Write the sparsity pattern of an ELL factor as a PBM bitmap
    (sp_spy_matrix analogue, ED_SPARSE_MATRIX.f90:452-565)."""
    img = np.zeros((n, n), dtype=np.int8)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    for k in range(cols.shape[1]):
        nz = vals[:, k] != 0
        img[np.nonzero(nz)[0], cols[nz, k]] = 1
    with open(path, "w") as fh:
        fh.write(f"P1\n{n} {n}\n")
        for row in img:
            fh.write(" ".join(str(int(x)) for x in row) + "\n")
