import contextlib
import functools

from .observability import (KernelStats, kernel_stats, profile_trace,
                            spy_matrix, Timer)


def host_device():
    """Context manager pinning jax dispatch to the host CPU backend.

    Small concrete-shape math (bath functions, chi2 fits, frequency-grid
    sums) is latency-bound, not throughput-bound: on an accelerator every
    such op pays a dispatch and a host<->device transfer, while XLA-CPU
    runs it in microseconds. Falls back
    to a no-op when no cpu backend is registered.
    """
    import jax
    try:
        # local_devices, NOT devices: in multi-process (multi-controller)
        # runs jax.devices() is the GLOBAL list, and on ranks != 0 its first
        # cpu entry is process 0's non-addressable device — dispatching to
        # it tries to create a cross-process Gloo context the other ranks
        # never join and hangs (30 s DEADLINE_EXCEEDED in process_allgather).
        cpu = jax.local_devices(backend="cpu")[0]
    except (RuntimeError, IndexError):
        return contextlib.nullcontext()
    return jax.default_device(cpu)


def on_host(fn):
    """Decorator: run `fn` (and everything it dispatches) on the host CPU
    backend via :func:`host_device`."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with host_device():
            return fn(*args, **kwargs)
    return wrapper
