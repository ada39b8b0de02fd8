"""Where JAX's persistent compilation cache lives.

A sector scan compiles one executable per sector shape; a persistent cache
lets repeated runs (DMFT loops, restarts, benchmarks) load them instead of
compiling again. The rule:

- ``JAX_COMPILATION_CACHE_DIR`` set: that directory, and no other;
- otherwise on the GPU: ``<checkout>/.jax_cache``, one fixed path, so that
  every later process finds what an earlier one compiled;
- otherwise (CPU): no cache. CPU executables embed the host's machine
  features, and reloading them in a process started with other flags risks
  SIGILL.

The platform is read from JAX's configuration and its installed plugins,
without initialising a backend: ``jax.distributed.initialize`` has to run
before that, and importing this package must not prevent it.
"""
from __future__ import annotations

import os
import pkgutil
from typing import Mapping, Optional

ENV = "JAX_COMPILATION_CACHE_DIR"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cache_dir(env: Mapping[str, str], platform: str,
              root: str = ROOT) -> Optional[str]:
    """The cache directory for this process, or None for no cache."""
    if env.get(ENV):
        return env[ENV]
    if platform == "gpu":
        return os.path.join(root, ".jax_cache")
    return None


def requested_platform(platforms: Optional[str] = None) -> str:
    """"gpu" or "cpu": the platform JAX will pick, read without starting it.

    An explicit ``jax_platforms`` setting (or ``platforms``) decides; with
    none, JAX prefers a CUDA device whenever its CUDA plugin is installed."""
    if platforms is None:
        import jax
        platforms = jax.config.jax_platforms or ""
    first = platforms.split(",")[0].strip()
    if first:
        return "gpu" if first in ("cuda", "gpu") else first
    try:
        import jax_plugins
    except ImportError:
        return "cpu"
    names = [m.name for m in pkgutil.iter_modules(jax_plugins.__path__)]
    return "gpu" if any("cuda" in n for n in names) else "cpu"


def configure() -> Optional[str]:
    """Point JAX at :func:`cache_dir`; returns the directory in use."""
    import jax
    path = cache_dir(os.environ, requested_platform())
    if path is None:
        return None
    if not os.environ.get(ENV):     # JAX reads the variable itself
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
