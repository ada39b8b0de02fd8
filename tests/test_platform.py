"""Platform-keyed defaults, retired options and the compile-cache rule."""
import os
import time

import jax
import pytest

from dmft_lanc_ed_tpu import compile_cache
from dmft_lanc_ed_tpu.config import EDConfig, read_input
from dmft_lanc_ed_tpu.ops.factory import (platform, resolve_backend,
                                          resolve_precision)


@pytest.mark.parametrize("plat, sparse_h, backend", [
    ("gpu", True, "dense"),
    ("gpu", False, "direct"),
    ("cpu", True, "ell"),
    ("cpu", False, "direct"),
])
def test_auto_backend_and_precision_per_platform(monkeypatch, plat,
                                                 sparse_h, backend):
    monkeypatch.setattr(jax, "default_backend", lambda: plat)
    cfg = EDConfig(ed_sparse_h=sparse_h)
    assert resolve_backend(cfg) == backend
    assert resolve_precision(cfg) == "f64"
    # explicit choices are never overridden by the platform
    cfg = EDConfig(ed_sparse_h=sparse_h, ed_backend="ell",
                   ed_precision="mixed")
    assert (resolve_backend(cfg), resolve_precision(cfg)) == ("ell", "mixed")


@pytest.mark.parametrize("plat", ["rocm", "metal"])
def test_unknown_platform_raises(monkeypatch, plat):
    monkeypatch.setattr(jax, "default_backend", lambda: plat)
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        platform()
    with pytest.raises(RuntimeError):
        resolve_backend(EDConfig())
    with pytest.raises(RuntimeError):
        resolve_precision(EDConfig())


def test_pallas_backend_rejected():
    with pytest.raises(ValueError, match="pallas"):
        EDConfig(ed_backend="pallas")


def test_retired_option_in_input_file_rejected(tmp_path):
    path = tmp_path / "inputED.conf"
    path.write_text("NBATH=4\nED_GF_CHAIN_MIN_DIM=65536\n")
    with pytest.raises(ValueError, match="ED_GF_CHAIN_MIN_DIM"):
        read_input(str(path))


def test_retired_option_as_override_rejected():
    with pytest.raises(ValueError, match="was removed"):
        read_input(None, ed_gf_chain_min_dim=0)


def test_cache_dir_env_wins_on_every_platform():
    env = {compile_cache.ENV: "/some/cache"}
    assert compile_cache.cache_dir(env, "gpu", "/repo") == "/some/cache"
    assert compile_cache.cache_dir(env, "cpu", "/repo") == "/some/cache"


def test_cache_dir_gpu_default_is_fixed_path_in_checkout():
    a = compile_cache.cache_dir({}, "gpu", "/repo")
    time.sleep(0.01)
    b = compile_cache.cache_dir({}, "gpu", "/repo")
    assert a == b == os.path.join("/repo", ".jax_cache")
    assert str(os.getpid()) not in a
    # the default root is this checkout, and .gitignore lists the cache
    root = compile_cache.ROOT
    assert os.path.exists(os.path.join(root, "dmft_lanc_ed_tpu"))
    with open(os.path.join(root, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_cache_dir_off_on_cpu_without_env():
    assert compile_cache.cache_dir({}, "cpu", "/repo") is None


@pytest.mark.parametrize("setting, expect", [
    ("cpu", "cpu"), ("cuda", "gpu"), ("gpu,cpu", "gpu")])
def test_requested_platform_reads_setting(setting, expect):
    assert compile_cache.requested_platform(setting) == expect
