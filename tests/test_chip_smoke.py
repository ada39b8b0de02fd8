"""chip_smoke.py: its pure helpers, its refusal to run without a GPU, and
its phases rehearsed at small sizes on the CPU with the GPU's defaults."""
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


@pytest.fixture
def gpu_defaults(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


def test_result_line_format():
    line = chip_smoke.result_line(True, "gpu", "NVIDIA H100 80GB HBM3", 1)
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    '"NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(chip_smoke.result_line(False, "gpu", "x", 4)) == {
        "ok": False, "device": {"platform": "gpu", "kind": "x", "count": 4}}


def test_four_selects_only_the_four_device_phase():
    assert chip_smoke.phases_for(True) == ["four"]
    assert "four" not in chip_smoke.phases_for(False)
    assert set(chip_smoke.phases_for(False)) | {"four"} == set(
        chip_smoke.PHASES)


def test_refuses_to_run_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_refuses_to_run_without_the_package(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_dmft_phase_rehearsal(gpu_defaults):
    assert chip_smoke.phase_dmft(nbath=3, lmats=64, lreal=16)


def test_large_phase_rehearsal(gpu_defaults):
    assert chip_smoke.phase_large(nbath=5, ed_batch_dim_max=100, lmats=64,
                                  lreal=16)


def test_four_device_phase_rehearsal(gpu_defaults):
    """The --four comparison on four of the virtual CPU devices."""
    assert len(jax.devices()) >= 4
    assert chip_smoke.phase_four(nbath=5, ed_batch_dim_max=100, lmats=64,
                                 lreal=16)
