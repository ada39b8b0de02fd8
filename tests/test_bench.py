"""bench.py and bench_matrix.py: the peak table, the floors, and their
refusal to run without a GPU."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import bench  # noqa: E402
import bench_matrix  # noqa: E402


def test_peak_table_rejects_unknown_device():
    with pytest.raises(KeyError, match="no peak rates"):
        bench.peaks("NVIDIA H100 PCIe")
    assert bench.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_s"] == 3.35e12


def test_floors_of_the_854k_sector():
    f = bench.floors(853776, 924, 924, bench.peaks("NVIDIA H100 80GB HBM3"))
    assert f["hbm_s"] == pytest.approx(4.0777e-6, rel=1e-4)
    assert f["dense_matmul_s"] == pytest.approx(4.7098e-5, rel=1e-4)
    assert f["dense_mixed_matmul_s"] == pytest.approx(f["dense_matmul_s"])


def test_bench_refuses_to_run_without_gpu(monkeypatch):
    monkeypatch.delenv("BENCH_CPU", raising=False)
    assert bench.main() == 1


@pytest.mark.parametrize("name, kw", [
    ("ell", {"ed_backend": "ell"}),
    ("dense-mixed", {"ed_backend": "dense", "ed_precision": "mixed"})])
def test_bench_matrix_backend_names(name, kw):
    assert bench_matrix.backend_kw(name) == kw
