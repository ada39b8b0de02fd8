"""Regenerate tests/golden_bethe_u2.json at EXACTLY the settings of
tests/test_dmft.py::test_golden_bethe_u2, so the golden file is a tight
deterministic regression lock (egs comparable at ~1e-6) rather than a
cross-settings approximation (ADVICE r3: the 5e-4 egs tolerance absorbed a
settings mismatch and weakened total-energy regression detection).

Run:  python experiments/gen_golden.py   (runs on the CPU, where the golden
values were taken)
"""
import json
import os
import sys

import jax
jax.config.update("jax_platforms", "cpu")

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from dmft_lanc_ed_tpu.config import EDConfig          # noqa: E402
from dmft_lanc_ed_tpu.models.hm_bethe import run_dmft  # noqa: E402


def main():
    cfg = EDConfig(norb=1, nbath=5, uloc=(2.0,), beta=100.0, lmats=512,
                   lfit=256, lreal=20, nloop=40, dmft_error=1e-6,
                   cg_scheme="weiss", lanc_dim_threshold=4096)
    res = run_dmft(cfg, wband=1.0, wmixing=0.5, verbose=True)
    assert res.converged
    s = res.sigma_mats[0, 0, 0, 0]
    g = res.g_mats[0, 0, 0, 0]
    out = {
        "config": {"norb": 1, "nbath": 5, "uloc": 2.0, "beta": 100.0,
                   "wband": 1.0, "cg_scheme": "weiss", "dmft_error": 1e-6,
                   "lmats": 512, "lfit": 256, "lreal": 20, "wmixing": 0.5,
                   "note": "generated by experiments/gen_golden.py at the "
                           "EXACT settings of test_golden_bethe_u2 (host-"
                           "side chi2 fit path, round 4) — a deterministic "
                           "regression lock, not a reference-parity "
                           "certificate"},
        "converged": bool(res.converged),
        "iterations": int(res.iterations),
        "dens": float(res.dens[0]),
        "docc": float(res.docc[0]),
        "egs": float(res.observables.egs),
        "ekin": float(res.ekin),
        "epot": float(res.observables.epot),
        "ehartree": float(res.observables.ehartree),
        "zimp": float(res.observables.zimp[0, 0]),
        "sigma_iw0": [float(s[0].real), float(s[0].imag)],
        "sigma_iw10": [float(s[10].real), float(s[10].imag)],
        "g_iw0": [float(g[0].real), float(g[0].imag)],
    }
    path = os.path.join(os.path.dirname(__file__), "..", "tests",
                        "golden_bethe_u2.json")
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
