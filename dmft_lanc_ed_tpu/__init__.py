"""dmft_lanc_ed_tpu — JAX Lanczos exact-diagonalization DMFT solver.

A from-scratch JAX/XLA re-design of the capabilities of the reference
Fortran+MPI solver lcrippa/dmft-lanc-ed (normal-phase (Nup, Ndw) quantum
impurity solver for DMFT): sector-blocked Hamiltonians as tensor-product
factors, Krylov eigensolvers and Green's functions as jitted scans, autodiff
bath fitting, and shard_map-sharded sector matvecs over a device mesh.

Public API mirrors the reference's DMFT_ED module surface (DMFT_ED.f90:2-66):
config/input parsing, bath helpers, `ed_init_solver`/`ed_solve`, getters for
Sigma/G/G0/observables, chi2 bath fit, and the DMFT self-consistency toolkit.
"""
import jax as _jax

# The ED core requires f64 (lanc_tolerance ~ 1e-18, gs_threshold ~ 1e-9;
# ED_INPUT_VARS.f90:179,190).
_jax.config.update("jax_enable_x64", True)

from . import compile_cache as _compile_cache  # noqa: E402

_compile_cache.configure()

from .config import EDConfig, read_input, save_used_input  # noqa: E402
from .bath import (  # noqa: E402
    Bath, bath_dimension, init_bath, pack_bath, unpack_bath,
    break_symmetry_bath, spin_symmetrize_bath, orb_symmetrize_bath,
    orb_equality_bath, ph_symmetrize_bath, ph_trans_bath,
    get_bath_component, set_bath_component, copy_bath_component,
)
from .sectors import Sector, SectorTable, qn  # noqa: E402
from .hamiltonian import (SectorHamiltonian, build_sector_hamiltonian,  # noqa: E402
                          dense_hamiltonian)
from .hloc import decompose_hloc, h_from_sym  # noqa: E402
from .solver import EDSolver, SolveResult, matsubara_grid, real_grid  # noqa: E402
from .lattice import LatticeSolver, LatticeResult  # noqa: E402
from .fit import chi2_fitgf  # noqa: E402

__version__ = "0.1.0"
