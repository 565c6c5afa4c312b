"""The native deployment artefact: the 6-state optimal-NPI EKF/EKS and its
Pareto epsilon sweep behind a plain C interface (the counterpart of the
reference's MATLAB Coder C++ project, SURVEY.md §2.9, and of
epidemicmodeling_tpu/deploy/).

The same C interface is built twice: for the card (csrc/newcase_ekf.cu, a
hand-written float64 kernel, the default) and for the CPU
(deploy/src/newcase_ekf.cpp, ``device="cpu"``, the JAX package's library
bit for bit). ``build_library()`` builds the CPU one; the card's builds at
its first call. ``pareto_sweep_plain`` is the sweep's plain PyTorch
version.
"""

from .native import (build_library, newcase_ekf_optimal_npi_native,
                     newcase_ekf_pareto_sweep_native)
from .plain import pareto_sweep_plain

__all__ = ["build_library", "newcase_ekf_optimal_npi_native",
           "newcase_ekf_pareto_sweep_native", "pareto_sweep_plain"]
