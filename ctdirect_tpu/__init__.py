"""ctdirect_tpu — a direct-transcription optimal-control framework in JAX.

Converts ODE-constrained optimal control problems (OCPs) into finite-dimensional
nonlinear programs (DOCPs) via collocation / direct shooting, and solves them with a
from-scratch structure-exploiting interior-point method written in JAX — so the whole
solve jits, vmaps across thousands of problem instances, and shards over device meshes.

Capability blueprint: control-toolbox/CTDirect.jl (see SURVEY.md). This is a
re-design for an accelerator, not a port: residuals are evaluated vectorized over the whole
collocation grid, derivatives come from JAX AD (no sparsity detection or hand patterns),
and the KKT system is solved by block-structured factorization instead of a general
sparse LU.

Precision: like the reference (Float64-only Julia), we default to float64 for
convergence parity with Ipopt-class solvers. Set CTDIRECT_TPU_X64=0 before import to
experiment with float32.
"""

import os as _os

if _os.environ.get("CTDIRECT_TPU_X64", "1") != "0":
    import jax as _jax

    _jax.config.update("jax_enable_x64", True)

from ctdirect_tpu.model import (  # noqa: E402
    OCP,
    PreOCP,
    define,
    InitialGuess,
    Solution,
)
from ctdirect_tpu.transcription import (  # noqa: E402
    DOCP,
    transcribe,
    Collocation,
    DirectShooting,
    discretize,
)
from ctdirect_tpu.solver import IPMOptions, solve, solve_docp  # noqa: E402

__all__ = [
    "OCP",
    "PreOCP",
    "InitialGuess",
    "Solution",
    "DOCP",
    "transcribe",
    "Collocation",
    "DirectShooting",
    "discretize",
    "IPMOptions",
    "solve",
    "solve_docp",
]

__version__ = "0.1.0"
