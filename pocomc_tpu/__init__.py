"""pocomc_tpu: Preconditioned Monte Carlo on JAX accelerators.

A from-scratch JAX/XLA re-design of the capabilities of pocoMC
(Karamanis et al., arXiv:2207.05660): adaptive-temperature Sequential
Monte Carlo with t-preconditioned Crank-Nicolson / random-walk Metropolis
mutation kernels, normalizing-flow preconditioning (MAF / NSF), persistent
sampling, and flow-importance-sampling evidence estimation — with every
hot loop compiled for the accelerator (an NVIDIA GPU) and particles
shardable over a device mesh.

Public API mirrors the reference package surface
(/root/reference/pocomc/__init__.py:27-31).
"""

from ._version import version, __version__

from .prior import (Prior, Normal, Uniform, LogUniform, TruncatedNormal,
                    LogNormal, Beta, Gamma, Exponential, HalfNormal,
                    Cauchy, StudentT, Laplace)
from .scaler import Reparameterize
from .particles import Particles
from .models.flow import Flow
from .models.geometry import Geometry
from .models.student import fit_mvstud
from .sampler import Sampler
from .parallel import MPIPool, ParticleMesh, initialize_distributed
from .ops.weights import (effective_sample_size, unique_sample_size,
                          compute_ess, increment_logz, trim_weights)
from .ops.resampling import systematic_resample, multinomial_resample

__all__ = [
    "Sampler", "Prior", "Flow", "Reparameterize", "Particles", "Geometry",
    "MPIPool", "ParticleMesh", "initialize_distributed", "fit_mvstud",
    "Normal", "Uniform", "LogUniform", "TruncatedNormal", "LogNormal",
    "Beta", "Gamma", "Exponential", "HalfNormal", "Cauchy", "StudentT",
    "Laplace",
    "effective_sample_size", "unique_sample_size", "compute_ess",
    "increment_logz", "trim_weights", "systematic_resample",
    "multinomial_resample",
    "version", "__version__",
]
