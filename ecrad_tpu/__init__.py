"""ecrad_tpu: atmospheric radiative transfer in JAX for accelerators.

A from-scratch JAX/XLA/Pallas implementation with the capabilities of the
ECMWF ecRad radiation scheme (reference: ecmwf-ifs/ecrad v1.7.1).  Computes
shortwave and longwave up/down radiative fluxes and heating rates for batches
of independent atmospheric columns given pressure, temperature, gases, clouds,
aerosols and surface properties.

Design (not a port):
  * Arrays are laid out ``(ncol, nlev, ng)`` (or ``(nlev, ng, ncol)`` where
    the fused solver kernels run, ecrad_tpu.backend); columns are the
    batch/shard axis (pure data parallelism over a ``jax.sharding.Mesh``).
  * Vertical recurrences (adding method, overlap cumulants) are ``lax.scan``.
  * Gas/cloud/aerosol optics and solvers are decoupled and swappable, matching
    the reference architecture (radiation/radiation_interface.F90:333-499).
  * Setup ("consolidate") is host-side NumPy; the hot path is jitted JAX.
"""

from ecrad_tpu.config import Config
from ecrad_tpu.containers import (
    Gas, Cloud, Aerosol, Thermodynamics, SingleLevel, Flux,
)

__version__ = "0.1.0"
