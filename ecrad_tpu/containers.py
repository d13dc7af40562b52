"""Input/output data containers as JAX pytrees.

These mirror the reference derived types (radiation_gas.F90,
radiation_cloud.F90, radiation_aerosol.F90, radiation_thermodynamics.F90,
radiation_single_level.F90, radiation_flux.F90) but are plain immutable
array pytrees:

  * batch (column) axis first everywhere: ``(ncol, nlev, ...)``
  * the spectral axis (g-points / bands) is always **last**
  * gases are one stacked array indexed by ``constants.GAS_INDEX``, always in
    volume mixing ratio (mol/mol); unit conversion happens at ingest
    (radiation_gas.F90 tracks per-gas units + scalings at run time instead).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from ecrad_tpu import constants


def _pytree_dataclass(cls):
    """Frozen dataclass registered as a JAX pytree (every field a node),
    with ``replace``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    return jax.tree_util.register_dataclass(
        cls, data_fields=[f.name for f in dataclasses.fields(cls)],
        meta_fields=[])


@_pytree_dataclass
class Thermodynamics:
    """radiation_thermodynamics.F90:29-48."""
    pressure_hl: jnp.ndarray       # (ncol, nlev+1) Pa, TOA first
    temperature_hl: jnp.ndarray    # (ncol, nlev+1) K

    @property
    def ncol(self):
        return self.pressure_hl.shape[0]

    @property
    def nlev(self):
        return self.pressure_hl.shape[1] - 1

    def pressure_fl(self):
        """Full-level pressure (mean of half levels)."""
        return 0.5 * (self.pressure_hl[:, :-1] + self.pressure_hl[:, 1:])

    def temperature_fl(self):
        return 0.5 * (self.temperature_hl[:, :-1]
                      + self.temperature_hl[:, 1:])

    def layer_mass(self):
        """Mass of a layer per unit area, kg m-2
        (radiation_thermodynamics.F90 get_layer_mass)."""
        dp = self.pressure_hl[:, 1:] - self.pressure_hl[:, :-1]
        return dp * (1.0 / constants.ACCEL_GRAVITY)


@_pytree_dataclass
class Gas:
    """Gas mixing ratios, always stored as VMR (mol/mol).

    Reference: radiation_gas.F90:36-79 stores (ncol,nlev,NMaxGases) with
    per-gas unit codes; here ingest converts everything to VMR once.
    """
    vmr: jnp.ndarray               # (ncol, nlev, NUM_GASES)

    @classmethod
    def create(cls, ncol: int, nlev: int, dtype=jnp.float32) -> "Gas":
        return cls(vmr=jnp.zeros((ncol, nlev, constants.NUM_GASES), dtype))

    def put(self, name: str, value) -> "Gas":
        """Set one gas from a (ncol, nlev) VMR field."""
        idx = constants.GAS_INDEX[name]
        return self.replace(vmr=self.vmr.at[:, :, idx].set(value))

    def put_well_mixed(self, name: str, vmr_scalar) -> "Gas":
        idx = constants.GAS_INDEX[name]
        return self.replace(vmr=self.vmr.at[:, :, idx].set(vmr_scalar))

    def get(self, name: str) -> jnp.ndarray:
        return self.vmr[:, :, constants.GAS_INDEX[name]]

    @staticmethod
    def mmr_to_vmr(name: str, mmr):
        return mmr * (constants.MOLAR_MASS_DRY_AIR
                      / constants.MOLAR_MASS[name])


@_pytree_dataclass
class Cloud:
    """radiation_cloud.F90:33-94 (two-type liquid/ice specialization).

    General hydrometeor types are stacked along the last axis of
    ``mixing_ratio``/``effective_radius``; for the classic IFS pair,
    index 0 = liquid, 1 = ice.
    """
    mixing_ratio: jnp.ndarray         # (ncol, nlev, ntype) kg/kg gridbox-mean
    effective_radius: jnp.ndarray     # (ncol, nlev, ntype) m
    fraction: jnp.ndarray             # (ncol, nlev)
    fractional_std: Optional[jnp.ndarray] = None        # (ncol, nlev)
    overlap_param: Optional[jnp.ndarray] = None         # (ncol, nlev-1)
    inv_cloud_effective_size: Optional[jnp.ndarray] = None   # (ncol, nlev) 1/m
    inv_inhom_effective_size: Optional[jnp.ndarray] = None   # (ncol, nlev) 1/m

    @property
    def q_liq(self):
        return self.mixing_ratio[:, :, 0]

    @property
    def q_ice(self):
        return self.mixing_ratio[:, :, 1]

    @property
    def re_liq(self):
        return self.effective_radius[:, :, 0]

    @property
    def re_ice(self):
        return self.effective_radius[:, :, 1]

    def crop_cloud_fraction(self, frac_threshold: float,
                            mr_threshold: float) -> "Cloud":
        """Zero cloud fraction where fraction or total water is negligible
        (radiation_cloud.F90 crop_cloud_fraction)."""
        total = jnp.sum(self.mixing_ratio, axis=-1)
        keep = (self.fraction >= frac_threshold) & (total >= mr_threshold)
        return self.replace(fraction=jnp.where(keep, self.fraction, 0.0))


@_pytree_dataclass
class Aerosol:
    """radiation_aerosol.F90:28-56."""
    mixing_ratio: Optional[jnp.ndarray] = None    # (ncol, nlev, ntype) kg/kg
    # Alternative direct specification of optical properties per band:
    od_sw: Optional[jnp.ndarray] = None           # (ncol, nlev, nband_sw)
    ssa_sw: Optional[jnp.ndarray] = None
    g_sw: Optional[jnp.ndarray] = None
    od_lw: Optional[jnp.ndarray] = None           # (ncol, nlev, nband_lw)
    ssa_lw: Optional[jnp.ndarray] = None


@_pytree_dataclass
class SingleLevel:
    """radiation_single_level.F90:29-101."""
    cos_sza: jnp.ndarray                 # (ncol,)
    skin_temperature: jnp.ndarray        # (ncol,) K
    sw_albedo: jnp.ndarray               # (ncol, n_albedo_intervals)
    lw_emissivity: jnp.ndarray           # (ncol, n_emiss_intervals)
    sw_albedo_direct: Optional[jnp.ndarray] = None
    solar_irradiance: float = 1366.0     # W m-2 (scalar)
    spectral_solar_scaling: Optional[jnp.ndarray] = None
    spectral_solar_cycle_multiplier: float = 0.0
    iseed: Optional[jnp.ndarray] = None  # (ncol,) int — McICA RNG seed


@_pytree_dataclass
class Flux:
    """Output fluxes (radiation_flux.F90:38-110). All in W m-2.

    Level axis is half-levels, TOA first, ``(ncol, nlev+1)``.
    Spectral axes ("band") are last.
    """
    lw_up: Optional[jnp.ndarray] = None
    lw_dn: Optional[jnp.ndarray] = None
    sw_up: Optional[jnp.ndarray] = None
    sw_dn: Optional[jnp.ndarray] = None
    sw_dn_direct: Optional[jnp.ndarray] = None
    lw_up_clear: Optional[jnp.ndarray] = None
    lw_dn_clear: Optional[jnp.ndarray] = None
    sw_up_clear: Optional[jnp.ndarray] = None
    sw_dn_clear: Optional[jnp.ndarray] = None
    sw_dn_direct_clear: Optional[jnp.ndarray] = None
    # Spectral flux profiles, (ncol, nlev+1, nspec)
    lw_up_band: Optional[jnp.ndarray] = None
    lw_dn_band: Optional[jnp.ndarray] = None
    sw_up_band: Optional[jnp.ndarray] = None
    sw_dn_band: Optional[jnp.ndarray] = None
    sw_dn_direct_band: Optional[jnp.ndarray] = None
    lw_up_clear_band: Optional[jnp.ndarray] = None
    lw_dn_clear_band: Optional[jnp.ndarray] = None
    sw_up_clear_band: Optional[jnp.ndarray] = None
    sw_dn_clear_band: Optional[jnp.ndarray] = None
    sw_dn_direct_clear_band: Optional[jnp.ndarray] = None
    # Surface spectral diagnostics, (ncol, nband)
    sw_dn_surf_band: Optional[jnp.ndarray] = None
    sw_dn_direct_surf_band: Optional[jnp.ndarray] = None
    sw_dn_surf_clear_band: Optional[jnp.ndarray] = None
    sw_dn_direct_surf_clear_band: Optional[jnp.ndarray] = None
    # TOA spectral diagnostics
    sw_dn_toa_band: Optional[jnp.ndarray] = None
    sw_up_toa_band: Optional[jnp.ndarray] = None
    sw_up_toa_clear_band: Optional[jnp.ndarray] = None
    lw_up_toa_band: Optional[jnp.ndarray] = None
    lw_up_toa_clear_band: Optional[jnp.ndarray] = None
    # Canopy fluxes, (ncol, n_canopy_bands)
    lw_dn_surf_canopy: Optional[jnp.ndarray] = None
    sw_dn_diffuse_surf_canopy: Optional[jnp.ndarray] = None
    sw_dn_direct_surf_canopy: Optional[jnp.ndarray] = None
    # Diagnostics
    cloud_cover_lw: Optional[jnp.ndarray] = None   # (ncol,)
    cloud_cover_sw: Optional[jnp.ndarray] = None
    lw_derivatives: Optional[jnp.ndarray] = None   # (ncol, nlev+1)
