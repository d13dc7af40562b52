"""Flat-array IFS-facing radiation scheme wrapper.

Reference: ifs/radiation_scheme.F90 (RADIATION_SCHEME) +
ifs/radiation_setup.F90 (UV/PAR weights via config get_sw_weights,
radiation_config.F90:1625-1722).

``setup_radiation_scheme`` builds the consolidated config/tables plus the
UV/PAR band weights; ``radiation_scheme`` takes plain arrays (as the IFS
passes them), derives effective radii / overlap / cloud geometry with the
ifs parameterizations, runs the core ``radiation()`` and unpacks net
fluxes and surface diagnostics.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ecrad_tpu import constants
from ecrad_tpu.config import Config, Solver
from ecrad_tpu.interface import radiation, setup_radiation
from ecrad_tpu.ifs.parameterizations import (
    liquid_effective_radius, ice_effective_radius,
    cloud_overlap_decorr_len)
from ecrad_tpu.ifs import parameterizations as P
from ecrad_tpu.cloud_size import param_cloud_effective_separation_eta

RSIGMA = 5.67037321e-8


from ecrad_tpu.optics.spectral import get_sw_weights  # noqa: E402


class RadiationScheme(NamedTuple):
    config: Config
    tables: object
    iband_uv: np.ndarray
    weight_uv: np.ndarray
    iband_par: np.ndarray
    weight_par: np.ndarray
    # UV biologically effective flux weights (per g-point; ecCKD only,
    # radiation_config.F90:1724-1764) — None for band-only gas optics
    ig_uv_bio: Optional[np.ndarray] = None
    weight_uv_bio: Optional[np.ndarray] = None


def _mm(a, b):
    """Matrix product at full f32 precision (never TF32)."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def setup_radiation_scheme(config: Config, data_dir: str = None,
                           ) -> RadiationScheme:
    """SETUP_RADIATION_SCHEME (ifs/radiation_setup.F90:109-580): core
    setup + UV (0.2-0.4415 um) and PAR (0.4-0.7 um) weights.

    UV/PAR weights work for any SW gas model via the spectral
    definition built at setup (tables.specdef_sw): band-wise for RRTMG,
    per-g-point when do_cloud_aerosol_per_sw_g_point (ecCKD), matching
    get_sw_weights' use_bands choice (radiation_config.F90:1666-1668).
    """
    cfg = config.replace(do_surface_sw_spectral_flux=True,
                         do_canopy_fluxes_sw=True,
                         do_canopy_fluxes_lw=True)
    cfg, tables = setup_radiation(cfg, data_dir=data_dir)
    specdef = tables.specdef_sw
    use_bands = not cfg.do_cloud_aerosol_per_sw_g_point
    iband_uv, weight_uv = get_sw_weights(specdef, 0.2e-6, 0.4415e-6,
                                         use_bands)
    iband_par, weight_par = get_sw_weights(specdef, 0.4e-6, 0.7e-6,
                                           use_bands)
    ig_uv_bio = weight_uv_bio = None
    if not use_bands:
        from ecrad_tpu.optics.spectral import get_uv_biological_weights
        try:
            ig_uv_bio, weight_uv_bio = get_uv_biological_weights(specdef)
        except ValueError:
            pass
    return RadiationScheme(cfg, tables, iband_uv, weight_uv,
                           iband_par, weight_par,
                           ig_uv_bio, weight_uv_bio)


def radiation_scheme(scheme: RadiationScheme, *,
                     solar_irradiance, mu0, skin_temperature,
                     albedo_diffuse, albedo_direct, spectral_emissivity,
                     sin_lat, lon, land_frac,
                     pressure_fl, temperature_fl,
                     pressure_hl, temperature_hl,
                     q, co2, ch4, n2o, no2, cfc11, cfc12, hcfc22, ccl4,
                     o3,
                     cloud_frac, q_liquid, q_ice, q_rain, q_snow,
                     aerosol_mmr=None, ccn_land=None, ccn_sea=None,
                     re_liq=None, re_ice=None, cloud_overlap=None,
                     iseed=None, cloud_extra=None, fractional_std=None,
                     gas_units="mmr"):
    """RADIATION_SCHEME (ifs/radiation_scheme.F90): flat arrays in, net
    fluxes + surface diagnostics out.  Gas arrays are mass mixing
    ratios by default (the IFS convention: q is specific humidity used
    directly as the H2O MMR, and q_ice includes snow, L393-395); host
    models holding VMR arrays pass ``gas_units="vmr"`` (or a per-gas
    dict) and conversion happens through the ecrad_tpu.gas.Gas
    container (radiation_gas.F90:412-464 set_units path).

    cloud_extra: optional dict merged into the cloud inputs before the
    McICA generation step; supplying od_scaling_sw/_lw +
    total_cloud_cover_sw/_lw there bypasses the on-device generator
    (used by the BITIDENTITY-style cross-driver consistency test,
    reference Makefile:66-69 + driver/ecrad_ifs_driver.F90:445-452).

    The returned dict includes "_flux" (the full Flux container) so
    drivers can write net-flux output files."""
    cfg, tables = scheme.config, scheme.tables
    ncol, nlev = np.shape(pressure_fl)

    # effective radii (L396-413)
    if re_liq is None:
        re_liq = liquid_effective_radius(
            pressure_fl, temperature_fl, cloud_frac, q_liquid, q_rain,
            land_frac, ccn_land, ccn_sea)
    if re_ice is None:
        re_ice = ice_effective_radius(
            pressure_fl, temperature_fl, cloud_frac, q_ice, q_snow,
            sin_lat)

    # overlap parameter from latitude-dependent decorrelation (L415-424)
    if cloud_overlap is None:
        decorr_km, _, _ = cloud_overlap_decorr_len(sin_lat)
        # set_overlap_param (radiation_cloud.F90): layer-separation
        # overlap with per-column decorrelation length
        r_over_g = P.RD / constants.ACCEL_GRAVITY
        p_fl = 0.5 * (pressure_hl[:, :-1] + pressure_hl[:, 1:])
        t_fl = 0.5 * (temperature_hl[:, :-1] + temperature_hl[:, 1:])
        tbar = 0.5 * (t_fl[:, :-1] + t_fl[:, 1:])
        dz = r_over_g * tbar * jnp.log(
            p_fl[:, 1:] / jnp.maximum(p_fl[:, :-1], 1e-10))
        cloud_overlap = jnp.exp(
            -jnp.maximum(dz, 0.0) / (decorr_km[:, None] * 1000.0))

    if fractional_std is None:
        fractional_std = jnp.ones((ncol, nlev)) * 1.0  # RCLOUD_FRAC_STD
    else:
        fractional_std = jnp.asarray(fractional_std)

    cloud = {
        "fraction": jnp.asarray(cloud_frac),
        "q_liq": jnp.asarray(q_liquid),
        "q_ice": jnp.asarray(q_ice) + jnp.asarray(q_snow),
        "re_liq": jnp.asarray(re_liq),
        "re_ice": jnp.asarray(re_ice),
        "overlap_param": jnp.asarray(cloud_overlap),
        "fractional_std": fractional_std,
    }
    if Solver.SPARTACUS in (cfg.sw_solver, cfg.lw_solver):
        inv_cloud, inv_inhom = param_cloud_effective_separation_eta(
            np.asarray(pressure_hl), np.asarray(cloud_frac),
            2500.0, 14000.0, 3.5, 0.75)
        cloud["inv_cloud_effective_size"] = jnp.asarray(inv_cloud)
        cloud["inv_inhom_effective_size"] = jnp.asarray(inv_inhom)
    if cloud_extra:
        cloud.update({k: jnp.asarray(v) for k, v in cloud_extra.items()})
    if Solver.MCICA in (cfg.sw_solver, cfg.lw_solver) \
            and "od_scaling_sw" not in cloud \
            and "od_scaling_lw" not in cloud:
        # on-device counter-based generator (solvers/cloud_generator.py)
        from ecrad_tpu.solvers.cloud_generator import \
            cloud_generator_device
        if iseed is None:
            iseed = jnp.arange(1, ncol + 1)
        iseed = jnp.asarray(iseed)
        total_water = cloud["q_liq"] + cloud["q_ice"]
        keep = ((cloud["fraction"] >= cfg.cloud_fraction_threshold)
                & (total_water >= cfg.cloud_mixing_ratio_threshold))
        frac_c = jnp.where(keep, cloud["fraction"], 0.0)
        if cfg.sw_solver == Solver.MCICA:
            od_s, tcc = cloud_generator_device(
                cfg, tables.pdf_sampler, iseed, frac_c,
                cloud["overlap_param"], fractional_std, cfg.n_g_sw)
            cloud.update(od_scaling_sw=od_s, total_cloud_cover_sw=tcc)
        if cfg.lw_solver == Solver.MCICA:
            od_s, tcc = cloud_generator_device(
                cfg, tables.pdf_sampler, iseed + 997, frac_c,
                cloud["overlap_param"], fractional_std, cfg.n_g_lw)
            cloud.update(od_scaling_lw=od_s, total_cloud_cover_lw=tcc)

    # Fill the gas container via the library-level Gas API
    # (GAS%PUT x 9 + PUT_WELL_MIXED(O2), radiation_scheme.F90:527-536).
    # gas_units: "mmr" (IFS convention, default) or "vmr", or a per-gas
    # dict — host models with VMR arrays pass gas_units="vmr".
    from ecrad_tpu.gas import Gas
    gas = Gas.allocate(ncol, nlev, jnp.asarray(q).dtype)
    for name, arr in (("h2o", q), ("co2", co2), ("ch4", ch4),
                      ("n2o", n2o), ("no2", no2), ("cfc11", cfc11),
                      ("cfc12", cfc12), ("hcfc22", hcfc22),
                      ("ccl4", ccl4), ("o3", o3)):
        units = gas_units.get(name, "mmr") \
            if isinstance(gas_units, dict) else gas_units
        gas = gas.put(name, units, jnp.asarray(arr))
    # well-mixed O2 at 0.20944 VMR (radiation_scheme.F90:536)
    gas = gas.put_well_mixed("o2", "vmr", 0.20944)
    gas_mmr = gas.to_mmr()

    aerosol = None
    if cfg.use_aerosols and aerosol_mmr is not None:
        aerosol = {"mixing_ratio": jnp.asarray(aerosol_mmr)}

    flux = radiation(
        cfg, tables,
        pressure_hl=jnp.asarray(pressure_hl),
        temperature_hl=jnp.asarray(temperature_hl),
        gas_mmr=gas_mmr,
        cos_sza=jnp.asarray(mu0),
        skin_temperature=jnp.asarray(skin_temperature),
        sw_albedo=jnp.asarray(albedo_diffuse),
        sw_albedo_direct=jnp.asarray(albedo_direct),
        lw_emissivity=jnp.asarray(spectral_emissivity),
        solar_irradiance=float(solar_irradiance),
        cloud=cloud, aerosol=aerosol)

    # unpack (radiation_scheme.F90:293-345)
    out = {
        "flux_sw": flux.sw_dn - flux.sw_up,
        "flux_lw": flux.lw_dn - flux.lw_up,
        "flux_sw_clear": flux.sw_dn_clear - flux.sw_up_clear,
        "flux_lw_clear": flux.lw_dn_clear - flux.lw_up_clear,
        "flux_sw_dn_surf": flux.sw_dn[:, -1],
        "flux_lw_dn_surf": flux.lw_dn[:, -1],
        "flux_sw_dn_clear_surf": flux.sw_dn_clear[:, -1],
        "flux_lw_dn_clear_surf": flux.lw_dn_clear[:, -1],
        "flux_dir": flux.sw_dn_direct[:, -1],
        "flux_dir_clear": flux.sw_dn_direct_clear[:, -1],
        "flux_sw_dn_toa": flux.sw_dn[:, 0],
    }
    mu0j = jnp.asarray(mu0)
    out["flux_dir_into_sun"] = jnp.where(
        mu0j > np.finfo(np.float64).eps, out["flux_dir"]
        / jnp.maximum(mu0j, 1e-30), 0.0)

    # UV / PAR from surface spectral fluxes
    sdb = flux.sw_dn_surf_band
    sdb_clear = flux.sw_dn_surf_clear_band
    wuv = jnp.asarray(scheme.weight_uv)
    wpar = jnp.asarray(scheme.weight_par)
    out["flux_uv"] = _mm(sdb[:, jnp.asarray(scheme.iband_uv)], wuv)
    out["flux_par"] = _mm(sdb[:, jnp.asarray(scheme.iband_par)], wpar)
    out["flux_par_clear"] = _mm(
        sdb_clear[:, jnp.asarray(scheme.iband_par)], wpar)
    if scheme.ig_uv_bio is not None:
        # biologically effective UV (divide by 40 for UV index,
        # radiation_config.F90:1722-1724)
        out["flux_uv_biological"] = _mm(
            sdb[:, jnp.asarray(scheme.ig_uv_bio)],
            jnp.asarray(scheme.weight_uv_bio))

    # effective broadband emissivity (L327-333)
    black_body_net = out["flux_lw_dn_surf"] \
        - RSIGMA * jnp.asarray(skin_temperature) ** 4
    emis0 = jnp.asarray(spectral_emissivity)[:, 0]
    out["emissivity_out"] = jnp.where(
        jnp.abs(black_body_net) > 1.0e-5,
        jnp.clip(out["flux_lw"][:, -1] / black_body_net, 0.8, 0.99),
        emis0)

    if cfg.do_lw_derivatives:
        out["lw_derivative"] = flux.lw_derivatives
    if flux.sw_dn_diffuse_surf_canopy is not None:
        out["sw_diffuse_band"] = flux.sw_dn_diffuse_surf_canopy
        out["sw_direct_band"] = flux.sw_dn_direct_surf_canopy
    out["_flux"] = flux
    return out
