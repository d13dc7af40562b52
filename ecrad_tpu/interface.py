"""Radiation scheme orchestration.

Equivalent of radiation/radiation_interface.F90: ``setup_radiation``
(host-side, loads LUTs and computes spectral mappings → a pytree of
tables + an updated static Config) and ``radiation`` (the jittable hot
path, dispatching gas optics / cloud optics / aerosols / solvers).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ecrad_tpu import backend, constants
from ecrad_tpu.config import Config, GasModel, Solver
from ecrad_tpu.containers import Flux
from ecrad_tpu.optics import aerosol as aerosol_mod
from ecrad_tpu.optics import cloud as cloud_optics_mod
from ecrad_tpu.optics import ecckd as ecckd_mod
from ecrad_tpu.optics import general_cloud as general_cloud_mod
from ecrad_tpu.optics import monochromatic as mono_mod
from ecrad_tpu.optics import rrtmg, rrtmg_data, spectral
from ecrad_tpu.solvers import cloudless, mcica, spartacus, tripleclouds


def _mm(a, b):
    """Matrix product at full f32 precision (never TF32)."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


class Tables(NamedTuple):
    """Setup-time derived arrays (device-resident pytree, replicated)."""
    gas: Dict                      # gas-optics tables
    gas_meta: Optional[Dict] = None       # ecCKD static metadata
    sw_albedo_weights: Optional[np.ndarray] = None   # (nalbedo, nbands_sw)
    lw_emiss_weights: Optional[np.ndarray] = None    # (nemiss, nbands_lw)
    i_albedo_from_band_sw: Optional[np.ndarray] = None
    i_emiss_from_band_lw: Optional[np.ndarray] = None
    band_from_g_sw: Optional[np.ndarray] = None      # (n_g_sw,) 0-based
    band_from_g_lw: Optional[np.ndarray] = None
    cloud: Optional[Dict] = None                     # cloud-optics tables
    aerosol: Optional[Dict] = None                   # aerosol-optics tables
    pdf_sampler: Optional[Dict] = None               # McICA PDF LUT
    specdef_sw: Optional[object] = None              # SpectralDefinition
    specdef_lw: Optional[object] = None


def setup_radiation(config: Config, data_dir: str = None):
    """Host-side setup (radiation_interface.F90:37-156).

    data_dir overrides config.directory_name for locating optics files.
    Returns (consolidated config, Tables).
    """
    if (GasModel.MONOCHROMATIC in (config.gas_model_sw,
                                   config.gas_model_lw)
            and config.gas_model_sw != config.gas_model_lw):
        raise NotImplementedError(
            "monochromatic gas optics cannot be mixed with other models")
    if config.use_spectral_solar_cycle \
            and config.gas_model_sw != GasModel.ECCKD:
        # radiation_config.F90:1201-1203
        raise ValueError(
            "solar cycle only available with ecCKD gas optics model")

    kw = {}
    gas_meta = {}
    gas_tables = {}
    specdef_sw = specdef_lw = None
    from ecrad_tpu.optics.spectral_def import SpectralDefinition

    if GasModel.RRTMG in (config.gas_model_sw, config.gas_model_lw):
        gas_tables["rrtmg"] = rrtmg.setup_tables()
    ddir0 = data_dir or config.directory_name
    from ecrad_tpu.data import find_data_file

    # --- shortwave band structure
    if config.gas_model_sw == GasModel.RRTMG:
        kw["n_g_sw"] = rrtmg_data.NG_SW
        kw["n_bands_sw"] = rrtmg_data.NBANDS_SW
        # RRTMG supports only band-wise cloud/aerosol/surface optics
        # (radiation_ifs_rrtm.F90:106-107,151-152)
        kw["do_cloud_aerosol_per_sw_g_point"] = False
        band_from_g_sw = gas_tables["rrtmg"]["sw_band_from_g"]
        wn1_sw, wn2_sw = rrtmg_data.SW_WAVENUM1, rrtmg_data.SW_WAVENUM2
        # band-bounds-only spectral definition
        # (radiation_ifs_rrtm.F90:111-115)
        specdef_sw = SpectralDefinition.bands_only(wn1_sw, wn2_sw,
                                                   is_solar=True)
    elif config.gas_model_sw == GasModel.ECCKD:
        sw_file = (config.gas_optics_sw_override_file_name
                   or "ecckd-1.4_sw_climate_rgb-32b_ckd-definition.nc")
        sw_file = find_data_file(ddir0, sw_file)
        t_sw, specdef_sw, meta_sw = ecckd_mod.load_ckd_model(sw_file)
        if config.use_spectral_solar_cycle:
            # radiation_config.F90:1200-1215 + radiation_ecckd.F90:295
            ssi_file = find_data_file(
                ddir0, config.ssi_override_file_name or "ssi_nrl2.nc")
            ecckd_mod.read_spectral_solar_cycle(
                t_sw, specdef_sw, ssi_file,
                use_updated_solar_spectrum=(
                    config.use_updated_solar_spectrum))
        gas_tables["sw"] = t_sw
        gas_meta["sw"] = meta_sw
        kw["n_g_sw"] = specdef_sw.ng
        if config.do_cloud_aerosol_per_sw_g_point:
            kw["n_bands_sw"] = specdef_sw.ng
            band_from_g_sw = np.arange(specdef_sw.ng)
        else:
            kw["n_bands_sw"] = specdef_sw.nband
            band_from_g_sw = specdef_sw.band_number
        wn1_sw, wn2_sw = (specdef_sw.wavenumber1_band,
                          specdef_sw.wavenumber2_band)
    elif config.gas_model_sw == GasModel.MONOCHROMATIC:
        # radiation_monochromatic.F90:20-40: one g-point, one band
        kw["n_g_sw"] = kw["n_bands_sw"] = 1
        kw["do_cloud_aerosol_per_sw_g_point"] = False
        band_from_g_sw = np.zeros(1, np.int32)
        wn1_sw = wn2_sw = None
    else:
        raise NotImplementedError(
            "only RRTMG, ecCKD and monochromatic gas optics are "
            "implemented")

    # --- longwave band structure
    if config.gas_model_lw == GasModel.RRTMG:
        kw["n_g_lw"] = rrtmg_data.NG_LW
        kw["n_bands_lw"] = rrtmg_data.NBANDS_LW
        kw["do_cloud_aerosol_per_lw_g_point"] = False
        band_from_g_lw = gas_tables["rrtmg"]["lw_band_from_g"]
        wn1_lw, wn2_lw = rrtmg_data.LW_WAVENUM1, rrtmg_data.LW_WAVENUM2
        specdef_lw = SpectralDefinition.bands_only(wn1_lw, wn2_lw,
                                                   is_solar=False)
    elif config.gas_model_lw == GasModel.ECCKD:
        lw_file = (config.gas_optics_lw_override_file_name
                   or "ecckd-1.0_lw_climate_fsck-32b_ckd-definition.nc")
        lw_file = find_data_file(ddir0, lw_file)
        t_lw, specdef_lw, meta_lw = ecckd_mod.load_ckd_model(lw_file)
        gas_tables["lw"] = t_lw
        gas_meta["lw"] = meta_lw
        kw["n_g_lw"] = specdef_lw.ng
        if config.do_cloud_aerosol_per_lw_g_point:
            kw["n_bands_lw"] = specdef_lw.ng
            band_from_g_lw = np.arange(specdef_lw.ng)
        else:
            kw["n_bands_lw"] = specdef_lw.nband
            band_from_g_lw = specdef_lw.band_number
        wn1_lw, wn2_lw = (specdef_lw.wavenumber1_band,
                          specdef_lw.wavenumber2_band)
    elif config.gas_model_lw == GasModel.MONOCHROMATIC:
        kw["n_g_lw"] = kw["n_bands_lw"] = 1
        kw["do_cloud_aerosol_per_lw_g_point"] = False
        band_from_g_lw = np.zeros(1, np.int32)
        wn1_lw = wn2_lw = None
    else:
        raise NotImplementedError(
            "only RRTMG, ecCKD and monochromatic gas optics are "
            "implemented")

    if config.gas_model_sw == GasModel.MONOCHROMATIC:
        gas_tables = None
        specdef_sw = specdef_lw = None

    # apply the band-structure consolidation now so downstream setup
    # (surface weights, cloud/aerosol tables) sees the forced flags
    config = config.replace(**kw)

    # --- surface albedo/emissivity interval consolidation
    # (radiation_config.F90:1947-2103).  Note do_weighted_surface_mapping
    # is parsed and printed but does NOT change the mapping: the
    # reference's v1.7.1 consolidate has byte-identical code in both
    # branches (radiation_config.F90:1985-1994, 2063-2072) and
    # calc_mapping_from_bands always Planck-weights, so the committed
    # golden outputs (CY49R1 sets the flag false) were produced with
    # weighted mapping.  The equal_weighting capability exists in
    # optics/spectral(_def).calc_mapping_from_bands for when upstream
    # wires it.
    i_sw_idx = [i for i in config.i_sw_albedo_index if i and i > 0]
    if not i_sw_idx:
        i_sw_idx = [1]
    sw_bounds = list(config.sw_albedo_wavelength_bound[:len(i_sw_idx) - 1])
    if specdef_sw is not None:
        sw_albedo_weights = specdef_sw.calc_mapping_from_bands(
            sw_bounds, i_sw_idx,
            use_bands=not config.do_cloud_aerosol_per_sw_g_point)
    elif wn1_sw is None:
        # monochromatic: all weight on the first albedo interval
        sw_albedo_weights = np.zeros((int(max(i_sw_idx)), 1))
        sw_albedo_weights[0, 0] = 1.0
    else:
        sw_albedo_weights = spectral.calc_mapping_from_bands(
            wn1_sw, wn2_sw, spectral.SOLAR_REFERENCE_TEMPERATURE,
            sw_bounds, i_sw_idx)
    kw["n_albedo_intervals"] = int(max(i_sw_idx))
    if config.use_canopy_full_spectrum_sw:
        kw["n_canopy_bands_sw"] = kw["n_g_sw"]
    else:
        kw["n_canopy_bands_sw"] = int(max(i_sw_idx))
    i_albedo_from_band_sw = None
    if config.do_nearest_spectral_sw_albedo:
        i_albedo_from_band_sw = np.argmax(sw_albedo_weights, axis=0)

    i_lw_idx = [i for i in config.i_lw_emiss_index if i and i > 0]
    if not i_lw_idx:
        i_lw_idx = [1]
    lw_bounds = list(config.lw_emiss_wavelength_bound[:len(i_lw_idx) - 1])
    if specdef_lw is not None:
        lw_emiss_weights = specdef_lw.calc_mapping_from_bands(
            lw_bounds, i_lw_idx,
            use_bands=not config.do_cloud_aerosol_per_lw_g_point)
    elif wn1_lw is None:
        lw_emiss_weights = np.zeros((int(max(i_lw_idx)), 1))
        lw_emiss_weights[0, 0] = 1.0
    else:
        lw_emiss_weights = spectral.calc_mapping_from_bands(
            wn1_lw, wn2_lw, spectral.TERRESTRIAL_REFERENCE_TEMPERATURE,
            lw_bounds, i_lw_idx)
    kw["n_emiss_intervals"] = int(max(i_lw_idx))
    if config.use_canopy_full_spectrum_lw:
        kw["n_canopy_bands_lw"] = kw["n_g_lw"]
    else:
        kw["n_canopy_bands_lw"] = int(max(i_lw_idx))
    i_emiss_from_band_lw = None
    if config.do_nearest_spectral_lw_emiss:
        i_emiss_from_band_lw = np.argmax(lw_emiss_weights, axis=0)

    kw["do_clouds"] = not (config.sw_solver == Solver.CLOUDLESS
                           and config.lw_solver == Solver.CLOUDLESS)
    # radiation_config.F90:1351-1356
    kw["is_homogeneous"] = (
        (config.do_sw and config.sw_solver == Solver.HOMOGENEOUS)
        or (config.do_lw and config.lw_solver == Solver.HOMOGENEOUS))
    kw["is_consolidated"] = True

    # --- cloud optics + McICA PDF LUT
    cloud_tables = None
    pdf_tables = None
    if kw["do_clouds"]:
        ddir = data_dir or config.directory_name
        if config.gas_model_sw == GasModel.MONOCHROMATIC:
            pass  # monochromatic cloud optics needs no tables
        elif config.use_general_cloud_optics:
            if specdef_sw is None:
                raise NotImplementedError(
                    "general cloud optics requires a spectral definition "
                    "(ecCKD gas optics)")
            cloud_tables = general_cloud_mod.setup_general_cloud_optics(
                config, ddir, specdef_sw, specdef_lw)
            kw["n_cloud_types"] = len(cloud_tables["type_names"])
        else:
            cloud_tables = cloud_optics_mod.setup_cloud_optics(config,
                                                               ddir)
        if Solver.MCICA in (config.sw_solver, config.lw_solver):
            import os as _os

            from ecrad_tpu.config import PdfShape
            from ecrad_tpu.io.netcdf import NcFile
            if config.cloud_pdf_override_file_name:
                pdf_file = config.cloud_pdf_override_file_name
            elif config.cloud_pdf_shape == PdfShape.GAMMA:
                pdf_file = "mcica_gamma.nc"
            else:
                pdf_file = "mcica_lognormal.nc"
            from ecrad_tpu.data import find_data_file
            with NcFile(find_data_file(ddir, pdf_file)) as f:
                pdf_tables = {"fsd": f.get("fsd"), "val": f.get("x").T}
            # Chebyshev fit of the inverse-CDF LUT for the on-device
            # generator (sampling without a gather)
            from ecrad_tpu.solvers.cloud_generator import fit_pdf_cheb
            pdf_tables["cheb_fit"] = fit_pdf_cheb(pdf_tables)

    aerosol_tables = None
    if config.use_aerosols and config.aerosol_type_name:
        # resolve name-based selection against the optics file's
        # metadata registry (radiation_aerosol_optics_description.F90)
        from ecrad_tpu.data import find_data_file
        from ecrad_tpu.optics.aerosol_description import \
            resolve_aerosol_type_names
        ddir = data_dir or config.directory_name
        if config.aerosol_optics_override_file_name:
            aer_path = find_data_file(
                ddir, config.aerosol_optics_override_file_name)
        elif config.use_general_aerosol_optics:
            aer_path = find_data_file(ddir, "aerosol_ifs_49R1_20230119.nc")
        else:
            aer_path = find_data_file(ddir,
                                      "aerosol_ifs_rrtm_46R1_with_NI_AM.nc")
        kw["i_aerosol_type_map"] = resolve_aerosol_type_names(
            config.aerosol_type_name, aer_path,
            config.aerosol_preferred_optical_model)
        kw["n_aerosol_types"] = len(kw["i_aerosol_type_map"])
        config = config.replace(
            i_aerosol_type_map=kw["i_aerosol_type_map"],
            n_aerosol_types=kw["n_aerosol_types"])
    if config.use_aerosols and config.n_aerosol_types > 0:
        ddir = data_dir or config.directory_name
        aerosol_tables = aerosol_mod.setup_aerosol_optics(
            config, ddir, wn1_sw, wn2_sw, wn1_lw, wn2_lw,
            specdef_sw=specdef_sw, specdef_lw=specdef_lw)

    new_config = config.replace(**kw)
    tables = Tables(
        gas_meta=gas_meta,
        cloud=cloud_tables,
        pdf_sampler=pdf_tables,
        aerosol=aerosol_tables,
        gas=gas_tables,
        sw_albedo_weights=sw_albedo_weights,
        lw_emiss_weights=lw_emiss_weights,
        i_albedo_from_band_sw=i_albedo_from_band_sw,
        i_emiss_from_band_lw=i_emiss_from_band_lw,
        band_from_g_sw=band_from_g_sw,
        band_from_g_lw=band_from_g_lw,
        specdef_sw=specdef_sw,
        specdef_lw=specdef_lw,
    )
    return new_config, tables


# ---------------------------------------------------------------------------

def get_albedos(config: Config, tables: Tables, sw_albedo,
                sw_albedo_direct, lw_emissivity):
    """Surface albedo/emissivity intervals → per-g-point values
    (radiation_single_level.F90:216-372)."""
    band_g_sw = jnp.asarray(tables.band_from_g_sw)
    band_g_lw = jnp.asarray(tables.band_from_g_lw)

    if config.do_nearest_spectral_sw_albedo:
        idx = jnp.asarray(tables.i_albedo_from_band_sw)[band_g_sw]
        sw_albedo_diffuse_g = sw_albedo[:, idx]
        sw_albedo_direct_g = (sw_albedo_direct[:, idx]
                              if sw_albedo_direct is not None
                              else sw_albedo_diffuse_g)
    else:
        w = jnp.asarray(tables.sw_albedo_weights)       # (nalb, nband)
        alb_band = _mm(sw_albedo, w)                    # (ncol, nband)
        sw_albedo_diffuse_g = alb_band[:, band_g_sw]
        if sw_albedo_direct is not None:
            sw_albedo_direct_g = _mm(sw_albedo_direct, w)[:, band_g_sw]
        else:
            sw_albedo_direct_g = sw_albedo_diffuse_g

    if config.do_nearest_spectral_lw_emiss:
        idx = jnp.asarray(tables.i_emiss_from_band_lw)[band_g_lw]
        lw_albedo_g = 1.0 - lw_emissivity[:, idx]
    else:
        w = jnp.asarray(tables.lw_emiss_weights)
        lw_albedo_g = _mm(1.0 - lw_emissivity, w)[:, band_g_lw]

    return sw_albedo_direct_g, sw_albedo_diffuse_g, lw_albedo_g


def _spartacus_perm(config: Config, is_sw: bool) -> np.ndarray:
    """G-point permutation for SPARTACUS: RRTMG g-points are reordered by
    approximately increasing optical depth (radiation_ifs_rrtm.F90:117-134);
    other gas models use natural order."""
    gm = config.gas_model_sw if is_sw else config.gas_model_lw
    ng = config.n_g_sw if is_sw else config.n_g_lw
    if gm == GasModel.RRTMG:
        return (rrtmg_data.RRTM_GPOINT_REORDERING_SW if is_sw
                else rrtmg_data.RRTM_GPOINT_REORDERING_LW)
    return np.arange(ng, dtype=np.int32)


def _unpermute_g_fields(out, perm: np.ndarray):
    """Restore natural g order in a solver output's *_g fields so the
    generic band/canopy post-processing applies unchanged."""
    inv = np.argsort(perm)
    rep = {}
    for f in out._fields:
        v = getattr(out, f)
        if v is not None and f.endswith("_g"):
            rep[f] = jnp.take(v, jnp.asarray(inv), axis=-1)
    return out._replace(**rep)


def indexed_sum_g(x_g, band_from_g, nbands: int):
    """Sum g-point array into bands along the last axis
    (radiation_flux.F90 indexed_sum). band_from_g 0-based."""
    band_from_g = jnp.asarray(band_from_g)
    onehot = (band_from_g[:, None]
              == jnp.arange(nbands)[None, :]).astype(x_g.dtype)
    return _mm(x_g, onehot)


def use_kernel_layout(config: Config, tables: Tables, cloud) -> bool:
    """True when the hot path should run end to end in the fused-solver
    kernel layout (nlev, ng, ncol): RRTMG gas optics, the cloud
    generator and the fused McICA sweeps then produce and consume the
    big (ncol*nlev*ng) fields in that layout, with no relayout copy
    between stages.

    Restricted to where the backend chooses the fused sweeps
    (``backend.choices().layout``) and to the configurations they cover:
    RRTMG gas models, McICA/homogeneous solvers, no per-g spectral
    profile outputs; everything else uses the classic (ncol, nlev, ng)
    layout."""
    if backend.choices().layout != "knl":
        return False
    if cloud is None or not config.do_clouds:
        return False
    if config.do_save_gpoint_flux or config.do_save_spectral_flux:
        return False
    # a pre-supplied stochastic sample (host bit-exact generator, or a
    # user of the ifs scheme API) arrives in classic layout — detect by
    # shape and stay classic.  (Degenerate ambiguity requires
    # ncol == nlev == ng.)
    if isinstance(cloud, dict):
        frac_shape = tuple(cloud["fraction"].shape)
        for k in ("od_scaling_sw", "od_scaling_lw"):
            if k in cloud and tuple(cloud[k].shape[:2]) == frac_shape:
                return False
    ok = (Solver.MCICA, Solver.HOMOGENEOUS)
    if config.do_lw:
        if (config.gas_model_lw != GasModel.RRTMG
                or config.lw_solver not in ok
                or not config.do_lw_cloud_scattering
                or config.do_lw_aerosol_scattering):
            return False
    if config.do_sw:
        if (config.gas_model_sw != GasModel.RRTMG
                or config.sw_solver not in ok):
            return False
    return True


def _optical_properties(config: Config, tables: Tables, *,
                        pressure_hl, temperature_hl, gas_mmr,
                        cos_sza, skin_temperature, sw_albedo,
                        sw_albedo_direct, lw_emissivity,
                        solar_irradiance, cloud=None, aerosol=None,
                        spectral_solar_scaling=None,
                        spectral_solar_cycle_multiplier=0.0,
                        layout="cln"):
    """Surface + gas + aerosol + cloud optical properties — the front
    half of radiation() (radiation_interface.F90:200-383), shared with
    compute_radiative_properties for the debug dump.

    layout="knl" (see use_kernel_layout) emits the per-g profile fields
    in kernel layout; the per-band cloud optics stay (ncol, nlev,
    nband) in both layouts (relaid cheaply inside the solver wrapper)."""
    sw_albedo_direct_g, sw_albedo_diffuse_g, lw_albedo_g = get_albedos(
        config, tables, sw_albedo, sw_albedo_direct, lw_emissivity)

    gdict = {name: gas_mmr[:, :, constants.GAS_INDEX[name]]
             for name in ("h2o", "co2", "ch4", "n2o", "cfc11", "cfc12",
                          "hcfc22", "ccl4", "o3")}

    if config.gas_model_sw == GasModel.MONOCHROMATIC:
        mono_out = mono_mod.gas_optics(
            config, pressure_hl, temperature_hl, skin_temperature,
            solar_irradiance)
        go = rrtmg.RRTMGGasOptics(
            od_lw=mono_out["od_lw"] if config.do_lw else None,
            planck_hl=mono_out["planck_hl"] if config.do_lw else None,
            lw_emission=mono_out["lw_emission"] if config.do_lw else None,
            od_sw=mono_out["od_sw"] if config.do_sw else None,
            ssa_sw=mono_out["ssa_sw"] if config.do_sw else None,
            incoming_sw=(mono_out["incoming_sw"]
                         if config.do_sw else None))
    else:
        # RRTMG and/or ecCKD, possibly mixed per band
        # (radiation_interface.F90 gas_optics dispatch)
        go_kw = {}
        do_lw_rrtmg = (config.do_lw
                       and config.gas_model_lw == GasModel.RRTMG)
        do_sw_rrtmg = (config.do_sw
                       and config.gas_model_sw == GasModel.RRTMG)
        if do_lw_rrtmg or do_sw_rrtmg:
            r = rrtmg.gas_optics(
                tables.gas["rrtmg"], pressure_hl, temperature_hl, gdict,
                cos_sza=cos_sza, do_lw=do_lw_rrtmg, do_sw=do_sw_rrtmg,
                skin_temperature=skin_temperature,
                solar_irradiance=solar_irradiance,
                min_gas_od_lw=config.min_gas_od_lw,
                min_gas_od_sw=config.min_gas_od_sw,
                spectral_solar_scaling=(
                    spectral_solar_scaling
                    if config.use_spectral_solar_scaling else None),
                layout=layout)
            if do_lw_rrtmg:
                go_kw.update(od_lw=r.od_lw, planck_hl=r.planck_hl,
                             lw_emission=r.lw_emission)
            if do_sw_rrtmg:
                go_kw.update(od_sw=r.od_sw, ssa_sw=r.ssa_sw,
                             incoming_sw=r.incoming_sw)
        if GasModel.ECCKD in (config.gas_model_sw, config.gas_model_lw):
            # ecCKD backend (radiation_ecckd_interface.F90:174-340):
            # pressure-weighted full-level temperature, gases in VMR
            phl = pressure_hl
            thl = temperature_hl
            t_fl = ((thl[:, :-1] * phl[:, :-1] + thl[:, 1:] * phl[:, 1:])
                    / (phl[:, :-1] + phl[:, 1:]))
            gas_vmr = {name: mmr * (constants.MOLAR_MASS_DRY_AIR
                                    / constants.MOLAR_MASS[name])
                       for name, mmr in gdict.items()}
            # share the bilinear one-hot between the SW and LW models
            # when their LUT grids coincide (they do for the standard
            # ecCKD files) — halves the W4 construction cost
            pt_w = pt_w_lw = None
            both = (config.do_sw and config.do_lw
                    and config.gas_model_sw == GasModel.ECCKD
                    and config.gas_model_lw == GasModel.ECCKD)
            if both and (ecckd_mod.grid_signature(
                    tables.gas["sw"], tables.gas_meta["sw"])
                    == ecckd_mod.grid_signature(
                        tables.gas["lw"], tables.gas_meta["lw"])):
                pt_w = pt_w_lw = ecckd_mod.pt_onehot(
                    tables.gas["sw"], tables.gas_meta["sw"], phl, t_fl)
            if config.do_sw and config.gas_model_sw == GasModel.ECCKD:
                od_sw_g, ray = ecckd_mod.calc_optical_depth(
                    tables.gas["sw"], tables.gas_meta["sw"], phl, t_fl,
                    gas_vmr, pt_w=pt_w)
                od_sw_tot = od_sw_g + ray
                go_kw["od_sw"] = od_sw_tot
                go_kw["ssa_sw"] = ray / od_sw_tot
                inc = ecckd_mod.calc_incoming_sw(
                    tables.gas["sw"], tables.gas_meta["sw"],
                    solar_irradiance, phl.shape[0],
                    solar_cycle_multiplier=(
                        spectral_solar_cycle_multiplier
                        if config.use_spectral_solar_cycle else 0.0))
                go_kw["incoming_sw"] = jnp.where(
                    (cos_sza > 0.0)[:, None], inc, 0.0)
            if config.do_lw and config.gas_model_lw == GasModel.ECCKD:
                od_lw_g, _ = ecckd_mod.calc_optical_depth(
                    tables.gas["lw"], tables.gas_meta["lw"], phl, t_fl,
                    gas_vmr, pt_w=pt_w_lw)
                go_kw["od_lw"] = jnp.maximum(od_lw_g,
                                             config.min_gas_od_lw)
                go_kw["planck_hl"] = ecckd_mod.calc_planck(
                    tables.gas["lw"], tables.gas_meta["lw"], thl)
                go_kw["lw_emission"] = ecckd_mod.calc_planck(
                    tables.gas["lw"], tables.gas_meta["lw"],
                    skin_temperature)
        go = rrtmg.RRTMGGasOptics(**go_kw)

    # --- gas + aerosol optical properties
    od_lw, planck_hl = go.od_lw, go.planck_hl
    od_sw, ssa_sw = go.od_sw, go.ssa_sw
    if config.do_lw:
        ssa_lw = jnp.zeros_like(od_lw)
        g_lw_arr = jnp.zeros_like(od_lw)
    if config.do_sw:
        g_sw_arr = jnp.zeros_like(od_sw)

    if config.use_aerosols and aerosol is not None \
            and "od_sw" in aerosol:
        # direct aerosol optical properties per band
        # (radiation_aerosol.F90:44-56 allocate_direct +
        # radiation_aerosol_optics.F90:832-1021
        # add_aerosol_optics_direct): the user supplies band-wise
        # od/ssa/g profiles (ncol, nlev, n_bands_sw|lw) instead of
        # mixing ratios; express them as extensive (od, scat, scat*g)
        # and reuse the same per-g merge
        zero_sw = jnp.zeros_like(aerosol["od_sw"])
        scat_sw = aerosol["od_sw"] * aerosol.get("ssa_sw", zero_sw)
        aer = {
            "od_sw": aerosol["od_sw"],
            "scat_sw": scat_sw,
            "scatg_sw": scat_sw * aerosol.get("g_sw", zero_sw),
        }
        if config.do_lw and "od_lw" in aerosol:
            zero_lw = jnp.zeros_like(aerosol["od_lw"])
            scat_lw = aerosol["od_lw"] * aerosol.get("ssa_lw", zero_lw)
            aer.update(
                od_lw=aerosol["od_lw"], scat_lw=scat_lw,
                scatg_lw=scat_lw * aerosol.get("g_lw", zero_lw))
        else:
            nblw = getattr(config, "n_bands_lw", 0) or 1
            zlw = jnp.zeros(aerosol["od_sw"].shape[:-1] + (nblw,),
                            aerosol["od_sw"].dtype) \
                if config.do_lw else None
            if zlw is not None:
                aer.update(od_lw=zlw, scat_lw=zlw, scatg_lw=zlw)
        if layout == "knl":
            aer = {k: jnp.transpose(v, (1, 2, 0)) for k, v in aer.items()}
        od_sw, ssa_sw, g_sw_arr, od_lw, ssa_lw, g_lw_arr = \
            aerosol_mod.add_aerosol_optics(
                config, aer, tables.band_from_g_sw, tables.band_from_g_lw,
                od_sw, ssa_sw, g_sw_arr, od_lw, ssa_lw, g_lw_arr,
                layout=layout)
    elif config.use_aerosols and aerosol is not None \
            and tables.aerosol is not None \
            and config.gas_model_sw != GasModel.MONOCHROMATIC:
        # RH-dependent aerosol merge (radiation_aerosol_optics.F90:487+)
        p_fl = 0.5 * (pressure_hl[:, :-1] + pressure_hl[:, 1:])
        t_fl = 0.5 * (temperature_hl[:, :-1] + temperature_hl[:, 1:])
        h2o_mmr = gas_mmr[:, :, constants.GAS_INDEX["h2o"]]
        rh = h2o_mmr / aerosol_mod.h2o_sat_liq(p_fl, t_fl)
        aer = aerosol_mod.aerosol_band_properties(
            config, tables.aerosol, pressure_hl,
            aerosol["mixing_ratio"], rh)
        if layout == "knl":
            # relay the small (ncol, nlev, nband) band profiles once
            aer = {k: jnp.transpose(v, (1, 2, 0)) for k, v in aer.items()}
        od_sw, ssa_sw, g_sw_arr, od_lw, ssa_lw, g_lw_arr = \
            aerosol_mod.add_aerosol_optics(
                config, aer, tables.band_from_g_sw, tables.band_from_g_lw,
                od_sw, ssa_sw, g_sw_arr, od_lw, ssa_lw, g_lw_arr,
                layout=layout)

    # --- cloud optics (radiation_interface.F90:357-383)
    do_clouds = config.do_clouds and cloud is not None
    if do_clouds:
        # crop_cloud_fraction (radiation_cloud.F90)
        total_water = cloud["q_liq"] + cloud["q_ice"]
        keep = ((cloud["fraction"] >= config.cloud_fraction_threshold)
                & (total_water >= config.cloud_mixing_ratio_threshold))
        frac = jnp.where(keep, cloud["fraction"], 0.0)
        if config.gas_model_sw == GasModel.MONOCHROMATIC:
            cl = mono_mod.cloud_optics(
                config, pressure_hl, frac, cloud["q_liq"], cloud["q_ice"],
                cloud["re_liq"], cloud["re_ice"])
        elif config.use_general_cloud_optics:
            mixing_ratio = jnp.stack([cloud["q_liq"], cloud["q_ice"]],
                                     axis=-1)
            reff = jnp.stack([cloud["re_liq"], cloud["re_ice"]], axis=-1)
            cl = general_cloud_mod.general_cloud_optics(
                config, tables.cloud, pressure_hl, frac, mixing_ratio,
                reff)
        else:
            cl = cloud_optics_mod.cloud_optics(
                config, tables.cloud, pressure_hl, temperature_hl,
                frac, cloud["q_liq"], cloud["q_ice"],
                cloud["re_liq"], cloud["re_ice"])

    return dict(
        sw_albedo_direct_g=sw_albedo_direct_g,
        sw_albedo_diffuse_g=sw_albedo_diffuse_g,
        lw_albedo_g=lw_albedo_g, go=go,
        od_lw=od_lw if config.do_lw else None,
        ssa_lw=ssa_lw if config.do_lw else None,
        g_lw_arr=g_lw_arr if config.do_lw else None,
        od_sw=od_sw if config.do_sw else None,
        ssa_sw=ssa_sw if config.do_sw else None,
        g_sw_arr=g_sw_arr if config.do_sw else None,
        do_clouds=do_clouds, frac=frac if do_clouds else None,
        cl=cl if do_clouds else None)


def radiation(config: Config, tables: Tables, *,
              pressure_hl, temperature_hl, gas_mmr,
              cos_sza, skin_temperature, sw_albedo, sw_albedo_direct,
              lw_emissivity, solar_irradiance,
              cloud=None, aerosol=None, iseed=None,
              spectral_solar_scaling=None,
              spectral_solar_cycle_multiplier=0.0) -> Flux:
    """The hot path (radiation_interface.F90:200-517). Jit with
    config static; all array args are traced.

    gas_mmr: (ncol, nlev, NUM_GASES) mass mixing ratios in
    constants.GAS_NAMES order.
    """
    from ecrad_tpu import profiling
    layout = "knl" if use_kernel_layout(config, tables, cloud) else "cln"
    with profiling.scope("radiation_interface:optical_properties"):
        op = _optical_properties(
            config, tables, pressure_hl=pressure_hl,
            temperature_hl=temperature_hl, gas_mmr=gas_mmr,
            cos_sza=cos_sza, skin_temperature=skin_temperature,
            sw_albedo=sw_albedo, sw_albedo_direct=sw_albedo_direct,
            lw_emissivity=lw_emissivity,
            solar_irradiance=solar_irradiance, cloud=cloud,
            aerosol=aerosol,
            spectral_solar_scaling=spectral_solar_scaling,
            spectral_solar_cycle_multiplier=(
                spectral_solar_cycle_multiplier),
            layout=layout)
    sw_albedo_direct_g = op["sw_albedo_direct_g"]
    sw_albedo_diffuse_g = op["sw_albedo_diffuse_g"]
    lw_albedo_g = op["lw_albedo_g"]
    go = op["go"]
    od_lw, ssa_lw, g_lw_arr = op["od_lw"], op["ssa_lw"], op["g_lw_arr"]
    od_sw, ssa_sw, g_sw_arr = op["od_sw"], op["ssa_sw"], op["g_sw_arr"]
    do_clouds, frac, cl = op["do_clouds"], op["frac"], op["cl"]
    planck_hl = go.planck_hl

    flux_kw = {}

    # spectral-flux projection matrices (ng, nspec): identity for g-point
    # output, one-hot band map for band output, else None — the vertical
    # scans project fluxes through these instead of materializing
    # (ncol, nlev+1, ng) profiles (see solvers/outputs.py)
    def _spec(band_from_g, ng, nbands):
        if config.do_save_gpoint_flux:
            return np.eye(ng, dtype=np.float64)
        if config.do_save_spectral_flux:
            return (np.asarray(band_from_g)[:, None]
                    == np.arange(nbands)[None, :]).astype(np.float64)
        return None

    spec_lw_m = (_spec(tables.band_from_g_lw, config.n_g_lw,
                       config.n_bands_lw) if config.do_lw else None)
    spec_sw_m = (_spec(tables.band_from_g_sw, config.n_g_sw,
                       config.n_bands_sw) if config.do_sw else None)
    dt = pressure_hl.dtype
    if spec_lw_m is not None:
        spec_lw_m = jnp.asarray(spec_lw_m, dt)
    if spec_sw_m is not None:
        spec_sw_m = jnp.asarray(spec_sw_m, dt)

    if config.do_lw:
        lw_emission = go.lw_emission * (1.0 - lw_albedo_g)

        if config.lw_solver == Solver.CLOUDLESS or not do_clouds:
            lw = cloudless.solver_cloudless_lw(
                od_lw, ssa_lw, g_lw_arr, planck_hl, lw_emission,
                lw_albedo_g,
                do_lw_aerosol_scattering=config.do_lw_aerosol_scattering,
                do_lw_derivatives=config.do_lw_derivatives,
                spec_matrix=spec_lw_m)
        elif config.lw_solver == Solver.MCICA:
            lw = mcica.solver_mcica_lw(
                od_lw, ssa_lw, g_lw_arr,
                cl["od_lw"], cl["ssa_lw"], cl["g_lw"],
                tables.band_from_g_lw,
                cloud["od_scaling_lw"], cloud["total_cloud_cover_lw"],
                frac, planck_hl, lw_emission, lw_albedo_g,
                cloud_fraction_threshold=config.cloud_fraction_threshold,
                do_lw_cloud_scattering=config.do_lw_cloud_scattering,
                do_lw_aerosol_scattering=config.do_lw_aerosol_scattering,
                do_lw_derivatives=config.do_lw_derivatives,
                spec_matrix=spec_lw_m, layout=layout)
        elif config.lw_solver == Solver.HOMOGENEOUS:
            # plane-parallel clouds fill the gridbox
            # (radiation_homogeneous_lw.F90): equivalent to McICA with
            # od_scaling == 1 and cloud cover 1 for any cloudy profile
            ones = jnp.ones(od_lw.shape, od_lw.dtype)
            any_cloud = jnp.any(
                frac >= config.cloud_fraction_threshold,
                axis=1).astype(od_lw.dtype)
            lw = mcica.solver_mcica_lw(
                od_lw, ssa_lw, g_lw_arr,
                cl["od_lw"], cl["ssa_lw"], cl["g_lw"],
                tables.band_from_g_lw, ones, any_cloud,
                frac, planck_hl, lw_emission, lw_albedo_g,
                cloud_fraction_threshold=config.cloud_fraction_threshold,
                do_lw_cloud_scattering=config.do_lw_cloud_scattering,
                do_lw_aerosol_scattering=config.do_lw_aerosol_scattering,
                do_lw_derivatives=config.do_lw_derivatives,
                spec_matrix=spec_lw_m, layout=layout)
            lw = lw._replace(
                cloud_cover=jnp.full_like(any_cloud, -1.0))
        elif config.lw_solver == Solver.TRIPLECLOUDS:
            lw = tripleclouds.solver_tripleclouds_lw(
                config, od_lw, ssa_lw, g_lw_arr,
                cl["od_lw"], cl["ssa_lw"], cl["g_lw"],
                tables.band_from_g_lw, frac, cloud["fractional_std"],
                cloud["overlap_param"], planck_hl, lw_emission,
                lw_albedo_g, spec_matrix=spec_lw_m)
        elif config.lw_solver == Solver.SPARTACUS:
            perm = _spartacus_perm(config, is_sw=False)
            pj = jnp.asarray(perm)
            take = lambda a: jnp.take(a, pj, axis=-1)
            lw = spartacus.solver_spartacus_lw(
                config, take(od_lw), take(ssa_lw), take(g_lw_arr),
                cl["od_lw"], cl["ssa_lw"], cl["g_lw"],
                np.asarray(tables.band_from_g_lw)[perm],
                frac, cloud["fractional_std"], cloud["overlap_param"],
                cloud["inv_cloud_effective_size"],
                cloud.get("inv_inhom_effective_size"),
                pressure_hl, temperature_hl,
                take(planck_hl), take(lw_emission), take(lw_albedo_g),
                spec_matrix=(None if spec_lw_m is None
                             else spec_lw_m[pj]))
            lw = _unpermute_g_fields(lw, perm)
        else:
            raise NotImplementedError(
                f"LW solver {config.lw_solver} not yet implemented")

        flux_kw.update(
            lw_up=lw.flux_up, lw_dn=lw.flux_dn,
            lw_up_clear=lw.flux_up_clear,
            lw_dn_clear=lw.flux_dn_clear,
            cloud_cover_lw=lw.cloud_cover)
        if config.do_lw_derivatives:
            flux_kw["lw_derivatives"] = lw.lw_derivatives
        if spec_lw_m is not None:
            # do_save_gpoint_flux makes the spectral axis the g-points
            # (radiation_config.F90 consolidate: i_spec_from_reordered_g)
            flux_kw["lw_up_band"] = lw.flux_up_s
            flux_kw["lw_dn_band"] = lw.flux_dn_s
            flux_kw["lw_up_clear_band"] = lw.flux_up_clear_s
            flux_kw["lw_dn_clear_band"] = lw.flux_dn_clear_s
        if config.do_toa_spectral_flux:
            # radiation_flux.F90:579-660 calc_toa_spectral
            flux_kw["lw_up_toa_band"] = indexed_sum_g(
                lw.lw_up_toa_g, tables.band_from_g_lw, config.n_bands_lw)
            flux_kw["lw_up_toa_clear_band"] = indexed_sum_g(
                lw.lw_up_toa_clear_g, tables.band_from_g_lw,
                config.n_bands_lw)
        if config.do_canopy_fluxes_lw:
            lw_dn_surf_g = lw.lw_dn_surf_g
            if config.use_canopy_full_spectrum_lw:
                flux_kw["lw_dn_surf_canopy"] = lw_dn_surf_g
            elif config.do_nearest_spectral_lw_emiss:
                idx = jnp.asarray(tables.i_emiss_from_band_lw)[
                    jnp.asarray(tables.band_from_g_lw)]
                flux_kw["lw_dn_surf_canopy"] = indexed_sum_g(
                    lw_dn_surf_g, idx, config.n_canopy_bands_lw)
            else:
                lw_dn_band = indexed_sum_g(
                    lw_dn_surf_g, tables.band_from_g_lw,
                    config.n_bands_lw)
                w = jnp.asarray(tables.lw_emiss_weights)
                flux_kw["lw_dn_surf_canopy"] = _mm(lw_dn_band, w.T)

    if config.do_sw:
        if config.sw_solver == Solver.CLOUDLESS or not do_clouds:
            sw = cloudless.solver_cloudless_sw(
                od_sw, ssa_sw, g_sw_arr,
                go.incoming_sw, cos_sza,
                sw_albedo_diffuse_g, sw_albedo_direct_g,
                do_sw_delta_scaling_with_gases=(
                    config.do_sw_delta_scaling_with_gases),
                spec_matrix=spec_sw_m)
        elif config.sw_solver == Solver.HOMOGENEOUS:
            ones = jnp.ones(od_sw.shape, od_sw.dtype)
            any_cloud = jnp.any(
                frac >= config.cloud_fraction_threshold,
                axis=1).astype(od_sw.dtype)
            sw = mcica.solver_mcica_sw(
                od_sw, ssa_sw, g_sw_arr,
                cl["od_sw"], cl["ssa_sw"], cl["g_sw"],
                tables.band_from_g_sw, ones, any_cloud,
                frac, go.incoming_sw, cos_sza,
                sw_albedo_diffuse_g, sw_albedo_direct_g,
                cloud_fraction_threshold=config.cloud_fraction_threshold,
                do_sw_delta_scaling_with_gases=(
                    config.do_sw_delta_scaling_with_gases),
                spec_matrix=spec_sw_m, layout=layout)
            sw = sw._replace(cloud_cover=jnp.full_like(any_cloud, -1.0))
        elif config.sw_solver == Solver.TRIPLECLOUDS:
            sw = tripleclouds.solver_tripleclouds_sw(
                config, od_sw, ssa_sw, g_sw_arr,
                cl["od_sw"], cl["ssa_sw"], cl["g_sw"],
                tables.band_from_g_sw, frac, cloud["fractional_std"],
                cloud["overlap_param"], go.incoming_sw, cos_sza,
                sw_albedo_diffuse_g, sw_albedo_direct_g,
                spec_matrix=spec_sw_m)
        elif config.sw_solver == Solver.SPARTACUS:
            perm = _spartacus_perm(config, is_sw=True)
            pj = jnp.asarray(perm)
            take = lambda a: jnp.take(a, pj, axis=-1)
            sw = spartacus.solver_spartacus_sw(
                config, take(od_sw), take(ssa_sw), take(g_sw_arr),
                cl["od_sw"], cl["ssa_sw"], cl["g_sw"],
                np.asarray(tables.band_from_g_sw)[perm],
                frac, cloud["fractional_std"], cloud["overlap_param"],
                cloud["inv_cloud_effective_size"],
                cloud.get("inv_inhom_effective_size"),
                pressure_hl, temperature_hl,
                take(go.incoming_sw), cos_sza,
                take(sw_albedo_diffuse_g), take(sw_albedo_direct_g),
                spec_matrix=(None if spec_sw_m is None
                             else spec_sw_m[pj]))
            sw = _unpermute_g_fields(sw, perm)
        elif config.sw_solver == Solver.MCICA:
            sw = mcica.solver_mcica_sw(
                od_sw, ssa_sw, g_sw_arr,
                cl["od_sw"], cl["ssa_sw"], cl["g_sw"],
                tables.band_from_g_sw,
                cloud["od_scaling_sw"], cloud["total_cloud_cover_sw"],
                frac, go.incoming_sw, cos_sza,
                sw_albedo_diffuse_g, sw_albedo_direct_g,
                cloud_fraction_threshold=config.cloud_fraction_threshold,
                do_sw_delta_scaling_with_gases=(
                    config.do_sw_delta_scaling_with_gases),
                spec_matrix=spec_sw_m, layout=layout)
        else:
            raise NotImplementedError(
                f"SW solver {config.sw_solver} not yet implemented")

        sw_dn_diffuse_surf_g = sw.sw_dn_diffuse_surf_g
        sw_dn_direct_surf_g = sw.sw_dn_direct_surf_g

        flux_kw.update(
            sw_up=sw.flux_up, sw_dn=sw.flux_dn,
            sw_dn_direct=sw.flux_dn_direct,
            sw_up_clear=sw.flux_up_clear, sw_dn_clear=sw.flux_dn_clear,
            sw_dn_direct_clear=sw.flux_dn_direct_clear,
            cloud_cover_sw=sw.cloud_cover)

        if config.do_surface_sw_spectral_flux:
            dir_band = indexed_sum_g(sw_dn_direct_surf_g,
                                     tables.band_from_g_sw,
                                     config.n_bands_sw)
            diff_band = indexed_sum_g(sw_dn_diffuse_surf_g,
                                      tables.band_from_g_sw,
                                      config.n_bands_sw)
            flux_kw["sw_dn_direct_surf_band"] = dir_band
            flux_kw["sw_dn_surf_band"] = dir_band + diff_band
            dir_clear_band = indexed_sum_g(sw.sw_dn_direct_surf_clear_g,
                                           tables.band_from_g_sw,
                                           config.n_bands_sw)
            diff_clear_band = indexed_sum_g(sw.sw_dn_diffuse_surf_clear_g,
                                            tables.band_from_g_sw,
                                            config.n_bands_sw)
            flux_kw["sw_dn_surf_clear_band"] = (dir_clear_band
                                               + diff_clear_band)
            flux_kw["sw_dn_direct_surf_clear_band"] = dir_clear_band
        if spec_sw_m is not None:
            flux_kw["sw_up_band"] = sw.flux_up_s
            flux_kw["sw_dn_band"] = sw.flux_dn_s
            flux_kw["sw_dn_direct_band"] = sw.flux_dn_direct_s
            flux_kw["sw_up_clear_band"] = sw.flux_up_clear_s
            flux_kw["sw_dn_clear_band"] = sw.flux_dn_clear_s
            flux_kw["sw_dn_direct_clear_band"] = sw.flux_dn_direct_clear_s
        if config.do_toa_spectral_flux:
            # at TOA the downward flux is the direct beam only
            sw_dn_toa_g = jnp.where((cos_sza > 0.0)[:, None],
                                    go.incoming_sw
                                    * jnp.maximum(cos_sza, 0.0)[:, None],
                                    0.0)
            flux_kw["sw_dn_toa_band"] = indexed_sum_g(
                sw_dn_toa_g, tables.band_from_g_sw, config.n_bands_sw)
            flux_kw["sw_up_toa_band"] = indexed_sum_g(
                sw.sw_up_toa_g, tables.band_from_g_sw, config.n_bands_sw)
            flux_kw["sw_up_toa_clear_band"] = indexed_sum_g(
                sw.sw_up_toa_clear_g, tables.band_from_g_sw,
                config.n_bands_sw)
        if config.do_canopy_fluxes_sw:
            if config.use_canopy_full_spectrum_sw:
                flux_kw["sw_dn_diffuse_surf_canopy"] = sw_dn_diffuse_surf_g
                flux_kw["sw_dn_direct_surf_canopy"] = sw_dn_direct_surf_g
            elif config.do_nearest_spectral_sw_albedo:
                idx = jnp.asarray(tables.i_albedo_from_band_sw)[
                    jnp.asarray(tables.band_from_g_sw)]
                flux_kw["sw_dn_diffuse_surf_canopy"] = indexed_sum_g(
                    sw_dn_diffuse_surf_g, idx, config.n_canopy_bands_sw)
                flux_kw["sw_dn_direct_surf_canopy"] = indexed_sum_g(
                    sw_dn_direct_surf_g, idx, config.n_canopy_bands_sw)
            else:
                # weights-based canopy mapping (radiation_flux.F90:498-518)
                dir_band = indexed_sum_g(sw_dn_direct_surf_g,
                                         tables.band_from_g_sw,
                                         config.n_bands_sw)
                tot_band = dir_band + indexed_sum_g(
                    sw_dn_diffuse_surf_g, tables.band_from_g_sw,
                    config.n_bands_sw)
                w = jnp.asarray(tables.sw_albedo_weights)  # (nalb, nband)
                canopy_dir = _mm(dir_band, w.T)
                canopy_tot = _mm(tot_band, w.T)
                flux_kw["sw_dn_direct_surf_canopy"] = canopy_dir
                flux_kw["sw_dn_diffuse_surf_canopy"] = (canopy_tot
                                                       - canopy_dir)

    return Flux(**flux_kw)


def compute_radiative_properties(config: Config, tables: Tables, **kw):
    """Debug dump of the per-g/band optical properties
    (radiation_save.F90:716-1025 save_radiative_properties contract).
    Same keyword inputs as radiation(); returns a dict of arrays."""
    kw.pop("iseed", None)
    op = _optical_properties(config, tables, **kw)
    go = op["go"]
    out = {}
    if config.do_sw:
        out["od_sw"] = op["od_sw"]
        out["ssa_sw"] = op["ssa_sw"]
        out["asymmetry_sw"] = op["g_sw_arr"]
        out["incoming_sw"] = go.incoming_sw
        out["sw_albedo"] = op["sw_albedo_diffuse_g"]
        out["sw_albedo_direct"] = op["sw_albedo_direct_g"]
    if config.do_lw:
        out["od_lw"] = op["od_lw"]
        out["ssa_lw"] = op["ssa_lw"]
        out["asymmetry_lw"] = op["g_lw_arr"]
        out["planck_hl"] = go.planck_hl
        out["lw_emission"] = go.lw_emission * (1.0 - op["lw_albedo_g"])
        out["lw_emissivity"] = 1.0 - op["lw_albedo_g"]
    if op["do_clouds"]:
        cl = op["cl"]
        out["cloud_fraction"] = op["frac"]
        if config.do_sw:
            out["od_sw_cloud"] = cl["od_sw"]
            out["ssa_sw_cloud"] = cl["ssa_sw"]
            out["asymmetry_sw_cloud"] = cl["g_sw"]
        if config.do_lw:
            out["od_lw_cloud"] = cl["od_lw"]
            out["ssa_lw_cloud"] = cl["ssa_lw"]
            out["asymmetry_lw_cloud"] = cl["g_lw"]
    return out
