"""Cloud optical properties on the RRTMG band structure.

Reference: radiation/radiation_cloud_optics.F90 (setup L33, run L218),
radiation_liquid_optics_socrates.F90, radiation_liquid_optics_slingo.F90,
radiation_ice_optics_fu.F90, radiation_ice_optics_yi.F90.

Vectorized over (ncol, nlev) with bands last; coefficient tables are tiny
(nband × ~16) and are fused into the elementwise kernels.
"""

from __future__ import annotations

import os
from typing import Dict

import jax.numpy as jnp
import numpy as np

from ecrad_tpu.config import Config, IceModel, LiquidModel
from ecrad_tpu.constants import ACCEL_GRAVITY

# File names per model (radiation_config.F90 consolidate: file names derived
# from model names)
LIQ_OPTICS_FILE = {
    LiquidModel.SOCRATES: "socrates_droplet_scattering_rrtm.nc",
    LiquidModel.SLINGO: "slingo_droplet_scattering_rrtm.nc",
    LiquidModel.JAHANGIR: "jahangir_droplet_scattering_rrtm.nc",
    LiquidModel.NIELSEN: "nielsen_droplet_scattering_rrtm.nc",
}
ICE_OPTICS_FILE = {
    IceModel.FU: "fu_ice_scattering_rrtm.nc",
    IceModel.BARAN: "baran_ice_scattering_rrtm.nc",
    IceModel.BARAN2016: "baran2016_ice_scattering_rrtm.nc",
    IceModel.BARAN2017: "baran2017_ice_scattering_rrtm.nc",
    IceModel.YI: "yi_ice_scattering_rrtm.nc",
}


def setup_cloud_optics(config: Config, data_dir: str) -> Dict:
    """Load band-wise liquid/ice coefficient tables (numpy)."""
    from ecrad_tpu.io.netcdf import NcFile

    if config.liq_optics_override_file_name:
        liq_file = config.liq_optics_override_file_name
    else:
        liq_file = LIQ_OPTICS_FILE[config.liquid_model]
    if config.ice_optics_override_file_name:
        ice_file = config.ice_optics_override_file_name
    else:
        ice_file = ICE_OPTICS_FILE[config.ice_model]

    from ecrad_tpu.data import find_data_file

    out = {}
    with NcFile(find_data_file(data_dir, liq_file)) as f:
        out["liq_coeff_lw"] = f.get("coeff_lw")   # (nband_lw, ncoeff)
        out["liq_coeff_sw"] = f.get("coeff_sw")
    with NcFile(find_data_file(data_dir, ice_file)) as f:
        out["ice_coeff_lw"] = f.get("coeff_lw")
        out["ice_coeff_sw"] = f.get("coeff_sw")
        if f.exists("coeff_gen"):
            out["ice_coeff_gen"] = f.get("coeff_gen")
    return out


# --- parameterizations (elementwise over (ncol, nlev, nband)) -------------

def liq_socrates(coeff, lwp, re):
    """SOCRATES Padé fits (radiation_liquid_optics_socrates.F90:9-31).
    coeff (nband, 16); lwp/re (ncol, nlev). Returns od, scat_od, g."""
    c = [jnp.asarray(coeff[:, i]) for i in range(16)]
    re = jnp.clip(re, 1.2e-6, 50.0e-6)[..., None]
    lwp = lwp[..., None]
    od = lwp * (c[0] + re * (c[1] + re * c[2])) \
        / (1.0 + re * (c[3] + re * (c[4] + re * c[5])))
    scat_od = od * (1.0 - (c[6] + re * (c[7] + re * c[8]))
                    / (1.0 + re * (c[9] + re * c[10])))
    g = (c[11] + re * (c[12] + re * c[13])) \
        / (1.0 + re * (c[14] + re * c[15]))
    return od, scat_od, g


def liq_slingo(coeff, lwp, re):
    """Slingo (1989) SW fits (radiation_liquid_optics_slingo.F90:26-49,
    calc_liq_optics_slingo).  coeff (nband, 6)."""
    c = [jnp.asarray(coeff[:, i]) for i in range(6)]
    lwp_g = (lwp * 1000.0)[..., None]
    re_um = jnp.clip(re * 1.0e6, 4.2, 16.6)[..., None]
    inv_re = 1.0 / re_um
    od = lwp_g * (c[0] + inv_re * c[1])
    scat_od = od * (1.0 - c[2] - re_um * c[3])
    g = c[4] + re_um * c[5]
    return od, scat_od, g


def liq_lindner_li(coeff, lwp, re):
    """Lindner & Li (2000) LW fits
    (radiation_liquid_optics_slingo.F90:56-93 calc_liq_optics_lindner_li).
    coeff (nband, 13)."""
    c = [jnp.asarray(coeff[:, i]) for i in range(13)]
    lwp_g = (lwp * 1000.0)[..., None]
    re_um = jnp.clip(re * 1.0e6, 2.0, 40.0)[..., None]
    inv_re = 1.0 / re_um
    od = lwp_g * (c[0] + re_um * c[1]
                  + inv_re * (c[2] + inv_re * (c[3] + inv_re * c[4])))
    scat_od = od * (1.0 - (c[5] + inv_re * c[6]
                           + re_um * (c[7] + re_um * c[8])))
    g = c[9] + inv_re * c[10] + re_um * (c[11] + re_um * c[12])
    return od, scat_od, g


# SW band centre wavelengths (um) for the Jahangir size-parameter
# threshold (radiation_liquid_optics_jahangir.F90:22-24)
_JAHANGIR_BANDS_UM = np.array([3.45, 2.78, 2.325, 2.045, 1.78, 1.45, 1.26,
                               1.01, 0.7, 0.533, 0.39, 0.3, 0.23, 3.92])


def liq_jahangir(coeff, lwp, re):
    """Jahangir et al. SW Pade fits with per-band small/large-droplet
    regimes (radiation_liquid_optics_jahangir.F90:9-80).
    coeff (14, 33); re in metres."""
    c = [jnp.asarray(coeff[:, i]) for i in range(33)]
    lwp_b = lwp[..., None]
    re_b = re[..., None]
    re_um = re_b * 1.0e6

    def pade_od(i0):
        return lwp_b * (c[i0] + re_b * (c[i0 + 1] + re_b * c[i0 + 2])) \
            / ((1.0 + re_b * (c[i0 + 3] + re_b * (c[i0 + 4]
                                                  + re_b * c[i0 + 5])))
               * 1.0e6)

    def pade_ssa(i0):
        return (c[i0] + re_b * (c[i0 + 1] + re_b * c[i0 + 2])) \
            / (1.0 + re_b * (c[i0 + 3] + re_b * c[i0 + 4]))

    # small/large size-parameter regime per band (bands 1-10 only)
    thres = re_um / _JAHANGIR_BANDS_UM
    nb = coeff.shape[0]
    small = (thres < 2.0) | (np.arange(nb) >= 10)
    od = jnp.where(small, pade_od(0), pade_od(16))
    g = jnp.where(small, pade_ssa(11), pade_ssa(27))
    co_ssa = jnp.where((c[32] > 0) & (re_um > c[32]),
                       pade_ssa(22), pade_ssa(6))
    scat_od = od * (1.0 - co_ssa)
    return od, scat_od, g


def liq_nielsen(coeff, lwp, re):
    """Nielsen power-law SW fits
    (radiation_liquid_optics_nielsen.F90:12-33).  coeff (nband, 8)."""
    c = [jnp.asarray(coeff[:, i]) for i in range(8)]
    lwp_g = (lwp * 1000.0)[..., None]
    re_um = (re * 1.0e6)[..., None]
    od = lwp_g * c[0] * re_um ** c[1]
    scat_od = od * (c[2] + c[3] * re_um)
    g = c[4] + c[5] * re_um + c[6] * jnp.exp(c[7] * re_um)
    return od, scat_od, g


def ice_baran(coeff, iwp, qi):
    """Baran ice parameterization in ice mixing ratio
    (radiation_ice_optics_baran.F90:10-29).  coeff (nband, 9)."""
    c = [jnp.asarray(coeff[:, i]) for i in range(9)]
    iwp_b = iwp[..., None]
    qi_b = qi[..., None]
    od = iwp_b * (c[0] + c[1] / (1.0 + qi_b * c[2]))
    scat_od = od * (c[3] + c[4] / (1.0 + qi_b * c[5]))
    g = c[6] + c[7] / (1.0 + qi_b * c[8])
    return od, scat_od, g


def ice_baran2016(coeff, iwp, qi, temperature):
    """Baran et al. (2016) in qi and T
    (radiation_ice_optics_baran.F90:31-62).  coeff (nband, 5)."""
    c = [jnp.asarray(coeff[:, i]) for i in range(5)]
    t = temperature[..., None]
    qi_t = jnp.minimum(qi, 1.0e-3)[..., None] * t
    qi_over_t4 = 1.0 / (t * t * t * t)
    od = iwp[..., None] * c[0] * qi_over_t4
    scat_od = od * (c[1] + c[2] * qi_t)
    g = c[3] + c[4] * qi_t
    return od, scat_od, g


def ice_baran2017(coeff_gen, coeff, iwp, qi, temperature):
    """Baran et al. (2017) (radiation_ice_optics_baran2017.F90:7-46).
    coeff_gen (5,), coeff (nband, 9)."""
    cg = np.asarray(coeff_gen)
    c = [jnp.asarray(coeff[:, i]) for i in range(9)]
    qi_mod = qi * jnp.exp(cg[0] * (temperature - cg[1]))
    qd = jnp.maximum(qi_mod, 1e-30)
    qi_od = (qd ** cg[2])[..., None]
    qi_ssa = (qd ** cg[3])[..., None]
    qi_g = (qd ** cg[4])[..., None]
    iwp_b = iwp[..., None]
    od = iwp_b * (c[0] + c[1] / (1.0 + qi_od * c[2]))
    scat_od = od * (c[3] + c[4] / (1.0 + qi_ssa * c[5]))
    g = c[6] + c[7] / (1.0 + qi_g * c[8])
    return od, scat_od, g


def ice_yi(coeff, iwp, re):
    """Yi et al. (2013) LUT interpolation in effective diameter
    (radiation_ice_optics_yi.F90:10-80).  coeff (nband, 69) laid out as
    23 extinction + 23 ssa + 23 asymmetry columns."""
    n_single = 23
    de_um = jnp.clip(re * 2.0e6, 10.0, 119.99)
    iwp_g = (iwp * 1000.0)[..., None]
    # Fortran lu_idx = floor(de*0.2 - 1), used as 1-based column index
    pos = de_um * 0.2 - 1.0
    idx = jnp.floor(pos).astype(jnp.int32)
    w2 = (pos - idx)[..., None]
    w1 = 1.0 - w2
    idx0 = (idx - 1)[..., None]                  # 0-based
    cf = jnp.asarray(coeff).T                    # (69, nband)

    def lut(offset):
        lo = jnp.take(cf, idx0 + offset, axis=0)[..., 0, :]
        hi = jnp.take(cf, idx0 + offset + 1, axis=0)[..., 0, :]
        return w1 * lo + w2 * hi

    od = 0.001 * iwp_g * lut(0)
    scat_od = od * lut(n_single)
    g = lut(2 * n_single)
    return od, scat_od, g


def ice_fu_sw(coeff, iwp, re):
    """Fu (1996) SW (radiation_ice_optics_fu.F90:10-33)."""
    c = [jnp.asarray(coeff[:, i]) for i in range(10)]
    max_g = 1.0 - 10.0 * np.finfo(np.float64).eps
    de_um = (jnp.minimum(re, 100.0e-6) * (1.0e6 / 0.64952))[..., None]
    inv_de = 1.0 / de_um
    iwp_g = (iwp * 1000.0)[..., None]
    od = iwp_g * (c[0] + c[1] * inv_de)
    scat_od = od * (1.0 - (c[2] + de_um * (c[3] + de_um * (c[4]
                                                          + de_um * c[5]))))
    g = jnp.minimum(c[6] + de_um * (c[7] + de_um * (c[8] + de_um * c[9])),
                    max_g)
    return od, scat_od, g


def ice_fu_lw(coeff, iwp, re):
    """Fu et al. (1998) LW (radiation_ice_optics_fu.F90:35-60)."""
    c = [jnp.asarray(coeff[:, i]) for i in range(11)]
    max_g = 1.0 - 10.0 * np.finfo(np.float64).eps
    de_um = (jnp.minimum(re, 100.0e-6) * (1.0e6 / 0.64952))[..., None]
    inv_de = 1.0 / de_um
    iwp_g = (iwp * 1000.0)[..., None]
    od = iwp_g * (c[0] + inv_de * (c[1] + inv_de * c[2]))
    scat_od = od - iwp_g * inv_de * (c[3] + de_um * (c[4] + de_um * (
        c[5] + de_um * c[6])))
    g = jnp.minimum(c[7] + de_um * (c[8] + de_um * (c[9] + de_um * c[10])),
                    max_g)
    return od, scat_od, g


def delta_eddington_scat_od(od, scat_od, g):
    """radiation_delta_eddington.h delta_eddington_scat_od."""
    f = g * g
    od = od - scat_od * f
    scat_od = scat_od * (1.0 - f)
    g = g / (1.0 + g)
    return od, scat_od, g


def cloud_optics(config: Config, tables: Dict, pressure_hl, temperature_hl,
                 cloud_fraction, q_liq, q_ice, re_liq, re_ice):
    """Cloud od/ssa/g per band (radiation_cloud_optics.F90:218-525).

    Returns dict with od_lw, ssa_lw, g_lw (ncol, nlev, nband_lw) and
    od_sw, ssa_sw, g_sw (ncol, nlev, nband_sw). In-cloud quantities.
    """
    in_cloud = cloud_fraction > 0.0
    if config.is_homogeneous:
        factor = (pressure_hl[:, 1:] - pressure_hl[:, :-1]) \
            / ACCEL_GRAVITY
    else:
        factor = (pressure_hl[:, 1:] - pressure_hl[:, :-1]) \
            / (ACCEL_GRAVITY * jnp.maximum(cloud_fraction, 1.0e-30))
    factor = jnp.where(in_cloud, factor, 0.0)
    lwp = factor * q_liq
    iwp = factor * q_ice

    if config.liquid_model == LiquidModel.SOCRATES:
        od_lw_liq, scat_lw_liq, g_lw_liq = liq_socrates(
            tables["liq_coeff_lw"], lwp, re_liq)
        od_sw_liq, scat_sw_liq, g_sw_liq = liq_socrates(
            tables["liq_coeff_sw"], lwp, re_liq)
    elif config.liquid_model == LiquidModel.SLINGO:
        # radiation_cloud_optics.F90:346-353: Lindner&Li LW + Slingo SW
        od_lw_liq, scat_lw_liq, g_lw_liq = liq_lindner_li(
            tables["liq_coeff_lw"], lwp, re_liq)
        od_sw_liq, scat_sw_liq, g_sw_liq = liq_slingo(
            tables["liq_coeff_sw"], lwp, re_liq)
    else:
        # Jahangir/Nielsen parameterizations exist (liq_jahangir,
        # liq_nielsen) but, as in the reference, the band cloud-optics
        # run path does not dispatch them
        # (radiation_cloud_optics.F90:335-356 aborts on unknown model)
        raise NotImplementedError(
            f"liquid model {config.liquid_model} has no run dispatch")
    liq_present = (lwp > 0.0)[..., None]
    od_lw_liq = jnp.where(liq_present, od_lw_liq, 0.0)
    scat_lw_liq = jnp.where(liq_present, scat_lw_liq, 0.0)
    g_lw_liq = jnp.where(liq_present, g_lw_liq, 0.0)
    od_sw_liq = jnp.where(liq_present, od_sw_liq, 0.0)
    scat_sw_liq = jnp.where(liq_present, scat_sw_liq, 0.0)
    g_sw_liq = jnp.where(liq_present, g_sw_liq, 0.0)
    if not config.do_sw_delta_scaling_with_gases:
        od_sw_liq, scat_sw_liq, g_sw_liq = delta_eddington_scat_od(
            od_sw_liq, scat_sw_liq, g_sw_liq)

    if config.ice_model == IceModel.FU:
        od_lw_ice, scat_lw_ice, g_lw_ice = ice_fu_lw(
            tables["ice_coeff_lw"], iwp, re_ice)
        if config.do_fu_lw_ice_optics_bug:
            scat_lw_ice = od_lw_ice - scat_lw_ice
        od_sw_ice, scat_sw_ice, g_sw_ice = ice_fu_sw(
            tables["ice_coeff_sw"], iwp, re_ice)
    elif config.ice_model == IceModel.BARAN:
        od_lw_ice, scat_lw_ice, g_lw_ice = ice_baran(
            tables["ice_coeff_lw"], iwp, q_ice)
        od_sw_ice, scat_sw_ice, g_sw_ice = ice_baran(
            tables["ice_coeff_sw"], iwp, q_ice)
    elif config.ice_model in (IceModel.BARAN2016, IceModel.BARAN2017):
        t_fl = 0.5 * (temperature_hl[:, :-1] + temperature_hl[:, 1:])
        if config.ice_model == IceModel.BARAN2016:
            od_lw_ice, scat_lw_ice, g_lw_ice = ice_baran2016(
                tables["ice_coeff_lw"], iwp, q_ice, t_fl)
            od_sw_ice, scat_sw_ice, g_sw_ice = ice_baran2016(
                tables["ice_coeff_sw"], iwp, q_ice, t_fl)
        else:
            od_lw_ice, scat_lw_ice, g_lw_ice = ice_baran2017(
                tables["ice_coeff_gen"], tables["ice_coeff_lw"],
                iwp, q_ice, t_fl)
            od_sw_ice, scat_sw_ice, g_sw_ice = ice_baran2017(
                tables["ice_coeff_gen"], tables["ice_coeff_sw"],
                iwp, q_ice, t_fl)
    elif config.ice_model == IceModel.YI:
        od_lw_ice, scat_lw_ice, g_lw_ice = ice_yi(
            tables["ice_coeff_lw"], iwp, re_ice)
        od_sw_ice, scat_sw_ice, g_sw_ice = ice_yi(
            tables["ice_coeff_sw"], iwp, re_ice)
    else:
        raise NotImplementedError(
            f"ice model {config.ice_model} not yet implemented")
    ice_present = (iwp > 0.0)[..., None]
    od_lw_ice = jnp.where(ice_present, od_lw_ice, 0.0)
    scat_lw_ice = jnp.where(ice_present, scat_lw_ice, 0.0)
    g_lw_ice = jnp.where(ice_present, g_lw_ice, 0.0)
    od_sw_ice = jnp.where(ice_present, od_sw_ice, 0.0)
    scat_sw_ice = jnp.where(ice_present, scat_sw_ice, 0.0)
    g_sw_ice = jnp.where(ice_present, g_sw_ice, 0.0)
    if not config.do_sw_delta_scaling_with_gases:
        od_sw_ice, scat_sw_ice, g_sw_ice = delta_eddington_scat_od(
            od_sw_ice, scat_sw_ice, g_sw_ice)
    od_lw_ice, scat_lw_ice, g_lw_ice = delta_eddington_scat_od(
        od_lw_ice, scat_lw_ice, g_lw_ice)

    in_cloud_b = in_cloud[..., None]
    out = {}
    if config.do_lw_cloud_scattering:
        od_lw = od_lw_liq + od_lw_ice
        scat_lw = scat_lw_liq + scat_lw_ice
        g_lw = jnp.where(scat_lw > 0.0,
                         (g_lw_liq * scat_lw_liq + g_lw_ice * scat_lw_ice)
                         / jnp.maximum(scat_lw, 1.0e-300), 0.0)
        ssa_lw = jnp.where(od_lw > 0.0,
                           scat_lw / jnp.maximum(od_lw, 1.0e-300), 0.0)
        out["od_lw"] = jnp.where(in_cloud_b, od_lw, 0.0)
        out["ssa_lw"] = jnp.where(in_cloud_b, ssa_lw, 0.0)
        out["g_lw"] = jnp.where(in_cloud_b, g_lw, 0.0)
    else:
        od_lw = (od_lw_liq - scat_lw_liq) + (od_lw_ice - scat_lw_ice)
        out["od_lw"] = jnp.where(in_cloud_b, od_lw, 0.0)
        out["ssa_lw"] = jnp.zeros_like(od_lw)
        out["g_lw"] = jnp.zeros_like(od_lw)

    od_sw = od_sw_liq + od_sw_ice
    scat_sw = scat_sw_liq + scat_sw_ice
    g_sw = jnp.where(scat_sw > 0.0,
                     (g_sw_liq * scat_sw_liq + g_sw_ice * scat_sw_ice)
                     / jnp.maximum(scat_sw, 1.0e-300), 0.0)
    ssa_sw = jnp.where(od_sw > 0.0,
                       scat_sw / jnp.maximum(od_sw, 1.0e-300), 0.0)
    out["od_sw"] = jnp.where(in_cloud_b, od_sw, 0.0)
    out["ssa_sw"] = jnp.where(in_cloud_b, ssa_sw, 0.0)
    out["g_sw"] = jnp.where(in_cloud_b, g_sw, 0.0)
    return out
