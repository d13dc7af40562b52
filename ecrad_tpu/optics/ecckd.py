"""ecCKD gas optics model.

Reference: radiation/radiation_ecckd.F90 (+ radiation_ecckd_gas.F90,
radiation_ecckd_interface.F90).  The k-distribution is loaded at runtime
from a NetCDF "ckd-definition" file: per-gas molar absorption LUTs on a
regular log-pressure × temperature(-offset) grid with four concentration-
dependence types, a Planck LUT (LW) or normalized solar irradiance +
Rayleigh coefficients (SW), and an embedded spectral definition.

Formulation: the LUTs are small, regular grids → pure jnp gather +
multilinear interpolation with the g axis on lanes; everything fuses into
a handful of elementwise kernels.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ecrad_tpu import constants
from ecrad_tpu.optics.spectral_def import SpectralDefinition

# radiation_ecckd_gas.F90:8-13
CONC_NONE = 0
CONC_LINEAR = 1
CONC_LUT = 2
CONC_RELATIVE_LINEAR = 3

AIR_MOLAR_MASS = 28.970        # radiation_gas_constants.F90
GRAVITY = 9.80665


def load_ckd_model(path: str):
    """Host-side read (radiation_ecckd.F90:127-293).

    Returns (tables dict of numpy arrays, SpectralDefinition, meta dict).
    """
    from ecrad_tpu.io.netcdf import NcFile

    t: Dict = {}
    meta: Dict = {}
    with NcFile(path) as f:
        pressure_lut = f.get("pressure")
        meta["log_pressure1"] = float(np.log(pressure_lut[0]))
        meta["npress"] = pressure_lut.size
        meta["d_log_pressure"] = float(np.log(pressure_lut[1])
                                       - np.log(pressure_lut[0]))
        temperature_full = f.get("temperature")     # (ntemp, npress) C
        t["temperature1"] = temperature_full[0, :]  # (npress,)
        meta["d_temperature"] = float(temperature_full[1, 0]
                                      - temperature_full[0, 0])
        meta["ntemp"] = temperature_full.shape[0]

        if f.exists("solar_irradiance"):
            meta["is_sw"] = True
            si = f.get("solar_irradiance")
            t["norm_solar_irradiance"] = si / si.sum()
            t["rayleigh_molar_scat"] = f.get(
                "rayleigh_molar_scattering_coeff")
        else:
            meta["is_sw"] = False
            tp = f.get("temperature_planck")
            meta["nplanck"] = tp.size
            meta["temperature1_planck"] = float(tp[0])
            meta["d_temperature_planck"] = float(tp[1] - tp[0])
            t["planck_function"] = f.get("planck_function")  # (nT, ng)

        specdef = SpectralDefinition.from_file(f)
        meta["ng"] = specdef.ng

        constituent_id = f.get_global_attr("constituent_id")
        gas_names = constituent_id.split()
        meta["gases"] = []
        for gname in gas_names:
            g: Dict = {"name": gname}
            code = int(np.asarray(
                f.get(f"{gname}_conc_dependence_code")).ravel()[0])
            g["conc_dependence"] = code
            if code == CONC_LUT:
                # (nconc, ntemp, npress, ng) in C-order
                t[f"{gname}_molar_abs_conc"] = f.get(
                    f"{gname}_molar_absorption_coeff")
                mf = f.get(f"{gname}_mole_fraction")
                g["log_mole_frac1"] = float(np.log(mf[0]))
                g["n_mole_frac"] = mf.size
                g["d_log_mole_frac"] = float(
                    (np.log(mf[-1]) - np.log(mf[0])) / (mf.size - 1))
            else:
                # (ntemp, npress, ng) in C-order
                t[f"{gname}_molar_abs"] = f.get(
                    f"{gname}_molar_absorption_coeff")
            if code == CONC_RELATIVE_LINEAR:
                g["reference_mole_frac"] = float(np.asarray(f.get(
                    f"{gname}_reference_mole_fraction")).ravel()[0])
            meta["gases"].append(g)
    return t, specdef, meta


def pt_onehot(tables: Dict, meta: Dict, pressure_hl, temperature_fl):
    """Weighted one-hot over the flat (t, p) LUT grid: W4 has the four
    bilinear corner weights as its only nonzeros, so ``W4 @ table`` IS
    the interpolation — one matmul (HIGHEST precision) over the tiny
    (~318, ng) tables in place of 4 row-gathers per gas.  Shareable
    between the SW and LW models when their (pressure, temperature)
    grids coincide (grid_signature)."""
    dtype = pressure_hl.dtype
    npress, ntemp = meta["npress"], meta["ntemp"]
    log_p = jnp.log(0.5 * (pressure_hl[:, :-1] + pressure_hl[:, 1:]))
    pindex1 = (log_p - meta["log_pressure1"]) / meta["d_log_pressure"]
    pindex1 = 1.0 + jnp.clip(pindex1, 0.0, npress - 1.0001)
    ip1 = pindex1.astype(jnp.int32)            # 1-based lower index
    pw2 = pindex1 - ip1
    pw1 = 1.0 - pw2

    temp1_lut = jnp.asarray(tables["temperature1"], dtype)
    temperature1 = pw1 * temp1_lut[ip1 - 1] + pw2 * temp1_lut[ip1]
    tindex1 = (temperature_fl - temperature1) / meta["d_temperature"]
    tindex1 = 1.0 + jnp.clip(tindex1, 0.0, ntemp - 1.0001)
    it1 = tindex1.astype(jnp.int32)
    tw2 = tindex1 - it1
    tw1 = 1.0 - tw2

    ncol, nlev = log_p.shape
    B = ncol * nlev
    fl = lambda x: x.reshape(B)
    iota_p = jnp.arange(npress, dtype=jnp.int32)
    WP = (jnp.where(iota_p == (fl(ip1) - 1)[:, None], fl(pw1)[:, None],
                    0.0)
          + jnp.where(iota_p == fl(ip1)[:, None], fl(pw2)[:, None],
                      0.0)).astype(dtype)
    iota_t = jnp.arange(ntemp, dtype=jnp.int32)
    WT = (jnp.where(iota_t == (fl(it1) - 1)[:, None], fl(tw1)[:, None],
                    0.0)
          + jnp.where(iota_t == fl(it1)[:, None], fl(tw2)[:, None],
                      0.0)).astype(dtype)
    return (WT[:, :, None] * WP[:, None, :]).reshape(B, ntemp * npress)


def grid_signature(tables: Dict, meta: Dict):
    """Hashable identity of the (p, T) LUT grid, for W4 sharing."""
    return (meta["npress"], meta["ntemp"], meta["log_pressure1"],
            meta["d_log_pressure"], meta["d_temperature"],
            tuple(np.asarray(tables["temperature1"]).tolist()))


def calc_optical_depth(tables: Dict, meta: Dict, pressure_hl,
                       temperature_fl, gas_vmr, pt_w=None):
    """radiation_ecckd.F90:457-658 calc_optical_depth_ckd_model.

    gas_vmr: dict name → (ncol, nlev) volume mixing ratio ("composite"
    needs no entry).  pt_w: optional precomputed :func:`pt_onehot`
    (grids must match — see grid_signature).
    Returns (od (ncol,nlev,ng) [, rayleigh_od]).
    """
    dtype = pressure_hl.dtype
    npress, ntemp = meta["npress"], meta["ntemp"]
    global_multiplier = 1.0 / (GRAVITY * 0.001 * AIR_MOLAR_MASS)
    ncol, nlev = temperature_fl.shape

    simple_multiplier = global_multiplier * (pressure_hl[:, 1:]
                                             - pressure_hl[:, :-1])

    W4 = pt_onehot(tables, meta, pressure_hl, temperature_fl) \
        if pt_w is None else pt_w

    def lut_dot(W, T):
        """(B, R) @ (R, G) at full f32 precision."""
        return jax.lax.dot_general(
            W, T, (((1,), (0,)), ((), ())),
            preferred_element_type=W.dtype,
            precision=jax.lax.Precision.HIGHEST)

    simple, lut = [], []
    for g in meta["gases"]:
        (lut if g["conc_dependence"] == CONC_LUT else simple).append(g)

    od = 0.0
    if simple:
        T_all = np.concatenate(
            [np.asarray(tables[f"{g['name']}_molar_abs"],
                        np.float64).reshape(ntemp * npress, -1)
             for g in simple], axis=1)
        ng = T_all.shape[1] // len(simple)
        K_all = lut_dot(W4, jnp.asarray(T_all, dtype)).reshape(
            ncol, nlev, len(simple), ng)
        for i, g in enumerate(simple):
            gname = g["name"]
            code = g["conc_dependence"]
            k = K_all[:, :, i, :]
            if code == CONC_LINEAR:
                mult = simple_multiplier * gas_vmr[gname]
            elif code == CONC_RELATIVE_LINEAR:
                mult = simple_multiplier * (gas_vmr[gname]
                                            - g["reference_mole_frac"])
            elif code == CONC_NONE:
                mult = simple_multiplier
            else:
                raise ValueError(f"unknown conc dependence {code}")
            od = od + mult[..., None] * k

    for g in lut:
        gname = g["name"]
        nconc = g["n_mole_frac"]
        log_conc = jnp.log(jnp.maximum(gas_vmr[gname],
                                       np.exp(g["log_mole_frac1"])))
        cindex1 = (log_conc - g["log_mole_frac1"]) \
            / g["d_log_mole_frac"]
        cindex1 = 1.0 + jnp.clip(cindex1, 0.0, nconc - 1.0001)
        ic1 = cindex1.astype(jnp.int32)
        cw2 = cindex1 - ic1
        cw1 = 1.0 - cw2
        # (nconc, ntemp, npress, ng): (t, p)-interpolate every conc
        # level in one matmul, then contract the two conc corners with
        # their linear weights
        tab = np.asarray(tables[f"{gname}_molar_abs_conc"], np.float64)
        ng = tab.shape[-1]
        # rows (t*npress + p), columns (conc*ng + g)
        T_c = jnp.asarray(
            np.transpose(tab, (1, 2, 0, 3)).reshape(ntemp * npress,
                                                    nconc * ng), dtype)
        K_c = lut_dot(W4, T_c).reshape(ncol, nlev, nconc, ng)
        iota_c = jnp.arange(nconc, dtype=jnp.int32)
        WC = (jnp.where(iota_c == (ic1 - 1)[..., None], cw1[..., None],
                        0.0)
              + jnp.where(iota_c == ic1[..., None], cw2[..., None],
                          0.0)).astype(dtype)
        k = jnp.einsum("blc,blcg->blg", WC, K_c,
                       precision=jax.lax.Precision.HIGHEST)
        mult = simple_multiplier * gas_vmr[gname]
        od = od + mult[..., None] * k

    od = jnp.maximum(od, 0.0)
    if meta["is_sw"]:
        ray = simple_multiplier[..., None] \
            * jnp.asarray(tables["rayleigh_molar_scat"], dtype)
        return od, ray
    return od, None


def calc_planck(tables: Dict, meta: Dict, temperature):
    """radiation_ecckd.F90:900-932 calc_planck_function.
    temperature (...,) → (..., ng).

    The 2-corner linear interpolation runs as a weighted one-hot
    matmul over the (nplanck, ng) table, as in calc_optical_depth."""
    pf = jnp.asarray(tables["planck_function"])      # (nT, ng)
    t1 = meta["temperature1_planck"]
    dt = meta["d_temperature_planck"]
    nplanck = meta["nplanck"]
    tindex0 = (temperature - t1) / dt
    tindex1 = 1.0 + tindex0
    it1 = jnp.minimum(tindex1.astype(jnp.int32), nplanck - 1)
    tw2 = tindex1 - it1
    tw1 = 1.0 - tw2
    it2 = jnp.minimum(it1, nplanck - 1)
    shape = temperature.shape
    B = int(np.prod(shape)) if shape else 1
    flz = lambda x: x.reshape(B)
    iota = jnp.arange(nplanck, dtype=jnp.int32)
    W2 = (jnp.where(iota == (flz(it1) - 1)[:, None], flz(tw1)[:, None],
                    0.0)
          + jnp.where(iota == flz(it2)[:, None], flz(tw2)[:, None],
                      0.0)).astype(pf.dtype)
    interp = jax.lax.dot_general(
        W2, pf, (((1,), (0,)), ((), ())),
        preferred_element_type=pf.dtype,
        precision=jax.lax.Precision.HIGHEST).reshape(
            shape + (pf.shape[-1],))
    # below-table extrapolation: scale first entry linearly in T
    low = pf[0] * (temperature / t1)[..., None]
    return jnp.where((tindex0 >= 0.0)[..., None], interp, low)


def read_spectral_solar_cycle(tables: Dict, specdef: SpectralDefinition,
                              ssi_path: str,
                              use_updated_solar_spectrum: bool = False):
    """Read the solar-cycle spectral-variation amplitude and map it to
    g-points (radiation_ecckd.F90:295-455 read_spectral_solar_cycle).

    Mutates ``tables`` in place: adds ``norm_amplitude_solar_irradiance``
    (ng,) and, with use_updated_solar_spectrum, rescales
    ``norm_solar_irradiance`` to the file's mean spectrum (requires an
    ecCKD >= 1.4 model carrying solar_spectral_irradiance)."""
    from ecrad_tpu.io.netcdf import NcFile

    with NcFile(ssi_path) as f:
        wav = np.asarray(f.get("wavenumber"), np.float64)
        ssi = np.asarray(f.get("mean_solar_spectral_irradiance"),
                         np.float64)
        amp = np.asarray(f.get("ssi_solar_cycle_amplitude"), np.float64)

    wg = 0.5 * (specdef.wavenumber1 + specdef.wavenumber2)
    dwav = float(specdef.wavenumber2[0] - specdef.wavenumber1[0])
    # linear interpolation to the model's fine wavenumber grid, zero
    # outside the file's range (reference loop semantics:
    # wav[j] < wg <= wav[j+1])
    j = np.searchsorted(wav, wg, side="left") - 1
    valid = (j >= 0) & (j < wav.size - 1)
    jc = np.clip(j, 0, wav.size - 2)
    denom = wav[jc + 1] - wav[jc]

    def interp(y):
        v = (y[jc] * (wav[jc + 1] - wg) + y[jc + 1] * (wg - wav[jc])) \
            * dwav / denom
        return np.where(valid, v, 0.0)

    ssi_grid = interp(ssi)
    amp_grid = interp(amp)

    norm = np.asarray(tables["norm_solar_irradiance"], np.float64)
    gf = specdef.gpoint_fraction                    # (nwav, ng)
    if use_updated_solar_spectrum:
        if specdef.solar_spectral_irradiance is None:
            raise ValueError(
                "use_updated_solar_spectrum requires an ecCKD >= 1.4 "
                "model (radiation_ecckd.F90:399-404)")
        old = np.asarray(specdef.solar_spectral_irradiance, np.float64)
        norm = norm * (ssi_grid @ gf) / (old @ gf)
        norm = norm / norm.sum()
        specdef.solar_spectral_irradiance = ssi_grid
        tables["norm_solar_irradiance"] = norm

    namp = norm * (amp_grid @ gf) / (ssi_grid @ gf)
    # remove the mean: the user scales total solar irradiance separately
    namp = (norm + namp) / np.sum(norm + namp) - norm
    tables["norm_amplitude_solar_irradiance"] = namp
    return tables


def calc_incoming_sw(tables: Dict, meta: Dict, total_solar_irradiance,
                     ncol: int, solar_cycle_multiplier: float = 0.0):
    """radiation_ecckd.F90:935-966: spectral solar irradiance per g
    point, optionally shifted along the solar cycle (multiplier is in
    standard deviations of the cycle; +1 ~ solar maximum)."""
    nsi = jnp.asarray(tables["norm_solar_irradiance"])
    if solar_cycle_multiplier != 0.0:
        if "norm_amplitude_solar_irradiance" not in tables:
            raise ValueError(
                "no information present on solar cycle "
                "(set use_spectral_solar_cycle; radiation_ecckd.F90:957)")
        nsi = nsi + solar_cycle_multiplier * jnp.asarray(
            tables["norm_amplitude_solar_irradiance"])
    return jnp.broadcast_to(total_solar_irradiance * nsi,
                            (ncol, nsi.shape[0]))
