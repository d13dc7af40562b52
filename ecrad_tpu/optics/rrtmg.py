"""RRTMG gas optics backend: the equivalent of
radiation/radiation_ifs_rrtm.F90:216-614 (gas_optics) plus
planck_function_atmos/surf (L618-904), fully vectorized in JAX with
top-down level ordering throughout (the reference's internal bottom-up
reordering and final flip cancel out here).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from ecrad_tpu import backend
from ecrad_tpu.optics import rrtmg_data, rrtmg_lw, rrtmg_sw
from ecrad_tpu.optics.rrtmg_prepare import prepare_columns
from ecrad_tpu import profiling

FLUXFAC = np.pi * 1.0e4


class RRTMGGasOptics(NamedTuple):
    """Output of the RRTMG backend (all top-down, g last)."""
    od_lw: Optional[jnp.ndarray] = None        # (ncol, nlev, 140)
    planck_hl: Optional[jnp.ndarray] = None    # (ncol, nlev+1, 140)
    lw_emission: Optional[jnp.ndarray] = None  # (ncol, 140) surface Planck
    od_sw: Optional[jnp.ndarray] = None        # (ncol, nlev, 112)
    ssa_sw: Optional[jnp.ndarray] = None       # (ncol, nlev, 112)
    incoming_sw: Optional[jnp.ndarray] = None  # (ncol, 112)


def setup_tables():
    """Host-side: load + reshape all tables. Returns (tables_dict, meta)."""
    raw = rrtmg_data.load_tables()
    tables = {}
    tables.update({f"lw:{k}": v
                   for k, v in rrtmg_lw.build_lw_tables(raw).items()})
    tables.update({f"sw:{k}": v
                   for k, v in rrtmg_sw.build_sw_tables(raw).items()})
    tables["pref"] = raw["pref"]
    tables["preflog"] = raw["preflog"]
    tables["tref"] = raw["tref"]
    tables["chi_mls"] = raw["chi_mls"]
    tables["totplnk"] = raw["lw_totplnk"]
    tables["delwave"] = raw["lw_delwave"]
    tables["lw_band_from_g"] = raw["lw_band_from_g"]
    tables["sw_band_from_g"] = raw["sw_band_from_g"]
    return tables


def install_interp_windows(tables, thermodynamics) -> None:
    """Store level windows for the one-hot interpolation in the RRTMG
    gas tables (part of the traced closure, so a step traced with them
    cannot silently be fed others; out-of-window inputs are NaN-poisoned
    by the interpolation guard), probed from this input grid.  Does
    nothing where the gather form is chosen, where there are no RRTMG
    tables, or with ECRAD_TPU_NO_WINDOWS=1."""
    if (backend.choices().interp != "onehot"
            or "rrtmg" not in (tables.gas or {})
            or os.environ.get("ECRAD_TPU_NO_WINDOWS", "0")
            not in ("", "0")):
        return
    tables.gas["rrtmg"]["windows"] = compute_interp_windows(
        tables.gas["rrtmg"], thermodynamics.pressure_hl,
        thermodynamics.temperature_hl)


def compute_interp_windows(tables, pressure_hl, temperature_hl) -> dict:
    """Probe the real inputs for the per-level (jp, jt)-plane spans and
    derive exact level-window widths for every major-species
    interpolation (see rrtmg_interp module notes).

    The row index of every major interpolation is ``P*njs + js + d``
    with ``P = jp*5 + jt`` (plane index into the flattened table) and
    ``js + d`` bounded by the eta-axis size, so a width of
    ``(Pspan-1)*njs + (njs + edge)`` covers the true span exactly.
    Pure function of pressure/temperature (rrtm_setcoef_140gp.F90 index
    formulas); one tiny jitted reduce, fetched to host ints.

    Install with :func:`install_interp_windows` BEFORE tracing the
    radiation step."""
    import jax

    preflog = np.asarray(tables["preflog"])
    tref = np.asarray(tables["tref"])

    @jax.jit
    def spans(phl, thl):
        pavel = 0.5 * (phl[:, :-1] + phl[:, 1:]) * 0.01   # hPa
        tavel = 0.5 * (thl[:, :-1] + thl[:, 1:])
        plog = jnp.log(pavel)
        jp1b = jnp.clip(jnp.floor(36.0 - 5.0 * (plog + 0.04))
                        .astype(jnp.int32), 1, 58)
        jp = jp1b - 1                                   # 0-based 0..57
        tref_jp = jnp.take(jnp.asarray(tref), jp, axis=0)
        tref_jp1 = jnp.take(jnp.asarray(tref),
                            jnp.clip(jp + 1, 0, 58), axis=0)
        jt = jnp.clip(jnp.floor(3.0 + (tavel - tref_jp) / 15.0)
                      .astype(jnp.int32), 1, 4) - 1     # 0-based 0..3
        jt1 = jnp.clip(jnp.floor(3.0 + (tavel - tref_jp1) / 15.0)
                       .astype(jnp.int32), 1, 4) - 1

        def pspan(njp, off):
            jp0 = jnp.clip(jp - off, 0, njp - 1)
            jp1_ = jnp.clip(jp + 1 - off, 0, njp - 1)
            cands = jnp.stack([jp0 * 5 + jt, jp0 * 5 + jt + 1,
                               jp1_ * 5 + jt1, jp1_ * 5 + jt1 + 1])
            pmin = jnp.min(cands, axis=(0, 1))          # per level
            pmax = jnp.max(cands, axis=(0, 1))
            return jnp.max(pmax - pmin) + 1

        # laytrop level bounds (tropo = plog > 4.56, monotone per
        # column top-down): lower tables are only selected at levels
        # where some column is tropospheric, upper tables only where
        # some column is stratospheric (rrtm_taumol* JLAY<=LAYTROP)
        nlev = pavel.shape[1]
        tropo = plog > 4.56
        any_tropo = jnp.any(tropo, axis=1)
        first_tropo = jnp.where(any_tropo,
                                jnp.argmax(tropo, axis=1), nlev)
        lo_start = jnp.min(first_tropo)
        hi_end = jnp.max(first_tropo)

        # minor-gas temperature index: floor((T-180.8)/7.2) in [1,18]
        # (rrtm_setcoef_140gp.F90); idx = jt*njs + js with jt in
        # {ind, ind+1}, js spanning the full eta axis
        im = jnp.clip(jnp.floor((tavel - 180.8) / 7.2)
                      .astype(jnp.int32), 1, 18)
        s_minor = jnp.max(jnp.max(im, axis=0) - jnp.min(im, axis=0)) + 1

        # LW Planck LUT index: floor(T-159) clipped to [1, 180]
        # (radiation_ifs_rrtm.F90:672-690); span over half-levels
        ind = jnp.clip(jnp.floor(thl - 159.0).astype(jnp.int32), 1, 180)
        pspan_planck = jnp.max(jnp.max(ind, axis=0)
                               - jnp.min(ind, axis=0)) + 2

        return (pspan(13, 0), pspan(47, 12), lo_start, hi_end,
                pspan_planck, s_minor)

    s_lo, s_hi, lo_start, hi_end, s_planck, s_minor = (int(x) for x in
        jax.device_get(spans(jnp.asarray(pressure_hl),
                             jnp.asarray(temperature_hl))))
    nlev = np.shape(pressure_hl)[1] - 1
    lo = (lo_start, nlev)          # level slice where lower tables used
    hi = (0, hi_end)               # level slice where upper tables used

    windows = {
        "lw/m1lo": (s_lo,) + lo, "lw/m1hi": (s_hi,) + hi,
        "sw/m1lo": (s_lo,) + lo, "sw/m1hi": (s_hi,) + hi,
        "lw/planck": s_planck,
        # minor-gas eta tables (19, njs, ng): idx range covers jt in
        # {ind, ind+1} times the full eta axis
        "lw/minor2lo": ((s_minor + 1) * 9,) + lo,
        "lw/minor2hi": ((s_minor + 1) * 5,) + hi,
    }
    # LW lower eta bands: njs=9, eta-edge offsets d in [-1, 2], js<=7
    # => js+d in [-1, 9]: 11 values
    for name in ("h2oco2", "h2oo3", "h2och4", "h2on2o", "n2oco2"):
        windows[f"lw/m2lo/{name}"] = ((s_lo - 1) * 9 + 11,) + lo
    # LW upper eta bands (3,4,5): njs=5, js in [0,3], djs in {0,1}
    for band in (3, 4, 5):
        windows[f"lw/m2hi/{band}"] = ((s_hi - 1) * 5 + 5,) + hi
    # SW: njs=9 lower (js+djs in [0,8]) / njs=5 upper (js+djs in [0,4])
    for band in range(16, 30):
        windows[f"sw/m2lo/{band}"] = ((s_lo - 1) * 9 + 9,) + lo
        windows[f"sw/m2hi/{band}"] = ((s_hi - 1) * 5 + 5,) + hi
    return windows


def _planck_interp_index(temperature):
    """TOTPLNK LUT index+fraction (radiation_ifs_rrtm.F90:672-690).

    Returns (0-based index, fraction)."""
    t = temperature
    ind_mid = jnp.floor(t - 159.0).astype(jnp.int32)
    frac_mid = t - jnp.floor(t)
    ind = jnp.where(t >= 339.0, 180,
                    jnp.where(t < 160.0, 1, ind_mid))
    frac = jnp.where(t >= 339.0, t - 339.0,
                     jnp.where(t < 160.0, 0.0, frac_mid))
    return ind - 1, frac


def _planck_store(totplnk, delwave, temperature, key=None, layout="cln",
                  windows=None):
    """Planck flux per LW band at given temperatures.

    temperature (...,) → (..., nbands) [cln] or, for layout="knl" with
    temperature (nlev+1, ncol), (nlev+1, nbands, ncol).  key:
    level-window key when temperature spans the level axis."""
    from ecrad_tpu.optics.rrtmg_interp import weighted_take
    totplnk = jnp.asarray(totplnk)                # (181, 16)
    delwave = jnp.asarray(delwave)
    ind, frac = _planck_interp_index(temperature)
    p = weighted_take(totplnk, [(ind, 1.0 - frac),
                                (jnp.clip(ind + 1, 0, 180), frac)],
                      key=key, layout=layout, windows=windows)
    if layout == "knl":
        return FLUXFAC * delwave[:, None] * p
    return FLUXFAC * delwave * p


@profiling.traced("radiation_ifs_rrtm:gas_optics")
def gas_optics(tables: dict, pressure_hl, temperature_hl,
               gas_mmr: dict, cos_sza=None,
               do_lw=True, do_sw=True, skin_temperature=None,
               solar_irradiance=1366.0,
               min_gas_od_lw=1.0e-15, min_gas_od_sw=0.0,
               spectral_solar_scaling=None,
               layout="cln") -> RRTMGGasOptics:
    """Full RRTMG gas optics.

    gas_mmr: dict of (ncol, nlev) MASS mixing ratios with keys
    h2o, co2, ch4, n2o, cfc11, cfc12, hcfc22, ccl4, o3 (absent → 0).

    layout="knl" emits the profile fields (od_lw, planck_hl, od_sw,
    ssa_sw) in the fused-solver kernel layout (nlev, ng, ncol) — the
    per-(col,lev) preparation still runs column-major (it is tiny) and
    is transposed once, so the (ncol·nlev·ng) fields are *written* in
    kernel layout and never relaid.  Surface fields (lw_emission,
    incoming_sw) stay (ncol, ng) in both layouts.

    Level windows are taken from tables["windows"] (set by the driver
    via compute_interp_windows) — part of the traced closure, per
    round-3 review.
    """
    windows = tables.get("windows")
    pressure_fl = 0.5 * (pressure_hl[:, :-1] + pressure_hl[:, 1:])
    temperature_fl = 0.5 * (temperature_hl[:, :-1] + temperature_hl[:, 1:])
    zero = jnp.zeros_like(pressure_fl)

    def g(name):
        return gas_mmr.get(name, zero)

    cols = prepare_columns(
        pressure_hl, pressure_fl, temperature_fl,
        g("h2o"), g("co2"), g("ch4"), g("n2o"), g("cfc11"), g("cfc12"),
        g("hcfc22"), g("ccl4"), g("o3"),
        tables["preflog"], tables["tref"], tables["chi_mls"])
    if layout == "knl":
        # relayout the small per-(col,lev) planes once (~1 MB each)
        cols = cols._replace(**{
            f: (jnp.transpose(v, (1, 2, 0)) if f == "chi_jp1" else v.T)
            for f, v in cols._asdict().items()})

    out = {}
    if do_lw:
        lw_tables = {k[3:]: v for k, v in tables.items()
                     if k.startswith("lw:")}
        lw_tables["chi_mls"] = tables["chi_mls"]
        tau_lw, pfrac = rrtmg_lw.gas_optical_depth_lw(lw_tables, cols,
                                                      layout, windows)
        out["od_lw"] = jnp.maximum(tau_lw, min_gas_od_lw)

        # Planck at half levels: each half-level pairs with the PFRAC of
        # the layer above it; TOA half-level uses the top layer
        # (radiation_ifs_rrtm.F90:712-745)
        band_from_g = jnp.asarray(tables["lw_band_from_g"])
        thl = temperature_hl.T if layout == "knl" else temperature_hl
        planck_bands_hl = _planck_store(tables["totplnk"],
                                        tables["delwave"], thl,
                                        key="lw/planck", layout=layout,
                                        windows=windows)
        from ecrad_tpu.optics.rrtmg_interp import take_bands
        planck_g_hl = take_bands(planck_bands_hl, band_from_g,
                                 layout=layout)
        if layout == "knl":
            pfrac_hl = jnp.concatenate([pfrac[:1], pfrac], axis=0)
        else:
            pfrac_hl = jnp.concatenate([pfrac[:, :1], pfrac], axis=1)
        out["planck_hl"] = planck_g_hl * pfrac_hl

        if skin_temperature is not None:
            planck_bands_surf = _planck_store(tables["totplnk"],
                                              tables["delwave"],
                                              skin_temperature)
            planck_g_surf = take_bands(planck_bands_surf, band_from_g)
            # PFRAC of the lowest model layer (radiation_ifs_rrtm.F90:453)
            pfrac_surf = pfrac[-1].T if layout == "knl" else pfrac[:, -1]
            out["lw_emission"] = planck_g_surf * pfrac_surf

    if do_sw:
        sw_tables = {k[3:]: v for k, v in tables.items()
                     if k.startswith("sw:")}
        taug, taur, sflux = rrtmg_sw.gas_optical_depth_sw(sw_tables, cols,
                                                          layout, windows)
        od_sw = taur + taug
        ssa_sw = taur / od_sw
        out["od_sw"] = jnp.maximum(od_sw, min_gas_od_sw)
        out["ssa_sw"] = ssa_sw

        if cos_sza is not None:
            day = cos_sza > 0.0
            incsol = jnp.where(day[:, None], sflux, 0.0)
            if spectral_solar_scaling is not None:
                # per-band scaling mapped to g points
                # (radiation_ifs_rrtm.F90:543-551)
                band_from_g_sw = jnp.asarray(tables["sw_band_from_g"])
                incsol = incsol * jnp.take(spectral_solar_scaling,
                                           band_from_g_sw, axis=-1)
            total = jnp.sum(incsol, axis=-1)
            scale = jnp.where(day, solar_irradiance
                              / jnp.maximum(total, 1.0e-30), 1.0)
            out["incoming_sw"] = incsol * scale[:, None]

    return RRTMGGasOptics(**out)
