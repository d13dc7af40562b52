"""RRTMG shortwave gas optical depths, Rayleigh scattering and solar
source (112 g-points over 14 bands).

Re-implementation of ifsrrtm/srtm_taumol16.F90 … srtm_taumol29.F90 +
srtm_gas_optical_depth.F90 as vectorized JAX, top-down level order, with
the reference's bottom-up LAYSOLFR ("solar source layer") search recast as
masked index arithmetic.

SW band structure (susrtm.F90 WAVENUM comments, yoesrta* headers):
  16: 2600-3250  H2O,CH4 / CH4        23: 8050-12850  H2O / —
  17: 3250-4000  H2O,CO2 / H2O,CO2    24: 12850-16000 H2O,O2 / O2 (O3 m)
  18: 4000-4650  H2O,CH4 / CH4        25: 16000-22650 H2O (O3 m) / O3
  19: 4650-5150  H2O,CO2 / CO2        26: 22650-29000 — (Rayleigh only)
  20: 5150-6150  H2O (CH4 m) / H2O    27: 29000-38000 O3 / O3
  21: 6150-7700  H2O,CO2 / H2O,CO2    28: 38000-50000 O3,O2 / O3,O2
  22: 7700-8050  H2O,O2 / O2          29:   820-2600  H2O (CO2 m) / CO2
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ecrad_tpu.optics import rrtmg_interp as ri
from ecrad_tpu.optics.rrtmg_prepare import GasColumns


def build_sw_tables(raw: dict) -> dict:
    t = {}
    for b in range(16, 30):
        p = f"sw{b:02d}/"
        for name, arr in raw.items():
            if not name.startswith(p):
                continue
            short = name[len(p):].lower()
            if short == "ka":
                t[f"{b}/ka"] = (ri.reshape_ka2(arr) if arr.ndim == 4
                                else ri.reshape_ka1(arr))
            elif short == "kb":
                t[f"{b}/kb"] = (ri.reshape_kb2(arr) if arr.ndim == 4
                                else ri.reshape_kb1(arr))
            else:
                t[f"{b}/{short}"] = arr
    return t


def _take(table, idx):
    return jnp.take(jnp.asarray(table), idx, axis=0)


def _sg(layout, x):
    return x[..., None] if layout == "cln" else x[:, None, :]


def _where_g(mask, a, b, layout="cln"):
    return jnp.where(_sg(layout, mask), a, b)


# Bands whose lower/upper major absorption is 1-key-species: their
# interpolation indices are band-independent, so the tables are batched
# into one weighted_take (rrtmg_interp.BatchedTake).  2-key SW bands each
# carry their own constant eta ratio (strrat) and cannot share js/fs.
_SW_M1_LOWER = (20, 23, 25, 27, 29)
_SW_M1_UPPER = (16, 18, 19, 20, 22, 24, 27, 29)
# Bands computing self/foreign continua (those with H2O as a key species)
_SW_SELFFOR = (16, 17, 18, 19, 20, 21, 22, 23, 24, 29)


def _shared_interp_sw(tables, cols: GasColumns, layout="cln",
                      windows=None):
    c = cols
    lay = layout

    def t(band, key):
        return tables[f"{band}/{key}"]

    b_self = ri.BatchedTake()
    b_for = ri.BatchedTake()
    b_m1lo = ri.BatchedTake()
    b_m1hi = ri.BatchedTake()
    for band in _SW_SELFFOR:
        b_self.add(band, t(band, "selfref"))
        forref = np.asarray(t(band, "forref"))
        if forref.shape[0] < 4:
            # duplicate-last-row padding == the per-band index clip
            forref = np.concatenate(
                [forref] + [forref[-1:]] * (4 - forref.shape[0]), axis=0)
        b_for.add(band, forref)
    for band in _SW_M1_LOWER:
        b_m1lo.add(band, t(band, "ka"))
    for band in _SW_M1_UPPER:
        b_m1hi.add(band, t(band, "kb"))

    w1 = c.selffac * c.selffrac
    ga = -1 if lay == "cln" else 1
    b_self.run(lambda tab: ri.weighted_take(
        tab.reshape(-1, tab.shape[-1]),
        [(c.indself, c.selffac - w1), (c.indself + 1, w1)],
        layout=lay), ga)
    w1f = c.forfac * c.forfrac
    b_for.run(lambda tab: ri.weighted_take(
        tab.reshape(-1, tab.shape[-1]),
        [(c.indfor, c.forfac - w1f), (jnp.clip(c.indfor + 1, 0, 3), w1f)],
        layout=lay), ga)
    b_m1lo.run(lambda tab: ri.major_1(
        tab, c.jp, c.jt, c.jt1, c.fac00, c.fac01, c.fac10, c.fac11,
        key="sw/m1lo", layout=lay, windows=windows), ga)
    b_m1hi.run(lambda tab: ri.major_1(
        tab, c.jp, c.jt, c.jt1, c.fac00, c.fac01, c.fac10, c.fac11,
        jp_offset=12, key="sw/m1hi", layout=lay, windows=windows), ga)
    return {"self": b_self, "for": b_for, "m1lo": b_m1lo, "m1hi": b_m1hi}


class _SwBand:
    def __init__(self, tables, cols: GasColumns, band: int, shared=None,
                 layout="cln", windows=None):
        self.t = {k.split("/", 1)[1]: v for k, v in tables.items()
                  if k.startswith(f"{band}/")}
        self.c = cols
        self.band = band
        self.sh = shared
        self.lay = layout
        self.win = windows
        # batch axes: (col, lev) [cln] / (lev, col) [knl]
        self.lev_ax = 1 if layout == "cln" else 0
        self.col_ax = 0 if layout == "cln" else 1
        # topmost lower-atmosphere layer (top-down index), per column
        self.k_trop_top = jnp.argmax(cols.tropo.astype(jnp.int32),
                                     axis=self.lev_ax)

    def s(self, x):
        return _sg(self.lay, x)

    def wg(self, a, b):
        return _where_g(self.c.tropo, a, b, self.lay)

    def gvec(self, vec):
        v = jnp.asarray(vec)
        return v if self.lay == "cln" else v[:, None]

    def zeros_g(self, ng):
        c2 = self.c.colh2o
        if self.lay == "knl":
            return jnp.zeros((c2.shape[0], ng, c2.shape[1]), c2.dtype)
        return jnp.zeros(c2.shape + (ng,), c2.dtype)

    def _shift_below(self, x):
        """Value at the layer below (top-down), duplicating the surface
        layer — the layout-general form of x[:, 1:] ++ x[:, -1:]."""
        if self.lay == "knl":
            return jnp.concatenate([x[1:], x[-1:]], axis=0)
        return jnp.concatenate([x[:, 1:], x[:, -1:]], axis=1)

    # --- major absorption -------------------------------------------------
    def major_lower_1(self):
        c = self.c
        if self.sh is not None and self.band in _SW_M1_LOWER:
            return self.sh["m1lo"].get(self.band)
        return ri.major_1(self.t["ka"], c.jp, c.jt, c.jt1,
                          c.fac00, c.fac01, c.fac10, c.fac11,
                          layout=self.lay, windows=self.win)

    def major_upper_1(self):
        c = self.c
        if self.sh is not None and self.band in _SW_M1_UPPER:
            return self.sh["m1hi"].get(self.band)
        return ri.major_1(self.t["kb"], c.jp, c.jt, c.jt1,
                          c.fac00, c.fac01, c.fac10, c.fac11, jp_offset=12,
                          layout=self.lay, windows=self.win)

    def _major_2_shared_js(self, table, col1, col2, rat, n_eta, jp_offset,
                           key=None):
        """SW 2-species interpolation: single js/fs shared by both
        pressure planes, no eta-edge corrections
        (srtm_taumol16.F90:50-103)."""
        c = self.c
        speccomb, _, js, fs = ri.spec_setup(n_eta, col1, col2, rat)
        njp, _, njs = table.shape[0], table.shape[1], table.shape[2]
        flat = jnp.asarray(table).reshape((-1,) + table.shape[3:])
        nfl = flat.shape[0]
        jp0 = jnp.clip(c.jp - jp_offset, 0, njp - 1)
        jp1 = jnp.clip(c.jp + 1 - jp_offset, 0, njp - 1)

        # 8 weighted rows assembled into one weighted_take
        pairs = []
        for djs, fsw in ((0, speccomb * (1.0 - fs)), (1, speccomb * fs)):
            for jp_s, jt_s, fac in ((jp0, c.jt, c.fac00),
                                    (jp0, c.jt + 1, c.fac10),
                                    (jp1, c.jt1, c.fac01),
                                    (jp1, c.jt1 + 1, c.fac11)):
                idx = jnp.clip((jp_s * 5 + jt_s) * njs + js + djs, 0,
                               nfl - 1)
                pairs.append((idx, fsw * fac))
        tau = ri.weighted_take(flat, pairs, key=key, layout=self.lay,
                               windows=self.win)
        return tau, js, fs

    def major_lower_2(self, col1, col2, strrat):
        return self._major_2_shared_js(self.t["ka"], col1, col2, strrat,
                                       8, 0, key=f"sw/m2lo/{self.band}")

    def major_upper_2(self, col1, col2, strrat):
        return self._major_2_shared_js(self.t["kb"], col1, col2, strrat,
                                       4, 12, key=f"sw/m2hi/{self.band}")

    # --- continua ---------------------------------------------------------
    def self_for(self):
        """colh2o * (self + foreign) — SW taumols multiply by colh2o
        explicitly (srtm_taumol16.F90:95-102)."""
        c = self.c
        if self.sh is not None:
            return self.s(c.colh2o) * (self.sh["self"].get(self.band)
                                          + self.sh["for"].get(self.band))
        tself = ri.self_continuum(self.t["selfref"], c.selffac, c.selffrac,
                                  c.indself, layout=self.lay)
        tfor = ri.foreign_continuum(self.t["forref"], c.forfac, c.forfrac,
                                    c.indfor, layout=self.lay)
        return self.s(c.colh2o) * (tself + tfor)

    def foreign_only(self):
        c = self.c
        if self.sh is not None:
            return self.s(c.colh2o) * self.sh["for"].get(self.band)
        tfor = ri.foreign_continuum(self.t["forref"], c.forfac, c.forfrac,
                                    c.indfor, layout=self.lay)
        return self.s(c.colh2o) * tfor

    # --- Rayleigh ---------------------------------------------------------
    def taur_const(self):
        ng = self.t["sfluxref"].shape[0]
        rayl = jnp.full((ng,), float(self.t["rayl"]))
        return self.s(self.c.colmol) * self.gvec(rayl)

    def taur_per_g(self, key="rayl"):
        return self.s(self.c.colmol) * self.gvec(self.t[key])

    # --- solar source layer -----------------------------------------------
    def solfr_lower(self):
        """Top-down index of the solar-source layer for bands whose
        reference level is tropospheric (srtm_taumol18.F90 pattern)."""
        c = self.c
        layreffr = int(self.t["layreffr"])
        jp1b = c.jp + 1                       # 1-based jp
        jp_below = self._shift_below(jp1b)
        tropo_below = self._shift_below(c.tropo)
        cross = (tropo_below & (jp1b >= layreffr) & (jp_below < layreffr))
        k_cross = jnp.argmax(cross.astype(jnp.int32), axis=self.lev_ax)
        has = jnp.any(cross, axis=self.lev_ax)
        k = jnp.where(has, k_cross, self.k_trop_top)
        # laysolfr = min(i+1, laytrop) bottom-up → top-down clamp so the
        # source layer is never above the topmost tropospheric layer
        return jnp.maximum(k, self.k_trop_top)

    def solfr_upper(self):
        """Solar-source layer for stratospheric reference bands
        (srtm_taumol16.F90:115-122)."""
        c = self.c
        layreffr = int(self.t["layreffr"])
        jp1b = c.jp + 1
        jp_below = self._shift_below(jp1b)
        cross = ((~c.tropo) & (jp1b >= layreffr) & (jp_below < layreffr))
        k_cross = jnp.argmax(cross.astype(jnp.int32), axis=self.lev_ax)
        has = jnp.any(cross, axis=self.lev_ax)
        return jnp.where(has, k_cross, 0)     # default: top layer

    def sflux_const(self):
        ncol = self.c.colh2o.shape[self.col_ax]
        return jnp.broadcast_to(jnp.asarray(self.t["sfluxref"]),
                                (ncol,) + self.t["sfluxref"].shape)

    def sflux_eta(self, js, fs, k_sol):
        """Eta-interpolated solar source at the source layer.

        sfluxref (ng, n_eta+1); js/fs batch-2D; k_sol (ncol,).
        Returns (ncol, ng) — solar source arrays stay column-major in
        both layouts."""
        sf = jnp.asarray(self.t["sfluxref"])       # (ng, njs)
        if self.lay == "knl":
            js_sol = jnp.take_along_axis(js, k_sol[None, :], axis=0)[0]
            fs_sol = jnp.take_along_axis(fs, k_sol[None, :], axis=0)[0]
        else:
            js_sol = jnp.take_along_axis(js, k_sol[:, None], axis=1)[:, 0]
            fs_sol = jnp.take_along_axis(fs, k_sol[:, None], axis=1)[:, 0]
        f0 = jnp.moveaxis(jnp.take(sf, js_sol, axis=1), 0, -1)
        f1 = jnp.moveaxis(jnp.take(sf, jnp.clip(js_sol + 1,
                                                0, sf.shape[1] - 1),
                                   axis=1), 0, -1)
        return f0 + fs_sol[..., None] * (f1 - f0)


# ---------------------------------------------------------------------------

def _band16(tb):
    c = tb.c
    tau_lo, _, _ = tb.major_lower_2(c.colh2o, c.colch4,
                                    float(tb.t["strrat1"]))
    tau_lo = tau_lo + tb.self_for()
    tau_hi = tb.s(c.colch4) * tb.major_upper_1()
    tau = tb.wg( tau_lo, tau_hi)
    return tau, tb.taur_const(), tb.sflux_const()


def _band17(tb):
    c = tb.c
    strrat = float(tb.t["strrat"])
    tau_lo, _, _ = tb.major_lower_2(c.colh2o, c.colco2, strrat)
    tau_lo = tau_lo + tb.self_for()
    tau_hi, js_hi, fs_hi = tb.major_upper_2(c.colh2o, c.colco2, strrat)
    tau_hi = tau_hi + tb.foreign_only()
    tau = tb.wg( tau_lo, tau_hi)
    sflux = tb.sflux_eta(js_hi, fs_hi, tb.solfr_upper())
    return tau, tb.taur_const(), sflux


def _band18(tb):
    c = tb.c
    tau_lo, js, fs = tb.major_lower_2(c.colh2o, c.colch4,
                                      float(tb.t["strrat"]))
    tau_lo = tau_lo + tb.self_for()
    tau_hi = tb.s(c.colch4) * tb.major_upper_1()
    tau = tb.wg( tau_lo, tau_hi)
    sflux = tb.sflux_eta(js, fs, tb.solfr_lower())
    return tau, tb.taur_const(), sflux


def _band19(tb):
    c = tb.c
    tau_lo, js, fs = tb.major_lower_2(c.colh2o, c.colco2,
                                      float(tb.t["strrat"]))
    tau_lo = tau_lo + tb.self_for()
    tau_hi = tb.s(c.colco2) * tb.major_upper_1()
    tau = tb.wg( tau_lo, tau_hi)
    sflux = tb.sflux_eta(js, fs, tb.solfr_lower())
    return tau, tb.taur_const(), sflux


def _band20(tb):
    c = tb.c
    absch4 = tb.gvec(tb.t["absch4"])
    tau_lo = (tb.s(c.colh2o) * tb.major_lower_1() + tb.self_for()
              + tb.s(c.colch4) * absch4)
    tau_hi = (tb.s(c.colh2o) * tb.major_upper_1() + tb.foreign_only()
              + tb.s(c.colch4) * absch4)
    tau = tb.wg( tau_lo, tau_hi)
    return tau, tb.taur_const(), tb.sflux_const()


def _band21(tb):
    c = tb.c
    strrat = float(tb.t["strrat"])
    tau_lo, js, fs = tb.major_lower_2(c.colh2o, c.colco2, strrat)
    tau_lo = tau_lo + tb.self_for()
    tau_hi, _, _ = tb.major_upper_2(c.colh2o, c.colco2, strrat)
    tau_hi = tau_hi + tb.foreign_only()
    tau = tb.wg( tau_lo, tau_hi)
    sflux = tb.sflux_eta(js, fs, tb.solfr_lower())
    return tau, tb.taur_const(), sflux


def _band22(tb):
    c = tb.c
    o2adj = 1.6
    strrat = float(tb.t["strrat"])
    o2cont = tb.s(4.35e-4 * c.colo2 / (350.0 * 2.0))
    tau_lo, js, fs = tb.major_lower_2(c.colh2o, c.colo2, o2adj * strrat)
    tau_lo = tau_lo + tb.self_for() + o2cont
    tau_hi = (tb.s(c.colo2) * o2adj * tb.major_upper_1() + o2cont)
    tau = tb.wg( tau_lo, tau_hi)
    sflux = tb.sflux_eta(js, fs, tb.solfr_lower())
    return tau, tb.taur_const(), sflux


def _band23(tb):
    c = tb.c
    givfac = float(tb.t["givfac"])
    tau_lo = (givfac * tb.s(c.colh2o) * tb.major_lower_1()
              + tb.self_for())
    tau_hi = jnp.zeros_like(tau_lo)
    tau = tb.wg( tau_lo, tau_hi)
    return tau, tb.taur_per_g(), tb.sflux_const()


def _band24(tb):
    c = tb.c
    tau_lo, js, fs = tb.major_lower_2(c.colh2o, c.colo2,
                                      float(tb.t["strrat"]))
    tau_lo = (tau_lo + tb.s(c.colo3) * tb.gvec(tb.t["abso3a"])
              + tb.self_for())
    tau_hi = (tb.s(c.colo2) * tb.major_upper_1()
              + tb.s(c.colo3) * tb.gvec(tb.t["abso3b"]))
    tau = tb.wg( tau_lo, tau_hi)
    # Rayleigh: eta-dependent in lower (RAYLA (ng,9)), constant-g upper
    rayla = jnp.asarray(tb.t["rayla"]).T         # (9, ng)
    ray = ri.weighted_take(rayla, [
        (js, 1.0 - fs), (jnp.clip(js + 1, 0, 8), fs)], layout=tb.lay)
    taur_lo = tb.s(c.colmol) * ray
    taur_hi = tb.s(c.colmol) * tb.gvec(tb.t["raylb"])
    taur = tb.wg( taur_lo, taur_hi)
    sflux = tb.sflux_eta(js, fs, tb.solfr_lower())
    return tau, taur, sflux


def _band25(tb):
    c = tb.c
    tau_lo = (tb.s(c.colh2o) * tb.major_lower_1()
              + tb.s(c.colo3) * tb.gvec(tb.t["abso3a"]))
    tau_hi = tb.s(c.colo3) * tb.gvec(tb.t["abso3b"])
    tau = tb.wg( tau_lo, tau_hi)
    return tau, tb.taur_per_g(), tb.sflux_const()


def _band26(tb):
    c = tb.c
    ng = tb.t["sfluxref"].shape[0]
    tau = tb.zeros_g(ng)
    return tau, tb.taur_per_g(), tb.sflux_const()


def _band27(tb):
    c = tb.c
    tau_lo = tb.s(c.colo3) * tb.major_lower_1()
    tau_hi = tb.s(c.colo3) * tb.major_upper_1()
    tau = tb.wg( tau_lo, tau_hi)
    sflux = tb.sflux_const() * float(tb.t["scalekur"])
    return tau, tb.taur_per_g(), sflux


def _band28(tb):
    c = tb.c
    strrat = float(tb.t["strrat"])
    tau_lo, _, _ = tb.major_lower_2(c.colo3, c.colo2, strrat)
    tau_hi, js_hi, fs_hi = tb.major_upper_2(c.colo3, c.colo2, strrat)
    tau = tb.wg( tau_lo, tau_hi)
    sflux = tb.sflux_eta(js_hi, fs_hi, tb.solfr_upper())
    return tau, tb.taur_const(), sflux


def _band29(tb):
    c = tb.c
    tau_lo = (tb.s(c.colh2o) * tb.major_lower_1() + tb.self_for()
              + tb.s(c.colco2) * tb.gvec(tb.t["absco2"]))
    tau_hi = (tb.s(c.colco2) * tb.major_upper_1()
              + tb.s(c.colh2o) * tb.gvec(tb.t["absh2o"]))
    tau = tb.wg( tau_lo, tau_hi)
    return tau, tb.taur_const(), tb.sflux_const()


_SW_BAND_FNS = {16: _band16, 17: _band17, 18: _band18, 19: _band19,
                20: _band20, 21: _band21, 22: _band22, 23: _band23,
                24: _band24, 25: _band25, 26: _band26, 27: _band27,
                28: _band28, 29: _band29}


def gas_optical_depth_sw(tables: dict, cols: GasColumns, layout="cln",
                         windows=None):
    """All 14 SW bands → (taug, taur, sfluxzen).

    taug/taur: (ncol, nlev, 112) [cln] or (nlev, 112, ncol) [knl];
    sfluxzen: (ncol, 112) in both layouts.
    Equivalent of ifsrrtm/srtm_gas_optical_depth.F90 (which also converts
    to od = taug + taur and ssa = taur/od — done in rrtmg.py here).
    """
    shared = _shared_interp_sw(tables, cols, layout, windows)
    g_axis = -1 if layout == "cln" else 1
    taugs, taurs, sfluxes = [], [], []
    for b in range(16, 30):
        tb = _SwBand(tables, cols, b, shared, layout, windows)
        taug, taur, sflux = _SW_BAND_FNS[b](tb)
        taugs.append(taug)
        taurs.append(taur)
        sfluxes.append(sflux)
    return (jnp.concatenate(taugs, axis=g_axis),
            jnp.concatenate(taurs, axis=g_axis),
            jnp.concatenate(sfluxes, axis=-1))
