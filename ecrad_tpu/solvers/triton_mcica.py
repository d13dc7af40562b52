"""Fused McICA solver sweeps as Pallas kernels on the Triton route.

Reference decomposition: radiation_mcica_lw.F90:39-285 and
radiation_mcica_sw.F90:41-410 compute per-g-point layer optics
(radiation_two_stream.F90), merge cloud properties into the gas optics
for cloudy layers, then run the adding sweeps
(radiation_adding_ica_{sw,lw}.F90).  The plain XLA path (mcica.py +
adding.py) stores reflectance, transmittance and sources for clear and
total sky as (ncol, nlev, ng) arrays and runs each sweep as a 137-step
while loop of small fusions.  Here one program owns a tile of
``gb`` g-points by ``cb`` columns over all levels: it reads the optical
inputs (gas od/ssa/g, per-band cloud properties, od scaling), recomputes
the layer coefficients in registers at each level, and carries the
sweep state through a ``fori_loop`` over levels.  Only what the next
sweep needs (the direct beam above each layer, the albedo and source
below it) goes back to device memory.

Layout: arrays are (nlev, ng, ncol) with columns contiguous, so every
load of a (gb, cb) tile coalesces; per-band cloud arrays are
(nlev, nband, ncol) and are gathered per g-point through ``band_of_g``;
the cloud mask is (nlev, ncol); per-column planes are (ng, ncol).  Tiles
are powers of two with masks for the g tail (ng = 140 LW, 112 SW) and
the column tail.  Broadband sums over g come out as one partial per
g-tile, (ngt, nlev, ncol), which the caller sums: deterministic, unlike
atomics.

Numerics: the per-level math calls the same functions as the plain path
(two_stream.py, the merge formulas of mcica.py), so the two agree to
roundoff.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ecrad_tpu import backend
from ecrad_tpu.solvers import two_stream

# Tile and launch shape: the fastest of tools/tune_sweeps.py on an H100
# at the flagship widths (ncol 16384, nlev 137, ng 140/112).
G_TILE = 8
COL_TILE = 32
NUM_WARPS = 4
NUM_STAGES = 1


def _cdiv(a, b):
    return -(-a // b)


class _Tile:
    """Indices, masks and masked loads/stores of one program's
    (gb, cb) tile."""

    def __init__(self, band_ref, ng, ncol, gb, cb):
        self.j = pl.program_id(0)
        i = pl.program_id(1)
        self.g0 = self.j * gb
        self.c0 = i * cb
        self.gb, self.cb = gb, cb
        g = self.g0 + jnp.arange(gb, dtype=jnp.int32)
        c = self.c0 + jnp.arange(cb, dtype=jnp.int32)
        self.cmask = c < ncol
        self.mask = (g < ng)[:, None] & self.cmask[None, :]
        self.band = band_ref[pl.ds(self.g0, gb)][:, None]
        self.col = jnp.minimum(c, ncol - 1)[None, :]

    def gsl(self):
        return pl.ds(self.g0, self.gb)

    def csl(self):
        return pl.ds(self.c0, self.cb)

    def load(self, ref, l, other=0.0):
        """(gb, cb) tile of a (nlev, ng, ncol) array at level l."""
        return plgpu.load(ref.at[l, self.gsl(), self.csl()],
                          mask=self.mask, other=other)

    def load_band(self, ref, l):
        """(gb, cb) tile of a (nlev, nband, ncol) array, expanded to
        g-points through band_of_g."""
        return plgpu.load(ref.at[l, self.band, self.col], mask=self.mask,
                          other=0.0)

    def load_row(self, ref, l, other=0.0):
        """(1, cb) slice of a (nlev, ncol) array at level l."""
        return plgpu.load(ref.at[l, self.csl()], mask=self.cmask,
                          other=other)[None, :]

    def load_plane(self, ref, other=0.0):
        """(gb, cb) tile of a (ng, ncol) array."""
        return plgpu.load(ref.at[self.gsl(), self.csl()], mask=self.mask,
                          other=other)

    def store(self, ref, l, val):
        plgpu.store(ref.at[l, self.gsl(), self.csl()], val, mask=self.mask)

    def store_plane(self, ref, val):
        plgpu.store(ref.at[self.gsl(), self.csl()], val, mask=self.mask)

    def store_sum(self, ref, l, val):
        """This tile's sum over g of val into the (ngt, nlev, ncol)
        partials at level l."""
        s = jnp.sum(jnp.where(self.mask, val, 0.0), axis=0)
        plgpu.store(ref.at[self.j, l, self.csl()], s, mask=self.cmask)


def _levels(nlev, body, init, reverse=False):
    """fori_loop over levels, top-down (or bottom-up when reverse)."""
    if reverse:
        def step(k, carry):
            return body(nlev - 1 - k, carry)
    else:
        step = body
    return jax.lax.fori_loop(jnp.int32(0), jnp.int32(nlev), step, init)


def _merge_lw(od, odc_g, ssac_g, gc_g, mask):
    """Total-sky LW merge for cloudy layers
    (radiation_mcica_lw.F90:133-171, cloud scattering on, aerosol
    scattering off); the expressions of mcica._merge_cloud_lw."""
    od_total = od + jnp.where(mask, odc_g, 0.0)
    scat = jnp.where(mask, ssac_g * odc_g, 0.0)
    gscat = jnp.where(mask, gc_g * ssac_g * odc_g, 0.0)
    ssa_total = jnp.where(od_total > 0.0,
                          scat / jnp.maximum(od_total, 1e-300), 0.0)
    g_total = jnp.where(scat > 0.0, gscat / jnp.maximum(scat, 1e-300), 0.0)
    return od_total, ssa_total, g_total


def _merge_sw(od, ssa, g, odc_g, ssac_g, gc_g, mask):
    """Total-sky SW merge (the expressions of mcica.solver_mcica_sw)."""
    od_tot = od + jnp.where(mask, odc_g, 0.0)
    scat = ssa * od + jnp.where(mask, ssac_g * odc_g, 0.0)
    gscat = g * ssa * od + jnp.where(mask, gc_g * ssac_g * odc_g, 0.0)
    ssa_tot = jnp.where(od_tot > 0.0,
                        scat / jnp.maximum(od_tot, 1e-300), 0.0)
    g_tot = jnp.where(scat > 0.0, gscat / jnp.maximum(scat, 1e-300), 0.0)
    return od_tot, ssa_tot, g_tot


# ===========================================================================
# LW
# ===========================================================================


def _lw_layer(t, l, od_ref, odscal_ref, odcb_ref, ssacb_ref, gcb_ref,
              mask_ref, planck_ref):
    """Clear-sky no-scattering and total-sky blended layer
    coefficients at level l."""
    od = t.load(od_ref, l)
    ptop = t.load(planck_ref, l)
    pbot = t.load(planck_ref, l + 1)
    trans_c, s_up_c, s_dn_c = two_stream.lw_no_scattering_trans(
        od, ptop, pbot)
    odc_g = t.load(odscal_ref, l) * t.load_band(odcb_ref, l)
    ssac_g = t.load_band(ssacb_ref, l)
    gc_g = t.load_band(gcb_ref, l)
    mask = t.load_row(mask_ref, l) != 0.0
    od_t, ssa_t, g_t = _merge_lw(od, odc_g, ssac_g, gc_g, mask)
    refl_m, trans_m, s_up_m, s_dn_m = two_stream.lw_ref_trans(
        od_t, ssa_t, g_t, ptop, pbot)
    refl = jnp.where(mask, refl_m, 0.0)
    trans = jnp.where(mask, trans_m, trans_c)
    s_up = jnp.where(mask, s_up_m, s_up_c)
    s_dn = jnp.where(mask, s_dn_m, s_dn_c)
    return (trans_c, s_up_c, s_dn_c), (refl, trans, s_up, s_dn)


def _lw_up_kernel(dims, band_ref, od_ref, odscal_ref, odcb_ref, ssacb_ref,
                  gcb_ref, mask_ref, planck_ref, emis_ref, alb_ref,
                  dn_bb_c_ref, fdn_surf_c_ref, fup_surf_c_ref, up_bb_c_ref,
                  fup_toa_c_ref, albb_ref, srcb_ref, src_top_t_ref):
    """Clear-sky downward sweep, then the clear-sky upward sweep and the
    total-sky Möbius up-sweep (radiation_adding_ica_lw.F90:32-134,
    272-334) sharing one read of the optics per level."""
    nlev, ng, ncol, gb, cb = dims
    t = _Tile(band_ref, ng, ncol, gb, cb)
    dt = od_ref.dtype

    def down(l, fdn):
        od = t.load(od_ref, l)
        trans_c, _, s_dn_c = two_stream.lw_no_scattering_trans(
            od, t.load(planck_ref, l), t.load(planck_ref, l + 1))
        fdn = trans_c * fdn + s_dn_c
        t.store_sum(dn_bb_c_ref, l, fdn)
        return fdn

    fdn_surf = _levels(nlev, down, jnp.zeros((gb, cb), dt))
    emission = t.load_plane(emis_ref)
    albedo = t.load_plane(alb_ref)
    fup_surf = emission + albedo * fdn_surf
    t.store_plane(fdn_surf_c_ref, fdn_surf)
    t.store_plane(fup_surf_c_ref, fup_surf)

    def up(l, carry):
        fup, alb, src = carry
        (trans_c, s_up_c, _), (refl, trans, s_up, s_dn) = _lw_layer(
            t, l, od_ref, odscal_ref, odcb_ref, ssacb_ref, gcb_ref,
            mask_ref, planck_ref)
        fup = trans_c * fup + s_up_c
        t.store_sum(up_bb_c_ref, l, fup)
        t.store(albb_ref, l, alb)
        t.store(srcb_ref, l, src)
        inv = 1.0 / (1.0 - alb * refl)
        src = s_up + trans * (src + alb * s_dn) * inv
        alb = refl + trans * trans * alb * inv
        return fup, alb, src

    fup_toa, _, src_top = _levels(nlev, up, (fup_surf, albedo, emission),
                                  reverse=True)
    t.store_plane(fup_toa_c_ref, fup_toa)
    t.store_plane(src_top_t_ref, src_top)


def _lw_dn_kernel(dims, do_derivatives, band_ref, od_ref, odscal_ref,
                  odcb_ref, ssacb_ref, gcb_ref, mask_ref, planck_ref,
                  emis_ref, alb_ref, albb_ref, srcb_ref, fup_surf_c_ref,
                  dn_bb_t_ref, up_bb_t_ref, fdn_surf_t_ref, fup_surf_t_ref,
                  *deriv_refs):
    """Total-sky downward sweep (adding_ica_lw.F90 downward half); then,
    if asked, the Hogan-Bozzo derivative up-sweep for both scenes
    (radiation_lw_derivatives.F90:43-83), unnormalised: the caller
    divides by the g-sum of the surface upwelling flux."""
    nlev, ng, ncol, gb, cb = dims
    t = _Tile(band_ref, ng, ncol, gb, cb)
    dt = od_ref.dtype
    layer = functools.partial(_lw_layer, t, od_ref=od_ref,
                              odscal_ref=odscal_ref, odcb_ref=odcb_ref,
                              ssacb_ref=ssacb_ref, gcb_ref=gcb_ref,
                              mask_ref=mask_ref, planck_ref=planck_ref)

    def down(l, fdn):
        _, (refl, trans, _, s_dn) = layer(l)
        alb_below = t.load(albb_ref, l)
        src_below = t.load(srcb_ref, l)
        inv = 1.0 / (1.0 - alb_below * refl)
        fdn = (trans * fdn + refl * src_below + s_dn) * inv
        t.store_sum(dn_bb_t_ref, l, fdn)
        t.store_sum(up_bb_t_ref, l, alb_below * fdn + src_below)
        return fdn

    fdn_surf = _levels(nlev, down, jnp.zeros((gb, cb), dt))
    fup_surf = t.load_plane(alb_ref) * fdn_surf + t.load_plane(emis_ref)
    t.store_plane(fdn_surf_t_ref, fdn_surf)
    t.store_plane(fup_surf_t_ref, fup_surf)
    if not do_derivatives:
        return
    deriv_c_ref, deriv_t_ref = deriv_refs

    def up(l, carry):
        dc, dtot = carry
        (trans_c, _, _), (_, trans_t, _, _) = layer(l)
        dc = dc * trans_c
        dtot = dtot * trans_t
        t.store_sum(deriv_c_ref, l, dc)
        t.store_sum(deriv_t_ref, l, dtot)
        return dc, dtot

    _levels(nlev, up, (t.load_plane(fup_surf_c_ref), fup_surf),
            reverse=True)


def _call(kernel, grid, out_shape, args):
    c = backend.choices()
    return pl.pallas_call(
        kernel, grid=grid, out_shape=out_shape, backend="triton",
        interpret=c.interpret,
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
    )(*args)


def _band_index(band_of_g, ngt, gb):
    bfg = np.asarray(band_of_g, np.int32)
    return jnp.asarray(np.pad(bfg, (0, ngt * gb - bfg.shape[0])))


def lw_sweeps(od, odc_b, ssac_b, gc_b, od_scaling, mask, planck_hl,
              emission, albedo, band_of_g, do_derivatives,
              gb=None, cb=None):
    """Fused LW McICA sweeps.

    Args: od/od_scaling (nlev, ng, ncol); odc_b/ssac_b/gc_b
    (nlev, nband, ncol); mask (nlev, ncol) 0/1; planck_hl
    (nlev+1, ng, ncol); emission/albedo (ng, ncol); band_of_g (ng,)
    static, 0-based.

    Returns a dict of clear and total-sky outputs: broadband profiles
    (nlev, ncol) and per-g boundary planes (ng, ncol)."""
    nlev, ng, ncol = od.shape
    gb = gb or G_TILE
    cb = cb or COL_TILE
    ngt = _cdiv(ng, gb)
    grid = (ngt, _cdiv(ncol, cb))
    dims = (nlev, ng, ncol, gb, cb)
    dt = od.dtype
    band = _band_index(band_of_g, ngt, gb)
    bb = jax.ShapeDtypeStruct((ngt, nlev, ncol), dt)
    plane = jax.ShapeDtypeStruct((ng, ncol), dt)
    big = jax.ShapeDtypeStruct((nlev, ng, ncol), dt)
    optics = (band, od, od_scaling, odc_b, ssac_b, gc_b, mask, planck_hl,
              emission, albedo)

    (dn_bb_c, fdn_surf_c, fup_surf_c, up_bb_c, fup_toa_c, albb, srcb,
     src_top_t) = _call(
        functools.partial(_lw_up_kernel, dims), grid,
        (bb, plane, plane, bb, plane, big, big, plane), optics)

    outs = (bb, bb, plane, plane) + ((bb, bb) if do_derivatives else ())
    r = _call(functools.partial(_lw_dn_kernel, dims, do_derivatives),
              grid, outs, optics + (albb, srcb, fup_surf_c))
    dn_bb_t, up_bb_t, fdn_surf_t, fup_surf_t = r[:4]
    out = dict(dn_bb_c=dn_bb_c.sum(0), fdn_surf_c=fdn_surf_c,
               up_bb_c=up_bb_c.sum(0), fup_toa_c=fup_toa_c,
               fup_surf_c=fup_surf_c, src_top_t=src_top_t,
               dn_bb_t=dn_bb_t.sum(0), up_bb_t=up_bb_t.sum(0),
               fdn_surf_t=fdn_surf_t, fup_surf_t=fup_surf_t)
    if do_derivatives:
        tiny = jnp.asarray(1e-30, dt)
        norm_c = jnp.maximum(jnp.sum(fup_surf_c, axis=0), tiny)
        norm_t = jnp.maximum(jnp.sum(fup_surf_t, axis=0), tiny)
        out["deriv_c"] = r[4].sum(0) / norm_c
        out["deriv_t"] = r[5].sum(0) / norm_t
    return out


# ===========================================================================
# SW
# ===========================================================================


def _sw_props(t, l, delta_gases, od_ref, ssa_ref, g_ref, odscal_ref,
              odcb_ref, ssacb_ref, gcb_ref, mask_ref):
    """Clear and total-sky (od, ssa, g) at level l, delta-scaled when
    the gases are."""
    od = t.load(od_ref, l)
    ssa = t.load(ssa_ref, l)
    g = t.load(g_ref, l)
    odc_g = t.load(odscal_ref, l) * t.load_band(odcb_ref, l)
    ssac_g = t.load_band(ssacb_ref, l)
    gc_g = t.load_band(gcb_ref, l)
    mask = t.load_row(mask_ref, l) != 0.0
    tot = _merge_sw(od, ssa, g, odc_g, ssac_g, gc_g, mask)
    clear = (od, ssa, g)
    if delta_gases:
        clear = two_stream.delta_eddington(*clear)
        tot = two_stream.delta_eddington(*tot)
    return clear, tot, mask


def _sw_coeffs(t, l, mu0, delta_gases, refs):
    """Clear and total-sky Meador-Weaver coefficients at level l
    (reflectance, transmittance, ref_dir, trans_dir_diff,
    trans_dir_dir)."""
    clear, tot, mask = _sw_props(t, l, delta_gases, *refs)
    cl = two_stream.sw_ref_trans(mu0, *clear)
    mg = two_stream.sw_ref_trans(mu0, *tot)
    return cl, tuple(jnp.where(mask, m, c) for m, c in zip(mg, cl))


def _sw_dir_kernel(dims, delta_gases, band_ref, od_ref, ssa_ref, g_ref,
                   odscal_ref, odcb_ref, ssacb_ref, gcb_ref, mask_ref,
                   mu0_ref, inc_ref, ftc_ref, ftt_ref, dir_bb_c_ref,
                   dir_bb_t_ref, fdir_surf_c_ref, fdir_surf_t_ref):
    """Direct-beam downward sweep for both scenes; stores the direct
    flux above each layer for the diffuse sweeps."""
    nlev, ng, ncol, gb, cb = dims
    t = _Tile(band_ref, ng, ncol, gb, cb)
    mu0 = plgpu.load(mu0_ref.at[t.csl()], mask=t.cmask, other=1.0)[None, :]
    refs = (od_ref, ssa_ref, g_ref, odscal_ref, odcb_ref, ssacb_ref,
            gcb_ref, mask_ref)

    def down(l, carry):
        fc, ft = carry
        if delta_gases:
            (od_c, _, _), (od_t, _, _), mask = _sw_props(
                t, l, delta_gases, *refs)
        else:
            od_c = t.load(od_ref, l)
            mask = t.load_row(mask_ref, l) != 0.0
            od_t = od_c + jnp.where(
                mask, t.load(odscal_ref, l) * t.load_band(odcb_ref, l),
                0.0)
        t.store(ftc_ref, l, fc)
        t.store(ftt_ref, l, ft)
        fc = two_stream.sw_direct_trans(mu0, od_c) * fc
        ft = jnp.where(mask, two_stream.sw_direct_trans(mu0, od_t),
                       two_stream.sw_direct_trans(mu0, od_c)) * ft
        t.store_sum(dir_bb_c_ref, l, fc)
        t.store_sum(dir_bb_t_ref, l, ft)
        return fc, ft

    inc = t.load_plane(inc_ref)
    fc, ft = _levels(nlev, down, (inc, inc))
    t.store_plane(fdir_surf_c_ref, fc)
    t.store_plane(fdir_surf_t_ref, ft)


def _sw_up_kernel(dims, delta_gases, band_ref, od_ref, ssa_ref, g_ref,
                  odscal_ref, odcb_ref, ssacb_ref, gcb_ref, mask_ref,
                  mu0_ref, ftc_ref, ftt_ref, fdir_surf_c_ref,
                  fdir_surf_t_ref, alb_dif_ref, alb_dir_mu0_ref,
                  albb_c_ref, srcb_c_ref, albb_t_ref, srcb_t_ref,
                  src_top_c_ref, src_top_t_ref):
    """Upward Möbius sweep for both scenes
    (radiation_adding_ica_sw.F90:24-153 up-sweep)."""
    nlev, ng, ncol, gb, cb = dims
    t = _Tile(band_ref, ng, ncol, gb, cb)
    mu0 = plgpu.load(mu0_ref.at[t.csl()], mask=t.cmask, other=1.0)[None, :]
    refs = (od_ref, ssa_ref, g_ref, odscal_ref, odcb_ref, ssacb_ref,
            gcb_ref, mask_ref)

    def advance(coeffs, fdir_top, alb, src):
        refl, trans, rdir, tdif, _ = coeffs
        inv = 1.0 / (1.0 - alb * refl)
        src = rdir * fdir_top + trans * (src + alb * tdif * fdir_top) * inv
        alb = refl + trans * trans * alb * inv
        return alb, src

    def up(l, carry):
        alb_c, src_c, alb_t, src_t = carry
        cl, tot = _sw_coeffs(t, l, mu0, delta_gases, refs)
        t.store(albb_c_ref, l, alb_c)
        t.store(srcb_c_ref, l, src_c)
        t.store(albb_t_ref, l, alb_t)
        t.store(srcb_t_ref, l, src_t)
        alb_c, src_c = advance(cl, t.load(ftc_ref, l), alb_c, src_c)
        alb_t, src_t = advance(tot, t.load(ftt_ref, l), alb_t, src_t)
        return alb_c, src_c, alb_t, src_t

    alb0 = t.load_plane(alb_dif_ref)
    albd = t.load_plane(alb_dir_mu0_ref)
    init = (alb0, albd * t.load_plane(fdir_surf_c_ref),
            alb0, albd * t.load_plane(fdir_surf_t_ref))
    _, src_c, _, src_t = _levels(nlev, up, init, reverse=True)
    t.store_plane(src_top_c_ref, src_c)
    t.store_plane(src_top_t_ref, src_t)


def _sw_dn_kernel(dims, delta_gases, band_ref, od_ref, ssa_ref, g_ref,
                  odscal_ref, odcb_ref, ssacb_ref, gcb_ref, mask_ref,
                  mu0_ref, ftc_ref, ftt_ref, albb_c_ref, srcb_c_ref,
                  albb_t_ref, srcb_t_ref, dn_bb_c_ref, up_bb_c_ref,
                  dn_bb_t_ref, up_bb_t_ref, fdn_surf_c_ref,
                  fdn_surf_t_ref):
    """Downward diffuse sweep for both scenes, emitting broadband
    profiles (radiation_adding_ica_sw.F90:24-153 down-sweep)."""
    nlev, ng, ncol, gb, cb = dims
    t = _Tile(band_ref, ng, ncol, gb, cb)
    mu0 = plgpu.load(mu0_ref.at[t.csl()], mask=t.cmask, other=1.0)[None, :]
    refs = (od_ref, ssa_ref, g_ref, odscal_ref, odcb_ref, ssacb_ref,
            gcb_ref, mask_ref)

    def advance(l, coeffs, fdir_top, fdn, albb_ref, srcb_ref, dn_ref,
                up_ref):
        refl, trans, _, tdif, _ = coeffs
        alb_below = t.load(albb_ref, l)
        src_below = t.load(srcb_ref, l)
        inv = 1.0 / (1.0 - alb_below * refl)
        fdn = (trans * fdn + refl * src_below + tdif * fdir_top) * inv
        t.store_sum(dn_ref, l, fdn)
        t.store_sum(up_ref, l, alb_below * fdn + src_below)
        return fdn

    def down(l, carry):
        fdn_c, fdn_t = carry
        cl, tot = _sw_coeffs(t, l, mu0, delta_gases, refs)
        fdn_c = advance(l, cl, t.load(ftc_ref, l), fdn_c, albb_c_ref,
                        srcb_c_ref, dn_bb_c_ref, up_bb_c_ref)
        fdn_t = advance(l, tot, t.load(ftt_ref, l), fdn_t, albb_t_ref,
                        srcb_t_ref, dn_bb_t_ref, up_bb_t_ref)
        return fdn_c, fdn_t

    zeros = jnp.zeros((gb, cb), od_ref.dtype)
    fdn_c, fdn_t = _levels(nlev, down, (zeros, zeros))
    t.store_plane(fdn_surf_c_ref, fdn_c)
    t.store_plane(fdn_surf_t_ref, fdn_t)


def sw_sweeps(od, ssa, g, odc_b, ssac_b, gc_b, od_scaling, mask, mu0,
              incoming, alb_dif, alb_dir_mu0, band_of_g, delta_gases,
              gb=None, cb=None):
    """Fused SW McICA sweeps.

    Args: od/ssa/g/od_scaling (nlev, ng, ncol); odc_b/ssac_b/gc_b
    (nlev, nband, ncol); mask (nlev, ncol) 0/1; mu0 (ncol,) clamped;
    incoming/alb_dif/alb_dir_mu0 (ng, ncol); band_of_g (ng,) static."""
    nlev, ng, ncol = od.shape
    gb = gb or G_TILE
    cb = cb or COL_TILE
    ngt = _cdiv(ng, gb)
    grid = (ngt, _cdiv(ncol, cb))
    dims = (nlev, ng, ncol, gb, cb)
    dt = od.dtype
    band = _band_index(band_of_g, ngt, gb)
    bb = jax.ShapeDtypeStruct((ngt, nlev, ncol), dt)
    plane = jax.ShapeDtypeStruct((ng, ncol), dt)
    big = jax.ShapeDtypeStruct((nlev, ng, ncol), dt)
    optics = (band, od, ssa, g, od_scaling, odc_b, ssac_b, gc_b, mask, mu0)

    ftc, ftt, dir_bb_c, dir_bb_t, fdir_surf_c, fdir_surf_t = _call(
        functools.partial(_sw_dir_kernel, dims, delta_gases), grid,
        (big, big, bb, bb, plane, plane), optics + (incoming,))
    albb_c, srcb_c, albb_t, srcb_t, src_top_c, src_top_t = _call(
        functools.partial(_sw_up_kernel, dims, delta_gases), grid,
        (big, big, big, big, plane, plane),
        optics + (ftc, ftt, fdir_surf_c, fdir_surf_t, alb_dif,
                  alb_dir_mu0))
    dn_bb_c, up_bb_c, dn_bb_t, up_bb_t, fdn_surf_c, fdn_surf_t = _call(
        functools.partial(_sw_dn_kernel, dims, delta_gases), grid,
        (bb, bb, bb, bb, plane, plane),
        optics + (ftc, ftt, albb_c, srcb_c, albb_t, srcb_t))
    return dict(
        dir_bb_c=dir_bb_c.sum(0), dir_bb_t=dir_bb_t.sum(0),
        fdir_surf_c=fdir_surf_c, fdir_surf_t=fdir_surf_t,
        src_top_c=src_top_c, src_top_t=src_top_t,
        dn_bb_c=dn_bb_c.sum(0), up_bb_c=up_bb_c.sum(0),
        dn_bb_t=dn_bb_t.sum(0), up_bb_t=up_bb_t.sum(0),
        fdn_surf_c=fdn_surf_c, fdn_surf_t=fdn_surf_t)
