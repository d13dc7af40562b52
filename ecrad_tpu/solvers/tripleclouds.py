"""Tripleclouds solver (Shonk & Hogan 2008): 3 regions per layer — clear +
two cloudy regions with different optical depths.

Reference: radiation_tripleclouds_sw.F90:42-663,
radiation_tripleclouds_lw.F90:38-607, radiation_regions.F90:35-202,
radiation_overlap.F90:64-459.

Batched formulation: the reference's per-column branches (is_clear_sky_layer,
i_cloud_top short-cuts) become masked dense compute; region-coupled
adding runs as a lax.scan over levels carrying (ncol, ng, nreg) states.
The region axis (3) is unrolled into the vector ops; the interface
mixing is an einsum over the tiny region axis.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ecrad_tpu.config import Config, PdfShape
from ecrad_tpu.solvers import two_stream
from ecrad_tpu.solvers.outputs import LwFluxes, SwFluxes
from ecrad_tpu import profiling


def _einsum(spec, a, b):
    """Region-axis contraction at full f32 precision (never TF32)."""
    return jnp.einsum(spec, a, b, precision=jax.lax.Precision.HIGHEST)


def _reduce_regions(x, spec_matrix):
    """(ncol, nreg, ng) → (broadband (ncol,), spectral (ncol, nspec))."""
    y = jnp.sum(x, axis=1)
    bb = jnp.sum(y, axis=-1)
    sp = None if spec_matrix is None else jnp.matmul(
        y, spec_matrix, precision=jax.lax.Precision.HIGHEST)
    return bb, sp


def _stack_prof(top, levels):
    """top (ncol, ...) + levels (nlev, ncol, ...) → (ncol, nlev+1, ...)."""
    return jnp.moveaxis(jnp.concatenate([top[None], levels], axis=0), 0, 1)

# radiation_regions.F90:10-18
MIN_GAMMA_OD_SCALING = 0.025
MIN_LOWER_FRAC = 0.5
MAX_LOWER_FRAC = 0.9
FSD_AT_MIN_LOWER_FRAC = 1.5
FSD_AT_MAX_LOWER_FRAC = 3.725
_GRAD = (MAX_LOWER_FRAC - MIN_LOWER_FRAC) / (FSD_AT_MAX_LOWER_FRAC
                                             - FSD_AT_MIN_LOWER_FRAC)
_INTERCEPT = MIN_LOWER_FRAC - FSD_AT_MIN_LOWER_FRAC * _GRAD


def calc_region_properties(cloud_fraction, frac_std, do_gamma,
                           frac_threshold=1.0e-20, n_regions=3):
    """radiation_regions.F90:35-202.

    Returns (reg_fracs (ncol,nlev,3), od_scaling (ncol,nlev,2)).

    n_regions=2 (radiation_regions.F90:105-111): a single HOMOGENEOUS
    cloudy region — expressed in the 3-region machinery as region 2 =
    full cloud fraction with od_scaling 1 and region 3 empty, which is
    exactly equivalent downstream (zero-fraction regions carry no flux
    and are masked out of the overlap matrices)."""
    cf = cloud_fraction
    cloudy = cf >= frac_threshold
    if n_regions == 2:
        frac1 = jnp.where(cloudy, 1.0 - cf, 1.0)
        frac2 = jnp.where(cloudy, cf, 0.0)
        zero = jnp.zeros_like(cf)
        one = jnp.ones_like(cf)
        return (jnp.stack([frac1, frac2, zero], axis=-1),
                jnp.stack([one, one], axis=-1))
    if n_regions != 3:
        raise NotImplementedError(
            f"n_regions={n_regions} not supported (reference allows "
            "2 or 3, radiation_regions.F90:105-202)")
    if do_gamma:
        frac2 = cf * jnp.clip(_INTERCEPT + frac_std * _GRAD,
                              MIN_LOWER_FRAC, MAX_LOWER_FRAC)
        scale2 = MIN_GAMMA_OD_SCALING + (1.0 - MIN_GAMMA_OD_SCALING) \
            * jnp.exp(-frac_std * (1.0 + 0.5 * frac_std
                                   * (1.0 + 0.5 * frac_std)))
        frac3 = cf - frac2
        scale3 = (cf - frac2 * scale2) / jnp.maximum(frac3, 1.0e-30)
    else:
        frac2 = cf * 0.5
        s = jnp.sqrt(frac_std ** 2 + 1.0)
        scale2 = jnp.exp(-jnp.sqrt(jnp.log(frac_std ** 2 + 1.0))) / s
        frac3 = cf * 0.5
        scale3 = 2.0 - scale2

    frac1 = jnp.where(cloudy, 1.0 - cf, 1.0)
    frac2 = jnp.where(cloudy, frac2, 0.0)
    frac3 = jnp.where(cloudy, frac3, 0.0)
    scale2 = jnp.where(cloudy, scale2, 1.0)
    scale3 = jnp.where(cloudy, scale3, 1.0)
    reg_fracs = jnp.stack([frac1, frac2, frac3], axis=-1)
    od_scaling = jnp.stack([scale2, scale3], axis=-1)
    return reg_fracs, od_scaling


def calc_overlap_matrices(reg_fracs, overlap_param, decorr_scaling,
                          frac_threshold=1.0e-20):
    """radiation_overlap.F90:280-459 (alpha overlap, nreg=3).

    reg_fracs (ncol, nlev, 3); overlap_param (ncol, nlev-1).
    Returns (u_matrix, v_matrix) each (ncol, nlev+1, 3, 3), and
    cloud_cover (ncol,).

    Matrix layout: overlap_matrix[upper, lower];
    u[upper,lower] = ov/frac_lower; v[lower,upper] = ov/frac_upper.
    """
    ncol, nlev, nreg = reg_fracs.shape
    one = jnp.ones((ncol, 1))
    zero = jnp.zeros((ncol, 1))
    # frac_upper at interface j (0..nlev): layer above (clear-sky at TOA)
    fu = jnp.concatenate(
        [jnp.stack([one, zero, zero], -1), reg_fracs], axis=1)
    # frac_lower: layer below (clear-sky below surface)
    fl = jnp.concatenate(
        [reg_fracs, jnp.stack([one, zero, zero], -1)], axis=1)
    # op at interface: 1 at TOA and surface
    op1 = jnp.concatenate([jnp.ones((ncol, 1)), overlap_param,
                           jnp.ones((ncol, 1))], axis=1)
    op_inhom = jnp.where(op1 >= 0.0,
                         jnp.maximum(op1, 1e-30) ** (1.0 / decorr_scaling),
                         op1)

    cf_u = fu[..., 1] + fu[..., 2]
    cf_l = fl[..., 1] + fl[..., 2]
    pcc = op1 * jnp.maximum(cf_u, cf_l) \
        + (1.0 - op1) * (cf_u + cf_l - cf_u * cf_l)

    ov = jnp.zeros(fu.shape[:-1] + (nreg, nreg), reg_fracs.dtype)
    ov = ov.at[..., 0, 0].set(1.0 - pcc)
    inv_l = 1.0 / jnp.maximum(cf_l, 1.0e-6)
    ov = ov.at[..., 0, 1].set((pcc - cf_u) * fl[..., 1] * inv_l)
    ov = ov.at[..., 0, 2].set((pcc - cf_u) * fl[..., 2] * inv_l)
    inv_u = 1.0 / jnp.maximum(cf_u, 1.0e-6)
    ov = ov.at[..., 1, 0].set((pcc - cf_l) * fu[..., 1] * inv_u)
    ov = ov.at[..., 2, 0].set((pcc - cf_l) * fu[..., 2] * inv_u)
    frac_both = cf_u + cf_l - pcc
    # within-cloud overlap of the optically-thick regions
    cu = fu[..., 2] * inv_u
    cl = fl[..., 2] * inv_l
    pcc2 = op_inhom * jnp.maximum(cu, cl) \
        + (1.0 - op_inhom) * (cu + cl - cu * cl)
    ov = ov.at[..., 1, 1].set(frac_both * (1.0 - pcc2))
    ov = ov.at[..., 1, 2].set(frac_both * (pcc2 - cu))
    ov = ov.at[..., 2, 1].set(frac_both * (pcc2 - cl))
    ov = ov.at[..., 2, 2].set(frac_both * (cu + cl - pcc2))

    fl_ok = fl >= frac_threshold
    fu_ok = fu >= frac_threshold
    # u[upper, lower]; v[lower, upper]
    u_matrix = jnp.where(fl_ok[..., None, :],
                         ov / jnp.maximum(fl[..., None, :], 1e-30), 0.0)
    v_matrix = jnp.where(fu_ok[..., None, :],
                         jnp.swapaxes(ov, -1, -2)
                         / jnp.maximum(fu[..., None, :], 1e-30), 0.0)
    cloud_cover = 1.0 - jnp.prod(v_matrix[..., 0, 0], axis=1)
    return u_matrix, v_matrix, cloud_cover


def _merge_regions(od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b,
                   band_from_g, od_scaling_reg):
    """Clear-sky + scaled-cloud optical properties for cloudy regions.

    od/ssa/g (ncol,nlev,ng); *_cloud_b (ncol,nlev,nband);
    od_scaling_reg (ncol,nlev,2).
    Returns od/ssa/g with extra region axis (ncol,nlev,2,ng)."""
    bb = jnp.asarray(band_from_g)
    odc = jnp.take(od_cloud_b, bb, axis=-1)[..., None, :] \
        * od_scaling_reg[..., :, None]
    ssac = jnp.take(ssa_cloud_b, bb, axis=-1)[..., None, :]
    gc = jnp.take(g_cloud_b, bb, axis=-1)[..., None, :]
    scat_clear = (ssa * od)[..., None, :]
    scat_cloud = ssac * odc
    od_tot = od[..., None, :] + odc
    scat = scat_clear + scat_cloud
    ssa_tot = scat / jnp.maximum(od_tot, 1e-300)
    g_tot = (g[..., None, :] * scat_clear + gc * scat_cloud) \
        / jnp.maximum(scat, 1e-300)
    return od_tot, ssa_tot, g_tot


@profiling.traced("radiation_tripleclouds_sw:solver_tripleclouds_sw")
def solver_tripleclouds_sw(config: Config, od, ssa, g, od_cloud_b,
                           ssa_cloud_b, g_cloud_b, band_from_g,
                           cloud_fraction, fractional_std, overlap_param,
                           incoming_sw, cos_sza, albedo_diffuse,
                           albedo_direct, spec_matrix=None) -> SwFluxes:
    """radiation_tripleclouds_sw.F90:42-663 (batched, dense)."""
    ncol, nlev, ng = od.shape
    nreg = 3
    mu0 = jnp.maximum(cos_sza, 1.0e-10)[:, None, None]

    reg_fracs, od_scaling = calc_region_properties(
        cloud_fraction, fractional_std,
        config.cloud_pdf_shape == PdfShape.GAMMA,
        config.cloud_fraction_threshold,
        n_regions=config.nregions)
    u_mat, v_mat, cloud_cover = calc_overlap_matrices(
        reg_fracs, overlap_param, config.cloud_inhom_decorr_scaling,
        config.cloud_fraction_threshold)

    clear_layer = cloud_fraction <= 0.0                 # (ncol, nlev)

    # layer properties: region 0 = clear
    r_cl, t_cl, rd_cl, tdd_cl, tdir_cl = two_stream.sw_ref_trans(
        mu0, od, ssa, g)
    od_r, ssa_r, g_r = _merge_regions(od, ssa, g, od_cloud_b, ssa_cloud_b,
                                      g_cloud_b, band_from_g, od_scaling)
    if config.do_sw_delta_scaling_with_gases:
        od_r, ssa_r, g_r = two_stream.delta_eddington(od_r, ssa_r, g_r)
    r_c, t_c, rd_c, tdd_c, tdir_c = two_stream.sw_ref_trans(
        mu0[..., None], od_r, ssa_r, g_r)

    def with_regions(clear, cloudy2):
        """(ncol,nlev,ng) + (ncol,nlev,2,ng) → (ncol,nlev,3,ng), zeroing
        cloudy regions in clear layers."""
        m = clear_layer[..., None, None]
        cl2 = jnp.where(m, 0.0, cloudy2)
        return jnp.concatenate([clear[..., None, :], cl2], axis=-2)

    refl = with_regions(r_cl, r_c)
    trans = with_regions(t_cl, t_c)
    ref_dir = with_regions(rd_cl, rd_c)
    tdd = with_regions(tdd_cl, tdd_c)
    tdir = with_regions(tdir_cl, tdir_c)

    # clear-clear masks for interface mixing
    clear_pad = jnp.concatenate(
        [jnp.ones((ncol, 1), bool), clear_layer,
         jnp.ones((ncol, 1), bool)], axis=1)     # layer index -1..nlev

    lev = lambda a: jnp.moveaxis(a, 1, 0)

    # ---- upward sweep: total albedo (diffuse + direct) per region
    alb_surf = jnp.broadcast_to(albedo_diffuse[:, None, :],
                                (ncol, nreg, ng))
    albd_surf = jnp.broadcast_to((cos_sza[:, None] * albedo_direct)
                                 [:, None, :], (ncol, nreg, ng))
    # regions >=2 active at surface only if layer nlev-1 cloudy
    low_cloudy = ~clear_layer[:, -1]
    mask_srf = jnp.concatenate(
        [jnp.ones((ncol, 1), bool),
         jnp.broadcast_to(low_cloudy[:, None], (ncol, 2))], axis=1)
    alb_init = jnp.where(mask_srf[..., None], alb_surf, 0.0)
    albd_init = jnp.where(mask_srf[..., None], albd_surf, 0.0)

    def up_step(carry, x):
        alb_below, albd_below = carry          # (ncol, nreg, ng)
        (refl_l, trans_l, rdir_l, tdd_l, tdir_l, v_l, cc_this,
         cc_above) = x
        inv_denom = 1.0 / (1.0 - alb_below * refl_l)
        alb = refl_l + trans_l * trans_l * alb_below * inv_denom
        albd = rdir_l + (tdir_l * albd_below + tdd_l * alb_below) \
            * trans_l * inv_denom
        # zero cloudy regions for clear layers
        m = cc_this[:, None, None] & (jnp.arange(nreg) > 0)[None, :, None]
        alb = jnp.where(m, 0.0, alb)
        albd = jnp.where(m, 0.0, albd)
        # interface mixing with v_matrix at this layer's top interface
        # unless this layer and the one above are both clear
        mixed_alb = _einsum("clr,clg->crg", v_l, alb)
        mixed_albd = _einsum("clr,clg->crg", v_l, albd)
        skip = (cc_this & cc_above)[:, None, None]
        alb_out = jnp.where(skip, alb, mixed_alb)
        albd_out = jnp.where(skip, albd, mixed_albd)
        return (alb_out, albd_out), (alb_below, albd_below, inv_denom)

    xs = (lev(refl), lev(trans), lev(ref_dir), lev(tdd), lev(tdir),
          lev(v_mat[:, :-1]),                   # v at layer top interface
          lev(clear_pad[:, 1:-1]), lev(clear_pad[:, :-2]))
    (alb_top, albd_top), (alb_below_s, albd_below_s, inv_denom_s) = \
        jax.lax.scan(up_step, (alb_init, albd_init), xs, reverse=True)

    # ---- clear-sky 1-region fluxes (standard adding, reduced)
    from ecrad_tpu.solvers import adding
    clear = adding.adding_sw_reduced(
        incoming_sw, albedo_diffuse, albedo_direct,
        jnp.maximum(cos_sza, 1.0e-10)[:, None],
        r_cl, t_cl, rd_cl, tdd_cl, tdir_cl, spec_matrix)

    # ---- downward sweep, emitting spectrally-reduced fluxes per level;
    # the pre-mixing surface slices ride in the carry
    fdir0 = incoming_sw[:, None, :] * reg_fracs[:, 0, :, None]
    fdn0 = jnp.zeros_like(fdir0)
    fup0 = fdir0 * albd_top

    def dn_step(carry, x):
        (fdn, fdir), _ = carry
        (refl_l, trans_l, rdir_l, tdd_l, tdir_l, alb_below, albd_below,
         v_below, cc_this, cc_below) = x
        fdn = (trans_l * fdn + fdir
               * (tdir_l * albd_below * refl_l + tdd_l)) \
            / (1.0 - refl_l * alb_below)
        fdir = tdir_l * fdir
        fup = fdir * albd_below + fdn * alb_below
        m = cc_this[:, None, None] & (jnp.arange(nreg) > 0)[None, :, None]
        fdn = jnp.where(m, 0.0, fdn)
        fdir = jnp.where(m, 0.0, fdir)
        fup = jnp.where(m, 0.0, fup)
        up_bb, up_sp = _reduce_regions(fup, spec_matrix)
        dn_bb, dn_sp = _reduce_regions(fdn, spec_matrix)
        dir_bb, dir_sp = _reduce_regions(fdir, spec_matrix)
        slices = (jnp.sum(fup, 1), jnp.sum(fdn, 1), jnp.sum(fdir, 1))
        # mix through the interface BELOW this layer
        skip = (cc_this & cc_below)[:, None, None]
        fdn_m = _einsum("clr,crg->clg", v_below, fdn)
        fdir_m = _einsum("clr,crg->clg", v_below, fdir)
        fdn_out = jnp.where(skip, fdn, fdn_m)
        fdir_out = jnp.where(skip, fdir, fdir_m)
        return (((fdn_out, fdir_out), slices),
                (up_bb, dn_bb, dir_bb, up_sp, dn_sp, dir_sp))

    xs2 = (lev(refl), lev(trans), lev(ref_dir), lev(tdd), lev(tdir),
           alb_below_s, albd_below_s, lev(v_mat[:, 1:]),
           lev(clear_pad[:, 1:-1]), lev(clear_pad[:, 2:]))
    zslice = jnp.zeros((ncol, ng), od.dtype)
    ((_, _), (fup_surf_g, fdn_surf_g, fdir_surf_g)), \
        (up_bb, dn_bb, dir_bb, up_sp, dn_sp, dir_sp) = jax.lax.scan(
            dn_step, ((fdn0, fdir0), (zslice, zslice, zslice)), xs2)

    day = (cos_sza > 0.0)

    def zn(x):
        if x is None:
            return None
        d = day.reshape(day.shape + (1,) * (x.ndim - 1))
        return jnp.where(d, x, 0.0)

    mu0p = jnp.maximum(cos_sza, 0.0)
    up0_bb, up0_sp = _reduce_regions(fup0, spec_matrix)
    dir0_bb, dir0_sp = _reduce_regions(fdir0, spec_matrix)
    fup_bb = _stack_prof(up0_bb, up_bb)
    fdn_diff_bb = _stack_prof(jnp.zeros_like(up0_bb), dn_bb)
    fdir_bb = mu0p[:, None] * _stack_prof(dir0_bb, dir_bb)
    fdir_surf_g = mu0p[:, None] * fdir_surf_g

    out = SwFluxes(
        flux_up=zn(fup_bb),
        flux_dn=zn(fdn_diff_bb + fdir_bb),
        flux_dn_direct=zn(fdir_bb),
        flux_up_clear=zn(clear.up),
        flux_dn_clear=zn(clear.dn_diffuse + clear.dn_direct),
        flux_dn_direct_clear=zn(clear.dn_direct),
        sw_dn_diffuse_surf_g=zn(fdn_surf_g),
        sw_dn_direct_surf_g=zn(fdir_surf_g),
        sw_up_toa_g=zn(jnp.sum(fup0, axis=1)),
        sw_dn_diffuse_surf_clear_g=zn(clear.dn_diffuse_surf_g),
        sw_dn_direct_surf_clear_g=zn(clear.dn_direct_surf_g),
        sw_up_toa_clear_g=zn(clear.up_toa_g),
        # Tripleclouds assigns cloud cover for all columns, including
        # night (calc_overlap_matrices runs before the mu0 check)
        cloud_cover=cloud_cover)
    if spec_matrix is not None:
        clear_dn_sp = clear.dn_diffuse_s + clear.dn_direct_s
        fup_sp = _stack_prof(up0_sp, up_sp)
        fdn_diff_sp = _stack_prof(jnp.zeros_like(up0_sp), dn_sp)
        fdir_sp = mu0p[:, None, None] * _stack_prof(dir0_sp, dir_sp)
        out = out._replace(
            flux_up_s=zn(fup_sp),
            flux_dn_s=zn(fdn_diff_sp + fdir_sp),
            flux_dn_direct_s=zn(fdir_sp),
            flux_up_clear_s=zn(clear.up_s),
            flux_dn_clear_s=zn(clear_dn_sp),
            flux_dn_direct_clear_s=zn(clear.dn_direct_s))
    return out


@profiling.traced("radiation_tripleclouds_lw:solver_tripleclouds_lw")
def solver_tripleclouds_lw(config: Config, od, ssa, g, od_cloud_b,
                           ssa_cloud_b, g_cloud_b, band_from_g,
                           cloud_fraction, fractional_std, overlap_param,
                           planck_hl, emission, albedo,
                           spec_matrix=None) -> LwFluxes:
    """radiation_tripleclouds_lw.F90:38-607 (batched, dense)."""
    ncol, nlev, ng = od.shape
    nreg = 3

    reg_fracs, od_scaling = calc_region_properties(
        cloud_fraction, fractional_std,
        config.cloud_pdf_shape == PdfShape.GAMMA,
        config.cloud_fraction_threshold,
        n_regions=config.nregions)
    u_mat, v_mat, cloud_cover = calc_overlap_matrices(
        reg_fracs, overlap_param, config.cloud_inhom_decorr_scaling,
        config.cloud_fraction_threshold)

    clear_layer = cloud_fraction <= 0.0
    planck_top, planck_bot = planck_hl[:, :-1], planck_hl[:, 1:]

    # clear-sky (region 1) properties + fluxes
    if config.do_lw_aerosol_scattering:
        r_cl, t_cl, su_cl, sd_cl = two_stream.lw_ref_trans(
            od, ssa, g, planck_top, planck_bot)
    else:
        t_cl, su_cl, sd_cl = two_stream.lw_no_scattering_trans(
            od, planck_top, planck_bot)
        r_cl = jnp.zeros_like(t_cl)

    from ecrad_tpu.solvers import adding
    if config.do_lw_aerosol_scattering:
        clear = adding.adding_lw_reduced(
            r_cl, t_cl, su_cl, sd_cl, emission, albedo, spec_matrix)
    else:
        clear = adding.lw_no_scattering_reduced(
            t_cl, su_cl, sd_cl, emission, albedo, spec_matrix)

    # cloudy regions
    od_r, ssa_r, g_r = _merge_regions(
        od, ssa if config.do_lw_aerosol_scattering else jnp.zeros_like(od),
        g if config.do_lw_aerosol_scattering else jnp.zeros_like(od),
        od_cloud_b, ssa_cloud_b, g_cloud_b, band_from_g, od_scaling)
    pt = planck_top[..., None, :]
    pb = planck_bot[..., None, :]
    if config.do_lw_cloud_scattering:
        r_c, t_c, su_c, sd_c = two_stream.lw_ref_trans(
            od_r, ssa_r, g_r, pt, pb)
    else:
        t_c, su_c, sd_c = two_stream.lw_no_scattering_trans(od_r, pt, pb)
        r_c = jnp.zeros_like(t_c)

    def with_regions(clear, cloudy2, clear_fill=0.0):
        m = clear_layer[..., None, None]
        cl2 = jnp.where(m, clear_fill, cloudy2)
        return jnp.concatenate([clear[..., None, :], cl2], axis=-2)

    refl = with_regions(r_cl, r_c)
    trans = with_regions(t_cl, t_c, clear_fill=1.0)
    # sources scaled by region fraction (tripleclouds_lw.F90:200-204)
    rf = reg_fracs[..., None]                   # (ncol, nlev, 3, 1)
    src_up = with_regions(su_cl, su_c) * rf
    src_dn = with_regions(sd_cl, sd_c) * rf

    clear_pad = jnp.concatenate(
        [jnp.ones((ncol, 1), bool), clear_layer,
         jnp.ones((ncol, 1), bool)], axis=1)

    lev = lambda a: jnp.moveaxis(a, 1, 0)

    # ---- upward sweep: albedo + source per region
    alb_init = jnp.broadcast_to(albedo[:, None, :], (ncol, nreg, ng))
    src_init = reg_fracs[:, -1, :, None] * emission[:, None, :]

    def up_step(carry, x):
        alb_below, src_below = carry
        refl_l, trans_l, su_l, sd_l, u_l, v_l, cc_this, cc_above = x
        inv_denom = 1.0 / (1.0 - alb_below * refl_l)
        alb = refl_l + trans_l * trans_l * alb_below * inv_denom
        src = su_l + trans_l * (src_below + alb_below * sd_l) * inv_denom
        # total_source upsweep mixes with u[upper, lower]
        # (tripleclouds_lw.F90:248-250)
        mixed_src = _einsum("cul,clg->cug", u_l, src)
        mixed_alb = _einsum("clr,clg->crg", v_l, alb)
        skip = (cc_this & cc_above)[:, None, None]
        alb_out = jnp.where(skip, alb, mixed_alb)
        src_out = jnp.where(skip, src, mixed_src)
        return (alb_out, src_out), (alb_below, src_below, inv_denom)

    xs = (lev(refl), lev(trans), lev(src_up), lev(src_dn),
          lev(u_mat[:, :-1]), lev(v_mat[:, :-1]),
          lev(clear_pad[:, 1:-1]), lev(clear_pad[:, :-2]))
    (alb_top, src_top), (alb_below_s, src_below_s, inv_denom_s) = \
        jax.lax.scan(up_step, (alb_init, src_init), xs, reverse=True)

    # ---- downward sweep, emitting spectrally-reduced fluxes per level
    fdn0 = jnp.zeros((ncol, nreg, ng), od.dtype)
    fup0 = src_top + alb_top * fdn0

    def dn_step(carry, x):
        fdn, _ = carry
        (refl_l, trans_l, sd_l, alb_below, src_below, v_below, cc_this,
         cc_below) = x
        fdn = (trans_l * fdn + refl_l * src_below + sd_l) \
            / (1.0 - refl_l * alb_below)
        fup = src_below + fdn * alb_below
        m = cc_this[:, None, None] & (jnp.arange(nreg) > 0)[None, :, None]
        fdn = jnp.where(m, 0.0, fdn)
        fup = jnp.where(m, 0.0, fup)
        up_bb, up_sp = _reduce_regions(fup, spec_matrix)
        dn_bb, dn_sp = _reduce_regions(fdn, spec_matrix)
        slices = (jnp.sum(fup, 1), jnp.sum(fdn, 1))
        skip = (cc_this & cc_below)[:, None, None]
        fdn_m = _einsum("clr,crg->clg", v_below, fdn)
        fdn_out = jnp.where(skip, fdn, fdn_m)
        return (fdn_out, slices), (up_bb, dn_bb, up_sp, dn_sp)

    xs2 = (lev(refl), lev(trans), lev(src_dn), alb_below_s, src_below_s,
           lev(v_mat[:, 1:]), lev(clear_pad[:, 1:-1]),
           lev(clear_pad[:, 2:]))
    zslice = jnp.zeros((ncol, ng), od.dtype)
    (_, (fup_surf_g, fdn_surf_g)), (up_bb, dn_bb, up_sp, dn_sp) = \
        jax.lax.scan(dn_step, (fdn0, (zslice, zslice)), xs2)

    up0_bb, up0_sp = _reduce_regions(fup0, spec_matrix)
    fup_bb = _stack_prof(up0_bb, up_bb)
    fdn_bb = _stack_prof(jnp.zeros_like(up0_bb), dn_bb)

    out = LwFluxes(
        flux_up=fup_bb,
        flux_dn=fdn_bb,
        flux_up_clear=clear.up,
        flux_dn_clear=clear.dn,
        lw_dn_surf_g=fdn_surf_g, lw_up_toa_g=jnp.sum(fup0, axis=1),
        lw_dn_surf_clear_g=clear.dn_surf_g,
        lw_up_toa_clear_g=clear.up_toa_g,
        cloud_cover=cloud_cover,
        flux_up_clear_s=clear.up_s, flux_dn_clear_s=clear.dn_s)
    if spec_matrix is not None:
        out = out._replace(
            flux_up_s=_stack_prof(up0_sp, up_sp),
            flux_dn_s=_stack_prof(jnp.zeros_like(up0_sp), dn_sp))

    if config.do_lw_derivatives:
        # Region-coupled Hogan-Bozzo derivatives
        # (radiation_lw_derivatives.F90:200-250
        # calc_lw_derivatives_region): propagate the per-region spectral
        # derivative upward through u-matrix mixing + transmittance
        fup_surf = fup_surf_g
        deriv0 = jnp.concatenate(
            [(fup_surf / jnp.sum(fup_surf, axis=-1,
                                 keepdims=True))[:, None, :],
             jnp.zeros((ncol, nreg - 1, ng), od.dtype)], axis=1)

        def deriv_step(dg, x):
            trans_l, u_below = x
            dg = _einsum("cul,clg->cug", u_below, dg) * trans_l
            return dg, jnp.sum(dg, axis=(1, 2))

        xs3 = (lev(trans), lev(u_mat[:, 1:]))
        _, deriv_levels = jax.lax.scan(deriv_step, deriv0, xs3,
                                       reverse=True)
        deriv = jnp.concatenate(
            [jnp.moveaxis(deriv_levels, 0, 1),
             jnp.ones((ncol, 1), od.dtype)], axis=1)
        out = out._replace(lw_derivatives=deriv)
    return out
