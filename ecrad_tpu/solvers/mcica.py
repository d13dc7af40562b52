"""McICA (Monte Carlo Independent Column Approximation) solvers.

Reference: radiation_mcica_lw.F90:39-285, radiation_mcica_sw.F90:41-410.

The stochastic cloud sample (``od_scaling`` per g-point/layer and
``total_cloud_cover``) is an *input* here: it is produced either by the
bit-exact host generator (solvers/cloud_generator_exact.py, used for
golden-file validation) or the on-device counter-based generator
(solvers/cloud_generator.py).  Everything else is batched JAX identical in
structure to the cloudless solver, with clear/cloudy layer properties
merged by masks rather than the reference's per-column branches.

Flux outputs follow the reduced contract of solvers/outputs.py: broadband
profiles + surface/TOA g slices (+ optional spectrally-projected
profiles), with the g-sums computed inside the vertical scans — the
reference optimizes exactly this reduction (radiation_mcica_sw.F90:
185-222) because the g axis dominates the flux-array footprint.
"""

from __future__ import annotations

import jax.numpy as jnp

from ecrad_tpu import backend
from ecrad_tpu.optics.rrtmg_interp import take_bands
from ecrad_tpu.solvers import adding, two_stream, triton_mcica
from ecrad_tpu.solvers.adding import (LwAdding, SwAdding, _stack_bot,
                                      _stack_top)
from ecrad_tpu.solvers.lw_derivatives import lw_derivatives_ica
from ecrad_tpu.solvers.outputs import LwFluxes, SwFluxes
from ecrad_tpu import profiling


def _use_fused(spec_matrix):
    """The fused Triton sweeps (solvers/triton_mcica.py) serve the
    reduced (no spectral-profile) contract where the backend chooses
    them."""
    return spec_matrix is None and backend.choices().sweeps == "triton"


def _mix(w, cloudy, clear):
    """total_cloud_cover-weighted scene blend, broadcasting w over
    trailing axes (radiation_mcica_lw.F90:236-248)."""
    if cloudy is None:
        return None
    w = w.reshape(w.shape + (1,) * (cloudy.ndim - 1))
    return w * cloudy + (1.0 - w) * clear


def _merge_cloud_lw(od_clear, od_cloud_g, cloudy_mask,
                    ssa_cloud_g=None, g_cloud_g=None,
                    ssa_clear=None, g_clear=None,
                    do_cloud_scattering=True,
                    do_aerosol_scattering=False):
    """Merge gas(+aerosol) and cloud optical properties per g-point
    (radiation_mcica_lw.F90:133-171)."""
    m = cloudy_mask[..., None]
    od_total = od_clear + jnp.where(m, od_cloud_g, 0.0)
    if not do_cloud_scattering:
        return od_total, None, None
    if do_aerosol_scattering:
        scat = ssa_clear * od_clear + jnp.where(
            m, ssa_cloud_g * od_cloud_g, 0.0)
        gscat = (g_clear * ssa_clear * od_clear
                 + jnp.where(m, g_cloud_g * ssa_cloud_g * od_cloud_g, 0.0))
    else:
        scat = jnp.where(m, ssa_cloud_g * od_cloud_g, 0.0)
        gscat = jnp.where(m, g_cloud_g * ssa_cloud_g * od_cloud_g, 0.0)
    ssa_total = jnp.where(od_total > 0.0,
                          scat / jnp.maximum(od_total, 1e-300), 0.0)
    g_total = jnp.where(scat > 0.0,
                        gscat / jnp.maximum(scat, 1e-300), 0.0)
    return od_total, ssa_total, g_total


@profiling.traced("radiation_mcica_lw:solver_mcica_lw")
def solver_mcica_lw(od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b,
                    band_from_g, od_scaling, total_cloud_cover,
                    cloud_fraction, planck_hl, emission, albedo,
                    cloud_fraction_threshold=1.0e-6,
                    do_lw_cloud_scattering=True,
                    do_lw_aerosol_scattering=False,
                    do_lw_derivatives=False,
                    spec_matrix=None, layout="cln") -> LwFluxes:
    """Args:
      od/ssa/g: clear-sky (gas+aerosol) (ncol, nlev, ng), or
        (nlev, ng, ncol) with layout="knl" (kernel layout, fused path
        only; od_scaling/planck_hl likewise)
      od_cloud_b/...: in-cloud per band (ncol, nlev, nband)
      band_from_g: (ng,) 0-based
      od_scaling: (ncol, nlev, ng); total_cloud_cover (ncol,)
      cloud_fraction: (ncol, nlev)
      spec_matrix: optional (ng, nspec) projection for spectral profiles
    """
    fused = (_use_fused(spec_matrix) and do_lw_cloud_scattering
             and not do_lw_aerosol_scattering)
    if layout == "knl" and not fused:
        raise ValueError(
            "kernel-layout inputs require the fused-solver configuration")
    if fused:
        return _solver_mcica_lw_fused(
            od, od_cloud_b, ssa_cloud_b, g_cloud_b, band_from_g,
            od_scaling, total_cloud_cover, cloud_fraction, planck_hl,
            emission, albedo, cloud_fraction_threshold,
            do_lw_derivatives, layout=layout)
    planck_top, planck_bot = planck_hl[:, :-1], planck_hl[:, 1:]
    bb = jnp.asarray(band_from_g)

    # --- clear sky
    if do_lw_aerosol_scattering:
        ref_clear, trans_clear, src_up_clear, src_dn_clear = \
            two_stream.lw_ref_trans(od, ssa, g, planck_top, planck_bot)
        clear = adding.adding_lw_reduced(
            ref_clear, trans_clear, src_up_clear, src_dn_clear,
            emission, albedo, spec_matrix)
    else:
        trans_clear, src_up_clear, src_dn_clear = \
            two_stream.lw_no_scattering_trans(od, planck_top, planck_bot)
        ref_clear = jnp.zeros_like(trans_clear)
        clear = adding.lw_no_scattering_reduced(
            trans_clear, src_up_clear, src_dn_clear, emission, albedo,
            spec_matrix)

    # --- total sky
    cloudy_layer = cloud_fraction >= cloud_fraction_threshold
    od_cloud_g = od_scaling * take_bands(od_cloud_b, bb)
    od_total, ssa_total, g_total = _merge_cloud_lw(
        od, od_cloud_g, cloudy_layer,
        ssa_cloud_g=take_bands(ssa_cloud_b, bb)
        if ssa_cloud_b is not None else None,
        g_cloud_g=take_bands(g_cloud_b, bb)
        if g_cloud_b is not None else None,
        ssa_clear=ssa, g_clear=g,
        do_cloud_scattering=do_lw_cloud_scattering,
        do_aerosol_scattering=do_lw_aerosol_scattering)

    mask = cloudy_layer[..., None]
    if do_lw_cloud_scattering:
        refl_c, trans_c, src_up_c, src_dn_c = two_stream.lw_ref_trans(
            od_total, ssa_total, g_total, planck_top, planck_bot)
        refl = jnp.where(mask, refl_c, ref_clear)
        trans = jnp.where(mask, trans_c, trans_clear)
        src_up = jnp.where(mask, src_up_c, src_up_clear)
        src_dn = jnp.where(mask, src_dn_c, src_dn_clear)
        tot = adding.adding_lw_reduced(refl, trans, src_up, src_dn,
                                       emission, albedo, spec_matrix)
    else:
        trans_c, src_up_c, src_dn_c = \
            two_stream.lw_no_scattering_trans(od_total, planck_top,
                                              planck_bot)
        trans = jnp.where(mask, trans_c, trans_clear)
        src_up = jnp.where(mask, src_up_c, src_up_clear)
        src_dn = jnp.where(mask, src_dn_c, src_dn_clear)
        tot = adding.lw_no_scattering_reduced(trans, src_up, src_dn,
                                              emission, albedo,
                                              spec_matrix)

    deriv_cloudy = deriv_clear = None
    if do_lw_derivatives:
        deriv_cloudy = lw_derivatives_ica(trans, tot.up_surf_g)
        deriv_clear = lw_derivatives_ica(trans_clear, clear.up_surf_g)
    return _finish_lw(clear, tot, total_cloud_cover,
                      cloud_fraction_threshold, deriv_cloudy, deriv_clear)


def _finish_lw(clear, tot, total_cloud_cover, cloud_fraction_threshold,
               deriv_cloudy=None, deriv_clear=None) -> LwFluxes:
    """Blend total/clear scenes by cloud cover and pack LwFluxes
    (radiation_mcica_lw.F90:236-248)."""
    tcc = total_cloud_cover
    has_cloud = (tcc >= cloud_fraction_threshold)
    w = jnp.where(has_cloud, tcc, 0.0)

    out = LwFluxes(
        flux_up=_mix(w, tot.up, clear.up),
        flux_dn=_mix(w, tot.dn, clear.dn),
        flux_up_clear=clear.up,
        flux_dn_clear=clear.dn,
        lw_dn_surf_g=_mix(w, tot.dn_surf_g, clear.dn_surf_g),
        lw_up_toa_g=_mix(w, tot.up_toa_g, clear.up_toa_g),
        lw_dn_surf_clear_g=clear.dn_surf_g,
        lw_up_toa_clear_g=clear.up_toa_g,
        cloud_cover=jnp.where(has_cloud, tcc, 0.0),
        flux_up_s=_mix(w, tot.up_s, clear.up_s),
        flux_dn_s=_mix(w, tot.dn_s, clear.dn_s),
        flux_up_clear_s=clear.up_s,
        flux_dn_clear_s=clear.dn_s)

    if deriv_cloudy is not None:
        # cloudy-scene derivative, then blend with clear
        # (modify_lw_derivatives_ica)
        wd = jnp.where(has_cloud, 1.0 - tcc, 1.0)[:, None]
        deriv = jnp.where(
            has_cloud[:, None],
            (1.0 - wd) * deriv_cloudy + wd * deriv_clear,
            deriv_clear)
        # surface value is defined as exactly 1
        deriv = deriv.at[:, -1].set(1.0)
        out = out._replace(lw_derivatives=deriv)
    return out


def _kernel_inputs(layout, cloudy, dtype):
    """Relayout helpers for the fused sweeps: (big-array, per-band,
    mask) converters to the (nlev, ng|nband, ncol) kernel layout.  With
    layout="knl" the big (ncol*nlev*ng) fields already arrive in it
    from the gas optics and cloud generator; only the small per-band
    cloud arrays and the mask are relaid here."""
    band = lambda x: jnp.transpose(x, (1, 2, 0))
    big = (lambda x: x) if layout == "knl" else band
    return big, band, cloudy.astype(dtype).T


def _solver_mcica_lw_fused(od, od_cloud_b, ssa_cloud_b, g_cloud_b,
                           band_from_g, od_scaling, total_cloud_cover,
                           cloud_fraction, planck_hl, emission, albedo,
                           cloud_fraction_threshold, do_lw_derivatives,
                           layout="cln") -> LwFluxes:
    """Fused-kernel LW path (see solvers/triton_mcica.py)."""
    ncol = cloud_fraction.shape[0]
    cloudy = cloud_fraction >= cloud_fraction_threshold
    big, band, mask = _kernel_inputs(layout, cloudy, od.dtype)
    albedo_b = jnp.broadcast_to(albedo, emission.shape)

    r = triton_mcica.lw_sweeps(
        big(od), band(od_cloud_b), band(ssa_cloud_b), band(g_cloud_b),
        big(od_scaling), mask, big(planck_hl), emission.T, albedo_b.T,
        band_from_g, do_lw_derivatives)

    fup_surf_c = r["fup_surf_c"].T                 # (ng, ncol) → (ncol, ng)
    zeros = jnp.zeros((ncol,), od.dtype)
    clear = LwAdding(
        up=_stack_bot(r["up_bb_c"], jnp.sum(fup_surf_c, axis=-1)),
        dn=_stack_top(zeros, r["dn_bb_c"]),
        up_toa_g=r["fup_toa_c"].T, dn_surf_g=r["fdn_surf_c"].T,
        up_surf_g=fup_surf_c)
    src_top_t = r["src_top_t"].T
    tot = LwAdding(
        up=_stack_top(jnp.sum(src_top_t, axis=-1), r["up_bb_t"]),
        dn=_stack_top(zeros, r["dn_bb_t"]),
        up_toa_g=src_top_t, dn_surf_g=r["fdn_surf_t"].T,
        up_surf_g=r["fup_surf_t"].T)

    deriv_cloudy = deriv_clear = None
    if do_lw_derivatives:
        ones = jnp.ones((ncol, 1), od.dtype)
        deriv_cloudy = jnp.concatenate([r["deriv_t"].T, ones], axis=-1)
        deriv_clear = jnp.concatenate([r["deriv_c"].T, ones], axis=-1)
    return _finish_lw(clear, tot, total_cloud_cover,
                      cloud_fraction_threshold, deriv_cloudy, deriv_clear)


@profiling.traced("radiation_mcica_sw:solver_mcica_sw")
def solver_mcica_sw(od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b,
                    band_from_g, od_scaling, total_cloud_cover,
                    cloud_fraction, incoming_sw, cos_sza,
                    albedo_diffuse, albedo_direct,
                    cloud_fraction_threshold=1.0e-6,
                    do_sw_delta_scaling_with_gases=False,
                    spec_matrix=None, layout="cln") -> SwFluxes:
    if layout == "knl" and not _use_fused(spec_matrix):
        raise ValueError(
            "kernel-layout inputs require the fused-solver configuration")
    if _use_fused(spec_matrix):
        return _solver_mcica_sw_fused(
            od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b, band_from_g,
            od_scaling, total_cloud_cover, cloud_fraction, incoming_sw,
            cos_sza, albedo_diffuse, albedo_direct,
            cloud_fraction_threshold, do_sw_delta_scaling_with_gases,
            layout=layout)
    mu0 = jnp.maximum(cos_sza, 1.0e-10)[:, None, None]
    bb = jnp.asarray(band_from_g)

    # --- clear sky
    od_c, ssa_c, g_c = od, ssa, g
    if do_sw_delta_scaling_with_gases:
        od_c, ssa_c, g_c = two_stream.delta_eddington(od_c, ssa_c, g_c)
    r_cl, t_cl, rdir_cl, tdd_cl, tdir_cl = two_stream.sw_ref_trans(
        mu0, od_c, ssa_c, g_c)
    clear = adding.adding_sw_reduced(
        incoming_sw, albedo_diffuse, albedo_direct,
        jnp.maximum(cos_sza, 1.0e-10)[:, None],
        r_cl, t_cl, rdir_cl, tdd_cl, tdir_cl, spec_matrix)

    # --- total sky: merge cloud into gas optics per g
    cloudy_layer = cloud_fraction >= cloud_fraction_threshold
    m = cloudy_layer[..., None]
    od_cloud_g = od_scaling * take_bands(od_cloud_b, bb)
    ssa_cloud_g = take_bands(ssa_cloud_b, bb)
    od_tot = od + jnp.where(m, od_cloud_g, 0.0)
    scat = ssa * od + jnp.where(m, ssa_cloud_g * od_cloud_g, 0.0)
    gscat = (g * ssa * od
             + jnp.where(m, take_bands(g_cloud_b, bb)
                         * ssa_cloud_g * od_cloud_g, 0.0))
    ssa_tot = jnp.where(od_tot > 0.0, scat / jnp.maximum(od_tot, 1e-300),
                        0.0)
    g_tot = jnp.where(scat > 0.0, gscat / jnp.maximum(scat, 1e-300), 0.0)
    if do_sw_delta_scaling_with_gases:
        od_tot, ssa_tot, g_tot = two_stream.delta_eddington(
            od_tot, ssa_tot, g_tot)
    r_c, t_c, rdir_c, tdd_c, tdir_c = two_stream.sw_ref_trans(
        mu0, od_tot, ssa_tot, g_tot)
    refl = jnp.where(m, r_c, r_cl)
    trans = jnp.where(m, t_c, t_cl)
    rdir = jnp.where(m, rdir_c, rdir_cl)
    tdd = jnp.where(m, tdd_c, tdd_cl)
    tdir = jnp.where(m, tdir_c, tdir_cl)
    tot = adding.adding_sw_reduced(
        incoming_sw, albedo_diffuse, albedo_direct,
        jnp.maximum(cos_sza, 1.0e-10)[:, None],
        refl, trans, rdir, tdd, tdir, spec_matrix)

    return _finish_sw(clear, tot, total_cloud_cover,
                      cloud_fraction_threshold, cos_sza)


def _finish_sw(clear, tot, total_cloud_cover, cloud_fraction_threshold,
               cos_sza) -> SwFluxes:
    """Blend total/clear SW scenes by cloud cover, zero night columns,
    and pack SwFluxes (radiation_mcica_sw.F90 output section)."""
    tcc = total_cloud_cover
    has_cloud = tcc >= cloud_fraction_threshold
    day = cos_sza > 0.0
    w = jnp.where(has_cloud, tcc, 0.0)

    def zn(x):
        """Zero night columns (the reference only assigns for
        cos_sza > 0, radiation_mcica_sw.F90)."""
        if x is None:
            return None
        d = day.reshape(day.shape + (1,) * (x.ndim - 1))
        return jnp.where(d, x, 0.0)

    return SwFluxes(
        flux_up=zn(_mix(w, tot.up, clear.up)),
        flux_dn=zn(_mix(w, tot.dn_diffuse + tot.dn_direct,
                        clear.dn_diffuse + clear.dn_direct)),
        flux_dn_direct=zn(_mix(w, tot.dn_direct, clear.dn_direct)),
        flux_up_clear=zn(clear.up),
        flux_dn_clear=zn(clear.dn_diffuse + clear.dn_direct),
        flux_dn_direct_clear=zn(clear.dn_direct),
        sw_dn_diffuse_surf_g=zn(_mix(w, tot.dn_diffuse_surf_g,
                                     clear.dn_diffuse_surf_g)),
        sw_dn_direct_surf_g=zn(_mix(w, tot.dn_direct_surf_g,
                                    clear.dn_direct_surf_g)),
        sw_up_toa_g=zn(_mix(w, tot.up_toa_g, clear.up_toa_g)),
        sw_dn_diffuse_surf_clear_g=zn(clear.dn_diffuse_surf_g),
        sw_dn_direct_surf_clear_g=zn(clear.dn_direct_surf_g),
        sw_up_toa_clear_g=zn(clear.up_toa_g),
        # night columns keep the reference's unset sentinel -1
        # (radiation_flux.F90 reset; radiation_mcica_sw.F90 only assigns
        # for cos_sza > 0)
        cloud_cover=jnp.where(day, tcc, -1.0),
        flux_up_s=zn(_mix(w, tot.up_s, clear.up_s)),
        flux_dn_s=zn(_mix(w,
                          None if tot.dn_diffuse_s is None
                          else tot.dn_diffuse_s + tot.dn_direct_s,
                          None if clear.dn_diffuse_s is None
                          else clear.dn_diffuse_s + clear.dn_direct_s)),
        flux_dn_direct_s=zn(_mix(w, tot.dn_direct_s, clear.dn_direct_s)),
        flux_up_clear_s=zn(clear.up_s),
        flux_dn_clear_s=zn(None if clear.dn_diffuse_s is None
                           else clear.dn_diffuse_s + clear.dn_direct_s),
        flux_dn_direct_clear_s=zn(clear.dn_direct_s))


def _solver_mcica_sw_fused(od, ssa, g, od_cloud_b, ssa_cloud_b,
                           g_cloud_b, band_from_g, od_scaling,
                           total_cloud_cover, cloud_fraction,
                           incoming_sw, cos_sza, albedo_diffuse,
                           albedo_direct, cloud_fraction_threshold,
                           do_sw_delta_scaling_with_gases,
                           layout="cln") -> SwFluxes:
    """Fused-kernel SW path (see solvers/triton_mcica.py)."""
    ncol = cloud_fraction.shape[0]
    cloudy = cloud_fraction >= cloud_fraction_threshold
    big, band, mask = _kernel_inputs(layout, cloudy, od.dtype)
    mu0_col = jnp.maximum(cos_sza, 1.0e-10)            # (ncol,)
    alb_dif = jnp.broadcast_to(albedo_diffuse, incoming_sw.shape)
    alb_dir_mu0 = jnp.broadcast_to(albedo_direct * mu0_col[:, None],
                                   incoming_sw.shape)

    r = triton_mcica.sw_sweeps(
        big(od), big(ssa), big(g),
        band(od_cloud_b), band(ssa_cloud_b), band(g_cloud_b),
        big(od_scaling), mask, mu0_col, incoming_sw.T, alb_dif.T,
        alb_dir_mu0.T, band_from_g, do_sw_delta_scaling_with_gases)

    dir_toa_bb = jnp.sum(incoming_sw, axis=-1)
    zeros_bb = jnp.zeros((ncol,), od.dtype)

    def scene(tag):
        src_top = r[f"src_top_{tag}"].T
        return SwAdding(
            up=_stack_top(jnp.sum(src_top, axis=-1), r[f"up_bb_{tag}"]),
            dn_diffuse=_stack_top(zeros_bb, r[f"dn_bb_{tag}"]),
            dn_direct=_stack_top(dir_toa_bb, r[f"dir_bb_{tag}"])
            * mu0_col[:, None],
            up_toa_g=src_top,
            dn_diffuse_surf_g=r[f"fdn_surf_{tag}"].T,
            dn_direct_surf_g=r[f"fdir_surf_{tag}"].T * mu0_col[:, None])

    return _finish_sw(scene("c"), scene("t"), total_cloud_cover,
                      cloud_fraction_threshold, cos_sza)
