"""Two-stream layer coefficients (reference: radiation_two_stream.F90).

All functions are elementwise over arrays of any matching shape (the
solvers use ``(..., nlev, ng)`` or the kernel tiles), fully fusable by
XLA.

Numerical notes vs the reference:
  * The reference promotes k/exponential math to double precision islands
    (radiation_two_stream.F90:28 jprd usage). Here the dtype follows the
    input; run f64 for golden-file validation, f32 in production with the
    same guard constants the reference uses for its single-precision build
    (KMIN_SP = 1e-6, radiation_two_stream.F90:616-622).
"""

from __future__ import annotations

import jax.numpy as jnp

from ecrad_tpu.constants import LW_DIFFUSIVITY


def _k_min(dtype):
    # Meador-Weaver Eq 18 guard: 1e-12 in dp, 1e-6 in sp
    return 1.0e-12 if dtype == jnp.float64 else 1.0e-6


def delta_eddington(od, ssa, g):
    """Delta-Eddington scaling (radiation_delta_eddington.h:24-42).

    Returns scaled (od, ssa, g)."""
    f = g * g
    od_new = od * (1.0 - ssa * f)
    ssa_new = ssa * (1.0 - f) / (1.0 - ssa * f)
    g_new = g / (1.0 + g)
    return od_new, ssa_new, g_new


def delta_eddington_scat_od(scat_od, g):
    """Delta-Eddington scaling applied to scattering optical depth
    (radiation_delta_eddington.h `delta_eddington_scat_od`): the inputs are
    (scat_od = ssa*od, g) and the total od reduction is returned.

    Returns (od_delta_reduction, scat_od_new, g_new) where the caller does
    ``od -= od_delta_reduction``."""
    f = g * g
    od_reduction = scat_od * f
    scat_od_new = scat_od * (1.0 - f)
    g_new = g / (1.0 + g)
    return od_reduction, scat_od_new, g_new


def lw_gammas(ssa, g):
    """LW two-stream gammas, Fu et al. (1997) Eqs 2.9-2.10
    (radiation_two_stream.F90:51-90)."""
    factor = (LW_DIFFUSIVITY * 0.5) * ssa
    gamma1 = LW_DIFFUSIVITY - factor * (1.0 + g)
    gamma2 = factor * (1.0 - g)
    return gamma1, gamma2


def sw_gammas(mu0, ssa, g):
    """SW Zdunkowski PIFM gammas (radiation_two_stream.F90:96-140).
    mu0 broadcasts against ssa/g."""
    factor = 0.75 * g
    gamma1 = 2.0 - ssa * (1.25 + factor)
    gamma2 = ssa * (0.75 - factor)
    gamma3 = 0.5 - mu0 * factor
    return gamma1, gamma2, gamma3


def lw_ref_trans(od, ssa, g, planck_top, planck_bot):
    """LW diffuse reflectance/transmittance + linear-in-tau Planck sources
    (radiation_two_stream.F90:246-334 calc_ref_trans_lw).

    Returns (reflectance, transmittance, source_up, source_dn)."""
    dtype = jnp.result_type(od)
    gamma1, gamma2 = lw_gammas(ssa, g)
    k = jnp.sqrt(jnp.maximum((gamma1 - gamma2) * (gamma1 + gamma2),
                             _k_min(dtype)))
    # Guard od to keep the thin branch finite before select
    od_safe = jnp.maximum(od, 1.0e-30)
    exponential = jnp.exp(-k * od_safe)
    exponential2 = exponential * exponential
    reftrans_factor = 1.0 / (k + gamma1 + (k - gamma1) * exponential2)
    ref_thick = gamma2 * (1.0 - exponential2) * reftrans_factor
    trans_thick = 2.0 * k * exponential * reftrans_factor

    # Stackhouse & Stephens (1991) Eqs 5 & 12: linear-in-tau emission
    coeff = (planck_bot - planck_top) / (od_safe * (gamma1 + gamma2))
    coeff_up_top = coeff + planck_top
    coeff_up_bot = coeff + planck_bot
    coeff_dn_top = -coeff + planck_top
    coeff_dn_bot = -coeff + planck_bot
    src_up_thick = (coeff_up_top - ref_thick * coeff_dn_top
                    - trans_thick * coeff_up_bot)
    src_dn_thick = (coeff_dn_bot - ref_thick * coeff_up_bot
                    - trans_thick * coeff_dn_top)

    # Thin limit (od <= 1e-3): linearized forms
    ref_thin = gamma2 * od
    trans_thin = (1.0 - k * od) / (1.0 + od * (gamma1 - k))
    src_thin = (1.0 - ref_thin - trans_thin) * 0.5 * (planck_top + planck_bot)

    thick = od > 1.0e-3
    reflectance = jnp.where(thick, ref_thick, ref_thin)
    transmittance = jnp.where(thick, trans_thick, trans_thin)
    source_up = jnp.where(thick, src_up_thick, src_thin)
    source_dn = jnp.where(thick, src_dn_thick, src_thin)
    return reflectance, transmittance, source_up, source_dn


def lw_no_scattering_trans(od, planck_top, planck_bot):
    """LW no-scattering transmittance + sources
    (radiation_two_stream.F90:342-409 calc_no_scattering_transmittance_lw).

    Returns (transmittance, source_up, source_dn)."""
    coeff0 = LW_DIFFUSIVITY * od
    transmittance = jnp.exp(-coeff0)
    coeff = (planck_bot - planck_top) / jnp.maximum(coeff0, 1.0e-30)
    src_up_thick = (coeff + planck_top) - transmittance * (coeff + planck_bot)
    src_dn_thick = (-coeff + planck_bot) - transmittance * (-coeff
                                                            + planck_top)
    src_thin = coeff0 * 0.5 * (planck_top + planck_bot)
    thick = od > 1.0e-3
    source_up = jnp.where(thick, src_up_thick, src_thin)
    source_dn = jnp.where(thick, src_dn_thick, src_thin)
    return transmittance, source_up, source_dn


def sw_ref_trans(mu0, od, ssa, g):
    """SW Meador & Weaver (1980) reflectance/transmittance
    (radiation_two_stream.F90:563-775 calc_ref_trans_sw).

    mu0 broadcasts against od/ssa/g (e.g. shape (ncol,1,1) vs
    (ncol,nlev,ng)).

    Returns (ref_diff, trans_diff, ref_dir, trans_dir_diff, trans_dir_dir).
    Direct quantities are normalized to the flux in the beam cross-section
    (so the caller multiplies direct fluxes by mu0 as in the reference).

    Numerical formulation differs deliberately from the reference to meet
    the single-precision flux bar without the reference's sp k-guard bias
    (radiation_two_stream.F90:616-622 raises the k^2 floor to 1e-6 in sp,
    which biases conservative-scattering transmittance by ~2e-5 per layer
    and accumulates to ~0.7 W m-2 over 137 levels):
      * k^2 uses the PIFM identity gamma1 - gamma2 = 2(1 - ssa) (exact in
        floating point by Sterbenz' lemma for ssa >= 0.5), so k^2 >= 0 by
        construction and no sp-specific floor is needed;
      * every Meador-Weaver bracket is regrouped so that in the
        conservative limit k -> 0 it is a sum of O(k) terms each computed
        to *relative* accuracy (1 - e^{-2k od} via expm1), instead of a
        catastrophically-cancelling difference of O(1) terms; the
        reftrans denominator becomes k(1+e^2) + gamma1*(1-e^2), all
        positive.
    """
    dtype = jnp.result_type(od)
    eps = jnp.finfo(dtype).eps

    trans_dir_dir = jnp.exp(jnp.maximum(-jnp.maximum(od / mu0, 0.0),
                                        -1000.0))

    factor = 0.75 * g
    gamma1 = 2.0 - ssa * (1.25 + factor)
    gamma2 = ssa * (0.75 - factor)
    gamma3 = 0.5 - mu0 * factor
    gamma4 = 1.0 - gamma3
    alpha1 = gamma1 * gamma4 + gamma2 * gamma3     # MW Eq. 16
    alpha2 = gamma1 * gamma3 + gamma2 * gamma4     # MW Eq. 17
    # k^2 = (g1-g2)(g1+g2) with g1-g2 = 2(1-ssa), g1+g2 = 2-ssa(0.5+1.5g)
    ksq = (2.0 * (1.0 - ssa)) * (2.0 - ssa * (0.5 + 1.5 * g))
    k = jnp.sqrt(jnp.maximum(ksq, 1.0e-12))

    exponential = jnp.exp(-k * od)
    exponential2 = exponential * exponential
    # 1 - exp(-2 k od), computed to relative accuracy
    one_minus_exp2 = -jnp.expm1(-2.0 * k * od)
    k_mu0 = k * mu0
    one_minus_kmu0_sqr = (1.0 - k_mu0) * (1.0 + k_mu0)
    k_2_exponential = 2.0 * k * exponential
    # k + gamma1 + (k - gamma1) e^2  ==  k (1 + e^2) + gamma1 (1 - e^2)
    reftrans_factor = 1.0 / (k * (1.0 + exponential2)
                             + gamma1 * one_minus_exp2)

    # MW Eq. 25 / 26
    ref_diff = gamma2 * one_minus_exp2 * reftrans_factor
    trans_diff = jnp.clip(k_2_exponential * reftrans_factor, 0.0,
                          1.0 - ref_diff)

    # Direct beam: singularity guard at k*mu0 == 1 as in the reference
    denom = jnp.where(jnp.abs(one_minus_kmu0_sqr) > eps,
                      one_minus_kmu0_sqr, eps)
    reftrans_dir = mu0 * ssa * reftrans_factor / denom

    # MW Eq. 14 bracket (scaled by exp(-k od)), regrouped:
    #   (1-kmu0)(a2+kg3) - (1+kmu0)(a2-kg3) e^2 - 2ke (g3 - a2 mu0) tdd
    # = a2 [(1-e^2) - kmu0 (1+e^2)] + kg3 [(1-kmu0) + (1+kmu0) e^2]
    #   - 2ke (g3 - a2 mu0) tdd        (every term O(k) as k -> 0)
    ref_dir = reftrans_dir * (
        alpha2 * (one_minus_exp2 - k_mu0 * (1.0 + exponential2))
        + k * gamma3 * ((1.0 - k_mu0) + (1.0 + k_mu0) * exponential2)
        - k_2_exponential * (gamma3 - alpha2 * mu0) * trans_dir_dir)
    # MW Eq. 15 bracket minus unscattered term, regrouped likewise:
    #   2ke (g4 + a1 mu0) - tdd [(1+kmu0)(a1+kg4) - (1-kmu0)(a1-kg4) e^2]
    # = 2ke (g4 + a1 mu0) - tdd (a1 [(1-e^2) + kmu0 (1+e^2)]
    #                            + kg4 [(1+kmu0) + (1-kmu0) e^2])
    trans_dir_diff = reftrans_dir * (
        k_2_exponential * (gamma4 + alpha1 * mu0)
        - trans_dir_dir * (
            alpha1 * (one_minus_exp2 + k_mu0 * (1.0 + exponential2))
            + k * gamma4 * ((1.0 + k_mu0) + (1.0 - k_mu0)
                            * exponential2)))

    max_dir = mu0 * (1.0 - trans_dir_dir)
    ref_dir = jnp.clip(ref_dir, 0.0, max_dir)
    trans_dir_diff = jnp.clip(trans_dir_diff, 0.0, max_dir - ref_dir)
    return ref_diff, trans_diff, ref_dir, trans_dir_diff, trans_dir_dir


def sw_direct_trans(mu0, od):
    """Direct-beam transmittance only (cloudless fast path)."""
    return jnp.exp(jnp.maximum(-jnp.maximum(od / mu0, 0.0), -1000.0))


def lw_frac_scattered_diffuse(od, ssa, g):
    """Fraction of transmitted diffuse radiation that was scattered
    (radiation_two_stream.F90:778-840, used by SPARTACUS entrapment)."""
    dtype = jnp.result_type(od)
    gamma1, gamma2 = lw_gammas(ssa, g)
    k = jnp.sqrt(jnp.maximum((gamma1 - gamma2) * (gamma1 + gamma2),
                             _k_min(dtype)))
    exponential = jnp.exp(-k * od)
    exponential2 = exponential * exponential
    reftrans_factor = 1.0 / (k + gamma1 + (k - gamma1) * exponential2)
    trans_diff = jnp.clip(2.0 * k * exponential * reftrans_factor, 0.0, 1.0)
    trans_unscat = jnp.exp(-LW_DIFFUSIVITY * od)
    return 1.0 - trans_unscat / jnp.maximum(trans_diff, 1.0e-30)
