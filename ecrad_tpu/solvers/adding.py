"""Adding method flux computations.

Reference: radiation_adding_ica_sw.F90:24-153 (adding_ica_sw),
radiation_adding_ica_lw.F90:32-334 (adding_ica_lw,
calc_fluxes_no_scattering_lw).

Level axis convention: index 0 = top of atmosphere. Arrays are
``(ncol, nlev, ng)``; per-column scalars broadcast ``(ncol, 1)``.

Two implementations of the vertical recurrences (chosen by
``backend.choices().sweeps``):

* ``lax.scan`` — the direct sequential form (137 steps, each a tiny
  ``(ncol, ng)`` elementwise op), in the reference's operation order.
* ``associative_scan`` (parallel prefix, ``ECRAD_TPU_ADDING=assoc``) —
  the adding recurrences are *Möbius/affine* in the carried state: the
  up-sweep carry (albedo, source) transforms per layer as a linear
  fractional map, i.e. a projective 3x3 matrix with sparsity pattern
  [[a,0,b],[p,t,q],[c,0,d]] acting on (albedo, source, 1), and matrix
  composition is associative; the down-sweeps are affine ``f' = Af+B``.
  ``jax.lax.associative_scan`` evaluates all 137 levels in ~log2(137)=8
  full-tensor combines instead of a sequential loop.  Each combine
  renormalizes the projective matrix by its (stays-positive)
  denominator d = 1 - r2*r1 to keep entries O(1) in f32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ecrad_tpu import backend


def _assoc_enabled() -> bool:
    return backend.choices().sweeps == "assoc"


def _up_compose(m1, m2):
    """Compose two up-sweep layer operators: m1 is applied first (the
    range nearer the surface — associative_scan passes the
    earlier-in-scan-order range as the first argument, which in the
    reverse scan is the *lower* range).  Operators are projective
    matrices [[a,0,b],[p,t,q],[c,0,d]] on homogeneous
    (albedo, source, 1); normalized so d == 1 (d = 1 - r2*r1 > 0
    physically)."""
    a1, b1, c1, p1, t1, q1 = m1
    a2, b2, c2, p2, t2, q2 = m2
    d = c2 * b1 + 1.0                    # d2 == d1 == 1 after normalize
    inv = 1.0 / d
    a = (a2 * a1 + b2 * c1) * inv
    b = (a2 * b1 + b2) * inv
    c = (c2 * a1 + c1) * inv
    p = (p2 * a1 + t2 * p1 + q2 * c1) * inv
    t = (t2 * t1) * inv
    q = (p2 * b1 + t2 * q1 + q2) * inv
    return (a, b, c, p, t, q)


def _up_states_assoc(refl, trans, s_up, s_dn, alb0, src0):
    """Parallel-prefix evaluation of the up-sweep.

    Args are (nlev, ncol, ng) layer operators and (ncol, ng) initial
    (surface) state.  Returns (albedo_below, source_below, inv_denom)
    per layer — the carry *before* applying that layer, exactly what
    the sequential scan emits — plus the final top-of-atmosphere
    (albedo_top, source_top).

    Per layer: albedo' = (a*albedo + b)/(c*albedo + 1) with
    a = trans^2 - refl^2, b = refl, c = -refl, and
    source' = (p*albedo + t*source + q)/(c*albedo + 1) with
    p = trans*s_dn - refl*s_up, t = trans, q = s_up
    (same algebra as the scan step in radiation_adding_ica_lw.F90:32+,
    cleared of its denominator)."""
    a = (trans - refl) * (trans + refl)
    m = (a, refl, -refl, trans * s_dn - refl * s_up, trans, s_up)
    cum = jax.lax.associative_scan(_up_compose, m, reverse=True, axis=0)
    # exclusive suffix: state below layer i = inclusive result at i+1;
    # below the bottom layer it is the initial (surface) state
    ident = [jnp.broadcast_to(z, alb0.shape)[None]
             for z in (jnp.ones_like(alb0), jnp.zeros_like(alb0),
                       jnp.zeros_like(alb0), jnp.zeros_like(alb0),
                       jnp.ones_like(alb0), jnp.zeros_like(alb0))]
    a_e, b_e, c_e, p_e, t_e, q_e = [
        jnp.concatenate([x[1:], i0], axis=0) for x, i0 in zip(cum, ident)]
    inv0 = 1.0 / (c_e * alb0 + 1.0)
    albedo_below = (a_e * alb0 + b_e) * inv0
    source_below = (p_e * alb0 + t_e * src0 + q_e) * inv0
    inv_denom = 1.0 / (1.0 - albedo_below * refl)
    # top state from the full (inclusive) composition at index 0
    a_t, b_t, c_t, p_t, t_t, q_t = [x[0] for x in cum]
    invt = 1.0 / (c_t * alb0 + 1.0)
    albedo_top = (a_t * alb0 + b_t) * invt
    source_top = (p_t * alb0 + t_t * src0 + q_t) * invt
    return (albedo_below, source_below, inv_denom, albedo_top, source_top)


def _affine_compose(c1, c2):
    """Affine composition with c1 applied first: (A2*A1, A2*B1 + B2).
    Works for both scan directions — associative_scan always passes the
    earlier-in-scan-order (= applied-first) range as the first arg."""
    a1, b1 = c1
    a2, b2 = c2
    return (a2 * a1, a2 * b1 + b2)


def _dn_levels_assoc(A, B, f0):
    """Parallel prefix for f[i+1] = A[i] f[i] + B[i] from the top:
    returns f at half-levels 1..nlev, shape (nlev, ncol, ng)."""
    cumA, cumB = jax.lax.associative_scan(_affine_compose, (A, B), axis=0)
    return cumA * f0 + cumB


def _up_levels_affine_assoc(A, B, f0):
    """Parallel prefix for f[i] = A[i] f[i+1] + B[i] from the surface
    (f[nlev] = f0): returns f at half-levels 0..nlev-1."""
    cumA, cumB = jax.lax.associative_scan(_affine_compose, (A, B), axis=0,
                                          reverse=True)
    return cumA * f0 + cumB


class SwAdding(NamedTuple):
    """Reduced SW adding output: broadband profiles + boundary g slices
    (+ optional spectrally-projected profiles)."""
    up: jnp.ndarray                  # (ncol, nlev+1) broadband
    dn_diffuse: jnp.ndarray
    dn_direct: jnp.ndarray
    up_toa_g: jnp.ndarray            # (ncol, ng)
    dn_diffuse_surf_g: jnp.ndarray
    dn_direct_surf_g: jnp.ndarray
    up_s: Optional[jnp.ndarray] = None        # (ncol, nlev+1, nspec)
    dn_diffuse_s: Optional[jnp.ndarray] = None
    dn_direct_s: Optional[jnp.ndarray] = None


class LwAdding(NamedTuple):
    up: jnp.ndarray                  # (ncol, nlev+1) broadband
    dn: jnp.ndarray
    up_toa_g: jnp.ndarray            # (ncol, ng)
    dn_surf_g: jnp.ndarray
    up_surf_g: jnp.ndarray           # for LW derivatives
    up_s: Optional[jnp.ndarray] = None
    dn_s: Optional[jnp.ndarray] = None


def _project(y, spec_matrix):
    """Project a (ncol, ng) plane to broadband (and optionally bands)."""
    bb = jnp.sum(y, axis=-1)
    if spec_matrix is None:
        return bb, None
    return bb, jnp.matmul(y, spec_matrix,
                          precision=jax.lax.Precision.HIGHEST)


def _stack_top(top, levels):
    """[top (ncol,...)] + levels (nlev, ncol, ...) → (ncol, nlev+1, ...)."""
    prof = jnp.concatenate([top[None], levels], axis=0)
    return jnp.moveaxis(prof, 0, 1)


def _stack_bot(levels, bottom):
    prof = jnp.concatenate([levels, bottom[None]], axis=0)
    return jnp.moveaxis(prof, 0, 1)


def _project_levels(y, spec_matrix):
    """Project (nlev, ncol, ng) level planes to broadband (nlev, ncol)
    and optionally (nlev, ncol, nspec)."""
    bb = jnp.sum(y, axis=-1)
    if spec_matrix is None:
        return bb, None
    return bb, jnp.matmul(y, spec_matrix,
                          precision=jax.lax.Precision.HIGHEST)


def _adding_sw_reduced_assoc(incoming_toa, albedo_surf_diffuse,
                             albedo_surf_direct, cos_sza, reflectance,
                             transmittance, ref_dir, trans_dir_diff,
                             trans_dir_dir, spec_matrix) -> SwAdding:
    """Parallel-prefix form of adding_sw_reduced (same recurrences as
    radiation_adding_ica_sw.F90:24-153, evaluated in log2(nlev) combines
    — see module docstring)."""
    lev = lambda a: jnp.moveaxis(a, -2, 0)       # (nlev, ncol, ng)
    refl, trans = lev(reflectance), lev(transmittance)
    rdir, tdirdiff = lev(ref_dir), lev(trans_dir_diff)

    # 1) direct beam: cumulative product of per-layer transmissions
    fdir_below = jnp.cumprod(lev(trans_dir_dir), axis=0) \
        * incoming_toa[None]                      # levels 1..nlev
    fdir_surf = fdir_below[-1]
    fdir_top_levels = jnp.concatenate(
        [incoming_toa[None], fdir_below[:-1]], axis=0)

    # 2) up sweep (Möbius prefix)
    alb0 = jnp.broadcast_to(albedo_surf_diffuse, incoming_toa.shape)
    src0 = albedo_surf_direct * fdir_surf * cos_sza
    s_up = rdir * fdir_top_levels
    s_dn = tdirdiff * fdir_top_levels
    albedo_below, source_below, inv_denom, _, source_top = \
        _up_states_assoc(refl, trans, s_up, s_dn, alb0, src0)

    # 3) down sweep (affine prefix), fluxes at levels 1..nlev
    A = trans * inv_denom
    Bv = (refl * source_below + tdirdiff * fdir_top_levels) * inv_denom
    fdn_levels = _dn_levels_assoc(A, Bv, jnp.zeros_like(incoming_toa))
    fup_levels = albedo_below * fdn_levels + source_below
    fdn_surf = fdn_levels[-1]

    dn_bb, dn_sp = _project_levels(fdn_levels, spec_matrix)
    up_bb, up_sp = _project_levels(fup_levels, spec_matrix)
    fdir_bb, fdir_sp = _project_levels(fdir_below, spec_matrix)

    mu0 = cos_sza
    mu0_bb = mu0[..., 0] if mu0.ndim == 2 else mu0
    up_toa_bb, up_toa_sp = _project(source_top, spec_matrix)
    dir_toa_bb, dir_toa_sp = _project(incoming_toa, spec_matrix)
    zeros_bb = jnp.zeros_like(up_toa_bb)

    out = SwAdding(
        up=_stack_top(up_toa_bb, up_bb),
        dn_diffuse=_stack_top(zeros_bb, dn_bb),
        dn_direct=_stack_top(dir_toa_bb, fdir_bb) * mu0_bb[:, None],
        up_toa_g=source_top,
        dn_diffuse_surf_g=fdn_surf,
        dn_direct_surf_g=fdir_surf * mu0,
    )
    if spec_matrix is not None:
        out = out._replace(
            up_s=_stack_top(up_toa_sp, up_sp),
            dn_diffuse_s=_stack_top(jnp.zeros_like(up_toa_sp), dn_sp),
            dn_direct_s=(_stack_top(dir_toa_sp, fdir_sp)
                         * mu0_bb[:, None, None]))
    return out


def _adding_lw_reduced_assoc(reflectance, transmittance, source_up,
                             source_dn, emission_surf, albedo_surf,
                             spec_matrix) -> LwAdding:
    """Parallel-prefix form of adding_lw_reduced
    (radiation_adding_ica_lw.F90:32-134 recurrences)."""
    lev = lambda a: jnp.moveaxis(a, -2, 0)
    refl, trans = lev(reflectance), lev(transmittance)
    s_up, s_dn = lev(source_up), lev(source_dn)
    alb0 = jnp.broadcast_to(albedo_surf, emission_surf.shape)

    albedo_below, source_below, inv_denom, _, source_top = \
        _up_states_assoc(refl, trans, s_up, s_dn, alb0, emission_surf)

    A = trans * inv_denom
    Bv = (refl * source_below + s_dn) * inv_denom
    fdn_levels = _dn_levels_assoc(A, Bv, jnp.zeros_like(emission_surf))
    fup_levels = albedo_below * fdn_levels + source_below
    fdn_surf = fdn_levels[-1]
    fup_surf_g = alb0 * fdn_surf + emission_surf

    dn_bb, dn_sp = _project_levels(fdn_levels, spec_matrix)
    up_bb, up_sp = _project_levels(fup_levels, spec_matrix)
    up_toa_bb, up_toa_sp = _project(source_top, spec_matrix)

    out = LwAdding(
        up=_stack_top(up_toa_bb, up_bb),
        dn=_stack_top(jnp.zeros_like(up_toa_bb), dn_bb),
        up_toa_g=source_top, dn_surf_g=fdn_surf, up_surf_g=fup_surf_g)
    if spec_matrix is not None:
        out = out._replace(
            up_s=_stack_top(up_toa_sp, up_sp),
            dn_s=_stack_top(jnp.zeros_like(up_toa_sp), dn_sp))
    return out


def _lw_no_scattering_reduced_assoc(transmittance, source_up, source_dn,
                                    emission_surf, albedo_surf,
                                    spec_matrix) -> LwAdding:
    """Parallel-prefix form of lw_no_scattering_reduced
    (radiation_adding_ica_lw.F90:272-334): both sweeps are affine."""
    lev = lambda a: jnp.moveaxis(a, -2, 0)
    trans = lev(transmittance)
    s_up, s_dn = lev(source_up), lev(source_dn)
    alb0 = jnp.broadcast_to(albedo_surf, emission_surf.shape)

    fdn_levels = _dn_levels_assoc(trans, s_dn,
                                  jnp.zeros_like(emission_surf))
    fdn_surf = fdn_levels[-1]
    fup_surf = emission_surf + alb0 * fdn_surf
    fup_levels = _up_levels_affine_assoc(trans, s_up, fup_surf)

    dn_bb, dn_sp = _project_levels(fdn_levels, spec_matrix)
    up_bb, up_sp = _project_levels(fup_levels, spec_matrix)
    surf_up_bb, surf_up_sp = _project(fup_surf, spec_matrix)
    zeros_bb = jnp.zeros_like(surf_up_bb)

    out = LwAdding(
        up=_stack_bot(up_bb, surf_up_bb),
        dn=_stack_top(zeros_bb, dn_bb),
        up_toa_g=fup_levels[0], dn_surf_g=fdn_surf, up_surf_g=fup_surf)
    if spec_matrix is not None:
        out = out._replace(up_s=_stack_bot(up_sp, surf_up_sp),
                           dn_s=_stack_top(jnp.zeros_like(surf_up_sp),
                                           dn_sp))
    return out


def adding_sw_reduced(incoming_toa, albedo_surf_diffuse, albedo_surf_direct,
                      cos_sza, reflectance, transmittance, ref_dir,
                      trans_dir_diff, trans_dir_dir, spec_matrix=None
                      ) -> SwAdding:
    """SW adding with on-the-fly spectral reduction.

    Same recurrences as :func:`adding_sw` (radiation_adding_ica_sw.F90:
    24-153) but each scan step emits only the g-sum (and an optional
    ``(ng, nspec)`` projection, e.g. a one-hot band matrix) instead of the
    full per-g flux profile — the reference computes broadband sums on the
    fly for exactly this reason (radiation_mcica_sw.F90:185-222), and
    here it removes an (ncol, nlev+1, ng) device temporary per output.
    Boundary (surface/TOA) fluxes stay g-resolved for the spectral
    diagnostics.
    """
    if _assoc_enabled():
        return _adding_sw_reduced_assoc(
            incoming_toa, albedo_surf_diffuse, albedo_surf_direct,
            cos_sza, reflectance, transmittance, ref_dir, trans_dir_diff,
            trans_dir_dir, spec_matrix)
    lev = lambda a: jnp.moveaxis(a, -2, 0)       # (nlev, ncol, ng)

    # 1) Direct-beam cumulative transmission downward
    def dir_step(fd, t):
        fd_next = fd * t
        bb, sp = _project(fd_next, spec_matrix)
        return fd_next, (fd_next, bb, sp)

    fdir_surf, (fdir_below, fdir_bb, fdir_sp) = jax.lax.scan(
        dir_step, incoming_toa, lev(trans_dir_dir))
    fdir_top_levels = jnp.concatenate(
        [incoming_toa[None], fdir_below[:-1]], axis=0)  # (nlev, ncol, ng)

    # 2) Upward sweep: albedo of atmosphere below + upwelling source
    def up_step(carry, x):
        albedo_below, source_below = carry
        refl, trans, rdir, tdirdiff, fdir_top = x
        inv_denom = 1.0 / (1.0 - albedo_below * refl)
        albedo = refl + trans * trans * albedo_below * inv_denom
        source = rdir * fdir_top + trans * (
            source_below + albedo_below * tdirdiff * fdir_top) * inv_denom
        return (albedo, source), (albedo_below, source_below, inv_denom)

    albedo_surf_diffuse = jnp.broadcast_to(albedo_surf_diffuse,
                                           incoming_toa.shape)
    source_surf = albedo_surf_direct * fdir_surf * cos_sza
    xs = (lev(reflectance), lev(transmittance), lev(ref_dir),
          lev(trans_dir_diff), fdir_top_levels)
    (albedo_top, source_top), (albedo_below, source_below, inv_denom) = \
        jax.lax.scan(up_step, (albedo_surf_diffuse, source_surf), xs,
                     reverse=True)

    # 3) Downward sweep emitting reduced fluxes per level
    def dn_step(fdn, x):
        trans, refl, tdirdiff, fdir_top, src_below, alb_below, inv_d = x
        fdn_next = (trans * fdn + refl * src_below
                    + tdirdiff * fdir_top) * inv_d
        fup_next = alb_below * fdn_next + src_below
        dn_bb, dn_sp = _project(fdn_next, spec_matrix)
        up_bb, up_sp = _project(fup_next, spec_matrix)
        return fdn_next, (dn_bb, up_bb, dn_sp, up_sp)

    fdn_top = jnp.zeros_like(incoming_toa)
    xs2 = (lev(transmittance), lev(reflectance), lev(trans_dir_diff),
           fdir_top_levels, source_below, albedo_below, inv_denom)
    fdn_surf, (dn_bb, up_bb, dn_sp, up_sp) = jax.lax.scan(
        dn_step, fdn_top, xs2)

    mu0 = cos_sza                                    # (ncol, 1) or (ncol, ng)
    mu0_bb = mu0[..., 0] if mu0.ndim == 2 else mu0

    def stack_profiles(top, levels):
        """[top (ncol,...)] + levels (nlev, ncol, ...) → (ncol, nlev+1, ...)"""
        prof = jnp.concatenate([top[None], levels], axis=0)
        return jnp.moveaxis(prof, 0, 1)

    up_toa_bb, up_toa_sp = _project(source_top, spec_matrix)
    dir_toa_bb, dir_toa_sp = _project(incoming_toa, spec_matrix)
    zeros_bb = jnp.zeros_like(up_toa_bb)

    out = SwAdding(
        up=stack_profiles(up_toa_bb, up_bb),
        dn_diffuse=stack_profiles(zeros_bb, dn_bb),
        dn_direct=stack_profiles(dir_toa_bb, fdir_bb) * mu0_bb[:, None],
        up_toa_g=source_top,
        dn_diffuse_surf_g=fdn_surf,
        dn_direct_surf_g=fdir_surf * mu0,
    )
    if spec_matrix is not None:
        out = out._replace(
            up_s=stack_profiles(up_toa_sp, up_sp),
            dn_diffuse_s=stack_profiles(jnp.zeros_like(up_toa_sp), dn_sp),
            dn_direct_s=(stack_profiles(dir_toa_sp, fdir_sp)
                         * mu0_bb[:, None, None]))
    return out


def adding_lw_reduced(reflectance, transmittance, source_up, source_dn,
                      emission_surf, albedo_surf, spec_matrix=None
                      ) -> LwAdding:
    """LW adding (scattering) with on-the-fly spectral reduction
    (recurrences of radiation_adding_ica_lw.F90:32-134)."""
    if _assoc_enabled():
        return _adding_lw_reduced_assoc(
            reflectance, transmittance, source_up, source_dn,
            emission_surf, albedo_surf, spec_matrix)
    lev = lambda a: jnp.moveaxis(a, -2, 0)
    albedo_surf = jnp.broadcast_to(albedo_surf, emission_surf.shape)

    def up_step(carry, x):
        albedo_below, source_below = carry
        refl, trans, s_up, s_dn = x
        inv_denom = 1.0 / (1.0 - albedo_below * refl)
        albedo = refl + trans * trans * albedo_below * inv_denom
        source = s_up + trans * (source_below
                                 + albedo_below * s_dn) * inv_denom
        return (albedo, source), (albedo_below, source_below, inv_denom)

    xs = (lev(reflectance), lev(transmittance), lev(source_up),
          lev(source_dn))
    (albedo_top, source_top), (albedo_below, source_below, inv_denom) = \
        jax.lax.scan(up_step, (albedo_surf, emission_surf), xs, reverse=True)

    def dn_step(fdn, x):
        trans, refl, s_dn, src_below, alb_below, inv_d = x
        fdn_next = (trans * fdn + refl * src_below + s_dn) * inv_d
        fup_next = alb_below * fdn_next + src_below
        dn_bb, dn_sp = _project(fdn_next, spec_matrix)
        up_bb, up_sp = _project(fup_next, spec_matrix)
        return fdn_next, (dn_bb, up_bb, dn_sp, up_sp)

    fdn_top = jnp.zeros_like(emission_surf)
    xs2 = (lev(transmittance), lev(reflectance), lev(source_dn),
           source_below, albedo_below, inv_denom)
    fdn_surf, (dn_bb, up_bb, dn_sp, up_sp) = jax.lax.scan(
        dn_step, fdn_top, xs2)
    fup_surf_g = albedo_surf * fdn_surf + emission_surf

    def stack_profiles(top, levels):
        prof = jnp.concatenate([top[None], levels], axis=0)
        return jnp.moveaxis(prof, 0, 1)

    up_toa_bb, up_toa_sp = _project(source_top, spec_matrix)
    out = LwAdding(
        up=stack_profiles(up_toa_bb, up_bb),
        dn=stack_profiles(jnp.zeros_like(up_toa_bb), dn_bb),
        up_toa_g=source_top, dn_surf_g=fdn_surf, up_surf_g=fup_surf_g)
    if spec_matrix is not None:
        out = out._replace(
            up_s=stack_profiles(up_toa_sp, up_sp),
            dn_s=stack_profiles(jnp.zeros_like(up_toa_sp), dn_sp))
    return out


def lw_no_scattering_reduced(transmittance, source_up, source_dn,
                             emission_surf, albedo_surf, spec_matrix=None
                             ) -> LwAdding:
    """No-scattering LW recurrences with on-the-fly spectral reduction
    (radiation_adding_ica_lw.F90:272-334)."""
    if _assoc_enabled():
        return _lw_no_scattering_reduced_assoc(
            transmittance, source_up, source_dn, emission_surf,
            albedo_surf, spec_matrix)
    lev = lambda a: jnp.moveaxis(a, -2, 0)
    albedo_surf = jnp.broadcast_to(albedo_surf, emission_surf.shape)

    def dn_step(fdn, x):
        trans, s_dn = x
        fdn_next = trans * fdn + s_dn
        bb, sp = _project(fdn_next, spec_matrix)
        return fdn_next, (bb, sp)

    fdn_top = jnp.zeros_like(emission_surf)
    fdn_surf, (dn_bb, dn_sp) = jax.lax.scan(
        dn_step, fdn_top, (lev(transmittance), lev(source_dn)))

    fup_surf = emission_surf + albedo_surf * fdn_surf

    def up_step(fup, x):
        trans, s_up = x
        fup_next = trans * fup + s_up
        bb, sp = _project(fup_next, spec_matrix)
        return fup_next, (bb, sp)

    fup_toa_g, (up_bb, up_sp) = jax.lax.scan(
        up_step, fup_surf, (lev(transmittance), lev(source_up)),
        reverse=True)

    surf_up_bb, surf_up_sp = _project(fup_surf, spec_matrix)
    zeros_bb = jnp.zeros_like(surf_up_bb)

    def stack_up(levels, bottom):
        prof = jnp.concatenate([levels, bottom[None]], axis=0)
        return jnp.moveaxis(prof, 0, 1)

    def stack_dn(top, levels):
        prof = jnp.concatenate([top[None], levels], axis=0)
        return jnp.moveaxis(prof, 0, 1)

    out = LwAdding(
        up=stack_up(up_bb, surf_up_bb),
        dn=stack_dn(zeros_bb, dn_bb),
        up_toa_g=fup_toa_g, dn_surf_g=fdn_surf, up_surf_g=fup_surf)
    if spec_matrix is not None:
        out = out._replace(up_s=stack_up(up_sp, surf_up_sp),
                           dn_s=stack_dn(jnp.zeros_like(surf_up_sp), dn_sp))
    return out


def adding_sw(incoming_toa, albedo_surf_diffuse, albedo_surf_direct,
              cos_sza, reflectance, transmittance, ref_dir, trans_dir_diff,
              trans_dir_dir):
    """Shortwave adding (radiation_adding_ica_sw.F90:24-153).

    Args:
      incoming_toa: (ncol, ng) direct solar flux into beam cross-section.
      albedo_surf_diffuse/direct: (ncol, ng).
      cos_sza: (ncol, 1) or (ncol, ng).
      reflectance..trans_dir_dir: (ncol, nlev, ng) layer properties.

    Returns (flux_up, flux_dn_diffuse, flux_dn_direct), each
    (ncol, nlev+1, ng); direct flux is into a *horizontal* plane (i.e.
    multiplied by mu0, as in the reference output).
    """
    nlev = reflectance.shape[-2]

    # 1) Direct-beam cumulative transmission downward (cumprod scan)
    def dir_step(fd, t):
        fd_next = fd * t
        return fd_next, fd_next

    lev = lambda a: jnp.moveaxis(a, -2, 0)       # (nlev, ncol, ng)
    _, fdir_below = jax.lax.scan(dir_step, incoming_toa, lev(trans_dir_dir))
    # flux_dn_direct at half-levels: [incoming_toa, fdir_below...]
    flux_dn_direct = jnp.concatenate(
        [incoming_toa[None], fdir_below], axis=0)   # (nlev+1, ncol, ng)

    # 2) Upward sweep: accumulate albedo of atmosphere below half-level and
    #    the upwelling "source" from scattered direct radiation
    def up_step(carry, x):
        albedo_below, source_below = carry
        refl, trans, rdir, tdirdiff, fdir_top = x
        inv_denom = 1.0 / (1.0 - albedo_below * refl)
        albedo = refl + trans * trans * albedo_below * inv_denom
        source = rdir * fdir_top + trans * (
            source_below + albedo_below * tdirdiff * fdir_top) * inv_denom
        return (albedo, source), (albedo_below, source_below, inv_denom)

    albedo_surf_diffuse = jnp.broadcast_to(albedo_surf_diffuse,
                                           incoming_toa.shape)
    source_surf = albedo_surf_direct * flux_dn_direct[-1] * cos_sza
    xs = (lev(reflectance), lev(transmittance), lev(ref_dir),
          lev(trans_dir_diff), flux_dn_direct[:-1])
    (albedo_top, source_top), (albedo_below, source_below, inv_denom) = \
        jax.lax.scan(up_step, (albedo_surf_diffuse, source_surf), xs,
                     reverse=True)

    # 3) Downward sweep computing diffuse fluxes
    def dn_step(fdn, x):
        trans, refl, tdirdiff, fdir_top, src_below, alb_below, inv_d = x
        fdn_next = (trans * fdn + refl * src_below
                    + tdirdiff * fdir_top) * inv_d
        fup_next = alb_below * fdn_next + src_below
        return fdn_next, (fdn_next, fup_next)

    fdn_top = jnp.zeros_like(incoming_toa)
    xs2 = (lev(transmittance), lev(reflectance), lev(trans_dir_diff),
           flux_dn_direct[:-1], source_below, albedo_below, inv_denom)
    _, (fdn_levels, fup_levels) = jax.lax.scan(dn_step, fdn_top, xs2)

    flux_dn_diffuse = jnp.concatenate([fdn_top[None], fdn_levels], axis=0)
    flux_up = jnp.concatenate([source_top[None], fup_levels], axis=0)
    flux_dn_direct = flux_dn_direct * cos_sza  # into horizontal plane

    tolev = lambda a: jnp.moveaxis(a, 0, -2)     # back to (ncol, nlev+1, ng)
    return tolev(flux_up), tolev(flux_dn_diffuse), tolev(flux_dn_direct)


def adding_lw(reflectance, transmittance, source_up, source_dn,
              emission_surf, albedo_surf):
    """Longwave adding with scattering
    (radiation_adding_ica_lw.F90:32-134 adding_ica_lw).

    Args (ncol, nlev, ng) layer props; (ncol, ng) surface.
    Returns (flux_up, flux_dn), each (ncol, nlev+1, ng).
    """
    lev = lambda a: jnp.moveaxis(a, -2, 0)
    albedo_surf = jnp.broadcast_to(albedo_surf, emission_surf.shape)

    def up_step(carry, x):
        albedo_below, source_below = carry
        refl, trans, s_up, s_dn = x
        inv_denom = 1.0 / (1.0 - albedo_below * refl)
        albedo = refl + trans * trans * albedo_below * inv_denom
        source = s_up + trans * (source_below
                                 + albedo_below * s_dn) * inv_denom
        return (albedo, source), (albedo_below, source_below, inv_denom)

    xs = (lev(reflectance), lev(transmittance), lev(source_up),
          lev(source_dn))
    (albedo_top, source_top), (albedo_below, source_below, inv_denom) = \
        jax.lax.scan(up_step, (albedo_surf, emission_surf), xs, reverse=True)

    def dn_step(fdn, x):
        trans, refl, s_dn, src_below, alb_below, inv_d = x
        fdn_next = (trans * fdn + refl * src_below + s_dn) * inv_d
        fup_next = alb_below * fdn_next + src_below
        return fdn_next, (fdn_next, fup_next)

    fdn_top = jnp.zeros_like(emission_surf)
    xs2 = (lev(transmittance), lev(reflectance), lev(source_dn),
           source_below, albedo_below, inv_denom)
    _, (fdn_levels, fup_levels) = jax.lax.scan(dn_step, fdn_top, xs2)

    flux_dn = jnp.concatenate([fdn_top[None], fdn_levels], axis=0)
    flux_up = jnp.concatenate([source_top[None], fup_levels], axis=0)
    tolev = lambda a: jnp.moveaxis(a, 0, -2)
    return tolev(flux_up), tolev(flux_dn)


def lw_no_scattering(transmittance, source_up, source_dn, emission_surf,
                     albedo_surf):
    """LW fluxes with no scattering: simple down then up recurrences
    (radiation_adding_ica_lw.F90:272-334 calc_fluxes_no_scattering_lw)."""
    lev = lambda a: jnp.moveaxis(a, -2, 0)
    albedo_surf = jnp.broadcast_to(albedo_surf, emission_surf.shape)

    def dn_step(fdn, x):
        trans, s_dn = x
        fdn_next = trans * fdn + s_dn
        return fdn_next, fdn_next

    fdn_top = jnp.zeros_like(emission_surf)
    fdn_surf, fdn_levels = jax.lax.scan(
        dn_step, fdn_top, (lev(transmittance), lev(source_dn)))
    flux_dn = jnp.concatenate([fdn_top[None], fdn_levels], axis=0)

    fup_surf = emission_surf + albedo_surf * fdn_surf

    def up_step(fup, x):
        trans, s_up = x
        fup_next = trans * fup + s_up
        return fup_next, fup_next

    _, fup_levels = jax.lax.scan(
        up_step, fup_surf, (lev(transmittance), lev(source_up)),
        reverse=True)
    flux_up = jnp.concatenate([fup_levels, fup_surf[None]], axis=0)
    tolev = lambda a: jnp.moveaxis(a, 0, -2)
    return tolev(flux_up), tolev(flux_dn)
