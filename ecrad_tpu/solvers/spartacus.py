"""SPARTACUS solvers: 3D radiative transfer with matrix exponentials.

Reference: radiation/radiation_spartacus_sw.F90 (solver L41-965,
step_migrations L966-1046), radiation_spartacus_lw.F90 (solver L35-607),
radiation_lw_derivatives.F90:138-193 (calc_lw_derivatives_matrix).

Batched formulation: the reference's per-column/per-layer/per-g triple
loop with data-dependent ``ng3D`` cutoffs becomes dense batched compute
over (ncol, ng) with masks.  ALL small-matrix state — the per-layer
reflectance/transmittance matrices (including the 6x6 / 9x9 matrix
exponentials), the upward albedo accumulation, and the downward flux
sweep — lives in PLANE FORM: a 3x3 matrix is a list-of-lists of
(ncol, ng) planes, a region vector a list of planes (see
solvers/matrix.py pl_* algebra).  Plane form keeps every op a fused
full-width elementwise op over the (ncol, ng) batch instead of many
tiny (3, 3) matrix operations.  For scan xs / ys, plane matrices travel stacked on a leading
length-9 (or 3) axis: (..., 9, ncol, ng) with k = 3*i + j.

Per-layer matrices are computed by a ``lax.map`` over level CHUNKS
(vmapped inside, bounding the expm working set); the upward albedo
accumulation and downward flux sweep are ``lax.scan`` recurrences.  The
g-point ordering is assumed already reordered by increasing gas optical
depth (radiation_ifs_rrtm.F90:51-67), so the reference's prefix rule
``od(g) <= max_gas_od_3d for g < ng3D`` becomes a per-g mask.

Entrapment modes (Hogan et al. GMD 2019) are compile-time (config-static)
branches; the per-column clear-layer special cases are runtime masks.
Matrix convention: plane [i][j] with i = destination region row, matching
the Fortran A(g, j1, j2).
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ecrad_tpu.config import Config, Entrapment, PdfShape
from ecrad_tpu.solvers import two_stream
from ecrad_tpu.solvers.matrix import (pl_expm, pl_expm_blockut,
                                      pl_fast_expm_exchange_3,
                                      pl_matmul, pl_matvec, pl_solve_mat,
                                      pl_solve_vec)
from ecrad_tpu.solvers.outputs import (LwFluxes, SwFluxes,
                                       lw_from_g_profiles,
                                       sw_from_g_profiles)
from ecrad_tpu.solvers.tripleclouds import (calc_region_properties,
                                            calc_overlap_matrices,
                                            _merge_regions)
from ecrad_tpu import profiling

# Doublings of the LW SPARTACUS layer (see layer_mats): the 6x6 exponent's
# 1-norm is bounded by ~2*max_cloud_od*gamma1 + 4*max_3d_transfer_rate
# *side_emiss ~ 120, so a 2^-6 sub-layer's stays near 2, where R and T
# come out of its exponential accurately.
_LW_DOUBLINGS = 6

# radiation_constants.F90:30-33
R_OVER_G = 287.058 / 9.80665
FOUR_OVER_PI = 4.0 / np.pi
TAN_DIFFUSE_ANGLE_3D = np.pi * 0.5          # radiation_spartacus_sw.F90:94
MIN_MU0_3D = 0.004625
SIDE_EMISS_THIN = 1.4107                    # radiation_spartacus_lw.F90:130
LW_DIFFUSIVITY = 1.66
NREG = 3
_EPS = float(np.finfo(np.float64).eps)


def _highest_precision(fn):
    """Trace the solver under full-precision matmuls: the exponentials
    and solves are numerically delicate, and reduced-precision matmul
    inputs (bf16 or TF32) turn near-singular systems into NaNs.  These
    matrices are tiny, so the cost is negligible."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)
    return wrapped


# ---------------------------------------------------------------------------
# Plane-form plumbing: matrices as [[plane]] (NREG x NREG lists of
# (ncol, ng) arrays), vectors as [plane]; stacked forms carry a leading
# k = 3*i + j axis through scan xs/ys.

def _punstack(A9):
    """(9, ...) stacked -> [[plane]]."""
    return [[A9[NREG * i + j] for j in range(NREG)] for i in range(NREG)]


def _pstack(P, axis=0):
    """[[plane]] (or [plane]) -> stacked array along ``axis``."""
    flat = [x for row in P for x in row] if isinstance(P[0], list) \
        else list(P)
    return jnp.stack(flat, axis=axis)


def _pmat_add(A, B):
    return [[A[i][j] + B[i][j] for j in range(NREG)] for i in range(NREG)]


def _pvec_add(a, b):
    return [a[i] + b[i] for i in range(NREG)]


def _pmat_where(cond, A, B):
    return [[jnp.where(cond, A[i][j], B[i][j]) for j in range(NREG)]
            for i in range(NREG)]


def _pvec_where(cond, a, b):
    return [jnp.where(cond, a[i], b[i]) for i in range(NREG)]


def _pmat_embed00(x, like):
    """Plane matrix with only the [0][0] entry set to x (zeros like the
    planes of ``like`` elsewhere)."""
    z = jnp.zeros_like(like[0][0])
    return [[jnp.broadcast_to(x, z.shape) if (i == 0 and j == 0) else z
             for j in range(NREG)] for i in range(NREG)]


def _pvec_embed0(x, like):
    z = jnp.zeros_like(like[0])
    return [jnp.broadcast_to(x, z.shape) if i == 0 else z
            for i in range(NREG)]


def _peye_minus(A):
    """I - A in plane form."""
    return [[(1.0 if i == j else 0.0) - A[i][j] for j in range(NREG)]
            for i in range(NREG)]


def _lev9(M4):
    """(ncol, L, m, m) small-matrix profile -> (L, m*m, ncol) stacked
    planes for scan xs (k = m*i + j)."""
    ncol, L, m, _ = M4.shape
    return jnp.transpose(M4.reshape(ncol, L, m * m), (1, 2, 0))


def _lev3(V3):
    """(ncol, L, 3) region-vector profile -> (L, 3, ncol)."""
    return jnp.transpose(V3, (1, 2, 0))


def _transfer_rates(reg_fracs, edge_length, dz, tan_angle, max_rate):
    """Transfer rates between regions (radiation_spartacus_sw.F90:259-296).

    reg_fracs/edge_length (..., 3), dz (...), tan_angle broadcastable.
    Returns (..., 3, 3) clamped at max_3d_transfer_rate."""
    f = reg_fracs

    def rate(el, fr):
        return jnp.where(fr > _EPS,
                         dz * el * tan_angle / jnp.maximum(fr, _EPS), 0.0)

    z = jnp.zeros_like(f[..., 0])
    row0 = jnp.stack([z, rate(edge_length[..., 0], f[..., 0]),
                      rate(edge_length[..., 2], f[..., 0])], -1)
    row1 = jnp.stack([rate(edge_length[..., 0], f[..., 1]), z,
                      rate(edge_length[..., 1], f[..., 1])], -1)
    row2 = jnp.stack([rate(edge_length[..., 2], f[..., 2]),
                      rate(edge_length[..., 1], f[..., 2]), z], -1)
    tr = jnp.stack([row0, row1, row2], -2)
    return jnp.minimum(tr, max_rate)


def _prep(config: Config, cloud_fraction, fractional_std, overlap_param,
          pressure_hl, temperature_hl, inv_cloud_size, inv_inhom_size):
    """Shared SPARTACUS geometry prep (radiation_spartacus_sw.F90:110-296)."""
    reg_fracs, od_scaling = calc_region_properties(
        cloud_fraction, fractional_std,
        config.cloud_pdf_shape == PdfShape.GAMMA,
        config.cloud_fraction_threshold,
        n_regions=config.nregions)
    u_mat, v_mat, cloud_cover = calc_overlap_matrices(
        reg_fracs, overlap_param, config.cloud_inhom_decorr_scaling,
        config.cloud_fraction_threshold)
    clear_layer = cloud_fraction <= 0.0

    phl, thl = pressure_hl, temperature_hl
    layer_depth = R_OVER_G * (phl[:, 1:] - phl[:, :-1]) \
        * (thl[:, :-1] + thl[:, 1:]) / (phl[:, :-1] + phl[:, 1:])

    max_inv_size = 1.0 / config.min_cloud_effective_size
    inv_size = jnp.minimum(inv_cloud_size, max_inv_size)
    if inv_inhom_size is None:
        inv_inhom = inv_size
    else:
        inv_inhom = jnp.minimum(inv_inhom_size, max_inv_size)

    active_3d = (config.do_3d_effects & ~clear_layer
                 & (inv_cloud_size > 0.0))
    f0 = reg_fracs[..., 0]
    f2 = reg_fracs[..., 2]
    el0 = FOUR_OVER_PI * f0 * (1.0 - f0) * inv_size
    el1 = FOUR_OVER_PI * f2 * (1.0 - f2) * inv_inhom
    if config.clear_to_thick_fraction > 0.0:
        el2 = config.clear_to_thick_fraction * jnp.minimum(el0, el1)
        el0 = el0 - el2
        el1 = el1 - el2
    else:
        el2 = jnp.zeros_like(el0)
    edge_length = jnp.where(active_3d[..., None],
                            jnp.stack([el0, el1, el2], -1), 0.0)

    return dict(reg_fracs=reg_fracs, od_scaling=od_scaling, u_mat=u_mat,
                v_mat=v_mat, cloud_cover=cloud_cover,
                clear_layer=clear_layer, layer_depth=layer_depth,
                edge_length=edge_length, active_3d=active_3d,
                inv_size=inv_size)


def _region_optics(config: Config, od, ssa, g, od_cloud_b, ssa_cloud_b,
                   g_cloud_b, band_from_g, od_scaling):
    """Per-region od/ssa/g, region axis LAST: (ncol, nlev, ng, 3).

    Follows radiation_spartacus_sw.F90:297-320: ssa/g from unclamped od,
    then od clamped at max_cloud_od."""
    od_c, ssa_c, g_c = _merge_regions(od, ssa, g, od_cloud_b, ssa_cloud_b,
                                      g_cloud_b, band_from_g, od_scaling)
    # (ncol, nlev, 2, ng) -> (ncol, nlev, ng, 2)
    od_c = jnp.moveaxis(od_c, -2, -1)
    ssa_c = jnp.moveaxis(ssa_c, -2, -1)
    g_c = jnp.moveaxis(g_c, -2, -1)
    od_c = jnp.minimum(od_c, config.max_cloud_od)
    od3 = jnp.concatenate([od[..., None], od_c], -1)
    ssa3 = jnp.concatenate([ssa[..., None], ssa_c], -1)
    g3 = jnp.concatenate([g[..., None], g_c], -1)
    return od3, ssa3, g3


def _use_expm_mask(config: Config, od_gas, active_3d):
    """Per-g expm mask implementing the ng3D prefix rule
    (radiation_spartacus_sw.F90:208-216, 326-330).  od_gas (ncol,nlev,ng)
    is the (reordered) clear-sky od; returns bool (ncol, nlev, ng)."""
    exceeds = od_gas > config.max_gas_od_3d
    any_exceeds = jnp.any(exceeds, axis=-1)
    first = jnp.argmax(exceeds, axis=-1)
    ng = od_gas.shape[-1]
    ng3d = jnp.where(any_exceeds, first, ng)
    prefix = jnp.arange(ng) < ng3d[..., None]
    if config.use_expm_everywhere:
        layer_on = jnp.ones_like(active_3d)
    else:
        layer_on = active_3d
    return prefix & layer_on[..., None]


def _level_chunk() -> int:
    """Levels vmapped per lax.map step of the layer-matrix builder
    (ECRAD_TPU_SPARTACUS_CHUNK, default 1).  A larger chunk batches more
    levels per step for a larger expm working set."""
    return int(os.environ.get("ECRAD_TPU_SPARTACUS_CHUNK", "1"))


class SwOpts(NamedTuple):
    """Static (compile-time) SW sweep options."""
    mode: object                 # Entrapment
    do_3d: bool
    overhang_factor: float
    cloud_fraction_threshold: float
    max_cloud_od: float


class LwOpts(NamedTuple):
    multilayer: bool


def _sw_up_core(carry, mats, cl5, u9b, v9b, msk, ent, opts: SwOpts):
    """One SW upward adding step in plane form — the pure math of
    radiation_spartacus_sw.F90:444-777, the body of the lax.scan
    up-sweep (all per-column inputs arrive broadcast-ready as (..., 1)
    planes).

    carry: (alb [[p]], albd [[p]], alb_c p, albd_c p, xdif [p], xdir [p])
    mats:  (R, T, Rd, Tdd, Tdir) as [[plane]]
    cl5:   (rcl, tcl, rdcl, tddcl, tdircl) clear-sky scalar planes
    u9b/v9b: 9 broadcast-ready (..., 1) overlap planes (k = 3*i + j)
    msk:   (clr, clr_above, migrate, ntop) bool (..., 1) planes
    ent:   (rf3, elp3, rfp3, invszp, opp, xld, xldir) broadcast-ready
    Returns the new carry (plane lists)."""
    alb, albd, alb_c, albd_c, xdif, xdir = carry
    R, T, Rd, Tdd, Tdir = mats
    rcl, tcl, rdcl, tddcl, tdircl = cl5
    cm, above_clear, mm, ntop = msk
    rf3, elp3, rfp3, invszp, opp, xld, xldir = ent
    explicit = opts.mode in (Entrapment.EXPLICIT,
                             Entrapment.EXPLICIT_NON_FRACTAL)
    alb = [list(row) for row in alb]
    albd = [list(row) for row in albd]
    xdif, xdir = list(xdif), list(xdir)
    u = [[u9b[NREG * i + j] for j in range(NREG)] for i in range(NREG)]
    v = [[v9b[NREG * i + j] for j in range(NREG)] for i in range(NREG)]

    # clear-sky scalar adding (radiation_spartacus_sw.F90:444-456)
    inv_d = 1.0 / (1.0 - alb_c * rcl)
    alb_c_new = rcl + tcl * tcl * alb_c * inv_d
    albd_c_new = rdcl + (tdircl * albd_c + tddcl * alb_c) * tcl * inv_d

    # layer adding: full matrix (radiation_spartacus_sw.F90:474-494)
    denom = _peye_minus(pl_matmul(alb, R))
    X = _pmat_add(R, pl_matmul(T, pl_solve_mat(denom,
                                               pl_matmul(alb, T))))
    srcm = _pmat_add(pl_matmul(albd, Tdir), pl_matmul(alb, Tdd))
    Xd = _pmat_add(Rd, pl_matmul(T, pl_solve_mat(denom, srcm)))
    # clear-layer scalar version (L458-473), region (0,0) only
    a00, ad00 = alb[0][0], albd[0][0]
    R00, T00 = R[0][0], T[0][0]
    inv_s = 1.0 / (1.0 - a00 * R00)
    s00 = R00 + T00 * T00 * a00 * inv_s
    sd00 = Rd[0][0] + (Tdir[0][0] * ad00 + Tdd[0][0] * a00) \
        * T00 * inv_s
    X = _pmat_where(cm, _pmat_embed00(s00, X), X)
    Xd = _pmat_where(cm, _pmat_embed00(sd00, Xd), Xd)

    # --- step_migrations (radiation_spartacus_sw.F90:966-1046)
    if explicit:
        cf = 1.0 - rf3[0]
        active_r = [cf < 1.0, cf > 0.0, cf > 0.0]
        for r in range(NREG):
            Rdg, Tdg = R[r][r], T[r][r]
            Rddg, Tddg, Tdirg = Rd[r][r], Tdd[r][r], Tdir[r][r]
            Adg, Addg = alb[r][r], albd[r][r]
            ms = Tdg / (1.0 - Rdg * Adg)
            xe = (1.0 - Rdg * Adg) ** (-1.5)
            top_alb_dir = jnp.maximum(
                1.0e-8, Rddg + ms * (Tddg * Adg + Tdirg * Addg))
            xdir_new = jnp.maximum(0.0, xldir + (
                (Tddg * Adg * xe + Tdirg * Addg * (xe - 1.0))
                * (xdif[r] + xld)
                + Tdirg * Addg * (xdir[r] + xldir))
                * Tdg / top_alb_dir)
            top_alb = jnp.maximum(1.0e-8, Rdg + ms * Tdg * Adg)
            xdif_new = xld + xe * Adg * Tdg * Tdg \
                * (xdif[r] + xld) / top_alb
            act = active_r[r]
            xdir_new = jnp.where(act, xdir_new, 0.0)
            xdif_new = jnp.where(act, xdif_new, 0.0)
            xdif[r] = jnp.where(mm, xdif_new, xdif[r])
            xdir[r] = jnp.where(mm, xdir_new, xdir[r])

    # --- overlap / entrapment mixing (radiation_spartacus_sw.F90:510-760)
    full = lambda A: pl_matmul(pl_matmul(u, A), v)
    fX, fXd = full(X), full(Xd)
    both_clear = cm & above_clear

    if opts.mode == Entrapment.MAXIMUM:
        alb_new, albd_new = fX, fXd
    elif opts.mode == Entrapment.ZERO:
        def zero_mix(A):
            colsum = [A[0][j] + A[1][j] + A[2][j]
                      for j in range(NREG)]     # sum over rows
            d = [sum(colsum[j] * v[j][i] for j in range(NREG))
                 for i in range(NREG)]
            z = jnp.zeros_like(d[0])
            return [[d[i] if i == j else z for j in range(NREG)]
                    for i in range(NREG)]
        alb_new = _pmat_where(above_clear, fX, zero_mix(X))
        albd_new = _pmat_where(above_clear, fXd, zero_mix(Xd))
    else:
        zpl = jnp.zeros_like(X[0][0])
        offd = lambda A: [[zpl if i == j else A[i][j]
                           for j in range(NREG)] for i in range(NREG)]
        base, based = full(offd(X)), full(offd(Xd))
        if opts.mode == Entrapment.EDGE_ONLY or not opts.do_3d:
            def dmix(A):
                d = [sum(A[j][j] * v[j][i] for j in range(NREG))
                     for i in range(NREG)]
                return [[d[i] if i == j else zpl
                         for j in range(NREG)] for i in range(NREG)]
            alb_new = _pmat_add(base, dmix(X))
            albd_new = _pmat_add(based, dmix(Xd))
        else:
            # Explicit entrapment (radiation_spartacus_sw.F90:586-760)
            acc = [[zpl] * NREG for _ in range(NREG)]
            accd = [[zpl] * NREG for _ in range(NREG)]
            for j2 in range(NREG):
                ts = 1.0 - (1.0 - opts.overhang_factor) * opp \
                    * jnp.minimum(rf3[j2], rfp3[j2]) \
                    / jnp.maximum(opts.cloud_fraction_threshold,
                                  rf3[j2])
                ts = jnp.where(ntop, ts, 0.0)

                def trd_entry(el_e, iup):
                    return ts * el_e \
                        / jnp.maximum(u9b[NREG * iup + j2], 1.0e-5)
                tr01 = trd_entry(elp3[0], 0)
                tr10 = trd_entry(elp3[0], 1)
                tr12 = trd_entry(elp3[1], 1)
                tr21 = trd_entry(elp3[1], 2)

                def entrap(xmig):
                    xj = xmig[j2]
                    if opts.mode == Entrapment.EXPLICIT:
                        ff = 1.0 / jnp.sqrt(jnp.maximum(
                            1.0, 2.5 * xj * invszp))
                    else:
                        ff = 1.0
                    e10 = tr01 * xj * ff
                    e01 = tr10 * xj * ff
                    e21 = tr12 * xj * ff
                    e12 = tr21 * xj * ff
                    e00 = -e10
                    e11 = -e01 - e21
                    max_entr = -jnp.minimum(e00, e11)
                    scale = jnp.where(
                        max_entr > opts.max_cloud_od,
                        opts.max_cloud_od
                        / jnp.maximum(max_entr, 1e-300), 1.0)
                    return (e10 * scale, e01 * scale, e21 * scale,
                            e12 * scale)

                Pm = pl_fast_expm_exchange_3(*entrap(xdif))
                Pmd = pl_fast_expm_exchange_3(*entrap(xdir))
                for i in range(NREG):
                    for j in range(NREG):
                        vxj = v9b[NREG * j2 + j]
                        acc[i][j] = acc[i][j] \
                            + Pm[i][j] * vxj * X[j2][j2]
                        accd[i][j] = accd[i][j] \
                            + Pmd[i][j] * vxj * Xd[j2][j2]
            alb_new = _pmat_add(base, acc)
            albd_new = _pmat_add(based, accd)
        alb_new = _pmat_where(above_clear, fX, alb_new)
        albd_new = _pmat_where(above_clear, fXd, albd_new)
    alb_new = _pmat_where(both_clear, _pmat_embed00(X[0][0], X),
                          alb_new)
    albd_new = _pmat_where(both_clear, _pmat_embed00(Xd[0][0], Xd),
                           albd_new)

    # migrate x through the interface (radiation_spartacus_sw.F90:758-777)
    if explicit:
        active_j2 = [jnp.ones_like(cm), ~cm, ~cm]

        def xm(x):
            return [sum(jnp.where(active_j2[j], x[j], 0.0)
                        * v9b[NREG * j + i]
                        for j in range(NREG)) for i in range(NREG)]

        nskip = ~both_clear
        xdif = _pvec_where(nskip, xm(xdif), xdif)
        xdir = _pvec_where(nskip, xm(xdir), xdir)

    return (alb_new, albd_new, alb_c_new, albd_c_new, xdif, xdir)


def _sw_dn_core(carry, mats, cl5, below, v9b, msk):
    """One SW downward step (radiation_spartacus_sw.F90:779-957).

    carry: (fdn [p], ddn [p], fdn_c p, ddn_c p)
    mats: (R, T, Rd, Tdd, Tdir) [[plane]]; cl5 clear-sky planes
    below: (alb_n [[p]], albd_n [[p]], alb_cn p, albd_cn p)
    v9b: 9 broadcast-ready planes of the interface BELOW
    msk: (clr, clr_below) bool broadcast-ready
    Returns (new_carry, (fup_sum, fdn_sum, ddn_sum, fup_c, fdn_c2,
    ddn_c2))."""
    fdn, ddn, fdn_c, ddn_c = carry
    R, T, Rd, Tdd, Tdir = mats
    rcl, tcl, rdcl, tddcl, tdircl = cl5
    alb_n, albd_n, alb_cn, albd_cn = below
    cm, clr_below = msk
    fdn, ddn = list(fdn), list(ddn)
    src = pl_matvec(Tdd, ddn)
    ddn_above = pl_matvec(Tdir, ddn)
    # clear-sky scalars
    src_c = tddcl * ddn_c
    ddn_c2 = tdircl * ddn_c
    fdn_c2 = (tcl * fdn_c + rcl * albd_cn * ddn_c2 + src_c) \
        / (1.0 - rcl * alb_cn)
    fup_c = albd_cn * ddn_c2 + alb_cn * fdn_c2
    # matrix branch
    denom = _peye_minus(pl_matmul(R, alb_n))
    tsrc = pl_matvec(albd_n, ddn_above)
    rhs = _pvec_add(_pvec_add(pl_matvec(T, fdn), pl_matvec(R, tsrc)),
                    src)
    fdn_above = pl_solve_vec(denom, rhs)
    fup_above = _pvec_add(pl_matvec(alb_n, fdn_above), tsrc)
    # clear-layer scalar branch, region 0
    f0 = (T[0][0] * fdn[0]
          + R[0][0] * albd_n[0][0] * ddn_above[0]
          + src[0]) / (1.0 - R[0][0] * alb_n[0][0])
    u0 = albd_n[0][0] * ddn_above[0] + alb_n[0][0] * f0
    fdn_above = _pvec_where(cm, _pvec_embed0(f0, fdn_above), fdn_above)
    fup_above = _pvec_where(cm, _pvec_embed0(u0, fup_above), fup_above)
    # through the interface below
    skip = cm & clr_below
    mix = lambda a: [sum(v9b[NREG * i + j] * a[j]
                         for j in range(NREG)) for i in range(NREG)]
    fdn_next = _pvec_where(skip, fdn_above, mix(fdn_above))
    ddn_next = _pvec_where(skip, ddn_above, mix(ddn_above))
    return (fdn_next, ddn_next, fdn_c2, ddn_c2), \
        (sum(fup_above), sum(fdn_above), sum(ddn_above),
         fup_c, fdn_c2, ddn_c2)


def _lw_up_core(carry, mats, cl4, u9b, v9b, msk, opts: LwOpts):
    """One LW upward step (radiation_spartacus_lw.F90:425-508).

    carry: (alb [[p]], src [p], alb_c p, src_c p)
    mats: (R, T, SU [p], SD [p]); cl4 = (rcl, tcl, sucl, sdcl)
    Returns the new carry."""
    alb, src, alb_c, src_c = carry
    R, T, SU, SD = mats
    rcl, tcl, sucl, sdcl = cl4
    cm, above_clear = msk
    alb = [list(row) for row in alb]
    src = list(src)
    u = [[u9b[NREG * i + j] for j in range(NREG)] for i in range(NREG)]
    v = [[v9b[NREG * i + j] for j in range(NREG)] for i in range(NREG)]
    # clear-sky scalar (radiation_spartacus_lw.F90:425-437)
    inv_d = 1.0 / (1.0 - alb_c * rcl)
    alb_c_new = rcl + tcl * tcl * alb_c * inv_d
    src_c_new = sucl + tcl * (src_c + alb_c * sdcl) * inv_d
    # matrix branch (L452-467)
    denom = _peye_minus(pl_matmul(alb, R))
    X = _pmat_add(R, pl_matmul(T, pl_solve_mat(denom,
                                               pl_matmul(alb, T))))
    rhs = _pvec_add(src, pl_matvec(alb, SD))
    S = _pvec_add(SU, pl_matvec(T, pl_solve_vec(denom, rhs)))
    # clear-layer scalar branch (L438-451), region 0
    a00 = alb[0][0]
    inv_s = 1.0 / (1.0 - a00 * R[0][0])
    x00 = R[0][0] + T[0][0] ** 2 * a00 * inv_s
    s0 = SU[0] + T[0][0] * (src[0] + a00 * SD[0]) * inv_s
    X = _pmat_where(cm, _pmat_embed00(x00, X), X)
    S = _pvec_where(cm, _pvec_embed0(s0, S), S)
    # mixing (L485-508)
    both_clear = cm & above_clear
    src_mixed = [sum(u[i][j] * S[j] for j in range(NREG))
                 for i in range(NREG)]
    src_new = _pvec_where(both_clear, _pvec_embed0(S[0], S), src_mixed)
    if opts.multilayer:
        mixed = pl_matmul(pl_matmul(u, X), v)
    else:
        d = [sum(X[j][j] * v[j][i] for j in range(NREG))
             for i in range(NREG)]
        z = jnp.zeros_like(d[0])
        mixed = [[d[i] if i == j else z for j in range(NREG)]
                 for i in range(NREG)]
    alb_new = _pmat_where(both_clear, _pmat_embed00(X[0][0], X), mixed)
    return (alb_new, src_new, alb_c_new, src_c_new)


def _lw_dn_core(carry, mats, cl4, below, v9b, msk):
    """One LW downward step (radiation_spartacus_lw.F90:509-595).

    carry: (fdn [p], fdn_c p); below: (src_n [p], alb_n [[p]],
    src_cn p, alb_cn p).  Returns (new_carry, (fup_sum, fdn_sum,
    fup_c, fdn_c2))."""
    fdn, fdn_c = carry
    R, T, SU, SD = mats
    rcl, tcl, sucl, sdcl = cl4
    src_n, alb_n, src_cn, alb_cn = below
    cm, clr_below = msk
    fdn = list(fdn)
    fdn_c2 = (tcl * fdn_c + rcl * src_cn + sdcl) \
        / (1.0 - rcl * alb_cn)
    fup_c = src_cn + alb_cn * fdn_c2
    denom = _peye_minus(pl_matmul(R, alb_n))
    rhs = _pvec_add(_pvec_add(pl_matvec(T, fdn),
                              pl_matvec(R, src_n)), SD)
    fdn_above = pl_solve_vec(denom, rhs)
    fup_above = _pvec_add(pl_matvec(alb_n, fdn_above), src_n)
    f0 = (T[0][0] * fdn[0] + R[0][0] * src_n[0] + SD[0]) \
        / (1.0 - R[0][0] * alb_n[0][0])
    u0 = src_n[0] + alb_n[0][0] * f0
    fdn_above = _pvec_where(cm, _pvec_embed0(f0, fdn_above), fdn_above)
    fup_above = _pvec_where(cm, _pvec_embed0(u0, fup_above), fup_above)
    skip = cm & clr_below
    mix = [sum(v9b[NREG * i + j] * fdn_above[j]
               for j in range(NREG)) for i in range(NREG)]
    fdn_next = _pvec_where(skip, fdn_above, mix)
    return (fdn_next, fdn_c2), \
        (sum(fup_above), sum(fdn_above), fup_c, fdn_c2)


def _map_levels(fn, xs, nlev, chunk=None):
    """lax.map over CHUNKS of levels instead of single levels.

    The per-level matrix builder (expm + LU solves) is dominated by
    sequential-dispatch overhead when run 137 times back to back; with
    ``chunk`` levels vmapped per map step the expensive ops batch and
    only ~nlev/chunk sequential rounds remain, while the plane
    temporaries stay bounded (vs batching all levels at once)."""
    chunk = chunk or _level_chunk()
    nchunk = -(-nlev // chunk)
    pad = nchunk * chunk - nlev

    def prep(x):
        if pad:
            x = jnp.concatenate([x, jnp.repeat(x[-1:], pad, 0)], 0)
        return x.reshape((nchunk, chunk) + x.shape[1:])

    xs = jax.tree_util.tree_map(prep, xs)
    # fn bodies are written for arbitrary leading batch dims (plane
    # form), so the chunk axis rides along as a plain batch dim
    out = jax.lax.map(fn, xs)
    return jax.tree_util.tree_map(
        lambda x: x.reshape((nchunk * chunk,) + x.shape[2:])[:nlev], out)


# ---------------------------------------------------------------------------
# Shortwave
# ---------------------------------------------------------------------------

@_highest_precision
@profiling.traced("radiation_spartacus_sw:solver_spartacus_sw")
def solver_spartacus_sw(config: Config, od, ssa, g, od_cloud_b,
                        ssa_cloud_b, g_cloud_b, band_from_g,
                        cloud_fraction, fractional_std, overlap_param,
                        inv_cloud_size, inv_inhom_size,
                        pressure_hl, temperature_hl,
                        incoming_sw, cos_sza, albedo_diffuse,
                        albedo_direct, spec_matrix=None) -> SwFluxes:
    """radiation_spartacus_sw.F90:41-965.  All g-dependent inputs must be
    in SPARTACUS (reordered) g order; band_from_g is the reordered map."""
    ncol, nlev, ng = od.shape
    dtype = od.dtype
    P = _prep(config, cloud_fraction, fractional_std, overlap_param,
              pressure_hl, temperature_hl, inv_cloud_size, inv_inhom_size)
    reg_fracs, u_mat, v_mat = P["reg_fracs"], P["u_mat"], P["v_mat"]
    clear_layer, edge_length = P["clear_layer"], P["edge_length"]

    # Night columns are masked at the end (the reference cycles them);
    # use mu0=1 there so the 1/mu0 Gamma entries keep expm norms small.
    day_mask = cos_sza >= 1.0e-10
    mu0 = jnp.where(day_mask, jnp.maximum(cos_sza, 1.0e-10), 1.0)
    one_over_mu0 = 1.0 / mu0
    # radiation_spartacus_sw.F90:168-176
    tan_sza = jnp.where(
        mu0 < MIN_MU0_3D,
        jnp.sqrt(1.0 / MIN_MU0_3D ** 2 - 1.0),
        jnp.where(one_over_mu0 > 1.0,
                  jnp.sqrt(jnp.maximum(one_over_mu0 ** 2 - 1.0, 0.0)
                           + config.overhead_sun_factor),
                  jnp.sqrt(config.overhead_sun_factor)))

    od3, ssa3, g3 = _region_optics(config, od, ssa, g, od_cloud_b,
                                   ssa_cloud_b, g_cloud_b, band_from_g,
                                   P["od_scaling"])
    use_expm = _use_expm_mask(config, od, P["active_3d"])
    any_expm = config.do_3d_effects or config.use_expm_everywhere

    tr_diff = _transfer_rates(reg_fracs, edge_length, P["layer_depth"],
                              TAN_DIFFUSE_ANGLE_3D,
                              config.max_3d_transfer_rate)
    tr_dir = _transfer_rates(reg_fracs, edge_length, P["layer_depth"],
                             tan_sza[:, None],
                             config.max_3d_transfer_rate)

    def layer_mats(xs):
        """Plane-form SW layer matrices for a chunk of levels: every
        quantity is a (chunk, ncol, ng) plane, so the 3x3..9x9 algebra
        never touches padded minor-dim tiles (see matrix.py plane
        algebra).  Returns the five R/T matrices stacked (chunk, 9,
        ncol, ng)."""
        od3l, ssa3l, g3l, trd, trdir, uem, clr = xs
        mu0p = mu0[:, None]                       # (ncol, 1)
        inv_mu0p = one_over_mu0[:, None]
        odr = [od3l[..., r] for r in range(NREG)]
        ssar = [ssa3l[..., r] for r in range(NREG)]
        gr = [g3l[..., r] for r in range(NREG)]
        zero = jnp.zeros_like(odr[0])
        r_p, t_p, rd_p, tdd_p, tdir_p = [], [], [], [], []
        g1r, g2r, g3r = [], [], []
        for r in range(NREG):
            g1, g2, g3_ = two_stream.sw_gammas(mu0p, ssar[r], gr[r])
            g1r.append(g1)
            g2r.append(g2)
            g3r.append(g3_)
            rr, tt, rd, tdd, tdir = two_stream.sw_ref_trans(
                mu0p, odr[r], ssar[r], gr[r])
            r_p.append(rr)
            t_p.append(tt)
            rd_p.append(rd)
            tdd_p.append(tdd)
            tdir_p.append(tdir)

        def diagm(v):
            return [[v[i] if i == j else zero for j in range(NREG)]
                    for i in range(NREG)]

        Rp, Tp = diagm(r_p), diagm(t_p)
        Rdp, Tddp, Tdirp = diagm(rd_p), diagm(tdd_p), diagm(tdir_p)
        if any_expm:
            def refine(mats):
                """Replace uem-masked entries by the expm-derived layer
                matrices.  Runs under a per-level lax.cond so levels
                with no 3D-active element (clear layers, or all g past
                the ng3D cutoff) skip the exponential entirely."""
                Rp, Tp, Rdp, Tddp, Tdirp = [
                    [list(row) for row in Mx] for Mx in mats]
                # Gamma assembly (radiation_spartacus_sw.F90:327-380);
                # transfer rates are per-column: broadcast (.., ncol, 1)
                def exch(trm):
                    t = [[trm[..., i, j][..., None] for j in range(NREG)]
                         for i in range(NREG)]
                    return [[(sum(t[i][k] for k in range(NREG))
                              if i == j else -t[j][i])
                             for j in range(NREG)] for i in range(NREG)]

                Xd = exch(trd)
                Xdir = exch(trdir)
                n2 = 2 * NREG
                # diffuse 6x6 block, direct 3x3 block, 6x3 coupling —
                # the lower-left 3x6 is structurally zero, so the
                # exponential runs blockwise (matrix.pl_expm_blockut)
                A11 = [[zero] * n2 for _ in range(n2)]
                A13 = [[zero] * NREG for _ in range(n2)]
                A33 = [[zero] * NREG for _ in range(NREG)]
                for i in range(NREG):
                    for j in range(NREG):
                        Dij = (odr[i] * g1r[i] if i == j else zero) \
                            + Xd[i][j]
                        A11[i][j] = Dij
                        A11[NREG + i][NREG + j] = -Dij
                        A33[i][j] = -Xdir[i][j] + (
                            -odr[i] * inv_mu0p if i == j else zero)
                    A11[i][NREG + i] = -odr[i] * g2r[i]
                    A11[NREG + i][i] = odr[i] * g2r[i]
                    A13[i][i] = -odr[i] * ssar[i] * g3r[i]
                    A13[NREG + i][i] = odr[i] * ssar[i] * (1.0 - g3r[i])
                Eb11, Eb13, Eb33 = pl_expm_blockut(A11, A13, A33)
                E11 = [row[0:NREG] for row in Eb11[0:NREG]]
                E12 = [row[NREG:n2] for row in Eb11[0:NREG]]
                E13 = [row[:] for row in Eb13[0:NREG]]
                E21 = [row[0:NREG] for row in Eb11[NREG:n2]]
                E22 = [row[NREG:n2] for row in Eb11[NREG:n2]]
                E23 = [row[:] for row in Eb13[NREG:n2]]
                tdir_e = [[jnp.clip(Eb33[i][j], 0.0, 1.0)
                           for j in range(NREG)] for i in range(NREG)]
                sm12 = pl_solve_mat(E11, E12)
                refl_e = [[jnp.clip(-sm12[i][j], 0.0, 1.0)
                           for j in range(NREG)] for i in range(NREG)]
                tr21 = pl_matmul(E21, refl_e)
                trans_e = [[jnp.clip(tr21[i][j] + E22[i][j], 0.0, 1.0)
                            for j in range(NREG)] for i in range(NREG)]
                sm13 = pl_solve_mat(E11, E13)
                rdir_e = [[jnp.clip(-sm13[i][j], 0.0, mu0p)
                           for j in range(NREG)] for i in range(NREG)]
                td21 = pl_matmul(E21, rdir_e)
                tdd_e = [[jnp.clip(td21[i][j] + E23[i][j], 0.0, mu0p)
                          for j in range(NREG)] for i in range(NREG)]
                for i in range(NREG):
                    for j in range(NREG):
                        Rp[i][j] = jnp.where(uem, refl_e[i][j], Rp[i][j])
                        Tp[i][j] = jnp.where(uem, trans_e[i][j],
                                             Tp[i][j])
                        Rdp[i][j] = jnp.where(uem, rdir_e[i][j],
                                              Rdp[i][j])
                        Tddp[i][j] = jnp.where(uem, tdd_e[i][j],
                                               Tddp[i][j])
                        Tdirp[i][j] = jnp.where(uem, tdir_e[i][j],
                                                Tdirp[i][j])
                tup = lambda Mx: tuple(tuple(row) for row in Mx)
                return tuple(tup(Mx) for Mx in (Rp, Tp, Rdp, Tddp,
                                                Tdirp))

            shp = odr[0].shape
            tup5 = tuple(
                tuple(tuple(jnp.broadcast_to(x, shp) for x in row)
                      for row in Mx)
                for Mx in (Rp, Tp, Rdp, Tddp, Tdirp))
            mats = jax.lax.cond(jnp.any(uem), refine, lambda m: m, tup5)
            Rp, Tp, Rdp, Tddp, Tdirp = [
                [list(row) for row in Mx] for Mx in mats]
        # clear layers keep only [0][0] (select, never a 0/1 multiply:
        # the masked entries can be NaN from the degenerate expm/solve
        # on all-zero cloudy regions and NaN*0 = NaN would leak into
        # consumers that reduce over all entries)
        clrb = clr[..., None]
        z0 = jnp.zeros((), dtype)
        for Mx in (Rp, Tp, Rdp, Tddp, Tdirp):
            for i in range(NREG):
                for j in range(NREG):
                    if i == 0 and j == 0:
                        continue
                    Mx[i][j] = jnp.where(clrb, z0, Mx[i][j])
        shp = odr[0].shape
        stk = lambda Pm: jnp.stack(
            [jnp.broadcast_to(x, shp) for row in Pm for x in row], axis=1)
        return stk(Rp), stk(Tp), stk(Rdp), stk(Tddp), stk(Tdirp)

    lev = lambda a: jnp.moveaxis(a, 1, 0)
    xs_mats = (lev(od3), lev(ssa3), lev(g3), lev(tr_diff), lev(tr_dir),
               lev(use_expm), lev(clear_layer))
    # (nlev, 9, ncol, ng) each
    Rs, Ts, Rds, Tdds, Tdirs = _map_levels(layer_mats, xs_mats, nlev)

    # clear-sky scalar layer properties
    r_cl, t_cl, rd_cl, tdd_cl, tdir_cl = two_stream.sw_ref_trans(
        mu0[:, None, None], od, ssa, g)

    clear_pad = jnp.concatenate(
        [jnp.ones((ncol, 1), bool), clear_layer,
         jnp.ones((ncol, 1), bool)], axis=1)  # layer index -1..nlev
    # condition "jlev >= i_cloud_top": a cloudy layer exists at or above
    at_or_below_cloud_top = jnp.cumsum(~clear_layer, axis=1) > 0

    mode = config.sw_entrapment
    explicit = mode in (Entrapment.EXPLICIT, Entrapment.EXPLICIT_NON_FRACTAL)

    # per-level views of "layer above" (index ell-1) quantities
    pad0 = lambda a: jnp.concatenate([jnp.zeros_like(a[:, :1]), a], axis=1)
    el_above = pad0(edge_length)[:, :-1]
    rf_above = pad0(reg_fracs)[:, :-1]
    inv_size_above = pad0(P["inv_size"])[:, :-1]
    # overlap_param between layer ell-1 and ell (zero-padded at ell=0)
    op_above = jnp.concatenate(
        [jnp.zeros((ncol, 1), dtype), overlap_param], axis=1)
    not_top = jnp.arange(nlev) > 0                # "jlev > 1"

    x_lay_dif_all = P["layer_depth"] * (TAN_DIFFUSE_ANGLE_3D / np.sqrt(2.0))
    x_lay_dir_all = P["layer_depth"] * 0.5 * jnp.sqrt(
        tan_sza[:, None] ** 2 + TAN_DIFFUSE_ANGLE_3D ** 2)

    sw_opts = SwOpts(mode=mode, do_3d=config.do_3d_effects,
                     overhang_factor=config.overhang_factor,
                     cloud_fraction_threshold=(
                         config.cloud_fraction_threshold),
                     max_cloud_od=config.max_cloud_od)

    zcg = jnp.zeros((ncol, ng), dtype)
    bc = lambda x: jnp.broadcast_to(x, (ncol, ng)).astype(dtype)
    alb0 = tuple(tuple(bc(albedo_diffuse) if i == j else zcg
                       for j in range(NREG)) for i in range(NREG))
    albd0 = tuple(tuple(bc(mu0[:, None] * albedo_direct) if i == j
                        else zcg for j in range(NREG))
                  for i in range(NREG))
    ddn0 = tuple(incoming_sw * reg_fracs[:, 0, r][:, None]
                 for r in range(NREG))

    def up_step(carry, xs):
        """Thin scan wrapper over _sw_up_core: unpack the stacked
        planes, broadcast the per-column scalars, emit the ENTRY
        carry as this level's ys."""
        alb, albd, alb_c, albd_c, xdif, xdir = carry
        (R9, T9, Rd9, Tdd9, Tdir9, rcl, tcl, rdcl, tddcl, tdircl,
         u9, v9, clr, clr_above, migrate, rf3, elp3, rfp3, invszp,
         opp, ntop, xld, xldir) = xs
        b = lambda x: x[:, None]
        mats = tuple(_punstack(x)
                     for x in (R9, T9, Rd9, Tdd9, Tdir9))
        u9b = [b(u9[k]) for k in range(NREG * NREG)]
        v9b = [b(v9[k]) for k in range(NREG * NREG)]
        msk = (b(clr), b(clr_above), b(migrate), b(ntop))
        ent = ([b(rf3[r]) for r in range(NREG)],
               [b(elp3[r]) for r in range(NREG)],
               [b(rfp3[r]) for r in range(NREG)],
               b(invszp), b(opp), b(xld), b(xldir))
        out_albs = (_pstack([list(r) for r in alb]),
                    _pstack([list(r) for r in albd]), alb_c, albd_c)
        alb_n, albd_n, alb_c_n, albd_c_n, xdif_n, xdir_n = \
            _sw_up_core(
                (alb, albd, alb_c, albd_c, xdif, xdir), mats,
                (rcl, tcl, rdcl, tddcl, tdircl), u9b, v9b, msk,
                ent, sw_opts)
        tup = lambda A: tuple(tuple(row) for row in A)
        return (tup(alb_n), tup(albd_n), alb_c_n, albd_c_n,
                tuple(xdif_n), tuple(xdir_n)), out_albs

    carry0 = (alb0, albd0, bc(albedo_diffuse),
              bc(mu0[:, None] * albedo_direct),
              (zcg,) * NREG, (zcg,) * NREG)
    xs_up = (Rs, Ts, Rds, Tdds, Tdirs,
             lev(r_cl), lev(t_cl), lev(rd_cl), lev(tdd_cl),
             lev(tdir_cl),
             _lev9(u_mat[:, :-1]), _lev9(v_mat[:, :-1]),
             lev(clear_layer), lev(clear_pad[:, :-2]),
             lev(at_or_below_cloud_top), _lev3(reg_fracs),
             _lev3(el_above), _lev3(rf_above), lev(inv_size_above),
             lev(op_above),
             jnp.broadcast_to(not_top[:, None], (nlev, ncol)),
             lev(x_lay_dif_all), lev(x_lay_dir_all))
    (alb_f, albd_f, alb_c_f, albd_c_f, _, _), \
        (alb_s9, albd_s9, alb_c_s, albd_c_s) = jax.lax.scan(
            up_step, carry0, xs_up, reverse=True)

    # ---- downward pass (radiation_spartacus_sw.F90:779-957)
    def dn_step(carry, xs):
        fdn, ddn, fdn_c, ddn_c = carry
        (R9, T9, Rd9, Tdd9, Tdir9, rcl, tcl, rdcl, tddcl, tdircl,
         alb_n9, albd_n9, alb_cn, albd_cn, v9b_, clr,
         clr_below) = xs
        b = lambda x: x[:, None]
        mats = tuple(_punstack(x)
                     for x in (R9, T9, Rd9, Tdd9, Tdir9))
        below = (_punstack(alb_n9), _punstack(albd_n9), alb_cn,
                 albd_cn)
        v9b = [b(v9b_[k]) for k in range(NREG * NREG)]
        (fdn_n, ddn_n, fdn_c2, ddn_c2), ys = _sw_dn_core(
            (fdn, ddn, fdn_c, ddn_c), mats,
            (rcl, tcl, rdcl, tddcl, tdircl), below, v9b,
            (b(clr), b(clr_below)))
        return (tuple(fdn_n), tuple(ddn_n), fdn_c2, ddn_c2), ys

    carry_dn0 = ((zcg,) * NREG, ddn0, zcg, bc(incoming_sw))
    xs_dn = (Rs, Ts, Rds, Tdds, Tdirs,
             lev(r_cl), lev(t_cl), lev(rd_cl), lev(tdd_cl),
             lev(tdir_cl),
             alb_s9, albd_s9, alb_c_s, albd_c_s,
             _lev9(v_mat[:, 1:]), lev(clear_layer),
             lev(clear_pad[:, 2:]))
    _, (fup_l, fdn_l, fdir_l, fup_cl, fdn_cl, fdir_cl) = \
        jax.lax.scan(dn_step, carry_dn0, xs_dn)

    fup_toa = sum(pl_matvec([list(r) for r in albd_f], list(ddn0)))
    fup_toa_c = incoming_sw * albd_c_f

    tolev = lambda a: jnp.moveaxis(a, 0, 1)
    # half-level (ncol, nlev+1, ng) profiles, regions already summed
    fup_g = jnp.concatenate([fup_toa[:, None], tolev(fup_l)], 1)
    fdn_diff_g = jnp.concatenate([jnp.zeros((ncol, 1, ng), dtype),
                                  tolev(fdn_l)], 1)
    fdir_g = jnp.concatenate([incoming_sw[:, None], tolev(fdir_l)], 1)
    fup_c_g = jnp.concatenate([fup_toa_c[:, None], tolev(fup_cl)], 1)
    fdn_c_g = jnp.concatenate([jnp.zeros((ncol, 1, ng), dtype),
                               tolev(fdn_cl)], 1)
    fdir_c_g = jnp.concatenate([incoming_sw[:, None], tolev(fdir_cl)], 1)

    mu0c = cos_sza[:, None, None]
    fdir_g = jnp.maximum(mu0c, 0.0) * fdir_g
    fdir_c_g = jnp.maximum(mu0c, 0.0) * fdir_c_g

    day = cos_sza >= 1.0e-10
    zn = lambda a: jnp.where(day[:, None, None], a, 0.0)
    fup_g, fdn_diff_g, fdir_g = zn(fup_g), zn(fdn_diff_g), zn(fdir_g)
    fup_c_g, fdn_c_g, fdir_c_g = zn(fup_c_g), zn(fdn_c_g), zn(fdir_c_g)

    return sw_from_g_profiles(
        flux_up_g=fup_g, flux_dn_diffuse_g=fdn_diff_g,
        flux_dn_direct_g=fdir_g,
        flux_up_clear_g=fup_c_g, flux_dn_diffuse_clear_g=fdn_c_g,
        flux_dn_direct_clear_g=fdir_c_g,
        cloud_cover=P["cloud_cover"], spec_matrix=spec_matrix)


# ---------------------------------------------------------------------------
# Longwave
# ---------------------------------------------------------------------------

@_highest_precision
@profiling.traced("radiation_spartacus_lw:solver_spartacus_lw")
def solver_spartacus_lw(config: Config, od, ssa, g, od_cloud_b,
                        ssa_cloud_b, g_cloud_b, band_from_g,
                        cloud_fraction, fractional_std, overlap_param,
                        inv_cloud_size, inv_inhom_size,
                        pressure_hl, temperature_hl,
                        planck_hl, emission, albedo,
                        spec_matrix=None) -> LwFluxes:
    """radiation_spartacus_lw.F90:35-607.  g-dependent inputs reordered."""
    ncol, nlev, ng = od.shape
    dtype = od.dtype
    P = _prep(config, cloud_fraction, fractional_std, overlap_param,
              pressure_hl, temperature_hl, inv_cloud_size, inv_inhom_size)
    reg_fracs, u_mat, v_mat = P["reg_fracs"], P["u_mat"], P["v_mat"]
    clear_layer, edge_length = P["clear_layer"], P["edge_length"]

    if not config.do_lw_aerosol_scattering:
        ssa = jnp.zeros_like(od)
        g = jnp.zeros_like(od)
    if config.do_lw_cloud_scattering:
        od3, ssa3, g3 = _region_optics(config, od, ssa, g, od_cloud_b,
                                       ssa_cloud_b, g_cloud_b, band_from_g,
                                       P["od_scaling"])
    else:
        zb = jnp.zeros_like(od_cloud_b)
        od3, ssa3, g3 = _region_optics(config, od, ssa, g, od_cloud_b,
                                       zb, zb, band_from_g,
                                       P["od_scaling"])
    use_expm = _use_expm_mask(config, od, P["active_3d"])
    any_expm = config.do_3d_effects or config.use_expm_everywhere

    tr = _transfer_rates(reg_fracs, edge_length, P["layer_depth"],
                         TAN_DIFFUSE_ANGLE_3D, config.max_3d_transfer_rate)

    # side emissivity (radiation_spartacus_lw.F90:289-310)
    f0 = reg_fracs[..., 0]
    f1 = reg_fracs[..., 1]
    if config.do_lw_side_emissivity and config.do_3d_effects:
        aspect = 1.0 / jnp.maximum(
            P["inv_size"] * f0 * P["layer_depth"], 1e-30)
        lateral_od = (aspect[..., None] / (NREG - 1.0)) * jnp.sum(
            od3[..., 1:] * (1.0 - ssa3[..., 1:]), -1)
        sq1 = jnp.sqrt(jnp.maximum(1.0 - ssa3[..., 1], 0.0))
        thick = 2.0 * sq1 / (sq1 + jnp.sqrt(
            jnp.maximum(1.0 - ssa3[..., 1] * g3[..., 1], 0.0)))
        side = (SIDE_EMISS_THIN - thick) / (lateral_od + 1.0) + thick
        cond = ((f0 > 0.0) & (f1 > 0.0)
                & (P["inv_size"] > 0.0))[..., None]
        side_emiss = jnp.where(cond, side, 1.0)
    else:
        side_emiss = jnp.ones_like(od3[..., 0])

    pl_top = planck_hl[:, :-1]                   # (ncol, nlev, ng)
    pl_bot = planck_hl[:, 1:]

    def layer_mats(xs):
        """Plane-form LW layer matrices for a chunk of levels (see the
        SW twin and matrix.py plane algebra).  Returns R, T stacked
        (chunk, 9, ncol, ng) and src_up/src_dn stacked (chunk, 3, ncol,
        ng)."""
        od3l, ssa3l, g3l, trl, sidel, rf, clr, plt, plb, uem = xs
        odr = [od3l[..., r] for r in range(NREG)]
        ssar = [ssa3l[..., r] for r in range(NREG)]
        gr = [g3l[..., r] for r in range(NREG)]
        rfr = [rf[..., r][..., None] for r in range(NREG)]
        zero = jnp.zeros_like(odr[0])
        r_p, t_p, su_p, sd_p, g1r, g2r = [], [], [], [], [], []
        for r in range(NREG):
            g1, g2 = two_stream.lw_gammas(ssar[r], gr[r])
            g1r.append(g1)
            g2r.append(g2)
            rr, tt, su, sd = two_stream.lw_ref_trans(
                odr[r], ssar[r], gr[r], rfr[r] * plt, rfr[r] * plb)
            r_p.append(rr)
            t_p.append(tt)
            su_p.append(su)
            sd_p.append(sd)
        Rp = [[r_p[i] if i == j else zero for j in range(NREG)]
              for i in range(NREG)]
        Tp = [[t_p[i] if i == j else zero for j in range(NREG)]
              for i in range(NREG)]
        src_up = su_p
        src_dn = sd_p
        if any_expm:
            def refine(state):
                """Replace uem-masked entries by the expm-derived layer
                matrices and sources; runs under a per-level lax.cond
                so levels with no 3D-active element skip the 6x6
                exponential entirely."""
                Rp, Tp, src_up, src_dn = state
                Rp = [list(row) for row in Rp]
                Tp = [list(row) for row in Tp]
                src_up, src_dn = list(src_up), list(src_dn)
                # side-emissivity-scaled transfer rates
                # (radiation_spartacus_lw.F90:311-338)
                trs = [[trl[..., i, j][..., None] + zero
                        for j in range(NREG)] for i in range(NREG)]
                trs[1][0] = trs[1][0] * sidel
                trs[2][0] = trs[2][0] * sidel
                # exchange: X[i][i] = sum_j tr[i][j]; X[i][j] = -tr[j][i]
                D = [[(odr[i] * g1r[i]
                       + sum(trs[i][k] for k in range(NREG))
                       if i == j else -trs[j][i])
                      for j in range(NREG)] for i in range(NREG)]
                G2d = [odr[r] * g2r[r] for r in range(NREG)]
                G = [[None] * (2 * NREG) for _ in range(2 * NREG)]
                for i in range(NREG):
                    for j in range(NREG):
                        G[i][j] = D[i][j]
                        G[i][NREG + j] = -G2d[i] if i == j else zero
                        G[NREG + i][j] = G2d[i] if i == j else zero
                        G[NREG + i][NREG + j] = -D[i][j]
                # Thin sub-layer of 2^-n the depth (G, the emissivity and
                # the Planck increment all scale with depth), then n
                # doublings.  Taking R and T of the whole layer from its
                # own exponential (T = E22 - E21 E11^-1 E12) cancels
                # terms of size exp(k od) down to exp(-k od), which
                # float32 cannot resolve in thick cloud; the doubling
                # (adding of two identical sub-layers) has no such
                # cancellation.
                scale = 0.5 ** _LW_DOUBLINGS
                Gs = [[x * scale for x in row] for row in G]
                e_s = [odr[r] * (1.0 - ssar[r]) * rfr[r]
                       * (LW_DIFFUSIVITY * scale) for r in range(NREG)]
                E = pl_expm(Gs, max_squarings=6)
                E11 = [row[0:NREG] for row in E[0:NREG]]
                E12 = [row[NREG:] for row in E[0:NREG]]
                E21 = [row[0:NREG] for row in E[NREG:]]
                E22 = [row[NREG:] for row in E[NREG:]]
                R_e = [[-x for x in row]
                       for row in pl_solve_mat(E11, E12)]
                T_e = pl_matmul(E21, R_e)
                T_e = [[T_e[i][j] + E22[i][j] for j in range(NREG)]
                       for i in range(NREG)]

                def sources(sol0, sol_d):
                    v12 = pl_matvec(E12, sol0[NREG:])
                    tmp = [sol0[i] + sol_d[i] - v12[i]
                           for i in range(NREG)]
                    xs_ = pl_solve_vec(E11, tmp)
                    su = [sol0[i] - xs_[i] for i in range(NREG)]
                    v21 = pl_matvec(E21, [su[i] - sol0[i]
                                          for i in range(NREG)])
                    v22 = pl_matvec(E22, sol0[NREG:])
                    sd = [v21[i] + sol0[NREG + i] - v22[i]
                          + sol_d[NREG + i] for i in range(NREG)]
                    return su, sd

                # sources are linear in the Planck function at the
                # sub-layer top (a) and its increment across it (b)
                pe = [-x for x in e_s] + list(e_s)
                au, ad = sources(pl_solve_vec(Gs, [-x for x in pe]),
                                 [zero] * (2 * NREG))
                sol_d = [-x for x in pl_solve_vec(Gs, pe)]
                bu, bd = sources(pl_solve_vec(Gs, sol_d), sol_d)
                one = jnp.ones_like(zero)
                eye = [[one if i == j else zero for j in range(NREG)]
                       for i in range(NREG)]
                for _ in range(_LW_DOUBLINGS):
                    tm = pl_matmul(T_e, pl_solve_mat(
                        _peye_minus(pl_matmul(R_e, R_e)), eye))
                    rau, rad = pl_matvec(R_e, au), pl_matvec(R_e, ad)
                    rbu, rbd = pl_matvec(R_e, bu), pl_matvec(R_e, bd)
                    up_a = pl_matvec(tm, [au[i] + rad[i]
                                          for i in range(NREG)])
                    up_b = pl_matvec(tm, [au[i] + bu[i] + rbd[i]
                                          for i in range(NREG)])
                    dn_a = pl_matvec(tm, [ad[i] + rau[i]
                                          for i in range(NREG)])
                    dn_b = pl_matvec(tm, [bd[i] + rau[i] + rbu[i]
                                          for i in range(NREG)])
                    au, bu, ad, bd = (
                        [au[i] + up_a[i] for i in range(NREG)],
                        [0.5 * (bu[i] + up_b[i]) for i in range(NREG)],
                        [ad[i] + dn_a[i] for i in range(NREG)],
                        [0.5 * (ad[i] + bd[i] + dn_b[i])
                         for i in range(NREG)])
                    R_e = _pmat_add(R_e, pl_matmul(pl_matmul(tm, R_e),
                                                   T_e))
                    T_e = pl_matmul(tm, T_e)
                dpl = plb - plt
                su_e = [au[i] * plt + bu[i] * dpl for i in range(NREG)]
                sd_e = [ad[i] * plt + bd[i] * dpl for i in range(NREG)]
                for i in range(NREG):
                    for j in range(NREG):
                        Rp[i][j] = jnp.where(uem, R_e[i][j], Rp[i][j])
                        Tp[i][j] = jnp.where(uem, T_e[i][j], Tp[i][j])
                src_up = [jnp.where(uem, su_e[r], src_up[r])
                          for r in range(NREG)]
                src_dn = [jnp.where(uem, sd_e[r], src_dn[r])
                          for r in range(NREG)]
                tup = lambda Mx: tuple(tuple(row) for row in Mx)
                return (tup(Rp), tup(Tp), tuple(src_up), tuple(src_dn))

            shp0 = odr[0].shape
            bcp = lambda x: jnp.broadcast_to(x, shp0)
            state0 = (tuple(tuple(bcp(x) for x in row) for row in Rp),
                      tuple(tuple(bcp(x) for x in row) for row in Tp),
                      tuple(bcp(x) for x in src_up),
                      tuple(bcp(x) for x in src_dn))
            Rp, Tp, src_up, src_dn = jax.lax.cond(
                jnp.any(uem), refine, lambda s: s, state0)
            Rp = [list(row) for row in Rp]
            Tp = [list(row) for row in Tp]
            src_up, src_dn = list(src_up), list(src_dn)
        # clear layers: only the [0][0] / region-0 entries survive
        # (select, never a 0/1 multiply — masked entries may be NaN
        # from the degenerate expm branch)
        clrb = clr[..., None]
        z0 = jnp.zeros((), dtype)
        for i in range(NREG):
            for j in range(NREG):
                if i == 0 and j == 0:
                    continue
                Rp[i][j] = jnp.where(clrb, z0, Rp[i][j])
                Tp[i][j] = jnp.where(clrb, z0, Tp[i][j])
        for r in range(1, NREG):
            src_up[r] = jnp.where(clrb, z0, src_up[r])
            src_dn[r] = jnp.where(clrb, z0, src_dn[r])
        shp = odr[0].shape
        stk = lambda Pm: jnp.stack(
            [jnp.broadcast_to(x, shp) for row in Pm for x in row], axis=1)
        stkv = lambda pv: jnp.stack(
            [jnp.broadcast_to(x, shp) for x in pv], axis=1)
        return stk(Rp), stk(Tp), stkv(src_up), stkv(src_dn)

    lev = lambda a: jnp.moveaxis(a, 1, 0)
    xs_mats = (lev(od3), lev(ssa3), lev(g3), lev(tr), lev(side_emiss),
               lev(reg_fracs), lev(clear_layer), lev(pl_top),
               lev(pl_bot), lev(use_expm))
    # R/T (nlev, 9, ncol, ng); SU/SD (nlev, 3, ncol, ng)
    Rs, Ts, SUs, SDs = _map_levels(layer_mats, xs_mats, nlev)

    # clear-sky scalar layer properties
    r_cl, t_cl, su_cl, sd_cl = two_stream.lw_ref_trans(
        od, ssa, g, pl_top, pl_bot)

    clear_pad = jnp.concatenate(
        [jnp.ones((ncol, 1), bool), clear_layer,
         jnp.ones((ncol, 1), bool)], axis=1)
    multilayer = config.do_3d_lw_multilayer_effects

    lw_opts = LwOpts(multilayer=multilayer)

    zcg = jnp.zeros((ncol, ng), dtype)
    bc = lambda x: jnp.broadcast_to(x, (ncol, ng)).astype(dtype)
    alb0 = tuple(tuple(bc(albedo) if i == j else zcg
                       for j in range(NREG)) for i in range(NREG))
    src0 = tuple(emission * reg_fracs[:, -1, r][:, None]
                 for r in range(NREG))

    def up_step(carry, xs):
        alb, src, alb_c, src_c = carry
        (R9, T9, SU3, SD3, rcl, tcl, sucl, sdcl, u9, v9, clr,
         clr_above) = xs
        b = lambda x: x[:, None]
        out = (_pstack([list(r) for r in alb]), _pstack(list(src)),
               alb_c, src_c)
        mats = (_punstack(R9), _punstack(T9),
                [SU3[r] for r in range(NREG)],
                [SD3[r] for r in range(NREG)])
        u9b = [b(u9[k]) for k in range(NREG * NREG)]
        v9b = [b(v9[k]) for k in range(NREG * NREG)]
        alb_n, src_n, alb_c_n, src_c_n = _lw_up_core(
            (alb, src, alb_c, src_c), mats, (rcl, tcl, sucl, sdcl),
            u9b, v9b, (b(clr), b(clr_above)), lw_opts)
        tup = lambda A: tuple(tuple(row) for row in A)
        return (tup(alb_n), tuple(src_n), alb_c_n, src_c_n), out

    carry0 = (alb0, src0, bc(albedo), bc(emission))
    xs_up = (Rs, Ts, SUs, SDs,
             lev(r_cl), lev(t_cl), lev(su_cl), lev(sd_cl),
             _lev9(u_mat[:, :-1]), _lev9(v_mat[:, :-1]),
             lev(clear_layer), lev(clear_pad[:, :-2]))
    (alb_f, src_f, alb_c_f, src_c_f), \
        (alb_s9, src_s3, alb_c_s, src_c_s) \
        = jax.lax.scan(up_step, carry0, xs_up, reverse=True)

    # ---- downward pass (radiation_spartacus_lw.F90:509-595)
    def dn_step(carry, xs):
        fdn, fdn_c = carry
        (R9, T9, SU3, SD3, rcl, tcl, sucl, sdcl, src_n3, alb_n9,
         src_cn, alb_cn, v9b_, clr, clr_below) = xs
        b = lambda x: x[:, None]
        mats = (_punstack(R9), _punstack(T9),
                [SU3[r] for r in range(NREG)],
                [SD3[r] for r in range(NREG)])
        below = ([src_n3[r] for r in range(NREG)],
                 _punstack(alb_n9), src_cn, alb_cn)
        v9b = [b(v9b_[k]) for k in range(NREG * NREG)]
        (fdn_n, fdn_c2), ys = _lw_dn_core(
            (fdn, fdn_c), mats, (rcl, tcl, sucl, sdcl), below, v9b,
            (b(clr), b(clr_below)))
        return (tuple(fdn_n), fdn_c2), ys

    carry_dn0 = ((zcg,) * NREG, zcg)
    xs_dn = (Rs, Ts, SUs, SDs,
             lev(r_cl), lev(t_cl), lev(su_cl), lev(sd_cl),
             src_s3, alb_s9, src_c_s, alb_c_s,
             _lev9(v_mat[:, 1:]), lev(clear_layer),
             lev(clear_pad[:, 2:]))
    _, (fup_l, fdn_l, fup_cl, fdn_cl) = jax.lax.scan(
        dn_step, carry_dn0, xs_dn)

    tolev = lambda a: jnp.moveaxis(a, 0, 1)
    fup_g = jnp.concatenate([sum(src_f)[:, None], tolev(fup_l)], 1)
    fdn_g = jnp.concatenate([jnp.zeros((ncol, 1, ng), dtype),
                             tolev(fdn_l)], 1)
    fup_c_g = jnp.concatenate([src_c_f[:, None], tolev(fup_cl)], 1)
    fdn_c_g = jnp.concatenate([jnp.zeros((ncol, 1, ng), dtype),
                               tolev(fdn_cl)], 1)

    lw_derivatives = None
    if config.do_lw_derivatives:
        # calc_lw_derivatives_matrix (radiation_lw_derivatives.F90:138-193)
        fup_surf_g = fup_l[-1]                    # (ncol, ng), regions
        dinit = tuple(
            fup_surf_g / jnp.maximum(
                jnp.sum(fup_surf_g, -1, keepdims=True), 1e-300)
            if r == 0 else zcg for r in range(NREG))

        def deriv_step(d, xs):
            T9, u9b = xs
            T = _punstack(T9)
            d = [sum(u9b[NREG * i + j][:, None] * d[j]
                     for j in range(NREG)) for i in range(NREG)]
            d = pl_matvec(T, d)
            return tuple(d), sum(jnp.sum(dr, axis=-1) for dr in d)

        _, dvals = jax.lax.scan(
            deriv_step, dinit, (Ts, _lev9(u_mat[:, 1:])), reverse=True)
        lw_derivatives = jnp.concatenate(
            [dvals.T, jnp.ones((ncol, 1), dtype)], 1)

    return lw_from_g_profiles(
        flux_up_g=fup_g, flux_dn_g=fdn_g,
        flux_up_clear_g=fup_c_g, flux_dn_clear_g=fdn_c_g,
        cloud_cover=P["cloud_cover"], lw_derivatives=lw_derivatives,
        spec_matrix=spec_matrix)
