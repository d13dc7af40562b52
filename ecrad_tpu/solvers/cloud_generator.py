"""On-device McICA cloud generator (counter-based RNG).

Statistically equivalent to the reference generator but reproducible under
any sharding: random fields come from JAX's counter-based threefry PRNG
keyed per column, and the sampling algorithm follows the reference's
"vectorizable" formulation (radiation_cloud_generator.F90:587-720
generate_columns_exp_ran), which draws a fixed pattern of random numbers
and is a per-level `lax.scan` here.

For bit-exact golden-file validation against the reference, use the
host-side port in cloud_generator_exact.py instead; both produce the same
(od_scaling, total_cloud_cover) contract consumed by the McICA solvers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ecrad_tpu.config import Config, Overlap
from ecrad_tpu import profiling

MAX_CLOUD_FRAC = 1.0 - 2.0e-6


def cum_cloud_cover_exp_ran_jnp(frac, overlap_param, max_ran=False):
    """Vectorized overlap cumulator (radiation_cloud_cover.F90:124-229).

    frac (ncol, nlev); overlap_param (ncol, nlev-1).
    Returns (cum_cloud_cover (ncol, nlev), pair_cloud_cover (ncol, nlev-1)).
    """
    if max_ran:
        pair = jnp.maximum(frac[:, :-1], frac[:, 1:])
    else:
        a = overlap_param
        pair = (a * jnp.maximum(frac[:, :-1], frac[:, 1:])
                + (1.0 - a) * (frac[:, :-1] + frac[:, 1:]
                               - frac[:, :-1] * frac[:, 1:]))

    def step(cum_product, x):
        frac_lev, pair_lev = x
        cum_product = jnp.where(
            frac_lev >= MAX_CLOUD_FRAC, 0.0,
            cum_product * (1.0 - pair_lev)
            / jnp.maximum(1.0 - frac_lev, 1.0e-12))
        return cum_product, 1.0 - cum_product

    xs = (jnp.moveaxis(frac[:, :-1], 1, 0), jnp.moveaxis(pair, 1, 0))
    _, cum_levels = jax.lax.scan(step, 1.0 - frac[:, 0], xs)
    cum = jnp.concatenate([frac[:, :1], jnp.moveaxis(cum_levels, 0, 1)],
                          axis=1)
    return cum, pair


MIN_FRAC = 1.0e-6          # radiation_cloud_cover.F90:380


def cum_cloud_cover_exp_exp_jnp(frac, overlap_param):
    """Batched object-based Exp-Exp overlap cumulative cloud cover
    (radiation_cloud_cover.F90:339-623 cum_cloud_cover_exp_exp).

    The reference decomposes each profile into "concave cloud objects"
    (contiguous cloudy runs of monotonically increasing-then-decreasing
    fraction), accumulates cover within each object with the exp-ran
    recurrence, then greedily merges the most-correlated adjacent object
    pairs.  Here the per-column while-loops become: a lax.scan phase
    machine for object detection, a sort to compact object slots, and a
    fixed-trip masked merge loop (one-hot selects instead of the
    linked-list traversal; the traversal's visit set reduces to
    "active slots with index < nobj-1" since merges keep the lower
    slot).

    frac (ncol, nlev); overlap_param (ncol, nlev-1) alpha.
    Returns (cum_cloud_cover (ncol, nlev), pair_cloud_cover
    (ncol, nlev-1)).
    """
    ncol, nlev = frac.shape
    dtype = frac.dtype
    nmax = (nlev + 1) // 2
    levs = jnp.arange(nlev)

    cloudy = frac > MIN_FRAC
    f_prev = jnp.concatenate([jnp.zeros_like(frac[:, :1]), frac[:, :-1]],
                             axis=1)

    # --- phase machine: 0 clear, 1 nondecreasing, 2 decreasing
    def det_step(phase, x):
        f, fp, cl = x
        new_top = cl & ((phase == 0) | ((phase == 2) & (f > fp)))
        phase_new = jnp.where(~cl, 0,
                              jnp.where(new_top, 1,
                                        jnp.where((phase == 1) & (f < fp),
                                                  2, phase)))
        return phase_new, (new_top, phase_new)

    lev = lambda a: jnp.moveaxis(a, 1, 0)
    _, (new_top, phase) = jax.lax.scan(
        det_step, jnp.zeros((ncol,), jnp.int32),
        (lev(frac), lev(f_prev), lev(cloudy)))
    new_top = jnp.moveaxis(new_top, 0, 1)            # (ncol, nlev)
    phase = jnp.moveaxis(phase, 0, 1)

    nt_next = jnp.concatenate([new_top[:, 1:],
                               jnp.zeros_like(new_top[:, :1])], axis=1)
    ph_next = jnp.concatenate([phase[:, 1:],
                               jnp.zeros_like(phase[:, :1])], axis=1)
    is_last = levs == nlev - 1
    is_max = (phase == 1) & (is_last | (ph_next != 1) | nt_next)
    cl_next = jnp.concatenate([cloudy[:, 1:],
                               jnp.zeros_like(cloudy[:, :1])], axis=1)
    is_base = cloudy & (is_last | nt_next | ~cl_next)

    nobj = jnp.sum(new_top, axis=1).astype(jnp.int32)        # (ncol,)

    def compact(mask):
        """Levels where mask is true, in order, padded with nlev-1."""
        vals = jnp.where(mask, levs[None, :], nlev)
        vals = jnp.sort(vals, axis=1)[:, :nmax]
        return jnp.minimum(vals, nlev - 1).astype(jnp.int32)

    top_lev = compact(new_top)
    max_lev = compact(is_max)
    base_lev = compact(is_base)

    # --- pair cloud cover (alpha form) + within-object cumulative cover
    alpha = overlap_param
    pair = (alpha * jnp.maximum(frac[:, :-1], frac[:, 1:])
            + (1.0 - alpha) * (frac[:, :-1] + frac[:, 1:]
                               - frac[:, :-1] * frac[:, 1:]))
    pair_m1 = jnp.concatenate([jnp.zeros_like(pair[:, :1]), pair], axis=1)

    def cum_step(cum_prev, x):
        f, fp, p_m1, cl, topm = x
        grow = jnp.where(fp >= MAX_CLOUD_FRAC, 1.0,
                         1.0 - (1.0 - cum_prev) * (1.0 - p_m1)
                         / jnp.maximum(1.0 - fp, 1e-12))
        cum = jnp.where(topm, f, jnp.where(cl, grow, 0.0))
        return cum, cum

    _, cum_l = jax.lax.scan(
        cum_step, jnp.zeros((ncol,), dtype),
        (lev(frac), lev(f_prev), lev(pair_m1), lev(cloudy), lev(new_top)))
    cum = jnp.moveaxis(cum_l, 0, 1)                  # (ncol, nlev)

    take = lambda arr, idx: jnp.take_along_axis(arr, idx, axis=1)
    cc_obj = take(cum, base_lev)                     # (ncol, nmax)

    # --- inter-object correlation: product of alpha over
    # [max_lev[k], max_lev[k+1]) (radiation_cloud_cover.F90:366-371)
    log_a = jnp.log(jnp.maximum(alpha, 1e-30))
    zero_a = (alpha <= 0.0).astype(jnp.int32)
    cs_log = jnp.concatenate([jnp.zeros((ncol, 1), dtype),
                              jnp.cumsum(log_a, axis=1)], axis=1)
    cs_zero = jnp.concatenate([jnp.zeros((ncol, 1), jnp.int32),
                               jnp.cumsum(zero_a, axis=1)], axis=1)
    max_next = jnp.concatenate([max_lev[:, 1:], max_lev[:, -1:]], axis=1)
    prod = jnp.exp(take(cs_log, max_next) - take(cs_log, max_lev))
    nzero = take(cs_zero, max_next) - take(cs_zero, max_lev)
    alpha_obj = jnp.where(nzero > 0, 0.0, prod).astype(dtype)

    # --- fixed-trip greedy merge
    slots = jnp.arange(nmax)

    def merge_step(state, _):
        cum, cc, base, alpha_o, active, n = state
        do = (n > 1)
        visited = active & (slots[None, :] < (n - 1)[:, None])
        masked = jnp.where(visited, alpha_o, -jnp.inf)
        i1 = jnp.where(jnp.max(masked, axis=1) > 0.0,
                       jnp.argmax(masked, axis=1), 0)
        after = active & (slots[None, :] > i1[:, None])
        i2 = jnp.argmax(after, axis=1)
        oh1 = slots[None, :] == i1[:, None]
        oh2 = slots[None, :] == i2[:, None]
        pick = lambda arr, oh: jnp.sum(jnp.where(oh, arr, 0),
                                       axis=1).astype(arr.dtype)
        base1 = pick(base, oh1)
        top2 = pick(top_lev, oh2)
        base2 = pick(base, oh2)
        cc1 = pick(cc, oh1)
        cc2 = pick(cc, oh2)
        a1 = pick(alpha_o, oh1)
        a2 = pick(alpha_o, oh2)
        cum_base1 = jnp.take_along_axis(cum, base1[:, None], axis=1)[:, 0]

        cc_pair = (a1 * jnp.maximum(cc1, cc2)
                   + (1.0 - a1) * (cc1 + cc2 - cc1 * cc2))
        scaling = jnp.clip((cc_pair - cc1)
                           / jnp.maximum(MIN_FRAC, cc2), 0.0, 1.0)

        gap = ((levs[None, :] > base1[:, None])
               & (levs[None, :] < top2[:, None]))
        lower = ((levs[None, :] >= top2[:, None])
                 & (levs[None, :] <= base2[:, None]))
        cum_new = jnp.where(gap, cum_base1[:, None], cum)
        cum_new = jnp.where(lower, cum_base1[:, None]
                            + cum * scaling[:, None], cum_new)
        cum = jnp.where(do[:, None], cum_new, cum)

        upd = lambda arr, val: jnp.where(do[:, None] & oh1,
                                         val[:, None].astype(arr.dtype),
                                         arr)
        cc = upd(cc, cc_pair)
        base = upd(base, base2)
        alpha_o = upd(alpha_o, a2)
        active = jnp.where(do[:, None] & oh2, False, active)
        n = jnp.where(do, n - 1, n)
        return (cum, cc, base, alpha_o, active, n), None

    active0 = slots[None, :] < nobj[:, None]
    state = (cum, cc_obj, base_lev, alpha_obj, active0, nobj)
    (cum, cc_obj, base_lev, _, active, _), _ = jax.lax.scan(
        merge_step, state, None, length=nmax - 1)

    # --- fill below the lowest cloud, enforce pair >= overhang, cap
    has_cloud = nobj > 0
    i_fin = jnp.argmax(active, axis=1)
    base_fin = jnp.take_along_axis(base_lev, i_fin[:, None], axis=1)[:, 0]
    cum_fin = jnp.take_along_axis(cum, base_fin[:, None], axis=1)[:, 0]
    below = levs[None, :] > base_fin[:, None]
    cum = jnp.where(has_cloud[:, None] & below, cum_fin[:, None], cum)
    pair = jnp.where(has_cloud[:, None],
                     jnp.maximum(pair, frac[:, :-1] + cum[:, 1:]
                                 - cum[:, :-1]), 0.0)
    cum = jnp.where(has_cloud[:, None], jnp.minimum(cum, 1.0), 0.0)
    return cum, pair


def fit_pdf_cheb(pdf_tables, degree: int = 14):
    """Fit log(od_scaling) per fsd column as a Chebyshev series in the
    normal quantile z = ndtri(cdf) (host-side, at setup).

    The reference samples a (ncdf=1000, nfsd=81) inverse-CDF LUT
    bilinearly (radiation_pdf_sampler.F90:59-105).  This fit reduces
    sampling to ndtri + a Clenshaw recurrence, elementwise math with no
    gather of the ~1e8 random indices (max relative error vs the LUT:
    1.4e-3 gamma / 2.9e-5 lognormal, far inside McICA sampling
    noise).  Coefficients are linearly
    interpolated in fsd, which commutes with the LUT's own fsd
    interpolation since the series is linear in its coefficients.
    """
    import numpy as np
    from scipy.special import ndtri

    val = np.asarray(pdf_tables["val"], np.float64)      # (ncdf, nfsd)
    ncdf, nfsd = val.shape
    cdf_grid = np.arange(ncdf) / (ncdf - 1)
    rows = np.arange(1, ncdf - 1)         # drop cdf=0 (sentinel), cdf=1
    z = ndtri(cdf_grid[rows])
    z_lo, z_hi = float(z[0]), float(z[-1])
    t = (2.0 * z - (z_lo + z_hi)) / (z_hi - z_lo)
    coeffs = np.zeros((nfsd, degree + 1))
    for j in range(nfsd):
        y = np.log(np.maximum(val[rows, j], 1e-300))
        coeffs[j] = np.polynomial.chebyshev.chebfit(t, y, degree)
    fsd_axis = np.asarray(pdf_tables["fsd"], np.float64)
    return {
        "cheb": coeffs, "z_lo": z_lo, "z_hi": z_hi,
        "fsd1": float(fsd_axis[0]),
        "inv_int": 1.0 / float(fsd_axis[1] - fsd_axis[0]),
        "nfsd": nfsd,
    }


def cheb_coeffs_for(fit, fsd, dtype):
    """Per-(col,lev) Chebyshev coefficients interpolated in fsd.

    fsd (ncol, nlev) → (ncol, nlev, deg+1)."""
    cheb = jnp.asarray(fit["cheb"], dtype)              # (nfsd, deg+1)
    nfsd = fit["nfsd"]
    wfsd = (fsd - fit["fsd1"]) * fit["inv_int"] + 1.0
    ifsd = jnp.clip(wfsd.astype(jnp.int32), 1, nfsd - 1)
    wfsd = jnp.clip(wfsd - ifsd, 0.0, 1.0)[..., None]
    c0 = jnp.take(cheb, jnp.clip(ifsd - 1, 0, nfsd - 1), axis=0)
    c1 = jnp.take(cheb, jnp.clip(ifsd, 0, nfsd - 1), axis=0)
    return (1.0 - wfsd) * c0 + wfsd * c1                # (..., deg+1)


# Cephes ndtri coefficients (the same rational approximations as
# scipy/jax.scipy.special.ndtri), kept as Python floats so the Horner
# evaluation is unrolled elementwise math with no array constants.
_NDTRI_P0 = (-5.99633501014107895267e1, 9.80010754185999661536e1,
             -5.66762857469070293439e1, 1.39312609387279679503e1,
             -1.23916583867381258016e0)
_NDTRI_Q0 = (1.95448858338141759834e0, 4.67627912898881538453e0,
             8.63602421390890590575e1, -2.25462687854119370527e2,
             2.00260212380060660359e2, -8.20372256168538034268e1,
             1.59056225126211695515e1, -1.18331621121330003142e0)
_NDTRI_P1 = (4.05544892305962419923e0, 3.15251094599893866154e1,
             5.71628192246421288162e1, 4.40805073893200834700e1,
             1.46849561928858024014e1, 2.18663306850790267539e0,
             -1.40256079171354495875e-1, -3.50424626827848203418e-2,
             -8.57456785154685413611e-4)
_NDTRI_Q1 = (1.57799883256466749731e1, 4.53907635128879210584e1,
             4.13172038254672030440e1, 1.50425385692907503408e1,
             2.50464946208309415979e0, -1.42182922854787788574e-1,
             -3.80806407691578277194e-2, -9.33259480895457427372e-4)
_NDTRI_P2 = (3.23774891776946035970e0, 6.91522889068984211695e0,
             3.93881025292474443415e0, 1.33303460815807542389e0,
             2.01485389549179081538e-1, 1.23716634817820021358e-2,
             3.01581553508235416007e-4, 2.65806974686737550832e-6,
             6.23974539184983651783e-9)
_NDTRI_Q2 = (6.02427039364742014255e0, 3.67983563856160859403e0,
             1.37702099489081330271e0, 2.16236993594496635890e-1,
             1.34204006088543189037e-2, 3.28014464682127739104e-4,
             2.89247864745380683936e-6, 6.79019408009981274425e-9)


def _polevl(x, coeffs):
    y = None
    for c in coeffs:
        y = x * y + c if y is not None else jnp.zeros_like(x) + c
    return y


def _p1evl(x, coeffs):
    y = jnp.ones_like(x)
    for c in coeffs:
        y = x * y + c
    return y


def ndtri(p):
    """Inverse normal CDF — cephes rational approximations with
    literal coefficients (values match jax.scipy.special.ndtri to
    roundoff)."""
    s2pi = 2.50662827463100050242
    exp_m2 = 0.13533528323661269189

    flip = p > 1.0 - exp_m2
    y = jnp.where(flip, 1.0 - p, p)

    # central region
    yc = y - 0.5
    y2 = yc * yc
    x_c = yc + yc * (y2 * _polevl(y2, _NDTRI_P0)
                     / _p1evl(y2, _NDTRI_Q0))
    x_c = x_c * s2pi

    # tails (guard y for the central-path lanes)
    ysafe = jnp.clip(y, 1e-30, 1.0)
    x = jnp.sqrt(-2.0 * jnp.log(ysafe))
    x0 = x - jnp.log(x) / x
    z = 1.0 / x
    x1 = jnp.where(x < 8.0,
                   z * _polevl(z, _NDTRI_P1) / _p1evl(z, _NDTRI_Q1),
                   z * _polevl(z, _NDTRI_P2) / _p1evl(z, _NDTRI_Q2))
    x_t = x1 - x0                         # negative tail value

    # the central branch is only reachable un-flipped (a flip implies
    # y < exp(-2)), and its sign comes from yc directly; the tail value
    # is negative for small p and mirrored for flipped (large) p
    central = y > exp_m2
    return jnp.where(central, x_c, jnp.where(flip, -x_t, x_t))


def cheb_eval(fit, coeff_at, ncoef, cdf):
    """exp(cheb(ndtri(cdf))) — the PDF sample evaluation, shared by both
    od_scaling layouts.

    coeff_at(k): coefficient k broadcastable against cdf."""
    eps = 1e-7
    z = ndtri(jnp.clip(cdf, eps, 1.0 - eps))
    t = jnp.clip((2.0 * z - (fit["z_lo"] + fit["z_hi"]))
                 / (fit["z_hi"] - fit["z_lo"]), -1.0, 1.0)
    b1 = jnp.zeros_like(t)
    b2 = jnp.zeros_like(t)
    two_t = 2.0 * t
    for k in range(ncoef - 1, 0, -1):
        b1, b2 = two_t * b1 - b2 + coeff_at(k), b1
    y = t * b1 - b2 + coeff_at(0)
    return jnp.exp(y)


def sample_pdf_cheb(fit, fsd, cdf):
    """Gather-free PDF sampling: od_scaling = exp(cheb(z)) with coefficients
    interpolated in fsd.  fsd (..., 1) broadcasting against cdf (..., ng);
    fsd must vary only over the leading (col, lev) axes."""
    c = cheb_coeffs_for(fit, fsd[..., 0], cdf.dtype)    # (..., deg+1)
    cb = c[..., None, :]
    return cheb_eval(fit, lambda k: cb[..., k], c.shape[-1], cdf)


def sample_pdf_jnp(pdf_tables, fsd, cdf):
    """Bilinear PDF LUT lookup (radiation_pdf_sampler.F90:59-105)."""
    val = jnp.asarray(pdf_tables["val"])             # (ncdf, nfsd)
    fsd_axis = pdf_tables["fsd"]
    ncdf, nfsd = val.shape
    fsd1 = float(fsd_axis[0])
    inv_int = 1.0 / float(fsd_axis[1] - fsd_axis[0])

    wcdf = cdf * (ncdf - 1) + 1.0
    icdf = jnp.clip(wcdf.astype(jnp.int32), 1, ncdf - 1)
    wcdf = jnp.clip(wcdf - icdf, 0.0, 1.0)
    wfsd = (fsd - fsd1) * inv_int + 1.0
    ifsd = jnp.clip(wfsd.astype(jnp.int32), 1, nfsd - 1)
    wfsd = jnp.clip(wfsd - ifsd, 0.0, 1.0)
    flat = val.reshape(-1)

    def at(ic, ifs):
        return flat[jnp.clip(ic - 1, 0, ncdf - 1) * nfsd
                    + jnp.clip(ifs - 1, 0, nfsd - 1)]

    return ((1 - wcdf) * (1 - wfsd) * at(icdf, ifsd)
            + (1 - wcdf) * wfsd * at(icdf, ifsd + 1)
            + wcdf * (1 - wfsd) * at(icdf + 1, ifsd)
            + wcdf * wfsd * at(icdf + 1, ifsd + 1))


@profiling.traced("radiation_cloud_generator:cloud_generator")
def cloud_generator_device(config: Config, pdf_tables, iseed, frac,
                           overlap_param, fractional_std, ng: int,
                           layout="cln"):
    """On-device stochastic cloud sample.

    Args:
      iseed: (ncol,) int — per-column RNG key seeds.
      frac: (ncol, nlev) cloud fraction (cropped).
      overlap_param: (ncol, nlev-1).
      fractional_std: (ncol, nlev).
      layout: "cln" → od_scaling (ncol, nlev, ng); "knl" → od_scaling
        (nlev, ng, ncol), the fused-solver kernel layout (the level scan
        runs in that layout, so no big relayout copy is made; identical
        random streams either way).
    Returns (od_scaling, total_cloud_cover (ncol,)).
    """
    ncol, nlev = frac.shape
    exp_exp = config.overlap_scheme == Overlap.EXPONENTIAL
    if exp_exp:
        # Exp-Exp: object-based cover (radiation_cloud_cover.F90:339)
        cum, pair = cum_cloud_cover_exp_exp_jnp(frac, overlap_param)
    else:
        max_ran = config.overlap_scheme == Overlap.MAXIMUM_RANDOM
        cum, pair = cum_cloud_cover_exp_ran_jnp(frac, overlap_param,
                                                max_ran=max_ran)
    total_cloud_cover = cum[:, -1]
    overhang = cum[:, 1:] - cum[:, :-1]

    decorr = config.cloud_inhom_decorr_scaling
    op_inhom = jnp.where(overlap_param > 0.0,
                         jnp.maximum(overlap_param, 1e-30)
                         ** (1.0 / decorr),
                         overlap_param)

    # Counter-based random fields, keyed per column
    keys = jax.vmap(lambda s: jax.random.key(s))(
        jnp.asarray(iseed, jnp.uint32))

    # Draws are float32 in every precision, so a float64 run samples the
    # same clouds as a float32 run with the same seeds.
    def draw(key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        u = lambda k, shape: jax.random.uniform(
            k, shape, jnp.float32).astype(frac.dtype)
        return (u(k1, (ng,)), u(k2, (nlev, ng)), u(k3, (nlev, ng)),
                u(k4, (nlev, ng)))

    is_any_cloud = frac >= config.cloud_fraction_threshold

    tcc = jnp.where(total_cloud_cover
                    >= config.cloud_fraction_threshold,
                    total_cloud_cover, 0.0)

    cdf = _generator_scan_jnp(
        keys, draw, frac, cum, pair, overhang, op_inhom, is_any_cloud,
        total_cloud_cover, exp_exp, ng, layout)
    if layout == "knl":                            # cdf (nlev, ng, ncol)
        fsd_k = fractional_std.T                   # (nlev, ncol)
        if pdf_tables.get("cheb_fit") is not None:
            fit = pdf_tables["cheb_fit"]
            c = cheb_coeffs_for(fit, fsd_k, cdf.dtype)  # (nlev, ncol, d)
            sampled = cheb_eval(fit, lambda k: c[..., k][:, None, :],
                                c.shape[-1], cdf)
        else:
            sampled = sample_pdf_jnp(pdf_tables, fsd_k[:, None, :], cdf)
        od_scaling = jnp.where(cdf > 0.0, sampled, 0.0)
        od_scaling = jnp.where(is_any_cloud.T[:, None, :],
                               od_scaling, 0.0)
        od_scaling = jnp.where(tcc[None, None, :] > 0.0, od_scaling, 0.0)
        return od_scaling, tcc

    if pdf_tables.get("cheb_fit") is not None:
        sampled = sample_pdf_cheb(pdf_tables["cheb_fit"],
                                  fractional_std[..., None], cdf)
    else:
        sampled = sample_pdf_jnp(pdf_tables, fractional_std[..., None],
                                 cdf)
    od_scaling = jnp.where(cdf > 0.0, sampled, 0.0)
    od_scaling = jnp.where(is_any_cloud[..., None], od_scaling, 0.0)
    od_scaling = jnp.where(tcc[:, None, None] > 0.0, od_scaling, 0.0)
    return od_scaling, tcc


def _m1_fields(frac, cum, pair, overhang, op_inhom):
    """Per-level fields shifted to the jlev-1 position (dummy level -1
    prepended)."""
    frac_m1 = jnp.concatenate([jnp.zeros_like(frac[:, :1]),
                               frac[:, :-1]], axis=1)
    cum_m1 = jnp.concatenate([jnp.zeros_like(cum[:, :1]), cum[:, :-1]],
                             axis=1)
    pair_m1 = jnp.concatenate([jnp.zeros_like(pair[:, :1]), pair],
                              axis=1)           # pair at jlev-1
    over_m1 = jnp.concatenate([jnp.zeros_like(overhang[:, :1]),
                               overhang], axis=1)
    op_m1 = jnp.concatenate([jnp.zeros_like(op_inhom[:, :1]), op_inhom],
                            axis=1)
    return frac_m1, cum_m1, pair_m1, over_m1, op_m1


def _generator_scan_jnp(keys, draw, frac, cum, pair, overhang, op_inhom,
                        is_any_cloud, total_cloud_cover, exp_exp, ng,
                        layout="cln"):
    """Level scan of the sampling recurrence.  The per-column states are
    (ncol, ng) planes, or (ng, ncol) with layout="knl"; the draws are
    the same numbers either way.  Returns the cdf samples
    (ncol, nlev, ng), or (nlev, ng, ncol) with layout="knl"."""
    knl = layout == "knl"
    if knl:
        trigger, rand_cloud, rand_inhom, rand_inhom2 = jax.vmap(
            draw, out_axes=(1, 2, 2, 2))(keys)          # (nlev, ng, ncol)
        trigger = trigger * total_cloud_cover[None, :]  # (ng, ncol)
        col = lambda v: v[None, :]
        lev_r = lambda a: a
    else:
        trigger, rand_cloud, rand_inhom, rand_inhom2 = jax.vmap(draw)(keys)
        trigger = trigger * total_cloud_cover[:, None]  # (ncol, ng)
        col = lambda v: v[:, None]
        lev_r = lambda a: jnp.moveaxis(a, 1, 0)          # (nlev, ncol, ng)
    ncol = frac.shape[0]
    plane = (ng, ncol) if knl else (ncol, ng)

    frac_m1, cum_m1, pair_m1, over_m1, op_m1 = _m1_fields(
        frac, cum, pair, overhang, op_inhom)

    lev = lambda a: jnp.moveaxis(a, 1, 0)

    def scan_step(carry, x):
        found_cloud, is_cloud, ri_prev = carry
        any_c, f, f_m1, c, c_m1, p_m1, o_m1, opi_m1, rc, ri, ri2 = x
        any_c = col(any_c)
        prev_cloud = is_cloud
        first_cloud = (trigger <= col(c)) & (~found_cloud)
        found_cloud = found_cloud | first_cloud
        cond_prev = rc * col(f_m1) < col(f + f_m1 - p_m1)
        cond_new = rc * col(c_m1 - f_m1) < col(p_m1 - o_m1 - f_m1)
        is_cloud = first_cloud | (found_cloud
                                  & jnp.where(prev_cloud, cond_prev,
                                              cond_new))
        is_cloud = is_cloud & any_c
        if exp_exp:
            # Exp-Exp chains the inhomogeneity sample across clear gaps
            # (radiation_cloud_generator.F90:497-509: rand_inhom1
            # repetition runs over the whole itrigger:iend range,
            # regardless of cloudiness)
            chain = jnp.where(ri2 < col(opi_m1), ri_prev, ri)
            emit = jnp.where(is_cloud & any_c, chain, 0.0)
            return (found_cloud, is_cloud, chain), emit
        ri_new = jnp.where((ri2 < col(opi_m1)) & prev_cloud, ri_prev, ri)
        ri_new = jnp.where(is_cloud, ri_new, 0.0)
        ri_new = jnp.where(any_c, ri_new, 0.0)
        return (found_cloud, is_cloud, ri_new), ri_new

    init = (jnp.zeros(plane, bool), jnp.zeros(plane, bool),
            jnp.zeros(plane, frac.dtype))
    xs = (lev(is_any_cloud), lev(frac), lev(frac_m1), lev(cum),
          lev(cum_m1), lev(pair_m1), lev(over_m1), lev(op_m1),
          lev_r(rand_cloud), lev_r(rand_inhom), lev_r(rand_inhom2))
    _, ri_levels = jax.lax.scan(scan_step, init, xs)
    if knl:
        return ri_levels                                # (nlev, ng, ncol)
    return jnp.moveaxis(ri_levels, 0, 1)                # (ncol, nlev, ng)
