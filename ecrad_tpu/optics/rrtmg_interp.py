"""Shared interpolation primitives for the RRTMG taumol kernels.

The reference accesses flattened ABSA/ABSB tables with precomputed flat
indices (e.g. ifsrrtm/rrtm_taumol1.F90:200-280, rrtm_taumol3.F90:95-310).
Here tables are reshaped to explicit (jp, jt, js, g) axes at load time.

Every interpolation is expressed through :func:`weighted_take` — a sum
of weighted table rows — which is either a plain gather (exact; the
default on every backend) or a one-hot matrix product at HIGHEST
precision ((ncol*nlev, nrows) @ (nrows, ng), the one-hot built in one
fused elementwise pass), as ``backend.choices().interp`` says.

Two batch layouts (``layout`` argument):
  * ``"cln"`` (default): index arrays (ncol, nlev), results
    (ncol, nlev, ng) — the classic column-major analysis layout used by
    the CPU/golden path and the non-fused solvers.
  * ``"knl"``: index arrays (nlev, ncol), results (nlev, ng, ncol) —
    the fused solver *kernel layout* (columns contiguous).  Producing
    gas optics directly in this layout removes the (ncol*nlev*ng)
    relayout copies between gas optics and the solver sweeps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ecrad_tpu import backend

ONEMINUS = 1.0 - 1.0e-6


# --- table reshaping (host-side, numpy, at setup) ------------------------

def reshape_ka1(kao: np.ndarray) -> np.ndarray:
    """KAO(5,13,ng) (jt,jp,g) → (13,5,ng) (jp,jt,g)."""
    return np.ascontiguousarray(np.transpose(kao, (1, 0, 2)))


def reshape_kb1(kbo: np.ndarray) -> np.ndarray:
    """KBO(5,47,ng) (jt,jp,g) → (47,5,ng) (jp,jt,g)."""
    return np.ascontiguousarray(np.transpose(kbo, (1, 0, 2)))


def reshape_ka2(kao: np.ndarray) -> np.ndarray:
    """KAO(9,5,13,ng) (js,jt,jp,g) → (13,5,9,ng) (jp,jt,js,g)."""
    return np.ascontiguousarray(np.transpose(kao, (2, 1, 0, 3)))


def reshape_kb2(kbo: np.ndarray) -> np.ndarray:
    """KBO(5,5,47,ng) (js,jt,jp,g) → (47,5,5,ng) (jp,jt,js,g)."""
    return np.ascontiguousarray(np.transpose(kbo, (2, 1, 0, 3)))


def reshape_minor2(kam: np.ndarray) -> np.ndarray:
    """KA_Mxxx(9,19,ng) (js,jt,g) → (19,9,ng) (jt,js,g)."""
    return np.ascontiguousarray(np.transpose(kam, (1, 0, 2)))


# --- level-windowed interpolation ------------------------------------------
#
# The dominant cost of the one-hot formulation is building the (N, nrows)
# weight matrix: N*nrows*npairs elementwise ops regardless of how narrow
# the output is.  But the row indices are driven by the
# pressure index jp, which at any given model LEVEL spans only a handful
# of values across columns (pressure varies across columns far less than
# across levels).  With a per-level row offset ``off[l]`` (traced, from
# the data) and a static window width W, the contraction becomes a
# level-batched matmul against a (nlev, W, ng) windowed table — cutting
# both the weight-matrix build and the contraction by nrows/W (the
# 1175-row upper tables have a jp span of a few rows per level).
#
# W must be static.  The driver computes the exact per-pair-set spans
# from the real inputs with :func:`pair_span` (a tiny jitted probe using
# the same index expressions) and carries them in the gas-optics tables
# dict under the ``"windows"`` key (rrtmg.compute_interp_windows), so
# the widths are part of the traced closure — a program jitted with one
# set of windows can never silently be fed another set.  When the
# installed width covers the true span the result is exact (identical
# row set, different summation grouping); when it does NOT (inputs with
# a wider span than the probe saw, e.g. a different vertical grid pushed
# through a stale compiled step), the runtime guard poisons the output
# with NaN instead of silently clamping — caught by check_fluxes /
# any finite-ness assertion downstream.
#
# ``set_level_windows`` remains as a process-global fallback for code
# that has no tables dict to hand (explicit ``windows=`` wins).

_LEVEL_WINDOWS = None


def set_level_windows(windows):
    """Install {key: width} interpolation windows (or None to disable).

    Trace-time state: set before building/jitting the radiation step;
    programs traced earlier keep whatever windows were installed then."""
    global _LEVEL_WINDOWS
    _LEVEL_WINDOWS = dict(windows) if windows else None


def get_level_windows():
    return dict(_LEVEL_WINDOWS) if _LEVEL_WINDOWS else None


def _round_up8(n):
    return -(-int(n) // 8) * 8


def pair_span(pairs):
    """Traced per-level row span of a pair set: max over levels of
    (max-min over columns and pairs) + 1.  idx arrays are (ncol, nlev)."""
    lo = hi = None
    for idx, _ in pairs:
        l_ = jnp.min(idx, axis=0)
        h_ = jnp.max(idx, axis=0)
        lo = l_ if lo is None else jnp.minimum(lo, l_)
        hi = h_ if hi is None else jnp.maximum(hi, h_)
    return jnp.max(hi - lo) + 1


def _window_width(key, nrows, windows=None):
    """Resolve a key to (width, lev_start, lev_end) or None.

    Installed values are either a plain width or a (width, ls, le)
    tuple; ``ls``/``le`` restrict the computation to a level slice
    (results outside are zeros — valid when the caller's tropo mask
    never selects them, the laytrop structure of the RRTMG tables)."""
    if windows is None:
        windows = _LEVEL_WINDOWS
    if windows is None or key is None:
        return None
    w = windows.get(key)
    if w is None:
        return None
    ls, le = 0, None
    if isinstance(w, tuple):
        w, ls, le = w
    w = min(_round_up8(w), nrows)
    if w >= nrows and ls == 0 and le is None:
        return None
    return min(w, nrows), ls, le


def _weighted_take_windowed(table, pairs, width, ls=0, le=None,
                            layout="cln"):
    """Level-windowed weighted_take.  idx arrays (ncol, nlev) [cln] or
    (nlev, ncol) [knl]; returns (ncol, nlev, ng) / (nlev, ng, ncol) with
    zeros outside the [ls, le) level slice.

    Exact when width covers the true per-level span (guaranteed by the
    driver probe).  If any index falls outside the window — a program
    traced with windows probed from one grid but fed another — the
    output is poisoned with NaN instead of silently clamped."""
    table = jnp.asarray(table)
    nrows = table.shape[0]
    lev_ax, col_ax = (0, 1) if layout == "knl" else (1, 0)
    nlev_full = pairs[0][0].shape[lev_ax]
    le = nlev_full if le is None else min(le, nlev_full)
    ls = max(0, min(ls, le))
    if ls > 0 or le < nlev_full:
        sl = ((slice(ls, le),) if layout == "knl"
              else (slice(None), slice(ls, le)))
        pairs = [(idx[sl], None if w is None else w[sl])
                 for idx, w in pairs]
    # per-level base row = min over pairs/columns
    off = None
    hi = None
    for idx, _ in pairs:
        m = jnp.min(idx, axis=col_ax)
        h = jnp.max(idx, axis=col_ax)
        off = m if off is None else jnp.minimum(off, m)
        hi = h if hi is None else jnp.maximum(hi, h)
    off = jnp.clip(off, 0, nrows - width)            # (nlev,)
    # runtime span guard: rel = idx - off is clamped to [0, width-1] in
    # the one-hot below; if the true span exceeds the static width the
    # clamp would silently corrupt the sum — poison with NaN instead
    # (one scalar reduce over the small (nlev,) span arrays)
    bad = jnp.max(hi - off) > width - 1
    poison = jnp.where(bad, jnp.asarray(float("nan"), table.dtype),
                       jnp.asarray(1.0, table.dtype))

    # windowed table (nlev, width, ng) — exact one-hot row selection
    offsets = off[:, None] + jnp.arange(width, dtype=off.dtype)[None, :]
    oh = (offsets[..., None]
          == jnp.arange(nrows, dtype=off.dtype)).astype(table.dtype)
    twin = jnp.dot(oh.reshape(-1, nrows), table,
                   preferred_element_type=table.dtype,
                   precision=jax.lax.Precision.HIGHEST)
    twin = twin.reshape(offsets.shape + (table.shape[-1],))

    iota = jnp.arange(width, dtype=jnp.int32)
    if layout == "knl":
        # weight matrix (nlev, width, ncol); contract width against the
        # windowed table batched over levels -> (nlev, ng, ncol)
        A = None
        for idx, w in pairs:
            rel = jnp.clip(idx - off[:, None], 0, width - 1)  # (nlev, nc)
            ohp = (rel[:, None, :] == iota[None, :, None]) \
                .astype(table.dtype)
            term = ohp if w is None else w[:, None, :] * ohp
            A = term if A is None else A + term
        out = jax.lax.dot_general(
            twin, A, dimension_numbers=(((1,), (1,)), ((0,), (0,))),
            preferred_element_type=table.dtype,
            precision=jax.lax.Precision.HIGHEST)        # (nlev, ng, ncol)
        out = out * poison
        if ls > 0 or le < nlev_full:
            out = jnp.pad(out, ((ls, nlev_full - le), (0, 0), (0, 0)))
        return out

    # cln: weight matrix over the window, (nlev, ncol, width) order
    A = None
    for idx, w in pairs:
        rel = jnp.clip(idx - off[None, :], 0, width - 1).T   # (nlev, ncol)
        ohp = (rel[..., None] == iota).astype(table.dtype)
        term = ohp if w is None else w.T[..., None] * ohp
        A = term if A is None else A + term

    out = jax.lax.dot_general(
        A, twin, dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=table.dtype,
        precision=jax.lax.Precision.HIGHEST)            # (nlev, ncol, ng)
    out = out * poison
    if ls > 0 or le < nlev_full:
        out = jnp.pad(out, ((ls, nlev_full - le), (0, 0), (0, 0)))
    return jnp.moveaxis(out, 0, 1)


# --- the gather primitive --------------------------------------------------

def weighted_take(table, pairs, key=None, layout="cln", windows=None):
    """``sum_i w_i * table[idx_i]`` over a list of (idx, weight) pairs.

    table: (nrows, ng); idx: 2D int batch — (ncol, nlev) [cln] or
    (nlev, ncol) [knl]; weight: same shape or None (== 1).
    Returns (ncol, nlev, ng) [cln] or (nlev, ng, ncol) [knl].

    ``backend.choices().interp`` picks a gather or a one-hot matrix
    product (at HIGHEST precision, so selection stays exact).

    ``windows``: {key: width} level-window dict (from the tables dict)
    for the one-hot form; falls back to the process-global
    set_level_windows state.
    """
    table = jnp.asarray(table)   # canonical dtype (f32 unless x64 on)
    nrows = table.shape[0]
    if backend.choices().interp == "gather":
        out = None
        for idx, w in pairs:
            t = jnp.take(table, idx, axis=0)
            if w is not None:
                t = w[..., None] * t
            out = t if out is None else out + t
        if layout == "knl":
            # (nlev, ncol, ng) -> (nlev, ng, ncol)
            out = jnp.moveaxis(out, -1, 1)
        return out
    win = _window_width(key, nrows, windows)
    if win is not None:
        return _weighted_take_windowed(table, pairs, *win, layout=layout)
    if layout == "knl":
        # A (nlev, nrows, ncol); table broadcast over levels; batched
        # contraction -> (nlev, ng, ncol).  Production major tables go
        # through the windowed path above; this fallback only sees the
        # small continuum/minor tables (<= ~200 rows), so the broadcast
        # (nlev, nrows, ng) operand stays tiny.
        iota = jnp.arange(nrows, dtype=jnp.int32)
        A = None
        for idx, w in pairs:
            oh = (idx[:, None, :] == iota[None, :, None]) \
                .astype(table.dtype)
            term = oh if w is None else w[:, None, :] * oh
            A = term if A is None else A + term
        nlev = A.shape[0]
        tbat = jnp.broadcast_to(table, (nlev,) + table.shape)
        out = jax.lax.dot_general(
            tbat, A, dimension_numbers=(((1,), (1,)), ((0,), (0,))),
            preferred_element_type=table.dtype,
            precision=jax.lax.Precision.HIGHEST)
        return out
    iota = jnp.arange(nrows, dtype=jnp.int32)
    A = None
    for idx, w in pairs:
        oh = (idx[..., None] == iota).astype(table.dtype)
        term = oh if w is None else w[..., None] * oh
        A = term if A is None else A + term
    lead = A.shape[:-1]
    out = jnp.dot(A.reshape(-1, nrows), table,
                  preferred_element_type=table.dtype,
                  precision=jax.lax.Precision.HIGHEST)
    return out.reshape(lead + (table.shape[-1],))


def _take2(table, idx):
    """table (n, ng); idx (...,) → (..., ng)."""
    return jnp.take(table, idx, axis=0)


def take_bands(x, band_from_g, layout="cln"):
    """Expand per-band values to per-g:
    cln: x (..., nband) → (..., ng); knl: x (nlev, nband, ncol) →
    (nlev, ng, ncol).  Static indices band_from_g (ng,).

    A gather, or with ``backend.choices().interp == "onehot"`` a constant
    0/1 matrix product at HIGHEST precision (exact: one-hot columns
    select single entries)."""
    onehot = backend.choices().interp == "onehot"
    if layout == "knl":
        if not onehot:
            return jnp.take(x, band_from_g, axis=1)
        nlev, nband = x.shape[0], x.shape[1]
        bfg = jnp.asarray(band_from_g)
        mat = (bfg[:, None] == jnp.arange(nband)[None, :]) \
            .astype(x.dtype)                          # (ng, nband)
        mbat = jnp.broadcast_to(mat, (nlev,) + mat.shape)
        return jax.lax.dot_general(
            mbat, x, dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=x.dtype,
            precision=jax.lax.Precision.HIGHEST)      # (nlev, ng, ncol)
    if not onehot:
        return jnp.take(x, band_from_g, axis=-1)
    nband = x.shape[-1]
    bfg = jnp.asarray(band_from_g)
    mat = (bfg[None, :] == jnp.arange(nband)[:, None]).astype(x.dtype)
    out = jnp.dot(x.reshape(-1, nband), mat,
                  preferred_element_type=x.dtype,
                  precision=jax.lax.Precision.HIGHEST)
    return out.reshape(x.shape[:-1] + (bfg.shape[0],))


# --- band batching ---------------------------------------------------------
#
# The one-hot formulation of weighted_take costs N * nrows * ng MACs
# regardless of how many (idx, weight) pairs share the product, and
# per-band calls produce 2-16-wide outputs.  But the *indices and
# weights* of most interpolations are band-independent (jp/jt/fac from
# pressure and temperature only; indself/indfor/indminor likewise; the
# eta index js only depends on the gas-pair ratio).  Grouping the tables
# of all bands that share an index set along the g axis turns ~100
# narrow lookups into ~10 wide ones with identical results.

class BatchedTake:
    """Accumulate (key, table(nrows, ngb)) entries that share one
    weighted_take index/weight set; evaluate once; serve per-key slices."""

    def __init__(self):
        self._tabs = []       # list of (key, np table)
        self._out = None

    def add(self, key, table):
        self._tabs.append((key, np.asarray(table)))

    def keys(self):
        return [k for k, _ in self._tabs]

    def run(self, fn, g_axis=-1):
        """fn(table) -> batch result with sum_ng on ``g_axis``; then
        get(key) serves per-band slices along that axis (g_axis=1 for
        the knl layout, -1 for cln)."""
        if not self._tabs:
            self._out = {}
            return
        table = np.concatenate([t for _, t in self._tabs], axis=-1)
        out = fn(table)
        self._out = {}
        start = 0
        for k, t in self._tabs:
            w = t.shape[-1]
            if g_axis == -1:
                self._out[k] = out[..., start:start + w]
            else:
                self._out[k] = jax.lax.slice_in_dim(out, start, start + w,
                                                    axis=g_axis)
            start += w

    def get(self, key):
        return self._out[key]

    def __contains__(self, key):
        return any(k == key for k, _ in self._tabs)


def major_1_pairs(njp, jp, jt, jt1, fac00, fac01, fac10, fac11,
                  jp_offset=0):
    """The 4 (row, weight) pairs of the 1-key-species interpolation."""
    jp0 = jnp.clip(jp - jp_offset, 0, njp - 1)
    jp1 = jnp.clip(jp + 1 - jp_offset, 0, njp - 1)
    return [
        (jp0 * 5 + jt, fac00),
        (jp0 * 5 + jt + 1, fac10),
        (jp1 * 5 + jt1, fac01),
        (jp1 * 5 + jt1 + 1, fac11),
    ]


def major_1(table, jp, jt, jt1, fac00, fac01, fac10, fac11, jp_offset=0,
            key=None, layout="cln", windows=None):
    """1-key-species major absorption (e.g. rrtm_taumol1.F90:202-236).

    table: (njp, 5, ng) jp-major; jp_offset subtracted from jp first
    (upper-atmosphere tables start at jp index 12).
    Returns k in batch layout — multiply by the column amount outside.
    """
    njp = table.shape[0]
    flat = table.reshape((-1,) + table.shape[2:])      # (njp*5, ng)
    return weighted_take(flat, major_1_pairs(
        njp, jp, jt, jt1, fac00, fac01, fac10, fac11, jp_offset),
        key=key, layout=layout, windows=windows)


def spec_setup(n_eta, colgas1, colgas2, rat):
    """Binary species parameter setup (rrtm_taumol3.F90:119-124 pattern).

    n_eta: 8 for lower (9-point eta axis), 4 for upper (5-point).
    Returns (speccomb, specparm, js0, fs): js0 is the 0-based eta index.
    """
    speccomb = colgas1 + rat * colgas2
    specparm = jnp.minimum(colgas1 / speccomb, ONEMINUS)
    specmult = n_eta * specparm
    js0 = specmult.astype(jnp.int32)          # 0-based (Fortran js-1)
    fs = specmult - js0
    return speccomb, specparm, js0, fs


def major_2_pairs(njp, njs, nfl, jp, jt, jt1, fac00, fac01, fac10, fac11,
                  speccomb, specparm, js, fs, speccomb1, specparm1, js1,
                  fs1, jp_offset=0, eta_edges=True):
    """The 12 (or 8) (row, weight) pairs of the 2-key-species
    interpolation (see :func:`major_2`)."""

    def side_pairs(jp_side, jt_side, facA, facB, speccomb_s, specparm_s,
                   js_s, fs_s):
        """facA = fac at jt, facB = fac at jt+1 (e.g. fac00, fac10)."""
        jp0 = jnp.clip(jp_side - jp_offset, 0, njp - 1)
        base = (jp0 * 5 + jt_side) * njs
        pairs = []
        if eta_edges:
            # three regimes on specparm
            p_lo = fs_s - 1.0
            p4_lo = p_lo ** 4
            fk0_lo, fk1_lo, fk2_lo = p4_lo, 1.0 - p_lo - 2.0 * p4_lo, \
                p_lo + p4_lo
            p_hi = -fs_s
            p4_hi = p_hi ** 4
            fk0_hi, fk1_hi, fk2_hi = p4_hi, 1.0 - p_hi - 2.0 * p4_hi, \
                p_hi + p4_hi

            lo = specparm_s < 0.125
            hi = specparm_s > 0.875
            # mid-regime uses (1-fs, fs) on (0,+1)
            fk0 = jnp.where(lo, fk0_lo, jnp.where(hi, fk0_hi, 1.0 - fs_s))
            fk1 = jnp.where(lo, fk1_lo, jnp.where(hi, fk1_hi, fs_s))
            fk2 = jnp.where(lo, fk2_lo, jnp.where(hi, fk2_hi, 0.0))
            # js offsets per regime: lo → (0,1,2); hi → (+1,0,-1);
            # mid → (0,1,·)
            d0 = jnp.where(hi, 1, 0)
            d1 = jnp.where(hi, 0, 1)
            d2 = jnp.where(hi, -1, 2)
            for djt, fac in ((0, facA), (1, facB)):
                off = base + djt * njs + js_s
                for fk, d in ((fk0, d0), (fk1, d1), (fk2, d2)):
                    pairs.append((jnp.clip(off + d, 0, nfl - 1),
                                  speccomb_s * fac * fk))
        else:
            fs_c = fs_s
            for djt, fac in ((0, facA), (1, facB)):
                off = base + djt * njs + js_s
                pairs.append((jnp.clip(off, 0, nfl - 1),
                              speccomb_s * fac * (1.0 - fs_c)))
                pairs.append((jnp.clip(off + 1, 0, nfl - 1),
                              speccomb_s * fac * fs_c))
        return pairs

    return (side_pairs(jp, jt, fac00, fac10, speccomb, specparm, js, fs)
            + side_pairs(jp + 1, jt1, fac01, fac11, speccomb1,
                         specparm1, js1, fs1))


def major_2(table, jp, jt, jt1, fac00, fac01, fac10, fac11,
            speccomb, specparm, js, fs, speccomb1, specparm1, js1, fs1,
            jp_offset=0, eta_edges=True, key=None, layout="cln",
            windows=None):
    """2-key-species major absorption with eta interpolation, including the
    quartic eta-edge corrections for specparm < 0.125 / > 0.875
    (rrtm_taumol3.F90:170-289 pattern).

    table: (njp, 5, n_js, ng); js/js1 0-based.
    eta_edges: bands using the 9-point eta axis apply the edge scheme;
    bands that don't (e.g. taumol9/12-like linear eta) pass False.
    Returns tau_major_total = speccomb-weighted sum of both jp planes,
    assembled as ONE weighted_take over 12 (or 8) weighted rows so the
    one-hot path is a single matmul (level-windowed when a window is
    installed for ``key``).
    """
    njp, njs = table.shape[0], table.shape[2]
    flat = table.reshape((-1,) + table.shape[3:])       # (njp*5*njs, ng)
    nfl = flat.shape[0]
    pairs = major_2_pairs(njp, njs, nfl, jp, jt, jt1, fac00, fac01,
                          fac10, fac11, speccomb, specparm, js, fs,
                          speccomb1, specparm1, js1, fs1, jp_offset,
                          eta_edges)
    return weighted_take(flat, pairs, key=key, layout=layout,
                         windows=windows)


def self_continuum(selfref, selffac, selffrac, indself, layout="cln"):
    """rrtm_taumol1.F90:219-222. selfref (10, ng)."""
    w1 = selffac * selffrac
    return weighted_take(selfref, [(indself, selffac - w1),
                                   (indself + 1, w1)], layout=layout)


def foreign_continuum(forref, forfac, forfrac, indfor, layout="cln"):
    """rrtm_taumol1.F90:224-226. forref (3|4, ng)."""
    n = forref.shape[0]
    w1 = forfac * forfrac
    return weighted_take(forref, [
        (jnp.clip(indfor, 0, n - 1), forfac - w1),
        (jnp.clip(indfor + 1, 0, n - 1), w1)], layout=layout)


def minor_1(kminor, scale, minorfrac, indminor, layout="cln"):
    """1-D minor-gas absorption (rrtm_taumol1.F90:228-231).
    kminor (19, ng)."""
    w1 = scale * minorfrac
    return weighted_take(kminor, [(indminor, scale - w1),
                                  (indminor + 1, w1)], layout=layout)


def minor_2(kminor, jm, fm, minorfrac, indminor, key=None, layout="cln",
            windows=None):
    """Eta-dependent minor-gas absorption (rrtm_taumol3.F90:139-143 +
    225-232 pattern). kminor (19, 9, ng) (jt, js, g); jm 0-based.

    Returns absorption coefficient (multiply by adjusted column outside).

    The bilinear stencil is expanded into 4 weighted rows:
    (1-mf)(1-fm)·T[i,j] + (1-mf)fm·T[i,j+1] + mf(1-fm)·T[i+1,j]
    + mf·fm·T[i+1,j+1].
    """
    flat = kminor.reshape((-1,) + kminor.shape[2:])    # (19*9, ng)
    njs = kminor.shape[1]
    nfl = flat.shape[0]

    def at(jt, js):
        return jnp.clip(jt * njs + js, 0, nfl - 1)

    mf = minorfrac
    return weighted_take(flat, [
        (at(indminor, jm), (1.0 - mf) * (1.0 - fm)),
        (at(indminor, jm + 1), (1.0 - mf) * fm),
        (at(indminor + 1, jm), mf * (1.0 - fm)),
        (at(indminor + 1, jm + 1), mf * fm)], key=key, layout=layout,
        windows=windows)


def planck_frac_1(fracref):
    """Constant Planck fraction per g (fracref (ng,))."""
    return jnp.asarray(fracref)


def planck_frac_2(fracref, jpl, fpl, layout="cln"):
    """Eta-interpolated Planck fraction (rrtm_taumol3.F90:300-303).
    fracref (ng, 9) (g, js); jpl 0-based."""
    tab = jnp.asarray(fracref).T                      # (njs, ng)
    njs = tab.shape[0]
    return weighted_take(tab, [
        (jpl, 1.0 - fpl),
        (jnp.clip(jpl + 1, 0, njs - 1), fpl)], layout=layout)
