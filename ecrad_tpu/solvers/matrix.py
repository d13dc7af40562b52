"""Batched small-matrix operations for the SPARTACUS solvers.

Reference: radiation/radiation_matrix.F90 (mat_x_vec L64, mat_x_mat L145,
solve_vec L737, solve_mat L769, expm L805, fast_expm_exchange_2 L914,
fast_expm_exchange_3 L952).

Formulation: matrices are (..., m, m) arrays with arbitrary leading
batch dims (typically (ncol, ng)); all ops are dense einsums / batched
``jnp.linalg.solve`` that XLA vectorizes over the batch.  The reference's
per-matrix variable squaring count in ``expm`` becomes a fixed-trip masked
squaring loop (data-independent control flow for jit).  The "shortwave"
sparsity pattern of radiation_matrix.F90:145-216 is a compile-time zero
structure that dense matmuls preserve, so no special-casing is needed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ecrad_tpu import backend

# Pade-7 coefficients (radiation_matrix.F90:813-818)
_THETA3 = 3.925724783138660
_C = (17297280.0, 8648640.0, 1995840.0, 277200.0, 25200.0, 1512.0, 56.0,
      1.0)
# Hard cap on the squaring count (norms up to ~2^60 * theta3); the loop
# below runs only to the batch-max exponent, so typical cost is ~5-16
# squarings.
_MAX_SQUARINGS = 60

# Static squaring count for the masked chain (backend.choices()
# .expm_squarings == "masked"): no loop condition is read back per trip,
# which a data-dependent while_loop needs inside the 137-level layer
# loop.  A fixed masked chain of 13 squarings is
# exact for 1-norms up to 2^13 * theta3 ~ 3.2e4 — above anything the
# solvers produce (od capped by max_cloud_od, transfer rates capped by
# max_3d_transfer_rate); norms beyond that fall back to a less-scaled
# Pade evaluation instead of more squarings (still finite, reference
# semantics unchanged for all physical inputs).
_STATIC_SQUARINGS = 13


def _mm(A, B):
    """Batched matrix product at full f32 precision (never TF32)."""
    return jnp.matmul(A, B, precision=jax.lax.Precision.HIGHEST)


def mat_x_vec(A, b):
    """out_i = sum_j A[...,i,j] b[...,j]."""
    return jnp.einsum("...ij,...j->...i", A, b,
                      precision=jax.lax.Precision.HIGHEST)


def _lu_nopivot(A):
    """Unrolled LU factorization without pivoting, vectorized over the
    batch (radiation_matrix.F90:639-674 lu_factorization).  Returns the
    packed LU as a list-of-lists of (...,) arrays.

    No pivoting matches the reference; the SPARTACUS matrices are
    strongly diagonally dominant.  Unrolling to elementwise FMAs keeps
    it in true f32 (no reduced-precision dot_general) and compiles
    fast."""
    m = A.shape[-1]
    LU = [[A[..., i, j] for j in range(m)] for i in range(m)]
    for k in range(m - 1):
        inv_diag = 1.0 / LU[k][k]
        for i in range(k + 1, m):
            LU[i][k] = LU[i][k] * inv_diag
            for j in range(k + 1, m):
                LU[i][j] = LU[i][j] - LU[i][k] * LU[k][j]
    return LU


def _lu_sub(LU, b):
    """Forward/back substitution (radiation_matrix.F90:681-706);
    b is a list of (...,) arrays, returns the same."""
    m = len(LU)
    y = list(b)
    for i in range(1, m):
        for j in range(i):
            y[i] = y[i] - LU[i][j] * y[j]
    x = [None] * m
    x[m - 1] = y[m - 1] / LU[m - 1][m - 1]
    for i in range(m - 2, -1, -1):
        acc = y[i]
        for j in range(i + 1, m):
            acc = acc - LU[i][j] * x[j]
        x[i] = acc / LU[i][i]
    return x


def solve_vec(A, b):
    """Solve A x = b for batched small matrices
    (radiation_matrix.F90:737-762)."""
    LU = _lu_nopivot(A)
    m = A.shape[-1]
    x = _lu_sub(LU, [b[..., i] for i in range(m)])
    return jnp.stack(x, axis=-1)


def solve_mat(A, B):
    """Solve A X = B for batched small matrices
    (radiation_matrix.F90:769-792)."""
    LU = _lu_nopivot(A)
    m = A.shape[-1]
    cols = []
    for j in range(B.shape[-1]):
        x = _lu_sub(LU, [B[..., i, j] for i in range(m)])
        cols.append(jnp.stack(x, axis=-1))
    return jnp.stack(cols, axis=-1)


def expm(A):
    """Matrix exponential by Pade-7 scaling-and-squaring
    (radiation_matrix.F90:805-903), batched over leading dims."""
    m = A.shape[-1]
    eye = jnp.eye(m, dtype=A.dtype)
    # 1-norm: max over columns of sum over rows of |A|
    norm = jnp.max(jnp.sum(jnp.abs(A), axis=-2), axis=-1)
    # number of squarings: exponent such that norm/2^expo <= theta3,
    # matching Fortran fraction()/exponent() semantics (= ceil(log2 x))
    x = norm / _THETA3
    frac, expo = jnp.frexp(jnp.maximum(x, 1e-300))
    expo = jnp.where(frac == 0.5, expo - 1, expo)
    expo = jnp.maximum(expo, 0)
    masked = backend.choices().expm_squarings == "masked"
    if masked:
        expo = jnp.minimum(expo, _STATIC_SQUARINGS)
    A = A * jnp.exp2(-expo)[..., None, None].astype(A.dtype)

    A2 = _mm(A, A)
    A4 = _mm(A2, A2)
    A6 = _mm(A2, A4)
    V = _C[7] * A6 + _C[5] * A4 + _C[3] * A2 + _C[1] * eye
    U = _mm(A, V)
    V = _C[6] * A6 + _C[4] * A4 + _C[2] * A2 + _C[0] * eye
    R = solve_mat(V - U, 2.0 * U) + eye

    if masked:
        # fixed masked chain: no loop condition read back per trip;
        # identical squaring counts to the dynamic loop for expo <= 13
        for i in range(_STATIC_SQUARINGS):
            R = jnp.where((i < expo)[..., None, None], _mm(R, R), R)
        return R

    n_needed = jnp.minimum(jnp.max(expo), _MAX_SQUARINGS)

    def cond(state):
        i, _ = state
        return i < n_needed

    def body(state):
        i, R = state
        sq = _mm(R, R)
        return i + 1, jnp.where((i < expo)[..., None, None], sq, R)

    _, R = jax.lax.while_loop(cond, body, (jnp.int32(0), R))
    return R


# ---------------------------------------------------------------------------
# Plane-form ("structure of arrays") small-matrix algebra.
#
# A matrix is a list-of-lists of equal-shaped jnp arrays ("planes"); a
# vector is a list of planes.  This is the representation of the
# SPARTACUS layer math: every operation is a fused full-width
# elementwise op over the (batch...) arrays instead of many tiny
# (m, m) matrix operations; the m^3 unrolled FLOPs are cheap.

def planes_from(A):
    """(..., m, n) -> [[plane]]."""
    m, n = A.shape[-2], A.shape[-1]
    return [[A[..., i, j] for j in range(n)] for i in range(m)]


def planes_to(P):
    """[[plane]] -> (..., m, n)."""
    return jnp.stack([jnp.stack(row, axis=-1) for row in P], axis=-2)


def vplanes_from(v):
    return [v[..., i] for i in range(v.shape[-1])]


def vplanes_to(p):
    return jnp.stack(p, axis=-1)


def pl_matmul(A, B):
    m, k, n = len(A), len(B), len(B[0])
    return [[sum(A[i][q] * B[q][j] for q in range(k))
             for j in range(n)] for i in range(m)]


def pl_matvec(A, x):
    return [sum(A[i][q] * x[q] for q in range(len(x)))
            for i in range(len(A))]


def _pl_lu(A):
    """LU without pivoting on plane form (same recurrence as
    _lu_nopivot)."""
    m = len(A)
    LU = [row[:] for row in A]
    for k in range(m - 1):
        inv_diag = 1.0 / LU[k][k]
        for i in range(k + 1, m):
            LU[i][k] = LU[i][k] * inv_diag
            for j in range(k + 1, m):
                LU[i][j] = LU[i][j] - LU[i][k] * LU[k][j]
    return LU


def pl_solve_vec(A, b):
    """Solve A x = b; A [[plane]], b [plane] -> [plane]."""
    return _lu_sub(_pl_lu(A), list(b))


def pl_solve_mat(A, B):
    """Solve A X = B in plane form."""
    LU = _pl_lu(A)
    m, n = len(A), len(B[0])
    cols = [_lu_sub(LU, [B[i][j] for i in range(m)]) for j in range(n)]
    return [[cols[j][i] for j in range(n)] for i in range(m)]


def pl_expm(A, max_squarings=_STATIC_SQUARINGS):
    """Matrix exponential in plane form: Pade-7 scaling-and-squaring
    with the fixed masked squaring chain (see _STATIC_SQUARINGS; exact
    for 1-norms <= 2^max_squarings * theta3).  Callers whose inputs
    carry a tighter physical norm bound may lower ``max_squarings`` —
    the SPARTACUS LW 6x6 generator is bounded by ~2*max_cloud_od*gamma1
    + 4*max_3d_transfer_rate*side_emiss ~ 120 << 2^6 * theta3 = 251,
    so its chain runs 6 trips instead of 13 (the chain is ~2/3 of the
    expm flops).

    Both the Pade power series (A^2 -> A^4 -> A^6 Horner accumulation)
    and the squaring chain run as static-trip ``fori_loop``s so the
    traced HLO carries exactly TWO unrolled m^3 plane matmuls (A@A and
    the loop bodies) instead of six — this is what brought the plane
    form's XLA compile time down far enough to make it the accelerator
    only SPARTACUS implementation (round-5; see spartacus.py)."""
    m = len(A)
    dtype = A[0][0].dtype
    colsums = [sum(jnp.abs(A[i][j]) for i in range(m)) for j in range(m)]
    norm = colsums[0]
    for cs in colsums[1:]:
        norm = jnp.maximum(norm, cs)
    frac, expo = jnp.frexp(jnp.maximum(norm / _THETA3, 1e-300))
    expo = jnp.where(frac == 0.5, expo - 1, expo)
    expo = jnp.clip(expo, 0, max_squarings)
    s = jnp.exp2(-expo).astype(dtype)
    As = [[A[i][j] * s for j in range(m)] for i in range(m)]
    A2 = pl_matmul(As, As)

    # Horner-free power accumulation as a 2-trip fori_loop: carry
    # (P = A2^k, Upoly, Vpoly) and add c_{2k+1} P / c_{2k} P each trip.
    # Only ONE plane matmul appears in the loop body HLO.
    cu = jnp.asarray([_C[5], _C[7]], dtype)
    cv = jnp.asarray([_C[4], _C[6]], dtype)

    def _pow(it, state):
        P, Up, Vp = state
        P_ = [list(row) for row in P]
        A2_ = [list(row) for row in A2]
        Pn = pl_matmul(P_, A2_)
        a, b = cu[it], cv[it]
        return (tuple(tuple(Pn[i][j] for j in range(m)) for i in range(m)),
                tuple(tuple(Up[i][j] + a * Pn[i][j] for j in range(m))
                      for i in range(m)),
                tuple(tuple(Vp[i][j] + b * Pn[i][j] for j in range(m))
                      for i in range(m)))

    U0 = tuple(tuple(_C[3] * A2[i][j] + (_C[1] if i == j else 0.0)
                     for j in range(m)) for i in range(m))
    V0 = tuple(tuple(_C[2] * A2[i][j] + (_C[0] if i == j else 0.0)
                     for j in range(m)) for i in range(m))
    P0 = tuple(tuple(A2[i][j] for j in range(m)) for i in range(m))
    _, Up, Vp = jax.lax.fori_loop(0, 2, _pow, (P0, U0, V0), unroll=False)
    U = pl_matmul(As, [list(row) for row in Up])
    V = [list(row) for row in Vp]
    W = [[V[i][j] - U[i][j] for j in range(m)] for i in range(m)]
    R = pl_solve_mat(W, [[2.0 * U[i][j] for j in range(m)]
                         for i in range(m)])
    R = [[R[i][j] + (1.0 if i == j else 0.0) for j in range(m)]
         for i in range(m)]

    # fori_loop with a TRACED bound (lowers to an on-device while): the
    # per-element masked squaring makes trips beyond each element's own
    # expo exact no-ops, so running only to the batch max is
    # bit-identical to the static chain while skipping the (typically
    # ~half) trips nothing needs; max_squarings stays the hard cap
    def _sq(it, Rt):
        R_ = [list(row) for row in Rt]
        RR = pl_matmul(R_, R_)
        keep = it < expo
        return tuple(tuple(jnp.where(keep, RR[i][j], R_[i][j])
                           for j in range(m)) for i in range(m))

    n_needed = jnp.max(expo).astype(jnp.int32)
    R = jax.lax.fori_loop(0, n_needed, _sq,
                          tuple(tuple(row) for row in R),
                          unroll=False)
    return [list(row) for row in R]


def _but_matmul(A, B):
    """Block-upper-triangular matmul: A = (A11, A13, A33) with A11
    (p x p), A13 (p x q), A33 (q x q) plane blocks and a structural zero
    lower-left block.  Returns the same block triple — 405 scalar
    multiplies for (p, q) = (6, 3) vs 729 for the dense 9x9."""
    A11, A13, A33 = A
    B11, B13, B33 = B
    C11 = pl_matmul(A11, B11)
    t1 = pl_matmul(A11, B13)
    t2 = pl_matmul(A13, B33)
    C13 = [[t1[i][j] + t2[i][j] for j in range(len(t1[0]))]
           for i in range(len(t1))]
    C33 = pl_matmul(A33, B33)
    return C11, C13, C33


def _but_solve(W, B):
    """Solve W X = B for block-upper-triangular W and B (plane blocks).
    X11 = W11^-1 B11; X33 = W33^-1 B33; X13 = W11^-1 (B13 - W13 X33)."""
    W11, W13, W33 = W
    B11, B13, B33 = B
    X11 = pl_solve_mat(W11, B11)
    X33 = pl_solve_mat(W33, B33)
    t = pl_matmul(W13, X33)
    C = [[B13[i][j] - t[i][j] for j in range(len(B13[0]))]
         for i in range(len(B13))]
    X13 = pl_solve_mat(W11, C)
    return X11, X13, X33


def pl_expm_blockut(A11, A13, A33):
    """Matrix exponential of the block-upper-triangular plane matrix
    [[A11, A13], [0, A33]] — the SPARTACUS SW Gamma structure
    (radiation_spartacus_sw.F90:327-380: diffuse 6x6 block, direct 3x3
    block, diffuse-from-direct coupling, zero lower-left).  Same Pade-7
    scaling-and-squaring as :func:`pl_expm`, but every matmul and solve
    runs blockwise, and block-UT structure is preserved exactly through
    powers, the LU solve, and the squaring chain — ~45% fewer scalar
    multiplies than the dense 9x9 and the structural zeros never touch
    memory.  Returns (E11, E13, E33) plane blocks."""
    p, q = len(A11), len(A33)
    dtype = A11[0][0].dtype
    colsums = [sum(jnp.abs(A11[i][j]) for i in range(p))
               for j in range(p)] + \
              [sum(jnp.abs(A13[i][j]) for i in range(p))
               + sum(jnp.abs(A33[i][j]) for i in range(q))
               for j in range(q)]
    norm = colsums[0]
    for cs in colsums[1:]:
        norm = jnp.maximum(norm, cs)
    frac, expo = jnp.frexp(jnp.maximum(norm / _THETA3, 1e-300))
    expo = jnp.where(frac == 0.5, expo - 1, expo)
    expo = jnp.clip(expo, 0, _STATIC_SQUARINGS)
    s = jnp.exp2(-expo).astype(dtype)
    scale = lambda A: [[x * s for x in row] for row in A]
    As = (scale(A11), scale(A13), scale(A33))
    A2 = _but_matmul(As, As)

    cu = jnp.asarray([_C[5], _C[7]], dtype)
    cv = jnp.asarray([_C[4], _C[6]], dtype)

    def _badd(X, c, Y):
        return tuple(
            tuple(tuple(Xb[i][j] + c * Yb[i][j]
                        for j in range(len(Xb[i])))
                  for i in range(len(Xb)))
            for Xb, Yb in zip(X, Y))

    def _tup(X):
        return tuple(tuple(tuple(row) for row in Xb) for Xb in X)

    def _lst(X):
        return tuple([list(row) for row in Xb] for Xb in X)

    def _pow(it, state):
        P, Up, Vp = state
        Pn = _but_matmul(_lst(P), _lst(A2))
        a, b = cu[it], cv[it]
        return _tup(Pn), _badd(Up, a, Pn), _badd(Vp, b, Pn)

    def _poly0(c2, c0):
        eye = lambda n: [[c0 if i == j else 0.0 for j in range(n)]
                         for i in range(n)]
        U11 = [[c2 * A2[0][i][j] + (c0 if i == j else 0.0)
                for j in range(p)] for i in range(p)]
        U13 = [[c2 * A2[1][i][j] for j in range(q)] for i in range(p)]
        U33 = [[c2 * A2[2][i][j] + (c0 if i == j else 0.0)
                for j in range(q)] for i in range(q)]
        return (U11, U13, U33)

    U0 = _tup(_poly0(_C[3], _C[1]))
    V0 = _tup(_poly0(_C[2], _C[0]))
    _, Up, Vp = jax.lax.fori_loop(0, 2, _pow, (_tup(A2), U0, V0),
                                  unroll=False)
    U = _but_matmul(_lst(As), _lst(Up))
    V = _lst(Vp)
    W = tuple([[V[b][i][j] - U[b][i][j] for j in range(len(V[b][i]))]
               for i in range(len(V[b]))] for b in range(3))
    B2 = tuple([[2.0 * U[b][i][j] for j in range(len(U[b][i]))]
                for i in range(len(U[b]))] for b in range(3))
    R = _but_solve(W, B2)
    addeye = lambda Rb, n: [[Rb[i][j] + (1.0 if i == j else 0.0)
                             for j in range(n)] for i in range(n)]
    R = (addeye(R[0], p), R[1], addeye(R[2], q))

    def _sq(it, Rt):
        RR = _but_matmul(_lst(Rt), _lst(Rt))
        keep = it < expo
        sel = lambda X, Y: tuple(
            tuple(tuple(jnp.where(keep, Xb[i][j], Yb[i][j])
                        for j in range(len(Xb[i])))
                  for i in range(len(Xb)))
            for Xb, Yb in zip(X, Y))
        return sel(RR, Rt)

    # traced bound = batch max: bit-identical to the static chain (see
    # pl_expm) while skipping trips no element needs
    n_needed = jnp.max(expo).astype(jnp.int32)
    R = jax.lax.fori_loop(0, n_needed, _sq, _tup(R), unroll=False)
    return tuple([list(row) for row in Rb] for Rb in R)


def pl_fast_expm_exchange_3(a, b, c, d):
    """Plane-form twin of :func:`fast_expm_exchange_3`: same Putzer /
    divided-difference math, but the (..., 3, 3) result is returned as a
    [[plane]] list so SPARTACUS's entrapment accumulation never touches
    padded minor-dim tiles.  a..d are (...,) planes."""
    tmp1 = 0.5 * (a + b + c + d)
    disc = jnp.maximum(0.0, tmp1 * tmp1 - (a * c + a * d + b * d))
    tmp2 = jnp.sqrt(disc)
    lam1 = -tmp1 + tmp2
    lam2 = -tmp1 - tmp2

    small = tmp2 < 1e-3
    h2 = tmp2 * tmp2
    # sinh(x)/x via exp; series for the confluent-eigenvalue limit
    ex = jnp.exp(jnp.where(small, 1.0, tmp2))
    sinh_over = jnp.where(
        small, 1.0 + h2 / 6.0 * (1.0 + h2 / 20.0),
        (ex - 1.0 / ex) * 0.5 / jnp.where(small, 1.0, tmp2))
    dd1_12 = jnp.exp(-tmp1) * sinh_over

    tiny2 = jnp.abs(lam2) < 1e-3
    lam2_safe = jnp.where(tiny2, 1.0, lam2)
    dd2_exact = (dd1_12 - _phi1(lam1)) / lam2_safe
    s1 = lam1 + lam2
    dd2_series = (0.5 + s1 / 6.0
                  + (lam1 * lam1 + lam1 * lam2 + lam2 * lam2) / 24.0)
    dd2 = jnp.where(tiny2, dd2_series, dd2_exact)

    zero = jnp.zeros_like(a)
    M = [[-a, b, zero], [a, -b - c, d], [zero, c, -d]]
    Ms = [[M[i][j] - (lam1 if i == j else 0.0) for j in range(3)]
          for i in range(3)]
    MM = pl_matmul(M, Ms)
    p1 = _phi1(lam1)
    return [[(1.0 if i == j else 0.0) + p1 * M[i][j] + dd2 * MM[i][j]
             for j in range(3)] for i in range(3)]


def fast_expm_exchange_2(a, b):
    """expm of (-a b; a -b) via Putzer's algorithm
    (radiation_matrix.F90:914-938).  a, b (...,) -> (..., 2, 2)."""
    s = a + b
    factor = (1.0 - jnp.exp(-s)) / jnp.maximum(1.0e-12, s)
    R00 = 1.0 - factor * a
    R10 = factor * a
    R01 = factor * b
    R11 = 1.0 - factor * b
    return jnp.stack(
        [jnp.stack([R00, R01], -1), jnp.stack([R10, R11], -1)], -2)


def _phi1(x):
    """(e^x - 1)/x with the x->0 limit (stable for all x <= 0).

    Series below |x| < 0.1 (next term ~2e-10 rel), exp form above; the
    exp-form cancellation is <= eps/0.1 ~ 1.2e-6 rel in f32, below the
    solver noise floor."""
    small = jnp.abs(x) < 0.1
    xs = jnp.where(small, 0.0, x)
    safe = jnp.where(small, 1.0, xs)
    series = 1.0 + x / 2.0 * (1.0 + x / 3.0 * (
        1.0 + x / 4.0 * (1.0 + x / 5.0 * (1.0 + x / 6.0))))
    return jnp.where(small, series, (jnp.exp(safe) - 1.0) / safe)


def fast_expm_exchange_3(a, b, c, d):
    """expm of the conservative-exchange generator
    (-a b 0; a -b-c d; 0 c -d), a..d >= 0.  Returns (..., 3, 3).

    Same role as radiation_matrix.F90:952-1028 (SPARTACUS entrapment),
    but computed with Putzer's algorithm on the eigenvalue sequence
    (0, lam1, lam2) using stable divided differences of exp:

        e^M = I + dd1(0,l1) M + dd2(0,l1,l2) M (M - l1 I)

    Unlike the reference's diagonalization (which needs an epsilon
    floor between eigenvalues and loses several digits in single
    precision when lam1 ~= lam2 — the driver/test_fast_expm.F90 case),
    divided differences have no degenerate case: confluent eigenvalues
    are handled by the exact identity
    dd1(l1,l2) = e^{(l1+l2)/2} * sinh(h)/h, h = (l1-l2)/2."""
    dtype = jnp.result_type(a, b, c, d)
    tmp1 = 0.5 * (a + b + c + d)                  # = -(l1+l2)/2 >= 0
    disc = jnp.maximum(0.0, tmp1 * tmp1 - (a * c + a * d + b * d))
    tmp2 = jnp.sqrt(disc)                         # = (l1-l2)/2 >= 0
    lam1 = -tmp1 + tmp2
    lam2 = -tmp1 - tmp2

    # dd1(l1,l2): exact symmetric form, series for small half-gap
    small = tmp2 < 1e-3
    h2 = tmp2 * tmp2
    # sinh(x)/x via exp; series for the confluent-eigenvalue limit
    ex = jnp.exp(jnp.where(small, 1.0, tmp2))
    sinh_over = jnp.where(
        small, 1.0 + h2 / 6.0 * (1.0 + h2 / 20.0),
        (ex - 1.0 / ex) * 0.5 / jnp.where(small, 1.0, tmp2))
    dd1_12 = jnp.exp(-tmp1) * sinh_over

    # dd2(0,l1,l2) = (dd1(l1,l2) - dd1(l1,0)) / l2; when |l2| is small
    # all three eigenvalues are near zero -> truncated Taylor of the
    # second divided difference of exp at (0,l1,l2)
    tiny2 = jnp.abs(lam2) < 1e-3
    lam2_safe = jnp.where(tiny2, 1.0, lam2)
    dd2_exact = (dd1_12 - _phi1(lam1)) / lam2_safe
    s1 = lam1 + lam2
    dd2_series = (0.5 + s1 / 6.0
                  + (lam1 * lam1 + lam1 * lam2 + lam2 * lam2) / 24.0)
    dd2 = jnp.where(tiny2, dd2_series, dd2_exact)

    zero = jnp.zeros_like(a)
    M = jnp.stack([
        jnp.stack([-a, b, zero], -1),
        jnp.stack([a, -b - c, d], -1),
        jnp.stack([zero, c, -d], -1),
    ], -2)
    eye = jnp.eye(3, dtype=dtype)
    M_shift = M - lam1[..., None, None] * eye
    return (eye + _phi1(lam1)[..., None, None] * M
            + dd2[..., None, None] * _mm(M, M_shift))
