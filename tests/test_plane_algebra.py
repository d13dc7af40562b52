"""Unit tests for the plane-form ("structure of arrays") small-matrix
algebra in solvers/matrix.py (pl_matmul, pl_matvec, _pl_lu,
pl_solve_vec, pl_solve_mat, pl_expm) — the representation of the
SPARTACUS layer math (see matrix.py plane-algebra notes).

Validated against the array-form ops and scipy on random
exchange-structured generator matrices, including the
repeated-eigenvalue inputs of driver/test_fast_expm.F90, plus a
norm-bound check for the fixed squaring-chain cap (_STATIC_SQUARINGS)
against the config clamps that keep solver inputs below it."""

import numpy as np
import pytest
import scipy.linalg as sla

import jax.numpy as jnp

from ecrad_tpu.solvers import matrix as M


def _rand(rng, shape):
    return rng.standard_normal(shape)


def _dd_matrices(rng, batch, m, scale=1.0):
    """Random strongly diagonally dominant batch (no-pivot LU safe)."""
    A = _rand(rng, batch + (m, m)) * scale
    d = np.abs(A).sum(-1) + 1.0
    A[..., np.arange(m), np.arange(m)] += d
    return A


def _exchange_generator(rng, batch, m, od_scale=4.0):
    """Random conservative-exchange-structured generator like the
    SPARTACUS Gamma blocks: nonpositive diagonal, nonnegative
    off-diagonals, columns summing to <= 0 (substochastic)."""
    T = np.abs(_rand(rng, batch + (m, m))) * od_scale / m
    T[..., np.arange(m), np.arange(m)] = 0.0
    G = T.copy()
    G[..., np.arange(m), np.arange(m)] = -T.sum(-2) \
        - np.abs(_rand(rng, batch + (m,)))
    return G


@pytest.mark.parametrize("m", [3, 6, 9])
def test_pl_matmul_matvec(m):
    rng = np.random.default_rng(7 + m)
    A = _rand(rng, (4, 5, m, m))
    B = _rand(rng, (4, 5, m, m))
    x = _rand(rng, (4, 5, m))
    Ap, Bp = M.planes_from(jnp.asarray(A)), M.planes_from(jnp.asarray(B))
    got = np.asarray(M.planes_to(M.pl_matmul(Ap, Bp)))
    np.testing.assert_allclose(got, A @ B, rtol=1e-12, atol=1e-12)
    gotv = np.asarray(M.vplanes_to(
        M.pl_matvec(Ap, M.vplanes_from(jnp.asarray(x)))))
    np.testing.assert_allclose(gotv, np.einsum("...ij,...j->...i", A, x),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("m", [3, 6, 9])
def test_pl_lu_solve_vs_numpy(m):
    rng = np.random.default_rng(17 + m)
    A = _dd_matrices(rng, (6,), m)
    B = _rand(rng, (6, m, m))
    b = _rand(rng, (6, m))
    Ap = M.planes_from(jnp.asarray(A))
    x = np.asarray(M.vplanes_to(
        M.pl_solve_vec(Ap, M.vplanes_from(jnp.asarray(b)))))
    np.testing.assert_allclose(x, np.linalg.solve(A, b[..., None])[..., 0],
                               rtol=1e-10)
    X = np.asarray(M.planes_to(
        M.pl_solve_mat(Ap, M.planes_from(jnp.asarray(B)))))
    np.testing.assert_allclose(X, np.linalg.solve(A, B), rtol=1e-10)
    # plane LU agrees with the array-form no-pivot LU entry by entry
    LUp = M._pl_lu(Ap)
    LUa = M._lu_nopivot(jnp.asarray(A))
    for i in range(m):
        for j in range(m):
            np.testing.assert_allclose(np.asarray(LUp[i][j]),
                                       np.asarray(LUa[i][j]), rtol=1e-12)


@pytest.mark.parametrize("m", [3, 6, 9])
def test_pl_expm_vs_array_and_scipy(m):
    rng = np.random.default_rng(29 + m)
    G = _exchange_generator(rng, (8,), m)
    Gp = M.planes_from(jnp.asarray(G))
    got = np.asarray(M.planes_to(M.pl_expm(Gp)))
    ref = np.stack([sla.expm(g) for g in G])
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-11)
    arr = np.asarray(M.expm(jnp.asarray(G)))
    np.testing.assert_allclose(got, arr, rtol=1e-11, atol=1e-13)


def test_pl_expm_large_norm_uses_squaring_chain():
    """Norms requiring many squarings (up to the _STATIC_SQUARINGS cap)
    still match scipy — exercises the masked fori_loop chain."""
    rng = np.random.default_rng(3)
    for scale in (50.0, 500.0, 2.0e4):
        G = _exchange_generator(rng, (4,), 6, od_scale=scale)
        norm = np.abs(G).sum(-2).max()
        assert norm > M._THETA3          # really needs squarings
        got = np.asarray(M.planes_to(M.pl_expm(M.planes_from(
            jnp.asarray(G)))))
        ref = np.stack([sla.expm(g) for g in G])
        # tolerance: Pade-7 at theta3=3.93 (a single-precision theta the
        # reference also uses in double) has ~1e-9 local error, and the
        # ~13 squarings amplify it ~2^13 — mechanism test, not precision
        np.testing.assert_allclose(got, ref, rtol=2e-6, atol=1e-12)


def test_pl_expm_repeated_eigenvalue_case():
    """driver/test_fast_expm.F90: inputs that give the 3x3
    conservative-exchange generator two (near-)repeated eigenvalues.
    The general Pade path has no degenerate case, but pin it anyway —
    this is the canonical SPARTACUS stress input."""
    a, b, c, d = 9.0408579e-02, 9.2716664e-07, 2.2503915e-03, \
        8.8152386e-02
    G = np.array([[-a, b, 0.0],
                  [a, -b - c, d],
                  [0.0, c, -d]])
    got = np.asarray(M.planes_to(M.pl_expm(M.planes_from(
        jnp.asarray(G[None])))))[0]
    ref = sla.expm(G)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)
    # and the dedicated Putzer routine on the same inputs
    fast = np.asarray(M.fast_expm_exchange_3(
        jnp.asarray([a]), jnp.asarray([b]), jnp.asarray([c]),
        jnp.asarray([d])))[0]
    np.testing.assert_allclose(fast, ref, rtol=1e-9, atol=1e-12)
    # plane-form twin must match the array form exactly
    pfast = np.asarray(M.planes_to(M.pl_fast_expm_exchange_3(
        jnp.asarray([a]), jnp.asarray([b]), jnp.asarray([c]),
        jnp.asarray([d]))))[0]
    np.testing.assert_allclose(pfast, fast, rtol=1e-14, atol=0.0)


def test_pl_expm_blockut_matches_dense():
    """The block-UT expm (SW Gamma structure) must match the dense
    plane expm on matrices with a zero lower-left 3x6 block, across
    norms exercising 0..many squarings."""
    rng = np.random.default_rng(41)
    for scale in (2.0, 40.0, 3000.0):
        G = _exchange_generator(rng, (5,), 9, od_scale=scale)
        G[..., 6:9, 0:6] = 0.0                 # SW block-UT structure
        Gp = M.planes_from(jnp.asarray(G))
        dense = np.asarray(M.planes_to(M.pl_expm(Gp)))
        A11 = [[Gp[i][j] for j in range(6)] for i in range(6)]
        A13 = [[Gp[i][6 + j] for j in range(3)] for i in range(6)]
        A33 = [[Gp[6 + i][6 + j] for j in range(3)] for i in range(3)]
        E11, E13, E33 = M.pl_expm_blockut(A11, A13, A33)
        got = np.zeros_like(dense)
        got[..., 0:6, 0:6] = np.asarray(M.planes_to(E11))
        got[..., 0:6, 6:9] = np.asarray(M.planes_to(E13))
        got[..., 6:9, 6:9] = np.asarray(M.planes_to(E33))
        assert np.abs(dense[..., 6:9, 0:6]).max() < 1e-13
        np.testing.assert_allclose(got, dense, rtol=1e-10, atol=1e-13)


def test_pl_fast_expm_exchange_3_batch():
    rng = np.random.default_rng(5)
    a, b, c, d = [jnp.asarray(np.abs(rng.random((6, 7)))) for _ in
                  range(4)]
    arr = np.asarray(M.fast_expm_exchange_3(a, b, c, d))
    pl = np.asarray(M.planes_to(M.pl_fast_expm_exchange_3(a, b, c, d)))
    np.testing.assert_allclose(pl, arr, rtol=1e-13, atol=1e-15)


def test_lw_squaring_cap_covers_config_clamps():
    """The SPARTACUS LW solver runs pl_expm with max_squarings=6
    (spartacus layer_mats): assert the worst-case LW 6x6 Gamma 1-norm
    implied by the config clamps stays below 2^6 * theta3, and that
    pl_expm at that cap matches scipy near the bound."""
    from ecrad_tpu.config import Config
    from ecrad_tpu.solvers.spartacus import SIDE_EMISS_THIN

    cfg = Config()
    od = cfg.max_cloud_od
    tr = cfg.max_3d_transfer_rate
    # one column of the LW G: |od*g1 + sum of 3 rates| + 2 rate entries
    # (side-emissivity-scaled, <= 1.4107) + the od*g2 coupling (g2 <=
    # gamma1 <= 2 for ssa <= 1)
    worst = od * 2.0 + 3.0 * tr * SIDE_EMISS_THIN \
        + 2.0 * tr * SIDE_EMISS_THIN + od * 2.0
    cap = 2.0 ** 6 * M._THETA3
    assert worst < cap, (worst, cap)
    rng = np.random.default_rng(23)
    G = _exchange_generator(rng, (3,), 6, od_scale=worst / 2.0)
    got = np.asarray(M.planes_to(M.pl_expm(
        M.planes_from(jnp.asarray(G)), max_squarings=6)))
    ref = np.stack([sla.expm(g) for g in G])
    np.testing.assert_allclose(got, ref, rtol=1e-7, atol=1e-12)


def test_static_squaring_cap_covers_config_clamps():
    """_STATIC_SQUARINGS=13 caps the masked squaring chain: it is exact
    for 1-norms <= 2^13 * theta3.  Assert the worst-case SPARTACUS
    Gamma 1-norm implied by the config clamps stays below that bound
    (matrix.py:29-40 relies on this silently).

    SW Gamma column bound (radiation_spartacus_sw.F90:327-380 analog,
    solvers/spartacus.py layer_mats): the direct block dominates with
    |S_jj| = od/mu0 + transfer terms; od <= max_cloud_od, 1/mu0 <=
    1/MIN_MU0_3D, each transfer rate <= max_3d_transfer_rate and a
    column holds at most 2 rate entries + their diagonal sums; the
    diffuse block adds od*g1 with g1 <= 2 (Meador-Weaver gamma1 for
    ssa<=1) and od*|g2|, od*ssa*g3 <= od."""
    from ecrad_tpu.config import Config
    from ecrad_tpu.solvers.spartacus import MIN_MU0_3D

    cfg = Config()
    od = cfg.max_cloud_od
    tr = cfg.max_3d_transfer_rate
    # worst single column: diagonal |od/mu0 + sum of 2 rates| plus the
    # 2 off-diagonal rate entries, plus the diffuse coupling terms
    direct_col = od / MIN_MU0_3D + 2.0 * tr + 2.0 * tr
    diffuse_col = od * 2.0 + 2.0 * tr + 2.0 * tr + od + od
    worst = max(direct_col, diffuse_col) + 2.0 * od   # coupling C1/C2
    cap = 2.0 ** M._STATIC_SQUARINGS * M._THETA3
    assert worst < cap, (worst, cap)
    # and pl_expm still matches scipy at ~the worst-case norm
    rng = np.random.default_rng(11)
    G = _exchange_generator(rng, (2,), 9, od_scale=worst / 2.0)
    got = np.asarray(M.planes_to(M.pl_expm(M.planes_from(
        jnp.asarray(G)))))
    ref = np.stack([sla.expm(g) for g in G])
    np.testing.assert_allclose(got, ref, rtol=1e-7, atol=1e-12)
