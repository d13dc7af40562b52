"""Equivalents of the reference's standalone kernel test programs
(driver/test_fast_expm.F90, driver/test_cloud_generator.F90,
driver/test_random_number_generator.F90): numerical edge cases and
statistical checks that golden-file tests cannot isolate."""

import os

import numpy as np
import pytest


def test_fast_expm_repeated_eigenvalue_f32():
    """driver/test_fast_expm.F90: this exact input makes the exchange
    matrix's two non-zero eigenvalues (nearly) coincide, which broke the
    single-precision diagonalization before the reference's v1.6.1 fix
    (CHANGELOG).  The result must stay close to the f64 scipy answer and
    be a valid stochastic-ish matrix (columns sum to 1: the exchange
    matrix conserves energy)."""
    import scipy.linalg as sla

    from ecrad_tpu.solvers.matrix import fast_expm_exchange_3

    a = np.float32(9.0408579e-02)
    b = np.float32(9.2716664e-07)
    c = np.float32(2.2503915e-03)
    d = np.float32(8.8152386e-02)

    R32 = np.asarray(fast_expm_exchange_3(
        np.atleast_1d(a), np.atleast_1d(b), np.atleast_1d(c),
        np.atleast_1d(d)))[0]
    assert R32.dtype == np.float32

    M = np.array([[-a, b, 0.0],
                  [a, -b - c, d],
                  [0.0, c, -d]], dtype=np.float64)
    ref = sla.expm(M)

    assert np.all(np.isfinite(R32))
    # column sums of expm of a generator matrix are exactly 1
    np.testing.assert_allclose(R32.sum(axis=0), 1.0, atol=2e-5)
    np.testing.assert_allclose(R32, ref, atol=2e-4)

    # and in f64 it should be tight
    R64 = np.asarray(fast_expm_exchange_3(
        np.atleast_1d(np.float64(a)), np.atleast_1d(np.float64(b)),
        np.atleast_1d(np.float64(c)), np.atleast_1d(np.float64(d))))[0]
    np.testing.assert_allclose(R64, ref, atol=1e-9)


@pytest.fixture(scope="module")
def sampler():
    from ecrad_tpu.io.netcdf import NcFile
    from ecrad_tpu.solvers import cloud_generator_exact as cge
    from ecrad_tpu.data import DATA_DIR
    with NcFile(os.path.join(DATA_DIR, "mcica_gamma.nc")) as f:
        return cge.PdfSampler(f.get("fsd"), f.get("x").T)


def test_cloud_generator_statistics(sampler):
    """driver/test_cloud_generator.F90: 2000 columns x 137 levels with
    two cloud decks (levels 19-99 and 114-124 0-based, fraction 0.1),
    exponential overlap 0.9, FSD 1.  Checks the *statistics* of the
    stochastic sample rather than any single draw:
      - per-level cloudy-sample frequency ~= the cloud fraction,
      - mean od_scaling over cloudy samples ~= 1 (gamma PDF has mean 1),
      - empirical total cover ~= the generator's analytic cover.
    """
    from ecrad_tpu.solvers import cloud_generator_exact as cge

    ncol, nlev, ng = 2000, 137, 1
    frac1 = np.zeros(nlev)
    frac1[19:100] = 0.1
    frac1[114:125] = 0.1
    frac = np.tile(frac1, (ncol, 1))
    overlap = np.full((ncol, nlev - 1), 0.9)
    fsd = np.ones((ncol, nlev))
    iseed = np.arange(1, ncol + 1, dtype=np.int64)

    od_scaling, cover = cge.cloud_generator_all_columns(
        ng=ng, i_overlap_scheme=2, iseed=iseed, frac_threshold=1e-6,
        frac=frac, overlap_param=overlap, decorrelation_scaling=0.5,
        fractional_std=fsd, pdf_sampler=sampler)

    cloudy = od_scaling[:, :, 0] > 0.0          # (ncol, nlev)

    # the generator samples subcolumns *conditioned on being within the
    # cloudy part of the column* (the solver weights the cloudy result
    # by total_cloud_cover, radiation_mcica_*.F90) — so every subcolumn
    # must contain cloud somewhere...
    assert cloudy.any(axis=1).all()

    ana_cover = cover.mean()
    # exponential overlap of 81 layers at alpha=0.9, frac 0.1 gives a
    # cover well above the single-layer 0.1 and below random-overlap 1.0
    assert 0.3 < ana_cover < 0.95

    # ...and the *unconditional* per-level cloud frequency
    # (freq-within-cloudy-subcolumn x cover) recovers the prescribed
    # fraction (binomial sigma ~ 0.007 over 2000 draws)
    lev_freq = cloudy[:, 19:100].mean() * ana_cover
    assert abs(lev_freq - 0.1) < 0.012

    # mean od scaling over cloudy cells: gamma PDF with FSD=1 has mean 1
    mean_scaling = od_scaling[:, :, 0][cloudy].mean()
    assert abs(mean_scaling - 1.0) < 0.05

    # max-random overlap: two decks separated by clear sky combine
    # randomly -> cover = 1-(1-0.1)^2 = 0.19 exactly
    _, cover_mr = cge.cloud_generator_all_columns(
        ng=ng, i_overlap_scheme=0, iseed=iseed, frac_threshold=1e-6,
        frac=frac, overlap_param=overlap, decorrelation_scaling=0.5,
        fractional_std=fsd, pdf_sampler=sampler)
    np.testing.assert_allclose(cover_mr, 0.19, atol=1e-9)


def test_rng_uniformity():
    """driver/test_random_number_generator.F90 analog: the lagged-
    Fibonacci stream driving the exact generator must be uniform on
    (0,1): mean 1/2, variance 1/12, no mass at the endpoints."""
    from ecrad_tpu.solvers import cloud_generator_exact as cge

    rng = cge.RandomStreamMix(12345)
    draws = np.concatenate([rng.uniform(1000) for _ in range(50)])
    assert draws.min() >= 0.0 and draws.max() <= 1.0
    assert abs(draws.mean() - 0.5) < 0.01
    assert abs(draws.var() - 1.0 / 12.0) < 0.005


def test_pdf_cheb_matches_lut():
    """The Chebyshev fit used by the on-device generator must reproduce
    the bilinear LUT sampling (radiation_pdf_sampler.F90:59-105) to well
    inside McICA sampling noise, for both PDF shapes."""
    import jax.numpy as jnp

    from ecrad_tpu.data import DATA_DIR
    from ecrad_tpu.io.netcdf import NcFile
    from ecrad_tpu.solvers.cloud_generator import (fit_pdf_cheb,
                                                   sample_pdf_cheb,
                                                   sample_pdf_jnp)

    for name, tol in (("mcica_gamma.nc", 6e-3),
                      ("mcica_lognormal.nc", 1e-3)):
        with NcFile(os.path.join(DATA_DIR, name)) as f:
            pdf = {"fsd": f.get("fsd"), "val": f.get("x").T}
        fit = fit_pdf_cheb(pdf)
        fsd = jnp.asarray(np.linspace(0.05, 3.95, 40))[:, None, None]
        cdf = jnp.asarray(np.linspace(0.002, 0.998, 499))[None, None, :]
        cdf = jnp.broadcast_to(cdf, (40, 1, 499))
        ref = np.asarray(sample_pdf_jnp(pdf, fsd, cdf))
        fast = np.asarray(sample_pdf_cheb(fit, fsd, cdf))
        rel = np.abs(fast - ref) / np.maximum(np.abs(ref), 1e-3)
        assert rel.max() < tol, (name, rel.max())


def test_device_generator_statistics():
    """Statistical contract of the on-device generator (counter-based
    RNG + Chebyshev PDF sampling), mirroring the host-generator test
    above and driver/test_cloud_generator.F90."""
    import jax.numpy as jnp

    from ecrad_tpu.config import Config, Overlap
    from ecrad_tpu.data import DATA_DIR
    from ecrad_tpu.interface import setup_radiation
    from ecrad_tpu.solvers.cloud_generator import cloud_generator_device

    ncol, nlev, ng = 500, 137, 4
    frac1 = np.zeros(nlev)
    frac1[19:100] = 0.1
    frac1[114:125] = 0.1
    frac = jnp.asarray(np.tile(frac1, (ncol, 1)))
    overlap = jnp.full((ncol, nlev - 1), 0.9)
    fsd = jnp.ones((ncol, nlev))
    iseed = jnp.arange(1, ncol + 1, dtype=jnp.int32)

    config = Config(overlap_scheme=Overlap.EXPONENTIAL_RANDOM)
    config, tables = setup_radiation(config, data_dir=DATA_DIR)

    od_scaling, cover = cloud_generator_device(
        config, tables.pdf_sampler, iseed, frac, overlap, fsd, ng)
    od_scaling = np.asarray(od_scaling)
    cover = np.asarray(cover)

    cloudy = od_scaling > 0.0
    assert cloudy.any(axis=(1, 2)).all()
    ana_cover = cover.mean()
    assert 0.3 < ana_cover < 0.95
    lev_freq = cloudy[:, 19:100].mean() * ana_cover
    assert abs(lev_freq - 0.1) < 0.012
    mean_scaling = od_scaling[cloudy].mean()
    assert abs(mean_scaling - 1.0) < 0.05


def test_exp_exp_cover_device_matches_host():
    """The batched XLA object-merge cover (cum_cloud_cover_exp_exp_jnp)
    must reproduce the per-column host port exactly — both implement
    radiation_cloud_cover.F90:339-623 including the greedy merge order."""
    import jax.numpy as jnp

    from ecrad_tpu.solvers import cloud_generator_exact as cge
    from ecrad_tpu.solvers.cloud_generator import (
        cum_cloud_cover_exp_exp_jnp)

    rng = np.random.default_rng(42)
    ncol, nlev = 60, 47
    frac = rng.uniform(0, 1, (ncol, nlev))
    # sparsify: clear gaps, multi-object profiles, some fully clear
    frac = np.where(rng.uniform(size=frac.shape) < 0.55, 0.0, frac)
    frac[0] = 0.0                               # fully clear column
    frac[1] = 0.9                               # fully cloudy column
    frac[2, ::2] = 0.0                          # alternating
    frac[3] = np.linspace(0.01, 0.99, nlev)     # monotone increase
    overlap = rng.uniform(0, 1, (ncol, nlev - 1))
    overlap[4, :] = 0.0                         # random overlap
    overlap[5, :] = 1.0                         # maximum overlap

    cum_d, pair_d = cum_cloud_cover_exp_exp_jnp(jnp.asarray(frac),
                                                jnp.asarray(overlap))
    cum_d, pair_d = np.asarray(cum_d), np.asarray(pair_d)
    for j in range(ncol):
        cum_h, pair_h = cge.cum_cloud_cover_exp_exp(frac[j], overlap[j])
        np.testing.assert_allclose(cum_d[j], cum_h, rtol=1e-10,
                                   atol=1e-12, err_msg=f"col {j} cum")
        np.testing.assert_allclose(pair_d[j], pair_h, rtol=1e-10,
                                   atol=1e-12, err_msg=f"col {j} pair")


def test_device_generator_exp_exp_statistics():
    """Device exp-exp generator: statistical contract mirroring the
    exp-ran test; cover must match the analytic exp-exp cover."""
    import jax.numpy as jnp

    from ecrad_tpu.config import Config, Overlap
    from ecrad_tpu.data import DATA_DIR
    from ecrad_tpu.interface import setup_radiation
    from ecrad_tpu.solvers.cloud_generator import (
        cloud_generator_device, cum_cloud_cover_exp_exp_jnp)

    ncol, nlev, ng = 500, 137, 4
    frac1 = np.zeros(nlev)
    frac1[19:100] = 0.1
    frac1[114:125] = 0.1
    frac = jnp.asarray(np.tile(frac1, (ncol, 1)))
    overlap = jnp.full((ncol, nlev - 1), 0.9)
    fsd = jnp.ones((ncol, nlev))
    iseed = jnp.arange(1, ncol + 1, dtype=jnp.int32)

    config = Config(overlap_scheme=Overlap.EXPONENTIAL)
    config, tables = setup_radiation(config, data_dir=DATA_DIR)

    od_scaling, cover = cloud_generator_device(
        config, tables.pdf_sampler, iseed, frac, overlap, fsd, ng)
    od_scaling = np.asarray(od_scaling)
    cover = np.asarray(cover)

    cum, _ = cum_cloud_cover_exp_exp_jnp(frac, overlap)
    np.testing.assert_allclose(cover, np.asarray(cum)[:, -1], rtol=1e-6)

    cloudy = od_scaling > 0.0
    assert cloudy.any(axis=(1, 2)).all()
    lev_freq = cloudy[:, 19:100].mean() * cover.mean()
    assert abs(lev_freq - 0.1) < 0.012
    mean_scaling = od_scaling[cloudy].mean()
    assert abs(mean_scaling - 1.0) < 0.05
