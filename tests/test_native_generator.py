"""Native (C++/OpenMP) cloud generator vs the NumPy reference port:
must be bit-identical for all overlap schemes (the golden McICA results
depend on exact draw order)."""

import os

import numpy as np
import pytest


@pytest.fixture(scope="module")
def sampler():
    from ecrad_tpu.solvers import cloud_generator_exact as cge
    from ecrad_tpu.io.netcdf import NcFile
    from ecrad_tpu.data import DATA_DIR
    with NcFile(os.path.join(DATA_DIR, "mcica_gamma.nc")) as f:
        return cge.PdfSampler(f.get("fsd"), f.get("x").T)


@pytest.mark.parametrize("scheme", [0, 1, 2])
def test_native_bit_exact(sampler, scheme):
    from ecrad_tpu import native
    from ecrad_tpu.solvers import cloud_generator_exact as cge
    if native.lib() is None:
        pytest.skip("no C++ toolchain")
    rng = np.random.default_rng(42 + scheme)
    ncol, nlev, ng = 12, 137, 112
    frac = np.clip(rng.uniform(-0.5, 1.1, (ncol, nlev)), 0.0, 1.0)
    frac[:, :30] = 0.0
    frac[0] = 0.0                    # fully clear column
    frac[1, 60:70] = 1.0             # overcast block
    op = rng.uniform(0.0, 0.999, (ncol, nlev - 1))
    fsd = rng.uniform(0.3, 2.5, (ncol, nlev))
    iseed = np.arange(1, ncol + 1) * 7919
    kw = dict(ng=ng, i_overlap_scheme=scheme, iseed=iseed,
              frac_threshold=1e-6, frac=frac, overlap_param=op,
              decorrelation_scaling=0.5, fractional_std=fsd,
              pdf_sampler=sampler)
    od_py, cc_py = cge.cloud_generator_all_columns(
        allow_native=False, **kw)
    od_c, cc_c = native.cloud_generator_all_columns(**kw)
    assert np.array_equal(cc_py, cc_c)
    assert np.array_equal(od_py, od_c)


def test_beta_overlap_bit_exact(sampler):
    from ecrad_tpu import native
    from ecrad_tpu.solvers import cloud_generator_exact as cge
    if native.lib() is None:
        pytest.skip("no C++ toolchain")
    rng = np.random.default_rng(3)
    ncol, nlev, ng = 6, 60, 140
    frac = np.clip(rng.uniform(-0.3, 1.0, (ncol, nlev)), 0.0, 0.99)
    op = rng.uniform(0.2, 0.95, (ncol, nlev - 1))
    fsd = np.ones((ncol, nlev))
    kw = dict(ng=ng, i_overlap_scheme=1,
              iseed=np.arange(1, ncol + 1), frac_threshold=1e-6,
              frac=frac, overlap_param=op, decorrelation_scaling=0.5,
              fractional_std=fsd, pdf_sampler=sampler,
              use_beta_overlap=True)
    od_py, cc_py = cge.cloud_generator_all_columns(
        allow_native=False, **kw)
    od_c, cc_c = native.cloud_generator_all_columns(**kw)
    assert np.array_equal(od_py, od_c)
    assert np.array_equal(cc_py, cc_c)
