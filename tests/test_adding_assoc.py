"""Parallel-prefix (associative_scan) adding must match the sequential
lax.scan recurrences to f64 roundoff — the two evaluate identical
algebra (radiation_adding_ica_sw.F90:24-153,
radiation_adding_ica_lw.F90:32-334) in different association orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ecrad_tpu.solvers import adding

NCOL, NLEV, NG = 7, 61, 24


@pytest.fixture()
def rng():
    return np.random.default_rng(42)


def _cmp(monkeypatch, fn, *args, **kw):
    monkeypatch.setenv("ECRAD_TPU_ADDING", "scan")
    ref = fn(*args, **kw)
    monkeypatch.setenv("ECRAD_TPU_ADDING", "assoc")
    out = fn(*args, **kw)
    for name in ref._fields:
        r, o = getattr(ref, name), getattr(out, name)
        if r is None:
            assert o is None, name
            continue
        np.testing.assert_allclose(np.asarray(o), np.asarray(r),
                                   rtol=2e-12, atol=2e-12, err_msg=name)


def _layer_props(rng, scattering=True):
    refl = jnp.asarray(rng.uniform(0.0, 0.35, (NCOL, NLEV, NG)))
    trans = jnp.asarray(rng.uniform(0.05, 0.6, (NCOL, NLEV, NG)))
    s_up = jnp.asarray(rng.uniform(0.0, 0.2, (NCOL, NLEV, NG)))
    s_dn = jnp.asarray(rng.uniform(0.0, 0.2, (NCOL, NLEV, NG)))
    return refl, trans, s_up, s_dn


@pytest.mark.parametrize("with_spec", [False, True])
def test_sw_assoc_matches_scan(monkeypatch, rng, with_spec):
    refl, trans, s_up, s_dn = _layer_props(rng)
    tdir = jnp.asarray(rng.uniform(0.3, 0.99, (NCOL, NLEV, NG)))
    inc = jnp.asarray(rng.uniform(0.5, 1.5, (NCOL, NG)))
    alb_diff = jnp.asarray(rng.uniform(0.05, 0.6, (NCOL, NG)))
    alb_dir = jnp.asarray(rng.uniform(0.05, 0.6, (NCOL, NG)))
    mu0 = jnp.asarray(rng.uniform(0.05, 1.0, (NCOL, 1)))
    spec = jnp.asarray(np.eye(NG)[:, :5]) if with_spec else None
    _cmp(monkeypatch, adding.adding_sw_reduced, inc, alb_diff, alb_dir,
         mu0, refl, trans, s_up, s_dn, tdir, spec)


@pytest.mark.parametrize("with_spec", [False, True])
def test_lw_assoc_matches_scan(monkeypatch, rng, with_spec):
    refl, trans, s_up, s_dn = _layer_props(rng)
    emis = jnp.asarray(rng.uniform(0.0, 0.4, (NCOL, NG)))
    alb = jnp.asarray(rng.uniform(0.0, 0.15, (NCOL, NG)))
    spec = jnp.asarray(np.eye(NG)[:, :5]) if with_spec else None
    _cmp(monkeypatch, adding.adding_lw_reduced, refl, trans, s_up, s_dn,
         emis, alb, spec)


@pytest.mark.parametrize("with_spec", [False, True])
def test_lw_no_scat_assoc_matches_scan(monkeypatch, rng, with_spec):
    _, trans, s_up, s_dn = _layer_props(rng)
    emis = jnp.asarray(rng.uniform(0.0, 0.4, (NCOL, NG)))
    alb = jnp.asarray(rng.uniform(0.0, 0.15, (NCOL, NG)))
    spec = jnp.asarray(np.eye(NG)[:, :5]) if with_spec else None
    _cmp(monkeypatch, adding.lw_no_scattering_reduced, trans, s_up, s_dn,
         emis, alb, spec)
