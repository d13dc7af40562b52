"""Fused McICA sweeps (solvers/triton_mcica.py, Pallas on the Triton
route) vs the unfused scan path (same two-stream + merge + adding math;
interpret mode on CPU, f64, so agreement is to roundoff)."""

import numpy as np
import pytest

import jax.numpy as jnp

from ecrad_tpu.solvers import mcica

NCOL, NLEV = 19, 17
NBAND = 5
GCOUNTS = (3, 2, 4, 2, 3)          # ng = 14: one partial g tile
NG = sum(GCOUNTS)
BAND_FROM_G = np.repeat(np.arange(NBAND), GCOUNTS)


@pytest.fixture()
def props():
    rng = np.random.default_rng(42)

    def u(*shape, lo=0.0, hi=1.0):
        return jnp.asarray(rng.uniform(lo, hi, shape))

    frac = jnp.asarray(
        rng.uniform(0, 1, (NCOL, NLEV))
        * (rng.uniform(0, 1, (NCOL, NLEV)) > 0.5))
    return dict(
        od=u(NCOL, NLEV, NG, lo=1e-4, hi=2.0),
        ssa=u(NCOL, NLEV, NG, lo=0.1, hi=0.999),
        g=u(NCOL, NLEV, NG, lo=0.0, hi=0.8),
        od_cloud_b=u(NCOL, NLEV, NBAND, lo=0.0, hi=5.0),
        ssa_cloud_b=u(NCOL, NLEV, NBAND, lo=0.3, hi=0.999),
        g_cloud_b=u(NCOL, NLEV, NBAND, lo=0.0, hi=0.9),
        od_scaling=u(NCOL, NLEV, NG, lo=0.0, hi=2.0),
        tcc=u(NCOL, lo=0.0, hi=1.0),
        cloud_fraction=frac,
        planck_hl=u(NCOL, NLEV + 1, NG, lo=0.5, hi=30.0),
        emission=u(NCOL, NG, hi=10.0),
        albedo=u(NCOL, NG, hi=0.3),
        incoming=u(NCOL, NG, hi=100.0),
        cos_sza=jnp.asarray(
            rng.uniform(-0.2, 1.0, (NCOL,))),   # includes night columns
        albedo_direct=u(NCOL, NG, hi=0.4),
    )


def _fields(out_p, out_s, rtol=1e-11, atol=1e-10):
    for name in out_s._fields:
        a, b = getattr(out_p, name), getattr(out_s, name)
        if b is None:
            assert a is None, name
            continue
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("derivs", [False, True])
def test_lw_fused_matches_scan(props, monkeypatch, derivs):
    p = props
    def call():
        return mcica.solver_mcica_lw(
            p["od"], None, None, p["od_cloud_b"], p["ssa_cloud_b"],
            p["g_cloud_b"], BAND_FROM_G, p["od_scaling"], p["tcc"],
            p["cloud_fraction"], p["planck_hl"], p["emission"],
            p["albedo"],
            do_lw_cloud_scattering=True, do_lw_aerosol_scattering=False,
            do_lw_derivatives=derivs)

    monkeypatch.setenv("ECRAD_TPU_ADDING", "scan")
    ref = call()
    monkeypatch.setenv("ECRAD_TPU_ADDING", "triton")
    got = call()
    _fields(got, ref)


def test_sw_fused_matches_scan(props, monkeypatch):
    p = props

    def call():
        return mcica.solver_mcica_sw(
            p["od"], p["ssa"], p["g"], p["od_cloud_b"],
            p["ssa_cloud_b"], p["g_cloud_b"], BAND_FROM_G,
            p["od_scaling"], p["tcc"], p["cloud_fraction"],
            p["incoming"], p["cos_sza"], p["albedo"],
            p["albedo_direct"])

    monkeypatch.setenv("ECRAD_TPU_ADDING", "scan")
    ref = call()
    monkeypatch.setenv("ECRAD_TPU_ADDING", "triton")
    got = call()
    _fields(got, ref)


def _rrtmg_props(band_from_g, ncol, nlev, seed):
    """Random inputs with RRTMG's g-point count and band layout."""
    rng = np.random.default_rng(seed)
    ng, nband = len(band_from_g), int(np.max(band_from_g)) + 1

    def u(*shape, lo=0.0, hi=1.0):
        return jnp.asarray(rng.uniform(lo, hi, shape))

    frac = jnp.asarray(rng.uniform(0, 1, (ncol, nlev))
                       * (rng.uniform(0, 1, (ncol, nlev)) > 0.5))
    return dict(
        od=u(ncol, nlev, ng, lo=1e-4, hi=2.0),
        ssa=u(ncol, nlev, ng, lo=0.1, hi=0.999),
        g=u(ncol, nlev, ng, lo=0.0, hi=0.8),
        od_cloud_b=u(ncol, nlev, nband, lo=0.0, hi=5.0),
        ssa_cloud_b=u(ncol, nlev, nband, lo=0.3, hi=0.999),
        g_cloud_b=u(ncol, nlev, nband, lo=0.0, hi=0.9),
        od_scaling=u(ncol, nlev, ng, lo=0.0, hi=2.0),
        tcc=u(ncol), cloud_fraction=frac,
        planck_hl=u(ncol, nlev + 1, ng, lo=0.5, hi=30.0),
        emission=u(ncol, ng, hi=10.0), albedo=u(ncol, ng, hi=0.3),
        incoming=u(ncol, ng, hi=100.0),
        cos_sza=jnp.asarray(rng.uniform(-0.2, 1.0, (ncol,))),
        albedo_direct=u(ncol, ng, hi=0.4))


def _knl(x):
    return jnp.transpose(x, (1, 2, 0))


def test_lw_kernel_layout_ng140_column_tail(monkeypatch):
    """The kernel-layout entry at RRTMG-LW width (ng 140: eight full g
    tiles and a partial one) over a column count that leaves a partial
    column tile."""
    from ecrad_tpu.optics import rrtmg
    from ecrad_tpu.solvers import triton_mcica
    band = rrtmg.setup_tables()["lw_band_from_g"]
    ncol = triton_mcica.COL_TILE + 6
    p = _rrtmg_props(band, ncol, 4, seed=1)

    def call(layout, f):
        return mcica.solver_mcica_lw(
            f(p["od"]), None, None, p["od_cloud_b"], p["ssa_cloud_b"],
            p["g_cloud_b"], band, f(p["od_scaling"]), p["tcc"],
            p["cloud_fraction"], f(p["planck_hl"]), p["emission"],
            p["albedo"], do_lw_cloud_scattering=True,
            do_lw_aerosol_scattering=False, do_lw_derivatives=True,
            layout=layout)

    monkeypatch.setenv("ECRAD_TPU_ADDING", "scan")
    ref = call("cln", lambda x: x)
    monkeypatch.setenv("ECRAD_TPU_ADDING", "triton")
    _fields(call("knl", _knl), ref)


def test_sw_kernel_layout_ng112_column_tail(monkeypatch):
    """The kernel-layout entry at RRTMG-SW width (ng 112) with gas
    delta-scaling on, over a partial column tile."""
    from ecrad_tpu.optics import rrtmg
    from ecrad_tpu.solvers import triton_mcica
    band = rrtmg.setup_tables()["sw_band_from_g"]
    ncol = triton_mcica.COL_TILE + 6
    p = _rrtmg_props(band, ncol, 4, seed=2)

    def call(layout, f):
        return mcica.solver_mcica_sw(
            f(p["od"]), f(p["ssa"]), f(p["g"]), p["od_cloud_b"],
            p["ssa_cloud_b"], p["g_cloud_b"], band, f(p["od_scaling"]),
            p["tcc"], p["cloud_fraction"], p["incoming"], p["cos_sza"],
            p["albedo"], p["albedo_direct"],
            do_sw_delta_scaling_with_gases=True, layout=layout)

    monkeypatch.setenv("ECRAD_TPU_ADDING", "scan")
    ref = call("cln", lambda x: x)
    monkeypatch.setenv("ECRAD_TPU_ADDING", "triton")
    _fields(call("knl", _knl), ref)
