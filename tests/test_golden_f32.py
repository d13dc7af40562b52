"""Golden-file tests in single precision (float32).

The reference ships single-precision builds validated at LW/SW max-abs
error <= 0.5 W m-2 against the same double-precision reference outputs
(test/ifs/CMakeLists.txt:15-18, Makefile_include `SINGLE_PRECISION`).
Production on the GPU is float32, so the same bar must hold for this
framework: run the deterministic/golden configurations with every input
cast to f32 and all math traced at f32 (jax disable_x64), and compare
against the committed double-precision reference files at the sp
thresholds.

The device path itself is covered by chip_smoke.py, which compares
float32 with float64 of the same code on the GPU at the same bar; this
module proves the *algorithm* meets the sp bar.
"""

import os

import pytest

from ecrad_tpu.config import Config, Solver

from . import golden

SP_LW = 0.5
SP_SW = 0.5


def _compare_f32(flux, reference_name, skip=()):
    return golden.compare(
        flux, os.path.join(golden.TEST_IFS, reference_name),
        lw_threshold=SP_LW, sw_threshold=SP_SW, skip=skip)


def _run_f32(config, nam=golden.CONFIG_NAM, skip=(), reference_name=None):
    import jax
    import jax.numpy as jnp

    from ecrad_tpu.io.input import DriverConfig, read_input

    with jax.enable_x64(False):
        dc = DriverConfig.from_namelist(nam)
        inp = read_input(golden.INPUT_FILE, dc)
        extra = {}
        if inp.aerosol_mmr is not None and config.use_aerosols:
            extra["aerosol"] = {
                "mixing_ratio": jnp.asarray(inp.aerosol_mmr,
                                            jnp.float32)}
        flux, _ = golden.run_config(config, driver_config=dc,
                                    extra_inputs=extra)
        jax.block_until_ready(flux)
    errors = _compare_f32(flux, reference_name, skip=skip)
    print(errors)
    return errors


def test_default_f32():
    config = Config.from_namelist(golden.CONFIG_NAM)
    _run_f32(config,
             reference_name="ecrad_meridian_default_out_REFERENCE.nc")


def test_tripleclouds_f32():
    config = Config.from_namelist(golden.CONFIG_NAM).replace(
        sw_solver=Solver.TRIPLECLOUDS, lw_solver=Solver.TRIPLECLOUDS)
    # lw_derivative skipped for the same reason as the f64 test
    _run_f32(config, skip=("lw_derivative",),
             reference_name="ecrad_meridian_tripleclouds_out_REFERENCE.nc")


def test_cloudless_f32():
    config = Config.from_namelist(golden.CONFIG_NAM).replace(
        use_aerosols=False,
        sw_solver=Solver.CLOUDLESS, lw_solver=Solver.CLOUDLESS)
    _run_f32(config,
             reference_name="ecrad_meridian_cloudless_out_REFERENCE.nc")


def test_ecckd_f32():
    nam = os.path.join(golden.TEST_IFS, "configCY49R1_ecckd.nam")
    config = Config.from_namelist(nam).replace(
        sw_solver=Solver.MCICA, lw_solver=Solver.MCICA,
        do_surface_sw_spectral_flux=True)
    _run_f32(config, nam=nam,
             reference_name="ecrad_meridian_ecckd_mcica_out_REFERENCE.nc")
