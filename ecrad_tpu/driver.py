"""Offline driver CLI, same contract as the reference:

    python -m ecrad_tpu.driver config.nam input.nc output.nc

Reference: driver/ecrad_driver.F90:28-431 (namelist → setup →
read input → radiation over all columns → save_fluxes).

The stochastic McICA sample is produced by the bit-exact host generator by
default (reproducing the reference's lagged-Fibonacci stream); pass
``--generator device`` to use the on-device counter-based generator.
"""

from __future__ import annotations

import argparse
import functools
import sys
import time

import numpy as np


def build_cloud_inputs(config, inp, generator="exact"):
    """Cloud dict for radiation(), incl. McICA samples if needed."""
    import jax.numpy as jnp

    from ecrad_tpu.config import Solver

    cloud = {
        "fraction": jnp.asarray(inp.cloud_fraction),
        "q_liq": jnp.asarray(inp.cloud_mixing_ratio[:, :, 0]),
        "q_ice": jnp.asarray(inp.cloud_mixing_ratio[:, :, 1]),
        "re_liq": jnp.asarray(inp.cloud_effective_radius[:, :, 0]),
        "re_ice": jnp.asarray(inp.cloud_effective_radius[:, :, 1]),
        "overlap_param": jnp.asarray(inp.overlap_param),
        "fractional_std": jnp.asarray(inp.fractional_std),
        "iseed": jnp.asarray(inp.iseed, jnp.int32),
    }
    if inp.inv_cloud_effective_size is not None:
        cloud["inv_cloud_effective_size"] = jnp.asarray(
            inp.inv_cloud_effective_size)
        if inp.inv_inhom_effective_size is not None:
            cloud["inv_inhom_effective_size"] = jnp.asarray(
                inp.inv_inhom_effective_size)
    if Solver.MCICA not in (config.sw_solver, config.lw_solver):
        return cloud

    frac = np.asarray(inp.cloud_fraction)
    total_water = inp.cloud_mixing_ratio.sum(axis=-1)
    frac = np.where(
        (frac >= config.cloud_fraction_threshold)
        & (total_water >= config.cloud_mixing_ratio_threshold), frac, 0.0)

    if generator == "exact":
        from ecrad_tpu.solvers import cloud_generator_exact as cge
        sampler = None

        def gen(ng, iseed):
            nonlocal sampler
            if sampler is None:
                from ecrad_tpu.config import PdfShape
                from ecrad_tpu.io.netcdf import NcFile
                import os
                from ecrad_tpu.data import DATA_DIR
                pdf_file = ("mcica_gamma.nc"
                            if config.cloud_pdf_shape == PdfShape.GAMMA
                            else "mcica_lognormal.nc")
                path = os.path.join(config.directory_name, pdf_file)
                if not os.path.exists(path):
                    path = os.path.join(DATA_DIR, pdf_file)
                with NcFile(path) as f:
                    sampler = cge.PdfSampler(f.get("fsd"), f.get("x").T)
            return cge.cloud_generator_all_columns(
                ng, int(config.overlap_scheme), iseed,
                config.cloud_fraction_threshold, frac, inp.overlap_param,
                config.cloud_inhom_decorr_scaling, inp.fractional_std,
                sampler, config.use_beta_overlap)

        if config.sw_solver == Solver.MCICA:
            od_s, tcc = gen(config.n_g_sw, inp.iseed)
            cloud["od_scaling_sw"] = jnp.asarray(od_s)
            cloud["total_cloud_cover_sw"] = jnp.asarray(tcc)
        if config.lw_solver == Solver.MCICA:
            od_s, tcc = gen(config.n_g_lw, inp.iseed + 997)
            cloud["od_scaling_lw"] = jnp.asarray(od_s)
            cloud["total_cloud_cover_lw"] = jnp.asarray(tcc)
    else:
        # on-device counter-based generator — samples computed inside
        # the jitted step by interface helpers; mark for deferral
        cloud["_device_generator"] = True
    return cloud


def resolve_data_dir(config, config_path):
    """The reference resolves a relative directory_name against the CWD,
    and its namelists carry paths like "../../data" meant for runs from
    test/ifs/.  Accept both: if the path does not resolve from here,
    retry relative to the namelist's own directory."""
    import os
    ddir = config.directory_name
    if ddir and not os.path.isabs(ddir) and not os.path.isdir(ddir):
        cand = os.path.normpath(
            os.path.join(os.path.dirname(os.path.abspath(config_path)),
                         ddir))
        if os.path.isdir(cand):
            config = config.replace(directory_name=cand)
    return config


def run(config_path: str, input_path: str, output_path: str,
        dtype: str = "float64", jit: bool = True, nrepeat: int = None,
        generator: str = "exact"):
    import jax
    if dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from ecrad_tpu.config import Config, Solver
    from ecrad_tpu.interface import radiation, setup_radiation
    from ecrad_tpu.io.input import DriverConfig, read_input
    from ecrad_tpu.io.output import save_fluxes, save_net_fluxes

    from ecrad_tpu import profiling
    from ecrad_tpu.jax_setup import enable_persistent_cache

    enable_persistent_cache()
    config = Config.from_namelist(config_path)
    driver_config = DriverConfig.from_namelist(config_path)

    config = resolve_data_dir(config, config_path)
    if nrepeat is None:
        nrepeat = driver_config.nrepeat

    if driver_config.iverbose >= 2:
        print("-------------------- OFFLINE ECRAD_TPU RADIATION SCHEME "
              "--------------------")
        print(f"Floating-point precision: "
              f"{'double' if dtype == 'float64' else 'single'}")

    with profiling.hook('radiation_interface:setup_radiation'):
        config, tables = setup_radiation(config)

    if driver_config.iverbose >= 2:
        # resolved-config dump (radiation_config.F90:1411-1612)
        from ecrad_tpu.config import describe_config
        print(describe_config(config))

    # setup-optics diagnostic dumps (ecrad_driver.F90:224-230)
    if driver_config.do_save_aerosol_optics and tables.aerosol:
        from ecrad_tpu.io.save_optics import save_aerosol_optics
        save_aerosol_optics("aerosol_optics.nc", tables.aerosol,
                            hdf5=driver_config.do_write_hdf5)
    if driver_config.do_save_cloud_optics \
            and config.use_general_cloud_optics and tables.cloud:
        from ecrad_tpu.io.save_optics import save_general_cloud_optics
        save_general_cloud_optics("hydrometeor_optics", tables.cloud,
                                  hdf5=driver_config.do_write_hdf5)
    with profiling.hook('ecrad_driver:read_input'):
        inp = read_input(input_path, driver_config)

    # bounds validation (driver/ecrad_driver.F90:314-323)
    from ecrad_tpu.check import check_inputs
    any_bad, inp = check_inputs(
        inp, do_fix=driver_config.do_correct_unphysical_inputs)
    if any_bad and not driver_config.do_correct_unphysical_inputs:
        raise ValueError(
            "input fields out of physical bounds; set "
            "do_correct_unphysical_inputs=true to clamp them")

    # Level-windowed one-hot RRTMG interpolation: probe the input grid
    # for exact per-level index spans before tracing (rrtmg_interp
    # module notes; the gather form needs no windows)
    from ecrad_tpu.optics import rrtmg as rrtmg_mod
    rrtmg_mod.install_interp_windows(tables, inp.thermodynamics)

    dt = jnp.float64 if dtype == "float64" else jnp.float32

    def to_dev(x):
        return jnp.asarray(x, dt) if x is not None else None

    cloud = None
    if config.do_clouds:
        with profiling.hook('ecrad_driver:build_cloud_inputs'):
            cloud = build_cloud_inputs(config, inp, generator)
        use_device_gen = cloud.pop("_device_generator", False)
    else:
        use_device_gen = False

    aerosol = None
    if config.use_aerosols and inp.aerosol_mmr is not None:
        aerosol = {"mixing_ratio": to_dev(inp.aerosol_mmr)}

    kwargs = dict(
        pressure_hl=to_dev(inp.thermodynamics.pressure_hl),
        temperature_hl=to_dev(inp.thermodynamics.temperature_hl),
        gas_mmr=to_dev(inp.gas_mmr),
        cos_sza=to_dev(inp.cos_sza),
        skin_temperature=to_dev(inp.skin_temperature),
        sw_albedo=to_dev(inp.sw_albedo),
        sw_albedo_direct=to_dev(inp.sw_albedo_direct),
        lw_emissivity=to_dev(inp.lw_emissivity),
        cloud=cloud, aerosol=aerosol,
    )
    solar = float(inp.solar_irradiance)

    def step(**kw):
        cl = kw.get("cloud")
        if use_device_gen and cl is not None:
            from ecrad_tpu.solvers.cloud_generator import (
                cloud_generator_device)
            total_water = cl["q_liq"] + cl["q_ice"]
            keep = ((cl["fraction"] >= config.cloud_fraction_threshold)
                    & (total_water
                       >= config.cloud_mixing_ratio_threshold))
            frac = jnp.where(keep, cl["fraction"], 0.0)
            if config.sw_solver == Solver.MCICA:
                od_s, tcc = cloud_generator_device(
                    config, tables.pdf_sampler, cl["iseed"], frac,
                    cl["overlap_param"], cl["fractional_std"],
                    config.n_g_sw)
                cl = dict(cl, od_scaling_sw=od_s,
                          total_cloud_cover_sw=tcc)
            if config.lw_solver == Solver.MCICA:
                od_s, tcc = cloud_generator_device(
                    config, tables.pdf_sampler, cl["iseed"] + 997, frac,
                    cl["overlap_param"], cl["fractional_std"],
                    config.n_g_lw)
                cl = dict(cl, od_scaling_lw=od_s,
                          total_cloud_cover_lw=tcc)
            kw = dict(kw, cloud=cl)
        return radiation(
            config, tables, solar_irradiance=solar,
            spectral_solar_cycle_multiplier=float(
                inp.spectral_solar_cycle_multiplier), **kw)

    fn = jax.jit(step) if jit else step

    t0 = time.time()
    with profiling.hook('ecrad_driver:radiation[first_call+compile]'):
        flux = fn(**kwargs)
        jax.block_until_ready(flux)
    t_first = time.time() - t0

    t0 = time.time()
    for _ in range(max(0, nrepeat - 1)):
        with profiling.hook('ecrad_driver:radiation'):
            flux = fn(**kwargs)
            jax.block_until_ready(flux)
    t_rest = time.time() - t0

    ncol = inp.ncol
    print(f"ecrad_tpu: {ncol} columns x {inp.nlev} levels; "
          f"first call (incl. compile) {t_first:.3f}s"
          + (f"; {nrepeat-1} repeats {t_rest:.3f}s "
             f"({ncol*(nrepeat-1)/max(t_rest,1e-9):.0f} cols/s)"
             if nrepeat > 1 else ""))

    out_phl = inp.thermodynamics.pressure_hl
    if inp.flipped:
        # flip output profiles back to the file's surface-first order
        # (radiation_interface.F90 radiation_reverse)
        rep = {}
        for f in ("lw_up", "lw_dn", "sw_up", "sw_dn", "sw_dn_direct",
                  "lw_up_clear", "lw_dn_clear", "sw_up_clear",
                  "sw_dn_clear", "sw_dn_direct_clear",
                  "lw_derivatives"):
            v = getattr(flux, f, None)
            if v is not None:
                rep[f] = v[:, ::-1]
        flux = flux.replace(**rep)
        out_phl = out_phl[:, ::-1]

    # Post-run output validation (ecrad_driver.F90:395
    # flux%out_of_physical_bounds / heating_rate_out_of_physical_bounds,
    # radiation_flux.F90:117): report non-finite fluxes and out-of-range
    # heating rates to stderr; the run still completes, as in the
    # reference (warn-only).
    from ecrad_tpu.check import check_fluxes
    check_fluxes(flux, out_phl)

    if driver_config.do_save_net_fluxes:
        save_net_fluxes(output_path, config, flux, out_phl,
                        experiment_name=driver_config.experiment_name,
                        double_precision=(
                            driver_config.do_write_double_precision),
                        hdf5=driver_config.do_write_hdf5)
    else:
        save_fluxes(output_path, config, flux, out_phl,
                    experiment_name=driver_config.experiment_name,
                    double_precision=driver_config.do_write_double_precision,
                    hdf5=driver_config.do_write_hdf5)

    # shortwave spectral diagnostics (ecrad_driver.F90:213-219,410-419)
    if len(driver_config.sw_diag_wavelength_bound) >= 2 and config.do_sw:
        from ecrad_tpu.io.output import save_sw_diagnostics
        from ecrad_tpu.optics.spectral import get_sw_mapping
        mapping = get_sw_mapping(
            tables.specdef_sw, driver_config.sw_diag_wavelength_bound,
            use_bands=not config.do_cloud_aerosol_per_sw_g_point)
        save_sw_diagnostics(
            driver_config.sw_diag_file_name, config,
            driver_config.sw_diag_wavelength_bound, mapping, flux,
            experiment_name=driver_config.experiment_name,
            double_precision=driver_config.do_write_double_precision)

    # debug dumps (ecrad_driver.F90 do_save_inputs;
    # radiation_interface do_save_radiative_properties)
    if driver_config.do_save_inputs:
        from ecrad_tpu.io.save_extras import save_inputs
        save_inputs("inputs.nc", config, inp)
    if config.do_save_radiative_properties:
        from ecrad_tpu.interface import compute_radiative_properties
        from ecrad_tpu.io.save_extras import save_radiative_properties
        props = compute_radiative_properties(
            config, tables,
            cloud={k: v for k, v in (cloud or {}).items()
                   if k != "iseed"} if cloud else None,
            aerosol=aerosol, solar_irradiance=solar, **{
                k: kwargs[k] for k in (
                    "pressure_hl", "temperature_hl", "gas_mmr",
                    "cos_sza", "skin_temperature", "sw_albedo",
                    "sw_albedo_direct", "lw_emissivity")})
        save_radiative_properties("radiative_properties.nc", config,
                                  props)
    if profiling.enabled():
        profiling.print_profile()
    return flux


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="ecrad_tpu",
        description="JAX ecRad-equivalent offline radiation driver")
    ap.add_argument("config")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--dtype", default="float64",
                    choices=["float32", "float64"])
    ap.add_argument("--nrepeat", type=int, default=None)
    ap.add_argument("--generator", default="exact",
                    choices=["exact", "device"],
                    help="McICA cloud generator: bit-exact host port or "
                         "on-device counter-based")
    args = ap.parse_args(argv)
    run(args.config, args.input, args.output, dtype=args.dtype,
        nrepeat=args.nrepeat, generator=args.generator)


if __name__ == "__main__":
    main(sys.argv[1:])
