"""IFS-style offline driver CLI (the reference's `bin/ecrad_ifs`).

Reference: driver/ecrad_ifs_driver.F90:45-530 — read the same namelist +
offline input NetCDF as the main driver, but exercise the IFS-facing
SETUP_RADIATION_SCHEME / RADIATION_SCHEME entry points (which derive
effective radii, cloud overlap and cloud geometry from IFS
parameterizations instead of taking them from the input file), then
write **net fluxes only** via save_net_fluxes.

Usage (mirrors the reference CLI):

    python -m ecrad_tpu.ifs.driver config.nam input.nc output.nc \
        [--dtype float32|float64] [--bitidentity]

--bitidentity pins effective radii, overlap parameter, fractional std
and the McICA od-scaling samples to the offline driver's values
(reference BITIDENTITY_TESTING, Makefile:66-69 +
driver/ecrad_ifs_driver.F90:445-452), so the offline and IFS paths
produce matching net fluxes — the cross-driver consistency contract of
test/ifs/Makefile:37-48.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def run_ifs(config_path: str, input_path: str, output_path: str = None,
            dtype: str = "float64", bitidentity: bool = False,
            nproma: int = None):
    """Run the IFS-path radiation scheme on an offline input file.

    nproma: NPROMA block size — routes through the ZRGP-style blocked
    path (ecrad_tpu.ifs.blocking; the reference's ecrad_ifs_blocked
    binary, driver/ecrad_ifs_driver_blocked.F90).

    Returns the radiation_scheme output dict (net fluxes +
    diagnostics, including "_flux")."""
    import jax
    if dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from ecrad_tpu import constants
    from ecrad_tpu.config import Config
    from ecrad_tpu.driver import build_cloud_inputs, resolve_data_dir
    from ecrad_tpu.ifs.scheme import (radiation_scheme,
                                      setup_radiation_scheme)
    from ecrad_tpu.io.input import DriverConfig, read_input
    from ecrad_tpu.io.netcdf import NcFile
    from ecrad_tpu.io.output import save_net_fluxes
    from ecrad_tpu.jax_setup import enable_persistent_cache

    enable_persistent_cache()
    config = Config.from_namelist(config_path)
    driver_config = DriverConfig.from_namelist(config_path)
    config = resolve_data_dir(config, config_path)

    scheme = setup_radiation_scheme(config)
    inp = read_input(input_path, driver_config)
    ncol, nlev = inp.gas_mmr.shape[:2]

    # latitude/longitude for overlap decorrelation & ice effective
    # radius (ecrad_ifs_driver.F90:259-276)
    with NcFile(input_path) as f:
        if f.exists("lat"):
            sin_lat = np.sin(np.deg2rad(np.asarray(f.get("lat"),
                                                   np.float64)))
        else:
            sin_lat = np.zeros(ncol)
        if f.exists("lon"):
            lon = np.deg2rad(np.asarray(f.get("lon"), np.float64))
        else:
            lon = np.zeros(ncol)

    dt = jnp.float64 if dtype == "float64" else jnp.float32

    def dev(x):
        return jnp.asarray(x, dt) if x is not None else None

    phl = inp.thermodynamics.pressure_hl
    thl = inp.thermodynamics.temperature_hl
    pressure_fl = 0.5 * (phl[:, :-1] + phl[:, 1:])
    temperature_fl = 0.5 * (thl[:, :-1] + thl[:, 1:])
    zeros = np.zeros((ncol, nlev))

    gi = constants.GAS_INDEX
    g = inp.gas_mmr

    kwargs = dict(
        solar_irradiance=float(inp.solar_irradiance),
        mu0=dev(inp.cos_sza),
        skin_temperature=dev(inp.skin_temperature),
        albedo_diffuse=dev(inp.sw_albedo),
        albedo_direct=dev(inp.sw_albedo_direct),
        spectral_emissivity=dev(inp.lw_emissivity),
        sin_lat=dev(sin_lat), lon=dev(lon),
        land_frac=dev(np.zeros(ncol)),
        pressure_fl=dev(pressure_fl), temperature_fl=dev(temperature_fl),
        pressure_hl=dev(phl), temperature_hl=dev(thl),
        q=dev(g[:, :, gi["h2o"]]), co2=dev(g[:, :, gi["co2"]]),
        ch4=dev(g[:, :, gi["ch4"]]), n2o=dev(g[:, :, gi["n2o"]]),
        no2=dev(g[:, :, gi["no2"]]), cfc11=dev(g[:, :, gi["cfc11"]]),
        cfc12=dev(g[:, :, gi["cfc12"]]),
        hcfc22=dev(g[:, :, gi["hcfc22"]]),
        ccl4=dev(g[:, :, gi["ccl4"]]), o3=dev(g[:, :, gi["o3"]]),
        cloud_frac=dev(inp.cloud_fraction),
        q_liquid=dev(inp.cloud_mixing_ratio[:, :, 0]),
        q_ice=dev(inp.cloud_mixing_ratio[:, :, 1]),
        q_rain=dev(zeros), q_snow=dev(zeros),
        iseed=jnp.asarray(inp.iseed),
    )
    if scheme.config.use_aerosols and inp.aerosol_mmr is not None:
        kwargs["aerosol_mmr"] = dev(inp.aerosol_mmr)

    if bitidentity:
        # pin the IFS-derived fields to the offline driver's inputs
        kwargs.update(
            re_liq=dev(inp.cloud_effective_radius[:, :, 0]),
            re_ice=dev(inp.cloud_effective_radius[:, :, 1]),
            cloud_overlap=dev(inp.overlap_param),
            fractional_std=dev(inp.fractional_std))
        if scheme.config.do_clouds:
            cloud = build_cloud_inputs(scheme.config, inp, "exact")
            cloud.pop("_device_generator", None)
            kwargs["cloud_extra"] = {
                k: v for k, v in cloud.items()
                if k.startswith(("od_scaling", "total_cloud_cover"))}

    t0 = time.time()
    import jax
    if nproma is not None and nproma < ncol:
        # ZRGP-style blocked execution (ifs/blocking.py; reference
        # driver/ifs_blocking.F90 + ecrad_ifs_driver_blocked.F90)
        from ecrad_tpu.ifs import blocking

        flat = {k: v for k, v in kwargs.items() if k != "cloud_extra"}
        for k, v in (kwargs.get("cloud_extra") or {}).items():
            flat[f"cloud_extra/{k}"] = v
        host = {k: (np.asarray(v) if hasattr(v, "ndim") else v)
                for k, v in flat.items()}
        zrgp, table, scalars = blocking.copy_inputs_to_blocked(
            host, ncol, nproma)
        blocks = []
        for jb in range(zrgp.shape[0]):
            bk = blocking.block_kwargs(zrgp[jb], table, scalars)
            ce = {k.split("/", 1)[1]: jnp.asarray(v, dt)
                  for k, v in bk.items() if k.startswith("cloud_extra/")}
            bk = {k: (jnp.asarray(v, dt) if hasattr(v, "ndim")
                      and np.asarray(v).dtype.kind == "f" else v)
                  for k, v in bk.items()
                  if not k.startswith("cloud_extra/")}
            if "iseed" in bk:
                bk["iseed"] = jnp.asarray(np.asarray(bk["iseed"]),
                                          jnp.int64 if dtype == "float64"
                                          else jnp.int32)
            if ce:
                bk["cloud_extra"] = ce
            blocks.append(radiation_scheme(scheme, **bk))
        jax.block_until_ready(blocks[-1]["_flux"])
        out = blocking.copy_fluxes_from_blocked(blocks, ncol)
        out["_flux"] = jax.tree_util.tree_map(
            lambda *xs: (None if xs[0] is None
                         else np.concatenate([np.asarray(x) for x in xs],
                                             axis=0)[:ncol]),
            *[b["_flux"] for b in blocks],
            is_leaf=lambda x: x is None or hasattr(x, "ndim"))
    else:
        out = radiation_scheme(scheme, **kwargs)
        jax.block_until_ready(out["_flux"])
    print(f"ecrad_tpu ifs: {ncol} columns x {nlev} levels in "
          f"{time.time() - t0:.3f}s"
          + (f" (nproma={nproma})" if nproma else ""))

    if output_path:
        save_net_fluxes(
            output_path, scheme.config, out["_flux"], phl,
            experiment_name=driver_config.experiment_name,
            double_precision=driver_config.do_write_double_precision)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="ecrad_ifs",
        description="IFS-path offline driver (reference bin/ecrad_ifs)")
    ap.add_argument("config")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--dtype", default="float64",
                    choices=["float32", "float64"])
    ap.add_argument("--bitidentity", action="store_true",
                    help="pin effective radii/overlap/McICA samples to "
                         "the offline driver's values")
    ap.add_argument("--nproma", type=int, default=None,
                    help="NPROMA block size: run the ZRGP-style blocked "
                         "path (reference bin/ecrad_ifs_blocked)")
    args = ap.parse_args(argv)
    run_ifs(args.config, args.input, args.output, dtype=args.dtype,
            bitidentity=args.bitidentity, nproma=args.nproma)


if __name__ == "__main__":
    sys.exit(main())
