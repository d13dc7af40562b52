"""Round-4 breadth items: 2-region Tripleclouds (n_regions=2),
setup-optics diagnostic dumps, and the deprecated encroachment
namelist aliases."""

import os

import numpy as np
import pytest

from tests import golden


def test_n_regions_2_matches_homogeneous_limit():
    """radiation_regions.F90:105-111: with n_regions=2 the single
    cloudy region is HOMOGENEOUS (od_scaling 1).  The 3-region scheme
    with fractional_std=0 has both cloudy regions at scaling 1, which
    is the same physics — fluxes must agree closely (not bitwise: the
    overlap matrices treat one 2-region cloud and two half-clouds with
    identical scaling slightly differently only through the inner
    overlap of identical regions, which is flux-neutral)."""
    import dataclasses
    import functools

    import jax
    import jax.numpy as jnp

    from ecrad_tpu.config import Config
    from ecrad_tpu.interface import radiation, setup_radiation
    from ecrad_tpu.io.input import DriverConfig, read_input
    from ecrad_tpu.namelist import read_namelist_file

    nml = dict(read_namelist_file(golden.CONFIG_NAM)["radiation"])
    nml["sw_solver_name"] = "Tripleclouds"
    nml["lw_solver_name"] = "Tripleclouds"
    nml["do_sw_delta_scaling_with_gases"] = False
    base = Config.from_dict(nml)

    dc = DriverConfig.from_namelist(golden.CONFIG_NAM)
    inp = read_input(golden.INPUT_FILE, dc)
    # zero inhomogeneity so the 3-region solver collapses physically
    inp_h = dataclasses.replace(
        inp, fractional_std=np.zeros_like(inp.fractional_std))

    def run(config):
        config, tables = setup_radiation(config)
        cloud = golden.make_cloud_inputs(config, inp_h)
        fn = jax.jit(functools.partial(radiation, config, tables))
        return jax.block_until_ready(fn(
            cloud=cloud,
            pressure_hl=jnp.asarray(inp_h.thermodynamics.pressure_hl),
            temperature_hl=jnp.asarray(
                inp_h.thermodynamics.temperature_hl),
            gas_mmr=jnp.asarray(inp_h.gas_mmr),
            cos_sza=jnp.asarray(inp_h.cos_sza),
            skin_temperature=jnp.asarray(inp_h.skin_temperature),
            sw_albedo=jnp.asarray(inp_h.sw_albedo),
            sw_albedo_direct=jnp.asarray(inp_h.sw_albedo_direct),
            lw_emissivity=jnp.asarray(inp_h.lw_emissivity),
            solar_irradiance=float(inp_h.solar_irradiance),
            aerosol={"mixing_ratio": jnp.asarray(inp_h.aerosol_mmr)}))

    f2 = run(base.replace(nregions=2))
    f3 = run(base)

    for name in ("sw_up", "sw_dn", "lw_up", "lw_dn"):
        a = np.asarray(getattr(f2, name))
        b = np.asarray(getattr(f3, name))
        err = np.abs(a - b).max()
        assert err < 0.15, f"{name}: 2-region vs FSD=0 drift {err}"
        assert np.isfinite(a).all()


def test_n_regions_invalid_raises():
    from ecrad_tpu.solvers.tripleclouds import calc_region_properties
    import jax.numpy as jnp
    cf = jnp.full((2, 3), 0.5)
    with pytest.raises(NotImplementedError):
        calc_region_properties(cf, cf, True, n_regions=4)


def test_save_aerosol_optics_roundtrip(tmp_path):
    """do_save_aerosol_optics writer
    (radiation_aerosol_optics_data.F90:406-503): field names and values
    round-trip."""
    from ecrad_tpu.config import Config
    from ecrad_tpu.interface import setup_radiation
    from ecrad_tpu.io.netcdf import NcFile
    from ecrad_tpu.io.save_optics import save_aerosol_optics

    config = Config.from_namelist(golden.CONFIG_NAM)
    config, tables = setup_radiation(config)
    path = str(tmp_path / "aerosol_optics.nc")
    save_aerosol_optics(path, tables.aerosol)
    with NcFile(path) as f:
        me = f.get("mass_ext_sw_hydrophobic")     # (ntype, nband)
        np.testing.assert_allclose(
            me.T, np.asarray(tables.aerosol["mass_ext_sw_phobic"],
                             np.float64), rtol=1e-6)
        if tables.aerosol.get("use_hydrophilic"):
            mp = f.get("mass_ext_lw_hydrophilic")
            np.testing.assert_allclose(
                np.transpose(mp, (2, 0, 1)),
                np.asarray(tables.aerosol["mass_ext_lw_philic"],
                           np.float64), rtol=1e-6)


def test_save_cloud_optics_files(tmp_path):
    """do_save_cloud_optics writer
    (radiation_general_cloud_optics.F90:294-328): one file per
    (type, spectrum) with the spectrally-averaged optics."""
    from ecrad_tpu.config import Config
    from ecrad_tpu.interface import setup_radiation
    from ecrad_tpu.io.netcdf import NcFile
    from ecrad_tpu.io.save_optics import save_general_cloud_optics
    from ecrad_tpu.namelist import read_namelist_file

    nml = dict(read_namelist_file(golden.CONFIG_NAM)["radiation"])
    nml["use_general_cloud_optics"] = True
    config = Config.from_dict(nml)
    config, tables = setup_radiation(config)
    prefix = str(tmp_path / "hydrometeor_optics")
    save_general_cloud_optics(prefix, tables.cloud)
    names = tables.cloud["type_names"]
    for spec in ("sw", "lw"):
        for i, name in enumerate(names):
            path = f"{prefix}_{spec}_{name}.nc"
            assert os.path.exists(path), path
            with NcFile(path) as f:
                me = f.get("mass_extinction_coefficient")
                lut = tables.cloud[spec][i]
                np.testing.assert_allclose(
                    me.T, np.asarray(lut["mass_ext"], np.float64),
                    rtol=1e-6)
                re = f.get("effective_radius")
                assert re.shape[0] == lut["n_effective_radius"]


def test_encroachment_namelist_aliases():
    """Deprecated pre-2019 keys parse as their entrapment equivalents
    (radiation_config.F90:87-94,973-976,1047-1051)."""
    from ecrad_tpu.config import Config, Entrapment

    c = Config.from_dict({"sw_encroachment_name": "Computed",
                          "encroachment_scaling": 0.4})
    assert c.sw_entrapment == Entrapment.EXPLICIT_NON_FRACTAL
    assert c.overhang_factor == pytest.approx(0.4)
    # explicit entrapment key wins over the deprecated alias
    c = Config.from_dict({"sw_encroachment_name": "Maximum",
                          "sw_entrapment_name": "Zero"})
    assert c.sw_entrapment == Entrapment.ZERO


def test_kernel_layout_gating_accepts_tripleclouds(monkeypatch):
    """use_kernel_layout follows the backend choice: with the fused
    Triton sweeps it admits McICA and rejects Tripleclouds (2 or 3
    regions), whose solver reads only the classic layout; with the scan
    sweeps (the CPU choice) nothing uses the kernel layout."""
    from ecrad_tpu import backend
    from ecrad_tpu.config import Config, Solver
    from ecrad_tpu.interface import setup_radiation, use_kernel_layout

    config, tables = setup_radiation(Config(
        sw_solver=Solver.MCICA, lw_solver=Solver.MCICA,
        do_lw_aerosol_scattering=False))
    tc_config, tc_tables = setup_radiation(Config(
        sw_solver=Solver.TRIPLECLOUDS, lw_solver=Solver.TRIPLECLOUDS,
        do_lw_aerosol_scattering=False))
    cloud = {"fraction": np.zeros((4, 7))}
    monkeypatch.delenv("ECRAD_TPU_ADDING", raising=False)
    monkeypatch.setitem(backend._TABLE, "cpu", backend._TABLE["gpu"])
    assert use_kernel_layout(config, tables, cloud)
    assert not use_kernel_layout(tc_config, tc_tables, cloud)
    assert not use_kernel_layout(
        dataclasses_replace(tc_config, nregions=2), tc_tables, cloud)
    # the scan sweeps never use the kernel layout
    monkeypatch.setenv("ECRAD_TPU_ADDING", "scan")
    assert not use_kernel_layout(config, tables, cloud)


def dataclasses_replace(cfg, **kw):
    import dataclasses
    return dataclasses.replace(cfg, **kw)
