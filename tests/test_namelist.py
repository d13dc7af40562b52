import os

from ecrad_tpu.namelist import read_namelist_file
from ecrad_tpu.config import Config, Solver, GasModel, Overlap

TEST_IFS = "/root/reference/test/ifs"


def test_parse_cy49r1():
    groups = read_namelist_file(os.path.join(TEST_IFS, "configCY49R1.nam"))
    assert "radiation" in groups and "radiation_driver" in groups
    r = groups["radiation"]
    assert r["do_sw"] is True
    assert r["sw_solver_name"] == "McICA"
    assert r["cloud_fraction_threshold"] == 0.001e-3
    assert r["i_aerosol_type_map"][:3] == [-1, -2, -3]
    assert len(r["i_aerosol_type_map"]) == 12
    assert r["sw_albedo_wavelength_bound"][0] == 0.25e-6
    d = groups["radiation_driver"]
    assert d["nblocksize"] == 80
    assert d["cloud_separation_scale_toa"] == 14000.0


def test_config_from_namelist():
    cfg = Config.from_namelist(os.path.join(TEST_IFS, "configCY49R1.nam"))
    assert cfg.sw_solver == Solver.MCICA
    assert cfg.lw_solver == Solver.MCICA
    assert cfg.gas_model_sw == GasModel.RRTMG
    assert cfg.overlap_scheme == Overlap.EXPONENTIAL_RANDOM
    assert cfg.use_aerosols is True
    assert cfg.n_aerosol_types == 12
    assert cfg.do_lw_derivatives is True
    assert cfg.do_canopy_fluxes_sw is True
    assert not cfg.use_general_cloud_optics
    assert cfg.use_general_aerosol_optics
    assert cfg.i_sw_albedo_index == (1, 2, 3, 4, 5, 6)
    assert cfg.do_nearest_spectral_lw_emiss is True
    # hashable (usable as jit static arg)
    hash(cfg)


def test_config_ecckd_namelist():
    cfg = Config.from_namelist(os.path.join(TEST_IFS,
                                            "configCY49R1_ecckd.nam"))
    assert cfg.gas_model_sw == GasModel.ECCKD


def test_vendored_flagship_namelist_matches_builder():
    """The vendored flagship namelist gives the builder's Config and
    driver settings, so the CLI runs the benchmarked configuration."""
    import dataclasses

    import __graft_entry__ as ge
    from ecrad_tpu.data import DATA_DIR
    from ecrad_tpu.io.input import DriverConfig

    nam = os.path.join(DATA_DIR, "io", "configCY49R1_flagship.nam")
    assert Config.from_namelist(nam) == ge.flagship_config()
    driver = DriverConfig.from_namelist(nam)
    assert dataclasses.replace(driver, iverbose=0) == dataclasses.replace(
        ge._flagship_driver(), iverbose=0)
