"""Configuration system.

Mirrors the reference's two-phase config design
(radiation/radiation_config.F90:163-655): a user-settable parameter set
(read from a Fortran namelist or constructed programmatically) followed by a
``consolidate`` step at setup time that derives file names, spectral sizes and
mapping tables.

Static/traced split:
  * :class:`Config` is a **frozen, hashable dataclass** of user parameters
    plus small derived integers — it is passed to ``jax.jit`` as a static
    argument, so each distinct configuration compiles once.
  * All derived *array* state (k-distribution tables, cloud/aerosol LUTs,
    spectral mappings) lives in pytrees built at setup time
    (see ecrad_tpu.interface.setup_radiation) and is passed as traced
    arguments, resident in device memory and replicated across the
    device mesh.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

from ecrad_tpu.namelist import read_namelist_file


class Solver(enum.IntEnum):
    # radiation_config.F90:59-62
    CLOUDLESS = 0
    HOMOGENEOUS = 1
    MCICA = 2
    SPARTACUS = 3
    TRIPLECLOUDS = 4


class GasModel(enum.IntEnum):
    # radiation_config.F90:100-106
    MONOCHROMATIC = 0
    RRTMG = 1
    ECCKD = 2


class LiquidModel(enum.IntEnum):
    # radiation_config.F90:108-119
    MONOCHROMATIC = 0
    SOCRATES = 1
    SLINGO = 2
    JAHANGIR = 3
    NIELSEN = 4


class IceModel(enum.IntEnum):
    # radiation_config.F90:121-137
    MONOCHROMATIC = 0
    FU = 1
    BARAN = 2
    BARAN2016 = 3
    BARAN2017 = 4
    YI = 5


class PdfShape(enum.IntEnum):
    # radiation_config.F90:139-143
    LOGNORMAL = 0
    GAMMA = 1


class Overlap(enum.IntEnum):
    # radiation_cloud_cover.F90 (exported via radiation_config.F90:46-47)
    MAXIMUM_RANDOM = 0
    EXPONENTIAL_RANDOM = 1
    EXPONENTIAL = 2          # "Exp-Exp"


class Entrapment(enum.IntEnum):
    # radiation_config.F90:71-90
    ZERO = 0
    EDGE_ONLY = 1
    EXPLICIT = 2
    EXPLICIT_NON_FRACTAL = 3
    MAXIMUM = 4


# Mapping of namelist name strings to enum values
# (radiation_config.F90 SolverName/GasModelName/... + get_enum_code L2103)
SOLVER_NAMES = {
    "cloudless": Solver.CLOUDLESS,
    "homogeneous": Solver.HOMOGENEOUS,
    "mcica": Solver.MCICA,
    "spartacus": Solver.SPARTACUS,
    "tripleclouds": Solver.TRIPLECLOUDS,
}
GAS_MODEL_NAMES = {
    "monochromatic": GasModel.MONOCHROMATIC,
    "rrtmg-ifs": GasModel.RRTMG,
    "ecckd": GasModel.ECCKD,
}
LIQUID_MODEL_NAMES = {
    "monochromatic": LiquidModel.MONOCHROMATIC,
    "socrates": LiquidModel.SOCRATES,
    "slingo": LiquidModel.SLINGO,
    "jahangir": LiquidModel.JAHANGIR,
    "nielsen": LiquidModel.NIELSEN,
}
ICE_MODEL_NAMES = {
    "monochromatic": IceModel.MONOCHROMATIC,
    "fu-ifs": IceModel.FU,
    "baran-experimental": IceModel.BARAN,
    "baran": IceModel.BARAN,
    "baran2016": IceModel.BARAN2016,
    "baran2017-experimental": IceModel.BARAN2017,
    "baran2017": IceModel.BARAN2017,
    "yi": IceModel.YI,
}
PDF_SHAPE_NAMES = {
    "lognormal": PdfShape.LOGNORMAL,
    "gamma": PdfShape.GAMMA,
}
OVERLAP_NAMES = {
    "max-ran": Overlap.MAXIMUM_RANDOM,
    "exp-ran": Overlap.EXPONENTIAL_RANDOM,
    "exp-exp": Overlap.EXPONENTIAL,
}
ENTRAPMENT_NAMES = {
    "zero": Entrapment.ZERO,
    "edge-only": Entrapment.EDGE_ONLY,
    "explicit": Entrapment.EXPLICIT,
    "non-fractal": Entrapment.EXPLICIT_NON_FRACTAL,
    "maximum": Entrapment.MAXIMUM,
}


def _match_enum(table, name, what):
    key = str(name).strip().lower()
    if key in table:
        return table[key]
    raise ValueError(f"Unknown {what} name: {name!r}")


@dataclasses.dataclass(frozen=True)
class Config:
    """User configuration + consolidated scalar metadata.

    Field names follow the reference namelist keys
    (radiation_config.F90:730-764) for drop-in namelist compatibility.
    """

    # --- actions
    do_sw: bool = True
    do_lw: bool = True
    do_sw_direct: bool = True
    do_clear: bool = True

    # --- gas model
    gas_model_sw: GasModel = GasModel.RRTMG
    gas_model_lw: GasModel = GasModel.RRTMG

    # --- solvers
    sw_solver: Solver = Solver.MCICA
    lw_solver: Solver = Solver.MCICA

    # --- particle optics models (RRTMG-band path)
    liquid_model: LiquidModel = LiquidModel.SOCRATES
    ice_model: IceModel = IceModel.BARAN
    use_general_cloud_optics: bool = True
    use_general_aerosol_optics: bool = True
    cloud_type_name: Tuple[str, ...] = ()
    use_thick_cloud_spectral_averaging: Tuple[bool, ...] = ()
    do_fu_lw_ice_optics_bug: bool = False

    # --- clouds
    cloud_fraction_threshold: float = 1.0e-6
    cloud_mixing_ratio_threshold: float = 1.0e-9
    overlap_scheme: Overlap = Overlap.EXPONENTIAL_RANDOM
    use_beta_overlap: bool = False
    use_vectorizable_generator: bool = False
    cloud_pdf_shape: PdfShape = PdfShape.GAMMA
    cloud_inhom_decorr_scaling: float = 0.5
    nregions: int = 3
    do_sw_delta_scaling_with_gases: bool = False

    # --- longwave scattering
    do_lw_cloud_scattering: bool = True
    do_lw_aerosol_scattering: bool = True

    # --- monochromatic model parameters
    mono_lw_wavelength: float = -1.0
    mono_lw_total_od: float = 0.0
    mono_sw_total_od: float = 0.0
    mono_sw_single_scattering_albedo: float = 0.999999
    mono_sw_asymmetry_factor: float = 0.86
    mono_lw_single_scattering_albedo: float = 0.538
    mono_lw_asymmetry_factor: float = 0.925

    # --- gas optical depth guards (radiation_config.F90:246-258)
    min_gas_od_lw: float = 1.0e-15
    min_gas_od_sw: float = 0.0
    max_gas_od_3d: float = 8.0
    max_cloud_od: float = 16.0

    # --- SPARTACUS / 3D
    do_3d_effects: bool = True
    do_3d_lw_multilayer_effects: bool = False
    do_lw_side_emissivity: bool = True
    sw_entrapment: Entrapment = Entrapment.EXPLICIT
    clear_to_thick_fraction: float = 0.0
    overhead_sun_factor: float = 0.0
    max_3d_transfer_rate: float = 10.0
    min_cloud_effective_size: float = 100.0
    overhang_factor: float = 0.0
    use_expm_everywhere: bool = False

    # --- aerosols
    use_aerosols: bool = False
    n_aerosol_types: int = 0
    i_aerosol_type_map: Tuple[int, ...] = ()
    # Name-based aerosol selection (resolved against the optics file's
    # metadata registry at setup, optics/aerosol_description.py;
    # reference: radiation_aerosol_optics_description.F90).  Entries
    # like "DD,bin=2,phobic"; non-empty overrides i_aerosol_type_map.
    aerosol_type_name: Tuple[str, ...] = ()
    # "CODE:model" preferences, e.g. "DD:Fouquart"
    aerosol_preferred_optical_model: Tuple[str, ...] = ()

    # --- surface mapping
    do_nearest_spectral_sw_albedo: bool = False
    do_nearest_spectral_lw_emiss: bool = False
    sw_albedo_wavelength_bound: Tuple[float, ...] = ()
    lw_emiss_wavelength_bound: Tuple[float, ...] = ()
    i_sw_albedo_index: Tuple[int, ...] = ()
    i_lw_emiss_index: Tuple[int, ...] = ()
    do_weighted_surface_mapping: bool = True

    # --- canopy
    do_canopy_fluxes_sw: bool = False
    do_canopy_fluxes_lw: bool = False
    use_canopy_full_spectrum_sw: bool = False
    use_canopy_full_spectrum_lw: bool = False
    do_canopy_gases_sw: bool = False
    do_canopy_gases_lw: bool = False

    # --- per-g-point cloud/aerosol/surface optics (ecCKD-era feature,
    # radiation_config.F90:504-507)
    do_cloud_aerosol_per_sw_g_point: bool = True
    do_cloud_aerosol_per_lw_g_point: bool = True

    # --- solar
    use_spectral_solar_scaling: bool = False
    use_spectral_solar_cycle: bool = False
    use_updated_solar_spectrum: bool = False

    # --- outputs
    do_save_radiative_properties: bool = False
    do_save_spectral_flux: bool = False
    do_save_gpoint_flux: bool = False
    do_surface_sw_spectral_flux: bool = True
    do_toa_spectral_flux: bool = False
    do_lw_derivatives: bool = False

    # --- verbosity
    iverbose: int = 1
    iverbosesetup: int = 2

    # --- files
    directory_name: str = "."
    ice_optics_override_file_name: str = ""
    liq_optics_override_file_name: str = ""
    aerosol_optics_override_file_name: str = ""
    gas_optics_sw_override_file_name: str = ""
    gas_optics_lw_override_file_name: str = ""
    ssi_override_file_name: str = ""
    cloud_pdf_override_file_name: str = ""

    # --- COMPUTED at consolidate() (scalars only; arrays live in Tables)
    is_consolidated: bool = False
    n_g_sw: int = 0
    n_g_lw: int = 0
    n_bands_sw: int = 0
    n_bands_lw: int = 0
    n_canopy_bands_sw: int = 1
    n_canopy_bands_lw: int = 1
    n_albedo_intervals: int = 0
    n_emiss_intervals: int = 0
    n_cloud_types: int = 2
    is_homogeneous: bool = False
    do_clouds: bool = True

    # numerical precision of the jitted compute path ("float32"/"float64")
    dtype_name: str = "float32"

    # ----- convenience ---------------------------------------------------

    @property
    def i_solver_sw(self) -> Solver:
        return self.sw_solver

    @property
    def i_solver_lw(self) -> Solver:
        return self.lw_solver

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def do_lw_scattering(self) -> bool:
        """Any longwave scattering at all? (controls LW solver path)"""
        return self.do_lw_cloud_scattering or self.do_lw_aerosol_scattering

    # ----- constructors --------------------------------------------------

    @classmethod
    def from_namelist(cls, path: str) -> "Config":
        """Build a Config from a Fortran namelist file (&radiation group).

        Reference reader: radiation_config.F90:664-1100.
        """
        groups = read_namelist_file(path)
        nml = groups.get("radiation", {})
        return cls.from_dict(nml)

    @classmethod
    def from_dict(cls, nml: dict) -> "Config":
        kw = {}

        def get(key, default=None):
            return nml.get(key, default)

        direct_bool_keys = [
            "do_sw", "do_lw", "do_sw_direct", "do_clear", "do_3d_effects",
            "do_3d_lw_multilayer_effects", "do_lw_side_emissivity",
            "do_lw_cloud_scattering", "do_lw_aerosol_scattering",
            "do_sw_delta_scaling_with_gases", "do_fu_lw_ice_optics_bug",
            "do_canopy_fluxes_sw", "do_canopy_fluxes_lw",
            "use_canopy_full_spectrum_sw", "use_canopy_full_spectrum_lw",
            "do_canopy_gases_sw", "do_canopy_gases_lw",
            "use_general_cloud_optics", "use_general_aerosol_optics",
            "use_beta_overlap", "use_vectorizable_generator",
            "use_expm_everywhere", "use_aerosols",
            "do_save_radiative_properties", "do_save_spectral_flux",
            "do_save_gpoint_flux", "do_surface_sw_spectral_flux",
            "do_toa_spectral_flux", "do_lw_derivatives",
            "do_nearest_spectral_sw_albedo", "do_nearest_spectral_lw_emiss",
            "do_weighted_surface_mapping", "use_spectral_solar_scaling",
            "use_spectral_solar_cycle", "use_updated_solar_spectrum",
            "do_cloud_aerosol_per_sw_g_point", "do_cloud_aerosol_per_lw_g_point",
        ]
        direct_float_keys = [
            "cloud_fraction_threshold", "cloud_mixing_ratio_threshold",
            "cloud_inhom_decorr_scaling", "clear_to_thick_fraction",
            "overhead_sun_factor", "max_gas_od_3d", "max_cloud_od",
            "max_3d_transfer_rate", "min_cloud_effective_size",
            "overhang_factor", "mono_lw_wavelength", "mono_lw_total_od",
            "mono_sw_total_od", "mono_sw_single_scattering_albedo",
            "mono_sw_asymmetry_factor", "mono_lw_single_scattering_albedo",
            "mono_lw_asymmetry_factor",
        ]
        direct_int_keys = ["iverbose", "iverbosesetup", "n_aerosol_types"]
        direct_str_keys = [
            "directory_name", "ice_optics_override_file_name",
            "liq_optics_override_file_name",
            "aerosol_optics_override_file_name",
            "gas_optics_sw_override_file_name",
            "gas_optics_lw_override_file_name",
            "ssi_override_file_name", "cloud_pdf_override_file_name",
        ]
        field_names = {f.name for f in dataclasses.fields(cls)}
        for k in direct_bool_keys + direct_float_keys + direct_int_keys \
                + direct_str_keys:
            if k in nml and k in field_names:
                kw[k] = nml[k]

        if "n_regions" in nml:
            kw["nregions"] = int(nml["n_regions"])

        # enums from name strings
        if "sw_solver_name" in nml:
            kw["sw_solver"] = _match_enum(SOLVER_NAMES, nml["sw_solver_name"],
                                          "solver")
        if "lw_solver_name" in nml:
            kw["lw_solver"] = _match_enum(SOLVER_NAMES, nml["lw_solver_name"],
                                          "solver")
        if "gas_model_name" in nml:
            gm = _match_enum(GAS_MODEL_NAMES, nml["gas_model_name"],
                             "gas model")
            kw["gas_model_sw"] = gm
            kw["gas_model_lw"] = gm
        if "sw_gas_model_name" in nml:
            kw["gas_model_sw"] = _match_enum(
                GAS_MODEL_NAMES, nml["sw_gas_model_name"], "gas model")
        if "lw_gas_model_name" in nml:
            kw["gas_model_lw"] = _match_enum(
                GAS_MODEL_NAMES, nml["lw_gas_model_name"], "gas model")
        if "liquid_model_name" in nml:
            kw["liquid_model"] = _match_enum(
                LIQUID_MODEL_NAMES, nml["liquid_model_name"], "liquid model")
        if "ice_model_name" in nml:
            kw["ice_model"] = _match_enum(ICE_MODEL_NAMES,
                                          nml["ice_model_name"], "ice model")
        if "overlap_scheme_name" in nml:
            kw["overlap_scheme"] = _match_enum(
                OVERLAP_NAMES, nml["overlap_scheme_name"], "overlap scheme")
        if "cloud_pdf_shape_name" in nml:
            kw["cloud_pdf_shape"] = _match_enum(
                PDF_SHAPE_NAMES, nml["cloud_pdf_shape_name"], "PDF shape")
        if "sw_entrapment_name" in nml:
            kw["sw_entrapment"] = _match_enum(
                ENTRAPMENT_NAMES, nml["sw_entrapment_name"], "entrapment")
        # deprecated pre-2019 "encroachment" aliases
        # (radiation_config.F90:87-94,973-976,1047-1051): value names
        # map 1:1 onto the entrapment enum in order
        if "sw_encroachment_name" in nml and "sw_entrapment_name" \
                not in nml:
            kw["sw_entrapment"] = _match_enum(
                {"zero": Entrapment.ZERO,
                 "minimum": Entrapment.EDGE_ONLY,
                 "fractal": Entrapment.EXPLICIT,
                 "computed": Entrapment.EXPLICIT_NON_FRACTAL,
                 "maximum": Entrapment.MAXIMUM},
                nml["sw_encroachment_name"], "encroachment")
        if "encroachment_scaling" in nml \
                and float(nml["encroachment_scaling"]) >= 0.0:
            kw["overhang_factor"] = float(nml["encroachment_scaling"])

        def as_tuple(x, cast):
            if x is None:
                return ()
            if not isinstance(x, list):
                x = [x]
            return tuple(cast(v) for v in x if v is not None)

        if "i_aerosol_type_map" in nml:
            kw["i_aerosol_type_map"] = as_tuple(nml["i_aerosol_type_map"], int)
        if "aerosol_type_name" in nml:
            kw["aerosol_type_name"] = as_tuple(nml["aerosol_type_name"],
                                               str)
        if "aerosol_preferred_optical_model" in nml:
            kw["aerosol_preferred_optical_model"] = as_tuple(
                nml["aerosol_preferred_optical_model"], str)
        if "cloud_type_name" in nml:
            kw["cloud_type_name"] = as_tuple(nml["cloud_type_name"], str)
        if "use_thick_cloud_spectral_averaging" in nml:
            kw["use_thick_cloud_spectral_averaging"] = as_tuple(
                nml["use_thick_cloud_spectral_averaging"], bool)
        if "sw_albedo_wavelength_bound" in nml:
            kw["sw_albedo_wavelength_bound"] = as_tuple(
                nml["sw_albedo_wavelength_bound"], float)
        if "lw_emiss_wavelength_bound" in nml:
            kw["lw_emiss_wavelength_bound"] = as_tuple(
                nml["lw_emiss_wavelength_bound"], float)
        if "i_sw_albedo_index" in nml:
            kw["i_sw_albedo_index"] = as_tuple(nml["i_sw_albedo_index"], int)
        if "i_lw_emiss_index" in nml:
            kw["i_lw_emiss_index"] = as_tuple(nml["i_lw_emiss_index"], int)

        return cls(**kw)


# ---------------------------------------------------------------------------
# Resolved-configuration dump (radiation_config.F90:1411-1612 print_config):
# the reference's main observability tool — every resolved setting with the
# namelist key that controls it, in the same layout as
# test/ifs/ecrad_meridian_default_out_REFERENCE.log.

_SOLVER_DISPLAY = {Solver.CLOUDLESS: "Cloudless", Solver.HOMOGENEOUS:
                   "Homogeneous", Solver.MCICA: "McICA",
                   Solver.SPARTACUS: "SPARTACUS",
                   Solver.TRIPLECLOUDS: "Tripleclouds"}
_GAS_DISPLAY = {GasModel.MONOCHROMATIC: "Monochromatic",
                GasModel.RRTMG: "RRTMG-IFS", GasModel.ECCKD: "ECCKD"}
_LIQ_DISPLAY = {LiquidModel.MONOCHROMATIC: "Monochromatic",
                LiquidModel.SOCRATES: "SOCRATES",
                LiquidModel.SLINGO: "Slingo",
                LiquidModel.JAHANGIR: "Jahangir",
                LiquidModel.NIELSEN: "Nielsen"}
_ICE_DISPLAY = {IceModel.MONOCHROMATIC: "Monochromatic",
                IceModel.FU: "Fu-IFS", IceModel.BARAN: "Baran",
                IceModel.BARAN2016: "Baran2016",
                IceModel.BARAN2017: "Baran2017", IceModel.YI: "Yi"}
_OVERLAP_DISPLAY = {Overlap.MAXIMUM_RANDOM: "Max-Ran",
                    Overlap.EXPONENTIAL_RANDOM: "Exp-Ran",
                    Overlap.EXPONENTIAL: "Exp-Exp"}
_PDF_DISPLAY = {PdfShape.LOGNORMAL: "Lognormal", PdfShape.GAMMA: "Gamma"}
_ENTRAPMENT_DISPLAY = {Entrapment.ZERO: "Zero",
                       Entrapment.EDGE_ONLY: "Edge-only",
                       Entrapment.EXPLICIT: "Explicit",
                       Entrapment.EXPLICIT_NON_FRACTAL: "Non-fractal",
                       Entrapment.MAXIMUM: "Maximum"}


def describe_config(config: "Config") -> str:
    """Reference-style resolved-config dump.  Each line shows the human
    description, the resolved value and the namelist key, mirroring
    print_config (radiation_config.F90:1411-1612)."""
    lines = []

    def tf(v):
        return "T" if v else "F"

    def onoff(desc, key, v):
        lines.append(f"  {desc + (' ON' if v else ' OFF'):58s} "
                     f"({key}={tf(v)})")

    def enum_line(desc, key, display, v):
        lines.append(f"  {desc + ' \"' + display[v] + '\"':58s} "
                     f"({key}={int(v)})")

    def num(desc, key, v):
        lines.append(f"  {desc + ' = ' + repr(v):58s} ({key})")

    lines.append("General settings:")
    lines.append(f'  Data files expected in "{config.directory_name}"')
    onoff("Clear-sky calculations are", "do_clear", config.do_clear)
    onoff("Saving intermediate radiative properties",
          "do_save_radiative_properties",
          config.do_save_radiative_properties)
    onoff("Saving spectral flux profiles", "do_save_spectral_flux",
          config.do_save_spectral_flux)
    enum_line("Shortwave gas model is", "i_gas_model_sw", _GAS_DISPLAY,
              config.gas_model_sw)
    enum_line("Longwave gas model is", "i_gas_model_lw", _GAS_DISPLAY,
              config.gas_model_lw)
    onoff("Aerosols are", "use_aerosols", config.use_aerosols)
    if config.use_aerosols:
        onoff("General aerosol optics", "use_general_aerosol_optics",
              config.use_general_aerosol_optics)
    lines.append("  Clouds are " + ("ON" if config.do_clouds else "OFF"))
    onoff("Do cloud/aerosol/surface SW properties per g-point",
          "do_cloud_aerosol_per_sw_g_point",
          config.do_cloud_aerosol_per_sw_g_point)
    onoff("Do cloud/aerosol/surface LW properties per g-point",
          "do_cloud_aerosol_per_lw_g_point",
          config.do_cloud_aerosol_per_lw_g_point)
    onoff("Represent solar cycle in spectral irradiance",
          "use_spectral_solar_cycle", config.use_spectral_solar_cycle)
    onoff("Scale spectral solar irradiance",
          "use_spectral_solar_scaling", config.use_spectral_solar_scaling)

    lines.append("Surface and top-of-atmosphere settings:")
    onoff("Saving top-of-atmosphere spectral fluxes",
          "do_toa_spectral_flux", config.do_toa_spectral_flux)
    onoff("Saving surface shortwave spectral fluxes",
          "do_surface_sw_spectral_flux",
          config.do_surface_sw_spectral_flux)
    onoff("Saving surface shortwave fluxes in albedo bands",
          "do_canopy_fluxes_sw", config.do_canopy_fluxes_sw)
    onoff("Saving surface longwave fluxes in emissivity bands",
          "do_canopy_fluxes_lw", config.do_canopy_fluxes_lw)
    onoff("Longwave derivative calculation is", "do_lw_derivatives",
          config.do_lw_derivatives)
    onoff("Nearest-neighbour spectral albedo mapping",
          "do_nearest_spectral_sw_albedo",
          config.do_nearest_spectral_sw_albedo)
    onoff("Nearest-neighbour spectral emissivity mapping",
          "do_nearest_spectral_lw_emiss",
          config.do_nearest_spectral_lw_emiss)
    onoff("Planck-weighted surface albedo/emiss mapping",
          "do_weighted_surface_mapping",
          config.do_weighted_surface_mapping)

    if config.do_clouds:
        lines.append("Cloud settings:")
        num("Cloud fraction threshold", "cloud_fraction_threshold",
            config.cloud_fraction_threshold)
        num("Cloud mixing-ratio threshold",
            "cloud_mixing_ratio_threshold",
            config.cloud_mixing_ratio_threshold)
        onoff("General cloud optics", "use_general_cloud_optics",
              config.use_general_cloud_optics)
        if not config.use_general_cloud_optics:
            enum_line("Liquid optics scheme is", "i_liq_model",
                      _LIQ_DISPLAY, config.liquid_model)
            enum_line("Ice optics scheme is", "i_ice_model",
                      _ICE_DISPLAY, config.ice_model)
            onoff("Longwave ice optics bug in Fu scheme is",
                  "do_fu_lw_ice_optics_bug",
                  config.do_fu_lw_ice_optics_bug)
        enum_line("Cloud overlap scheme is", "i_overlap_scheme",
                  _OVERLAP_DISPLAY, config.overlap_scheme)
        onoff("Use \"beta\" overlap parameter is", "use_beta_overlap",
              config.use_beta_overlap)
        enum_line("Cloud PDF shape is", "i_cloud_pdf_shape",
                  _PDF_DISPLAY, config.cloud_pdf_shape)
        num("Cloud inhom decorrelation scaling",
            "cloud_inhom_decorr_scaling",
            config.cloud_inhom_decorr_scaling)

    lines.append("Solver settings:")
    enum_line("Shortwave solver is", "i_solver_sw", _SOLVER_DISPLAY,
              config.sw_solver)
    onoff("Shortwave delta scaling after merge with gases",
          "do_sw_delta_scaling_with_gases",
          config.do_sw_delta_scaling_with_gases)
    enum_line("Longwave solver is", "i_solver_lw", _SOLVER_DISPLAY,
              config.lw_solver)
    onoff("Longwave cloud scattering is", "do_lw_cloud_scattering",
          config.do_lw_cloud_scattering)
    onoff("Longwave aerosol scattering is", "do_lw_aerosol_scattering",
          config.do_lw_aerosol_scattering)
    onoff("Use vectorizable McICA cloud generator",
          "use_vectorizable_generator",
          config.use_vectorizable_generator)
    if Solver.SPARTACUS in (config.sw_solver, config.lw_solver):
        onoff("3D effects are", "do_3d_effects", config.do_3d_effects)
        enum_line("Shortwave entrapment is", "i_sw_entrapment",
                  _ENTRAPMENT_DISPLAY, config.sw_entrapment)
    if config.is_consolidated:
        lines.append("Consolidated spectral sizes:")
        lines.append(f"  n_g_sw = {config.n_g_sw}, n_bands_sw = "
                     f"{config.n_bands_sw}, n_g_lw = {config.n_g_lw}, "
                     f"n_bands_lw = {config.n_bands_lw}")
    return "\n".join(lines)
