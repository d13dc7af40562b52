"""Unified solver output contract.

Every SW/LW solver returns these tuples so radiation() has exactly one
post-processing path (reference: the per-solver output packing in
radiation_interface.F90:427-499 is likewise uniform over flux_type).

Memory contract (what bounds device memory): profiles are **broadband**
``(ncol, nlev+1)``; spectrally-resolved data exists only as
surface/TOA g slices ``(ncol, ng)`` plus, when spectral flux output is
requested, ``*_s`` profiles ``(ncol, nlev+1, nspec)`` projected through a
(ng, nspec) matrix *inside* the vertical scans.  Full g-resolved flux
profiles ``(ncol, nlev+1, ng)`` are never materialized — the reference
computes broadband sums on the fly for the same reason
(radiation_mcica_sw.F90:185-222).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp


class LwFluxes(NamedTuple):
    flux_up: jnp.ndarray                 # (ncol, nlev+1) broadband
    flux_dn: jnp.ndarray
    flux_up_clear: jnp.ndarray
    flux_dn_clear: jnp.ndarray
    lw_dn_surf_g: jnp.ndarray            # (ncol, ng)
    lw_up_toa_g: jnp.ndarray
    lw_dn_surf_clear_g: jnp.ndarray
    lw_up_toa_clear_g: jnp.ndarray
    cloud_cover: jnp.ndarray             # (ncol,)
    lw_derivatives: Optional[jnp.ndarray] = None
    # spectral profiles (ncol, nlev+1, nspec), present iff spec_matrix given
    flux_up_s: Optional[jnp.ndarray] = None
    flux_dn_s: Optional[jnp.ndarray] = None
    flux_up_clear_s: Optional[jnp.ndarray] = None
    flux_dn_clear_s: Optional[jnp.ndarray] = None


class SwFluxes(NamedTuple):
    flux_up: jnp.ndarray                 # (ncol, nlev+1) broadband
    flux_dn: jnp.ndarray                 # diffuse + direct
    flux_dn_direct: jnp.ndarray
    flux_up_clear: jnp.ndarray
    flux_dn_clear: jnp.ndarray
    flux_dn_direct_clear: jnp.ndarray
    sw_dn_diffuse_surf_g: jnp.ndarray    # (ncol, ng)
    sw_dn_direct_surf_g: jnp.ndarray
    sw_up_toa_g: jnp.ndarray
    sw_dn_diffuse_surf_clear_g: jnp.ndarray
    sw_dn_direct_surf_clear_g: jnp.ndarray
    sw_up_toa_clear_g: jnp.ndarray
    cloud_cover: jnp.ndarray
    flux_up_s: Optional[jnp.ndarray] = None
    flux_dn_s: Optional[jnp.ndarray] = None
    flux_dn_direct_s: Optional[jnp.ndarray] = None
    flux_up_clear_s: Optional[jnp.ndarray] = None
    flux_dn_clear_s: Optional[jnp.ndarray] = None
    flux_dn_direct_clear_s: Optional[jnp.ndarray] = None


def _proj(x_g, spec_matrix):
    if spec_matrix is None:
        return None
    return jnp.matmul(x_g, spec_matrix, precision=jax.lax.Precision.HIGHEST)


def lw_from_g_profiles(*, flux_up_g, flux_dn_g, flux_up_clear_g,
                       flux_dn_clear_g, cloud_cover, lw_derivatives=None,
                       spec_matrix=None) -> LwFluxes:
    """Adapter for solvers that (still) build full g-resolved profiles
    internally (Tripleclouds/SPARTACUS region-coupled adding)."""
    return LwFluxes(
        flux_up=jnp.sum(flux_up_g, axis=-1),
        flux_dn=jnp.sum(flux_dn_g, axis=-1),
        flux_up_clear=jnp.sum(flux_up_clear_g, axis=-1),
        flux_dn_clear=jnp.sum(flux_dn_clear_g, axis=-1),
        lw_dn_surf_g=flux_dn_g[:, -1, :],
        lw_up_toa_g=flux_up_g[:, 0, :],
        lw_dn_surf_clear_g=flux_dn_clear_g[:, -1, :],
        lw_up_toa_clear_g=flux_up_clear_g[:, 0, :],
        cloud_cover=cloud_cover,
        lw_derivatives=lw_derivatives,
        flux_up_s=_proj(flux_up_g, spec_matrix),
        flux_dn_s=_proj(flux_dn_g, spec_matrix),
        flux_up_clear_s=_proj(flux_up_clear_g, spec_matrix),
        flux_dn_clear_s=_proj(flux_dn_clear_g, spec_matrix))


def sw_from_g_profiles(*, flux_up_g, flux_dn_diffuse_g, flux_dn_direct_g,
                       flux_up_clear_g, flux_dn_diffuse_clear_g,
                       flux_dn_direct_clear_g, cloud_cover,
                       spec_matrix=None) -> SwFluxes:
    flux_dn_g = flux_dn_diffuse_g + flux_dn_direct_g
    flux_dn_clear_g = flux_dn_diffuse_clear_g + flux_dn_direct_clear_g
    return SwFluxes(
        flux_up=jnp.sum(flux_up_g, axis=-1),
        flux_dn=jnp.sum(flux_dn_g, axis=-1),
        flux_dn_direct=jnp.sum(flux_dn_direct_g, axis=-1),
        flux_up_clear=jnp.sum(flux_up_clear_g, axis=-1),
        flux_dn_clear=jnp.sum(flux_dn_clear_g, axis=-1),
        flux_dn_direct_clear=jnp.sum(flux_dn_direct_clear_g, axis=-1),
        sw_dn_diffuse_surf_g=flux_dn_diffuse_g[:, -1, :],
        sw_dn_direct_surf_g=flux_dn_direct_g[:, -1, :],
        sw_up_toa_g=flux_up_g[:, 0, :],
        sw_dn_diffuse_surf_clear_g=flux_dn_diffuse_clear_g[:, -1, :],
        sw_dn_direct_surf_clear_g=flux_dn_direct_clear_g[:, -1, :],
        sw_up_toa_clear_g=flux_up_clear_g[:, 0, :],
        cloud_cover=cloud_cover,
        flux_up_s=_proj(flux_up_g, spec_matrix),
        flux_dn_s=_proj(flux_dn_g, spec_matrix),
        flux_dn_direct_s=_proj(flux_dn_direct_g, spec_matrix),
        flux_up_clear_s=_proj(flux_up_clear_g, spec_matrix),
        flux_dn_clear_s=_proj(flux_dn_clear_g, spec_matrix),
        flux_dn_direct_clear_s=_proj(flux_dn_direct_clear_g, spec_matrix))
