"""Column-blocked and multi-device execution of the radiation scheme.

This is the equivalent of the reference's two batching layers:

* **Column blocking** — the reference driver splits the domain into
  ``nblocksize`` chunks and loops (driver/ecrad_driver.F90:339-384,
  driver/ifs_blocking.F90:328-331, NPROMA pattern).  Here
  :func:`radiation_blocked` reshapes the column axis into
  ``(nblocks, block_size)`` and runs a ``lax.map`` over blocks inside one
  jitted program, bounding the device working set to one block
  regardless of total ncol.
* **Column data parallelism across devices** — the reference uses OpenMP
  threads over blocks; here :func:`radiation_sharded` shard_maps the
  column axis over a 1-D ``jax.sharding.Mesh`` (pure DP — columns are
  independent, SURVEY §2.5 P1), with the LUT tables replicated (P4).
  There is no cross-device communication in the hot path.

The stochastic McICA cloud sample is generated on device inside the step
(counter-based threefry keyed per column via ``cloud["iseed"]``), so the
result is independent of blocking and sharding by construction.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ecrad_tpu.config import Config, Solver
from ecrad_tpu.containers import Flux
from ecrad_tpu.interface import Tables, radiation
from ecrad_tpu.solvers.cloud_generator import cloud_generator_device

# Offset decorrelating the LW stochastic sample from the SW one (the
# reference draws SW and LW samples from one RNG stream sequentially,
# radiation_cloud_generator.F90:37+; with counter-based keys we offset)
LW_SEED_OFFSET = 997


def _needs_mcica_sample(config: Config) -> bool:
    return config.do_clouds and Solver.MCICA in (config.sw_solver,
                                                 config.lw_solver)


def add_cloud_sample(config: Config, tables: Tables, cloud: dict) -> dict:
    """Attach the on-device stochastic cloud sample (od_scaling +
    total_cloud_cover per band set) to the cloud dict.

    The od_scaling layout follows interface.use_kernel_layout — kernel
    layout (nlev, ng, ncol) when the fused-solver hot path is active,
    classic (ncol, nlev, ng) otherwise — so it matches what the solver
    the sample is destined for expects."""
    if cloud is None or not _needs_mcica_sample(config):
        return cloud
    from ecrad_tpu.interface import use_kernel_layout
    layout = "knl" if use_kernel_layout(config, tables, cloud) else "cln"
    pdf = tables.pdf_sampler
    out = dict(cloud)
    if config.do_sw and config.sw_solver == Solver.MCICA:
        od_scaling_sw, tcc_sw = cloud_generator_device(
            config, pdf, cloud["iseed"], cloud["fraction"],
            cloud["overlap_param"], cloud["fractional_std"],
            config.n_g_sw, layout=layout)
        out.update(od_scaling_sw=od_scaling_sw,
                   total_cloud_cover_sw=tcc_sw)
    if config.do_lw and config.lw_solver == Solver.MCICA:
        od_scaling_lw, tcc_lw = cloud_generator_device(
            config, pdf, cloud["iseed"] + LW_SEED_OFFSET,
            cloud["fraction"], cloud["overlap_param"],
            cloud["fractional_std"], config.n_g_lw, layout=layout)
        out.update(od_scaling_lw=od_scaling_lw,
                   total_cloud_cover_lw=tcc_lw)
    return out


def radiation_step(config: Config, tables: Tables, *, solar_irradiance,
                   cloud=None, aerosol=None, **inputs) -> Flux:
    """Cloud generator + radiation() — the full jittable per-block step."""
    cloud_in = add_cloud_sample(config, tables, cloud)
    return radiation(config, tables, solar_irradiance=solar_irradiance,
                     cloud=cloud_in, aerosol=aerosol, **inputs)


def _pad_columns(tree, ncol: int, target: int):
    """Pad the leading (column) axis to ``target`` by repeating the last
    column — physically valid values, results are sliced off after."""
    if target == ncol:
        return tree

    def pad(x):
        if not hasattr(x, "ndim") or x.ndim == 0 or x.shape[0] != ncol:
            return x
        reps = jnp.broadcast_to(x[-1:], (target - ncol,) + x.shape[1:])
        return jnp.concatenate([x, reps], axis=0)

    return jax.tree_util.tree_map(pad, tree)


def _block(tree, nblocks: int, block_size: int):
    def rs(x):
        if not hasattr(x, "ndim") or x.ndim == 0:
            return x
        return x.reshape((nblocks, block_size) + x.shape[1:])

    return jax.tree_util.tree_map(rs, tree)


def _unblock(tree, ncol: int):
    def rs(x):
        if not hasattr(x, "ndim") or x is None:
            return x
        return x.reshape((-1,) + x.shape[2:])[:ncol]

    return jax.tree_util.tree_map(rs, tree)


def radiation_blocked(config: Config, tables: Tables, *, solar_irradiance,
                      block_size: int, cloud=None, aerosol=None,
                      **inputs) -> Flux:
    """NPROMA-style column blocking: run radiation_step over column
    blocks sequentially (lax.map) inside one compiled program, bounding
    device temporaries to one block (driver/ecrad_driver.F90:339-384)."""
    ncol = inputs["pressure_hl"].shape[0]
    if block_size >= ncol:
        return radiation_step(config, tables,
                              solar_irradiance=solar_irradiance,
                              cloud=cloud, aerosol=aerosol, **inputs)
    nblocks = -(-ncol // block_size)
    tree = dict(inputs)
    tree["cloud"] = cloud
    tree["aerosol"] = aerosol
    tree = _pad_columns(tree, ncol, nblocks * block_size)
    tree = _block(tree, nblocks, block_size)

    def one_block(block):
        cl = block.pop("cloud")
        aer = block.pop("aerosol")
        return radiation_step(config, tables,
                              solar_irradiance=solar_irradiance,
                              cloud=cl, aerosol=aer, **block)

    flux = jax.lax.map(one_block, tree)
    return _unblock(flux, ncol)


# Peak device bytes of one radiation step per column, per level, per
# g-point (SW + LW) and per byte of the float type: the flagship's
# compiled.memory_analysis() on an H100 (see CHANGES.md).
STEP_BYTES_PER_COLUMN_LEVEL_G = 12.0


# Share of the device's memory limit a step may take (the rest holds the
# inputs, outputs and the tables).
BLOCK_MEMORY_FILL = 0.7


def block_size_for(config: Config, ncol: int, nlev: int, itemsize: int,
                   device=None) -> int:
    """Largest power-of-two column block (at most ncol) whose step fits
    BLOCK_MEMORY_FILL of the device's memory, from
    STEP_BYTES_PER_COLUMN_LEVEL_G."""
    device = device or jax.devices()[0]
    stats = device.memory_stats()
    if not stats or "bytes_limit" not in stats:
        raise ValueError(f"{device} reports no memory limit to size a "
                         "column block from")
    per_col = (STEP_BYTES_PER_COLUMN_LEVEL_G * nlev * itemsize
               * (config.n_g_sw + config.n_g_lw))
    fit = max(1, int(BLOCK_MEMORY_FILL * stats["bytes_limit"] // per_col))
    return 1 << (min(fit, ncol).bit_length() - 1)


def make_mesh(n_devices: Optional[int] = None) -> jax.sharding.Mesh:
    """1-D device mesh over the column axis (SURVEY §2.5 P1)."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return jax.sharding.Mesh(np.array(devices), axis_names=("columns",))


def shard_inputs(mesh: jax.sharding.Mesh, tree, ncol: int):
    """Place every ncol-leading array on the mesh, sharded over columns;
    everything else replicated."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    col_sharding = NamedSharding(mesh, P("columns"))
    rep_sharding = NamedSharding(mesh, P())

    def put(x):
        if x is None or not hasattr(x, "ndim"):
            return x
        if x.ndim >= 1 and x.shape[0] == ncol:
            return jax.device_put(x, col_sharding)
        return jax.device_put(x, rep_sharding)

    return jax.tree_util.tree_map(put, tree)


def radiation_sharded(config: Config, tables: Tables,
                      mesh: jax.sharding.Mesh, *, solar_irradiance,
                      block_size: Optional[int] = None, cloud=None,
                      aerosol=None, **inputs) -> Flux:
    """Column-DP over the mesh via shard_map; per-device blocking
    optional.  Tables are closed over (replicated broadcast at compile,
    the analog of the reference's rank-0-read + MPI broadcast,
    utilities/easy_netcdf_read_mpi.F90)."""
    from jax.sharding import PartitionSpec as P
    n_dev = mesh.devices.size
    ncol = inputs["pressure_hl"].shape[0]
    padded = -(-ncol // n_dev) * n_dev
    tree = dict(inputs)
    tree["cloud"] = cloud
    tree["aerosol"] = aerosol
    tree = _pad_columns(tree, ncol, padded)

    def local_step(block):
        cl = block.pop("cloud")
        aer = block.pop("aerosol")
        if block_size is not None:
            return radiation_blocked(
                config, tables, solar_irradiance=solar_irradiance,
                block_size=block_size, cloud=cl, aerosol=aer, **block)
        return radiation_step(config, tables,
                              solar_irradiance=solar_irradiance,
                              cloud=cl, aerosol=aer, **block)

    # check_vma off: lax.scan carries initialized from constants are
    # device-unvarying at entry but varying at exit, which the VMA check
    # rejects; the computation itself is purely column-local.
    # jax.jit around shard_map is essential: an eager shard_map call
    # dispatches every primitive of the body separately across devices
    # (minutes for this program) instead of compiling one SPMD module.
    fn = jax.jit(jax.shard_map(local_step, mesh=mesh,
                               in_specs=(P("columns"),),
                               out_specs=P("columns"), check_vma=False))
    flux = fn(tree)
    return jax.tree_util.tree_map(
        lambda x: None if x is None else x[:ncol], flux,
        is_leaf=lambda x: x is None)
