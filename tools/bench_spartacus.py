#!/usr/bin/env python3
"""Isolated SPARTACUS solver benchmark: trace/compile/run timings for
solver_spartacus_sw / solver_spartacus_lw on synthetic inputs at bench
shapes, so layer-matrix optimizations can be iterated without paying
the full-pipeline compile each time.

Usage: python tools/bench_spartacus.py [sw|lw|both] [--ncol N] [--ng G]
Env: ECRAD_TPU_SPARTACUS_CHUNK tunes the layer-matrix level chunk.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np


def make_inputs(ncol, nlev, ng, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    pressure_hl = np.linspace(100.0, 1.0e5, nlev + 1)[None, :].repeat(
        ncol, 0) * (1.0 + 0.01 * rng.random((ncol, 1)))
    temperature_hl = 220.0 + 80.0 * np.linspace(0, 1, nlev + 1)[None, :] \
        + rng.random((ncol, nlev + 1))
    od = np.abs(rng.lognormal(-3.0, 1.5, (ncol, nlev, ng))).astype(dtype)
    ssa = rng.uniform(0.0, 0.6, (ncol, nlev, ng)).astype(dtype)
    g = rng.uniform(0.0, 0.4, (ncol, nlev, ng)).astype(dtype)
    nband = 14
    od_cloud_b = np.abs(rng.lognormal(0.0, 1.0, (ncol, nlev, nband))
                        ).astype(dtype)
    ssa_cloud_b = rng.uniform(0.3, 0.999, (ncol, nlev, nband)).astype(dtype)
    g_cloud_b = rng.uniform(0.5, 0.9, (ncol, nlev, nband)).astype(dtype)
    band_from_g = (np.arange(ng) * nband // ng).astype(np.int32)
    cf = np.clip(rng.random((ncol, nlev)) * 1.5 - 0.5, 0.0, 1.0)
    cf[:, : nlev // 3] = 0.0                      # clear upper levels
    inputs = dict(
        od=od, ssa=ssa, g=g, od_cloud_b=od_cloud_b,
        ssa_cloud_b=ssa_cloud_b, g_cloud_b=g_cloud_b,
        band_from_g=band_from_g,
        cloud_fraction=cf.astype(dtype),
        fractional_std=np.full((ncol, nlev), 0.75, dtype),
        overlap_param=rng.uniform(0.3, 0.95, (ncol, nlev - 1)).astype(
            dtype),
        inv_cloud_size=np.full((ncol, nlev), 1.0e-4, dtype),
        inv_inhom_size=np.full((ncol, nlev), 2.5e-4, dtype),
        pressure_hl=pressure_hl.astype(dtype),
        temperature_hl=temperature_hl.astype(dtype),
    )
    sw = dict(
        incoming_sw=np.abs(rng.random((ncol, ng))).astype(dtype),
        cos_sza=rng.uniform(-0.1, 1.0, ncol).astype(dtype),
        albedo_diffuse=np.full((ncol, ng), 0.08, dtype),
        albedo_direct=np.full((ncol, ng), 0.06, dtype),
    )
    lw = dict(
        planck_hl=np.abs(rng.random((ncol, nlev + 1, ng))).astype(dtype),
        emission=np.abs(rng.random((ncol, ng))).astype(dtype),
        albedo=np.full((ncol, ng), 0.02, dtype),
    )
    return inputs, sw, lw


def bench(which="both", ncol=512, nlev=137, ng=112, niter=5):
    import jax
    import jax.numpy as jnp

    from ecrad_tpu.config import Config, Solver
    from ecrad_tpu.jax_setup import enable_persistent_cache
    from ecrad_tpu.solvers.spartacus import (solver_spartacus_lw,
                                             solver_spartacus_sw)

    enable_persistent_cache()
    config = Config(sw_solver=Solver.SPARTACUS, lw_solver=Solver.SPARTACUS,
                    do_3d_effects=True, do_lw_derivatives=True,
                    dtype_name="float32")
    common, sw_in, lw_in = make_inputs(ncol, nlev, ng)
    dev = jax.devices()[0]
    put = lambda d: {k: jax.device_put(jnp.asarray(v), dev)
                     for k, v in d.items()}
    common, sw_in, lw_in = put(common), put(sw_in), put(lw_in)

    def run_one(name, fn, kwargs):
        def scalar_fn(kw):
            out = fn(config, **kw)
            acc = jnp.float32(0.0)
            for leaf in jax.tree_util.tree_leaves(out):
                if leaf is not None:
                    acc = acc + jnp.sum(leaf.astype(jnp.float32))
            return acc

        jfn = jax.jit(scalar_fn)
        t0 = time.time()
        lowered = jfn.lower(kwargs)
        t_trace = time.time() - t0
        t0 = time.time()
        compiled = lowered.compile()
        t_compile = time.time() - t0
        v = float(np.asarray(compiled(kwargs)))
        ts = []
        for _ in range(niter):
            t0 = time.time()
            float(np.asarray(compiled(kwargs)))
            ts.append(time.time() - t0)
        t = min(ts)
        print(f"{name}: trace={t_trace:.1f}s compile={t_compile:.1f}s "
              f"run={t*1e3:.1f}ms cols/s={ncol/t:.0f} checksum={v:.5g}",
              flush=True)
        return t_compile, t

    kw = dict(common)
    chunk = os.environ.get("ECRAD_TPU_SPARTACUS_CHUNK", "1")
    print(f"# chunk={chunk} ncol={ncol} nlev={nlev} ng={ng} "
          f"backend={jax.default_backend()}", flush=True)
    if which in ("sw", "both"):
        run_one("sw", solver_spartacus_sw, {**kw, **sw_in})
    if which in ("lw", "both"):
        run_one("lw", solver_spartacus_lw, {**kw, **lw_in})


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("which", nargs="?", default="both")
    p.add_argument("--ncol", type=int, default=512)
    p.add_argument("--nlev", type=int, default=137)
    p.add_argument("--ng", type=int, default=112)
    p.add_argument("--niter", type=int, default=5)
    a = p.parse_args()
    bench(a.which, a.ncol, a.nlev, a.ng, a.niter)
