#!/usr/bin/env python3
"""Benchmark and correctness gate of the five cells on one GPU.

The cells (``CELLS``) are the CY49R1 flagship (RRTMG gas optics + McICA
SW+LW + 12-type aerosols, 137 levels) and four solver/gas-model variants
of it.  For each cell:

* time: one jitted step over ``ncol`` columns (column-blocked, with a
  block the builder sizes to the device for the flagship), synchronised
  on every output array; the first call (compile) is reported apart, and
  cols/s comes from the best and the median of the timed calls;
* gate: the float32 fluxes against the float64 fluxes of the same code
  on ``GATE_NCOL`` columns with the same seeds; every LW and SW flux
  field must agree within 0.5 W m-2 max-abs (the reference's
  single-precision threshold, BASELINE.md).

Every result names the device as JAX reports it and the card's name and
power limit as nvidia-smi reports them.  A run that finds no GPU fails.

    python bench.py [cell ...]     # all cells by default
    python bench.py --ab           # fused Triton sweeps vs lax.scan,
                                   # gather vs one-hot gas optics
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
import numpy as np

from ecrad_tpu.config import GasModel, Solver

REFERENCE_COLS_PER_SEC = 268.0   # ecRad CPU driver, one thread (BASELINE.md)
GATE_NCOL = 2048
GATE_W_M2 = 0.5

# name: (Config overrides on the flagship, ncol, block; None = builder)
_ECCKD = dict(gas_model_sw=GasModel.ECCKD, gas_model_lw=GasModel.ECCKD,
              use_general_cloud_optics=True,
              do_nearest_spectral_lw_emiss=False, use_aerosols=False,
              n_aerosol_types=0, i_aerosol_type_map=())
_TRIPLECLOUDS = dict(sw_solver=Solver.TRIPLECLOUDS,
                     lw_solver=Solver.TRIPLECLOUDS)
CELLS = {
    "flagship": (dict(), 32768, None),
    "tripleclouds_rrtmg": (_TRIPLECLOUDS, 4096, 4096),
    "tripleclouds_ecckd": (dict(_TRIPLECLOUDS, **_ECCKD), 4096, 4096),
    "ecckd_mcica": (_ECCKD, 4096, 4096),
    "spartacus_3d": (dict(sw_solver=Solver.SPARTACUS,
                          lw_solver=Solver.SPARTACUS, do_3d_effects=True,
                          do_sw_delta_scaling_with_gases=False), 1024, 1024),
}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True)
    return r.stdout.strip().splitlines()[0]


def device_info() -> dict:
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def require_gpu() -> dict:
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX reports {info}")
    return info


def build(name, ncol, dtype="float32", block=None):
    import __graft_entry__ as ge
    return ge._build(ncol=ncol, dtype=dtype, block_size=block,
                     nam_overrides=CELLS[name][0])


def timed(fn, args, niter):
    """(compile seconds, [seconds per call], last output): each call is
    synchronised on every output array."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(niter):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return compile_s, times, out


def flux_fields(flux) -> dict:
    """Host copies of every LW and SW flux field (W m-2)."""
    out = {}
    for f in flux.__dataclass_fields__:
        v = getattr(flux, f)
        if v is not None and f.startswith(("lw_", "sw_")) \
                and f != "lw_derivatives":
            out[f] = np.asarray(v, np.float64)
    return out


def gate(name, ncol=GATE_NCOL) -> dict:
    """float32 vs float64 of the same code on the same columns and seeds:
    max-abs difference per flux field, and whether all are within
    GATE_W_M2."""
    step, args = build(name, ncol, "float32")
    f32 = flux_fields(jax.block_until_ready(jax.jit(step)(*args)))
    jax.config.update("jax_enable_x64", True)
    try:
        step, args = build(name, ncol, "float64")
        f64 = flux_fields(jax.block_until_ready(jax.jit(step)(*args)))
    finally:
        jax.config.update("jax_enable_x64", False)
    diff = {k: float(np.max(np.abs(f32[k] - f64[k]))) for k in f32}
    finite = all(np.isfinite(v).all() for v in f32.values())
    return {"gate_ncol": ncol, "finite": finite,
            "max_abs_w_m2": max(diff.values()),
            "worst_field": max(diff, key=diff.get),
            "ok": finite and max(diff.values()) <= GATE_W_M2,
            "per_field": diff}


def bench_cell(name, niter=10) -> dict:
    _, ncol, block = CELLS[name]
    step, args = build(name, ncol, "float32",
                       block=block if block is not None else "auto")
    compile_s, times, out = timed(jax.jit(step), args, niter)
    finite = all(np.isfinite(v).all() for v in flux_fields(out).values())
    best, median = min(times), float(np.median(times))
    return {"cell": name, "ncol": ncol, "block": step.block_size,
            "cols_per_sec": ncol / median, "cols_per_sec_best": ncol / best,
            "step_ms_median": median * 1e3, "step_ms_best": best * 1e3,
            "step_ms_all": [t * 1e3 for t in times],
            "compile_seconds": compile_s, "finite": finite,
            "vs_reference_1thread": ncol / median / REFERENCE_COLS_PER_SEC,
            "peak_bytes_in_use":
                jax.devices()[0].memory_stats()["peak_bytes_in_use"]}


# ---------------------------------------------------------------------------
# A/B timings of implementation choices
# ---------------------------------------------------------------------------

def sweep_inputs(ncol, nlev, band_of_g, dtype=jnp.float32, seed=0):
    """Random McICA solver inputs at physical magnitudes, classic layout
    (ncol, nlev, ng), made on the device."""
    ng = len(band_of_g)
    nband = int(np.max(band_of_g)) + 1
    ks = iter(jax.random.split(jax.random.key(seed), 16))

    def u(shape, lo, hi):
        return jax.random.uniform(next(ks), shape, dtype, lo, hi)

    frac = u((ncol, nlev), 0.0, 1.0) * (u((ncol, nlev), 0.0, 1.0) > 0.6)
    return dict(
        od=u((ncol, nlev, ng), 1e-4, 2.0), ssa=u((ncol, nlev, ng), 0.0, 1.0),
        g=u((ncol, nlev, ng), 0.0, 0.8),
        od_cloud_b=u((ncol, nlev, nband), 0.0, 5.0),
        ssa_cloud_b=u((ncol, nlev, nband), 0.3, 0.999),
        g_cloud_b=u((ncol, nlev, nband), 0.0, 0.9),
        od_scaling=u((ncol, nlev, ng), 0.0, 2.0), tcc=u((ncol,), 0.0, 1.0),
        cloud_fraction=frac, planck_hl=u((ncol, nlev + 1, ng), 0.0, 3.0),
        emission=u((ncol, ng), 0.0, 3.0), albedo=u((ncol, ng), 0.0, 0.3),
        incoming=u((ncol, ng), 0.0, 30.0), cos_sza=u((ncol,), -0.2, 1.0),
        albedo_direct=u((ncol, ng), 0.0, 0.4))


def _knl(p):
    """Kernel-layout copies of the per-g profile fields."""
    t = lambda x: jnp.transpose(x, (1, 2, 0))
    return dict(p, **{k: t(p[k]) for k in
                      ("od", "ssa", "g", "od_scaling", "planck_hl")})


def solver_calls(band_lw, band_sw):
    """jit-able LW and SW McICA solver calls over sweep_inputs dicts, as
    the flagship makes them."""
    from ecrad_tpu.solvers import mcica

    def lw(p, layout):
        return mcica.solver_mcica_lw(
            p["od"], None, None, p["od_cloud_b"], p["ssa_cloud_b"],
            p["g_cloud_b"], band_lw, p["od_scaling"], p["tcc"],
            p["cloud_fraction"], p["planck_hl"], p["emission"],
            p["albedo"], do_lw_cloud_scattering=True,
            do_lw_aerosol_scattering=False, do_lw_derivatives=True,
            layout=layout)

    def sw(p, layout):
        return mcica.solver_mcica_sw(
            p["od"], p["ssa"], p["g"], p["od_cloud_b"], p["ssa_cloud_b"],
            p["g_cloud_b"], band_sw, p["od_scaling"], p["tcc"],
            p["cloud_fraction"], p["incoming"], p["cos_sza"],
            p["albedo"], p["albedo_direct"], layout=layout)

    return lw, sw


def compile_with_env(name, value, fn, args):
    """Compile fn for args with environment variable ``name`` set to
    ``value`` while tracing (the implementation choices are read at
    trace time); returns (executable, compile seconds)."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        t0 = time.perf_counter()
        exe = jax.jit(fn).lower(*args).compile()
        return exe, time.perf_counter() - t0
    finally:
        if old is None:
            os.environ.pop(name)
        else:
            os.environ[name] = old


def _max_rel(a, b):
    """Worst leaf of two output pytrees: its max-abs difference over the
    largest magnitude of b's leaf, and the leaf's name."""
    worst, name = 0.0, None
    for (path, x), y in zip(jax.tree_util.tree_leaves_with_path(a),
                            jax.tree_util.tree_leaves(b)):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        scale = max(float(np.max(np.abs(y))), 1e-30)
        err = float(np.max(np.abs(x - y))) / scale
        if err >= worst:
            worst, name = err, jax.tree_util.keystr(path)
    return worst, name


def compare_sweeps(ncol=GATE_NCOL, nlev=137, niter=10) -> dict:
    """The fused Triton sweeps against the lax.scan path on the same
    random inputs at flagship widths (ng 140 LW, 112 SW), in float32,
    both measured against the float64 lax.scan path on those inputs;
    plus the solver-alone times of both."""
    from ecrad_tpu.optics import rrtmg
    t = rrtmg.setup_tables()
    band_lw, band_sw = t["lw_band_from_g"], t["sw_band_from_g"]
    lw, sw = solver_calls(band_lw, band_sw)
    res = {"ncol": ncol, "nlev": nlev, "ng_lw": len(band_lw),
           "ng_sw": len(band_sw),
           "tolerance": ("worst relative error of the fused kernel vs "
                         "float64 <= max(2 x that of the float32 lax.scan "
                         "path, 1e-6)"),
           "tolerance_reason": (
               "both are float32 and do the same arithmetic in another "
               "order (g sums by tile partials; exp/expm1 from libdevice "
               "vs XLA) over 137 chained levels, so the kernel must be as "
               "accurate as the plain path it replaces")}
    ok = True
    for tag, call, band in (("lw", lw, band_lw), ("sw", sw, band_sw)):
        p = sweep_inputs(ncol, nlev, band)
        pk = jax.block_until_ready(_knl(p))
        fn_t, ct = compile_with_env("ECRAD_TPU_ADDING", "triton",
                                    lambda q: call(q, "knl"), (pk,))
        fn_s, cs = compile_with_env("ECRAD_TPU_ADDING", "scan",
                                    lambda q: call(q, "cln"), (p,))
        _, tt, out_t = timed(fn_t, (pk,), niter)
        _, ts, out_s = timed(fn_s, (p,), niter)
        jax.config.update("jax_enable_x64", True)
        try:
            p64 = jax.tree.map(lambda x: x.astype(jnp.float64)
                               if x.dtype == jnp.float32 else x, p)
            fn_r, _ = compile_with_env("ECRAD_TPU_ADDING", "scan",
                                       lambda q: call(q, "cln"), (p64,))
            ref = jax.block_until_ready(fn_r(p64))
        finally:
            jax.config.update("jax_enable_x64", False)
        err_t, leaf_t = _max_rel(out_t, ref)
        err_s, leaf_s = _max_rel(out_s, ref)
        res[tag] = {"triton_ms": float(np.median(tt)) * 1e3,
                    "scan_ms": float(np.median(ts)) * 1e3,
                    "compile_s": {"triton": ct, "scan": cs},
                    "triton_rel_err_vs_f64": err_t, "worst_leaf": leaf_t,
                    "scan_rel_err_vs_f64": err_s, "scan_worst_leaf": leaf_s,
                    "triton_vs_scan_rel": _max_rel(out_t, out_s)[0]}
        ok &= err_t <= max(2.0 * err_s, 1e-6)
    res["ok"] = ok
    return res


def ab_flagship_step(ncol=16384, niter=6) -> dict:
    """Whole flagship step with the fused Triton sweeps and with the
    lax.scan path, in turns (triton, scan, scan, triton)."""
    fns = {}
    for mode in ("triton", "scan"):
        step, args = build("flagship", ncol, block="auto")
        exe, c = compile_with_env("ECRAD_TPU_ADDING", mode, step, args)
        fns[mode] = (exe, args, c)
    res = {"ncol": ncol, "block": step.block_size, "ms": {},
           "compile_s": {m: v[2] for m, v in fns.items()}}
    for mode in ("triton", "scan", "scan", "triton"):
        fn, args, _ = fns[mode]
        _, ts, _ = timed(fn, args, niter)
        res["ms"].setdefault(mode, []).extend(t * 1e3 for t in ts)
    res["median_ms"] = {m: float(np.median(v)) for m, v in res["ms"].items()}
    return res


def ab_gas_optics(ncol=16384, niter=10) -> dict:
    """The flagship's RRTMG gas-optics phase with gathers and with the
    level-windowed one-hot products at HIGHEST precision."""
    from ecrad_tpu import constants
    from ecrad_tpu.optics import rrtmg
    step, args = build("flagship", ncol)
    tables = step.tables
    gas_args = args[:5]                # phl, thl, gas_mmr, cos_sza, tskin

    def gas_fn():
        """A fresh function per mode: jit caches traces by function."""
        def gas(phl, thl, mmr, cos_sza, tskin):
            gd = {n: mmr[:, :, constants.GAS_INDEX[n]] for n in (
                "h2o", "co2", "ch4", "n2o", "cfc11", "cfc12", "hcfc22",
                "ccl4", "o3")}
            return rrtmg.gas_optics(
                tables.gas["rrtmg"], phl, thl, gd, cos_sza=cos_sza,
                do_lw=True, do_sw=True, skin_temperature=tskin,
                solar_irradiance=step.solar, layout="knl")
        return gas

    exes = {}
    exes["gather"] = compile_with_env("ECRAD_TPU_FORCE_ONEHOT", "0",
                                      gas_fn(), gas_args)
    from ecrad_tpu.data import MERIDIAN_INPUT
    from ecrad_tpu.io.input import DriverConfig, read_input
    inp = read_input(MERIDIAN_INPUT, DriverConfig())
    os.environ["ECRAD_TPU_FORCE_ONEHOT"] = "1"
    try:
        rrtmg.install_interp_windows(tables, inp.thermodynamics)
    finally:
        os.environ.pop("ECRAD_TPU_FORCE_ONEHOT")
    exes["onehot"] = compile_with_env("ECRAD_TPU_FORCE_ONEHOT", "1",
                                      gas_fn(), gas_args)
    res = {"ncol": ncol, "ms": {},
           "compile_s": {m: v[1] for m, v in exes.items()}}
    outs = {}
    for mode in ("gather", "onehot", "onehot", "gather"):
        _, ts, outs[mode] = timed(exes[mode][0], gas_args, niter)
        res["ms"].setdefault(mode, []).extend(t * 1e3 for t in ts)
    res["median_ms"] = {m: float(np.median(v)) for m, v in res["ms"].items()}
    res["onehot_vs_gather_max_rel_diff"] = _max_rel(outs["onehot"],
                                                    outs["gather"])[0]
    return res


def four_cards(ncol_per_device=4096, niter=6) -> dict:
    """pipeline.radiation_sharded over four GPUs (a 1-D column mesh)
    against the same columns on one device in blocks of the per-device
    size; fluxes equal to float32 roundoff required, both times
    reported."""
    from ecrad_tpu import pipeline
    n = 4
    if len(jax.devices()) < n:
        raise SystemExit(f"--four-cards needs {n} GPUs, JAX reports "
                         f"{device_info()}")
    ncol = n * ncol_per_device
    step, args = build("flagship", ncol)
    names = ["pressure_hl", "temperature_hl", "gas_mmr", "cos_sza",
             "skin_temperature", "sw_albedo", "sw_albedo_direct",
             "lw_emissivity", "cloud", "aerosol"]
    mesh = pipeline.make_mesh(n)
    kw = pipeline.shard_inputs(mesh, dict(zip(names, args)), ncol)
    cl, aer = kw.pop("cloud"), kw.pop("aerosol")
    sharded = jax.jit(lambda cl, aer, kw: pipeline.radiation_sharded(
        step.config, step.tables, mesh, solar_irradiance=step.solar,
        cloud=cl, aerosol=aer, **kw))
    c4, t4, out4 = timed(sharded, (cl, aer, kw), niter)
    one = dict(zip(names, args))
    cl1, aer1 = one.pop("cloud"), one.pop("aerosol")
    single = jax.jit(lambda cl, aer, kw: pipeline.radiation_blocked(
        step.config, step.tables, solar_irradiance=step.solar,
        block_size=ncol_per_device, cloud=cl, aerosol=aer, **kw))
    c1, t1, out1 = timed(single, (cl1, aer1, one), niter)
    f4, f1 = flux_fields(out4), flux_fields(out1)
    diff = max(float(np.max(np.abs(f4[k] - f1[k]))) for k in f1)
    return {"n_devices": n, "ncol": ncol, "ms_4_devices": np.median(t4) * 1e3,
            "ms_1_device": np.median(t1) * 1e3,
            "speedup": float(np.median(t1) / np.median(t4)),
            "compile_s": {"4": c4, "1": c1}, "max_abs_w_m2": diff,
            "tolerance_w_m2": 1e-3,
            "tolerance_reason": ("float32 roundoff: the same per-column "
                                 "arithmetic compiled into two programs "
                                 "(shard_map vs lax.map over blocks)"),
            "ok": diff <= 1e-3}


def main(argv):
    info = require_gpu()
    card = card_line()
    print(f"# card: {card}", flush=True)
    if "--ab" in argv:
        for fn in (compare_sweeps, ab_flagship_step, ab_gas_optics):
            r = fn()
            print(json.dumps(dict(r, ab=fn.__name__, device=info,
                                  card=card)), flush=True)
        return 0
    ok = True
    for name in [a for a in argv if not a.startswith("-")] or list(CELLS):
        cell, g = bench_cell(name), gate(name)
        ok &= cell["finite"] and g["ok"]
        print(json.dumps(dict(cell, gate=g, device=info, card=card)),
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
