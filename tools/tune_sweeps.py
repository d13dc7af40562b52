#!/usr/bin/env python3
"""Tile and launch shape of the fused McICA sweeps (solvers/triton_mcica.py):
time the LW and SW solver calls for candidate (g tile, column tile,
num_warps, num_stages) at flagship widths on the GPU, one JSON line per
candidate.  First the tiles at 4 warps and 1 stage, then warps and stages
around the fastest tiles.

    python tools/tune_sweeps.py [ncol] [nlev]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

import bench
from ecrad_tpu.optics import rrtmg
from ecrad_tpu.solvers import triton_mcica as tm


def time_candidate(cand, calls, inputs, niter):
    tm.G_TILE, tm.COL_TILE, tm.NUM_WARPS, tm.NUM_STAGES = cand
    ms = {}
    for tag, call in calls.items():
        exe, _ = bench.compile_with_env(
            "ECRAD_TPU_ADDING", "triton",
            lambda q, call=call: call(q, "knl"), (inputs[tag],))
        _, ts, _ = bench.timed(exe, (inputs[tag],), niter)
        ms[tag] = float(np.median(ts)) * 1e3
    r = {"g_tile": cand[0], "col_tile": cand[1], "num_warps": cand[2],
         "num_stages": cand[3], "lw_ms": ms["lw"], "sw_ms": ms["sw"],
         "total_ms": ms["lw"] + ms["sw"]}
    print(json.dumps(r), flush=True)
    return r


def main(argv):
    ncol = int(argv[0]) if argv else 16384
    nlev = int(argv[1]) if len(argv) > 1 else 137
    t = rrtmg.setup_tables()
    band_lw, band_sw = t["lw_band_from_g"], t["sw_band_from_g"]
    lw, sw = bench.solver_calls(band_lw, band_sw)
    calls = {"lw": lw, "sw": sw}
    inputs = {"lw": bench._knl(bench.sweep_inputs(ncol, nlev, band_lw)),
              "sw": bench._knl(bench.sweep_inputs(ncol, nlev, band_sw))}
    niter = 5
    tiles = [(g, c, 4, 1) for g in (8, 16, 32) for c in (32, 64, 128)]
    results = [time_candidate(c, calls, inputs, niter) for c in tiles]
    best = min(results, key=lambda r: r["total_ms"])
    g, c = best["g_tile"], best["col_tile"]
    launches = [(g, c, w, s) for w in (2, 4, 8) for s in (1, 2)
                if (w, s) != (4, 1)]
    results += [time_candidate(x, calls, inputs, niter) for x in launches]
    best = min(results, key=lambda r: r["total_ms"])
    print(json.dumps(dict(best, best=True, ncol=ncol, nlev=nlev,
                          card=bench.card_line())), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
