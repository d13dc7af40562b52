#!/usr/bin/env python3
"""Proof that the system runs on one NVIDIA GPU, through the entry
points a user calls.  One process holds the card; any failed phase
exits non-zero.

1. device: JAX must report a GPU; prints its kind, and the card's name
   and power limit as nvidia-smi gives them.
2. CLI: ``ecrad_tpu.driver`` main in-process on the vendored flagship
   namelist and the meridian input; every output flux must be finite.
3. flagship: ``__graft_entry__._build`` + ``pipeline.radiation_blocked``
   at 32768 columns with a block the builder sizes to the device; prints
   the block, peak device bytes, compile seconds and cols/s; float32 vs
   float64 of the same code on 2048 columns and seeds, every SW and LW
   flux field within 0.5 W m-2 max-abs.
4. the fused Triton McICA sweeps against the lax.scan path at flagship
   widths (ncol 2048, nlev 137, ng 140/112), float32.
5. one float32 vs float64 gate of each other bench.py cell.

``--four-cards`` runs only ``pipeline.radiation_sharded`` over four GPUs
against the same columns on one device.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

    python chip_smoke.py [--four-cards]
"""

import json
import os
import sys
import tempfile


def _show(tag, result):
    print(f"{tag}: {json.dumps(result)}", flush=True)


def cli_phase():
    """The CLI driver on the vendored flagship namelist: finite fluxes."""
    import numpy as np
    from scipy.io import netcdf_file

    from ecrad_tpu import driver
    from ecrad_tpu.data import DATA_DIR, MERIDIAN_INPUT

    nam = os.path.join(DATA_DIR, "io", "configCY49R1_flagship.nam")
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "out.nc")
        driver.main([nam, MERIDIAN_INPUT, out, "--dtype", "float32"])
        with netcdf_file(out, mmap=False) as f:
            fluxes = {k: np.asarray(v[:]) for k, v in f.variables.items()
                      if k.startswith("flux_")}
    bad = [k for k, v in fluxes.items() if not np.isfinite(v).all()]
    return {"fields": len(fluxes), "non_finite": bad,
            "ok": bool(fluxes) and not bad}


def main(argv):
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU, JAX reports {dev.platform!r}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import bench

    info = bench.device_info()
    print(f"device: {info['kind']} x {info['count']}", flush=True)
    print(bench.card_line(), flush=True)

    results = []
    if "--four-cards" in argv:
        results.append(("four_cards", bench.four_cards()))
        _show(*results[-1])
    else:
        results.append(("cli", cli_phase()))
        _show(*results[-1])
        cell = bench.bench_cell("flagship", niter=3)
        cell["ok"] = (cell["finite"] and cell["ncol"] >= 16384
                      and cell["block"] is not None)
        results.append(("flagship", cell))
        _show(*results[-1])
        results.append(("flagship_gate", bench.gate("flagship")))
        _show(*results[-1])
        results.append(("sweeps", bench.compare_sweeps(niter=3)))
        _show(*results[-1])
        for name in bench.CELLS:
            if name != "flagship":
                results.append((f"{name}_gate", bench.gate(name)))
                _show(*results[-1])

    failed = [tag for tag, r in results if not r["ok"]]
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
