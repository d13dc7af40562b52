#!/usr/bin/env python3
"""Visualize an ecRad-style input file: cloud, thermodynamic and gas
fields as column × pressure cross-sections plus surface properties —
this repository's equivalent of the reference's practical/plot_input.py /
plot_input_profile.py (built on ecrad_tpu.io.netcdf + matplotlib, no
xarray/seaborn).

  python tools/plot_input.py input.nc --out input_report.png
  python tools/plot_input.py input.nc --column 42 --out col42.png
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from ecrad_tpu.io.input import DriverConfig, read_input
from ecrad_tpu.io.netcdf import NcFile


def _coord(path, ncol):
    with NcFile(path) as f:
        if f.exists("latitude"):
            lat = np.asarray(f.get("latitude", np.float64))
            if lat.shape[0] == ncol:
                return lat, "latitude [deg]"
    return np.arange(ncol), "column"


def plot_input(path, out, column=None):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    inp = read_input(path, DriverConfig())
    phl = np.asarray(inp.thermodynamics.pressure_hl) / 100.0   # hPa
    p_fl = 0.5 * (phl[:, :-1] + phl[:, 1:])
    x, xlabel = _coord(path, inp.ncol)

    fields = [
        ("cloud fraction", inp.cloud_fraction, "Blues", None),
        ("q_liquid [g/kg]", 1e3 * inp.cloud_mixing_ratio[..., 0],
         "viridis", None),
        ("q_ice [g/kg]", 1e3 * inp.cloud_mixing_ratio[..., 1],
         "viridis", None),
        ("temperature [K]",
         0.5 * (np.asarray(inp.thermodynamics.temperature_hl)[:, :-1]
                + np.asarray(inp.thermodynamics.temperature_hl)[:, 1:]),
         "RdYlBu_r", None),
        ("specific humidity [g/kg]", 1e3 * inp.gas_mmr[:, :, 0],
         "viridis", None),
        ("ozone [mg/kg]", 1e6 * inp.gas_mmr[:, :, 2], "viridis", None),
    ]

    if column is not None:
        fig, axes = plt.subplots(1, len(fields), figsize=(3 * len(fields),
                                                          5),
                                 sharey=True)
        for ax, (title, v, _, _) in zip(axes, fields):
            ax.plot(v[column], p_fl[column], "C0-")
            ax.set_title(title, fontsize=9)
            ax.grid(alpha=0.3)
            if not ax.yaxis_inverted():
                ax.invert_yaxis()
        axes[0].set_ylabel("pressure [hPa]")
        fig.suptitle(f"{os.path.basename(path)} — column {column}")
    else:
        fig, axes = plt.subplots(3, 2, figsize=(13, 11), sharex=True)
        for ax, (title, v, cmap, norm) in zip(axes.ravel(), fields):
            pm = ax.pcolormesh(x, p_fl.mean(0), v.T, cmap=cmap,
                               shading="auto")
            fig.colorbar(pm, ax=ax, pad=0.01)
            ax.set_title(title, fontsize=10, loc="left")
            if not ax.yaxis_inverted():
                ax.invert_yaxis()
            ax.set_ylabel("pressure [hPa]")
        for ax in axes[-1]:
            ax.set_xlabel(xlabel)
        # surface / scalar strip in the title
        fig.suptitle(
            f"{os.path.basename(path)} — ncol={inp.ncol} "
            f"nlev={inp.nlev}  cos_sza [{inp.cos_sza.min():.2f}, "
            f"{inp.cos_sza.max():.2f}]  solar {inp.solar_irradiance:.0f}"
            " W m-2")
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    plt.close(fig)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input")
    ap.add_argument("--out", default=None)
    ap.add_argument("--column", type=int, default=None)
    args = ap.parse_args(argv)
    out = args.out or (os.path.splitext(
        os.path.basename(args.input))[0] + "_input.png")
    print("wrote", plot_input(args.input, out, args.column))
    return 0


if __name__ == "__main__":
    sys.exit(main())
