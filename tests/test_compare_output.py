"""Evaluation toolkit (tools/compare_output.py): this repository's
equivalent of the reference's practical/compare_output*.py scripts."""

import os
import subprocess
import sys

import numpy as np
import pytest

from tests import golden

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "compare_output.py")
REF_DEFAULT = os.path.join(golden.TEST_IFS,
                           "ecrad_meridian_default_out_REFERENCE.nc")
REF_NOAER = os.path.join(golden.TEST_IFS,
                         "ecrad_meridian_noaer_out_REFERENCE.nc")

sys.path.insert(0, os.path.join(REPO, "tools"))
import compare_output as co  # noqa: E402


def test_self_comparison_is_zero():
    rows, miss_a, miss_b = co.compare(REF_DEFAULT, REF_DEFAULT,
                                      golden.INPUT_FILE)
    assert rows and not miss_a and not miss_b
    for name, s in rows.items():
        assert s["max_abs"] == 0.0, name
    assert any(n.startswith("heating_rate") for n in rows)


def test_thresholds_pass_and_fail():
    rows, _, _ = co.compare(REF_DEFAULT, REF_DEFAULT)
    assert co.check_thresholds(rows, 0.001, 0.1) == {}
    rows2, _, _ = co.compare(REF_NOAER, REF_DEFAULT)
    bad = co.check_thresholds(rows2, 0.001, 0.1)
    assert "flux_dn_sw" in bad        # aerosols change SW a lot


def test_heating_rate_formula():
    """Constant net-flux divergence -> uniform K/day heating."""
    ncol, nlev = 2, 4
    phl = np.linspace(1.0e4, 1.0e5, nlev + 1)[None, :].repeat(ncol, 0)
    dn = np.linspace(0.0, 90.0, nlev + 1)[None, :].repeat(ncol, 0)
    up = np.zeros_like(dn)
    hr = co.heating_rate(dn, up, phl)
    expect = (co.SECONDS_PER_DAY * co.ACCEL_GRAVITY / co.CP_DRY
              * (90.0 / nlev) / (9.0e4 / nlev))
    np.testing.assert_allclose(hr, expect, rtol=1e-12)


def test_cli_report_and_plots(tmp_path):
    prefix = str(tmp_path / "rep")
    r = subprocess.run(
        [sys.executable, TOOL, REF_NOAER, REF_DEFAULT,
         "--input", golden.INPUT_FILE, "--plot", prefix],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-800:]
    assert "heating_rate_lw" in r.stdout
    for suffix in ("_profile.png", "_scalar.png"):
        f = prefix + suffix
        assert os.path.exists(f) and os.path.getsize(f) > 10000, f


def test_plot_input_tool(tmp_path):
    tool = os.path.join(REPO, "tools", "plot_input.py")
    out = str(tmp_path / "inp.png")
    r = subprocess.run(
        [sys.executable, tool, golden.INPUT_FILE, "--out", out],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-800:]
    assert os.path.getsize(out) > 10000
    out2 = str(tmp_path / "col.png")
    r = subprocess.run(
        [sys.executable, tool, golden.INPUT_FILE, "--column", "20",
         "--out", out2],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and os.path.getsize(out2) > 10000


def test_cli_threshold_exit_code():
    r = subprocess.run(
        [sys.executable, TOOL, REF_NOAER, REF_DEFAULT,
         "--threshold-lw", "0.001", "--threshold-sw", "0.1"],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 1
    assert "FAIL" in r.stdout
