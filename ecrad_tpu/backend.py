"""Implementation choices per JAX platform.

Every place where the code takes a different path on a different device
asks :func:`choices`; nothing else tests ``jax.default_backend()``.

* ``sweeps`` — the McICA solver sweeps: ``"triton"`` runs the fused
  Pallas kernels of ``solvers/triton_mcica.py``; ``"scan"`` the
  ``lax.scan`` recurrences of ``solvers/adding.py`` (the reference's
  operation order); ``"assoc"`` the parallel-prefix form of the same
  recurrences.  ``ECRAD_TPU_ADDING`` overrides the table (A/B timing).
* ``layout`` — ``"knl"`` ((nlev, ng, ncol), columns contiguous) where
  the fused kernels consume the gas optics and cloud sample directly;
  ``"cln"`` ((ncol, nlev, ng)) otherwise.  It follows ``sweeps``.
* ``interp`` — RRTMG table interpolation and band expansion:
  ``"gather"`` (exact) or ``"onehot"`` (a 0/1 matrix product at HIGHEST
  precision over level windows).  ``ECRAD_TPU_FORCE_ONEHOT=1`` selects
  the one-hot form.
* ``expm_squarings`` — ``"dynamic"`` (a while loop over the batch-max
  squaring count) or ``"masked"`` (a fixed chain of masked squarings,
  no loop condition read back per trip).
* ``interpret`` — whether Pallas kernels run in interpret mode (only
  where there is no accelerator to compile them for).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import jax


class Choices(NamedTuple):
    sweeps: str
    layout: str
    interp: str
    expm_squarings: str
    interpret: bool


_TABLE = {
    "cpu": Choices(sweeps="scan", layout="cln", interp="gather",
                   expm_squarings="dynamic", interpret=True),
    "gpu": Choices(sweeps="triton", layout="knl", interp="gather",
                   expm_squarings="masked", interpret=False),
}

_SWEEPS = ("triton", "scan", "assoc")


def choices(platform: str = None) -> Choices:
    """The implementation choices for ``platform`` (default: JAX's
    default backend), after the environment overrides.  Raises for a
    platform without a table entry."""
    platform = platform or jax.default_backend()
    if platform not in _TABLE:
        raise NotImplementedError(
            f"no implementation choices for platform {platform!r}; "
            f"supported: {', '.join(sorted(_TABLE))}")
    c = _TABLE[platform]
    sweeps = os.environ.get("ECRAD_TPU_ADDING", "").lower() or c.sweeps
    if sweeps not in _SWEEPS:
        raise ValueError(f"ECRAD_TPU_ADDING={sweeps!r}; expected one of "
                         f"{', '.join(_SWEEPS)}")
    interp = c.interp
    if os.environ.get("ECRAD_TPU_FORCE_ONEHOT", "0") not in ("", "0"):
        interp = "onehot"
    return c._replace(sweeps=sweeps,
                      layout="knl" if sweeps == "triton" else "cln",
                      interp=interp)
