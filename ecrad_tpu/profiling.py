"""Dr-Hook-equivalent tracing/profiling.

The reference brackets every subroutine with
``if (lhook) call dr_hook('module:proc', 0/1, handle)`` and, when linked
against ECMWF fiat and activated by the env var ``DR_HOOK=1``, prints a
call-tree wall-clock profile at exit (drhook/yomhook_dummy.F90:14-39;
activation protocol test/ifs/Makefile:175-192).

Equivalent here, two layers:

* ``hook(name)`` — host-side span: wall-clock accumulation per name +
  a ``jax.profiler.TraceAnnotation`` so spans appear on the xprof/
  perfetto timeline.  Near-zero cost when disabled (one dict lookup).
  Activated by env ``DR_HOOK=1`` (same convention as the reference) or
  programmatically with ``enable()``.
* ``scope(name)`` — ``jax.named_scope`` for *traced* code: names the
  HLO ops of a region so XLA profiles attribute device time to the same
  ``module:proc`` labels the reference uses.  Free at run time.

``print_profile()`` renders the accumulated table like a Dr Hook
profile (sorted by self-time share).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Dict, Tuple

_enabled = os.environ.get("DR_HOOK", "0") not in ("", "0", "false",
                                                  "no", "off")
# name -> [ncalls, total_seconds]
_registry: Dict[str, list] = {}
_t_origin = time.time()


def enable(on: bool = True):
    global _enabled, _t_origin
    _enabled = on
    _t_origin = time.time()


def enabled() -> bool:
    return _enabled


def reset():
    _registry.clear()
    global _t_origin
    _t_origin = time.time()


@contextlib.contextmanager
def hook(name: str):
    """Host-side profiling span (dr_hook equivalent)."""
    if not _enabled:
        yield
        return
    import jax.profiler
    entry = _registry.setdefault(name, [0, 0.0])
    t0 = time.perf_counter()
    with jax.profiler.TraceAnnotation(name):
        try:
            yield
        finally:
            entry[0] += 1
            entry[1] += time.perf_counter() - t0


def scope(name: str):
    """jax.named_scope for traced regions (always on, zero run cost)."""
    import jax
    return jax.named_scope(name)


def traced(name: str):
    """Decorator: run the function under a jax.named_scope so its HLO
    ops carry the reference's module:proc label in device profiles."""
    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with scope(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def get_profile() -> Dict[str, Tuple[int, float]]:
    return {k: (v[0], v[1]) for k, v in _registry.items()}


def print_profile(file=None):
    """Dr-Hook-style profile table (sorted by total walltime)."""
    file = file or sys.stdout
    if not _registry:
        return
    wall = max(time.time() - _t_origin, 1e-9)
    rows = sorted(_registry.items(), key=lambda kv: -kv[1][1])
    print("", file=file)
    print("Profiling information (DR_HOOK=1):", file=file)
    print(f"  {'%time':>6} {'cumul(s)':>10} {'self(s)':>10} "
          f"{'#calls':>8} {'s/call':>10}  routine", file=file)
    for name, (ncalls, total) in rows:
        print(f"  {100.0 * total / wall:6.2f} {total:10.4f} "
              f"{total:10.4f} {ncalls:8d} {total / max(ncalls, 1):10.5f}"
              f"  {name}", file=file)
    print(f"  wall-clock since profile start: {wall:.4f} s", file=file)
