"""The backend-choice table, precision at every contraction, the
compilation-cache directory, and the Triton wrapper's launch mode."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ecrad_tpu import backend, jax_setup


@pytest.mark.parametrize("platform", ["cpu", "gpu", "rocm"])
def test_choices_table(platform, monkeypatch):
    monkeypatch.delenv("ECRAD_TPU_ADDING", raising=False)
    monkeypatch.delenv("ECRAD_TPU_FORCE_ONEHOT", raising=False)
    if platform == "rocm":
        with pytest.raises(NotImplementedError, match="cpu, gpu"):
            backend.choices(platform)
        return
    c = backend.choices(platform)
    want = {"cpu": ("scan", "cln", "gather", "dynamic", True),
            "gpu": ("triton", "knl", "gather", "masked", False)}[platform]
    assert tuple(c) == want
    # the A/B switch moves the layout with the sweeps
    monkeypatch.setenv("ECRAD_TPU_ADDING", "scan")
    assert backend.choices(platform)[:2] == ("scan", "cln")
    monkeypatch.setenv("ECRAD_TPU_ADDING", "triton")
    assert backend.choices(platform)[:2] == ("triton", "knl")
    monkeypatch.setenv("ECRAD_TPU_FORCE_ONEHOT", "1")
    assert backend.choices(platform).interp == "onehot"
    monkeypatch.setenv("ECRAD_TPU_ADDING", "pallas")
    with pytest.raises(ValueError, match="ECRAD_TPU_ADDING"):
        backend.choices(platform)


def _dot_precisions(jaxpr):
    """(dtype, precision) of every dot_general in a jaxpr, recursing into
    sub-jaxprs (scan/while/cond/pjit/custom rules/pallas_call)."""
    found = []

    def subs(v):
        if hasattr(v, "eqns"):
            yield v
        elif hasattr(v, "jaxpr") and hasattr(v.jaxpr, "eqns"):
            yield v.jaxpr
        elif isinstance(v, (list, tuple)):
            for x in v:
                yield from subs(x)

    def walk(j):
        for eqn in j.eqns:
            if eqn.primitive.name == "dot_general":
                found.append((eqn.invars[0].aval.dtype,
                              eqn.params["precision"]))
            for v in eqn.params.values():
                for s in subs(v):
                    walk(s)

    walk(jaxpr.jaxpr)
    return found


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_flagship_contractions_are_highest(platform, monkeypatch):
    """Every floating-point contraction of the flagship step names
    Precision.HIGHEST (never TF32 or bf16 passes), on both backends'
    paths, whatever entry point configured JAX.  (Traced in float64, as
    the test session runs with x64 on; the precision named at each
    contraction does not depend on the dtype.)"""
    import __graft_entry__ as ge
    monkeypatch.delenv("ECRAD_TPU_ADDING", raising=False)
    monkeypatch.setitem(backend._TABLE, "cpu", backend._TABLE[platform])
    step, args = ge._build(ncol=4, dtype="float64")
    found = _dot_precisions(jax.make_jaxpr(step)(*args))
    assert found, "the flagship step has contractions"
    highest = jax.lax.Precision.HIGHEST
    bad = [(dt, p) for dt, p in found
           if jnp.issubdtype(dt, jnp.floating)
           and (p is None or any(x != highest for x in
                                 (p if isinstance(p, tuple) else (p,))))]
    assert not bad, bad


def test_cache_dir_from_environment(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is used and
    the code sets no other."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jax_setup.enable_persistent_cache() == str(tmp_path)
    assert jax_setup.cache_dir() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_default_in_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert jax_setup.enable_persistent_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert os.path.isdir(want)


def test_triton_wrapper_compiles_off_cpu(monkeypatch):
    """Off the CPU the wrapper asks for compiled Triton kernels, never
    interpret mode."""
    from ecrad_tpu.solvers import triton_mcica

    calls = []

    def fake_pallas_call(kernel, *, grid, out_shape, backend, interpret,
                         compiler_params):
        calls.append((backend, interpret))
        return lambda *args: tuple(jnp.zeros(s.shape, s.dtype)
                                   for s in out_shape)

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(triton_mcica.pl, "pallas_call", fake_pallas_call)
    nlev, ng, ncol, nband = 3, 20, 5, 4
    z = lambda *s: jnp.zeros(s, jnp.float32)
    band = np.arange(ng) % nband
    triton_mcica.lw_sweeps(z(nlev, ng, ncol), z(nlev, nband, ncol),
                           z(nlev, nband, ncol), z(nlev, nband, ncol),
                           z(nlev, ng, ncol), z(nlev, ncol),
                           z(nlev + 1, ng, ncol), z(ng, ncol), z(ng, ncol),
                           band, True)
    triton_mcica.sw_sweeps(z(nlev, ng, ncol), z(nlev, ng, ncol),
                           z(nlev, ng, ncol), z(nlev, nband, ncol),
                           z(nlev, nband, ncol), z(nlev, nband, ncol),
                           z(nlev, ng, ncol), z(nlev, ncol), z(ncol),
                           z(ng, ncol), z(ng, ncol), z(ng, ncol), band,
                           False)
    assert len(calls) == 5
    assert all(c == ("triton", False) for c in calls), calls


def test_block_size_for_fills_device_memory():
    """The builder's column block: the largest power of two whose step
    fits the device's memory share, capped at ncol; a device without a
    memory limit is an error, not a default."""
    from types import SimpleNamespace

    from ecrad_tpu import pipeline

    cfg = SimpleNamespace(n_g_sw=112, n_g_lw=140)
    per_col = pipeline.STEP_BYTES_PER_COLUMN_LEVEL_G * 137 * 4 * 252
    limit = 20000 * per_col / pipeline.BLOCK_MEMORY_FILL
    dev = SimpleNamespace(memory_stats=lambda: {"bytes_limit": limit})
    assert pipeline.block_size_for(cfg, 32768, 137, 4, dev) == 16384
    assert pipeline.block_size_for(cfg, 3000, 137, 4, dev) == 2048
    assert pipeline.block_size_for(cfg, 32768, 137, 8, dev) == 8192
    with pytest.raises(ValueError, match="memory limit"):
        pipeline.block_size_for(
            cfg, 32768, 137, 4, SimpleNamespace(memory_stats=lambda: None))
