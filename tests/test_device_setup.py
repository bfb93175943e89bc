"""Process hygiene: the compile-cache directory and import side effects."""

import os
import subprocess
import sys

import pytest

from rafft_tpu import jax_setup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("environ,want", [
    ({}, jax_setup.REPO_CACHE),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, jax_setup.REPO_CACHE),
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}, None)])
def test_cache_dir_choice(environ, want):
    assert jax_setup.cache_dir(environ) == want


def test_repo_cache_is_fixed_and_ignored():
    assert jax_setup.REPO_CACHE == jax_setup.REPO_CACHE.parent / ".jax_cache"
    assert os.path.samefile(jax_setup.REPO_CACHE.parent, ROOT)
    with open(os.path.join(ROOT, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def _run(code, **env):
    full = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=full,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("module", [
    "rafft_tpu.engine.fold_jax", "rafft_tpu.mfe.mfe_jax",
    "rafft_tpu.parallel.sweep", "rafft_tpu.engine.wavefront"])
def test_import_initialises_no_backend(module):
    out = _run(f"import {module}\n"
               "from jax._src import xla_bridge\n"
               "print(xla_bridge.backends_are_initialized())")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-1] == "False"


@pytest.mark.parametrize("env_dir", [None, "env"])
def test_cache_lands_where_chosen(tmp_path, env_dir):
    """Compiled programs are written to $JAX_COMPILATION_CACHE_DIR when it
    is set, else to the checkout's .jax_cache."""
    code = ("import os, rafft_tpu.jax_setup, jax, jax.numpy as jnp\n"
            "jax.config.update('jax_persistent_cache_min_compile_time_secs',"
            " 0)\n"
            "jax.jit(lambda x: x * 3 + 1)(jnp.arange(7.0)).block_until_ready()\n"
            "d = jax.config.jax_compilation_cache_dir\n"
            "print(d, len(os.listdir(d)))")
    env = {}
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    out = _run(code, **env)
    assert out.returncode == 0, out.stderr[-2000:]
    where, count = out.stdout.split()[-2:]
    assert where == env.get("JAX_COMPILATION_CACHE_DIR",
                            str(jax_setup.REPO_CACHE))
    assert int(count) > 0


def test_refold_pool_workers_stay_on_cpu(monkeypatch):
    """The CPU refold pool's processes never open the accelerator, whatever
    the parent's JAX_PLATFORMS; the parent's setting is left as it was."""
    from rafft_tpu.parallel.sweep import refold_pool

    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    with refold_pool(2) as pool:
        seen = pool.map(os.getenv, ["JAX_PLATFORMS"] * 4)
    assert seen == ["cpu"] * 4
    assert os.environ["JAX_PLATFORMS"] == "cuda"
