"""The in-repo pytree dataclass and the compile-cache directory rule."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import rgc_slam_tpu
from rgc_slam_tpu.types import ImuBatch, PointCloud
from rgc_slam_tpu.utils import pytree

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytree.dataclass
class _Pair:
    a: jax.Array
    b: jax.Array


def test_replace_returns_changed_copy():
    p = _Pair(a=jnp.zeros(2), b=jnp.ones(3))
    q = p.replace(b=jnp.full(3, 2.0))
    np.testing.assert_array_equal(np.asarray(p.b), np.ones(3))
    np.testing.assert_array_equal(np.asarray(q.b), np.full(3, 2.0))
    assert q.a is p.a
    with pytest.raises(Exception):
        p.a = jnp.ones(2)                      # frozen, like flax.struct


def test_leaves_in_declaration_order():
    cloud = PointCloud.zeros(4)
    leaves = jax.tree.leaves(cloud)
    assert [l.shape for l in leaves] == [(4, 3), (4,), (4,), (4,), (4,)]
    assert [l.dtype for l in leaves][3:] == [jnp.int32, jnp.bool_]
    rebuilt = jax.tree.unflatten(jax.tree.structure(cloud), leaves)
    assert isinstance(rebuilt, PointCloud)


def test_jit_and_vmap_round_trip():
    imu = ImuBatch.zeros(8)

    @jax.jit
    def shift(x: ImuBatch) -> ImuBatch:
        return x.replace(t=x.t + 1.0)

    out = shift(imu)
    assert isinstance(out, ImuBatch)
    np.testing.assert_array_equal(np.asarray(out.t), np.ones(8))
    batched = jax.tree.map(lambda a: jnp.stack([a, a]), imu)
    outs = jax.vmap(shift)(batched)
    assert outs.acc.shape == (2, 8, 3) and isinstance(outs, ImuBatch)


def _cache_dir(env_value):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = ("import jax, rgc_slam_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, check=True, timeout=120)
    return r.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("env_value", [None, "/elsewhere/jax-cache"])
def test_compile_cache_directory(env_value):
    """JAX_COMPILATION_CACHE_DIR wins; otherwise one fixed, git-ignored
    directory inside the checkout."""
    got = _cache_dir(env_value)
    if env_value is not None:
        assert got == env_value
        return
    assert got == rgc_slam_tpu.CACHE_DIR
    path = pathlib.Path(got)
    assert path.parent == ROOT
    ignored = (ROOT / ".gitignore").read_text().split()
    assert f"{path.name}/" in ignored


def test_tests_keep_the_cache_off():
    """The CPU test run writes nothing into the checkout's cache."""
    assert not jax.config.jax_enable_compilation_cache
