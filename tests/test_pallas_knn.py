"""Pallas Triton k-NN kernel vs the XLA reference formulation (interpret mode
on the CPU; the compiled kernel runs in the ``gpu``-marked tests below and in
``python chip_smoke.py`` on the card)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rgc_slam_tpu.ops import knn as knn_ops
from rgc_slam_tpu.ops.pallas.knn_kernel import _splits, kernel_pays, knn_triton


def _cloud(rng, Q, N, lo=-10, hi=10, keep=0.9, lead=()):
    q = jnp.asarray(rng.uniform(lo, hi, lead + (Q, 3)), jnp.float32)
    p = jnp.asarray(rng.uniform(lo, hi, lead + (N, 3)), jnp.float32)
    m = jnp.asarray(rng.random(lead + (N,)) < keep)
    return q, p, m


@pytest.mark.parametrize("Q,N,K", [(200, 512, 5), (64, 256, 1), (130, 384, 3),
                                   (128, 8192, 5),   # multi point-tile path
                                   (96, 5000, 4),    # ragged tile padding
                                   (100, 640, 20),   # k=20 (gicp/normals path)
                                   (37, 1001, 5),    # ragged queries and points
                                   (16, 257, 1)])    # one point past a tile
def test_matches_xla_reference(rng, Q, N, K):
    q, p, m = _cloud(rng, Q, N)
    d_ref, i_ref = knn_ops.knn_xla(q, p, m, K)
    d_k, i_k = knn_triton(q, p, m, K, interpret=True)
    np.testing.assert_allclose(np.asarray(d_ref), np.asarray(d_k), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(i_ref), np.asarray(i_k))


def test_all_masked(rng):
    q, p, _ = _cloud(rng, 64, 128, -1, 1)
    m = jnp.zeros(128, bool)
    d, i = knn_triton(q, p, m, 5, interpret=True)
    assert np.isinf(np.asarray(d)).all()
    # indices stay in [0, n) for unfilled slots: a consumer gating on
    # mask[idx] then reads a real masked column, exactly like the XLA path
    _, i_ref = knn_ops.knn_xla(q, p, m, 5)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))


def test_fewer_valid_than_k(rng):
    """Masked points fill the slots past the valid ones, lowest index first,
    as XLA's top_k orders +inf columns."""
    q, p, _ = _cloud(rng, 32, 300)
    m = jnp.zeros(300, bool).at[jnp.array([7, 150, 299])].set(True)
    d_ref, i_ref = knn_ops.knn_xla(q, p, m, 5)
    d_k, i_k = knn_triton(q, p, m, 5, interpret=True)
    np.testing.assert_array_equal(np.asarray(i_ref), np.asarray(i_k))
    np.testing.assert_allclose(np.asarray(d_ref), np.asarray(d_k), atol=1e-4)


def test_ties_go_to_lower_index(rng):
    """Every point appears four times: equal distances must come back in
    ascending index order, across tiles and segments."""
    base = rng.uniform(-1, 1, (100, 3))
    p = jnp.asarray(np.repeat(base, 4, axis=0), jnp.float32)
    q = jnp.asarray(rng.uniform(-1, 1, (48, 3)), jnp.float32)
    m = jnp.ones(400, bool)
    _, i_ref = knn_ops.knn_xla(q, p, m, 6)
    for tn, min_blocks in [(128, 1), (16, 64)]:
        _, i_k = knn_triton(q, p, m, 6, tn=tn, min_blocks=min_blocks,
                            interpret=True)
        np.testing.assert_array_equal(np.asarray(i_ref), np.asarray(i_k))


def test_point_segments_merge(rng):
    """The point axis split over several blocks per query tile (the
    single-stream layout on the card) gives the one-segment answer."""
    q, p, m = _cloud(rng, 32, 2000)
    assert _splits(32 // 16, -(-2000 // 128), 64) > 1
    d1, i1 = knn_triton(q, p, m, 5, tn=128, min_blocks=1, interpret=True)
    d2, i2 = knn_triton(q, p, m, 5, tn=128, min_blocks=64, interpret=True)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))


def test_vmapped_fleet(rng):
    """Under vmap (the fleet) the robot axis becomes a grid axis."""
    q, p, m = _cloud(rng, 40, 300, lead=(3,))
    f = lambda a, b, c: knn_triton(a, b, c, 5, interpret=True)
    d_k, i_k = jax.vmap(f)(q, p, m)
    d_r, i_r = jax.vmap(lambda a, b, c: knn_ops.knn_xla(a, b, c, 5))(q, p, m)
    np.testing.assert_allclose(np.asarray(d_r), np.asarray(d_k), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(i_r), np.asarray(i_k))


def test_supported_gate():
    """The shape gate, and the CPU never taking the kernel."""
    assert kernel_pays(2048, 32768, 5)
    assert kernel_pays(1024, 8192, 5)
    assert kernel_pays(256, 1024, 5)            # the measured crossover
    assert not kernel_pays(128, 512, 5)         # too small to pay off
    assert not kernel_pays(2048, 32768, 24)     # k past the sweep budget
    assert jax.default_backend() == "cpu"
    assert not knn_ops.use_kernel(2048, 32768, 5)


def test_knn_dispatch_on_cpu_is_xla(rng):
    q, p, m = _cloud(rng, 50, 700)
    d, i = knn_ops.knn(q, p, m, 5)
    d_r, i_r = knn_ops.knn_xla(q, p, m, 5)
    np.testing.assert_array_equal(np.asarray(d), np.asarray(d_r))
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_r))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["mapping", "fleet_mapping", "loop_icp"])
def test_kernel_at_real_widths(gpu_device, shape):
    """The compiled kernel at the pipeline's widths vs XLA on the card."""
    import chip_smoke

    qn, n, k, b = chip_smoke.KNN_SHAPES[shape]
    chip_smoke.check_knn_kernel(qn, n, k, b)


@pytest.mark.gpu
def test_float32_products_on_card(gpu_device):
    """The pinned matmul precision gives true float32 distances (no TF32)."""
    import chip_smoke

    r = chip_smoke.float32_check()
    assert r["max_err_m2"] < r["bound_m2"], r
