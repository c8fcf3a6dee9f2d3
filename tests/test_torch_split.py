"""Port parity: split finding (numerical path).

Identical float histograms must give bit-identical splits: the port's
``_cumsum_bins`` reproduces the order in which XLA's CPU backend sums
``jnp.cumsum`` (16-wide blocks), and every other operation is the same
element-wise expression. The JAX side runs jitted and vmapped over
leaves, as grow_tree runs it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import split as js
from lightgbm_tpu_torch.ops import split as ts


@pytest.mark.parametrize("B", [8, 16, 24, 40, 64, 128, 200, 256, 264])
def test_cumsum_bins_matches_xla_order(B):
    rng = np.random.default_rng(B)
    x = (rng.normal(size=(3, 28, B, 3))
         * rng.uniform(0.1, 100, size=(3, 28, 1, 1))).astype(np.float32)
    ref = np.asarray(jax.jit(jax.vmap(js._cumsum_bins))(jnp.asarray(x)))
    out = ts._cumsum_bins(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out.view(np.uint32), ref.view(np.uint32))


def _hists(C, F, B, seed):
    rng = np.random.default_rng(seed)
    nb = rng.integers(4, B + 1, size=F).astype(np.int32)
    has_nan = rng.random(F) < 0.3
    g = rng.normal(size=(C, F, B)) * 3
    h = rng.uniform(0.01, 2.0, size=(C, F, B))
    c = rng.integers(0, 40, size=(C, F, B)).astype(np.float64)
    hist = np.stack([g, h, c], -1).astype(np.float32)
    hist *= (np.arange(B)[None, :] < nb[:, None])[None, :, :, None]
    sums = hist[:, 0].sum(axis=1)                     # [C, 3]
    allowed = rng.random((C, F)) < 0.9
    return hist, sums, nb, has_nan, allowed


CFGS = [dict(min_data_in_leaf=5),
        dict(lambda_l1=0.5, lambda_l2=1.0, min_data_in_leaf=20,
             min_sum_hessian_in_leaf=0.5),
        dict(min_gain_to_split=0.3, max_delta_step=0.7, min_data_in_leaf=1)]


@pytest.mark.parametrize("cfg", CFGS)
@pytest.mark.parametrize("B", [64, 256])
def test_find_best_split_bit_equal(cfg, B):
    hist, sums, nb, hn, allowed = _hists(16, 12, B, seed=B)
    jcfg, tcfg = js.SplitConfig(**cfg), ts.SplitConfig(**cfg)
    ref = jax.jit(jax.vmap(lambda h, s, a: js.find_best_split(
        h, s, jnp.asarray(nb), jnp.asarray(hn), a, jcfg)))(
        jnp.asarray(hist), jnp.asarray(sums), jnp.asarray(allowed))
    out = ts.find_best_split(torch.from_numpy(hist), torch.from_numpy(sums),
                             torch.from_numpy(nb), torch.from_numpy(hn),
                             torch.from_numpy(allowed), tcfg)
    assert set(out) <= set(ref)
    for k, v in out.items():
        a, b = np.asarray(ref[k]), v.numpy()
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    pf_ref = jax.jit(jax.vmap(lambda h, s, a: js.per_feature_gains(
        h, s, jnp.asarray(nb), jnp.asarray(hn), a, jcfg)))(
        jnp.asarray(hist), jnp.asarray(sums), jnp.asarray(allowed))
    pf = ts.per_feature_gains(torch.from_numpy(hist), torch.from_numpy(sums),
                              torch.from_numpy(nb), torch.from_numpy(hn),
                              torch.from_numpy(allowed), tcfg)
    np.testing.assert_array_equal(pf.numpy(), np.asarray(pf_ref))


def test_leaf_output_and_gain_bit_equal():
    rng = np.random.default_rng(1)
    g = rng.normal(size=1000).astype(np.float32) * 10
    h = rng.uniform(-0.5, 5, size=1000).astype(np.float32)
    for l1, l2, mds in [(0.0, 0.0, 0.0), (0.3, 2.0, 0.5)]:
        np.testing.assert_array_equal(
            ts.leaf_gain(torch.from_numpy(g), torch.from_numpy(h), l1,
                         l2).numpy(),
            np.asarray(jax.jit(lambda a, b: js.leaf_gain(a, b, l1, l2))(g, h)))
        np.testing.assert_array_equal(
            ts.calc_leaf_output(torch.from_numpy(g), torch.from_numpy(h), l1,
                                l2, mds).numpy(),
            np.asarray(jax.jit(lambda a, b: js.calc_leaf_output(
                a, b, l1, l2, mds))(g, h)))


def test_elect_best_matches_reference():
    hist, sums, nb, hn, allowed = _hists(8, 10, 64, seed=3)
    tcfg = ts.SplitConfig(min_data_in_leaf=3)
    per_dev = [ts.find_best_split(
        torch.from_numpy(hist[d::4]), torch.from_numpy(sums[d::4]),
        torch.from_numpy(nb), torch.from_numpy(hn),
        torch.from_numpy(allowed[d::4]), tcfg) for d in range(4)]
    stacked = {k: torch.stack([d[k] for d in per_dev])  # [D=4, C=2, ...]
               for k in per_dev[0]}
    out = ts.elect_best(stacked)
    ref = jax.vmap(lambda b: js.elect_best(b, "d"), axis_name="d")(
        {k: jnp.asarray(v.numpy()) for k, v in stacked.items()})
    for k, v in out.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k][0]))
