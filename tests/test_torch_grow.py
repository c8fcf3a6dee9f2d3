"""Port parity: tree growth on identical bins and quantized values.

``grow_tree`` of both packages gets the same bins and the same integer
gradient levels (the JAX side as its CPU tests run it, use_pallas=False).
With a power-of-two channel scale every histogram and leaf sum is exact,
so the tree arrays and the per-row leaf ids must be bit-equal — at
leaf_batch 1 and 8, with and without the GOSS compacted buffer.

With a general scale the trees stay structurally equal but float sums
can differ in the last bit: XLA's CPU backend fuses the scale multiply
into the following subtraction (an FMA) in some fusions and not in
others, depending on the fusion XLA picks (the root's right-child sums
always; the sibling subtraction at leaf_batch 8 but not 1), while the
port rounds the product first.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.learner.serial import GrowConfig as JaxGrowConfig
from lightgbm_tpu.learner.serial import grow_tree as jax_grow_tree
from lightgbm_tpu_torch.learner.serial import GrowConfig, grow_tree

EXACT_KEYS = ("num_leaves", "split_feature", "threshold_bin", "default_left",
              "left_child", "right_child", "internal_count", "leaf_count")
POW2_SCALE = np.array([2.0 ** -6, 2.0 ** -5, 1.0], np.float32)


def _data(n=8192, F=12, B=64, seed=0):
    rng = np.random.default_rng(seed)
    nb = rng.integers(8, B + 1, size=F).astype(np.int32)
    has_nan = rng.random(F) < 0.3
    bins = (rng.random((n, F)) * nb[None, :]).astype(np.uint8)
    g = rng.integers(-2, 3, size=n).astype(np.float32)
    h = rng.integers(0, 4, size=n).astype(np.float32)
    m = (rng.random(n) < 0.9).astype(np.float32)
    vals = np.stack([g * m, h * m, m], 1)
    return bins, vals, nb, has_nan


def _grow_both(leaf_batch, compact, scale, L=31, B=64, seed=0,
               partition=False):
    bins, vals, nb, hn = _data(B=B, seed=seed + leaf_batch)
    F = bins.shape[1]
    allowed = np.ones(F, bool)
    jcfg = JaxGrowConfig(num_leaves=L, num_bins=B, rows_per_block=1024,
                         leaf_batch=leaf_batch, hist_compact=compact,
                         min_data_in_leaf=5, partition=partition)
    tcfg = GrowConfig(num_leaves=L, num_bins=B, leaf_batch=leaf_batch,
                      int_hist=True, hist_compact=compact,
                      min_data_in_leaf=5, partition=partition)
    j = dict(chan_scale=jnp.asarray(scale))
    t = dict(chan_scale=torch.from_numpy(scale))
    hv = vals
    if compact:
        idx = np.sort(np.random.default_rng(7).choice(len(bins), 4096,
                                                      replace=False))
        hv = vals[idx]
        j["compact"] = (jnp.asarray(bins[idx]), None, jnp.asarray(hv))
        t["compact_bins_t"] = torch.from_numpy(bins[idx].T.copy())
    jt, jl = jax_grow_tree(jnp.asarray(bins), jnp.asarray(hv),
                           jnp.asarray(nb), jnp.asarray(hn),
                           jnp.asarray(allowed), jcfg, **j)
    tt, tl = grow_tree(torch.from_numpy(bins.T.copy()), torch.from_numpy(hv),
                       torch.from_numpy(nb), torch.from_numpy(hn),
                       torch.from_numpy(allowed), tcfg, **t)
    return ({k: np.asarray(v) for k, v in jt.items()}, np.asarray(jl),
            {k: np.asarray(v.cpu() if torch.is_tensor(v) else v)
             for k, v in tt.items()}, tl.numpy())


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("leaf_batch", [1, 8])
def test_grow_tree_bit_equal(leaf_batch, compact):
    jt, jl, tt, tl = _grow_both(leaf_batch, compact, POW2_SCALE)
    assert int(tt["num_leaves"]) > 20
    for k, v in tt.items():
        assert v.dtype == jt[k].dtype, k
        np.testing.assert_array_equal(v, jt[k], err_msg=k)
    np.testing.assert_array_equal(tl, jl)


@pytest.mark.parametrize("leaf_batch", [1, 8])
def test_grow_tree_general_scale_same_structure(leaf_batch):
    """Non-power-of-two scales: same structure and leaf ids; leaf sums
    within a few float32 ULPs of the largest sum (the differing roundings
    of ``parent - levels * scale``), outputs and gains, which divide by
    those sums, within 2e-4 relative (see module doc)."""
    scale = np.array([0.013, 0.021, 1.0], np.float32)
    jt, jl, tt, tl = _grow_both(leaf_batch, True, scale)
    for k in EXACT_KEYS:
        np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)
    np.testing.assert_array_equal(tl, jl)
    mag = np.abs(jt["leaf_weight"]).max()
    np.testing.assert_allclose(tt["leaf_weight"], jt["leaf_weight"], rtol=0,
                               atol=8 * np.finfo(np.float32).eps * mag)
    for k in ("leaf_value", "internal_value", "split_gain"):
        np.testing.assert_allclose(tt[k], jt[k], rtol=2e-4, atol=1e-7,
                                   err_msg=k)
