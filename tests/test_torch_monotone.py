"""Port parity: monotone constraints, from the split search to the model.

- ``find_best_split`` with ``mono`` (+1, -1 and 0 features, some with a
  NaN bin), per-leaf output ranges (unbounded, one-sided, two-sided and
  tight ones that clip most candidates) and ``monotone_penalty`` at leaf
  depths 0-5 (0: none; 1: the ``f_small`` branch; 3: ``f_large``), on
  random histograms, with and without categorical features (their gains
  are taken at clipped outputs; they carry no direction): the same
  features, thresholds, directions, left sums and bitsets, bit for bit,
  as the reference's jitted search, and the same gains within 2e-5
  relative. The bounded gain ``2 t o + (h + l2) o^2`` is where XLA's CPU
  backend contracts a product into a fused multiply-add, and it does so
  per fusion: the argmax's evaluation of the candidates contracts the
  first product (the port's ``leaf_gain_at_output`` does the same, and
  its candidate gains equal the reference's bit for bit), while the
  evaluation that reads back the winner's gain, and the ones inside
  ``grow_tree``'s loop, contract otherwise or not at all. So the
  reference's recorded gain is not one function of its inputs, and an
  ULP of the terms that cancel in ``gain_l + gain_r - gain_parent`` is
  up to 8.4e-6 of the gain;
- ``grow_tree`` with the basic and the intermediate method at leaf batch
  1 and 8 (at 8 the intermediate method's batch race guard is live: one
  round splits leaves on both sides of a constrained node), on integer
  gradient levels at a power-of-two scale: identical tree arrays (split
  gains within 2e-5, as above; leaf and internal values, counts and
  structure bit for bit) and leaf ids;
- end to end with +1 and -1 constraints (basic; intermediate at leaf
  batch 8; basic with ``monotone_penalty`` 1), the reference's draws
  replayed: the same split lines, holdout predictions within 1e-5, and
  the response to each constrained feature over a 201-point grid at 5
  rows moves only in its direction.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu.ops.split as js
from lightgbm_tpu.learner.serial import GrowConfig as JaxGrowConfig
from lightgbm_tpu.learner.serial import grow_tree as jax_grow_tree
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.learner.serial import GrowConfig, grow_tree
from lightgbm_tpu_torch.ops import split as ts
from test_torch_grow import POW2_SCALE, _data
from test_torch_regression import _one_torch_thread, tree_split_lines  # noqa
from test_torch_split import _hists
from test_torch_train import JaxReplayNoise, _reference_metrics_off  # noqa

TOL = 1e-5
# XLA contracts the bounded gain's products into fused multiply-adds
# differently in each fusion that evaluates it; an ULP of the children's
# and the parent's terms, which cancel in the gain, reaches 8.4e-6 of it
GAIN_RTOL = 2e-5


# ---- split search -----------------------------------------------------------
def _assert_gains_close(got, want):
    """Bounded gains: the same winners, their gains within GAIN_RTOL (see
    the module docstring)."""
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=GAIN_RTOL, atol=0)


def _bounds(C, seed):
    """Per-leaf output ranges: unbounded, lower only, upper only, both,
    and tight ranges around 0 that clip most candidate outputs."""
    rng = np.random.default_rng(seed)
    lo = np.full(C, -np.inf, np.float32)
    hi = np.full(C, np.inf, np.float32)
    kind = np.arange(C) % 5
    lo[kind == 1] = rng.normal(size=(kind == 1).sum()) * 0.5
    hi[kind == 2] = rng.normal(size=(kind == 2).sum()) * 0.5
    a = rng.normal(size=(kind == 3).sum()) * 0.5
    lo[kind == 3], hi[kind == 3] = a - 0.3, a + 0.3
    lo[kind == 4], hi[kind == 4] = -0.02, 0.03
    return lo, hi


@pytest.mark.parametrize("penalty", [0.0, 1.0, 3.0])
@pytest.mark.parametrize("categorical", [False, True])
def test_find_best_split_bounded_bit_equal(categorical, penalty):
    C, F, B = 20, 12, 64
    hist, sums, nb, hn, allowed = _hists(C, F, B, seed=3)
    mono = np.array([1, -1, 0, 1, 0, -1, 1, 0, 0, -1, 1, 0], np.int8)
    is_cat = np.zeros(F, bool)
    if categorical:
        is_cat[[2, 7]] = True
        hn = hn & ~is_cat
    lo, hi = _bounds(C, seed=4)
    depth = (np.arange(C) % 6).astype(np.int32)
    kw = dict(min_data_in_leaf=5, lambda_l2=0.5, has_monotone=True,
              monotone_penalty=penalty, has_categorical=categorical,
              max_cat_to_onehot=4, min_data_per_group=5)
    jcfg = js.SplitConfig(**kw, cat_positions=(
        tuple(int(i) for i in np.flatnonzero(is_cat)) if categorical
        else ()))
    tcfg = ts.SplitConfig(**kw)
    ref = jax.jit(jax.vmap(lambda h, s, a, l_, u, d: js.find_best_split(
        h, s, jnp.asarray(nb), jnp.asarray(hn), a, jcfg,
        is_cat=jnp.asarray(is_cat), mono=jnp.asarray(mono), out_lower=l_,
        out_upper=u, depth=d)))(
        jnp.asarray(hist), jnp.asarray(sums), jnp.asarray(allowed),
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(depth))
    t = torch.from_numpy
    out = ts.find_best_split(
        t(hist), t(sums), t(nb), t(hn), t(allowed), tcfg,
        is_cat=t(is_cat) if categorical else None,
        cat_idx=t(np.flatnonzero(is_cat)) if categorical else None,
        mono=t(mono), out_lower=t(lo), out_upper=t(hi), depth=t(depth))
    gains = out["gain"].numpy()
    # bounds and vetoes bite: some leaves keep a split, and the winners
    # differ from the unconstrained search's
    assert np.isfinite(gains).sum() >= C // 2
    free = ts.find_best_split(t(hist), t(sums), t(nb), t(hn), t(allowed),
                              ts.SplitConfig(min_data_in_leaf=5,
                                             lambda_l2=0.5))
    assert (free["threshold_bin"] != out["threshold_bin"]).any()
    for k, v in out.items():
        a = np.asarray(ref[k])
        if k == "cat_bitset":
            a = a.astype(np.int64)
        b = v.numpy()
        assert a.shape == b.shape, k
        if k == "gain":
            _assert_gains_close(b, a)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


def test_penalty_factor_bit_equal():
    d = np.arange(8, dtype=np.int32)
    for pen in (0.5, 1.0, 2.0, 3.0, 6.0):
        want = np.asarray(jax.jit(lambda x: js.monotone_penalty_factor(
            x, pen))(jnp.asarray(d)))
        got = ts.monotone_penalty_factor(torch.from_numpy(d), pen).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(pen))


# ---- tree growth ------------------------------------------------------------
@pytest.mark.parametrize("intermediate", [False, True])
@pytest.mark.parametrize("leaf_batch", [1, 8])
def test_grow_tree_monotone_bit_equal(leaf_batch, intermediate):
    L, B = 31, 64
    bins, vals, nb, hn = _data(B=B, seed=11 + leaf_batch)
    F = bins.shape[1]
    # gradients that follow features 0 (up) and 1 (down) closely, so the
    # constraints bind at many nodes
    rng = np.random.default_rng(leaf_batch)
    trend = (bins[:, 0].astype(np.float32) / nb[0]
             - bins[:, 1].astype(np.float32) / nb[1])
    g = np.round(-4 * trend + rng.normal(size=len(bins))).clip(-6, 6)
    vals = vals.copy()
    vals[:, 0] = g * vals[:, 2]
    mono = np.zeros(F, np.int8)
    mono[[0, 3]] = 1
    mono[[1, 5]] = -1
    allowed = np.ones(F, bool)
    kw = dict(num_leaves=L, num_bins=B, leaf_batch=leaf_batch,
              min_data_in_leaf=5, has_monotone=True,
              monotone_intermediate=intermediate)
    jt, jl = jax_grow_tree(jnp.asarray(bins), jnp.asarray(vals),
                           jnp.asarray(nb), jnp.asarray(hn),
                           jnp.asarray(allowed),
                           JaxGrowConfig(rows_per_block=1024, **kw),
                           mono=jnp.asarray(mono),
                           chan_scale=jnp.asarray(POW2_SCALE))
    tt, tl = grow_tree(torch.from_numpy(bins.T.copy()), torch.from_numpy(vals),
                       torch.from_numpy(nb), torch.from_numpy(hn),
                       torch.from_numpy(allowed),
                       GrowConfig(int_hist=True, **kw),
                       chan_scale=torch.from_numpy(POW2_SCALE),
                       mono=torch.from_numpy(mono))
    assert int(tt["num_leaves"]) > 20
    used = np.asarray(jt["split_feature"])[:int(tt["num_leaves"]) - 1]
    assert np.isin(used, [0, 1, 3, 5]).sum() >= 3
    for k, v in tt.items():
        got = np.asarray(v.cpu() if torch.is_tensor(v) else v)
        want = np.asarray(jt[k])
        assert got.dtype == want.dtype, k
        if k == "split_gain":
            _assert_gains_close(got, want)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


# ---- end to end -------------------------------------------------------------
N_TRAIN, N_HOLD, N_FEAT, ROUNDS = 3000, 500, 8, 8
BASE = {"objective": "regression", "num_leaves": 15, "max_bin": 63,
        "learning_rate": 0.3, "use_quantized_grad": True,
        "monotone_constraints": [1, -1, 0, 0, 0, 0, 0, 0],
        "verbosity": -1}
CASES = {
    "basic": {"tpu_leaf_batch": 4},
    "intermediate": {"monotone_constraints_method": "intermediate",
                     "tpu_leaf_batch": 8},
    "penalty": {"monotone_penalty": 1.0, "tpu_leaf_batch": 4},
}


def _mono_data(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N_TRAIN + N_HOLD, N_FEAT))
    y = (2 * X[:, 0] - np.sin(2 * X[:, 1]) - X[:, 1] + np.abs(X[:, 2])
         + 0.5 * X[:, 3] * X[:, 0] + rng.normal(scale=0.5, size=len(X)))
    return X, y


@pytest.mark.parametrize("case", list(CASES))
def test_monotone_matches_reference(case):
    X, y = _mono_data()
    params = dict(BASE, **CASES[case])
    ref = lgb.train(dict(params), lgb.Dataset(X[:N_TRAIN],
                                              label=y[:N_TRAIN]),
                    num_boost_round=ROUNDS)
    port = lgt.train(dict(params, device_type="cpu"),
                     lgt.Dataset(X[:N_TRAIN], label=y[:N_TRAIN]),
                     num_boost_round=ROUNDS,
                     noise=JaxReplayNoise(Config({}).objective_seed))
    assert port.engine.has_monotone
    got = tree_split_lines(port.model_to_string())
    want = tree_split_lines(ref.model_to_string())
    assert got == want
    Xv = X[N_TRAIN:]
    np.testing.assert_allclose(port.predict(Xv), ref.predict(Xv), rtol=0,
                               atol=TOL)
    grid = np.linspace(-3.0, 3.0, 201)
    for f, sign in ((0, 1.0), (1, -1.0)):
        Z = np.repeat(Xv[:5], len(grid), axis=0)
        Z[:, f] = np.tile(grid, 5)
        resp = port.predict(Z).reshape(5, len(grid))
        assert (sign * np.diff(resp, axis=1)).min() >= -1e-6
        assert np.ptp(resp) > 0.5
