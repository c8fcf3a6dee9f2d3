"""Port parity: bagging and per-tree feature_fraction.

Both packages draw these masks on the host from
``numpy.random.RandomState(bagging_seed / feature_fraction_seed)``, so the
port's masks must equal the JAX engine's draw for draw. End to end, the
full-row configuration with bagging, feature_fraction, quantized
gradients and the row partition forced on trains in both packages at test
size (20k rows, 31 leaves, leaf_batch 8) with the JAX package's noise
replayed into the port: the same first tree, and holdout AUC within 1e-3
(gradients differ by float32 ULPs; tests/test_torch_train.py).
"""
import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from test_torch_train import EXACT, JaxReplayNoise, synth_higgs

PARAMS = {"objective": "binary", "num_leaves": 31, "max_bin": 255,
          "learning_rate": 0.1, "use_quantized_grad": True,
          "stochastic_rounding": True, "bagging_fraction": 0.8,
          "bagging_freq": 1, "feature_fraction": 0.8, "tpu_leaf_batch": 8,
          "tpu_hist_partition": "true", "metric": "auc", "verbosity": -1}
ROUNDS = 10


@pytest.fixture(autouse=True, scope="module")
def _reference_metrics_off():
    """Keep this module's runs of the JAX package out of that package's
    process-global metrics registry, which other test files read."""
    from lightgbm_tpu import obs
    was = obs.enabled()
    obs.disable()
    yield
    if was:
        obs.enable()


def _engines(params, n=3000, f=10):
    X, y = synth_higgs(n, f, seed=3)
    ref = lgb.Booster(params=dict(params), train_set=lgb.Dataset(X, label=y))
    port = lgt.Booster(params=dict(params, device_type="cpu"),
                       train_set=lgt.Dataset(X, label=y))
    return ref.engine, port.engine


@pytest.mark.parametrize("extra", [
    {"bagging_fraction": 0.7, "bagging_freq": 1},
    {"bagging_fraction": 0.5, "bagging_freq": 3, "bagging_seed": 11},
    {"pos_bagging_fraction": 0.6, "neg_bagging_fraction": 0.9,
     "bagging_freq": 2},
    {"bagging_fraction": 1.0, "bagging_freq": 1},
], ids=["plain", "freq3_seed11", "pos_neg", "off"])
def test_bagging_masks_equal(extra):
    ref, port = _engines({"objective": "binary", "verbosity": -1, **extra})
    for it in range(10):
        ref.iter_ = port.iter_ = it
        rg, rc = ref._bagging_masks()
        pg, pc = port._bagging_masks()
        np.testing.assert_array_equal(pg.numpy(), np.asarray(rg))
        np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))
        assert pc.numpy()[port.data.n:].sum() == 0     # padding stays out


@pytest.mark.parametrize("frac,seed", [(0.8, 2), (0.35, 7), (1.0, 2)])
def test_feature_masks_equal(frac, seed):
    ref, port = _engines({"objective": "binary", "verbosity": -1,
                          "feature_fraction": frac,
                          "feature_fraction_seed": seed})
    for _ in range(10):
        want = np.asarray(ref._feature_mask())
        got = port._feature_mask().numpy()
        np.testing.assert_array_equal(got, want)
        assert got.sum() == int(np.ceil(port.num_features * frac))


@pytest.fixture(scope="module")
def trained():
    X, y = synth_higgs(24_000, 28)
    Xt, yt, Xv, yv = X[:20_000], y[:20_000], X[20_000:], y[20_000:]
    ds = lgb.Dataset(Xt, label=yt)
    ref = lgb.Booster(params=dict(PARAMS), train_set=ds)
    ref.add_valid(ds.create_valid(Xv, label=yv), "holdout")
    assert ref.engine.hist_partition
    for _ in range(ROUNDS):
        ref.update()
    pds = lgt.Dataset(Xt, label=yt)
    port = lgt.train(dict(PARAMS, device_type="cpu"), pds,
                     num_boost_round=ROUNDS,
                     valid_sets=[pds.create_valid(Xv, label=yv)],
                     valid_names=["holdout"],
                     noise=JaxReplayNoise(ref.engine.config.objective_seed))
    return dict(ref=ref, port=port)


def test_full_row_same_first_tree(trained):
    pe, re_ = trained["port"].engine, trained["ref"].engine
    assert pe.hist_partition and pe.iter_ == ROUNDS
    a, b = pe.models[0], re_.models[0]
    assert a.num_leaves == b.num_leaves == 31
    for k in EXACT:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=k)
    for k in ("leaf_value", "leaf_weight", "internal_value", "split_gain"):
        np.testing.assert_allclose(getattr(a, k), getattr(b, k), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_full_row_holdout_auc_within_1e3(trained):
    [(_, _, auc_p, _)] = trained["port"].eval_valid()
    [(_, _, auc_r, _)] = trained["ref"].eval_valid()
    assert auc_r > 0.8
    assert abs(auc_p - auc_r) <= 1e-3
