"""Port parity end to end, and the port's package rules.

Both packages train the flagship configuration at test size (20k rows x
28 Higgs-like features, 31 leaves, leaf_batch 8, GOSS with the compacted
histogram buffer, quantized gradients with stochastic rounding, 14
rounds, so GOSS runs for 4). The port draws its noise from the JAX
package's own threefry stream through a replay object built here (the
package itself never sees JAX). Gradients still differ by float32 ULPs
(``torch.sigmoid`` vs XLA's), so the check is: the same first tree, and
holdout AUC within 1e-3.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import capabilities
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.convert import forest_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = {"objective": "binary", "num_leaves": 31, "max_bin": 255,
          "learning_rate": 0.1, "use_quantized_grad": True,
          "data_sample_strategy": "goss", "tpu_leaf_batch": 8,
          "metric": "auc", "verbosity": -1}
ROUNDS = 14
EXACT = ("split_feature", "threshold_bin", "default_left", "left_child",
         "right_child", "leaf_count", "internal_count")


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


def synth_higgs(n, f, seed=0):
    """bench.py::synth_higgs."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    w = rng.normal(size=f)
    logit = (X @ w * 0.5 + 0.8 * X[:, 0] * X[:, 1]
             + 0.5 * np.abs(X[:, 2]) - 0.4)
    y = (logit + rng.normal(scale=1.0, size=n) > 0).astype(np.float64)
    return X.astype(np.float64), y


class JaxReplayNoise:
    """The JAX package's training draws (gbdt.py key derivation:
    PRNGKey(objective_seed + iter); split -> (kg, km) for GOSS;
    fold_in(key, 0x9e37) then fold_in(., class k) -> split -> (kg, kh)
    for stochastic rounding of class k's tree; rank_xendcg's gammas from
    the key itself on a full-row step and from kg under GOSS), handed to
    the port as tensors."""

    def __init__(self, seed):
        self.seed = seed

    def rank_uniforms(self, iteration, Q, M, goss):
        key = jax.random.PRNGKey(self.seed + iteration)
        if goss:
            key = jax.random.split(key)[0]
        return torch.from_numpy(np.array(jax.random.uniform(key, (Q, M))))

    def goss_uniform(self, iteration, n):
        _, km = jax.random.split(jax.random.PRNGKey(self.seed + iteration))
        return torch.from_numpy(np.array(jax.random.uniform(km, (n,))))

    def quant_uniforms(self, iteration, n, k=0):
        key = jax.random.PRNGKey(self.seed + iteration)
        kq = jax.random.fold_in(jax.random.fold_in(key, 0x9e37), k)
        kg, kh = jax.random.split(kq)
        return tuple(torch.from_numpy(np.array(jax.random.uniform(
            k, (n,), minval=-0.5, maxval=0.5))) for k in (kg, kh))


@pytest.fixture(scope="module")
def trained():
    X, y = synth_higgs(24_000, 28)
    Xt, yt, Xv, yv = X[:20_000], y[:20_000], X[20_000:], y[20_000:]
    ds = lgb.Dataset(Xt, label=yt)
    ref = lgb.Booster(params=dict(PARAMS), train_set=ds)
    ref.add_valid(ds.create_valid(Xv, label=yv), "holdout")
    eng = ref.engine
    assert eng._use_goss_compact
    fetched = []
    fetch = eng._fetch_tree_arrays
    eng._fetch_tree_arrays = lambda st: fetched.append(fetch(st)) or \
        fetched[-1]
    for _ in range(ROUNDS):
        ref.update()
    pds = lgt.Dataset(Xt, label=yt)
    port = lgt.train(dict(PARAMS, device_type="cpu"), pds,
                     num_boost_round=ROUNDS,
                     valid_sets=[pds.create_valid(Xv, label=yv)],
                     valid_names=["holdout"],
                     noise=JaxReplayNoise(eng.config.objective_seed))
    return dict(ref=ref, port=port, fetched=fetched, Xv=Xv)


def test_same_first_tree(trained):
    pe, re_ = trained["port"].engine, trained["ref"].engine
    assert pe.use_goss_compact and pe.iter_ == ROUNDS
    a, b = pe.models[0], re_.models[0]
    assert a.num_leaves == b.num_leaves == 31
    for k in EXACT:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=k)
    for k in ("leaf_value", "leaf_weight", "internal_value", "split_gain"):
        np.testing.assert_allclose(getattr(a, k), getattr(b, k), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_holdout_auc_within_1e3(trained):
    [(_, _, auc_p, _)] = trained["port"].eval_valid()
    [(_, _, auc_r, _)] = trained["ref"].eval_valid()
    assert auc_r > 0.8
    assert abs(auc_p - auc_r) <= 1e-3


def test_port_predicts_jax_model_text(trained):
    Xv = trained["Xv"]
    text = trained["ref"].model_to_string()
    got = lgt.Booster(model_str=text).predict(Xv)
    np.testing.assert_allclose(got, trained["ref"].predict(Xv), rtol=0,
                               atol=1e-6)
    # the port's own text round-trips through its host predict
    port = trained["port"]
    again = lgt.Booster(model_str=port.model_to_string()).predict(Xv)
    np.testing.assert_allclose(again, port.predict(Xv), rtol=0, atol=1e-6)


def test_forest_from_jax_predicts_the_same(trained):
    ref, port = trained["ref"], trained["port"]
    eng = port.engine
    trees = forest_from_jax(trained["fetched"],
                            float(PARAMS["learning_rate"]),
                            eng.train_set.bin_mappers,
                            eng.train_set.used_features)
    saved = (eng.models, eng.init_scores, eng._stack_cache)
    try:
        eng.models, eng._stack_cache = trees, None
        eng.init_scores = np.asarray(ref.engine.init_scores, np.float64)
        got = eng.predict(trained["Xv"])
    finally:
        eng.models, eng.init_scores, eng._stack_cache = saved
    np.testing.assert_allclose(got, ref.predict(trained["Xv"]), rtol=0,
                               atol=1e-6)


# ---- package rules --------------------------------------------------------
def test_package_imports_no_jax():
    code = (
        "import sys, numpy as np\n"
        "import lightgbm_tpu_torch as lgt\n"
        "rng = np.random.default_rng(0)\n"
        "X = rng.normal(size=(3000, 5)); y = (X[:, 0] > 0).astype(float)\n"
        "bst = lgt.train({'objective': 'binary', 'num_leaves': 7,\n"
        "                 'device_type': 'cpu', 'verbosity': -1},\n"
        "                lgt.Dataset(X, label=y), num_boost_round=2)\n"
        "assert bst.predict(X).shape == (3000,)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'lightgbm_tpu' or m.startswith('lightgbm_tpu.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


def test_default_device_is_cuda_and_never_falls_back():
    X, y = synth_higgs(2000, 4)
    assert Config({}).device_type == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(lgt.LightGBMError, match="device_type"):
        lgt.train({"objective": "binary", "verbosity": -1},
                  lgt.Dataset(X, label=y), num_boost_round=1)


def test_unknown_device_type_is_fatal():
    with pytest.raises(lgt.LightGBMError, match="device_type"):
        Config({"device_type": "gpu"})


@pytest.mark.parametrize("name", sorted(capabilities.UNPORTED))
def test_unported_features_fail_loudly(name):
    X, y = synth_higgs(2000, 4)
    params = {"objective": "binary", "device_type": "cpu", "verbosity": -1,
              **capabilities.UNPORTED[name].example}
    with pytest.raises(lgt.LightGBMError, match="does not support"):
        lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=1)
