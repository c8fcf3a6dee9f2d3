"""Port parity on more configurations, on the paths of the stable-partition
kernels: the leaf-ordered row partition (``tpu_hist_partition=true``, the
move B′) and GOSS with the compacted histogram buffer (B).

Each case trains both packages on the same seeded Higgs-like data with one
configuration feature set: sample weights, ``is_unbalance``,
``scale_pos_weight``, NaN-routed splits (10% NaN in three features), a
dataset ``init_score``, or ``max_depth`` / ``lambda_l2`` /
``min_sum_hessian_in_leaf``. The port replays the reference's own GOSS and
stochastic-rounding draws. The check: the split lines of the model text
(features, thresholds, decision types, children) are identical, and the
holdout probabilities differ by at most 1e-5 (the gradients differ by
float32 ULPs of the sigmoid, ``tests/test_torch_train.py``; every
histogram sum is exact under quantized gradients).
"""
import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from test_torch_regression import _one_torch_thread  # noqa
from test_torch_train import JaxReplayNoise, _reference_metrics_off  # noqa

ROUNDS = 6
N_FEAT = 10
TOL = 1e-5
BASE = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.3,
        "use_quantized_grad": True, "tpu_leaf_batch": 4, "verbosity": -1}
# path -> (training rows, params); GOSS starts at iteration 1/lr = 3
PATHS = {
    "partition": (5000, {"tpu_hist_partition": "true"}),
    "goss_compact": (16_000, {"data_sample_strategy": "goss",
                              "top_rate": 0.1, "other_rate": 0.05,
                              "tpu_goss_compact": True}),
}
CONFIGS = {
    "weights": {},
    "is_unbalance": {"is_unbalance": True},
    "scale_pos_weight": {"scale_pos_weight": 3.0},
    "nan": {},
    "init_score": {},
    "limits": {"max_depth": 4, "lambda_l2": 2.0,
               "min_sum_hessian_in_leaf": 5.0},
}
SPLIT_KEYS = ("split_feature", "threshold", "decision_type", "left_child",
              "right_child", "num_leaves")


def _data(n, config, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n + 1000, N_FEAT))
    w = rng.normal(size=N_FEAT)
    logit = X @ w * 0.5 + 0.8 * X[:, 0] * X[:, 1] - 0.6
    y = (logit + rng.normal(size=len(X)) > 0).astype(np.float64)
    if config == "nan":
        X[rng.random(X.shape) < 0.1 * (np.arange(N_FEAT) < 3)] = np.nan
    kw = {}
    if config == "weights":
        kw["weight"] = rng.uniform(0.2, 3.0, size=n)
    if config == "init_score":
        kw["init_score"] = rng.normal(scale=0.5, size=n)
    return X[:n], y[:n], X[n:], kw


def _split_lines(text):
    return [ln for ln in text.splitlines()
            if ln.split("=", 1)[0] in SPLIT_KEYS]


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("path", list(PATHS))
def test_port_matches_reference(path, config):
    n, extra = PATHS[path]
    params = dict(BASE, **extra, **CONFIGS[config])
    X, y, Xv, kw = _data(n, config)
    ref = lgb.Booster(params=dict(params),
                      train_set=lgb.Dataset(X, label=y, **kw))
    eng = ref.engine
    if path == "partition":
        assert eng.hist_partition
    else:
        assert eng._use_goss_compact
    for _ in range(ROUNDS):
        ref.update()
    port = lgt.train(dict(params, device_type="cpu"),
                     lgt.Dataset(X, label=y, **kw), num_boost_round=ROUNDS,
                     noise=JaxReplayNoise(eng.config.objective_seed))
    pe = port.engine
    assert pe.hist_partition if path == "partition" else pe.use_goss_compact
    lines = _split_lines(port.model_to_string())
    assert len(lines) == len(SPLIT_KEYS) * ROUNDS
    assert lines == _split_lines(ref.model_to_string())
    if config == "nan":       # some split's missing type is NaN
        assert any((int(v) >> 2) & 3 == 2 for ln in lines
                   if ln.startswith("decision_type=")
                   for v in ln.split("=")[1].split())
    dp = np.abs(port.predict(Xv) - ref.predict(Xv)).max()
    assert dp <= TOL, dp
