"""The port's metrics against the JAX package's, on the same predictions.

Every metric the port evaluates gets the same seeded predictions, labels
and (or no) weights in both packages: ``[n]`` predictions for the binary
and regression metrics, ``[n, K]`` class probabilities for the multiclass
ones (``multi_error`` also at ``multi_error_top_k`` 2 and 3, ``auc_mu``
also with ``auc_mu_weights``), relevance labels 0-4 in uneven query groups
for ``ndcg`` and ``map`` (tests/test_torch_ranking.py holds them at
``eval_at`` 1, 3 and 10 and on 1-document and all-zero queries). Both are
host numpy, so the values agree within 1e-12 relative. The registries
(names, aliases, default metric per objective) are the reference's.
"""
import numpy as np
import pytest

import lightgbm_tpu.config as jcfg
import lightgbm_tpu.metric as jmet
from lightgbm_tpu_torch import capabilities
from lightgbm_tpu_torch import metric as tmet
from lightgbm_tpu_torch.config import Config

N, K = 3000, 5
MULTI = ("multi_logloss", "multi_error", "auc_mu")
RANKING = ("ndcg", "map")
CONFIGS = {"": {}, "top_k2": {"multi_error_top_k": 2},
           "top_k3": {"multi_error_top_k": 3},
           "alpha": {"alpha": 0.3, "fair_c": 2.0,
                     "tweedie_variance_power": 1.7},
           "auc_mu_weights": {"auc_mu_weights": list(
               np.arange(K * K, dtype=float) % 3 + 1)}}


def _inputs(name, weighted, seed=0):
    rng = np.random.default_rng(seed)
    if name in RANKING:
        pred = rng.normal(size=N)
        label = np.clip(np.round(pred + rng.normal(size=N) + 1.5), 0, 4)
    elif name in MULTI:
        raw = rng.normal(size=(N, K))
        pred = np.exp(raw) / np.exp(raw).sum(1, keepdims=True)
        label = rng.integers(0, K, size=N).astype(np.float64)
    elif name in ("binary_logloss", "binary_error", "auc",
                  "average_precision"):
        pred = rng.uniform(size=N)
        pred[:50] = pred[50:100]                 # tied predictions
        label = (rng.uniform(size=N) < pred).astype(np.float64)
    elif name in ("cross_entropy", "kullback_leibler"):
        pred = rng.uniform(size=N)
        label = np.clip(pred + rng.normal(scale=0.2, size=N), 0, 1)
    elif name in ("poisson", "gamma", "gamma_deviance", "tweedie"):
        pred = rng.gamma(2.0, 1.0, size=N)
        label = rng.poisson(pred).astype(np.float64)
        if name.startswith("gamma"):
            label = label + rng.uniform(0.1, 1.0, size=N)
    else:
        pred = rng.normal(scale=2.0, size=N)
        label = pred + rng.normal(size=N)
    weight = rng.uniform(0.2, 3.0, size=N) if weighted else None
    return pred, label, weight


def _cases():
    for name in capabilities.PORTED_METRICS:
        yield name, ""
    for name, cfg in (("multi_error", "top_k2"), ("multi_error", "top_k3"),
                      ("auc_mu", "auc_mu_weights"), ("quantile", "alpha"),
                      ("huber", "alpha"), ("fair", "alpha"),
                      ("tweedie", "alpha")):
        yield name, cfg


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name,cfg", list(_cases()))
def test_metric_matches_reference(name, cfg, weighted):
    params = CONFIGS[cfg]
    pred, label, weight = _inputs(name, weighted)
    port = tmet.create_metric(name, Config(dict(params)))
    ref = jmet.create_metric(name, jcfg.Config(dict(params)))
    qb = None
    if name in RANKING:
        cuts = np.cumsum(np.random.default_rng(1).integers(1, 40, size=N))
        qb = np.concatenate([[0], cuts[cuts < N], [N]])
    got = port.eval(pred, label, weight, qb)
    want = ref.eval(pred, label, weight, qb)
    assert [n for n, _ in got] == [n for n, _ in want]
    assert port.higher_better == ref.higher_better
    for (_, a), (_, b) in zip(got, want):
        assert np.isfinite(a)
        assert abs(a - b) <= 1e-12 * abs(b), (a, b)


def test_registry_and_defaults_match_reference():
    assert set(tmet._REGISTRY) == set(jmet._REGISTRY)
    for alias, cls in tmet._REGISTRY.items():
        assert cls.__name__ == jmet._REGISTRY[alias].__name__, alias
    assert {cls.name for cls in tmet._REGISTRY.values()} \
        == set(capabilities.PORTED_METRICS)
    assert tmet._DEFAULT_FOR_OBJECTIVE == jmet._DEFAULT_FOR_OBJECTIVE
    for obj, default in tmet._DEFAULT_FOR_OBJECTIVE.items():
        [m] = tmet.metrics_for_config(Config({"objective": obj,
                                              "num_class": 3}))
        assert type(m).__name__ == jmet._REGISTRY[default].__name__


@pytest.mark.parametrize("raw_shape", [(N,), (N, 1), (N, K)])
def test_eval_metric_rows_shapes(raw_shape):
    """Raw scores ``[n]``, ``[n, 1]`` (one tree an iteration) and ``[n, K]``
    go through the objective's transform before the metrics."""
    from lightgbm_tpu_torch.objective import create_objective
    rng = np.random.default_rng(2)
    raw = rng.normal(size=raw_shape)
    K_ = raw_shape[1] if len(raw_shape) == 2 and raw_shape[1] > 1 else 1
    cfg = Config({"objective": "multiclass" if K_ > 1 else "binary",
                  "num_class": K_})
    label = rng.integers(0, max(K_, 2), size=N).astype(np.float64)
    rows = tmet.eval_metric_rows(create_objective(cfg),
                                 tmet.metrics_for_config(cfg), "valid",
                                 raw, label, None, K_)
    [(name, metric, value, higher)] = rows
    assert name == "valid" and not higher and np.isfinite(value)
    assert metric == ("multi_logloss" if K_ > 1 else "binary_logloss")
