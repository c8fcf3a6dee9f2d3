"""Multiclass (3 classes) beyond the training paths: early stopping on
``multi_logloss`` against the JAX package (``first_metric_only`` and
``min_delta`` included), the reference's saved model text and its forest
carried across by ``forest_from_jax`` (3 trees an iteration, in class
order), and a per-class dataset ``init_score``. Data and checks as in
``test_torch_regression.py``.
"""
import numpy as np
import pytest

from test_torch_regression import check_early_stopping, check_reference_model
from test_torch_regression import _one_torch_thread  # noqa
from test_torch_train import _reference_metrics_off  # noqa

MULTI = ("multiclass", "multiclassova")


@pytest.mark.parametrize("es", [
    {"early_stopping_round": 3},
    {"early_stopping_round": 2, "metric": ["multi_logloss", "multi_error"],
     "first_metric_only": True, "early_stopping_min_delta": 0.01},
])
def test_early_stopping_matches_reference_multi_logloss(es):
    check_early_stopping("multiclass", es)


@pytest.mark.parametrize("case", MULTI)
def test_reference_model_predicts_the_same(case):
    check_reference_model(case)


def test_multiclass_init_score_per_class():
    """A dataset ``init_score`` of n * K values seeds every class's score,
    read row by row as the reference reads it."""
    import lightgbm_tpu_torch as lgt
    from test_torch_regression import make_data
    X, y, _, _ = make_data("multiclass", 600)
    init = np.random.default_rng(0).normal(size=600 * 3)
    bst = lgt.Booster(params={"objective": "multiclass", "num_class": 3,
                              "device_type": "cpu", "verbosity": -1},
                      train_set=lgt.Dataset(X, label=y, init_score=init))
    got = bst.engine.score[:600].numpy()
    np.testing.assert_array_equal(got, init.reshape(600, 3)
                                  .astype(np.float32))
