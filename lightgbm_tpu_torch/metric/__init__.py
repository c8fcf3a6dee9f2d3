"""Evaluation metrics.

Reference: src/metric/*.hpp + ``Metric::CreateMetric`` (src/metric/metric
.cpp, UNVERIFIED — empty mount, see SURVEY.md banner). Metrics consume the
prediction-space output (after the objective's convert_output).

The port of ``lightgbm_tpu/metric/__init__.py`` for the binary metrics:
host-side NumPy, run once per ``metric_freq`` iterations on already
computed scores, so they are not on the hot path.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils import log

EPS = 1e-15


class Metric:
    name = "base"
    higher_better = False

    def __init__(self, config):
        self.config = config

    def eval(self, pred: np.ndarray, label: np.ndarray,
             weight: Optional[np.ndarray]) -> List[Tuple[str, float]]:
        """Returns a list of (metric_name, value)."""
        raise NotImplementedError

    @staticmethod
    def _avg(values: np.ndarray, weight: Optional[np.ndarray]) -> float:
        if weight is None:
            return float(np.mean(values))
        return float(np.sum(values * weight) / np.sum(weight))


class BinaryLoglossMetric(Metric):
    name = "binary_logloss"

    def eval(self, pred, label, weight):
        p = np.clip(pred, EPS, 1 - EPS)
        y = (label > 0).astype(np.float64)
        loss = -(y * np.log(p) + (1 - y) * np.log(1 - p))
        return [("binary_logloss", self._avg(loss, weight))]


class AUCMetric(Metric):
    name = "auc"
    higher_better = True

    def eval(self, pred, label, weight):
        y = (label > 0).astype(np.float64)
        w = np.ones_like(y) if weight is None else weight
        order = np.argsort(pred, kind="mergesort")
        y, w, p = y[order], w[order], pred[order]
        # rank-sum with midrank tie handling
        pos_w = np.sum(w * y)
        neg_w = np.sum(w * (1 - y))
        if pos_w == 0 or neg_w == 0:
            return [("auc", 0.5)]
        cum_neg = np.cumsum(w * (1 - y))
        # group ties: average cum_neg within tied prediction blocks
        _, idx, inv = np.unique(p, return_index=True, return_inverse=True)
        start_neg = np.concatenate([[0.0], cum_neg])[idx]
        end_neg = np.concatenate(
            [cum_neg[np.concatenate([idx[1:] - 1, [len(p) - 1]])]])
        mid = (start_neg + end_neg) / 2.0
        auc = float(np.sum(w * y * mid[inv]) / (pos_w * neg_w))
        return [("auc", auc)]


_REGISTRY = {"binary_logloss": BinaryLoglossMetric,
             "binary": BinaryLoglossMetric, "auc": AUCMetric}
_DEFAULT_FOR_OBJECTIVE = {"binary": "binary_logloss"}


def create_metric(name: str, config) -> Optional[Metric]:
    name = name.strip().lower()
    if name in ("", "na", "null", "none", "custom"):
        return None
    if name not in _REGISTRY:
        log.fatal(f"metric {name!r} is not supported by lightgbm_tpu_torch "
                  f"yet")
    return _REGISTRY[name](config)


def metrics_for_config(config) -> List[Metric]:
    """Resolve the configured metric list (default = objective's metric)."""
    names = list(config.metric)
    if not names:
        default = _DEFAULT_FOR_OBJECTIVE.get(config.objective)
        names = [default] if default else []
    out = []
    for n in names:
        m = create_metric(n, config)
        if m is not None:
            out.append(m)
    return out


def eval_metric_rows(objective, metrics, name, raw, label, weight):
    """Convert a raw-score vector through the objective (in float32, as
    the JAX package does) and run every metric: ``(data_name,
    metric_name, value, higher_better)`` tuples."""
    raw = np.asarray(raw, np.float64)
    if raw.ndim == 2:
        raw = raw[:, 0]
    pred = objective.convert_output(
        torch.from_numpy(raw.astype(np.float32))).numpy()
    out = []
    for m in metrics:
        for mname, value in m.eval(pred, label, weight):
            out.append((name, mname, value, m.higher_better))
    return out
