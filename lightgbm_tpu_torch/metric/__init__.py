"""Evaluation metrics.

Reference: src/metric/*.hpp + ``Metric::CreateMetric`` (src/metric/metric
.cpp, UNVERIFIED — empty mount, see SURVEY.md banner). Metrics consume the
prediction-space output (after the objective's convert_output).

The port of ``lightgbm_tpu/metric/__init__.py``: host-side NumPy, copied
from the JAX package, run once per ``metric_freq`` iterations on already
computed scores, so they are not on the hot path. The ranking metrics
(``ndcg@k``, ``map@k`` at ``eval_at``) read the data's query boundaries.
"""
from __future__ import annotations

import copy
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
             weight: Optional[np.ndarray],
             query_boundaries: Optional[np.ndarray] = None
             ) -> List[Tuple[str, float]]:
        """Returns a list of (metric_name, value)."""
        raise NotImplementedError

    @staticmethod
    def _avg(values: np.ndarray, weight: Optional[np.ndarray]) -> float:
        if weight is None:
            return float(np.mean(values))
        return float(np.sum(values * weight) / np.sum(weight))


def _simple(name: str, higher: bool, fn) -> type:
    class _M(Metric):
        def eval(self, pred, label, weight, query_boundaries=None):
            return [(name, self._avg(fn(self, pred, label), weight))]
    _M.name = name
    _M.higher_better = higher
    _M.__name__ = f"Metric_{name}"
    return _M


L2Metric = _simple("l2", False, lambda s, p, y: (p - y) ** 2)
RMSEMetric = _simple("rmse", False, lambda s, p, y: (p - y) ** 2)
L1Metric = _simple("l1", False, lambda s, p, y: np.abs(p - y))
MAPEMetric = _simple("mape", False,
                     lambda s, p, y: np.abs(p - y) / np.maximum(np.abs(y), 1))
PoissonMetric = _simple("poisson", False,
                        lambda s, p, y: p - y * np.log(np.maximum(p, EPS)))
GammaMetric = _simple(
    "gamma", False,
    lambda s, p, y: y / np.maximum(p, EPS)
    + np.log(np.maximum(p, EPS)) - 1 - np.log(np.maximum(y, EPS)))
GammaDevianceMetric = _simple(
    "gamma_deviance", False,
    lambda s, p, y: 2.0 * (np.log(np.maximum(p, EPS) / np.maximum(y, EPS))
                           + y / np.maximum(p, EPS) - 1))


class RMSEMetricSqrt(RMSEMetric):
    def eval(self, pred, label, weight, query_boundaries=None):
        [(n, v)] = super().eval(pred, label, weight)
        return [("rmse", float(np.sqrt(v)))]


class QuantileMetric(Metric):
    name = "quantile"

    def eval(self, pred, label, weight, query_boundaries=None):
        a = self.config.alpha
        d = label - pred
        loss = np.where(d >= 0, a * d, (a - 1.0) * d)
        return [("quantile", self._avg(loss, weight))]


class HuberMetric(Metric):
    name = "huber"

    def eval(self, pred, label, weight, query_boundaries=None):
        a = self.config.alpha
        d = np.abs(pred - label)
        loss = np.where(d <= a, 0.5 * d * d, a * (d - 0.5 * a))
        return [("huber", self._avg(loss, weight))]


class FairMetric(Metric):
    name = "fair"

    def eval(self, pred, label, weight, query_boundaries=None):
        c = self.config.fair_c
        d = np.abs(pred - label)
        loss = c * c * (d / c - np.log1p(d / c))
        return [("fair", self._avg(loss, weight))]


class TweedieMetric(Metric):
    name = "tweedie"

    def eval(self, pred, label, weight, query_boundaries=None):
        rho = self.config.tweedie_variance_power
        p = np.maximum(pred, EPS)
        loss = (-label * np.power(p, 1 - rho) / (1 - rho)
                + np.power(p, 2 - rho) / (2 - rho))
        return [("tweedie", self._avg(loss, weight))]


class BinaryLoglossMetric(Metric):
    name = "binary_logloss"

    def eval(self, pred, label, weight, query_boundaries=None):
        p = np.clip(pred, EPS, 1 - EPS)
        y = (label > 0).astype(np.float64)
        loss = -(y * np.log(p) + (1 - y) * np.log(1 - p))
        return [("binary_logloss", self._avg(loss, weight))]


class BinaryErrorMetric(Metric):
    name = "binary_error"

    def eval(self, pred, label, weight, query_boundaries=None):
        y = (label > 0).astype(np.float64)
        err = ((pred > 0.5) != (y > 0)).astype(np.float64)
        return [("binary_error", self._avg(err, weight))]


class AUCMetric(Metric):
    name = "auc"
    higher_better = True

    def eval(self, pred, label, weight, query_boundaries=None):
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


class AUCMuMetric(Metric):
    """Multiclass AUC-mu (Kleiman & Page; reference:
    src/metric/multiclass_metric.hpp AucMuMetric, UNVERIFIED): mean over
    class pairs (i, j) of the binary AUC separating class-i rows from
    class-j rows, scored by pred[:, i] - pred[:, j]; optional
    ``auc_mu_weights`` flat (num_class x num_class) weight matrix."""

    name = "auc_mu"
    higher_better = True

    def eval(self, pred, label, weight, query_boundaries=None):
        pred = np.asarray(pred)
        if pred.ndim != 2:
            return [("auc_mu", 0.5)]
        K = pred.shape[1]
        label = np.asarray(label).astype(np.int64)
        wm = None
        aw = getattr(self.config, "auc_mu_weights", None)
        if aw:
            wm = np.asarray(aw, dtype=np.float64).reshape(K, K)
        auc_bin = AUCMetric(self.config)
        total, wsum = 0.0, 0.0
        for i in range(K):
            for j in range(i + 1, K):
                m = (label == i) | (label == j)
                if not m.any() or (label[m] == i).all() \
                        or (label[m] == j).all():
                    continue
                s = pred[m, i] - pred[m, j]
                y = (label[m] == i).astype(np.float64)
                w = None if weight is None else weight[m]
                a = auc_bin.eval(s, y, w)[0][1]
                pw = wm[i, j] if wm is not None else 1.0
                total += pw * a
                wsum += pw
        return [("auc_mu", total / wsum if wsum else 0.5)]


class AveragePrecisionMetric(Metric):
    name = "average_precision"
    higher_better = True

    def eval(self, pred, label, weight, query_boundaries=None):
        y = (label > 0).astype(np.float64)
        w = np.ones_like(y) if weight is None else weight
        order = np.argsort(-pred, kind="mergesort")
        y, w = y[order], w[order]
        tp = np.cumsum(w * y)
        total = np.cumsum(w)
        total_pos = tp[-1]
        if total_pos == 0:
            return [("average_precision", 0.0)]
        precision = tp / np.maximum(total, EPS)
        recall_delta = np.diff(np.concatenate([[0.0], tp])) / total_pos
        return [("average_precision", float(np.sum(precision * recall_delta)))]


class MultiLoglossMetric(Metric):
    name = "multi_logloss"

    def eval(self, pred, label, weight, query_boundaries=None):
        # pred: [n, K] probabilities
        idx = label.astype(np.int64)
        p = np.clip(pred[np.arange(len(idx)), idx], EPS, 1.0)
        return [("multi_logloss", self._avg(-np.log(p), weight))]


class MultiErrorMetric(Metric):
    name = "multi_error"

    def eval(self, pred, label, weight, query_boundaries=None):
        k = self.config.multi_error_top_k
        idx = label.astype(np.int64)
        if k <= 1:
            err = (np.argmax(pred, axis=1) != idx).astype(np.float64)
        else:
            true_p = pred[np.arange(len(idx)), idx][:, None]
            rank = np.sum(pred > true_p, axis=1)
            err = (rank >= k).astype(np.float64)
        return [("multi_error", self._avg(err, weight))]


class CrossEntropyMetric(Metric):
    name = "cross_entropy"

    def eval(self, pred, label, weight, query_boundaries=None):
        p = np.clip(pred, EPS, 1 - EPS)
        loss = -(label * np.log(p) + (1 - label) * np.log(1 - p))
        return [("cross_entropy", self._avg(loss, weight))]


class KLDivMetric(Metric):
    name = "kullback_leibler"

    def eval(self, pred, label, weight, query_boundaries=None):
        p = np.clip(pred, EPS, 1 - EPS)
        y = np.clip(label, EPS, 1 - EPS)
        loss = (y * np.log(y / p) + (1 - y) * np.log((1 - y) / (1 - p)))
        return [("kullback_leibler", self._avg(loss, weight))]


# ---------------------------------------------------------------------------
# Ranking metrics (src/metric/rank_metric.hpp + dcg_calculator.cpp,
# UNVERIFIED)
# ---------------------------------------------------------------------------
def _label_gains(config, max_label: int) -> np.ndarray:
    if config.label_gain:
        g = np.asarray(config.label_gain, dtype=np.float64)
        if len(g) <= max_label:
            log.fatal("label_gain table shorter than max label")
        return g
    return (2.0 ** np.arange(max_label + 1)) - 1.0


def _dcg_at_k(labels: np.ndarray, scores: np.ndarray, k: int,
              gains: np.ndarray) -> float:
    order = np.argsort(-scores, kind="mergesort")
    top = labels[order[:k]].astype(np.int64)
    discounts = 1.0 / np.log2(np.arange(2, len(top) + 2))
    return float(np.sum(gains[top] * discounts))


class NDCGMetric(Metric):
    name = "ndcg"
    higher_better = True

    def eval(self, pred, label, weight, query_boundaries=None):
        if query_boundaries is None:
            log.fatal("ndcg metric requires query information")
        ks = self.config.eval_at
        gains = _label_gains(self.config, int(label.max()))
        results = {k: [] for k in ks}
        for qi in range(len(query_boundaries) - 1):
            s, e = query_boundaries[qi], query_boundaries[qi + 1]
            ql, qp = label[s:e], pred[s:e]
            ideal = np.sort(ql)[::-1].astype(np.int64)
            for k in ks:
                idcg = float(np.sum(
                    gains[ideal[:k]]
                    / np.log2(np.arange(2, min(k, len(ideal)) + 2))))
                if idcg > 0:
                    results[k].append(_dcg_at_k(ql, qp, k, gains) / idcg)
                else:
                    results[k].append(1.0)  # all-zero-label query counts as 1
        return [(f"ndcg@{k}", float(np.mean(results[k]))) for k in ks]


class MAPMetric(Metric):
    name = "map"
    higher_better = True

    def eval(self, pred, label, weight, query_boundaries=None):
        if query_boundaries is None:
            log.fatal("map metric requires query information")
        ks = self.config.eval_at
        results = {k: [] for k in ks}
        for qi in range(len(query_boundaries) - 1):
            s, e = query_boundaries[qi], query_boundaries[qi + 1]
            ql = (label[s:e] > 0).astype(np.float64)
            order = np.argsort(-pred[s:e], kind="mergesort")
            rel = ql[order]
            cum = np.cumsum(rel)
            prec = cum / np.arange(1, len(rel) + 1)
            for k in ks:
                nrel = rel[:k].sum()
                results[k].append(
                    float(np.sum(prec[:k] * rel[:k]) / nrel)
                    if nrel > 0 else 0.0)
        return [(f"map@{k}", float(np.mean(results[k]))) for k in ks]


_REGISTRY = {
    "l2": L2Metric, "mse": L2Metric, "mean_squared_error": L2Metric,
    "regression": L2Metric, "regression_l2": L2Metric,
    "rmse": RMSEMetricSqrt, "root_mean_squared_error": RMSEMetricSqrt,
    "l2_root": RMSEMetricSqrt,
    "l1": L1Metric, "mae": L1Metric, "mean_absolute_error": L1Metric,
    "regression_l1": L1Metric,
    "mape": MAPEMetric, "mean_absolute_percentage_error": MAPEMetric,
    "quantile": QuantileMetric, "huber": HuberMetric, "fair": FairMetric,
    "poisson": PoissonMetric, "gamma": GammaMetric,
    "gamma_deviance": GammaDevianceMetric, "tweedie": TweedieMetric,
    "binary_logloss": BinaryLoglossMetric, "binary": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AUCMetric, "average_precision": AveragePrecisionMetric,
    "auc_mu": AUCMuMetric,
    "multi_logloss": MultiLoglossMetric, "multiclass": MultiLoglossMetric,
    "softmax": MultiLoglossMetric, "multiclassova": MultiLoglossMetric,
    "multi_error": MultiErrorMetric,
    "cross_entropy": CrossEntropyMetric, "xentropy": CrossEntropyMetric,
    "cross_entropy_lambda": CrossEntropyMetric,
    "xentlambda": CrossEntropyMetric,
    "kullback_leibler": KLDivMetric, "kldiv": KLDivMetric,
    "ndcg": NDCGMetric, "lambdarank": NDCGMetric,
    "rank_xendcg": NDCGMetric, "xendcg": NDCGMetric,
    "map": MAPMetric, "mean_average_precision": MAPMetric,
}
_NO_METRIC = ("", "na", "null", "none", "custom")

_DEFAULT_FOR_OBJECTIVE = {
    "regression": "l2", "regression_l1": "l1", "huber": "huber",
    "fair": "fair", "poisson": "poisson", "quantile": "quantile",
    "mape": "mape", "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary_logloss",
    "multiclass": "multi_logloss", "multiclassova": "multi_logloss",
    "cross_entropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "lambdarank": "ndcg", "rank_xendcg": "ndcg",
}


def create_metric(name: str, config) -> Optional[Metric]:
    name = name.strip().lower()
    if name in _NO_METRIC:
        return None
    if name.startswith("ndcg@") or name.startswith("map@"):
        # "ndcg@5": this metric at k = 5 alone
        base, k = name.split("@", 1)
        cfg = copy.copy(config)
        cfg.eval_at = [int(k)]
        return _REGISTRY[base](cfg)
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


def eval_metric_rows(objective, metrics, name, raw, label, weight,
                     num_class: int = 1, query_boundaries=None):
    """Convert a raw-score matrix or vector through the objective (in
    float32, as the JAX package does) and run every metric (the ranking
    ones per query of ``query_boundaries``): ``(data_name, metric_name,
    value, higher_better)`` tuples."""
    raw = np.asarray(raw, np.float64)
    if num_class == 1 and raw.ndim == 2:
        raw = raw[:, 0]
    pred = objective.convert_output(
        torch.from_numpy(raw.astype(np.float32))).numpy()
    out = []
    for m in metrics:
        for mname, value in m.eval(pred, label, weight, query_boundaries):
            out.append((name, mname, value, m.higher_better))
    return out
