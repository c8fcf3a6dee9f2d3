"""Objective functions: per-row gradient/hessian producers.

Reference: src/objective/*.hpp + ``ObjectiveFunction::CreateObjectiveFunction``
(src/objective/objective_function.cpp, UNVERIFIED — empty mount, see
SURVEY.md banner). Each objective supplies ``GetGradients(score) ->
(grad, hess)``, an optional boost-from-average init score, and the
score→output transform used at predict time.

The port of ``lightgbm_tpu/objective/__init__.py`` (the ranking objectives,
lambdarank and rank_xendcg, are in ``ranking.py``): pure element-wise torch
functions on the data's device, written
operation for operation as the JAX package writes them. Where an
objective's only transcendental is ``exp`` or ``sigmoid`` (binary,
multiclassova, poisson, gamma, tweedie, cross_entropy) it runs XLA's own
float32 algorithm (``_exp_xla``, ``_sigmoid_xla``): every step a correctly
rounded IEEE operation, so the card, the CPU and the JAX package on its
CPU backend give the same bits. The others (``softmax``, ``log1p``) run in
float64 and round to float32: the card's and the CPU's float32 versions
differ in the last bits, and so would their quantized gradients and
trees; rounded from float64 they agree, and differ from XLA's by ULPs.
The multiclass objectives take a ``[n, K]`` score;
the others take ``[n]``. The boost-from-average init scores and the leaf
renewal of L1, quantile and MAPE (``renew_tree_output``) are host numpy,
copied from the JAX package.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils import log
from ..utils.fp import f32 as _f32, fma as _fma


def _exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x.double()).to(x.dtype)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x.double()).to(x.dtype)


# XLA's CPU exp (the Cephes polynomial, evaluated with fused multiply-adds)
_LOG2E = 1.44269504088896341
_EXP_C1, _EXP_C2 = -0.693359375, 2.12194440e-4
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)
# XLA's CPU backend flushes float32 results below the smallest normal
_MIN_NORMAL = 2.0 ** -126


def _exp_xla(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp`` with the bits of ``jnp.exp`` on XLA's CPU backend:
    clamp to [-87.8, 88.8], ``m = floor(x log2(e) + 0.5)`` clamped to
    [-127, 127], ``r = x - m ln 2`` in two parts, the Cephes polynomial
    in Horner form, ``y * 2^m`` (one rounding, in float64, from the
    exponent bits), and results below 2^-126 flushed to +0. Overflow
    gives inf, NaN stays NaN."""
    x = x.to(torch.float32)
    xc = torch.clamp(x, -87.8, 88.8)
    m = torch.clamp(torch.floor(_fma(xc, _f32(_LOG2E), _f32(0.5))),
                    -127.0, 127.0)
    r = _fma(m, _f32(_EXP_C1), xc)
    r = _fma(m, _f32(_EXP_C2), r)
    y = torch.full_like(r, _EXP_POLY[0])
    for c in _EXP_POLY[1:]:
        y = _fma(y, r, _f32(c))
    y = _fma(y, r * r, r) + 1.0
    e = torch.nan_to_num(m, nan=0.0).to(torch.int64)
    pow2 = ((e + 1023) << 52).view(torch.float64)
    out = (y.double() * pow2).float()
    return torch.where(out < _MIN_NORMAL, 0.0, out)


def _sigmoid_xla(x: torch.Tensor) -> torch.Tensor:
    """float32 ``sigmoid`` with the bits of ``jax.nn.sigmoid`` on XLA's
    CPU backend: ``1 / (1 + exp(-x))``, the divide a tensor by a tensor
    (CUDA turns a Python number over a tensor into a product with the
    reciprocal), results below 2^-126 flushed to +0."""
    d = 1.0 + _exp_xla(-x)
    out = torch.ones_like(d) / d
    return torch.where(out < _MIN_NORMAL, 0.0, out)


def _softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.softmax(x.double(), dim=dim).to(x.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log1p(exp(x))`` as the JAX package writes it, in float64."""
    return torch.log1p(torch.exp(x.double())).to(x.dtype)


class Objective:
    """Base objective. Subclasses implement torch ``get_gradients``."""

    name = "base"
    is_ranking = False
    # rank_xendcg takes per-iteration uniforms; position-debiased
    # lambdarank threads per-position state through the iterations
    needs_rng = False
    has_pos_state = False

    def __init__(self, config):
        self.config = config

    def init_score(self, label: np.ndarray,
                   weight: Optional[np.ndarray]) -> float:
        """BoostFromAverage initial score (host-side, once)."""
        return 0.0

    def get_gradients(self, score: torch.Tensor, label: torch.Tensor,
                      weight: Optional[torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def convert_output(self, score: torch.Tensor) -> torch.Tensor:
        """Raw score -> prediction-space transform (identity by default)."""
        return score

    def renew_tree_output(self, *_args, **_kw):
        """Hook for leaf re-fitting (L1/quantile/MAPE median renewal)."""
        return None

    @property
    def renews(self) -> bool:
        """True when this objective re-fits leaf outputs on the host."""
        return (type(self).renew_tree_output
                is not Objective.renew_tree_output)

    def _apply_weight(self, grad, hess, weight):
        if weight is None:
            return grad, hess
        return grad * weight, hess * weight

    # -- boost_from_average as a mean statistic (the reference's
    # Network::GlobalSyncUpByMean decomposition) -------------------------
    def init_mean_stats(self, label, weight):
        """``(weighted_sum, weight_total)`` such that
        ``init_from_mean(weighted_sum / weight_total)`` reproduces
        ``init_score``. None when the init score is not a mean statistic
        (the median/percentile family)."""
        return None

    def init_from_mean(self, mean: float) -> float:
        raise NotImplementedError

    @staticmethod
    def _mean_stats_of(v: np.ndarray, weight) -> Tuple[float, float]:
        if weight is None:
            return float(np.sum(v)), float(len(v))
        return float(np.sum(v * weight)), float(np.sum(weight))

    @staticmethod
    def _wavg(v: np.ndarray, weight: Optional[np.ndarray]) -> float:
        if weight is None:
            return float(np.mean(v))
        return float(np.sum(v * weight) / np.sum(weight))


# ---------------------------------------------------------------------------
# Regression family (src/objective/regression_objective.hpp, UNVERIFIED)
# ---------------------------------------------------------------------------
class RegressionL2(Objective):
    name = "regression"

    def __init__(self, config):
        super().__init__(config)
        # reg_sqrt: fit sign(y)*sqrt(|y|) instead of y; predictions
        # convert back as sign(s)*s^2
        self.reg_sqrt = bool(getattr(config, "reg_sqrt", False))

    def init_score(self, label, weight):
        if not self.config.boost_from_average:
            return 0.0
        if self.reg_sqrt:
            label = np.sign(label) * np.sqrt(np.abs(label))
        return self._wavg(label, weight)

    def get_gradients(self, score, label, weight):
        if self.reg_sqrt:
            label = torch.sign(label) * torch.sqrt(torch.abs(label))
        grad = score - label
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess, weight)

    def convert_output(self, score):
        if self.reg_sqrt:
            return torch.sign(score) * score * score
        return score

    def init_mean_stats(self, label, weight):
        if self.reg_sqrt:
            label = np.sign(label) * np.sqrt(np.abs(label))
        return self._mean_stats_of(label, weight)

    def init_from_mean(self, mean):
        return float(mean)


class RegressionL1(Objective):
    name = "regression_l1"

    def init_score(self, label, weight):
        if not self.config.boost_from_average:
            return 0.0
        return _weighted_percentile_np(label, weight, 0.5)

    def get_gradients(self, score, label, weight):
        grad = torch.sign(score - label)
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess, weight)

    def renew_tree_output(self, score, label, weight, leaf_id, num_leaves):
        return _leaf_percentile_renewal(score, label, weight, leaf_id,
                                        num_leaves, 0.5)


class Huber(Objective):
    name = "huber"

    def get_gradients(self, score, label, weight):
        alpha = self.config.alpha
        r = score - label
        grad = torch.clamp(r, -alpha, alpha)
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess, weight)


class Fair(Objective):
    name = "fair"

    def get_gradients(self, score, label, weight):
        c = self.config.fair_c
        r = score - label
        denom = torch.abs(r) + c
        grad = c * r / denom
        # one division, as the JAX package divides (a Python number over
        # a tensor is a product with the tensor's reciprocal in torch)
        hess = torch.full_like(denom, c * c) / (denom * denom)
        return self._apply_weight(grad, hess, weight)


class _LogMean(Objective):
    """Objectives whose init score is the log of the weighted label mean
    and whose output is ``exp(score)``."""

    def init_score(self, label, weight):
        if not self.config.boost_from_average:
            return 0.0
        return float(np.log(max(self._wavg(label, weight), 1e-9)))

    def convert_output(self, score):
        return _exp_xla(score)

    def init_mean_stats(self, label, weight):
        return self._mean_stats_of(np.asarray(label, np.float64), weight)

    def init_from_mean(self, mean):
        return float(np.log(max(mean, 1e-9)))


class Poisson(_LogMean):
    name = "poisson"

    def get_gradients(self, score, label, weight):
        grad = _exp_xla(score) - label
        hess = _exp_xla(score + self.config.poisson_max_delta_step)
        return self._apply_weight(grad, hess, weight)


class Quantile(Objective):
    name = "quantile"

    def init_score(self, label, weight):
        if not self.config.boost_from_average:
            return 0.0
        return _weighted_percentile_np(label, weight, self.config.alpha)

    def get_gradients(self, score, label, weight):
        alpha = self.config.alpha
        grad = torch.where(label - score > 0, -alpha, 1.0 - alpha) \
            .to(score.dtype)
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess, weight)

    def renew_tree_output(self, score, label, weight, leaf_id, num_leaves):
        return _leaf_percentile_renewal(score, label, weight, leaf_id,
                                        num_leaves, self.config.alpha)


class MAPE(Objective):
    name = "mape"

    def init_score(self, label, weight):
        if not self.config.boost_from_average:
            return 0.0
        return _weighted_percentile_np(label, weight, 0.5)

    def get_gradients(self, score, label, weight):
        scale = 1.0 / torch.clamp(torch.abs(label), min=1.0)
        grad = torch.sign(score - label) * scale
        hess = scale
        return self._apply_weight(grad, hess, weight)

    def renew_tree_output(self, score, label, weight, leaf_id, num_leaves):
        # weighted median with the 1/|label| scaling folded into weights
        scale = 1.0 / np.maximum(np.abs(np.asarray(label)), 1.0)
        w = scale if weight is None else scale * np.asarray(weight)
        return _leaf_percentile_renewal(score, label, w, leaf_id,
                                        num_leaves, 0.5)


class Gamma(_LogMean):
    name = "gamma"

    def get_gradients(self, score, label, weight):
        e = _exp_xla(-score)
        grad = 1.0 - label * e
        hess = label * e
        return self._apply_weight(grad, hess, weight)


class Tweedie(_LogMean):
    name = "tweedie"

    def get_gradients(self, score, label, weight):
        rho = self.config.tweedie_variance_power
        e1 = _exp_xla((1.0 - rho) * score)
        e2 = _exp_xla((2.0 - rho) * score)
        # XLA contracts each product and sum into one fused multiply-add
        # in the JAX package's jitted step
        grad = _fma(-label, e1, e2)
        hess = _fma(-label * (1.0 - rho), e1, (2.0 - rho) * e2)
        return self._apply_weight(grad, hess, weight)


# ---------------------------------------------------------------------------
# Binary classification (src/objective/binary_objective.hpp, UNVERIFIED)
# ---------------------------------------------------------------------------
class Binary(Objective):
    name = "binary"

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = config.sigmoid
        self._pos_weight = 1.0
        self._neg_weight = 1.0

    def prepare(self, label: np.ndarray, weight) -> None:
        """Compute class weights (is_unbalance / scale_pos_weight)."""
        cnt_pos = float(np.sum(label > 0))
        cnt_neg = float(len(label) - cnt_pos)
        if self.config.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                self._pos_weight = 1.0
                self._neg_weight = cnt_pos / cnt_neg
            else:
                self._pos_weight = cnt_neg / cnt_pos
                self._neg_weight = 1.0
        else:
            self._pos_weight = self.config.scale_pos_weight
            self._neg_weight = 1.0

    def init_score(self, label, weight):
        if not self.config.boost_from_average:
            return 0.0
        pavg = min(max(self._wavg((label > 0).astype(np.float64), weight),
                       1e-15), 1.0 - 1e-15)
        init = float(np.log(pavg / (1.0 - pavg)) / self.sigmoid)
        log.info(f"[binary:BoostFromScore]: pavg={pavg:.6f} -> "
                 f"initscore={init:.6f}")
        return init

    def get_gradients(self, score, label, weight):
        sig = self.sigmoid
        y = (label > 0).to(score.dtype)
        p = _sigmoid_xla(sig * score)
        label_w = torch.where(y > 0, self._pos_weight, self._neg_weight) \
            .to(score.dtype)
        grad = sig * (p - y) * label_w
        hess = sig * sig * p * (1.0 - p) * label_w
        return self._apply_weight(grad, hess, weight)

    def convert_output(self, score):
        return _sigmoid_xla(self.sigmoid * score)

    def init_mean_stats(self, label, weight):
        return self._mean_stats_of((label > 0).astype(np.float64),
                                   weight)

    def init_from_mean(self, mean):
        pavg = min(max(float(mean), 1e-15), 1.0 - 1e-15)
        return float(np.log(pavg / (1.0 - pavg)) / self.sigmoid)


# ---------------------------------------------------------------------------
# Multiclass (src/objective/multiclass_objective.hpp, UNVERIFIED)
# ---------------------------------------------------------------------------
def _one_hot(label: torch.Tensor, K: int, dtype) -> torch.Tensor:
    return torch.nn.functional.one_hot(label.to(torch.int64), K).to(dtype)


def _class_weight(grad, hess, weight):
    if weight is None:
        return grad, hess
    return grad * weight[:, None], hess * weight[:, None]


class MulticlassSoftmax(Objective):
    name = "multiclass"

    def get_gradients(self, score, label, weight):
        # score: [n, K]
        y = _one_hot(label, score.shape[1], score.dtype)
        p = _softmax(score, dim=1)
        grad = p - y
        # the factor-2 hessian follows the reference's multiclass softmax
        hess = 2.0 * p * (1.0 - p)
        return _class_weight(grad, hess, weight)

    def convert_output(self, score):
        return _softmax(score, dim=-1)


class MulticlassOVA(Objective):
    name = "multiclassova"

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = config.sigmoid

    def get_gradients(self, score, label, weight):
        y = _one_hot(label, score.shape[1], score.dtype)
        sig = self.sigmoid
        p = _sigmoid_xla(sig * score)
        grad = sig * (p - y)
        hess = sig * sig * p * (1.0 - p)
        return _class_weight(grad, hess, weight)

    def convert_output(self, score):
        p = _sigmoid_xla(self.sigmoid * score)
        return p / torch.sum(p, dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# Cross-entropy family (src/objective/xentropy_objective.hpp, UNVERIFIED)
# ---------------------------------------------------------------------------
class CrossEntropy(Objective):
    name = "cross_entropy"

    def init_score(self, label, weight):
        if not self.config.boost_from_average:
            return 0.0
        pavg = min(max(self._wavg(label, weight), 1e-15), 1.0 - 1e-15)
        return float(np.log(pavg / (1.0 - pavg)))

    def get_gradients(self, score, label, weight):
        p = _sigmoid_xla(score)
        if weight is None:
            return p - label, p * (1.0 - p)
        # weighted cross-entropy: gradient scales with weight
        return (p - label) * weight, p * (1.0 - p) * weight

    def convert_output(self, score):
        return _sigmoid_xla(score)


class CrossEntropyLambda(Objective):
    name = "cross_entropy_lambda"

    def get_gradients(self, score, label, weight):
        # intensity parameterization, weights folded in (the reference's
        # xentlambda)
        w = torch.ones_like(score) if weight is None else weight
        eps = _softplus(score)
        sig = _sigmoid(score)
        e = _exp(-w * eps)
        hhat = 1.0 - e
        grad = sig * (w * (1.0 - label / torch.clamp(hhat, min=1e-15)
                           * e))
        hess_base = sig * (1.0 - sig)
        hess = torch.clamp(hess_base * w, min=1e-15)
        return grad, hess

    def convert_output(self, score):
        return _softplus(score)


# ---------------------------------------------------------------------------
# helpers + factory
# ---------------------------------------------------------------------------
def _weighted_percentile_np(v: np.ndarray, weight: Optional[np.ndarray],
                            alpha: float) -> float:
    v = np.asarray(v, dtype=np.float64)
    if weight is None:
        return float(np.percentile(v, alpha * 100.0,
                                   method="inverted_cdf"))
    order = np.argsort(v)
    cw = np.cumsum(np.asarray(weight, dtype=np.float64)[order])
    cut = alpha * cw[-1]
    idx = int(np.searchsorted(cw, cut))
    return float(v[order[min(idx, len(v) - 1)]])


def _leaf_percentile_renewal(score, label, weight, leaf_id, num_leaves,
                             alpha):
    """Per-leaf weighted percentile of residuals (RenewTreeOutput).

    Host-side numpy (runs once per tree for L1-family objectives).
    """
    score = np.asarray(score)
    label = np.asarray(label)
    leaf_id = np.asarray(leaf_id)
    out = np.zeros(num_leaves, dtype=np.float64)
    resid = label - score
    for lf in range(num_leaves):
        m = leaf_id == lf
        if not m.any():
            continue
        w = None if weight is None else np.asarray(weight)[m]
        out[lf] = _weighted_percentile_np(resid[m], w, alpha)
    return out


_REGISTRY: Dict[str, Callable[..., Objective]] = {
    "regression": RegressionL2,
    "regression_l1": RegressionL1,
    "huber": Huber,
    "fair": Fair,
    "poisson": Poisson,
    "quantile": Quantile,
    "mape": MAPE,
    "gamma": Gamma,
    "tweedie": Tweedie,
    "binary": Binary,
    "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "cross_entropy": CrossEntropy,
    "cross_entropy_lambda": CrossEntropyLambda,
}


def create_objective(config) -> Objective:
    """Factory by canonical objective name (after Config alias resolution)."""
    name = config.objective
    if name in _REGISTRY:
        return _REGISTRY[name](config)
    if name in ("lambdarank", "rank_xendcg"):
        from .ranking import LambdaRank, RankXENDCG
        return (LambdaRank if name == "lambdarank" else RankXENDCG)(config)
    log.fatal(f"objective {name!r} is not supported by lightgbm_tpu_torch "
              f"yet")
