"""Objective functions: per-row gradient/hessian producers.

Reference: src/objective/*.hpp + ``ObjectiveFunction::CreateObjectiveFunction``
(src/objective/objective_function.cpp, UNVERIFIED — empty mount, see
SURVEY.md banner). Each objective supplies ``GetGradients(score) ->
(grad, hess)``, an optional boost-from-average init score, and the
score→output transform used at predict time.

The port of ``lightgbm_tpu/objective/__init__.py`` for the binary
objective: pure element-wise torch functions on the data's device. The
sigmoid is ``torch.sigmoid``, which differs from XLA's by an ULP on a small
share of inputs, so gradients agree with the JAX package to within an ULP
rather than bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import log


class Objective:
    """Base objective. Subclasses implement torch ``get_gradients``."""

    name = "base"

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

    def _apply_weight(self, grad, hess, weight):
        if weight is None:
            return grad, hess
        return grad * weight, hess * weight

    @staticmethod
    def _wavg(v: np.ndarray, weight: Optional[np.ndarray]) -> float:
        if weight is None:
            return float(np.mean(v))
        return float(np.sum(v * weight) / np.sum(weight))


class Binary(Objective):
    """Binary logloss (src/objective/binary_objective.hpp, UNVERIFIED)."""

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
        p = torch.sigmoid(sig * score)
        label_w = torch.where(y > 0, self._pos_weight, self._neg_weight) \
            .to(score.dtype)
        grad = sig * (p - y) * label_w
        hess = sig * sig * p * (1.0 - p) * label_w
        return self._apply_weight(grad, hess, weight)

    def convert_output(self, score):
        return torch.sigmoid(self.sigmoid * score)


def create_objective(config) -> Objective:
    """Factory by canonical objective name (after Config alias resolution)."""
    if config.objective == "binary":
        return Binary(config)
    log.fatal(f"objective {config.objective!r} is not supported by "
              f"lightgbm_tpu_torch yet")
