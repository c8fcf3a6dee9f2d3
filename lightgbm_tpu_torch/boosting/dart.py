"""DART boosting: Dropouts meet Multiple Additive Regression Trees.

Reference: ``DART`` (src/boosting/dart.hpp, UNVERIFIED — empty mount, see
SURVEY.md banner). The port of ``lightgbm_tpu/boosting/dart.py``. Each
iteration:

1. draws the iterations to drop (none with probability ``skip_drop``;
   each with probability ``drop_rate``, weighted by its tree weight
   unless ``uniform_drop``; at most ``max_drop``) from
   ``numpy.random.RandomState(drop_seed)`` on the host, draw for draw as
   the JAX package draws them;
2. takes the dropped trees' contribution (one stacked traversal of the
   logical bins, summed per class in the dropped trees' order) off the
   train and valid scores and trains the GBDT step there;
3. renormalizes: the new trees get ``1/(k+1)`` of their learning-rate
   output and the dropped trees ``k/(k+1)`` of theirs
   (``xgboost_dart_mode``: ``1/(k+lr)`` and ``k/(k+lr)``), on the scores
   in the JAX package's order of float32 operations and on the stored
   trees (``Tree.shrink``), whose change bumps the model version.

The JAX package pads the dropped stack with zero-valued one-leaf trees to
a power of two, so that its jitted traversal compiles once per size;
the per-class sums run in tree order from +0.0, so the padding adds
+0.0 and leaves the bits as they are, and the port stacks the dropped
trees alone. The JAX package's carry donation (``_donate_carries``) and
fused iterations (``can_fuse_iters``) have no counterpart here: the port
neither donates buffers nor fuses iterations. Saving and restoring the
training state waits for the port's recovery slice. The split search's
options run in the GBDT step as they are; CEGB's state (the features the
model uses, the rows' acquired features) only grows, and
``rollback_one_iter`` leaves it as it is, as the JAX package's does.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..ops.predict import forest_predict_binned
from .gbdt import GBDT


class DART(GBDT):
    """DART engine (reference: src/boosting/dart.hpp DART : public GBDT)."""

    def __init__(self, config, train_set, noise=None):
        super().__init__(config, train_set, noise=noise)
        self._rng_drop = np.random.RandomState(config.drop_seed)
        self._iter_weights: List[float] = []   # current weight per iteration
        self._sum_weight = 0.0
        # iterations that dropped trees, and trees dropped, so far
        self.drop_iterations = 0
        self.dropped_trees = 0

    def _select_drop(self) -> np.ndarray:
        """DART::DroppingTrees: the iteration indices to drop this
        round."""
        c = self.config
        n_iter = len(self._iter_weights)
        if n_iter == 0 or self._rng_drop.rand() < c.skip_drop:
            return np.array([], dtype=np.int64)
        if c.uniform_drop:
            p = np.full(n_iter, c.drop_rate)
        else:
            # weight-proportional, normalized so that the mean probability
            # is drop_rate (heavier trees drop more often)
            w = np.asarray(self._iter_weights, dtype=np.float64)
            mean_w = self._sum_weight / n_iter
            p = c.drop_rate * w / max(mean_w, 1e-32)
        drop = np.flatnonzero(self._rng_drop.rand(n_iter) < p)
        if c.max_drop > 0 and len(drop) > c.max_drop:
            drop = np.sort(self._rng_drop.choice(
                drop, size=c.max_drop, replace=False))
        return drop

    def train_one_iter(self) -> None:
        K = self.num_class
        lr = float(self.config.learning_rate)
        drop_iters = self._select_drop()
        k = len(drop_iters)
        drop_contrib = None
        drop_contrib_valid = []
        if k:
            model_idx = [int(i) * K + c for i in drop_iters for c in range(K)]
            stacked, class_index, depth = self._stack_model_list(model_idx)
            # the logical bins: trees split on logical features, and
            # under EFB the resident matrix is the bundled one
            drop_contrib, _ = forest_predict_binned(
                stacked, self._logical_bins(), self.feat_num_bin,
                self.feat_has_nan, depth, K, class_index=class_index)
            self.score = self.score - drop_contrib
            for vi, dd in enumerate(self.valid_data):
                vc, _ = forest_predict_binned(
                    stacked, dd.bins, self.feat_num_bin, self.feat_has_nan,
                    depth, K, class_index=class_index)
                drop_contrib_valid.append(vc)
                self.valid_scores[vi] = self.valid_scores[vi] - vc
            self.drop_iterations += 1
            self.dropped_trees += len(model_idx)

        score_pre = self.score
        valid_pre = list(self.valid_scores)
        super().train_one_iter()

        if k == 0:
            self._iter_weights.append(lr)
            self._sum_weight += lr
            return
        if self.config.xgboost_dart_mode:
            # XGBoost's normalize_type=tree: the new weight is lr/(k+lr)
            new_mult = 1.0 / (k + lr)       # of the lr already applied
            old_mult = k / (k + lr)
        else:
            new_mult = 1.0 / (k + 1.0)
            old_mult = k / (k + 1.0)
        # score_pre + new_mult * (the new trees' lr-scaled output)
        #           + old_mult * (the dropped trees' old contribution)
        self.score = (score_pre + (self.score - score_pre) * new_mult
                      + drop_contrib * old_mult)
        for vi in range(len(self.valid_scores)):
            self.valid_scores[vi] = (
                valid_pre[vi]
                + (self.valid_scores[vi] - valid_pre[vi]) * new_mult
                + drop_contrib_valid[vi] * old_mult)
        # the stored trees follow the scores
        for t in self.models[-K:]:
            t.shrink(new_mult)
        for i in drop_iters:
            for c in range(K):
                self.models[int(i) * K + c].shrink(old_mult)
            self._iter_weights[int(i)] *= old_mult
        self._iter_weights.append(lr * new_mult)
        self._sum_weight = float(np.sum(self._iter_weights))
        # the rescales changed stored trees in place
        self._invalidate_forest_cache()

    def rollback_one_iter(self) -> None:
        """Drop the last iteration's trees and its weight. The rescales
        it made to the trees it dropped stay, as in the reference."""
        if self.iter_ and self._iter_weights:
            self._sum_weight -= self._iter_weights.pop()
        super().rollback_one_iter()
