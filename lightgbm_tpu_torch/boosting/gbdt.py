"""GBDT boosting engine: the per-iteration training loop.

Reference: ``GBDT::TrainOneIter`` (src/boosting/gbdt.cpp, UNVERIFIED —
empty mount, see SURVEY.md banner): gradients from the objective →
(GOSS subset) → train one tree → shrinkage → update train + valid scores.

The port of ``lightgbm_tpu/boosting/gbdt.py`` for the main paths: every
objective, with K trees an iteration for multiclass
(one per class, all on the same row and feature masks, the scores an
``[n_pad, K]`` tensor), serial learner, full-row steps (with bagging,
per-tree feature_fraction and the leaf-ordered row partition of
``tpu_hist_partition``) and GOSS steps (masked, or with the compacted
histogram buffer of ``tpu_goss_compact``), exact or quantized gradients
with stochastic rounding, categorical features (bitset splits) and the
host leaf renewal of L1, quantile and MAPE, and the ranking objectives
(query-grouped gradients; rank_xendcg's per-iteration gammas;
position-debiased lambdarank's per-position state, threaded from one
iteration's gradients to the next). Scores and the binned
matrices stay on the device across iterations; each iteration copies the
finished trees' flat arrays to the host. ``gradients``, ``quantize`` and
``goss_masks`` are pure functions that take their uniform draws as
tensors; the draws come from a noise object (``utils/random.py``).
Bagging and feature masks are drawn on the host from
``numpy.random.RandomState(bagging_seed / feature_fraction_seed)``
exactly as the JAX package draws them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import capabilities
from ..config import Config
from ..io.dataset import Dataset
from ..learner.serial import GrowConfig, grow_tree
from ..metric import eval_metric_rows, metrics_for_config
from ..objective import Objective, create_objective
from ..ops.compact import compact_by_mask, compaction_out_cols
from ..ops.predict import forest_predict_binned, tree_predict_binned
from ..tree import Tree
from ..utils import log
from ..utils.random import TorchNoise

def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_rows(n_rows: int, rows_per_block: int) -> int:
    """Padded row count: whole blocks, at least one."""
    return _ceil_to(max(n_rows, rows_per_block), rows_per_block)


def resolve_device(device_type: str) -> torch.device:
    """The torch device for ``device_type`` ("cuda" or "cpu"). CUDA
    without a visible card is an error: the package never falls back to
    the CPU unasked."""
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        log.fatal("device_type='cuda' (the default) needs a CUDA device and "
                  "torch sees none; pass device_type='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


class DeviceData:
    """Device-resident binned data + metadata for one dataset: the
    row-major ``[n_pad, F]`` uint8 bins, optionally the feature-major
    ``[F, n_pad]`` copy the histogram and compaction kernels read, and
    label / weight / validity padded to ``n_pad`` rows (a multiple of
    ``rows_per_block``). Padding rows are bin 0 with validity 0."""

    def __init__(self, bins: torch.Tensor, bins_t: Optional[torch.Tensor],
                 n: int, label: Optional[torch.Tensor],
                 weight: Optional[torch.Tensor],
                 init_score: Optional[np.ndarray] = None,
                 query_boundaries: Optional[np.ndarray] = None):
        self.bins = bins
        self.bins_t = bins_t
        self.n = n
        self.n_pad = bins.shape[0]
        self.label = label
        self.weight = weight
        self.init_score = init_score
        self.query_boundaries = query_boundaries
        self.valid_mask = (torch.arange(self.n_pad, device=bins.device)
                           < n).to(torch.float32)

    @classmethod
    def from_dataset(cls, ds: Dataset, rows_per_block: int,
                     device: torch.device, transposed: bool
                     ) -> "DeviceData":
        ds.construct()
        n = ds.num_data
        n_pad = pad_rows(n, rows_per_block)
        binned = ds.binned
        if n_pad > n:
            binned = np.concatenate(
                [binned, np.zeros((n_pad - n, binned.shape[1]),
                                  binned.dtype)])
        bins = torch.from_numpy(np.ascontiguousarray(binned)).to(device)
        bins_t = bins.T.contiguous() if transposed else None
        md = ds.metadata

        def pad1(a):
            if a is None:
                return None
            out = np.zeros(n_pad, np.float32)
            out[:n] = a
            return torch.from_numpy(out).to(device)

        return cls(bins, bins_t, n, pad1(md.label), pad1(md.weight),
                   md.init_score, md.query_boundaries)


# ---------------------------------------------------------------------------
# pure step functions (the JAX package's closures in _build_step)
# ---------------------------------------------------------------------------
def quantize(gk_m: torch.Tensor, hk_m: torch.Tensor,
             mask_count: torch.Tensor, glevels: int, hlevels: int,
             noise: Optional[Tuple[torch.Tensor, torch.Tensor]]
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradient quantization (use_quantized_grad; reference:
    cuda_gradient_discretizer.cu): grad/hess become integer levels with
    stochastic rounding offsets ``noise = (ng, nh)`` (None = nearest).
    Returns (grad levels, hess levels, per-channel scale ``[3]``). The
    level counts divide as tensors: CUDA divides a tensor by a Python
    number as a product with its reciprocal, which at 15 levels is not
    the quotient the CPU and the JAX package compute."""
    gmax = torch.max(torch.abs(gk_m))
    hmax = torch.max(hk_m)
    scale_g = torch.clamp(gmax / torch.as_tensor(
        glevels, dtype=gmax.dtype, device=gmax.device), min=1e-30)
    scale_h = torch.clamp(hmax / torch.as_tensor(
        hlevels, dtype=hmax.dtype, device=hmax.device), min=1e-30)
    ng, nh = noise if noise is not None else (0.0, 0.0)
    gq = torch.round(gk_m / scale_g + ng)
    hq = torch.round(hk_m / scale_h + nh)
    # stochastic rounding must not resurrect masked-out rows
    live = mask_count > 0
    gq = torch.where(live, gq, 0.0)
    hq = torch.where(live, hq, 0.0)
    scale = torch.stack([scale_g, scale_h, torch.ones_like(scale_g)])
    return gq, hq, scale


def goss_masks(g: torch.Tensor, h: torch.Tensor, valid_mask: torch.Tensor,
               u: torch.Tensor, k_top: int, k_rand: int, top_rate: float,
               other_rate: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """GOSS (goss.hpp): keep the top ``k_top`` rows by |g*h| (summed over
    the classes of ``[n, K]`` gradients; ties by row index), sample
    exactly ``min(k_rand, rest)`` of the rest — the smallest uniform
    draws ``u`` (ties by row index) — and amplify the sampled rest by
    (1-a)/b. Returns (mask_gh, mask_count)."""
    metric = torch.abs(g * h)
    if metric.dim() == 2:
        # class after class, as XLA reduces the short class axis
        per_class = metric
        metric = per_class[:, 0]
        for k in range(1, per_class.shape[1]):
            metric = metric + per_class[:, k]
    metric = metric * valid_mask
    n_local = metric.shape[0]
    n_valid = torch.sum(valid_mask)
    k_rest = torch.clamp(n_valid - k_top, min=1.0)
    if k_top < n_local:
        thresh = torch.topk(metric, k_top).values[k_top - 1]
    else:
        thresh = torch.sort(metric).values[max(n_local - k_top, 0)]
    valid = valid_mask > 0
    above = (metric > thresh) & valid
    k_need = k_top - above.sum(dtype=torch.int32)
    tie = (metric == thresh) & valid
    tie_rank = torch.cumsum(tie.to(torch.int32), 0, dtype=torch.int32)
    is_top = above | (tie & (tie_rank <= k_need))
    rest = valid & ~is_top
    k_cap = torch.minimum(torch.tensor(float(k_rand), device=g.device),
                          k_rest).to(torch.int32)
    uu = torch.where(rest, u, float("inf"))
    if 0 < k_rand < n_local:
        u_small = torch.topk(uu, k_rand, largest=False).values
        u_thresh = u_small[(k_cap - 1).clamp(0, k_rand - 1)]
    elif k_rand == 0:
        u_thresh = torch.tensor(0.0, device=g.device)
    else:
        u_thresh = torch.sort(uu).values[(k_cap - 1).clamp(0, n_local - 1)]
    strictly = rest & (uu < u_thresh)
    at_t = rest & (uu == u_thresh)
    need = k_cap - strictly.sum(dtype=torch.int32)
    at_rank = torch.cumsum(at_t.to(torch.int32), 0, dtype=torch.int32)
    picked = (strictly | (at_t & (at_rank <= need))) & (k_cap > 0)
    amp = (1.0 - top_rate) / max(other_rate, 1e-12)
    mask_gh = is_top.to(torch.float32) + picked.to(torch.float32) * amp
    mask_count = (is_top | picked).to(torch.float32)
    return mask_gh, mask_count


class GBDT:
    """Boosting engine (reference: GBDT class, src/boosting/gbdt.cpp).

    ``noise`` supplies the per-iteration uniforms (``TorchNoise`` by
    default); tests pass an object with the same methods that replays the
    JAX package's draws."""

    def __init__(self, config: Config, train_set: Dataset, noise=None):
        self.config = config
        capabilities.check(config)
        self.device = resolve_device(config.device_type)
        self.train_set = train_set.construct()
        if (bool(config.tpu_auto_quantize)
                and "use_quantized_grad" not in config.raw_params
                and not config.use_quantized_grad
                and self.train_set.num_data
                >= capabilities.AUTO_QUANT_MIN_ROWS
                and str(config.objective)
                in capabilities.AUTO_QUANTIZE_OBJECTIVES):
            config.use_quantized_grad = True
            log.info("tpu_auto_quantize: enabling quantized gradients for "
                     "this training; set use_quantized_grad=false to keep "
                     "f32")
        self.objective: Objective = create_objective(config)
        md = self.train_set.metadata
        if hasattr(self.objective, "prepare") and md.label is not None:
            self.objective.prepare(md.label, md.weight)
        if self.objective.is_ranking:
            self.objective.setup_queries(md.query_boundaries,
                                         self.train_set.num_data,
                                         position=md.position,
                                         device=self.device)
        # position-debiased lambdarank: the per-position propensities
        # each iteration's gradients read and replace
        self._pos_state = (self.objective.init_pos_state()
                           if self.objective.has_pos_state else None)
        self.metrics = metrics_for_config(config)
        self.num_class = config.num_tree_per_iteration
        self.average_output = False
        self.models: List[Tree] = []
        self.iter_ = 0
        dev = self.device

        n = self.train_set.num_data
        self.rows_per_block = min(config.tpu_rows_per_block,
                                  pad_rows(max(1, n), 256))
        F = len(self.train_set.used_features)
        num_bin = self.train_set.feature_num_bins()
        self.B = max(8, _ceil_to(int(num_bin.max()) if F else 2, 8))
        is_cat = np.array(
            [self.train_set.bin_mappers[f].bin_type == "categorical"
             for f in self.train_set.used_features], dtype=bool)
        # a categorical NaN or unseen category is bin 0 and routes by a
        # bitset miss, not by the numerical last-bin NaN convention
        has_nan = np.array(
            [self.train_set.bin_mappers[f].missing_type == "nan"
             for f in self.train_set.used_features], dtype=bool) & ~is_cat
        self.feat_num_bin = torch.as_tensor(num_bin.astype(np.int32),
                                            device=dev)
        self.feat_has_nan = torch.as_tensor(has_nan, device=dev)
        self.has_categorical = bool(is_cat.any())
        self.feat_is_cat = torch.as_tensor(is_cat, device=dev)
        self.num_features = F
        self.allowed = torch.ones(F, dtype=torch.bool, device=dev)
        self.data = DeviceData.from_dataset(self.train_set,
                                            self.rows_per_block, dev,
                                            transposed=True)
        self.hist_partition = self._engage_partition(F)
        label = md.label
        # BoostFromAverage for one tree an iteration; per-class init
        # scores stay 0 (the JAX package's GBDT.__init__)
        self.init_scores = np.zeros(self.num_class, dtype=np.float64)
        if label is not None and self.num_class == 1:
            self.init_scores[0] = self.objective.init_score(label, md.weight)
        self.score = self._init_score(self.data)
        self.valid_data: List[DeviceData] = []
        self.valid_scores: List[torch.Tensor] = []
        self.valid_names: List[str] = []
        self.noise = noise if noise is not None else TorchNoise(
            config.objective_seed, dev)

        c = config
        self.use_quant = bool(c.use_quantized_grad)
        qbins = max(2, int(c.num_grad_quant_bins))
        # the level counts as device tensors (quantize divides by them)
        self.glevels = torch.tensor(float(max(qbins // 2, 1)), device=dev)
        self.hlevels = torch.tensor(float(max(qbins - 1, 1)), device=dev)
        self.use_sr = bool(c.stochastic_rounding)
        self.grow_cfg = GrowConfig(
            num_leaves=c.num_leaves, max_depth=c.max_depth,
            lambda_l1=c.lambda_l1, lambda_l2=c.lambda_l2,
            min_data_in_leaf=c.min_data_in_leaf,
            min_sum_hessian_in_leaf=c.min_sum_hessian_in_leaf,
            min_gain_to_split=c.min_gain_to_split,
            max_delta_step=c.max_delta_step, num_bins=self.B,
            leaf_batch=max(1, c.tpu_leaf_batch),
            # the int32 accumulator must hold qbins * n_rows
            int_hist=(self.use_quant and qbins <= 127
                      and self.data.n_pad * qbins < 2**31),
            partition=self.hist_partition,
            has_categorical=self.has_categorical,
            max_cat_threshold=c.max_cat_threshold,
            cat_smooth=c.cat_smooth, cat_l2=c.cat_l2,
            max_cat_to_onehot=c.max_cat_to_onehot,
            min_data_per_group=c.min_data_per_group)

        # ---- GOSS (goss.hpp) ------------------------------------------
        # goss.hpp truncates the DOUBLE product rate * cnt; the counts
        # are static (the padding mask is the only row mask under GOSS)
        self.top_rate = float(c.top_rate)
        self.other_rate = float(c.other_rate)
        self.goss_k_top = max(1, int(n * self.top_rate))
        self.goss_k_rand = int(n * self.other_rate)
        # compaction block size: <= 1024 and a divisor of n_pad
        self.compact_rpb = math.gcd(1024, self.rows_per_block)
        frac = self.top_rate + self.other_rate
        self.goss_n_sub = compaction_out_cols(
            int(np.ceil(self.data.n_pad * frac)) + 8192,
            self.compact_rpb, self.rows_per_block)
        # renewing objectives and position debiasing keep the masked
        # GOSS path, as the JAX package does
        self.use_goss_compact = (
            bool(c.tpu_goss_compact) and c.data_sample_strategy == "goss"
            and not self.objective.renews
            and not self.objective.has_pos_state
            and frac < 1.0 and self.compact_rpb >= 256
            # the buffer (sampled rows + write slack) must shrink the scan
            and self.goss_n_sub < self.data.n_pad)
        self._stack_cache: Optional[Tuple[Tuple[int, int, int], Dict,
                                          int]] = None

        self._rng_feature = np.random.RandomState(c.feature_fraction_seed)
        self._rng_bagging = np.random.RandomState(c.bagging_seed)
        self._bag_mask: Optional[torch.Tensor] = None
        # rows the histogram scans touched, summed over all trees (the
        # JAX package's hist.rows_scanned counter)
        self.hist_rows_scanned = 0.0

    def _engage_partition(self, F: int) -> bool:
        """``tpu_hist_partition``: "true" engages the leaf-ordered row
        partition on any device, "false" and "auto" never (the JAX
        package's auto engages it on its Pallas path at 2^20 padded rows;
        on the card it measured slower at every size,
        ``capabilities.PARTITION_STAND_DOWN``)."""
        c = self.config
        mode = str(c.tpu_hist_partition)
        engage = mode == "true" and F > 0
        if mode == "auto" and self.device.type == "cuda":
            log.info(f"tpu_hist_partition=auto: staying on masked "
                     f"histograms ({capabilities.PARTITION_STAND_DOWN}); "
                     f"set tpu_hist_partition=true to force")
        if engage:
            log.info("leaf-ordered row partition enabled: histograms scan "
                     "only the elected children's row spans")
        return engage

    # ------------------------------------------------------------------
    def _init_score(self, dd: DeviceData) -> torch.Tensor:
        """Device ``[n_pad, K]`` init scores + the dataset's init_score
        (n values, or n * K read row by row as the JAX package reads
        them)."""
        K = self.num_class
        s0 = np.tile(self.init_scores.astype(np.float32), (dd.n_pad, 1))
        if dd.init_score is not None:
            init = np.asarray(dd.init_score)
            if init.size not in (dd.n, dd.n * K):
                log.fatal(f"Length of init_score ({init.size}) does not "
                          f"match number of data ({dd.n}) or number of "
                          f"data * num_class ({dd.n * K})")
            s0[:dd.n] += init.reshape(dd.n, -1).astype(np.float32)
        return torch.from_numpy(s0).to(dd.bins.device)

    def add_valid(self, ds: Dataset, name: str) -> None:
        dd = DeviceData.from_dataset(ds, self.rows_per_block, self.device,
                                     transposed=False)
        score = self._init_score(dd)
        if self.models:
            score = score + self._forest_raw(dd.bins, 0, len(self.models))
        self.valid_data.append(dd)
        self.valid_scores.append(score)
        self.valid_names.append(name)

    # ------------------------------------------------------------------
    def gradients(self, score: torch.Tensor, goss: bool = False):
        """(grad, hess) at ``score`` ``[n_pad, K]``: ``[n_pad]`` each for
        one tree an iteration, ``[n_pad, K]`` for multiclass. rank_xendcg
        draws its gammas first (keyed by whether GOSS is active); position
        debiasing replaces ``_pos_state`` with the state the gradients
        return."""
        d = self.data
        obj = self.objective
        s = score[:, 0] if self.num_class == 1 else score
        if obj.needs_rng:
            Q, M = obj.query_shape
            return obj.get_gradients(s, d.label, d.weight, gammas=(
                self.noise.rank_uniforms(self.iter_, Q, M, goss)))
        if self._pos_state is not None:
            g, h, self._pos_state = obj.get_gradients(
                s, d.label, d.weight, pos_state=self._pos_state)
            return g, h
        return obj.get_gradients(s, d.label, d.weight)

    def _vals(self, gk_m, hk_m, mask_count, n_rows, k):
        """Histogram value rows ``[n, 3]`` of class ``k``'s tree +
        channel scale (None unless quantized)."""
        if not self.use_quant:
            return torch.stack([gk_m, hk_m, mask_count], dim=1), None
        draws = (self.noise.quant_uniforms(self.iter_, n_rows, k)
                 if self.use_sr else None)
        gq, hq, scale = quantize(gk_m, hk_m, mask_count, self.glevels,
                                 self.hlevels, draws)
        return torch.stack([gq, hq, mask_count], dim=1), scale

    def _goss(self, g, h):
        d = self.data
        u = self.noise.goss_uniform(self.iter_, d.n_pad)
        return goss_masks(g, h, d.valid_mask, u, self.goss_k_top,
                          self.goss_k_rand, self.top_rate, self.other_rate)

    def _feature_mask(self) -> torch.Tensor:
        """This tree's ``[F]`` feature mask (feature_fraction): ceil(F *
        frac) features drawn without replacement, draw for draw the JAX
        package's ``_feature_mask``."""
        F = self.num_features
        frac = self.config.feature_fraction
        if frac >= 1.0 or F == 0:
            return self.allowed
        mask = np.zeros(F, dtype=bool)
        k = max(1, int(np.ceil(F * frac)))
        mask[self._rng_feature.choice(F, size=k, replace=False)] = True
        return torch.from_numpy(mask).to(self.device)

    def _bagging_masks(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mask_gh, mask_count) of a full-row step, with row validity:
        every ``bagging_freq`` iterations a fresh Bernoulli draw per row
        (per label class with ``pos/neg_bagging_fraction``), draw for
        draw the JAX package's ``_bagging_masks``."""
        c = self.config
        d = self.data
        use_bagging = (c.bagging_freq > 0
                       and (c.bagging_fraction < 1.0
                            or c.pos_bagging_fraction < 1.0
                            or c.neg_bagging_fraction < 1.0))
        if not use_bagging:
            return d.valid_mask, d.valid_mask
        if self._bag_mask is None or self.iter_ % c.bagging_freq == 0:
            n = d.n
            if (c.pos_bagging_fraction < 1.0
                    or c.neg_bagging_fraction < 1.0):
                pos = np.asarray(self.train_set.metadata.label) > 0
                keep = np.zeros(n, dtype=np.float32)
                keep[pos] = (self._rng_bagging.rand(int(pos.sum()))
                             < c.pos_bagging_fraction)
                keep[~pos] = (self._rng_bagging.rand(int((~pos).sum()))
                              < c.neg_bagging_fraction)
            else:
                keep = (self._rng_bagging.rand(n)
                        < c.bagging_fraction).astype(np.float32)
            full = np.zeros(d.n_pad, dtype=np.float32)
            full[:n] = keep
            self._bag_mask = torch.from_numpy(full).to(self.device)
        return self._bag_mask, self._bag_mask

    def _step(self, goss: bool, allowed: torch.Tensor):
        """Masked full-row step: every row is scanned (or, under the
        partition, every row stays in the partitioned source), GOSS or
        bagging (or the padding) enters as per-row weights. Returns the
        K class trees' ``(tree, leaf_id)``."""
        d = self.data
        K = self.num_class
        g, h = self.gradients(self.score, goss)
        if goss:
            mask_gh, mask_count = self._goss(g, h)
        else:
            mask_gh, mask_count = self._bagging_masks()
        out = []
        for k in range(K):
            gk = g if K == 1 else g[:, k]
            hk = h if K == 1 else h[:, k]
            vals, scale = self._vals(gk * mask_gh, hk * mask_gh,
                                     mask_count, d.n_pad, k)
            out.append(grow_tree(d.bins_t, vals, self.feat_num_bin,
                                 self.feat_has_nan, allowed, self.grow_cfg,
                                 chan_scale=scale, is_cat=self.feat_is_cat))
        return out

    def _step_goss_compact(self, allowed: torch.Tensor):
        """GOSS with histogram-only compaction: the sampled rows move into
        a fixed-size buffer (``compact_by_mask``, one launch for all K
        classes' gradients) that the histograms scan; the full-row leaf
        ids and score update stay as in the masked step."""
        d = self.data
        K = self.num_class
        g, h = self.gradients(self.score, True)
        mask_gh, mask_count = self._goss(g, h)
        g2 = g[None] if K == 1 else g.T
        h2 = h[None] if K == 1 else h.T
        vals_all = torch.cat([g2, h2, mask_gh[None], mask_count[None]]) \
            .contiguous()                                     # [2K+2, n]
        bins_t_c, vc = compact_by_mask(d.bins_t, vals_all, mask_count > 0,
                                       self.goss_n_sub)
        cfg = dataclasses.replace(self.grow_cfg, hist_compact=True)
        out = []
        for k in range(K):
            gk, hk = vc[k] * vc[2 * K], vc[K + k] * vc[2 * K]
            vals_c, scale = self._vals(gk, hk, vc[2 * K + 1],
                                       self.goss_n_sub, k)
            out.append(grow_tree(d.bins_t, vals_c, self.feat_num_bin,
                                 self.feat_has_nan, allowed, cfg,
                                 chan_scale=scale, compact_bins_t=bins_t_c,
                                 is_cat=self.feat_is_cat))
        return out

    def goss_active(self) -> bool:
        """GOSS starts after 1/learning_rate iterations (goss.hpp keeps
        the first iterations un-subsampled)."""
        c = self.config
        return (c.data_sample_strategy == "goss"
                and self.iter_ >= int(1.0 / max(c.learning_rate, 1e-6)))

    def _renew(self, grown) -> None:
        """Leaf renewal (L1 / quantile / MAPE, RenewTreeOutput): each
        class tree's leaf values become the per-leaf percentiles of the
        residuals at the score BEFORE this iteration's update (host
        numpy, the JAX package's ``_leaf_percentile_renewal``)."""
        n = self.data.n
        md = self.train_set.metadata
        old = self.score[:n].cpu().numpy()
        for k, (tree, leaf_id) in enumerate(grown):
            renewed = self.objective.renew_tree_output(
                old[:, k], md.label, md.weight,
                leaf_id[:n].cpu().numpy(), self.config.num_leaves)
            tree["leaf_value"] = torch.from_numpy(
                renewed.astype(np.float32)).to(self.device)

    def train_one_iter(self) -> None:
        """One boosting iteration: K class trees."""
        lr = float(self.config.learning_rate)
        allowed = self._feature_mask()
        if self.goss_active() and self.use_goss_compact:
            grown = self._step_goss_compact(allowed)
        else:
            grown = self._step(self.goss_active(), allowed)
        if self.objective.renews:
            self._renew(grown)
        self.score = torch.stack(
            [self.score[:, k] + tree["leaf_value"][leaf_id.to(torch.int64)]
             * lr for k, (tree, leaf_id) in enumerate(grown)], dim=1)
        trees = []
        for tree, _ in grown:
            # rows the histogram scans touched (a host float32): n per
            # scan on the masked path, the elected children's padded
            # spans under the partition
            self.hist_rows_scanned += float(tree.pop("hist_rows"))
            host = {k: v.cpu().numpy() for k, v in tree.items()}
            trees.append(Tree.from_device(host, lr,
                                          self.train_set.bin_mappers,
                                          self.train_set.used_features))
        for i, dd in enumerate(self.valid_data):
            self.valid_scores[i] = torch.stack(
                [self.valid_scores[i][:, k] + tree_predict_binned(
                    tree, dd.bins, self.feat_num_bin, self.feat_has_nan,
                    int(t.leaf_depths().max()))[0] * lr
                 for k, ((tree, _), t) in enumerate(zip(grown, trees))],
                dim=1)
        self.models.extend(trees)
        self._stack_cache = None
        self.iter_ += 1

    # ------------------------------------------------------------------
    def _stacked_forest(self, start: int, count: int
                        ) -> Tuple[Dict[str, torch.Tensor], int]:
        """Trees ``[start, start + count)`` as padded device arrays (with
        each tree's class, ``t % K``) + their depth; the last slice is
        cached until the model list changes."""
        key = (len(self.models), start, count)
        if self._stack_cache is not None and self._stack_cache[0] == key:
            return self._stack_cache[1], self._stack_cache[2]
        trees = self.models[start:start + count]
        L = max(max(t.num_leaves for t in trees), 1)
        Ln = max(L - 1, 1)
        dev = self.device

        def padded(getter, size, dtype):
            out = np.zeros((len(trees), size), dtype=dtype)
            for i, t in enumerate(trees):
                a = getter(t)
                out[i, :len(a)] = a
            return torch.from_numpy(out).to(dev)

        stacked = {
            "num_leaves": torch.as_tensor(
                np.array([t.num_leaves for t in trees], np.int32),
                device=dev),
            "split_feature": padded(lambda t: t.split_feature, Ln, np.int32),
            "threshold_bin": padded(lambda t: t.threshold_bin, Ln, np.int32),
            "default_left": padded(lambda t: t.default_left, Ln, bool),
            "left_child": padded(lambda t: t.left_child, Ln, np.int32),
            "right_child": padded(lambda t: t.right_child, Ln, np.int32),
            "leaf_value": padded(lambda t: t.leaf_value.astype(np.float32),
                                 L, np.float32),
        }
        if any(t.cat_bitset_bins is not None for t in trees):
            W = max(t.cat_bitset_bins.shape[1] for t in trees
                    if t.cat_bitset_bins is not None)
            bs = np.zeros((len(trees), Ln, W), dtype=np.int64)
            for i, t in enumerate(trees):
                if t.cat_bitset_bins is not None:
                    a = t.cat_bitset_bins
                    bs[i, :a.shape[0], :a.shape[1]] = a
            stacked["is_cat"] = padded(
                lambda t: (t.is_categorical if t.is_categorical is not None
                           else np.zeros(t.num_nodes, bool)), Ln, bool)
            stacked["cat_bitset"] = torch.from_numpy(bs).to(dev)
        depth = max(int(t.leaf_depths().max()) for t in trees)
        self._stack_cache = (key, stacked, depth)
        return stacked, depth

    def _forest_raw(self, bins: torch.Tensor, start: int, count: int
                    ) -> torch.Tensor:
        """Raw scores ``[n, K]`` of trees ``[start, start + count)`` on
        binned rows, summed per class in tree order."""
        stacked, depth = self._stacked_forest(start, count)
        raw, _ = forest_predict_binned(stacked, bins, self.feat_num_bin,
                                       self.feat_has_nan, depth,
                                       self.num_class, start)
        return raw

    def eval_set(self, which: int) -> List[Tuple[str, str, float, bool]]:
        """Evaluate metrics: which=-1 train, else valid index."""
        if which < 0:
            dd, name, score = self.data, "training", self.score
        else:
            dd = self.valid_data[which]
            name = self.valid_names[which]
            score = self.valid_scores[which]
        raw = score.cpu().numpy()[:dd.n]
        label = dd.label.cpu().numpy()[:dd.n] if dd.label is not None \
            else None
        weight = dd.weight.cpu().numpy()[:dd.n] if dd.weight is not None \
            else None
        return eval_metric_rows(self.objective, self.metrics, name, raw,
                                label, weight, self.num_class,
                                dd.query_boundaries)

    def predict(self, X, raw_score: bool = False, start_iteration: int = 0,
                num_iteration: int = -1) -> np.ndarray:
        """Predict on raw features (binned through the train mappers):
        ``[n]`` for one tree an iteration, ``[n, K]`` for multiclass.
        Iterations ``[start_iteration, start_iteration + num_iteration)``
        (all from ``start_iteration`` when ``num_iteration <= 0``); the
        init scores count only from iteration 0."""
        X = Dataset._to_matrix(X)
        if X.shape[1] != self.train_set.num_total_features:
            log.fatal(f"The number of features in data ({X.shape[1]}) is "
                      f"not the same as it was in training data "
                      f"({self.train_set.num_total_features})")
        n, K = X.shape[0], self.num_class
        total = len(self.models) // K
        if num_iteration <= 0:
            num_iteration = total - start_iteration
        num_iteration = min(num_iteration, total - start_iteration)
        if num_iteration > 0:
            bins = torch.from_numpy(self.train_set.bin_rows(X)).to(
                self.device)
            raw = self._forest_raw(bins, start_iteration * K,
                                   num_iteration * K)
            raw = raw.cpu().numpy().astype(np.float64)
        else:
            raw = np.zeros((n, K), np.float64)
        if start_iteration == 0:
            raw = raw + self.init_scores[None, :]
        if K == 1:
            raw = raw[:, 0]
        if raw_score:
            return raw
        return self.objective.convert_output(
            torch.from_numpy(raw.astype(np.float32))).numpy()

    @property
    def current_iteration(self) -> int:
        return self.iter_
