"""Best-split search over bin histograms (numerical features).

Reference: ``FeatureHistogram::FindBestThreshold*`` + ``SplitInfo``
(src/treelearner/feature_histogram.hpp, split_info.hpp, UNVERIFIED — empty
mount, see SURVEY.md banner): a left-to-right threshold scan per feature,
both missing-value directions, L1/L2-regularized gain, constraints
``min_data_in_leaf``, ``min_sum_hessian_in_leaf``, ``min_gain_to_split``.

The port of ``lightgbm_tpu/ops/split.py``'s numerical and categorical
paths: the numerical scan is one prefix sum over the bin axis for every
feature of every leaf at once, with both missing directions stacked, and
an argmax over ``[features, bins, directions]``; categorical features
(``SplitConfig.has_categorical``) scan one-vs-rest below
``max_cat_to_onehot`` categories, else prefixes of the bins sorted by
``grad / (hess + cat_smooth)`` in both directions, and the winner is a
``[ceil(B/32)]`` bitset of left bins. Functions take any leading batch
shape (the JAX package vmaps over leaves; here the batch dims are written
out).

Every float operation repeats the JAX package's on its CPU backend in the
same order, so identical histograms give bit-identical splits: the prefix
sums are XLA's blocked scan (``_cumsum_bins``), the sorts are stable, and
the gains are the same element-wise expressions. Monotone constraints
(``SplitConfig.has_monotone``) clip every candidate's outputs to the
leaf's inherited range, take the gains at the clipped outputs, veto the
thresholds whose outputs break the feature's direction, and scale the
gains of constrained features by ``monotone_penalty``'s depth factor
after the validity check. Path smoothing (``path_smooth``) shrinks every
candidate output toward the leaf's parent output before the clip;
``extra_trees`` keeps one threshold per numerical feature, drawn from a
uniform per (leaf, feature); ``feature_contri`` scales the valid gains of
each feature; CEGB subtracts ``cegb_tradeoff * cegb_penalty_split *
count`` plus a per-feature penalty (coupled and lazy) from every
candidate and drops those that no longer clear ``min_gain_to_split``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..utils.fp import f32, fma

NEG_INF = float("-inf")

# XLA's CPU backend computes jnp.cumsum as a blocked scan with 16-wide
# blocks, applied recursively to the block totals (checked bit for bit for
# every B <= 264 in tests/test_torch_split.py and at B = 8 to 65,536 in
# tests/test_torch_wide_bins.py)
_SCAN_BLOCK = 16


def _cumsum_bins(hist_vals: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the bin axis (-2) of ``[..., B, C]``, in
    the order XLA's CPU backend sums ``jnp.cumsum``: a sequential prefix
    inside each 16-bin block, the exclusive prefix of the block totals
    (the same scan of the totals, recursively: up to 16 blocks it is
    sequential), then one add. ``torch.cumsum`` sums in another order (in
    float64 on the CPU, in a parallel scan on the card), which moves
    near-tied split gains by ULPs."""
    return _blocked_scan(hist_vals.movedim(-2, -1)).movedim(-1, -2)


def _blocked_scan(x: torch.Tensor) -> torch.Tensor:
    """``_cumsum_bins`` over the last axis."""
    B = x.shape[-1]
    nb = -(-B // _SCAN_BLOCK)
    pad = nb * _SCAN_BLOCK - B
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
    xb = x.reshape(x.shape[:-1] + (nb, _SCAN_BLOCK))
    within = xb.clone()
    for j in range(1, _SCAN_BLOCK):
        within[..., j] = within[..., j - 1] + xb[..., j]
    tot = within[..., -1]
    if nb == 1:
        excl = torch.zeros_like(tot)       # the add still turns -0.0 to +0.0
    else:
        incl = _blocked_scan(tot)
        excl = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]],
                         dim=-1)
    return (within + excl[..., None]).reshape(x.shape)[..., :B]


@dataclasses.dataclass(frozen=True)
class SplitConfig:
    """Static split-search hyperparameters (subset of Config)."""

    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    max_delta_step: float = 0.0
    # categorical split search: one-vs-rest at most max_cat_to_onehot
    # categories, else sorted many-vs-many by grad / (hess + cat_smooth)
    # with cat_l2 added to the L2 term and min_data_per_group per child
    has_categorical: bool = False
    max_cat_threshold: int = 32
    cat_smooth: float = 10.0
    cat_l2: float = 10.0
    max_cat_to_onehot: int = 4
    min_data_per_group: int = 100
    # monotone constraints (monotone_constraints.hpp): candidate outputs
    # are clipped to the leaf's inherited [out_lower, out_upper], gains
    # taken at the clipped outputs, and thresholds whose outputs break
    # the feature's direction vetoed (find_best_split's `mono`)
    has_monotone: bool = False
    # ComputeMonotoneSplitGainPenalty: gains of splits on constrained
    # features scale by a depth factor < 1 (find_best_split's `depth`)
    monotone_penalty: float = 0.0
    # CEGB (cost_effective_gradient_boosting.hpp): every candidate's gain
    # loses cegb_tradeoff * cegb_penalty_split * count and the feature's
    # penalty (find_best_split's `cegb_pen`)
    has_cegb: bool = False
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0
    # path smoothing: candidate outputs shrink toward the leaf's parent
    # output by n / (n + path_smooth) (find_best_split's `parent_out`)
    path_smooth: float = 0.0
    # extra_trees: one threshold per numerical feature, picked by a
    # uniform (find_best_split's `extra_u`)
    extra_trees: bool = False
    # feature_contri: per-feature gain factors (find_best_split's
    # `contri`)
    has_contri: bool = False


def threshold_l1(s: torch.Tensor, l1: float) -> torch.Tensor:
    if l1 <= 0.0:
        return s
    return torch.sign(s) * torch.clamp(torch.abs(s) - l1, min=0.0)


def leaf_gain(sum_g: torch.Tensor, sum_h: torch.Tensor, l1: float,
              l2: float) -> torch.Tensor:
    """Variance-reduction leaf gain: ThresholdL1(g)^2 / (h + l2)."""
    t = threshold_l1(sum_g, l1)
    denom = sum_h + l2
    return torch.where(denom > 0.0, t * t / torch.clamp(denom, min=1e-30),
                       0.0)


def calc_leaf_output(sum_g: torch.Tensor, sum_h: torch.Tensor, l1: float,
                     l2: float, max_delta_step: float = 0.0) -> torch.Tensor:
    """Leaf output: -ThresholdL1(g) / (h + l2), optionally clipped."""
    denom = sum_h + l2
    out = torch.where(denom > 0.0,
                      -threshold_l1(sum_g, l1) / torch.clamp(denom,
                                                             min=1e-30),
                      0.0)
    if max_delta_step > 0.0:
        out = torch.clamp(out, -max_delta_step, max_delta_step)
    return out


def leaf_gain_at_output(sum_g: torch.Tensor, sum_h: torch.Tensor, l1: float,
                        l2: float, output: torch.Tensor) -> torch.Tensor:
    """Leaf gain at a given (possibly clipped) output,
    ``GetLeafSplitGainGivenOutput``: ``leaf_gain`` at the unconstrained
    optimum. ``2 t output + (h + l2) output^2`` with the first product
    fused into the sum, as XLA's CPU backend contracts it."""
    t = threshold_l1(sum_g, l1)
    return -fma(2.0 * t, output, (sum_h + l2) * output * output)


def smooth_output(raw: torch.Tensor, count: torch.Tensor,
                  parent_out: torch.Tensor, alpha: float,
                  fused: str = "raw") -> torch.Tensor:
    """Path smoothing (``USE_SMOOTHING``): ``raw * n/(n+alpha) +
    parent_out * alpha/(n+alpha)``, as ``raw * w + parent_out * (1 - w)``
    with one of the two products fused into the sum, as XLA's CPU backend
    contracts it, which depends on the fusion: ``fused="raw"`` rounds
    ``parent_out * (1 - w)`` first (the function jitted alone, and the
    leaf's own output in the split search), ``"parent"`` rounds ``raw *
    w`` first (the split search's candidate children)."""
    w = count / (count + alpha)
    if fused == "raw":
        return fma(raw, w, parent_out * (1.0 - w))
    return fma(parent_out * torch.ones_like(w), 1.0 - w, raw * w)


def monotone_penalty_factor(depth: torch.Tensor,
                            penalization: float) -> torch.Tensor:
    """Gain factor of splits on constrained features at ``depth``
    (``ComputeMonotoneSplitGainPenalty``): ~0 while depth + 1 <=
    penalization, then rising toward 1. float32, as the JAX package
    computes it."""
    eps = 1e-10
    d = depth.to(torch.float32)
    two = torch.full_like(d, 2.0)
    f_small = 1.0 - torch.full_like(d, penalization) / torch.pow(two, d) \
        + eps
    f_large = 1.0 - torch.pow(two, (penalization - 1.0) - d) + eps
    f = f_small if penalization <= 1.0 else f_large
    return torch.where(penalization >= d + 1.0, eps, f)


def clip(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
         ) -> torch.Tensor:
    """``jnp.clip``: ``min(max(x, lo), hi)`` (``hi`` where ``lo > hi``)."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _numerical_candidates(hist, parent_sums, num_bin, has_nan, num_allowed,
                          cfg: SplitConfig, mono=None, out_lower=None,
                          out_upper=None, depth=None, parent_out=None,
                          extra_u=None, contri=None):
    """Threshold-scan gains ``[..., F, B, 2]`` and left sums
    ``[..., F, B, 2, 3]`` — dir 0: missing right, dir 1: missing left.

    hist ``[..., F, B, 3]``, parent_sums ``[..., 3]``, num_bin / has_nan
    ``[F]``, num_allowed ``[..., F]`` (or ``[F]``). With
    ``cfg.has_monotone``: ``mono`` ``[F]`` in {-1, 0, +1} and the leaves'
    output ranges ``out_lower`` / ``out_upper`` ``[...]``; with
    ``cfg.monotone_penalty`` also ``depth`` ``[...]``. With
    ``cfg.path_smooth``: the leaves' parent outputs ``parent_out``
    ``[...]``; with ``cfg.extra_trees``: ``extra_u`` ``[..., F]``
    uniforms; with ``cfg.has_contri``: ``contri`` ``[F]``."""
    B = hist.shape[-2]
    dev = hist.device
    bin_idx = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
    nan_bin = (num_bin - 1)[:, None]                          # [F, 1]
    is_nan_bin = has_nan[:, None] & (bin_idx == nan_bin)      # [F, B]

    hist_vals = torch.where(is_nan_bin[..., None], 0.0, hist)
    nan_sums = torch.where(is_nan_bin[..., None], hist, 0.0).sum(dim=-2)
    cum = _cumsum_bins(hist_vals)                             # [..., F, B, 3]
    parent = parent_sums[..., None, None, None, :]

    left = torch.stack([cum, cum + nan_sums[..., None, :]], dim=-2)
    right = parent - left
    lg, lh, lc = left[..., 0], left[..., 1], left[..., 2]
    rg, rh, rc = right[..., 0], right[..., 1], right[..., 2]

    use_mono = cfg.has_monotone and mono is not None
    use_smooth = cfg.path_smooth > 0.0 and parent_out is not None
    if use_mono or use_smooth:
        l1, l2, mds = cfg.lambda_l1, cfg.lambda_l2, cfg.max_delta_step
        l_out = calc_leaf_output(lg, lh, l1, l2, mds)
        r_out = calc_leaf_output(rg, rh, l1, l2, mds)
        p_out = calc_leaf_output(parent_sums[..., 0], parent_sums[..., 1],
                                 l1, l2, mds)
        if use_smooth:
            a = cfg.path_smooth
            po = parent_out[..., None, None, None]
            l_out = smooth_output(l_out, lc, po, a, fused="parent")
            r_out = smooth_output(r_out, rc, po, a, fused="parent")
            p_out = smooth_output(p_out, parent_sums[..., 2], parent_out, a)
        if use_mono:
            # the parent's gain is taken at its clipped output too
            lo = out_lower[..., None, None, None]
            hi = out_upper[..., None, None, None]
            l_out = clip(l_out, lo, hi)
            r_out = clip(r_out, lo, hi)
            p_out = clip(p_out, out_lower, out_upper)
        parent_gain = leaf_gain_at_output(parent_sums[..., 0],
                                          parent_sums[..., 1], l1, l2, p_out)
        gain = (leaf_gain_at_output(lg, lh, l1, l2, l_out)
                + leaf_gain_at_output(rg, rh, l1, l2, r_out)
                - parent_gain[..., None, None, None])
    else:
        parent_gain = leaf_gain(parent_sums[..., 0], parent_sums[..., 1],
                                cfg.lambda_l1, cfg.lambda_l2)
        gain = (leaf_gain(lg, lh, cfg.lambda_l1, cfg.lambda_l2)
                + leaf_gain(rg, rh, cfg.lambda_l1, cfg.lambda_l2)
                - parent_gain[..., None, None, None])

    has_nan_i = has_nan.to(torch.int32)
    n_value_bins = num_bin - has_nan_i
    # thresholds t split value-bins {<=t} | {>t}; the extra slot when a NaN
    # bin exists realizes the "all values vs NaN" split
    valid_t = bin_idx < (n_value_bins[:, None] - 1 + has_nan_i[:, None])
    valid = (valid_t[..., None]
             & num_allowed[..., None, None]
             & (lc >= cfg.min_data_in_leaf) & (rc >= cfg.min_data_in_leaf)
             & (lh >= cfg.min_sum_hessian_in_leaf)
             & (rh >= cfg.min_sum_hessian_in_leaf)
             & (gain > cfg.min_gain_to_split))
    if use_mono:
        # +1 (increasing): the left output must not exceed the right
        valid = valid & ~((mono[:, None, None].to(torch.float32)
                           * (l_out - r_out)) > 0)
    if cfg.extra_trees and extra_u is not None:
        # one threshold per feature, below num_bin - 1 whether or not the
        # last bin is the NaN bin
        t_extra = (extra_u * (num_bin - 1).to(torch.float32)
                   ).to(torch.int32)                          # [..., F]
        valid = valid & (bin_idx == t_extra[..., None])[..., None]
    if cfg.has_contri and contri is not None:
        # after the validity check, which sees the unscaled gain
        gain = gain * contri[:, None, None]
    if cfg.monotone_penalty > 0.0 and use_mono and depth is not None:
        # after the validity check, as the reference scales the gain
        # found by FindBestThreshold
        pf = monotone_penalty_factor(depth, cfg.monotone_penalty)
        gain = torch.where((mono != 0)[:, None, None],
                           gain * pf[..., None, None, None], gain)
    return torch.where(valid, gain, NEG_INF), left


def _pack_bitset(inset: torch.Tensor) -> torch.Tensor:
    """Pack a ``[..., B]`` bool left-set into ``[..., ceil(B/32)]`` words:
    int64 holding the uint32 bit patterns of the JAX package's words."""
    B = inset.shape[-1]
    W = (B + 31) // 32
    if W * 32 > B:
        inset = torch.cat([inset, inset.new_zeros(
            inset.shape[:-1] + (W * 32 - B,))], dim=-1)
    shifts = torch.arange(32, dtype=torch.int64, device=inset.device)
    words = inset.reshape(inset.shape[:-1] + (W, 32)).to(torch.int64) \
        << shifts
    return words.sum(dim=-1)


def _categorical_candidates(hist, parent_sums, num_bin, cat_allowed,
                            cfg: SplitConfig, out_lower=None, out_upper=None,
                            parent_out=None, contri=None, cegb_pen=None):
    """Candidate categorical gains ``[..., Fc, 3, B]`` over the modes
    (one-hot, sorted ascending, sorted descending), the two sort orders
    ``[..., Fc, 2, B]``, the sorted prefix sums ``[..., Fc, 2, B, 3]`` and
    the valid bins ``[..., Fc, B]``.

    hist ``[..., Fc, B, 3]``, parent_sums ``[..., 3]``, num_bin ``[Fc]``,
    cat_allowed ``[..., Fc]`` (or ``[Fc]``): the features scanned here and
    allowed in this leaf. Bin 0 (NaN and unseen categories) never enters
    a left set. With monotone bounds (``out_lower`` / ``out_upper``
    ``[...]``) the gains are taken at outputs clipped to the leaves'
    ranges, as on the numerical scan; the features carry no direction.
    ``parent_out`` ``[...]`` smooths the outputs (``cfg.path_smooth``),
    ``contri`` ``[Fc]`` scales the finite gains (``cfg.has_contri``) and
    ``cegb_pen`` ``[..., Fc]`` adds to CEGB's split penalty
    (``cfg.has_cegb``), before the argmax."""
    B = hist.shape[-2]
    dev = hist.device
    bin_idx = torch.arange(B, dtype=torch.int32, device=dev)
    cnt = hist[..., 2]
    l1, l2c = cfg.lambda_l1, cfg.lambda_l2 + cfg.cat_l2
    pg, ph, pc = (parent_sums[..., i] for i in range(3))
    mds = cfg.max_delta_step
    bounded = cfg.has_monotone and out_lower is not None
    smoothed = cfg.path_smooth > 0.0 and parent_out is not None
    if bounded or smoothed:
        p_out = calc_leaf_output(pg, ph, l1, l2c, mds)
        if smoothed:
            p_out = smooth_output(p_out, pc, parent_out, cfg.path_smooth)
        if bounded:
            p_out = clip(p_out, out_lower, out_upper)
        parent_gain = leaf_gain_at_output(pg, ph, l1, l2c, p_out)
    else:
        parent_gain = leaf_gain(pg, ph, l1, l2c)
    min_cnt = float(max(cfg.min_data_in_leaf, cfg.min_data_per_group))
    valid_bin = ((bin_idx >= 1) & (bin_idx < num_bin[:, None]) & (cnt > 0)
                 & cat_allowed[..., None])                     # [..., Fc, B]

    def child_gain(lg, lh, lc, extra_dims):
        # parent sums broadcast over [Fc, B] (+ the sort direction)
        def p(a):
            return a.reshape(a.shape + (1,) * extra_dims)
        rg, rh, rc = p(pg) - lg, p(ph) - lh, p(pc) - lc
        if bounded or smoothed:
            lo_out = calc_leaf_output(lg, lh, l1, l2c, mds)
            ro_out = calc_leaf_output(rg, rh, l1, l2c, mds)
            if smoothed:
                po = p(parent_out)
                lo_out = smooth_output(lo_out, lc, po, cfg.path_smooth,
                                       fused="parent")
                ro_out = smooth_output(ro_out, rc, po, cfg.path_smooth,
                                       fused="parent")
            if bounded:
                lo, hi = p(out_lower), p(out_upper)
                lo_out = clip(lo_out, lo, hi)
                ro_out = clip(ro_out, lo, hi)
            g = (leaf_gain_at_output(lg, lh, l1, l2c, lo_out)
                 + leaf_gain_at_output(rg, rh, l1, l2c, ro_out)
                 - p(parent_gain))
        else:
            g = (leaf_gain(lg, lh, l1, l2c) + leaf_gain(rg, rh, l1, l2c)
                 - p(parent_gain))
        ok = ((lc >= min_cnt) & (rc >= min_cnt)
              & (lh >= cfg.min_sum_hessian_in_leaf)
              & (rh >= cfg.min_sum_hessian_in_leaf)
              & (g > cfg.min_gain_to_split))
        return torch.where(ok, g, NEG_INF)

    # ---- one-hot (one category vs rest) ----------------------------
    use_onehot = (num_bin - 1) <= cfg.max_cat_to_onehot       # [Fc]
    gain_oh = child_gain(hist[..., 0], hist[..., 1], cnt, 2)
    gain_oh = torch.where(valid_bin & use_onehot[:, None], gain_oh, NEG_INF)

    # ---- sorted many-vs-many ---------------------------------------
    # stable sorts (jnp.argsort's); invalid bins sort last both ways
    ratio = torch.where(valid_bin, hist[..., 0] / (hist[..., 1]
                                                   + cfg.cat_smooth),
                        float("inf"))
    order_asc = torch.sort(ratio, dim=-1, stable=True).indices
    order_desc = torch.sort(torch.where(valid_bin, -ratio, float("inf")),
                            dim=-1, stable=True).indices
    orders = torch.stack([order_asc, order_desc], dim=-2)     # [..., Fc, 2, B]
    src = hist.unsqueeze(-3).expand(hist.shape[:-2] + (2, B, 3))
    sorted_hist = torch.gather(src, -2, orders[..., None].expand(
        orders.shape + (3,)))                             # [..., Fc, 2, B, 3]
    sorted_valid = torch.gather(
        valid_bin.unsqueeze(-2).expand(orders.shape), -1, orders)
    cum = _cumsum_bins(sorted_hist)
    # a prefix is valid while every bin in it is (jnp.cumprod of the flags)
    prefix_ok = torch.cumsum((~sorted_valid).to(torch.int32), dim=-1) == 0
    gain_sorted = child_gain(cum[..., 0], cum[..., 1], cum[..., 2], 3)
    gain_sorted = torch.where(
        prefix_ok & (bin_idx < cfg.max_cat_threshold)
        & ~use_onehot[:, None, None] & cat_allowed[..., None, None],
        gain_sorted, NEG_INF)                                 # [..., Fc, 2, B]
    all_gain = torch.cat([gain_oh.unsqueeze(-2), gain_sorted], dim=-2)
    if cfg.has_contri and contri is not None:
        all_gain = torch.where(torch.isfinite(all_gain),
                               all_gain * contri[:, None, None], all_gain)
    if cfg.has_cegb:
        # penalized before the argmax, as on the numerical scan
        all_gain = all_gain - _cegb_penalty(cfg, pc, cegb_pen)[
            ..., None, None]
        all_gain = torch.where(all_gain > cfg.min_gain_to_split, all_gain,
                               NEG_INF)
    return all_gain, orders, cum, valid_bin


def _cegb_penalty(cfg: SplitConfig, count: torch.Tensor,
                  cegb_pen: Optional[torch.Tensor],
                  fused: bool = True) -> torch.Tensor:
    """CEGB's penalty of splitting leaves of ``count`` ``[...]`` rows:
    ``[..., 1]``, or ``[..., F]`` with the per-feature ``cegb_pen``, the
    split penalty's product fused into that sum where XLA's CPU backend
    contracts it (the candidate scans; not the per-feature vote)."""
    a = f32(cfg.cegb_tradeoff * cfg.cegb_penalty_split)
    if cegb_pen is None:
        return a * count[..., None]
    if fused:
        return fma(count[..., None].expand_as(cegb_pen), a, cegb_pen)
    return a * count[..., None] + cegb_pen


def _categorical_best(hist, parent_sums, num_bin, cat_allowed,
                      cfg: SplitConfig, out_lower=None, out_upper=None,
                      parent_out=None, contri=None, cegb_pen=None):
    """Best categorical split of each leaf (reference:
    ``FindBestThresholdCategoricalInner``, through the JAX package's
    ``_categorical_best``). Ties go to the first index of the flattened
    ``[Fc, 3, B]`` candidates. Returns (gain ``[...]``, feature ``[...]``
    (an index into the scanned features), left sums ``[..., 3]``, left
    set ``[..., B]`` bool over bins)."""
    B = hist.shape[-2]
    dev = hist.device
    all_gain, orders, cum, valid_bin = _categorical_candidates(
        hist, parent_sums, num_bin, cat_allowed, cfg, out_lower, out_upper,
        parent_out, contri, cegb_pen)
    flat = all_gain.flatten(-3)
    best = torch.argmax(flat, dim=-1, keepdim=True)
    best_gain = torch.gather(flat, -1, best)[..., 0]
    best = best[..., 0]
    feature = best // (3 * B)
    mode = (best // B) % 3                                    # 0 one-hot
    j = best % B
    bin_idx = torch.arange(B, device=dev)
    onehot_inset = bin_idx == j[..., None]                    # [..., B]

    def at_feature(a):
        # a[..., feature, ...] for each leaf
        idx = feature.reshape(feature.shape + (1,) * (a.dim()
                                                      - feature.dim()))
        idx = idx.expand(feature.shape + (1,) + a.shape[feature.dim() + 1:])
        return torch.gather(a, feature.dim(), idx).squeeze(feature.dim())

    direction = (mode - 1).clamp(min=0)
    order_f, cum_f = at_feature(orders), at_feature(cum)     # [..., 2, B(,3)]
    d_idx = direction[..., None, None]
    order_w = torch.gather(order_f, -2, d_idx.expand(
        direction.shape + (1, B)))[..., 0, :]                 # [..., B]
    inv = torch.empty_like(order_w).scatter_(
        -1, order_w, bin_idx.expand(order_w.shape).contiguous())
    sorted_inset = (inv <= j[..., None]) & at_feature(valid_bin)
    inset = torch.where((mode == 0)[..., None], onehot_inset, sorted_inset)
    left_oh = torch.gather(at_feature(hist), -2, j[..., None, None].expand(
        j.shape + (1, 3)))[..., 0, :]
    cum_d = torch.gather(cum_f, -3, d_idx[..., None].expand(
        direction.shape + (1, B, 3)))[..., 0, :, :]           # [..., B, 3]
    left_sorted = torch.gather(cum_d, -2, j[..., None, None].expand(
        j.shape + (1, 3)))[..., 0, :]
    left_sums = torch.where((mode == 0)[..., None], left_oh, left_sorted)
    return best_gain, feature, left_sums, inset


def per_feature_gains(hist, parent_sums, num_bin, has_nan, allowed_feature,
                      cfg: SplitConfig, is_cat=None, cat_idx=None,
                      mono=None, out_lower=None, out_upper=None,
                      cegb_pen=None, parent_out=None, extra_u=None,
                      contri=None, depth=None) -> torch.Tensor:
    """Best achievable gain per feature ``[..., F]`` — the local vote of
    the voting-parallel learner (PV-Tree). The arguments are
    ``find_best_split``'s; the gains are CEGB-penalized."""
    categorical = cfg.has_categorical and cat_idx is not None
    num_allowed = allowed_feature & ~is_cat if categorical \
        else allowed_feature
    gain, _ = _numerical_candidates(
        hist, parent_sums, num_bin, has_nan, num_allowed, cfg, mono=mono,
        out_lower=out_lower, out_upper=out_upper, depth=depth,
        parent_out=parent_out, extra_u=extra_u, contri=contri)
    pf = gain.flatten(-2).amax(dim=-1)
    if cfg.has_cegb:
        pf = torch.where(torch.isfinite(pf),
                         pf - _cegb_penalty(cfg, parent_sums[..., 2],
                                            cegb_pen, fused=False), pf)
    if categorical:
        all_gain, _, _, _ = _categorical_candidates(
            hist.index_select(-3, cat_idx), parent_sums, num_bin[cat_idx],
            allowed_feature.index_select(-1, cat_idx), cfg,
            out_lower=out_lower, out_upper=out_upper, parent_out=parent_out,
            contri=None if contri is None else contri[cat_idx],
            cegb_pen=(None if cegb_pen is None
                      else cegb_pen.index_select(-1, cat_idx)))
        pf_cat = torch.full_like(pf, NEG_INF)
        pf_cat[..., cat_idx] = all_gain.flatten(-2).amax(dim=-1)
        pf = torch.maximum(pf, pf_cat)
    return pf


def elect_best(gathered: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Election of per-child best splits across devices: ``gathered``
    holds every device's records stacked on a leading device axis
    (``[D, C, ...]``, the all-gather of ``SyncUpGlobalBestSplit``); keep
    the max-gain device's entry per child (the first on ties)."""
    win = torch.argmax(gathered["gain"], dim=0)                # [C]

    def take(a):
        idx = win.reshape((1, -1) + (1,) * (a.dim() - 2)).expand(
            (1,) + a.shape[1:])
        return torch.gather(a, 0, idx)[0]

    return {k: take(v) for k, v in gathered.items()}


def find_best_split(hist: torch.Tensor, parent_sums: torch.Tensor,
                    num_bin: torch.Tensor, has_nan: torch.Tensor,
                    allowed_feature: torch.Tensor,
                    cfg: SplitConfig, is_cat: Optional[torch.Tensor] = None,
                    cat_idx: Optional[torch.Tensor] = None,
                    mono: Optional[torch.Tensor] = None,
                    out_lower: Optional[torch.Tensor] = None,
                    out_upper: Optional[torch.Tensor] = None,
                    depth: Optional[torch.Tensor] = None,
                    cegb_pen: Optional[torch.Tensor] = None,
                    parent_out: Optional[torch.Tensor] = None,
                    extra_u: Optional[torch.Tensor] = None,
                    contri: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
    """Best split of each leaf given its histogram.

    Args:
      hist: ``[..., F, B, 3]`` float32 — (sum_grad, sum_hess, count).
      parent_sums: ``[..., 3]`` — leaf totals (grad, hess, count).
      num_bin: ``[F]`` int32 — bins used per feature (incl. NaN bin).
      has_nan: ``[F]`` bool — whether the LAST used bin is the NaN bin.
      allowed_feature: ``[F]`` or ``[..., F]`` bool column mask.
      cfg: static hyperparameters.
      is_cat: ``[F]`` bool categorical features and ``cat_idx`` their
        ``[Fc]`` int64 indices, whose histograms alone the categorical
        scan reads (the JAX package's ``cat_positions``); read only when
        ``cfg.has_categorical``.
      mono: ``[F]`` int8 directions in {-1, 0, +1} and ``out_lower`` /
        ``out_upper`` the leaves' output ranges ``[...]`` (±inf for no
        bound, as at the root), given together; read only when
        ``cfg.has_monotone``.
      depth: ``[...]`` int32 leaf depths; read only with
        ``cfg.monotone_penalty > 0``.
      cegb_pen: ``[..., F]`` float32 per-feature CEGB penalties (coupled
        and lazy), added to the split penalty; read only with
        ``cfg.has_cegb``.
      parent_out: ``[...]`` the leaves' parent outputs; read only with
        ``cfg.path_smooth > 0``.
      extra_u: ``[..., F]`` float32 uniforms, one numerical threshold per
        feature; read only with ``cfg.extra_trees``.
      contri: ``[F]`` float32 gain factors; read only with
        ``cfg.has_contri``.

    Returns dict of ``[...]`` tensors: ``gain`` (−inf if no valid split),
    ``feature``, ``threshold_bin`` (split sends ``bin <= t`` left),
    ``default_left``, and ``left_sums`` / ``right_sums`` (``[..., 3]``);
    with ``cfg.has_categorical`` also ``is_cat`` (a categorical split?)
    and ``cat_bitset`` (``[..., ceil(B/32)]`` int64 words holding the
    uint32 left set over bins). Numerical ties go to the first candidate
    in (feature, bin, direction) order; a categorical split wins only
    with a strictly larger gain.
    """
    B = hist.shape[-2]
    categorical = cfg.has_categorical and cat_idx is not None
    num_allowed = allowed_feature & ~is_cat if categorical \
        else allowed_feature
    bounds = {}
    if cfg.has_monotone and mono is not None:
        if out_lower is None or out_upper is None:
            raise ValueError("monotone split search needs out_lower and "
                             "out_upper")
        bounds = dict(out_lower=out_lower, out_upper=out_upper)
    else:
        mono = None
    opts = dict(parent_out=parent_out, contri=contri)
    gain, left = _numerical_candidates(hist, parent_sums, num_bin, has_nan,
                                       num_allowed, cfg, mono=mono,
                                       depth=depth, extra_u=extra_u,
                                       **bounds, **opts)
    if cfg.has_cegb:
        # candidates whose penalized gain no longer clears
        # min_gain_to_split are dropped
        gain = gain - _cegb_penalty(cfg, parent_sums[..., 2], cegb_pen)[
            ..., None, None]
        gain = torch.where(gain > cfg.min_gain_to_split, gain, NEG_INF)
    flat = gain.flatten(-3)                                   # [..., F*B*2]
    best = torch.argmax(flat, dim=-1, keepdim=True)
    best_gain = torch.gather(flat, -1, best)[..., 0]
    best = best[..., 0]
    feature = (best // (B * 2)).to(torch.int32)
    threshold_bin = ((best // 2) % B).to(torch.int32)
    default_left = (best % 2).to(torch.bool)
    left_flat = left.flatten(-4, -2)                          # [..., F*B*2, 3]
    left_best = torch.gather(
        left_flat, -2, best[..., None, None].expand(
            best.shape + (1, 3)))[..., 0, :]
    out = {}
    if categorical:
        if contri is not None:
            opts["contri"] = contri[cat_idx]
        cgain, cfeat, cleft, cinset = _categorical_best(
            hist.index_select(-3, cat_idx), parent_sums, num_bin[cat_idx],
            allowed_feature.index_select(-1, cat_idx), cfg,
            cegb_pen=(None if cegb_pen is None
                      else cegb_pen.index_select(-1, cat_idx)),
            **bounds, **opts)
        cfeat = cat_idx[cfeat]
        take_cat = cgain > best_gain
        best_gain = torch.maximum(best_gain, cgain)
        feature = torch.where(take_cat, cfeat.to(torch.int32), feature)
        threshold_bin = torch.where(take_cat, 0, threshold_bin)
        default_left = default_left & ~take_cat
        left_best = torch.where(take_cat[..., None], cleft, left_best)
        out["is_cat"] = take_cat
        out["cat_bitset"] = torch.where(take_cat[..., None],
                                        _pack_bitset(cinset), 0)
    out.update({
        "gain": best_gain,
        "feature": feature,
        "threshold_bin": threshold_bin,
        "default_left": default_left,
        "left_sums": left_best,
        "right_sums": parent_sums - left_best,
    })
    return out

