"""Best-split search over bin histograms (numerical features).

Reference: ``FeatureHistogram::FindBestThreshold*`` + ``SplitInfo``
(src/treelearner/feature_histogram.hpp, split_info.hpp, UNVERIFIED — empty
mount, see SURVEY.md banner): a left-to-right threshold scan per feature,
both missing-value directions, L1/L2-regularized gain, constraints
``min_data_in_leaf``, ``min_sum_hessian_in_leaf``, ``min_gain_to_split``.

The port of the numerical path of ``lightgbm_tpu/ops/split.py``: the scans
are one prefix sum over the bin axis for every feature of every leaf at
once, with both missing directions stacked, and an argmax over
``[features, bins, directions]``. Functions take any leading batch shape
(the JAX package vmaps over leaves; here the batch dims are written out).

Every float operation repeats the JAX package's on its CPU backend in the
same order, so identical histograms give bit-identical splits: the prefix
sum is XLA's blocked scan (``_cumsum_bins``), and the gains are the same
element-wise expressions. Categorical, monotone, CEGB, path-smoothing,
extra-trees and feature-contribution variants are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

NEG_INF = float("-inf")

# XLA's CPU backend computes jnp.cumsum over an axis of up to a few hundred
# elements as a blocked scan with 16-wide blocks (checked bit for bit for
# every B <= 264 in tests/test_torch_split.py)
_SCAN_BLOCK = 16


def _cumsum_bins(hist_vals: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the bin axis (-2) of ``[..., B, C]``, in
    the order XLA's CPU backend sums ``jnp.cumsum``: a sequential prefix
    inside each 16-bin block, a sequential exclusive prefix of the block
    totals, then one add. ``torch.cumsum`` sums in another order (in
    float64 on the CPU, in a parallel scan on the card), which moves
    near-tied split gains by ULPs."""
    x = hist_vals.movedim(-2, -1)                        # [..., C, B]
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
    excl = torch.zeros_like(tot)
    for j in range(1, nb):
        excl[..., j] = excl[..., j - 1] + tot[..., j - 1]
    out = (within + excl[..., None]).reshape(x.shape)[..., :B]
    return out.movedim(-1, -2)


@dataclasses.dataclass(frozen=True)
class SplitConfig:
    """Static split-search hyperparameters (subset of Config)."""

    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    max_delta_step: float = 0.0


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


def _numerical_candidates(hist, parent_sums, num_bin, has_nan, num_allowed,
                          cfg: SplitConfig):
    """Threshold-scan gains ``[..., F, B, 2]`` and left sums
    ``[..., F, B, 2, 3]`` — dir 0: missing right, dir 1: missing left.

    hist ``[..., F, B, 3]``, parent_sums ``[..., 3]``, num_bin / has_nan
    ``[F]``, num_allowed ``[..., F]`` (or ``[F]``)."""
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
    return torch.where(valid, gain, NEG_INF), left


def per_feature_gains(hist, parent_sums, num_bin, has_nan, allowed_feature,
                      cfg: SplitConfig) -> torch.Tensor:
    """Best achievable gain per feature ``[..., F]`` — the local vote of
    the voting-parallel learner (PV-Tree)."""
    gain, _ = _numerical_candidates(hist, parent_sums, num_bin, has_nan,
                                    allowed_feature, cfg)
    return gain.flatten(-2).amax(dim=-1)


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
                    cfg: SplitConfig) -> Dict[str, torch.Tensor]:
    """Best split of each leaf given its histogram.

    Args:
      hist: ``[..., F, B, 3]`` float32 — (sum_grad, sum_hess, count).
      parent_sums: ``[..., 3]`` — leaf totals (grad, hess, count).
      num_bin: ``[F]`` int32 — bins used per feature (incl. NaN bin).
      has_nan: ``[F]`` bool — whether the LAST used bin is the NaN bin.
      allowed_feature: ``[F]`` or ``[..., F]`` bool column mask.
      cfg: static hyperparameters.

    Returns dict of ``[...]`` tensors: ``gain`` (−inf if no valid split),
    ``feature``, ``threshold_bin`` (split sends ``bin <= t`` left),
    ``default_left``, and ``left_sums`` / ``right_sums`` (``[..., 3]``).
    Ties go to the first candidate in (feature, bin, direction) order.
    """
    B = hist.shape[-2]
    gain, left = _numerical_candidates(hist, parent_sums, num_bin, has_nan,
                                       allowed_feature, cfg)
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
    return {
        "gain": best_gain,
        "feature": feature,
        "threshold_bin": threshold_bin,
        "default_left": default_left,
        "left_sums": left_best,
        "right_sums": parent_sums - left_best,
    }

