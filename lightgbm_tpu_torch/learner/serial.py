"""Leaf-wise tree learner: batched best-first growth.

Reference: ``SerialTreeLearner::Train`` (src/treelearner/serial_tree_learner
.cpp, UNVERIFIED — empty mount, see SURVEY.md banner): best-first growth —
construct the smaller new leaf's histogram, derive the sibling by
SUBTRACTION from the parent, find per-leaf best splits, expand the best
leaf, partition its rows.

The port of ``lightgbm_tpu/learner/serial.py::grow_tree`` for the subset
of ``GrowConfig`` the main path sets:

- a per-row ``leaf_id`` vector instead of per-leaf index buckets;
- BATCHED best-first: each round expands the top-``leaf_batch`` leaves
  and one histogram kernel launch builds all their smaller children's
  histograms (``leaf_batch=1`` is the reference's exact leaf-wise order);
- the ``[L+1, F, B, 3]`` histogram pool with sibling subtraction;
- ``int_hist``: quantized gradients summed exactly in the kernel;
- ``hist_compact`` (GOSS): histograms scan a compacted buffer of the
  sampled rows while the full-row ``leaf_id`` drives the score update;
- ``partition`` (tpu_hist_partition): the histogram source's rows are
  kept grouped by leaf (``ops/partition.py``), moved once per round by
  the partition-move kernel, and each round's histogram scans only the
  elected children's spans, cut to a power-of-two budget, or the whole
  partitioned source when the spans would not shrink the scan.

The JAX package's ``lax.while_loop`` becomes a host-driven loop of device
ops with one host sync per round (the top-k leaf election), plus, under
the partition, one read of the largest elected span (the budget that the
JAX package picks on the device with ``lax.switch``). Tree arrays carry
one trailing TRASH slot (node L-1, leaf L) so inactive batch lanes write
harmlessly, exactly as in the JAX package, so both produce the same
arrays. Constraints, EFB, categorical splits, forced splits, rebuild mode
and the distributed modes are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.histogram import multi_leaf_histogram
from ..ops.partition import move_cols, plan_split_move, slice_spans, \
    span_budgets, update_tables
from ..ops.split import NEG_INF, SplitConfig, calc_leaf_output, \
    find_best_split


@dataclasses.dataclass(frozen=True)
class GrowConfig:
    """Static tree-growth hyperparameters."""

    num_leaves: int = 31
    max_depth: int = -1
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    max_delta_step: float = 0.0
    num_bins: int = 256
    # number of leaves expanded per round (1 = exact reference order)
    leaf_batch: int = 1
    # quantized gradients: histogram values are integer levels, summed
    # exactly (int32) by the kernel
    int_hist: bool = False
    # GOSS histogram-only compaction: histograms scan the compacted
    # sampled-row buffer (grow_tree's `compact_bins_t` argument)
    hist_compact: bool = False
    # leaf-ordered row partition of the histogram source (all rows, or
    # the compacted buffer under hist_compact): histograms scan only the
    # elected children's spans
    partition: bool = False

    @property
    def split_config(self) -> SplitConfig:
        return SplitConfig(
            lambda_l1=self.lambda_l1, lambda_l2=self.lambda_l2,
            min_data_in_leaf=self.min_data_in_leaf,
            min_sum_hessian_in_leaf=self.min_sum_hessian_in_leaf,
            min_gain_to_split=self.min_gain_to_split,
            max_delta_step=self.max_delta_step)


def _top_leaves(gains: torch.Tensor, k: int):
    """The k largest gains, ties to the lower leaf id (``lax.top_k``'s
    order), as host arrays."""
    vals, idx = torch.sort(gains, descending=True, stable=True)
    return vals[:k].cpu().numpy(), idx[:k].cpu().numpy().astype(np.int64)


def _apply_splits(leaf_vec: torch.Tensor, bins_t: torch.Tensor,
                  leaf_lane: torch.Tensor, feat: torch.Tensor,
                  thr: torch.Tensor, dl: torch.Tensor, new_ids: torch.Tensor,
                  num_bin: torch.Tensor, has_nan: torch.Tensor
                  ) -> torch.Tensor:
    """Route one row set through this round's splits: a row in a split
    leaf moves to the lane's new (right) leaf unless it goes left.
    ``bins_t`` is the feature-major ``[F, n]`` matrix of those rows."""
    lane = leaf_lane[leaf_vec.to(torch.int64)]                # [n], -1 = none
    sel = lane >= 0
    ln = lane.clamp(min=0)
    feat_r = feat[ln].to(torch.int64)
    col = torch.gather(bins_t, 0, feat_r[None, :])[0].to(torch.int32)
    nb_r = num_bin[feat_r]
    missing = has_nan[feat_r] & (col == nb_r - 1)
    goes_left = torch.where(missing, dl[ln], col <= thr[ln])
    return torch.where(sel & ~goes_left, new_ids[ln], leaf_vec)


def grow_tree(bins_t: torch.Tensor, vals: torch.Tensor,
              feat_num_bin: torch.Tensor, feat_has_nan: torch.Tensor,
              allowed_feature: torch.Tensor, cfg: GrowConfig,
              chan_scale: Optional[torch.Tensor] = None,
              compact_bins_t: Optional[torch.Tensor] = None
              ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Grow one tree.

    Args:
      bins_t: ``[F, n]`` uint8 feature-major binned matrix of all rows.
      vals: ``[n, 3]`` float32 (grad*mask, hess*mask, count-mask) — or,
        with ``compact_bins_t``, the compacted buffer's ``[n_c, 3]``
        values.
      feat_num_bin / feat_has_nan: ``[F]`` per-feature bin metadata.
      allowed_feature: ``[F]`` bool feature mask for this tree.
      cfg: static growth config.
      chan_scale: ``[3]`` per-channel scale of quantized histograms
        (``vals`` hold integer levels); None for exact gradients.
      compact_bins_t: ``[F, n_c]`` uint8 compacted buffer — with
        ``cfg.hist_compact`` the histograms scan it (its per-row values
        are ``vals``) while ``leaf_id`` covers all rows.

    Returns:
      (tree dict of fixed-size arrays + ``num_leaves`` + ``hist_rows``,
      per-row leaf_id ``[n]`` int32) — the same arrays as the JAX
      package's grow_tree. ``hist_rows`` (a host ``np.float32``, summed
      in float32 like the JAX package's) counts the rows the histogram
      scans touched: the source's n once per scan on the masked path,
      the padded spans under the partition.
    """
    dev = bins_t.device
    F, n_rows = bins_t.shape
    L = cfg.num_leaves
    B = cfg.num_bins
    Kb = max(1, min(cfg.leaf_batch, L))
    i32, f32 = torch.int32, torch.float32
    scfg = cfg.split_config
    compact = cfg.hist_compact and compact_bins_t is not None
    h_bins_t = compact_bins_t if compact else bins_t
    h_vals_t = vals.T.contiguous()
    n_h = h_bins_t.shape[1]

    def hist_of(b_src, v_src, l_src, small_ids):
        h = multi_leaf_histogram(b_src, v_src, l_src, small_ids,
                                 num_bins=B, int_mode=cfg.int_hist)
        return h * chan_scale if chan_scale is not None else h

    def hist_multi(leaf_ids, small_ids):
        return hist_of(h_bins_t, h_vals_t, leaf_ids, small_ids)

    def leaf_out(sums):
        return calc_leaf_output(sums[..., 0], sums[..., 1], cfg.lambda_l1,
                                cfg.lambda_l2, cfg.max_delta_step)

    def search_best(hists, sums):
        return find_best_split(hists, sums, feat_num_bin, feat_has_nan,
                               allowed_feature, scfg)

    # ---- root ----------------------------------------------------------
    leaf_id = torch.zeros(n_rows, dtype=i32, device=dev)
    leaf_id_c = torch.zeros(n_h, dtype=i32, device=dev) if compact else None
    root_small = torch.full((Kb,), -1, dtype=i32, device=dev)
    root_small[0] = 0
    root_hist = hist_multi(leaf_id_c if compact else leaf_id,
                           root_small)[0]
    root_sums = vals.sum(dim=0)
    if chan_scale is not None:
        root_sums = root_sums * chan_scale
    root_best = search_best(root_hist[None], root_sums[None])

    leaf_hist = torch.zeros((L + 1,) + tuple(root_hist.shape), dtype=f32,
                            device=dev)
    leaf_hist[0] = root_hist
    leaf_sums = torch.zeros((L + 1, 3), dtype=f32, device=dev)
    leaf_sums[0] = root_sums
    leaf_depth = torch.zeros(L + 1, dtype=i32, device=dev)
    best_gain = torch.full((L + 1,), NEG_INF, dtype=f32, device=dev)
    best_gain[0] = root_best["gain"][0]
    best_feature = torch.zeros(L + 1, dtype=i32, device=dev)
    best_feature[0] = root_best["feature"][0]
    best_threshold = torch.zeros(L + 1, dtype=i32, device=dev)
    best_threshold[0] = root_best["threshold_bin"][0]
    best_default_left = torch.zeros(L + 1, dtype=torch.bool, device=dev)
    best_default_left[0] = root_best["default_left"][0]
    best_lr_sums = torch.zeros((L + 1, 2, 3), dtype=f32, device=dev)
    best_lr_sums[0, 0] = root_best["left_sums"][0]
    best_lr_sums[0, 1] = root_best["right_sums"][0]
    split_feature = torch.zeros(L, dtype=i32, device=dev)
    threshold_bin = torch.zeros(L, dtype=i32, device=dev)
    default_left = torch.zeros(L, dtype=torch.bool, device=dev)
    left_child = torch.zeros(L, dtype=i32, device=dev)
    right_child = torch.zeros(L, dtype=i32, device=dev)
    node_vcg = torch.zeros((L, 3), dtype=f32, device=dev)
    leaf_vcw = torch.zeros((L + 1, 3), dtype=f32, device=dev)
    leaf_vcw[0] = torch.stack([leaf_out(root_sums), root_sums[2],
                               root_sums[1]])
    leaf_parent = torch.full((L + 1,), -1, dtype=i32, device=dev)
    leaf_is_left = torch.zeros(L + 1, dtype=torch.bool, device=dev)

    # ---- leaf-ordered row partition (cfg.partition) -------------------
    # the source's rows start as one span (the root); each round moves
    # them into one of two buffers allocated at first use (never into the
    # caller's arrays) and the next round moves them back
    if cfg.partition:
        budgets = span_budgets(n_h, Kb)
        part = (h_bins_t, h_vals_t, torch.zeros(n_h, dtype=i32, device=dev))
        part_off = torch.zeros(L + 1, dtype=i32, device=dev)
        part_cnt = torch.zeros(L + 1, dtype=i32, device=dev)
        part_cnt[0] = n_h
        bufs = [None, None]
        cur = -1                  # the buffer holding `part` (-1: inputs)
    # the root histogram scanned the whole source once
    rows_scanned = np.float32(n_h)

    node_trash = L - 1  # real nodes occupy 0..L-2
    leaf_trash = L
    lanes = np.arange(Kb)
    split_idx, num_leaves = 0, 1

    while split_idx < L - 1:
        gains = torch.where(
            torch.arange(L + 1, device=dev) < num_leaves, best_gain, NEG_INF)
        if cfg.max_depth > 0:
            gains = torch.where(leaf_depth < cfg.max_depth, gains, NEG_INF)
        top_gain_h, top_leaf_h = _top_leaves(gains, Kb)     # the host sync
        valid_h = np.isfinite(top_gain_h) & (lanes < (L - 1) - split_idx)
        nv = int(valid_h.sum())
        if nv == 0:
            break
        rank = np.cumsum(valid_h) - 1
        node_h = np.where(valid_h, split_idx + rank, node_trash)
        new_h = np.where(valid_h, num_leaves + rank, leaf_trash)
        tl_h = np.where(valid_h, top_leaf_h, leaf_trash)

        def dev_i(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=dev)

        valid = torch.as_tensor(valid_h, device=dev)
        node_ids, new_ids, tl_safe = dev_i(node_h), dev_i(new_h), dev_i(tl_h)
        top_leaf = dev_i(top_leaf_h)
        top_gain = torch.as_tensor(top_gain_h, dtype=f32, device=dev)

        feat_sel = best_feature[tl_safe]
        thr_sel = best_threshold[tl_safe]
        dl_sel = best_default_left[tl_safe]
        lr_sel = best_lr_sums[tl_safe]                      # [Kb, 2, 3]
        lsums, rsums = lr_sel[:, 0], lr_sel[:, 1]

        # ---- partition: apply all selected splits in one row pass ------
        leaf_lane = torch.full((L + 1,), -1, dtype=torch.int64, device=dev)
        leaf_lane[dev_i(tl_h[valid_h])] = dev_i(lanes[valid_h])
        new_i32 = new_ids.to(i32)
        leaf_id = _apply_splits(leaf_id, bins_t, leaf_lane, feat_sel,
                                thr_sel, dl_sel, new_i32, feat_num_bin,
                                feat_has_nan)
        # under the partition the compacted buffer's masked ids are dead
        # (histograms read the partition's ids): skip their pass
        if compact and not cfg.partition:
            leaf_id_c = _apply_splits(leaf_id_c, h_bins_t, leaf_lane,
                                      feat_sel, thr_sel, dl_sel, new_i32,
                                      feat_num_bin, feat_has_nan)

        # ---- leaf-ordered repartition: one stable front/back move ------
        if cfg.partition:
            p_bins, p_vals, p_leaf = part
            leaf_mv = _apply_splits(p_leaf, p_bins, leaf_lane, feat_sel,
                                    thr_sel, dl_sel, new_i32, feat_num_bin,
                                    feat_has_nan)
            dest, n_front, cum = plan_split_move(leaf_mv != p_leaf)
            part_off, part_cnt = update_tables(part_off, part_cnt, cum,
                                               n_front, tl_safe, new_ids,
                                               valid)
            nxt = 1 if cur == 0 else 0
            if bufs[nxt] is None:
                bufs[nxt] = (torch.empty_like(p_bins),
                             torch.empty_like(p_vals),
                             torch.empty_like(p_leaf))
            part = move_cols(p_bins, p_vals, leaf_mv, dest, out=bufs[nxt])
            cur = nxt

        # ---- smaller-child histogram + sibling subtraction -------------
        left_smaller = lsums[:, 2] <= rsums[:, 2]
        small_ids = torch.where(
            valid, torch.where(left_smaller, top_leaf, new_ids), -1).to(i32)
        span_rows = n_h
        if cfg.partition:
            # scan only the elected children's spans, at the smallest
            # budget that holds the largest (one host read per round)
            safe = small_ids.clamp(0, L).to(torch.int64)
            offs_k = part_off[safe]
            cnts_k = torch.where(small_ids >= 0, part_cnt[safe], 0)
            need = int(cnts_k.max())
            fits = [s for s in budgets if s >= need]
            if fits:
                span_rows = Kb * fits[0]
                hist_small = hist_of(*slice_spans(*part, offs_k, cnts_k,
                                                  fits[0]), small_ids)
            else:                  # masked full scan over the partition
                hist_small = hist_of(*part, small_ids)
        else:
            hist_small = hist_multi(leaf_id_c if compact else leaf_id,
                                    small_ids)
        rows_scanned = np.float32(rows_scanned + np.float32(span_rows))
        parent_hist = leaf_hist[tl_safe]
        hist_large = parent_hist - hist_small
        ls4 = left_smaller[:, None, None, None]
        left_hist = torch.where(ls4, hist_small, hist_large)
        right_hist = torch.where(ls4, hist_large, hist_small)
        ids2 = torch.cat([tl_safe, new_ids])
        leaf_hist[ids2] = torch.cat([left_hist, right_hist])

        depth2 = leaf_depth[tl_safe] + 1
        lvals = leaf_out(lsums)
        rvals = leaf_out(rsums)
        psums = leaf_sums[tl_safe]

        # ---- best splits for all 2*Kb children -------------------------
        child_sums = torch.cat([lsums, rsums])
        bests = search_best(torch.cat([left_hist, right_hist]), child_sums)

        # ---- tree wiring -----------------------------------------------
        left_child[node_ids] = (-top_leaf - 1).to(i32)
        right_child[node_ids] = (-new_ids - 1).to(i32)
        p = leaf_parent[tl_safe].to(torch.int64)
        was_left = leaf_is_left[tl_safe]
        fix_l = torch.where(valid & (p >= 0) & was_left, p, node_trash)
        fix_r = torch.where(valid & (p >= 0) & ~was_left, p, node_trash)
        left_child[fix_l] = torch.where(fix_l == node_trash,
                                        left_child[fix_l], node_ids.to(i32))
        right_child[fix_r] = torch.where(fix_r == node_trash,
                                         right_child[fix_r],
                                         node_ids.to(i32))

        leaf_sums[ids2] = child_sums
        leaf_depth[ids2] = torch.cat([depth2, depth2])
        best_gain[ids2] = bests["gain"]
        best_feature[ids2] = bests["feature"]
        best_threshold[ids2] = bests["threshold_bin"]
        best_default_left[ids2] = bests["default_left"]
        best_lr_sums[ids2] = torch.stack([bests["left_sums"],
                                          bests["right_sums"]], dim=1)
        split_feature[node_ids] = feat_sel
        threshold_bin[node_ids] = thr_sel
        default_left[node_ids] = dl_sel
        node_vcg[node_ids] = torch.stack(
            [leaf_out(psums), psums[:, 2], top_gain], dim=1)
        leaf_vcw[ids2] = torch.stack(
            [torch.cat([lvals, rvals]), child_sums[:, 2], child_sums[:, 1]],
            dim=1)
        leaf_parent[ids2] = torch.cat([node_ids, node_ids]).to(i32)
        leaf_is_left[ids2] = torch.cat(
            [torch.ones(Kb, dtype=torch.bool, device=dev),
             torch.zeros(Kb, dtype=torch.bool, device=dev)])
        split_idx += nv
        num_leaves += nv

    nn = max(L - 1, 1)
    tree = {
        "num_leaves": torch.tensor(num_leaves, dtype=i32, device=dev),
        "split_feature": split_feature[:nn],
        "threshold_bin": threshold_bin[:nn],
        "default_left": default_left[:nn],
        "left_child": left_child[:nn],
        "right_child": right_child[:nn],
        "split_gain": node_vcg[:nn, 2],
        "internal_value": node_vcg[:nn, 0],
        "internal_count": node_vcg[:nn, 1],
        "leaf_value": leaf_vcw[:L, 0],
        "leaf_count": leaf_vcw[:L, 1],
        "leaf_weight": leaf_vcw[:L, 2],
        "hist_rows": rows_scanned,
    }
    return tree, leaf_id
