"""Binned tree traversal for prediction and score updates.

Reference: ``GBDT::PredictRaw`` + ``Tree::Predict`` (src/boosting/
gbdt_prediction.cpp, src/io/tree.cpp, UNVERIFIED — empty mount, see
SURVEY.md banner): per-row node walk by threshold comparisons.

The port of ``lightgbm_tpu/ops/predict.py::forest_predict_binned``: every
row of every tree advances one level per step by gathering its node's
attributes (the JAX package's one-hot matmul form exists because gathers
are slow on the TPU; on the card a gather is the direct form). The number
of steps is the forest's depth, computed on the host, so the loop needs no
device sync. Tree t of a multiclass forest belongs to the class that
``class_index[t]`` names (the stack may be any subset of trees, as DART's
dropped trees are); per-class scores add the trees' leaf values in tree order, as the JAX
package does, so float32 sums agree bit for bit. Where the forest carries
``is_cat`` / ``cat_bitset``, a categorical node sends a row left iff its
bin's bit is set in the node's bitset, so NaN and unseen categories (bin 0)
go right.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from .bins import index_bins


def forest_predict_binned(stacked: Dict[str, torch.Tensor],
                          bins: torch.Tensor, feat_num_bin: torch.Tensor,
                          feat_has_nan: torch.Tensor, max_depth: int,
                          num_class: int = 0,
                          class_index: Optional[Sequence[int]] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route every row of ``bins`` through T stacked trees.

    Args:
      stacked: tree arrays with a leading ``[T]`` axis, node arrays padded
        to ``[T, Ln]`` and ``leaf_value`` to ``[T, L]``; optionally
        ``is_cat`` ``[T, Ln]`` and ``cat_bitset`` ``[T, Ln, W]`` (int64
        words holding uint32 bit patterns).
      bins: ``[n, F]`` uint8 or uint16 binned features.
      max_depth: the forest's depth (``Tree.leaf_depths``' maximum).
      num_class: K > 0 sums tree t into class ``class_index[t]`` (host
        ints, ``[T]``, required) of an ``[n, K]`` score; 0 sums every tree
        into one ``[n]`` score.

    Returns:
      (raw score sum ``[n]`` or ``[n, K]`` float32, leaf index per tree
      ``[T, n]``).
    """
    if num_class and class_index is None:
        raise ValueError("a multiclass forest needs its class_index")
    sf = stacked["split_feature"].to(torch.int64)            # [T, Ln]
    T, Ln = sf.shape
    n = bins.shape[0]
    dev = bins.device
    thr = stacked["threshold_bin"].to(torch.int32)
    dl = stacked["default_left"]
    lc = stacked["left_child"].to(torch.int64)
    rc = stacked["right_child"].to(torch.int64)
    nan_bin = torch.where(feat_has_nan[sf], feat_num_bin[sf] - 1, -1) \
        .to(torch.int32)
    node = torch.where(stacked["num_leaves"][:, None] > 1,
                       torch.zeros((T, n), dtype=torch.int64, device=dev),
                       torch.full((T, n), -1, dtype=torch.int64, device=dev))
    rows = torch.arange(n, device=dev)[None, :]
    has_cat = "is_cat" in stacked
    if has_cat:
        W = stacked["cat_bitset"].shape[2]
        bitset = stacked["cat_bitset"].to(torch.int64).reshape(T, Ln * W)
        node_cat = stacked["is_cat"]
    for _ in range(max_depth):
        nd = node.clamp(min=0)
        feat = torch.gather(sf, 1, nd)                        # [T, n]
        col = index_bins(bins, rows, feat)
        go_left = torch.where(col == torch.gather(nan_bin, 1, nd),
                              torch.gather(dl, 1, nd),
                              col <= torch.gather(thr, 1, nd))
        if has_cat:
            word = torch.gather(bitset, 1, nd * W + (col >> 5).to(
                torch.int64))
            cat_left = ((word >> (col & 31).to(torch.int64)) & 1) > 0
            go_left = torch.where(torch.gather(node_cat, 1, nd), cat_left,
                                  go_left)
        nxt = torch.where(go_left, torch.gather(lc, 1, nd),
                          torch.gather(rc, 1, nd))
        node = torch.where(node >= 0, nxt, node)
    leaf = -node - 1
    vals = torch.gather(stacked["leaf_value"], 1, leaf)       # [T, n]
    cols = [torch.zeros(n, dtype=torch.float32, device=dev)
            for _ in range(max(num_class, 1))]
    for t in range(T):
        c = int(class_index[t]) if num_class else 0
        cols[c] = cols[c] + vals[t]
    score = torch.stack(cols, dim=1) if num_class else cols[0]
    return score, leaf.to(torch.int32)


def tree_predict_binned(tree: Dict[str, torch.Tensor], bins: torch.Tensor,
                        feat_num_bin: torch.Tensor,
                        feat_has_nan: torch.Tensor, max_depth: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One tree: (leaf value per row ``[n]``, leaf index ``[n]``)."""
    stacked = {k: v[None] for k, v in tree.items()}
    score, leaf = forest_predict_binned(stacked, bins, feat_num_bin,
                                        feat_has_nan, max_depth)
    return score, leaf[0]
