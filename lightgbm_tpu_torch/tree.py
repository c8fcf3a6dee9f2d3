"""Host-side tree model: flat-array binary tree.

Reference: ``Tree`` (include/LightGBM/tree.h, src/io/tree.cpp, UNVERIFIED —
empty mount, see SURVEY.md banner): internal nodes in arrays of size
``num_leaves-1`` (split_feature, threshold, left/right child with ``~leaf``
encoding), leaves in arrays of size ``num_leaves``; both bin thresholds and
real-valued thresholds kept so prediction works on raw features.

A copy of ``lightgbm_tpu/tree.py`` without the linear-leaf and
training-continuation (``rebin``) parts, which this package does not port
yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Tree:
    """One trained tree (host numpy; device stacking happens in predict)."""

    num_leaves: int
    split_feature: np.ndarray    # [num_leaves-1] int32 (used-feature index)
    threshold_bin: np.ndarray    # [num_leaves-1] int32
    threshold_real: np.ndarray   # [num_leaves-1] float64
    default_left: np.ndarray     # [num_leaves-1] bool
    left_child: np.ndarray       # [num_leaves-1] int32 (~leaf if negative)
    right_child: np.ndarray      # [num_leaves-1] int32
    split_gain: np.ndarray       # [num_leaves-1] float32
    internal_value: np.ndarray   # [num_leaves-1] float32
    internal_count: np.ndarray   # [num_leaves-1] int64
    leaf_value: np.ndarray       # [num_leaves] float64 (shrinkage applied)
    leaf_count: np.ndarray       # [num_leaves] int64
    leaf_weight: np.ndarray      # [num_leaves] float64
    shrinkage: float = 1.0
    # categorical split support (filled when cat splits exist):
    # value-level bitsets for raw-feature predict + model text (LightGBM
    # layout: threshold_real[i] = cat idx; cat_boundaries[idx:idx+1]
    # delimit this node's uint32 words in cat_threshold)
    cat_boundaries: Optional[np.ndarray] = None
    cat_threshold: Optional[np.ndarray] = None
    is_categorical: Optional[np.ndarray] = None
    # bin-level bitsets in the device layout ([nn, W] uint32) for
    # binned-matrix prediction (engine predict / score rebuild)
    cat_bitset_bins: Optional[np.ndarray] = None

    @property
    def num_nodes(self) -> int:
        return max(self.num_leaves - 1, 0)

    def shrink(self, rate: float) -> None:
        """Tree::Shrinkage — scale leaf outputs."""
        self.leaf_value = self.leaf_value * rate
        self.internal_value = self.internal_value * rate
        self.shrinkage *= rate

    # ------------------------------------------------------------------
    def predict_raw(self, X: np.ndarray) -> np.ndarray:
        """Predict on raw feature values (used features only)."""
        n = X.shape[0]
        if self.num_leaves <= 1:
            return np.full(n, self.leaf_value[0] if len(self.leaf_value)
                           else 0.0)
        return self.leaf_value[self._leaf_index_raw(X)]

    def _cat_go_left(self, cat_idx: np.ndarray,
                     vals: np.ndarray) -> np.ndarray:
        """Vectorized category-value bitset membership (NaN/negative/
        unseen values miss the set and go right)."""
        ci = np.clip(cat_idx.astype(np.int64), 0,
                     len(self.cat_boundaries) - 2)
        start = self.cat_boundaries[ci]
        nw = self.cat_boundaries[ci + 1] - start
        iv = np.where(np.isfinite(vals) & (vals >= 0), vals, -1.0) \
            .astype(np.int64)
        w = iv >> 5
        ok = (iv >= 0) & (w < nw)
        word = self.cat_threshold[np.clip(start + w, 0,
                                          len(self.cat_threshold) - 1)]
        bit = (word >> (iv & 31).astype(np.uint32)) & np.uint32(1)
        return ok & (bit > 0)

    def _leaf_index_raw(self, X: np.ndarray) -> np.ndarray:
        n = X.shape[0]
        node = np.zeros(n, dtype=np.int64)
        active = np.ones(n, dtype=bool) if self.num_leaves > 1 else \
            np.zeros(n, dtype=bool)
        out = np.zeros(n, dtype=np.int64)
        has_cat = (self.is_categorical is not None
                   and np.any(self.is_categorical))
        # per-node missing codes (0 none / 1 zero / 2 nan), attached by
        # HostModel; without them NaN takes the default direction
        nmt = getattr(self, "node_missing_type", None)
        for _ in range(self.num_nodes + 1):
            if not active.any():
                break
            nd = node[active]
            feat = self.split_feature[nd]
            vals = X[active, feat]
            thr = self.threshold_real[nd]
            dl = self.default_left[nd]
            miss = np.isnan(vals)
            if nmt is None:
                go_left = np.where(miss, dl, vals <= thr)
            else:
                # stock semantics per missing type: none converts NaN
                # to 0.0; zero routes |x|<=1e-35 (and NaN) by default
                # direction; nan routes NaN by default direction
                mtn = nmt[nd]
                v0 = np.where(miss, 0.0, vals)
                zeroish = miss | (np.abs(v0) <= 1e-35)
                go_left = np.where(
                    mtn == 2, np.where(miss, dl, vals <= thr),
                    np.where(mtn == 1,
                             np.where(zeroish, dl, v0 <= thr),
                             v0 <= thr))
            if has_cat:
                catn = self.is_categorical[nd]
                go_left = np.where(catn, self._cat_go_left(thr, vals),
                                   go_left)
            nxt = np.where(go_left, self.left_child[nd],
                           self.right_child[nd])
            at_leaf = nxt < 0
            idx = np.flatnonzero(active)
            out[idx[at_leaf]] = -nxt[at_leaf] - 1
            node[idx] = np.maximum(nxt, 0)
            new_active = active.copy()
            new_active[idx[at_leaf]] = False
            active = new_active
        return out

    def predict_leaf_raw(self, X: np.ndarray) -> np.ndarray:
        if self.num_leaves <= 1:
            return np.zeros(X.shape[0], dtype=np.int64)
        return self._leaf_index_raw(X)

    def leaf_depths(self) -> np.ndarray:
        """Depth of each leaf (for model text's leaf_depth field)."""
        depth = np.zeros(self.num_leaves, dtype=np.int64)
        if self.num_leaves <= 1:
            return depth
        node_depth = np.zeros(self.num_nodes, dtype=np.int64)
        for nd in range(self.num_nodes):
            for child in (self.left_child[nd], self.right_child[nd]):
                if child >= 0:
                    node_depth[child] = node_depth[nd] + 1
                else:
                    depth[-child - 1] = node_depth[nd] + 1
        return depth

    # ------------------------------------------------------------------
    @staticmethod
    def from_device(tree_arrays: Dict[str, np.ndarray], shrinkage: float,
                    bin_mappers, used_features: List[int]) -> "Tree":
        """Build from grow_tree's device output (already on host)."""
        nl = int(tree_arrays["num_leaves"])
        nn = max(nl - 1, 0)
        sf = np.asarray(tree_arrays["split_feature"])[:nn].astype(np.int32)
        tb = np.asarray(tree_arrays["threshold_bin"])[:nn].astype(np.int32)
        is_cat = None
        cat_bs = None
        cat_boundaries = None
        cat_threshold = None
        if "is_cat" in tree_arrays:
            is_cat = np.asarray(tree_arrays["is_cat"])[:nn].astype(bool)
            cat_bs = np.asarray(tree_arrays["cat_bitset"])[:nn] \
                .astype(np.uint32)
            if not is_cat.any():
                is_cat = None
                cat_bs = None
        tr = np.zeros(nn, dtype=np.float64)
        bounds = [0]
        words_all: list = []
        for i in range(nn):
            mapper = bin_mappers[used_features[int(sf[i])]]
            if is_cat is not None and is_cat[i]:
                # bin-level bitset -> category-VALUE bitset (LightGBM
                # stores the raw category values, bin.h CategoricalBin)
                bits = np.unpackbits(
                    np.ascontiguousarray(cat_bs[i]).view(np.uint8),
                    bitorder="little")
                nb = len(mapper.bin_to_cat)
                bins_in = np.flatnonzero(bits[:nb])
                cats = mapper.bin_to_cat[bins_in]
                cats = cats[cats >= 0]
                nwords = (int(cats.max()) >> 5) + 1 if len(cats) else 1
                words = np.zeros(nwords, dtype=np.uint32)
                for v in cats:
                    words[int(v) >> 5] |= np.uint32(1) << np.uint32(v & 31)
                tr[i] = float(len(bounds) - 1)   # cat split index
                words_all.extend(words)
                bounds.append(len(words_all))
            else:
                tr[i] = mapper.bin_to_threshold(int(tb[i]))
        if is_cat is not None:
            cat_boundaries = np.asarray(bounds, dtype=np.int64)
            cat_threshold = np.asarray(words_all, dtype=np.uint32)
        t = Tree(
            num_leaves=nl,
            split_feature=sf,
            threshold_bin=tb,
            threshold_real=tr,
            default_left=np.asarray(tree_arrays["default_left"])[:nn],
            left_child=np.asarray(tree_arrays["left_child"])[:nn]
            .astype(np.int32),
            right_child=np.asarray(tree_arrays["right_child"])[:nn]
            .astype(np.int32),
            split_gain=np.asarray(tree_arrays["split_gain"])[:nn],
            internal_value=np.asarray(tree_arrays["internal_value"])[:nn],
            internal_count=np.asarray(tree_arrays["internal_count"])[:nn]
            .astype(np.int64),
            leaf_value=np.asarray(tree_arrays["leaf_value"])[:nl]
            .astype(np.float64),
            leaf_count=np.asarray(tree_arrays["leaf_count"])[:nl]
            .astype(np.int64),
            leaf_weight=np.asarray(tree_arrays["leaf_weight"])[:nl]
            .astype(np.float64),
            cat_boundaries=cat_boundaries,
            cat_threshold=cat_threshold,
            is_categorical=is_cat,
            cat_bitset_bins=cat_bs,
        )
        t.shrink(shrinkage)
        return t
