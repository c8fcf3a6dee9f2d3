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
  partitioned source when the spans would not shrink the scan;
- categorical splits (``has_categorical``): a split's left set is a
  bitset over bins, and every row pass (``leaf_id``, the compacted
  buffer's ids, the partition move) routes a categorical split's rows by
  a bitset test;
- EFB (``has_bundles``): the bins are the bundled physical matrix
  (``io/bundling.py``). The pool, the sibling subtraction and the kernel
  stay physical; the split search sees each leaf's histogram expanded to
  the logical features (``expand_hist``), and every row pass reads the
  winning feature's physical column and inverts the bundle relabeling;
- monotone constraints (``has_monotone``): each leaf carries an output
  range ``[lower, upper]`` (±inf at the root); a split's child outputs
  are clipped to the split leaf's range and the split search sees the
  children's ranges. The basic method gives both children the midpoint
  of their outputs as a shared bound; the intermediate method recomputes
  every range each round from the current outputs of the opposite
  subtree of each constrained ancestor (``[L, L+1]`` membership
  matrices), with a shared midpoint where one round splits leaves on
  both sides of a constrained node;
- the split search's options: ``feature_fraction_bynode`` (each search
  keeps exactly ``ceil(frac * n)`` of a leaf's allowed features, by the
  smallest of a ``[C, F]`` draw), ``extra_trees`` (one threshold per
  leaf and feature, from a ``[C, F]`` draw), ``path_smooth`` (each leaf
  carries its parent's output), ``feature_contri``, interaction
  constraints (``[L+1, F]`` path features: a leaf searches the union of
  the groups that hold its whole path), and CEGB (a split penalty, the
  coupled per-feature one, and the lazy one: the child's rows that never
  acquired the feature, counted by one ``index_add_`` a round). The
  draws of a search come from the caller with the JAX package's shapes
  and tags (``[1, F]`` at the root, tag ``L + 7``; ``[2 Kb, F]`` for a
  round's children, inactive lanes included, tag ``split_idx``);
- forced splits: a preorder table whose entries wait for their parent,
  then take their target leaves' lanes in forced rounds in which no
  other leaf splits; an entry whose child would get no rows (or at
  ``max_depth``) is skipped with its subtree. The entries' state lives
  on the host; a forced round reads its lanes' child counts (from the
  target leaves' histograms) in place of the leaf election.

The JAX package's ``lax.while_loop`` becomes a host-driven loop of device
ops with one host sync per round (the top-k leaf election), plus, under
the partition, one read of the largest elected span (the budget that the
JAX package picks on the device with ``lax.switch``). Tree arrays carry
one trailing TRASH slot (node L-1, leaf L) so inactive batch lanes write
harmlessly, exactly as in the JAX package, so both produce the same
arrays. The advanced monotone method, rebuild mode and the distributed
modes are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..io.bundling import build_expand_maps
from ..ops.bins import gather_bins
from ..ops.histogram import multi_leaf_histogram
from ..ops.partition import partition_move, slice_spans, span_budgets, \
    update_tables
from ..ops.split import NEG_INF, SplitConfig, calc_leaf_output, clip, \
    find_best_split, leaf_gain, smooth_output
from ..utils.fp import f32 as round_f32, fma


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
    # categorical split search (grow_tree's `is_cat` argument)
    has_categorical: bool = False
    max_cat_threshold: int = 32
    cat_smooth: float = 10.0
    cat_l2: float = 10.0
    max_cat_to_onehot: int = 4
    min_data_per_group: int = 100
    # EFB: the bins are the bundled physical matrix (grow_tree's `bundle`
    # argument); the split search expands histograms to logical features
    has_bundles: bool = False
    # monotone constraints (grow_tree's `mono` argument): "basic" bounds,
    # or the intermediate method's per-round recomputation; and the
    # monotone_penalty gain factor by depth
    has_monotone: bool = False
    monotone_intermediate: bool = False
    monotone_penalty: float = 0.0
    # forced splits: entries in the preorder forced-split table
    # (grow_tree's `forced` argument); while entries wait, only their
    # target leaves split
    n_forced: int = 0
    # per-node column sampling: each leaf searches exactly
    # ceil(frac * n_allowed) of its allowed features, drawn from
    # grow_tree's `node_draws`
    feature_fraction_bynode: float = 1.0
    # interaction constraints (grow_tree's `groups` argument): a leaf
    # searches the union of the groups that hold every feature on its path
    has_interaction: bool = False
    # CEGB: the split penalty (tradeoff * penalty_split * count), the
    # per-feature coupled penalty (grow_tree's `cegb_pen`) and the lazy
    # per-row one (grow_tree's `lazy`)
    has_cegb: bool = False
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0
    has_cegb_lazy: bool = False
    # path smoothing: leaf outputs shrink toward their parent's output
    path_smooth: float = 0.0
    # extra_trees: one random numerical threshold per feature and leaf,
    # drawn from grow_tree's `extra_draws` (which honour extra_seed)
    extra_trees: bool = False
    # feature_contri gain factors (grow_tree's `contri` argument)
    has_contri: bool = False

    @property
    def cat_words(self) -> int:
        """32-bit words per categorical bitset (over bins)."""
        return (self.num_bins + 31) // 32

    @property
    def split_config(self) -> SplitConfig:
        return SplitConfig(
            lambda_l1=self.lambda_l1, lambda_l2=self.lambda_l2,
            min_data_in_leaf=self.min_data_in_leaf,
            min_sum_hessian_in_leaf=self.min_sum_hessian_in_leaf,
            min_gain_to_split=self.min_gain_to_split,
            max_delta_step=self.max_delta_step,
            has_categorical=self.has_categorical,
            max_cat_threshold=self.max_cat_threshold,
            cat_smooth=self.cat_smooth, cat_l2=self.cat_l2,
            max_cat_to_onehot=self.max_cat_to_onehot,
            min_data_per_group=self.min_data_per_group,
            has_monotone=self.has_monotone,
            monotone_penalty=self.monotone_penalty,
            has_cegb=self.has_cegb, cegb_tradeoff=self.cegb_tradeoff,
            cegb_penalty_split=self.cegb_penalty_split,
            path_smooth=self.path_smooth, extra_trees=self.extra_trees,
            has_contri=self.has_contri)


class BundleMaps(NamedTuple):
    """Device form of an EFB plan (``io/bundling.py``): the expansion
    gather ``map_pf / map_pb / map_valid`` ``[F, B]``, ``at_default``
    ``[F, B]`` float32 (1 at each bundled feature's default bin), and per
    logical feature ``bundled``, ``phys_col``, ``start`` and
    ``default_bin`` ``[F]`` for routing rows on the physical columns;
    ``bundled_idx`` ``[F_b]`` lists the bundled features and
    ``bundled_bins`` is the most bins one of them has (past it their
    expanded bins are zero)."""

    map_pf: torch.Tensor
    map_pb: torch.Tensor
    map_valid: torch.Tensor
    at_default: torch.Tensor
    bundled: torch.Tensor
    phys_col: torch.Tensor
    start: torch.Tensor
    default_bin: torch.Tensor
    bundled_idx: torch.Tensor
    bundled_bins: int

    @classmethod
    def from_plan(cls, plan, num_bins: np.ndarray, B: int,
                  device: torch.device) -> "BundleMaps":
        mpf, mpb, mvalid, mdef = build_expand_maps(plan, num_bins, B)

        def dev(a, dtype=None):
            t = torch.as_tensor(a, device=device)
            return t if dtype is None else t.to(dtype)

        idx = np.flatnonzero(plan.bundled)
        return cls(dev(mpf, torch.int64), dev(mpb, torch.int64),
                   dev(mvalid), dev(mdef, torch.float32),
                   dev(plan.bundled), dev(plan.phys_col, torch.int64),
                   dev(plan.start, torch.int32),
                   dev(plan.default_bin, torch.int32),
                   dev(idx, torch.int64),
                   int(np.asarray(num_bins)[idx].max(initial=1)))


# XLA's CPU backend sums jnp.sum over an axis of more than 32 elements by
# windows of 32 (its tree-reduction rewrite)
_SUM_WINDOW = 32


def sum_bins(x: torch.Tensor, length: Optional[int] = None
             ) -> torch.Tensor:
    """Sum over axis 2 of ``[C, F, n, ...]`` in the order XLA's CPU backend
    sums ``jnp.sum`` over an axis of ``length`` (default n) elements, the
    ones past n being +0.0: the axis is padded with zeros to a multiple of
    32 (half the padding in front, rounded down), each window of 32 is
    summed in sequence from 0, then the window sums the same way.
    ``torch.sum`` adds in other orders on the CPU and the card, which
    moves a residual by ULPs. A sum in sequence from +0.0 is never -0.0,
    so adding zeros leaves it as it is: windows past the last entry are
    left out, and so are the leading pad's adds."""
    N = x.shape[2] if length is None else length
    n = x.shape[2]
    nw = -(-N // _SUM_WINDOW)
    lo = (nw * _SUM_WINDOW - N) // 2
    if N <= _SUM_WINDOW or lo + n <= _SUM_WINDOW:
        # every entry in the first window; the other windows sum to +0.0
        acc = torch.zeros_like(x[:, :, 0])
        for v in x.unbind(2):
            acc = acc + v
        return acc
    used = -(-(lo + n) // _SUM_WINDOW)
    pad = used * _SUM_WINDOW - lo - n
    z = x.new_zeros(x.shape[:2] + (max(lo, pad),) + x.shape[3:])
    x = torch.cat([z[:, :, :lo], x, z[:, :, :pad]], dim=2)
    w = x.reshape(x.shape[:2] + (used, _SUM_WINDOW) + x.shape[3:])
    acc = torch.zeros_like(w[:, :, :, 0])
    for v in w.unbind(3):
        acc = acc + v
    return sum_bins(acc, nw)


def expand_hist(hists: torch.Tensor, totals: torch.Tensor,
                bundle: BundleMaps) -> torch.Tensor:
    """Physical ``[C, F_phys, B, 3]`` histograms -> logical ``[C, F, B,
    3]`` (the JAX package's ``expand_hist``): each feature's bins gathered
    through ``map_pf / map_pb`` (zero where not ``map_valid``), and each
    bundled feature's default-bin mass recovered as the leaf total
    ``totals [C, 3]`` less its other bins, injected at ``at_default``.
    The residual is summed for the bundled features only, over their
    bins: elsewhere ``at_default`` is 0 and the bins are +0.0."""
    g = hists[:, bundle.map_pf, bundle.map_pb]
    g = torch.where(bundle.map_valid[None, :, :, None], g, 0.0)
    gb = g[:, bundle.bundled_idx, :bundle.bundled_bins]
    resid = torch.zeros_like(g[:, :, 0])
    resid[:, bundle.bundled_idx] = (totals[:, None, :]
                                    - sum_bins(gb, g.shape[2]))
    return g + bundle.at_default[None, :, :, None] * resid[:, :, None, :]


def _intermediate_bounds(mono_left: torch.Tensor, mono_right: torch.Tensor,
                         mono: torch.Tensor, split_feature: torch.Tensor,
                         leaf_vcw: torch.Tensor, split_idx: int,
                         num_leaves: int, tl_safe: torch.Tensor,
                         valid: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The intermediate method's output range ``(lower, upper)`` ``[Kb]``
    of each leaf split this round (IntermediateLeafConstraints, as the
    JAX package computes it): every constrained node ``[L]`` bounds the
    leaves of one subtree by the current outputs of the other (the min
    and max over the ``[L, L+1]`` memberships ``mono_left`` /
    ``mono_right``). Where this round splits leaves on both sides of a
    constrained node, each side would read the other's outputs from
    before the round and their children could cross, so that node binds
    both sides at the midpoint of its two sides instead."""
    dev = leaf_vcw.device
    L = mono_left.shape[0]
    big = float("inf")
    node_ok = torch.arange(L, device=dev) < split_idx
    node_m = torch.where(node_ok, mono[split_feature.to(torch.int64)],
                         0)                                       # [L]
    act = (torch.arange(L + 1, device=dev) < num_leaves)[None, :]
    vals_c = leaf_vcw[:, 0][None, :]
    in_r_act = mono_right & act
    in_l_act = mono_left & act
    rmin = torch.where(in_r_act, vals_c, big).amin(dim=1)         # [L]
    lmin = torch.where(in_l_act, vals_c, big).amin(dim=1)
    rmax = torch.where(in_r_act, vals_c, -big).amax(dim=1)
    lmax = torch.where(in_l_act, vals_c, -big).amax(dim=1)
    in_l = mono_left[:, tl_safe]                                  # [L, Kb]
    in_r = mono_right[:, tl_safe]
    both = ((in_l & valid[None, :]).any(dim=1)
            & (in_r & valid[None, :]).any(dim=1))                 # [L]
    c_inc = torch.where(both, 0.5 * (lmax + rmin), 0.0)
    c_dec = torch.where(both, 0.5 * (lmin + rmax), 0.0)
    nup_l = torch.where(both, c_inc, rmin)    # increasing, leaf on left
    nlo_r = torch.where(both, c_inc, lmax)    # increasing, leaf on right
    nup_r = torch.where(both, c_dec, lmin)    # decreasing, leaf on right
    nlo_l = torch.where(both, c_dec, rmax)    # decreasing, leaf on left
    pos = (node_m > 0)[:, None]
    neg = (node_m < 0)[:, None]
    phi = torch.where(pos & in_l, nup_l[:, None],
                      torch.where(neg & in_r, nup_r[:, None], big)
                      ).amin(dim=0)
    plo = torch.where(pos & in_r, nlo_r[:, None],
                      torch.where(neg & in_l, nlo_l[:, None], -big)
                      ).amax(dim=0)
    return plo, phi


def _top_leaves(gains: torch.Tensor, k: int):
    """The k largest gains, ties to the lower leaf id (``lax.top_k``'s
    order), as host arrays."""
    vals, idx = torch.sort(gains, descending=True, stable=True)
    return vals[:k].cpu().numpy(), idx[:k].cpu().numpy().astype(np.int64)


def _apply_splits(leaf_vec: torch.Tensor, bins_t: torch.Tensor,
                  leaf_lane: torch.Tensor, feat: torch.Tensor,
                  thr: torch.Tensor, dl: torch.Tensor, new_ids: torch.Tensor,
                  num_bin: torch.Tensor, has_nan: torch.Tensor,
                  cat: Optional[torch.Tensor] = None,
                  bitset: Optional[torch.Tensor] = None,
                  bundle: Optional[BundleMaps] = None) -> torch.Tensor:
    """Route one row set through this round's splits: a row in a split
    leaf moves to the lane's new (right) leaf unless it goes left.
    ``bins_t`` is the feature-major ``[F, n]`` matrix of those rows. With
    ``cat`` ``[Kb]`` / ``bitset`` ``[Kb, W]`` a categorical lane sends a
    row left iff bit ``col & 31`` of word ``col >> 5`` is set (NaN and
    unseen categories, bin 0, are never in the set). With ``bundle``
    ``bins_t`` is the physical ``[F_phys, n]`` matrix: the row reads the
    feature's physical column, and a bundled feature's bin is
    ``idx + (idx >= default)`` for ``idx = col - start`` in ``[0, nb - 2]``
    and its default bin otherwise (another member's bin, or all at their
    defaults)."""
    lane = leaf_lane[leaf_vec.to(torch.int64)]                # [n], -1 = none
    sel = lane >= 0
    ln = lane.clamp(min=0)
    feat_r = feat[ln].to(torch.int64)
    pcol_r = bundle.phys_col[feat_r] if bundle is not None else feat_r
    col = gather_bins(bins_t, 0, pcol_r[None, :])[0]
    nb_r = num_bin[feat_r]
    if bundle is not None:
        idx = col - bundle.start[feat_r]
        def_r = bundle.default_bin[feat_r]
        in_r = (idx >= 0) & (idx <= nb_r - 2)
        b_log = idx + (idx >= def_r).to(torch.int32)
        col = torch.where(bundle.bundled[feat_r],
                          torch.where(in_r, b_log, def_r), col)
    missing = has_nan[feat_r] & (col == nb_r - 1)
    goes_left = torch.where(missing, dl[ln], col <= thr[ln])
    if cat is not None:
        W = bitset.shape[1]
        word = bitset.reshape(-1)[ln * W + (col >> 5).to(torch.int64)]
        cat_left = ((word >> (col & 31).to(torch.int64)) & 1) > 0
        goes_left = torch.where(cat[ln], cat_left, goes_left)
    return torch.where(sel & ~goes_left, new_ids[ln], leaf_vec)


class ForcedSplits(NamedTuple):
    """The preorder forced-split table (parents before children) that
    ``grow_tree`` applies at the top of every tree, as host arrays ``[M]``:
    ``parent`` (-1 at the root entry), ``is_left``, ``feature`` (a used
    feature), ``threshold_bin``, ``is_cat``, and ``bitset`` ``[M, W]``
    (int64 words holding a categorical entry's uint32 left set over
    bins)."""

    parent: np.ndarray
    is_left: np.ndarray
    feature: np.ndarray
    threshold_bin: np.ndarray
    is_cat: np.ndarray
    bitset: np.ndarray


class _ForcedRounds:
    """A forced-split table's state within one tree (the JAX package's
    ``forced_target``), on the host, where each round's leaf choice is
    read anyway: each entry is -1 while its parent waits, then its target
    leaf (>= 0), then -3 once applied or -2 once skipped (an entry whose
    child would get no rows or that ``max_depth`` stops, and with it its
    subtree)."""

    def __init__(self, forced: ForcedSplits, num_bins: int,
                 device: torch.device):
        self.f = forced
        self.parent = np.asarray(forced.parent, np.int64)
        self.target = np.where(self.parent < 0, 0, -1).astype(np.int64)
        self.bitset = torch.as_tensor(np.asarray(forced.bitset, np.int64),
                                      device=device)
        self.bin_ax = torch.arange(num_bins, dtype=torch.int32,
                                   device=device)[None, :]
        self.device = device

    def pending(self) -> bool:
        return bool(((self.target == -1) | (self.target >= 0)).any())

    def lanes(self, Kb: int, leaf_hist: torch.Tensor, leaf_sums: torch.Tensor,
              leaf_depth: torch.Tensor, num_bin: torch.Tensor,
              has_nan: torch.Tensor, max_depth: int):
        """A forced round: the ready entries' target leaves in leaf order,
        one a lane, and no other leaf. Returns the lanes' leaves ``[Kb]``
        (-1 on free lanes), which lanes apply their entry (host bool
        ``[Kb]``: both children get rows, under ``max_depth``; one host
        read), and the entries' splits on the device: ``feature``,
        ``threshold``, ``is_cat``, ``bitset`` and the child sums
        ``lsums`` / ``rsums`` (from the target leaves' histograms) and
        ``psums``."""
        f, dev = self.f, self.device
        ready = self.target >= 0
        leaves = np.sort(self.target[ready])[:Kb]
        top_leaf = np.full(Kb, -1, np.int64)
        top_leaf[:len(leaves)] = leaves
        self.lane_match = ((top_leaf[:, None] == self.target[None, :])
                           & ready[None, :])                    # [Kb, M]
        self.flane = self.lane_match.any(axis=1)
        ent = np.where(self.flane, self.lane_match.argmax(axis=1), 0)
        fl = torch.as_tensor(self.flane, device=dev)
        feat = torch.as_tensor(np.where(self.flane, f.feature[ent], 0),
                               dtype=torch.int64, device=dev)
        thr = torch.as_tensor(np.where(self.flane, f.threshold_bin[ent], 0)
                              .astype(np.int32), device=dev)
        is_cat = torch.as_tensor(self.flane & f.is_cat[ent], device=dev)
        bitset = torch.where(fl[:, None], self.bitset[torch.as_tensor(
            ent, device=dev)], 0)
        tl = torch.as_tensor(top_leaf, device=dev).clamp(min=0)
        bin_ax = self.bin_ax
        col = leaf_hist[tl, feat]                              # [Kb, B, 3]
        nb = num_bin[feat]
        nan_bin = has_nan[feat][:, None] & (bin_ax == nb[:, None] - 1)
        word = torch.gather(bitset, 1, (bin_ax >> 5).to(torch.int64).expand(
            Kb, bin_ax.shape[1]))
        cat_left = ((word >> (bin_ax & 31).to(torch.int64)) & 1) > 0
        left = torch.where(is_cat[:, None], cat_left,
                           (bin_ax <= thr[:, None]) & ~nan_bin) \
            & (bin_ax < nb[:, None])
        lsums = sum_bins((col * left[:, :, None].to(torch.float32))[None])[0]
        psums = leaf_sums[tl]
        rsums = psums - lsums
        chk = torch.stack([lsums[:, 2], rsums[:, 2],
                           leaf_depth[tl].to(torch.float32)], dim=1)
        chk = chk.cpu().numpy()
        applied = self.flane & (chk[:, 0] > 0) & (chk[:, 1] > 0)
        if max_depth > 0:
            applied &= chk[:, 2] < max_depth
        return top_leaf, applied, dict(
            feature=feat.to(torch.int32), threshold=thr, is_cat=is_cat,
            bitset=bitset, lsums=lsums, rsums=rsums, psums=psums, lane=fl)

    def advance(self, applied: np.ndarray, tl: np.ndarray, new: np.ndarray
                ) -> None:
        """The entries' next states after a forced round whose lanes split
        leaves ``tl`` into ``tl`` (left) and ``new`` (right) where
        ``applied``: the lanes' entries applied or skipped, and the
        children of applied entries given their target leaves."""
        t, parent = self.target, self.parent
        sel = self.lane_match & applied[:, None]
        applied_e = sel.any(axis=0)
        skipped = (self.lane_match & self.flane[:, None]).any(axis=0) \
            & ~applied_e
        fp = np.clip(parent, 0, len(parent) - 1)
        pm = sel[:, fp]                                        # [Kb, M]
        child = np.where(self.f.is_left,
                         np.where(pm, tl[:, None], 0).sum(axis=0),
                         np.where(pm, new[:, None], 0).sum(axis=0))
        resolved = pm.any(axis=0) & (parent >= 0)
        dead = (parent >= 0) & (skipped[fp] | (t[fp] == -2))
        self.target = np.where(
            applied_e, -3, np.where(skipped, -2, np.where(
                t == -1, np.where(resolved, child, np.where(dead, -2, -1)),
                t)))


def bynode_mask(allow: torch.Tensor, u: torch.Tensor,
                frac: float) -> torch.Tensor:
    """Per-node column sampling (``ColSampler`` ``feature_fraction_bynode``,
    the JAX package's ``bynode_mask``): of each row of ``allow`` ``[C, F]``
    keep exactly ``ceil(frac * n_allowed)`` features, those with the
    smallest uniforms ``u`` ``[C, F]``. ``k`` is rounded up in float32."""
    F = allow.shape[1]
    uu = torch.where(allow, u, float("inf"))
    n_allow = allow.sum(dim=1).to(torch.float32)
    k_idx = (torch.ceil(round_f32(frac) * n_allow).to(torch.int64) - 1).clamp(
        0, F - 1)
    kth = torch.gather(torch.sort(uu, dim=1).values, 1, k_idx[:, None])
    return allow & (uu <= kth)


def lazy_counts(leaf_vec: torch.Tensor, not_acq: torch.Tensor,
                n_slots: int) -> torch.Tensor:
    """Rows of each leaf slot that never acquired each feature: ``[n_slots,
    F]`` float32 from the per-row leaf ids ``leaf_vec`` ``[n]`` and the 0/1
    ``not_acq`` ``[n, F]`` float32 (the JAX package's membership product,
    exact below 2^24 rows a leaf)."""
    out = torch.zeros((n_slots, not_acq.shape[1]), dtype=torch.float32,
                      device=not_acq.device)
    return out.index_add_(0, leaf_vec.to(torch.int64), not_acq)


def acquire(U: torch.Tensor, leaf_used: torch.Tensor, leaf_id: torch.Tensor,
            in_sample: torch.Tensor) -> torch.Tensor:
    """Lazy CEGB's acquisition fold after one tree (the JAX package's
    ``_cegb_u_fold``): every in-sample row acquires the features on its
    leaf's path, ``U [n, F] |= leaf_used [L, F][leaf_id] & in_sample``."""
    return U | (leaf_used[leaf_id.to(torch.int64)] & in_sample[:, None])


def grow_tree(bins_t: torch.Tensor, vals: torch.Tensor,
              feat_num_bin: torch.Tensor, feat_has_nan: torch.Tensor,
              allowed_feature: torch.Tensor, cfg: GrowConfig,
              chan_scale: Optional[torch.Tensor] = None,
              compact_bins_t: Optional[torch.Tensor] = None,
              is_cat: Optional[torch.Tensor] = None,
              bundle: Optional[BundleMaps] = None,
              mono: Optional[torch.Tensor] = None,
              groups: Optional[torch.Tensor] = None,
              cegb_pen: Optional[torch.Tensor] = None,
              contri: Optional[torch.Tensor] = None,
              lazy: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              forced: Optional[ForcedSplits] = None,
              node_draws: Optional[Callable[[int, int], torch.Tensor]]
              = None,
              extra_draws: Optional[Callable[[int, int], torch.Tensor]]
              = None
              ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Grow one tree.

    Args:
      bins_t: ``[F, n]`` uint8 (or, with more than 256 bins, uint16)
        feature-major binned matrix of all rows (with ``cfg.has_bundles``,
        the physical ``[F_phys, n]`` one).
      vals: ``[n, 3]`` float32 (grad*mask, hess*mask, count-mask) — or,
        with ``compact_bins_t``, the compacted buffer's ``[n_c, 3]``
        values.
      feat_num_bin / feat_has_nan: ``[F]`` per-feature bin metadata.
      allowed_feature: ``[F]`` bool feature mask for this tree.
      cfg: static growth config.
      chan_scale: ``[3]`` per-channel scale of quantized histograms
        (``vals`` hold integer levels); None for exact gradients.
      compact_bins_t: ``[F, n_c]`` compacted buffer (``bins_t``'s dtype)
        — with ``cfg.hist_compact`` the histograms scan it (its per-row
        values are ``vals``) while ``leaf_id`` covers all rows.
      is_cat: ``[F]`` bool categorical features; read only when
        ``cfg.has_categorical``.
      bundle: the EFB maps of ``bins_t``'s columns; read only when
        ``cfg.has_bundles``. ``feat_num_bin``, ``feat_has_nan``,
        ``allowed_feature``, ``is_cat`` and the tree arrays stay logical.
      mono: ``[F]`` int8 monotone directions in {-1, 0, +1} of the
        logical features; read only when ``cfg.has_monotone``.
      groups: ``[G, F]`` bool interaction-constraint groups; read only
        with ``cfg.has_interaction``.
      cegb_pen: ``[F]`` float32 coupled CEGB penalties (0 for features
        the model uses); read only with ``cfg.has_cegb``.
      contri: ``[F]`` float32 gain factors; read only with
        ``cfg.has_contri``.
      lazy: ``(U, penalty)`` — the ``[n, F]`` bool features each row has
        acquired (rows outside the sample count as acquired) and the
        ``[F]`` float32 lazy penalties; read only with
        ``cfg.has_cegb_lazy``.
      forced: the forced-split table; read only with ``cfg.n_forced``.
      node_draws / extra_draws: ``(tag, C) -> [C, F]`` float32 uniforms of
        one search of C leaves (tag ``L + 7`` at the root, else the
        round's first node index) for ``feature_fraction_bynode`` and
        ``extra_trees``; the options are off without them.

    Returns:
      (tree dict of fixed-size arrays + ``num_leaves`` + ``hist_rows``,
      per-row leaf_id ``[n]`` int32) — the same arrays as the JAX
      package's grow_tree; with ``cfg.has_categorical`` also ``is_cat``
      ``[L-1]`` and ``cat_bitset`` ``[L-1, W]`` (int64 words holding the
      uint32 bit patterns); with ``cfg.has_cegb_lazy`` also ``leaf_used``
      ``[L, F]``, the features on each leaf's path. ``hist_rows`` (a host
      ``np.float32``, summed in float32 like the JAX package's) counts the
      rows the histogram scans touched: the source's n once per scan on
      the masked path, the padded spans under the partition.
    """
    dev = bins_t.device
    n_rows = bins_t.shape[1]
    L = cfg.num_leaves
    B = cfg.num_bins
    F = feat_num_bin.shape[0]
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

    def leaf_out(sums, l2=cfg.lambda_l2):
        return calc_leaf_output(sums[..., 0], sums[..., 1], cfg.lambda_l1,
                                l2, cfg.max_delta_step)

    categorical = cfg.has_categorical and is_cat is not None
    W = cfg.cat_words
    # the categorical scan reads those features' histograms only (one
    # host sync a tree)
    cat_idx = torch.nonzero(is_cat)[:, 0] if categorical else None
    if not cfg.has_bundles:
        bundle = None
    monotone = cfg.has_monotone and mono is not None
    inter = monotone and cfg.monotone_intermediate
    basic = monotone and not inter
    penalized = monotone and cfg.monotone_penalty > 0.0
    if not cfg.has_interaction:
        groups = None
    if not cfg.has_cegb:
        cegb_pen = None
    if not cfg.has_contri:
        contri = None
    if not cfg.has_cegb_lazy:
        lazy = None
    if cfg.feature_fraction_bynode >= 1.0:
        node_draws = None
    if not cfg.extra_trees:
        extra_draws = None
    if cfg.n_forced <= 0:
        forced = None
    smooth = cfg.path_smooth > 0.0
    track_used = groups is not None or lazy is not None
    if lazy is not None:
        not_acq = (~lazy[0]).to(f32)
        lazy_pen = lazy[1]

        def lazy_rows(child_ids, leaf_vec, pathf=None):
            # [C] leaf slots -> [C, F]: the rows of the child that never
            # acquired the feature (search_best scales them by the
            # penalty); features already on the child's path this tree
            # cost nothing
            cnt = lazy_counts(leaf_vec, not_acq, L + 1)[child_ids]
            if pathf is not None:
                cnt = cnt * (1.0 - pathf.to(f32))
            return cnt

    def search_best(hists, sums, lowers=None, uppers=None, depths=None,
                    allows=None, parent_outs=None, round_tag=0, lazy_cnt=None):
        if bundle is not None:
            hists = expand_hist(hists, sums, bundle)
        extra = {}
        if monotone:
            extra = dict(mono=mono, out_lower=lowers, out_upper=uppers,
                         depth=depths)
        if lazy_cnt is not None:
            # the lazy penalty's product fused into the sum with the
            # coupled one, as XLA's CPU backend contracts it
            extra["cegb_pen"] = (
                lazy_cnt * lazy_pen[None, :] if cegb_pen is None
                else fma(lazy_cnt, lazy_pen[None, :], cegb_pen[None, :]))
        elif cegb_pen is not None:
            extra["cegb_pen"] = cegb_pen[None, :].expand(
                hists.shape[0], F)
        if extra_draws is not None:
            extra["extra_u"] = extra_draws(round_tag, hists.shape[0])
        return find_best_split(hists, sums, feat_num_bin, feat_has_nan,
                               allowed_feature if allows is None else allows,
                               scfg, is_cat=is_cat if categorical else None,
                               cat_idx=cat_idx, parent_out=parent_outs,
                               contri=contri, **extra)

    # ---- root ----------------------------------------------------------
    leaf_id = torch.zeros(n_rows, dtype=i32, device=dev)
    leaf_id_c = torch.zeros(n_h, dtype=i32, device=dev) if compact else None
    root_small = torch.full((Kb,), -1, dtype=i32, device=dev)
    root_small[0] = 0
    root_hist = hist_multi(leaf_id_c if compact else leaf_id,
                           root_small)[0]
    if chan_scale is not None:
        # integer levels: exact in any order
        root_sums = vals.sum(dim=0) * chan_scale
    else:
        # float32 values: in XLA's order of the JAX package's jnp.sum, the
        # same bits on the card and the CPU (torch.sum adds in another
        # order on each, and the ULP lands in every right-hand leaf's sums)
        root_sums = sum_bins(vals.T[None])[0]
    root_opts = {}
    if monotone:
        # the root's output range is unbounded
        root_opts = dict(
            lowers=torch.full((1,), float("-inf"), device=dev),
            uppers=torch.full((1,), float("inf"), device=dev))
    if penalized:
        root_opts["depths"] = torch.zeros(1, dtype=i32, device=dev)
    # features in no interaction group are never used
    root_allow = (groups.any(dim=0) & allowed_feature)[None] \
        if groups is not None else None
    if node_draws is not None:
        base = (root_allow if root_allow is not None
                else allowed_feature[None])
        root_allow = bynode_mask(base, node_draws(L + 7, 1),
                                 cfg.feature_fraction_bynode)
    root_best = search_best(
        root_hist[None], root_sums[None], allows=root_allow,
        parent_outs=leaf_out(root_sums)[None] if smooth else None,
        round_tag=L + 7,
        lazy_cnt=(lazy_rows(torch.zeros(1, dtype=torch.int64, device=dev),
                        leaf_id) if lazy is not None else None),
        **root_opts)

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
    if categorical:
        best_is_cat = torch.zeros(L + 1, dtype=torch.bool, device=dev)
        best_is_cat[0] = root_best["is_cat"][0]
        best_cat_bitset = torch.zeros((L + 1, W), dtype=torch.int64,
                                      device=dev)
        best_cat_bitset[0] = root_best["cat_bitset"][0]
        node_is_cat = torch.zeros(L, dtype=torch.bool, device=dev)
        node_cat_bitset = torch.zeros((L, W), dtype=torch.int64, device=dev)
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
    if basic:
        # each leaf's output range, unbounded at the root
        leaf_bounds = torch.stack(
            [torch.full((L + 1,), float("-inf"), device=dev),
             torch.full((L + 1,), float("inf"), device=dev)], dim=1)
    if inter:
        # membership of each leaf in the left / right subtree of each node
        mono_left = torch.zeros((L, L + 1), dtype=torch.bool, device=dev)
        mono_right = torch.zeros((L, L + 1), dtype=torch.bool, device=dev)
    if track_used:
        # the features on each leaf's path
        leaf_used = torch.zeros((L + 1, F), dtype=torch.bool, device=dev)
    rounds_f = _ForcedRounds(forced, B, dev) if forced is not None \
        else None

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

    def dev_i(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    def masked_gains():
        gains = torch.where(torch.arange(L + 1, device=dev) < num_leaves,
                            best_gain, NEG_INF)
        if cfg.max_depth > 0:
            gains = torch.where(leaf_depth < cfg.max_depth, gains, NEG_INF)
        return gains

    while split_idx < L - 1:
        remaining = (L - 1) - split_idx
        # while forced entries remain, only their target leaves split
        in_forced = rounds_f is not None and rounds_f.pending()
        if in_forced:
            top_leaf_h, applied_h, fsplit = rounds_f.lanes(
                Kb, leaf_hist, leaf_sums, leaf_depth, feat_num_bin,
                feat_has_nan, cfg.max_depth)
            valid_h = applied_h & (lanes < remaining)
            top_gain_h = np.zeros(Kb, np.float32)
        else:
            # the host sync
            top_gain_h, top_leaf_h = _top_leaves(masked_gains(), Kb)
            valid_h = np.isfinite(top_gain_h) & (lanes < remaining)
        nv = int(valid_h.sum())
        rank = np.cumsum(valid_h) - 1
        node_h = np.where(valid_h, split_idx + rank, node_trash)
        new_h = np.where(valid_h, num_leaves + rank, leaf_trash)
        tl_h = np.where(valid_h, top_leaf_h, leaf_trash)
        if in_forced:
            rounds_f.advance(applied_h, tl_h, new_h)
        if nv == 0:
            if not in_forced:
                break
            # a forced round that split nothing (every entry skipped):
            # the JAX package still scans once
            rows_scanned = np.float32(rows_scanned + np.float32(
                Kb * budgets[0] if cfg.partition and budgets else n_h))
            if rounds_f.pending() or bool(
                    torch.isfinite(masked_gains()).any()):
                continue
            break

        valid = torch.as_tensor(valid_h, device=dev)
        node_ids, new_ids, tl_safe = dev_i(node_h), dev_i(new_h), dev_i(tl_h)
        top_leaf = dev_i(top_leaf_h)
        top_gain = torch.as_tensor(top_gain_h, dtype=f32, device=dev)

        feat_sel = best_feature[tl_safe]
        thr_sel = best_threshold[tl_safe]
        dl_sel = best_default_left[tl_safe]
        lr_sel = best_lr_sums[tl_safe]                      # [Kb, 2, 3]
        lsums, rsums = lr_sel[:, 0], lr_sel[:, 1]
        route = {}
        if categorical:
            cat_sel = best_is_cat[tl_safe]
            bs_sel = best_cat_bitset[tl_safe]
        if in_forced:
            # the forced entries' splits on their lanes, recorded with the
            # plain leaf gain of their children
            fl = fsplit["lane"]
            feat_sel = torch.where(fl, fsplit["feature"], feat_sel)
            thr_sel = torch.where(fl, fsplit["threshold"], thr_sel)
            dl_sel = dl_sel & ~fl
            lsums = torch.where(fl[:, None], fsplit["lsums"], lsums)
            rsums = torch.where(fl[:, None], fsplit["rsums"], rsums)
            def gain_of(sums):
                return leaf_gain(sums[:, 0], sums[:, 1], cfg.lambda_l1,
                                 cfg.lambda_l2)
            top_gain = torch.where(
                fl, gain_of(fsplit["lsums"]) + gain_of(fsplit["rsums"])
                - gain_of(fsplit["psums"]), top_gain)
            if categorical:
                cat_sel = torch.where(fl, fsplit["is_cat"], cat_sel)
                bs_sel = torch.where(fl[:, None], fsplit["bitset"], bs_sel)
        if categorical:
            route = dict(cat=cat_sel, bitset=bs_sel)
        route["bundle"] = bundle

        # ---- partition: apply all selected splits in one row pass ------
        leaf_lane = torch.full((L + 1,), -1, dtype=torch.int64, device=dev)
        leaf_lane[dev_i(tl_h[valid_h])] = dev_i(lanes[valid_h])
        new_i32 = new_ids.to(i32)
        leaf_id = _apply_splits(leaf_id, bins_t, leaf_lane, feat_sel,
                                thr_sel, dl_sel, new_i32, feat_num_bin,
                                feat_has_nan, **route)
        # under the partition the compacted buffer's masked ids are dead
        # (histograms read the partition's ids): skip their pass
        if compact and not cfg.partition:
            leaf_id_c = _apply_splits(leaf_id_c, h_bins_t, leaf_lane,
                                      feat_sel, thr_sel, dl_sel, new_i32,
                                      feat_num_bin, feat_has_nan, **route)

        # ---- leaf-ordered repartition: one stable front/back move ------
        if cfg.partition:
            p_bins, p_vals, p_leaf = part
            leaf_mv = _apply_splits(p_leaf, p_bins, leaf_lane, feat_sel,
                                    thr_sel, dl_sel, new_i32, feat_num_bin,
                                    feat_has_nan, **route)
            nxt = 1 if cur == 0 else 0
            if bufs[nxt] is None:
                bufs[nxt] = (torch.empty_like(p_bins),
                             torch.empty_like(p_vals),
                             torch.empty_like(p_leaf))
            part, n_front, cum = partition_move(p_bins, p_vals, p_leaf,
                                               leaf_mv, out=bufs[nxt])
            part_off, part_cnt = update_tables(part_off, part_cnt, cum,
                                               n_front, tl_safe, new_ids,
                                               valid)
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
        if categorical:
            # a categorical split's children are regularized with
            # lambda_l2 + cat_l2, as its gain was
            l2c = cfg.lambda_l2 + cfg.cat_l2
            lvals = torch.where(cat_sel, leaf_out(lsums, l2c), lvals)
            rvals = torch.where(cat_sel, leaf_out(rsums, l2c), rvals)
        psums = leaf_sums[tl_safe]
        if smooth:
            # the children shrink toward the split leaf's stored output,
            # before any monotone clip
            pvals = leaf_vcw[tl_safe, 0]
            lvals = smooth_output(lvals, lsums[:, 2], pvals, cfg.path_smooth,
                                  fused="parent")
            rvals = smooth_output(rvals, rsums[:, 2], pvals, cfg.path_smooth,
                                  fused="parent")

        # ---- constraint propagation (monotone_constraints.hpp) ---------
        child_lower = child_upper = None
        if monotone:
            m_k = mono[feat_sel.to(torch.int64)].to(f32)
            if basic:
                plo, phi = leaf_bounds[tl_safe, 0], leaf_bounds[tl_safe, 1]
            else:
                plo, phi = _intermediate_bounds(
                    mono_left, mono_right, mono, split_feature, leaf_vcw,
                    split_idx, num_leaves, tl_safe, valid)
            lvals = clip(lvals, plo, phi)
            rvals = clip(rvals, plo, phi)
            if basic:
                # the midpoint of the realized outputs bounds every later
                # split below either child
                bound_l = bound_r = 0.5 * (lvals + rvals)
            else:
                # bounded by the sibling's realized output; later
                # tightenings come from the per-round recomputation
                bound_l, bound_r = rvals, lvals
            lo_l = torch.where(m_k < 0, torch.maximum(plo, bound_l), plo)
            hi_l = torch.where(m_k > 0, torch.minimum(phi, bound_l), phi)
            lo_r = torch.where(m_k > 0, torch.maximum(plo, bound_r), plo)
            hi_r = torch.where(m_k < 0, torch.minimum(phi, bound_r), phi)
            child_lower = torch.cat([lo_l, lo_r])
            child_upper = torch.cat([hi_l, hi_r])
        # ---- the children's allowed features ---------------------------
        child_allow = None
        if track_used:
            # only lanes that split extend their path set
            used_k = leaf_used[tl_safe] | (
                (feat_sel.to(torch.int64)[:, None]
                 == torch.arange(F, device=dev)[None, :]) & valid[:, None])
            child_used = torch.cat([used_k, used_k])
        if groups is not None:
            # a group is usable iff it holds every feature on the path
            viol = (used_k[:, None, :] & ~groups[None]).any(dim=2)  # [Kb, G]
            allow_k = (groups[None] & ~viol[:, :, None]).any(dim=1) \
                & allowed_feature[None]
            child_allow = torch.cat([allow_k, allow_k])
        if node_draws is not None:
            base = (child_allow if child_allow is not None
                    else allowed_feature[None].expand(2 * Kb, F))
            child_allow = bynode_mask(base, node_draws(split_idx, 2 * Kb),
                                      cfg.feature_fraction_bynode)
        if inter:
            # children inherit the split leaf's memberships, then join
            # the new node's two sides
            mono_left[:, new_ids] = mono_left[:, tl_safe]
            mono_right[:, new_ids] = mono_right[:, tl_safe]
            mono_left[node_ids, tl_safe] = True
            mono_right[node_ids, new_ids] = True

        # ---- best splits for all 2*Kb children -------------------------
        child_sums = torch.cat([lsums, rsums])
        bests = search_best(
            torch.cat([left_hist, right_hist]), child_sums, child_lower,
            child_upper, torch.cat([depth2, depth2]) if penalized else None,
            allows=child_allow,
            parent_outs=torch.cat([lvals, rvals]) if smooth else None,
            round_tag=split_idx,
            lazy_cnt=(lazy_rows(ids2, leaf_id, child_used) if lazy is not None
                  else None))

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
        if basic:
            leaf_bounds[ids2] = torch.stack([child_lower, child_upper],
                                            dim=1)
        if track_used:
            leaf_used[ids2] = child_used
        best_gain[ids2] = bests["gain"]
        best_feature[ids2] = bests["feature"]
        best_threshold[ids2] = bests["threshold_bin"]
        best_default_left[ids2] = bests["default_left"]
        best_lr_sums[ids2] = torch.stack([bests["left_sums"],
                                          bests["right_sums"]], dim=1)
        if categorical:
            best_is_cat[ids2] = bests["is_cat"]
            best_cat_bitset[ids2] = bests["cat_bitset"]
            node_is_cat[node_ids] = cat_sel
            node_cat_bitset[node_ids] = bs_sel
        split_feature[node_ids] = feat_sel
        threshold_bin[node_ids] = thr_sel
        default_left[node_ids] = dl_sel
        node_vcg[node_ids] = torch.stack(
            [leaf_vcw[tl_safe, 0] if smooth else leaf_out(psums),
             psums[:, 2], top_gain], dim=1)
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
    if categorical:
        # only with categorical features, so the numerical path's arrays
        # (and its model text) stay as they were
        tree["is_cat"] = node_is_cat[:nn]
        tree["cat_bitset"] = node_cat_bitset[:nn]
    if lazy is not None:
        # the engine folds these into the rows' acquired features
        tree["leaf_used"] = leaf_used[:L]
    return tree, leaf_id
