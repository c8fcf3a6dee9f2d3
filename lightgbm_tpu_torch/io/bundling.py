"""Exclusive Feature Bundling (EFB).

Reference: ``DatasetLoader`` FindGroups / FastFeatureBundling
(src/io/dataset_loader.cpp, UNVERIFIED — empty mount, see SURVEY.md
banner): sparse features that are (almost) never non-default on the same
row are merged into one physical column whose bins are the union of the
members' non-default bins at disjoint offsets, so the histogram kernel
scans F_phys columns instead of F.

The port's copy of ``lightgbm_tpu/io/bundling.py`` (host numpy, the same
arrays for the same inputs): bundling is a static bin-level relabeling
decided on the host when the engine is built. The learner scans the
bundled matrix (``[n, F_phys]``) and expands each leaf's physical
histogram back to logical features with the ``[F, B] -> (phys_col,
phys_bin)`` gather of ``build_expand_maps`` (each bundled feature's
default-bin mass is recovered as the leaf's residual,
``learner/serial.py::expand_hist``), so splits are exactly the unbundled
ones when ``max_conflict_rate=0``.

The "default" of a feature is the bin its zero value falls in; it may
sit anywhere in the bin range, so physical offsets skip over it.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class BundlePlan:
    """Static bundling layout shared by train and valid matrices."""

    bundles: List[List[int]]        # each: logical feature idx list
    phys_col: np.ndarray            # [F] physical column per feature
    start: np.ndarray               # [F] offset of the 1st non-def bin
    default_bin: np.ndarray         # [F] the feature's default bin
    bundled: np.ndarray             # [F] bool: True if in a multi-bundle
    n_phys: int
    phys_num_bin: np.ndarray        # [F_phys]


def find_bundles(binned: np.ndarray, num_bins: np.ndarray,
                 eligible: np.ndarray, default_bins: np.ndarray,
                 max_conflict_rate: float = 0.0,
                 sample_cnt: int = 50_000, max_bundle_bins: int = 256,
                 seed: int = 0) -> List[List[int]]:
    """Greedy conflict-bounded grouping (FindGroups): order features by
    non-default count, place each into the first bundle whose
    accumulated conflict count stays within ``max_conflict_rate``."""
    n, F = binned.shape
    rng = np.random.default_rng(seed)
    rows = (np.arange(n) if n <= sample_cnt
            else rng.choice(n, size=sample_cnt, replace=False))
    sub = binned[rows]
    nz = [np.flatnonzero(sub[:, f] != default_bins[f]) for f in range(F)]
    nnz = np.array([len(z) for z in nz])
    max_conflicts = int(max_conflict_rate * len(rows))

    order = np.argsort(-nnz, kind="stable")
    bundles: List[List[int]] = []
    bundle_mask: List[np.ndarray] = []      # rows already non-default
    bundle_conf: List[int] = []
    bundle_bins: List[int] = []
    for f in order:
        f = int(f)
        if not eligible[f]:
            continue
        if nnz[f] > 0.5 * len(rows):
            continue                         # dense: not worth bundling
        placed = False
        fmask = np.zeros(len(rows), dtype=bool)
        fmask[nz[f]] = True
        for bi in range(len(bundles)):
            extra_bins = int(num_bins[f]) - 1
            if bundle_bins[bi] + extra_bins > max_bundle_bins:
                continue
            conf = int(np.count_nonzero(bundle_mask[bi] & fmask))
            if bundle_conf[bi] + conf <= max_conflicts:
                bundles[bi].append(f)
                bundle_mask[bi] |= fmask
                bundle_conf[bi] += conf
                bundle_bins[bi] += extra_bins
                placed = True
                break
        if not placed:
            bundles.append([f])
            bundle_mask.append(fmask)
            bundle_conf.append(0)
            bundle_bins.append(1 + int(num_bins[f]) - 1)

    # full-data verification: the sample can miss conflicts, and
    # apply_bundles relabels EVERY row — enforce the conflict budget on
    # the full matrix, evicting the worst offender until it holds
    full_budget = int(max_conflict_rate * n)
    out = []
    for grp in (b for b in bundles if len(b) >= 2):
        grp = list(grp)
        while len(grp) >= 2:
            nd = np.stack([binned[:, f] != default_bins[f] for f in grp])
            cnt = nd.sum(axis=0)
            conflict_rows = cnt > 1
            if int(np.count_nonzero(conflict_rows)) <= full_budget:
                break
            share = (nd & conflict_rows[None, :]).sum(axis=1)
            grp.pop(int(np.argmax(share)))
        if len(grp) >= 2:
            out.append(grp)
    return out


def plan_bundles(num_bins: np.ndarray, default_bins: np.ndarray,
                 multi_bundles: List[List[int]]) -> BundlePlan:
    """Column/offset layout: multi-feature bundles first, then singleton
    identity columns for everything else. Within a bundle column, bin 0
    means "every member at its default"; member f's non-default bins
    occupy ``[start_f, start_f + num_bins_f - 2]``."""
    F = len(num_bins)
    phys_col = np.zeros(F, dtype=np.int32)
    start = np.zeros(F, dtype=np.int32)
    bundled = np.zeros(F, dtype=bool)
    phys_num_bin: List[int] = []
    col = 0
    for grp in multi_bundles:
        off = 1                              # bin 0 = all-defaults
        for f in grp:
            phys_col[f] = col
            start[f] = off
            bundled[f] = True
            off += int(num_bins[f]) - 1
        phys_num_bin.append(off)
        col += 1
    for f in range(F):
        if not bundled[f]:
            phys_col[f] = col
            start[f] = 0                     # identity (all bins)
            phys_num_bin.append(int(num_bins[f]))
            col += 1
    return BundlePlan(bundles=multi_bundles, phys_col=phys_col,
                      start=start,
                      default_bin=np.asarray(default_bins, np.int32),
                      bundled=bundled, n_phys=col,
                      phys_num_bin=np.asarray(phys_num_bin, np.int32))


def apply_bundles(binned: np.ndarray, plan: BundlePlan) -> np.ndarray:
    """Relabel a logical binned matrix [n, F] into the physical bundled
    matrix [n, F_phys]. A member's non-default bin b maps to
    ``start + b - (b > default)`` (the default bin is skipped in the
    enumeration). Conflicting rows (several members non-default,
    possible when max_conflict_rate > 0) keep the LAST member's value."""
    n, F = binned.shape
    dtype = (np.uint8 if int(plan.phys_num_bin.max(initial=1)) <= 256
             else np.uint16)
    out = np.zeros((n, plan.n_phys), dtype=dtype)
    for f in range(F):
        col = plan.phys_col[f]
        b = binned[:, f].astype(np.int64)
        if plan.bundled[f]:
            d = int(plan.default_bin[f])
            nd = b != d
            idx = b[nd] - (b[nd] > d)
            out[nd, col] = (plan.start[f] + idx).astype(dtype)
        else:
            out[:, col] = b.astype(dtype)
    return out


def build_expand_maps(plan: BundlePlan, num_bins: np.ndarray, B: int):
    """Precompute the physical->logical histogram gather:
    ``map_pf/map_pb [F, B]``, ``map_valid [F, B]`` and ``at_default
    [F, B]`` (the slot where each bundled feature's residual default-bin
    mass is injected)."""
    F = len(num_bins)
    map_pf = np.zeros((F, B), dtype=np.int32)
    map_pb = np.zeros((F, B), dtype=np.int32)
    map_valid = np.zeros((F, B), dtype=bool)
    at_default = np.zeros((F, B), dtype=bool)
    for f in range(F):
        nb = int(num_bins[f])
        map_pf[f, :] = plan.phys_col[f]
        if plan.bundled[f]:
            d = int(plan.default_bin[f])
            for b in range(nb):
                if b == d:
                    at_default[f, b] = True
                    continue
                map_pb[f, b] = plan.start[f] + b - (b > d)
                map_valid[f, b] = True
        else:
            for b in range(min(nb, B)):
                map_pb[f, b] = b
                map_valid[f, b] = True
    return map_pf, map_pb, map_valid, at_default
