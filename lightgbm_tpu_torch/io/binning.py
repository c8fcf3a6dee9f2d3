"""Feature binning: quantile-ish greedy binning with zero/NaN handling.

Reference: src/io/bin.cpp ``BinMapper::FindBin`` / ``GreedyFindBin`` and
include/LightGBM/bin.h (UNVERIFIED — empty mount, see SURVEY.md banner).

Semantics reproduced:
- numerical features: bins chosen on a sample so that each bin holds roughly
  equal counts, honoring ``min_data_in_bin``; distinct-value-count aware
  (heavy values get their own bin); zero ([-1e-35, 1e-35]) forced into its
  own bin; bin boundaries are midpoints between adjacent distinct values.
- missing handling: ``missing_type`` in {none, zero, nan}. With
  ``use_missing`` and NaNs present, NaN occupies the LAST bin. With
  ``zero_as_missing``, zeros/NaN map to the zero bin.
- categorical features: categories sorted by count desc, capped at
  ``max_bin``-1 (rare tail pruned, mirroring the 99%% mass cut upstream);
  bin 0 is reserved for NaN/unseen categories.

Binning is host-side, a one-time load cost; the hot path is the binned
matrix on the device. The port of ``lightgbm_tpu/io/binning.py``: the
greedy bound search and the numerical value-to-bin pass run in the native
C++ binner (``native/binning.cpp``, built with ``g++`` at first use); their
NumPy versions (``_greedy_find_distinct_bounds_plain``,
``BinMapper.values_to_bins_plain``) are the plain versions the tests hold
the native ones against, bit for bit. Categorical columns bin in NumPy, as
in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..utils import log


def _native():
    """The native binning library (built at first use; a failed build
    raises with the compiler's message)."""
    from ..native import binning
    return binning()


K_ZERO_THRESHOLD = 1e-35
BIN_TYPE_NUMERICAL = "numerical"
BIN_TYPE_CATEGORICAL = "categorical"
MISSING_NONE = "none"
MISSING_ZERO = "zero"
MISSING_NAN = "nan"
# the native binner's missing-type codes
MISSING_CODE = {MISSING_NONE: 0, MISSING_ZERO: 1, MISSING_NAN: 2}


def _greedy_find_distinct_bounds(distinct_values: np.ndarray,
                                 counts: np.ndarray,
                                 max_bin: int,
                                 total_cnt: int,
                                 min_data_in_bin: int) -> List[float]:
    """Pick bin upper bounds over sorted distinct values (native
    ``greedy_find_bounds``).

    Returns a list of upper bounds; the last bound is +inf. Mirrors the
    greedy equal-mass packing of the reference's GreedyFindBin: values whose
    count exceeds the mean bin size get dedicated bins; the rest are packed
    to roughly ``mean_bin_size`` each.
    """
    import ctypes
    lib = _native()
    dv = np.ascontiguousarray(distinct_values, dtype=np.float64)
    cn = np.ascontiguousarray(counts, dtype=np.int64)
    out = np.empty(int(max_bin) + 2, dtype=np.float64)
    n_out = lib.greedy_find_bounds(
        dv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        cn.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(dv), int(max_bin), int(total_cnt), int(min_data_in_bin),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return list(out[:n_out])


def _greedy_find_distinct_bounds_plain(distinct_values: np.ndarray,
                                       counts: np.ndarray,
                                       max_bin: int,
                                       total_cnt: int,
                                       min_data_in_bin: int) -> List[float]:
    """The NumPy version of ``_greedy_find_distinct_bounds``."""
    n_distinct = len(distinct_values)
    bounds: List[float] = []
    if n_distinct == 0:
        return [np.inf]
    if n_distinct <= max_bin:
        # one bin per distinct value, merging up to min_data_in_bin
        cur_cnt = 0
        for i in range(n_distinct - 1):
            cur_cnt += counts[i]
            if cur_cnt >= min_data_in_bin:
                bounds.append((distinct_values[i] + distinct_values[i + 1]) / 2.0)
                cur_cnt = 0
        bounds.append(np.inf)
        return bounds
    # more distinct values than bins: greedy packing
    if min_data_in_bin > 0:
        max_bin = min(max_bin, max(1, total_cnt // min_data_in_bin))
    mean_size = total_cnt / max_bin
    is_big = counts >= mean_size
    rest_cnt = int(total_cnt - counts[is_big].sum())
    rest_bins = int(max_bin - is_big.sum())
    mean_size = rest_cnt / rest_bins if rest_bins > 0 else np.inf

    upper_idx: List[int] = []  # index i means boundary between value i, i+1
    cur_cnt = 0
    for i in range(n_distinct - 1):
        if not is_big[i]:
            rest_cnt -= counts[i]
        cur_cnt += counts[i]
        # close the bin on: a heavy value, reaching mean size, or just before
        # a heavy value once half-full
        if is_big[i] or cur_cnt >= mean_size or \
                (is_big[i + 1] and cur_cnt >= max(1.0, mean_size * 0.5)):
            upper_idx.append(i)
            cur_cnt = 0
            if len(upper_idx) >= max_bin - 1:
                break
            if not is_big[i]:
                rest_bins -= 1
                if rest_bins > 0:
                    mean_size = rest_cnt / rest_bins
    for i in upper_idx:
        bounds.append((distinct_values[i] + distinct_values[i + 1]) / 2.0)
    bounds.append(np.inf)
    return bounds


def resolve_ingest_threads(n_threads: int) -> int:
    """The ONE tpu_ingest_threads resolution rule (0/unset = one per
    core, capped) — shared by mapper finding, the native row-chunked
    binning pass and the per-column fallback so the knob can never mean
    different things on different paths. Callers apply their own
    work-size gates on top."""
    if n_threads and n_threads > 0:
        return int(n_threads)
    import os
    return min(os.cpu_count() or 1, 16)


def _distinct_with_counts(values: np.ndarray):
    if len(values) == 0:
        return np.empty(0), np.empty(0, dtype=np.int64)
    return np.unique(values, return_counts=True)


@dataclasses.dataclass
class BinMapper:
    """Per-feature value→bin mapping (reference: BinMapper, bin.h)."""

    bin_type: str = BIN_TYPE_NUMERICAL
    num_bin: int = 1
    missing_type: str = MISSING_NONE
    # numerical: sorted upper bounds, len == number of value bins
    bin_upper_bound: Optional[np.ndarray] = None
    # categorical: raw int category value per bin (index 0 unused / NaN-bin)
    bin_to_cat: Optional[np.ndarray] = None
    cat_to_bin: Optional[Dict[int, int]] = None
    default_bin: int = 0       # bin of value 0.0 (sparse default)
    most_freq_bin: int = 0
    min_value: float = 0.0
    max_value: float = 0.0

    @property
    def is_trivial(self) -> bool:
        """True when the feature has <=1 effective bin (constant feature)."""
        return self.num_bin <= 1

    # ------------------------------------------------------------------
    @staticmethod
    def from_sample(values: np.ndarray, total_sample_cnt: int, max_bin: int,
                    min_data_in_bin: int = 3, use_missing: bool = True,
                    zero_as_missing: bool = False,
                    is_categorical: bool = False,
                    min_data_in_cat: int = 1,
                    forced_bounds=None) -> "BinMapper":
        """Build a mapper from sampled raw values (NaN included).
        ``forced_bounds``: user-forced bin upper bounds
        (forcedbins_filename, DatasetLoader FindBinWithPredefinedBin —
        UNVERIFIED): the listed boundaries are guaranteed present; the
        remaining bin budget is filled by the usual greedy packing."""
        values = np.asarray(values, dtype=np.float64)
        if is_categorical:
            return BinMapper._categorical_from_sample(
                values, max_bin, use_missing)
        m = BinMapper._numerical_from_sample(
            values, total_sample_cnt, max_bin, min_data_in_bin, use_missing,
            zero_as_missing)
        if forced_bounds is not None and len(forced_bounds):
            forced = np.asarray(sorted(set(float(b)
                                           for b in forced_bounds)))
            ub = np.asarray(m.bin_upper_bound)
            cap = max_bin - (1 if m.missing_type == MISSING_NAN else 0)
            if len(forced) + 1 > cap:
                # +inf terminator always occupies one slot; forced
                # bounds beyond the budget are dropped (highest first)
                # so num_bin can never exceed max_bin
                log.warning(
                    f"forcedbins: {len(forced)} forced bounds exceed "
                    f"the max_bin={max_bin} budget; keeping the first "
                    f"{cap - 1}")
                forced = forced[:cap - 1]
            merged = np.array(sorted(set(ub) | set(forced)))
            if len(merged) > cap:
                # over budget: drop the greedy (non-forced) bounds
                # nearest to a forced one until the cap holds
                keep_forced = np.isin(merged, forced) | np.isinf(merged)
                greedy = merged[~keep_forced]
                n_drop = len(merged) - cap
                if n_drop > 0 and len(greedy):
                    dist = np.min(np.abs(greedy[:, None]
                                         - forced[None, :]), axis=1)
                    drop = set(greedy[np.argsort(dist)[:n_drop]])
                    merged = np.array([b for b in merged
                                       if b not in drop])
            if merged[-1] != np.inf:
                merged = np.append(merged, np.inf)
            m.bin_upper_bound = merged
            m.num_bin = len(merged) + (1 if m.missing_type == MISSING_NAN
                                       else 0)
            # most_freq_bin tracks default_bin whenever the feature had
            # zero mass; recompute both against the merged bounds so
            # neither can point at a pre-merge bin index
            m.default_bin = int(np.searchsorted(merged, 0.0,
                                                side="left"))
            m.most_freq_bin = m.default_bin if m._zero_mass else 0
        return m

    @staticmethod
    def _numerical_from_sample(values, total_sample_cnt, max_bin,
                               min_data_in_bin, use_missing,
                               zero_as_missing) -> "BinMapper":
        nan_mask = np.isnan(values)
        na_cnt = int(nan_mask.sum())
        finite = values[~nan_mask]
        # implicit zeros: rows not present in the sample (sparse semantics) —
        # total_sample_cnt may exceed len(values); the difference counts as 0.
        implicit_zero = max(0, total_sample_cnt - len(values) - na_cnt)

        if zero_as_missing:
            missing_type = MISSING_ZERO
            # NaNs will be mapped to the zero bin at bin time; count them
            # into the zero mass so bin-size statistics match
            implicit_zero += na_cnt
        elif use_missing and na_cnt > 0:
            missing_type = MISSING_NAN
        else:
            missing_type = MISSING_NONE
            if na_cnt > 0:
                # treat NaN as zero when use_missing=false (reference does)
                implicit_zero += na_cnt

        zero_mask = np.abs(finite) <= K_ZERO_THRESHOLD
        zero_cnt = int(zero_mask.sum()) + implicit_zero
        neg = np.sort(finite[(~zero_mask) & (finite < 0)])
        pos = np.sort(finite[(~zero_mask) & (finite > 0)])

        n_eff = len(neg) + len(pos) + zero_cnt
        # reserve one bin for NaN when missing_type == nan
        value_bins = max_bin - (1 if missing_type == MISSING_NAN else 0)
        # allocate bins to the negative / positive sides by mass; zero gets
        # its own forced bin whenever zeros exist
        zero_bin_needed = zero_cnt > 0
        avail = value_bins - (1 if zero_bin_needed else 0)
        bounds: List[float] = []
        if n_eff == 0 or avail <= 0:
            bounds = [np.inf]
        else:
            nz = len(neg) + len(pos)
            if nz == 0:
                bounds = [np.inf]
            else:
                neg_bins = int(round(avail * len(neg) / nz)) if nz else 0
                neg_bins = min(max(neg_bins, 1 if len(neg) else 0), avail)
                pos_bins = avail - neg_bins if len(pos) else 0
                neg_bins = avail - pos_bins if len(neg) else 0
                if len(neg):
                    dv, cnt = _distinct_with_counts(neg)
                    b = _greedy_find_distinct_bounds(
                        dv, cnt, max(neg_bins, 1), len(neg), min_data_in_bin)
                    b[-1] = -K_ZERO_THRESHOLD  # cap the negative side at zero
                    bounds.extend(b)
                if zero_bin_needed:
                    if not bounds or bounds[-1] < -K_ZERO_THRESHOLD:
                        bounds.append(-K_ZERO_THRESHOLD)
                    bounds.append(K_ZERO_THRESHOLD)
                elif len(neg) and len(pos):
                    # ensure a boundary separating neg from pos exists
                    pass
                if len(pos):
                    dv, cnt = _distinct_with_counts(pos)
                    b = _greedy_find_distinct_bounds(
                        dv, cnt, max(pos_bins, 1), len(pos), min_data_in_bin)
                    bounds.extend(b)
                else:
                    if not bounds or bounds[-1] != np.inf:
                        bounds.append(np.inf)
        # dedupe & sort
        ub = np.array(sorted(set(bounds)), dtype=np.float64)
        if len(ub) == 0 or ub[-1] != np.inf:
            ub = np.append(ub, np.inf)
        num_bin = len(ub) + (1 if missing_type == MISSING_NAN else 0)

        m = BinMapper(bin_type=BIN_TYPE_NUMERICAL, num_bin=int(num_bin),
                      missing_type=missing_type, bin_upper_bound=ub,
                      min_value=float(finite.min()) if len(finite) else 0.0,
                      max_value=float(finite.max()) if len(finite) else 0.0)
        m.default_bin = int(np.searchsorted(ub, 0.0, side="left"))
        m.most_freq_bin = m.default_bin if zero_cnt > 0 else 0
        m._zero_mass = zero_cnt > 0   # read by the forcedbins merge
        return m

    @staticmethod
    def _categorical_from_sample(values, max_bin, use_missing) -> "BinMapper":
        nan_mask = np.isnan(values)
        cats = values[~nan_mask].astype(np.int64)
        if np.any(values[~nan_mask] < 0):
            log.warning("Met negative value in categorical features, will "
                        "convert it to NaN")
            neg = values[~nan_mask] < 0
            cats = cats[~neg]
        dv, cnt = np.unique(cats, return_counts=True)
        order = np.argsort(-cnt, kind="stable")
        dv, cnt = dv[order], cnt[order]
        # keep top categories covering 99% of mass, capped at max_bin-1
        # (bin 0 is the NaN/unseen bin)
        keep = min(len(dv), max_bin - 1)
        if keep > 1:
            cum = np.cumsum(cnt[:keep])
            cut = int(np.searchsorted(cum, 0.99 * cnt.sum()) + 1)
            keep = min(keep, max(cut, 1))
        dv = dv[:keep]
        bin_to_cat = np.concatenate([[-1], dv]).astype(np.int64)
        cat_to_bin = {int(v): i + 1 for i, v in enumerate(dv)}
        m = BinMapper(bin_type=BIN_TYPE_CATEGORICAL, num_bin=int(keep + 1),
                      missing_type=MISSING_NAN if use_missing else MISSING_NONE,
                      bin_to_cat=bin_to_cat, cat_to_bin=cat_to_bin,
                      min_value=float(dv.min()) if len(dv) else 0.0,
                      max_value=float(dv.max()) if len(dv) else 0.0)
        m.default_bin = cat_to_bin.get(0, 0)
        m.most_freq_bin = 1 if keep >= 1 else 0
        return m

    # ------------------------------------------------------------------
    def values_to_bins(self, values: np.ndarray) -> np.ndarray:
        """Value→bin for a full column (NaN-aware), int32. A numerical
        column takes the native single pass (``bin_numeric_column``): f32
        is read without a float64 copy, and a strided column view of a
        row-major matrix is read in place."""
        raw = np.asarray(values)
        if self.bin_type == BIN_TYPE_CATEGORICAL:
            return self.values_to_bins_plain(raw)
        if raw.dtype not in (np.float32, np.float64) or raw.strides[0] <= 0:
            raw = np.ascontiguousarray(raw, dtype=np.float64)
        import ctypes
        lib = _native()
        ub = np.ascontiguousarray(self.bin_upper_bound, dtype=np.float64)
        out = np.empty(len(raw), dtype=np.int32)
        lib.bin_numeric_column(
            raw.ctypes.data_as(ctypes.c_void_p), int(raw.dtype == np.float32),
            len(raw), raw.strides[0] // raw.itemsize,
            ub.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(ub),
            MISSING_CODE[self.missing_type], int(self.default_bin),
            int(self.num_bin), out.ctypes.data_as(ctypes.c_void_p), 2, 1)
        return out

    def values_to_bins_plain(self, values: np.ndarray) -> np.ndarray:
        """The NumPy version of ``values_to_bins`` (and the categorical
        route)."""
        values = np.asarray(values, dtype=np.float64)
        if self.bin_type == BIN_TYPE_CATEGORICAL:
            out = np.zeros(len(values), dtype=np.int32)
            nan_mask = ~np.isfinite(values)
            iv = np.where(nan_mask, -1, values).astype(np.int64)
            # vectorized dict lookup via the bin_to_cat table
            table_vals = self.bin_to_cat[1:]
            sorter = np.argsort(table_vals)
            pos = np.searchsorted(table_vals[sorter], iv)
            pos = np.clip(pos, 0, len(table_vals) - 1)
            hit = table_vals[sorter][pos] == iv
            out[hit & ~nan_mask] = (sorter[pos[hit & ~nan_mask]] + 1)
            return out
        nan_mask = np.isnan(values)
        if self.missing_type == MISSING_ZERO:
            values = np.where(nan_mask, 0.0, values)
            nan_mask = np.zeros_like(nan_mask)
        vb = np.searchsorted(self.bin_upper_bound, values, side="left")
        vb = np.clip(vb, 0, len(self.bin_upper_bound) - 1)
        if self.missing_type == MISSING_NAN:
            vb = np.where(nan_mask, self.num_bin - 1, vb)
        else:
            vb = np.where(nan_mask, self.default_bin, vb)
        return vb.astype(np.int32)

    def value_to_bin(self, value: float) -> int:
        return int(self.values_to_bins(np.array([value]))[0])

    def bin_to_threshold(self, bin_idx: int) -> float:
        """Upper-bound real value for a bin threshold (for model dump)."""
        assert self.bin_type == BIN_TYPE_NUMERICAL
        b = int(np.clip(bin_idx, 0, len(self.bin_upper_bound) - 1))
        return float(self.bin_upper_bound[b])


def find_bin_mappers(X: np.ndarray, max_bin: int, min_data_in_bin: int = 3,
                     sample_cnt: int = 200000, use_missing: bool = True,
                     zero_as_missing: bool = False,
                     categorical_features: Optional[List[int]] = None,
                     max_bin_by_feature: Optional[List[int]] = None,
                     seed: int = 1,
                     forced_bins: Optional[Dict[int, List[float]]] = None,
                     n_threads: int = 0) -> List[BinMapper]:
    """Build a BinMapper per column of ``X`` from a row sample.

    Mirrors DatasetLoader::ConstructFromSampleData's sampling step
    (src/io/dataset_loader.cpp, UNVERIFIED). Per-feature boundary
    finding is independent and numpy-sort dominated (sorts release the
    GIL), so columns run on a thread pool when the sample is big enough
    to pay for it; results are position-ordered, so the mapper list is
    identical to the serial loop's.
    """
    n_rows, n_features = X.shape
    categorical = set(categorical_features or [])
    # scipy sparse accepted without densifying the full matrix: rows are
    # sampled in CSR, then one column at a time is materialized (the
    # reference's sparse sample path, dataset_loader.cpp SampleData)
    is_sparse = hasattr(X, "tocsr") and not isinstance(X, np.ndarray)
    if n_rows > sample_cnt:
        rng = np.random.default_rng(seed)
        idx = np.sort(rng.choice(n_rows, size=sample_cnt, replace=False))
        sample = (X.tocsr()[idx] if is_sparse else X[idx])
    else:
        sample = X
    if is_sparse:
        sample = sample.tocsc()
    n_sample = sample.shape[0]

    def build_one(f: int) -> BinMapper:
        mb = max_bin
        if max_bin_by_feature and f < len(max_bin_by_feature) \
                and max_bin_by_feature[f] > 0:
            mb = max_bin_by_feature[f]
        col = sample[:, f]
        if is_sparse:
            col = np.asarray(col.todense(), dtype=np.float64).ravel()
        return BinMapper.from_sample(
            col, n_sample, mb, min_data_in_bin, use_missing,
            zero_as_missing, is_categorical=(f in categorical),
            forced_bounds=(forced_bins or {}).get(f))

    n_threads = min(resolve_ingest_threads(n_threads), n_features)
    if n_threads > 1 and n_sample * n_features >= 1_000_000:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=n_threads) as ex:
            return list(ex.map(build_one, range(n_features)))
    return [build_one(f) for f in range(n_features)]


def mappers_from_params(X, params: Dict, categorical_idx=None,
                        sample_cnt=None) -> List["BinMapper"]:
    """The ONE params -> ``find_bin_mappers`` marshaling point, shared
    by ``Dataset.construct`` and the distributed bin-boundary sync
    (``parallel.launch.sync_bin_mappers``) so both paths can never
    drift on a binning parameter."""
    from ..config import coerce_bool, get_param
    p = params
    return find_bin_mappers(
        X,
        max_bin=int(p.get("max_bin", 255)),
        min_data_in_bin=int(p.get("min_data_in_bin", 3)),
        sample_cnt=(int(p.get("bin_construct_sample_cnt", 200000))
                    if sample_cnt is None else sample_cnt),
        use_missing=coerce_bool(p.get("use_missing", True)),
        zero_as_missing=coerce_bool(p.get("zero_as_missing", False)),
        categorical_features=categorical_idx,
        max_bin_by_feature=p.get("max_bin_by_feature"),
        seed=int(p.get("data_random_seed", 1)),
        forced_bins=(load_forced_bins(str(p["forcedbins_filename"]))
                     if p.get("forcedbins_filename") else None),
        n_threads=get_param(p, "tpu_ingest_threads"))


def load_forced_bins(path: str) -> Dict[int, List[float]]:
    """Parse a forcedbins_filename JSON file: a list of
    ``{"feature": i, "bin_upper_bound": [...]}`` entries (upstream
    docs/Advanced-Topics forced-bins format)."""
    import json
    with open(path) as f:
        spec = json.load(f)
    out: Dict[int, List[float]] = {}
    for entry in spec:
        out[int(entry["feature"])] = [
            float(v) for v in entry["bin_upper_bound"]]
    return out
