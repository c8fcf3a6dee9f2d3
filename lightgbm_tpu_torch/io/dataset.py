"""Binned dataset + metadata.

Reference: src/io/dataset.cpp, src/io/metadata.cpp,
include/LightGBM/dataset.h (UNVERIFIED — empty mount, see SURVEY.md banner).

The port of ``lightgbm_tpu/io/dataset.py`` for dense numeric input: the
binned matrix is ONE packed ``[n_rows, n_used_features]`` uint8 array
(every feature has <= 256 bins under ``max_bin <= 255``), built on the
host with the same bin mappers and the same bytes as the JAX package.
``categorical_feature`` (indices or names) bins those columns by category
(bin 0: NaN and unseen categories). ``group`` (per-query document counts,
for the ranking objectives and metrics) becomes the cumulative
``query_boundaries``; ``set_position`` / ``set_field("position", ...)``
attach per-row presentation positions (LambdaRank's position debiasing).
The ``group_column`` parameter belongs to file input and is ignored for
in-memory data, as the JAX package ignores it. Sparse, pandas (category
columns included), file and streamed inputs are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

import numpy as np

from ..utils import log
from .binning import BinMapper, mappers_from_params, resolve_ingest_threads


@dataclasses.dataclass
class Metadata:
    """Per-row training metadata (reference: Metadata, metadata.cpp)."""

    label: Optional[np.ndarray] = None
    weight: Optional[np.ndarray] = None
    # query boundaries: int array of size num_queries + 1 (cumulative),
    # built from the per-query counts given as ``group``
    query_boundaries: Optional[np.ndarray] = None
    init_score: Optional[np.ndarray] = None
    # per-row presentation positions (LambdaRank's position debiasing)
    position: Optional[np.ndarray] = None

    def set_group(self, group: Optional[np.ndarray]) -> None:
        if group is None:
            self.query_boundaries = None
            return
        group = np.asarray(group, dtype=np.int64).ravel()
        self.query_boundaries = np.concatenate([[0], np.cumsum(group)])

    def num_queries(self) -> int:
        if self.query_boundaries is None:
            return 0
        return len(self.query_boundaries) - 1


def _coerce_1d(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float64).ravel()


class Dataset:
    """User-facing Dataset mirroring ``lightgbm.Dataset`` semantics.

    Lazy construction: raw data is kept until ``construct()`` is called
    (by ``train()``/``Booster``). A validation dataset created via
    ``create_valid``/``reference=`` reuses the training set's BinMappers.
    """

    def __init__(self, data, label=None, reference: "Dataset" = None,
                 weight=None, group=None, init_score=None,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, List] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True):
        self.data = data
        self.params = dict(params or {})
        self.reference = reference
        self.free_raw_data = free_raw_data
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.metadata = Metadata()
        if label is not None:
            self.metadata.label = _coerce_1d(label)
        if weight is not None:
            self.metadata.weight = _coerce_1d(weight)
        if group is not None:
            self.metadata.set_group(_coerce_1d(group))
        if init_score is not None:
            self.metadata.init_score = _coerce_1d(init_score)
        self._constructed = False
        self.bin_mappers: List[BinMapper] = []
        self.binned: Optional[np.ndarray] = None   # [n_rows, n_used]
        self.used_features: List[int] = []         # original feature indices
        self.feature_names: List[str] = []
        self.num_total_features = 0
        self.num_data = 0
        self.categorical_idx: List[int] = []       # original feature indices
        self.pandas_categorical = None             # model-text field

    # ------------------------------------------------------------------
    @staticmethod
    def _to_matrix(data) -> np.ndarray:
        """Dense 2-D float matrix from numpy / pandas / list-of-lists."""
        if hasattr(data, "toarray") or isinstance(data, (str, bytes)):
            log.fatal("only dense in-memory input is supported by this "
                      "package yet (no sparse matrices or files)")
        if hasattr(data, "values") and hasattr(data, "columns"):  # pandas
            return np.asarray(data.values, dtype=np.float64)
        if isinstance(data, np.ndarray) and data.ndim == 2 \
                and data.dtype in (np.float32, np.float64):
            return data
        arr = np.asarray(data, dtype=np.float64)
        if arr.ndim == 1:
            arr = arr.reshape(-1, 1)
        return arr

    def _resolve_feature_names(self, n_features: int) -> List[str]:
        if isinstance(self.feature_name, list):
            return list(self.feature_name)
        if hasattr(self.data, "columns"):     # pandas
            return [str(c) for c in self.data.columns]
        return [f"Column_{i}" for i in range(n_features)]

    def _resolve_categorical(self, names: List[str]) -> List[int]:
        """``categorical_feature`` as column indices: integers, or names
        looked up in ``names`` (an unknown name warns); "auto" is none,
        as numpy input carries no category columns."""
        cf = self.categorical_feature
        if cf == "auto" or cf is None:
            return []
        out = []
        for c in cf:
            if isinstance(c, str):
                if c in names:
                    out.append(names.index(c))
                else:
                    log.warning(f"categorical_feature {c} not in data")
            else:
                out.append(int(c))
        return out

    # ------------------------------------------------------------------
    def construct(self) -> "Dataset":
        if self._constructed:
            return self
        X = self._to_matrix(self.data)
        self.num_data, self.num_total_features = X.shape
        self._validate_metadata()
        self.feature_names = self._resolve_feature_names(
            self.num_total_features)
        self.categorical_idx = self._resolve_categorical(self.feature_names)
        if self.reference is not None:
            ref = self.reference.construct()
            self.bin_mappers = ref.bin_mappers
            self.used_features = ref.used_features
            self.feature_names = ref.feature_names
            self.categorical_idx = ref.categorical_idx
            if self.num_total_features != ref.num_total_features:
                log.fatal(f"The number of features in data "
                          f"({self.num_total_features}) is not the same as "
                          f"it was in training data "
                          f"({ref.num_total_features})")
        else:
            self.bin_mappers = mappers_from_params(
                X, self.params, categorical_idx=self.categorical_idx)
            self.used_features = [i for i, m in enumerate(self.bin_mappers)
                                  if not m.is_trivial]
            if len(self.used_features) < self.num_total_features:
                n_drop = self.num_total_features - len(self.used_features)
                log.info(f"Dropped {n_drop} constant feature(s)")
            if not self.used_features:
                log.warning("There are no meaningful features which satisfy "
                            "the provided configuration.")
        self.binned = self.bin_rows(X)
        self._constructed = True
        if self.free_raw_data:
            self.data = None
        return self

    def bin_rows(self, X: np.ndarray) -> np.ndarray:
        """Pack ``X``'s used columns into the uint8 binned matrix
        ``[n, n_used]`` with this dataset's mappers. Columns bin on a
        thread pool for large inputs (numpy's searchsorted releases the
        GIL); each column's bytes are independent of the pool."""
        used = self.used_features
        n_rows = X.shape[0]
        if max((self.bin_mappers[f].num_bin for f in used), default=2) > 256:
            log.fatal("features with more than 256 bins (max_bin > 255) "
                      "are not supported by this package yet")
        out = np.empty((n_rows, len(used)), dtype=np.uint8)

        def bin_one(jf):
            j, f = jf
            out[:, j] = self.bin_mappers[f].values_to_bins(X[:, f])

        n_threads = min(resolve_ingest_threads(0), max(len(used), 1))
        if n_threads > 1 and n_rows * len(used) >= 2_000_000:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=n_threads) as ex:
                list(ex.map(bin_one, enumerate(used)))
        else:
            for jf in enumerate(used):
                bin_one(jf)
        return out

    # ------------------------------------------------------------------
    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score, params=params,
                       free_raw_data=self.free_raw_data)

    def _validate_metadata(self) -> None:
        n = self.num_data
        md = self.metadata
        for fname in ("label", "weight", "position"):
            v = getattr(md, fname)
            if v is not None and len(v) != n:
                log.fatal(f"Length of {fname} ({len(v)}) does not "
                          f"match number of data ({n})")
        if md.init_score is not None:
            m = len(md.init_score)
            # num_data, or num_data * num_class for multiclass
            if m != n and (n == 0 or m % n != 0):
                log.fatal(f"Length of init_score ({m}) does not match "
                          f"number of data ({n})")
        if md.query_boundaries is not None \
                and int(md.query_boundaries[-1]) != n:
            log.fatal(f"Sum of query counts "
                      f"({int(md.query_boundaries[-1])}) does not match "
                      f"number of data ({n})")

    # ------------------------------------------------------------------
    def set_group(self, group) -> "Dataset":
        self.metadata.set_group(None if group is None else _coerce_1d(group))
        return self

    def set_position(self, position) -> "Dataset":
        self.metadata.position = (None if position is None
                                  else _coerce_1d(position).astype(np.int32))
        return self

    def set_field(self, field_name: str, data) -> "Dataset":
        if field_name == "group":
            return self.set_group(data)
        if field_name == "position":
            return self.set_position(data)
        if field_name not in ("label", "weight", "init_score"):
            log.fatal(f"Unknown field name {field_name}")
        setattr(self.metadata, field_name,
                None if data is None else _coerce_1d(data))
        return self

    def get_field(self, field_name: str):
        """The field's metadata; "group" gives the query boundaries, as
        the JAX package's ``get_field`` does (``get_group`` the counts)."""
        md = self.metadata
        if field_name == "group":
            return md.query_boundaries
        if field_name not in ("label", "weight", "init_score", "position"):
            log.fatal(f"Unknown field name {field_name}")
        return getattr(md, field_name)

    def get_group(self):
        qb = self.metadata.query_boundaries
        return None if qb is None else np.diff(qb)

    def feature_num_bins(self) -> np.ndarray:
        """num_bin per used feature."""
        self.construct()
        return np.array([self.bin_mappers[f].num_bin
                         for f in self.used_features], dtype=np.int32)

