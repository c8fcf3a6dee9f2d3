"""Binned dataset + metadata.

Reference: src/io/dataset.cpp, src/io/metadata.cpp,
include/LightGBM/dataset.h (UNVERIFIED — empty mount, see SURVEY.md banner).

The port of ``lightgbm_tpu/io/dataset.py``: the binned matrix is ONE packed
``[n_rows, n_used_features]`` array, uint8 when every used feature has at
most 256 bins (``max_bin <= 255``) and uint16 otherwise (wide bins, up to
65,536 a feature), with the same bin mappers and the same bytes as the JAX
package. Input is a numpy array, a pandas DataFrame (its
category-dtype columns are categorical features, binned from their codes;
the category lists become the model's ``pandas_categorical``), a scipy
sparse matrix (binned from CSC one column at a time, never densified
whole; its bin mappers sample CSR rows), a list of lists, a CSV / TSV /
LibSVM text file (``io/text_loader.py``) or a binary dataset file written
by ``save_binary``.

Bin assignment takes one of two routes, byte-equal for float32 input and
for float64 input that float32 holds exactly (``_want_device_ingest``):

- the host: one threaded pass of the native binner over all numerical
  columns of a dense float matrix (``_bin_all_columns``; float32 and
  float64 are read in place, without a float64 copy), and a column at a
  time otherwise;
- the device (``tpu_ingest_device``; ``ops/ingest.py``): float32 row
  chunks stream to the card and are bucketized there. The engine adopts
  the device arrays (``device_ingested()``) without a host round trip; the
  host copy (``binned``) materialises lazily, only for the paths that need
  host bytes (EFB probing, ``save_binary``, ``subset``).

``categorical_feature`` (indices or names) bins those columns by category
(bin 0: NaN and unseen categories). ``group`` (per-query document counts)
becomes the cumulative ``query_boundaries``; ``set_position`` /
``set_field("position", ...)`` attach per-row presentation positions. The
``group_column`` parameter applies to file input only. Streamed
(``two_round``) loading and ``push_rows`` belong to the out-of-core engine
and are not ported.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from ..ops.bins import MAX_BINS_U16, bin_dtype
from ..utils import log
from .binning import (BIN_TYPE_CATEGORICAL, MISSING_CODE, BinMapper,
                      _native, mappers_from_params, resolve_ingest_threads)

# dense float input of at least this many rows bins in the native
# row-major pass, and engages device ingest under tpu_ingest_device=auto
DENSE_PASS_MIN_ROWS = 65_536
DEVICE_INGEST_MIN_ROWS = 65_536
BINARY_MAGIC = b"LGBTBIN1"


def _host_mem_bytes():
    """Total physical host RAM, or None when undeterminable."""
    try:
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError, AttributeError):
        return None


def _is_pandas_df(data) -> bool:
    return (hasattr(data, "dtypes") and hasattr(data, "columns")
            and hasattr(data, "values"))


def _pandas_cat_columns(df) -> list:
    return [c for c, dt in zip(df.columns, df.dtypes)
            if str(dt) == "category"]


def extract_pandas_categorical(df):
    """Per category-dtype column (in column order), the category-value
    list — the mapping stock LightGBM records as ``pandas_categorical`` in
    the model file. None when the frame has no category columns. Category
    values go into the model text as JSON, so values JSON cannot hold are
    refused here rather than at save time."""
    cols = _pandas_cat_columns(df)
    if not cols:
        return None
    import json
    out = []
    for c in cols:
        cats = list(df[c].cat.categories.tolist())
        try:
            json.dumps(cats)
        except TypeError:
            log.fatal(
                f"Categories of column '{c}' are not "
                f"JSON-serializable (e.g. pd.cut Intervals or "
                f"Timestamps) and cannot be stored in the model file — "
                f"convert them to str or int first "
                f"(e.g. df['{c}'] = df['{c}'].astype(str)"
                f".astype('category'))")
        out.append(cats)
    return out


def apply_pandas_categorical(data, pandas_categorical):
    """Replace a DataFrame's category-dtype columns with their integer
    CODES under ``pandas_categorical``'s category lists (float64; NaN for
    missing values and for values outside the lists). Training passes the
    frame's own lists; predict passes the lists stored with the model, so
    a frame whose categories come in another order, or with new values,
    still maps to the training codes. Anything but a DataFrame passes
    through untouched."""
    if not _is_pandas_df(data):
        return data
    cols = _pandas_cat_columns(data)
    if not cols:
        return data
    if pandas_categorical is None or \
            len(pandas_categorical) != len(cols):
        log.fatal(
            f"Input DataFrame has {len(cols)} category-dtype columns "
            f"but the model/dataset records "
            f"{0 if pandas_categorical is None else len(pandas_categorical)} "
            f"— train and predict frames must have matching categorical "
            f"columns (pandas_categorical)")
    data = data.copy(deep=False)
    for c, cats in zip(cols, pandas_categorical):
        # set_categories drops values outside ``cats`` to NaN (code -1):
        # the unseen-category bin; at train time cats is the column's own
        # list, so these are its plain codes
        codes = data[c].cat.set_categories(cats).cat.codes.to_numpy()
        vals = codes.astype(np.float64)
        vals[codes < 0] = np.nan
        data[c] = vals
    return data


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


def is_sparse(data) -> bool:
    """A scipy sparse matrix (of any format)."""
    return (hasattr(data, "tocsc") and hasattr(data, "nnz")
            and not isinstance(data, np.ndarray))


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
        self._binned: Optional[np.ndarray] = None   # [n_rows, n_used]
        self._ingest = None                         # DeviceIngestResult
        self.used_features: List[int] = []         # original feature indices
        self.feature_names: List[str] = []
        self.num_total_features = 0
        self.num_data = 0
        self.categorical_idx: List[int] = []       # original feature indices
        # category-value lists of pandas category-dtype columns (the
        # model text's pandas_categorical); filled at construct
        self.pandas_categorical = None
        self.construct_seconds: Dict[str, float] = {}
        if isinstance(data, (str, os.PathLike)):
            self._init_from_file(os.fspath(data))

    # ------------------------------------------------------------------
    @property
    def binned(self) -> Optional[np.ndarray]:
        """Host ``[n, n_used]`` binned matrix. Under device ingest the
        matrix lives on the device and this host copy materialises lazily,
        only for the paths that need host bytes (EFB probing,
        ``save_binary``, ``subset``); training reads the device arrays
        through ``device_ingested()``."""
        if self._binned is None and self._ingest is not None:
            self._binned = self._ingest.host_binned()
        return self._binned

    @binned.setter
    def binned(self, value) -> None:
        self._binned = value

    def device_ingested(self):
        """The device ingest result (``ops/ingest.DeviceIngestResult``),
        or None when this dataset was binned on the host."""
        return self._ingest

    def binned_dtype(self):
        """The bin-id dtype, without materialising a device-resident
        matrix on the host."""
        if self._binned is not None:
            return self._binned.dtype
        if self._ingest is not None:
            return self._bins_dtype()
        return self.binned.dtype

    def _bins_dtype(self) -> np.dtype:
        """uint8 when every used feature has at most 256 bins, else
        uint16 (the JAX package's rule)."""
        return bin_dtype(max((self.bin_mappers[f].num_bin
                              for f in self.used_features), default=2))

    # ------------------------------------------------------------------
    @staticmethod
    def _to_matrix(data):
        """Dense 2-D float matrix from numpy / pandas / list-of-lists, or
        the CSC form of a scipy sparse matrix. A frame's category columns
        must have been replaced by their codes first
        (``apply_pandas_categorical``)."""
        if is_sparse(data):
            return data.tocsc()
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
        looked up in ``names`` (an unknown name warns); "auto" takes a
        DataFrame's category-dtype columns."""
        cf = self.categorical_feature
        if cf == "auto" or cf is None:
            if hasattr(self.data, "dtypes"):
                return [i for i, dt in enumerate(self.data.dtypes)
                        if str(dt) == "category"]
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
        t_start = time.perf_counter()
        sparse = is_sparse(self.data)
        data = self.data
        if not sparse and _is_pandas_df(data) and _pandas_cat_columns(data):
            # a valid set takes the TRAINING frame's category lists, so
            # codes agree across datasets
            self.pandas_categorical = (
                self.reference.construct().pandas_categorical
                if self.reference is not None
                else extract_pandas_categorical(data))
            data = apply_pandas_categorical(data, self.pandas_categorical)
        # a dense float32 / float64 ndarray bins in place: no float64 copy
        # (at 10M x 28 that copy alone is 2.2 GB); the mappers still see
        # float64 (from_sample converts its sample)
        X = self._to_matrix(data)
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
        t_bounds = time.perf_counter()
        self._guard_binned_size()
        device = self._want_device_ingest(X, sparse)
        if device is not None:
            from ..ops.ingest import device_ingest
            self._ingest = device_ingest(X, self.bin_mappers,
                                         self.used_features, device,
                                         out_dtype=self._bins_dtype())
            self._binned = None       # the host copy materialises lazily
        else:
            self._binned = self._bin_all_columns(X, sparse)
        t_end = time.perf_counter()
        # host-clock seconds of the bound search (mappers; from the raw
        # input on), of the assignment and of the whole construct
        self.construct_seconds = {"bounds": t_bounds - t_start,
                                  "assign": t_end - t_bounds,
                                  "total": t_end - t_start}
        self._constructed = True
        if self.free_raw_data:
            self.data = None
        return self

    def _want_device_ingest(self, X, sparse: bool):
        """The device to assign bins on (``ops/ingest.py``), or None for
        the host route. ``tpu_ingest_device``:

        - "false": the host;
        - "true": the device of the Dataset's ``device_type`` (FATAL for
          "cuda" without a card; "cpu" runs the torch route on the CPU);
        - "auto": the card, when ``device_type`` is "cuda" (the default),
          a card is present and the data has at least 65,536 rows — the
          JAX package's own rule, "off the accelerator, bin on the host".
          Nothing trains on the CPU unasked: the engine still refuses
          ``device_type=cuda`` without a card.

        The device route casts chunks to float32, so the two routes' bins
        are byte-equal for float32 input and for float64 input whose
        values float32 holds exactly; a genuine float64 value within half
        a float32 ulp of a bound may land one bin off, as on the JAX
        package's device route ("false" bins float64 exactly).

        Either of the first two stands down (to the host) for sparse or
        non-float input, no used features, categorical ids outside the
        exact float32 / int32 window, or a binned matrix too large to sit
        comfortably on the card. A set built against a reference (a valid
        set) follows the reference's parameters where it sets none."""
        from ..config import coerce_tristate, get_param
        params = self.params
        if self.reference is not None:
            params = {**self.reference.params, **params}
        mode = coerce_tristate(get_param(params, "tpu_ingest_device"),
                               "tpu_ingest_device")
        if mode == "false":
            return None
        if (sparse or not isinstance(X, np.ndarray) or X.ndim != 2
                or X.dtype not in (np.float32, np.float64)
                or not self.used_features):
            return None
        import torch
        device_type = str(get_param(params, "device_type")).lower()
        forced = mode == "true"
        if not forced and (device_type != "cuda"
                           or not torch.cuda.is_available()
                           or self.num_data < DEVICE_INGEST_MIN_ROWS):
            return None
        from ..boosting.gbdt import resolve_device
        device = resolve_device(device_type)
        from ..ops.ingest import cat_device_safe
        if not cat_device_safe(self.bin_mappers, self.used_features):
            if forced:
                log.warning("tpu_ingest_device=true ignored: categorical "
                            "ids exceed the exact float32/int32 device "
                            "window; binning on the host")
            return None
        if device.type == "cuda":
            from ..utils.hbm import (STREAM_HBM_FRACTION,
                                     binned_device_bytes, hbm_bytes_limit)
            limit = hbm_bytes_limit()
            est = binned_device_bytes(self.num_data, len(self.used_features),
                                      self._bins_dtype().itemsize, True)
            # twice the resident size: the ingest arrays and the engine's
            # row-padded copies are alive together at adoption
            if limit and 2 * est > STREAM_HBM_FRACTION * limit:
                if forced:
                    log.warning("tpu_ingest_device=true ignored: the binned "
                                "matrix is too large to sit comfortably in "
                                "device memory; binning on the host")
                return None
        return device

    def _bin_all_columns(self, X, sparse: bool) -> np.ndarray:
        """Pack the binned matrix ``[n, n_used]``. A dense C-contiguous
        float matrix of more than 65,536 rows takes ONE native row-major
        pass over all numerical columns (``bin_matrix``, row chunks on a
        thread pool: binning a column at a time strides the whole row per
        element); categorical columns and everything else go a column at
        a time (``values_to_bins``), on a thread pool for large inputs."""
        used = self.used_features
        n_rows = X.shape[0]
        dtype = self._bins_dtype()
        if not used:
            return np.zeros((n_rows, 0), dtype=dtype)
        from ..config import get_param
        threads = resolve_ingest_threads(
            get_param(self.params, "tpu_ingest_threads"))
        if (not sparse and isinstance(X, np.ndarray) and X.ndim == 2
                and X.dtype in (np.float32, np.float64)
                and X.flags.c_contiguous and n_rows > DENSE_PASS_MIN_ROWS):
            return self._bin_matrix_native(X, n_rows, threads)

        def col_values(f):
            if not sparse:
                return X[:, f]
            # X is CSC: one float64 column at a time
            col = np.zeros(n_rows, np.float64)
            sl = slice(X.indptr[f], X.indptr[f + 1])
            col[X.indices[sl]] = X.data[sl]
            return col

        out = np.empty((n_rows, len(used)), dtype=dtype)

        def bin_one(jf):
            j, f = jf
            out[:, j] = self.bin_mappers[f].values_to_bins(col_values(f))

        n_threads = min(threads, len(used))
        if n_threads > 1 and n_rows * len(used) >= 2_000_000:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=n_threads) as ex:
                list(ex.map(bin_one, enumerate(used)))
        else:
            for jf in enumerate(used):
                bin_one(jf)
        return out

    def _bin_matrix_native(self, X: np.ndarray, n_rows: int,
                           threads: int) -> np.ndarray:
        """The native row-major pass of ``_bin_all_columns`` (uint8 or
        uint16 output; columns of more than 256 bounds take its scalar
        search)."""
        import ctypes as c
        lib = _native()
        used = self.used_features
        mappers = [self.bin_mappers[f] for f in used]
        n_cols = len(used)
        is_num = np.array([m.bin_type != BIN_TYPE_CATEGORICAL
                           for m in mappers], dtype=np.int32)
        ubs = [np.ascontiguousarray(m.bin_upper_bound if is_num[j]
                                    else np.zeros(1), dtype=np.float64)
               for j, m in enumerate(mappers)]
        ub_off = np.zeros(n_cols + 1, dtype=np.int64)
        np.cumsum([len(u) for u in ubs], out=ub_off[1:])
        ub_concat = np.concatenate(ubs)
        meta_mt = np.array([MISSING_CODE.get(m.missing_type, 0)
                            for m in mappers], dtype=np.int32)
        meta_db = np.array([m.default_bin for m in mappers], dtype=np.int64)
        meta_nb = np.array([m.num_bin for m in mappers], dtype=np.int64)
        col_idx = np.array(used, dtype=np.int64)
        out = np.empty((n_rows, n_cols), dtype=self._bins_dtype())
        out_kind = 0 if out.dtype == np.uint8 else 1
        row_stride = X.strides[0] // X.itemsize

        def bin_rows(se) -> None:
            s, e = se
            lib.bin_matrix(
                c.c_void_p(X.ctypes.data + s * row_stride * X.itemsize),
                int(X.dtype == np.float32), e - s, row_stride,
                col_idx.ctypes.data_as(c.POINTER(c.c_int64)), n_cols,
                ub_concat.ctypes.data_as(c.POINTER(c.c_double)),
                ub_off.ctypes.data_as(c.POINTER(c.c_int64)),
                meta_mt.ctypes.data_as(c.POINTER(c.c_int32)),
                meta_db.ctypes.data_as(c.POINTER(c.c_int64)),
                meta_nb.ctypes.data_as(c.POINTER(c.c_int64)),
                is_num.ctypes.data_as(c.POINTER(c.c_int32)),
                c.c_void_p(out.ctypes.data + s * n_cols * out.itemsize),
                out_kind)

        # ctypes releases the GIL for the call and each row chunk writes
        # a disjoint slice of ``out``, so the pass scales with cores
        n_threads = min(threads, max(n_rows // 262_144, 1))
        blk = -(-n_rows // n_threads)
        spans = [(s, min(s + blk, n_rows)) for s in range(0, n_rows, blk)]
        if n_threads > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=n_threads) as ex:
                list(ex.map(bin_rows, spans))
        else:
            bin_rows(spans[0])
        for j, m in enumerate(mappers):     # the categorical remainder
            if not is_num[j]:
                out[:, j] = m.values_to_bins(X[:, used[j]])
        return out

    def _guard_binned_size(self) -> None:
        """The JAX package's ``_binned_dtype_with_guard``: fail before
        allocating a binned matrix that cannot fit in host RAM (1 or 2
        bytes an element). A feature of more than 65,536 bins is FATAL:
        uint16 cannot hold its ids (the JAX package's cast would wrap
        them)."""
        for f in self.used_features:
            nb = self.bin_mappers[f].num_bin
            if nb > MAX_BINS_U16:
                name = (self.feature_names[f] if self.feature_names
                        else f"Column_{f}")
                log.fatal(f"feature {name} has {nb} bins: more than "
                          f"{MAX_BINS_U16} bins (max_bin or "
                          f"max_bin_by_feature above 65535) is not "
                          f"supported, as uint16 bin ids cannot hold them")
        est = (int(self.num_data) * max(len(self.used_features), 1)
               * self._bins_dtype().itemsize)
        budget = _host_mem_bytes()
        if budget is not None and est > 0.9 * budget:
            log.fatal(
                f"binned dataset ({self.num_data} rows x "
                f"{len(self.used_features)} features) would need "
                f"{est / 2**30:.1f} GiB — more than 90% of host RAM "
                f"({budget / 2**30:.1f} GiB). Reduce rows or features")

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
    def _init_from_file(self, path: str) -> None:
        """Load from disk: a binary dataset file (``save_binary``) or
        CSV / TSV / LibSVM text (DatasetLoader::LoadFromFile semantics:
        label / weight / group / ignore columns, header, sidecar files)."""
        import pickle
        with open(path, "rb") as f:
            magic = f.read(len(BINARY_MAGIC))
            if magic == BINARY_MAGIC:
                state = pickle.load(f)
        if magic == BINARY_MAGIC:
            user_md = self.metadata
            user_params = self.params
            for k, v in state.items():
                setattr(self, k, v)
            # metadata and params the caller passed override the stored
            for field in ("label", "weight", "init_score",
                          "query_boundaries"):
                v = getattr(user_md, field)
                if v is not None:
                    setattr(self.metadata, field, v)
            self.params = {**self.params, **user_params}
            self._constructed = True
            self.data = None
            return
        from ..config import Config, coerce_bool
        from .text_loader import load_text
        # reference aliases (label=, weight=, group=/query=, has_header=,
        # ignore_feature=...) to canonical names
        p = {Config.canonical_name(k): v for k, v in self.params.items()}
        if coerce_bool(p.get("two_round", False)):
            log.fatal("two_round=true (streamed two-round file loading) is "
                      "not supported by this package yet: it belongs to the "
                      "out-of-core engine; load the file in one round")
        loaded = load_text(
            path,
            label_column=p.get("label_column", "auto"),
            weight_column=p.get("weight_column"),
            group_column=p.get("group_column"),
            ignore_column=p.get("ignore_column"),
            has_header=(coerce_bool(p["header"]) if "header" in p
                        else None))
        self.data = loaded.X
        if self.metadata.label is None and loaded.label is not None:
            self.metadata.label = loaded.label.astype(np.float64)
        if self.metadata.weight is None and loaded.weight is not None:
            self.metadata.weight = loaded.weight.astype(np.float64)
        if self.metadata.query_boundaries is None \
                and loaded.group is not None:
            self.metadata.set_group(loaded.group)
        if self.feature_name == "auto" and loaded.feature_names:
            self.feature_name = loaded.feature_names

    def save_binary(self, path: str) -> "Dataset":
        """Write the CONSTRUCTED dataset (binned matrix, mappers,
        metadata) to a binary file that ``Dataset(path)`` loads (the
        reference's binary dataset file, dataset.cpp SaveBinaryFile). The
        file holds this package's classes."""
        import pickle
        self.construct()
        state = {k: getattr(self, k) for k in (
            "binned", "bin_mappers", "used_features", "feature_names",
            "categorical_idx", "num_total_features", "num_data",
            "metadata", "params", "pandas_categorical")}
        state["_binned"] = state.pop("binned")
        with open(path, "wb") as f:
            f.write(BINARY_MAGIC)
            pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
        return self

    def subset(self, used_indices: Sequence[int],
               params: Optional[Dict[str, Any]] = None) -> "Dataset":
        """Row subset sharing this dataset's bin mappers (for cv folds),
        binned from the host copy. With query groups, ``used_indices``
        keeps whole queries together and the boundaries are rebuilt."""
        self.construct()
        idx = np.asarray(used_indices, dtype=np.int64)
        sub = Dataset(None, reference=self,
                      feature_name=self.feature_name,
                      categorical_feature=self.categorical_feature,
                      params=dict(params or self.params),
                      free_raw_data=self.free_raw_data)
        sub.pandas_categorical = self.pandas_categorical
        md = self.metadata
        for field in ("label", "weight", "position"):
            v = getattr(md, field)
            if v is not None:
                setattr(sub.metadata, field, v[idx])
        if md.init_score is not None:
            init = np.asarray(md.init_score)
            if len(init) != self.num_data:
                # n * K values, read row by row
                init = init.reshape(self.num_data, -1)[idx].ravel()
            else:
                init = init[idx]
            sub.metadata.init_score = init
        if md.query_boundaries is not None:
            qid = np.searchsorted(md.query_boundaries, idx,
                                  side="right") - 1
            change = np.flatnonzero(np.diff(qid)) + 1
            sub.metadata.set_group(
                np.diff(np.concatenate([[0], change, [len(idx)]])))
        sub._constructed = True
        sub.bin_mappers = self.bin_mappers
        sub.binned = self.binned[idx]
        sub.used_features = self.used_features
        sub.feature_names = self.feature_names
        sub.categorical_idx = self.categorical_idx
        sub.num_total_features = self.num_total_features
        sub.num_data = len(idx)
        return sub

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
