"""Device-side dataset ingest: chunked bin assignment on the card.

Reference: ``Dataset::Construct`` + ``BinMapper::ValueToBin`` +
``DenseBin::Push`` (src/io/dataset.cpp, include/LightGBM/bin.h,
UNVERIFIED — empty mount, see SURVEY.md banner). The port of
``lightgbm_tpu/ops/ingest.py``: bin-boundary finding stays on the host (a
bounded sample, ``io/binning.py``), the assignment of the full ``[n, F]``
raw matrix runs on the device. float32 row chunks stream host→device
through two pinned staging buffers (``non_blocking`` copies; an event
recorded after each copy guards the buffer's reuse, so the host's cast of
chunk i+1 overlaps the copy and assignment of chunk i), every feature is
bucketized at once against a padded ``[Fu, B]`` bound matrix
(``torch.searchsorted``), the missing / zero / categorical mappings apply
on the device, and the result is both layouts the engine holds: the
row-major ``[n, Fu]`` ``bins`` and the feature-major ``[Fu, n]``
``bins_t``, uint8, or uint16 where a feature has more than 256 bins (the
JAX package's ``out_dtype``). The JAX package's assignment is plain XLA
(no Pallas kernel), so this one is plain torch.

Exactness: the device bins are byte-equal to the host ``values_to_bins``
for every value that float32 represents exactly (float32 input always;
float64 input whose values round-trip through float32). Each float64 bound
``b`` becomes the smallest float32 strictly greater than ``b``
(``_f32_exclusive``), so ``count(b < v)`` in float64 equals
``count(b32' <= v)`` in float32: a ``right=True`` searchsorted. A genuine
float64 value within half a float32 ulp of a bound may land one bin off,
as on the JAX package's device route; ``tpu_ingest_device=false`` keeps the
host's float64 semantics.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from .bins import bin_dtype

MT_CODE = {"none": 0, "zero": 1, "nan": 2}

# int32 pad value for the SORTED categorical table: sorts past every real
# id (cat_device_safe keeps real ids below 2**31 - 128, the largest
# float32 below 2**31) and never equals a candidate value
_CAT_PAD = np.int32(2**31 - 1)

# float32 bytes of one chunk: 262,144 rows at 28 features (the JAX
# package's default chunk at HIGGS width), fewer rows at larger widths
CHUNK_BYTES = 28 << 20


def cat_device_safe(bin_mappers, used_features: Sequence[int]) -> bool:
    """True when every categorical feature's category ids survive the
    device route exactly: chunks stream as float32 and the lookup table is
    int32, so each id must be in int32 range and exact in float32. Ids
    outside that window (64-bit hashes) keep the host's int64 route."""
    from ..io.binning import BIN_TYPE_CATEGORICAL
    for f in used_features:
        m = bin_mappers[f]
        if m.bin_type != BIN_TYPE_CATEGORICAL or m.bin_to_cat is None:
            continue
        cv = np.asarray(m.bin_to_cat[1:], dtype=np.int64)
        if not len(cv):
            continue
        if ((cv >= 2**31) | (cv <= -2**31)).any():
            return False
        if (cv.astype(np.float32).astype(np.int64) != cv).any():
            return False
    return True


def _f32_exclusive(bounds: np.ndarray) -> np.ndarray:
    """Smallest float32 strictly greater than each float64 bound.

    For a float32 value v and float64 bound b:  (b < v)  <=>  (b32' <= v)
    where b32' = min{float32 x : x > b}. This turns the host's float64
    ``searchsorted(side="left")`` (count of bounds < v) into an exact
    float32 ``searchsorted(right=True)`` for every float32 v. +inf stays
    +inf (the final clip catches +inf values, as on the host).
    """
    b = np.asarray(bounds, dtype=np.float64)
    c = b.astype(np.float32)
    # where the round-to-nearest float32 is <= b, step up one ulp
    need_up = c.astype(np.float64) <= b
    up = np.nextafter(c, np.float32(np.inf), dtype=np.float32)
    out = np.where(need_up, up, c)
    out[np.isposinf(b)] = np.inf
    return out.astype(np.float32)


@dataclasses.dataclass
class IngestTables:
    """Padded per-used-feature mapping tables (host numpy; uploaded once
    per construct: they are ``Fu x max_bin``)."""

    ub: np.ndarray          # [Fu, B] f32 exclusive upper bounds (+inf pad)
    n_ub: np.ndarray        # [Fu] int32 — real bound count per feature
    mt: np.ndarray          # [Fu] int32 missing_type code (MT_CODE)
    default_bin: np.ndarray  # [Fu] int32
    num_bin: np.ndarray     # [Fu] int32
    is_cat: np.ndarray      # [Fu] bool
    cat_sorted: np.ndarray  # [Fu, C] int32 category values, ASCENDING
    cat_perm: np.ndarray    # [Fu, C] int32 bin index per sorted slot


def build_tables(bin_mappers, used_features: Sequence[int]) -> IngestTables:
    """Flatten the used features' BinMappers into padded device tables."""
    from ..io.binning import BIN_TYPE_CATEGORICAL
    used = list(used_features)
    if not cat_device_safe(bin_mappers, used):
        raise ValueError(
            "categorical ids outside the exact float32/int32 device "
            "window — the host path must bin this dataset "
            "(Dataset._want_device_ingest gates on cat_device_safe)")
    Fu = len(used)
    n_ub = np.ones(Fu, dtype=np.int32)
    mt = np.zeros(Fu, dtype=np.int32)
    dbin = np.zeros(Fu, dtype=np.int32)
    nbin = np.ones(Fu, dtype=np.int32)
    is_cat = np.zeros(Fu, dtype=bool)
    ubs: List[np.ndarray] = []
    cats: List[np.ndarray] = []
    for j, f in enumerate(used):
        m = bin_mappers[f]
        mt[j] = MT_CODE.get(m.missing_type, 0)
        dbin[j] = int(m.default_bin)
        nbin[j] = int(m.num_bin)
        if m.bin_type == BIN_TYPE_CATEGORICAL:
            is_cat[j] = True
            # bin_to_cat[0] is the NaN/unseen slot; slots 1.. hold the raw
            # category values, bin index = slot index
            cats.append(np.asarray(m.bin_to_cat[1:], dtype=np.int64))
            ubs.append(np.asarray([np.inf]))
            n_ub[j] = 1
        else:
            ub = np.asarray(m.bin_upper_bound, dtype=np.float64)
            n_ub[j] = len(ub)
            ubs.append(ub)
            cats.append(np.empty(0, dtype=np.int64))
    B = max((len(u) for u in ubs), default=1)
    C = max((len(c) for c in cats), default=0)
    ub_pad = np.full((Fu, B), np.inf, dtype=np.float32)
    for j, u in enumerate(ubs):
        ub_pad[j, :len(u)] = _f32_exclusive(u)
    # sorted table + permutation: slot k of bin_to_cat[1:] is bin k+1, so
    # the assignment searches cat_sorted and maps the hit position through
    # cat_perm back to the bin index
    cat_sorted = np.full((Fu, max(C, 1)), _CAT_PAD, dtype=np.int32)
    cat_perm = np.zeros((Fu, max(C, 1)), dtype=np.int32)
    for j, cv in enumerate(cats):
        if len(cv):
            order = np.argsort(cv, kind="stable")
            cat_sorted[j, :len(cv)] = cv[order].astype(np.int32)
            cat_perm[j, :len(cv)] = order.astype(np.int32) + 1
    return IngestTables(ub=ub_pad, n_ub=n_ub, mt=mt, default_bin=dbin,
                        num_bin=nbin, is_cat=is_cat, cat_sorted=cat_sorted,
                        cat_perm=cat_perm)


class _DeviceTables:
    """``IngestTables`` on the device, shaped for the assignment."""

    def __init__(self, t: IngestTables, device: torch.device):
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)
        self.ub = put(t.ub)                                   # [Fu, B]
        self.n_ub_m1 = put(t.n_ub - 1)[:, None]               # [Fu, 1]
        self.miss = put(np.where(t.mt == 2, t.num_bin - 1,
                                 t.default_bin).astype(np.int32))[:, None]
        self.is_cat = put(t.is_cat)[:, None]                  # [Fu, 1]
        self.any_cat = bool(t.is_cat.any())
        self.cat_sorted = put(t.cat_sorted)                   # [Fu, C]
        self.cat_perm = put(t.cat_perm)                       # [Fu, C]


def assign_chunk(raw: torch.Tensor, t: _DeviceTables) -> torch.Tensor:
    """One chunk of rows through the full mapping: ``raw`` ``[R, Fu]``
    float32 (NaN = missing) gives the feature-major ``[Fu, R]`` int32 bins
    (the port of the JAX package's ``_assign_chunk_impl``)."""
    raw_t = raw.T.contiguous()                                # [Fu, R]
    nanm = torch.isnan(raw_t)
    v = torch.where(nanm, 0.0, raw_t)
    # one batched binary search per feature row against the exclusive-f32
    # bounds (padding bounds are +inf: they count only for v = +inf, which
    # the clip removes as the host's clip does)
    cnt = torch.searchsorted(t.ub, v, right=True, out_int32=True)
    del v
    out = torch.where(nanm, t.miss, torch.minimum(cnt, t.n_ub_m1))
    del cnt
    if t.any_cat:
        # categorical: the host's truncating int cast, with NaN -> -1 (the
        # host's missing sentinel) and inf / out-of-int32-range values ->
        # INT32_MIN (no table entry), masked BEFORE the cast, which is
        # undefined on CUDA for such values; then a binary search of the
        # sorted table, a hit mapped through cat_perm, a miss to bin 0
        inr = (raw_t >= -2.0**31) & (raw_t < 2.0**31)
        iv = torch.where(nanm, -1.0,
                         torch.where(inr, raw_t, -2.0**31)).to(torch.int32)
        del inr
        C = t.cat_sorted.shape[1]
        pos = torch.searchsorted(t.cat_sorted, iv,
                                 out_int32=True).clamp_(max=C - 1).long()
        found = torch.gather(t.cat_sorted, 1, pos)
        cb = torch.where(found == iv, torch.gather(t.cat_perm, 1, pos), 0)
        del pos, found, iv
        out = torch.where(t.is_cat, cb, out)
    return out


@dataclasses.dataclass
class DeviceIngestResult:
    """The binned matrix ``device_ingest`` produced, on its device.

    ``bins``: ``[n, Fu]`` row-major; ``bins_t``: ``[Fu, n]`` feature-major;
    both uint8, or both uint16 (wide bins). The engine may swap its
    row-padded copies in (so the
    unpadded originals are freed); ``host_binned`` always gives exactly
    the real rows. ``h2d_bytes``, ``chunks`` and ``assign_ms`` (the
    assignment's device time by CUDA events; None on the CPU) describe the
    run.
    """

    bins: torch.Tensor
    bins_t: torch.Tensor
    n_rows: int
    chunk_rows: int
    h2d_bytes: int = 0
    chunks: int = 0
    assign_ms: Optional[float] = None

    def host_binned(self) -> np.ndarray:
        return self.bins[:self.n_rows].cpu().numpy()


def chunk_rows_for(n_features: int) -> int:
    """Rows a chunk holds: a fixed budget of float32 chunk bytes (each
    staging buffer and each ``[Fu, R]`` int32 intermediate is one budget),
    so the chunk's memory stays the same at any width."""
    return max(CHUNK_BYTES // (4 * max(n_features, 1)), 1)


def device_ingest(X: np.ndarray, bin_mappers, used_features,
                  device: torch.device,
                  chunk_rows: Optional[int] = None,
                  out_dtype=None) -> DeviceIngestResult:
    """Bin the raw ``[n, F]`` float32/float64 host matrix ``X`` on
    ``device`` into bins of ``out_dtype`` (uint8 or uint16; by default
    uint8 unless a used feature has more than 256 bins), chunk by chunk
    (only ``used_features`` columns are read). ``chunk_rows`` defaults to
    ``chunk_rows_for(Fu)``."""
    used = list(used_features)
    n = int(X.shape[0])
    Fu = len(used)
    host_tables = build_tables(bin_mappers, used)
    tables = _DeviceTables(host_tables, device)
    if chunk_rows is None:
        chunk_rows = chunk_rows_for(Fu)
    R = max(min(int(chunk_rows), max(n, 1)), 1)
    col_sel = np.asarray(used, dtype=np.intp)
    take_all = Fu == X.shape[1] and np.array_equal(col_sel, np.arange(Fu))
    if out_dtype is None:
        out_dtype = bin_dtype(int(host_tables.num_bin.max(initial=2)))
    tdtype = torch.uint8 if np.dtype(out_dtype) == np.uint8 \
        else torch.uint16
    bins = torch.empty((n, Fu), dtype=tdtype, device=device)
    bins_t = torch.empty((Fu, n), dtype=tdtype, device=device)
    cuda = device.type == "cuda"
    if cuda:
        staging = [torch.empty((R, Fu), dtype=torch.float32,
                               pin_memory=True) for _ in range(2)]
        copied = [None, None]          # event after each buffer's last copy
        timers = []
    h2d = 0
    chunks = 0
    for i, s in enumerate(range(0, n, R)):
        e = min(s + R, n)
        src = X[s:e] if take_all else np.take(X[s:e], col_sel, axis=1)
        src = torch.from_numpy(np.ascontiguousarray(src))
        if cuda:
            buf = staging[i % 2][:e - s]
            if copied[i % 2] is not None:
                # the copy that last read this buffer must be done before
                # the host writes it again
                copied[i % 2].synchronize()
            buf.copy_(src)             # the float32 cast, on the host
            chunk = buf.to(device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            copied[i % 2] = ev
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
        else:
            chunk = src.to(torch.float32)
        out = assign_chunk(chunk, tables)
        bins_t[:, s:e] = out
        bins[s:e] = out.T
        del out, chunk
        if cuda:
            t1.record()
            timers.append((t0, t1))
        h2d += (e - s) * Fu * 4
        chunks += 1
    assign_ms = None
    if cuda:
        torch.cuda.synchronize(device)
        assign_ms = float(sum(a.elapsed_time(b) for a, b in timers))
    return DeviceIngestResult(bins=bins, bins_t=bins_t, n_rows=n,
                              chunk_rows=R, h2d_bytes=h2d, chunks=chunks,
                              assign_ms=assign_ms)
