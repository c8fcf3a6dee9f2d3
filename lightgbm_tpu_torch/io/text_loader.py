"""Text dataset loaders: CSV / TSV / LibSVM (+ sidecar files).

Reference: ``DatasetLoader::LoadFromFile`` + the Parser hierarchy
(src/io/dataset_loader.cpp, src/io/parser.cpp, UNVERIFIED — empty mount,
see SURVEY.md banner): format detection from the first lines,
``label_column`` / ``weight_column`` / ``group_column`` / ``ignore_column``
(by index or ``name:`` prefix), header handling, and ``.weight`` /
``.query`` sidecar files.

The port of ``lightgbm_tpu/io/text_loader.py``'s one-round loader. Files
are parsed by the native C++ reader (``native/text_parser.cpp``, built
with ``g++`` at first use); there is no Python fallback. Streamed
(``two_round``) loading is not ported.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np

from ..utils import log


@dataclasses.dataclass
class LoadedText:
    X: np.ndarray
    label: Optional[np.ndarray] = None
    weight: Optional[np.ndarray] = None
    group: Optional[np.ndarray] = None
    feature_names: Optional[List[str]] = None


def _first_data_lines(path: str, k: int = 2) -> List[str]:
    out = []
    with open(path, "r") as f:
        for line in f:
            s = line.strip()
            if s and not s.startswith("#"):
                out.append(s)
                if len(out) >= k:
                    break
    return out


def _detect_delim(line: str) -> str:
    for d in ("\t", ",", " "):
        if d in line:
            return d
    return ","


def _is_number(tok: str) -> bool:
    tok = tok.strip()
    if tok in ("", "NA", "na", "nan", "NaN", "?"):
        return True
    try:
        float(tok)
        return True
    except ValueError:
        return False


def sniff_format(path: str) -> Tuple[str, str, bool]:
    """Returns (kind, delim, has_header): kind in {csv, libsvm}."""
    lines = _first_data_lines(path)
    if not lines:
        log.fatal(f"Data file {path} is empty")
    first = lines[0]
    probe = lines[-1]
    toks = probe.replace("\t", " ").split()
    if len(toks) >= 2 and all(":" in t for t in toks[1:3]):
        return "libsvm", " ", False
    delim = _detect_delim(first)
    has_header = not all(_is_number(t) for t in first.split(delim))
    return "csv", delim, has_header


def _native():
    from ..native import text_parser
    return text_parser()


def _parse_dense(path: str, delim: str, skip: int, n_rows: int,
                 n_cols: int) -> np.ndarray:
    out = np.empty((max(n_rows, 0), n_cols), dtype=np.float64)
    got = _native().parse_dense(
        path.encode(), delim.encode(), skip,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        max(n_rows, 0), n_cols)
    if got < 0:
        log.fatal(f"Could not read data file {path}")
    return out[:got]


def _parse_libsvm(path: str) -> Tuple[np.ndarray, np.ndarray]:
    lib = _native()
    n_rows = lib.count_lines(path.encode())
    if n_rows < 0:
        log.fatal(f"Could not read data file {path}")
    # an entry "i:v" and its separator take at least 4 bytes
    max_nnz = max(os.path.getsize(path) // 4, 16)
    ri = np.empty(max_nnz, dtype=np.int32)
    ci = np.empty(max_nnz, dtype=np.int32)
    vv = np.empty(max_nnz, dtype=np.float64)
    lab = np.empty(n_rows, dtype=np.float64)
    nnz = lib.parse_libsvm(
        path.encode(), 0,
        ri.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        ci.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        vv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        lab.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        max_nnz, n_rows)
    if nnz < 0:
        log.fatal(f"Could not parse LibSVM data file {path}")
    ri, ci, vv = ri[:nnz], ci[:nnz], vv[:nnz]
    n_cols = int(ci.max()) + 1 if nnz else 0
    X = np.zeros((n_rows, n_cols), dtype=np.float64)
    X[ri, ci] = vv
    return X, lab


def _resolve_column(spec, names: Optional[List[str]]) -> Optional[int]:
    """LightGBM column spec: int index, 'N', or 'name:colname'."""
    if spec is None or spec == "":
        return None
    if isinstance(spec, int):
        return spec
    s = str(spec)
    if s.startswith("name:"):
        want = s[5:]
        if names and want in names:
            return names.index(want)
        log.fatal(f"Could not find column {want} in data file header")
    return int(s)


def _resolve_columns(names, label_column, weight_column, group_column,
                     ignore_column):
    """Column specs as indices: (label, weight, group, dropped list)."""
    lbl_idx = _resolve_column(
        0 if label_column in ("auto", "", None) else label_column, names)
    w_idx = _resolve_column(weight_column, names)
    g_idx = _resolve_column(group_column, names)
    drop = [i for i in (lbl_idx, w_idx, g_idx) if i is not None]
    if ignore_column:
        if isinstance(ignore_column, str):
            s = ignore_column
            if s.startswith("name:"):
                # the form name:c1,c2,c3 — the prefix applies to the list
                spec = ["name:" + c for c in s[5:].split(",") if c]
            else:
                spec = s.split(",")
        else:
            spec = ignore_column
        drop += [_resolve_column(c, names) for c in spec]
    return lbl_idx, w_idx, g_idx, drop


def load_text(path, label_column="auto", weight_column=None,
              group_column=None, ignore_column=None,
              has_header: Optional[bool] = None) -> LoadedText:
    """Load a text dataset the way the reference CLI does."""
    path = os.fspath(path)
    kind, delim, sniffed_header = sniff_format(path)
    if kind == "libsvm":
        X, label = _parse_libsvm(path)
        out = LoadedText(X=X, label=label)
    else:
        header = sniffed_header if has_header is None else has_header
        first = _first_data_lines(path, 1)[0]
        names = [t.strip() for t in first.split(delim)] if header else None
        n_rows = _native().count_lines(path.encode()) - (1 if header else 0)
        X = _parse_dense(path, delim, 1 if header else 0, n_rows,
                         first.count(delim) + 1)
        lbl_idx, w_idx, g_idx, drop = _resolve_columns(
            names, label_column, weight_column, group_column,
            ignore_column)
        keep = [i for i in range(X.shape[1]) if i not in drop]
        out = LoadedText(
            X=X[:, keep],
            label=X[:, lbl_idx] if lbl_idx is not None else None,
            weight=X[:, w_idx] if w_idx is not None else None,
            feature_names=([names[i] for i in keep] if names else None))
        if g_idx is not None:
            # the group column holds per-row query ids; counts are taken in
            # row order (sorting by id would misalign the boundaries of
            # ids that do not ascend)
            qid = X[:, g_idx].astype(np.int64)
            change = np.flatnonzero(np.diff(qid) != 0) + 1
            out.group = np.diff(np.concatenate([[0], change, [len(qid)]]))

    # sidecar files (metadata.cpp: <data>.weight / <data>.query)
    if out.weight is None and os.path.exists(path + ".weight"):
        out.weight = np.loadtxt(path + ".weight", dtype=np.float64).ravel()
    if out.group is None and os.path.exists(path + ".query"):
        out.group = np.loadtxt(path + ".query", dtype=np.int64).ravel()
    return out
