"""Mask-driven row compaction (stream compaction).

Reference context: LightGBM's sampled training paths scan index subsets
(``bag_data_indices_`` in goss.hpp / bagging.hpp — upstream paths
UNVERIFIED, empty mount, see SURVEY.md banner).

The port of ``lightgbm_tpu/ops/compact.py``: ``plan_compaction`` turns a
keep mask into exact stream positions (per-block destinations plus
128-aligned block write positions, the JAX package's layout), and
``compact_rows`` moves the kept columns of feature-major arrays into a
fixed-width buffer, bit-exact, in source order, with a zero tail. For
CUDA tensors ``compact_rows`` launches the hand-written kernel
(``csrc/compact.cu``, a plain scatter — a GPU store to a computed address
is exact, so the TPU kernel's permutation matmuls and bf16x3 split have
no counterpart); for CPU tensors it runs ``compact_rows_plain``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import kernels

_LANE = 128  # block write positions are multiples of this (TPU layout)


def compaction_out_cols(max_selected: int, rows_per_block: int,
                        multiple: int) -> int:
    """Static output width for ``compact_rows``: the kept rows plus one
    block of write slack, rounded up to ``multiple`` (the histogram
    row-block size) — the JAX package's buffer size."""
    m = max_selected + rows_per_block + _LANE
    return -(-m // multiple) * multiple


def plan_compaction(mask: torch.Tensor, rows_per_block: int,
                    out_cols: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Within-block destinations + per-block aligned write positions.

    Args:
      mask: ``[n]`` bool/int keep mask; n % rows_per_block == 0.
      rows_per_block: source block size R.
      out_cols: output width (``compaction_out_cols``); write positions
        are clamped like the JAX package's so the layouts agree even when
        a caller's bound is violated.

    Returns:
      (dest ``[n]`` int32 within-block destination or -1 for dropped
      rows, aligned ``[nb]`` int32 block write positions in 128-column
      units, rem ``[nb]`` int32 offset of each block's first kept row past
      its aligned position).
    """
    n = mask.shape[0]
    R = rows_per_block
    if n % R:
        raise ValueError(f"n={n} must be a multiple of rows_per_block={R}")
    nb = n // R
    mb = mask.reshape(nb, R).to(torch.int32)
    within = torch.cumsum(mb, dim=1, dtype=torch.int32)
    cnt = within[:, -1]
    dest = torch.where(mb > 0, within - 1, -1).reshape(n).to(torch.int32)
    stream = torch.cat([torch.zeros(1, dtype=torch.int32, device=mask.device),
                        torch.cumsum(cnt, 0, dtype=torch.int32)[:-1]])
    aligned = torch.clamp(stream // _LANE,
                          max=(out_cols - R - _LANE) // _LANE)
    rem = stream - aligned * _LANE
    return dest, aligned.to(torch.int32), rem.to(torch.int32)


def _positions(dest, aligned, rem, rows_per_block):
    """Exact stream position of every row (-1 = dropped)."""
    stream = aligned.to(torch.int64) * _LANE + rem
    pos = torch.repeat_interleave(stream, rows_per_block) + dest
    return torch.where(dest >= 0, pos, -1)


def compact_rows_plain(bins_t: torch.Tensor, vals_t: torch.Tensor,
                       dest: torch.Tensor, aligned: torch.Tensor,
                       rem: torch.Tensor, *, out_cols: int,
                       rows_per_block: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the kernel (same contract): an indexed
    copy of the kept columns; positions past ``out_cols`` are dropped."""
    pos = _positions(dest, aligned, rem, rows_per_block)
    keep = (pos >= 0) & (pos < out_cols)
    out_b = torch.zeros((bins_t.shape[0], out_cols), dtype=bins_t.dtype,
                        device=bins_t.device)
    out_v = torch.zeros((vals_t.shape[0], out_cols), dtype=vals_t.dtype,
                        device=vals_t.device)
    out_b[:, pos[keep]] = bins_t[:, keep]
    out_v[:, pos[keep]] = vals_t[:, keep]
    return out_b, out_v


def _check_inputs(bins_t, vals_t, dest, aligned, rem, out_cols, R):
    if bins_t.dtype != torch.uint8 or bins_t.dim() != 2:
        raise ValueError(f"bins_t must be [F, n] uint8, got "
                         f"{tuple(bins_t.shape)} {bins_t.dtype}")
    F, n = bins_t.shape
    if vals_t.dtype != torch.float32 or vals_t.dim() != 2 \
            or vals_t.shape[1] != n:
        raise ValueError(f"vals_t must be [C, {n}] float32, got "
                         f"{tuple(vals_t.shape)} {vals_t.dtype}")
    if R <= 0 or n % R:
        raise ValueError(f"n={n} must be a multiple of rows_per_block={R}")
    for name, t, size in (("dest", dest, n), ("aligned", aligned, n // R),
                          ("rem", rem, n // R)):
        if t.dtype != torch.int32 or tuple(t.shape) != (size,):
            raise ValueError(f"{name} must be [{size}] int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if out_cols <= 0:
        raise ValueError(f"out_cols must be positive, got {out_cols}")
    tensors = (bins_t, vals_t, dest, aligned, rem)
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on different devices: {devs}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("compaction inputs must be contiguous")


def compact_rows(bins_t: torch.Tensor, vals_t: torch.Tensor,
                 dest: torch.Tensor, aligned: torch.Tensor,
                 rem: torch.Tensor, *, out_cols: int,
                 rows_per_block: int = 1024
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact kept columns of feature-major arrays.

    Args:
      bins_t: ``[F, n]`` uint8 feature-major binned matrix.
      vals_t: ``[C, n]`` float32 channel-major per-row values.
      dest / aligned / rem: from ``plan_compaction`` (same rows_per_block).
      out_cols: output width (``compaction_out_cols``).

    Returns:
      (``[F, out_cols]`` uint8, ``[C, out_cols]`` float32): kept columns
      packed contiguously left to right in source order; the tail is
      zero. CUDA tensors launch the kernel (``compact_rows.launches``
      counts the launches); CPU tensors take ``compact_rows_plain``.
    """
    R = rows_per_block
    _check_inputs(bins_t, vals_t, dest, aligned, rem, out_cols, R)
    dev = bins_t.device
    if dev.type == "cpu":
        return compact_rows_plain(bins_t, vals_t, dest, aligned, rem,
                                  out_cols=out_cols, rows_per_block=R)
    if dev.type != "cuda":
        raise ValueError(f"no compaction kernel for device {dev}")
    F, n = bins_t.shape
    C = vals_t.shape[0]
    out_b = torch.zeros((F, out_cols), dtype=torch.uint8, device=dev)
    out_v = torch.zeros((C, out_cols), dtype=torch.float32, device=dev)
    rc = _lib().lgbt_compact_rows(
        bins_t.data_ptr(), vals_t.data_ptr(), dest.data_ptr(),
        aligned.data_ptr(), rem.data_ptr(), n, F, C, R, out_cols,
        out_b.data_ptr(), out_v.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(rc, "compact_rows")
    compact_rows.launches += 1
    return out_b, out_v


compact_rows.launches = 0


def _lib() -> ctypes.CDLL:
    lib = kernels.load("compact")
    fn = lib.lgbt_compact_rows
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
    return lib
