"""Mask-driven row compaction (stream compaction).

Reference context: LightGBM's sampled training paths scan index subsets
(``bag_data_indices_`` in goss.hpp / bagging.hpp — upstream paths
UNVERIFIED, empty mount, see SURVEY.md banner).

The port of ``lightgbm_tpu/ops/compact.py``: ``compact_by_mask`` moves the
kept columns of feature-major arrays into a fixed-width buffer, bit-exact,
in source order, with a zero tail; a kept column's position is the number
of kept columns before it, and positions at or past the buffer's width
are dropped. For CUDA tensors it is one launch of the hand-written kernel
(``csrc/compact.cu`` on the stable-partition core of
``csrc/stable_partition.cuh``), which scans the mask, finds the positions
and writes the whole output itself; for CPU tensors it runs
``compact_by_mask_plain``. ``plan_compaction`` is the JAX package's plan
(per-block destinations plus 128-aligned block write positions, the TPU
kernel's layout), kept as a plain function held against its JAX twin:
its positions ``aligned * 128 + rem + dest`` are the same exclusive
prefix counts, clamp or not, so the main path no longer needs it. A GPU
store to a computed address is exact, so the TPU kernel's permutation
matmuls and bf16x3 split have no counterpart.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import kernels
from .bins import BIN_DTYPES, movable

_LANE = 128  # block write positions are multiples of this (TPU layout)


def compaction_out_cols(max_selected: int, rows_per_block: int,
                        multiple: int) -> int:
    """Static output width for ``compact_by_mask``: the kept rows plus one
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


def compact_by_mask_plain(bins_t: torch.Tensor, vals_t: torch.Tensor,
                          keep: torch.Tensor, out_cols: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the kernel (same contract): positions from
    one cumsum of the mask, then an indexed copy with a zero tail (uint16
    bins through their int16 view)."""
    k = keep.to(torch.bool)
    pos = torch.cumsum(k, 0) - 1                 # kept columns before
    sel = k & (pos < out_cols)
    out_b = torch.zeros((bins_t.shape[0], out_cols), dtype=bins_t.dtype,
                        device=bins_t.device)
    out_v = torch.zeros((vals_t.shape[0], out_cols), dtype=vals_t.dtype,
                        device=vals_t.device)
    movable(out_b)[:, pos[sel]] = movable(bins_t)[:, sel]
    out_v[:, pos[sel]] = vals_t[:, sel]
    return out_b, out_v


def _check_inputs(bins_t, vals_t, keep, out_cols):
    if bins_t.dtype not in BIN_DTYPES or bins_t.dim() != 2:
        raise ValueError(f"bins_t must be [F, n] uint8 or uint16, got "
                         f"{tuple(bins_t.shape)} {bins_t.dtype}")
    F, n = bins_t.shape
    if vals_t.dtype != torch.float32 or vals_t.dim() != 2 \
            or vals_t.shape[1] != n:
        raise ValueError(f"vals_t must be [C, {n}] float32, got "
                         f"{tuple(vals_t.shape)} {vals_t.dtype}")
    if keep.dtype not in (torch.bool, torch.uint8) \
            or tuple(keep.shape) != (n,):
        raise ValueError(f"keep must be [{n}] bool or uint8, got "
                         f"{tuple(keep.shape)} {keep.dtype}")
    if out_cols <= 0:
        raise ValueError(f"out_cols must be positive, got {out_cols}")
    tensors = (bins_t, vals_t, keep)
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on different devices: {devs}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("compaction inputs must be contiguous")


def compact_by_mask(bins_t: torch.Tensor, vals_t: torch.Tensor,
                    keep: torch.Tensor, out_cols: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact the kept columns of feature-major arrays.

    Args:
      bins_t: ``[F, n]`` uint8 or uint16 feature-major binned matrix.
      vals_t: ``[C, n]`` float32 channel-major per-row values.
      keep: ``[n]`` bool or uint8 keep mask (non-zero: kept).
      out_cols: output width (``compaction_out_cols``).

    Returns:
      (``[F, out_cols]`` bins of ``bins_t``'s dtype, ``[C, out_cols]``
      float32): kept columns
      packed contiguously left to right in source order, those past
      ``out_cols`` dropped; the tail is zero. CUDA tensors launch the
      kernel once, which writes every output element
      (``compact_by_mask.launches`` counts the launches, and
      ``compact_by_mask.launches_u16`` those on uint16 bins); CPU tensors
      take ``compact_by_mask_plain``.
    """
    _check_inputs(bins_t, vals_t, keep, out_cols)
    dev = bins_t.device
    if dev.type == "cpu":
        return compact_by_mask_plain(bins_t, vals_t, keep, out_cols)
    if dev.type != "cuda":
        raise ValueError(f"no compaction kernel for device {dev}")
    F, n = bins_t.shape
    C = vals_t.shape[0]
    wide = bins_t.dtype == torch.uint16
    out_b = torch.empty((F, out_cols), dtype=bins_t.dtype, device=dev)
    out_v = torch.empty((C, out_cols), dtype=torch.float32, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev)
    scratch, epoch = kernels.scan_scratch(
        stream, lib.lgbt_compact_scratch_bytes(n))
    fn = lib.lgbt_compact_by_mask_u16 if wide else lib.lgbt_compact_by_mask
    rc = fn(
        bins_t.data_ptr(), vals_t.data_ptr(), keep.data_ptr(), n, F, C,
        out_cols, out_b.data_ptr(), out_v.data_ptr(), scratch.data_ptr(),
        epoch, stream.cuda_stream)
    kernels.check(rc, "compact_by_mask")
    kernels.scan_launched(stream, epoch)
    compact_by_mask.launches += 1
    compact_by_mask.launches_u16 += int(wide)
    return out_b, out_v


compact_by_mask.launches = 0
compact_by_mask.launches_u16 = 0


def _lib() -> ctypes.CDLL:
    lib = kernels.load("compact")
    if lib.lgbt_compact_by_mask.argtypes is None:
        for fn in (lib.lgbt_compact_by_mask, lib.lgbt_compact_by_mask_u16):
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                           + [ctypes.c_void_p] * 3 + [ctypes.c_uint]
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        q = lib.lgbt_compact_scratch_bytes
        q.argtypes = [ctypes.c_int]
        q.restype = ctypes.c_longlong
    return lib
