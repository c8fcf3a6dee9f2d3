"""Bin-id matrices of one or two bytes an element.

A dataset whose used features (and, under EFB, whose physical columns)
all have at most 256 bins stores its bin ids as uint8; with more, as
uint16 (the JAX package's rule, ``io/dataset.py::_binned_dtype_with_guard``).
Kernels A, B and B′ take both.

torch implements few operations on uint16: copies, casts, slices,
``cat`` and ``index_select`` work, but comparisons, arithmetic, ``gather``
and indexed stores raise. So the port keeps uint16 storage, runs
``gather`` and indexed stores on an int16 view of the same bytes
(``movable``), and widens a gathered slice to int32 (masked with 0xFFFF,
so ids of 32,768 and above stay positive) before any compare. No int32
copy of a whole matrix is made: resident bins stay two bytes an
element.
"""
from __future__ import annotations

import numpy as np
import torch

# a feature with up to this many bins fits uint8 ids
MAX_BINS_U8 = 256
# and up to this many, uint16 ids (past it the reference's cast would wrap)
MAX_BINS_U16 = 65536
BIN_DTYPES = (torch.uint8, torch.uint16)


def bin_dtype(max_num_bin: int) -> np.dtype:
    """The bin-id dtype of a matrix whose widest column has
    ``max_num_bin`` bins."""
    return np.dtype(np.uint8 if max_num_bin <= MAX_BINS_U8 else np.uint16)


def movable(t: torch.Tensor) -> torch.Tensor:
    """A view of ``t`` that ``gather`` and indexed stores accept: int16
    for uint16 bins, ``t`` itself otherwise."""
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def gather_bins(t: torch.Tensor, dim: int, index: torch.Tensor
                ) -> torch.Tensor:
    """``torch.gather(t, dim, index)`` as int32 bin ids."""
    if t.dtype == torch.uint16:
        return torch.gather(t.view(torch.int16), dim, index).to(
            torch.int32) & 0xFFFF
    return torch.gather(t, dim, index).to(torch.int32)


def index_bins(t: torch.Tensor, *index) -> torch.Tensor:
    """``t[index]`` (advanced indexing) as int32 bin ids."""
    if t.dtype == torch.uint16:
        return t.view(torch.int16)[index].to(torch.int32) & 0xFFFF
    return t[index].to(torch.int32)
