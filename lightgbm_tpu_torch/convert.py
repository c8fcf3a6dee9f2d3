"""Carry the JAX package's state across, as numpy arrays.

The tests hand the same state to both packages: the padded binned
matrices of ``lightgbm_tpu``'s ``_DeviceData`` (its feature-major copy is
int8 holding uint8 values by wraparound; torch has uint8, so the bytes
are viewed, not converted) and the per-tree arrays its engine fetches
(``GBDT._fetch_tree_arrays``). Nothing here imports JAX: the arrays arrive
as numpy.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .boosting.gbdt import DeviceData
from .tree import Tree


def device_data_from_jax(bins: np.ndarray, bins_t: Optional[np.ndarray],
                         label: Optional[np.ndarray], n: int,
                         weight: Optional[np.ndarray] = None,
                         device="cpu") -> DeviceData:
    """A ``DeviceData`` from the JAX package's padded arrays: ``bins``
    ``[n_pad, F]`` uint8, ``bins_t`` ``[F, n_pad]`` int8 or uint8 (or
    None), ``label``/``weight`` ``[n_pad]``, ``n`` real rows."""
    dev = torch.device(device)
    b = torch.from_numpy(np.array(bins).view(np.uint8)).to(dev)
    bt = None
    if bins_t is not None:
        bt = torch.from_numpy(np.array(bins_t).view(np.uint8)).to(dev)

    def f32(a):
        return None if a is None else torch.from_numpy(
            np.array(a, np.float32)).to(dev)

    return DeviceData(b, bt, int(n), f32(label), f32(weight))


def forest_from_jax(iterations: List[Dict[str, np.ndarray]],
                    shrinkage: float, bin_mappers,
                    used_features: List[int]) -> List[Tree]:
    """The port's trees from the JAX engine's arrays, one dict per
    iteration as ``GBDT._fetch_tree_arrays`` returns it (a leading class
    axis of K trees), appended in class order as the engine appends them
    and shrunk by ``shrinkage`` like the engine's own."""
    return [Tree.from_device({k: v[c] for k, v in it.items()}, shrinkage,
                             bin_mappers, used_features)
            for it in iterations for c in range(len(it["num_leaves"]))]
