"""Device-memory budgeting for the binned dataset: one limit probe and one
size estimate.

The port of ``lightgbm_tpu/utils/hbm.py`` as far as the device-ingest gate
(``io/dataset.py``) needs it: the gate stands down when the binned matrix
would not sit comfortably in the card's memory.
"""
from __future__ import annotations

from typing import Optional

# the device-ingest gate stands down above this fraction of the card's
# memory (the JAX package's auto-streaming line)
STREAM_HBM_FRACTION = 0.6


def hbm_bytes_limit() -> Optional[int]:
    """Total memory of the current CUDA device in bytes, or None on a
    machine without one (every caller reads None as "no gate")."""
    import torch
    if not torch.cuda.is_available():
        return None
    _free, total = torch.cuda.mem_get_info()
    return int(total)


def binned_device_bytes(n_rows: int, n_features: int, itemsize: int,
                        with_transposed: bool = True) -> int:
    """Device-resident footprint of a binned dataset: the row-major bins
    plus the same-size feature-major copy."""
    return (int(n_rows) * int(n_features) * int(itemsize)
            * (2 if with_transposed else 1))
