"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu.

A LightGBM-compatible ``Dataset`` / ``train`` / ``Booster`` surface whose
hot loops run hand-written CUDA kernels on an NVIDIA Hopper card
(``csrc/``). ``device_type`` picks the device: "cuda" (default) or "cpu"
(the kernels' plain torch versions; what the CPU tests run). The package
imports torch and numpy, never JAX or ``lightgbm_tpu``.
"""
from .basic import Booster, Dataset, LightGBMError
from .callback import early_stopping, log_evaluation, record_evaluation
from .engine import train

__all__ = ["Booster", "Dataset", "LightGBMError", "train",
           "early_stopping", "log_evaluation", "record_evaluation"]
