"""Booster: the user-facing training/prediction handle.

Reference: python-package/lightgbm/basic.py (UNVERIFIED — empty mount, see
SURVEY.md banner). The port of ``lightgbm_tpu/basic.py``: the Booster
wraps the in-process boosting engine (GBDT, or DART with
``boosting="dart"``), or a host model loaded from LightGBM model text,
with the same method names.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .boosting import GBDT, create_boosting
from .config import Config
from .io.dataset import Dataset
from .utils.log import LightGBMError

__all__ = ["Booster", "Dataset", "LightGBMError"]


class Booster:
    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None, noise=None):
        self.params = dict(params or {})
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._engine: Optional[GBDT] = None
        self._from_model = None
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("Training data should be Dataset instance")
            self.config = Config(self.params)
            for key in ("max_bin", "min_data_in_bin",
                        "bin_construct_sample_cnt", "use_missing",
                        "zero_as_missing", "data_random_seed",
                        "device_type", "tpu_ingest_device"):
                train_set.params.setdefault(key, getattr(self.config, key))
            self._engine = create_boosting(self.config, train_set,
                                           noise=noise)
            self.train_set = train_set
        elif model_file is not None or model_str is not None:
            from .io.model_text import load_model_string
            if model_file is not None:
                with open(model_file) as f:
                    model_str = f.read()
            self._from_model = load_model_string(model_str)
            self.config = Config(self.params)
        else:
            raise TypeError("At least one of train_set, model_file or "
                            "model_str should be provided")

    # ------------------------------------------------------------------
    @property
    def engine(self) -> GBDT:
        if self._engine is None:
            raise LightGBMError("Booster has no training engine "
                                "(loaded from model file)")
        return self._engine

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        self.engine.add_valid(data, name)
        return self

    def update(self) -> bool:
        """Run one boosting iteration; returns True if stopped early."""
        self.engine.train_one_iter()
        return False

    def rollback_one_iter(self) -> "Booster":
        """Drop the last iteration's trees (GBDT::RollbackOneIter)."""
        self.engine.rollback_one_iter()
        return self

    def eval_train(self) -> List:
        return self.engine.eval_set(-1)

    def eval_valid(self) -> List:
        out = []
        for i in range(len(self.engine.valid_data)):
            out.extend(self.engine.eval_set(i))
        return out

    # ------------------------------------------------------------------
    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False
                ) -> np.ndarray:
        """Predictions ``[n]``, or ``[n, K]`` for multiclass. With
        ``num_iteration`` None, the best iteration (early stopping's, or
        every iteration trained) when there is one."""
        if num_iteration is None:
            num_iteration = (self.best_iteration
                             if self.best_iteration > 0 else -1)
        if self._from_model is not None:
            return self._from_model.predict(
                data, raw_score=raw_score, start_iteration=start_iteration,
                num_iteration=num_iteration, pred_leaf=pred_leaf)
        if pred_leaf:
            # leaf indices: the host model
            return self._to_host_model().predict(
                data, raw_score=raw_score, start_iteration=start_iteration,
                num_iteration=num_iteration, pred_leaf=pred_leaf)
        return self.engine.predict(data, raw_score=raw_score,
                                   start_iteration=start_iteration,
                                   num_iteration=num_iteration)

    def _to_host_model(self):
        from .io.model_text import HostModel
        return HostModel.from_engine(self.engine, self.config)

    def model_to_string(self, importance_type: str = "split") -> str:
        from .io.model_text import save_model_string
        if (importance_type == "split"
                and int(self.params.get("saved_feature_importance_type",
                                        0) or 0) == 1):
            importance_type = "gain"
        hm = (self._from_model if self._from_model is not None
              else self._to_host_model())
        return save_model_string(hm, importance_type=importance_type)

    def save_model(self, filename: str,
                   importance_type: str = "split") -> "Booster":
        with open(filename, "w") as f:
            f.write(self.model_to_string(importance_type))
        return self

    def current_iteration(self) -> int:
        if self._from_model is not None:
            return len(self._from_model.trees) \
                // max(self._from_model.num_class, 1)
        return self.engine.current_iteration
