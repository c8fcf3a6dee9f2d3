"""The port's capability table: which features this package trains.

``lightgbm_tpu/capabilities.py`` gates features per boosting engine; this
package has one engine so far -- binary gradient boosting with the serial
learner and pool-mode histograms, trained on full rows (with bagging,
per-tree feature_fraction and the leaf-ordered row partition) or under
GOSS (with the compacted histogram buffer), on exact or quantized
gradients. Every other feature of the JAX package is FATAL here with a
message that names it, so an unported parameter fails loudly instead of
silently training something else.
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Tuple)

from .utils import log

# objectives training one tree PER CLASS per iteration
# (Config.num_tree_per_iteration)
MULTI_TREE_OBJECTIVES = ("multiclass", "multiclassova")

# tpu_auto_quantize flips use_quantized_grad on for these objectives at
# this many rows or more (lightgbm_tpu/capabilities.py's policy)
AUTO_QUANTIZE_OBJECTIVES = ("binary",)
AUTO_QUANT_MIN_ROWS = 500_000

# tpu_hist_partition=auto engages the leaf-ordered row partition only at
# this many padded rows or more (the JAX package's threshold; not yet
# re-decided from measurements on the GPU)
HIST_PARTITION_MIN_ROWS = 1 << 20

# metrics this package evaluates
PORTED_METRICS = ("auc", "binary_logloss", "binary")

# JAX-package knobs (``tpu_*`` and friends in config._PARAMS) this package
# honours; any other one set to a non-default value is FATAL
PORTED_KNOBS = ("tpu_rows_per_block", "tpu_leaf_batch", "tpu_goss_compact",
                "tpu_auto_quantize", "tpu_hist_mode", "tpu_hist_partition",
                "tpu_ingest_threads")


class Capability(NamedTuple):
    describe: str                           # phrase for fatal messages
    requested: Callable[[Any], bool]        # predicate over Config
    example: Optional[Dict[str, Any]] = None  # params witnessing it (tests)


def _unported_knobs(c) -> List[str]:
    from .config import _PARAMS
    out = []
    for name in c.raw_params:
        if name not in _PARAMS or name in PORTED_KNOBS:
            continue
        if not (name.startswith("tpu_") or name.startswith("checkpoint_")):
            continue
        if getattr(c, name) != _PARAMS[name][1]:
            out.append(name)
    return out


# every entry is FATAL: the port trains none of these yet
UNPORTED: Dict[str, Capability] = {
    "objective": Capability(
        "objectives other than binary",
        lambda c: str(c.objective) != "binary",
        {"objective": "regression"}),
    "multiclass": Capability(
        "multiclass", lambda c: c.num_tree_per_iteration > 1,
        {"objective": "multiclass", "num_class": 3}),
    "boosting": Capability(
        "boosting other than gbdt (dart, rf)",
        lambda c: c.boosting != "gbdt", {"boosting": "dart"}),
    "sample_strategy": Capability(
        "data_sample_strategy other than bagging/goss",
        lambda c: str(c.data_sample_strategy) not in ("bagging", "goss"),
        {"data_sample_strategy": "uniform"}),
    "feature_fraction": Capability(
        "feature_fraction_bynode < 1 (per-node column sampling)",
        lambda c: c.feature_fraction_bynode < 1.0,
        {"feature_fraction_bynode": 0.5}),
    "tree_learner": Capability(
        "distributed tree learners (data, voting, feature)",
        lambda c: c.tree_learner != "serial", {"tree_learner": "data"}),
    "categorical_features": Capability(
        "categorical features", lambda c: bool(c.categorical_feature),
        {"categorical_feature": "0"}),
    "wide_bins": Capability(
        "max_bin > 255 (uint16 bins)",
        lambda c: int(c.max_bin) > 255 or any(
            int(m) > 255 for m in (c.max_bin_by_feature or [])),
        {"max_bin": 1023}),
    "linear_tree": Capability(
        "linear_tree", lambda c: bool(c.linear_tree), {"linear_tree": True}),
    "monotone_constraints": Capability(
        "monotone constraints",
        lambda c: any(int(m) != 0 for m in (c.monotone_constraints or [])),
        {"monotone_constraints": [1, 0, 0, 0]}),
    "interaction_constraints": Capability(
        "interaction constraints",
        lambda c: bool(c.interaction_constraints),
        {"interaction_constraints": "[0,1],[2,3]"}),
    "cegb": Capability(
        "CEGB",
        lambda c: (c.cegb_tradeoff != 1.0 or c.cegb_penalty_split > 0
                   or bool(c.cegb_penalty_feature_coupled)
                   or bool(c.cegb_penalty_feature_lazy)),
        {"cegb_penalty_split": 1.0}),
    "forced_splits": Capability(
        "forced splits", lambda c: bool(c.forcedsplits_filename),
        {"forcedsplits_filename": "forced.json"}),
    "path_smooth": Capability(
        "path_smooth", lambda c: c.path_smooth > 0.0, {"path_smooth": 1.0}),
    "extra_trees": Capability(
        "extra_trees", lambda c: bool(c.extra_trees), {"extra_trees": True}),
    "feature_contri": Capability(
        "feature_contri",
        lambda c: any(float(v) != 1.0 for v in (c.feature_contri or [])),
        {"feature_contri": [0.5, 1.0]}),
    "quant_renew": Capability(
        "quant_train_renew_leaf", lambda c: bool(c.quant_train_renew_leaf),
        {"use_quantized_grad": True, "quant_train_renew_leaf": True}),
    "hist_rebuild": Capability(
        "tpu_hist_mode=rebuild", lambda c: c.tpu_hist_mode != "pool",
        {"tpu_hist_mode": "rebuild"}),
    "early_stopping": Capability(
        "early stopping", lambda c: c.early_stopping_round > 0,
        {"early_stopping_round": 5}),
    "metric": Capability(
        f"metrics other than {', '.join(PORTED_METRICS)}",
        lambda c: any(m.strip().lower() not in PORTED_METRICS + (
            "", "na", "null", "none", "custom") for m in c.metric),
        {"metric": "l2"}),
    "training_metric": Capability(
        "is_provide_training_metric",
        lambda c: bool(c.is_provide_training_metric),
        {"is_provide_training_metric": True}),
    "snapshots": Capability(
        "snapshot_freq", lambda c: c.snapshot_freq > 0, {"snapshot_freq": 5}),
    "jax_knobs": Capability(
        "knobs of the JAX package this port does not honour",
        lambda c: bool(_unported_knobs(c)),
        {"tpu_double_precision_hist": True}),
}


def hist_partition_auto(config, cuda_kernels: bool,
                        n_pad: int) -> Tuple[bool, Optional[str]]:
    """The ``tpu_hist_partition=auto`` policy (the JAX package's, with
    "the CUDA kernels are in use" where it has "the Pallas kernels are in
    use"): engage the leaf-ordered row partition only on the pool path
    over a large un-compacted source. Returns ``(engage,
    stand_down_reason)``; the reason is None when engaging or when the
    path was never plausible (no CUDA kernels, or rebuild mode)."""
    if not cuda_kernels or str(config.tpu_hist_mode) != "pool":
        return False, None
    if str(config.data_sample_strategy) == "goss":
        return False, "GOSS already compacts the scan"
    if n_pad < HIST_PARTITION_MIN_ROWS:
        return False, ("dataset too small to amortize the "
                       "repartition move")
    return True, None


def unported_features(config) -> List[str]:
    """Names of the UNPORTED entries ``config`` requests."""
    return [name for name, cap in UNPORTED.items() if cap.requested(config)]


def check(config, fobj=None, init_model=None) -> None:
    """Refuse (``LightGBMError``) any feature this package does not train
    yet; the message names every one the config requests."""
    found = [UNPORTED[n].describe
             + (f" ({', '.join(_unported_knobs(config))})"
                if n == "jax_knobs" else "")
             for n in unported_features(config)]
    if fobj is not None:
        found.append("custom objective functions")
    if init_model is not None:
        found.append("training continuation (init_model)")
    if found:
        log.fatal("lightgbm_tpu_torch does not support "
                  + "; ".join(found) + " yet")
