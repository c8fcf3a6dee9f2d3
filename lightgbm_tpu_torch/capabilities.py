"""The port's capability table: which features this package trains.

``lightgbm_tpu/capabilities.py`` gates features per boosting engine; this
package has two so far -- gradient boosting and DART (``boosting="dart"``,
with ``drop_rate``, ``max_drop``, ``skip_drop``, ``uniform_drop`` and
``xgboost_dart_mode``) -- with the serial learner and pool-mode histograms
for every built-in objective (K trees an iteration for multiclass;
lambdarank, with truncation, norm and position debiasing, and rank_xendcg
on query groups from ``Dataset(group=...)``), trained on full rows (with
bagging, per-tree feature_fraction and the leaf-ordered row partition) or
under GOSS (with the compacted histogram buffer), on exact or quantized
gradients, with categorical features (given to
``Dataset(categorical_feature=...)``; the ``categorical_feature`` parameter
is ignored, as the JAX package ignores it outside streaming), with
Exclusive Feature Bundling as the JAX package does it (``enable_bundle``,
on by default, and ``max_conflict_rate``, lossy above 0 in both packages
alike), with monotone constraints by the basic and intermediate methods
(and ``monotone_penalty``), with the split search's options
(``feature_fraction_bynode``, ``extra_trees``, ``path_smooth``,
``feature_contri``, interaction constraints, CEGB's split, coupled and
lazy penalties, and forced splits from ``forcedsplits_filename``; lazy
CEGB with EFB bundles or a position-debiased objective is FATAL, and EFB
bundles ignore forced splits with a warning, as in the JAX package), on
dense, pandas (category columns included),
scipy sparse, text-file or binary-file input, with any ``max_bin`` and
``max_bin_by_feature`` up to 65,535 (a feature of more than 256 bins makes
the binned matrix uint16, which kernels A, B and B′ read as they read
uint8; more than 65,536 bins is FATAL by the feature's name when the
dataset is built), with bins assigned on the
host's native binner or on the device (``tpu_ingest_device``; a chunk's
rows follow from the width, so ``tpu_ingest_chunk_rows`` is not a knob),
every metric (ndcg@k and map@k included) and early stopping. Every other feature of the
JAX package is FATAL here with a message that names it, so an unported
parameter fails loudly instead of silently training something else.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional

from .utils import log

# objectives training one tree PER CLASS per iteration
# (Config.num_tree_per_iteration)
MULTI_TREE_OBJECTIVES = ("multiclass", "multiclassova")

# tpu_auto_quantize flips use_quantized_grad on for these objectives at
# this many rows or more (lightgbm_tpu/capabilities.py's policy)
AUTO_QUANTIZE_OBJECTIVES = ("binary", "regression", "multiclass",
                            "multiclassova", "cross_entropy")
AUTO_QUANT_MIN_ROWS = 500_000

# why tpu_hist_partition=auto stands down on the card: in the in-turns
# sweep of full-row training on an H100 (off, on, on, off; three calls)
# the partition won 2 of 6 pairs at 2M rows, 1 of 6 at 8M and none at 10M
# (PERF.md section 6), so it won every pair at no size
PARTITION_STAND_DOWN = ("measured slower than masked histograms on the "
                        "H100 at 2M, 8M and 10M rows, PERF.md section 6")

# metrics this package evaluates (canonical names; metric/__init__.py
# holds their aliases)
PORTED_METRICS = ("l1", "l2", "rmse", "quantile", "huber", "fair",
                  "poisson", "mape", "gamma", "gamma_deviance", "tweedie",
                  "binary_logloss", "binary_error", "auc",
                  "average_precision", "auc_mu", "multi_logloss",
                  "multi_error", "cross_entropy", "kullback_leibler",
                  "ndcg", "map")
# objectives of the JAX package this package does not train yet
UNPORTED_OBJECTIVES = ("custom",)

# JAX-package knobs (``tpu_*`` and friends in config._PARAMS) this package
# honours; any other one set to a non-default value is FATAL
PORTED_KNOBS = ("tpu_rows_per_block", "tpu_leaf_batch", "tpu_goss_compact",
                "tpu_auto_quantize", "tpu_hist_mode", "tpu_hist_partition",
                "tpu_ingest_threads", "tpu_ingest_device")


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
        "the custom objective",
        lambda c: str(c.objective) in UNPORTED_OBJECTIVES,
        {"objective": "custom"}),
    "boosting": Capability(
        "boosting=rf (random forest)",
        lambda c: c.boosting == "rf", {"boosting": "rf"}),
    "sample_strategy": Capability(
        "data_sample_strategy other than bagging/goss",
        lambda c: str(c.data_sample_strategy) not in ("bagging", "goss"),
        {"data_sample_strategy": "uniform"}),
    "tree_learner": Capability(
        "distributed tree learners (data, voting, feature)",
        lambda c: c.tree_learner != "serial", {"tree_learner": "data"}),
    "linear_tree": Capability(
        "linear_tree", lambda c: bool(c.linear_tree), {"linear_tree": True}),
    "monotone_advanced": Capability(
        "monotone_constraints_method=advanced",
        lambda c: (any(int(m) != 0 for m in (c.monotone_constraints or []))
                   and str(c.monotone_constraints_method).lower()
                   == "advanced"),
        {"monotone_constraints": [1, 0, 0, 0],
         "monotone_constraints_method": "advanced"}),
    "quant_renew": Capability(
        "quant_train_renew_leaf", lambda c: bool(c.quant_train_renew_leaf),
        {"use_quantized_grad": True, "quant_train_renew_leaf": True}),
    "hist_rebuild": Capability(
        "tpu_hist_mode=rebuild", lambda c: c.tpu_hist_mode != "pool",
        {"tpu_hist_mode": "rebuild"}),
    "snapshots": Capability(
        "snapshot_freq", lambda c: c.snapshot_freq > 0, {"snapshot_freq": 5}),
    "jax_knobs": Capability(
        "knobs of the JAX package this port does not honour",
        lambda c: bool(_unported_knobs(c)),
        {"tpu_double_precision_hist": True}),
}


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
