"""The port's capability table: which features this package trains.

``lightgbm_tpu/capabilities.py`` gates features per boosting engine; this
package has one engine so far -- gradient boosting with the serial learner
and pool-mode histograms for every built-in objective (K trees an
iteration for multiclass; lambdarank, with truncation, norm and position
debiasing, and rank_xendcg on query groups from ``Dataset(group=...)``),
trained on full rows (with bagging, per-tree feature_fraction and the
leaf-ordered row partition) or under GOSS (with the compacted histogram
buffer), on exact or quantized gradients, with categorical features
(given to ``Dataset(categorical_feature=...)``; the
``categorical_feature`` parameter is ignored, as the JAX package ignores
it outside streaming), every metric (ndcg@k and map@k included) and early
stopping. Every other feature of the JAX package is FATAL here with a
message that names it, so an unported parameter fails loudly instead of
silently training something else.
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
        "the custom objective",
        lambda c: str(c.objective) in UNPORTED_OBJECTIVES,
        {"objective": "custom"}),
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
