"""Boosting engines."""
from .gbdt import GBDT


def create_boosting(config, train_set, noise=None) -> GBDT:
    """The engine ``config.boosting`` names (reference:
    ``lightgbm_tpu/boosting/__init__.py::create_boosting``): DART or
    GBDT. ``capabilities.check`` refuses rf first."""
    if config.boosting == "dart":
        from .dart import DART
        return DART(config, train_set, noise=noise)
    return GBDT(config, train_set, noise=noise)


__all__ = ["GBDT", "create_boosting"]
