"""End-to-end parity of the non-binary objectives under GOSS (16,000 rows,
top rate 0.1, other rate 0.05, from iteration 3): with the compacted
histogram buffer (kernel B) where the reference compacts, which it does not
for the renewing objectives L1, quantile and MAPE (they keep the masked
GOSS path). Same data, settings and checks as ``test_torch_regression.py``.
"""
import pytest

from test_torch_regression import SINGLE, check_parity
from test_torch_regression import _one_torch_thread  # noqa
from test_torch_train import _reference_metrics_off  # noqa


@pytest.mark.parametrize("case", SINGLE)
def test_goss_path_matches_reference(case):
    ref, port = check_parity(case, "goss")
    renews = case in ("regression_l1", "quantile", "mape")
    assert port.engine.use_goss_compact == (not renews)
