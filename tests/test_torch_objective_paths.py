"""End-to-end parity of the non-binary objectives on the leaf-ordered row
partition (``tpu_hist_partition=true``, the move B′, 5,000 rows). Same
data, settings and checks as ``test_torch_regression.py``; GOSS runs in
``test_torch_objective_goss.py``.
"""
import pytest

from test_torch_regression import SINGLE, check_parity
from test_torch_regression import _one_torch_thread  # noqa
from test_torch_train import _reference_metrics_off  # noqa


@pytest.mark.parametrize("case", SINGLE)
def test_partition_path_matches_reference(case):
    check_parity(case, "partition")
