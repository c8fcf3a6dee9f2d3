"""End-to-end parity of the multiclass objectives (softmax and
one-vs-all, 3 classes, so 3 trees an iteration): the port against the JAX
package on the masked path, the row partition and GOSS with the compacted
buffer. Same data sizes, settings and checks as
``test_torch_regression.py``; the stochastic-rounding draws are replayed
class by class (``fold_in(qkey, k)``). Early stopping, the reference's
model text and forest and a per-class ``init_score`` are in
``test_torch_multiclass_stopping.py``.
"""
import pytest

from test_torch_regression import PATHS, check_parity
from test_torch_regression import _one_torch_thread  # noqa
from test_torch_train import _reference_metrics_off  # noqa

MULTI = ("multiclass", "multiclassova")


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("case", MULTI)
def test_multiclass_matches_reference(case, path):
    ref, port = check_parity(case, path)
    assert len(port.engine.models) == 3 * port.current_iteration()
    assert port.engine.score.shape == (port.engine.data.n_pad, 3)
