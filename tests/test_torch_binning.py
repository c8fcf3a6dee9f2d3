"""Port parity: host binning, datasets and model text.

The same seeded numpy data goes through ``lightgbm_tpu`` (the JAX
reference) and ``lightgbm_tpu_torch``; bin mappers, binned bytes and the
padded device matrices must be equal, and model text written for the same
trees byte-equal.
"""
import jax  # noqa: F401  (the JAX package runs on the CPU, see conftest)
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.boosting.gbdt import _DeviceData
from lightgbm_tpu_torch.boosting.gbdt import DeviceData
from lightgbm_tpu_torch.convert import device_data_from_jax
from lightgbm_tpu_torch.io.model_text import load_model_string


@pytest.fixture(autouse=True, scope="module")
def _reference_metrics_off():
    """Keep this module's runs of the JAX package out of that package's
    process-global metrics registry, which other test files read."""
    from lightgbm_tpu import obs
    was = obs.enabled()
    obs.disable()
    yield
    if was:
        obs.enable()


def _data(n=6000, F=9, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F))
    X[:, 1] = np.round(X[:, 1] * 3)              # few distinct values
    X[rng.random(n) < 0.1, 2] = np.nan            # NaN bin
    X[:, 3] = 0.0                                 # constant: dropped
    X[rng.random(n) < 0.4, 4] = 0.0               # heavy zero bin
    X[:, 5] = rng.exponential(size=n) * 1e4       # wide range
    y = (X[:, 0] + rng.normal(size=n) > 0).astype(np.float64)
    return X, y


def _mapper_fields(m):
    return (m.bin_type, m.num_bin, m.missing_type, m.default_bin,
            m.most_freq_bin, m.min_value, m.max_value,
            None if m.bin_upper_bound is None
            else np.asarray(m.bin_upper_bound).tobytes())


@pytest.mark.parametrize("max_bin", [255, 63])
def test_bin_mappers_and_bytes_equal(max_bin):
    X, y = _data()
    params = {"max_bin": max_bin}
    ref = lgb.Dataset(X, label=y, params=params).construct()
    port = lgt.Dataset(X, label=y, params=params).construct()
    assert port.used_features == ref.used_features
    assert len(port.bin_mappers) == len(ref.bin_mappers)
    for a, b in zip(port.bin_mappers, ref.bin_mappers):
        assert _mapper_fields(a) == _mapper_fields(b)
    assert port.binned.dtype == np.uint8
    np.testing.assert_array_equal(port.binned, ref.binned)
    np.testing.assert_array_equal(port.feature_num_bins(),
                                  ref.feature_num_bins())


def test_valid_set_reuses_mappers_and_bins_equal():
    X, y = _data()
    Xv, yv = _data(n=1500, seed=1)
    ref = lgb.Dataset(X, label=y).create_valid(Xv, label=yv).construct()
    port = lgt.Dataset(X, label=y).create_valid(Xv, label=yv).construct()
    np.testing.assert_array_equal(port.binned, ref.binned)


def test_device_data_padding_equals_reference():
    """Padded row-major and feature-major matrices, label and validity
    mask are the reference's (its int8 feature-major copy viewed as
    uint8)."""
    X, y = _data(n=5000)
    ref = _DeviceData(lgb.Dataset(X, label=y).construct(), 1024,
                      transposed=True)
    port = DeviceData.from_dataset(lgt.Dataset(X, label=y), 1024,
                                   torch.device("cpu"), transposed=True)
    assert port.n_pad == ref.n_pad == 5120
    np.testing.assert_array_equal(port.bins.numpy(), np.asarray(ref.bins))
    np.testing.assert_array_equal(
        port.bins_t.numpy(), np.asarray(ref.bins_t).view(np.uint8))
    np.testing.assert_array_equal(port.label.numpy(), np.asarray(ref.label))
    np.testing.assert_array_equal(port.valid_mask.numpy(),
                                  np.asarray(ref.valid_mask))
    conv = device_data_from_jax(np.asarray(ref.bins), np.asarray(ref.bins_t),
                                np.asarray(ref.label), ref.n)
    np.testing.assert_array_equal(conv.bins_t.numpy(), port.bins_t.numpy())
    np.testing.assert_array_equal(conv.valid_mask.numpy(),
                                  port.valid_mask.numpy())


def test_model_text_byte_equal_for_same_trees():
    """A JAX-trained model's text re-serialized by the port's copy of
    model_text is byte-equal, and both packages predict it alike."""
    X, y = _data(n=4000)
    bst = lgb.train({"objective": "binary", "num_leaves": 15,
                     "verbosity": -1}, lgb.Dataset(X, label=y),
                    num_boost_round=3)
    text = bst.model_to_string()
    from lightgbm_tpu_torch.io.model_text import HostModel, save_model_string
    assert save_model_string(HostModel.from_engine(bst.engine,
                                                   bst.config)) == text
    loaded = load_model_string(text)
    assert [t.num_leaves for t in loaded.trees] == \
        [t.num_leaves for t in bst.engine.models]
    port = lgt.Booster(model_str=text)
    ref = lgb.Booster(model_str=text)
    np.testing.assert_allclose(port.predict(X[:500]), ref.predict(X[:500]),
                               rtol=0, atol=1e-12)
