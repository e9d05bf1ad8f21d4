"""Drift, outlier and accumulator ops of the port against the JAX package.

Inputs are made from a numpy seed and go through both packages.
Tolerances: integer counts and the K-S statistic are exact (integer
comparisons, one correctly rounded f32 division each); the chi-squared
statistic sums in another order (rtol 1e-6); p-values atol 1e-5;
accumulator counters exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlops_tpu.monitor import state as jstate
from mlops_tpu.ops import drift as jdrift
from mlops_tpu.ops import outlier as joutlier
from mlops_tpu_torch.monitor import state as tstate
from mlops_tpu_torch.ops import drift as tdrift
from mlops_tpu_torch.ops import outlier as toutlier

P_ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _counts(rng, c=9, k=12, total=500):
    ref = rng.integers(0, total, size=(c, k)).astype(np.float32)
    batch = rng.integers(0, 20, size=(c, k)).astype(np.float32)
    ref[:, -3:] = 0.0  # narrow-cardinality padding columns
    batch[:, -3:] = 0.0
    batch[2, 4] = 7.0  # a category the reference never saw
    ref[2, 4] = 0.0
    return ref, batch


def test_chi2_two_sample_matches_reference():
    rng = np.random.default_rng(0)
    ref, batch = _counts(rng)
    j_stat, j_p = jax.vmap(jdrift.chi2_two_sample)(ref, batch)
    t_stat, t_p = tdrift.chi2_two_sample(_t(ref), _t(batch))
    np.testing.assert_allclose(t_stat.numpy(), np.asarray(j_stat), rtol=1e-6)
    np.testing.assert_allclose(t_p.numpy(), np.asarray(j_p), atol=P_ATOL)


def test_chi2_of_an_empty_batch_is_nan_in_both():
    rng = np.random.default_rng(1)
    ref, _ = _counts(rng)
    empty = np.zeros_like(ref)
    _, j_p = jax.vmap(jdrift.chi2_two_sample)(ref, empty)
    _, t_p = tdrift.chi2_two_sample(_t(ref), _t(empty))
    assert np.isnan(np.asarray(j_p)).all() and torch.isnan(t_p).all()


@pytest.mark.parametrize("branch", ["small", "large"])
def test_kolmogorov_sf_both_branches(branch):
    rng = np.random.default_rng(2)
    t = (
        rng.uniform(0.05, 0.999, size=64) if branch == "small"
        else rng.uniform(1.0, 3.0, size=64)
    ).astype(np.float32)
    want = np.asarray(jax.vmap(jdrift._kolmogorov_sf)(t))
    got = tdrift._kolmogorov_sf(_t(t)).numpy()
    np.testing.assert_allclose(got, want, atol=P_ATOL, rtol=0)


def _ks_case(rng, case):
    r, b = 256, 16
    ref = np.sort(rng.normal(size=r).astype(np.float32))
    ref[10:20] = ref[10]  # ties inside the reference
    ref = np.sort(ref)
    cdf = (np.searchsorted(ref, ref, side="right") / r).astype(np.float32)
    batch = rng.normal(size=b).astype(np.float32)
    mask = np.ones(b, bool)
    if case == "ties":
        batch[:4] = ref[10]  # batch values equal to tied reference points
        batch[4:6] = batch[6]  # ties inside the batch
        mask[-3:] = False
    elif case == "one_row":
        mask[:] = False
        mask[5] = True
    elif case == "all_padding":
        mask[:] = False
    return ref, cdf, batch, mask


@pytest.mark.parametrize("case", ["ties", "one_row", "all_padding", "full"])
def test_ks_small_masked_statistic_is_exact(case):
    rng = np.random.default_rng(3)
    ref, cdf, batch, mask = _ks_case(rng, case)
    want = np.asarray(
        jdrift.ks_small_masked_statistic(ref, cdf, batch, jnp.asarray(mask))
    )
    got = tdrift.ks_small_masked_statistic(_t(ref), _t(cdf), _t(batch), _t(mask))
    assert got.numpy() == want
    if case == "all_padding":
        assert want == 0.0


def test_ks_statistic_over_feature_and_slot_dimensions():
    """The port's leading dimensions stand in for the reference's vmap."""
    rng = np.random.default_rng(4)
    m, r, s, b = 3, 128, 4, 8
    ref = np.sort(rng.normal(size=(m, r)).astype(np.float32), axis=1)
    cdf = np.stack(
        [np.searchsorted(x, x, side="right") / r for x in ref]
    ).astype(np.float32)
    batch = rng.normal(size=(s, m, b)).astype(np.float32)
    mask = rng.random((s, b)) < 0.6
    mask[-1] = False
    got = tdrift.ks_small_masked_statistic(
        _t(ref)[None], _t(cdf)[None], _t(batch), _t(mask)[:, None, :]
    ).numpy()
    for i in range(s):
        for j in range(m):
            want = np.asarray(jdrift.ks_small_masked_statistic(
                ref[j], cdf[j], batch[i, j], jnp.asarray(mask[i])
            ))
            assert got[i, j] == want


def test_mahalanobis_sq_and_fit_match():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(300, 14)).astype(np.float32)
    j_fit = joutlier.fit_mahalanobis(x)
    t_fit = toutlier.fit_mahalanobis(x)
    for a, b in zip(j_fit[:2], t_fit[:2]):
        np.testing.assert_array_equal(a, b)
    assert j_fit[2] == t_fit[2]
    mean, prec, _ = j_fit
    want = np.asarray(joutlier.mahalanobis_sq(x[:32], mean, prec))
    got = toutlier.mahalanobis_sq(_t(x[:32]), _t(mean), _t(prec)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _acc_arrays(acc):
    return {
        k: np.asarray(getattr(acc, k))
        for k in ("rows", "outliers", "batches", "drift_sum", "drift_last")
    }


def _torch_acc(arrays):
    return tstate.MonitorAccumulator(**{k: _t(v) for k, v in arrays.items()})


def _assert_acc_equal(j_acc, t_acc):
    want, got = _acc_arrays(j_acc), _acc_arrays(t_acc)
    for key in ("rows", "outliers", "batches"):
        assert got[key] == want[key], key
    for key in ("drift_sum", "drift_last"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-6, err_msg=key)
        assert np.isfinite(got[key]).all(), key


@pytest.mark.parametrize("empty", [False, True])
def test_fold_accumulator_matches_and_ignores_empty_batches(empty):
    rng = np.random.default_rng(6)
    d = 23
    start = {
        "rows": np.float32(10), "outliers": np.float32(2),
        "batches": np.float32(3),
        "drift_sum": rng.random(d).astype(np.float32),
        "drift_last": rng.random(d).astype(np.float32),
    }
    mask = np.zeros(8, bool) if empty else np.arange(8) < 5
    flags = (rng.random(8) < 0.3).astype(np.float32) * mask
    drift = np.full(d, np.nan, np.float32) if empty else rng.random(d).astype(
        np.float32
    )
    j_acc = jstate.fold_accumulator(
        jstate.MonitorAccumulator(**start), flags, drift, mask
    )
    t_acc = tstate.fold_accumulator(
        _torch_acc(start), _t(flags), _t(drift), _t(mask)
    )
    _assert_acc_equal(j_acc, t_acc)


def test_fold_accumulator_grouped_nan_poison_padding_slots():
    rng = np.random.default_rng(7)
    s, r, d = 8, 4, 23
    mask = rng.random((s, r)) < 0.7
    mask[:, 0] = True
    mask[-2:] = False  # padding slots
    flags = (rng.random((s, r)) < 0.2).astype(np.float32) * mask
    drift = rng.random((s, d)).astype(np.float32)
    drift[-2:] = np.nan  # chi-squared over zero rows
    start = _acc_arrays(jstate.init_accumulator())
    j_acc = jstate.fold_accumulator_grouped(
        jstate.init_accumulator(), flags, drift, mask
    )
    t_acc = tstate.fold_accumulator_grouped(
        _torch_acc(start), _t(flags), _t(drift), _t(mask)
    )
    _assert_acc_equal(j_acc, t_acc)
    assert float(t_acc.batches) == s - 2
