"""The port's ``eval/metrics.py`` against the JAX package's on the CPU: the
tensor path and the numpy path against ``_metric_stack_jit`` and
``_metric_stack_np`` on seeded ``(N, 32, 27)`` stacks (1e-6), the flat key
sets of ``metrics_dict`` and ``format_families``, ``rhythmic_distances``,
and that host arrays never take the tensor path."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transformergrooveinfilling_tpu.eval import metrics as JM
from transformergrooveinfilling_tpu_torch.eval import metrics as M


def _stacks(rng, n):
    """A thresholded prediction and a GT stack: binary hits, velocities in
    [0, 1], offsets in [-0.5, 0.5]."""
    def one():
        h = (rng.random((n, 32, 9)) < 0.3).astype(np.float32)
        return np.concatenate([h, h * rng.random((n, 32, 9)),
                               h * (rng.random((n, 32, 9)) - 0.5)], -1).astype(np.float32)
    return one(), one()


@pytest.mark.parametrize("n", [1, 7, 64])
def test_metric_stacks_match_jax(rng, n):
    pred, gt = _stacks(rng, n)
    want = [np.asarray(a) for a in JM._metric_stack_jit(jnp.asarray(pred), jnp.asarray(gt))]
    want_np = JM._metric_stack_np(pred, gt)
    got_t = [a.numpy() for a in M._metric_stack_torch(torch.from_numpy(pred),
                                                      torch.from_numpy(gt))]
    got_np = M._metric_stack_np(pred, gt)
    for w, w_np, t, g in zip(want, want_np, got_t, got_np):
        assert t.shape == g.shape == (9,)
        np.testing.assert_allclose(t, w, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(g, w_np, rtol=1e-6, atol=1e-7)
        assert g.dtype == w_np.dtype
    # one public function per family, each the stack's row
    for fn, jfn, i in ((M.hits_accuracy_per_voice, JM.hits_accuracy_per_voice, 0),
                       (M.velocity_mse_per_voice, JM.velocity_mse_per_voice, 1),
                       (M.offset_mse_per_voice, JM.offset_mse_per_voice, 2)):
        np.testing.assert_allclose(fn(torch.from_numpy(pred), torch.from_numpy(gt)),
                                   jfn(pred, gt), rtol=1e-6, atol=1e-7)


def test_metrics_dict_and_families_match_jax(rng):
    pred, gt = _stacks(rng, 16)
    for args in ((pred, gt), (torch.from_numpy(pred), gt), (pred, torch.from_numpy(gt))):
        got, want = M.metrics_dict(*args, "Validation_Set"), JM.metrics_dict(pred, gt,
                                                                              "Validation_Set")
        assert list(got) == list(want) and len(got) == 30
        np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want],
                                   rtol=1e-6, atol=1e-7)
    acc, mse_v, mse_o = JM._metric_stack_np(pred, gt)
    names = ["v%d" % i for i in range(9)]
    assert M.format_families("X", acc, mse_v, mse_o, names) == \
        JM.format_families("X", acc, mse_v, mse_o, names)


def test_rhythmic_distances_match_jax(rng):
    pred, gt = _stacks(rng, 12)
    for ident in ("", "Test_Set"):
        assert M.rhythmic_distances(pred, gt, ident) == JM.rhythmic_distances(pred, gt, ident)


def test_host_arrays_never_take_the_tensor_path(rng, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the tensor path ran for host numpy arrays")

    pred, gt = _stacks(rng, 4)
    want = M.metrics_dict(torch.from_numpy(pred), torch.from_numpy(gt), "X")
    monkeypatch.setattr(M, "_metric_stack_torch", boom)
    got = M.metrics_dict(pred, gt, "X")
    assert got.keys() == want.keys()
    np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=1e-6)
    with pytest.raises(AssertionError, match="tensor path"):
        M.metrics_dict(torch.from_numpy(pred), gt, "X")
