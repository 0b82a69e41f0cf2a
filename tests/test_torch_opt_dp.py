"""The port's data-parallel training (training/opt.py `OptContext(mesh=)`,
training/finetune.py `mesh=`) against the JAX package's solo run on the
CPU.

Four ranks (parallel/launch.py, gloo, one thread each;
tests/torch_dist_ranks.py `opt_dp`): the JAX test_dp_mesh_matches_single_device
toy regression over 3 AdamW steps at dp 4 and at dp 2 (a 2 x 2 mesh),
losses and leaves within rtol 1e-5 of the JAX package's solo OptContext;
an eval on one-hot labels at dp 2 whose loss, accuracy, predictions and
datapoint count are the solo eval's (the rows' predictions gathered in
order); a batch whose rows do not split over the ranks raises; and one
`finetune` step of a 64-wide Whisper (2 + 2 layers) at dp 2, its loss
within rtol 1e-5 of the JAX solo step's and its parameters within the
AdamW bound of tests/test_torch_finetune.py (`_adam_close`).
"""

import numpy as np
import pytest

import whisper_tpu.training.finetune as JF
from test_opt import _init_linear, _linear_fn, _toy_regression
from test_torch_finetune import HP, _adam_close, _leaves, _samples
from whisper_tpu.models.whisper.load import load_model as j_load_model
from whisper_tpu.training.opt import (LOSS_CROSS_ENTROPY, LOSS_MEAN_SQUARED_ERROR,
                                      OptContext, Result)
from whisper_tpu_torch.parallel.launch import launch
from whisper_tpu_torch.utils.synth import write_synth_model


@pytest.fixture(scope="module")
def data():
    x, y = _toy_regression(n=64)
    labels = np.eye(2, dtype=np.float32)[(x[:, 0] > 0).astype(int)]
    return x, y, labels


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("ft-dp") / "m-f16.bin"
    write_synth_model(str(path), HP, seed=4, qtype="f16")
    return str(path)


@pytest.fixture(scope="module")
def ranks(data, model_path):
    x, y, labels = data
    samples = _samples(j_load_model(model_path))
    return launch("tests/torch_dist_ranks.py:opt_dp", 4,
                  (x, y, _init_linear(), labels, model_path, samples), threads=1)


@pytest.mark.parametrize("dp", ["dp4", "dp2"])
def test_dp_matches_jax_solo(ranks, data, dp):
    x, y, _ = data
    solo = OptContext(_linear_fn, _init_linear(), loss_type=LOSS_MEAN_SQUARED_ERROR,
                      optimizer="adamw")
    losses = [solo.step(x, y) for _ in range(3)]
    for r in ranks:
        assert r["foreign"] == []
        got = r[dp]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        for k in ("w", "b"):
            np.testing.assert_allclose(got[f".{k}"], np.asarray(solo.params[k]), rtol=1e-5)


def test_dp_eval_gathers_the_batch(ranks, data):
    x, _, labels = data
    solo = OptContext(_linear_fn, _init_linear(), loss_type=LOSS_CROSS_ENTROPY)
    res = Result()
    loss = solo.eval(x, labels, res)
    for r in ranks:
        got = r["eval"]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        assert got["ndata"] == res.ndata == 64
        np.testing.assert_array_equal(got["pred"], res.pred())
        np.testing.assert_allclose(got["accuracy"], res.accuracy(), rtol=1e-6)


def test_uneven_batch_raises(ranks):
    for r in ranks:
        assert "5 rows does not split evenly over the 2" in r["uneven"]


def test_finetune_step_dp2_matches_jax_solo(ranks, model_path):
    wm = j_load_model(model_path)
    pj, lj = JF.finetune(wm, _samples(wm), steps=1, batch_size=2, lr=1e-3,
                         optimizer="adamw")
    tj = _leaves(pj)
    for r in ranks:
        got = r["finetune"]
        np.testing.assert_allclose(got["losses"], lj, rtol=1e-5)
        for k in tj:
            if k.startswith(".enc"):
                np.testing.assert_array_equal(got[k], np.asarray(_leaves(wm.params)[k],
                                                                  np.float32))
            else:
                _adam_close(got[k], tj[k], 1e-3, 1, k)
