"""The port's ggml-opt analogue (whisper_tpu_torch/training/opt.py, torch
autograd) against the JAX package's (whisper_tpu/training/opt.py), on the
CPU.

One model function serves both (`x @ w + b` reads jax arrays and torch
tensors alike), with the same seeded numpy inputs and initial parameters.
Losses agree within rtol 1e-5 and parameters after N steps within rtol
1e-5 / atol 1e-6 (f32 forward and backward sums in another order, carried
through the steps); Dataset shuffle orders, Result statistics and eval
predictions exactly.  The frozen-parameter case runs with wd > 0: in both
packages a frozen parameter's gradient is zeroed but the update still
applies, so it decays by 1 - alpha*wd each step, exactly.
"""

import numpy as np
import pytest
import torch

import whisper_tpu.training.opt as JO
import whisper_tpu_torch.training.opt as TO


def linear(params, x):
    return x @ params["w"] + params["b"]


def _regression(n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = (x @ rng.normal(size=(4, 2)).astype(np.float32) + 0.5).astype(np.float32)
    return x, y


def _init(seed=1):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 2)).astype(np.float32) * 0.1,
            "b": np.full((2,), 0.3, np.float32)}


def _np(a):
    return a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)


CASES = {
    # name: (OptContext kwargs, steps, microbatches per step)
    "adamw": (dict(optimizer="adamw", loss_type=JO.LOSS_MEAN_SQUARED_ERROR,
                   get_opt_pars=lambda i: JO.OptimizerParams(alpha=0.05, wd=0.01)), 6, 1),
    "sgd": (dict(optimizer="sgd", loss_type=JO.LOSS_MEAN_SQUARED_ERROR,
                 get_opt_pars=lambda i: JO.OptimizerParams(alpha=0.05, wd=0.1)), 6, 1),
    "opt_period_2": (dict(optimizer="adamw", loss_type=JO.LOSS_MEAN, opt_period=2,
                          get_opt_pars=lambda i: JO.OptimizerParams(alpha=0.02 * i)), 4, 2),
    "frozen_b_wd": (dict(optimizer="adamw", loss_type=JO.LOSS_MEAN_SQUARED_ERROR,
                         trainable=lambda path: "b" not in path,
                         get_opt_pars=lambda i: JO.OptimizerParams(alpha=0.05, wd=0.2)), 5, 1),
    "frozen_b_wd_sgd": (dict(optimizer="sgd", loss_type=JO.LOSS_SUM,
                             trainable=lambda path: "['b']" not in path,
                             get_opt_pars=lambda i: JO.OptimizerParams(alpha=0.01, wd=0.3)),
                        5, 1),
}


@pytest.mark.parametrize("name", list(CASES))
def test_steps_match_jax(name):
    kw, steps, micro = CASES[name]
    x, y = _regression()
    tkw = dict(kw, get_opt_pars=lambda i, f=kw["get_opt_pars"]: TO.OptimizerParams(
        **vars(f(i))))
    j = JO.OptContext(linear, _init(), **kw)
    t = TO.OptContext(linear, _init(), device="cpu", **tkw)
    n = len(x) // micro
    for _ in range(steps):
        for k in range(micro):
            xs, ys = x[k * n:(k + 1) * n], y[k * n:(k + 1) * n]
            lj, lt = j.step(xs, ys), t.step(xs, ys)
            np.testing.assert_allclose(lt, lj, rtol=1e-5)
    assert t.iter == j.iter == steps + 1 and t.opt_i == j.opt_i == 0
    for k in ("w", "b"):
        np.testing.assert_allclose(_np(t.params[k]), _np(j.params[k]), rtol=1e-5, atol=1e-6)
    if "frozen" in name:
        p = kw["get_opt_pars"](1)
        want = _init()["b"] * np.float32(1 - np.float32(p.alpha) * np.float32(p.wd)) ** steps
        for ctx in (j, t):     # zero gradient, decayed every step
            np.testing.assert_allclose(_np(ctx.params["b"]), want, rtol=1e-6)
        assert not np.allclose(_np(t.params["b"]), _init()["b"])


def test_classification_eval_and_result_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    labels = np.eye(2, dtype=np.float32)[(x[:, 0] + x[:, 1] > 0).astype(np.int32)]
    kw = dict(loss_type=JO.LOSS_CROSS_ENTROPY, optimizer="adamw")
    j = JO.OptContext(linear, _init(), get_opt_pars=lambda i: JO.OptimizerParams(alpha=0.05),
                      **kw)
    t = TO.OptContext(linear, _init(), get_opt_pars=lambda i: TO.OptimizerParams(alpha=0.05),
                      device="cpu", **kw)
    rj, rt = JO.Result(), TO.Result()
    for _ in range(20):
        np.testing.assert_allclose(t.step(x, labels, rt), j.step(x, labels, rj), rtol=1e-5)
    ej, et = JO.Result(), TO.Result()
    np.testing.assert_allclose(t.eval(x, labels, et), j.eval(x, labels, ej), rtol=1e-5)
    np.testing.assert_array_equal(et.pred(), ej.pred())
    assert et.accuracy() == ej.accuracy() and et.accuracy()[0] > 0.8
    for a, b in ((rt, rj), (et, ej)):
        np.testing.assert_allclose(a.loss(), b.loss(), rtol=1e-5)
        assert (a.ndata, a.ncorrect) == (b.ndata, b.ncorrect)


def test_dataset_shuffle_orders_match_jax():
    data = np.arange(24, dtype=np.float32).reshape(24, 1)
    for shard, idata in ((1, -1), (2, -1), (3, 12), (1, 8)):
        dj = JO.Dataset(data, labels=data * 2, ndata_shard=shard)
        dt = TO.Dataset(data, labels=data * 2, ndata_shard=shard)
        rj, rt = np.random.default_rng(7), np.random.default_rng(7)
        for _ in range(3):
            dj.shuffle(rj, idata)
            dt.shuffle(rt, idata)
            for ib in range(4):
                for a, b in zip(dt.get_batch(ib, 6), dj.get_batch(ib, 6)):
                    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        TO.Dataset(data, ndata_shard=5)


def test_result_statistics_match_jax():
    for per_dp, period in ((True, 1), (False, 1), (True, 2)):
        rj, rt = JO.Result(), TO.Result()
        for i, l in enumerate([1.0, 2.0, 4.0, 3.5]):
            pred = np.array([i % 2, 1], np.int32)
            rj._accumulate(l, 4, i, pred, per_dp, period)
            rt._accumulate(l, 4, i, pred, per_dp, period)
        assert rt.loss() == rj.loss() and rt.accuracy() == rj.accuracy()
        np.testing.assert_array_equal(rt.pred(), rj.pred())
    assert np.isnan(TO.Result().loss()[1]) and TO.Result().loss()[0] == 0.0


def test_fit_matches_jax():
    x, y = _regression(n=48)
    out = []
    for mod, kw in ((JO, {}), (TO, {"device": "cpu"})):
        out.append(mod.fit(linear, _init(), mod.Dataset(x, y),
                           loss_type=mod.LOSS_MEAN_SQUARED_ERROR, optimizer="adamw",
                           get_opt_pars=lambda i, m=mod: m.OptimizerParams(alpha=0.05),
                           nepoch=4, nbatch_logical=8, nbatch_physical=4,
                           val_split=0.25, seed=3, silent=True, **kw))
    for k in ("w", "b"):
        np.testing.assert_allclose(_np(out[1][k]), _np(out[0][k]), rtol=1e-5, atol=1e-6)


def test_defaults_and_mesh():
    assert vars(TO.default_optimizer_params()) == vars(JO.default_optimizer_params())
    with pytest.raises(NotImplementedError, match="item 12"):
        TO.OptContext(linear, _init(), mesh=object(), device="cpu")
    with pytest.raises(ValueError):
        TO.OptContext(linear, _init(), loss_type="hinge", device="cpu")
    # paths are spelled as jax.tree_util.keystr spells them
    assert [p for p, _ in TO._flatten({"b": 1, "a": [2, {"c": 3}]})] == [
        "['a'][0]", "['a'][1]['c']", "['b']"]
