"""The port's whisper fine-tuning (whisper_tpu_torch/training/finetune.py,
cli/finetune.py) against the JAX package's, on the CPU, on a 64-wide model
with 2 encoder and 2 decoder layers written from a seed (f16 file, f32
compute), seeded mels and token rows.

- teacher_forced_logits: within 1e-4 of max |logit| (f32 products summed
  in another order).
- gradients of the masked CE loss, decoder leaves (the fused qkv weight
  holds K and V, whose gradient flows through decode_step's in-place cache
  writes) and, with the encoder trained, encoder leaves: within 1e-4 of
  each leaf's max |grad|.
- 3 `finetune` steps (encoder frozen), SGD and AdamW: losses within rtol
  1e-5; the frozen encoder bit-equal to the file's (wd 0); the decoder's
  parameters after SGD within 1e-7 (f32 noise of alpha * g); after AdamW
  (`_adam_close`) all but 1% of each leaf's elements within 1e-6, and every
  element within 0.1 * alpha * steps.  AdamW's step is alpha * m/(sqrt(v)
  + eps): where |g| is within a few eps (1e-8) of 0, the f32 noise of g
  (~1e-9 on gradients of max ~1e-1) moves m/(sqrt(v) + eps) by up to ~0.1,
  so such an element may move up to 0.1 * alpha a step apart.  The key
  bias (the middle third of qkv_b) is left out: softmax is invariant to it,
  its gradient is f32 noise alone, and the file format does not store it
  (pytree_to_tensors drops it).
- pytree_to_tensors: the port's tensors equal the JAX package's for the
  same parameters; a save_finetuned file loads equal in both packages, and
  equal to the saved tensors at the file's rounding (f16 where the
  converter's storage rule says so).
- the CLI with -ng on a seeded wav/txt pair writes the file the JAX CLI
  writes, within the `_adam_close` bound; it is the JAX file with -ng.
- on the card: tests/test_torch_gpu.py (3 steps' losses within rtol 1e-4 of
  the CPU's).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu.training.finetune as JF
from whisper_tpu.models.whisper.load import load_model as j_load_model
from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
from whisper_tpu_torch.models.whisper.load import load_model
from whisper_tpu_torch.training import finetune as TF
from whisper_tpu_torch.utils.synth import write_synth_model

REPO = Path(__file__).resolve().parents[1]
HP = WhisperHParams(n_vocab=51865, n_audio_ctx=32, n_audio_state=64, n_audio_head=2,
                    n_audio_layer=2, n_text_ctx=64, n_text_state=64, n_text_head=2,
                    n_text_layer=2, n_mels=80)


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("ft") / "m-f16.bin"
    write_synth_model(str(path), HP, seed=4, qtype="f16")
    return str(path)


@pytest.fixture(scope="module")
def wm(model_path):
    return load_model(model_path)


def _samples(wm, n=2, seed=0):
    rng = np.random.default_rng(seed)
    v = wm.vocab
    out = []
    for i in range(n):
        mel = (rng.normal(size=(HP.n_mels, 2 * HP.n_audio_ctx)) * 0.1).astype(np.float32)
        body = rng.integers(100, 1000, size=8 + 3 * i).astype(np.int32)
        out.append((mel, np.concatenate([[v.token_sot], body, [v.token_eot]]).astype(np.int32)))
    return out


def _batch(wm, n=2):
    s = _samples(wm, n)
    return JF._DictBatcher.collate(s, max(len(t) for _, t in s))


def _j_params(wm):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), wm.params)


def _t_params(wm, grad=True):
    return TF._map(lambda a: torch.tensor(np.asarray(a, np.float32), requires_grad=grad),
                   wm.params)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in tree for k2, v2 in _leaves(tree[k], f"{prefix}.{k}").items()}
    return {prefix: tree}


def _adam_close(got, want, alpha, steps, what):
    """All but 1% of the elements within 1e-6, all within 0.1*alpha*steps
    (see the module's docstring)."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    err = np.abs(got - np.asarray(want))
    if what.endswith("qkv_b"):              # the key bias: see the docstring
        n = HP.n_text_state if what.startswith(".dec") else HP.n_audio_state
        err = np.concatenate([err[..., :n], err[..., 2 * n:]], -1)
    assert err.max() <= 0.1 * alpha * steps, (what, float(err.max()))
    assert np.mean(err > 1e-6) <= 1e-2, (what, float(np.mean(err > 1e-6)))


def _close(got, want, rel, what):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    bound = rel * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bound, (what, err, bound)


def test_teacher_forced_logits_match_jax(wm):
    b = _batch(wm)
    inp = np.maximum(b["tokens"][:, :-1], 0)
    want = JF.teacher_forced_logits(_j_params(wm), jnp.asarray(b["mel"]), jnp.asarray(inp), HP)
    with torch.no_grad():
        got = TF.teacher_forced_logits(_t_params(wm, False), torch.from_numpy(b["mel"]),
                                       torch.from_numpy(inp).long(), HP)
    _close(got, want, 1e-4, "logits")


@pytest.mark.parametrize("freeze_encoder", [True, False], ids=["decoder", "encoder_too"])
def test_gradients_match_jax(wm, freeze_encoder):
    b = _batch(wm)
    toks = b["tokens"]
    inp, labels = np.maximum(toks[:, :-1], 0), toks[:, 1:]

    def jloss(p):
        return JF.masked_ce_loss(JF.teacher_forced_logits(
            p, jnp.asarray(b["mel"]), jnp.asarray(inp), HP), jnp.asarray(labels))

    gj = _leaves(jax.grad(jloss)(_j_params(wm)))
    tp = _t_params(wm)
    loss = TF.masked_ce_loss(TF.teacher_forced_logits(
        tp, torch.from_numpy(b["mel"]), torch.from_numpy(inp).long(), HP,
        freeze_encoder=freeze_encoder), torch.from_numpy(labels).long())
    np.testing.assert_allclose(float(loss.detach()), float(jloss(_j_params(wm))), rtol=1e-5)
    loss.backward()
    gt = {k: v.grad for k, v in _leaves(tp).items()}
    for k, g in gt.items():
        if k.startswith(".enc") and freeze_encoder:
            assert g is None, k         # the encoder ran without a graph
            continue
        assert g is not None, k
        _close(g, gj[k], 1e-4, k)
    # K and V weights (qkv_w's last 2/3 of columns) did take a gradient
    n = HP.n_text_state
    assert float(gt[".dec.blocks.qkv_w"][:, :, n:].abs().max()) > 0


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_finetune_steps_match_jax(wm, optimizer):
    samples = _samples(wm)
    pj, lj = JF.finetune(wm, samples, steps=3, batch_size=2, lr=1e-3, optimizer=optimizer)
    pt, lt = TF.finetune(wm, samples, steps=3, batch_size=2, lr=1e-3, optimizer=optimizer,
                         device="cpu")
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    assert lt[-1] < lt[0]
    tj, tt = _leaves(pj), _leaves(pt)
    for k in tj:
        if k.startswith(".enc"):
            np.testing.assert_array_equal(tt[k].detach().numpy(),
                                          np.asarray(_leaves(wm.params)[k], np.float32))
        elif optimizer == "sgd":
            np.testing.assert_allclose(tt[k].detach().numpy(), np.asarray(tj[k]),
                                       rtol=0, atol=1e-7, err_msg=k)
        else:
            _adam_close(tt[k], tj[k], 1e-3, 3, k)
    if optimizer == "sgd":
        return
    # one step with the encoder trained too
    b = _batch(wm)
    cj = JF.make_finetune_context(wm, freeze_encoder=False)
    ct = TF.make_finetune_context(wm, freeze_encoder=False, device="cpu")
    np.testing.assert_allclose(ct.step(b), cj.step(b), rtol=1e-5)
    ej, et = _leaves(cj.params), _leaves(ct.params)
    for k in ej:
        _adam_close(et[k], ej[k], 1e-3, 1, k)
    for k in (".enc.blocks.mlp0_w", ".enc.conv1_w", ".dec.blocks.xk_w"):
        assert not np.array_equal(et[k].detach().numpy(),
                                  np.asarray(_leaves(wm.params)[k], np.float32))


def test_pytree_to_tensors_and_save_match_jax(wm, tmp_path):
    tt = TF.pytree_to_tensors(_t_params(wm, False), HP)
    tj = JF.pytree_to_tensors(wm.params, HP)
    assert tt.keys() == tj.keys()
    for k in tj:
        np.testing.assert_array_equal(tt[k], tj[k], err_msg=k)
    from whisper_tpu_torch.formats.quants import GGML_TYPE_F16
    from whisper_tpu_torch.models.whisper.writer import tensor_storage_type

    params = TF._map(lambda a: torch.tensor(np.asarray(a, np.float32) * 1.5), wm.params)
    saved = TF.pytree_to_tensors(params, HP)
    for use_f16 in (False, True):
        out = tmp_path / f"saved-{use_f16}.bin"
        TF.save_finetuned(str(out), wm, params, use_f16=use_f16)
        back_t, back_j = load_model(str(out)), j_load_model(str(out))
        lt, lj = _leaves(back_t.params), _leaves(back_j.params)
        assert lt.keys() == lj.keys() == _leaves(params).keys()
        for k in lt:
            np.testing.assert_array_equal(lt[k], lj[k], err_msg=k)
        got = TF.pytree_to_tensors(back_t.params, HP)
        assert got.keys() == saved.keys()
        for name, a in saved.items():
            if tensor_storage_type(name, a.ndim, use_f16) == GGML_TYPE_F16:
                a = a.astype(np.float16).astype(np.float32)
            np.testing.assert_array_equal(got[name], a, err_msg=name)
        assert back_t.vocab.id_to_token == back_j.vocab.id_to_token


def test_cli_matches_jax(model_path, tmp_path, capsys):
    from whisper_tpu.cli import finetune as JCLI
    from whisper_tpu_torch.audio.io import write_wav
    from whisper_tpu_torch.cli import finetune as TCLI

    pcm = (0.1 * np.random.default_rng(2).standard_normal(16000 * 2)).astype(np.float32)
    write_wav(str(tmp_path / "clip.wav"), pcm)
    (tmp_path / "clip.txt").write_text("ask not what your country can do")
    common = ["--steps", "2", "--lr", "1e-3", "--f32", str(tmp_path / "clip.wav")]
    assert JCLI.main(["-m", model_path, "-o", str(tmp_path / "j.bin"), *common]) == 0
    assert TCLI.main(["-m", model_path, "-o", str(tmp_path / "t.bin"), "-ng", *common]) == 0
    err = capsys.readouterr().err
    assert "step 2/2: loss" in err and "wrote" in err
    a, b = load_model(str(tmp_path / "j.bin")), load_model(str(tmp_path / "t.bin"))
    la, lb = _leaves(a.params), _leaves(b.params)
    for k in la:
        _adam_close(lb[k], la[k], 1e-3, 2, k)
    assert not np.array_equal(lb[".dec.blocks.mlp0_w"],
                              _leaves(load_model(model_path).params)[".dec.blocks.mlp0_w"])


def test_cli_is_the_jax_file_with_ng():
    src = (REPO / "whisper_tpu" / "cli" / "finetune.py").read_text()
    i = src.index('"""', 3)
    want = (src[:i].rstrip("\n")
            + "\n\nPort of whisper_tpu/cli/finetune.py: the same tool over the port's\n"
            "training/finetune.py, on the CUDA card; -ng runs it on the CPU (the\n"
            "reference tools' --no-gpu).\n" + src[i:])
    model_arg = '    ap.add_argument("-m", "--model", required=True)\n'
    want = want.replace(model_arg, model_arg + (
        '    ap.add_argument("-ng", "--no-gpu", action="store_true",\n'
        '                    help="run on the CPU instead of the CUDA card")\n'))
    want = want.replace("        log=lambda msg: print(msg, file=sys.stderr))",
                        "        log=lambda msg: print(msg, file=sys.stderr),\n"
                        '        device="cpu" if args.no_gpu else None)')
    assert (REPO / "whisper_tpu_torch" / "cli" / "finetune.py").read_text() == want

