"""The port's TDT greedy loop against the JAX package's, on the CPU.

The JAX loop is one `lax.while_loop` (a vmap of it for a batch); the
port's is a step over a state of tensors, B rows at once, run eagerly here
(on the card it replays CUDA graphs of the same step; tests/test_torch_gpu.py
holds those to this eager loop bit for bit).  Both run from the same
weights (`convert.params_from_numpy`) on the same seeded encoder frames.
Tokens, frames, duration indices and values, and n_out are equal exactly;
p, plog, the captured joint-logit rows and the final LSTM state agree to
1e-5 of their largest magnitude (f32 products summed in another order).
Crafted joint biases reach the loop's two limits: the forced advance after
n_max_tokens emissions without one, and the max_out cap.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.models.parakeet import decode as JD
from whisper_tpu.models.parakeet.load import build_param_pytree
from whisper_tpu_torch.models.parakeet import decode as TD
from whisper_tpu_torch.models.parakeet.convert import params_from_numpy
from whisper_tpu_torch.models.parakeet.hparams import ParakeetHParams
from whisper_tpu_torch.models.parakeet.writer import synth_parakeet_tensors

HP = ParakeetHParams(
    n_vocab=12, n_audio_ctx=512, n_audio_state=32, n_audio_head=2,
    n_audio_layer=1, n_mels=16, n_fft=64, subsampling_factor=8,
    n_subsampling_channels=4, n_conv_kernel=3, n_pred_dim=32,
    n_pred_layers=2, n_tdt_durations=3, n_max_tokens=4,
    tdt_durations=(0, 1, 2))
RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(hp, bias=None):
    """The numpy tree (JAX layout) of seeded weights; `bias` overrides
    entries of the joint's output bias."""
    tree = build_param_pytree(synth_parakeet_tensors(hp, seed=3), hp)
    if bias:
        nb = tree["joint"]["net_b"].copy()
        for i, v in bias.items():
            nb[i] = v
        tree["joint"]["net_b"] = nb
    return tree


def _enc(T, S, seed):
    return (3.0 * np.random.default_rng(seed).standard_normal((T, S))).astype(np.float32)


def _state(hp, seed=None):
    shape = (hp.n_pred_layers, hp.n_pred_dim)
    if seed is None:
        return np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    rng = np.random.default_rng(seed)
    return tuple((0.5 * rng.standard_normal(shape)).astype(np.float32) for _ in range(2))


def _close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.abs(a).max(initial=0.0)), 1e-30)
    assert np.abs(a - b).max(initial=0.0) <= RTOL * scale, what


def _both(hp, tree, enc, n_frames, max_out, h0, c0, capture=True):
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    j = JD.tdt_greedy_decode(jp, jnp.asarray(enc), jnp.int32(n_frames),
                             jnp.asarray(h0), jnp.asarray(c0), hp, max_out,
                             capture_logits=capture)
    loop = TD.TdtLoop(params_from_numpy(tree), hp)
    t = TD.tdt_greedy_decode(loop, torch.from_numpy(enc), n_frames,
                             torch.from_numpy(h0), torch.from_numpy(c0), max_out,
                             capture_logits=capture)
    return [np.asarray(a) for a in j], t, loop


def _assert_same(j, t):
    n = int(j[6])
    assert t[6] == n
    for i, name in enumerate(("tok", "frame", "didx", "dval")):
        np.testing.assert_array_equal(t[i][:n], j[i][:n], err_msg=name)
    _close(j[4][:n], t[4][:n], "p")
    _close(j[5][:n], t[5][:n], "plog")
    _close(j[7], t[7].numpy(), "h")
    _close(j[8], t[8].numpy(), "c")
    if len(j) > 9:
        _close(j[9][:n], t[9][:n], "logits")
    return n


@pytest.mark.parametrize("T,n_frames,state_seed", [(5, 5, None), (37, 37, None),
                                                   (120, 120, 1), (64, 50, 2)])
def test_loop_matches_jax(T, n_frames, state_seed):
    tree = _params(HP)
    enc = _enc(T, HP.n_audio_state, T)
    h0, c0 = _state(HP, state_seed)
    j, t, loop = _both(HP, tree, enc, n_frames, TD.max_out_for(n_frames, HP), h0, c0)
    n = _assert_same(j, t)
    assert n > 3 and len(set(t[0][:n].tolist())) > 2      # not one repeated token
    assert loop.runs == 1 and loop.flag_reads == loop.replays > 0
    assert loop.steps == TD.STEPS_PER_REPLAY * loop.replays


def test_forced_advance_after_n_max_tokens():
    # a non-blank token and duration 0 win every step: each frame emits
    # n_max_tokens tokens, then t is forced forward by one
    nv = HP.n_vocab + 1
    tree = _params(HP, bias={5: 60.0, nv: 60.0})
    T = 9
    j, t, _ = _both(HP, tree, _enc(T, HP.n_audio_state, 4), T, TD.max_out_for(T, HP),
                    *_state(HP))
    n = _assert_same(j, t)
    assert n == T * HP.n_max_tokens
    np.testing.assert_array_equal(t[1][:n], np.repeat(np.arange(T), HP.n_max_tokens))
    assert (t[3][:n] == 0).all() and (t[0][:n] == 5).all()


def test_max_out_cap():
    # n_max_tokens 10 over 20 frames: the cap min(200, 4*20+64) = 144 stops
    # the loop before t reaches the end
    hp = dataclasses.replace(HP, n_max_tokens=10)
    nv = hp.n_vocab + 1
    tree = _params(hp, bias={7: 60.0, nv: 60.0})
    T = 20
    max_out = TD.max_out_for(T, hp)
    assert max_out == 144
    j, t, _ = _both(hp, tree, _enc(T, hp.n_audio_state, 5), T, max_out, *_state(hp))
    n = _assert_same(j, t)
    assert n == max_out and t[1][n - 1] < T - 1


def test_batch_rows_stop_on_their_own():
    """The vmapped JAX batch and the port's row axis: every row equal to the
    JAX row (and to its own solo decode), rows of different lengths."""
    tree = _params(HP)
    lens = [40, 7, 23]
    T = max(lens)
    enc_b = np.stack([_enc(T, HP.n_audio_state, 10 + i) for i in range(3)])
    max_out = TD.max_out_for(T, HP)
    L, D = HP.n_pred_layers, HP.n_pred_dim
    zeros = np.zeros((3, L, D), np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    j = [np.asarray(a) for a in JD.tdt_greedy_decode_batch(
        jp, jnp.asarray(enc_b), jnp.asarray(lens, jnp.int32), jnp.asarray(zeros),
        jnp.asarray(zeros), HP, max_out)]
    loop = TD.TdtLoop(params_from_numpy(tree), HP)
    t = TD.tdt_greedy_decode_batch(loop, torch.from_numpy(enc_b), lens,
                                   torch.from_numpy(zeros), torch.from_numpy(zeros),
                                   max_out)
    for b in range(3):
        rb = [a[b] for a in j]
        tb = [t[i][b] for i in range(6)] + [int(t[6][b]), t[7][b], t[8][b]]
        _assert_same(rb, tb)
        solo = TD.tdt_greedy_decode(loop, torch.from_numpy(enc_b[b]), lens[b],
                                    torch.zeros(L, D), torch.zeros(L, D), max_out)
        assert solo[6] == tb[6]
        for i in range(4):
            np.testing.assert_array_equal(solo[i][:solo[6]], tb[i][:tb[6]])


def test_decoder_carries_lstm_state():
    """TdtDecoder keeps h/c between calls (parakeet_chunk) and resets them:
    its second call equals the JAX loop run from the JAX loop's first h/c."""
    from whisper_tpu_torch.models.parakeet.load import ParakeetModel, ParakeetVocab

    tree = _params(HP)
    vocab = ParakeetVocab([f"t{i}" for i in range(HP.n_vocab)] + ["[BLANK]"],
                          HP.n_vocab, 0, 1, 2)
    model = ParakeetModel(HP, np.zeros((16, 33), np.float32), np.ones(64, np.float32),
                          vocab, tree)
    dec = TD.TdtDecoder(model, params_from_numpy(tree), "cpu")
    enc = _enc(30, HP.n_audio_state, 8)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    h, c = (jnp.asarray(a) for a in _state(HP))
    for _ in range(2):
        j = JD.tdt_greedy_decode(jp, jnp.asarray(enc), jnp.int32(30), h, c, HP,
                                 TD.max_out_for(30, HP))
        h, c = j[7], j[8]
        toks = dec.decode(torch.from_numpy(enc), 30)
        assert [td.id for td in toks] == np.asarray(j[0][:int(j[6])]).tolist()
        assert [td.frame_index for td in toks] == np.asarray(j[1][:int(j[6])]).tolist()
        _close(np.asarray(h), dec.h.numpy(), "h")
        _close(np.asarray(c), dec.c.numpy(), "c")
    assert dec.h.abs().sum() > 0
    dec.reset_state()
    assert dec.h.abs().sum() == 0 and dec.c.abs().sum() == 0
