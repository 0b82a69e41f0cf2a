"""The port's chunked TDT loop (`chunk` = 16) against its frame loop
(`chunk` = 1) and against the JAX package's chunked loop
(`_tdt_greedy_decode_chunked`), on the CPU, with the seeded weights and
encoder frames of tests/test_torch_parakeet_decode.py (its helpers are
imported from there), at T in {5, 37, 120} frames as tests/test_parakeet.py
holds the JAX loops to each other, and on a batch of rows of different
lengths.

Against the frame loop: tokens, frames, duration indices and values, n_out
and the final LSTM state h/c equal exactly (the predictor sees the same
tokens); p, plog and the captured joint-logit rows within 1e-4 (the joint's
encoder half is one batched product over every frame, its rows summed in
another order), as tests/test_parakeet.py:258-270.  Against JAX's chunk 16:
the integer fields exact; p, plog and the logit rows within 1e-4, h and c
within 1e-5 of their largest magnitude (torch's and XLA's f32 products sum
in other orders, as the frame loops' comparison holds them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parakeet_decode import HP, _close, _enc, _params, _state, one_torch_thread  # noqa: F401
from whisper_tpu.models.parakeet import decode as JD
from whisper_tpu_torch.models.parakeet import decode as TD
from whisper_tpu_torch.models.parakeet.convert import params_from_numpy

CHUNK = 16
ATOL = 1e-4


def _ints_equal(a, b, n):
    for i, name in enumerate(("tok", "frame", "didx", "dval")):
        np.testing.assert_array_equal(np.asarray(a[i])[:n], np.asarray(b[i])[:n], err_msg=name)


def _floats_near(a, b, n):
    for i, name in ((4, "p"), (5, "plog")):
        np.testing.assert_allclose(np.asarray(a[i])[:n], np.asarray(b[i])[:n], rtol=0,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("T,state_seed", [(5, None), (37, None), (120, 1)])
def test_chunked_matches_frame_loop_and_jax(T, state_seed):
    tree = _params(HP)
    enc = _enc(T, HP.n_audio_state, T)
    h0, c0 = _state(HP, state_seed)
    max_out = 4 * T + 64
    loop = TD.TdtLoop(params_from_numpy(tree), HP)
    args = (torch.from_numpy(enc), T, torch.from_numpy(h0), torch.from_numpy(c0), max_out)
    one = TD.tdt_greedy_decode(loop, *args, capture_logits=True, chunk=1)
    steps_one = loop.steps
    ck = TD.tdt_greedy_decode(loop, *args, capture_logits=True, chunk=CHUNK)
    n = one[6]
    assert ck[6] == n and n > 3
    _ints_equal(ck, one, n)
    _floats_near(ck, one, n)
    assert torch.equal(ck[7], one[7]) and torch.equal(ck[8], one[8])
    np.testing.assert_allclose(ck[9][:n], one[9][:n], rtol=0, atol=ATOL)
    # about one step per emitted token, not one per frame
    assert loop.steps - steps_one <= steps_one

    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    j = [np.asarray(a) for a in JD.tdt_greedy_decode(
        jp, jnp.asarray(enc), jnp.int32(T), jnp.asarray(h0), jnp.asarray(c0), HP, max_out,
        capture_logits=True, chunk=CHUNK)]
    assert int(j[6]) == n
    _ints_equal(ck, j, n)
    _floats_near(ck, j, n)
    _close(j[7], ck[7].numpy(), "h")
    _close(j[8], ck[8].numpy(), "c")
    np.testing.assert_allclose(ck[9][:n], j[9][:n], rtol=0, atol=ATOL)


def test_chunked_limits_match_frame_loop():
    """Crafted joint biases, as the frame loop's tests: a token of duration
    0 on every frame (the forced advance after n_max_tokens emissions), and
    blanks of duration 2 on every frame (no emission: each chunk's walk
    steps past its last frame)."""
    nv = HP.n_vocab + 1
    for bias in ({5: 60.0, nv: 60.0}, {HP.blank_id: 60.0, nv + 2: 60.0}):
        tree = _params(HP, bias=bias)
        T = 41
        loop = TD.TdtLoop(params_from_numpy(tree), HP)
        args = (torch.from_numpy(_enc(T, HP.n_audio_state, 4)), T, *map(torch.from_numpy,
                                                                        _state(HP)))
        max_out = TD.max_out_for(T, HP)
        one = TD.tdt_greedy_decode(loop, *args, max_out, chunk=1)
        ck = TD.tdt_greedy_decode(loop, *args, max_out, chunk=CHUNK)
        assert ck[6] == one[6]
        _ints_equal(ck, one, one[6])
        assert torch.equal(ck[7], one[7]) and torch.equal(ck[8], one[8])


def test_chunked_batch_rows_stop_on_their_own():
    tree = _params(HP)
    lens = [40, 7, 23]
    T = max(lens)
    enc_b = torch.from_numpy(np.stack([_enc(T, HP.n_audio_state, 10 + i) for i in range(3)]))
    zeros = torch.zeros((3, HP.n_pred_layers, HP.n_pred_dim))
    max_out = TD.max_out_for(T, HP)
    loop = TD.TdtLoop(params_from_numpy(tree), HP)
    one = TD.tdt_greedy_decode_batch(loop, enc_b, lens, zeros, zeros, max_out)
    ck = TD.tdt_greedy_decode_batch(loop, enc_b, lens, zeros, zeros, max_out, chunk=CHUNK)
    np.testing.assert_array_equal(ck[6], one[6])
    for b in range(3):
        n = int(one[6][b])
        _ints_equal([a[b] for a in ck[:6]], [a[b] for a in one[:6]], n)
        _floats_near([a[b] for a in ck[:6]], [a[b] for a in one[:6]], n)
    assert torch.equal(ck[7], one[7]) and torch.equal(ck[8], one[8])


def test_chunk_must_be_positive():
    loop = TD.TdtLoop(params_from_numpy(_params(HP)), HP)
    with pytest.raises(ValueError):
        TD.tdt_greedy_decode(loop, torch.zeros((4, HP.n_audio_state)), 4,
                             *map(torch.from_numpy, _state(HP)), 16, chunk=0)
