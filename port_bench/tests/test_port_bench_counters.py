"""The operation and byte counts of port_bench/flops.py against hand counts
at tiny widths."""

import pytest

from port_bench import flops

HP = dict(n_vocab=10, n_audio_ctx=4, n_audio_state=2, n_audio_head=1, n_audio_layer=1,
          n_text_ctx=8, n_text_state=2, n_text_head=1, n_text_layer=1, n_mels=3)


def test_encoder_flops_by_hand():
    # conv1: 2 * 8 frames * 2 out * 9 in; conv2: 2 * 4 * 2 * 6
    conv = 2 * 8 * 2 * 9 + 2 * 4 * 2 * 6
    # a block: qkv 2*4*2*6, o 2*4*2*2, mlp 2 * 2*4*2*8, scores and values 2 * 2*4*4*2
    block = 2 * 4 * 2 * 6 + 2 * 4 * 2 * 2 + 2 * (2 * 4 * 2 * 8) + 2 * (2 * 4 * 4 * 2)
    cross = 2 * (2 * 4 * 2 * 2)
    assert flops.encoder_flops(HP) == conv + block + cross


def test_encoder_bytes_by_hand():
    weights = (12 * 4 + 2 * 4) * 22 / 32
    conv = (3 * 2 * 3 + 3 * 2 * 2) * 2
    io = 3 * 8 * 4 + 2 * 4 * 2 * 2
    assert flops.encoder_bytes(HP) == pytest.approx(weights + conv + io)


def test_decoder_row_and_windows_by_hand():
    # a row at context c: 28 S^2 + 4 S c + 4 S n_audio_ctx, then the logits 2 S V
    row = lambda c: 28 * 4 + 4 * 2 * c + 4 * 2 * 4 + 2 * 2 * 10
    assert flops.row_flops(HP, 3) == row(3)
    # a 2-token prompt and 3 chosen tokens need rows at contexts 1..4
    assert flops.decoder_flops(HP, [(2, 3)]) == sum(row(c) for c in (1, 2, 3, 4))
    # one chosen token needs no step after it
    assert flops.decoder_flops(HP, [(2, 1)]) == row(1) + row(2)


def test_group_bound_counts_live_windows_only():
    w = flops.weight_bytes(HP)
    assert w == (14 * 4 + 10 * 2) * 22 / 32
    kv = lambda c: 2 * (4 + c) * 2 * 2
    # windows (prompt 2, 3 tokens) and (prompt 2, 1 token): the prompt pass
    # reads both windows' K/V, the two steps only the first window's
    expect = (w + 2 * kv(2)) / flops.PEAK_BYTES + (w + kv(3)) / flops.PEAK_BYTES \
        + (w + kv(4)) / flops.PEAK_BYTES
    assert flops.group_bound_s(HP, [(2, 3), (2, 1)]) == pytest.approx(expect)


def test_bytes_bound_at_full_width():
    hp = dict(n_vocab=51866, n_audio_ctx=1500, n_audio_state=1280, n_audio_head=20,
              n_audio_layer=32, n_text_ctx=448, n_text_state=1280, n_text_head=20,
              n_text_layer=32, n_mels=128)
    # ~0.55 GB of q5_0 planes a step: 32 x 22.9 M weights and the 66.4 M head
    assert flops.weight_bytes(hp) == pytest.approx(0.5503e9, rel=1e-3)
    # one encoder window: ~2.27 TFLOP of encoder and 0.31 of cross K/V
    assert flops.encoder_flops(hp) == pytest.approx(2.58e12, rel=0.01)
