"""The frozen writer and reader round trip, the q5_0 codec against the
port's, and the port's load() of a tiny written file on the CPU."""

import json
import os

import numpy as np
import torch

from port_bench import ggml, model_file

HERE = os.path.dirname(os.path.abspath(__file__))


def tiny():
    with open(os.path.join(HERE, "data", "tiny-q5_0.json")) as f:
        return json.load(f)


def test_round_trip_through_the_frozen_reader():
    cfg = tiny()
    fd, path, size = model_file.write_memfd(cfg, 7, "cpu")
    try:
        with open(path, "rb") as f:
            mf = ggml.read_model(f.read())
    finally:
        os.close(fd)
    hp = model_file.hparams(cfg)
    assert {k: mf.hp[k] for k in hp} == hp and mf.hp["ftype"] == ggml.FTYPE_MOSTLY_Q5_0
    assert list(mf.tensors) == ggml.tensor_names(hp)
    assert mf.vocab == ggml.synth_vocab(hp["n_vocab"])
    for name, (t, shape, raw) in mf.tensors.items():
        assert shape == ggml.tensor_shape(name, hp)
        assert t == ggml.storage_type(name, shape)
    w = ggml.tensor_f32(mf, "encoder.blocks.0.mlp.0.weight", "cpu")
    assert w.shape == (256, 64)
    # uniform 5-bit codes with scales for N(0, 1/fan_in)
    assert abs(w.std().item() * 8.0 - 1.0) < 0.05
    ln = ggml.tensor_f32(mf, "decoder.ln.weight", "cpu")
    assert abs(ln.mean().item() - 1.0) < 0.01


def test_q5_0_codec_matches_the_ports():
    from whisper_tpu_torch.formats import quants

    x = np.random.default_rng(0).standard_normal(32 * 40).astype(np.float32)
    raw = quants.quantize_q5_0(x)
    ours = ggml.q5_0_to_f32(torch.frombuffer(bytearray(raw), dtype=torch.uint8)).numpy()
    np.testing.assert_array_equal(ours, quants.dequantize_q5_0(raw, x.size))


def test_the_same_seed_draws_the_same_file():
    cfg = tiny()
    a = model_file.draw(cfg, 11, "cpu")[1]
    b = model_file.draw(cfg, 11, "cpu")[1]
    c = model_file.draw(cfg, 12, "cpu")[1]
    name = "decoder.blocks.1.mlp.2.weight"
    assert torch.equal(a[name], b[name]) and not torch.equal(a[name], c[name])


def test_the_ports_load_reads_the_written_file():
    from whisper_tpu_torch.runtime.context import WhisperContext

    cfg = tiny()
    fd, path, _ = model_file.write_memfd(cfg, 3, "cpu")
    try:
        ctx = WhisperContext.from_file(path, device="cpu")
        with open(path, "rb") as f:
            mf = ggml.read_model(f.read())
    finally:
        os.close(fd)
    hp = model_file.hparams(cfg)
    assert ctx.hp.n_text_layer == hp["n_text_layer"] and ctx.hp.n_vocab == hp["n_vocab"]
    # the port's dense o projection is the file's, transposed to (in, out)
    o = ggml.tensor_f32(mf, "decoder.blocks.0.attn.out.weight", "cpu")
    torch.testing.assert_close(ctx.params["dec"]["blocks"]["o_w"][0], o.T, rtol=0, atol=0)
    tk = model_file.special_tokens(hp["n_vocab"])
    assert (ctx.vocab.token_eot, ctx.vocab.token_beg) == (tk["eot"], tk["beg"])
