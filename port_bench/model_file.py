"""The model file of a run: random q5_0 weights drawn on the device from
the run's seed, written as a ggml Whisper file into anonymous memory.

Weights are drawn in a few large calls of one `torch.Generator` on the
device, directly in the stored form: a q5_0 block is an f16 scale and 20
bytes of 5-bit codes, and uniform bytes are uniform codes, so no host or
device quantizer runs.  The scales give each matrix the spread of
N(0, 1/fan_in) (uniform codes q - 16 have a standard deviation of 9.247);
the token embedding has the spread 0.02, the layer norms 1 + 0.02 N, the
biases and positional embeddings 0.02 N, the conv kernels (stored f16)
N(0, 1/(3 c_in)).

Random weights give near-tied logits, on which greedy decoding runs to the
token cap and timestamps make no sense.  `decisive` boosts a fixed set of
token rows and mixes boosted rows into each decoder position (the
`make_decisive` rescaling of whisper_tpu_torch/utils/synth.py, copied), so
each window decodes a scripted transcript with wide argmax margins: the
script of `decisive_script`, segments of speech at a stated rate of words
a second and tokens a word.  `residual_scale` scales the output
projections of the decoder blocks' three branches (self-attention,
cross-attention, MLP), which keeps every product at its width but lets the
random weights and the audio move the residual stream only a little, so
the scripted token wins at every position on every seed; `logit_scale`
then scales the decoder's final layer norm, and so every logit, which
keeps each argmax and brings the runners-up within reach of float32's
softmax, so that the served probabilities say something about the logits.
The script comes from the configuration's own fixed seed, not from the
run's: every seed then decodes the same tokens a window, and only the
values of the weights and the audio change.

The file lives in a memfd (`os.memfd_create`): the program's `load()`
opens it by its /proc path as it would open a file on disk, and nothing is
written to the machine's disk.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from . import ggml

CODE_STD = 9.247        # standard deviation of uniform codes q - 16, q in 0..31


def hparams(cfg: dict) -> Dict[str, int]:
    """ggml header fields from the configuration's published keys."""
    assert cfg["encoder_ffn_dim"] == 4 * cfg["d_model"] == cfg["decoder_ffn_dim"]
    return {"n_vocab": cfg["vocab_size"], "n_audio_ctx": cfg["max_source_positions"],
            "n_audio_state": cfg["d_model"], "n_audio_head": cfg["encoder_attention_heads"],
            "n_audio_layer": cfg["encoder_layers"], "n_text_ctx": cfg["max_target_positions"],
            "n_text_state": cfg["d_model"], "n_text_head": cfg["decoder_attention_heads"],
            "n_text_layer": cfg["decoder_layers"], "n_mels": cfg["num_mel_bins"]}


def special_tokens(n_vocab: int) -> Dict[str, int]:
    """whisper.cpp's special-token ids for a vocabulary size
    (src/whisper.cpp:439-449, 1625-1639)."""
    ids = dict(eot=50256, sot=50257, translate=50357, transcribe=50358,
               solm=50359, prev=50360, nosp=50361, not_=50362, beg=50363)
    if n_vocab >= 51865:
        n_lang = n_vocab - 51765 - 1
        ids["eot"] += 1
        ids["sot"] += 1
        for k in ("translate", "transcribe", "solm", "prev", "nosp", "not_", "beg"):
            ids[k] += n_lang - 98
        ids["n_lang"] = n_lang
    else:
        ids["n_lang"] = n_vocab - 51765
    return ids


def _float_spec(name: str, shape) -> Tuple[float, float]:
    """(mean, std) of a tensor stored as f32 or f16."""
    if name.endswith("ln.weight") or name.endswith("ln_post.weight"):
        return 1.0, 0.02
    if name.endswith(".conv1.weight") or name.endswith(".conv2.weight"):
        return 0.0, 1.0 / np.sqrt(3 * shape[1])
    return 0.0, 0.02


def _window_script(rng, tok: Dict[str, int], d: dict, n_exact: int = 0):
    """One window's scripted tokens, EOT left out: segments of `segment_s`
    seconds (uniform, on the timestamp grid), each `<|t0|> text <|t1|>`
    with words_per_s x tokens_per_word text tokens a second, the next
    opening at the last one's close, up to a last close in `window_end_s`
    (a single closing timestamp: the window then advances the whole 30 s,
    src/whisper.cpp's single-timestamp ending).  `n_exact` sets the
    window's length by the last segment's text."""
    grid = d["ts_stride"] * 0.02
    rate = d["words_per_s"] * d["tokens_per_word"]
    lo, hi = d["segment_s"]
    end = round(rng.uniform(*d["window_end_s"]) / grid)
    bounds = [0]
    while True:
        nxt = bounds[-1] + round(rng.uniform(lo, hi) / grid)
        if nxt * grid > end * grid - lo:
            bounds.append(end)
            break
        bounds.append(nxt)
    counts = [max(1, round(rate * (b1 - b0) * grid)) for b0, b1 in zip(bounds, bounds[1:])]
    if n_exact:
        counts[-1] += n_exact - (sum(counts) + 2 * len(counts))
        assert counts[-1] >= 1, "n_exact leaves the last segment no text"
    ts = lambda k: tok["beg"] + k * d["ts_stride"]   # noqa: E731
    seq = []
    for s, (b0, b1) in enumerate(zip(bounds, bounds[1:])):
        seq += [ts(b0)] + [-1] * counts[s] + [ts(b1)]
    return seq


def decisive_script(hp: Dict[str, int], d: dict):
    """(active text rows, active timestamp rows, and per position: the
    scripted token, a second choice (-1: none), a text alternative), all
    from the configuration's fixed seed.

    The token chosen at step i of a window is the script's at position
    len(prompt) - 1 + i.  The server carries each window's tokens into the
    next one's prompt (`[prev] + past[-max_prompt:]`, max_prompt
    n_text_ctx / 2 - 1), so a clip's first window runs from position
    len(sot) - 1, its second from n1 + len(sot), and every later one from
    max_prompt + len(sot).  The first two windows' lengths add up to
    max_prompt, so the second window's EOT and the later windows' first
    timestamp share one position: EOT first there, `<|0.00|>` second (the
    rules ban EOT at a window's first step, and every timestamp below the
    last one at a window's end).  A clip's last window is cut where a
    timestamp passes its end, and one that starts within 5 s of its end
    has no prompt and runs the first window's script.  Every other choice
    is the script's own: the second choice, the timestamp of the
    segment's start (never below the last), and the text alternative only
    shape the served probabilities."""
    tok = special_tokens(hp["n_vocab"])
    rng = np.random.default_rng(d["script_seed"])
    active = rng.choice(np.arange(1000, 50000), size=d["n_text_active"], replace=False)
    ts_active = np.arange(tok["beg"], hp["n_vocab"], d["ts_stride"])
    n_pos = hp["n_text_ctx"]
    n_sot = 3                                       # sot, language, task
    max_prompt = n_pos // 2 - 1
    w1 = _window_script(rng, tok, d)
    w2 = _window_script(rng, tok, d, n_exact=max_prompt - len(w1))
    w3 = _window_script(rng, tok, d)
    first = active[rng.integers(0, len(active), n_pos)]
    second = np.full(n_pos, -1)
    for start, seq in ((n_sot - 1, w1), (len(w1) + n_sot, w2), (max_prompt + n_sot, w3)):
        assert start + len(seq) < n_pos
        last_ts = seq[0]
        for i, t in enumerate(seq):
            p = start + i
            if t < 0:
                t = active[rng.integers(0, len(active))]
                second[p] = last_ts
            else:
                last_ts = t
            first[p] = t
        first[start + len(seq)], second[start + len(seq)] = tok["eot"], last_ts
    # the junction: window 2's EOT, the later windows' <|0.00|>
    first[max_prompt + n_sot], second[max_prompt + n_sot] = tok["eot"], tok["beg"]
    pick = rng.integers(0, len(active), n_pos)
    alt = np.where(active[pick] == first, active[(pick + 1) % len(active)], active[pick])
    return active, ts_active, first, second, alt


def draw(cfg: dict, seed: int, device):
    """(header bytes, {name: payload as uint8 on the host}, {name: shape},
    {name: ggml type}) of the run's model, in converter order."""
    hp = hparams(cfg)
    names = ggml.tensor_names(hp)
    shapes = {n: ggml.tensor_shape(n, hp) for n in names}
    types = {n: ggml.storage_type(n, shapes[n]) for n in names}
    q5 = [n for n in names if types[n] == ggml.TYPE_Q5_0]
    fl = [n for n in names if types[n] != ggml.TYPE_Q5_0]
    nblk = {n: int(np.prod(shapes[n])) // ggml.QK for n in q5}
    nel = {n: int(np.prod(shapes[n])) for n in fl}

    g = torch.Generator(device=device).manual_seed(int(seed))
    n_blocks = sum(nblk.values())
    codes = torch.randint(0, 256, (n_blocks, 20), dtype=torch.uint8, generator=g,
                          device=device)
    std = torch.tensor([0.02 if n == "decoder.token_embedding.weight"
                        else 1.0 / np.sqrt(shapes[n][1]) for n in q5],
                       dtype=torch.float32, device=device)
    per_block = torch.repeat_interleave(std, torch.tensor([nblk[n] for n in q5],
                                                          device=device))
    scale = per_block / CODE_STD * (0.75 + 0.5 * torch.rand(n_blocks, generator=g,
                                                           device=device))
    flat = torch.randn(sum(nel.values()), generator=g, device=device)
    mean_std = [_float_spec(n, shapes[n]) for n in fl]
    sizes = torch.tensor([nel[n] for n in fl], device=device)
    f32 = dict(dtype=torch.float32, device=device)
    flat = (flat * torch.repeat_interleave(torch.tensor([s for _, s in mean_std], **f32), sizes)
            + torch.repeat_interleave(torch.tensor([m for m, _ in mean_std], **f32), sizes))

    q_off = dict(zip(q5, np.cumsum([0] + [nblk[n] for n in q5])[:-1].tolist()))
    f_off = dict(zip(fl, np.cumsum([0] + [nel[n] for n in fl])[:-1].tolist()))
    if cfg.get("decisive"):
        c = cfg["decisive"].get("logit_scale", 1.0)
        for n in ("decoder.ln.weight", "decoder.ln.bias"):
            flat[f_off[n]:f_off[n] + nel[n]] *= c
        r = cfg["decisive"].get("residual_scale", 1.0)
        for n in names:
            if n.startswith("decoder.blocks.") and any(
                    k in n for k in (".attn.out.", ".cross_attn.out.", ".mlp.2.")):
                if n.endswith("weight"):
                    scale[q_off[n]:q_off[n] + nblk[n]] *= r
                else:
                    flat[f_off[n]:f_off[n] + nel[n]] *= r
        _make_decisive(hp, cfg["decisive"], codes, scale, flat,
                       q_off["decoder.token_embedding.weight"],
                       f_off["decoder.positional_embedding"])

    blocks = torch.cat([scale.half().view(torch.uint8).reshape(-1, 2), codes], 1).cpu()
    floats = flat.cpu()
    payload = {}
    for n in names:
        if types[n] == ggml.TYPE_Q5_0:
            payload[n] = blocks[q_off[n]:q_off[n] + nblk[n]].reshape(-1)
        else:
            t = floats[f_off[n]:f_off[n] + nel[n]]
            t = t.half() if types[n] == ggml.TYPE_F16 else t
            payload[n] = t.view(torch.uint8)
    header = ggml.header_bytes(hp, ggml.synth_filters(hp["n_mels"]),
                               ggml.synth_vocab(hp["n_vocab"]))
    return header, payload, shapes, types


def _make_decisive(hp, d, codes, scale, flat, emb_off: int, pos_off: int) -> None:
    """make_decisive on the drawn blocks, in place: a boosted row's scales
    are set (its codes stay), and the positional rows gain the boosted
    rows' dequantized values."""
    tok = special_tokens(hp["n_vocab"])
    n, V = hp["n_text_state"], hp["n_vocab"]
    bpr = n // ggml.QK
    dev = codes.device
    emb_scale = scale[emb_off:emb_off + V * bpr].view(V, bpr)
    P = flat[pos_off:pos_off + hp["n_text_ctx"] * n].view(hp["n_text_ctx"], n)
    active, ts_active, first, second, alt = decisive_script(hp, d)

    def rows(ids: np.ndarray) -> torch.Tensor:
        """Dequantized token-embedding rows, with scales as stored (f16)."""
        ids_t = torch.as_tensor(np.asarray(ids), device=dev)
        blk = codes.view(-1, 20)[emb_off:emb_off + V * bpr].view(V, bpr, 20)[ids_t]
        d16 = emb_scale[ids_t].half()
        raw = torch.cat([d16.view(torch.uint8).reshape(-1, bpr, 2), blk], 2)
        return ggml.q5_0_to_f32(raw).view(len(ids_t), n)

    # a boosted row's scales are the token embedding's mean scale times the
    # boost, not drawn: rows of one norm keep the scripted margins alike
    boosted = d["boost"] * 0.02 / CODE_STD
    if hp["n_vocab"] >= 51865:
        lang_es = tok["sot"] + 1 + 3            # scripts `-l auto` at position 0
        emb_scale[lang_es] = boosted
        P[0] += 3.0 * rows(np.array([lang_es]))[0]
    emb_scale[torch.as_tensor(active, device=dev)] = boosted
    emb_scale[torch.as_tensor(ts_active, device=dev)] = boosted
    emb_scale[tok["eot"]] = boosted * d["eot_boost"]
    has_second = torch.as_tensor(second >= 0, device=dev, dtype=P.dtype)[:, None]
    P += (d["pos_mix"] * rows(first) + d["ts_mix"] * has_second * rows(np.maximum(second, 0))
          + d["alt_mix"] * rows(alt))


def write_memfd(cfg: dict, seed: int, device) -> Tuple[int, str, int]:
    """Draw the run's model and write it into a memfd: (fd, path, bytes)."""
    header, payload, shapes, types = draw(cfg, seed, device)
    fd = os.memfd_create("port_bench_model")
    with os.fdopen(os.dup(fd), "wb") as f:
        f.write(header)
        for name, raw in payload.items():
            f.write(ggml.record_header(name, types[name], shapes[name]))
            f.write(raw.numpy().data)
    return fd, f"/proc/self/fd/{fd}", os.fstat(fd).st_size
