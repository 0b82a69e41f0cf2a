"""Rank functions of the port's scale-out tests (tests/test_torch_sharding.py,
test_torch_parakeet_sharding.py, test_torch_multihost.py,
test_torch_opt_dp.py, test_torch_collectives.py).

`parallel/launch.py` runs them in processes of their own over gloo on the
CPU.  This module imports numpy and the port only, so a rank imports no
JAX: each result carries the rank's foreign modules (`foreign`), which the
tests hold empty.  Inputs are drawn from seeds with numpy, here and in the
test process alike (`whisper_params`), so the JAX reference there sees the
same numbers.
"""

from __future__ import annotations

import sys
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
from whisper_tpu_torch.parallel import mesh as PM
from whisper_tpu_torch.parallel import sharding as PS

F32 = torch.float32


def foreign() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "whisper_tpu"))


def whisper_params(hp: WhisperHParams, seed: int, parts=("enc", "dec")) -> Dict[str, Any]:
    """A dense parameter tree (models/whisper/load.py's layout, numpy f32)
    drawn from `seed`: N(0, 0.02) weights and biases (0.1 for the conv
    stem), unit layer-norm gains, as utils/synth.py synth_params."""
    rng = np.random.default_rng(seed)

    def w(*shape, std=0.02):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    def ones(*shape):
        return np.ones(shape, np.float32)

    def blocks(n, L, cross):
        b = {
            "attn_ln_w": ones(L, n), "attn_ln_b": w(L, n),
            "qkv_w": w(L, n, 3 * n), "qkv_b": w(L, 3 * n),
            "o_w": w(L, n, n), "o_b": w(L, n),
            "mlp_ln_w": ones(L, n), "mlp_ln_b": w(L, n),
            "mlp0_w": w(L, n, 4 * n), "mlp0_b": w(L, 4 * n),
            "mlp1_w": w(L, 4 * n, n), "mlp1_b": w(L, n),
        }
        if cross:
            b.update({
                "xattn_ln_w": ones(L, n), "xattn_ln_b": w(L, n),
                "xq_w": w(L, n, n), "xq_b": w(L, n),
                "xk_w": w(L, n, n),
                "xv_w": w(L, n, n), "xv_b": w(L, n),
                "xo_w": w(L, n, n), "xo_b": w(L, n),
            })
        return b

    ns, nt = hp.n_audio_state, hp.n_text_state
    tree = {}
    if "enc" in parts:
        tree["enc"] = {
            "pos_embd": w(hp.n_audio_ctx, ns),
            "conv1_w": w(ns, hp.n_mels, 3, std=0.1), "conv1_b": w(ns),
            "conv2_w": w(ns, ns, 3, std=0.1), "conv2_b": w(ns),
            "ln_post_w": ones(ns), "ln_post_b": w(ns),
            "blocks": blocks(ns, hp.n_audio_layer, cross=False),
        }
    if "dec" in parts:
        tree["dec"] = {
            "pos_embd": w(hp.n_text_ctx, nt),
            "tok_embd": w(hp.n_vocab, nt),
            "ln_w": ones(nt), "ln_b": w(nt),
            "blocks": blocks(nt, hp.n_text_layer, cross=True),
        }
    return tree


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


def _np(x):
    if isinstance(x, tuple):
        return tuple(_np(a) for a in x)
    return x.detach().float().numpy() if x.dtype != torch.int8 else x.numpy()


def forward(params, mel, tokens, hp, itype: str, tp):
    """encode -> cross-K/V -> a prompt pass and 2 greedy steps (the JAX
    test_multichip_numerics `_forward`): (encoder output, the logits of
    every step concatenated, the self-KV cache)."""
    from whisper_tpu_torch.models.whisper import model as M

    enc = M.encode(params, mel, hp, dtype=F32, tp=tp)
    xk, xv = M.compute_cross_kv(params, enc, hp, dtype=F32,
                                itype="q8" if itype == "q8" else "f16", tp=tp)
    B, T = tokens.shape
    cache = M.new_cache(hp, B, F32, itype=itype, tp=tp)
    pos0 = torch.arange(T).expand(B, T)
    logits0, cache = M.decode_step(params, tokens, pos0, 0, cache, xk, xv, hp,
                                   dtype=F32, tp=tp)
    outs = [logits0]
    tok = logits0[:, -1:].argmax(-1)
    for s in range(2):
        pos = torch.full_like(tok, T + s)
        lg, cache = M.decode_step(params, tok, pos, T + s, cache, xk, xv, hp,
                                  dtype=F32, tp=tp)
        outs.append(lg)
        tok = lg[:, -1:].argmax(-1)
    return enc, torch.cat(outs, 1), cache


def whisper_sharded(hp: WhisperHParams, seed: int, mel: np.ndarray,
                    tokens: np.ndarray, meshes, window: bool = False,
                    medium: Dict[str, Any] = None) -> Dict[str, Any]:
    """For each (n_dp, n_tp) of `meshes`: the sharded forward's encoder
    output and logits (f16 and q8 caches) and the q8 cache's scales beside
    the unsharded run's; the q8 row quantizer on a sharded row against the
    whole row; with `window`, the native window decoder (W = 4) on the
    first mesh; with `medium`, the medium-width decode chain on the last."""
    torch.manual_seed(0)
    from whisper_tpu_torch.models.whisper import model as M

    params = _tensors(whisper_params(hp, seed))
    mel_t, tok_t = torch.from_numpy(mel), torch.from_numpy(tokens).long()
    out: Dict[str, Any] = {"rank": dist.get_rank()}
    for n_dp, n_tp in meshes:
        mesh = PM.make_mesh(n_dp, n_tp)
        tp = PM.axis_group(mesh, "tp")
        local = PS.shard_params(params, mesh, hp)
        for itype in ("f16", "q8"):
            enc, logits, cache = forward(local, mel_t, tok_t, hp, itype, tp)
            res = {"enc": _np(enc), "logits": _np(logits)}
            if itype == "q8":
                _, _, ref = forward(params, mel_t, tok_t, hp, itype, None)
                res["scale"], res["scale_ref"] = _np(cache.scale), _np(ref.scale)
                res["cache_heads"] = cache.kv.shape[2]
            out[(n_dp, n_tp, itype)] = res
        # the row quantizer alone: a (B, T, 2, S) block cut by heads
        kv2 = torch.from_numpy(np.random.default_rng(11).standard_normal(
            (2, 3, 2, hp.n_text_state)).astype(np.float32))
        kv2[..., -1] *= 9.0        # the row's amax lies in the last rank's heads
        n, r = PM.group_size(tp), PM.group_rank(tp)
        k = hp.n_text_state // n
        codes, sc = M._quantize_rows(kv2[..., r * k:(r + 1) * k], tp)
        codes_ref, sc_ref = M._quantize_rows(kv2)
        out[(n_dp, n_tp, "rows")] = {
            "scale_equal": bool(torch.equal(sc, sc_ref)),
            "codes_equal": bool(torch.equal(codes, codes_ref[..., r * k:(r + 1) * k]))}
        if window and (n_dp, n_tp) == tuple(meshes[0]):
            out["window"] = window_decode(local, mel_t, hp, tp)
        if medium is not None and (n_dp, n_tp) == tuple(meshes[-1]):
            out["medium"] = medium_chain(medium, mesh, tp)
    out["foreign"] = foreign()
    return out


def window_decode(params, mel, hp, tp, W: int = 4) -> Dict[str, np.ndarray]:
    """The JAX test_sharded_window_decoder_tokens_exact's call on the port's
    native window decoder: W windows of one prompt, greedy, t = 0."""
    from whisper_tpu_torch.decoding import device_loop as DL
    from whisper_tpu_torch.models.whisper import model as M

    enc = M.encode(params, mel, hp, dtype=F32, tp=tp)
    xk1, xv1 = M.compute_cross_kv(params, enc, hp, dtype=F32, tp=tp)
    xk = xk1[None].expand(W, *xk1.shape).contiguous()
    xv = xv1[None].expand(W, *xv1.shape).contiguous()
    prompts = torch.tensor([[0, 0, 0, 0, 0, 0, 1, 2]]).repeat(W, 1)
    eot, beg = hp.n_vocab - 2, hp.n_vocab - 10
    fn = DL.make_window_decoder(hp, 1, 8, F32, False, False, eot, beg,
                                n_windows=W, tp=tp)
    res = fn(params, prompts, [2] * W, xk, xv, torch.zeros(hp.n_vocab),
             torch.zeros(hp.n_vocab), [0.0] * W, [0] * W, [3000] * W, 0, list(range(W)))
    return {"tok_id": res.tok_id[:, 0], "n_tok": res.n_tok[:, 0],
            "eager_windows": fn.eager_windows}


def medium_chain(medium: Dict[str, Any], mesh, tp) -> np.ndarray:
    """The JAX test_sharded_decode_step_medium_depth chain: B = 4 rows, 3
    greedy steps, a random cross-K/V, sharded decoder."""
    from whisper_tpu_torch.models.whisper import model as M

    hp, B = medium["hp"], 4
    params = PS.shard_params(_tensors(whisper_params(hp, medium["seed"], ("dec",))),
                             mesh, hp)
    xk1, xv1 = (torch.from_numpy(a) for a in medium_xkv(hp, medium["seed"]))
    xk, xv = (PM.shard(mesh, PS.cross_kv_spec(), a) for a in (xk1, xv1))
    cache = M.new_cache(hp, B, F32, tp=tp)
    toks = torch.arange(B)[:, None] + 17
    outs = []
    for step in range(3):
        pos = torch.full((B, 1), step)
        logits, cache = M.decode_step(params, toks, pos, step, cache, xk, xv, hp,
                                      dtype=F32, tp=tp)
        toks = logits[:, -1:].argmax(-1)
        outs.append(logits)
    return _np(torch.stack(outs)) if dist.get_rank() == 0 else None


def medium_xkv(hp: WhisperHParams, seed: int):
    d = hp.n_text_state // hp.n_text_head
    xk = np.random.default_rng(seed + 1).standard_normal(
        (hp.n_text_layer, hp.n_text_head, hp.n_audio_ctx, d), dtype=np.float32) * np.float32(0.1)
    return xk, xk * np.float32(0.5) + np.float32(0.01)


def parakeet_sharded(hp, mels: np.ndarray, n_dp: int, n_tp: int,
                     max_out: int = 32) -> Dict[str, Any]:
    """Parakeet on a (dp, tp) mesh: dp rank d encodes its consecutive rows
    of `mels` (W, T, n_mels) with its tp group, then TDT-decodes each row
    on the replicated predictor and joint.  The rows' encoder outputs and
    tokens, by row index."""
    from whisper_tpu_torch.models.parakeet import decode as TD
    from whisper_tpu_torch.models.parakeet import model as TM
    from whisper_tpu_torch.models.parakeet.convert import params_from_numpy
    from whisper_tpu_torch.models.parakeet.load import build_param_pytree
    from whisper_tpu_torch.models.parakeet.writer import synth_parakeet_tensors
    from whisper_tpu_torch.parallel.parakeet_sharding import shard_parakeet_params

    mesh = PM.make_mesh(n_dp, n_tp)
    tp = PM.axis_group(mesh, "tp")
    params = shard_parakeet_params(
        params_from_numpy(build_param_pytree(synth_parakeet_tensors(hp), hp)), mesh)
    dp = PM.axis_group(mesh, "dp")
    k = mels.shape[0] // n_dp
    rows = list(range(PM.group_rank(dp) * k, (PM.group_rank(dp) + 1) * k))
    with torch.no_grad():
        enc = TM.encode(params, torch.from_numpy(mels[rows]), mels.shape[1], hp,
                        tp=tp)
        loop = TD.TdtLoop(params, hp)
        out = {}
        for i, row in enumerate(rows):
            h = torch.zeros(hp.n_pred_layers, hp.n_pred_dim)
            res = TD.tdt_greedy_decode(loop, enc[i], enc.shape[1], h, h.clone(), max_out)
            # the loop's result arrays are views of its state on the CPU
            out[row] = {"enc": _np(enc[i]), "tokens": np.array(res[0][:res[6]])}
    return {"rows": out, "heads_local": params["layers"]["pos_bias_u"].shape[1],
            "foreign": foreign()}


def multihost_transcribe(path: str, samples: np.ndarray) -> Dict[str, Any]:
    """`transcribe_multihost` of `samples` on the model file at `path`
    (the CPU), after a `make_global_mesh` over every rank."""
    import whisper_tpu_torch as W
    from whisper_tpu_torch.parallel.multihost import make_global_mesh, transcribe_multihost

    mesh = make_global_mesh(n_tp=1)
    ctx = W.load(path, device="cpu")
    p = W.TranscribeParams(language="en", print_progress=False, temperature_inc=0.0)
    segs = transcribe_multihost(ctx, p, samples)
    return {"segs": [(s.t0, s.t1, s.text, [t.id for t in s.tokens]) for s in segs],
            "mesh": tuple(mesh.shape), "windows": ctx.timings.n_encode,
            "foreign": foreign()}


def _leaves_np(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in tree for k2, v2 in _leaves_np(tree[k], f"{prefix}.{k}").items()}
    return {prefix: tree.detach().numpy().copy()}


def opt_dp(x: np.ndarray, y: np.ndarray, init: Dict[str, np.ndarray],
           labels: np.ndarray, model_path: str, samples) -> Dict[str, Any]:
    """OptContext(mesh=) on 4 ranks: the toy regression over 3 AdamW steps
    at dp 4 (a 4 x 1 mesh) and dp 2 (2 x 2: the two ranks of a tp group
    hold the same rows); an eval with a Result on one-hot labels at dp 2;
    an uneven batch's error; one `finetune` step at dp 2."""
    from whisper_tpu_torch.models.whisper.load import load_model
    from whisper_tpu_torch.training import finetune as TF
    from whisper_tpu_torch.training import opt as TO

    def linear(p, a):
        return a @ p["w"] + p["b"]

    meshes = {"dp4": PM.make_mesh(4, 1), "dp2": PM.make_mesh(2, 2)}
    out: Dict[str, Any] = {}
    for name, mesh in meshes.items():
        ctx = TO.OptContext(linear, init, loss_type=TO.LOSS_MEAN_SQUARED_ERROR,
                            optimizer="adamw", mesh=mesh, device="cpu")
        losses = [ctx.step(x, y) for _ in range(3)]
        out[name] = {"losses": losses, **_leaves_np(ctx.params)}
    ce = TO.OptContext(linear, init, loss_type=TO.LOSS_CROSS_ENTROPY, mesh=meshes["dp2"],
                       device="cpu")
    res = TO.Result()
    out["eval"] = {"loss": ce.eval(x, labels, res), "accuracy": res.accuracy(),
                   "pred": res.pred(), "ndata": res.ndata}
    try:
        ce.step(x[:5], labels[:5])
    except ValueError as e:
        out["uneven"] = str(e)
    params, losses = TF.finetune(load_model(model_path), samples, steps=1, batch_size=2,
                                 lr=1e-3, optimizer="adamw", mesh=meshes["dp2"],
                                 device="cpu")
    out["finetune"] = {"losses": losses, **_leaves_np(params)}
    out["foreign"] = foreign()
    return out


def _plant(mod, fn, old: str, new: str):
    """`fn` of module `mod` recompiled with `old` in its source replaced by
    `new` (once), for a planted fault in this rank only."""
    import inspect
    import textwrap

    src = textwrap.dedent(inspect.getsource(fn))
    assert src.count(old) == 1, (fn.__name__, old)
    ns: Dict[str, Any] = {}
    exec(compile(src.replace(old, new), f"<planted {fn.__name__}>", "exec"), mod.__dict__, ns)
    return ns[fn.__name__]


def planted_faults(path: str, pcm: np.ndarray) -> Dict[str, Any]:
    """chip_smoke.py phase 12b's and 12e's readings on the card at full
    width (the turbo file at `path`, dense bf16 for tp=2, f32 for dp=2
    fine-tuning), sound and under planted faults: the q8 self-KV cache's
    amax taken on the rank's own heads; the decoder's and the encoder's
    attention-output bias added on every rank before the reduce; the
    gradients not all-reduced."""
    import chip_smoke as CS

    from whisper_tpu_torch.decoding import graphs as G
    from whisper_tpu_torch.models.whisper import model as M
    from whisper_tpu_torch.models.whisper.load import load_model
    from whisper_tpu_torch.runtime.context import WhisperContext
    from whisper_tpu_torch.training import opt as TO

    wm = load_model(path)
    ctx = WhisperContext(wm, use_packed_weights=False)
    hp, bf16 = ctx.hp, torch.bfloat16
    mesh = PM.make_mesh(1, 2)
    tp = PM.axis_group(mesh, "tp")
    local = PS.shard_params(ctx.params, mesh, hp)
    mel, prompt, *_ = CS._window_args(ctx, pcm[:16000 * 30])
    r, k = PM.group_rank(tp), hp.n_text_head // 2

    def readings() -> Dict[str, Any]:
        with G.DEVICE_LOCK:
            enc_tp = M.encode(local, mel, hp, dtype=bf16, tp=tp)
            enc_1 = M.encode(ctx.params, mel, hp, dtype=bf16)
            out: Dict[str, Any] = {"enc_rel": CS._rel(enc_tp, enc_1)}
            for itype in ("f16", "q8"):
                xk_tp, xv_tp = M.compute_cross_kv(local, enc_tp, hp, dtype=bf16, itype=itype,
                                                  tp=tp)
                xk_1, xv_1 = M.compute_cross_kv(ctx.params, enc_1, hp, dtype=bf16, itype=itype)
                lg_tp, tok_tp, kv_tp = CS._decode_chain(M, local, xk_tp, xv_tp, prompt, hp,
                                                        itype, tp)
                lg_1, tok_1, kv_1 = CS._decode_chain(M, ctx.params, xk_1, xv_1, prompt, hp,
                                                     itype, None)
                out[itype] = {"logits_rel": CS._rel(lg_tp, lg_1), "tokens_equal": tok_tp == tok_1}
                if itype == "q8":
                    out["kv8"] = CS._q8_against(kv_tp.kv, kv_tp.scale,
                                                kv_1.kv[:, :, r * k:(r + 1) * k], kv_1.scale)
        return out

    res: Dict[str, Any] = {"sound": readings()}
    faults = {
        "local_q8_amax": (M, "_quantize_rows", "all_reduce_max(x32.abs().amax(-1), tp)",
                          "x32.abs().amax(-1)"),
        "dec_bias_before_reduce": (M, "_row_parallel",
                                   "all_reduce_sum(_mm(h, w, dtype), tp) + bias + res",
                                   "all_reduce_sum(_mm(h, w, dtype) + bias, tp) + res"),
        "enc_o_bias_before_reduce": (
            M, "_encoder_block",
            'all_reduce_sum(_mm(merged, blk["o_w"], dtype), tp) + blk["o_b"]',
            'all_reduce_sum(_mm(merged, blk["o_w"], dtype) + blk["o_b"], tp)'),
    }
    for name, (mod, fn, old, new) in faults.items():
        sound = getattr(mod, fn)
        setattr(mod, fn, _plant(mod, sound, old, new))
        try:
            res[name] = readings()
        finally:
            setattr(mod, fn, sound)
    del ctx, local
    torch.cuda.empty_cache()
    sound = TO.OptContext.step
    TO.OptContext.step = _plant(TO, sound, "all_reduce_sum(g, self.dp)", "g")
    CS.DP_FT_REL = CS.DP_FT_STEP_REL = float("inf")   # read, not held, here
    try:
        res["grads_not_reduced"] = CS._dp_finetune(wm, pcm)
    finally:
        TO.OptContext.step = sound
    return res


def collectives(layers: int, state: int, heads: int, beams: int) -> Dict[str, Any]:
    """tests/test_torch_collectives.py on 2 ranks: parallel/mesh.py's two
    all-reduces on a one-rank group (a (2, 1) mesh's tp axis) and on both
    ranks, and the collective audit's decode step (parallel/
    collective_audit.py) at tp = 1 and tp = 2 with float and q8 caches,
    with the one-rank step's logits against tp=None's."""
    from whisper_tpu_torch.parallel import collective_audit as CA

    out: Dict[str, Any] = {}
    solo = PM.make_mesh(2, 1)
    pair = PM.make_mesh(1, 2)
    g = torch.Generator().manual_seed(dist.get_rank())
    for name, group in (("one_rank", PM.axis_group(solo, "tp")),
                        ("two_ranks", PM.axis_group(pair, "tp"))):
        x = torch.randn(4, 5, generator=g)
        x0, y = x.clone(), x.clone()
        with CA.recorded_all_reduces() as calls:
            s = PM.all_reduce_sum(x, group)
            m = PM.all_reduce_max(y, group)
        out[name] = {"calls": [c[0] for c in calls], "in": x0.numpy(), "sum": s.numpy(),
                     "max": m.numpy(), "group_size": PM.group_size(group)}
    hp = CA.audit_hparams(layers, state, heads)
    _, ref = CA.step_collectives(hp, None, beams)
    for itype in ("f16", "q8"):
        calls1, lg1 = CA.step_collectives(hp, solo, beams, itype)
        out[f"tp1_{itype}"] = calls1
        out[f"tp2_{itype}"] = CA.step_collectives(hp, pair, beams, itype)[0]
        if itype == "f16":
            out["tp1_equal_none"] = bool(torch.equal(lg1, ref))
    out["foreign"] = foreign()
    return out
