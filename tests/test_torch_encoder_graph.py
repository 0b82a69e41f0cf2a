"""The encoder as one CUDA graph (models/whisper/model.py `EncoderGraph`,
runtime/context.py `encode_window`).

On the CPU: where the graph engages (`encoder_graph_key`: on the card at
the model's own context, outside the parity mode, imatrix capture weights
and tp, keyed on the attention route), and the context's routing with a
stub in place of `CountedGraph` that runs the captured pass op by op at
each replay, so the plumbing around it is seen without a card: one graph
shared with the clones, one `M.encode` call a window returning that
window's output (as the benchmark's probe wraps it), the counter
`n_encode_graph` and the `encode` span's `graph` attribute.

On the card (marked `gpu`): at large-v3-turbo widths with random bf16
weights, the replayed encoder's output and the cross K/V computed from it
are bit-equal to the eager ones over mels in turns (A, B, A), K4 launches
as often per replay as per eager encode, and a graph holds no device
memory beyond its static input and output, its capture plus 10 replays
peaking no higher than an eager encode with that input beside it."""

import numpy as np
import pytest
import torch

import whisper_tpu_torch as W
from whisper_tpu_torch.decoding.graphs import DEVICE_LOCK
from whisper_tpu_torch.models.whisper import model as M
from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
from whisper_tpu_torch.ops import attention as FA
from whisper_tpu_torch.ops import enc_attn as EA
from whisper_tpu_torch.runtime import trace
from whisper_tpu_torch.utils.synth import write_synth_model

HP = WhisperHParams(n_vocab=51865, n_audio_ctx=1500, n_audio_state=64,
                    n_audio_head=2, n_audio_layer=1, n_text_ctx=448,
                    n_text_state=64, n_text_head=2, n_text_layer=3, n_mels=80)
CUDA = torch.device("cuda")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_spans():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("encoder_graph") / "decisive-q5_0.bin")
    write_synth_model(path, HP, seed=4, qtype="q5_0", decisive=True)
    return path


def _ctx(model, **kw):
    """A CPU context with 35 s of seeded audio's mel set: windows at 0, 3000."""
    ctx = W.load(model, device="cpu", **kw)
    ctx.pcm_to_mel((0.1 * np.random.default_rng(5).standard_normal(16000 * 35))
                   .astype(np.float32))
    return ctx


def _window(ctx, seek, n_ctx=HP.n_audio_ctx):
    w = np.zeros((HP.n_mels, 2 * n_ctx), np.float32)
    i1 = min(seek + 2 * n_ctx, ctx.n_len)
    w[:, : i1 - seek] = ctx.mel[:, seek:i1]
    return torch.from_numpy(w)


def _eager(ctx, seek, n_ctx=HP.n_audio_ctx):
    return M._encode(ctx.params, _window(ctx, seek, n_ctx), ctx.hp, ctx.compute_dtype,
                     parity=ctx.parity)


class _Collector:
    def add(self, names, x):
        pass


@pytest.fixture
def graphs(monkeypatch):
    """`CountedGraph` replaced by a stub that runs the captured pass op by
    op (its warm-up and capture at build, once more at each replay); the
    stubs built are listed in the list returned."""
    built = []

    class Stub:
        def __init__(self, fn, pool):
            assert pool is None           # a pool of its own
            fn()
            fn()
            self.fn, self.replays = fn, 0
            built.append(self)

        def replay(self):
            self.fn()
            self.replays += 1

    monkeypatch.setattr(M, "CountedGraph", Stub)
    return built


@pytest.fixture
def on_card(monkeypatch, graphs):
    """`encoder_graph_key` answering as it would for a context on the card."""
    key = M.encoder_graph_key
    monkeypatch.setattr(M, "encoder_graph_key",
                        lambda p, hp, n_ctx, dtype, device, *a, **k:
                        key(p, hp, n_ctx, dtype, CUDA, *a, **k))
    return graphs


@pytest.fixture
def calls(monkeypatch):
    """`M.encode` wrapped as the benchmark's probe wraps it: each call's
    `graph` argument and a copy of its output."""
    seen = []
    orig = M.encode

    def encode(*a, **k):
        out = orig(*a, **k)
        seen.append((k.get("graph"), out.detach().clone()))
        return out

    monkeypatch.setattr(M, "encode", encode)
    return seen


# -- where the graph engages --------------------------------------------------

def _set_up_case(case, ctx):
    """The key's arguments for `case` changed from an encode it would graph."""
    args = dict(params=ctx.params, hp=ctx.hp, n_ctx=HP.n_audio_ctx,
                dtype=ctx.compute_dtype, device=CUDA, parity=False, tp=None)
    if case == "cpu":
        args["device"] = torch.device("cpu")
    elif case == "parity":
        args["parity"] = True
    elif case == "captured":
        blocks = ctx.params["enc"]["blocks"]
        blocks["qkv_w"] = M.CapturedWeight([["encoder.blocks.0.attn.query.weight"]],
                                           blocks["qkv_w"], _Collector())
    elif case == "tp":
        args["tp"] = object()
    elif case == "audio_ctx":
        args["n_ctx"] = 768
    return args


@pytest.mark.parametrize("case", ["cpu", "parity", "captured", "tp", "audio_ctx"])
def test_key_says_eager(model, case):
    ctx = W.load(model, device="cpu")
    base = dict(params=ctx.params, hp=ctx.hp, n_ctx=HP.n_audio_ctx,
                dtype=ctx.compute_dtype, device=CUDA)
    assert M.encoder_graph_key(**base) == (HP.n_audio_ctx, "plain")
    assert M.encoder_graph_key(**_set_up_case(case, ctx)) is None


def test_key_follows_the_attention_route(model, monkeypatch):
    # heads of 64 at bf16: K4 ("qkv") over the 1536-row stream; WTPU_ENC_ATTN
    # =flash takes K6's graph, -nfa (flash off, xla) the plain unpadded one
    ctx = W.load(model, device="cpu")
    hp = WhisperHParams(**{**vars(HP), "n_audio_state": 128})
    key = lambda: M.encoder_graph_key(ctx.params, hp, 1500, torch.bfloat16, CUDA)
    monkeypatch.delenv("WTPU_ENC_ATTN", raising=False)
    assert key() == (1536, "qkv")
    monkeypatch.setenv("WTPU_ENC_ATTN", "flash")
    assert key() == (1536, "flash")
    monkeypatch.setenv("WTPU_ENC_ATTN", "xla")
    FA.set_flash_enabled(False)
    try:
        assert key() == (1500, "plain")
    finally:
        FA.set_flash_enabled(True)


@pytest.mark.parametrize("case", ["cpu", "parity", "captured", "audio_ctx"])
def test_encode_window_stays_eager(model, monkeypatch, graphs, calls, case):
    if case != "cpu":
        key = M.encoder_graph_key
        monkeypatch.setattr(M, "encoder_graph_key",
                            lambda p, hp, n_ctx, dtype, device, *a, **k:
                            key(p, hp, n_ctx, dtype, CUDA, *a, **k))
    ctx = _ctx(model, precision="ggml_cpu_f16" if case == "parity" else None)
    _set_up_case(case, ctx)
    n_ctx = 768 if case == "audio_ctx" else HP.n_audio_ctx
    ctx.encode_window(0, n_ctx if case == "audio_ctx" else 0)
    assert graphs == [] and ctx._encoder_graphs == {}
    assert len(calls) == 1 and calls[0][0] is None
    assert torch.equal(calls[0][1], _eager(ctx, 0, n_ctx))
    assert (ctx.timings.n_encode, ctx.timings.n_encode_graph) == (1, 0)


# -- the graph's plumbing -------------------------------------------------------

def test_one_encode_call_a_window_and_one_graph_for_the_clones(model, on_card, calls):
    ctx = _ctx(model)
    sub = ctx.clone_state()
    sub.set_mel(ctx.mel, ctx.n_len_org)
    for c, seek in ((ctx, 0), (ctx, 3000), (sub, 0), (ctx, 0)):
        c.encode_window(seek)
        # the window's own output, and the cross K/V computed from it
        graph, out = calls[-1]
        want = _eager(c, seek)
        assert graph is not None and torch.equal(out, want)
        xk, xv = M.compute_cross_kv(c.params, want, c.hp, dtype=c.compute_dtype)
        assert torch.equal(c.xk, xk) and torch.equal(c.xv, xv)
    assert len(calls) == 4
    assert len(on_card) == 1 and on_card[0].replays == 4
    assert sub._encoder_graphs is ctx._encoder_graphs
    assert list(ctx._encoder_graphs) == [(HP.n_audio_ctx, "plain")]
    assert not ctx._window_fns
    assert (ctx.timings.n_encode, ctx.timings.n_encode_graph) == (3, 3)
    assert (sub.timings.n_encode, sub.timings.n_encode_graph) == (1, 1)


@pytest.mark.parametrize("graphed", [True, False], ids=["graph", "eager"])
def test_counter_and_span_attribute(model, monkeypatch, graphs, graphed):
    if graphed:
        key = M.encoder_graph_key
        monkeypatch.setattr(M, "encoder_graph_key",
                            lambda p, hp, n_ctx, dtype, device, *a, **k:
                            key(p, hp, n_ctx, dtype, CUDA, *a, **k))
    ctx = _ctx(model)
    with trace.enable():
        ctx.encode_window(0)
        ctx.encode_window(3000)
        ctx.encode_window(0, 768)       # -ac: op by op, graphed or not
    spans = [s for s in trace.snapshot() if s.name == "encode"]
    assert [s.attrs for s in spans] == [{"graph": int(graphed)}] * 2 + [{"graph": 0}]
    assert ctx.timings.n_encode == 3
    assert ctx.timings.n_encode_graph == 2 * graphed
    assert len(graphs) == int(graphed)


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return CUDA


TURBO = WhisperHParams(n_vocab=51866, n_audio_ctx=1500, n_audio_state=1280,
                       n_audio_head=20, n_audio_layer=32, n_text_ctx=448,
                       n_text_state=1280, n_text_head=20, n_text_layer=4, n_mels=128)


def _random_params(hp, dev):
    """Encoder and cross K/V weights at `hp`'s widths: matmul weights bf16
    N(0, 1/fan_in), as the context stores them; biases and norms f32."""
    g = torch.Generator(device=dev).manual_seed(7)
    S, L, Lt, F = hp.n_audio_state, hp.n_audio_layer, hp.n_text_layer, 4 * hp.n_audio_state

    def w(*shape, fan_in):
        return (torch.randn(*shape, generator=g, device=dev) / fan_in ** 0.5).to(torch.bfloat16)

    def b(*shape, at=0.0):
        return at + 0.02 * torch.randn(*shape, generator=g, device=dev)

    blocks = {"attn_ln_w": b(L, S, at=1.0), "attn_ln_b": b(L, S),
              "qkv_w": w(L, S, 3 * S, fan_in=S), "qkv_b": b(L, 3 * S),
              "o_w": w(L, S, S, fan_in=S), "o_b": b(L, S),
              "mlp_ln_w": b(L, S, at=1.0), "mlp_ln_b": b(L, S),
              "mlp0_w": w(L, S, F, fan_in=S), "mlp0_b": b(L, F),
              "mlp1_w": w(L, F, S, fan_in=F), "mlp1_b": b(L, S)}
    enc = {"pos_embd": b(hp.n_audio_ctx, S), "conv1_w": w(S, hp.n_mels, 3, fan_in=3 * hp.n_mels),
           "conv1_b": b(S), "conv2_w": w(S, S, 3, fan_in=3 * S), "conv2_b": b(S),
           "ln_post_w": b(S, at=1.0), "ln_post_b": b(S), "blocks": blocks}
    dec = {"blocks": {"xk_w": w(Lt, S, S, fan_in=S), "xv_w": w(Lt, S, S, fan_in=S),
                      "xv_b": b(Lt, S)}}
    return {"enc": enc, "dec": dec}


def _mels(hp, dev):
    g = torch.Generator(device=dev).manual_seed(11)
    return [torch.randn(hp.n_mels, 2 * hp.n_audio_ctx, generator=g, device=dev)
            for _ in range(2)]


@pytest.mark.gpu
def test_graph_matches_eager_on_the_card(cuda, monkeypatch):
    monkeypatch.delenv("WTPU_ENC_ATTN", raising=False)
    hp, dt = TURBO, torch.bfloat16
    params, mels = _random_params(hp, cuda), _mels(TURBO, cuda)
    with DEVICE_LOCK:
        eager = []
        for mel in mels:
            n = EA.self_attention_qkv.launches
            enc = M.encode(params, mel, hp, dtype=dt)
            assert EA.self_attention_qkv.launches - n == hp.n_audio_layer
            eager.append((enc, *M.compute_cross_kv(params, enc, hp, dtype=dt)))
        assert torch.isfinite(eager[0][0]).all()
        assert not torch.equal(eager[0][0], eager[1][0])
        assert M.encoder_graph_key(params, hp, hp.n_audio_ctx, dt, cuda) == (1536, "qkv")
        graph = M.EncoderGraph(params, hp, dt, cuda)
        # bit-equal to eager, mels in turns so that a stale input or output
        # shows; K4 launches as often per replay as per eager encode
        for i in (0, 1, 0):
            n = EA.self_attention_qkv.launches
            out = M.encode(params, mels[i], hp, dtype=dt, graph=graph)
            assert EA.self_attention_qkv.launches - n == hp.n_audio_layer
            assert out.data_ptr() == graph.out.data_ptr()
            xk, xv = M.compute_cross_kv(params, out, hp, dtype=dt)
            torch.cuda.synchronize()
            assert torch.equal(out, eager[i][0])
            assert torch.equal(xk, eager[i][1]) and torch.equal(xv, eager[i][2])


@pytest.mark.gpu
def test_graph_holds_its_static_buffers_alone(cuda, monkeypatch):
    # The first capture makes the side stream's cuBLAS workspaces
    # (decoding/graphs.py _side_stream); a graph captured after it holds its
    # static input and output and nothing more, and its capture plus 10
    # replays peak no higher than an eager encode with that input beside it.
    monkeypatch.delenv("WTPU_ENC_ATTN", raising=False)
    hp, dt = TURBO, torch.bfloat16
    params, mels = _random_params(hp, cuda), _mels(TURBO, cuda)
    with DEVICE_LOCK:
        M.EncoderGraph(params, hp, dt, cuda)(mels[1])
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        M.encode(params, mels[0], hp, dtype=dt)
        torch.cuda.synchronize()
        eager_peak = torch.cuda.max_memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        graph = M.EncoderGraph(params, hp, dt, cuda)
        for i in range(10):
            M.encode(params, mels[i % 2], hp, dtype=dt, graph=graph)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        peak = torch.cuda.max_memory_allocated() - base
        # the allocator counts a buffer of over 1 MiB at its block, which it
        # leaves unsplit where the rest is under 1 MiB
        static = graph.mel.nbytes + graph.out.nbytes + 2 * 2 ** 20
        assert held <= static, (held, static)
        assert peak <= eager_peak + graph.mel.nbytes + 2 ** 20, (peak, eager_peak)
