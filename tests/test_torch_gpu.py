"""Card tests of the port: each Hopper kernel against its plain PyTorch
version on the same CUDA inputs (the decode matmul and decode attention
also at the rows of natively batched windows), the window loop's CUDA
graphs against its eager loop (one window, and W windows batched), the
batcher's concurrent requests against sequential ones, the slice on the
card against the slice on the CPU, and the steps before and after the
window loop (the VAD and the device mel against the CPU, K2 at a DTW
pass's rows, a VAD + DTW transcribe against the CPU's), and Parakeet-TDT
(the TDT loop's CUDA graphs against its eager loop bit for bit, the card's
f32 encoder within 1e-4 of max |enc| of the CPU's, its device mel within
1e-5 of max |mel| of numpy), and the tools of phase 10 (the imatrix
capture within 1e-4 of each tensor's largest sum of the CPU's, `ncalls`
equal; whisper-stream with -ac 768 printing what the CPU prints), and the C
ABI and fine-tuning (the C hosts and the library in process print what the
port's transcribe() gives on the card, K1 and K4 launched from C; 3 AdamW
steps' losses within rtol 1e-4 of the CPU's).  They need a CUDA
card and skip without one (run them on the card with
`python -m pytest tests/test_torch_gpu.py -m gpu`).

Tolerances: qmmt 1e-4 of max |y| (f32 sums in another order over K up to
5120; the kernel itself is bit-identical from call to call); self_attend_q8 f32 1e-5, bf16 2e-2 (one bf16 ulp on p * s_v);
self_attend_q8 f16 (the parity mode's q8 cache) 2.5e-3, about as many f16
ulps as bf16's bound is bf16 ulps; the parity mode's Q8_0 activation rows
bit-identical to the CPU's, its block-dot products within 2e-6 of max |y|
(exact integer dots, f32 sums over the blocks in another order);
self_attention_qkv 8e-3 of max |out| (the same rounding points, so only
the f32 sums' order differs, which can move an output's bf16 rounding by
one ulp, at most 2^-7 of the value); qmm 1e-4 of max |y| (the same
bf16-rounded operands, tensor-core f32 sums in another order over K up to
4096); both bit-identical from call to call; flash_self_attention 8e-3 of
max |out| over real rows (chip_smoke.FLASH_REL_TOL, one bf16 step of the
largest output: the online softmax rounds p to bf16 against a running
max), bit-identical from call to call and under a CUDA-graph replay.
"""

import numpy as np
import pytest
import torch

from whisper_tpu_torch.formats import quants as Q
from whisper_tpu_torch.ops import attention as FA
from whisper_tpu_torch.ops import decode_attn as DA
from whisper_tpu_torch.ops import enc_attn as EA
from whisper_tpu_torch.ops import qmm as QM

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _planes(qtype, k, r, seed, device):
    # installed as the main path installs them: rows pitched to 64 columns
    w = np.random.default_rng(seed).standard_normal((r, k)).astype(np.float32)
    p = Q.unpack_to_planes(Q.quantize(w, qtype), qtype, (r, k))
    tr = lambda a: None if a is None else a.T
    return QM.pitch_qweight_t(tr(p.codes), tr(p.scales), tr(p.mins), device=device)


# R not a multiple of the 64-column tile (51866, 100), K = 5120 over 20
# slices, T around the 8-row groups
@pytest.mark.parametrize("T,K,R", [(1, 1280, 3840), (5, 5120, 1280), (3, 256, 51866),
                                   (9, 128, 100), (1, 1280, 51866), (8, 5120, 100),
                                   (17, 1280, 1280)])
@pytest.mark.parametrize("qtype", [Q.GGML_TYPE_Q5_0, Q.GGML_TYPE_Q4_1])
def test_qmmt_fused_kernel(cuda, T, K, R, qtype, monkeypatch):
    rng = np.random.default_rng(0)
    codes, scales, mins = _planes(qtype, K, R, 1, cuda)
    assert codes.stride(0) % 64 == 0
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)
    x, lw, lb, b, res = t(T, K), t(K), t(K), t(R), t(T, R)
    for kw in (dict(ln_w=lw, ln_b=lb, bias=b), dict(bias=b, residual=res),
               dict(ln_w=lw, ln_b=lb, bias=b, act="gelu"), dict(ln_w=lw, ln_b=lb)):
        for dtype, min_t in ((torch.float32, QM.MMA_MIN_T), (torch.bfloat16, 1),
                             (torch.bfloat16, T + 1)):
            # bf16 on the tensor-core product and on the CUDA-core one
            monkeypatch.setattr(QM, "MMA_MIN_T", min_t)
            y = QM.qmmt_fused(x, codes, scales, mins, dtype=dtype, **kw)
            ref = QM.qmmt_fused_plain(x, codes, scales, mins, dtype=dtype, **kw)
            torch.cuda.synchronize()
            assert (y - ref).abs().max() <= 1e-4 * ref.abs().max()
    n = QM.qmmt.launches
    y = QM.qmmt(x, codes, scales, mins, dtype=torch.bfloat16)
    assert QM.qmmt.launches == n + 1
    ref = QM.qmmt_fused_plain(x, codes, scales, mins, dtype=torch.bfloat16)
    assert (y - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize("T,K,R", [(1, 5120, 1280), (5, 1280, 51866), (17, 1280, 3840)])
def test_qmmt_fused_kernel_deterministic(cuda, T, K, R):
    # the split-K fix-up sums the slices in order: two calls and a replay of
    # a captured CUDA graph give the same bits
    from chip_smoke import same_under_graph

    codes, scales, mins = _planes(Q.GGML_TYPE_Q4_1, K, R, 2, cuda)
    g = torch.Generator().manual_seed(5)
    x = torch.randn((T, K), generator=g).to(cuda)
    bias = torch.randn((R,), generator=g).to(cuda)
    assert same_under_graph(lambda: QM.qmmt_fused(x, codes, scales, mins, bias=bias,
                                                  act="gelu"))


def test_qmmt_kernel_refuses_unaligned_rows(cuda):
    codes, scales, _ = _planes(Q.GGML_TYPE_Q5_0, 128, 100, 3, cuda)
    x = torch.zeros((1, 128), device=cuda)
    with pytest.raises(ValueError, match="aligned rows"):
        QM.qmmt(x, codes.contiguous(), scales)


# A not a multiple of the cluster (100), G over a chunk of 16 query rows,
# B = 5 beam lanes; q is the strided f32 head view decode_step passes
@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("G,A", [(1, 100), (1, 448), (4, 256), (16, 384), (16, 100),
                                 (20, 100)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2),
                                       (torch.float16, 2.5e-3)])
def test_self_attend_q8_kernel(cuda, B, G, A, dtype, tol):
    L, H, C, D = 4, 20, 448, 64
    g = torch.Generator().manual_seed(0)
    kv = torch.randint(-127, 128, (L, B, H, 2, C, D), generator=g, dtype=torch.int8)
    scale = 0.01 + 0.02 * torch.rand((L, B, 2, C), generator=g)
    qkv = torch.randn((B, G, 3 * H * D), generator=g)
    vis = torch.arange(A)[None, :] < (A - G + torch.arange(G) + 1)[:, None]
    mask = torch.where(vis, 0.0, float("-inf")).expand(B, G, A).contiguous()
    kv, scale, qkv, mask = (a.to(cuda) for a in (kv, scale, qkv, mask))
    q = qkv[..., :H * D].reshape(B, G, H, D).transpose(1, 2)
    for l in (0, L - 1):
        n = DA.self_attend_q8.launches
        out = DA.self_attend_q8(kv, scale, q, mask, l=l, attn_ctx=A, dtype=dtype)
        assert DA.self_attend_q8.launches == n + 1
        ref = DA.self_attend_q8_plain(kv, scale, q, mask, l=l, attn_ctx=A, dtype=dtype)
        torch.cuda.synchronize()
        assert (out - ref).abs().max() <= tol * ref.abs().max()
        again = DA.self_attend_q8(kv, scale, q, mask, l=l, attn_ctx=A, dtype=dtype)
        assert torch.equal(out, again)


# T = 208 is a multiple of 16 but not of the 64-row query block; true_len
# 17 and 1 leave most key tiles past the real columns
@pytest.mark.parametrize("T", [512, 1536, 208])
@pytest.mark.parametrize("cut", ["T", "T-36", "17", "1"])
@pytest.mark.parametrize("n_head,d", [(20, 64), (2, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_self_attention_qkv_kernel(cuda, T, cut, n_head, d, dtype):
    true_len = {"T": T, "T-36": T - 36, "17": 17, "1": 1}[cut]
    g = torch.Generator().manual_seed(1)
    qkv = torch.randn((T, 3 * n_head * d), generator=g).to(cuda, dtype)
    n = EA.self_attention_qkv.launches
    out = EA.self_attention_qkv(qkv, n_head, true_len=true_len)
    assert EA.self_attention_qkv.launches == n + 1
    ref = EA.self_attention_qkv_plain(qkv, n_head, true_len=true_len)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (T, n_head * d)
    assert (out.float() - ref.float()).abs().max() <= 8e-3 * ref.float().abs().max()
    assert torch.equal(out, EA.self_attention_qkv(qkv, n_head, true_len=true_len))


# K = 1040 is not a multiple of the 64-deep stage; T and R not multiples of
# the 256 x 128 tile
@pytest.mark.parametrize("T,K,R,qk", [(4096, 4096, 4096, 32), (37, 256, 300, 16),
                                      (1, 1280, 51866, 32), (130, 512, 129, 16),
                                      (70, 1040, 200, 16)])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_qmm_kernel(cuda, T, K, R, qk, x_dtype):
    g = torch.Generator().manual_seed(2)
    x = torch.randn((T, K), generator=g).to(cuda, x_dtype)
    codes = torch.randint(-16, 16, (R, K), generator=g, dtype=torch.int8).to(cuda)
    scales = (0.02 * torch.rand((R, K // qk), generator=g)).to(cuda)
    n = QM.qmm.launches
    y = QM.qmm(x, codes, scales)
    assert QM.qmm.launches == n + 1
    ref = QM.qmm_plain(x, codes, scales)
    torch.cuda.synchronize()
    assert y.dtype == torch.float32 and tuple(y.shape) == (T, R)
    assert (y - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert torch.equal(y, QM.qmm(x, codes, scales))


# 128-row query blocks of two warpgroups over 64-key tiles: lengths that are
# not multiples of either (1500, 129, 65, 700), true_len of 1 and below T.
# Heads of 32 and 16 (the parity matrix's mini and multilingual minis) take
# the mma.sync kernel of the same source: 64-row blocks in clusters that
# split the key tiles and merge at the end; T not a multiple of 64 (100,
# 129, 700), true_len on a 64-key tile boundary (256, 128), one tile and
# empty key ranges (48, 64), one head, and clusters of 4 (most shapes), 2
# (6 x 1536) and 1 (12 x 1536)
@pytest.mark.parametrize("H,T,true_len,D", [(20, 1536, 1500, 64), (2, 700, 650, 128),
                                            (3, 100, 100, 64), (20, 1500, 1500, 64),
                                            (2, 129, 100, 64), (1, 65, 1, 64),
                                            (2, 1536, 1500, 32), (6, 1536, 1500, 16),
                                            (2, 129, 100, 32), (6, 700, 650, 16),
                                            (1, 65, 1, 16), (1, 100, 77, 32),
                                            (2, 300, 256, 32), (3, 200, 128, 16),
                                            (1, 1536, 1500, 32), (1, 48, 48, 16),
                                            (2, 64, 64, 32), (3, 2000, 1999, 16),
                                            (12, 1536, 1500, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_self_attention_kernel(cuda, H, T, true_len, D, dtype):
    from chip_smoke import FLASH_REL_TOL, same_under_graph

    g = torch.Generator().manual_seed(3)
    qkv = torch.randn((T, 3 * H * D), generator=g).to(cuda, dtype)
    S = H * D
    # strided head views of the fused buffer, as the encoder passes them
    q, k, v = (qkv[:, i * S:(i + 1) * S].reshape(T, H, D).transpose(0, 1)
               for i in range(3))
    n = FA.flash_self_attention.launches
    out = FA.flash_self_attention(q, k, v, true_len=true_len)
    assert FA.flash_self_attention.launches == n + 1
    ref = FA.flash_self_attention_plain(q, k, v, true_len=true_len)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and tuple(out.shape) == (H, T, D)
    assert torch.isfinite(out).all()
    # one bf16 step of the largest real output (the kernel rounds it to bf16)
    tol = FLASH_REL_TOL * ref[:, :true_len].abs().max()
    assert (out[:, :true_len] - ref[:, :true_len]).abs().max() <= tol
    # no atomics: two calls and a CUDA-graph replay give the same bits
    assert same_under_graph(lambda: FA.flash_self_attention(q, k, v, true_len=true_len))


_DECISIVE = {}


def _decisive_ctx(tmp_path_factory, kv_itype, **kw):
    """A card context on a small decisive model with 35 s of seeded audio's
    mel set (two windows); `kw` go to load()."""
    import whisper_tpu_torch as W
    from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
    from whisper_tpu_torch.utils.synth import write_synth_model

    if "path" not in _DECISIVE:
        hp = WhisperHParams(n_vocab=51865, n_audio_ctx=1500, n_audio_state=128,
                            n_audio_head=2, n_audio_layer=2, n_text_ctx=448,
                            n_text_state=128, n_text_head=2, n_text_layer=3, n_mels=80)
        path = str(tmp_path_factory.mktemp("window") / "decisive-q5_0.bin")
        write_synth_model(path, hp, seed=1, qtype="q5_0", decisive=True)
        _DECISIVE["path"] = path
    ctx = W.load(_DECISIVE["path"], kv_itype=kv_itype, **kw)
    ctx.pcm_to_mel((0.1 * np.random.default_rng(5).standard_normal(16000 * 35))
                   .astype(np.float32))
    return ctx


@pytest.mark.parametrize("kv_itype", ["q8", "f16"])
@pytest.mark.parametrize("strategy", ["greedy", "beam"])
def test_window_graphs_match_eager(cuda, tmp_path_factory, strategy, kv_itype):
    # two consecutive windows, each with its own cross-K/V: the graphs give
    # the eager loop's WindowResult bit for bit and its kernel launches
    from chip_smoke import graph_matches_eager
    from whisper_tpu_torch.decoding.graphs import COUNTED

    ctx = _decisive_ctx(tmp_path_factory, kv_itype)
    graph_matches_eager(ctx, COUNTED, strategy, seeks=(0, 3000),
                        n_lanes=5 if strategy == "beam" else 1)


def test_window_graphs_sample_at_t_above_0(cuda, tmp_path_factory):
    # five sampling lanes at t = 0.7: the same rng_seed gives the same tokens
    # twice, and the graphs draw what the eager loop draws
    from chip_smoke import graph_matches_eager
    from whisper_tpu_torch.decoding.graphs import COUNTED

    ctx = _decisive_ctx(tmp_path_factory, "q8")
    graph_matches_eager(ctx, COUNTED, "greedy", seeks=(0, 3000), temperature=0.7,
                        n_lanes=5)


@pytest.mark.parametrize("kv_itype", ["f16", "q8"])
@pytest.mark.parametrize("strategy", ["greedy", "beam"])
def test_parity_window_graphs_match_eager(cuda, tmp_path_factory, strategy, kv_itype):
    # the parity mode's window decoder (an f16 cache, f16 products inside
    # full_f32): graphs == eager bit for bit, and no kernel but K3 (q8)
    from chip_smoke import graph_matches_eager
    from whisper_tpu_torch.decoding.graphs import COUNTED

    ctx = _decisive_ctx(tmp_path_factory, kv_itype, precision="ggml_cpu_f16")
    graph_matches_eager(ctx, COUNTED, strategy, seeks=(0, 3000),
                        n_lanes=5 if strategy == "beam" else 1)


def _half_way_rows(n, k, seed):
    """Rows whose Q8_0 codes sit on .5: blocks with amax 127 (d = 1) or
    63.5 (d = 0.5) whose other values are (j + 0.5) * d; and plain rows."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        d = (1.0, 0.5, None)[i % 3]
        if d is None:
            rows.append(rng.standard_normal(k) * 4)
            continue
        x = (rng.integers(-126, 126, k) + 0.5) * d
        x[::32] = 127.0 * d
        rows.append(x)
    return torch.from_numpy(np.stack(rows).astype(np.float32))


@pytest.mark.parametrize("rows,K,R", [(1, 1280, 51866), (5, 1280, 3840), (1500, 1280, 5120),
                                      (1500, 5120, 1280)])
def test_mm_ggml_q_card_matches_cpu(cuda, rows, K, R):
    from whisper_tpu_torch.decoding.graphs import DEVICE_LOCK, full_f32
    from whisper_tpu_torch.models.whisper import model as M

    x = _half_way_rows(rows, K, rows)
    w = np.random.default_rng(K).standard_normal((R, K)).astype(np.float32)
    p = Q.unpack_to_planes(Q.quantize(w, Q.GGML_TYPE_Q5_0), Q.GGML_TYPE_Q5_0, (R, K))
    wq = M.QWGGML(torch.from_numpy(p.codes.astype(np.float32)), torch.from_numpy(p.scales))
    wd = M.QWGGML(*(a.to(cuda) for a in wq))
    with DEVICE_LOCK, full_f32():
        q_card, d_card = M._q8_0_rows(x.to(cuda))
        y_card = M._mm_ggml_q(x.to(cuda), wd)
    q_cpu, d_cpu = M._q8_0_rows(x)
    assert torch.equal(q_card.cpu(), q_cpu) and torch.equal(d_card.cpu(), d_cpu)
    # rows 0, 3, ... have d = 1: their codes are roundf(x), which half-to-even
    # rounding misses on the half-way points
    half = x[::3].unflatten(-1, (-1, 32))
    assert not torch.equal(q_cpu[::3], torch.round(half))
    y_cpu = M._mm_ggml_q(x, wq)
    assert (y_card.cpu() - y_cpu).abs().max() <= 2e-6 * y_cpu.abs().max()


def test_parity_grammar_card_matches_cpu(cuda, tmp_path):
    # the check lives in chip_smoke.py (its phase 9); this runs it under pytest
    from chip_smoke import parity_grammar_card_matches_cpu
    from whisper_tpu_torch.decoding.graphs import COUNTED

    parity_grammar_card_matches_cpu(str(tmp_path), COUNTED)


def test_transcribe_card_matches_cpu(cuda, tmp_path):
    # the check lives in chip_smoke.py (its phase 5); this runs it under pytest
    from chip_smoke import card_matches_cpu

    card_matches_cpu(str(tmp_path))


# rows of natively batched steps: W x G for W up to 8 windows of 1 or 5
# lanes, and of the prompt passes of 4 windows, 4 x bucket (4, 32, 256), on
# the turbo decoder's shapes with the prologue and epilogue each has there:
# the layer norm on the 1280-wide rows (qkv with its bias, mlp0 with GELU,
# the logits head), the residual on mlp1's 5120-wide ones.  The layer
# norm's statistics are summed in f64 on both sides: summed in f32 in two
# orders, they rounded some normalised rows to bf16 one ulp apart, past
# this bound, from 128 rows of the logits head on.
@pytest.mark.parametrize("T", [2, 4, 8, 10, 16, 20, 40, 128, 1024])
@pytest.mark.parametrize("K,R,use", [(1280, 3840, "qkv"), (1280, 5120, "mlp0"),
                                     (5120, 1280, "mlp1"), (1280, 51866, "logits")])
def test_qmmt_fused_kernel_batched_rows(cuda, T, K, R, use):
    from chip_smoke import same_under_graph

    codes, scales, mins = _planes(Q.GGML_TYPE_Q5_0, K, R, 4, cuda)
    g = torch.Generator().manual_seed(T)
    x, lw, lb, b, res = (torch.randn(s, generator=g).to(cuda)
                         for s in ((T, K), (K,), (K,), (R,), (T, R)))
    kw = {"qkv": dict(ln_w=lw, ln_b=lb, bias=b), "logits": dict(ln_w=lw, ln_b=lb),
          "mlp0": dict(ln_w=lw, ln_b=lb, bias=b, act="gelu"),
          "mlp1": dict(bias=b, residual=res)}[use]
    call = lambda: QM.qmmt_fused(x, codes, scales, mins, dtype=torch.bfloat16, **kw)
    n = QM.qmmt_fused.launches
    y = call()
    assert QM.qmmt_fused.launches == n + 1
    ref = QM.qmmt_fused_plain(x, codes, scales, mins, dtype=torch.bfloat16, **kw)
    torch.cuda.synchronize()
    assert (y - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert same_under_graph(call)


# K1/K2's many-row route (csrc/qmmt.cu qmmt_rows_kernel) on the turbo
# decoder's uses, forced at 1-8 rows (QM.MMA_MIN_T = 1) and taken by the
# wrapper above: batched steps (16, 20), DTW passes and prompt buckets (32,
# 128, 224) and a batched prompt pass (1024, its row groups and resident
# converted codes); the logits head's ragged last tile (R = 51866), mlp1's
# K = 5120.  Within 1e-4 of max |y| of the plain version, launched through
# the route, bit-identical over two calls and a CUDA-graph replay.
@pytest.mark.parametrize("T", [1, 2, 3, 4, 5, 6, 7, 8, 16, 20, 32, 128, 224, 1024])
@pytest.mark.parametrize("K,R,use", [(1280, 3840, "qkv"), (1280, 5120, "mlp0"),
                                     (5120, 1280, "mlp1"), (1280, 51866, "logits")])
def test_qmmt_rows_route(cuda, T, K, R, use, monkeypatch):
    from chip_smoke import same_under_graph

    monkeypatch.setattr(QM, "MMA_MIN_T", 1)
    codes, scales, mins = _planes(Q.GGML_TYPE_Q5_0, K, R, 6, cuda)
    g = torch.Generator().manual_seed(T)
    x, lw, lb, b, res = (torch.randn(s, generator=g).to(cuda)
                         for s in ((T, K), (K,), (K,), (R,), (T, R)))
    kw = {"qkv": dict(ln_w=lw, ln_b=lb, bias=b), "logits": dict(ln_w=lw, ln_b=lb),
          "mlp0": dict(ln_w=lw, ln_b=lb, bias=b, act="gelu"),
          "mlp1": dict(bias=b, residual=res)}[use]
    call = lambda: QM.qmmt_fused(x, codes, scales, mins, dtype=torch.bfloat16, **kw)
    n = QM.qmmt_rows.launches
    y = call()
    assert QM.qmmt_rows.launches == n + 1
    ref = QM.qmmt_fused_plain(x, codes, scales, mins, dtype=torch.bfloat16, **kw)
    torch.cuda.synchronize()
    assert (y - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert same_under_graph(call)
    if use == "mlp1":
        # K2, the bare product, through the same route
        y2 = QM.qmmt(x, codes, scales, mins, dtype=torch.bfloat16)
        ref2 = QM.qmmt_fused_plain(x, codes, scales, mins, dtype=torch.bfloat16)
        assert (y2 - ref2).abs().max() <= 1e-4 * ref2.abs().max()


def _planes_qk16(k, r, seed, device, affine):
    # qk = 16 planes (NVFP4's block size), codes as a 5-bit format's
    rng = np.random.default_rng(seed)
    codes = rng.integers(-16, 16, (k, r)).astype(np.int8)
    scales = (0.01 + 0.02 * rng.random((k // 16, r))).astype(np.float32)
    mins = (0.05 * rng.standard_normal((k // 16, r))).astype(np.float32) if affine else None
    return QM.pitch_qweight_t(codes, scales, mins, device=device)


# the many-row route on affine planes (q4_1: mins and the rows' block sums)
# and on qk = 16 planes, symmetric and affine, with the layer norm, GELU
# and the residual
@pytest.mark.parametrize("T", [8, 20, 128, 224])
@pytest.mark.parametrize("planes", ["q4_1", "qk16", "qk16_affine"])
def test_qmmt_rows_route_planes(cuda, T, planes, monkeypatch):
    from chip_smoke import same_under_graph

    K, R = 1280, 1280
    if planes == "q4_1":
        codes, scales, mins = _planes(Q.GGML_TYPE_Q4_1, K, R, 8, cuda)
    else:
        codes, scales, mins = _planes_qk16(K, R, 8, cuda, planes == "qk16_affine")
    g = torch.Generator().manual_seed(T)
    x, lw, lb, b, res = (torch.randn(s, generator=g).to(cuda)
                         for s in ((T, K), (K,), (K,), (R,), (T, R)))
    for kw in (dict(ln_w=lw, ln_b=lb, bias=b, act="gelu"), dict(bias=b, residual=res)):
        call = lambda: QM.qmmt_fused(x, codes, scales, mins, dtype=torch.bfloat16, **kw)
        n = QM.qmmt_rows.launches
        y = call()
        assert QM.qmmt_rows.launches == n + 1
        ref = QM.qmmt_fused_plain(x, codes, scales, mins, dtype=torch.bfloat16, **kw)
        torch.cuda.synchronize()
        assert (y - ref).abs().max() <= 1e-4 * ref.abs().max()
        assert same_under_graph(call)


# the bare product and mlp1's residual epilogue on both product routes
# (the many-row route, "mma", from QM.MMA_MIN_T rows, CUDA-core FMAs
# below) against an f64
# computation on the same bf16-rounded operands, at 5 to 64 rows
@pytest.mark.parametrize("T", [5, 8, 16, 20, 32, 33, 40, 48, 64])
@pytest.mark.parametrize("route", ["mma", "fma"])
def test_qmmt_fused_product_near_f64(cuda, T, route, monkeypatch):
    K, R = 5120, 1280
    codes, scales, _ = _planes(Q.GGML_TYPE_Q5_0, K, R, 4, cuda)
    w64 = codes.double() * scales.double().repeat_interleave(32, 0)     # (K, R)
    g = torch.Generator().manual_seed(T)
    x, res, b = (torch.randn(s, generator=g).to(cuda) for s in ((T, K), (T, R), (R,)))
    exact = x.to(torch.bfloat16).double() @ w64 + b.double() + res.double()
    monkeypatch.setattr(QM, "MMA_MIN_T", QM.MMA_MIN_T if route == "mma" else 1 << 30)
    y = QM.qmmt_fused(x, codes, scales, bias=b, residual=res, dtype=torch.bfloat16)
    assert (y.double() - exact).abs().max() <= 1e-4 * exact.abs().max()


# K3 at the prompt pass of 4 natively batched windows: G = bucket query
# rows, A = the prompt's attention bucket, C = the native cache's cells,
# and the mask the prompt pass builds (causal, each row's left-pad cells
# hidden, a pad query seeing itself)
@pytest.mark.parametrize("G", [4, 32, 256])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_self_attend_q8_kernel_native_prompt(cuda, G, dtype, tol):
    from whisper_tpu_torch.decoding import device_loop as DL
    from whisper_tpu_torch.models.whisper import model as M

    B, L, H, D = 4, 4, 20, 64
    A = next(a for a in M.attn_ctx_buckets(448) if a >= G)
    C = max(448, G + 220)
    g = torch.Generator().manual_seed(G)
    kv = torch.randint(-127, 128, (L, B, H, 2, C, D), generator=g, dtype=torch.int8)
    scale = 0.01 + 0.02 * torch.rand((L, B, 2, C), generator=g)
    qkv = torch.randn((B, G, 3 * H * D), generator=g)
    lens = [1, G // 2 + 1, G - 1, G]
    kv, scale, qkv = (a.to(cuda) for a in (kv, scale, qkv))
    _, mask_prompt, _ = DL.prompt_pad_masks(G, C, lens, cuda)
    mask = M.decode_mask(0, G, A, cuda, mask_prompt)[:, 0].expand(B, G, A).contiguous()
    q = qkv[..., :H * D].reshape(B, G, H, D).transpose(1, 2)
    n = DA.self_attend_q8.launches
    out = DA.self_attend_q8(kv, scale, q, mask, l=L - 1, attn_ctx=A, dtype=dtype)
    assert DA.self_attend_q8.launches == n + 1
    ref = DA.self_attend_q8_plain(kv, scale, q, mask, l=L - 1, attn_ctx=A, dtype=dtype)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max() <= tol * ref.abs().max()


# B = W x G rows of natively batched windows, each with 0 to 7 left-pad
# cells masked; C = 476 is a native cache of 256 prompt cells + 220 steps
@pytest.mark.parametrize("B", [2, 10, 40])
@pytest.mark.parametrize("C,A", [(448, 128), (448, 448), (476, 476)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_self_attend_q8_kernel_pad_rows(cuda, B, C, A, dtype, tol):
    L, H, D = 4, 20, 64
    g = torch.Generator().manual_seed(B)
    kv = torch.randint(-127, 128, (L, B, H, 2, C, D), generator=g, dtype=torch.int8)
    scale = 0.01 + 0.02 * torch.rand((L, B, 2, C), generator=g)
    qkv = torch.randn((B, 1, 3 * H * D), generator=g)
    shift = torch.randint(0, 8, (B,), generator=g)
    cells = torch.arange(A)[None, None, :]
    mask = torch.where(cells >= shift[:, None, None], 0.0, float("-inf")).contiguous()
    kv, scale, qkv, mask = (a.to(cuda) for a in (kv, scale, qkv, mask))
    q = qkv[..., :H * D].reshape(B, 1, H, D).transpose(1, 2)
    out = DA.self_attend_q8(kv, scale, q, mask, l=L - 1, attn_ctx=A, dtype=dtype)
    ref = DA.self_attend_q8_plain(kv, scale, q, mask, l=L - 1, attn_ctx=A, dtype=dtype)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max() <= tol * ref.abs().max()
    assert torch.equal(out, DA.self_attend_q8(kv, scale, q, mask, l=L - 1, attn_ctx=A,
                                              dtype=dtype))


@pytest.mark.parametrize("kv_itype", ["q8", "f16"])
@pytest.mark.parametrize("strategy,n_windows,n_lanes", [
    ("greedy", 2, 1), ("greedy", 4, 1), ("beam", 2, 5)])
def test_native_window_graphs_match_eager(cuda, tmp_path_factory, strategy, n_windows,
                                         n_lanes, kv_itype):
    from chip_smoke import native_graph_matches_eager
    from whisper_tpu_torch.decoding.graphs import COUNTED

    ctx = _decisive_ctx(tmp_path_factory, kv_itype)
    native_graph_matches_eager(ctx, COUNTED, strategy, n_windows, n_lanes)


def test_native_window_graphs_sample_at_t_above_0(cuda, tmp_path_factory):
    from chip_smoke import native_graph_matches_eager
    from whisper_tpu_torch.decoding.graphs import COUNTED

    ctx = _decisive_ctx(tmp_path_factory, "q8")
    native_graph_matches_eager(ctx, COUNTED, "greedy", 2, 3, temperature=0.7)


def test_joining_threads_match_sequential_calls(cuda, tmp_path_factory):
    # 4 threads transcribing 4 clips through one batcher give the segments
    # 4 calls one after another give; some rounds batch several windows
    import threading

    import whisper_tpu_torch as W
    from whisper_tpu_torch.runtime.batching import WindowBatcher, transcribe_joining

    ctx = _decisive_ctx(tmp_path_factory, "q8")
    clips = [(0.1 * np.random.default_rng(20 + i).standard_normal(16000 * 35))
             .astype(np.float32) for i in range(4)]
    params = W.TranscribeParams()
    batcher = WindowBatcher(ctx, 0, max_wait_s=2.0)
    got, errors = [None] * 4, []

    def run(i):
        try:
            got[i] = transcribe_joining(ctx, params, clips[i], batcher)[0]
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert batcher.n_coalesced_rounds >= 1 and batcher.max_round_size >= 2
    for i, clip in enumerate(clips):
        want = transcribe_joining(ctx, params, clip, WindowBatcher(ctx, 0))[0]
        assert [(s.t0, s.t1, s.text) for s in got[i]] == \
            [(s.t0, s.t1, s.text) for s in want], i
        assert len(want) >= 2


# the steps before and after the window loop: the VAD, the device mel, and
# the DTW pass's bare matmul (K2) at a window's token counts

@pytest.fixture(scope="module")
def vad_file(tmp_path_factory):
    from whisper_tpu_torch.models.vad.writer import synth_vad_tensors, write_vad_model

    path = str(tmp_path_factory.mktemp("vad") / "silero-synth.bin")
    write_vad_model(path, synth_vad_tensors(seed=0))
    return path


def _vad_clip(seconds=40.0):
    from chip_smoke import vad_clip

    return vad_clip()[:int(16000 * seconds)]


@pytest.mark.parametrize("matmul_tf32,cudnn_tf32", [(False, True), (True, True)])
def test_vad_card_matches_cpu(cuda, vad_file, matmul_tf32, cudnn_tf32):
    # torch's default flags (cuDNN TF32 on) and all TF32 on: the module pins
    # full f32 itself, so the card stays within 1e-5 of the CPU and the
    # segments at the median threshold are the CPU's
    from chip_smoke import VAD_MAX_SPEECH_S, tf32_flags
    from whisper_tpu_torch.decoding.params import VadParams
    from whisper_tpu_torch.models.vad import silero as VS

    pcm = _vad_clip()
    want = VS.VadContext.from_file(vad_file, device="cpu").detect_speech(pcm)
    card = VS.VadContext.from_file(vad_file)
    with tf32_flags(matmul_tf32, cudnn_tf32):
        got = card.detect_speech(pcm)
        again = card.detect_speech(pcm)
    assert np.abs(got - want).max() <= 1e-5
    np.testing.assert_array_equal(got, again)
    vp = VadParams(threshold=float(np.median(got)), max_speech_duration_s=VAD_MAX_SPEECH_S)
    assert ([(s.start, s.end) for s in VS.segments_from_probs(got, vp)]
            == [(s.start, s.end) for s in VS.segments_from_probs(want, vp)])


def test_vad_card_carries_state_like_cpu(cuda, vad_file):
    from whisper_tpu_torch.models.vad import silero as VS

    pcm = _vad_clip(11.0)
    cpu = VS.VadContext.from_file(vad_file, device="cpu")
    card = VS.VadContext.from_file(vad_file)
    for reset, part in ((True, pcm), (False, pcm[:16000 * 3])):
        want = cpu.detect_speech(part, reset=reset)
        got = card.detect_speech(part, reset=reset)
        assert np.abs(got - want).max() <= 1e-5


def test_device_mel_matches_numpy(cuda):
    from whisper_tpu_torch.audio.mel import LogMel

    rng = np.random.default_rng(0)
    filters = np.abs(rng.standard_normal((128, 201))).astype(np.float32) * 0.01
    pcm = _vad_clip()
    ref, n_ref = LogMel(filters)(pcm)
    got, n = LogMel(filters, backend="torch")(pcm)
    assert n == n_ref and got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("T", [1, 8, 32, 128, 224])
@pytest.mark.parametrize("K,R", [(1280, 3840), (1280, 1280), (1280, 5120), (5120, 1280)])
def test_qmmt_kernel_dtw_rows(cuda, T, K, R):
    # K2 at a DTW pass's rows (a window's tokens) on the turbo decoder's
    # planes: within 1e-4 of max |y| of its plain version, the same bits
    # over two calls
    codes, scales, _ = _planes(Q.GGML_TYPE_Q5_0, K, R, 7, cuda)
    x = torch.from_numpy(np.random.default_rng(T).standard_normal((T, K))
                         .astype(np.float32)).to(cuda)
    n = QM.qmmt.launches
    y = QM.qmmt(x, codes, scales, dtype=torch.bfloat16)
    y2 = QM.qmmt(x, codes, scales, dtype=torch.bfloat16)
    assert QM.qmmt.launches == n + 2
    ref = QM.qmmt_fused_plain(x, codes, scales, dtype=torch.bfloat16)
    assert (y - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert torch.equal(y, y2)


def test_transcribe_vad_dtw_card_matches_cpu(cuda, vad_file, tmp_path_factory):
    # VAD and DTW on the small decisive model: the card's segments and t_dtw
    # are the CPU's (packed weights and bf16 on both; the DTW pass runs K2
    # on the card)
    import whisper_tpu_torch as W
    from chip_smoke import VAD_MAX_SPEECH_S
    from whisper_tpu_torch.models.vad import silero as VS

    _decisive_ctx(tmp_path_factory, "f16")       # writes the file once
    path = _DECISIVE["path"]
    pcm = _vad_clip(35.0)
    thr = float(np.median(VS.VadContext.from_file(vad_file, device="cpu").detect_speech(pcm)))
    out = {}
    for dev in ("cuda", "cpu"):
        ctx = W.load(path, device=dev, use_packed_weights=True, compute_dtype=torch.bfloat16)
        ctx.enable_dtw(n_top_most=1)
        p = W.TranscribeParams(temperature_inc=0.0, vad=True, vad_model_path=vad_file)
        p.vad_params.threshold = thr
        p.vad_params.max_speech_duration_s = VAD_MAX_SPEECH_S
        n = QM.qmmt.launches
        segs = W.transcribe(ctx, p, pcm)
        out[dev] = ([(s.t0, s.t1, s.text, [t.t_dtw for t in s.tokens]) for s in segs],
                    ctx.vad_segments_used, QM.qmmt.launches - n)
    assert out["cuda"][:2] == out["cpu"][:2] and len(out["cuda"][0]) >= 2
    assert out["cuda"][2] > 0 and out["cpu"][2] == 0


# Parakeet-TDT: the TDT loop's graphs against its eager loop (one row and a
# batch of rows that stop on their own), the card's encoder against the
# CPU's (f32 both; global and local attention), the device mel against numpy

@pytest.fixture(scope="module")
def parakeet_file(tmp_path_factory):
    from chip_smoke import SMALL_JOINT_SCALE, SMALL_PARAKEET, write_parakeet
    from whisper_tpu_torch.models.parakeet.hparams import ParakeetHParams

    path = str(tmp_path_factory.mktemp("parakeet") / "small.bin")
    write_parakeet(path, ParakeetHParams(**SMALL_PARAKEET), seed=3, use_f16=False,
                   joint_scale=SMALL_JOINT_SCALE)
    return path


@pytest.mark.parametrize("lens", [[200], [200, 57, 130]])
def test_parakeet_tdt_graphs_match_eager(cuda, parakeet_file, lens):
    from whisper_tpu_torch.models.parakeet.context import ParakeetContext
    from whisper_tpu_torch.models.parakeet.decode import max_out_for

    ctx = ParakeetContext.from_file(parakeet_file)
    hp, loop = ctx.hp, ctx.decoder.loop
    B, T = len(lens), max(lens)
    gen = torch.Generator().manual_seed(B)
    enc = (3.0 * torch.randn(B, T, hp.n_audio_state, generator=gen)).to(cuda)
    z = torch.zeros((B, hp.n_pred_layers, hp.n_pred_dim), device=cuda)
    max_out = [max_out_for(T, hp)] * B
    graphs = loop.graphs
    a = loop.run(enc, lens, z, z, max_out)
    b = loop.run(enc, lens, z, z, max_out, eager=True)
    c = loop.run(enc, lens, z, z, max_out)
    assert loop.graphs == graphs + 1
    for x, y, w in zip(a[:7], b[:7], c[:7]):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, w)
    for x, y in zip(a[7:9], b[7:9]):
        assert torch.equal(x, y)
    assert all(n > 5 for n in a[6])


@pytest.mark.parametrize("local", [False, True])
def test_parakeet_encoder_card_matches_cpu(cuda, parakeet_file, local, monkeypatch):
    from whisper_tpu_torch.models.parakeet import model as PM
    from whisper_tpu_torch.models.parakeet.context import ParakeetContext

    if local:
        monkeypatch.setattr(PM, "LOCAL_ATTN_THRESHOLD", 64)
    cpu = ParakeetContext.from_file(parakeet_file, device="cpu")
    card = ParakeetContext.from_file(parakeet_file)
    pcm = (0.1 * np.random.default_rng(6).standard_normal(16000 * 20)).astype(np.float32)
    cpu.pcm_to_mel(pcm)
    want = cpu._encode(cpu.mel[None], cpu.n_len_org)
    got = card._encode(cpu.mel[None], cpu.n_len_org).cpu()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    for c in (cpu, card):
        assert c.full(pcm) == 0
    key = lambda c: [(t.id, t.frame_index, t.duration_idx) for t in c.decoded_token_data]
    assert key(card) == key(cpu) and len(key(cpu)) > 5


def test_parakeet_device_mel_matches_numpy(cuda, parakeet_file):
    from whisper_tpu_torch.models.parakeet.load import load_parakeet_model
    from whisper_tpu_torch.models.parakeet.mel import (log_mel_spectrogram,
                                                        log_mel_spectrogram_torch)

    m = load_parakeet_model(parakeet_file)
    for seconds, seed in ((40.0, 0), (2.137, 1)):
        pcm = (0.1 * np.random.default_rng(seed).standard_normal(int(16000 * seconds))
               ).astype(np.float32)
        ref = log_mel_spectrogram(pcm, m.filters, m.window, m.hparams.n_fft)
        got = log_mel_spectrogram_torch(pcm, torch.from_numpy(m.filters).to(cuda),
                                        torch.from_numpy(m.window).to(cuda),
                                        m.hparams.n_fft).cpu().numpy()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_imatrix_capture_card_matches_cpu(cuda, tmp_path):
    # the check lives in chip_smoke.py (its phase 10): the capture on the
    # card (f64 sums there) against the CPU's, on a 256-wide decisive model
    from chip_smoke import IQ_DIMS, imatrix_card_matches_cpu, seeded_audio, voice_clip
    from whisper_tpu_torch.audio.io import write_wav
    from whisper_tpu_torch.cli import make_imatrix as MI
    from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
    from whisper_tpu_torch.utils.synth import write_synth_model

    path, wav = str(tmp_path / "small256-f16.bin"), str(tmp_path / "audio.wav")
    write_synth_model(path, WhisperHParams(**IQ_DIMS), seed=1, qtype="f16", decisive=True)
    write_wav(wav, voice_clip(seeded_audio(10.0, seed=0), 10.0))
    imatrix_card_matches_cpu(MI, path, wav)


def test_stream_ac768_card_matches_cpu(cuda, tmp_path):
    # the check lives in chip_smoke.py (its phase 10): whisper-stream with
    # -ac 768 (K4 over 768 frames, padded to 1024) on the card against the
    # CPU (bf16, packed planes), identical output
    import whisper_tpu_torch as W
    from chip_smoke import SMALL_DIMS, seeded_audio, stream_card_matches_cpu, voice_clip
    from whisper_tpu_torch.audio.io import write_wav
    from whisper_tpu_torch.cli import stream as TS
    from whisper_tpu_torch.decoding.graphs import COUNTED
    from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
    from whisper_tpu_torch.utils.synth import write_synth_model

    path, wav = str(tmp_path / "small-q5_0.bin"), str(tmp_path / "audio.wav")
    write_synth_model(path, WhisperHParams(**SMALL_DIMS), seed=1, qtype="q5_0",
                      decisive=True)
    write_wav(wav, voice_clip(seeded_audio(12.0, seed=0), 12.0))
    card = W.load(path)
    cpu = W.load(path, device="cpu", use_packed_weights=True, compute_dtype=torch.bfloat16)
    before = {fn.__name__: fn.launches for fn in COUNTED}
    stream_card_matches_cpu(TS, card, cpu, {"fixed_ac768": wav}, modes=("fixed_ac768",))
    after = {fn.__name__: fn.launches for fn in COUNTED}
    for name in ("qmmt_fused", "self_attention_qkv"):
        assert after[name] > before[name], name


# ---------------------------------------------------------------------------
# the C ABI and fine-tuning (whisper_tpu_torch/abi.py, capi.py, training/)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def abi_files(tmp_path_factory):
    """The small decisive model of chip_smoke.py phase 5, 12 s of seeded
    audio, and that audio as raw f32 PCM."""
    from chip_smoke import SMALL_DIMS
    from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
    from whisper_tpu_torch.utils.synth import write_synth_model

    d = tmp_path_factory.mktemp("abi")
    path = str(d / "small-q5_0.bin")
    write_synth_model(path, WhisperHParams(**SMALL_DIMS), seed=1, qtype="q5_0",
                      decisive=True)
    pcm = (0.1 * np.random.default_rng(5).standard_normal(16000 * 12)).astype(np.float32)
    pcm.astype("<f4").tofile(d / "audio.pcm.f32")
    return path, pcm, str(d / "audio.pcm.f32")


def _card_segments(path, pcm, params_json):
    import whisper_tpu_torch as W
    from whisper_tpu_torch.capi import _params_from_json

    return [(s.t0, s.t1, s.text, [t.id for t in s.tokens])
            for s in W.transcribe(W.load(path), _params_from_json(params_json), pcm)]


def test_c_hosts_on_the_card(cuda, abi_files):
    import subprocess

    from whisper_tpu_torch import abi

    path, pcm, pcm_file = abi_files
    want = _card_segments(path, pcm, abi.GREEDY)
    assert len(want) >= 2
    for src, extra, ok in (("whisper_tpu_torch/native/abi_host.c", ["cuda"], "ABI-HOST-OK"),
                           ("native/test_abi_main.c", [], "C-ABI OK"),
                           ("native/test_abi_structs.c", [], "STRUCT-ABI-OK"),
                           ("native/test_abi_callbacks.c", [], "CALLBACKS-OK")):
        exe = abi.build_host(abi.REPO / src)
        r = subprocess.run([str(exe), path, pcm_file, *extra], capture_output=True,
                           text=True, env=abi.host_env(), timeout=600)
        assert r.returncode == 0 and ok in r.stdout, r.stdout + r.stderr
        if src.endswith("abi_host.c"):
            assert abi.seg_lines(r.stdout) == want
        if src.endswith("main.c"):
            assert [s[:3] for s in abi.seg_lines(r.stdout)] == [s[:3] for s in want]


def test_library_in_process_on_the_card(cuda, abi_files):
    import ctypes

    from whisper_tpu_torch import abi
    from whisper_tpu_torch.decoding.graphs import COUNTED
    from whisper_tpu_torch.ops import enc_attn, qmm

    path, pcm, _ = abi_files
    lib = abi.load_library()
    cp = lib.whisper_context_default_params()
    assert cp.use_gpu
    ctx = lib.whisper_init_from_file_with_params(path.encode(), cp)
    assert ctx
    fp = lib.whisper_full_default_params(0)
    fp.language, fp.temperature_inc, fp.print_progress = b"en", 0.0, False
    buf = np.ascontiguousarray(pcm, np.float32)
    ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    assert lib.whisper_full(ctx, fp, ptr, len(buf)) == 0     # captures the graphs
    for fn in COUNTED:
        fn.launches = 0
    assert lib.whisper_full(ctx, fp, ptr, len(buf)) == 0
    assert qmm.qmmt_fused.launches > 0 and enc_attn.self_attention_qkv.launches > 0
    assert abi.segments(lib, ctx) == _card_segments(path, pcm, abi.GREEDY)
    lib.whisper_free(ctx)


def test_vad_from_c_on_the_card(cuda, vad_file):
    # the check lives in chip_smoke.py (its phase 11): the library's VAD at
    # its default context params (the card) against the Python VAD's
    # segments, at a threshold at the median of the CPU's probabilities
    from chip_smoke import abi_vad_in_process
    from whisper_tpu_torch import abi
    from whisper_tpu_torch.models.vad import silero as VS

    pcm = _vad_clip()
    thr = float(np.median(VS.VadContext.from_file(vad_file, device="cpu").detect_speech(pcm)))
    abi_vad_in_process(abi, vad_file, pcm, thr)


def test_finetune_card_matches_cpu(cuda, tmp_path):
    # the check lives in chip_smoke.py (its phase 11): 3 AdamW steps with
    # the encoder trained, losses within rtol 1e-4 of the CPU's
    from chip_smoke import finetune_card_matches_cpu

    finetune_card_matches_cpu(str(tmp_path))
