"""Card tests of the port: each Hopper kernel against its plain PyTorch
version on the same CUDA inputs, and the slice on the card against the
slice on the CPU.  They need a CUDA card and skip without one (run them on
the card with `python -m pytest tests/test_torch_gpu.py -m gpu`).

Tolerances: qmmt 1e-4 of max |y| (f32 sums in another order over K up to
5120); self_attend_q8 f32 1e-5, bf16 2e-2 (one bf16 ulp on p * s_v);
self_attention_qkv 2e-2 (bf16 output); qmm 1e-4 of max |y| (the same
bf16-rounded operands, tensor-core f32 sums in another order over K up to
4096); flash_self_attention 2e-2 absolute on real rows (bf16 output, and
the online softmax rounds p to bf16 before its final rescale).
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


def _planes(qtype, k, r, seed):
    w = np.random.default_rng(seed).standard_normal((r, k)).astype(np.float32)
    p = Q.unpack_to_planes(Q.quantize(w, qtype), qtype, (r, k))
    tr = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a.T))
    return tr(p.codes), tr(p.scales), tr(p.mins)


@pytest.mark.parametrize("T,K,R", [(1, 1280, 3840), (5, 5120, 1280),
                                   (3, 256, 51866), (9, 128, 100)])
@pytest.mark.parametrize("qtype", [Q.GGML_TYPE_Q5_0, Q.GGML_TYPE_Q4_1])
def test_qmmt_fused_kernel(cuda, T, K, R, qtype):
    rng = np.random.default_rng(0)
    codes, scales, mins = (None if a is None else a.to(cuda)
                           for a in _planes(qtype, K, R, 1))
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)
    x, lw, lb, b, res = t(T, K), t(K), t(K), t(R), t(T, R)
    for kw in (dict(ln_w=lw, ln_b=lb, bias=b), dict(bias=b, residual=res),
               dict(ln_w=lw, ln_b=lb, bias=b, act="gelu"), dict(ln_w=lw, ln_b=lb)):
        for dtype in (torch.float32, torch.bfloat16):
            y = QM.qmmt_fused(x, codes, scales, mins, dtype=dtype, **kw)
            ref = QM.qmmt_fused_plain(x, codes, scales, mins, dtype=dtype, **kw)
            torch.cuda.synchronize()
            assert (y - ref).abs().max() <= 1e-4 * ref.abs().max()
    n = QM.qmmt.launches
    y = QM.qmmt(x, codes, scales, mins, dtype=torch.bfloat16)
    assert QM.qmmt.launches == n + 1
    ref = QM.qmmt_fused_plain(x, codes, scales, mins, dtype=torch.bfloat16)
    assert (y - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize("G,A", [(1, 128), (1, 448), (4, 256), (16, 384)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_self_attend_q8_kernel(cuda, G, A, dtype, tol):
    L, B, H, C, D = 4, 2, 20, 448, 64
    g = torch.Generator().manual_seed(0)
    kv = torch.randint(-127, 128, (L, B, H, 2, C, D), generator=g, dtype=torch.int8)
    scale = 0.01 + 0.02 * torch.rand((L, B, 2, C), generator=g)
    q = torch.randn((B, H, G, D), generator=g)
    vis = torch.arange(A)[None, :] < (A - G + torch.arange(G) + 1)[:, None]
    mask = torch.where(vis, 0.0, float("-inf")).expand(B, G, A).contiguous()
    kv, scale, q, mask = (a.to(cuda) for a in (kv, scale, q, mask))
    for l in (0, L - 1):
        out = DA.self_attend_q8(kv, scale, q, mask, l=l, attn_ctx=A, dtype=dtype)
        ref = DA.self_attend_q8_plain(kv, scale, q, mask, l=l, attn_ctx=A, dtype=dtype)
        assert (out - ref).abs().max() <= tol * ref.abs().max()


@pytest.mark.parametrize("T,true_len,n_head,d", [(1536, 1500, 20, 64),
                                                 (512, 500, 2, 128)])
def test_self_attention_qkv_kernel(cuda, T, true_len, n_head, d):
    g = torch.Generator().manual_seed(1)
    qkv = torch.randn((T, 3 * n_head * d), generator=g).to(cuda)
    out = EA.self_attention_qkv(qkv, n_head, true_len=true_len)
    ref = EA.self_attention_qkv_plain(qkv, n_head, true_len=true_len)
    assert out.dtype == torch.bfloat16
    assert (out.float() - ref.float()).abs().max() <= 2e-2 * ref.float().abs().max()


@pytest.mark.parametrize("T,K,R,qk", [(4096, 4096, 4096, 32), (37, 256, 300, 16),
                                      (1, 1280, 51866, 32), (130, 512, 129, 16)])
def test_qmm_kernel(cuda, T, K, R, qk):
    g = torch.Generator().manual_seed(2)
    x = torch.randn((T, K), generator=g).to(cuda)
    codes = torch.randint(-16, 16, (R, K), generator=g, dtype=torch.int8).to(cuda)
    scales = (0.02 * torch.rand((R, K // qk), generator=g)).to(cuda)
    n = QM.qmm.launches
    y = QM.qmm(x, codes, scales)
    assert QM.qmm.launches == n + 1
    ref = QM.qmm_plain(x, codes, scales)
    torch.cuda.synchronize()
    assert (y - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize("H,T,true_len,D", [(20, 1536, 1500, 64), (2, 700, 650, 128),
                                            (3, 100, 100, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_self_attention_kernel(cuda, H, T, true_len, D, dtype):
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
    assert (out[:, :true_len] - ref[:, :true_len]).abs().max() <= 2e-2


def test_transcribe_card_matches_cpu(cuda, tmp_path):
    # the check lives in chip_smoke.py (its phase 5); this runs it under pytest
    from chip_smoke import card_matches_cpu

    card_matches_cpu(str(tmp_path))
