"""The flash route's tile algorithm in plain PyTorch, to trace a parity
matrix case that parts card from CPU after a change to K6.

`emulate` computes flash_self_attention the way the CUDA kernel walks its
tiles (csrc/flash_attn.cu): 64-row query blocks, 64-key tiles, an online
softmax over each key range, the ranges' (m, l, acc) merged in order, at
the kernel's rounding points (bf16 q, k, v and p; the finite mask).  Its
arguments are the choices a design of the kernel makes: key ranges per
row block (`nc`), the exponent in base 2 (scores scaled by sm_scale *
log2(e)), and a first pass for the exact row max (`twopass`).  Its f32
scores come from the same product as the plain version's, so what it
shows is the algorithm's effect, not the tensor cores' order of sums.

    python -m whisper_tpu_torch.utils.flash_emulation [case]   # ml-dtw

runs one matrix case on the CPU with the card's numerics, first with the
plain version, then with each of MODES in its place, and prints whether
the rows equal the plain version's and the first segments' t_dtw.
"""

from __future__ import annotations

import math
import sys
import tempfile
from typing import Optional

import torch

from ..ops import attention as FA

MBQ = MBKV = 64  # query rows per block, keys per tile (csrc/flash_attn.cu)
MODES = {"seq_exp": dict(nc=1), "seq_exp2": dict(nc=1, base2=True),
         "split2_exp": dict(nc=2), "split2_exp2": dict(nc=2, base2=True),
         "twopass_split2_exp2": dict(nc=2, base2=True, twopass=True)}


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def emulate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            true_len: Optional[int] = None, nc: int = 1, base2: bool = False,
            twopass: bool = False) -> torch.Tensor:
    """flash_self_attention's function, (H, T, D) -> (H, T, D) f32 rounded
    to bf16, by the kernel's walk over its tiles: each 64-row block's key
    tiles (those below n_real where every row is real) split into `nc`
    ranges, each an online softmax (or, with `twopass`, p against the
    exact row max), merged in range order."""
    H, T, D = q.shape
    n_real = T if true_len is None else true_len
    qb, kb, vb = (_bf16(a.float()) for a in (q, k, v))
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    if base2:
        scale = scale * torch.tensor(math.log2(math.e), dtype=torch.float32)
    ex = torch.exp2 if base2 else torch.exp
    real_col = torch.arange(T) < n_real
    out = torch.zeros(H, T, D)
    for q0 in range(0, T, MBQ):
        rows = torch.arange(q0, min(q0 + MBQ, T))
        all_real = q0 + MBQ <= n_real
        n_tiles = -(-(n_real if all_real else T) // MBKV)
        per = -(-n_tiles // nc)
        ranges = []
        for r in range(nc):
            scores = []
            for jt in range(r * per, min(n_tiles, (r + 1) * per)):
                cols = torch.arange(jt * MBKV, min((jt + 1) * MBKV, T))
                s = (qb[:, rows] @ kb[:, cols].transpose(1, 2)) * scale
                if not (all_real and (jt + 1) * MBKV <= n_real):
                    allow = (rows < n_real)[:, None] == real_col[cols][None, :]
                    s = torch.where(allow, s, s + FA.MASK_VALUE)
                scores.append((cols, s))
            ranges.append(scores)
        if twopass:
            row_max = torch.cat([s for sc in ranges for _, s in sc], -1).amax(-1)
        parts = []
        for scores in ranges:
            m = torch.full((H, len(rows)), -math.inf)
            l = torch.zeros(H, len(rows))
            acc = torch.zeros(H, len(rows), D)
            for cols, s in scores:
                mn = row_max if twopass else torch.maximum(m, s.amax(-1))
                al = ex(m - mn)
                p = ex(s - mn[..., None])
                l = al * l + p.sum(-1)
                acc = acc * al[..., None] + _bf16(p) @ vb[:, cols]
                m = mn
            parts.append((m, l, acc))
        m, l, acc = parts[0]
        for om, ol, oacc in parts[1:]:
            mn = torch.maximum(m, om)
            a, b = ex(m - mn), ex(om - mn)
            l = a * l + b * ol
            acc = a[..., None] * acc + b[..., None] * oacc
            m = mn
        out[:, rows] = _bf16(acc / l[..., None])
    return out


def main(case_name: str = "ml-dtw") -> None:
    from ..evals import matrix as MX

    with tempfile.TemporaryDirectory() as root:
        inputs = MX.Inputs.make(root)
        engine = MX.port_engine("cpu", card_numerics=True)
        inputs.set_script(MX.script_rows(engine, inputs))
        case = MX.synth_case({c.name: c for c in MX.ALL_CASES}[case_name], inputs)
        plain = FA.flash_self_attention
        try:
            def rows(fn):
                FA.flash_self_attention = fn
                engine.ctxs.clear()
                return MX.run_case(engine, case, inputs)["rows"]

            ref = rows(plain)
            dtw = lambda rs: [[t.get("t_dtw") for t in s["tokens"]] for s in rs[:3]]
            print(f"plain: t_dtw {dtw(ref)}", flush=True)
            for name, kw in MODES.items():
                got = rows(lambda q, k, v, true_len=None, kw=kw: emulate(q, k, v, true_len, **kw))
                print(f"{name}: {'equal' if got == ref else 'parts'} t_dtw {dtw(got)}",
                      flush=True)
        finally:
            FA.flash_self_attention = plain


if __name__ == "__main__":
    main(*sys.argv[1:2])
