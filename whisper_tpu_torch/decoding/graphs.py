"""CUDA graphs whose kernel launches stay counted.

Each kernel wrapper of the port adds one to its `launches` where it launches
its kernel (ops/qmm.py, ops/decode_attn.py, ops/enc_attn.py,
ops/attention.py).  While a graph is captured the wrappers run but launch
nothing, and a replay launches every captured kernel without running them.
`CountedGraph` records how far each count moved during its capture, takes
that back, and adds it on every replay, so the counts keep saying what the
card ran.
"""

from __future__ import annotations

import torch

from ..ops import attention, decode_attn, enc_attn, qmm

COUNTED = (qmm.qmmt_fused, qmm.qmmt, qmm.qmm, decode_attn.self_attend_q8,
           enc_attn.self_attention_qkv, attention.flash_self_attention)


class CountedGraph:
    """`fn` run once eagerly on a side stream (so that lazy set-up, such as
    the decode matmul's arrival counters, happens outside the capture), then
    captured into a CUDA graph in the memory pool `pool`.  `generator`, when
    given, is registered with the graph, so each replay draws the numbers
    the next eager call would draw."""

    def __init__(self, fn, pool, generator=None):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        before = [f.launches for f in COUNTED]
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        with torch.cuda.graph(self.graph, pool=pool):
            fn()
        self.deltas = [(f, f.launches - n) for f, n in zip(COUNTED, before)
                       if f.launches != n]
        for f, d in self.deltas:
            f.launches -= d

    def replay(self) -> None:
        self.graph.replay()
        for f, d in self.deltas:
            f.launches += d
