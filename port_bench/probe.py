"""What the benchmark takes from the running program: wrappers on module
attributes of the port, installed for one run and taken off after it.

Every run records, per request, its start and end and its context clone's
timers, and per window decode its prompt length and tokens chosen (for the
operation counts); for the requests drawn for the check, also the served
mel, each window's encoder output, and each window's prompt, tokens,
logprobs, timestamp mass, state and prompt-pass softmax, and the cross
K/V its decode steps read, at every XKV_EVERY-th audio frame, as the
window decoder's state holds it once its round is loaded.  A traced run also records spans
on CLOCK_MONOTONIC around the calls into each layer; the encode and
window-decode spans hold the program's device lock while open, so the
device work inside one span is that call's alone.

Requests are told apart by the form field `port_bench_id`, which the
server ignores; the handler thread that parsed a request runs its
transcription, so a thread-local names the request in the wrappers below.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

XKV_EVERY = 100

@dataclasses.dataclass
class Sample:
    rid: str
    mel: Optional[object] = None
    n_len_org: int = 0
    enc: List[object] = dataclasses.field(default_factory=list)
    xkv: List[tuple] = dataclasses.field(default_factory=list)
    windows: List[dict] = dataclasses.field(default_factory=list)


class Probe:
    def __init__(self, chosen_clients, longest_index: int, trace: bool):
        self.local = threading.local()
        self.lock = threading.Lock()
        self.trace = trace
        self.chosen = set(chosen_clients)
        self.longest = longest_index
        self.t0: Optional[float] = None      # the window, once it is open
        self.t1: Optional[float] = None
        self.requests: Dict[str, dict] = {}
        self.windows: List[tuple] = []       # (end, prompt length, tokens chosen)
        self.encodes: List[float] = []       # end of each encode
        # (kind, start ns, end ns, [(prompt length, tokens chosen)] of a
        # window-decode call)
        self.spans: List[tuple] = []
        self.samples: Dict[str, Sample] = {}
        self.errors: List[str] = []          # requests the server failed
        self._by_args: Dict[int, Sample] = {}  # a drawn request's window, by its args
        self._saved = []

    # -- which requests the check takes ---------------------------------------

    def _draw(self, rid: str) -> Optional[Sample]:
        """The first request of each chosen client sent inside the window,
        and the first request of the longest clip sent in its first half."""
        if self.t0 is None or not rid:
            return None
        now = time.monotonic()
        client, _, li = (int(x) for x in rid.split(":"))
        with self.lock:
            taken = {s.rid.split(":")[0] for s in self.samples.values()}
            longest = any(int(s.rid.split(":")[2]) == self.longest
                          for s in self.samples.values())
            if now <= self.t1 and ((client in self.chosen and str(client) not in taken)
                                   or (li == self.longest and not longest
                                       and now < (self.t0 + self.t1) / 2)):
                self.samples[rid] = Sample(rid)
                return self.samples[rid]
        return None

    # -- installing -----------------------------------------------------------

    def _patch(self, owner, name: str, make):
        orig = getattr(owner, name)
        self._saved.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def install(self) -> None:
        import torch
        from whisper_tpu_torch.cli import server as S
        from whisper_tpu_torch.decoding.device_loop import LoopState
        from whisper_tpu_torch.decoding.graphs import DEVICE_LOCK
        from whisper_tpu_torch.models.whisper import model as M
        from whisper_tpu_torch.runtime.batching import WindowBatcher
        from whisper_tpu_torch.runtime.context import WhisperContext

        local, probe = self.local, self

        def span(kind, fn, lock=False, count=lambda a: None):
            def run(*a, **k):
                if not probe.trace:
                    return fn(*a, **k)
                if lock:
                    DEVICE_LOCK.acquire()
                try:
                    t = time.monotonic_ns()
                    out = fn(*a, **k)
                    probe.spans.append((kind, t, time.monotonic_ns(), count(a)))
                    return out
                finally:
                    if lock:
                        DEVICE_LOCK.release()
            return run

        def parse(orig):
            def parse_multipart(body, content_type):
                fields = orig(body, content_type)
                rid = fields.get("port_bench_id", ("", b""))[1].decode()
                local.rid, local.sample = rid, probe._draw(rid)
                local.t_parse = time.monotonic()
                return fields
            return parse_multipart

        def joining(orig):
            def transcribe_joining(ctx, params, pcm, batcher):
                try:
                    segs, sub = orig(ctx, params, pcm, batcher)
                except Exception as e:  # noqa: BLE001 - recorded, then raised
                    probe.errors.append(f"{type(e).__name__}: {e}")
                    raise
                rid, sample = getattr(local, "rid", ""), getattr(local, "sample", None)
                probe.requests[rid] = dict(start=local.t_parse, end=time.monotonic(),
                                           timings=dataclasses.asdict(sub.timings))
                if sample is not None:
                    sample.mel, sample.n_len_org = sub.mel, sub.n_len_org
                return segs, sub
            return span("request", transcribe_joining)

        def encode(orig):
            def enc(*a, **k):
                out = orig(*a, **k)
                sample = getattr(local, "sample", None)
                if sample is not None:
                    sample.enc.append(out.detach().float().clone())
                return out
            return enc

        def encode_window(orig):
            def run(*a, **k):
                out = orig(*a, **k)
                probe.encodes.append(time.monotonic())
                return out
            return span("encode", run, lock=True)

        def decode_window(orig):
            def decode_window_device(ctx, prompt, *a, **k):
                res = orig(ctx, prompt, *a, **k)
                n = int(res.n_tok[0])
                probe.windows.append((time.monotonic(), len(prompt), n))
                sample = getattr(local, "sample", None)
                if sample is not None:
                    seek, seek_end = a[2], a[3]
                    sample.windows.append(dict(
                        prompt=[int(t) for t in prompt], seek=int(seek),
                        seek_end=int(seek_end), tok=res.tok_id[0, :n].tolist(),
                        plog=res.tok_plog[0, :n].tolist(),
                        ptsum=res.tok_ptsum[0, :n].tolist(), n_tok=n,
                        result_len=int(res.result_len[0]),
                        seek_delta=int(res.seek_delta[0]), failed=bool(res.failed[0]),
                        completed=bool(res.completed[0]),
                        prompt_probs=res.prompt_probs.copy()))
                return res
            return decode_window_device

        def submit(orig):
            def run(batcher, key, args):
                sample = getattr(local, "sample", None)
                if sample is not None:
                    probe._by_args[id(args)] = sample
                try:
                    return orig(batcher, key, args)
                finally:
                    probe._by_args.pop(id(args), None)
            return run

        def run_group(orig):
            def run(batcher, key, reqs):
                local.round = [probe._by_args.get(id(r.args)) for r in reqs]
                try:
                    return orig(batcher, key, reqs)
                finally:
                    local.round = None
            return span("decode", run, lock=True, count=lambda a: [
                (int(r.args[1]), int(r.result.n_tok[0])) for r in a[2]
                if r.result is not None])

        def load(orig):
            def run(st, *a, **k):
                out = orig(st, *a, **k)
                rnd = getattr(local, "round", None)
                if rnd and any(rnd) and torch.is_tensor(st.xk):
                    for j, sample in enumerate(rnd):
                        if sample is not None:
                            sample.xkv.append(tuple(
                                (x[:, j] if x.dim() == 5 else x)[:, :, ::XKV_EVERY]
                                .to("cpu", torch.float32, copy=True)
                                for x in (st.xk, st.xv)))
                    local.round = None
                return out
            return run

        self._patch(S, "parse_multipart", parse)
        self._patch(S, "transcribe_joining", joining)
        self._patch(M, "encode", encode)
        self._patch(WhisperContext, "encode_window", encode_window)
        self._patch(WhisperContext, "decode_window_device", decode_window)
        self._patch(WhisperContext, "pcm_to_mel", lambda f: span("mel", f))
        self._patch(WindowBatcher, "submit", submit)
        self._patch(WindowBatcher, "_run_group", run_group)
        self._patch(LoopState, "load", load)

    def uninstall(self) -> None:
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved.clear()
