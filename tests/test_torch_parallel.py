"""`transcribe_parallel` in the port against the JAX package's, on the CPU,
on the DECISIVE file and audio of tests/test_torch_batching.py (its
fixtures are imported from there): the audio split into n chunks whose
worker threads batch their windows natively (runtime/batching.py), merged
with the offset fix-up and the non-overlap clamp.  At t = 0
(temperature_inc = 0) the merged (t0, t1, text) must be identical, greedy
and beam search.  Kept in a file of its own so that a worker of its own can
run it.
"""

import numpy as np
import pytest

import whisper_tpu as J
import whisper_tpu_torch as W
from test_torch_batching import HP, model_path, one_torch_thread, pcm  # noqa: F401
from whisper_tpu.decoding.parallel import transcribe_parallel as j_parallel
from whisper_tpu_torch.decoding.parallel import transcribe_parallel as t_parallel
from whisper_tpu_torch.runtime import batching as TB


def _params(pkg, strategy):
    p = (pkg.TranscribeParams.default(pkg.SamplingStrategy.BEAM_SEARCH)
         if strategy == "beam" else pkg.TranscribeParams())
    p.temperature_inc = 0.0
    p.print_progress = False
    return p


@pytest.mark.parametrize("strategy,n", [("greedy", 2), ("greedy", 3), ("beam", 2)])
def test_transcribe_parallel_matches_jax(model_path, pcm, strategy, n, monkeypatch):
    rounds = []

    class Counted(TB.WindowBatcher):
        # a long straggler deadline: on a loaded host one chunk's encode can
        # outlast the default 0.25 s, and its window would then run alone
        def __init__(self, ctx, n_workers):
            super().__init__(ctx, n_workers, max_wait_s=60.0)

        def _take_locked(self):
            rounds.append(len(self.pending))
            return super()._take_locked()

    monkeypatch.setattr(TB, "WindowBatcher", Counted)
    jctx = J.load(model_path, use_packed_weights=True)
    tctx = W.load(model_path, device="cpu", use_packed_weights=True)
    ref = j_parallel(jctx, _params(J, strategy), pcm, n)
    got = t_parallel(tctx, _params(W, strategy), pcm, n)
    assert [(s.t0, s.t1, s.text) for s in got] == [(s.t0, s.t1, s.text) for s in ref]
    assert len(got) >= n
    ts = [(s.t0, s.t1) for s in got]
    assert all(b[0] >= a[1] for a, b in zip(ts, ts[1:]))      # the clamp
    # the chunks' windows went through the batcher, some of them together
    assert rounds and max(rounds) >= 2


def test_transcribe_parallel_unbatched_and_refusals(model_path, pcm):
    tctx = W.load(model_path, device="cpu", use_packed_weights=True)
    p = _params(W, "greedy")
    batched = t_parallel(tctx, p, pcm, 2)
    seq = t_parallel(tctx, p, pcm, 2, batched=False)
    assert [(s.t0, s.t1, s.text) for s in seq] == [(s.t0, s.t1, s.text) for s in batched]
    assert np.isfinite([s.t0 for s in seq]).all()
