"""`transcribe` with beam search on the host loop (the fallback ladder, and
`beam_sampling="reference"`) in the port against the JAX package, on the
decisive synthetic file of test_torch_beam.py (its fixtures and helpers are
imported from there).  Kept in a file of its own so that a worker of its
own can run it.
"""

import pytest

import whisper_tpu as J
import whisper_tpu_torch as W
from test_torch_beam import _beam_params, _summary, model_path, pcm  # noqa: F401


@pytest.mark.parametrize("kw", [
    # an unreachable logprob threshold fails every attempt but the last: the
    # t=0 beam attempt on the device loop, the t>0 attempts on the host loop
    # with best_of lanes replaying the reference's mt19937 stream (advanced
    # past the device beam attempt's skipped draws)
    dict(logprob_thold=1.0, temperature_inc=0.5),
    # the binary's t=0 beam: beam_size draws per decoder on the host loop
    dict(temperature_inc=0.0, beam_sampling="reference"),
], ids=["fallback_ladder", "reference_sampling"])
def test_transcribe_beam_host_paths_match_jax(model_path, pcm, kw):
    jctx = J.load(model_path, use_packed_weights=True)
    tctx = W.load(model_path, device="cpu", use_packed_weights=True)
    ref = J.transcribe(jctx, _beam_params(J, **kw), pcm)
    got = W.transcribe(tctx, _beam_params(W, **kw), pcm)
    assert ref and _summary(got) == _summary(ref)
    assert tctx.timings.n_fail_p == jctx.timings.n_fail_p
