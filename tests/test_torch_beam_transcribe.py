"""`transcribe` with beam search at t=0 in the port against the JAX
package, on the decisive synthetic file of test_torch_beam.py (its fixtures
and helpers are imported from there): identical segments and token ids.
Kept in a file of its own so that a worker of its own can run it.
"""

import pytest

import whisper_tpu as J
import whisper_tpu_torch as W
from test_torch_beam import _beam_params, _summary, model_path, pcm  # noqa: F401


@pytest.mark.parametrize("kv_itype", ["f16", "q8"])
def test_transcribe_beam_matches_jax_at_t0(model_path, pcm, kv_itype):
    kw = dict(temperature_inc=0.0)
    ref = J.transcribe(J.load(model_path, use_packed_weights=True, kv_itype=kv_itype),
                       _beam_params(J, **kw), pcm)
    got = W.transcribe(W.load(model_path, device="cpu", use_packed_weights=True,
                              kv_itype=kv_itype), _beam_params(W, **kw), pcm)
    assert len(ref) >= 2 and {s.t0 // 3000 for s in ref} == {0, 1}
    assert _summary(got) == _summary(ref)
