"""The port's multi-host transcription (parallel/multihost.py) against the
JAX package on the CPU.

Two ranks (parallel/launch.py, gloo, one thread each) run
`transcribe_multihost` on a DECISIVE synthetic file (utils/synth.py
make_decisive: argmax margins far above f32 summation noise): each
transcribes its own chunk of the whisper_full_parallel split, and both
return the same merged list, equal to the JAX package's
`transcribe_parallel(ctx, p, samples, 2, batched=False)` (t0, t1, text,
token ids).  The layout checks of `make_global_mesh` raise the JAX
package's three messages.
"""

import numpy as np
import pytest

import whisper_tpu as J
from whisper_tpu.decoding.parallel import transcribe_parallel
from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
from whisper_tpu_torch.parallel.launch import launch
from whisper_tpu_torch.parallel.multihost import check_layout
from whisper_tpu_torch.utils.synth import write_synth_model

HP = WhisperHParams(n_vocab=51865, n_audio_ctx=1500, n_audio_state=128,
                    n_audio_head=2, n_audio_layer=2, n_text_ctx=448,
                    n_text_state=128, n_text_head=2, n_text_layer=3, n_mels=80)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("multihost") / "decisive-q5_0.bin"
    write_synth_model(str(path), HP, seed=1, qtype="q5_0", decisive=True)
    return str(path)


def test_two_ranks_merge_the_jax_transcribe_parallel(model_path):
    samples = (0.1 * np.random.default_rng(5).standard_normal(16000 * 24)).astype(np.float32)
    ranks = launch("tests/torch_dist_ranks.py:multihost_transcribe", 2,
                   (model_path, samples), threads=1)
    ctx = J.load(model_path)
    p = J.TranscribeParams(language="en", print_progress=False, temperature_inc=0.0)
    ref = [(s.t0, s.t1, s.text, [t.id for t in s.tokens])
           for s in transcribe_parallel(ctx, p, samples, 2, batched=False)]
    assert len(ref) > 1 and any(s[0] >= 1200 for s in ref)   # both chunks spoke
    for r in ranks:
        assert r["foreign"] == [] and r["mesh"] == (2, 1)
        assert r["windows"] == 1                  # each rank encoded its own chunk
        assert r["segs"] == ref


@pytest.mark.parametrize("n_dp,n_tp,n_global,local,match", [
    (None, 8, 8, [4, 4], "exceeds"),
    (None, 3, 8, [4, 4], "does not divide"),
    (3, 2, 8, [4, 4], "does not cover"),
    (None, 2, 6, [4, 2], "unequal device counts"),
])
def test_layout_checks_raise(n_dp, n_tp, n_global, local, match):
    with pytest.raises(ValueError, match=match):
        check_layout(n_dp, n_tp, n_global, local)


def test_layout_checks_pass():
    assert check_layout(None, 2, 8, [4, 4]) == 4
    assert check_layout(2, 4, 8, [4, 4]) == 2
    assert check_layout(None, 1, 2, [2]) == 2
