"""The Silero VAD and the device mel in the port against the JAX package's,
on the CPU.

The VAD file is the synthetic Silero model at Silero's own widths
(`synth_vad_tensors`, seed 0); the audio is seeded noise with two 3 s
silences cut into it.  The synthetic model's probabilities stay within
~0.41-0.65 on any input, so a silence never falls 0.15 below a threshold
at their median (the state machine's end-of-speech rule): the tests set
the threshold to the median and a 2 s maximum speech duration, whose
forced splits inside a silence let it be cut.  Probabilities agree to rtol
1e-5 (f32 convolutions and products summed in another order), segments,
filtered samples and mapping tables exactly.  The device mel
(backend="torch", here on the CPU) agrees with the JAX package's device mel
and with the numpy mel to 1e-5 of max |mel| (MEL_RTOL).
`transcribe` with VAD, and `transcribe_parallel` n = 2 with VAD, give the
JAX package's segments at t = 0 on the DECISIVE file.  PyTorch runs on one
intra-op thread (many small ops per scan step).
"""

import inspect

import numpy as np
import pytest
import torch

import whisper_tpu as J
import whisper_tpu.audio.mel as JMEL
import whisper_tpu_torch as W
import whisper_tpu_torch.audio.mel as TMEL
from whisper_tpu.decoding.params import VadParams as JVadParams
from whisper_tpu.decoding.parallel import transcribe_parallel as j_parallel
from whisper_tpu.models.vad import pipeline as JP
from whisper_tpu.models.vad import silero as JS
from whisper_tpu_torch.decoding.parallel import transcribe_parallel as t_parallel
from whisper_tpu_torch.decoding.params import VadParams
from whisper_tpu_torch.models.vad import pipeline as TP
from whisper_tpu_torch.models.vad import silero as TS
from whisper_tpu_torch.models.vad.writer import synth_vad_tensors, write_vad_model
from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
from whisper_tpu_torch.utils.synth import write_synth_model

HP = WhisperHParams(n_vocab=51865, n_audio_ctx=1500, n_audio_state=128,
                    n_audio_head=2, n_audio_layer=2, n_text_ctx=448,
                    n_text_state=128, n_text_head=2, n_text_layer=3, n_mels=80)
MAX_SPEECH_S = 2.0
# the device mel against the numpy mel and the JAX device mel: max |diff| over
# max |mel|.  Two f32 FFTs differ by ~1e-7 of a frame's largest bin, which the
# log turns into ~1e-6-1e-5 of max |mel| in the quiet bins: the JAX device
# mel itself sits 7.7e-7 to 1.3e-5 from the numpy mel on such inputs
MEL_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def clip(seconds: float, seed: int) -> np.ndarray:
    """Seeded noise with 3 s of silence at 8 s and at 20 s."""
    pcm = (0.1 * np.random.default_rng(seed).standard_normal(int(16000 * seconds))
           ).astype(np.float32)
    for s in (8, 20):
        pcm[16000 * s:16000 * (s + 3)] = 0.0
    return pcm


@pytest.fixture(scope="module")
def vad_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("vad") / "silero-synth.bin"
    write_vad_model(str(path), synth_vad_tensors(seed=0))
    return str(path)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("vad-slice") / "decisive-q5_0.bin"
    write_synth_model(str(path), HP, seed=1, qtype="q5_0", decisive=True)
    return str(path)


@pytest.fixture(scope="module")
def pcm():
    return clip(35.0, 5)


@pytest.fixture(scope="module")
def threshold(vad_path, pcm):
    """The median of the clip's probabilities (the port's, on the CPU)."""
    return float(np.median(TS.VadContext.from_file(vad_path, device="cpu")
                           .detect_speech(pcm)))


def _vad_params(pkg_params, threshold):
    return pkg_params(threshold=threshold, max_speech_duration_s=MAX_SPEECH_S)


@pytest.mark.parametrize("seconds", [0.3, 11.0])
def test_vad_probs_match_jax(vad_path, seconds):
    # a bucket of 8 chunks and one of 512; the second call carries h/c over
    pcm = clip(seconds, 1)
    j = JS.VadContext.from_file(vad_path)
    t = TS.VadContext.from_file(vad_path, device="cpu")
    for reset, part in ((True, pcm), (False, pcm[: len(pcm) // 2])):
        want = j.detect_speech(part, reset=reset)
        got = t.detect_speech(part, reset=reset)
        assert got.shape == want.shape == ((len(part) + 511) // 512,)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    np.testing.assert_allclose(t._h.numpy(), np.asarray(j._h), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(t._c.numpy(), np.asarray(j._c), rtol=1e-5, atol=1e-7)
    assert t.t_vad_us > 0


def test_vad_segments_and_filter_match_jax(vad_path, pcm, threshold):
    j = JS.VadContext.from_file(vad_path)
    t = TS.VadContext.from_file(vad_path, device="cpu")
    want = JS.segments_from_samples(j, _vad_params(JVadParams, threshold), pcm)
    got = TS.segments_from_samples(t, _vad_params(VadParams, threshold), pcm)
    assert [(s.start, s.end) for s in got] == [(s.start, s.end) for s in want]
    # the filter really cuts: the silences go, more than one segment stays
    assert len(got) >= 2

    pj = J.TranscribeParams(vad_model_path=vad_path,
                            vad_params=_vad_params(JVadParams, threshold))
    pt = W.TranscribeParams(vad_model_path=vad_path,
                            vad_params=_vad_params(VadParams, threshold))
    fj, mj, uj = JP.filter_speech(None, pj, pcm)
    ft, mt, ut = TP.filter_speech(_CpuCtx(), pt, pcm)
    np.testing.assert_array_equal(ft, fj)
    assert mt == mj and ut == uj
    assert 0.5 < len(ft) / len(pcm) < 0.95
    for proc, orig in mt:
        assert TP.map_processed_to_original_time(proc, mt) == orig


class _CpuCtx:
    """filter_speech reads only the Whisper context's device."""

    device = torch.device("cpu")


def test_vad_context_cached_by_path_and_device(vad_path):
    a = TP.get_vad_context(vad_path, "cpu")
    assert TP.get_vad_context(vad_path, torch.device("cpu")) is a
    assert a.device.type == "cpu"


def test_vad_forward_pins_full_f32(vad_path, monkeypatch):
    # TF32 stays off inside the forward whatever the caller set, and the
    # caller's flags come back afterwards
    seen = []
    inner = TS._forward_probs

    def spy(*a):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return inner(*a)

    monkeypatch.setattr(TS, "_forward_probs", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    TS.VadContext.from_file(vad_path, device="cpu").detect_speech(clip(0.3, 2))
    assert seen == [(False, False)]
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


def test_empty_vad_model(tmp_path):
    path = str(tmp_path / "vad-empty.bin")
    write_vad_model(path, {})
    t = TS.VadContext.from_file(path, device="cpu")
    assert t.model.is_empty
    probs = t.detect_speech(np.zeros(512 * 4, np.float32))
    assert probs.shape == (4,) and np.all(probs == 1.0)


@pytest.mark.parametrize("fn", ["load_vad_model", "_read_string", "segments_from_probs",
                                "segments_from_samples", "_samples_to_cs", "cs_to_samples"])
def test_vad_host_functions_are_copies(fn):
    assert inspect.getsource(getattr(TS, fn)) == inspect.getsource(getattr(JS, fn))


@pytest.mark.parametrize("fn", ["map_processed_to_original_time", "remap_segment_times",
                                "_samples_to_cs"])
def test_vad_pipeline_functions_are_copies(fn):
    assert inspect.getsource(getattr(TP, fn)) == inspect.getsource(getattr(JP, fn))


def test_device_mel_matches_jax_and_numpy():
    rng = np.random.default_rng(0)
    filters = np.abs(rng.standard_normal((80, 201))).astype(np.float32)
    pcm = (0.1 * rng.standard_normal(16000 * 7)).astype(np.float32)
    want_np, n_np = JMEL.LogMel(filters, backend="numpy")(pcm)
    want_jax, n_jax = JMEL.LogMel(filters, backend="jax")(pcm)
    got, n = TMEL.LogMel(filters, backend="torch", device="cpu")(pcm)
    assert n == n_np == n_jax and got.shape == want_np.shape and got.dtype == np.float32
    for want in (want_jax, want_np):
        assert np.abs(got - want).max() <= MEL_RTOL * np.abs(want).max()
    # the native C mel is ported (whisper_tpu_torch/native.py): the same
    # library code as the JAX package's, so the same mel
    got_c, n_c = TMEL.LogMel(filters, backend="native")(pcm)
    want_c, _ = JMEL.LogMel(filters, backend="native")(pcm)
    assert n_c == n_np
    np.testing.assert_array_equal(got_c, want_c)
    assert np.abs(got_c - want_np).max() <= MEL_RTOL * np.abs(want_np).max()


@pytest.mark.parametrize("mel_backend,want", [("auto", "numpy"), ("numpy", "numpy"),
                                              ("torch", "torch")])
def test_load_mel_backend(model_path, mel_backend, want):
    ctx = W.load(model_path, device="cpu", mel_backend=mel_backend)
    assert ctx.mel_fn.backend == want
    pcm = clip(2.0, 3)
    ctx.pcm_to_mel(pcm)
    jctx = J.load(model_path, mel_backend="numpy")
    jctx.pcm_to_mel(pcm)
    assert np.abs(ctx.mel - jctx.mel).max() <= MEL_RTOL * np.abs(jctx.mel).max()
    if want == "numpy":
        np.testing.assert_array_equal(ctx.mel, jctx.mel)
    assert ctx.n_len_org == jctx.n_len_org and ctx.timings.t_mel_us > 0


def _params(pkg, vad_path, threshold):
    p = pkg.TranscribeParams(temperature_inc=0.0)
    p.print_progress = False
    p.vad = True
    p.vad_model_path = vad_path
    p.vad_params.threshold = threshold
    p.vad_params.max_speech_duration_s = MAX_SPEECH_S
    return p


def _summary(segs):
    return [(s.t0, s.t1, s.text, [t.id for t in s.tokens]) for s in segs]


def test_transcribe_vad_matches_jax(model_path, vad_path, pcm, threshold):
    jctx = J.load(model_path, use_packed_weights=True)
    tctx = W.load(model_path, device="cpu", use_packed_weights=True)
    ref = J.transcribe(jctx, _params(J, vad_path, threshold), pcm)
    got = W.transcribe(tctx, _params(W, vad_path, threshold), pcm)
    assert len(ref) >= 2 and _summary(got) == _summary(ref)
    assert tctx.vad_segments_used == jctx.vad_segments_used
    assert len(tctx.vad_segments_used) >= 2
    # times are in the original audio's time
    assert all(0 <= s.t0 and s.t1 <= len(pcm) // 160 for s in got)


def test_transcribe_parallel_vad_matches_jax(model_path, vad_path, pcm, threshold):
    jctx = J.load(model_path, use_packed_weights=True)
    tctx = W.load(model_path, device="cpu", use_packed_weights=True)
    ref = j_parallel(jctx, _params(J, vad_path, threshold), pcm, 2)
    got = t_parallel(tctx, _params(W, vad_path, threshold), pcm, 2)
    assert len(ref) >= 2
    assert [(s.t0, s.t1, s.text) for s in got] == [(s.t0, s.t1, s.text) for s in ref]
    assert tctx.vad_segments_used == jctx.vad_segments_used

