"""VAD and DTW through the port's command-line tools and server, against
the JAX package's, on the CPU.

The files of tests/test_torch_vad.py: the DECISIVE synthetic Whisper file
(n_text_layer 3, so timestamps are on), the synthetic Silero file and 35 s
of seeded noise with two 3 s silences, the VAD threshold at the median of
its probabilities and a 2 s maximum speech duration (that file says why).

- whisper-cli `-vad -vm ... -dtw top:1 -ojf` with -ng against the JAX CLI:
  text formats byte-equal, the JSON equal but for `systeminfo` and each
  token's `p` within 2e-6 (tests/test_torch_cli.py says why); every text
  token carries a `t_dtw`.
- whisper-server `-vm`: its defaults name the VAD model, and a request with
  vad=true gets the JAX server's body.
- vad-speech-segments: the same stdout as the JAX CLI's; its VadContext is
  put on the CPU from the test side (the CLI runs on the card).
"""

import json

import pytest
import torch

from test_torch_cli import TEXT, _assert_json_equal
from test_torch_server import _post, started  # noqa: F401
from test_torch_vad import (MAX_SPEECH_S, model_path, one_torch_thread,  # noqa: F401
                            pcm, threshold, vad_path)
from whisper_tpu.cli import server as JSV
from whisper_tpu.cli import transcribe as JC
from whisper_tpu.cli import vad_segments as JVS
from whisper_tpu_torch.audio.io import write_wav
from whisper_tpu_torch.cli import server as TSV
from whisper_tpu_torch.cli import transcribe as TC
from whisper_tpu_torch.cli import vad_segments as TVS
from whisper_tpu_torch.runtime import context as TCTX


@pytest.fixture(scope="module")
def wav(tmp_path_factory, pcm):
    path = str(tmp_path_factory.mktemp("vad-cli") / "audio.wav")
    write_wav(path, pcm)
    return path


def _vad_flags(vad_path, threshold):
    return ["-vad", "-vm", vad_path, "-vt", repr(threshold),
            "-vmsd", str(MAX_SPEECH_S)]


def test_cli_vad_dtw_matches_jax(model_path, vad_path, wav, threshold, tmp_path):
    flags = [*_vad_flags(vad_path, threshold), "-dtw", "top:1", "-bs", "1", "-nf"]
    outs = {}
    for name, mod, extra in (("jax", JC, []), ("torch", TC, ["-ng"])):
        of = str(tmp_path / name)
        rc = mod.run(["-m", model_path, "-f", wav, "-otxt", "-ovtt", "-osrt", "-ocsv",
                      "-olrc", "-ojf", "-of", of, "-np", *flags, *extra])
        assert rc == 0, name
        outs[name] = of
    for ext in TEXT:
        with open(f"{outs['jax']}.{ext}", "rb") as f:
            want = f.read()
        with open(f"{outs['torch']}.{ext}", "rb") as f:
            assert f.read() == want, ext
    with open(f"{outs['jax']}.json") as f:
        jj = json.load(f)
    with open(f"{outs['torch']}.json") as f:
        tj = json.load(f)
    jj.pop("systeminfo")
    tj.pop("systeminfo")
    _assert_json_equal(tj, jj)
    segs = tj["transcription"]
    assert len(segs) >= 2
    assert all(t["t_dtw"] >= 0 for sg in segs for t in sg["tokens"]
               if not t["text"].startswith("[_"))


def test_server_vad_matches_jax(model_path, vad_path, wav, threshold, started):
    defaults = {"language": "en", "temperature_inc": 0.0, "vad_model_path": vad_path}
    jurl = started(JSV.serve(model_path, host="127.0.0.1", port=0, defaults=defaults))
    turl = started(TSV.serve(model_path, host="127.0.0.1", port=0, defaults=defaults,
                             device="cpu"))
    with open(wav, "rb") as f:
        fields = {"file": ("clip.wav", f.read()), "response_format": ("", "srt"),
                  "vad": ("", "true"), "vad_threshold": ("", repr(threshold)),
                  "vad_max_speech_duration_s": ("", str(MAX_SPEECH_S))}
    want = _post(jurl + "/inference", fields)
    got = _post(turl + "/inference", fields)
    assert got == want and got[0] == 200
    assert got[1].count("-->") >= 2


def test_server_vm_sets_the_vad_model(monkeypatch):
    seen = {}

    class Fake:
        class whisper_state:
            @staticmethod
            def ensure_loaded():
                pass

        @staticmethod
        def serve_forever():
            raise KeyboardInterrupt

    def serve(model, host, port, request_path, inference_path, defaults, **kw):
        seen.update(defaults)
        return Fake

    monkeypatch.setattr(TSV, "serve", serve)
    assert TSV.main(["-m", "model.bin", "-vm", "silero.bin", "-ng"]) == 0
    assert seen == {"language": "en", "vad_model_path": "silero.bin"}


def test_vad_segments_matches_jax(vad_path, wav, threshold, capsys, monkeypatch):
    argv = ["-vm", vad_path, "-f", wav, "-vt", repr(threshold),
            "-vmsd", str(MAX_SPEECH_S)]
    assert JVS.main(argv) == 0
    want = capsys.readouterr().out
    # the CLI's VadContext takes the default device, the card: put it on the
    # CPU here
    resolve = TCTX.resolve_device
    monkeypatch.setattr(TCTX, "resolve_device",
                        lambda device=None: resolve("cpu" if device is None else device))
    assert TVS.main(argv) == 0
    got = capsys.readouterr().out
    assert got == want
    n = int(got.split("Detected ")[1].split()[0])
    assert n >= 2


def test_vad_segments_needs_a_card(vad_path, wav, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TVS.main(["-vm", vad_path, "-f", wav])
