"""The port's whisper-server against the JAX package's, on the CPU.

Both `serve()`s run on the same DECISIVE synthetic file (n_text_layer 3, so
timestamps are on) and get the same three concurrent /inference requests,
each with its own seeded 35 s clip and its own response format (json, srt,
vtt); greedy at t = 0 (temperature_inc 0), so the bodies must be equal.
The port's requests coalesce through its server-wide WindowBatcher: at
least one round runs several requests' windows as one native batch.  The
port's batcher gets a 2 s straggler deadline (its ServerState's
batch_wait_s), so the three requests' first windows meet whatever the
order their encodes take on a loaded host.  Then /health, GET /, a /load
hot swap with a request after it, and the refusal of a missing model.
VAD requests are compared in tests/test_torch_vad_cli.py.
"""

import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from whisper_tpu.cli import server as JS
from whisper_tpu_torch.audio.io import write_wav
from whisper_tpu_torch.cli import server as TS
from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
from whisper_tpu_torch.utils.synth import write_synth_model

HP = WhisperHParams(n_vocab=51865, n_audio_ctx=1500, n_audio_state=128,
                    n_audio_head=2, n_audio_layer=2, n_text_ctx=448,
                    n_text_state=128, n_text_head=2, n_text_layer=3, n_mels=80)
FORMATS = ("json", "srt", "vtt")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("server")
    model = str(d / "decisive-q5_0.bin")
    write_synth_model(model, HP, seed=1, qtype="q5_0", decisive=True)
    wavs = []
    for i in range(3):
        wav = str(d / f"clip{i}.wav")
        write_wav(wav, (0.1 * np.random.default_rng(10 + i).standard_normal(16000 * 35)
                        ).astype(np.float32))
        wavs.append(wav)
    return model, wavs


def _multipart(fields):
    boundary = "----whisper-tpu-torch-test"
    out = io.BytesIO()
    for name, (filename, content) in fields.items():
        out.write(f"--{boundary}\r\n".encode())
        dispo = f'Content-Disposition: form-data; name="{name}"'
        if filename:
            dispo += f'; filename="{filename}"'
        out.write((dispo + "\r\n\r\n").encode())
        out.write(content if isinstance(content, bytes) else content.encode())
        out.write(b"\r\n")
    out.write(f"--{boundary}--\r\n".encode())
    return out.getvalue(), f"multipart/form-data; boundary={boundary}"


def _post(url, fields, timeout=600):
    body, ctype = _multipart(fields)
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read().decode("utf-8")


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.read().decode("utf-8")


@pytest.fixture
def started():
    """Start a server's serve_forever in a thread; shut all down after."""
    running = []

    def start(httpd):
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        running.append((httpd, t))
        return f"http://127.0.0.1:{httpd.server_address[1]}"

    yield start
    for httpd, t in running:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)


def _volley(url, wavs):
    """The three requests at once: {format: body}."""
    out, errors = {}, []

    def hit(wav, fmt):
        try:
            with open(wav, "rb") as f:
                status, body = _post(url + "/inference", {
                    "file": ("clip.wav", f.read()), "response_format": ("", fmt)})
            assert status == 200
            out[fmt] = body
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=hit, args=a) for a in zip(wavs, FORMATS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not errors, errors
    return out


def test_server_matches_jax_and_coalesces(files, started):
    model, wavs = files
    defaults = {"language": "en", "temperature_inc": 0.0}
    jurl = started(JS.serve(model, host="127.0.0.1", port=0, defaults=defaults))
    thttpd = TS.serve(model, host="127.0.0.1", port=0, defaults=defaults, device="cpu")
    thttpd.whisper_state.batch_wait_s = 2.0
    turl = started(thttpd)
    want = _volley(jurl, wavs)
    got = _volley(turl, wavs)
    for fmt in FORMATS:
        assert got[fmt] == want[fmt], fmt
    assert json.loads(got["json"])["text"].strip()
    assert got["srt"].count("-->") >= 2
    b = thttpd.whisper_state.batcher
    assert b.n_coalesced_rounds >= 1 and b.max_round_size >= 2, (
        b.n_rounds, b.n_coalesced_rounds, b.max_round_size)
    assert b.n_live == 0


def test_server_health_load_and_refusals(files, started):
    model, wavs = files
    httpd = TS.serve(model, host="127.0.0.1", port=0,
                     defaults={"language": "en", "temperature_inc": 0.0}, device="cpu")
    url = started(httpd)
    assert _get(url + "/health") == (200, json.dumps({"status": "ok"}))
    status, body = _get(url + "/")
    assert status == 200 and "whisper_tpu_torch server" in body
    state = httpd.whisper_state
    with open(wavs[0], "rb") as f:
        clip = f.read()
    fields = {"file": ("clip.wav", clip), "response_format": ("", "text")}
    before = _post(url + "/inference", fields)
    ctx, batcher = state.get()
    # /load swaps the model and the batcher; a request after it uses the pair
    status, body = _post(url + "/load", {"model": ("", model)})
    assert status == 200 and json.loads(body) == {"status": "ok", "model": model}
    ctx2, batcher2 = state.get()
    assert ctx2 is not ctx and batcher2 is not batcher
    assert ctx2.device.type == "cpu"
    assert _post(url + "/inference", fields) == before
    assert batcher2.n_rounds > 0
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/load", {"model": ("", model + ".missing")})
    assert e.value.code == 400
