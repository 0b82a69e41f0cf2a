"""The port's spans (whisper_tpu_torch/runtime/trace.py) on the CPU: when
recording is on, the served path's spans and their tree, the device lock's
spans, the phase timers that share the spans' clock reads, the benchmark's
eight readers of them on a fixed span list, and the whisper-server's
multipart parse, which keeps every byte of an upload."""

import io
import threading
import time
import urllib.request
import wave
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import whisper_tpu_torch as W
from whisper_tpu_torch.cli import server as TS
from whisper_tpu_torch.decoding.graphs import DEVICE_LOCK
from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
from whisper_tpu_torch.runtime import trace
from whisper_tpu_torch.runtime.batching import WindowBatcher
from whisper_tpu_torch.utils.synth import write_synth_model

HP = WhisperHParams(n_vocab=51865, n_audio_ctx=1500, n_audio_state=64,
                    n_audio_head=2, n_audio_layer=1, n_text_ctx=448,
                    n_text_state=64, n_text_head=2, n_text_layer=3, n_mels=80)
BOUNDARY = "----trace-test"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_spans():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("trace") / "decisive-q5_0.bin")
    write_synth_model(path, HP, seed=3, qtype="q5_0", decisive=True)
    return path


@pytest.fixture(scope="module")
def server(model):
    httpd = TS.serve(model, "127.0.0.1", 0, defaults={"language": "en"}, device="cpu")
    httpd.whisper_state.batch_wait_s = 2.0
    httpd.whisper_state.ensure_loaded()
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield httpd
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=30)


def _wav(samples: np.ndarray) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(samples.astype("<i2").tobytes())
    return buf.getvalue()


def _clip(seconds: float, seed: int) -> bytes:
    x = np.random.default_rng(seed).standard_normal(int(16000 * seconds)) * 3000
    return _wav(x.astype(np.int16))


def _body(fields) -> bytes:
    out = []
    for name, (filename, content) in fields.items():
        dispo = f'Content-Disposition: form-data; name="{name}"'
        if filename:
            dispo += f'; filename="{filename}"'
        out += [f"--{BOUNDARY}\r\n{dispo}\r\n\r\n".encode(), content, b"\r\n"]
    out.append(f"--{BOUNDARY}--\r\n".encode())
    return b"".join(out)


def _post(httpd, fields) -> int:
    url = f"http://127.0.0.1:{httpd.server_address[1]}/inference"
    req = urllib.request.Request(url, data=_body(fields), headers={
        "Content-Type": f"multipart/form-data; boundary={BOUNDARY}"})
    with urllib.request.urlopen(req, timeout=120) as r:
        r.read()
        return r.status


def _windows(httpd) -> int:
    return sum(f.windows for f in httpd.whisper_state.ctx._window_fns.values())


# -- recording on and off -------------------------------------------------------

def test_recording_off_leaves_no_spans(server):
    assert not trace.on()
    assert _post(server, {"file": ("a.wav", _clip(2.0, 1))}) == 200
    assert trace.snapshot() == [] and trace.dropped() == 0


def test_profiler_session_turns_recording_on():
    # torch's own flag: a torch upgrade that drops it fails here, not as
    # empty per-layer metrics in the benchmark's traced runs
    assert not trace.on()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        assert trace.on()
        with trace.span("x"):
            pass
    finally:
        prof.stop()
    assert not trace.on()
    with trace.span("y"):
        pass
    assert [s.name for s in trace.snapshot()] == ["x"]


def test_enable_nests_and_ends():
    with trace.enable():
        with trace.enable():
            assert trace.on()
        assert trace.on()
    assert not trace.on()


# -- the served path's spans ------------------------------------------------------

def _concurrent(httpd, clips):
    errors, status = [], []

    def hit(data):
        try:
            status.append(_post(httpd, {"file": ("clip.wav", data)}))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=hit, args=(c,)) for c in clips]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors and status == [200] * len(clips), (errors, status)


def test_two_concurrent_requests_span_tree(server):
    w0 = _windows(server)
    with trace.enable():
        _concurrent(server, [_clip(3.0, 2), _clip(4.0, 3)])
    # a handler closes its request's span just after sending the response
    deadline = time.monotonic() + 10
    while (sum(s.name == "server.request" for s in trace.snapshot()) < 2
           and time.monotonic() < deadline):
        time.sleep(0.01)
    spans = trace.snapshot()
    by_sid = {s.sid: s for s in spans}
    reqs = [s for s in spans if s.name == "server.request"]
    assert len(reqs) == 2 and {r.rid for r in reqs} == {r.sid for r in reqs}
    rids = {r.rid for r in reqs}

    def root(s):
        while s.parent:
            s = by_sid[s.parent]
        return s

    names = set()
    for s in spans:
        names.add(s.name)
        r = root(s)
        assert r.name in ("server.request", "batch.round"), (s, r)
        # a request's spans carry its id; a round's carry none, and the
        # round names the requests it served
        assert s.rid == (r.sid if r.name == "server.request" else 0), s
        if s.parent:
            p = by_sid[s.parent]
            assert p.t0 <= s.t0 <= s.t1 <= p.t1, (p, s)
    assert {"server.read", "server.parse", "server.audio", "server.respond", "seek.mel",
            "seek.window", "encode", "encode.issue", "decode", "batch.wait",
            "batch.round", "round.prompt", "lock.wait", "lock.hold"} <= names
    rounds = [s for s in spans if s.name == "batch.round"]
    assert all(set(r.attrs["rids"]) <= rids for r in rounds)
    assert sum(r.attrs["windows"] for r in rounds) == _windows(server) - w0
    # one seek.window per window decoded
    assert sum(s.name == "seek.window" for s in spans) == _windows(server) - w0
    # a queued window's wait ends when its round is taken, before it runs
    for w in (s for s in spans if s.name == "batch.wait"):
        mine = [r for r in rounds if w.rid in r.attrs["rids"] and r.t1 >= w.t1]
        assert min(mine, key=lambda r: r.t1).t0 >= w.t1
    # outermost holds of the device lock never overlap, whatever the thread
    holds = sorted((s.t0, s.t1) for s in spans if s.name == "lock.hold")
    assert len({s.tid for s in spans if s.name == "lock.hold"}) >= 2
    assert all(a1 <= b0 for (_, a1), (b0, _) in zip(holds, holds[1:]))


def test_lock_spans_outermost_only_and_safe_across_toggles():
    with trace.enable():
        with DEVICE_LOCK:
            with DEVICE_LOCK:
                pass
    assert [s.name for s in trace.snapshot()] == ["lock.wait", "lock.hold"]
    trace.reset()
    # recording turns on inside a hold: that hold records nothing
    with DEVICE_LOCK:
        on = trace.enable()
    on.__exit__()
    assert trace.snapshot() == []
    # and off inside one: the hold begun while on is recorded, once
    on = trace.enable()
    with DEVICE_LOCK:
        on.__exit__()
    with DEVICE_LOCK:
        pass
    assert [s.name for s in trace.snapshot()] == ["lock.wait", "lock.hold"]
    assert not DEVICE_LOCK._depth and DEVICE_LOCK._hold is None


# -- the timers keep the waits apart ---------------------------------------------

def _hold_lock_for(seconds: float) -> threading.Thread:
    got = threading.Event()

    def hold():
        with DEVICE_LOCK:
            got.set()
            time.sleep(seconds)

    t = threading.Thread(target=hold)
    t.start()
    got.wait(10)
    return t


def test_encode_timer_leaves_out_the_lock_wait(model):
    ctx = W.load(model, device="cpu")
    with trace.enable():
        ctx.pcm_to_mel(np.zeros(16000, np.float32))
        t = _hold_lock_for(0.4)
        ctx.encode_window(0)
        t.join(10)
    enc = next(s for s in trace.snapshot() if s.name == "encode")
    tm = ctx.timings
    assert tm.t_lock_wait_us >= 350_000
    assert tm.t_encode_us < (enc.t1 - enc.t0) / 1e3 - 350_000
    assert abs(tm.t_encode_us + tm.t_lock_wait_us - (enc.t1 - enc.t0) / 1e3) <= 2
    mel = next(s for s in trace.snapshot() if s.name == "seek.mel")
    assert tm.t_mel_us == (mel.t1 - mel.t0) // 1000


def test_decode_timer_leaves_out_lock_and_batcher_waits(model):
    ctx = W.load(model, device="cpu")
    ctx.pcm_to_mel(np.zeros(16000, np.float32))
    ctx.encode_window(0)
    # two live workers and one request: it waits out the straggler deadline
    ctx.batcher = WindowBatcher(ctx, n_workers=2, max_wait_s=0.3)
    v = ctx.vocab
    prompt = [v.token_sot, v.lang_token(0), v.token_transcribe]
    ctx.timings.reset()
    with trace.enable():
        t = _hold_lock_for(0.3)
        ctx.decode_window_device(prompt, 1, 0.0, 0, 100, W.TranscribeParams(), False, 0)
        t.join(10)
    dec = next(s for s in trace.snapshot() if s.name == "decode")
    wait = next(s for s in trace.snapshot() if s.name == "batch.wait")
    tm = ctx.timings
    assert tm.t_lock_wait_us >= 250_000 and tm.t_batch_wait_us >= 250_000
    assert tm.t_batch_wait_us == (wait.t1 - wait.t0) // 1000
    total = (dec.t1 - dec.t0) / 1e3
    parts = tm.t_decode_us + tm.t_lock_wait_us + tm.t_batch_wait_us + tm.t_capture_us
    assert abs(parts - total) <= 3
    assert tm.t_decode_us < total - 500_000


def test_batcher_charges_its_rounds_lock_wait():
    class _Ctx:
        def _decode_window_exec(self, key, *args):
            return "ran", (0, 0)

    b = WindowBatcher(_Ctx(), n_workers=1)
    lock0, batch0 = trace.waits()
    t = _hold_lock_for(0.3)
    assert b.submit("k", ()) == ("ran", (0, 0))
    t.join(10)
    lock1, batch1 = trace.waits()
    assert lock1 - lock0 >= 250_000_000 and batch1 - batch0 < 50_000_000


# -- the benchmark's readers ----------------------------------------------------

def _rec(name, t0, t1, sid, parent=0, rid=0, tid=1):
    ms = 1_000_000
    return trace.Span(name, t0 * ms, t1 * ms, tid, rid, sid, parent)


# t in ms from 1000 s; the window is [1000 s, 1000.1 s]
T = 1_000_000
SPANS = [
    _rec("server.read", T + 1, T + 2, 2, 1, 1),
    _rec("server.parse", T + 2, T + 4, 3, 1, 1),
    _rec("seek.mel", T + 4, T + 10, 4, 1, 1),
    _rec("encode.issue", T + 11, T + 14, 7, 6, 1),
    _rec("lock.wait", T + 10, T + 11, 8, 5, 1),
    _rec("encode", T + 10, T + 20, 6, 5, 1),
    _rec("lock.hold", T + 11, T + 18, 9, 6, 1),
    _rec("batch.wait", T + 21, T + 25, 11, 10, 1),
    _rec("round.prompt", T + 26, T + 28, 13, 12, 0),
    _rec("lock.hold", T + 26, T + 40, 14, 12, 0, tid=2),
    _rec("batch.round", T + 25, T + 41, 12, 0, 0, tid=2),
    _rec("decode", T + 21, T + 42, 10, 5, 1),
    _rec("seek.window", T + 10, T + 50, 5, 1, 1),
    _rec("server.audio", T + 50, T + 53, 15, 1, 1),
    _rec("server.respond", T + 53, T + 57, 16, 1, 1),
    _rec("server.request", T + 0, T + 58, 1, 0, 1),
    # ended after the window: left out of means, clipped in shares
    _rec("lock.hold", T + 95, T + 130, 17, 0, 0),
    _rec("seek.window", T + 60, T + 120, 18, 0, 0),
]
EXPECTED = {
    "front_end_ms_per_request": 1 + 2 + 3 + 4,
    "mel_ms_per_request": 6,
    # 40 ms less encode (10-20) and decode (21-42): 9
    "host_ms_per_window": 9,
    "encode_issue_ms_per_window": 3,
    "prompt_issue_ms_per_round": 2,
    "batch_wait_ms_per_window": 4,
    "lock_wait_ms_per_window": 1,
    # held 11-18, 26-40, 95-100 of 100 ms
    "lock_free_share": 100 * (1 - 26 / 100),
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_fixed_span_list(name):
    from port_bench.run import _reader

    read = _reader(name)
    run = SimpleNamespace(t0=1000.0, t1=1000.1)
    assert read(run) is None
    trace._spans.extend(SPANS)
    assert read(run) == pytest.approx(EXPECTED[name], rel=1e-6)


# -- the multipart parse keeps every byte ----------------------------------------

@pytest.mark.parametrize("tail", [0x0A05, 0x0D00, 0x0A0D], ids=["lf", "cr", "crlf"])
def test_upload_ending_in_cr_or_lf_arrives_whole(server, monkeypatch, tail):
    x = (np.random.default_rng(tail).standard_normal(8001) * 3000).astype(np.int16)
    x[-1] = tail
    data = _wav(x)
    assert data[-2:] == int(tail).to_bytes(2, "little")
    got = []
    orig = TS.load_audio

    def load_audio(path):
        out = orig(path)
        got.append(out[0])
        return out

    monkeypatch.setattr(TS, "load_audio", load_audio)
    assert _post(server, {"file": ("clip.wav", data)}) == 200
    np.testing.assert_array_equal(got[0], x.astype(np.float32) / 32768.0)


@pytest.mark.parametrize("content", [b"\r\n", b"\n\rx\r\n", b"\r\n\r\nab\r", b""])
def test_parse_multipart_keeps_cr_and_lf(content):
    body = b"preamble\r\n" + _body({"a": ("", content), "b": ("f.bin", b"\n" + content)})
    fields = TS.parse_multipart(body, f"multipart/form-data; boundary={BOUNDARY}")
    assert fields == {"a": ("", content), "b": ("f.bin", b"\n" + content)}
