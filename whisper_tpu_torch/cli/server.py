"""whisper-server: HTTP transcription service.

Port of whisper_tpu/cli/server.py, the analogue of examples/server/server.cpp
(httplib + nlohmann json there; Python stdlib ThreadingHTTPServer here):

  GET  {request_path}/                    hello
  POST {request_path}{inference_path}     multipart audio + whisper params
  POST {request_path}/load                hot-swap the model
  GET  {request_path}/health              liveness probe

Response formats: json (default), text, srt, vtt, verbose_json
(server.cpp:1000-1162).

    python -m whisper_tpu_torch.cli.server -m model.bin [--port 8080] [-p N]

It runs on the CUDA card (the context raises without one).  The lock of
ServerState guards only model load and hot swap; concurrent /inference
requests run in threads of their own against a shared read-only context,
and their window decodes coalesce through one server-wide WindowBatcher
into natively batched device calls (runtime/batching.py), where the
reference's whisper_mutex serializes whole requests (server.cpp:1219).
`-p/--processors` also chunk-splits each request, the
whisper_full_parallel role (server.cpp:211,990), the chunks joining the
same batcher.  `-vm FILE` names the Silero VAD model that requests with
vad=true run on the card before their window loop (the request's vad_*
fields set its parameters).

Each /inference request is a span, `server.request` (runtime/trace.py),
which gives the request its id; inside it the body's read, the multipart
parse, the audio (temporary file and WAV read) and the response
(formatting and sending) are spans of their own.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..audio.io import load_audio
from ..decoding.full import lang_auto_detect, transcribe
from ..decoding.languages import lang_str, lang_str_full, max_lang_id
from ..decoding.params import SamplingStrategy, TranscribeParams
from ..runtime.batching import WindowBatcher, transcribe_joining
from ..runtime import trace
from ..runtime.context import WhisperContext
from .output import estimate_diarization_speaker, to_timestamp


# --------------------------------------------------------------------------
# multipart/form-data parsing (httplib's req.files analogue)
# --------------------------------------------------------------------------

def parse_multipart(body: bytes, content_type: str) -> Dict[str, Tuple[str, bytes]]:
    """Returns {field_name: (filename, content)}.  A part's content is every
    byte between the CRLF that ends its header block and the CRLF that
    begins the next delimiter (RFC 2046 section 5.1.1): bytes of the
    content itself, CR and LF included, are kept."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise ValueError("multipart boundary missing")
    boundary = m.group(1).encode()
    out: Dict[str, Tuple[str, bytes]] = {}
    # a delimiter is CRLF "--" boundary; the first may open the body
    for part in (b"\r\n" + body).split(b"\r\n--" + boundary)[1:]:
        if part.startswith(b"--"):
            break           # the close delimiter
        # the rest of the delimiter's line (transport padding) and its CRLF
        part = part.partition(b"\r\n")[2]
        if b"\r\n\r\n" not in part:
            continue
        head, content = part.split(b"\r\n\r\n", 1)
        header = head.decode("utf-8", errors="replace")
        nm = re.search(r'name="([^"]*)"', header)
        if not nm:
            continue
        fm = re.search(r'filename="([^"]*)"', header)
        out[nm.group(1)] = (fm.group(1) if fm else "", content)
    return out


def parse_bool(s: str) -> bool:
    return s.strip().lower() in ("true", "1", "yes", "y")


# field -> (params attr, converter); mirrors get_req_parameters
# (server.cpp:480-640)
_PARAM_FIELDS = {
    "offset_t": ("offset_ms", int),
    "offset_n": ("offset_n", int),
    "duration": ("duration_ms", int),
    "max_context": ("n_max_text_ctx", int),
    "max_len": ("max_len", int),
    "audio_ctx": ("audio_ctx", lambda s: int(float(s))),
    "word_thold": ("thold_pt", float),
    "entropy_thold": ("entropy_thold", float),
    "logprob_thold": ("logprob_thold", float),
    "no_speech_thold": ("no_speech_thold", float),
    "debug_mode": ("debug_mode", parse_bool),
    "translate": ("translate", parse_bool),
    "tinydiarize": ("tdrz_enable", parse_bool),
    "split_on_word": ("split_on_word", parse_bool),
    "no_timestamps": ("no_timestamps", parse_bool),
    "token_timestamps": ("token_timestamps", parse_bool),
    "language": ("language", str),
    "detect_language": ("detect_language", parse_bool),
    "prompt": ("initial_prompt", str),
    "carry_initial_prompt": ("carry_initial_prompt", parse_bool),
    "temperature": ("temperature", float),
    "temperature_inc": ("temperature_inc", float),
    "suppress_non_speech": ("suppress_nst", parse_bool),
    "suppress_nst": ("suppress_nst", parse_bool),
    "vad": ("vad", parse_bool),
}
_VAD_FIELDS = {
    "vad_threshold": ("threshold", float),
    "vad_min_speech_duration_ms": ("min_speech_duration_ms", int),
    "vad_min_silence_duration_ms": ("min_silence_duration_ms", int),
    "vad_max_speech_duration_s": ("max_speech_duration_s", float),
    "vad_speech_pad_ms": ("speech_pad_ms", int),
    "vad_samples_overlap": ("samples_overlap", float),
}


class ServerState:
    def __init__(self, model_path: str, defaults: Optional[dict] = None,
                 n_processors: int = 1, batch_wait_s: float = 0.05,
                 device=None):
        # guards load/hot-swap only; inference runs lock-free on a snapshot
        self.lock = threading.Lock()
        self.device = device             # None: the CUDA card
        self.model_path = model_path
        self.ctx: Optional[WhisperContext] = None
        self.batcher = None
        self.defaults = defaults or {}
        self.n_processors = max(1, n_processors)
        self.batch_wait_s = batch_wait_s

    def get(self):
        """(ctx, batcher) snapshot; in-flight requests keep using the pair
        they grabbed even across a /load hot-swap."""
        with self.lock:
            if self.ctx is None:
                self.ctx = WhisperContext.from_file(self.model_path,
                                                    device=self.device)
                self.batcher = WindowBatcher(self.ctx, 0,
                                             max_wait_s=self.batch_wait_s)
            return self.ctx, self.batcher

    # kept for tests/back-compat
    def ensure_loaded(self):
        return self.get()[0]

    def load(self, model_path: str):
        ctx = WhisperContext.from_file(model_path, device=self.device)
        with self.lock:
            self.ctx = ctx
            self.batcher = WindowBatcher(ctx, 0, max_wait_s=self.batch_wait_s)
            self.model_path = model_path


def build_params(fields: Dict[str, Tuple[str, bytes]],
                 defaults: dict) -> Tuple[TranscribeParams, dict]:
    raw = {k: v[1].decode("utf-8", errors="replace") for k, v in fields.items()
           if k != "file"}
    strategy = SamplingStrategy.GREEDY
    if int(raw.get("beam_size", defaults.get("beam_size", -1))) > 1:
        strategy = SamplingStrategy.BEAM_SEARCH
    params = TranscribeParams.default(strategy)
    params.print_progress = False
    params.print_realtime = False
    for k, v in defaults.items():
        if hasattr(params, k):
            setattr(params, k, v)
    extra = {
        "response_format": raw.get("response_format", "json"),
        "diarize": parse_bool(raw.get("diarize", "false")),
        "offset_n": int(raw.get("offset_n", "0")),
        "no_language_probabilities": parse_bool(
            raw.get("no_language_probabilities", "false")),
    }
    for field, (attr, conv) in _PARAM_FIELDS.items():
        if field in raw:
            setattr(params, attr, conv(raw[field]))
    for field, (attr, conv) in _VAD_FIELDS.items():
        if field in raw:
            setattr(params.vad_params, attr, conv(raw[field]))
    if "best_of" in raw:
        params.greedy.best_of = int(raw["best_of"])
    if "beam_size" in raw:
        params.beam_search.beam_size = int(raw["beam_size"])
    if "token_timestamps" not in raw:
        params.token_timestamps = not params.no_timestamps
    return params, extra


# --------------------------------------------------------------------------
# response formatting (server.cpp:1000-1162)
# --------------------------------------------------------------------------

def output_str(segments, diarize: bool, stereo) -> str:
    out = []
    for s in segments:
        speaker = ""
        if diarize and stereo is not None:
            speaker = estimate_diarization_speaker(stereo, s.t0, s.t1)
        out.append(f"{speaker}{s.text}\n")
    return "".join(out)


def format_srt(segments, diarize, stereo, offset_n) -> str:
    out = []
    for i, s in enumerate(segments):
        speaker = (estimate_diarization_speaker(stereo, s.t0, s.t1)
                   if diarize and stereo is not None else "")
        out.append(f"{i + 1 + offset_n}\n{to_timestamp(s.t0, True)} --> "
                   f"{to_timestamp(s.t1, True)}\n{speaker}{s.text}\n\n")
    return "".join(out)


def format_vtt(segments, diarize, stereo) -> str:
    out = ["WEBVTT\n\n"]
    for s in segments:
        speaker = ""
        if diarize and stereo is not None:
            speaker = "<v Speaker%s>" % estimate_diarization_speaker(
                stereo, s.t0, s.t1, True)
        out.append(f"{to_timestamp(s.t0)} --> {to_timestamp(s.t1)}\n"
                   f"{speaker}{s.text}\n\n")
    return "".join(out)


def _utf8_trailing_needed(s: bytes) -> int:
    """How many continuation bytes the tail of `s` still needs."""
    if not s:
        return 0
    # walk back over continuation bytes
    i = len(s) - 1
    n_cont = 0
    while i >= 0 and (s[i] & 0xC0) == 0x80:
        n_cont += 1
        i -= 1
    if i < 0:
        return 0
    lead = s[i]
    if lead >= 0xF0:
        need = 3
    elif lead >= 0xE0:
        need = 2
    elif lead >= 0xC0:
        need = 1
    else:
        need = 0
    return max(0, need - n_cont)


def format_verbose_json(ctx, segments, params, extra, pcm, stereo) -> dict:
    lang_id_cur = getattr(ctx, "lang_id", 0)
    jres = {
        "task": "translate" if params.translate else "transcribe",
        "language": lang_str_full(lang_id_cur) or "english",
        "duration": float(len(pcm)) / 16000.0,
        "text": output_str(segments, extra["diarize"], stereo),
        "segments": [],
    }
    if not extra.get("no_language_probabilities") and not ctx.is_empty:
        if ctx.mel is None:
            ctx.pcm_to_mel(pcm)
        lid, probs = lang_auto_detect(ctx)
        jres["detected_language"] = lang_str_full(lid)
        jres["detected_language_probability"] = float(probs[lid])
        jres["language_probabilities"] = {
            lang_str(i): float(probs[i]) for i in range(max_lang_id() + 1)
            if probs[i] > 0.001
        }
    eot = ctx.vocab.token_eot
    for i, s in enumerate(segments):
        seg = {"id": i, "text": s.text}
        if not params.no_timestamps:
            seg["start"] = s.t0 * 0.01
            seg["end"] = s.t1 * 0.01
        if extra["diarize"] and stereo is not None:
            seg["speaker"] = estimate_diarization_speaker(stereo, s.t0, s.t1,
                                                          True)
        tokens_out: List[int] = []
        words = []
        total_logprob = 0.0
        toks = s.tokens
        j = 0
        while j < len(toks):
            t = toks[j]
            if t.id >= eot:
                j += 1
                continue
            tokens_out.append(t.id)
            word_bytes = ctx.vocab.token_str(t.id).encode("utf-8")
            word_t1 = t.t1
            while (j + 1 < len(toks)
                   and _utf8_trailing_needed(word_bytes) > 0
                   and toks[j + 1].id < eot):
                j += 1
                nxt = toks[j]
                tokens_out.append(nxt.id)
                word_bytes += ctx.vocab.token_str(nxt.id).encode("utf-8")
                if nxt.t1 > -1:
                    word_t1 = nxt.t1
                total_logprob += nxt.plog
            word = {"word": word_bytes.decode("utf-8", errors="replace")}
            if not params.no_timestamps and params.token_timestamps:
                word["start"] = t.t0 * 0.01
                word["end"] = word_t1 * 0.01
                word["t_dtw"] = getattr(t, "t_dtw", -1)
            word["probability"] = float(t.p)
            total_logprob += t.plog
            words.append(word)
            j += 1
        seg["tokens"] = tokens_out
        seg["words"] = words
        seg["temperature"] = params.temperature
        seg["avg_logprob"] = total_logprob / max(1, len(toks))
        seg["no_speech_prob"] = float(s.no_speech_prob)
        jres["segments"].append(seg)
    return jres


# --------------------------------------------------------------------------
# HTTP plumbing
# --------------------------------------------------------------------------

def make_handler(state: ServerState, request_path: str, inference_path: str):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _send(self, code: int, body: str, ctype: str):
            data = body.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.send_header("Access-Control-Allow-Origin", "*")
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, fmt, *args):
            print("%s - %s" % (self.address_string(), fmt % args),
                  file=sys.stderr)

        def do_GET(self):
            if self.path == request_path + "/health":
                self._send(200, json.dumps({"status": "ok"}),
                           "application/json")
            elif self.path in (request_path + "/", request_path or "/"):
                self._send(200, "whisper_tpu_torch server. usage: POST "
                           f"{request_path}{inference_path}", "text/html")
            else:
                self._send(404, json.dumps({"error": "not found"}),
                           "application/json")

        def do_OPTIONS(self):
            self.send_response(200)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Methods", "POST, OPTIONS")
            self.send_header("Access-Control-Allow-Headers", "*")
            self.send_header("Content-Length", "0")
            self.end_headers()

        def _read_body(self) -> bytes:
            n = int(self.headers.get("Content-Length", "0"))
            return self.rfile.read(n)

        def do_POST(self):
            try:
                if self.path == request_path + inference_path:
                    self._inference()
                elif self.path == request_path + "/load":
                    self._load()
                else:
                    self._send(404, json.dumps({"error": "not found"}),
                               "application/json")
            except Exception as e:  # noqa: BLE001 — server must not die
                self._send(500, json.dumps({"error": str(e)}),
                           "application/json")

        def _load(self):
            fields = parse_multipart(self._read_body(),
                                     self.headers.get("Content-Type", ""))
            if "model" not in fields:
                self._send(400, json.dumps(
                    {"error": "no 'model' field in the request"}),
                    "application/json")
                return
            path = fields["model"][1].decode("utf-8").strip()
            if not os.path.exists(path):
                self._send(400, json.dumps(
                    {"error": f"model file not found: {path}"}),
                    "application/json")
                return
            state.load(path)
            self._send(200, json.dumps({"status": "ok", "model": path}),
                       "application/json")

        def _inference(self):
            with trace.span("server.request", request=True):
                self._infer()

        def _infer(self):
            with trace.span("server.read"):
                body = self._read_body()
            with trace.span("server.parse"):
                fields = parse_multipart(body, self.headers.get("Content-Type", ""))
            if "file" not in fields:
                self._send(400, json.dumps(
                    {"error": "no 'file' field in the request"}),
                    "application/json")
                return
            fname, blob = fields["file"]
            suffix = os.path.splitext(fname)[1] or ".wav"
            with trace.span("server.audio"):
                with tempfile.NamedTemporaryFile(suffix=suffix, delete=False) as tf:
                    tf.write(blob)
                    tmp = tf.name
                try:
                    pcm, stereo = load_audio(tmp)
                except Exception as e:  # noqa: BLE001
                    os.unlink(tmp)
                    self._send(400, json.dumps(
                        {"error": f"failed to read audio: {e}"}),
                        "application/json")
                    return
                os.unlink(tmp)

            params, extra = build_params(fields, state.defaults)
            fmt = extra["response_format"]
            ctx, batcher = state.get()
            if state.n_processors > 1:
                from ..decoding.parallel import transcribe_parallel

                segments = transcribe_parallel(
                    ctx, params, pcm, state.n_processors, batcher=batcher)
                # per-request clone for verbose_json's language probe —
                # the shared ctx must stay mutation-free across requests
                req_ctx = ctx.clone_state()
            else:
                segments, req_ctx = transcribe_joining(ctx, params, pcm,
                                                       batcher)
            with trace.span("server.respond"):
                self._respond(fmt, segments, extra, stereo, params, req_ctx, pcm)

        def _respond(self, fmt, segments, extra, stereo, params, req_ctx, pcm):
            if fmt == "text":
                self._send(200, output_str(segments, extra["diarize"],
                                           stereo),
                           "text/html; charset=utf-8")
            elif fmt == "srt":
                self._send(200, format_srt(segments, extra["diarize"],
                                           stereo, extra["offset_n"]),
                           "application/x-subrip")
            elif fmt == "vtt":
                self._send(200, format_vtt(segments, extra["diarize"],
                                           stereo), "text/vtt")
            elif fmt == "verbose_json":
                self._send(200, json.dumps(
                    format_verbose_json(req_ctx, segments, params, extra,
                                        pcm, stereo),
                    ensure_ascii=False), "application/json")
            else:
                self._send(200, json.dumps(
                    {"text": output_str(segments, extra["diarize"],
                                        stereo)},
                    ensure_ascii=False), "application/json")

    return Handler


def serve(model_path: str, host: str = "127.0.0.1", port: int = 8080,
          request_path: str = "", inference_path: str = "/inference",
          defaults: Optional[dict] = None,
          n_processors: int = 1, device=None) -> ThreadingHTTPServer:
    """The server, not yet serving; `device` "cpu" runs the plain PyTorch
    path (the tests), None the CUDA card."""
    state = ServerState(model_path, defaults, n_processors=n_processors,
                        device=device)
    handler = make_handler(state, request_path, inference_path)
    httpd = ThreadingHTTPServer((host, port), handler)
    httpd.whisper_state = state  # for tests
    return httpd


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="whisper-server")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--request-path", default="")
    ap.add_argument("--inference-path", default="/inference")
    ap.add_argument("-l", "--language", default="en")
    ap.add_argument("-vm", "--vad-model", default=None)
    ap.add_argument("-p", "--processors", type=int, default=1,
                    help="chunk-split each request across N parallel decode "
                         "states (whisper_full_parallel role, "
                         "server.cpp:211)")
    ap.add_argument("-ng", "--no-gpu", action="store_true",
                    help="run on the CPU (the plain PyTorch path)")
    args = ap.parse_args(argv)

    defaults = {"language": args.language}
    if args.vad_model:
        defaults["vad_model_path"] = args.vad_model
    httpd = serve(args.model, args.host, args.port, args.request_path,
                  args.inference_path, defaults,
                  n_processors=args.processors,
                  device="cpu" if args.no_gpu else None)
    httpd.whisper_state.ensure_loaded()
    print(f"whisper server listening at http://{args.host}:{args.port}",
          file=sys.stderr)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
