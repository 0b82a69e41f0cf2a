"""Language-server-protocol style voice interface
(reference: examples/lsp/lsp.cpp).

JSON-RPC 2.0 over stdin/stdout with Content-Length framing.  Methods:
  unguided            VAD-gated short transcription ({"prompt", "no_context",
                      "timestamp"} params)
  guided              pick the most likely command from a registered
                      commandset by the first-token probability behind the
                      guiding prompt (lsp.cpp:205-289)
  registerCommandset  tokenize a list of commands -> {"index": N}
  echo                returns params
  seek                unsupported (error -32601), like the reference

Audio comes from --file (played back in real time) or --no-realtime for
batch processing; stdin carries the protocol, so raw-PCM stdin capture is
not available here.

Port of whisper_tpu/cli/lsp.py: the same loop over the port's
WhisperContext and transcribe(), on the CUDA card; -ng runs it on the
CPU (the reference tool's --no-gpu).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import numpy as np

from ..audio.energy_vad import vad_simple
from ..decoding.full import transcribe
from ..decoding.params import SamplingStrategy, TranscribeParams
from ..runtime.context import WhisperContext
from .stream import FileAudioSource, SAMPLE_RATE


class RpcError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.payload = {"code": code, "message": message}


class Commandset:
    def __init__(self, first_tokens: List[int], plaintexts: List[str],
                 prompt_tokens: List[int]):
        self.first_tokens = first_tokens
        self.plaintexts = plaintexts
        self.prompt_tokens = prompt_tokens


class LspServer:
    def __init__(self, ctx: WhisperContext, source, language: str = "en",
                 max_tokens: int = 32, audio_ctx: int = 0):
        self.ctx = ctx
        self.source = source
        self.language = language
        self.max_tokens = max_tokens
        self.audio_ctx = audio_ctx
        self.commandsets: List[Commandset] = []

    # -- audio ----------------------------------------------------------------

    def wait_for_vad(self, maxlength_ms: int, timeout_s: float = 30.0
                     ) -> np.ndarray:
        """Wait for end-of-speech (lsp.cpp:115-157) and return the audio."""
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout_s and not self.source.done:
            self.source.poll()
            probe = self.source.get(2000)
            if len(probe) and vad_simple(probe, SAMPLE_RATE, 1000, 0.6, 100.0):
                return self.source.get(maxlength_ms)
            time.sleep(0.01)
        if self.source.done:
            return self.source.get(maxlength_ms)
        raise RpcError(-32803, "timed out waiting for speech")

    # -- methods ----------------------------------------------------------------

    def unguided(self, jparams: dict) -> dict:
        pcm = self.wait_for_vad(int(jparams.get("maxlength_ms", 10000)))
        params = TranscribeParams.default(SamplingStrategy.GREEDY)
        params.print_progress = False
        params.no_timestamps = True
        params.single_segment = True
        params.no_context = bool(jparams.get("no_context", True))
        params.max_tokens = self.max_tokens
        params.language = self.language
        params.audio_ctx = self.audio_ctx
        params.suppress_nst = True
        if "prompt" in jparams:
            params.initial_prompt = str(jparams["prompt"])
        segments = transcribe(self.ctx, params, pcm)
        text = segments[0].text if segments else ""
        return {"transcription": text, "timestamp": 0}

    def register_commandset(self, jparams) -> dict:
        vocab = self.ctx.vocab
        firsts: List[int] = []
        texts: List[str] = []
        seen = set()
        prompt = " select one from the available words: "
        for s in jparams:
            toks = vocab.tokenize(" " + s)
            if not toks:
                raise RpcError(-31000, f"failed to tokenize command: {s}")
            if toks[0] in seen:
                raise RpcError(-31000, f"Duplicate token in token set: {s}")
            seen.add(toks[0])
            firsts.append(toks[0])
            texts.append(s)
            prompt += s + ", "
        prompt = prompt[:-2] + ". Selected word:"
        cs = Commandset(firsts, texts, vocab.tokenize(prompt))
        self.commandsets.append(cs)
        return {"index": len(self.commandsets) - 1}

    def guided(self, jparams: dict) -> dict:
        if not self.commandsets:
            raise RpcError(-32803, "no commandset registered")
        idx = int(jparams.get("commandset_index", len(self.commandsets) - 1))
        cs = self.commandsets[idx]
        pcm = self.wait_for_vad(2000)

        ctx = self.ctx
        vocab = ctx.vocab
        ctx.pcm_to_mel(pcm)
        ctx.encode_window(0, self.audio_ctx)
        init = [vocab.token_sot]
        if vocab.is_multilingual:
            init += [vocab.lang_token(ctx.lang_id), vocab.token_transcribe]
        init += [vocab.token_not]
        seq = np.asarray([init + cs.prompt_tokens], np.int32)
        cache = ctx.new_cache(1)
        logits, _ = ctx.decode(seq, 0, cache)
        row = np.asarray(logits[0], np.float64)
        row -= row.max()
        probs = np.exp(row)
        probs /= probs.sum()
        scores = [float(probs[t]) for t in cs.first_tokens]
        best = int(np.argmax(scores))
        return {"command_index": best, "command_text": cs.plaintexts[best],
                "timestamp": 0}

    # -- protocol ----------------------------------------------------------------

    def dispatch(self, body: dict) -> dict:
        rid = body.get("id")
        try:
            if body.get("jsonrpc") != "2.0":
                raise RpcError(-3260, "invalid jsonrpc version")
            method = body.get("method", "")
            jparams = body.get("params", {})
            if method == "unguided":
                res = self.unguided(jparams)
            elif method == "guided":
                res = self.guided(jparams)
            elif method == "registerCommandset":
                res = self.register_commandset(jparams)
            elif method == "echo":
                res = jparams
            elif method == "seek":
                raise RpcError(-32601, "Seeking is not yet supported.")
            else:
                raise RpcError(-32601, f"unknown method '{method}'")
            return {"jsonrpc": "2.0", "result": res, "id": rid}
        except RpcError as e:
            return {"jsonrpc": "2.0", "error": e.payload, "id": rid}


def read_message(stream) -> Optional[dict]:
    """Content-Length framed JSON (LSP base protocol)."""
    headers = {}
    line = stream.readline()
    if not line:
        return None
    while line.strip():
        if b":" in line:
            k, v = line.split(b":", 1)
            headers[k.strip().lower()] = v.strip()
        line = stream.readline()
        if not line:
            return None
    n = int(headers.get(b"content-length", b"0"))
    return json.loads(stream.read(n)) if n else None


def write_message(stream, body: dict) -> None:
    data = json.dumps(body).encode("utf-8")
    stream.write(f"Content-Length: {len(data)}\r\n\r\n".encode())
    stream.write(data)
    stream.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="whisper-lsp")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-ng", "--no-gpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    ap.add_argument("-f", "--file", required=True,
                    help="audio source file (stdin carries the protocol)")
    ap.add_argument("--no-realtime", action="store_true")
    ap.add_argument("-l", "--language", default="en")
    ap.add_argument("-ac", "--audio-ctx", type=int, default=0)
    ap.add_argument("-mt", "--max-tokens", type=int, default=32)
    args = ap.parse_args(argv)

    ctx = WhisperContext.from_file(args.model,
                                  device="cpu" if args.no_gpu else None)
    source = FileAudioSource(args.file, 30000, realtime=not args.no_realtime)
    server = LspServer(ctx, source, args.language, args.max_tokens,
                       args.audio_ctx)
    while True:
        body = read_message(sys.stdin.buffer)
        if body is None:
            return 0
        write_message(sys.stdout.buffer, server.dispatch(body))


if __name__ == "__main__":
    sys.exit(main())
