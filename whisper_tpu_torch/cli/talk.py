"""Voice chat (reference: examples/talk-llama/talk-llama.cpp).

The reference vendors a full llama.cpp runtime; the TPU-native build keeps
the conversation loop — energy-VAD capture → whisper STT → rolling dialog
transcript → generate the assistant turn → optional TTS shell-out
(speak_with_file, examples/common-whisper.cpp:229) — and makes the text
generator pluggable instead of vendored:

  --llm-cmd CMD   pipe the dialog prompt to a shell command's stdin and read
                  the continuation from its stdout (works with
                  `llama-cli -f /dev/stdin`, an API wrapper script, ...);
  --llm-url URL   POST {"prompt", "n_predict", "stop"} to a llama.cpp-server
                  compatible /completion endpoint and read .content;
  (neither)       echo mode: the assistant repeats what it heard — lets the
                  audio→STT→dialog→TTS loop run with no LLM installed.

The dialog prompt is the reference's k_prompt_llama template verbatim
(talk-llama.cpp:277-293) with {0}=person, {1}=bot, {2}=time, {3}=year,
{4}=chat separator, and generation stops at the person's reverse prompt
(talk-llama.cpp:562-566).

Port of whisper_tpu/cli/talk.py: the same loop over the port's
WhisperContext and transcribe(), on the CUDA card; -ng runs it on the
CPU (the reference tool's --no-gpu).
"""

from __future__ import annotations

import argparse
import datetime
import json
import re
import subprocess
import sys
import time
import urllib.request

import numpy as np

from ..audio.energy_vad import vad_simple
from ..decoding.full import transcribe
from ..decoding.params import SamplingStrategy, TranscribeParams
from ..runtime.context import WhisperContext
from .stream import FileAudioSource, SAMPLE_RATE, StdinAudioSource

CHAT_SYMB = ":"

# talk-llama.cpp:275
K_PROMPT_WHISPER = "A conversation with a person called {1}."

# talk-llama.cpp:277-293
K_PROMPT_LLAMA = """\
Text transcript of a never ending dialog, where {0} interacts with an AI \
assistant named {1}.
{1} is helpful, kind, honest, friendly, good at writing and never fails to \
answer {0}'s requests immediately and with details and precision.
There are no annotations like (30 seconds passed...) or (to himself), just \
what {0} and {1} say aloud to each other.
The transcript only includes text, it does not include markup like HTML and \
Markdown.
{1} responds with short and concise answers.

{0}{4} Hello, {1}!
{1}{4} Hello {0}! How may I help you today?
{0}{4} What time is it?
{1}{4} It is {2} o'clock.
{0}{4} What year is it?
{1}{4} We are in {3}.
{0}{4} What is a cat?
{1}{4} A cat is a domestic species of small carnivorous mammal. It is the \
only domesticated species in the family Felidae.
{0}{4} Name a color.
{1}{4} Blue
{0}{4}"""


def build_prompt(template: str, person: str, bot: str,
                 now: datetime.datetime) -> str:
    """{0}..{4} substitution (talk-llama.cpp:396-430)."""
    out = " " + template
    out = out.replace("{0}", person).replace("{1}", bot)
    out = out.replace("{2}", now.strftime("%H:%M"))
    out = out.replace("{3}", str(now.year))
    return out.replace("{4}", CHAT_SYMB)


def clean_heard(text: str) -> str:
    """The reference strips [..]/(..) annotations and non-text characters
    from the transcription before feeding the LLM (talk-llama.cpp:623-637)."""
    text = re.sub(r"\[.*?\]", "", text)
    text = re.sub(r"\(.*?\)", "", text)
    text = re.sub(r"[^a-zA-Z0-9\.,\?!\s:'\-]", "", text)
    return text.strip()


def cut_at_stops(text: str, stops) -> str:
    for s in stops:
        i = text.find(s)
        if i >= 0:
            text = text[:i]
    return text


class LLM:
    """Pluggable assistant-turn generator over the rolling transcript."""

    def __init__(self, cmd=None, url=None, n_predict=64):
        self.cmd, self.url, self.n_predict = cmd, url, n_predict

    def generate(self, prompt: str, stops) -> str:
        if self.cmd:
            proc = subprocess.run(self.cmd, shell=True, input=prompt,
                                  capture_output=True, text=True)
            out = proc.stdout
            # commands that echo the prompt back (llama-cli) return
            # prompt+continuation; keep only the continuation
            if out.startswith(prompt):
                out = out[len(prompt):]
            return cut_at_stops(out, stops).strip()
        if self.url:
            req = urllib.request.Request(
                self.url,
                data=json.dumps({"prompt": prompt,
                                 "n_predict": self.n_predict,
                                 "stop": list(stops)}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req) as resp:
                return cut_at_stops(
                    json.loads(resp.read()).get("content", ""), stops).strip()
        return ""  # echo mode handled by the caller


def speak_with_file(command: str, text: str, path: str, voice_id: int) -> bool:
    """TTS shell-out (examples/common-whisper.cpp:229-244)."""
    try:
        with open(path, "w") as f:
            f.write(text)
    except OSError:
        print("speak_with_file: failed to open speak_file", file=sys.stderr)
        return False
    ret = subprocess.call(f"{command} {voice_id} {path}", shell=True)
    if ret != 0:
        print("speak_with_file: failed to speak", file=sys.stderr)
        return False
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="whisper-talk")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-ng", "--no-gpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    ap.add_argument("-f", "--file", default=None)
    ap.add_argument("--stdin", choices=["s16", "f32"], default=None)
    ap.add_argument("-c", "--capture", default=None,
                    help="capture device for the live microphone")
    ap.add_argument("--no-realtime", action="store_true")
    ap.add_argument("-p", "--person", default="Georgi")
    ap.add_argument("-bn", "--bot-name", default="Assistant")
    ap.add_argument("--prompt", default="",
                    help="custom dialog template ({0}..{4} placeholders)")
    ap.add_argument("--llm-cmd", default=None,
                    help="shell command: prompt on stdin -> reply on stdout")
    ap.add_argument("--llm-url", default=None,
                    help="llama.cpp-server /completion endpoint")
    ap.add_argument("-n", "--n-predict", type=int, default=64)
    ap.add_argument("-s", "--speak", default=None, help="TTS command")
    ap.add_argument("-sf", "--speak-file", default="/tmp/to_speak.txt")
    ap.add_argument("--voice-id", type=int, default=2)
    ap.add_argument("-l", "--language", default="en")
    ap.add_argument("-mt", "--max-tokens", type=int, default=32)
    ap.add_argument("-vth", "--vad-thold", type=float, default=0.6)
    ap.add_argument("-fth", "--freq-thold", type=float, default=100.0)
    ap.add_argument("-vms", "--voice-ms", type=int, default=10000)
    args = ap.parse_args(argv)

    ctx = WhisperContext.from_file(args.model,
                                  device="cpu" if args.no_gpu else None)
    length_ms = max(args.voice_ms, 30000)
    if args.file:
        source = FileAudioSource(args.file, length_ms,
                                 realtime=not args.no_realtime)
    elif args.stdin:
        source = StdinAudioSource(args.stdin, length_ms)
    else:
        from .stream import MicAudioSource

        try:
            source = MicAudioSource(length_ms, device=args.capture)
        except RuntimeError as e:
            print(f"error: {e} (use --file or --stdin)", file=sys.stderr)
            return 1

    person, bot = args.person, args.bot_name
    dialog = build_prompt(args.prompt or K_PROMPT_LLAMA, person, bot,
                          datetime.datetime.now())
    stops = [f"{person}{CHAT_SYMB}", f"\n{person}"]
    llm = LLM(args.llm_cmd, args.llm_url, args.n_predict)

    print(f"{bot} ready — start speaking", file=sys.stderr)
    t_last = time.monotonic()
    flushed = False
    while True:
        source.poll()
        if source.done:
            # flush whatever is buffered as a last utterance (file mode)
            if flushed:
                break
            flushed = True
            pcm = source.get(args.voice_ms)
            if len(pcm) == 0:
                break
        else:
            if (time.monotonic() - t_last) < 2.0:
                time.sleep(0.01)
                continue
            probe = source.get(2000)
            if len(probe) == 0 or not vad_simple(
                    probe, SAMPLE_RATE, 1250, args.vad_thold,
                    args.freq_thold):
                time.sleep(0.01)
                continue
            t_last = time.monotonic()
            pcm = source.get(args.voice_ms)

        params = TranscribeParams.default(SamplingStrategy.GREEDY)
        params.print_progress = False
        params.single_segment = True
        params.no_timestamps = True
        params.language = args.language
        params.max_tokens = args.max_tokens
        params.initial_prompt = K_PROMPT_WHISPER.replace("{1}", bot)
        heard = clean_heard("".join(
            s.text for s in transcribe(ctx, params, pcm)))
        if not heard:
            continue
        print(f"{person}{CHAT_SYMB} {heard}")

        dialog += f" {heard}\n{bot}{CHAT_SYMB}"
        if args.llm_cmd or args.llm_url:
            reply = llm.generate(dialog, stops)
        else:
            reply = f"You said: {heard}"  # echo mode (no LLM configured)
        reply = reply or "..."
        dialog += f" {reply}\n{person}{CHAT_SYMB}"
        print(f"{bot}{CHAT_SYMB} {reply}")

        if args.speak:
            speak_with_file(args.speak, reply, args.speak_file, args.voice_id)
    return 0


if __name__ == "__main__":
    sys.exit(main())
