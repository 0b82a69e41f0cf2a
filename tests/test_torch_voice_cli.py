"""The port's voice-command CLIs against the JAX package's, on the CPU:
whisper-command (its guided scores and its main loop), whisper-talk,
whisper-lsp and wchess, on tests/test_torch_stream.py's DECISIVE file and
a seeded 5 s clip whose quiet last 1.5 s makes the energy VAD fire.

- command scores: each command's mean teacher-forced log-probability
  within 1e-4 of JAX's, for four commands of different token lengths.  The
  port's decode_step writes the cache in place, so the commands' branches
  share one cache (cli/command.py); a branch that read another's cells
  would move its score.
- command, talk and wchess: `main()` (the port with -ng) prints the same
  lines.  command and wchess only listen once 2 s have passed, so their
  file plays back in real time on chip_smoke.py's SimClock
  (--no-realtime would read it all before then and stop); talk reads it
  with --no-realtime and transcribes what it holds when the file ends,
  and its LLM is a local command (`head -c 32`).  The JAX package's
  grammar engine raises on the empty alternates of wchess's grammars,
  which the port's copy fixes (tests/test_torch_copies.py EDITS), so the
  JAX wchess runs with the port's two fixed functions.
- lsp: the same JSON-RPC responses from LspServer.dispatch over a source
  filled with the whole clip (as tests/test_lsp.py builds its fixture),
  and the port's Content-Length framing round-trips.
- the five CLIs are the JAX files with three edits: a docstring paragraph,
  -ng, and the context's device (and command.py's note on its cache).
"""

import io
import json
import re
from pathlib import Path

import numpy as np
import pytest

from test_torch_stream import HP, SimClock, torch_one_thread, voice_clip  # noqa: F401
from whisper_tpu.cli import command as JCMD
from whisper_tpu.cli import lsp as JLSP
from whisper_tpu.cli import stream as JS
from whisper_tpu.cli import talk as JTALK
from whisper_tpu.cli import wchess as JCHESS
from whisper_tpu.runtime.context import WhisperContext as JCtx
from whisper_tpu_torch.audio.io import write_wav
from whisper_tpu_torch.cli import command as TCMD
from whisper_tpu_torch.cli import lsp as TLSP
from whisper_tpu_torch.cli import stream as TS
from whisper_tpu_torch.cli import talk as TTALK
from whisper_tpu_torch.cli import wchess as TCHESS
from whisper_tpu_torch.runtime.context import WhisperContext as TCtx
from whisper_tpu_torch.utils.synth import write_synth_model

REPO = Path(__file__).resolve().parents[1]
COMMANDS = ["red", "green apple", "blue sky tonight", "stop the music now"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("voice")
    model = str(d / "decisive-q5_0.bin")
    write_synth_model(model, HP, seed=1, qtype="q5_0", decisive=True)
    wav = str(d / "audio-5s.wav")
    write_wav(wav, voice_clip(5.0, 1.5, seed=5))
    cmds = d / "commands.txt"
    cmds.write_text("\n".join(COMMANDS) + "\n")
    return model, wav, str(cmds)


@pytest.fixture(scope="module")
def ctxs(files):
    model = files[0]
    return JCtx.from_file(model), TCtx.from_file(model, device="cpu")


def test_command_scores_match_jax(files, ctxs):
    jctx, tctx = ctxs
    pcm = voice_clip(5.0, 1.5, seed=5)
    lengths = {len(tctx.vocab.tokenize(" " + c)) for c in COMMANDS}
    assert len(lengths) >= 3, lengths
    want = JCMD.score_commands(jctx, pcm, COMMANDS)
    got = TCMD.score_commands(tctx, pcm, COMMANDS)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # and again on the same context: nothing of the first call's cache leaks
    np.testing.assert_allclose(TCMD.score_commands(tctx, pcm, COMMANDS), got,
                               rtol=0, atol=0)


def _main_out(mod, stream, argv, capsys, monkeypatch, clock: bool):
    if clock:
        # the loop and the file source (cli/stream.py) on one simulated clock
        sim = SimClock()
        monkeypatch.setattr(mod, "time", sim)
        monkeypatch.setattr(stream, "time", sim)
    assert mod.main(argv) == 0
    return capsys.readouterr().out


def _jax_grammar_fixed(monkeypatch):
    """The JAX package's grammar engine raises on an empty alternate
    (tests/test_torch_copies.py EDITS); wchess's grammars have one in every
    position.  Its two functions take the port's fixed ones (GType is an
    IntEnum in both, so the port's code reads the JAX rules)."""
    import whisper_tpu.decoding.grammar as JG
    import whisper_tpu_torch.decoding.grammar as TG

    monkeypatch.setattr(JG, "_advance_stack", TG._advance_stack)
    monkeypatch.setattr(JG, "grammar_init", TG.grammar_init)


def test_jax_grammar_raises_on_the_chess_grammar():
    import whisper_tpu.decoding.grammar as JG
    import whisper_tpu_torch.decoding.grammar as TG
    from whisper_tpu.decoding import grammar_parser as JP
    from whisper_tpu_torch.decoding import grammar_parser as TP
    from whisper_tpu_torch.utils.chess import Chessboard

    gbnf = Chessboard().grammar()
    assert "?" in gbnf
    jp, tp = JP.parse(gbnf), TP.parse(gbnf)
    # past the leading " " the root rule reaches its optional group
    jg = JG.grammar_init(jp.rules, jp.start_rule_id("root"))
    with pytest.raises(ValueError, match="unexpected grammar element"):
        JG._accept_char(jg.rules, jg.stacks, ord(" "))
    tg = TG.grammar_init(tp.rules, tp.start_rule_id("root"))
    stacks = TG._accept_char(tg.rules, tg.stacks, ord(" "))
    for ch in "knight to f3":
        stacks = TG._accept_char(tg.rules, stacks, ord(ch))
        assert stacks, ch
    assert [] in stacks                      # the move is complete


@pytest.mark.parametrize("tool", ["command", "talk", "wchess"])
def test_voice_cli_matches_jax(files, tool, capsys, monkeypatch):
    model, wav, cmds = files
    mods = {"command": (JCMD, TCMD), "talk": (JTALK, TTALK),
            "wchess": (JCHESS, TCHESS)}[tool]
    argv = {"command": ["-m", model, "-f", wav, "-cmd", cmds],
            "talk": ["-m", model, "-f", wav, "--no-realtime", "-p", "Sam",
                     "-bn", "Echo", "--llm-cmd", "head -c 32", "-vms", "4000"],
            "wchess": ["-m", model, "-f", wav]}[tool]
    clock = tool != "talk"
    if tool == "wchess":
        _jax_grammar_fixed(monkeypatch)
    want = _main_out(mods[0], JS, argv, capsys, monkeypatch, clock)
    got = _main_out(mods[1], TS, argv + ["-ng"], capsys, monkeypatch, clock)
    assert got == want
    if tool == "command":
        assert re.search(r"detected command: .*(RED|GREEN|BLUE|STOP)", got)
    elif tool == "talk":
        assert "Sam:" in got and "Echo:" in got
    else:
        # the grammar is a logit penalty (100), which the decisive model's
        # margins outweigh, so what it heard need not be a legal move
        assert "White said: '" in got


def _lsp_calls():
    return [
        {"jsonrpc": "2.0", "id": 1, "method": "echo", "params": {"x": 1}},
        {"jsonrpc": "2.0", "id": 2, "method": "registerCommandset",
         "params": ["red", "green", "blue", "stop"]},
        {"jsonrpc": "2.0", "id": 3, "method": "registerCommandset",
         "params": ["red", "red"]},
        {"jsonrpc": "2.0", "id": 4, "method": "guided",
         "params": {"commandset_index": 0}},
        {"jsonrpc": "2.0", "id": 5, "method": "unguided", "params": {}},
        {"jsonrpc": "2.0", "id": 6, "method": "seek"},
        {"jsonrpc": "1.0", "id": 7, "method": "echo"},
    ]


def test_lsp_matches_jax(files, ctxs):
    wav = files[1]
    out = []
    for mod, ctx in ((JLSP, ctxs[0]), (TLSP, ctxs[1])):
        source = mod.FileAudioSource(wav, 30000, realtime=False)
        while not source.done:
            source.poll()
        server = mod.LspServer(ctx, source)
        out.append([server.dispatch(c) for c in _lsp_calls()])
    assert out[1] == out[0]
    res = {r["id"]: r for r in out[1]}
    assert res[4]["result"]["command_text"] in ("red", "green", "blue", "stop")
    assert res[5]["result"]["transcription"].strip()
    assert res[3]["error"]["code"] == -31000 and res[6]["error"]["code"] == -32601


def test_lsp_framing_roundtrip():
    buf = io.BytesIO()
    body = {"jsonrpc": "2.0", "id": 1, "result": {"a": [1, "b"]}}
    TLSP.write_message(buf, body)
    data = json.dumps(body).encode()
    assert buf.getvalue() == f"Content-Length: {len(data)}\r\n\r\n".encode() + data
    buf.seek(0)
    assert TLSP.read_message(buf) == body
    assert TLSP.read_message(buf) is None


NG = ('    ap.add_argument("-ng", "--no-gpu", action="store_true",\n'
      '                    help="run on the CPU instead of the CUDA card")\n')
CACHE_NOTE = (
    "    # decode the guiding prompt once; per-command caches branch off the\n"
    "    # (immutable) prompt cache\n",
    "    # decode the guiding prompt once; every command branches off it.  The\n"
    "    # port's decode_step writes the cache in place, so the branches share\n"
    "    # one cache: each command steps one token at a time from n_prefix and\n"
    "    # writes its cell before it reads it, so no branch reads a cell that an\n"
    "    # earlier branch (or the prompt's bucket padding) wrote\n")


@pytest.mark.parametrize("name", ["stream", "command", "talk", "lsp", "wchess"])
def test_cli_is_the_jax_file_with_ng(name):
    src = (REPO / "whisper_tpu" / "cli" / f"{name}.py").read_text()
    i = src.index('"""', 3)
    want = (src[:i].rstrip("\n")
            + f"\n\nPort of whisper_tpu/cli/{name}.py: the same loop over the port's\n"
            "WhisperContext and transcribe(), on the CUDA card; -ng runs it on the\n"
            "CPU (the reference tool's --no-gpu).\n" + src[i:])
    model_arg = '    ap.add_argument("-m", "--model", required=True)\n'
    want = want.replace(model_arg, model_arg + NG)
    want = want.replace("WhisperContext.from_file(args.model)",
                        "WhisperContext.from_file(args.model,\n"
                        '                                  device="cpu" if args.no_gpu '
                        "else None)")
    if name == "command":
        want = want.replace(*CACHE_NOTE)
    assert (REPO / "whisper_tpu_torch" / "cli" / f"{name}.py").read_text() == want
