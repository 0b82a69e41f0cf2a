"""Grammar-constrained decoding through the port's `transcribe`, on the
CPU, against the JAX package.

decoding/grammar.py and grammar_parser.py are verbatim copies
(tests/test_torch_copies.py); the host token loop applies the grammar as
the JAX package's does (grammar_init per attempt, the penalty in
process_logits, grammar_copy on beam forks, accept_token after each
token).  On the decisive file and wav of tests/test_torch_cli.py (its
fixtures are imported from there), with the committed
tests/data/text_parity/script.gbnf, at t = 0:
  * `transcribe` greedy and beam 5 on the first 20 s (one window; the
    grammar's host filter is Python over the vocabulary, ~50 ms a
    lane-step): identical segments and token ids;
  * -p 2 with a grammar takes the unbatched path, as in the JAX package:
    each chunk's windows run in turn through the host loop, and no batcher
    is built.
The whisper-cli with --grammar and --precision: test_torch_grammar_cli.py.
"""

import os

import pytest

import whisper_tpu as J
import whisper_tpu_torch as W
from test_torch_cli import REPO, files  # noqa: F401
from whisper_tpu.audio.io import load_audio
from whisper_tpu.decoding import grammar_parser as JGP
from whisper_tpu.decoding.parallel import transcribe_parallel as j_parallel
from whisper_tpu_torch.decoding import grammar_parser as TGP
from whisper_tpu_torch.decoding.parallel import transcribe_parallel as t_parallel
from whisper_tpu_torch.runtime import batching as TB

GRAMMAR = os.path.join(REPO, "tests", "data", "text_parity", "script.gbnf")


def _params(pkg, gp, strategy):
    p = (pkg.TranscribeParams.default(pkg.SamplingStrategy.BEAM_SEARCH)
         if strategy == "beam" else pkg.TranscribeParams())
    p.temperature_inc = 0.0
    with open(GRAMMAR) as f:
        parsed = gp.parse(f.read())
    p.grammar_rules = parsed.rules
    p.i_start_rule = parsed.start_rule_id("root")
    return p


def _summary(segs):
    return [(s.t0, s.t1, s.text, [t.id for t in s.tokens]) for s in segs]


@pytest.mark.parametrize("strategy", ["greedy", "beam"])
def test_transcribe_grammar_matches_jax(files, strategy):
    model, wav = files
    pcm = load_audio(wav)[0][:16000 * 20]
    ref = J.transcribe(J.load(model), _params(J, JGP, strategy), pcm)
    tctx = W.load(model, device="cpu")
    got = W.transcribe(tctx, _params(W, TGP, strategy), pcm)
    assert len(ref) >= 2
    assert _summary(got) == _summary(ref)
    assert not tctx._window_fns                  # the host loop only


def test_parallel_grammar_takes_the_unbatched_path(files, monkeypatch):
    built = []

    class Counted(TB.WindowBatcher):
        def __init__(self, *a, **kw):
            built.append(1)
            super().__init__(*a, **kw)

    monkeypatch.setattr(TB, "WindowBatcher", Counted)
    model, wav = files
    pcm, _ = load_audio(wav)
    ref = j_parallel(J.load(model), _params(J, JGP, "greedy"), pcm, 2)
    got = t_parallel(W.load(model, device="cpu"), _params(W, TGP, "greedy"), pcm, 2)
    assert len(ref) >= 2
    assert _summary(got) == _summary(ref)
    assert built == []
