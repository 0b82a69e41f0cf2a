"""The port's framework-free modules are copies of the JAX package's.

Verbatim copies must stay byte-identical to their originals (relative
imports resolve inside each package, so no line differs); a copy that
fixes a fault of its original is the original with the replacements of
EDITS.  The two edited
copies are held to the originals by behaviour: formats/quants.py (the
optional native fast path dropped) and audio/mel.py (its numpy path here;
the device mel in tests/test_torch_vad.py).
The same synthetic file through both loaders gives equal arrays, planes,
vocab and hyperparameters.
"""

import dataclasses
import inspect
import pathlib
from dataclasses import asdict

import numpy as np
import pytest

import whisper_tpu.audio.mel as JMEL
import whisper_tpu.formats.quants as JQ
from whisper_tpu.models.whisper import load as JLOAD

import whisper_tpu_torch.audio.mel as TMEL
import whisper_tpu_torch.formats.quants as TQ
from whisper_tpu_torch.models.whisper import load as TLOAD
from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
from whisper_tpu_torch.utils.synth import write_synth_model

REPO = pathlib.Path(__file__).resolve().parents[1]

VERBATIM = [
    "models/whisper/hparams.py", "models/whisper/load.py",
    "models/whisper/writer.py", "formats/container.py", "formats/kquants.py",
    "formats/iquants.py", "formats/iq_tables.py", "formats/iq_grids.npz",
    "decoding/tokenizer.py", "decoding/languages.py", "decoding/logits.py",
    "decoding/grammar.py", "decoding/grammar_parser.py",
    "decoding/params.py", "decoding/sampling.py", "decoding/stdrng.py",
    "decoding/timestamps.py", "runtime/timings.py", "audio/io.py",
    "models/vad/writer.py", "models/parakeet/__init__.py",
    "models/parakeet/hparams.py", "models/parakeet/tokenizer.py",
    "models/parakeet/writer.py", "models/parakeet/load.py", "formats/requant.py",
    "cli/parakeet_quantize.py", "audio/energy_vad.py", "audio/capture.py",
    "utils/chess.py", "formats/imatrix.py", "formats/iq_encode.py",
    "formats/gguf.py", "cli/quantize.py", "evals/__init__.py", "evals/wer.py",
    "evals/data/english_spellings.json", "evals/data/LICENSE",
]

HP = WhisperHParams(n_vocab=51865, n_audio_ctx=64, n_audio_state=64,
                    n_audio_head=1, n_audio_layer=1, n_text_ctx=32,
                    n_text_state=64, n_text_head=1, n_text_layer=2, n_mels=80)


# copies that fix a fault of the original: the original with these
# replacements made is the copy, byte for byte.  decoding/grammar.py: an
# empty alternate (`x?`) pushes no frame, as in the reference's
# whisper_grammar_advance_stack and whisper_grammar_init; the JAX
# package's copy pushes its END element and raises "unexpected grammar
# element" (wchess's grammars have one in every position)
EDITS = {
    "decoding/grammar.py": [
        (b"""        while True:
            ns = next_stack + [(sub_id, i)]
            _advance_stack(rules, ns, out)""",
         b"""        while True:
            # an empty alternate (`x?`, `(a | )`) adds no frame, as in the
            # reference; the JAX package's copy pushes its END and raises
            ns = next_stack + ([] if _is_end_of_sequence(sub[i]) else [(sub_id, i)])
            _advance_stack(rules, ns, out)"""),
        (b"""    while True:
        _advance_stack(rules, [(start_rule, i)], stacks)""",
         b"""    while True:
        _advance_stack(rules, [] if _is_end_of_sequence(rule[i]) else [(start_rule, i)],
                       stacks)"""),
    ],
}


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy(rel):
    a = (REPO / "whisper_tpu" / rel).read_bytes()
    b = (REPO / "whisper_tpu_torch" / rel).read_bytes()
    for old, new in EDITS.get(rel, ()):
        assert a.count(old) == 1, (rel, old)
        a = a.replace(old, new)
    assert a == b, f"whisper_tpu_torch/{rel} drifted from whisper_tpu/{rel}"


def test_output_writers_are_a_copy():
    # one deliberate difference: the JSON's fixed "systeminfo" names the port
    a = (REPO / "whisper_tpu" / "cli" / "output.py").read_text().splitlines()
    b = (REPO / "whisper_tpu_torch" / "cli" / "output.py").read_text().splitlines()
    assert len(a) == len(b)
    diff = [(x, y) for x, y in zip(a, b) if x != y]
    assert diff == [('        "systeminfo": "whisper_tpu (JAX/XLA/Pallas)",',
                     '        "systeminfo": "whisper_tpu_torch (PyTorch/CUDA)",')]


def test_logging_levels_are_a_copy():
    import whisper_tpu.runtime.logging as JL
    import whisper_tpu_torch.runtime.logging as TL

    assert ([(k, int(v)) for k, v in TL.LogLevel.__members__.items()]
            == [(k, int(v)) for k, v in JL.LogLevel.__members__.items()])
    for fn in ("_default_callback", "log_set", "log", "log_info", "log_warn",
               "log_error"):
        assert inspect.getsource(getattr(TL, fn)) == inspect.getsource(getattr(JL, fn))
    assert TL.print_system_info().startswith("WHISPER_TPU_TORCH : torch = ")


@pytest.mark.parametrize("fn", ["hann_window", "pad_audio", "mel_frame_counts",
                                "_log_mel_numpy"])
def test_mel_numpy_functions_are_copies(fn):
    assert inspect.getsource(getattr(TMEL, fn)) == inspect.getsource(getattr(JMEL, fn))


def test_log_mel_matches():
    rng = np.random.default_rng(0)
    filters = np.abs(rng.standard_normal((80, 201))).astype(np.float32)
    pcm = (0.1 * rng.standard_normal(16000 * 3)).astype(np.float32)
    ma, na = JMEL.LogMel(filters, backend="numpy")(pcm)
    mb, nb = TMEL.LogMel(filters)(pcm)
    assert na == nb
    np.testing.assert_array_equal(ma, mb)
    with pytest.raises(NotImplementedError):
        TMEL.LogMel(filters, backend="native")


@pytest.mark.parametrize("qtype", ["Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0",
                                   "Q4_K", "Q5_K", "Q6_K", "IQ4_NL"])
def test_quant_codecs_match(qtype):
    t = getattr(JQ, "GGML_TYPE_" + qtype)
    assert t == getattr(TQ, "GGML_TYPE_" + qtype)
    x = np.random.default_rng(1).standard_normal((4, 512)).astype(np.float32)
    raw = TQ.quantize(x, t)
    assert raw == JQ.quantize(x, t)
    np.testing.assert_array_equal(TQ.dequantize(raw, t, x.size),
                                  JQ.dequantize(raw, t, x.size))
    pa, pb = JQ.unpack_to_planes(raw, t, x.shape), TQ.unpack_to_planes(raw, t, x.shape)
    np.testing.assert_array_equal(pa.codes, pb.codes)
    np.testing.assert_array_equal(pa.scales, pb.scales)
    assert (pa.mins is None) == (pb.mins is None)
    if pa.mins is not None:
        np.testing.assert_array_equal(pa.mins, pb.mins)


def test_quant_grid_encoders_refused():
    # the grid formats encode (formats/iq_encode.py, tests/test_torch_quantize.py)
    # but, as in the JAX package and the reference, only with an importance
    # matrix: without one both packages refuse
    x = np.zeros((1, 256), np.float32)
    for t in (TQ.GGML_TYPE_IQ2_XXS, TQ.GGML_TYPE_IQ1_S, TQ.GGML_TYPE_IQ3_S):
        msgs = []
        for mod in (JQ, TQ):
            with pytest.raises(NotImplementedError) as e:
                mod.quantize(x, t)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1] and "importance matrix" in msgs[1]


@pytest.fixture(scope="module")
def synth_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("synth") / "m.bin"
    write_synth_model(str(path), HP, seed=3, qtype="q5_0")
    return str(path)


def _assert_tree_equal(a, b, where="params"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{where}.{k}")
    else:
        np.testing.assert_array_equal(a, b, err_msg=where)


def test_loaders_agree(synth_file):
    ja = JLOAD.load_model(synth_file)
    tb = TLOAD.load_model(synth_file)
    assert asdict(ja.hparams) == asdict(tb.hparams)
    assert tb.hparams == dataclasses.replace(HP, ftype=tb.hparams.ftype)
    np.testing.assert_array_equal(ja.filters.data, tb.filters.data)
    assert ja.vocab.id_to_token == tb.vocab.id_to_token
    assert (ja.vocab.token_eot, ja.vocab.token_beg) == (tb.vocab.token_eot,
                                                       tb.vocab.token_beg)
    _assert_tree_equal(ja.params, tb.params)
    assert ja.qparams.keys() == tb.qparams.keys()
    for name in ja.qparams:
        np.testing.assert_array_equal(ja.qparams[name].codes, tb.qparams[name].codes)
        np.testing.assert_array_equal(ja.qparams[name].scales, tb.qparams[name].scales)


def test_synth_file_is_quantized(synth_file):
    m = TLOAD.load_model(synth_file)
    assert m.hparams.ftype == TQ.GGML_FTYPE_MOSTLY_Q5_0
    assert "decoder.token_embedding.weight" in m.qparams
    assert "decoder.blocks.1.mlp.2.weight" in m.qparams
    assert "decoder.positional_embedding" not in m.qparams
