"""The port's framework-free modules are copies of the JAX package's.

Verbatim copies must stay byte-identical to their originals (relative
imports resolve inside each package, so no line differs); a copy that
fixes a fault of its original, or builds into the port's own directory, is
the original with the replacements of EDITS (native.py).  The C ABI shim
whisper_tpu_torch/native/whisper_abi.cpp is native/whisper_abi.cpp with the
replacements of ABI_EDITS.  audio/mel.py is held to its original by
behaviour (its numpy and native paths here; the device mel in
tests/test_torch_vad.py).
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
    "formats/quants.py", "native.py",
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
    # native.py: the unchanged native/wtpu_native.cpp builds into the
    # port's own build directory, through a temporary directory renamed
    # into place (processes building at once never load a half-written
    # library)
    "native.py": [
        (b"""Set WTPU_NATIVE=0 to force the numpy paths.
""",
         b"""Set WTPU_NATIVE=0 to force the numpy paths.

Port of whisper_tpu/native.py: the same unchanged native/wtpu_native.cpp,
built with native/Makefile into whisper_tpu_torch/build/ (a temporary
directory there, then renamed into place, so processes that build at once
never load a half-written library).
"""),
        (b"""import subprocess
import threading
""",
         b"""import subprocess
import tempfile
import threading
"""),
        (b"""_LIB_PATH = _NATIVE_DIR / "build" / "libwtpu_native.so"
""",
         b"""_LIB_PATH = Path(__file__).resolve().parent / "build" / "libwtpu_native.so"
"""),
        (b"""    try:
        r = subprocess.run(["make", "-C", str(_NATIVE_DIR)],
                           capture_output=True, text=True, timeout=300)
        return r.returncode == 0 and _LIB_PATH.exists()
    except (OSError, subprocess.TimeoutExpired):
        return False
""",
         b"""    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_LIB_PATH.parent) as tmp:
        try:
            r = subprocess.run(["make", "-C", str(_NATIVE_DIR), f"BUILD={tmp}"],
                               capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired):
            return False
        if r.returncode != 0:
            return False
        os.replace(Path(tmp) / _LIB_PATH.name, _LIB_PATH)
    return True
"""),
    ],
}

# the C ABI shim (whisper_tpu_torch/native/whisper_abi.cpp) is
# native/whisper_abi.cpp with these replacements: it embeds the port's
# capi module, whisper_context_params' use_gpu and gpu_device reach the
# port's init (which chooses the device from them), and so do
# whisper_vad_context_params' (the original ignores both)
ABI_EDITS = [
    (b"""// whisper.h-shaped C ABI over the whisper_tpu Python engine.
""",
     b"""// whisper.h-shaped C ABI over the whisper_tpu_torch Python engine (the
// PyTorch/CUDA port; native/whisper_abi.cpp with the edits that
// tests/test_torch_copies.py lists).
"""),
    (b"""// sequence to whisper_tpu.capi \xe2\x80\x94 letting""",
     b"""// sequence to whisper_tpu_torch.capi \xe2\x80\x94 letting"""),
    (b"""// Build (see tests/test_c_abi.py):
//   g++ -shared -fPIC native/whisper_abi.cpp -o libwhisper_tpu.so \\
""",
     b"""// Build (whisper_tpu_torch/abi.py does it at first use):
//   g++ -shared -fPIC whisper_tpu_torch/native/whisper_abi.cpp \\
//       -o whisper_tpu_torch/build/libwhisper_tpu_torch.so \\
"""),
    (b"""PyObject * g_capi = nullptr;   // whisper_tpu.capi module""",
     b"""PyObject * g_capi = nullptr;   // whisper_tpu_torch.capi module"""),
    (b"""        g_capi = PyImport_ImportModule("whisper_tpu.capi");""",
     b"""        g_capi = PyImport_ImportModule("whisper_tpu_torch.capi");"""),
    (b"""// cparams -> JSON for capi._apply_cparams (only the DTW fields act on TPU)
static std::string cparams_to_json(const struct whisper_context_params & p) {
    std::string js = "{";
    js += "\\"dtw_token_timestamps\\": ";
""",
     b"""// cparams -> JSON for capi.init_from_file_with_cparams: use_gpu and
// gpu_device choose the device, then the DTW fields act
static std::string cparams_to_json(const struct whisper_context_params & p) {
    std::string js = "{";
    js += "\\"use_gpu\\": ";
    js += p.use_gpu ? "true" : "false";
    js += ", \\"gpu_device\\": " + std::to_string(p.gpu_device);
    js += ", \\"dtw_token_timestamps\\": ";
"""),
    (b"""// the context params carry no TPU-relevant knobs; init ignores them
struct whisper_vad_context * whisper_vad_init_from_file_with_params(
        const char * path_model, struct whisper_vad_context_params params) {
    (void) params;
    return whisper_vad_init_from_file(path_model);
}
""",
     b"""// use_gpu and gpu_device choose the VAD context's device (n_threads has
// no knob here)
static std::string vad_cparams_to_json(
        const struct whisper_vad_context_params & p) {
    std::string js = "{\\"use_gpu\\": ";
    js += p.use_gpu ? "true" : "false";
    js += ", \\"gpu_device\\": " + std::to_string(p.gpu_device) + "}";
    return js;
}

struct whisper_vad_context * whisper_vad_init_from_file_with_params(
        const char * path_model, struct whisper_vad_context_params params) {
    const std::string js = vad_cparams_to_json(params);
    return (struct whisper_vad_context *) (intptr_t) call_long(
        "vad_init_from_file_with_cparams", 0, "(s,s)", path_model, js.c_str());
}
"""),
    (b"""        struct whisper_vad_context_params params) {
    (void) params;
    if (!loader || !loader->read) return nullptr;
""",
     b"""        struct whisper_vad_context_params params) {
    if (!loader || !loader->read) return nullptr;
"""),
    (b"""    PyObject * args = PyTuple_New(1);
    PyTuple_SET_ITEM(args, 0, PyBytes_FromStringAndSize(buf.data(),
                                                        (Py_ssize_t) buf.size()));
    PyObject * res = call("vad_init_from_buffer", args);
""",
     b"""    PyObject * args = PyTuple_New(2);
    PyTuple_SET_ITEM(args, 0, PyBytes_FromStringAndSize(buf.data(),
                                                        (Py_ssize_t) buf.size()));
    PyTuple_SET_ITEM(args, 1, PyUnicode_FromString(
                                  vad_cparams_to_json(params).c_str()));
    PyObject * res = call("vad_init_from_buffer_with_cparams", args);
"""),
    (b"""    struct whisper_vad_context_params p;  // src/whisper.cpp:4453-4460
    p.n_threads  = 4;
    p.use_gpu    = false;
""",
     b"""    // src/whisper.cpp:4453-4460, but use_gpu true: the port's entry points
    // run on the card unless the host asks for the CPU
    struct whisper_vad_context_params p;
    p.n_threads  = 4;
    p.use_gpu    = true;
"""),
    (b"""// public C surface, forwarded to whisper_tpu.capi_parakeet through the same""",
     b"""// public C surface, forwarded to whisper_tpu_torch.capi_parakeet through the same"""),
]


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy(rel):
    a = (REPO / "whisper_tpu" / rel).read_bytes()
    b = (REPO / "whisper_tpu_torch" / rel).read_bytes()
    for old, new in EDITS.get(rel, ()):
        assert a.count(old) == 1, (rel, old)
        a = a.replace(old, new)
    assert a == b, f"whisper_tpu_torch/{rel} drifted from whisper_tpu/{rel}"


def test_abi_shim_is_the_original_with_edits():
    a = (REPO / "native" / "whisper_abi.cpp").read_bytes()
    for old, new in ABI_EDITS:
        assert a.count(old) == 1, old
        a = a.replace(old, new)
    assert a == (REPO / "whisper_tpu_torch" / "native" / "whisper_abi.cpp").read_bytes()


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
    # the native C mel (native/wtpu_native.cpp), built into each package's
    # own directory: the same library code, the same mel
    mc, nc = JMEL.LogMel(filters, backend="native")(pcm)
    md, nd = TMEL.LogMel(filters, backend="native")(pcm)
    assert nc == nd == na
    np.testing.assert_array_equal(mc, md)
    np.testing.assert_allclose(md, mb, rtol=0, atol=1e-5)


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
