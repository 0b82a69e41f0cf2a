"""The port's format tools against the JAX package's, on the CPU.

- imatrix capture: the port's make-imatrix (-ng) and the repo's
  tools/make_imatrix.py on the same DECISIVE f16 file (tests/
  test_torch_stream.py's widths) and seeded 12 s wav, 8 steps: the same
  tensors in the same order, `ncalls` equal, each tensor's sums within
  1e-5 of its largest (the activations' f32 sums run in another order;
  the sums themselves are the JAX package's Collector on the CPU).
- whisper-quantize: the port's and the JAX CLI write byte-equal files for
  q4_0 (that f16 file), q4_k and iq2_xxs with the port's imatrix.  K-quant
  and grid-format rows hold whole 256-blocks, and the grid encoders take
  ~33 us an element in numpy, so q4_k runs on a 256-wide one-layer file
  of 512 vocabulary rows and iq2_xxs on the same cut to its token
  embedding (no layers), with the imatrix the port captured on a 256-wide
  one-layer model of the full vocabulary (the tensor names match).
- the seven grid encoders (IQ1_S ... IQ3_S) give the JAX package's bytes
  on the same rows and imatrix; the IQ tables build once per process.
- GGUF: both packages write the same bytes and read the same file back.
- WER: the same normalised text and word error rate.
"""

import importlib.util
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

from test_torch_stream import HP, torch_one_thread, voice_clip  # noqa: F401
from whisper_tpu.cli import quantize as JQC
from whisper_tpu.evals import wer as JW
from whisper_tpu.formats import gguf as JG
from whisper_tpu.formats import quants as JQ
from whisper_tpu_torch.audio.io import write_wav
from whisper_tpu_torch.cli import make_imatrix as TMI
from whisper_tpu_torch.cli import quantize as TQC
from whisper_tpu_torch.evals import wer as TW
from whisper_tpu_torch.formats import gguf as TG
from whisper_tpu_torch.formats import quants as TQ
from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
from whisper_tpu_torch.utils.synth import write_synth_model

REPO = Path(__file__).resolve().parents[1]
HP_IQ = WhisperHParams(n_vocab=51865, n_audio_ctx=1500, n_audio_state=256,
                       n_audio_head=4, n_audio_layer=1, n_text_ctx=448,
                       n_text_state=256, n_text_head=4, n_text_layer=1, n_mels=80)


def read_imatrix(path):
    """{name: (ncall, values)} in file order."""
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<i", f.read(4))
        for _ in range(n):
            (ln,) = struct.unpack("<i", f.read(4))
            name = f.read(ln).decode()
            nc, nv = struct.unpack("<ii", f.read(8))
            out[name] = (nc, np.frombuffer(f.read(4 * nv), "<f4"))
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("quantize")
    model = str(d / "decisive-f16.bin")
    write_synth_model(model, HP, seed=1, qtype="f16", decisive=True)
    wav = str(d / "audio-12s.wav")
    write_wav(wav, voice_clip(12.0, 1.5, seed=5))
    return d, model, wav


@pytest.fixture(scope="module")
def imatrices(files):
    d, model, wav = files
    spec = importlib.util.spec_from_file_location("jax_make_imatrix",
                                                  REPO / "tools" / "make_imatrix.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    argv = sys.argv
    try:
        sys.argv = ["make_imatrix.py", "-m", model, "-f", wav, "-o",
                    str(d / "jax.imatrix"), "--steps", "8"]
        assert tool.main() == 0
    finally:
        sys.argv = argv
    assert TMI.main(["-m", model, "-f", wav, "-o", str(d / "torch.imatrix"),
                     "--steps", "8", "-ng"]) == 0
    return str(d / "jax.imatrix"), str(d / "torch.imatrix")


def test_imatrix_capture_matches_jax(imatrices):
    want, got = (read_imatrix(p) for p in imatrices)
    # q, k, v (one input), o, mlp.0, mlp.2 per encoder layer; those, the four
    # cross-attention projections per decoder layer; the logits head
    assert list(got) == list(want)
    assert len(got) == 6 * HP.n_audio_layer + 10 * HP.n_text_layer + 1
    for name, (nc, v) in want.items():
        assert got[name][0] == nc, name
        assert np.all(v > 0), name
        np.testing.assert_allclose(got[name][1], v, rtol=0, atol=1e-5 * v.max(),
                                   err_msg=name)


@pytest.fixture(scope="module")
def iq_files(tmp_path_factory):
    """The port's imatrix of a 256-wide one-layer decisive model of the full
    vocabulary, and two 256-wide files of its tensor names cut to 512
    vocabulary rows: with one layer each, and with no layers."""
    d = tmp_path_factory.mktemp("iq")
    full = str(d / "iq-full-f16.bin")
    write_synth_model(full, HP_IQ, seed=2, qtype="f16", decisive=True)
    wav = str(d / "audio.wav")
    write_wav(wav, voice_clip(6.0, 1.5, seed=6))
    imatrix = str(d / "torch.imatrix")
    assert TMI.main(["-m", full, "-f", wav, "-o", imatrix, "--steps", "4", "-ng"]) == 0
    cut = {}
    for layers in (1, 0):
        hp = WhisperHParams(**{**HP_IQ.__dict__, "n_vocab": 512,
                               "n_audio_layer": layers, "n_text_layer": layers})
        cut[layers] = str(d / f"iq-cut{layers}-f16.bin")
        write_synth_model(cut[layers], hp, seed=2, qtype="f16")
    return imatrix, cut


def _quantize_both(model, ftype, tmp_path, *flags):
    outs = []
    for name, mod in (("jax", JQC), ("torch", TQC)):
        out = str(tmp_path / f"{name}-{ftype}.bin")
        assert mod.main([model, out, ftype, *flags, "-q"]) == 0
        outs.append(Path(out).read_bytes())
    assert outs[1] == outs[0]
    return outs[1]


def test_quantize_q4_0_matches_jax(files, tmp_path):
    model = files[1]
    assert len(_quantize_both(model, "q4_0", tmp_path)) < Path(model).stat().st_size


def test_quantize_q4_k_matches_jax(iq_files, tmp_path):
    # K-quant rows hold whole 256-blocks: the 256-wide one-layer cut
    model = iq_files[1][1]
    assert len(_quantize_both(model, "q4_k", tmp_path)) < Path(model).stat().st_size


def test_quantize_iq2_xxs_matches_jax(iq_files, tmp_path):
    imatrix, cut = iq_files
    out = _quantize_both(cut[0], "iq2_xxs", tmp_path, "--imatrix", imatrix)
    # the token embedding went to iq2_xxs: 66 bytes per 256 values
    assert len(out) < Path(cut[0]).stat().st_size - 512 * 256 * 2 + 512 * 66 + 4096


@pytest.mark.parametrize("qtype", ["IQ2_XXS", "IQ2_XS", "IQ2_S", "IQ3_XXS", "IQ3_S",
                                   "IQ1_S", "IQ1_M"])
def test_grid_encoders_match_jax(qtype):
    t = getattr(TQ, "GGML_TYPE_" + qtype)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 512)).astype(np.float32)
    im = (rng.random(512) * 2 + 0.1).astype(np.float32)
    raw = TQ.quantize(x, t, imatrix=im)
    assert raw == JQ.quantize(x, t, imatrix=im)
    y = TQ.dequantize(raw, t, x.size).reshape(x.shape)
    assert np.corrcoef(x.ravel(), y.ravel())[0, 1] > 0.8


def test_gguf_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    kv = {"general.architecture": "whisper", "whisper.n_audio_layer": 4,
          "custom.pi": 3.5, "custom.flag": True, "custom.big": 2 ** 40,
          "custom.langs": ["en", "es"], "custom.dims": [80, 384]}
    tensors = [("enc.w", rng.standard_normal((8, 64)).astype(np.float32), TQ.GGML_TYPE_F32),
               ("enc.h", rng.standard_normal((16, 32)).astype(np.float32), TQ.GGML_TYPE_F16),
               ("enc.q", rng.standard_normal((4, 64)).astype(np.float32), TQ.GGML_TYPE_Q8_0),
               ("enc.k", rng.standard_normal((2, 256)).astype(np.float32), TQ.GGML_TYPE_Q4_K)]
    paths = [str(tmp_path / "jax.gguf"), str(tmp_path / "torch.gguf")]
    JG.write_gguf(paths[0], kv, tensors)
    TG.write_gguf(paths[1], kv, tensors)
    assert Path(paths[1]).read_bytes() == Path(paths[0]).read_bytes()
    a, b = JG.read_gguf(paths[0]), TG.read_gguf(paths[1])
    assert b.kv == a.kv and b.alignment == a.alignment
    assert ([(t.name, t.shape, t.ggml_type, t.offset, t.data) for t in b.tensors]
            == [(t.name, t.shape, t.ggml_type, t.offset, t.data) for t in a.tensors])
    np.testing.assert_array_equal(b.tensor("enc.w").to_f32(), tensors[0][1])


def test_wer_matches_jax():
    refs = ["The quick brown fox jumped over 2 lazy dogs.", "It's 5 o'clock, Mr. Smith!",
            "colour and honour in the theatre"]
    hyps = ["the quick brown fox jumps over two lazy dog", "it is five o'clock mister smith",
            "color and honor in the theater"]
    for r in refs + hyps:
        assert TW.normalize_english(r) == JW.normalize_english(r)
    assert TW.wer(refs, hyps) == JW.wer(refs, hyps)
    assert TW.wer(refs, hyps, normalize=False) == JW.wer(refs, hyps, normalize=False)


def test_device_collector_matches_collector():
    # the card's collector (f64 sums on the activations' device) against the
    # JAX package's numpy one, on CPU tensors: the same rows counted, the
    # same sums to f32 rounding, the fused q/k/v names sharing one input
    import torch
    from whisper_tpu.formats.imatrix import Collector

    rng = np.random.default_rng(0)
    xs = [rng.standard_normal(s).astype(np.float32) for s in ((5, 16), (2, 3, 16))]
    a, b = Collector(), TMI.DeviceCollector()
    for names, x in ((["q", "k", "v"], xs[0]), ("q", xs[1])):
        a.add(names, x)
        b.add(names, torch.from_numpy(x))
    assert b.ncalls == a.ncalls == {"q": 11, "k": 5, "v": 5}
    got = TMI.host_sums(b)
    assert list(got) == list(a.sums)
    for k in a.sums:
        np.testing.assert_allclose(got[k], a.sums[k], rtol=1e-6)
