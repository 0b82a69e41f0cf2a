"""The port's C ABI library (the shim whisper_tpu_torch/native/whisper_abi.cpp
built by whisper_tpu_torch/abi.py as libwhisper_tpu_torch.so) and C hosts
linked against it.

On the CPU: the library exports every symbol the original shim
(native/whisper_abi.cpp) exports; whisper_tpu_torch/native/abi_host.c with
`cpu` (whisper_context_params.use_gpu = false) prints the JAX capi's
segments and token ids for the same file, audio and params (the DECISIVE
file of tests/test_torch_capi.py); with `cuda` and no card its init returns
NULL and it exits 1; the library loaded into this interpreter with
use_gpu = false (`_in_process`, whisper_full with the struct params) gives
the JAX capi's segments, and so does its VAD (whisper_vad_segments_from_
samples on the synthetic Silero file) with use_gpu = false; at the port's
default VAD context params (use_gpu true) and no card its init returns
NULL.  The card's tests of the C hosts and of the
library in process are in tests/test_torch_gpu.py.
"""

import json
import subprocess

import numpy as np
import pytest

import whisper_tpu.capi as JC
from whisper_tpu_torch import abi
from test_torch_capi import GREEDY, HP, model_path, pcm  # noqa: F401

@pytest.fixture(scope="module")
def pcm_file(tmp_path_factory, pcm):  # noqa: F811
    path = tmp_path_factory.mktemp("abi") / "audio.pcm.f32"
    pcm.astype("<f4").tofile(path)
    return str(path)


def _exported(lib) -> set:
    r = subprocess.run(["nm", "-D", "--defined-only", str(lib)], check=True,
                       capture_output=True, text=True)
    return {ln.split()[-1] for ln in r.stdout.splitlines() if " T " in ln}


def test_library_exports_every_symbol_of_the_original_shim(tmp_path):
    import sys
    import sysconfig

    orig = tmp_path / "libwhisper_tpu.so"
    pyver = f"python{sys.version_info.major}.{sys.version_info.minor}"
    subprocess.run(["g++", "-shared", "-fPIC", "-O2", str(abi.REPO / "native" / "whisper_abi.cpp"),
                    "-o", str(orig), f"-I{sysconfig.get_paths()['include']}",
                    f"-L{sysconfig.get_config_var('LIBDIR')}", f"-l{pyver}"], check=True)
    want = _exported(orig)
    got = _exported(abi.build_library())
    assert len(want) > 200 and "whisper_full" in want and "parakeet_full" in want
    assert want <= got, sorted(want - got)
    assert got == want          # the edits add no export


def test_abi_host_cpu_prints_the_jax_segments(model_path, pcm, pcm_file):  # noqa: F811
    exe = abi.build_host(abi.PKG / "native" / "abi_host.c")
    r = subprocess.run([str(exe), model_path, pcm_file, "cpu"], capture_output=True,
                       text=True, env=abi.host_env(), timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "ABI-HOST-OK" in r.stdout
    h = JC.init_from_file(model_path)
    assert JC.full(h, GREEDY, pcm) == 0
    want = [(JC.full_get_segment_t0(h, i), JC.full_get_segment_t1(h, i),
             JC.full_get_segment_text(h, i),
             [JC.full_get_token_id(h, i, j) for j in range(JC.full_n_tokens(h, i))])
            for i in range(JC.full_n_segments(h))]
    JC.free(h)
    assert len(want) >= 2
    assert abi.seg_lines(r.stdout) == want
    assert f"n_segments={len(want)}" in r.stdout


def test_abi_host_cuda_without_a_card_fails(model_path, pcm_file):  # noqa: F811
    exe = abi.build_host(abi.PKG / "native" / "abi_host.c")
    # an embedded interpreter that sees no card, whatever this host has
    r = subprocess.run([str(exe), model_path, pcm_file, "cuda"], capture_output=True,
                       text=True, env=abi.host_env(CUDA_VISIBLE_DEVICES=""), timeout=600)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "init failed (use_gpu=1)" in r.stderr
    assert "no CUDA card is available" in r.stderr
    assert "n_segments" not in r.stdout


def _in_process(model_path, pcm, use_gpu):  # noqa: F811
    """whisper_init_from_file_with_params + whisper_full (struct params at
    their greedy defaults, language "en", no fallback) through the library
    loaded into this interpreter."""
    import ctypes

    lib = abi.load_library()
    cp = lib.whisper_context_default_params()
    assert cp.use_gpu                      # whisper.h's default: the card
    cp.use_gpu = use_gpu
    ctx = lib.whisper_init_from_file_with_params(model_path.encode(), cp)
    assert ctx
    fp = lib.whisper_full_default_params(0)
    fp.language, fp.temperature_inc, fp.print_progress = b"en", 0.0, False
    buf = np.ascontiguousarray(pcm, np.float32)
    assert lib.whisper_full(ctx, fp, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                            len(buf)) == 0
    segs = abi.segments(lib, ctx)
    lib.whisper_free(ctx)
    return segs


def test_library_in_process_prints_the_jax_segments(model_path, pcm):  # noqa: F811
    h = JC.init_from_file(model_path)
    assert JC.full(h, GREEDY, pcm) == 0
    want = [(JC.full_get_segment_t0(h, i), JC.full_get_segment_t1(h, i),
             JC.full_get_segment_text(h, i),
             [JC.full_get_token_id(h, i, j) for j in range(JC.full_n_tokens(h, i))])
            for i in range(JC.full_n_segments(h))]
    JC.free(h)
    assert _in_process(model_path, pcm, False) == want


def test_library_vad_in_process_gives_the_jax_segments(tmp_path, pcm, monkeypatch):  # noqa: F811
    import torch

    from whisper_tpu_torch.models.vad.writer import synth_vad_tensors, write_vad_model

    vad = str(tmp_path / "silero-synth.bin")
    write_vad_model(vad, synth_vad_tensors(seed=0))
    clip = pcm.copy()
    clip[16000 * 4:16000 * 7] = 0.0
    vj = JC.vad_init_from_file(vad)
    assert JC.vad_detect_speech(vj, clip) == 1
    thr = float(np.median(np.frombuffer(JC.vad_probs_bytes(vj), "<f4")))
    lib = abi.load_library()
    vp = lib.whisper_vad_default_params()
    vp.threshold, vp.max_speech_duration_s = thr, 2.0
    sh = JC.vad_segments_from_samples(
        vj, json.dumps({"threshold": float(vp.threshold), "max_speech_duration_s": 2.0}), clip)
    want = [(JC.vad_segments_get_segment_t0(sh, i), JC.vad_segments_get_segment_t1(sh, i))
            for i in range(JC.vad_segments_n_segments(sh))]
    JC.vad_free_segments(sh)
    JC.vad_free(vj)
    assert len(want) >= 2
    vcp = lib.whisper_vad_default_context_params()
    assert vcp.use_gpu and vcp.n_threads == 4       # the port's default: the card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not lib.whisper_vad_init_from_file_with_params(vad.encode(), vcp)
    vcp.use_gpu = False
    vctx = lib.whisper_vad_init_from_file_with_params(vad.encode(), vcp)
    assert vctx
    assert abi.vad_segments(lib, vctx, vp, clip) == want
    lib.whisper_vad_free(vctx)
