"""Transcription output writers — txt/vtt/srt/csv/json/lrc/score.

Format parity with whisper-cli's writers (examples/cli/cli.cpp:455-960):
same timestamp strings, same escaping rules, same layouts, so downstream
tooling built for the reference keeps working.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence

import numpy as np

SAMPLE_RATE = 16000


def _cdiv(a: int, b: int) -> int:
    """C++ integer division (truncates toward zero; Python // floors).
    Matters for the negative-t0 segments the reference's greedy tid-zero
    quirk can produce (src/whisper.cpp:7642)."""
    return -(-a // b) if (a < 0) != (b < 0) else a // b


def to_timestamp(t: int, comma: bool = False) -> str:
    """10ms ticks -> 'HH:MM:SS.mmm' (common-whisper.cpp:182 to_timestamp;
    int64 C division semantics for negative ticks)."""
    msec = t * 10
    hr = _cdiv(msec, 1000 * 60 * 60)
    msec -= hr * 1000 * 60 * 60
    mi = _cdiv(msec, 1000 * 60)
    msec -= mi * 1000 * 60
    s = _cdiv(msec, 1000)
    msec -= s * 1000
    sep = "," if comma else "."
    return f"{hr:02d}:{mi:02d}:{s:02d}{sep}{msec:03d}"


def _timestamp_to_sample(t: int, n_samples: int) -> int:
    return max(0, min(n_samples - 1, (t * SAMPLE_RATE) // 100))


def estimate_diarization_speaker(stereo: np.ndarray, t0: int, t1: int,
                                 id_only: bool = False) -> str:
    """Stereo channel-energy diarization (examples/cli/cli.cpp:320-356)."""
    n = stereo.shape[0]
    is0 = _timestamp_to_sample(t0, n)
    is1 = _timestamp_to_sample(t1, n)
    e0 = float(np.abs(stereo[is0:is1, 0]).sum())
    e1 = float(np.abs(stereo[is0:is1, 1]).sum())
    if e0 > 1.1 * e1:
        speaker = "0"
    elif e1 > 1.1 * e0:
        speaker = "1"
    else:
        speaker = "?"
    if not id_only:
        speaker = f"(speaker {speaker})"
    return speaker


def write_txt(segments, f, diarize=False, stereo=None) -> None:
    for s in segments:
        text = s.text
        if diarize and stereo is not None:
            f.write(estimate_diarization_speaker(stereo, s.t0, s.t1))
            f.write(text)
        else:
            f.write(text.lstrip(" \t"))
        f.write("\n")


def write_vtt(segments, f, diarize=False, stereo=None) -> None:
    f.write("WEBVTT\n\n")
    for s in segments:
        speaker = ""
        if diarize and stereo is not None:
            sid = estimate_diarization_speaker(stereo, s.t0, s.t1, True)
            speaker = f"<v Speaker{sid}>"
        f.write(f"{to_timestamp(s.t0)} --> {to_timestamp(s.t1)}\n")
        f.write(f"{speaker}{s.text}\n\n")


def write_srt(segments, f, diarize=False, stereo=None, offset_n=0) -> None:
    for i, s in enumerate(segments):
        speaker = ""
        if diarize and stereo is not None:
            speaker = estimate_diarization_speaker(stereo, s.t0, s.t1)
        f.write(f"{i + 1 + offset_n}\n")
        f.write(f"{to_timestamp(s.t0, True)} --> {to_timestamp(s.t1, True)}\n")
        f.write(f"{speaker}{s.text}\n\n")


def write_csv(segments, f, diarize=False, stereo=None) -> None:
    f.write("start,end,")
    if diarize and stereo is not None:
        f.write("speaker,")
    f.write("text\n")
    for s in segments:
        text = s.text.replace('"', '""')
        f.write(f"{10 * s.t0},{10 * s.t1},")
        if diarize and stereo is not None:
            f.write(estimate_diarization_speaker(stereo, s.t0, s.t1, True) + ",")
        f.write(f'"{text}"\n')


def write_lrc(segments, f, diarize=False, stereo=None) -> None:
    """examples/cli/cli.cpp:937-960: [mm:ss.cc] lines."""
    # the "[by:whisper.cpp]" credit line is part of the reference's byte
    # format (cli.cpp:941); emitting it keeps .lrc outputs byte-identical
    f.write("[by:whisper.cpp]\n")
    for s in segments:
        t = s.t0
        msec = t * 10
        mi = _cdiv(msec, 1000 * 60)
        msec -= mi * 1000 * 60
        ss = _cdiv(msec, 1000)
        msec -= ss * 1000
        hund = _cdiv(msec, 10)
        speaker = ""
        if diarize and stereo is not None:
            speaker = estimate_diarization_speaker(stereo, s.t0, s.t1)
        f.write(f"[{mi:02d}:{ss:02d}.{hund:02d}]{speaker}{s.text}\n")


def write_wts(segments, f, vocab, fname_inp: str, t_sec: float,
              font_path: str, diarize=False, stereo=None) -> None:
    """Karaoke ffmpeg script (output_wts, examples/cli/cli.cpp:816-937):
    a bash script rendering the audio into a video with the current token
    highlighted.  Requires token-level timestamps (-owts implies them)."""
    def esc(s: str) -> str:
        return s.replace("'", "’").replace('"', '\\"')

    def g(x: float) -> str:
        # C++ ostream default float formatting (6 significant digits,
        # trailing zeros stripped): 1.0 -> "1", 11.0625 -> "11.0625"
        return f"{x:.6g}"

    f.write("#!/bin/bash\n\n")
    f.write(f"ffmpeg -i {fname_inp} -f lavfi -i "
            f"color=size=1200x120:duration={g(t_sec)}:rate=25:color=black "
            f"-vf \"")
    for i, seg in enumerate(segments):
        toks = [t for t in seg.tokens]
        if i > 0:
            f.write(",")
        f.write(f"drawtext=fontfile='{font_path}':fontsize=24:fontcolor=gray:"
                f"x=(w-text_w)/2:y=h/2:text='':enable='between(t,"
                f"{g(seg.t0 / 100.0)},{g(seg.t0 / 100.0)})'")
        speaker = ""
        if diarize and stereo is not None:
            speaker = estimate_diarization_speaker(stereo, seg.t0, seg.t1)
        first = True
        for j, tok in enumerate(toks):
            if tok.id >= vocab.token_eot:
                continue
            txt_bg = speaker + "> "
            txt_fg = speaker + "> "
            txt_ul = ("\\ " * len(speaker)) + "\\ \\ "
            for k, tok2 in enumerate(toks):
                if tok2.id >= vocab.token_eot:
                    continue
                txt = vocab.token_str(tok2.id)
                txt_bg += txt
                if k == j:
                    txt_fg += txt
                    txt_ul += "_" * len(txt)
                    txt_fg += "|"
                else:
                    txt_fg += "\\ " * len(txt)
                    txt_ul += "\\ " * len(txt)
            if first:
                f.write(f",drawtext=fontfile='{font_path}':fontsize=24:"
                        f"fontcolor=gray:x=(w-text_w)/2:y=h/2:"
                        f"text='{esc(txt_bg)}':enable='between(t,"
                        f"{g(seg.t0 / 100.0)},{g(seg.t1 / 100.0)})'")
                first = False
            f.write(f",drawtext=fontfile='{font_path}':fontsize=24:"
                    f"fontcolor=lightgreen:x=(w-text_w)/2+8:y=h/2:"
                    f"text='{esc(txt_fg)}':enable='between(t,"
                    f"{g(tok.t0 / 100.0)},{g(tok.t1 / 100.0)})'")
            f.write(f",drawtext=fontfile='{font_path}':fontsize=24:"
                    f"fontcolor=lightgreen:x=(w-text_w)/2+8:y=h/2+16:"
                    f"text='{esc(txt_ul)}':enable='between(t,"
                    f"{g(tok.t0 / 100.0)},{g(tok.t1 / 100.0)})'")
    f.write(f"\" -c:v libx264 -pix_fmt yuv420p -y {fname_inp}.mp4\n")
    f.write(f"\n\necho \"Your video has been saved to {fname_inp}.mp4\"\n")
    f.write(f"\necho \"  ffplay {fname_inp}.mp4\"\n\n")


def write_score(segments, f, vocab) -> None:
    for s in segments:
        for t in s.tokens:
            f.write(f"{vocab.token_str(t.id)}\t{t.p}\n")


def write_json(segments, f, ctx, params, language: str, full: bool = False,
               diarize: bool = False, stereo=None) -> None:
    hp = ctx.hp
    out = {
        "systeminfo": "whisper_tpu_torch (PyTorch/CUDA)",
        "model": {
            "type": hp.model_name,
            "multilingual": ctx.vocab.is_multilingual,
            "vocab": hp.n_vocab,
            "audio": {
                "ctx": hp.n_audio_ctx, "state": hp.n_audio_state,
                "head": hp.n_audio_head, "layer": hp.n_audio_layer,
            },
            "text": {
                "ctx": hp.n_text_ctx, "state": hp.n_text_state,
                "head": hp.n_text_head, "layer": hp.n_text_layer,
            },
            "mels": hp.n_mels,
            "ftype": hp.ftype,
        },
        "params": {
            "model": getattr(params, "model_path", ""),
            "language": language,
            "translate": params.translate,
        },
        "result": {"language": language},
        "transcription": [],
    }
    for s in segments:
        seg = {
            "timestamps": {
                "from": to_timestamp(s.t0, True),
                "to": to_timestamp(s.t1, True),
            },
            "offsets": {"from": 10 * s.t0, "to": 10 * s.t1},
            "text": s.text,
        }
        if full:
            seg["tokens"] = [
                {
                    "text": ctx.vocab.token_str(t.id),
                    "timestamps": {
                        "from": to_timestamp(t.t0, True),
                        "to": to_timestamp(t.t1, True),
                    },
                    "offsets": {"from": 10 * t.t0, "to": 10 * t.t1},
                    "id": t.id,
                    "p": round(float(t.p), 6),
                    "t_dtw": t.t_dtw,
                }
                for t in s.tokens
            ]
        if diarize and stereo is not None:
            seg["speaker"] = estimate_diarization_speaker(stereo, s.t0, s.t1, True)
        if getattr(params, "tdrz_enable", False):
            # the reference emits the flag for EVERY segment when
            # tinydiarize is on, true or false (cli.cpp:803-805)
            seg["speaker_turn_next"] = bool(
                getattr(s, "speaker_turn_next", False))
        out["transcription"].append(seg)
    # tab indentation matches the reference writer (cli.cpp output_json's
    # indent() emits \t) so -oj files are byte-comparable
    json.dump(out, f, indent="\t", ensure_ascii=False)
    f.write("\n")
