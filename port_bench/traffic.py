"""Traffic mixes: one general generator driven by a data file each
(`traffic/<name>.json`), the seeded audio and the request bodies.

A mix names its loop ("closed", the only one so far: each of `clients`
sends its next request when the last one's response is read), the clip
lengths (a
fixed multiset: `n` quantiles of a lognormal, clipped), the form fields
every request carries, and its warm-up.  The seed changes only the audio
and the order of the lengths, so every seed offers the same work.

The audio is `chip_smoke.seeded_audio` (a 220 Hz tone, amplitude-modulated
at 0.5 Hz, under white noise), copied, ending in 1 ms of silence: one clip
per client and length, each from its own generator.
"""

from __future__ import annotations

import io
import json
import math
import os
import statistics
import wave
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

SAMPLE_RATE = 16000
HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Request:
    rid: str              # "client:index:length index", sent as a form field
    client: int
    length_index: int
    audio_s: float


@dataclass
class Mix:
    name: str
    loop: str
    clients: int
    lengths_s: List[float]
    fields: Dict[str, str]
    warmup: Dict[str, float] = field(default_factory=dict)
    sample_clients: int = 1


def load(name: str, root: str = HERE) -> Mix:
    with open(os.path.join(root, "traffic", f"{name}.json")) as f:
        spec = json.load(f)
    return Mix(name=name, loop=spec["loop"], clients=int(spec.get("clients", 1)),
               lengths_s=lengths(spec["lengths"]), fields=dict(spec["fields"]),
               warmup=dict(spec.get("warmup", {})),
               sample_clients=int(spec.get("sample_clients", 1)))


def lengths(spec: dict) -> List[float]:
    """The multiset of clip lengths, seconds to 10 ms."""
    if spec["kind"] == "lognormal_quantiles":
        nd = statistics.NormalDist()
        n = int(spec["n"])
        out = [spec["median_s"] * math.exp(spec["sigma"] * nd.inv_cdf((i + 0.5) / n))
               for i in range(n)]
    elif spec["kind"] == "list":
        out = list(spec["values_s"])
    else:
        raise ValueError(f"unknown length distribution {spec['kind']!r}")
    return [round(min(max(x, spec.get("min_s", 0.0)), spec.get("max_s", 1e9)), 2)
            for x in out]


def order(mix: Mix, seed: int) -> List[int]:
    """The seeded order of the length indices; client c starts c places on,
    so the clients' first requests cover the lengths together."""
    return [int(i) for i in np.random.default_rng([seed, 1]).permutation(len(mix.lengths_s))]


def plan(mix: Mix, seed: int, n_per_client: int) -> List[List[Request]]:
    """Each client's first `n_per_client` requests."""
    if mix.loop != "closed":
        raise ValueError(f"unknown loop {mix.loop!r}")
    perm = order(mix, seed)
    n = len(perm)
    return [[Request(f"{c}:{k}:{perm[(k + c) % n]}", c, perm[(k + c) % n],
                     mix.lengths_s[perm[(k + c) % n]]) for k in range(n_per_client)]
            for c in range(mix.clients)]


def audio(seed: int, client: int, length_index: int, seconds: float) -> np.ndarray:
    """The clip of one client and length: chip_smoke.seeded_audio's signal."""
    rng = np.random.default_rng([seed, 3, client, length_index])
    n = int(SAMPLE_RATE * seconds)
    t = np.arange(n) / SAMPLE_RATE
    tone = 0.05 * np.sin(2 * np.pi * 220.0 * t) * (1 + np.sin(2 * np.pi * 0.5 * t))
    x = (tone + 0.05 * rng.standard_normal(n)).astype(np.float32)
    # 1 ms of digital silence at the end: the server's multipart parser
    # strips CR and LF bytes from the end of an upload, so a clip whose last
    # byte is 0x0a or 0x0d comes out a byte short and is refused (PERF.md,
    # Open questions)
    x[-16:] = 0.0
    return x


def pcm16(x: np.ndarray) -> np.ndarray:
    return np.clip(np.round(x * 32767.0), -32768, 32767).astype("<i2")


def served_pcm(x: np.ndarray) -> np.ndarray:
    """What a 16-bit WAV reader hands on: the stored samples over 32768."""
    return pcm16(x).astype(np.float32) / 32768.0


def wav_bytes(x: np.ndarray) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SAMPLE_RATE)
        w.writeframes(pcm16(x).tobytes())
    return buf.getvalue()


BOUNDARY = "----port-bench-boundary"


def multipart(fields: Dict[str, Tuple[str, bytes]]) -> Tuple[bytes, str]:
    """A multipart/form-data body: chip_smoke._multipart, copied."""
    out = []
    for name, (filename, content) in fields.items():
        dispo = f'Content-Disposition: form-data; name="{name}"'
        if filename:
            dispo += f'; filename="{filename}"'
        out += [f"--{BOUNDARY}\r\n{dispo}\r\n\r\n".encode(),
                content if isinstance(content, bytes) else content.encode(), b"\r\n"]
    out.append(f"--{BOUNDARY}--\r\n".encode())
    return b"".join(out), f"multipart/form-data; boundary={BOUNDARY}"


def body_parts(mix: Mix, req: Request, wav: bytes) -> List[bytes]:
    """One request's multipart body as three pieces, the clip's WAV bytes
    (made once per client and length) in the middle: no large copy at send
    time."""
    fields = {"port_bench_id": ("", req.rid)}
    fields.update({k: ("", v) for k, v in mix.fields.items()})
    fields["file"] = ("clip.wav", b"")
    head, _ = multipart(fields)
    tail = f"\r\n--{BOUNDARY}--\r\n".encode()
    head = head[:-len(tail)]
    return [head, wav, tail]
