"""The load generator: a child process of its own, so that its client
threads never take the server's interpreter lock.

It makes every clip's WAV bytes from the seed before it reports ready
(the request bodies are three pieces each, the clip in the middle), then
on "go" sends the mix to the server until "stop", and sends back one
record per request: (rid, audio seconds, due, sent, done, HTTP status,
response text).  Times are CLOCK_MONOTONIC, which the parent reads too.
A failed or refused request has status 0 or its HTTP code, and counts as
attempted.  The loop is closed: a request is due when its client sends it.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from typing import List

from . import traffic as T

CLOSED_PLAN = 100000     # requests a closed-loop client may send in one run


def _post(conn_box, host: str, port: int, parts: List[bytes]):
    """(status, text) of one POST /inference on a kept-alive connection."""
    n = sum(len(p) for p in parts)
    for attempt in (0, 1):
        if conn_box[0] is None:
            conn_box[0] = http.client.HTTPConnection(host, port, timeout=600)
        conn = conn_box[0]
        try:
            conn.putrequest("POST", "/inference")
            conn.putheader("Content-Type", T.multipart({})[1])
            conn.putheader("Content-Length", str(n))
            conn.endheaders()
            for p in parts:
                conn.send(p)
            resp = conn.getresponse()
            data = resp.read()
            break
        except (ConnectionError, http.client.HTTPException) as e:
            conn.close()
            conn_box[0] = None
            if attempt:
                return 0, f"{type(e).__name__}: {e}"
    if resp.status != 200:
        return resp.status, data.decode("utf-8", "replace")
    try:
        return 200, json.loads(data)["text"]
    except (ValueError, KeyError) as e:
        return 0, f"bad response: {e}: {data[:200]!r}"


def main(conn, mix: T.Mix, seed: int) -> None:
    """The child's entry (multiprocessing, spawn)."""
    streams = T.plan(mix, seed, CLOSED_PLAN)
    keys = {(c, li) for c in range(mix.clients) for li in range(len(mix.lengths_s))}
    wavs = {(c, li): T.wav_bytes(T.audio(seed, c, li, mix.lengths_s[li])) for c, li in keys}
    conn.send(("ready",))
    msg = conn.recv()
    if msg[0] != "go":
        return
    host, port = msg[1], msg[2]
    stop = threading.Event()
    records, lock = [], threading.Lock()

    def send(box, req, due):
        sent = time.monotonic()
        status, text = _post(box, host, port, T.body_parts(mix, req, wavs[(req.client,
                                                                           req.length_index)]))
        with lock:
            records.append((req.rid, req.audio_s, due, sent, time.monotonic(), status, text))

    def closed_client(reqs):
        box = [None]
        for req in reqs:
            if stop.is_set():
                break
            send(box, req, time.monotonic())

    threads = [threading.Thread(target=closed_client, args=(s,), daemon=True)
               for s in streams]
    for t in threads:
        t.start()
    conn.recv()                        # "stop"
    stop.set()
    for t in threads:
        t.join(timeout=300)
    with lock:
        conn.send(("log", list(records), sum(t.is_alive() for t in threads)))
