"""The server front end's time per request, in ms: over the program's
`server.request` spans ended in the window, the mean of their
`server.read`, `server.parse`, `server.audio` and `server.respond` children
(the body read, the multipart parse, the temporary file and WAV read, the
formatting and sending)."""

from port_bench import spans

PARTS = ("server.read", "server.parse", "server.audio", "server.respond")


def read(run):
    reqs = spans.ended(run, "server.request")
    if not reqs:
        return None
    kids = spans.children(spans.recorded())
    return sum(sum(c.t1 - c.t0 for c in kids.get(r.sid, ()) if c.name in PARTS)
               for r in reqs) / len(reqs) / 1e6
