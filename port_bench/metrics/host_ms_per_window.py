"""The seek loop's host time per window, in ms: over the program's
`seek.window` spans ended in the window, the mean self time (the span
less the part its children cover: the encode, the window decode, waits
for the device lock), which is the loop's own work between them (prompts,
segments, text)."""

from port_bench import spans


def read(run):
    wins = spans.ended(run, "seek.window")
    if not wins:
        return None
    kids = spans.children(spans.recorded())
    return sum(spans.self_ns(w, kids.get(w.sid, [])) for w in wins) / len(wins) / 1e6
