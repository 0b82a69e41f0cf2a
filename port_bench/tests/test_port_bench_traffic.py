"""The traffic generator: the same work for every seed."""

import os

from port_bench import traffic

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_length_multiset_is_the_same_for_every_seed():
    mix = traffic.load("batch16", HERE)
    seen = None
    for seed in (0, 1, 2 ** 31 + 7, 987654321):
        plan = traffic.plan(mix, seed, 32)
        per_client = [sorted(r.audio_s for r in reqs[:16]) for reqs in plan]
        assert all(p == sorted(mix.lengths_s) for p in per_client)
        seen = seen or traffic.order(mix, seed)
    assert traffic.order(mix, 0) != traffic.order(mix, 1)


def test_lengths_are_the_lognormal_quantiles():
    mix = traffic.load("batch16", HERE)
    x = mix.lengths_s
    assert len(x) == 16 and x == sorted(x)
    assert x[7] < 20.0 < x[8]                         # the median lies between
    assert 3.0 <= x[0] and x[-1] <= 120.0
    assert 25.0 < sum(x) / len(x) < 29.0


def test_first_requests_cover_every_length():
    mix = traffic.load("batch16", HERE)
    plan = traffic.plan(mix, 5, 4)
    assert sorted(reqs[0].length_index for reqs in plan) == list(range(16))


def test_audio_depends_on_seed_client_and_length_only():
    a = traffic.audio(3, 1, 2, 1.5)
    assert (a == traffic.audio(3, 1, 2, 1.5)).all()
    assert not (a == traffic.audio(4, 1, 2, 1.5)).all()
    assert len(a) == 24000


def test_body_parses_as_the_server_parses_it():
    from whisper_tpu_torch.cli.server import parse_multipart

    mix = traffic.load("solo", HERE)
    req = traffic.plan(mix, 1, 1)[0][0]
    wav = traffic.wav_bytes(traffic.audio(1, 0, req.length_index, 0.5))
    body = b"".join(traffic.body_parts(mix, req, wav))
    fields = parse_multipart(body, traffic.multipart({})[1])
    assert fields["file"][1] == wav
    assert fields["port_bench_id"][1].decode() == req.rid
    assert fields["temperature_inc"][1] == b"0"
