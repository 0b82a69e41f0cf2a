"""`encode_graph_share` (port_bench/metrics/encode_graph_share.py) on fixed
request timings: the requests finished in the window count, and a program
that keeps no `n_encode_graph` counter gives no reading."""

from types import SimpleNamespace

import pytest

from port_bench.run import _reader


def _run(*requests):
    reqs = {str(i): dict(end=end, timings=t) for i, (end, t) in enumerate(requests)}
    return SimpleNamespace(t0=10.0, t1=20.0, probe=SimpleNamespace(requests=reqs))


def test_share_over_the_requests_finished_in_the_window():
    read = _reader("encode_graph_share")
    run = _run((12.0, dict(n_encode=3, n_encode_graph=3)),
               (19.5, dict(n_encode=2, n_encode_graph=1)),
               (9.0, dict(n_encode=5, n_encode_graph=0)),      # before the window
               (21.0, dict(n_encode=5, n_encode_graph=0)))     # after it
    assert read(run) == pytest.approx(100.0 * 4 / 5)


def test_no_reading_without_the_counter_or_an_encode():
    read = _reader("encode_graph_share")
    assert read(_run((12.0, dict(n_encode=3)))) is None
    assert read(_run((12.0, dict(n_encode=0, n_encode_graph=0)))) is None
    assert read(_run()) is None
