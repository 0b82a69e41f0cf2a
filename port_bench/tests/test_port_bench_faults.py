"""A run of a tiny cell on the CPU, past the look for a card: `correct`
holds for the program as it is, and comes out false with the timed path
broken underneath it, once for each fault a serving cell can have on one
chip: a token altered where the window decoder produces it, a decode step
that leaves its state (the self-attention cache) unchanged, half of a
batched round of windows left out (given the other half's results), the
cross K/V of a round's windows rotated among them, and a window decoder
that keeps the cross K/V of its last round.  The exchange between chips
does not exist on one chip."""

import os

import numpy as np
import pytest
import torch

from port_bench import run as R

HERE = os.path.dirname(os.path.abspath(__file__))


def tiny_bench():
    bench = R.load_bench()
    bench["configs"] = [{"name": "tiny", "file": "port_bench/tests/data/tiny-q5_0.json"}]
    bench["workloads"] = [{"name": t, "config": "tiny", "traffic": t, "chips": 1}
                          for t in ("tiny", "tiny4")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    return bench


def run_tiny(seed=12345, seconds=4.0, workload="tiny"):
    import time

    return R.run_cell(tiny_bench(), workload, seed, seconds, False, device="cpu",
                      traffic_dir=os.path.join(HERE, "data"), t_start=time.monotonic())


@pytest.mark.parametrize("workload", ["tiny", "tiny4"])
def test_sound_run_is_correct(workload):
    res = run_tiny(workload=workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"audio_s_per_s", "request_p95_s", "peak_mem_gib", "setup_s"}
    assert list(res)[-1] == "checks"


def test_altered_token_is_caught(monkeypatch):
    from whisper_tpu_torch.decoding import device_loop as DL

    orig = DL.LoopState.result

    def result(self, prompt_probs):
        res = orig(self, prompt_probs)
        tok = res.tok_id.copy()
        flat = tok.reshape(-1, tok.shape[-1])
        flat[:, 1] = np.where(flat[:, 1] == 1000, 1001, 1000)
        return res._replace(tok_id=tok)

    monkeypatch.setattr(DL.LoopState, "result", result)
    assert not run_tiny()["correct"]


def test_step_leaving_its_cache_unchanged_is_caught(monkeypatch):
    from whisper_tpu_torch.models.whisper import model as M

    orig = M.decode_step

    def decode_step(params, tokens, positions, kv_head, cache, *a, **k):
        logits, _ = orig(params, tokens, positions, kv_head,
                         type(cache)(*(t.clone() for t in cache)), *a, **k)
        return logits, cache

    monkeypatch.setattr(M, "decode_step", decode_step)
    assert not run_tiny()["correct"]


def test_half_of_a_round_left_out_is_caught(monkeypatch):
    from whisper_tpu_torch.runtime.batching import WindowBatcher

    orig = WindowBatcher._run_group

    def _run_group(self, key, reqs):
        if len(reqs) < 2:
            return orig(self, key, reqs)
        half = len(reqs) // 2
        orig(self, key, reqs[:half])
        for i, r in enumerate(reqs[half:]):
            r.result, r.capture = reqs[i % half].result, (0, 0)

    monkeypatch.setattr(WindowBatcher, "_run_group", _run_group)
    # four clients of clips of four lengths, every client's request drawn:
    # the drawn windows ride rounds of several windows
    res = run_tiny(workload="tiny4")
    assert not res["correct"], res["checks"]


def test_cross_kv_rotated_among_a_rounds_windows_is_caught(monkeypatch):
    from whisper_tpu_torch.runtime import batching as B

    orig = B._stack

    def _stack(vals):
        out = orig(vals)
        if torch.is_tensor(out) and out.dim() == 5 and out.shape[0] > 1:
            return out.roll(1, 0)
        return out

    monkeypatch.setattr(B, "_stack", _stack)
    res = run_tiny(workload="tiny4")
    assert not res["correct"], res["checks"]


def test_cross_kv_left_from_the_last_round_is_caught(monkeypatch):
    from whisper_tpu_torch.decoding import device_loop as DL

    orig = DL.LoopState.load

    def load(self, cache_w, last_rows, xk, xv, *a, **k):
        if getattr(self, "_loaded", False):
            xk, xv = self.xk.clone(), self.xv.clone()
        self._loaded = True
        return orig(self, cache_w, last_rows, xk, xv, *a, **k)

    monkeypatch.setattr(DL.LoopState, "load", load)
    res = run_tiny()
    assert not res["correct"], res["checks"]
