"""The comparison that decides `correct`.

For each request the run drew, the reference recomputes everything from
the request's audio and the model file: the mel, each window's encoder
output and cross K/V, and one causal pass over the window's prompt and the
tokens the server chose.  It then replays whisper.cpp's logit filters and
window rules (src/whisper.cpp:6194-6469, 7360-7443, 7530-7700) over those
tokens, in float64 on the host, and rebuilds the response's text.

Numbers (each the worst over the drawn requests):
  mel      max |served mel - reference mel|
  enc      max over windows of rms(encoder output - reference) / rms(reference)
  xkv      max over windows of rms(cross K or V - reference) / rms(reference),
           the cross K/V the window's decode steps read, at every
           probe.XKV_EVERY-th audio frame
  prompt   max over windows of |log p - log p_ref| of the prompt pass's
           softmax, over the tokens the reference gives p_ref > 1e-12
  steps    max over chosen tokens of |log ptsum - log ptsum_ref|, the
           timestamp tokens' share of the filtered distribution at each
           step through the self-attention cache, where ptsum_ref > 1e-12
  logprob  max over chosen tokens of |the server's filtered logprob - the
           reference's|
  gap      max over chosen tokens of how far the token's filtered logit
           lies below the reference's best
  text     mismatches, counted exactly: a window's seek, end or prompt,
           its tokens' end and state (result length, seek delta, failed,
           completed), the windows' count, and the response text against
           what the rules make of the tokens
With `ctrl` (the reference in fp8), `check_request` also reads the same
numbers for the control at the same prompts and tokens; there `gap` is
taken at the token the control puts first.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from ..model_file import special_tokens
from ..probe import XKV_EVERY

NAMES = ("mel", "enc", "xkv", "prompt", "steps", "logprob", "gap", "text")
P_FLOOR = 1e-12
DELTA_MIN = 10


class Rules:
    """whisper.cpp's greedy t = 0 rules at the server's defaults
    (suppress_blank, max_initial_ts 1 s, timestamps on, no token cap)."""

    def __init__(self, hp: Dict[str, int], vocab: List[bytes]):
        self.tk = special_tokens(hp["n_vocab"])
        self.V = hp["n_vocab"]
        self.n_max = hp["n_text_ctx"] // 2 - 4
        self.max_prompt = hp["n_text_ctx"] // 2 - 1
        try:
            self.space = vocab.index(b" ")
        except ValueError:
            self.space = None
        tk = self.tk
        base = np.zeros(self.V)
        for k in ("not_", "sot", "nosp", "solm", "translate", "transcribe", "prev"):
            base[tk[k]] = -np.inf
        base[tk["sot"] + 1: tk["sot"] + 1 + tk["n_lang"]] = -np.inf
        self.base = base
        first = np.zeros(self.V)
        first[tk["eot"]] = -np.inf
        if self.space is not None:
            first[self.space] = -np.inf
        tid0 = int(round(1.0 / (30.0 / hp["n_audio_ctx"])))
        first[tk["beg"] + tid0 + 1:] = -np.inf
        self.first = first

    def filtered(self, raw: np.ndarray, i: int, last: int, penult: int,
                 has_ts: bool, seek_delta: int):
        """(filtered logits, logprobs) of step i (float64)."""
        beg, eot = self.tk["beg"], self.tk["eot"]
        l = raw.astype(np.float64) + self.base
        if i == 0:
            l = l + self.first
        if i > 0 and last >= beg:
            if i < 2 or penult >= beg:
                l[beg:] = -np.inf
            else:
                l[:eot] = -np.inf
        if has_ts:
            l[beg: beg + seek_delta // 2] = -np.inf
        m = l.max()
        lp = l - (m + math.log(np.exp(l - m).sum()))
        ts = lp[beg:]
        tm = ts.max()
        ts_lse = tm + math.log(np.exp(ts - tm).sum()) if np.isfinite(tm) else -np.inf
        if ts_lse > lp[:beg].max():
            l[:beg] = -np.inf
            lp[:beg] = -np.inf
        return l, lp

    def prompt(self, past: List[int]) -> List[int]:
        tk = self.tk
        head = [tk["prev"]] + past[-min(self.max_prompt, len(past)):] if past else []
        return head + [tk["sot"], tk["sot"] + 1, tk["transcribe"]]


def _kv_frames(kv, n_head: int):
    """(K, V), each (layers, heads, frames, head size), at every
    XKV_EVERY-th frame of the [(K, V)] per layer, each (frames, state)."""
    out = []
    for i in (0, 1):
        x = torch.stack([layer[i][::XKV_EVERY] for layer in kv])        # (L, F, S)
        out.append(x.view(*x.shape[:2], n_head, -1).transpose(1, 2))
    return out


def _xkv_gap(got, ref) -> float:
    """Worst of K and V: rms(got - ref) / rms(ref)."""
    return max(((g.to(r.device) - r).norm() / r.norm()).item() for g, r in zip(got, ref))


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max())
    return e / e.sum()


def _log_gap(p: np.ndarray, p_ref: np.ndarray) -> float:
    """Largest |log p - log p_ref| over the tokens with p_ref > P_FLOOR."""
    m = p_ref > P_FLOOR
    with np.errstate(divide="ignore"):
        return float(np.abs(np.log(p[m].astype(np.float64)) - np.log(p_ref[m])).max())


class Tally:
    def __init__(self):
        self.v = {k: 0.0 for k in NAMES}
        self.n_tokens = 0
        self.n_windows = 0
        self.notes: List[str] = []
        self.margins: List[float] = []   # the reference's top-2 filtered margins

    def worst(self, name: str, x: float) -> None:
        self.v[name] = max(self.v[name], float(x))

    def miss(self, what: str) -> None:
        self.v["text"] += 1
        if len(self.notes) < 8:
            self.notes.append(what)


def check_request(ref, rules: Rules, pcm: np.ndarray, text: Optional[str], sample,
                  tally: Tally, ctrl=None, ctrl_tally: Optional[Tally] = None) -> None:
    """Hold one served request (`sample`: probe.Sample) to the reference;
    with `ctrl`, read the control's numbers at the same prompts and tokens."""
    tk, beg, eot = rules.tk, rules.tk["beg"], rules.tk["eot"]
    mel, n_len_org = ref.mel(pcm)
    if sample.mel is None or tuple(sample.mel.shape) != mel.shape:
        tally.miss(f"{sample.rid}: mel shape")
    else:
        tally.worst("mel", np.abs(sample.mel - mel).max())
    if ctrl is not None:
        cmel = ctrl.mel(pcm)[0]
        ctrl_tally.worst("mel", np.abs(cmel - mel).max())
    if len(sample.enc) != len(sample.windows):
        tally.miss(f"{sample.rid}: {len(sample.enc)} encodes for {len(sample.windows)} windows")
    seek, seek_end, past, out = 0, n_len_org, [], []
    for wi, w in enumerate(sample.windows):
        if seek + DELTA_MIN >= seek_end:
            tally.miss(f"{sample.rid}: window {wi} past the end")
            break
        if seek > 0 and seek + 500 >= seek_end:
            past = []
        prompt = rules.prompt(past)
        if (w["seek"], w["seek_end"], w["prompt"]) != (seek, seek_end, prompt):
            tally.miss(f"{sample.rid}: window {wi} seek/end/prompt")
        enc = ref.encode(ref.window(mel, seek))
        if wi < len(sample.enc):
            e = sample.enc[wi].to(enc.device)
            tally.worst("enc", ((e - enc).norm() / enc.norm()).item())
        kv = ref.cross_kv(enc)
        kv_ref = _kv_frames(kv, ref.hp["n_text_head"])
        if wi < len(sample.xkv):
            tally.worst("xkv", _xkv_gap(sample.xkv[wi], kv_ref))
        else:
            tally.miss(f"{sample.rid}: window {wi}'s cross K/V not read")
        toks = w["tok"]
        n = len(toks)
        seq = prompt + toks[:-1]
        raw = ref.logits(seq, kv)[len(prompt) - 1:].double().cpu().numpy()
        p_ref = _softmax(raw[0])
        tally.worst("prompt", _log_gap(w["prompt_probs"], p_ref))
        craw = None
        if ctrl is not None:
            cenc = ctrl.encode(ctrl.window(cmel, seek))
            ctrl_tally.worst("enc", ((cenc - enc).norm() / enc.norm()).item())
            ckv = ctrl.cross_kv(cenc)
            ctrl_tally.worst("xkv", _xkv_gap(_kv_frames(ckv, ref.hp["n_text_head"]), kv_ref))
            craw = ctrl.logits(seq, ckv)[len(prompt) - 1:].double().cpu().numpy()
            ctrl_tally.worst("prompt", _log_gap(_softmax(craw[0]), p_ref))
            ctrl_tally.n_windows += 1
        # the window's state, replayed over the chosen tokens
        has_ts, seek_delta, result_len, failed, completed = False, 100 * 30, 0, False, False
        last = penult = -1
        for i, t in enumerate(toks):
            l, lp = rules.filtered(raw[i], i, last, penult, has_ts, seek_delta)
            tally.worst("gap", l.max() - l[t])
            top2 = np.partition(l, -2)[-2:]
            tally.margins.append(float(top2[1] - top2[0]))
            ptsum = float(np.exp(lp[beg:]).sum())
            if ptsum > P_FLOOR:
                tally.worst("steps", abs(math.log(max(w["ptsum"][i], 1e-300)) - math.log(ptsum)))
            tally.worst("logprob", abs(w["plog"][i] - lp[t]) if np.isfinite(lp[t]) else 1e30)
            tally.n_tokens += 1
            if craw is not None:
                cl, clp = rules.filtered(craw[i], i, last, penult, has_ts, seek_delta)
                first = int(np.argmax(cl))
                ctrl_tally.worst("gap", l.max() - l[first])
                if ptsum > P_FLOOR:
                    c_ptsum = float(np.exp(clp[beg:]).sum())
                    ctrl_tally.worst("steps", abs(math.log(max(c_ptsum, 1e-300))
                                                  - math.log(ptsum)))
                ctrl_tally.worst("logprob", abs(clp[t] - lp[t])
                                 if np.isfinite(clp[t]) and np.isfinite(lp[t]) else 1e30)
                ctrl_tally.n_tokens += 1
            is_ts = t > beg
            fail_seek = is_ts and has_ts and seek_delta > 2 * (t - beg) and result_len < i
            if is_ts and not fail_seek:
                seek_delta, result_len, has_ts = 2 * (t - beg), i + 1, True
            end_window = seek + seek_delta + DELTA_MIN >= seek_end
            complete = not fail_seek and (t == eot or (has_ts and end_window))
            if complete and result_len == 0:
                if end_window:
                    result_len = i + 1
                else:
                    fail_seek, complete = True, False
            if (i == rules.n_max - 1 and not fail_seek and not complete
                    and (result_len == 0 or seek_delta < 100 * 30 // 2)):
                fail_seek = True
            penult, last = last, t
            if fail_seek or complete:
                failed, completed = fail_seek, complete
                if i != n - 1:
                    tally.miss(f"{sample.rid}: window {wi} ran past its end at token {i}")
                break
        if n and not (failed or completed) and n != rules.n_max:
            tally.miss(f"{sample.rid}: window {wi} stopped early at {n} tokens")
        got = (w["result_len"], w["seek_delta"], w["failed"], w["completed"])
        if got != (result_len, seek_delta, failed, completed):
            tally.miss(f"{sample.rid}: window {wi} state {got} != "
                       f"{(result_len, seek_delta, failed, completed)}")
        tally.n_windows += 1
        # emission (one decoder, no fallback)
        cur = toks if failed else toks[:result_len]
        avg = (sum(w["plog"][:result_len]) / result_len
               if not failed and result_len > 0 else -math.inf)
        no_speech = w["prompt_probs"][tk["nosp"]] > 0.6 and avg < -1.0
        new_past = prompt[1:len(prompt) - 3] if prompt[0] == tk["prev"] else []
        past = new_past + ([] if no_speech else cur[:result_len])
        if cur and not no_speech:
            text_acc, i = "", 0
            while i < len(cur):
                if cur[i] < eot:
                    text_acc += ref.token_text(cur[i])
                if cur[i] > beg:
                    if text_acc:
                        out.append(text_acc)
                    text_acc = ""
                    while i + 1 < len(cur) and cur[i + 1] > beg:
                        i += 1
                i += 1
            if text_acc:
                out.append(text_acc)
        if len(cur) > 1 and cur[-2] < beg and cur[-1] > beg:
            seek_delta = min(seek_end - seek, 100 * 30)
        seek += seek_delta
    else:
        if seek + DELTA_MIN < seek_end:
            tally.miss(f"{sample.rid}: windows end at frame {seek} of {seek_end}")
    if text is not None and text != "".join(s + "\n" for s in out):
        tally.miss(f"{sample.rid}: response text")
