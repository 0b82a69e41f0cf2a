"""The port's collectives on the CPU: parallel/mesh.py's two all-reduces
skip a one-rank group, and the collective audit
(whisper_tpu_torch/parallel/collective_audit.py) counts the decode step's
all-reduces at the model's seams, held against the JAX tool
(tools/collective_audit.py, run here as a subprocess on virtual CPU
devices at the same dims).

One launch of 2 gloo ranks (tests/torch_dist_ranks.py `collectives`,
which imports no JAX) serves the file: a (2, 1) mesh's tp axis is a
one-rank group on each rank, a (1, 2) mesh's spans both.

- On a one-rank group `all_reduce_sum` / `all_reduce_max` launch no
  torch.distributed.all_reduce and return their input bit for bit; on two
  ranks each launches one.
- The audit at tp = 1 reads no collective, and its step's logits equal
  tp=None's bit for bit.
- At tp = 2 the seams give, per decoder layer, one all-reduce (sum) of the
  (B, 1, S) f32 residual after each row-parallel product (self-attention
  o, cross-attention xo, mlp1: `_row_parallel`), and with the q8 cache one
  all-reduce (max) of the (B, 1, 2) row amax (`_quantize_rows`); nothing
  else.
- The JAX tool's all-reduce rows are the port's float-cache rows; its
  table also lists the collective-permutes GSPMD adds, which the port has
  none of.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from whisper_tpu_torch.parallel import collective_audit as CA
from whisper_tpu_torch.parallel.launch import launch

LAYERS, STATE, HEADS, BEAMS = 2, 256, 4, 8
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ranks():
    return launch("tests/torch_dist_ranks.py:collectives", 2, (LAYERS, STATE, HEADS, BEAMS),
                  threads=1, timeout=300)


@pytest.fixture(scope="module")
def jax_table():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "tools/collective_audit.py", "--layers", str(LAYERS),
                          "--state", str(STATE), "--heads", str(HEADS), "--beams", str(BEAMS),
                          "--tp", "2"], cwd=str(REPO), env=env, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    rows = re.findall(r"^\s+(\S+)\s+(\S+\[[\d,]*\])\s+x(\d+)\s+(\d+) B each$", out, re.M)
    return {(op, shape): (int(n), int(nb)) for op, shape, n, nb in rows}


def test_ranks_import_no_jax(ranks):
    assert all(r["foreign"] == [] for r in ranks)


def test_one_rank_group_launches_no_all_reduce(ranks):
    for r in ranks:
        one = r["one_rank"]
        assert one["group_size"] == 1 and one["calls"] == []
        np.testing.assert_array_equal(one["sum"], one["in"])
        np.testing.assert_array_equal(one["max"], one["in"])
        two = r["two_ranks"]
        assert two["group_size"] == 2 and two["calls"] == ["all-reduce", "all-reduce-max"]
    a, b = (r["two_ranks"] for r in ranks)
    np.testing.assert_allclose(a["sum"], a["in"] + b["in"], rtol=1e-6)
    np.testing.assert_array_equal(a["max"], np.maximum(a["in"], b["in"]))
    np.testing.assert_array_equal(a["sum"], b["sum"])


def test_audit_tp1_reads_zero(ranks):
    for r in ranks:
        assert r["tp1_f16"] == [] and r["tp1_q8"] == []
        assert r["tp1_equal_none"]
    assert CA.table_rows(1, [], LAYERS) == ["| 1 | none | 0.00 | 0.0 KiB |"]


@pytest.mark.parametrize("itype", ["f16", "q8"])
def test_audit_tp2_holds_the_seams(ranks, itype):
    resid = ("all-reduce", "f32", (BEAMS, 1, STATE), 4 * BEAMS * STATE)
    amax = ("all-reduce-max", "f32", (BEAMS, 1, 2), 4 * BEAMS * 2)
    # per layer: o, (q8: the cache row amax, before o), xo, mlp1
    layer = [amax, resid, resid, resid] if itype == "q8" else [resid] * 3
    for r in ranks:
        assert r[f"tp2_{itype}"] == layer * LAYERS
    counts, nbytes, _ = CA.summarize(ranks[0][f"tp2_{itype}"])
    assert sum(counts.values()) / LAYERS == (4 if itype == "q8" else 3)
    rows = CA.table_rows(2, ranks[0][f"tp2_{itype}"], LAYERS)
    want = "| 2 | 6 all-reduce + 2 all-reduce-max | 4.00 | 48.1 KiB |" if itype == "q8" \
        else "| 2 | 6 all-reduce | 3.00 | 48.0 KiB |"
    assert rows[0] == want


def test_audit_matches_the_jax_tools_all_reduces(ranks, jax_table):
    _, _, port = CA.summarize(ranks[0]["tp2_f16"])
    jax_ar = {k: v for k, v in jax_table.items() if k[0] == "all-reduce"}
    assert port == jax_ar
    assert set(op for op, _ in jax_table) <= {"all-reduce", "collective-permute"}
