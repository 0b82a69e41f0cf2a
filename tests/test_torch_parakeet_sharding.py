"""The port's Parakeet tensor parallelism (parallel/parakeet_sharding.py,
models/parakeet/model.py `tp=`) against the JAX package on the CPU.

The JAX test_parakeet_sharding hparams on a dp 2 x tp 2 mesh of 4 ranks
(parallel/launch.py, gloo, one thread each; tests/torch_dist_ranks.py):
4 seeded utterances over dp, each dp rank's encode over its tp group (one
head per rank), then the TDT loop on the replicated predictor and joint.
Each utterance's encoder output is held to the JAX package's UNSHARDED
encode within 2e-5 of its largest value, and its TDT tokens are the JAX
`tdt_greedy_decode`'s.  The spec table equals the JAX one leaf for leaf,
and packed `PQW` planes raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.models.parakeet import model as JPM
from whisper_tpu.models.parakeet.decode import tdt_greedy_decode
from whisper_tpu.parallel import parakeet_sharding as JPS
from whisper_tpu_torch.models.parakeet.convert import params_from_numpy
from whisper_tpu_torch.models.parakeet.hparams import ParakeetHParams
from whisper_tpu_torch.models.parakeet.load import build_param_pytree
from whisper_tpu_torch.models.parakeet.model import PQW
from whisper_tpu_torch.models.parakeet.writer import synth_parakeet_tensors
from whisper_tpu_torch.parallel import parakeet_sharding as PPS
from whisper_tpu_torch.parallel.sharding import shard_tree
from whisper_tpu_torch.parallel.launch import launch

HP = ParakeetHParams(
    n_vocab=32, n_audio_ctx=512, n_audio_state=32, n_audio_head=2,
    n_audio_layer=2, n_mels=16, n_fft=64, subsampling_factor=8,
    n_subsampling_channels=16, n_conv_kernel=3, n_pred_dim=32,
    n_pred_layers=2, n_tdt_durations=2, n_max_tokens=4,
    tdt_durations=(0, 1))
W, T = 4, 128


@pytest.fixture(scope="module")
def mels():
    return np.random.default_rng(3).standard_normal((W, T, HP.n_mels)).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(mels):
    return launch("tests/torch_dist_ranks.py:parakeet_sharded", 4, (HP, mels, 2, 2),
                  threads=1)


def test_dp2_tp2_encode_and_tdt_match_jax_unsharded(ranks, mels):
    jp = jax.tree.map(jnp.asarray, build_param_pytree(synth_parakeet_tensors(HP), HP))
    seen = set()
    for r in ranks:
        assert r["foreign"] == []
        assert r["heads_local"] == HP.n_audio_head // 2
        for row, got in r["rows"].items():
            seen.add(row)
            enc = np.asarray(JPM.encode(jp, jnp.asarray(mels[row]), T, HP,
                                        dtype=jnp.float32))
            assert got["enc"].shape == enc.shape
            err = np.abs(got["enc"] - enc).max() / np.abs(enc).max()
            assert err <= 2e-5, (row, err)
            h = jnp.zeros((HP.n_pred_layers, HP.n_pred_dim))
            out = tdt_greedy_decode(jp, jnp.asarray(enc), jnp.int32(enc.shape[0]), h, h,
                                    HP, max_out=32, dtype=jnp.float32)
            n = int(out[6])
            np.testing.assert_array_equal(got["tokens"], np.asarray(out[0])[:n])
    assert seen == set(range(W))


def test_spec_table_matches_jax():
    jt = jax.tree.map(lambda s: s.index("tp") if "tp" in s else None,
                      JPS.parakeet_param_specs(),
                      is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    assert PPS.parakeet_param_specs() == jt


def test_packed_planes_raise():
    tree = params_from_numpy(build_param_pytree(synth_parakeet_tensors(HP), HP))
    w = tree["layers"]["attn_q_w"]
    tree["layers"]["attn_q_w"] = PQW(w.to(torch.int8), torch.ones(*w.shape[:-1], 1))
    with pytest.raises(ValueError, match="dense parameter tree only"):
        shard_tree(tree, PPS.parakeet_param_specs(), 2, 0, {})
