"""Card test of chip_smoke.py phase 12's bounds: at full large-v3-turbo
width (its synthetic q5_0 file, read dense), on two ranks that share the
card over gloo, each bound of phase 12b and 12e lies above the sound
reading and below the reading of a planted fault, so the smoke's check
would see that fault on the card:

  * encoder (TP_ENC_REL): the attention-output bias added on every rank
    before the reduce;
  * logits, f16 and q8 caches (TP_LOGITS_REL): the decoder's row-parallel
    biases added on every rank before the reduce;
  * the q8 self-KV cache's scales (TP_XK_REL): the row amax taken over the
    rank's own heads only (the logits cannot see that one: it moves them
    no further than the reduce order does);
  * the dp=2 fine-tuning update (DP_FT_STEP_REL): the gradients not
    all-reduced, so each rank steps on its half of the batch.

The faults are planted in the ranks' processes only (tests/torch_dist_ranks.py
`planted_faults`).  It needs a CUDA card and skips without one (on the card:
`python -m pytest tests/test_torch_gpu_scale_out.py -m gpu -s`, which also
prints the readings).
"""

import json
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.gpu

HERE = Path(__file__).resolve().parent


def test_scale_out_bounds_see_planted_faults(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke as CS
    from whisper_tpu_torch.models.whisper.hparams import LARGE_V3_TURBO
    from whisper_tpu_torch.ops import _cuda
    from whisper_tpu_torch.parallel.launch import launch
    from whisper_tpu_torch.utils.synth import write_synth_model

    _cuda.build_all()
    path = str(tmp_path / "large-v3-turbo-q5_0.bin")
    write_synth_model(path, LARGE_V3_TURBO, seed=0, qtype="q5_0", decisive=True)
    r0, r1 = launch(f"{HERE / 'torch_dist_ranks.py'}:planted_faults", 2,
                    (path, CS.seeded_audio(40.0, seed=0)), backend="gloo", timeout=900)
    print("rank 0:", json.dumps(r0))
    print("rank 1:", json.dumps(r1))
    for r in (r0, r1):
        sound = r["sound"]
        assert sound["enc_rel"] <= CS.TP_ENC_REL < r["enc_o_bias_before_reduce"]["enc_rel"]
        for it in ("f16", "q8"):
            assert sound[it]["tokens_equal"]
            assert sound[it]["logits_rel"] <= CS.TP_LOGITS_REL
            assert r["dec_bias_before_reduce"][it]["logits_rel"] > CS.TP_LOGITS_REL
        assert sound["kv8"]["code_step_max"] <= 1
        assert sound["kv8"]["scale_rel"] <= CS.TP_XK_REL < r["local_q8_amax"]["kv8"]["scale_rel"]
    assert r0["grads_not_reduced"]["step_rel"] > CS.DP_FT_STEP_REL
