"""Beam search's window loop at every flag period against the JAX package:
the cases of test_torch_window_loop.py (which says what is held and how)
for the beam strategy, in a file of their own so that xdist's --dist
loadfile runs them beside the greedy ones."""

import pytest

from test_torch_window_loop import (check_window_loop, model_path, one_torch_thread,  # noqa: F401
                                    pcm)


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("kv_itype", ["f16", "q8"])
def test_beam_window_loop_matches_jax_for_every_flag_period(model_path, pcm,
                                                            kv_itype, k):
    check_window_loop(model_path, pcm, "beam", kv_itype, k)
