"""Scale-out on torch.distributed — the port of whisper_tpu/parallel.

The JAX package lets XLA GSPMD place its collectives over a (dp, tp)
`jax.sharding.Mesh`.  PyTorch has no GSPMD, so here every collective is
written where it goes: the model functions take a tensor-parallel process
group (`tp=`) and all-reduce after each row-parallel product
(models/whisper/model.py, models/parakeet/model.py), `shard_params` slices
the dense parameter tree to one rank's heads, `transcribe_multihost` splits
the audio over processes, and `OptContext(mesh=)` splits each batch over
the data-parallel axis (training/opt.py).

  * mesh.py — `make_mesh`, a (dp, tp) DeviceMesh over the default group's
    ranks, and the helpers the model seams call;
  * sharding.py, parakeet_sharding.py — the JAX spec tables as data (the
    dimension each leaf shards over tp, or None) and `shard_params`;
  * multihost.py — `init_distributed`, `make_global_mesh`,
    `transcribe_multihost`;
  * launch.py — N local ranks on a file:// rendezvous (tests, `chip_smoke.py`).
"""
