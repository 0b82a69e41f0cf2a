"""Model optimization on torch autograd — the capability analogue of
ggml-opt.

Port of whisper_tpu/training/opt.py, which mirrors the reference training
module surface (ggml/include/ggml-opt.h:30-240, ggml/src/ggml-opt.cpp):

  * loss types mean / sum / cross-entropy / mean-squared-error with the
    reference's exact scaling (mean and MSE divide by opt_period * n_outputs;
    cross-entropy is per-datapoint and divides by opt_period,
    ggml-opt.cpp:385-428);
  * AdamW and SGD optimizer steps with the reference's exact update math
    (decoupled weight decay `w *= 1 - alpha*wd`; bias-corrected momenta,
    ggml/src/ggml-cpu/ops.cpp:11685-11812) and defaults
    (alpha 1e-3, betas 0.9/0.999, eps 1e-8, wd 0 — ggml-opt.cpp:226-236);
  * gradient accumulation over `opt_period` physical batches
    (ggml-opt.h:124, ggml-opt.cpp:727-826);
  * shard-granular dataset shuffling and batch extraction
    (ggml_opt_dataset_shuffle / get_batch, ggml-opt.h:55-68);
  * per-batch loss statistics with the reference's uncertainty estimators and
    argmax classification accuracy (ggml_opt_result_*, ggml-opt.cpp:660-708);
  * `epoch` (train on the front of the dataset, eval on the back) and the
    high-level `fit` loop with the progress-bar callback
    (ggml-opt.h:220-240).

`OptimizerParams`, `Dataset` (the same numpy Generator shuffle, so the
orders match), `Result`, `epoch`, `fit` and the progress bar are the JAX
package's, numpy for numpy.  `OptContext` runs the same steps with torch
autograd on the device its parameters live on (the caller's `device`, the
CUDA card unless it passes "cpu"): forward, `torch.autograd.grad`, the
trainable mask, accumulation, and every `opt_period`-th call the update,
with the hyperparameters as f32 scalars computed as the JAX `_hyper` does.
A step or an eval holds decoding/graphs.py DEVICE_LOCK, and on the card
computes in IEEE f32 (`full_f32`: no TF32), so it computes what it computes
on the CPU up to the order of f32 sums.
A frozen parameter has its gradient zeroed, as the JAX `_mask_grads` does;
it still takes the update, so under wd > 0 it decays by 1 - alpha*wd every
step.  Data parallelism over a mesh (`mesh=`) is not ported: it is part of
the scale-out work (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

import contextlib
import sys
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..decoding.graphs import DEVICE_LOCK, full_f32

# loss types — ggml_opt_loss_type (ggml-opt.h:31-36)
LOSS_MEAN = "mean"
LOSS_SUM = "sum"
LOSS_CROSS_ENTROPY = "cross_entropy"
LOSS_MEAN_SQUARED_ERROR = "mse"

_LOSS_TYPES = (LOSS_MEAN, LOSS_SUM, LOSS_CROSS_ENTROPY, LOSS_MEAN_SQUARED_ERROR)


@dataclass
class OptimizerParams:
    """ggml_opt_optimizer_params (ggml-opt.h:88-100): one flat struct holds
    both optimizers' hyperparameters; `optimizer` on the context selects."""

    alpha: float = 1e-3   # learning rate (shared: adamw.alpha / sgd.alpha)
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    wd: float = 0.0       # decoupled weight decay; 0 disables


def default_optimizer_params(_userdata=None) -> OptimizerParams:
    """ggml_opt_get_default_optimizer_params (ggml-opt.cpp:226-236)."""
    return OptimizerParams()


class Dataset:
    """In-memory dataset with shard-granular shuffling.

    Mirrors ggml_opt_dataset (ggml-opt.h:38-68): `data` is (ndata,
    ne_datapoint), `labels` (ndata, ne_label) or None; `ndata_shard` is the
    granularity at which datapoints are shuffled (label rows move with their
    data rows).  Rows are numpy on host — batches stream to device per step,
    like the reference's backend_tensor_set upload per batch.
    """

    def __init__(self, data: np.ndarray, labels: Optional[np.ndarray] = None,
                 ndata_shard: int = 1):
        data = np.asarray(data)
        if data.ndim < 2:
            raise ValueError("data must be (ndata, ...)")
        if labels is not None:
            labels = np.asarray(labels)
            if labels.shape[0] != data.shape[0]:
                raise ValueError("labels/data length mismatch")
        if ndata_shard < 1 or data.shape[0] % ndata_shard:
            raise ValueError("ndata must be a multiple of ndata_shard")
        self.data = data
        self.labels = labels
        self.ndata_shard = ndata_shard
        self._perm = np.arange(data.shape[0] // ndata_shard)

    @property
    def ndata(self) -> int:
        return self.data.shape[0]

    def shuffle(self, rng: np.random.Generator, idata: int = -1) -> None:
        """Shuffle the first `idata` datapoints (all if negative) at shard
        granularity (ggml_opt_dataset_shuffle, ggml-opt.h:55)."""
        if idata < 0:
            idata = self.ndata
        if idata % self.ndata_shard:
            raise ValueError("idata must be a multiple of ndata_shard")
        nsh = idata // self.ndata_shard
        head = self._perm[:nsh].copy()
        rng.shuffle(head)
        self._perm[:nsh] = head

    def _rows(self, ibatch: int, nbatch: int) -> np.ndarray:
        ish = np.arange(ibatch * nbatch, (ibatch + 1) * nbatch)
        shard = self._perm[ish // self.ndata_shard]
        return shard * self.ndata_shard + (ish % self.ndata_shard)

    def get_batch(self, ibatch: int, nbatch: int
                  ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Batch `ibatch` of size `nbatch` in shuffled order
        (ggml_opt_dataset_get_batch, ggml-opt.h:58-68)."""
        rows = self._rows(ibatch, nbatch)
        return (self.data[rows],
                None if self.labels is None else self.labels[rows])


class Result:
    """Accumulates per-batch loss / accuracy statistics.

    Mirrors ggml_opt_result (ggml-opt.cpp:74-82, 660-708): `loss()` returns
    (value, uncertainty) where per-datapoint losses report the mean over
    batches with unc = sqrt(var/(n-1)), sum losses report the sum with
    unc = sqrt(var * n / (n-1)); `accuracy()` returns the argmax match rate
    with a binomial standard error over ndata-1.
    """

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.ndata = 0
        self.losses: List[float] = []
        self.ncorrect = 0
        self.preds: List[np.ndarray] = []
        self.loss_per_datapoint = False
        self.opt_period = 1

    def _accumulate(self, loss: float, ndata: int, ncorrect: Optional[int],
                    pred: Optional[np.ndarray], per_datapoint: bool,
                    opt_period: int) -> None:
        if self.ndata == 0:
            self.loss_per_datapoint = per_datapoint
            self.opt_period = opt_period
        self.ndata += ndata
        self.losses.append(float(loss))
        if ncorrect is None:
            self.ncorrect = -1
        elif self.ncorrect >= 0:
            self.ncorrect += int(ncorrect)
        if pred is not None:
            self.preds.append(np.asarray(pred))

    def loss(self) -> Tuple[float, float]:
        n = len(self.losses)
        if n == 0:
            return 0.0, float("nan")
        # per-datapoint losses were scaled by 1/opt_period per physical batch
        scaled = [l * self.opt_period if self.loss_per_datapoint else l
                  for l in self.losses]
        s = float(np.sum(scaled))
        mean = s / n
        if n < 2:
            return (mean if self.loss_per_datapoint else s), float("nan")
        var = float(np.sum((np.asarray(scaled) - mean) ** 2)) / n
        if self.loss_per_datapoint:
            return mean, float(np.sqrt(var / (n - 1)))
        return s, float(np.sqrt(var * n / (n - 1)))

    def accuracy(self) -> Tuple[float, float]:
        if self.ncorrect < 0 or self.ndata == 0:
            return float("nan"), float("nan")
        acc = self.ncorrect / self.ndata
        unc = (float(np.sqrt(acc * (1.0 - acc) / (self.ndata - 1)))
               if self.ndata >= 2 else float("nan"))
        return acc, unc

    def pred(self) -> np.ndarray:
        return (np.concatenate(self.preds)
                if self.preds else np.zeros((0,), np.int32))


def _loss_and_stats(outputs: torch.Tensor, labels: Optional[torch.Tensor],
                    loss_type: str, opt_period: int):
    """Loss exactly as ggml-opt builds it (ggml-opt.cpp:385-445), plus
    argmax predictions / ncorrect when labels are classifications."""
    n_out = outputs.numel()
    if loss_type == LOSS_MEAN:
        loss = torch.sum(outputs) / (opt_period * n_out)
    elif loss_type == LOSS_SUM:
        loss = torch.sum(outputs)
    elif loss_type == LOSS_CROSS_ENTROPY:
        # ggml_cross_entropy_loss: softmax CE against a label distribution,
        # mean over datapoint rows; rows = all leading dims of outputs.
        logp = torch.log_softmax(outputs.float(), dim=-1)
        nrows = max(1, n_out // outputs.shape[-1])
        loss = -torch.sum(labels * logp) / (nrows * opt_period)
    elif loss_type == LOSS_MEAN_SQUARED_ERROR:
        loss = torch.sum((outputs - labels) ** 2) / (opt_period * n_out)
    else:
        raise ValueError(f"unknown loss type {loss_type!r}")
    pred = ncorrect = None
    if labels is not None and outputs.ndim >= 2:
        pred = torch.argmax(outputs, dim=-1)
        ncorrect = torch.sum(pred == torch.argmax(labels, dim=-1))
    return loss, pred, ncorrect


def _adamw_step(p, g, m, v, h):
    """Exact reference AdamW (ggml-cpu/ops.cpp:11737-11748): decoupled decay
    applied independently of the momenta.  h = [alpha,b1,b2,eps,wd,b1h,b2h],
    f32 scalars."""
    alpha, b1, b2, eps, wd, b1h, b2h = h
    m = m * b1 + g * (1.0 - b1)
    v = v * b2 + g * g * (1.0 - b2)
    mh = m * b1h
    vh = torch.sqrt(v * b2h) + eps
    return p * (1.0 - alpha * wd) - alpha * mh / vh, m, v


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) in the order of jax.tree_util.tree_flatten_with_path, the
    path spelled as jax.tree_util.keystr spells it (['enc']['blocks'],
    [0]), so `trainable` predicates written for the JAX package apply."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, f"{prefix}[{i}]")]
    return [] if tree is None else [(prefix, tree)]


def _rebuild(tree, leaves: Dict[str, Any], prefix: str = ""):
    """`tree` with each leaf replaced by leaves[its path]."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_rebuild(v, leaves, f"{prefix}[{i}]") for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return None if tree is None else leaves[prefix]


class OptContext:
    """Train/eval driver over an arbitrary `model_fn(params, inputs)`.

    The capability analogue of ggml_opt_context (ggml-opt.h:112-155 +
    ggml_opt_alloc/eval): owns the parameter tree (tensors on `device`),
    optimizer moments, and gradient accumulators; `step()` is
    forward+backward (+optimizer every `opt_period` calls), `eval()` is
    forward-only.  `get_opt_pars(iter)` recomputes hyperparameters before
    every optimizer step, like the reference's callback (ggml-opt.h:103-110).

    `trainable(path) -> bool` freezes parameters (grads zeroed — the
    analogue of not flagging a tensor GGML_TENSOR_FLAG_PARAM; the update
    still applies, as in the JAX package).  `mesh` is not ported (ROADMAP
    Queue 1 item 12, scale-out) and raises.
    """

    def __init__(self, model_fn: Callable[[Dict[str, Any], Any], torch.Tensor],
                 params: Dict[str, Any],
                 loss_type: str = LOSS_CROSS_ENTROPY,
                 optimizer: str = "adamw",
                 opt_period: int = 1,
                 get_opt_pars: Optional[Callable[[int], OptimizerParams]] = None,
                 trainable: Optional[Callable[[str], bool]] = None,
                 mesh=None,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(
                "data parallelism over a mesh is not ported to whisper_tpu_torch "
                "(ROADMAP Queue 1 item 12, scale-out)")
        if loss_type not in _LOSS_TYPES:
            raise ValueError(f"unknown loss type {loss_type!r}")
        if optimizer not in ("adamw", "sgd"):
            raise ValueError(f"unknown optimizer {optimizer!r}")
        if opt_period < 1:
            raise ValueError("opt_period must be >= 1")
        from ..runtime.context import resolve_device

        self.device = resolve_device(device)
        self.model_fn = model_fn
        self.loss_type = loss_type
        self.optimizer = optimizer
        self.opt_period = int(opt_period)
        self.get_opt_pars = get_opt_pars or (lambda _it: OptimizerParams())
        self.iter = 1  # optimizer-step counter for bias correction
        self.opt_i = 0  # position within the current accumulation period

        self._tree = params
        self._paths = [p for p, _ in _flatten(params)]
        self._leaves = [torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a)
                        .detach().to(self.device).clone().requires_grad_(True)
                        for _, a in _flatten(params)]
        self._trainable = [bool(trainable(p)) if trainable else True
                           for p in self._paths]
        self.reset(optimizer=True)

    @property
    def params(self):
        """The parameter tree (the leaves are the context's tensors)."""
        return _rebuild(self._tree, dict(zip(self._paths, self._leaves)))

    # -- device placement ---------------------------------------------------
    def _to_device(self, batch):
        """Batches may be arrays or trees of arrays (dict inputs)."""
        if batch is None:
            return None
        if isinstance(batch, dict):
            return {k: self._to_device(v) for k, v in batch.items()}
        if isinstance(batch, (list, tuple)):
            return type(batch)(self._to_device(v) for v in batch)
        t = batch if torch.is_tensor(batch) else torch.as_tensor(np.asarray(batch))
        return t.to(self.device)

    @staticmethod
    def _batch_ndata(batch) -> int:
        leaves = [v for _, v in _flatten(batch)]
        return int(leaves[0].shape[0]) if leaves else 0

    # -- core steps ------------------------------------------------------------
    @contextlib.contextmanager
    def _device_section(self):
        """DEVICE_LOCK, and IEEE f32 products on the card."""
        with DEVICE_LOCK, (full_f32() if self.device.type == "cuda"
                           else contextlib.nullcontext()):
            yield

    def _loss(self, inputs, labels):
        outputs = self.model_fn(self.params, inputs)
        return _loss_and_stats(outputs, labels, self.loss_type, self.opt_period)

    def _hyper(self) -> Tuple[torch.Tensor, ...]:
        """[alpha, beta1, beta2, eps, wd, b1h, b2h] as f32 scalars, the
        bias-correction factors computed in Python as the JAX `_hyper` does
        (then rounded to f32, as its jnp.asarray)."""
        p = self.get_opt_pars(self.iter)
        b1h = 1.0 / (1.0 - p.beta1 ** self.iter)
        b2h = 1.0 / (1.0 - p.beta2 ** self.iter)
        h = torch.tensor([p.alpha, p.beta1, p.beta2, p.eps, p.wd, b1h, b2h],
                         dtype=torch.float32, device=self.device)
        return tuple(h.unbind(0))

    @torch.no_grad()
    def _update(self) -> None:
        h = self._hyper()
        for i, (p, g) in enumerate(zip(self._leaves, self._acc)):
            if self.optimizer == "adamw":
                new, self._m[i], self._v[i] = _adamw_step(p, g, self._m[i], self._v[i], h)
            else:  # sgd: w = w*(1 - alpha*wd) - alpha*g  (ops.cpp:11790-1812)
                alpha, wd = h[0], h[4]
                new = p * (1.0 - alpha * wd) - alpha * g
            p.copy_(new)
            self._acc[i] = torch.zeros_like(p)

    # -- public API -----------------------------------------------------------
    def reset(self, optimizer: bool = True) -> None:
        """Zero gradient accumulators (+ optimizer moments / iter if
        `optimizer`), mirroring ggml_opt_reset (ggml-opt.h:142)."""
        zeros = lambda: [torch.zeros_like(p, requires_grad=False) for p in self._leaves]
        self._acc = zeros()
        self.opt_i = 0
        if optimizer:
            self.iter = 1
            self._m, self._v = (zeros(), zeros()) if self.optimizer == "adamw" else ([], [])

    def step(self, inputs, labels=None, result: Optional[Result] = None) -> float:
        """Forward + backward on one physical batch; applies the optimizer on
        every `opt_period`-th call (ggml_opt_eval with backward graphs)."""
        apply_update = (self.opt_i + 1) % self.opt_period == 0
        with self._device_section():
            inputs = self._to_device(inputs)
            labels = self._to_device(labels)
            loss, pred, ncorrect = self._loss(inputs, labels)
            grads = torch.autograd.grad(loss, self._leaves, allow_unused=True)
            with torch.no_grad():
                for i, g in enumerate(grads):
                    if g is not None and self._trainable[i]:
                        self._acc[i] += g
            if apply_update:
                self._update()
        self.opt_i = (self.opt_i + 1) % self.opt_period
        if apply_update:
            self.iter += 1
        return self._record(loss.detach(), pred, ncorrect, inputs, result)

    def eval(self, inputs, labels=None, result: Optional[Result] = None) -> float:
        """Forward only (ggml_opt_eval without backward)."""
        with self._device_section(), torch.no_grad():
            inputs = self._to_device(inputs)
            labels = self._to_device(labels)
            loss, pred, ncorrect = self._loss(inputs, labels)
        return self._record(loss, pred, ncorrect, inputs, result)

    def _record(self, loss, pred, ncorrect, inputs, result) -> float:
        loss = float(loss)
        if result is not None:
            per_dp = self.loss_type != LOSS_SUM
            result._accumulate(
                loss, self._batch_ndata(inputs),
                None if ncorrect is None else int(ncorrect),
                None if pred is None else pred.cpu().numpy(),
                per_dp, self.opt_period)
        return loss


def _progress_bar(train: bool, loss: float, unc: float, acc: Tuple[float, float],
                  ibatch: int, ibatch_max: int, t_start: float) -> None:
    """ggml_opt_epoch_callback_progress_bar analogue (stderr, one line)."""
    frac = (ibatch + 1) / max(1, ibatch_max)
    bar = "=" * int(20 * frac) + " " * (20 - int(20 * frac))
    dt = time.time() - t_start
    tag = "train" if train else "val"
    sys.stderr.write(
        f"\r{tag}: [{bar}] {ibatch + 1}/{ibatch_max} "
        f"loss={loss:.6f}±{0.0 if np.isnan(unc) else unc:.6f} "
        f"acc={acc[0] * 100:.2f}% t={dt:.1f}s")
    if ibatch + 1 == ibatch_max:
        sys.stderr.write("\n")


def epoch(opt_ctx: OptContext, dataset: Dataset,
          result_train: Optional[Result], result_eval: Optional[Result],
          idata_split: int, nbatch: int,
          callback_train: Optional[Callable] = None,
          callback_eval: Optional[Callable] = None) -> None:
    """Train on dataset[:idata_split], evaluate on the rest
    (ggml_opt_epoch, ggml-opt.h:220-231)."""
    if idata_split < 0:
        idata_split = dataset.ndata
    if idata_split % nbatch:
        raise ValueError("idata_split must be a multiple of the batch size")
    nb_train = idata_split // nbatch
    nb_total = dataset.ndata // nbatch
    t0 = time.time()
    for ib in range(nb_train):
        data, labels = dataset.get_batch(ib, nbatch)
        opt_ctx.step(data, labels, result_train)
        if callback_train:
            callback_train(True, opt_ctx, dataset, result_train, ib, nb_train, t0)
    t0 = time.time()
    for ib in range(nb_train, nb_total):
        data, labels = dataset.get_batch(ib, nbatch)
        opt_ctx.eval(data, labels, result_eval)
        if callback_eval:
            callback_eval(False, opt_ctx, dataset, result_eval,
                          ib - nb_train, nb_total - nb_train, t0)


def fit(model_fn, params, dataset: Dataset,
        loss_type: str = LOSS_CROSS_ENTROPY,
        optimizer: str = "adamw",
        get_opt_pars: Optional[Callable[[int], OptimizerParams]] = None,
        nepoch: int = 1,
        nbatch_logical: int = 32,
        nbatch_physical: Optional[int] = None,
        val_split: float = 0.05,
        seed: int = 0,
        silent: bool = False,
        trainable: Optional[Callable[[str], bool]] = None,
        mesh=None,
        device=None) -> Dict[str, Any]:
    """High-level training loop (ggml_opt_fit, ggml-opt.h:236+): shuffles
    once up front, then per epoch shuffles the train split, runs `epoch`,
    and prints loss/accuracy.  Returns the trained parameter tree."""
    nbatch_physical = nbatch_physical or nbatch_logical
    if nbatch_logical % nbatch_physical:
        raise ValueError("nbatch_logical must be a multiple of nbatch_physical")
    opt_period = nbatch_logical // nbatch_physical
    ctx = OptContext(model_fn, params, loss_type=loss_type,
                     optimizer=optimizer, opt_period=opt_period,
                     get_opt_pars=get_opt_pars, trainable=trainable, mesh=mesh,
                     device=device)
    rng = np.random.default_rng(seed)
    nb = dataset.ndata // nbatch_physical
    nb_eval = int(round(nb * val_split))
    idata_split = (nb - nb_eval) * nbatch_physical
    dataset.shuffle(rng)  # whole dataset once, incl. the future val split
    for ep in range(nepoch):
        dataset.shuffle(rng, idata_split)
        rt, re = Result(), Result()
        cb = None if silent else (
            lambda train, c, d, r, ib, ibm, t0:
            _progress_bar(train, *r.loss(), r.accuracy(), ib, ibm, t0))
        epoch(ctx, dataset, rt, re, idata_split, nbatch_physical, cb, cb)
        if not silent:
            tl, tu = rt.loss()
            vl, vu = re.loss() if re.ndata else (float("nan"), float("nan"))
            sys.stderr.write(
                f"epoch {ep + 1}/{nepoch}: train loss {tl:.6f}±{tu:.6f}"
                + (f", val loss {vl:.6f}±{vu:.6f}\n" if re.ndata else "\n"))
    return ctx.params
