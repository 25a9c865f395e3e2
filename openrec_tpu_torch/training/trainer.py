"""Training and evaluation harness.

Counterpart of `openrec_tpu/training/trainer.py`. One optimizer step is
autograd (`torch.autograd.grad` of the model's total loss: dense
gradients, as JAX's value_and_grad gives them) -> `model.grad_transform`
-> the optimizer's `update` -> in-place `apply_updates` ->
`model.post_step`. The JAX package's fused K-step (`lax.scan`,
`trainer.py:149-203`) is a K-iteration Python loop inside one call that
keeps the losses on the device: no `.item()` or host copy inside it.

Ported: `train_step`, `train_step_multi`, `train_step_multi_flat`,
`_dispatch_multi`, `train_steps_device` (on-device sampling);
`train(...)` with `steps_per_call`, every `feed` mode, `eval_interval`,
`save_interval`, `defer_metrics`, `scorer=` and a JSONL `log_file`;
`evaluate` on mask batches, id batches (`device_masks=True`), through a
`CachedDotProductScorer` and with `dump_path`; `save` / `restore` in the
JAX package's checkpoint format; warm start from `init_model_dir`;
`profile` through `torch.profiler`.

With `sparse_tables` (JAX `trainer.py:58-61, 82-88`) every step of every
entry point is the O(batch) sparse step of `training/sparse.py` instead:
gather -> Adam -> scatter on the named tables, and `optimizer` (default
optax-form `adam(lr)`) on the other parameters only.

Every step of every entry point passes the trainer's `torch.Generator`
to `model.loss(batch, generator=...)` (JAX passes a per-step rng,
`trainer.py:103-105, 119-202`): a model whose loss draws randomness
(MLPRec's, NeuMF's and CDL's dropout) draws from it, a model that draws
nothing leaves it where it was, so device-sampled streams do not move.
The same generator drives on-device sampling.

Not in this slice, each coming with the model that needs it:
`evaluate_temporal`, the per-record regression eval, and
`update_interval` / `update_fn`.

Behaviours kept from the JAX package and tested: `feed='auto'` reads a
batch as stacked whenever every value has ndim >= 2 and leading dim k;
an empty batch stream with `steps_per_call` k > 1 and a non-per-step
feed still requires `total_iter % k == 0` (raised as ValueError here,
an assert there) and then trains nothing.
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from openrec_tpu_torch import checkpoint as ckpt_lib
from openrec_tpu_torch.convert import flatten_tree, unflatten_like
from openrec_tpu_torch.data.pipeline import device_iterator, to_device
from openrec_tpu_torch.device import resolve_device
from openrec_tpu_torch.metrics import (DeviceDictMean, DeviceMean, DictMean,
                                       Mean, ids_to_masks)
from openrec_tpu_torch.metrics.ranking import ranking_metrics
from openrec_tpu_torch.training.optim import apply_updates, lazy_adam
from openrec_tpu_torch.training.sparse import make_sparse_train_step

FEEDS = ("auto", "per_step", "flat", "stacked")


def _color(text, code):
    if not sys.stdout.isatty():
        return text
    return f"\033[{code}m{text}\033[0m"


def _stacked_like(batch: dict, k: int) -> bool:
    """feed='auto': every value has ndim >= 2 and leading dim k."""
    return all(np.ndim(v) >= 2 and tuple(np.shape(v))[0] == k
               for v in batch.values())


class Trainer:

    def __init__(self, model, optimizer=None, lr: float = 1e-3, seed: int = 0,
                 save_model_dir: Optional[str] = None,
                 init_model_dir: Optional[str] = None,
                 max_to_keep: int = 10,
                 log_file: Optional[str] = None,
                 sparse_tables=None, device=None):
        """
        model: a Recommender (`openrec_tpu_torch.models`) whose parameters
          lie on `device` (default CUDA; raises without it unless
          device='cpu').
        optimizer: a GradientTransformation of `training/optim.py`.
          Default lazy_adam(lr): rows-touched updates; pass
          keras_adam(lr) for the reference's dense Adam trajectory. With
          sparse_tables: the dense parameters' optimizer only.
        seed: seeds the trainer's `torch.Generator` on `device`, which
          drives on-device sampling (`train_steps_device`) and every
          randomness a model's loss draws (dropout).
        init_model_dir: warm-start checkpoint dir; its latest checkpoint's
          params are loaded optimistically (entries whose name and shape
          match), before the optimizer state is made.
        sparse_tables: optional table specs (`training/sparse.py`, e.g.
          `dlrm_fused_table_spec(model)`) switching every step to the
          O(batch) gather -> Adam(lr) -> scatter update of those tables;
          `optimizer` then applies to the other parameters only, and
          defaults to optax-form `adam(lr)`.
        """
        self.device = resolve_device(device)
        for name, p in model.named_parameters():
            if p.device != self.device:
                raise ValueError(f"parameter '{name}' lies on {p.device}, "
                                 f"the trainer runs on {self.device}")
        self.model = model
        self.lr = lr
        self.tx = optimizer if optimizer is not None else lazy_adam(lr)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.save_model_dir = save_model_dir
        self.max_to_keep = max_to_keep
        self.log_file = log_file
        if init_model_dir is not None:
            path = ckpt_lib.latest_checkpoint(init_model_dir)
            if path is not None:
                template = {f"params/{k}": v.detach()
                            for k, v in self.params.items()}
                flat = ckpt_lib.restore(path, template, optimistic=True)
                model.load_params({k[len("params/"):]: v
                                   for k, v in flat.items()})
                self._log(f"warm-started from {path}")
        self.sparse_tables = sparse_tables
        if sparse_tables is not None:
            init_fn, self._sparse_step = make_sparse_train_step(
                model, sparse_tables, learning_rate=lr, dense_tx=optimizer)
            self.opt_state = init_fn(self.params)
        else:
            self.opt_state = self.tx.init(self.params)
        self.global_step = 0

    @property
    def params(self) -> dict:
        """{name: parameter} of the model, keyed like the JAX pytree."""
        return self.model.params()

    # ------------------------------------------------------------------ #

    def _step_body(self, batch: dict):
        """One optimizer step on a batch of device tensors; returns the
        total loss and the aux dict, detached, on the device."""
        if self.sparse_tables is not None:
            self.opt_state, loss = self._sparse_step(self.opt_state, batch,
                                                     self.generator)
            return loss, {"loss": loss}
        params = self.params
        names = list(params)
        total, aux = self.model.loss(batch, generator=self.generator)
        grads = torch.autograd.grad(total, [params[n] for n in names],
                                    allow_unused=True)
        grads = {n: torch.zeros_like(params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        grads = self.model.grad_transform(grads, batch)
        with torch.no_grad():
            updates, self.opt_state = self.tx.update(grads, self.opt_state,
                                                     params)
            apply_updates(params, updates)
            self.model.post_step(batch)
        return total.detach(), {k: v.detach() for k, v in aux.items()}

    def train_step(self, batch: dict):
        """One optimizer step on a numpy/tensor batch dict; returns
        (loss, aux) on the device."""
        loss, aux = self._step_body(to_device(batch, self.device))
        self.global_step += 1
        return loss, aux

    def train_step_multi(self, batches: list):
        """K optimizer steps in one call over K batch dicts (stacked on the
        host, copied once). Identical math to K train_step calls. Returns
        the per-step loss vector [K] on the device."""
        k = len(batches)
        stacked = {key: np.stack([np.asarray(b[key]) for b in batches])
                   for key in batches[0]}
        return self._dispatch_multi(stacked, k)

    def train_step_multi_flat(self, flat_batch: dict, k: int):
        """Like train_step_multi, but takes ONE flat batch of k*B examples
        (e.g. one sampler call with batch_size=k*B) and runs k sequential
        steps of B."""
        stacked = {key: np.asarray(v).reshape(
            (k, -1) + np.asarray(v).shape[1:])
            for key, v in flat_batch.items()}
        return self._dispatch_multi(stacked, k)

    def _dispatch_multi(self, stacked: dict, k: int):
        """k steps over a dict of [k, B, ...] arrays or tensors; the losses
        stay on the device."""
        stacked = to_device(stacked, self.device)
        losses = [self._step_body({key: v[i] for key, v in stacked.items()})
                  [0] for i in range(k)]
        self.global_step += k
        return torch.stack(losses)

    def train_steps_device(self, sampler, k: int, fused: bool = False):
        """K optimizer steps with ON-DEVICE batch sampling: the host sends
        no batch. `sampler` is a Device*Sampler (data/device_sampler.py)
        on the trainer's device, drawing from the trainer's generator.
        With `sample_stacked` (and fused=False) the k batches are drawn in
        one go and fed to the K-step loop; otherwise each step samples its
        own batch."""
        if not fused and hasattr(sampler, "sample_stacked"):
            return self._dispatch_multi(
                sampler.sample_stacked(self.generator, k), k)
        losses = [self._step_body(sampler.sample(self.generator))[0]
                  for _ in range(k)]
        self.global_step += k
        return torch.stack(losses)

    def _make_fused_feed(self, it, k: int, feed: str):
        """(it, fused_feed) for train(steps_per_call=k, feed=...): wraps
        the batch iterator into a stream of [k, B, ...] payloads on the
        device, two copies in flight. fused_feed is None for per-step
        feeds (the peeked batch is pushed back onto `it`)."""
        try:
            first = next(it)
        except StopIteration:
            return iter(()), iter(())     # empty stream: the loop exits
        if feed == "auto":
            feed = "stacked" if _stacked_like(first, k) else "per_step"
        if feed == "per_step":
            return itertools.chain([first], it), None

        def _restack(b):
            if feed == "flat":
                return {key: np.asarray(v).reshape(
                    (k, -1) + np.asarray(v).shape[1:])
                    for key, v in b.items()}
            return b

        stream = map(_restack, itertools.chain([first], it))
        return it, device_iterator(stream, self.device, prefetch=2)

    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def _eval_batch(self, user_id, pos_mask, excl_mask, at):
        pred = self.model.score({"user_id": user_id})
        return ranking_metrics(pos_mask, pred, excl_mask, at=at)

    def evaluate(self, eval_sampler, at=(50, 100),
                 eval_fn: Callable = None, scorer=None,
                 eval_chunk: int = 16384,
                 dump_path: Optional[str] = None,
                 defer_metrics: bool = False) -> dict:
        """Run one epoch of an EvaluationSampler; returns metric means.
        Accepts mask batches and id batches (device_masks=True).

        scorer: optional CachedDotProductScorer; id batches then take its
        chunked giant-catalog path (O(B*eval_chunk) memory).

        dump_path: optional .npz path; dumps every evaluated user's raw
        full-catalog score row (plus user ids). Not with `scorer`.

        defer_metrics: accumulate on the device and return a dict of
        device tensors; nothing is copied to the host."""
        acc = None
        if defer_metrics:
            if dump_path is not None:
                raise ValueError("dump_path copies scores to the host; not "
                                 "with defer_metrics")
            acc = DeviceDictMean()
        if scorer is not None:
            # params changed since the last eval epoch
            scorer.mark_dirty()
            if dump_path is not None:
                raise ValueError("dump_path requires the dense scoring path "
                                 "(no scorer)")
        at = tuple(at)
        dump_users, dump_scores = [], []
        show_progress = sys.stdout.isatty() and not defer_metrics
        try:
            n_total = len(eval_sampler)
        except TypeError:
            n_total = None
        t_prog = time.time()
        progress_shown = False
        for i_batch, batch in enumerate(eval_sampler):
            if show_progress and time.time() - t_prog > 0.5:
                t_prog = time.time()
                progress_shown = True
                frac = (f"{i_batch + 1}/{n_total}" if n_total
                        else f"{i_batch + 1}")
                print(f"  eval batch {frac}", end="\r", flush=True)
            if "label" in batch and "item_id" in batch:
                raise NotImplementedError(
                    "per-record regression eval comes with the models that "
                    "use it; the port evaluates ranking batches")
            dev_batch = to_device(
                {k: v for k, v in batch.items() if k != "valid"},
                self.device)
            user_id = dev_batch["user_id"]
            if eval_fn is not None:
                out = eval_fn(self.params, user_id, dev_batch["pos_mask"],
                              dev_batch["excl_mask"])
            elif scorer is not None and "pos_ids" in batch:
                out = scorer.eval_metrics(
                    self.params, user_id, dev_batch["pos_ids"],
                    dev_batch["excl_ids"], at=at, chunk=eval_chunk)
            elif "pos_ids" in batch:
                pos_mask, excl_mask = ids_to_masks(
                    dev_batch["pos_ids"], dev_batch["excl_ids"],
                    self.model.total_items)
                out = self._eval_batch(user_id, pos_mask, excl_mask, at)
            else:
                out = self._eval_batch(user_id, dev_batch["pos_mask"],
                                       dev_batch["excl_mask"], at)
            valid = batch.get("valid")
            if defer_metrics:
                acc.update_state(out, valid=None if valid is None else
                                 torch.as_tensor(valid).to(self.device))
            else:
                out = {k: torch.as_tensor(v).cpu().numpy()
                       for k, v in out.items()}
                if acc is None:
                    acc = DictMean({k: list(v.shape[1:])
                                    for k, v in out.items()})
                acc.update_state(out, valid=valid)
            if dump_path is not None:
                with torch.no_grad():
                    rows = self.model.score({"user_id": user_id}).cpu()
                keep = np.asarray(batch.get(
                    "valid", np.ones(len(batch["user_id"]), bool)))
                dump_users.append(np.asarray(batch["user_id"])[keep])
                dump_scores.append(rows.numpy()[keep])
        if progress_shown:
            print("\r\x1b[K", end="", flush=True)
        if dump_path is not None:
            os.makedirs(os.path.dirname(dump_path) or ".", exist_ok=True)
            np.savez(dump_path,
                     user_ids=np.concatenate(dump_users)
                     if dump_users else np.empty(0, np.int32),
                     scores=np.concatenate(dump_scores)
                     if dump_scores else np.empty((0, 0), np.float32))
        if defer_metrics:
            return acc.result_device() if acc._sums else {}
        return acc.result() if acc is not None else {}

    # ------------------------------------------------------------------ #

    def _log(self, msg, color=None):
        print(msg if color is None else _color(msg, color), flush=True)

    def _log_jsonl(self, record: dict):
        if self.log_file:
            os.makedirs(os.path.dirname(self.log_file) or ".", exist_ok=True)

            def _default(o):
                if isinstance(o, torch.Tensor):
                    return o.tolist()
                if hasattr(o, "tolist"):
                    return o.tolist()
                return float(o)
            with open(self.log_file, "a") as f:
                f.write(json.dumps(record, default=_default) + "\n")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self, total_iter: int, train_batches,
              eval_samplers: Optional[dict] = None,
              eval_interval: Optional[int] = None,
              save_interval: Optional[int] = None,
              at=(50, 100),
              eval_fn: Callable = None,
              train_iter_hook: Callable = None,
              steps_per_call: int = 1,
              scorer=None, eval_chunk: int = 16384,
              defer_metrics: bool = False,
              feed: str = "auto",
              verbose: bool = True) -> dict:
        """Iteration-driven loop (the JAX package's `Trainer.train`).

        train_batches: iterable of batch dicts (e.g. Dataset.pairwise(...)),
          or a Device*Sampler (an object with `sample` and no `__iter__`),
          which trains with on-device sampling.
        eval_samplers: {name: EvaluationSampler} evaluated every
          eval_interval iterations.
        train_iter_hook: optional f(trainer, batch) replacing the default
          step; only with steps_per_call=1.
        steps_per_call: k optimizer steps per call (train_step_multi);
          intervals should be multiples of k.
        feed: how train_batches maps onto k-step calls when k > 1
          (ignored at k=1 and for device samplers):
          - 'per_step': each dict is ONE step's batch; k are stacked on
            the host per call.
          - 'flat': each dict is ONE call's payload as flat [k*B] arrays,
            reshaped to [k, B].
          - 'stacked': each dict is already [k, B, ...].
          - 'auto': 'stacked' if every value has ndim >= 2 and leading dim
            k, else 'per_step' ('flat' cannot be told from a bigger
            per-step batch).
          'flat'/'stacked' payloads are copied to the device two calls
          ahead (pinned, non_blocking), so the copy of call i+1 overlaps
          the steps of call i; total_iter must be a multiple of k.
        scorer: optional CachedDotProductScorer for the interval evals.
        defer_metrics: keep the losses and eval metrics on the device for
          the whole run and copy them once at the end; interval console
          lines then show it/s only, the full records (and JSONL) follow
          the loop. Otherwise the loss of each call is copied to the host
          after the call.
        verbose: False silences console lines (JSONL logging unaffected).
        Returns the last eval results.
        """
        eval_samplers = eval_samplers or {}
        avg_loss = DeviceMean() if defer_metrics else Mean()
        deferred = []        # (step, it/s, device loss, device eval dict)
        last_results = {}
        t_start = time.time()
        log = self._log if verbose else (lambda *a, **k: None)
        device_sampler = (train_batches
                          if hasattr(train_batches, "sample")
                          and not hasattr(train_batches, "__iter__")
                          else None)
        it = iter(train_batches) if device_sampler is None else None
        if steps_per_call != 1 and train_iter_hook is not None:
            raise ValueError("train_iter_hook requires steps_per_call=1")
        if feed not in FEEDS:
            raise ValueError(f"feed must be one of {FEEDS}, not {feed!r}")
        fused_feed = None
        if device_sampler is None and steps_per_call > 1 \
                and feed != "per_step":
            it, fused_feed = self._make_fused_feed(it, steps_per_call, feed)
            if fused_feed is not None and total_iter % steps_per_call:
                raise ValueError("flat/stacked feeds need total_iter % "
                                 "steps_per_call == 0")

        log(_color(f"[openrec_tpu_torch] start training "
                   f"{type(self.model).__name__} for {total_iter} "
                   "iterations", "1;34"))
        i = 0
        while i < total_iter:
            chunk = min(steps_per_call, total_iter - i)
            i += chunk
            try:
                if device_sampler is not None:
                    loss = self.train_steps_device(device_sampler, chunk)
                elif fused_feed is not None:
                    loss = self._dispatch_multi(next(fused_feed), chunk)
                elif chunk > 1:
                    loss = self.train_step_multi(
                        [next(it) for _ in range(chunk)])
                elif train_iter_hook is not None:
                    loss = train_iter_hook(self, next(it))
                else:
                    loss, _ = self.train_step(next(it))
            except StopIteration:
                # a finite stream (e.g. a chronological epoch) ran out
                log(f"train stream exhausted at iter {self.global_step}")
                break
            avg_loss.update_state(
                loss if defer_metrics else
                (loss.cpu().numpy() if isinstance(loss, torch.Tensor)
                 else loss))

            if save_interval and self.save_model_dir \
                    and i % save_interval == 0:
                self.save()

            if eval_interval and i % eval_interval == 0:
                if defer_metrics:
                    self._sync()              # honest it/s boundary
                dt = time.time() - t_start
                its_per_s = eval_interval / dt if dt > 0 else float("inf")
                results = {}
                for name, sampler in eval_samplers.items():
                    results[name] = self.evaluate(
                        sampler, at=at, eval_fn=eval_fn, scorer=scorer,
                        eval_chunk=eval_chunk, defer_metrics=defer_metrics)
                last_results = results
                if defer_metrics:
                    deferred.append((self.global_step, its_per_s,
                                     avg_loss.result_device(), results))
                    log(f"Iter {self.global_step}  "
                        f"({its_per_s:.1f} it/s)  "
                        "[metrics on device, fetched at end]")
                    avg_loss = DeviceMean()
                    t_start = time.time()
                    continue
                msg = (f"Iter {self.global_step}  "
                       f"loss {avg_loss.result():.4f}  "
                       f"({its_per_s:.1f} it/s)")
                for name, res in results.items():
                    parts = [f"{key}={np.array2string(np.asarray(val), precision=4)}"
                             for key, val in res.items()]
                    msg += f"  [{name}] " + " ".join(parts)
                log(_color(msg, "32"))
                self._log_jsonl({"step": self.global_step,
                                 "loss": avg_loss.result(),
                                 "iters_per_s": its_per_s,
                                 "eval": results})
                avg_loss.reset_states()
                t_start = time.time()

        if hasattr(train_batches, "stop"):
            train_batches.stop()
        if deferred:
            # ONE copy to the host for the whole run, after the loop
            for step, its, lv, res in deferred:
                res = {name: {k: torch.as_tensor(v).cpu().numpy()
                              for k, v in d.items()}
                       for name, d in res.items()}
                lv = float(lv)
                msg = f"Iter {step}  loss {lv:.4f}  ({its:.1f} it/s)"
                for name, d in res.items():
                    parts = [f"{k}={np.array2string(v, precision=4)}"
                             for k, v in d.items()]
                    msg += f"  [{name}] " + " ".join(parts)
                log(_color(msg, "32"))
                self._log_jsonl({"step": step, "loss": lv,
                                 "iters_per_s": its, "eval": res})
                last_results = res
        return last_results

    # ------------------------------------------------------------------ #

    def profile(self, train_batches, steps: int = 20,
                trace_dir: Optional[str] = None):
        """Trace `steps` train steps with torch.profiler (CPU, and CUDA on
        the card) after one untraced warm-up step; writes a Chrome trace
        to `<trace_dir>/trace.json` (default: a directory under the
        system's temporary directory). Returns the trace path."""
        from torch.profiler import ProfilerActivity, profile
        if trace_dir is None:
            trace_dir = os.path.join(tempfile.gettempdir(),
                                     "openrec_tpu_torch_trace")
        it = iter(train_batches)
        self.train_step(next(it))
        self._sync()
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            for _ in range(steps):
                self.train_step(next(it))
            self._sync()
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, "trace.json")
        prof.export_chrome_trace(path)
        self._log(f"trace written to {path}")
        return path

    # ------------------------------------------------------------------ #

    def _state_tree(self):
        return {"params": {k: v.detach() for k, v in self.params.items()},
                "opt_state": self.opt_state}

    def save(self, step: Optional[int] = None):
        if not self.save_model_dir:
            raise ValueError("save_model_dir not set")
        return ckpt_lib.save(self.save_model_dir,
                             step if step is not None else self.global_step,
                             self._state_tree(),
                             max_to_keep=self.max_to_keep)

    def restore(self, path: Optional[str] = None, optimistic: bool = False):
        """Load params and optimizer state from `path` (default: the latest
        checkpoint in save_model_dir); the JAX package's files load too."""
        if path is None:
            path = ckpt_lib.latest_checkpoint(self.save_model_dir)
            if path is None:
                raise FileNotFoundError(
                    f"no checkpoint found in {self.save_model_dir!r}")
        tree = self._state_tree()
        flat = ckpt_lib.restore(path, flatten_tree(tree),
                                optimistic=optimistic)
        tree = unflatten_like(tree, flat)
        self.model.load_params(tree["params"])
        self.opt_state = tree["opt_state"]
        return path
