"""Walkthrough: EXTENDING the framework with your own model, the port of
examples/tutorial_extending.py (the reference's "build your own
recommender" tutorials and the `.extend()` mechanism of its macro DSL,
whose canonical use is BPR -> VBPR).

A model here is an `nn.Module` (`models.Recommender`) with a `loss` that
autograd differentiates (where the JAX script takes `jax.grad` of a pure
function) and a `score`; extension is ordinary subclassing:

  Part 1: add a feature pathway: BPR -> a mini visual BPR (a new
          parameter, the parent's tables and losses reused).
  Part 2: post_step hooks: norm censoring of the touched item rows
          after every optimizer step, in place.
  Part 3: grad_transform: rescale one parameter's gradients before the
          optimizer.

    python -m openrec_tpu_torch.examples.tutorial_extending
"""

import os

import numpy as np
import torch
from torch import nn

from openrec_tpu_torch import Dataset, Trainer, resolve_device
from openrec_tpu_torch.models import BPR
from openrec_tpu_torch.modules.embedding import censor_norm_
from openrec_tpu_torch.modules.losses import pairwise_log_loss

device = os.environ.get("OPENREC_EXAMPLE_DEVICE")     # None: CUDA
_SMALL = os.environ.get("OPENREC_EXAMPLE_SMALL") == "1"
total_users, total_items = (60, 300) if _SMALL else (300, 2000)
dim = 16
total_iter = int(os.environ.get("OPENREC_EXAMPLE_ITERS", 2000))
eval_interval = int(os.environ.get("OPENREC_EXAMPLE_EVAL_INTERVAL",
                                   total_iter // 2))

# planted low-rank interactions so AUC visibly rises
rng = np.random.default_rng(0)
U = rng.normal(size=(total_users, 8)).astype(np.float32)
V = rng.normal(size=(total_items, 8)).astype(np.float32)
top = np.argsort(-(U @ V.T), axis=1)[:, :20]
rows = [(u, i) for u in range(total_users) for i in top[u]]
data = np.array(rows, dtype=[("user_id", np.int32),
                             ("item_id", np.int32)])
rng.shuffle(data)
split = int(len(data) * 0.8)
train = Dataset(data[:split], total_users, total_items, seed=0)
test = Dataset(data[split:], total_users, total_items, seed=0)

# item "visual" features correlated with the planted structure
visual = (V + 0.3 * rng.normal(size=V.shape)).astype(np.float32)
gen = torch.Generator(device=resolve_device(device)).manual_seed(0)

# ------------------------------------------------------------- Part 1 #
# The reference's VBPR extends BPR by adding a visual subgraph and
# re-wiring the item port. Here: subclass, register the projection as a
# parameter, append the projected feature to the item vector. The
# Trainer, samplers, eval and checkpoints work unchanged: they only see
# params() / loss / score.


class MiniVisualBPR(BPR):
    def __init__(self, *args, dim_visual_embed=8, **kw):
        super().__init__(*args, **kw)
        dev = self.item_embed.device
        self.visual = torch.as_tensor(visual, device=dev)
        self.visual_proj = nn.Parameter(0.1 * torch.randn(
            (visual.shape[1], dim_visual_embed), generator=gen, device=dev))

    def _item_vecs(self, item_id):
        latent = self.lookup("item_embed", item_id)
        vis = self.visual[item_id.long()] @ self.visual_proj
        return torch.cat([latent, vis], dim=-1)

    def loss(self, batch, tables=None, generator=None):
        # the user dim matches the wider item vector
        user_vec = self.lookup("user_embed", batch["user_id"])
        p_vec = self._item_vecs(batch["p_item_id"])
        n_vec = self._item_vecs(batch["n_item_id"])
        p_b = self.lookup("item_bias", batch["p_item_id"])
        n_b = self.lookup("item_bias", batch["n_item_id"])
        task = pairwise_log_loss(user_vec, p_vec, n_vec, p_b, n_b)
        return task, {"loss": task}

    def score(self, batch):
        user_vec = self.lookup("user_embed", batch["user_id"])
        all_items = torch.cat([self.item_embed,
                               self.visual @ self.visual_proj], dim=-1)
        return user_vec @ all_items.T + self.item_bias.reshape(-1)


def run(title, model, lr):
    print(title)
    tr = Trainer(model, lr=lr, seed=0, device=device)
    tr.train(total_iter=total_iter,
             train_batches=train.pairwise(batch_size=256,
                                          num_parallel_calls=1),
             eval_samplers={"test": test.evaluation(
                 batch_size=128, excl_datasets=[train])},
             eval_interval=eval_interval, at=(10, 50))
    return tr


run("== Part 1: MiniVisualBPR (BPR + feature pathway by subclassing)",
    MiniVisualBPR(total_users, total_items, dim + 8, dim, l2_weight=0.0,
                  device=device, generator=gen), lr=0.02)

# ------------------------------------------------------------- Part 2 #
# post_step: a projection applied after every optimizer step, in place on
# the parameters (the reference runs its censor ops after each train
# call, ucml_citeulike.py:28-34).


class CensoredBPR(BPR):
    @torch.no_grad()
    def post_step(self, batch):
        ids = torch.cat([torch.as_tensor(batch["p_item_id"]),
                         torch.as_tensor(batch["n_item_id"])])
        censor_norm_(self.item_embed, ids)


tr2 = run("== Part 2: CensoredBPR (post_step norm projection)",
          CensoredBPR(total_users, total_items, dim, dim, l2_weight=0.0,
                      device=device, generator=gen), lr=0.05)
norms = torch.linalg.vector_norm(tr2.model.item_embed.detach(), dim=1)
print(f"   max item-embedding norm after censoring: {norms.max():.3f} "
      "(<= 1 + eps)")

# ------------------------------------------------------------- Part 3 #
# grad_transform: rescale one parameter's gradients before the optimizer
# (the legacy `_grad_post_processing` hook: VisualBPR divides its visual
# MLP's gradients by the batch size, visual_bpr.py:74-82).


class RescaledVisualBPR(MiniVisualBPR):
    def grad_transform(self, grads, batch):
        b = len(batch["p_item_id"])
        return dict(grads, visual_proj=grads["visual_proj"] / b)


run("== Part 3: grad_transform (visual grads scaled by 1/batch)",
    RescaledVisualBPR(total_users, total_items, dim + 8, dim,
                      l2_weight=0.0, device=device, generator=gen), lr=0.02)

print("done: three extensions, no framework change; the harness only "
      "ever sees params/loss/score/post_step/grad_transform.")
