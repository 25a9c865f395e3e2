"""openrec_tpu_torch: the PyTorch / CUDA (NVIDIA H100) port of openrec_tpu.

The JAX package `openrec_tpu` is the reference and this package stands
beside it, module for module under the same names: it imports `torch`,
never `jax` and nothing of `openrec_tpu`. Every entry point runs on CUDA
unless the caller passes `device="cpu"`; with no GPU and no explicit CPU
request it raises. The Pallas TPU kernels become hand-written CUDA
kernels for Hopper (`csrc/`), built with nvcc at first use; on a CPU
tensor each kernel wrapper runs its plain PyTorch version instead.

Ported so far, the BPR-CiteULike main path end to end:
  - data: InteractionStore, PairwiseSampler (numpy path and the C++
    feeder, `native/`, built with g++ at first use), EvaluationSampler,
    Dataset, Prefetcher, pinned non_blocking `to_device`, the CiteULike
    loaders, and the on-device DevicePairwiseSampler (bitmap /
    searchsorted membership);
  - training: BPR, lazy_adam / keras_adam / lazy_adagrad, Trainer (the
    K-step loops, on-device sampling, train / evaluate, checkpoints in
    the JAX format, warm start, torch.profiler);
  - metrics: ranking, chunked eval, the streaming means;
  - serving: CachedDotProductScorer -> bucket_score_topk -> the
    bucket-max kernels K1/K2, and the exact fused score + top-k kernel K3
    (`ops.fused_score_topk`);
  - parameter and optimizer-state conversion from the JAX package.

And the DLRM-Criteo flagship: MLP, the dot interaction, BCE / MSE,
DLRM (separate or fused tables, bf16 compute), the Criteo loaders,
optax-form `adam`, and the O(batch) sparse Adam step with flat dedup
(`training.sparse`), also behind `Trainer(sparse_tables=...)`.

And the rest of the tf2 zoo with PMF: PMF, WRMF, GMF and UCML (= CML,
with its unit-ball censoring as `post_step`), their losses
(`pairwise_eudist_hinge_loss`, `pointwise_mse_loss`, `bce_logits_loss`),
the pointwise samplers (`StratifiedPointwiseSampler` with its C++ branch,
`PerPosStratifiedPointwiseSampler`, `RandomPointwiseSampler`, the
`Dataset` methods) and the on-device `DevicePointwiseSampler`. Their
tables serve through the same scorer and kernels as BPR's
(`examples/`: the ported example scripts).

And the multi-negative and content models: NBPR and WCML (with
`NPairwiseSampler`, `Dataset.n_pairwise` and the multi-negative losses),
MLPRec and NeuMF (the NCF family, dropout drawn from the Trainer's
generator), CDL with its `SDAE`, and the numpy evaluators
(`metrics.numpy_eval`, `EvalManager`).

And the visual family and the user-feature PMFs: VBPR, VisualBPR,
VisualCML, VisualPMF, VisualGMF, ConcatVisualBPR, UserPMF and
UserVisualPMF, with `FeatureJoinedSampler` (`Dataset.pairwise(joins=)`),
the fusions and the Tradesy / Amazon-book loaders.

And the sequence models: RNNRec (GRU or LSTM, `modules/rnn.py`; full or
sampled softmax), VanillaYouTubeRec and YouTubeRec, with
`masked_mean_pool`, the softmax losses, `TemporalSampler`,
`TemporalEvaluationSampler`, `Dataset.temporal` /
`temporal_evaluation`, the on-device `DeviceTemporalSampler`,
`Trainer.evaluate_temporal` and the LastFM loader.

And ItrMLP with its explicit-rating path: frozen tables that
`update_embeddings` rewrites on a schedule (`Trainer.train(
update_interval=)`), `ExplicitSampler` (`Dataset.explicit`),
`RegressionEvalSampler` (`Dataset.regression_evaluation`) and the
per-record MSE eval.

And the last modules: the sparse step's `'columns'`, `'mixed'` and
`'hash'` dedup modes, and the distribution layer on torch.distributed
(`parallel`: one process per rank, a ('data', 'model') DeviceMesh over
NCCL or gloo, row-sharded lookups, K1/K2 retrieval per shard, sharded
eval, data-parallel dense and sparse steps, per-rank checkpoints in the
JAX package's format, `ParallelTrainer`, the multi-rank dry run). Every
module of the JAX package now has its counterpart here.

Beside them, the port's own tracing (`trace.py`): spans in the scorer,
the training step and the feed, which are `torch.profiler` annotations
while a profiler records, and counters of kernel launches, host waits
and unique rows a step.
"""

__version__ = "0.1.0"

from openrec_tpu_torch.device import resolve_device
from openrec_tpu_torch.convert import (
    opt_state_from_jax, opt_state_to_numpy, params_from_jax, params_to_numpy,
    sparse_opt_state_from_jax, sparse_opt_state_to_numpy)
from openrec_tpu_torch.models import (
    BPR, CDL, CML, DLRM, GMF, NBPR, PMF, UCML, VBPR, WCML, WRMF,
    ConcatVisualBPR, FactorRecommender, ItrMLP, MLPRec, NeuMF, Recommender,
    RNNRec, UserPMF, UserVisualPMF, VanillaYouTubeRec, VisualBPR, VisualCML,
    VisualGMF, VisualPMF, YouTubeRec, criteo_dlrm)
from openrec_tpu_torch.ops import (
    bucket_max2_scores, bucket_max_scores, bucket_score_topk,
    fused_score_topk, topk_approx, topk_xla)
from openrec_tpu_torch.metrics import (
    AUC, MSE, NDCG, DeviceDictMean, DeviceMean, DictMean, EvalManager, Mean,
    Precision, Recall, chunked_dot_eval_metrics, metrics_from_counts,
    numpy_eval)
from openrec_tpu_torch.serving import CachedDotProductScorer
from openrec_tpu_torch.modules import (
    GRU, LSTM, MLP, SDAE, average_fusion, censor_max_norm, censor_norm,
    concat_fusion, embedding_init, embedding_lookup, losses,
    masked_mean_pool, second_order_interaction)
from openrec_tpu_torch.data import (
    Dataset, DevicePairwiseSampler, DevicePointwiseSampler,
    DeviceTemporalSampler, EvaluationSampler, ExplicitSampler,
    FeatureJoinedSampler, InteractionStore, NPairwiseSampler,
    PairwiseSampler, PerPosStratifiedPointwiseSampler,
    RandomPointwiseSampler, RegressionEvalSampler,
    StratifiedPointwiseSampler, TemporalEvaluationSampler, TemporalSampler)
from openrec_tpu_torch.training import (ParallelTrainer, Trainer, adam,
                                        keras_adam, lazy_adagrad, lazy_adam)
from openrec_tpu_torch.training.sparse import (
    dlrm_fused_table_spec, dlrm_table_specs, make_sparse_device_loop,
    make_sparse_train_step)
from openrec_tpu_torch import parallel
