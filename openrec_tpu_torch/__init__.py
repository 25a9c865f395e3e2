"""openrec_tpu_torch: the PyTorch / CUDA (NVIDIA H100) port of openrec_tpu.

The JAX package `openrec_tpu` is the reference and this package stands
beside it, module for module under the same names: it imports `torch`,
never `jax` and nothing of `openrec_tpu`. Every entry point runs on CUDA
unless the caller passes `device="cpu"`; with no GPU and no explicit CPU
request it raises. The Pallas TPU kernels become hand-written CUDA
kernels for Hopper (`csrc/`), built with nvcc at first use; on a CPU
tensor each kernel wrapper runs its plain PyTorch version instead.

Ported so far, the serving path: BPR -> CachedDotProductScorer ->
bucket_score_topk -> the bucket-max kernels, with checkpoints, parameter
conversion from the JAX package and the eval metrics.
"""

__version__ = "0.1.0"

from openrec_tpu_torch.device import resolve_device
from openrec_tpu_torch.convert import params_from_jax, params_to_numpy
from openrec_tpu_torch.models import BPR, Recommender
from openrec_tpu_torch.ops import (
    bucket_max2_scores, bucket_max_scores, bucket_score_topk, topk_approx,
    topk_xla)
from openrec_tpu_torch.metrics import (
    AUC, NDCG, Precision, Recall, chunked_dot_eval_metrics,
    metrics_from_counts)
from openrec_tpu_torch.serving import CachedDotProductScorer
from openrec_tpu_torch.modules import (
    censor_max_norm, censor_norm, embedding_init, embedding_lookup, losses)
