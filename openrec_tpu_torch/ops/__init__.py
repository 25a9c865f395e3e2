from openrec_tpu_torch.ops.topk import (
    fused_score_topk, fused_topk_plain, topk_approx, topk_xla)
from openrec_tpu_torch.ops.bucketed_topk import (
    bucket_max2_scores, bucket_max_scores, bucket_score_topk)
from openrec_tpu_torch.ops.ordered_topk import topk_ordered
