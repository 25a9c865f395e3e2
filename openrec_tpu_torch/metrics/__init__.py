from openrec_tpu_torch.metrics.ranking import (
    AUC, MSE, NDCG, Precision, Recall, ids_to_masks, metrics_from_counts,
    ranking_metrics)
from openrec_tpu_torch.metrics.chunked import chunked_dot_eval_metrics
from openrec_tpu_torch.metrics.mean import (DeviceDictMean, DeviceMean,
                                            DictMean, Mean)
from openrec_tpu_torch.metrics import numpy_eval
from openrec_tpu_torch.metrics.numpy_eval import EvalManager
