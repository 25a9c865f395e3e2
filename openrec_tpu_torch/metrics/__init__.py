from openrec_tpu_torch.metrics.ranking import (
    AUC, NDCG, Precision, Recall, ids_to_masks, metrics_from_counts)
from openrec_tpu_torch.metrics.chunked import chunked_dot_eval_metrics
from openrec_tpu_torch.metrics.mean import (DeviceDictMean, DeviceMean,
                                            DictMean, Mean)
