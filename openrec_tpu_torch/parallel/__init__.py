"""The distribution layer: a ('data', 'model') mesh of torch.distributed
ranks, row-sharded tables and their lookups and vocabulary-parallel
softmax, retrieval through K1 / K2 per shard, sharded eval, dense and
sparse steps over data and model ranks, and
per-rank checkpoints (the counterpart of `openrec_tpu.parallel`)."""

from openrec_tpu_torch.parallel.mesh import (
    DATA_AXIS, DEFAULT_RULES, MODEL_AXIS, Sharding, batch_sharding,
    initialize_multihost, make_mesh, match_partition_rules, replicated,
    row_sharding, shard_model, shard_params)
from openrec_tpu_torch.parallel.train import (
    data_slice, fold_in, full_params, make_parallel_device_sparse_train_step,
    make_parallel_device_train_step, make_parallel_eval_step,
    make_parallel_sparse_train_step, make_parallel_train_step,
    rank_generator, shared_generator, table_views)
from openrec_tpu_torch.parallel.embedding import (
    ShardedTable, merge_topk, pad_rows, sharded_lookup, sharded_pallas_topk,
    sharded_scores, sharded_softmax_ce, sharded_topk)
from openrec_tpu_torch.parallel.bucketed import (
    alltoall_lookup, bucket_batch, bucket_batch_2d, bucket_ids,
    default_capacity, gathered_lookup)
from openrec_tpu_torch.parallel.metrics import (
    sharded_dot_eval_metrics, sharded_eval_metrics)
from openrec_tpu_torch.parallel import checkpoint as sharded_checkpoint
