from openrec_tpu_torch.modules.embedding import (
    censor_max_norm, censor_norm, embedding_init, embedding_lookup)
from openrec_tpu_torch.modules.fusions import average_fusion, concat_fusion
from openrec_tpu_torch.modules.interactions import (masked_mean_pool,
                                                    second_order_interaction)
from openrec_tpu_torch.modules.mlp import MLP, activate, glorot_uniform
from openrec_tpu_torch.modules.rnn import GRU, LSTM
from openrec_tpu_torch.modules import losses
from openrec_tpu_torch.modules.sdae import SDAE
