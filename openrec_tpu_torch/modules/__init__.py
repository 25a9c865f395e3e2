from openrec_tpu_torch.modules.embedding import (
    censor_max_norm, censor_norm, embedding_init, embedding_lookup)
from openrec_tpu_torch.modules.interactions import second_order_interaction
from openrec_tpu_torch.modules.mlp import MLP
from openrec_tpu_torch.modules import losses
from openrec_tpu_torch.modules.sdae import SDAE
