from openrec_tpu_torch.modules.embedding import (
    censor_max_norm, censor_norm, embedding_init, embedding_lookup)
from openrec_tpu_torch.modules import losses
