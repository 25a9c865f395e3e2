from openrec_tpu_torch.models.base import Recommender
from openrec_tpu_torch.models.bpr import BPR
