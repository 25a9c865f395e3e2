from openrec_tpu_torch.models.base import FactorRecommender, Recommender
from openrec_tpu_torch.models.bpr import BPR
from openrec_tpu_torch.models.pmf import PMF
from openrec_tpu_torch.models.wrmf import WRMF
from openrec_tpu_torch.models.gmf import GMF
from openrec_tpu_torch.models.ucml import CML, UCML
from openrec_tpu_torch.models.dlrm import DLRM, criteo_dlrm
