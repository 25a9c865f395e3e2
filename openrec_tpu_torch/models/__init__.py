from openrec_tpu_torch.models.base import FactorRecommender, Recommender
from openrec_tpu_torch.models.bpr import BPR
from openrec_tpu_torch.models.pmf import PMF
from openrec_tpu_torch.models.wrmf import WRMF
from openrec_tpu_torch.models.gmf import GMF
from openrec_tpu_torch.models.ucml import CML, UCML
from openrec_tpu_torch.models.dlrm import DLRM, criteo_dlrm
from openrec_tpu_torch.models.nbpr import NBPR, WCML
from openrec_tpu_torch.models.ncf import MLPRec, NeuMF
from openrec_tpu_torch.models.cdl import CDL
from openrec_tpu_torch.models.visual import (VBPR, ConcatVisualBPR,
                                             VisualBPR, VisualCML, VisualGMF,
                                             VisualPMF)
from openrec_tpu_torch.models.user_feature import UserPMF, UserVisualPMF
from openrec_tpu_torch.models.sequence import (RNNRec, VanillaYouTubeRec,
                                               YouTubeRec)
from openrec_tpu_torch.models.itr_mlp import ItrMLP
