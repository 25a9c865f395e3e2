from openrec_tpu_torch.training.optim import (
    GradientTransformation, LazyAdamState, apply_updates, keras_adam,
    lazy_adagrad, lazy_adam)
from openrec_tpu_torch.training.trainer import Trainer
