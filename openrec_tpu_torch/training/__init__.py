from openrec_tpu_torch.training.optim import (
    EmptyState, GradientTransformation, LazyAdamState, ScaleByAdamState,
    adam, apply_updates, keras_adam, lazy_adagrad, lazy_adam)
from openrec_tpu_torch.training.trainer import Trainer
from openrec_tpu_torch.training.parallel_trainer import ParallelTrainer
