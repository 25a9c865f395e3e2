from openrec_tpu_torch.data.store import InteractionStore
from openrec_tpu_torch.data.dataset import Dataset
from openrec_tpu_torch.data.pipeline import (
    Prefetcher, ShuffledArrayLoader, device_iterator, to_device)
from openrec_tpu_torch.data.device_sampler import (DevicePairwiseSampler,
                                                  DevicePointwiseSampler)
from openrec_tpu_torch.data.samplers import (
    BatchSampler, EndOfData, EvaluationSampler, NPairwiseSampler,
    PairwiseSampler, PerPosStratifiedPointwiseSampler,
    RandomPointwiseSampler, StratifiedPointwiseSampler)
from openrec_tpu_torch.data import loaders
