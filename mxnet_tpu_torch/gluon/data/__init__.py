"""Gluon data API (reference ``python/mxnet/gluon/data/``; SURVEY.md §3.2
"Gluon data" row): Dataset/ArrayDataset/RecordFileDataset, samplers,
batchify functions, DataLoader with its device ring, and ``vision``
(datasets + transforms).  Port of ``mxnet_tpu/gluon/data``."""
from .dataset import (Dataset, SimpleDataset, ArrayDataset,
                      RecordFileDataset)
from .sampler import (Sampler, SequentialSampler, RandomSampler,
                      BatchSampler, IntervalSampler, FilterSampler)
from .dataloader import (DataLoader, DevicePrefetchIter, default_batchify_fn,
                         default_mp_batchify_fn)
from . import vision
from . import dataset
from . import sampler
from . import dataloader
from . import batchify
