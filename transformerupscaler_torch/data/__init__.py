"""Training data (JAX counterpart: transformerupscaler_tpu/data/): the PNG
and streaming datasets and the geometry bucketing of a batch."""

from transformerupscaler_torch.data.bucketing import (  # noqa: F401
    batched,
    bucket_batch,
    prefetched,
)
from transformerupscaler_torch.data.datasets import (  # noqa: F401
    HighresImageDataset,
    OnlineHighresDataset,
)
