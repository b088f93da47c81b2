from repro_torch.data.pipeline import (DataConfig,  # noqa: F401
                                      make_batch_iterator, synthetic_batch)
from repro_torch.data.sparse_datasets import make_url_like_dataset  # noqa: F401
