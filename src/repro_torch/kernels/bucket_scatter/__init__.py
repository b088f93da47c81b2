from repro_torch.kernels.bucket_scatter.ops import (  # noqa: F401
    bucket_scatter, bucket_scatter_sum, bucket_scatter_sum_grouped)
from repro_torch.kernels.bucket_scatter.ref import ScatterSumSegment  # noqa: F401
