from repro_torch.kernels.qsgd_unpack.ops import (  # noqa: F401
    qsgd_unpack, qsgd_unpack_grouped)
from repro_torch.kernels.qsgd_unpack.ref import UnpackSegment  # noqa: F401
