from repro_torch.kernels.qsgd_pack.ops import (  # noqa: F401
    qsgd_pack, qsgd_pack_grouped)
from repro_torch.kernels.qsgd_pack.ref import PackSegment  # noqa: F401
