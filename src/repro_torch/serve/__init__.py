"""Serving (DESIGN.md §8): the static-batch engine, the continuous-
batching scheduler and the slot decode engine, for the dense and MoE
families."""
from repro_torch.serve.engine import (  # noqa: F401
    ServeEngine,
    build_prefill,
    build_serve_step,
)
from repro_torch.serve.scheduler import (  # noqa: F401
    ContinuousScheduler,
    Request,
    ServeConfig,
    poisson_trace,
    truncate_at_eos,
)
from repro_torch.serve.sparse_decode import (  # noqa: F401
    ContinuousServeEngine,
    ServeResult,
    build_slot_decode_step,
    insert_slot_state,
)
