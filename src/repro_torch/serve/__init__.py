"""Serving on torch: the K = 1 ``TMService`` and its batch router."""
from repro_torch.serve.router import BatchRouter  # noqa: F401
from repro_torch.serve.service import (  # noqa: F401
    AdaptPolicy,
    ServiceConfig,
    TickReport,
    TMService,
)
