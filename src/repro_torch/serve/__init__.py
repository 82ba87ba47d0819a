"""Serving on torch: ``TMService`` (K >= 1), its batch router, the
``OnlineFleet`` shim and the Fig-3 adapt managers."""
from repro_torch.serve.router import BatchRouter  # noqa: F401
from repro_torch.serve.service import (  # noqa: F401
    AdaptPolicy,
    ServiceConfig,
    TickReport,
    TMService,
)
from repro_torch.serve.fleet import OnlineFleet  # noqa: F401
from repro_torch.serve.online_adapt import (  # noqa: F401
    TMFleetAdaptManager,
    TMOnlineAdaptConfig,
    TMOnlineAdaptManager,
)
