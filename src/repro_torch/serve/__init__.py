"""Serving on torch: ``TMService`` (K >= 1), its batch router, the
``OnlineFleet`` shim, the Fig-3 adapt managers (TM and LM),
runtime-tunable serving and the traffic harness."""
from repro_torch.serve.router import BatchRouter  # noqa: F401
from repro_torch.serve.service import (  # noqa: F401
    AdaptPolicy,
    ServiceConfig,
    TickReport,
    TMService,
)
from repro_torch.serve.fleet import OnlineFleet  # noqa: F401
from repro_torch.serve.online_adapt import (  # noqa: F401
    OnlineAdaptConfig,
    OnlineAdaptManager,
    TMFleetAdaptManager,
    TMOnlineAdaptConfig,
    TMOnlineAdaptManager,
)
from repro_torch.serve.tunable import (  # noqa: F401
    ServeAux,
    TunableConfig,
    TuneController,
)
from repro_torch.serve.traffic import (  # noqa: F401
    SCENARIOS,
    ProducerScript,
    Scenario,
    TrafficResult,
    make_script,
    make_scripts,
    replay_single_caller,
    run_threaded,
)
