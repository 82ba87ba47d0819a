"""The TM core on torch: datapath, learning, accuracy and the online drain.

  TMConfig / TMState / TMRuntime       -- design-time / learnt / runtime state
  init_state / init_runtime            -- constructors (default: the card)
  forward / forward_batch / predict / predict_batch -- inference datapath
  train_step / train_update / train_datapoints / train_epochs -- learning
  faults, accuracy, manager, online, hpsearch   -- management subsystems
"""
from repro_torch.core.tm import (  # noqa: F401
    TMConfig,
    TMRuntime,
    TMState,
    forward,
    forward_batch,
    init_runtime,
    init_state,
    predict,
    predict_batch,
)
from repro_torch.core.feedback import (  # noqa: F401
    StepAux,
    train_datapoints,
    train_epochs,
    train_step,
    train_update,
)
