"""Training: the optimizers, the train step, the fault-tolerant loop and
durable state (the reference's checkpoint layout)."""
