"""train_large.busy_ms: device busy ms per training step (the union of the
profiler's device operations); read as train.busy_ms is, in the training
cells at published scale, which report train_step_ms.large."""
from splatbench.harness import readers


def read(rec):
    return readers.busy_ms(rec)
