"""train.busy_ms: device busy ms per training step (the union of the
profiler's device operations)."""
from splatbench.harness import readers


def read(rec):
    return readers.busy_ms(rec)
