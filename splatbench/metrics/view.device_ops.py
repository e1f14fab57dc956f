"""view.device_ops: device operations per frame in the traced window."""
from splatbench.harness import readers


def read(rec):
    return readers.device_ops(rec)
