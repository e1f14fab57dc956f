"""train.mfu: the step's counted operations (splatbench/counts) over its
time in the traced window, as a share of the H100's 67 TFLOP/s fp32
peak."""
from splatbench.harness import readers


def read(rec):
    return readers.mfu(rec)
