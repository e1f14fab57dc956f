"""view.mfu: the frame's counted operations over the frame time in the
traced window, as a share of the 67 TFLOP/s fp32 peak."""
from splatbench.harness import readers


def read(rec):
    return readers.mfu(rec)
