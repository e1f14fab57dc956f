"""train_large.mfu: the step's counted operations (splatbench/counts) over
its time in the traced window, as a share of the H100's 67 TFLOP/s fp32
peak; read as train.mfu is, in the training cells at published scale, which
report train_step_ms.large."""
from splatbench.harness import readers


def read(rec):
    return readers.mfu(rec)
