"""train_large.k2_roofline: the backward composite's least time at the
counted work over K2's device time per step; read as train.k2_roofline is,
in the training cells at published scale, which report train_step_ms.large."""
from splatbench.harness import readers


def read(rec):
    return readers.roofline(rec, "k2", readers.K2)
