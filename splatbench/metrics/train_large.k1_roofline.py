"""train_large.k1_roofline: the forward composite's least time at the
counted work over K1's device time per step; read as train.k1_roofline is,
in the training cells at published scale, which report train_step_ms.large."""
from splatbench.harness import readers


def read(rec):
    return readers.roofline(rec, "k1", readers.K1)
