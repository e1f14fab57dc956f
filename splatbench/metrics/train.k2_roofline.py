"""train.k2_roofline: the backward composite's least time at the counted
work over K2's device time per step."""
from splatbench.harness import readers


def read(rec):
    return readers.roofline(rec, "k2", readers.K2)
