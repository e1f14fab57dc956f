"""view.k1_roofline: the forward composite's least time at the counted work
over K1's device time per frame."""
from splatbench.harness import readers


def read(rec):
    return readers.roofline(rec, "k1", readers.K1)
