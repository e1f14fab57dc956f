"""view.idle_share: the share of the traced viewer window in which no
device operation ran."""
from splatbench.harness import readers


def read(rec):
    return readers.idle_share(rec)
