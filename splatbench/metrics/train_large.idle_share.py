"""train_large.idle_share: the share of the traced training window in which
no device operation ran; read as train.idle_share is, in the training cells
at published scale, which report train_step_ms.large."""
from splatbench.harness import readers


def read(rec):
    return readers.idle_share(rec)
