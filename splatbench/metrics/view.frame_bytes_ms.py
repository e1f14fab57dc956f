"""view.frame_bytes_ms: the harness's span around network_gui.frame_bytes
(readback and host quantise), mean ms a frame."""
from splatbench.harness import readers


def read(rec):
    return readers.span_ms(rec, "frame_bytes")
