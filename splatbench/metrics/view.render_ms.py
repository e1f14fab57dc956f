"""view.render_ms: the harness's span around renderer.render, closed by
torch.cuda.synchronize, mean ms a frame."""
from splatbench.harness import readers


def read(rec):
    return readers.span_ms(rec, "render")
