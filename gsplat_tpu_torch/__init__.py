"""gsplat_tpu_torch — the PyTorch + CUDA port of ``gsplat_tpu``.

A second package beside the JAX one, with the same module layout and names
so each function has an obvious counterpart.  Plain tensor code is PyTorch;
every Pallas TPU kernel on the ported path is a hand-written CUDA kernel for
Hopper (``sm_90a``) under ``csrc/``, built with ``nvcc`` at first use and
loaded with ``ctypes`` (``_kernels.py``).

This package imports neither ``jax`` nor anything of ``gsplat_tpu``.

Ported so far (the serving path, ``renderer.render``):

- ``core``   : cameras (numpy), quaternion/covariance math, SH evaluation
- ``data``   : PLY reading
- ``models`` : ``GaussianParams`` / ``GaussianModel`` (no optimizer yet)
- ``ops``    : preprocess, binning (expansion kernel K3), composite
               (forward kernel K1), rasterize, the O(P*H*W) oracle

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU, where every kernel wrapper uses its plain PyTorch version.
"""

__version__ = "0.1.0"

from gsplat_tpu_torch.core.cameras import Camera, MiniCam  # noqa: F401
