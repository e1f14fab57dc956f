"""gsplat_tpu_torch — the PyTorch + CUDA port of ``gsplat_tpu``.

A second package beside the JAX one, with the same module layout and names
so each function has an obvious counterpart.  Plain tensor code is PyTorch;
every Pallas TPU kernel on the ported path is a hand-written CUDA kernel for
Hopper (``sm_90a``) under ``csrc/``, built with ``nvcc`` at first use and
loaded with ``ctypes`` (``_kernels.py``).

This package imports neither ``jax`` nor anything of ``gsplat_tpu``.

Ported so far (the serving path, ``renderer.render``; the training step,
``train.trainer.make_train_step``; the training command line,
``scripts/train.py`` over ``train.trainer.Trainer``, with the appearance
embedding and the live-viewer socket; and the render and evaluation
command lines):

- ``core``    : cameras (numpy), quaternion/covariance math, SH evaluation
- ``data``    : PLY reading and writing, COLMAP parsers, the COLMAP /
                Blender / NeRFstudio readers, ``Scene`` and camera loading
- ``models``  : ``GaussianParams`` / ``GaussianAux`` / ``GaussianModel``
                (PLY export, checkpoints), per-group Adam, densification,
                the appearance embedding, the camera pose optimizer
- ``ops``     : preprocess, binning (expansion kernel K3 and its extras
                form K3x for exact culling), composite (forward kernel K1,
                backward kernel K2), the segment sum (kernel K4) behind the
                gather's adjoint, differentiable rasterize, KNN scale init,
                the O(P*H*W) oracle
- ``train``   : losses, learning-rate schedules, the train step and its
                appearance form, ``Trainer``
- ``config``  : the argparse parameter groups
- ``scripts`` : ``train``, ``train_segment``, ``render``, ``metrics``,
                ``full_eval``
- ``viz``     : camera paths (``camera_trajectory``), videos, LPIPS, the
                SIBR viewer socket (``network_gui``)
- ``utils``   : ``safe_state``, ``mkdir_p``, ``searchForMaxIteration``
- ``tools``   : the kernel probes (P1 to P4: K1 and K2 under knockouts,
                K1's loads against its math, an in-kernel gather, f32
                against bf16x2), ``python -m gsplat_tpu_torch.tools.bench_*``

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU, where every kernel wrapper uses its plain PyTorch version.
"""

__version__ = "0.1.0"

from gsplat_tpu_torch.core.cameras import Camera, MiniCam  # noqa: F401
