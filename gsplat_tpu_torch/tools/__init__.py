"""Kernel probes of the port: the measurement tools of ``tools/`` on the card.

PyTorch + CUDA port of the JAX package's TPU measurement scripts
(``tools/bench_fwd_attrib.py``, ``bench_bwd_attrib.py``,
``bench_kernels.py``, ``bench_dma_overhead.py``,
``bench_inkernel_gather.py``, ``bench_vpu_dtype.py``).  They ask where the
composite kernels K1 and K2 spend their time, by timing variants with one
piece knocked out, the loads apart from the math, an in-kernel gather and
the 16-bit elementwise rate.  Each Pallas kernel of those scripts is a
hand-written CUDA kernel here (``csrc/probe_fwd.cu`` P1,
``probe_bwd.cu`` P2, ``probe_load.cu`` P3, ``probe_dtype.cu`` P4), each a
template over its variants with a plain PyTorch version of every variant
(``probes.py``); P1's and P2's variants are those of K1's and K2's own
kernel templates.

- ``timing``    : CUDA-event timing and the card's name and power limit
- ``workload``  : K1's and K2's real inputs at the 1080p asset, the
                  synthetic workload of ``bench_dma_overhead.make_workload``,
                  the (pixel, instance) pair counts and the bounds
- ``probes``    : the wrappers, launch counted, and the plain versions
- ``bench_*``   : one entry module per JAX tool, ``python -m
                  gsplat_tpu_torch.tools.<name>`` on the card
- ``serve_asset_viewer``: not a probe; the HTTP viewer on a bare PLY or
                  NPZ asset (the JAX package's ``tools/serve_asset_viewer.py``)

The entry modules measure, so they run on the card only; the wrappers, like
every kernel wrapper of the port, take their plain versions for CPU tensors.
"""
