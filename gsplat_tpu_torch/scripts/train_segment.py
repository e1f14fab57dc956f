"""Segmentation training CLI (PyTorch port of
``gsplat_tpu/scripts/train_segment.py``, mirror of reference
train_segment.py).

The training loop of ``scripts/train.py`` with the per-gaussian segment
logits trained against ground-truth segment maps via alpha-composited
cross-entropy (train_segment.py:125-138); the reference's default test/save
iterations are shifted by +3000 (train_segment.py:370-371).

Usage: python -m gsplat_tpu_torch.scripts.train_segment -s <data> \
    --disable_gui_server ...
"""
from __future__ import annotations

import sys


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    if "--using_seg" not in argv:
        argv.append("--using_seg")
    # reference default iteration shift (train_segment.py:370-371)
    if "--test_iterations" not in argv:
        argv += ["--test_iterations", "10000", "33000"]
    if "--save_iterations" not in argv:
        argv += ["--save_iterations", "10000", "33000"]

    from gsplat_tpu_torch.scripts.train import main as train_main
    train_main(argv)


if __name__ == "__main__":
    main()
