"""Dataset-suite evaluation driver (PyTorch port of
``gsplat_tpu/scripts/full_eval.py``, mirror of reference full_eval.py:15-75).

Trains, renders and scores the Mip-NeRF-360 / Tanks&Temples /
DeepBlending suites at the reference's resolutions and iteration counts,
through ``gsplat_tpu_torch.scripts.{train,render,metrics}``, each in its
own process on the card.  The commands are the JAX driver's with the
package swapped.
"""
from __future__ import annotations

import os
import subprocess
import sys
from argparse import ArgumentParser

mipnerf360_outdoor_scenes = ["bicycle", "flowers", "garden", "stump",
                             "treehill"]
mipnerf360_indoor_scenes = ["room", "counter", "kitchen", "bonsai"]
tanks_and_temples_scenes = ["truck", "train"]
deep_blending_scenes = ["drjohnson", "playroom"]


def run(cmd):
    print("+", " ".join(cmd))
    subprocess.run(cmd, check=True)


def main(argv=None):
    parser = ArgumentParser(description="Full evaluation script parameters")
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--output_path", default="./eval")
    parser.add_argument("--mipnerf360", "-m360", type=str, default=None)
    parser.add_argument("--tanksandtemples", "-tat", type=str, default=None)
    parser.add_argument("--deepblending", "-db", type=str, default=None)
    parser.add_argument("--iterations", type=int, default=30_000)
    args = parser.parse_args(argv)

    scenes = []
    if args.mipnerf360:
        scenes += [(os.path.join(args.mipnerf360, s), "-i images_4")
                   for s in mipnerf360_outdoor_scenes]
        scenes += [(os.path.join(args.mipnerf360, s), "-i images_2")
                   for s in mipnerf360_indoor_scenes]
    if args.tanksandtemples:
        scenes += [(os.path.join(args.tanksandtemples, s), "")
                   for s in tanks_and_temples_scenes]
    if args.deepblending:
        scenes += [(os.path.join(args.deepblending, s), "")
                   for s in deep_blending_scenes]
    if not scenes:
        print("No dataset roots given; nothing to do "
              "(-m360/-tat/-db point at dataset folders).")
        return

    py = sys.executable
    all_outputs = []
    for source, extra in scenes:
        name = os.path.basename(source)
        out = os.path.join(args.output_path, name)
        all_outputs.append(out)
        if not args.skip_training:
            cmd = [py, "-m", "gsplat_tpu_torch.scripts.train", "-s", source,
                   "-m", out, "--eval", "--quiet",
                   "--test_iterations", "7000", str(args.iterations),
                   "--save_iterations", "7000", str(args.iterations),
                   "--iterations_override", str(args.iterations)]
            if extra:
                cmd += extra.split()
            run(cmd)
        if not args.skip_rendering:
            for it in (7000, args.iterations):
                run([py, "-m", "gsplat_tpu_torch.scripts.render", "-m", out,
                     "--iteration", str(it), "--skip_train", "--eval"])
    if not args.skip_metrics:
        run([py, "-m", "gsplat_tpu_torch.scripts.metrics", "-m"]
            + all_outputs)


if __name__ == "__main__":
    main()
