"""COLMAP pipeline driver (PyTorch port's copy of
``gsplat_tpu/scripts/convert.py``, mirror of reference convert.py:31-124).

    python -m gsplat_tpu_torch.scripts.convert -s <scene> [--resize]
        [--colmap_executable <path>] [--no_gpu] [--skip_matching]

Runs feature_extractor -> matcher -> mapper -> image_undistorter on a raw
``input/`` image folder (the same ``os.system`` command lines as the JAX
CLI; it exits 1 when ``colmap`` is not found), moves ``sparse/*`` into
``sparse/0``, then with ``--resize`` builds the images_2/4/8 downscale
pyramid (via PIL instead of ImageMagick).  Host work only: no device.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
from argparse import ArgumentParser


def run(cmd: str):
    print("+", cmd)
    code = os.system(cmd)
    if code != 0:
        print(f"command failed with code {code}. Exiting.")
        sys.exit(code)


def main(argv=None):
    parser = ArgumentParser("Colmap converter")
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--source_path", "-s", required=True, type=str)
    parser.add_argument("--camera", default="OPENCV", type=str)
    parser.add_argument("--colmap_executable", default="", type=str)
    parser.add_argument("--resize", action="store_true")
    parser.add_argument("--magick_executable", default="", type=str)
    args = parser.parse_args(argv)

    colmap = (f'"{args.colmap_executable}"' if args.colmap_executable
              else "colmap")
    if shutil.which(colmap.strip('"')) is None:
        print("colmap not found on PATH — install COLMAP or pass "
              "--colmap_executable. (This step runs on the host, not TPU.)")
        sys.exit(1)
    use_gpu = 0 if args.no_gpu else 1
    src = args.source_path

    if not args.skip_matching:
        os.makedirs(os.path.join(src, "distorted", "sparse"), exist_ok=True)
        run(f"{colmap} feature_extractor "
            f"--database_path {src}/distorted/database.db "
            f"--image_path {src}/input "
            f"--ImageReader.single_camera 1 "
            f"--ImageReader.camera_model {args.camera} "
            f"--SiftExtraction.use_gpu {use_gpu}")
        run(f"{colmap} exhaustive_matcher "
            f"--database_path {src}/distorted/database.db "
            f"--SiftMatching.use_gpu {use_gpu}")
        run(f"{colmap} mapper "
            f"--database_path {src}/distorted/database.db "
            f"--image_path {src}/input "
            f"--output_path {src}/distorted/sparse "
            f"--Mapper.ba_global_function_tolerance=0.000001")

    run(f"{colmap} image_undistorter "
        f"--image_path {src}/input "
        f"--input_path {src}/distorted/sparse/0 "
        f"--output_path {src} --output_type COLMAP")

    # move sparse files into sparse/0 (convert.py:76-86)
    files = os.listdir(os.path.join(src, "sparse"))
    os.makedirs(os.path.join(src, "sparse", "0"), exist_ok=True)
    for f in files:
        if f == "0":
            continue
        shutil.move(os.path.join(src, "sparse", f),
                    os.path.join(src, "sparse", "0", f))

    if args.resize:
        from PIL import Image

        print("Copying and resizing...")
        for scale, name in ((2, "images_2"), (4, "images_4"), (8, "images_8")):
            os.makedirs(os.path.join(src, name), exist_ok=True)
            for f in os.listdir(os.path.join(src, "images")):
                img = Image.open(os.path.join(src, "images", f))
                img.resize((img.width // scale, img.height // scale)).save(
                    os.path.join(src, name, f))
    print("Done.")


if __name__ == "__main__":
    main()
