"""Config system: reflection-based parameter groups -> argparse (PyTorch
port of ``gsplat_tpu/config.py``).

Behavioral spec: reference arguments/__init__.py:19-141 (ParamGroup, leading
'_' = shorthand flag, ModelParams/PipelineParams/OptimizationParams defaults,
get_combined_args cfg_args merge).  The same flags and defaults as the JAX
package, with one stated difference: ``ModelParams.data_device`` defaults
to ``"cuda"`` (the JAX package's ``"tpu"``); ``"cpu"`` runs every kernel's
plain version on the CPU.
"""
from __future__ import annotations

import os
import sys
from argparse import ArgumentParser, Namespace


class ParamGroup:
    """Declarative flag groups: a subclass's __init__ assigns instance
    attributes (its config schema + defaults) and then calls super().__init__,
    which registers one ``--<attr>`` argument per attribute.  An attribute
    named with a leading underscore also gets the one-letter ``-<a>``
    shorthand (CLI contract of the reference's arguments/__init__.py group
    classes).  Bools are store_true flags; everything else is typed from its
    default.  ``fill_none`` registers every default as None so ``extract``
    can distinguish "given on this CLI" from "absent" when merging with a
    saved cfg_args."""

    def __init__(self, parser: ArgumentParser, name: str, fill_none=False):
        group = parser.add_argument_group(name)
        for attr, default in vars(self).items():
            flag = attr[1:] if attr.startswith("_") else attr
            names = [f"--{flag}"] + ([f"-{flag[0]}"] if attr != flag else [])
            spec = {"default": None if fill_none else default}
            if isinstance(default, bool):
                spec["action"] = "store_true"
            else:
                spec["type"] = type(default)
            group.add_argument(*names, **spec)

    def extract(self, args) -> Namespace:
        group = Namespace()
        for var in vars(args).items():
            if var[0] in vars(self) or ("_" + var[0]) in vars(self):
                setattr(group, var[0], var[1])
        return group


class ModelParams(ParamGroup):
    """arguments/__init__.py:61-81."""

    def __init__(self, parser, sentinel=False):
        self.sh_degree = 3
        self.num_class = 29
        self._source_path = ""
        self._model_path = ""
        self._images = "images"
        self._resolution = -1
        self._white_background = False
        self.data_device = "cuda"
        self.eval = False
        self.using_depth = False
        self.using_seg = False
        self.able_appearance_embedding = False
        super().__init__(parser, "Loading Parameters", sentinel)

    def extract(self, args):
        g = super().extract(args)
        g.source_path = os.path.abspath(g.source_path)
        return g


class PipelineParams(ParamGroup):
    """arguments/__init__.py:83-88."""

    def __init__(self, parser):
        self.convert_SHs_python = False
        self.compute_cov3D_python = False
        self.debug = False
        super().__init__(parser, "Pipeline Parameters")


class OptimizationParams(ParamGroup):
    """arguments/__init__.py:90-113 — identical schedule constants.  Without
    a parser it is a plain record of the defaults."""

    def __init__(self, parser=None):
        self.iterations = 30_000
        self.position_lr_init = 0.00008
        self.position_lr_final = 0.0000016
        self.position_lr_delay_mult = 0.01
        self.position_lr_max_steps = 30_000
        self.feature_lr = 0.0025
        self.opacity_lr = 0.05
        self.segment_lr = 0.05
        self.scaling_lr = 0.002
        self.rotation_lr = 0.001
        self.percent_dense = 0.01
        self.lambda_dssim = 0.2
        self.lambda_depth = 0.1
        self.lambda_segment = 0.01
        self.lambda_rank_depth = 0.2
        self.lambda_continue_depth = 0.02
        self.densification_interval = 100
        self.opacity_reset_interval = 3000
        self.densify_from_iter = 500
        self.densify_until_iter = 15_000
        self.densify_grad_threshold = 0.0002
        if parser is not None:
            super().__init__(parser, "Optimization Parameters")


class PerformanceParams(ParamGroup):
    """Sizing/backend knobs of the JAX package (no reference analogue).
    ``backend``: ``auto`` or ``pallas`` (kernels K1/K2), ``jnp`` or
    ``reference`` (the plain-torch tiled compositor)."""

    def __init__(self, parser):
        self.capacity = 0            # gaussian capacity (0 = auto from init size)
        self.max_instances = 0       # tile-instance capacity (0 = auto)
        self.backend = "auto"        # auto | pallas | jnp | reference
        self.data_parallel = 1       # cameras per step = ranks (-1: all)
        self.tile_parallel = 1       # tile-row slices per camera; with
                                     # data_parallel an (M, N) mesh
        self.profile_dir = ""        # torch.profiler trace output dir
        self.grad_precision = "bf16"  # bf16 | f32 per-instance grad rows
        self.feat_precision = "bf16"  # bf16 | f32 attr-table feature cols
        self.cull = "none"           # none | exact ellipse-tile culling
        self.vs_prune = False        # ablation: restore the screen-radius
                                     # prune (the reference's is inert —
                                     # models/densify.py::densify_and_prune)
        self.low_memory = False      # lazy GT decode (bounded host RAM)
        self.gt_cache = 0            # LRU cap on cached GT device batches
                                     # (0 = auto ~2 GB)
        super().__init__(parser, "Performance Parameters")


def get_combined_args(parser: ArgumentParser, argv=None):
    """Merge saved cfg_args with CLI (arguments/__init__.py:115-141);
    ``argv`` defaults to ``sys.argv[1:]``."""
    cmdline = sys.argv[1:] if argv is None else list(argv)
    cfgfile_string = "Namespace()"
    args_cmdline = parser.parse_args(cmdline)
    try:
        cfgfilepath = os.path.join(args_cmdline.model_path, "cfg_args")
        print("Looking for config file in", cfgfilepath)
        with open(cfgfilepath) as cfg_file:
            print(f"Config file found: {cfgfilepath}")
            cfgfile_string = cfg_file.read()
    except (TypeError, FileNotFoundError):
        print("Config file not found")
    args_cfgfile = eval(cfgfile_string)  # noqa: S307 (reference format)
    merged = vars(args_cfgfile).copy()
    for k, v in vars(args_cmdline).items():
        if v is not None or k not in merged:
            # None-defaulted flags absent from the saved cfg still need to
            # exist on the namespace (reference special-cases sub_scene /
            # render_file the same way, arguments/__init__.py:134-139)
            merged.setdefault(k, v)
            if v is not None:
                merged[k] = v
    return Namespace(**merged)
