"""Scene editing operations, headless (PyTorch port of
``gsplat_tpu/viz/editor.py``).

Behavioral spec: reference visualizer.py's editing features: bbox crop with
a rotated basis (:718-792), sub-scene merge (:196-226), copy (:228-257),
remove (:269-325), per-sub-scene translate/scale (:384-396), per-class
segment filtering (:79-83, :871-874) and save-clip (:411-415).  The
visualize CLI (``scripts/visualize.py``) and the HTTP viewer
(``viz/render_app.py``) drive them.

Selections are numpy masks over the model's slots and the sub-scene
``instance`` ids a numpy array, as in the JAX package.  The edits are index
operations on the model's tensors, on the model's device, in place; the
arithmetic of ``transform_instance`` takes the dtypes the JAX module's
numpy arithmetic takes, so both packages write the same floats.
"""
from __future__ import annotations

import numpy as np
import torch

from gsplat_tpu_torch.models.gaussians import (DEAD_OPACITY_LOGIT, DEAD_XYZ,
                                               GaussianModel)
from gsplat_tpu_torch.viz.camera_trajectory import bbox_basis, bbox_mask


class SceneEditor:
    """Tracks sub-scene instance membership like the visualizer's
    instance_parm bookkeeping (visualizer.py:196-226)."""

    def __init__(self, model: GaussianModel):
        self.model = model
        # instance id per gaussian slot (0 = base scene)
        self.instance = np.zeros(model.capacity, np.int32)
        self._next_instance = 1

    def _index(self, idx: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(idx, np.int64),
                               device=self.model.device)

    # --- selection ----------------------------------------------------------
    def alive_mask(self) -> np.ndarray:
        return self.model.aux.alive.cpu().numpy()

    def bbox_select(self, center, rotation_deg=(0, 0, 0),
                    extents=(1, 1, 1)) -> np.ndarray:
        """Rotated-box containment mask (bbox_clip, visualizer.py:718-792)."""
        basis = bbox_basis(*rotation_deg)
        pts = self.model.params.xyz.cpu().numpy()
        m = bbox_mask(pts, np.asarray(center, np.float64),
                      basis, np.asarray(extents, np.float64))
        return m & self.alive_mask()

    def segment_select(self, class_id: int) -> np.ndarray:
        """Mask of gaussians whose argmax segment class is class_id
        (visualizer.py:79-83)."""
        cls = self.model.get_segment.argmax(1).cpu().numpy()
        return (cls == class_id) & self.alive_mask()

    # --- edits --------------------------------------------------------------
    def _free_slots(self, n: int) -> np.ndarray:
        free = np.nonzero(~self.alive_mask())[0]
        if len(free) < n:
            # merge/copy concatenate in the reference (visualizer.py:196-226):
            # grow to the next power of two, the Adam moments kept
            need = self.model.capacity - len(free) + n
            new_cap = 1 << int(np.ceil(np.log2(need)))
            self.model.grow_capacity(new_cap)
            inst = np.zeros(new_cap, np.int32)
            inst[: len(self.instance)] = self.instance
            self.instance = inst
            free = np.nonzero(~self.alive_mask())[0]
        return free[:n]

    def _claim(self, dst: np.ndarray) -> int:
        """Mark ``dst`` alive as a new sub-scene instance; returns its id."""
        self.model.aux.alive[self._index(dst)] = True
        iid = self._next_instance
        self._next_instance += 1
        self.instance[dst] = iid
        return iid

    def copy(self, mask: np.ndarray, translate=(0, 0, 0)) -> int:
        """Duplicate selected gaussians as a new sub-scene instance
        (visualizer.py:228-257). Returns the new instance id."""
        src = np.nonzero(mask)[0]
        dst = self._free_slots(len(src))
        s, d = self._index(src), self._index(dst)
        p = self.model.params
        for t in p:
            t[d] = t[s]
        p.xyz[d] += torch.as_tensor(translate, dtype=torch.float32,
                                    device=p.xyz.device)
        return self._claim(dst)

    def remove(self, mask: np.ndarray) -> int:
        """Delete selected gaussians (visualizer.py:269-325)."""
        idx = np.nonzero(mask)[0]
        i = self._index(idx)
        p = self.model.params
        self.model.aux.alive[i] = False
        p.xyz[i] = DEAD_XYZ
        p.opacity[i] = DEAD_OPACITY_LOGIT
        return len(idx)

    def transform_instance(self, instance_id: int, translate=(0, 0, 0),
                           scale: float = 1.0):
        """Per-sub-scene translate/scale (visualizer.py:384-396)."""
        sel = (self.instance == instance_id) & self.alive_mask()
        i = self._index(np.nonzero(sel)[0])
        p = self.model.params
        # the JAX module's numpy dtypes: the scale in float32, the offset
        # added in its array's dtype (float64 for a tuple of floats) and
        # log(scale) in float64, each result rounded back to float32
        off = np.asarray(translate)
        moved = p.xyz[i] * scale
        if off.dtype != np.float32:
            moved = moved.to(torch.float64)
        p.xyz[i] = (moved + torch.as_tensor(off, dtype=moved.dtype,
                                            device=moved.device)).to(
            torch.float32)
        p.scaling[i] = (p.scaling[i].to(torch.float64)
                        + float(np.log(scale))).to(torch.float32)

    def merge_ply(self, path: str, translate=(0, 0, 0),
                  scale: float = 1.0) -> int:
        """Load another PLY and merge it as a new sub-scene instance
        (_merge_scenes, visualizer.py:196-226)."""
        other = GaussianModel(self.model.max_sh_degree,
                              num_class=self.model.num_class,
                              capacity=self.model.capacity,
                              device=self.model.device)
        other.load_ply(path)
        n = other.num_alive
        dst = self._free_slots(n)
        d = self._index(dst)
        p = self.model.params
        for name, t, src in zip(p._fields, p, other.params):
            src = src[:n]
            if name == "segment" and src.shape[1] != t.shape[1]:
                # the other scene's classes, padded with zeros or cut
                fit = src.new_zeros((n, t.shape[1]))
                c = min(src.shape[1], t.shape[1])
                fit[:, :c] = src[:, :c]
                src = fit
            t[d] = src
        iid = self._claim(dst)
        self.transform_instance(iid, translate, scale)
        return iid

    def save_clip(self, path: str, mask: np.ndarray):
        """Save selected gaussians as a sub-scene PLY (Scene.save_clip,
        scene/__init__.py:131-137)."""
        self.model.save_ply(path, mask=mask)
