"""Scene container + camera loading/resolution policy.

Behavioral spec: reference scene/__init__.py:25-143 (dataset-type dispatch by
marker file, camera shuffling, cameras_extent, per-resolution-scale lists,
trained-PLY loading, save/save_clip) and utils/camera_utils.py:20-128
(resolution policy: -r in {1,2,4,8} divides, -1 auto-caps width at 1600px).
A copy of ``gsplat_tpu/data/scene.py``: the port imports nothing of the JAX
package.  Cameras hold their pixels as host numpy arrays, as there; the
trainer moves each camera's batch to the model's device when it uses it.
"""
from __future__ import annotations

import json
import os
import random
import shutil
from typing import List, Optional

import numpy as np

from gsplat_tpu_torch.core.cameras import (Camera, MiniCam, fov2focal,
                                           get_projection_matrix,
                                           get_world2view2)
from gsplat_tpu_torch.data.readers import (CameraInfo,
                                           scene_load_type_callbacks)
from gsplat_tpu_torch.utils.general import search_for_max_iteration

_WARNED = False


def _resize_pil(img, resolution):
    return img.resize(resolution)


def _camera_resolution(orig_w: int, orig_h: int, resolution_scale: float,
                       resolution_arg: int):
    """The -r / 1600px-cap policy (utils/camera_utils.py:24-46)."""
    global _WARNED
    if resolution_arg in (1, 2, 4, 8):
        return (round(orig_w / (resolution_scale * resolution_arg)),
                round(orig_h / (resolution_scale * resolution_arg)))
    if resolution_arg == -1:
        if orig_w > 1600:
            if not _WARNED:
                print("[ INFO ] Encountered quite large input images "
                      "(>1.6K pixels width), rescaling to 1.6K.\n If this "
                      "is not desired, please explicitly specify "
                      "'--resolution/-r' as 1")
                _WARNED = True
            global_down = orig_w / 1600
        else:
            global_down = 1
    else:
        global_down = orig_w / resolution_arg
    scale = float(global_down) * float(resolution_scale)
    return (int(orig_w / scale), int(orig_h / scale))


def _load_pixel_arrays(cam_info: CameraInfo, resolution):
    """Decode GT image (+alpha policy) and optional depth/segment at
    ``resolution`` — the pixel half of loadCam (utils/camera_utils.py:47-60),
    shared by the eager Camera and LazyCamera."""
    from PIL import Image

    with Image.open(cam_info.image_path) as img:
        has_alpha = img.mode in ("RGBA", "LA", "PA")
        arr = np.asarray(_resize_pil(img, resolution),
                         dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    alpha_mask = None
    if has_alpha and arr.shape[-1] >= 4:
        alpha = arr[..., 3:4]
        if cam_info.white_background:
            # Blender alpha-over-white compositing (dataset_readers.py:293-300)
            arr = arr[..., :3] * alpha + (1.0 - alpha)
        else:
            arr = arr[..., :3]
            alpha_mask = alpha.transpose(2, 0, 1)
    else:
        arr = arr[..., :3]
    image = arr.transpose(2, 0, 1)  # [3,H,W]

    depth = None
    if cam_info.depth_path:
        with Image.open(cam_info.depth_path) as dimg:
            depth = np.asarray(_resize_pil(dimg, resolution),
                               dtype=np.float32)
        if depth.ndim == 3:
            depth = depth[..., 0]
        depth = depth[None]  # [1,H,W], raw values (no normalization —
                             # general_utils.py:29-35 PILtoTorch_notrgb)

    seg = None
    if cam_info.seg_path:
        with Image.open(cam_info.seg_path) as simg:
            seg = np.asarray(_resize_pil(simg, resolution))
        if seg.ndim == 3:
            seg = seg[..., 0]
        seg = seg.astype(np.int32)  # [H,W] labels
    return image, alpha_mask, depth, seg


def load_camera(cam_info: CameraInfo, uid: int, resolution_scale: float,
                resolution_arg: int) -> Camera:
    """utils/camera_utils.py:20-65 (loadCam)."""
    from PIL import Image

    with Image.open(cam_info.image_path) as img:
        orig_w, orig_h = img.size
    resolution = _camera_resolution(orig_w, orig_h, resolution_scale,
                                    resolution_arg)
    image, alpha_mask, depth, seg = _load_pixel_arrays(cam_info, resolution)
    return Camera(
        colmap_id=cam_info.uid, R=cam_info.R, T=cam_info.T,
        FoVx=cam_info.FovX, FoVy=cam_info.FovY, image=image,
        gt_alpha_mask=alpha_mask, image_name=cam_info.image_name, uid=uid,
        depth=depth, segment=seg,
    )


class LazyCamera(Camera):
    """A full training Camera whose pixel arrays (GT image / depth / segment)
    are decoded from disk ON EACH ACCESS instead of held in host RAM — the
    bounded-memory training mode (the reference keeps every camera's pixels
    resident on ``data_device``, scene/cameras.py:41-50, which at the 1600px
    cap with hundreds of cameras is tens of GB; its ``low_memory`` MiniCam
    path drops pixels entirely and cannot train).  Pose/projection matrices
    are computed eagerly (tiny); pair with the Trainer's LRU device-batch
    cache so at most ``gt_cache`` cameras' pixels exist anywhere at once."""

    def __init__(self, cam_info: CameraInfo, uid: int,
                 resolution_scale: float, resolution_arg: int):
        from PIL import Image

        orig_w, orig_h = cam_info.width, cam_info.height
        if not (orig_w and orig_h):
            with Image.open(cam_info.image_path) as img:
                orig_w, orig_h = img.size
        resolution = _camera_resolution(orig_w, orig_h, resolution_scale,
                                        resolution_arg)
        # bypass the dataclass __init__ (it requires eager pixels)
        self.colmap_id = cam_info.uid
        self.R = cam_info.R
        self.T = cam_info.T
        self.FoVx = cam_info.FovX
        self.FoVy = cam_info.FovY
        self.image_name = cam_info.image_name
        self.uid = uid
        self.gt_alpha_mask = None
        self.trans = np.zeros(3)
        self.scale = 1.0
        self.znear, self.zfar = 0.01, 100.0
        self.image_width, self.image_height = resolution
        self._cam_info = cam_info
        self._resolution = resolution
        self._build_matrices()

    def _pixels(self):
        image, alpha_mask, depth, seg = _load_pixel_arrays(
            self._cam_info, self._resolution)
        image = np.clip(image, 0.0, 1.0)
        if alpha_mask is not None:
            image = image * np.asarray(alpha_mask, np.float32)
        return image, depth, seg

    @property
    def image(self):
        return self._pixels()[0]

    @property
    def depth(self):
        return self._pixels()[1]

    @property
    def segment(self):
        return self._pixels()[2]


def load_camera_low_memory(cam_info: CameraInfo, resolution_scale: float,
                           resolution_arg: int) -> MiniCam:
    """utils/camera_utils.py:67-96 — pose-only camera, no pixels."""
    orig_w, orig_h = cam_info.width, cam_info.height
    if resolution_arg in (1, 2, 4, 8):
        w = round(orig_w / (resolution_scale * resolution_arg))
        h = round(orig_h / (resolution_scale * resolution_arg))
    else:
        global_down = (orig_w / 1600 if resolution_arg == -1 and orig_w > 1600
                       else (1 if resolution_arg == -1 else orig_w / resolution_arg))
        scale = float(global_down) * float(resolution_scale)
        w, h = int(orig_w / scale), int(orig_h / scale)
    znear, zfar = 0.01, 100.0
    wvt = get_world2view2(cam_info.R, cam_info.T).T
    proj = get_projection_matrix(znear, zfar, cam_info.FovX, cam_info.FovY).T
    return MiniCam(w, h, cam_info.FovY, cam_info.FovX, znear, zfar, wvt, wvt @ proj)


def camera_to_json(uid: int, cam: CameraInfo) -> dict:
    """utils/camera_utils.py:108-128."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = cam.R.transpose()
    Rt[:3, 3] = cam.T
    Rt[3, 3] = 1.0
    W2C = np.linalg.inv(Rt)
    pos = W2C[:3, 3]
    rot = W2C[:3, :3]
    return {
        "id": uid, "img_name": cam.image_name,
        "width": cam.width, "height": cam.height,
        "position": pos.tolist(),
        "rotation": [r.tolist() for r in rot],
        "fy": fov2focal(cam.FovY, cam.height),
        "fx": fov2focal(cam.FovX, cam.width),
    }


class Scene:
    """Reference scene/__init__.py:25-143."""

    def __init__(self, args, gaussians, load_iteration: Optional[int] = None,
                 shuffle: bool = True, resolution_scales=(1.0,),
                 sub_scene: Optional[List[str]] = None, low_memory: bool = False,
                 lazy_images: bool = False, write_inputs: bool = True):
        # lazy_images: build LazyCameras (pixels decoded per access) so host
        # RAM stays bounded on large datasets; low_memory keeps the
        # reference's pose-only MiniCam semantics (render/visualize only);
        # write_inputs=False leaves input.ply and cameras.json to another
        # process (the ranks of a multi-device run but rank 0)
        self.model_path = args.model_path
        self.loaded_iter = None
        self.gaussians = gaussians

        if load_iteration is not None:
            if load_iteration == -1:
                self.loaded_iter = search_for_max_iteration(
                    os.path.join(self.model_path, "point_cloud"))
            else:
                self.loaded_iter = load_iteration
            print(f"Loading trained model at iteration {self.loaded_iter}")

        # dataset-type dispatch by marker file (scene/__init__.py:56-66)
        src = args.source_path
        if os.path.exists(os.path.join(src, "sparse")):
            scene_info = scene_load_type_callbacks["Colmap"](
                src, args.images, args.eval,
                using_depth=getattr(args, "using_depth", False),
                using_seg=getattr(args, "using_seg", False))
        elif os.path.exists(os.path.join(src, "transforms_train.json")):
            print("Found transforms_train.json file, assuming Blender data set!")
            scene_info = scene_load_type_callbacks["Blender"](
                src, args.white_background, args.eval,
                using_depth=getattr(args, "using_depth", False),
                using_seg=getattr(args, "using_seg", False))
        elif os.path.exists(os.path.join(src, "transforms.json")):
            print("Found transforms.json file, assuming NeRFstudio data set!")
            scene_info = scene_load_type_callbacks["NeRFstudio"](
                src, args.eval,
                using_depth=getattr(args, "using_depth", False),
                using_seg=getattr(args, "using_seg", False))
        else:
            raise ValueError(f"Could not recognize scene type for {src}")
        self.scene_info = scene_info

        if not self.loaded_iter and write_inputs:
            os.makedirs(self.model_path, exist_ok=True)
            if scene_info.ply_path and os.path.exists(scene_info.ply_path):
                shutil.copyfile(scene_info.ply_path,
                                os.path.join(self.model_path, "input.ply"))
            cam_json = [camera_to_json(i, c) for i, c in enumerate(
                scene_info.train_cameras + scene_info.test_cameras)]
            with open(os.path.join(self.model_path, "cameras.json"), "w") as f:
                json.dump(cam_json, f)

        if shuffle:
            random.shuffle(scene_info.train_cameras)
            random.shuffle(scene_info.test_cameras)

        self.cameras_extent = scene_info.nerf_normalization["radius"]

        self.train_cameras = {}
        self.test_cameras = {}
        for scale in resolution_scales:
            print("Loading Training Cameras")
            if low_memory:
                self.train_cameras[scale] = [
                    load_camera_low_memory(c, scale, args.resolution)
                    for c in scene_info.train_cameras]
                self.test_cameras[scale] = [
                    load_camera_low_memory(c, scale, args.resolution)
                    for c in scene_info.test_cameras]
            elif lazy_images:
                self.train_cameras[scale] = [
                    LazyCamera(c, i, scale, args.resolution)
                    for i, c in enumerate(scene_info.train_cameras)]
                self.test_cameras[scale] = [
                    LazyCamera(c, i, scale, args.resolution)
                    for i, c in enumerate(scene_info.test_cameras)]
            else:
                self.train_cameras[scale] = [
                    load_camera(c, i, scale, args.resolution)
                    for i, c in enumerate(scene_info.train_cameras)]
                print("Loading Test Cameras")
                self.test_cameras[scale] = [
                    load_camera(c, i, scale, args.resolution)
                    for i, c in enumerate(scene_info.test_cameras)]

        if self.loaded_iter:
            self.gaussians.load_ply(os.path.join(
                self.model_path, "point_cloud",
                f"iteration_{self.loaded_iter}", "point_cloud.ply"))
        elif scene_info.point_cloud is not None:
            self.gaussians.create_from_pcd(
                scene_info.point_cloud.points, scene_info.point_cloud.colors,
                self.cameras_extent)

        # sub-scene merge support for the editor (scene/__init__.py:108-121)
        if sub_scene:
            self.sub_scene_paths = list(sub_scene)

    def save(self, iteration: int):
        pc_path = os.path.join(self.model_path, "point_cloud",
                               f"iteration_{iteration}")
        self.gaussians.save_ply(os.path.join(pc_path, "point_cloud.ply"))

    def save_clip(self, iteration: int, mask, name: str = "clip"):
        """Masked sub-scene PLY (scene/__init__.py:131-137)."""
        pc_path = os.path.join(self.model_path, "sub_scene_lib")
        os.makedirs(pc_path, exist_ok=True)
        self.gaussians.save_ply(
            os.path.join(pc_path, f"{name}_iteration_{iteration}.ply"), mask=mask)

    def getTrainCameras(self, scale=1.0):
        return self.train_cameras[scale]

    def getTestCameras(self, scale=1.0):
        return self.test_cameras[scale]
