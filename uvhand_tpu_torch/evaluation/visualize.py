"""Visualization: 2D keypoint overlays, software mesh rendering, OBJ export.

Port of `uvhand_tpu/evaluation/visualize.py`. The reference renders meshes
with aitviewer's HeadlessRenderer and draws 2D keypoints with cv2
(util/tools.py). There is no headless GL here either, so the drawing is
GL-free numpy/cv2 on the host, copied from the JAX package:
  - `draw_keypoints_2d`: a cv2 overlay of normalized keypoints on the input
    crop (hands 21, object 32, bbox 16),
  - `render_mesh_overlay`: a numpy z-buffer rasterizer (perspective
    projection with the frame intrinsics, Lambert-shaded triangles,
    depth-tested across meshes, alpha-composited onto the crop),
  - `export_obj` / `export_scene`: per-frame wavefront OBJ files of the
    predicted MANO and object meshes.
`save_eval_visualizations` (`--eval --visualization`) runs the serving
step -- `process_targets`, the forward, `select_queries`,
`decode_predictions`, the projection -- on the model's device.
"""

from __future__ import annotations

import os
import os.path as op

import numpy as np
import torch

HAND_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 4),
    (0, 5), (5, 6), (6, 7), (7, 8),
    (0, 9), (9, 10), (10, 11), (11, 12),
    (0, 13), (13, 14), (14, 15), (15, 16),
    (0, 17), (17, 18), (18, 19), (19, 20),
]


def denormalize_image(img_norm: np.ndarray) -> np.ndarray:
    """Invert ImageNet normalization -> uint8 RGB."""
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    img = np.clip((img_norm * std + mean) * 255.0, 0, 255)
    return img.astype(np.uint8)


def draw_keypoints_2d(img_norm, kp2d_norm_dict, img_res: int = 224) -> np.ndarray:
    """img (H, W, 3) normalized; kp2d dict of (N, 2) in [-1, 1] patch coords.
    Colors: right hand red, left green, object blue."""
    import cv2

    img = denormalize_image(np.asarray(img_norm)).copy()
    colors = {"r": (255, 60, 60), "l": (60, 220, 60), "o": (80, 120, 255)}
    for key, kp in kp2d_norm_dict.items():
        kp = np.asarray(kp)
        px = (0.5 * img_res * (kp + 1)).astype(int)
        c = colors.get(key[-1], (255, 255, 0))
        if kp.shape[0] == 21:
            for a, b in HAND_EDGES:
                cv2.line(img, tuple(px[a]), tuple(px[b]), c, 1)
        for p in px:
            cv2.circle(img, tuple(p), 2, c, -1)
    return img


def rasterize_mesh(zbuf, shaded, verts_px, depth, faces, color,
                   light_dir=(0.3, -0.4, -0.85)):
    """Rasterize one triangle mesh into (zbuf, shaded) in place.

    verts_px (N, 2) pixel coords, depth (N,) camera z, faces (F, 3) int.
    Per-face flat Lambert shading; z-buffer depth test per pixel. Pure
    numpy: a per-face loop over small bounding boxes (~1.5k MANO faces ->
    ~40 ms/frame), plenty for an eval-time visualizer.
    """
    H, W = zbuf.shape
    v = np.asarray(verts_px, np.float32)
    z = np.asarray(depth, np.float32)
    tri = v[faces]  # (F, 3, 2)
    triz = z[faces]  # (F, 3)

    # face normals in camera space for shading (rebuild 3D from px + z is
    # unnecessary: use the 3D verts passed via depth plane approximation —
    # caller supplies camera-space verts through _face_normals instead)
    p3 = np.concatenate([v, z[:, None]], 1)[faces]  # pseudo-3D for normals
    n = np.cross(p3[:, 1] - p3[:, 0], p3[:, 2] - p3[:, 0])
    n = n / (np.linalg.norm(n, axis=1, keepdims=True) + 1e-9)
    lam = np.clip(-(n @ np.asarray(light_dir, np.float32)), 0.15, 1.0)

    order = np.argsort(-triz.mean(1))  # far-to-near helps early z coherence
    color = np.asarray(color, np.float32)
    for f in order:
        (x0, y0), (x1, y1), (x2, y2) = tri[f]
        xmin = max(int(np.floor(min(x0, x1, x2))), 0)
        xmax = min(int(np.ceil(max(x0, x1, x2))) + 1, W)
        ymin = max(int(np.floor(min(y0, y1, y2))), 0)
        ymax = min(int(np.ceil(max(y0, y1, y2))) + 1, H)
        if xmin >= xmax or ymin >= ymax:
            continue
        xs, ys = np.meshgrid(np.arange(xmin, xmax), np.arange(ymin, ymax))
        d = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
        if abs(d) < 1e-12:
            continue
        w0 = ((y1 - y2) * (xs - x2) + (x2 - x1) * (ys - y2)) / d
        w1 = ((y2 - y0) * (xs - x2) + (x0 - x2) * (ys - y2)) / d
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        zpix = w0 * triz[f, 0] + w1 * triz[f, 1] + w2 * triz[f, 2]
        zb = zbuf[ymin:ymax, xmin:xmax]
        upd = inside & (zpix < zb)
        zb[upd] = zpix[upd]
        shaded[ymin:ymax, xmin:xmax][upd] = color * lam[f]


def render_mesh_overlay(img_norm, meshes, K, img_res: int = 224,
                        alpha: float = 0.75) -> np.ndarray:
    """Render camera-space meshes onto the (normalized) input crop.

    meshes: list of (verts_cam (N,3), faces (F,3), rgb (3,)) — hands +
    object together so the shared z-buffer resolves their occlusion, the
    property the reference gets from aitviewer's HeadlessRenderer.
    K maps camera space to CROP pixel coords (the dataset's intrinsics).
    """
    img = denormalize_image(np.asarray(img_norm)).astype(np.float32)
    H = W = int(img_res)
    zbuf = np.full((H, W), np.inf, np.float32)
    shaded = np.zeros((H, W, 3), np.float32)
    K = np.asarray(K, np.float32)
    for verts, faces, color in meshes:
        if faces is None or len(verts) == 0:
            continue
        v = np.asarray(verts, np.float32)
        z = np.maximum(v[:, 2], 1e-6)
        px = np.stack([
            K[0, 0] * v[:, 0] / z + K[0, 2],
            K[1, 1] * v[:, 1] / z + K[1, 2],
        ], 1)
        rasterize_mesh(zbuf, shaded, px, z, np.asarray(faces, np.int64), color)
    hit = np.isfinite(zbuf)
    img[hit] = (1 - alpha) * img[hit] + alpha * shaded[hit]
    return np.clip(img, 0, 255).astype(np.uint8)


def export_obj(path: str, verts: np.ndarray, faces: np.ndarray | None = None):
    os.makedirs(op.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for v in np.asarray(verts):
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        if faces is not None:
            for tri in np.asarray(faces):
                f.write(f"f {tri[0]+1} {tri[1]+1} {tri[2]+1}\n")


def export_scene(out_dir: str, frame_idx: int, pred: dict,
                 mano_faces_r=None, mano_faces_l=None, obj_faces=None):
    """Dump one frame's predicted meshes (cam space) as OBJ files."""
    base = op.join(out_dir, f"{frame_idx:05d}")
    export_obj(base + "_hand_r.obj", np.asarray(pred["mano.v3d.cam.r"])[frame_idx], mano_faces_r)
    export_obj(base + "_hand_l.obj", np.asarray(pred["mano.v3d.cam.l"])[frame_idx], mano_faces_l)
    v = np.asarray(pred["object.v.cam"])[frame_idx]
    vlen = int(np.asarray(pred["object.v_len"])[frame_idx]) if "object.v_len" in pred else len(v)
    export_obj(base + "_object.obj", v[:vlen], obj_faces)
    return base


def save_eval_visualizations(model, dataset, mano_r, mano_l, obj_bank, out_dir: str,
                             img_res: float = 224.0, batch_size: int = 4,
                             max_frames: int = 64) -> str:
    """`--eval --visualization` (the reference's `visualize_arctic_result`):
    the first `max_frames` frames of `dataset` in batches of `batch_size`,
    each written as `{i:05d}.png` (the predicted joints and object
    keypoints projected with the frame's intrinsics, drawn on its crop),
    and OBJ meshes of the first batch's first 4 frames. The model, the MANO
    models and the object bank must be on one device, where the step runs.
    Returns `out_dir`."""
    import cv2

    from ..data.arctic import collate
    from ..data.process import process_targets
    from ..engine import to_device
    from ..evaluation.decode import decode_predictions
    from ..geometry import camera
    from ..losses.criterion import select_queries

    device = next(model.parameters()).device
    os.makedirs(out_dir, exist_ok=True)

    @torch.inference_mode()
    def step(batch):
        model.eval()
        targets = process_targets(batch, mano_r, mano_l, obj_bank, img_res)
        outputs = model(batch["images"])
        sel = select_queries({k: v[-1] for k, v in outputs["stacked"].items()
                              if v is not None})
        pred = decode_predictions(sel, targets, mano_r, mano_l, obj_bank, img_res)
        K = targets["intrinsics"]
        kp2d = {key: camera.normalize_kp2d(camera.project2d(K, j3d), img_res)
                for key, j3d in (("r", pred["mano.j3d.cam.r"]), ("l", pred["mano.j3d.cam.l"]),
                                 ("o", pred["object.kp3d.cam"]))}
        return kp2d, {k: pred[k] for k in ("mano.v3d.cam.r", "mano.v3d.cam.l", "object.v.cam")}

    n = min(len(dataset), max_frames)
    written = 0
    for s0 in range(0, n, batch_size):
        ids = list(range(s0, min(s0 + batch_size, n)))
        samples = [dataset[i] for i in ids]
        kp2d, meshes = step(to_device(collate(samples), device))
        kp2d = {k: v.cpu().numpy() for k, v in kp2d.items()}
        meshes = {k: v.cpu().numpy() for k, v in meshes.items()}
        for bi, i in enumerate(ids):
            img = draw_keypoints_2d(samples[bi]["images"], {k: kp2d[k][bi] for k in kp2d},
                                    int(img_res))
            cv2.imwrite(op.join(out_dir, f"{i:05d}.png"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
            if written < 4:  # OBJ meshes for the first few frames
                export_scene(out_dir, bi, meshes,
                             mano_faces_r=None if mano_r.faces is None else np.asarray(mano_r.faces),
                             mano_faces_l=None if mano_l.faces is None else np.asarray(mano_l.faces))
            written += 1
    return out_dir
