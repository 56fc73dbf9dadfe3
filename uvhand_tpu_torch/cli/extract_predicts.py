"""Prediction extraction: the ARCTIC submission export (`--extraction_mode`).

Port of `uvhand_tpu/cli/extract_predicts.py` (the reference's
extract_predicts.py and arctic_tools/extraction/interface.py:
`std_interface`, `save_results`): per-sequence inference, the selected
queries decoded, weak-perspective cameras made perspective, axis-angle
poses made rotation matrices, the frames sorted by imgname and split per
camera, and `{out}/{sid}_{seq}_{cam}/preds/pred.*.pt` and
`meta_info/meta_info.imgname.pt` written with `torch.save`, float32 values
as float16, so the official ARCTIC submission tooling reads them unchanged.
The forward runs the model in eval mode under `torch.inference_mode()` on
the model's device, fed by `data/loader.py::prefetch_samples`.
"""

from __future__ import annotations

import json
import os
import os.path as op
from typing import Dict, List

import numpy as np
import torch

from ..data.loader import prefetch_samples
from ..geometry import camera as camera_lib
from ..geometry.rotations import axis_angle_to_matrix
from ..losses.criterion import select_queries
from ..utils.spans import recording, span, steps

SUBMIT_KEYS = (
    "pred.mano.cam_t.l", "pred.mano.beta.l", "pred.mano.pose.l",
    "pred.mano.cam_t.r", "pred.mano.beta.r", "pred.mano.pose.r",
    "pred.object.rot", "pred.object.cam_t", "pred.object.radian",
    "meta_info.imgname",
)


def extract_batch(outputs, intrinsics: torch.Tensor, imgnames,
                  img_res=224.0) -> Dict[str, np.ndarray]:
    """One batch's model outputs -> the reference's out_dict (float32 numpy
    arrays and the list of imgnames)."""
    sel = select_queries({k: v[-1] for k, v in outputs["stacked"].items() if v is not None})
    avg_f = (intrinsics[:, 0, 0] + intrinsics[:, 1, 1]) / 2.0

    def cam_t(wp):
        return camera_lib.weak_perspective_to_perspective(wp, avg_f, img_res)

    def to_rotmat(p):
        return axis_angle_to_matrix(p.reshape(-1, 16, 3))

    out = {
        "pred.mano.cam_t.l": cam_t(sel["root.l"]),
        "pred.mano.beta.l": sel["beta.l"],
        "pred.mano.pose.l": to_rotmat(sel["pose.l"]),
        "pred.mano.cam_t.r": cam_t(sel["root.r"]),
        "pred.mano.beta.r": sel["beta.r"],
        "pred.mano.pose.r": to_rotmat(sel["pose.r"]),
        "pred.object.rot": sel["obj_rot"],
        "pred.object.cam_t": cam_t(sel["root.o"]),
        "pred.object.radian": sel["obj_rad"],
    }
    out = {k: v.float().cpu().numpy() for k, v in out.items()}
    out["meta_info.imgname"] = list(imgnames)
    return out


def std_interface(out_list: List[Dict]) -> Dict[str, Dict]:
    """Concatenate the batches, sort by imgname, split per camera
    (interface.py's `std_interface`). One sequence only."""
    out = {}
    for k in out_list[0]:
        vals = [b[k] for b in out_list]
        out[k] = sum(vals, []) if isinstance(vals[0], list) else np.concatenate(vals, 0)

    sort_idx = np.argsort(np.array(out["meta_info.imgname"]))
    for k, v in out.items():
        out[k] = [v[i] for i in sort_idx] if isinstance(v, list) else v[sort_idx]

    cam_ids, seqs, sids = [], [], []
    for n in out["meta_info.imgname"]:
        sid, seq_name, cam, _ = n.split("/")[-4:]
        cam_ids.append(int(cam))
        seqs.append(seq_name)
        sids.append(sid)
    assert len(set(seqs)) == 1, "std_interface expects one sequence"
    cam_ids = np.array(cam_ids)
    out_cam = {}
    for cam in sorted(set(cam_ids.tolist())):
        idx = np.where(cam_ids == cam)[0]
        out_cam[f"{sids[0]}_{seqs[0]}_{cam}"] = {
            k: [v[i] for i in idx] if isinstance(v, list) else v[idx] for k, v in out.items()}
    return out_cam


def save_results(out_cam: Dict[str, Dict], out_dir: str):
    """Write each sequence's .pt files in the ARCTIC submission layout
    (interface.py's `save_results`): float32 arrays as float16 tensors,
    other arrays as they are, lists pickled by `torch.save`."""
    for seq_name, seq_data in out_cam.items():
        folder = op.join(out_dir, seq_name)
        for key, val in seq_data.items():
            if "pred." in key:
                out_p = op.join(folder, "preds", key + ".pt")
            elif "meta_info." in key:
                out_p = op.join(folder, "meta_info", key + ".pt")
            else:
                continue
            os.makedirs(op.dirname(out_p), exist_ok=True)
            if isinstance(val, np.ndarray) and val.dtype == np.float32:
                torch.save(torch.from_numpy(val).half(), out_p)
            elif isinstance(val, np.ndarray):
                torch.save(torch.from_numpy(val), out_p)
            else:
                torch.save(val, out_p)


def load_protocol_seqs(coco_path: str, dataset_file: str, setup: str, run_on: str = "val"):
    """The sequence list of `splits_json/protocol_{setup}.json[run_on]`
    (extract_predicts.py:71-77); None where the protocol file is absent (a
    synthetic root): then every sequence is exported."""
    for cand in (
        op.join(coco_path, dataset_file, f"data/arctic_data/data/splits_json/protocol_{setup}.json"),
        op.join(coco_path, dataset_file, f"splits_json/protocol_{setup}.json"),
    ):
        if op.exists(cand):
            with open(cand) as f:
                return json.load(f)[run_on]
    return None


def run_extraction(model, dataset, batch_size, out_dir, img_res=224.0, seqs=None,
                   results: dict | None = None, timing: dict | None = None):
    """The per-sequence loop (extract_predicts.py:99-130): the dataset's
    imgnames grouped by sequence (only the protocol's `seqs` where given),
    each group run in batches of `batch_size` (the last padded with its
    last frame, the padding dropped), exported to `out_dir`. `model` runs
    on the device its parameters are on. `results`, where given, receives
    each camera's dict before the float16 cast; `timing` the loop's spans
    (`utils.spans`: each batch's `wait` for its decoded frames and the
    `batch`, its forward and extraction) in `timing["spans"]`, the batch
    index counted over every sequence, and the `batch` spans' ms in
    `timing["batch_ms"]`. Returns `out_dir`."""
    groups: Dict[str, List[int]] = {}
    for i, n in enumerate(dataset.imgnames):
        sid, seq_name, _, _ = n.split("/")[-4:]
        if seqs is not None and seq_name not in seqs and f"{sid}/{seq_name}" not in seqs:
            continue
        groups.setdefault(f"{sid}/{seq_name}", []).append(i)

    device = next(model.parameters()).device
    model.eval()
    done = 0  # batches of the sequences before this one
    with recording(timing, batch_ms="batch"):
        for ids in groups.values():
            out_list, chunks, trims = [], [], []
            for s in range(0, len(ids), batch_size):
                chunk = ids[s:s + batch_size]
                trims.append(len(chunk))
                chunks.append(chunk + [chunk[-1]] * (batch_size - len(chunk)))
            # the host's decode overlaps the device's work (a thread-pool prefetch)
            for _, (samples, trim) in steps(zip(prefetch_samples(dataset, chunks), trims),
                                            start=done):
                with span("batch"):
                    imgs = torch.as_tensor(np.stack([x["images"] for x in samples]),
                                           device=device)
                    K = torch.as_tensor(np.stack([x["intrinsics"] for x in samples]),
                                        device=device)
                    with torch.inference_mode():
                        b = extract_batch(model(imgs), K, [x["imgname"] for x in samples],
                                          img_res)
                out_list.append({k: v[:trim] for k, v in b.items()})
            done += len(chunks)
            out_cam = std_interface(out_list)
            if results is not None:
                results.update(out_cam)
            save_results(out_cam, out_dir)
    return out_dir
