"""Motion deviation (MDev): contact-window hand-object motion consistency.

A copy of `uvhand_tpu/evaluation/mdev.py` (the reference's
`arctic_tools/src/utils/mdev.py`: `find_windows`, `compute_mdev`,
`eval_motion_deviation`). A whole-sequence, host-side metric with
data-dependent window discovery, in numpy; the window scan is vectorized
over frames.
"""

from __future__ import annotations

import numpy as np


def find_windows(dist, dist_idx, vo, contact_thres=3e-3, window_thres=15):
    """dist (F, 778), dist_idx (F, 778), vo (V, 3) static object verts.

    Returns list of [start, end, hand_vertex, object_vertex] stable-contact
    windows (end inclusive)."""
    dist = np.asarray(dist)
    dist_idx = np.asarray(dist_idx)
    vo = np.asarray(vo)
    F, _ = dist.shape
    contacts = dist < contact_thres

    vert_ids = np.nonzero(contacts.sum(0) >= window_thres)[0]
    windows = []
    for vidx in vert_ids:
        col = contacts[:, vidx]
        # run-length scan: starts where 0->1, ends where 1->0
        padded = np.concatenate([[False], col, [False]])
        starts = np.nonzero(~padded[:-1] & padded[1:])[0]
        ends = np.nonzero(padded[:-1] & ~padded[1:])[0] - 1
        for s, e in zip(starts, ends):
            if e - s + 1 < window_thres:
                continue
            # reference skips windows touching the sequence borders implicitly
            # via its asserts on s-1 / e+1; replicate that guard
            if s == 0 or e == F - 1:
                continue
            j_list = dist_idx[s : e + 1, vidx]
            vj = vo[j_list]
            d = np.linalg.norm(vj[:, None] - vj[None], axis=-1)
            # the reference nans only the top-left (window_thres,
            # window_thres) triangle regardless of window length
            # (mdev.py:73-76 passes window_thres to triu_indices, not
            # len(window)); windows longer than window_thres keep their
            # remaining upper-triangle duplicates + diagonal zeros in the
            # mean. Replicated exactly for metric parity.
            iu = np.triu_indices(window_thres)
            d[iu] = np.nan
            if np.nanmean(d) > contact_thres:
                continue  # finger slid along the surface
            vals, counts = np.unique(j_list, return_counts=True)
            jidx = int(vals[np.argmax(counts)])
            windows.append([int(s), int(e), int(vidx), jidx])
    return windows


def compute_mdev(windows, pred_vh, pred_vo, frame_valid):
    """Per-window mean deviation between hand and object motion (meters)."""
    pred_vh = np.asarray(pred_vh)
    pred_vo = np.asarray(pred_vo)
    frame_valid = np.asarray(frame_valid)
    out = []
    for m, n, i, j in windows:
        dvh = np.diff(pred_vh[m : n + 1, i], axis=0)
        dvo = np.diff(pred_vo[m : n + 1, j], axis=0)
        diff = dvh - dvo
        valid = frame_valid[m : n + 1]
        dv = (valid[1:] * valid[:-1]) > 0
        diff[~dv] = np.nan
        out.append(np.nanmean(np.linalg.norm(diff, axis=1)))
    return np.asarray(out)


def eval_motion_deviation(pred, targets, contact_thres=3e-3, window_thres=15):
    """mdev/h in mm over a whole ordered sequence (eval_modules registry)."""
    is_valid = np.asarray(targets["is_valid"])
    rv = np.asarray(targets["right_valid"]) * is_valid
    lv = np.asarray(targets["left_valid"]) * is_valid
    vo_static = np.asarray(targets["object.v.cam"])[0]

    wr = find_windows(targets["dist.ro"], targets["idx.ro"], vo_static,
                      contact_thres, window_thres)
    wl = find_windows(targets["dist.lo"], targets["idx.lo"], vo_static,
                      contact_thres, window_thres)
    mr = compute_mdev(wr, pred["mano.v3d.cam.r"], pred["object.v.cam"], rv)
    ml = compute_mdev(wl, pred["mano.v3d.cam.l"], pred["object.v.cam"], lv)
    return {"mdev/h": np.concatenate([mr, ml]) * 1000.0}
