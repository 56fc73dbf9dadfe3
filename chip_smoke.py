"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. card: name and power limit (nvidia-smi), torch/CUDA versions, TF32 off;
  2. build: compiles the MSDA kernels (csrc/msda_fwd.cu, csrc/msda_bwd.cu),
     one nvcc per source, started together;
  3. forward kernel against its plain version (`ms_deform_attn_torch`) at
     the serving path's encoder and decoder shapes in float32 and bfloat16,
     and at an out-of-range-heavy, an odd-D and a >128-side case; times the
     kernel, the plain version, the bound and a per-level `F.grid_sample`
     composition (a yardstick only; the port never calls it);
  3b. backward kernel against its plain version
     (`ms_deform_attn_torch_backward`) on the same cases plus an
     integer-exact one (every sample on a tent's kink), float32 and
     bfloat16, a >128 side in both; times it like the forward, with the
     grid_sample composition's autograd backward as the yardstick;
  4. serving path: `UVHandDETR` at full width (ResNet-50, 224x224, d=256,
     6+6 layers, 300 queries, 4 levels x 4 points, two-stage, box refine,
     float32) with seeded random weights serves three batches of 16
     synthetic frames through `engine.make_eval_step`; the forward kernel's
     launch count must rise by exactly 12 per batch, the backward's not at
     all;
  5. the same batch with the plain MSDA version must give the same outputs
     and metric rows;
  6. profile: host-clock times of the serving stages of one batch, and a
     torch.profiler table of its device kernels with the device's busy share;
  7. train, kernel against plain: one loss and backward of the same model in
     train mode from the same weights and generator seed with the kernels
     and with the plain MSDA versions; loss terms and every gradient agree;
  8. training path: `engine.make_fused_train_step` (dropout 0.1, feature mask
     0.3, AdamW lr 2e-4 / backbone 2e-5, clip 0.1) takes 4 steps on batches
     of 16 synthetic frames; per step every loss is finite, grad_norm is
     finite and > 0, both kernels' launch counts rise by exactly 12 and the
     parameters of every group move;
  9. train profile: host-clock times of the train stages of one step, and a
     torch.profiler table of one step with the device's busy share.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}; the
line before it gives every ported kernel's numbers as JSON.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from uvhand_tpu_torch import engine
from uvhand_tpu_torch.geometry import mano, objects
from uvhand_tpu_torch.geometry.rotations import axis_angle_to_matrix, rotate_about_axis
from uvhand_tpu_torch.models.detr import UVHandDETR
from uvhand_tpu_torch.ops import msda_cuda
from uvhand_tpu_torch.ops.msda import (MSDeformAttn, ms_deform_attn_torch,
                                       ms_deform_attn_torch_backward)
from uvhand_tpu_torch.train.state import create_optimizer, label_params

SEED = 0
BATCH = 16
IMG_RES = 224
N_BATCHES = 3
TRAIN_STEPS = 4
MSDA_PER_FORWARD = 12  # 6 encoder self-attention + 6 decoder cross-attention
# level shapes of a 224x224 image: strides 8, 16, 32 and the extra stride-64 level
LEVELS = ((28, 28), (14, 14), (7, 7), (4, 4))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_OPS_PER_S = 67e12  # H100 SXM, outside the tensor cores
# relative to max|value| (forward) or to each gradient's max (backward: the
# float32 dvalue is summed by atomics in no fixed order)
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def log(*args):
    print(*args, flush=True)


# ------------------------------------------------------------ 3. kernel


def msda_inputs(gen, B, Lq, M, D, P, shapes, lo, hi, dtype):
    """Random MSDA inputs; lo == hi == None puts every sample on an exact
    pixel centre (the shapes must be powers of two to make that exact)."""
    L = len(shapes)
    S = sum(h * w for h, w in shapes)
    dev = "cuda"
    value = torch.randn(B, S, M, D, generator=gen, device=dev).to(dtype)
    u = torch.rand(B, Lq, M, L, P, 2, generator=gen, device=dev)
    if lo is None:
        size = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=dev)
        loc = (torch.floor(u * size[:, None, :]) + 0.5) / size[:, None, :]
    else:
        loc = lo + (hi - lo) * u
    attn = torch.randn(B, Lq, M, L * P, generator=gen, device=dev).softmax(-1)
    return value, loc, attn.view(B, Lq, M, L, P).to(dtype)


def in_map_corners(shapes, loc) -> int:
    """Bilinear corners of this call's samples that fall inside their map."""
    Ws = torch.tensor([w for _, w in shapes], device=loc.device, dtype=torch.float32)
    Hs = torch.tensor([h for h, _ in shapes], device=loc.device, dtype=torch.float32)
    px = loc[..., 0] * Ws[:, None] - 0.5
    py = loc[..., 1] * Hs[:, None] - 0.5
    corners = 0
    for dy in (0, 1):
        cy = torch.floor(py) + dy
        for dx in (0, 1):
            cx = torch.floor(px) + dx
            corners += int(((cx >= 0) & (cx < Ws[:, None]) & (cy >= 0) & (cy < Hs[:, None])).sum())
    return corners


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def msda_bound_ms(value, shapes, loc, attn):
    """Least time for one forward call: compulsory bytes (each input read
    once, the output written once) over HBM bandwidth, or the float32
    operations that this call's in-map corners need over the non-tensor-core
    peak."""
    B, S, M, D = value.shape
    out_bytes = B * loc.shape[1] * M * D * value.element_size()
    # per point: 2 products + 2 subtractions for the pixel coordinates; per
    # in-map corner: 3 for the tent, 2 for the weight, 2 per channel
    ops = loc[..., 0].numel() * 4 + in_map_corners(shapes, loc) * (5 + 2 * D)
    return bound_ms(nbytes(value, loc, attn) + out_bytes, ops)


def msda_bwd_bound_ms(value, shapes, loc, attn, grad):
    """Least time for one backward call: value, locations, attention and the
    incoming gradient read once, dvalue / dloc / dattn written once (in the
    value's, float32 and the attention's types), or the float32 operations
    of this call's in-map corners."""
    D = value.shape[-1]
    # per point: 4 for the pixel coordinates; per in-map corner: ~12 for the
    # tents, signs, weights and the three per-point sums, and per channel a
    # product and a sum for the dot and a product and an add for dvalue
    ops = loc[..., 0].numel() * 4 + in_map_corners(shapes, loc) * (12 + 4 * D)
    return bound_ms(2 * nbytes(value, loc, attn) + nbytes(grad), ops)


def grid_sample_msda(value, shapes, loc, attn):
    """The reference's pure-PyTorch MSDA formula, one grid_sample per level."""
    B, S, M, D = value.shape
    Lq, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    grids = 2 * loc - 1
    out = 0
    start = 0
    for lvl, (H, W) in enumerate(shapes):
        v = value[:, start:start + H * W].permute(0, 2, 3, 1).reshape(B * M, D, H, W)
        g = grids[:, :, :, lvl].transpose(1, 2).reshape(B * M, Lq, P, 2)
        s = F.grid_sample(v, g.to(v.dtype), mode="bilinear", padding_mode="zeros",
                          align_corners=False)  # (B*M, D, Lq, P)
        a = attn[:, :, :, lvl].transpose(1, 2).reshape(B * M, 1, Lq, P)
        out = out + (s * a).sum(-1)
        start += H * W
    return out.view(B, M, D, Lq).permute(0, 3, 1, 2).reshape(B, Lq, M * D)


def median_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_phase():
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    enc = dict(B=BATCH, Lq=sum(h * w for h, w in LEVELS), M=8, D=32, P=4, shapes=LEVELS)
    dec = dict(enc, Lq=300)
    cases = [
        # name, shape, loc range, dtype, timed
        ("encoder fp32", enc, (0.0, 1.0), torch.float32, True),
        ("decoder fp32", dec, (-1.0, 1.0), torch.float32, True),
        ("encoder bf16", enc, (0.0, 1.0), torch.bfloat16, True),
        ("decoder bf16", dec, (-1.0, 1.0), torch.bfloat16, True),
        ("out-of-range fp32", dec, (-2.0, 3.0), torch.float32, False),
        ("odd D=71 fp32", dict(B=2, Lq=100, M=4, D=71, P=4, shapes=LEVELS[:2]),
         (-0.2, 1.2), torch.float32, False),
        ("odd D=30 bf16", dict(B=2, Lq=100, M=4, D=30, P=2, shapes=LEVELS),
         (-0.2, 1.2), torch.bfloat16, False),
        ("side>128 fp32", dict(B=2, Lq=200, M=8, D=32, P=4, shapes=((4, 200), (150, 3))),
         (-0.1, 1.1), torch.float32, False),
    ]
    timed = {}
    log("[kernel] forward (csrc/msda_fwd.cu) against ms_deform_attn_torch")
    max_err = 0.0
    for name, shape, (lo, hi), dtype, is_timed in cases:
        shp = dict(shape)
        shapes = shp.pop("shapes")
        value, loc, attn = msda_inputs(gen, **shp, shapes=shapes, lo=lo, hi=hi, dtype=dtype)
        out = msda_cuda.ms_deform_attn_cuda(value, shapes, loc, attn)
        ref = ms_deform_attn_torch(value, shapes, loc, attn)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        rel = err / float(value.float().abs().max())
        ok = bool(torch.isfinite(out.float()).all()) and rel <= TOL[dtype]
        log(f"[kernel] {name}: max_abs_err={err:.3e} rel={rel:.3e} tol={TOL[dtype]:.0e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"MSDA kernel disagrees with its plain version ({name})")
        if dtype == torch.float32:
            max_err = max(max_err, err)
        if not is_timed:
            continue
        ms = median_ms(lambda: msda_cuda.ms_deform_attn_cuda(value, shapes, loc, attn))
        plain = median_ms(lambda: ms_deform_attn_torch(value, shapes, loc, attn), iters=5)
        bound, bound_by = msda_bound_ms(value, shapes, loc, attn)
        timed[name] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=bound_by)
        log(f"[kernel] {name}: kernel {ms:.4f} ms (median), plain {plain:.4f} ms, "
            f"bound {bound:.4f} ms ({bound_by})")
        if dtype == torch.float32:
            gs_err = float((grid_sample_msda(value, shapes, loc, attn) - ref).abs().max())
            gs = median_ms(lambda: grid_sample_msda(value, shapes, loc, attn))
            log(f"[kernel] {name}: per-level grid_sample composition (yardstick only, "
                f"not one library call) {gs:.4f} ms, max_abs_err {gs_err:.2e}")
    return timed, max_err


def backward_kernel_phase():
    """The backward kernel against `ms_deform_attn_torch_backward`; every
    gradient within TOL of its own max."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    enc = dict(B=BATCH, Lq=sum(h * w for h, w in LEVELS), M=8, D=32, P=4, shapes=LEVELS)
    dec = dict(enc, Lq=300)
    side = dict(B=2, Lq=200, M=8, D=32, P=4, shapes=((4, 200), (150, 3)))
    exact = dict(B=2, Lq=300, M=8, D=32, P=4, shapes=((16, 32), (8, 16), (4, 8), (2, 4)))
    cases = [
        ("encoder fp32", enc, (0.0, 1.0), torch.float32, True),
        ("decoder fp32", dec, (-1.0, 1.0), torch.float32, True),
        ("encoder bf16", enc, (0.0, 1.0), torch.bfloat16, True),
        ("decoder bf16", dec, (-1.0, 1.0), torch.bfloat16, True),
        ("out-of-range fp32", dec, (-2.0, 3.0), torch.float32, False),
        ("odd D=71 fp32", dict(B=2, Lq=100, M=4, D=71, P=4, shapes=LEVELS[:2]),
         (-0.2, 1.2), torch.float32, False),
        ("odd D=30 bf16", dict(B=2, Lq=100, M=4, D=30, P=2, shapes=LEVELS),
         (-0.2, 1.2), torch.bfloat16, False),
        ("side>128 fp32", side, (-0.1, 1.1), torch.float32, False),
        ("side>128 bf16", side, (-0.1, 1.1), torch.bfloat16, False),
        ("integer-exact fp32", exact, (None, None), torch.float32, False),
        ("integer-exact bf16", exact, (None, None), torch.bfloat16, False),
    ]
    log("[bwd] backward (csrc/msda_bwd.cu) against ms_deform_attn_torch_backward")
    timed, max_err = {}, 0.0
    bwd = msda_cuda.ms_deform_attn_backward_cuda
    for name, shape, (lo, hi), dtype, is_timed in cases:
        shp = dict(shape)
        shapes = shp.pop("shapes")
        value, loc, attn = msda_inputs(gen, **shp, shapes=shapes, lo=lo, hi=hi, dtype=dtype)
        grad = torch.randn(shp["B"], shp["Lq"], shp["M"] * shp["D"], generator=gen,
                           device="cuda").to(dtype)
        ours = bwd(value, shapes, loc, attn, grad)
        ref = ms_deform_attn_torch_backward(value, shapes, loc, attn, grad)
        torch.cuda.synchronize()
        errs = []
        for gname, o, r in zip(("dvalue", "dloc", "dattn"), ours, ref):
            err = float((o.float() - r.float()).abs().max())
            rel = err / max(float(r.float().abs().max()), 1e-30)
            ok = bool(torch.isfinite(o.float()).all()) and o.dtype == r.dtype and rel <= TOL[dtype]
            errs.append(f"{gname} {err:.3e} (rel {rel:.2e})")
            if not ok:
                raise AssertionError(f"MSDA backward kernel disagrees with its plain version "
                                     f"({name}, {gname}: rel {rel:.3e})")
            if dtype == torch.float32:
                max_err = max(max_err, err)
        log(f"[bwd] {name}: max_abs_err " + ", ".join(errs) + f"; tol {TOL[dtype]:.0e} ok")
        if not is_timed:
            continue
        ms = median_ms(lambda: bwd(value, shapes, loc, attn, grad))
        plain = median_ms(lambda: ms_deform_attn_torch_backward(value, shapes, loc, attn, grad),
                          iters=5)
        bound, bound_by = msda_bwd_bound_ms(value, shapes, loc, attn, grad)
        timed[name] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=bound_by)
        log(f"[bwd] {name}: kernel {ms:.4f} ms (median), plain {plain:.4f} ms, "
            f"bound {bound:.4f} ms ({bound_by})")
        if dtype == torch.float32:
            leaves = [t.clone().requires_grad_() for t in (value, loc, attn)]
            out = grid_sample_msda(leaves[0], shapes, leaves[1], leaves[2])
            gs = median_ms(lambda: torch.autograd.grad(out, leaves, grad, retain_graph=True))
            log(f"[bwd] {name}: per-level grid_sample composition's autograd backward "
                f"(yardstick only, not one library call) {gs:.4f} ms")
    return timed, max_err


# ------------------------------------------------------------ 4. main path


def synthetic_batch(rng, bank: objects.ObjectBank, B: int) -> dict:
    """A batch of GT drawn the way `make_synthetic_root(obj_bank=...)` draws
    it: the bank's canonical object posed by a sampled articulation, rotation
    and translation ~0.6 m in front of a 1000 px camera, hands near it, and
    2D keypoints that are the exact projections of the 3D GT. The training
    keys are set as `ArcticDataset` sets them: slots (object, left, right)
    with the object's class (1..11, alphabetical) and the hands' 12 / 13,
    and 21 projected keypoints each (the object's from its top and bottom
    keypoints, every third dropped, as the dataset picks them)."""
    mk = lambda *shape: rng.normal(size=shape).astype(np.float32)
    oidx = rng.integers(0, bank.num_objects, size=B).astype(np.int32)
    radian = np.abs(mk(B)) * 0.5
    rot = mk(B, 3) * 0.3
    transl = mk(B, 3) * np.array([0.08, 0.08, 0.05], np.float32) + np.array([0, 0, 0.6], np.float32)
    Rg = axis_angle_to_matrix(torch.from_numpy(rot)).numpy()
    Ra = rotate_about_axis(torch.from_numpy(radian), torch.tensor([0.0, 0.0, -1.0])).numpy()
    kp_top = bank.kp_top.cpu().numpy()[oidx]
    kp_bottom = bank.kp_bottom.cpu().numpy()[oidx]
    pose = lambda R, pts: (np.einsum("bij,bnj->bni", R, pts) + transl[:, None]).astype(np.float32)
    kp3d_b = pose(Rg, kp_bottom)
    kp3d_t = pose(Rg @ Ra, kp_top)
    K = np.tile(np.array([[1000.0, 0, IMG_RES / 2], [0, 1000.0, IMG_RES / 2], [0, 0, 1]],
                         np.float32), (B, 1, 1))

    def kp2d_norm(p3d):
        pix = np.einsum("bij,bnj->bni", K, p3d)
        return (2.0 * (pix[..., :2] / pix[..., 2:]) / IMG_RES - 1.0).astype(np.float32)

    ones = np.ones(B, np.float32)
    j3d_r = mk(B, 21, 3) * 0.05 + transl[:, None]
    j3d_l = mk(B, 21, 3) * 0.05 + transl[:, None]
    j2d_r, j2d_l = kp2d_norm(j3d_r), kp2d_norm(j3d_l)
    small_obj_idx = [i for i in range(32) if i % 3 != 0][:21]
    obj_kp = np.concatenate([kp2d_norm(kp3d_t), kp2d_norm(kp3d_b)], 1)[:, small_obj_idx]
    alphabetical = sorted(bank.names)
    obj_label = np.array([alphabetical.index(bank.names[i]) + 1 for i in oidx], np.int32)
    return {
        "images": mk(B, IMG_RES, IMG_RES, 3),
        "intrinsics": K,
        "query_idx": oidx,
        "is_valid": ones, "left_valid": ones, "right_valid": ones,
        "mano.pose.r": np.concatenate([mk(B, 3) * 0.3, mk(B, 45) * 0.2], 1),
        "mano.pose.l": np.concatenate([mk(B, 3) * 0.3, mk(B, 45) * 0.2], 1),
        "mano.beta.r": mk(B, 10) * 0.5,
        "mano.beta.l": mk(B, 10) * 0.5,
        "mano.j3d.full.r": j3d_r,
        "mano.j3d.full.l": j3d_l,
        "object.kp3d.full.b": kp3d_b,
        "object.kp2d.norm.b": kp2d_norm(kp3d_b),
        "object.kp2d.norm.t": kp2d_norm(kp3d_t),
        "object.rot": rot,
        "object.radian": radian,
        "transl": transl,  # what the GT translation solve must recover
        "labels": np.stack([obj_label, np.full(B, 12, np.int32), np.full(B, 13, np.int32)], 1),
        "keypoints": np.stack([obj_kp, j2d_l, j2d_r], 1).reshape(B, 3, 42),
        "target_valid": np.ones((B, 3), bool),
        "joints_valid_r": np.ones((B, 21), np.float32),
        "joints_valid_l": np.ones((B, 21), np.float32),
        "mano.j2d.norm.r": j2d_r,
        "mano.j2d.norm.l": j2d_l,
    }


def build_world(device):
    gen = torch.Generator().manual_seed(SEED)
    model = UVHandDETR(generator=gen, device=device)  # the default: full width
    world = (mano.synthetic_mano(0, True, device=device),
             mano.synthetic_mano(1, False, device=device),
             objects.synthetic_object_bank(2, device=device))
    return model, world


def set_msda_impl(model, impl):
    for mod in model.modules():
        if isinstance(mod, MSDeformAttn):
            mod.impl = impl


def reset_counts():
    msda_cuda.ms_deform_attn_cuda.launches = 0
    msda_cuda.ms_deform_attn_backward_cuda.launches = 0


def read_counts():
    return (msda_cuda.ms_deform_attn_cuda.launches,
            msda_cuda.ms_deform_attn_backward_cuda.launches)


def main_path_phase(model, world, batches, card):
    step = engine.make_eval_step(model, *world, img_res=IMG_RES)
    reset_counts()
    rows, times = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        rows.append({k: v.cpu().numpy() for k, v in r.items()})
    launches, bwd_launches = read_counts()
    for i, t in enumerate(times):
        log(f"[serve] batch {i}: {t * 1e3:.3f} ms, {BATCH / t:.1f} frames/s "
            f"(B={BATCH}, fp32, {card})")
    if launches != MSDA_PER_FORWARD * len(batches) or bwd_launches != 0:
        raise AssertionError(f"MSDA kernels launched {launches} (forward) and {bwd_launches} "
                             f"(backward) times, expected {MSDA_PER_FORWARD * len(batches)} and 0")
    log(f"[serve] MSDA kernel launches: forward {launches} ({MSDA_PER_FORWARD} per batch), "
        f"backward {bwd_launches}")
    for i, (r, batch) in enumerate(zip(rows, batches)):
        valid = batch["is_valid"] > 0
        for k, v in r.items():
            if v.shape != (BATCH,):
                raise AssertionError(f"metric {k} has shape {v.shape}")
            # CDev is NaN by definition for a frame whose GT has no contact
            finite = np.isfinite(v[valid]) | (np.isnan(v[valid]) if k == "cdev/ho" else False)
            if not finite.all():
                raise AssertionError(f"batch {i}: metric {k} not finite on valid frames: {v}")
    means = {k: float(np.nanmean(np.concatenate([r[k] for r in rows]))) for k in rows[0]}
    log("[serve] metrics (random weights): " + json.dumps(means))
    return rows, times, launches, bwd_launches


def gt_phase(world, batch):
    """The GT solves recover the translation the synthetic object was drawn at."""
    from uvhand_tpu_torch.data.process import process_targets

    with torch.inference_mode():
        t = process_targets(engine.to_device(batch, "cuda"), *world, IMG_RES)
    err = float(np.abs(t["object.cam_t"].cpu().numpy() - batch["transl"]).max())
    log(f"[gt] object translation recovered to {err:.2e} m (tol 1e-4)")
    if not err <= 1e-4:
        raise AssertionError("GT translation solve did not recover the drawn translation")


def e2e_phase(model, world, batch, kernel_rows):
    with torch.inference_mode():
        images = torch.as_tensor(batch["images"], device="cuda")
        out_k = model(images)
        set_msda_impl(model, "torch")
        try:
            out_p = model(images)
            plain_rows = engine.make_eval_step(model, *world, img_res=IMG_RES)(batch)
        finally:
            set_msda_impl(model, "auto")
    worst = 0.0
    for k in ("pred_logits", "pred_hand_key", "pred_obj_key"):
        d = float((out_k["stacked"][k] - out_p["stacked"][k]).abs().max())
        worst = max(worst, d)
        log(f"[e2e] {k}: kernel vs plain max_abs_diff={d:.3e} (tol 1e-4)")
    for k, v in plain_rows.items():
        a, b = kernel_rows[k], v.cpu().numpy()
        same_nan = np.array_equal(np.isnan(a), np.isnan(b))
        d = float(np.nanmax(np.abs(a - b))) if np.isfinite(a).any() else 0.0
        log(f"[e2e] metric {k}: kernel vs plain max_abs_diff={d:.3e} mm (tol 1e-2)")
        if not same_nan or d > 1e-2:
            raise AssertionError(f"metric {k}: kernel and plain runs disagree")
    if worst > 1e-4:
        raise AssertionError("kernel and plain MSDA runs disagree end to end")


def profile_phase(model, world, batch):
    """Where one batch's time goes: host-clock stage times (each ending in a
    synchronize) and the profiler's device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from uvhand_tpu_torch.data.process import process_targets
    from uvhand_tpu_torch.evaluation.decode import decode_predictions
    from uvhand_tpu_torch.evaluation.metrics import measure_error
    from uvhand_tpu_torch.losses.criterion import select_queries

    b = engine.to_device(batch, "cuda")
    stages = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = stages.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    reps = 3
    with torch.inference_mode():
        for _ in range(reps):
            targets = timed("process_targets", lambda: process_targets(b, *world, IMG_RES))
            timed("backbone+input_proj+posenc", lambda: model.level_features(b["images"]))
            out = timed("model forward (all)", lambda: model(b["images"]))
            last = {k: v[-1] for k, v in out["stacked"].items()}
            pred = timed("select+decode", lambda: decode_predictions(
                select_queries(last), targets, *world, IMG_RES))
            timed("metrics", lambda: measure_error(pred, targets, engine.BATCH_METRICS))
    for name, ms in stages.items():
        log(f"[profile] stage {name}: {ms / reps:.3f} ms")

    step = engine.make_eval_step(model, *world, img_res=IMG_RES)
    step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_kernels = sum(e.count for e in kernels)
    log(f"[profile] one step: wall {wall:.3f} ms, device busy {device_ms:.3f} ms "
        f"({100 * device_ms / wall:.1f}%), {n_kernels} device kernels and copies")
    log(events.table(sort_by="self_cuda_time_total", row_limit=25, max_name_column_width=60))


# ------------------------------------------------------------ 7-9. training


def train_ab_phase(model, world, batch):
    """One loss and backward in train mode (dropout and feature mask on)
    from the same weights and generator seed, with the kernels and with the
    plain MSDA versions. Loss terms within 1e-4 relative; each gradient
    within 1e-3 of its tensor's max (the backward kernel's float32 dvalue
    sums are atomics in no fixed order, and cuDNN's weight gradients are
    not bit-repeatable either)."""
    loss_fn = engine.make_loss_fn(model, *world, img_res=IMG_RES)
    tb = engine.to_device(batch, "cuda", engine.TRAIN_KEYS)
    params = dict(model.named_parameters())
    runs = {}
    model.train()
    try:
        for impl in ("auto", "torch"):
            set_msda_impl(model, impl)
            model.zero_grad(set_to_none=True)
            total, ld = loss_fn(tb, torch.Generator(device="cuda").manual_seed(SEED))
            total.backward()
            runs[impl] = ({k: float(v.detach()) for k, v in ld.items()},
                          {n: p.grad.clone() for n, p in params.items() if p.grad is not None})
    finally:
        set_msda_impl(model, "auto")
        model.zero_grad(set_to_none=True)
    (ld_k, g_k), (ld_p, g_p) = runs["auto"], runs["torch"]
    loss_worst = max(abs(ld_k[k] - ld_p[k]) / max(abs(ld_p[k]), 1e-2) for k in ld_p)
    bad = [k for k in ld_p if not abs(ld_k[k] - ld_p[k]) <= 1e-4 * abs(ld_p[k]) + 1e-6]
    log(f"[train-ab] {len(ld_p)} loss terms, worst relative diff {loss_worst:.3e} (tol 1e-4)")
    if set(g_k) != set(g_p) or bad:
        raise AssertionError(f"kernel and plain train passes disagree on losses {bad}")
    worst, worst_name = 0.0, ""
    for n, gp in g_p.items():
        rel = float((g_k[n] - gp).abs().max()) / max(float(gp.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, n
    log(f"[train-ab] {len(g_p)} gradients, worst {worst:.3e} of its tensor's max ({worst_name}; "
        f"tol 1e-3)")
    if worst > 1e-3:
        raise AssertionError("kernel and plain train passes disagree on gradients")


def train_phase(model, world, batches, card):
    """The training path: make_fused_train_step with the CLI's defaults."""
    opt = create_optimizer(model)  # lr 2e-4, backbone 2e-5, linear proj x0.1, wd 1e-4
    step = engine.make_fused_train_step(
        model, *world, opt, img_res=IMG_RES, clip_max_norm=0.1,
        generator=torch.Generator(device="cuda").manual_seed(SEED))
    labels = label_params(model)
    params = dict(model.named_parameters())
    times = []
    reset_counts()
    for i, batch in enumerate(batches):
        old = {n: p.detach().clone() for n, p in params.items()}
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ld = step(batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        times.append(dt)
        after = read_counts()
        vals = {k: float(v) for k, v in ld.items()}
        bad = sorted(k for k, v in vals.items() if not np.isfinite(v))
        moved = {g: any(not torch.equal(p, old[n]) for n, p in params.items() if labels[n] == g)
                 for g in set(labels.values())}
        delta = (after[0] - before[0], after[1] - before[1])
        log(f"[train] step {i}: {dt * 1e3:.3f} ms, {BATCH / dt:.1f} frames/s (B={BATCH}, fp32, "
            f"{card}); total {vals['total']:.6g}, grad_norm {vals['grad_norm']:.6g}, "
            f"launches forward +{delta[0]} backward +{delta[1]}, groups moved {moved}")
        if bad or not vals["grad_norm"] > 0:
            raise AssertionError(f"step {i}: non-finite losses {bad} or grad_norm "
                                 f"{vals['grad_norm']}")
        if delta != (MSDA_PER_FORWARD, MSDA_PER_FORWARD):
            raise AssertionError(f"step {i}: MSDA launches {delta}, expected 12 and 12")
        if not all(moved.values()):
            raise AssertionError(f"step {i}: a parameter group did not move: {moved}")
    fwd, bwd = read_counts()
    log(f"[train] MSDA kernel launches over {len(batches)} steps: forward {fwd}, backward {bwd}")
    log("[train] last step's losses: " + json.dumps(vals))
    return times, fwd, bwd


def train_profile_phase(model, world, batch):
    """Where one train step's time goes, from the profiler over two steps of
    make_fused_train_step itself: each stage's host time and the device time
    of the kernels it launched (its `engine.TRAIN_STAGES` range), and the
    device's busy share of the wall clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    opt = create_optimizer(model)
    step = engine.make_fused_train_step(model, *world, opt, img_res=IMG_RES,
                                        generator=torch.Generator(device="cuda").manual_seed(SEED))
    step(batch)
    torch.cuda.synchronize()
    reps = 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    events = prof.key_averages()
    ranges = {e.key: e for e in events
              if e.key in engine.TRAIN_STAGES and e.device_type == DeviceType.CPU}
    attributed = 0.0
    for name in engine.TRAIN_STAGES:
        e = ranges[name]
        attributed += e.device_time_total / 1e3 / reps
        log(f"[train-profile] stage {name}: host {e.cpu_time_total / 1e3 / reps:.3f} ms, "
            f"device {e.device_time_total / 1e3 / reps:.3f} ms")
    # device-side annotations (these ranges, torch's Optimizer.step) are spans, not work
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    n_kernels = sum(e.count for e in kernels) // reps
    # autograd runs a CUDA backward on its own device thread, outside the
    # caller's ranges: the backward's kernels (and the input copies) land here
    log(f"[train-profile] device time outside the stages' threads (autograd's device "
        f"thread, input copies): {device_ms - attributed:.3f} ms")
    log(f"[train-profile] one step: wall {wall:.3f} ms, device busy {device_ms:.3f} ms "
        f"({100 * device_ms / wall:.1f}%), {n_kernels} device kernels and copies")
    log(events.table(sort_by="self_cuda_time_total", row_limit=25, max_name_column_width=60))


# ------------------------------------------------------------ main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is present", file=sys.stderr)
        return 2

    # 1. card
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[card] {card}")
    log(f"[card] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    log(f"[card] allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    # 2. build
    t0 = time.perf_counter()
    msda_cuda.library()
    log(f"[build] msda_fwd.cu and msda_bwd.cu built (one nvcc each, together) and loaded "
        f"in {time.perf_counter() - t0:.2f} s")

    # 3. kernels against their plain versions
    timed, max_err = kernel_phase()
    btimed, bmax_err = backward_kernel_phase()

    # 4. main path
    model, world = build_world("cuda")
    rng = np.random.default_rng(SEED)
    batches = [synthetic_batch(rng, world[2], BATCH) for _ in range(N_BATCHES)]
    gt_phase(world, batches[0])
    rows, times, launches, serve_bwd = main_path_phase(model, world, batches, card)

    # 5. the same batch with the plain MSDA version
    e2e_phase(model, world, batches[0], rows[0])

    # 6. where one batch's time goes
    profile_phase(model, world, batches[1])

    # 7-9. training, from the same seeded weights
    model, world = build_world("cuda")
    train_batches = [synthetic_batch(rng, world[2], BATCH) for _ in range(TRAIN_STEPS)]
    train_ab_phase(model, world, train_batches[0])
    _, train_fwd, train_bwd = train_phase(model, world, train_batches, card)
    train_profile_phase(model, world, train_batches[1])

    def per_step(t):
        # a forward or a backward calls its kernel 6 times at each of the two shapes
        row = {key: 6 * t["encoder fp32"][key] + 6 * t["decoder fp32"][key]
               for key in ("ms", "plain_ms", "bound_ms")}
        by = {t[n]["bound_by"] for n in ("encoder fp32", "decoder fp32")}
        row["bound_by"] = "bytes" if by == {"bytes"} else "operations"
        return row

    log("[kernel] ms, plain_ms and bound_ms are per forward (msda_fwd) and per backward "
        "(msda_bwd): 6 encoder + 6 decoder float32 calls; launches are the serving path's "
        "(msda_fwd) and the training path's (msda_bwd), launches_by_path gives both")
    log(json.dumps({"kernels": [
        {"name": "msda_fwd", "route": "cuda", "source": "uvhand_tpu_torch/ops/csrc/msda_fwd.cu",
         "replaces": "uvhand_tpu/ops/msda_pallas.py:207", "launches": launches,
         "launches_by_path": {"serve": launches, "train": train_fwd},
         "max_abs_err": max_err, **per_step(timed), "library_ms": None},
        {"name": "msda_bwd", "route": "cuda", "source": "uvhand_tpu_torch/ops/csrc/msda_bwd.cu",
         "replaces": "uvhand_tpu/ops/msda_pallas.py:233, :320", "launches": train_bwd,
         "launches_by_path": {"serve": serve_bwd, "train": train_bwd},
         "max_abs_err": bmax_err, **per_step(btimed), "library_ms": None},
    ]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
