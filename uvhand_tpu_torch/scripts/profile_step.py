"""Profile the fused train step and break its device time down: port of
`scripts/profile_step.py`.

    python -m uvhand_tpu_torch.scripts.profile_step [--steps 3] [--batch 16]
        [--fp32] [--enc_lite] [--logdir build/profile_step] [--trace]
        [--report-only] [--top 40] [--device cpu] [--hidden_dim 64 ...]

`capture` builds the program the CLI trains with (`engine.make_fused_train_step`:
GT preprocessing, forward, criterion, backward, clip, AdamW) for arctic_sf at
full width (the flags shrink it), bf16 compute unless `--fp32`, enc_lite
with `--enc_lite`, on the first batch of a synthetic ARCTIC root read
through `ArcticDataset` and `DataLoader`. It takes a warm-up step, times
`--steps` steps on the host clock (ending in a synchronize), then runs
`--steps` more under torch.profiler (the card's activity alone on the card,
the host's on the CPU) and saves what it saw under `--logdir`:
`ops.json` (every row of `key_averages()`), and with `--trace` also
`trace.json` (the Chrome trace: ~75 MB and tens of seconds to write a
full-width step).

`report` takes the place of xprof's `hlo_stats`: from the saved rows it
prints the total device self time (the CUDA rows: kernels, copies and
fills, as `measure.device_ms` counts them), its share by category, and the
top ops. Categories, first match wins, so a kernel counts once: each MSDA
kernel by its name (`msda_*`), GEMM/conv, copies, elementwise/reduction,
other. It also prints the device ops a step and the busy share (device
time over the profiled steps' wall clock), the two numbers behind PERF.md
§5's first bottleneck. On the CPU there is no device: the report reads the
host's self time of the CPU ops instead, by the same categories, and the
busy share is not measured. `--report-only` reads a saved `ops.json`.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time

import numpy as np
import torch

#: an MSDA kernel's name (`void msda_fwd_staged_kernel<float>(...)`)
MSDA = re.compile(r"\bmsda_\w+?_kernel")
#: (category, pattern of a kernel's or op's name), in the order they are tried
CATEGORIES = (
    ("GEMM/conv", re.compile(r"gemm|cutlass|cublas|xmma|conv|wgrad|dgrad|winograd|cudnn|"
                             r"aten::(mm|bmm|addmm|baddbmm|matmul|linear|convolution|_convolution"
                             r"|cudnn_convolution|mkldnn_convolution)\b", re.I)),
    ("copies", re.compile(r"memcpy|memset|copy|aten::(to|_to_copy|contiguous|clone|cat|stack)\b",
                          re.I)),
    ("elementwise/reduction", re.compile(r"elementwise|vectorized|unrolled|reduce|reduction|"
                                         r"softmax|norm|index|scatter|gather|where|aten::", re.I)),
)


def category(name: str) -> str:
    """The category of a kernel or op by its name: an MSDA kernel is its own
    (`msda: <name>`), then the first of `CATEGORIES` that matches, else other."""
    msda = MSDA.search(name)
    if msda:
        return "msda: " + msda.group(0)
    for cat, pattern in CATEGORIES:
        if pattern.search(name):
            return cat
    return "other"


def capture(args, logdir: str) -> dict:
    """Profile `args.steps` fused train steps; writes `ops.json` and
    `trace.json` under `logdir`; -> {"wall_ms", "profiled_ms", "steps"}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from uvhand_tpu_torch import engine
    from uvhand_tpu_torch.bench import first_batch
    from uvhand_tpu_torch.device import resolve_device
    from uvhand_tpu_torch.geometry import mano, objects
    from uvhand_tpu_torch.models.detr import UVHandDETR
    from uvhand_tpu_torch.train.state import create_optimizer

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    batch = {k: torch.as_tensor(np.asarray(v), device=device)
             for k, v in first_batch(args, args.batch).items()}
    world = (mano.synthetic_mano(0, True, device=device),
             mano.synthetic_mano(1, False, device=device),
             objects.synthetic_object_bank(2, device=device))
    model = UVHandDETR(num_queries=args.num_queries, d_model=args.hidden_dim,
                       n_heads=args.nheads, num_encoder_layers=args.enc_layers,
                       num_decoder_layers=args.dec_layers, dim_feedforward=args.dim_feedforward,
                       compute_dtype=torch.float32 if args.fp32 else torch.bfloat16,
                       enc_lite=args.enc_lite, generator=torch.Generator().manual_seed(0),
                       device=device)
    step = engine.make_fused_train_step(
        model, *world, create_optimizer(model), img_res=float(args.img_res),
        generator=torch.Generator(device=device).manual_seed(0), device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    step(batch)  # warm-up: the kernels' build, the optimizer's state
    sync()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step(batch)
    sync()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    # the card's kernels alone where there is a card: the host's ~2 ops a
    # kernel would double the events the profiler must process
    activities = [ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(batch)
        sync()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(logdir, exist_ok=True)
    if args.trace:
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    rows = [{"name": e.key, "device": "cuda" if e.device_type == DeviceType.CUDA else "cpu",
             "user_annotation": bool(e.is_user_annotation), "count": int(e.count),
             "self_device_us": float(e.self_device_time_total),
             "self_cpu_us": float(e.self_cpu_time_total)} for e in prof.key_averages()]
    meta = {"steps": args.steps, "wall_ms": wall_ms, "profiled_ms": profiled_ms,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "dtype": "float32" if args.fp32 else "bfloat16", "enc_lite": args.enc_lite,
            "batch": args.batch}
    with open(os.path.join(logdir, "ops.json"), "w") as f:
        json.dump({"meta": meta, "rows": rows}, f)
    print(f"per-step wall: {wall_ms:.3f} ms ({meta['device']}, {meta['dtype']}, "
          f"batch {args.batch})", flush=True)
    return meta


def report(logdir: str, top: int = 40) -> dict:
    """The breakdown of `logdir/ops.json`: {"source", "total_us", "by_category"
    (us), "top" [(name, category, us)], "ops_per_step", "busy_share" (None
    without a device)}, printed."""
    with open(os.path.join(logdir, "ops.json")) as f:
        saved = json.load(f)
    meta, rows = saved["meta"], saved["rows"]
    device_rows = [r for r in rows if r["device"] == "cuda" and not r["user_annotation"]
                   and r["self_device_us"] > 0]
    if device_rows:
        source, key, used = "device", "self_device_us", device_rows
    else:
        source, key = "host (no device in this profile)", "self_cpu_us"
        used = [r for r in rows if r["device"] == "cpu" and not r["user_annotation"]
                and r["self_cpu_us"] > 0]
    used = sorted(used, key=lambda r: -r[key])
    total = sum(r[key] for r in used)
    by_cat: dict = {}
    for r in used:
        by_cat[category(r["name"])] = by_cat.get(category(r["name"]), 0.0) + r[key]
    steps = meta["steps"]
    ops_per_step = sum(r["count"] for r in used) / steps
    busy = total / 1e3 / meta["profiled_ms"] if device_rows else None
    print(f"total {source} self time: {total:.1f} us over {steps} steps "
          f"({total / steps / 1e3:.3f} ms a step; {meta['device']})")
    print(f"{source} ops a step: {ops_per_step:.1f}; busy share: "
          + ("not measured" if busy is None else f"{busy * 100:.2f} % of "
             f"{meta['profiled_ms'] / steps:.3f} ms a profiled step"))
    print("\n-- by category --")
    for cat, us in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"{us / max(total, 1e-30) * 100:6.2f}%  {us:12.1f} us  {cat}")
    print("\n-- top ops --")
    top_rows = [(r["name"], category(r["name"]), r[key]) for r in used[:top]]
    for name, cat, us in top_rows:
        print(f"{us / max(total, 1e-30) * 100:6.2f}%  {us:12.1f} us  {cat:24s} {name[:90]}")
    msda = sum(us for cat, us in by_cat.items() if cat.startswith("msda: "))
    out = {"source": source, "total_us": total, "by_category": by_cat, "top": top_rows,
           "ops_per_step": ops_per_step, "busy_share": busy,
           "msda_share": msda / total if total else 0.0, "meta": meta}
    print(json.dumps({k: v for k, v in out.items() if k != "top"}), flush=True)
    return out


def get_args_parser():
    from uvhand_tpu_torch.bench import get_args_parser as widths

    ap = argparse.ArgumentParser("uvhand_tpu_torch.scripts.profile_step", parents=[widths()],
                                 add_help=False, description=__doc__.split("\n\n")[0])
    ap.add_argument("--logdir", default=os.path.join("build", "profile_step"))
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--enc_lite", action="store_true")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--trace", action="store_true", help="also write the Chrome trace")
    ap.add_argument("--report-only", dest="report_only", action="store_true")
    return ap


def main(argv=None) -> dict:
    args = get_args_parser().parse_args(argv)
    if not args.report_only:
        capture(args, args.logdir)
    return report(args.logdir, args.top)


if __name__ == "__main__":
    main()
