"""The MSDA op alone at the encoder's shape: port of `scripts/bench_msda.py`.

    python -m uvhand_tpu_torch.scripts.bench_msda [--impl kernel|plain]
        [--dtype float32|bfloat16] [--mode fwd|grad|both] [--local]
        [--batch 16] [--lq 1045] [--steps 10] [--device cpu]

The encoder's self-attention call: B=16, Lq = S = 1045 (224x224 at strides
8..64: levels 28x28, 14x14, 7x7, 4x4), M=8, D=32, L=4, P=4. The inputs are
the TPU script's draws, in its order from numpy `default_rng(0)`: the value
(standard normal), the locations (uniform in [0, 1), or with `--local` and
Lq = S each query's cell centre on its level plus N(0, 0.03) offsets, the
encoder's layout), the attention (uniform, normalised over L*P in the
type). A call's value varies with the call, v + 0.001 * i, as in the TPU
script's scan. `--impl kernel` (the TPU script's `pallas`) runs the
hand-written kernels through `ms_deform_attn(impl="auto")`: the staged
forward (K1) and the staged backward, bf16 (K2) or float32 (K3), as
`msda_cuda.staged_plan` picks; `--impl plain` (its `xla`) the plain
versions.

It prints, for the forward (`fwd`) and for the forward and the gradients
of `out.mean()` with respect to the value, the locations and the attention
(`fwd+bwd`): the time a call as launched (`measure.median_ms`: CUDA
events), the card's busy time a call (the profiler, from a session that
recorded every MSDA kernel the calls launched),
and the bound (`measure.msda_bound_ms`, plus `msda_bwd_bound_ms` for the
backward); then `max |kernel - plain|` of the output and of each gradient
on the same inputs (the TPU script's `max |pallas - xla|`), absolute and
relative to the plain version's largest magnitude. The last line is the
same as JSON, with the number of op calls a route made (`calls`), from
which each kernel's launches follow: one staged forward a call, and one
staged backward a `grad` call. On the CPU (`--device cpu`) both routes are
the plain version, the times are the host's, and there is no device time.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

SHAPES = ((28, 28), (14, 14), (7, 7), (4, 4))
M, D, L, P = 8, 32, 4, 4
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
WARMUP = 3


def draw_inputs(batch: int, lq: int, local: bool, seed: int = 0):
    """The TPU script's draws (`scripts/bench_msda.py:40-60`) as numpy
    arrays: value (B, S, M, D) float64, locations (B, Lq, M, L, P, 2)
    float32, attention (B, Lq, M, L, P) float64, unnormalised."""
    S = sum(h * w for h, w in SHAPES)
    rng = np.random.default_rng(seed)
    value = rng.standard_normal((batch, S, M, D))
    if local and lq == S:
        refs = []
        for h, w in SHAPES:
            rr, cc = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
            refs.append(np.stack([(cc.ravel() + 0.5) / w, (rr.ravel() + 0.5) / h], -1))
        refs = np.concatenate(refs)  # (S, 2)
        off = rng.normal(scale=0.03, size=(batch, lq, M, L, P, 2))
        loc = (refs[None, :, None, None, None, :] + off).astype(np.float32)
    else:
        loc = rng.uniform(0, 1, (batch, lq, M, L, P, 2)).astype(np.float32)
    attn = rng.uniform(0, 1, (batch, lq, M, L, P))
    return value, loc, attn


def op_inputs(batch, lq, local, dtype, device):
    """The op's tensors: the value and the attention in `dtype` (the
    attention normalised in it, as the TPU script does), float32 locations."""
    value, loc, attn = draw_inputs(batch, lq, local)
    B = value.shape[0]
    a = torch.as_tensor(attn, dtype=dtype, device=device)
    a = a / a.reshape(B, lq, M, -1).sum(-1).reshape(B, lq, M, 1, 1)
    return (torch.as_tensor(value, dtype=dtype, device=device),
            torch.as_tensor(loc, device=device), a)


class Calls:
    """The op's calls by route, so that a caller can hold the kernels'
    launch counts against them."""

    def __init__(self):
        self.fwd = self.grad = 0


def forward(value, loc, attn, impl):
    from uvhand_tpu_torch.ops.msda import ms_deform_attn

    return ms_deform_attn(value, SHAPES, loc, attn, impl=impl)


def gradients(value, loc, attn, impl):
    """The gradients of out.mean() with respect to value, locations and
    attention."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (value, loc, attn)]
        out = forward(*leaves, impl).float().mean()
        return torch.autograd.grad(out, leaves)


def device_ms(fn, iters, msda_per_call):
    """The card's busy time a call of `fn` (every kernel, copy and fill that
    `iters` calls launch, from torch.profiler, over `iters`), from a session
    that recorded every MSDA kernel the calls launched (`msda_per_call`
    each); None after three sessions short of them. A session now and then
    comes back with few or none of the card's records, and a partial one
    would read as a short time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        if rows and sum(e.count for e in rows if "msda_" in e.key) == iters * msda_per_call:
            return sum(e.self_device_time_total for e in rows) / 1e3 / iters
    return None


def timed(fn, device, steps, msda_per_call):
    """(ms a call as launched, device ms a call or None): CUDA events and the
    profiler on the card; the host clock on the CPU (no device time)."""
    from uvhand_tpu_torch.scripts.measure import median_ms

    if device.type == "cuda":
        return median_ms(fn, iters=steps, warmup=WARMUP), device_ms(fn, steps, msda_per_call)
    for _ in range(WARMUP):
        fn()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    return (time.perf_counter() - t0) / steps * 1e3, None


def max_errors(got, want):
    """(max |got - want|, that over max |want|) of one tensor."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(float(want.float().abs().max()), 1e-30)


def run(args) -> dict:
    from uvhand_tpu_torch.device import resolve_device
    from uvhand_tpu_torch.scripts.measure import msda_bound_ms, msda_bwd_bound_ms

    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    impl = {"kernel": "auto", "plain": "torch"}[args.impl]
    value, loc, attn = op_inputs(args.batch, args.lq, args.local, dtype, device)
    calls = Calls()
    step = {"i": 0}

    def vary():
        step["i"] += 1
        return value + 0.001 * step["i"]

    def fwd_call():
        calls.fwd += impl == "auto"
        return forward(vary(), loc, attn, impl)

    def grad_call():
        calls.grad += impl == "auto"
        return gradients(vary(), loc, attn, impl)

    tag = f"{args.impl} {args.dtype}{' local' if args.local else ''}"
    res = {"impl": args.impl, "dtype": args.dtype, "local": args.local, "batch": args.batch,
           "lq": args.lq, "device": str(device)}
    calls.fwd += impl == "auto"
    out = forward(value, loc, attn, impl)
    res["bound_ms"], res["bound_by"] = msda_bound_ms(value, SHAPES, loc, attn)
    if args.mode in ("fwd", "both"):
        res["fwd_ms"], res["fwd_device_ms"] = timed(fwd_call, device, args.steps,
                                                    msda_per_call=impl == "auto")
        print(f"{tag} fwd: {res['fwd_ms']:.4f} ms/call, device "
              f"{_ms(res['fwd_device_ms'])} ms/call, bound {res['bound_ms']:.4f} ms "
              f"({res['bound_by']})", flush=True)
    if args.mode in ("grad", "both"):
        bwd_bound, res["bwd_bound_by"] = msda_bwd_bound_ms(value, SHAPES, loc, attn, out)
        res["grad_bound_ms"] = res["bound_ms"] + bwd_bound
        res["grad_ms"], res["grad_device_ms"] = timed(grad_call, device, args.steps,
                                                      msda_per_call=2 * (impl == "auto"))
        print(f"{tag} fwd+bwd: {res['grad_ms']:.4f} ms/call, device "
              f"{_ms(res['grad_device_ms'])} ms/call, bound {res['grad_bound_ms']:.4f} ms "
              f"(forward {res['bound_by']}, backward {res['bwd_bound_by']})", flush=True)

    # numerics: the kernel against the plain version on the same inputs
    calls.fwd += 1
    errs = {"out": max_errors(forward(value, loc, attn, "auto"),
                              forward(value, loc, attn, "torch"))}
    if args.mode in ("grad", "both"):
        calls.grad += 1
        kernel = gradients(value, loc, attn, "auto")
        plain = gradients(value, loc, attn, "torch")
        errs.update({k: max_errors(a, b) for k, a, b in zip(("dvalue", "dloc", "dattn"),
                                                            kernel, plain)})
    for k, (err, rel) in errs.items():
        print(f"max |kernel - plain| {k} = {err:.3e} ({rel:.3e} of the plain version's max)",
              flush=True)
    res["max_abs_err"] = {k: e for k, (e, _) in errs.items()}
    res["max_rel_err"] = {k: r for k, (_, r) in errs.items()}
    if device.type != "cuda":  # `calls` counts the kernel route's calls on the card
        calls.fwd = calls.grad = 0
    res["calls"] = {"fwd": calls.fwd, "grad": calls.grad}
    print(json.dumps(res), flush=True)
    return res


def _ms(x):
    return "not measured" if x is None else f"{x:.4f}"


def get_args_parser():
    ap = argparse.ArgumentParser("uvhand_tpu_torch.scripts.bench_msda",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--impl", default="kernel", choices=["kernel", "plain"])
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lq", type=int, default=1045)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--mode", default="both", choices=["fwd", "grad", "both"])
    ap.add_argument("--local", action="store_true",
                    help="the encoder's locations: each query's cell centre plus small "
                         "offsets (Lq must be S); default uniform")
    ap.add_argument("--device", default=None, help="cuda (the default: the card) or cpu")
    return ap


def main(argv=None) -> dict:
    return run(get_args_parser().parse_args(argv))


if __name__ == "__main__":
    main()
