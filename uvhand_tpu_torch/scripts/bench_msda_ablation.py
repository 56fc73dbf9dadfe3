"""MSDA backward ablation bench on the card: port of
`scripts/bench_msda_ablation.py`.

    python -m uvhand_tpu_torch.scripts.bench_msda_ablation [--check | --kinds] [--fp32]
        [--device DEV] [variant ...]

The TPU bench timed stripped and restructured bodies of its MSDA kernels to
find where Mosaic spent its time. This one runs every variant name of that
script on the card, each through its Hopper counterpart, and times it, so
that the gather backward (`csrc/msda_bwd.cu`) splits into what each of its
outputs costs:

  full matred signfree fused   the gather backward, every output
                               (`msda_ablate_bwd`; matred, signfree and
                               fused differ from full only in how Mosaic
                               reduced or selected)
  eqgate eqred                 full with the equality tent gate (differs
                               from full at integer-exact coordinates)
  nodpy nodaw nodv             full without dpy/dpx (they return the
                               attention), without daw (likewise), or
                               without dvalue (zeros; no atomics)
  onlyg                        the dense floor: G = g v^T over every token,
                               dvalue = round(G)^T g, daw = G at level 0's
                               first L*P tokens (`msda_onlyg`)
  xdot xdotred                 G by a GEMM, the per-point work and the
                               weight plane ws (`msda_xdot`), dvalue = ws^T g
                               by a GEMM
  sep sepx sep2 sepT           other TPU layouts of the full backward: the
                               production kernel `msda_bwd`
  bwdfac                       the factorized backward: `msda_fac_bwd`
  fwd fwdsepx fwdT             the forward: `msda_fwd`
  fwdfac                       the factorized forward: `msda_fac_fwd`

`--kinds` times the tiled and the general `msda_onlyg` kernel in turns on
the same inputs at the bench shapes, and the `msda_xdot` kernel alone (G
made before), each held against its plain version (`kinds_ab`).

`--check` holds each variant's kernel against its plain version at the TPU
script's check shapes (levels 6x6, 3x3, 2x2; B=2, M=2, D=32, P=4, Lq=S=49;
in float32, then in bf16) and prints max|delta| per output, and for the
backward variants also against `full`'s plain version (the TPU script's
comparison: the nod*/onlyg variants differ by design). On the CPU
(`--device cpu`) a variant's route is its plain version, so only that second
comparison says anything there.

The default mode times each variant on the card at the TPU script's shapes
(levels 28x28, 14x14, 7x7, 4x4; B=16, M=8, D=32, L=P=4, Lq=S=1045; bf16
unless --fp32): the median of 10 calls after 3 warm-up calls, each call on
other sampling locations, CUDA events around each; the variant's bound, its
plain version's time and the largest difference from it. value and g (17 MB
each in float32) fit in the card's 50 MB L2, so these are warm-L2 times. The
timing mode needs a card.

Without a card and without `--device cpu` it raises.
"""

from __future__ import annotations

import argparse
import itertools
from collections import Counter

import torch

from uvhand_tpu_torch.device import resolve_device
from uvhand_tpu_torch.ops import msda_ablation, msda_cuda
from uvhand_tpu_torch.ops.msda import (ms_deform_attn_fac_torch,
                                       ms_deform_attn_fac_torch_backward, ms_deform_attn_torch,
                                       ms_deform_attn_torch_backward)
from uvhand_tpu_torch.scripts.measure import (BF16_TC_OPS_PER_S, FP32_OPS_PER_S,
                                              HBM_BYTES_PER_S, bound_ms, device_ms,
                                              in_map_corners, median_ms, msda_bound_ms,
                                              msda_bwd_bound_ms, nbytes)

CHECK_SHAPES = ((6, 6), (3, 3), (2, 2))  # scripts/bench_msda_ablation.py:1252-1256
CHECK_DIMS = dict(B=2, M=2, D=32, P=4)
BENCH_SHAPES = ((28, 28), (14, 14), (7, 7), (4, 4))  # :1302-1305
BENCH_DIMS = dict(B=16, M=8, D=32, P=4)
TIMED_DEFAULT = ["full", "onlyg", "nodpy", "nodaw", "nodv", "matred", "signfree", "fused"]
CHECK_DEFAULT = ["sep"]

#: variant: (route, options); a route is one of ROUTES
VARIANTS = {
    "full": ("ablate", dict(out="full", gate="where")),
    "matred": ("ablate", dict(out="full", gate="where")),
    "signfree": ("ablate", dict(out="full", gate="where")),
    "fused": ("ablate", dict(out="full", gate="where")),
    "eqgate": ("ablate", dict(out="full", gate="eq")),
    "eqred": ("ablate", dict(out="full", gate="eq")),
    "nodpy": ("ablate", dict(out="nodpy", gate="where")),
    "nodaw": ("ablate", dict(out="nodaw", gate="where")),
    "nodv": ("ablate", dict(out="nodv", gate="where")),
    "onlyg": ("onlyg", {}),
    "xdot": ("xdot", {}),
    "xdotred": ("xdot", {}),
    "sep": ("bwd", {}),
    "sepx": ("bwd", {}),
    "sep2": ("bwd", {}),
    "sepT": ("bwd", {}),
    "bwdfac": ("fac_bwd", {}),
    "fwd": ("fwd", {}),
    "fwdsepx": ("fwd", {}),
    "fwdT": ("fwd", {}),
    "fwdfac": ("fac_fwd", {}),
}
#: the TPU kernel's `pallas_call` each variant replaces, in scripts/bench_msda_ablation.py
REPLACES = {
    **{v: ":1215" for v in ("full", "matred", "signfree", "fused", "eqgate", "eqred", "nodpy",
                            "nodaw", "nodv", "onlyg")},
    "xdot": ":1182", "xdotred": ":1182", "sep": ":806", "sepx": ":231", "sep2": ":981",
    "sepT": ":757", "bwdfac": ":456", "fwd": ":562", "fwdsepx": ":562", "fwdT": ":729",
    "fwdfac": ":345",
}
#: route: (the kernel it launches, that kernel's wrapper, its output names)
ROUTES = {
    "ablate": ("msda_ablate_bwd", msda_cuda.ms_deform_attn_ablate_backward_cuda,
               ("dv", "dpy", "dpx", "daw")),
    "onlyg": ("msda_onlyg", msda_cuda.ms_deform_attn_onlyg_cuda, ("dv", "dpy", "dpx", "daw")),
    "xdot": ("msda_xdot", msda_cuda.ms_deform_attn_xdot_cuda, ("dv", "dpy", "dpx", "daw")),
    "bwd": ("msda_bwd", msda_cuda.ms_deform_attn_backward_cuda, ("dvalue", "dloc", "dattn")),
    "fac_bwd": ("msda_fac_bwd", msda_cuda.ms_deform_attn_fac_backward_cuda,
                ("dvalue", "dloc", "dattn")),
    "fwd": ("msda_fwd", msda_cuda.ms_deform_attn_cuda, ("out",)),
    "fac_fwd": ("msda_fac_fwd", msda_cuda.ms_deform_attn_fac_cuda, ("out",)),
}
#: outputs summed in another order than the plain version's (float32
#: atomics, or a GEMM), held within a tolerance of their max; every other
#: output must equal the plain version's exactly
ORDERED = {"ablate": {"dv"}, "onlyg": {"dv"}, "xdot": {"dv"}, "bwd": {"dvalue"},
           "fac_bwd": {"dvalue"}}
#: a float32 sum in another order: 1e-5 of the max; rounded to bf16 afterwards
#: (the landed backwards' dvalue in bf16): 2e-2
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
#: `msda_onlyg`'s dvalue for a bf16 value: the tiled kernel's G, summed on the
#: tensor cores, can round to another bf16 than the plain version's
#: sequential G (one last-bit step), so dvalue differs by 7e-5 (the bench
#: shapes) to 1.8e-4 (the card tests' decoder case) of its max on the H100.
#: A kernel that skips round_T (G kept in float32, `onlyg_unrounded_rel`)
#: is off by more than this on every such input
ONLYG_BF16_TOL = 2.5e-4
ITERS, WARMUP = 10, 3  # the timing mode's calls of each variant


def make_inputs(shapes, B, M, D, P, dtype, device, seed, lo, hi):
    """Seeded inputs as the TPU script makes them: value and g normal, the
    locations uniform in [lo, hi), the attention uniform in [0, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    S = sum(h * w for h, w in shapes)
    L, Lq = len(shapes), S
    value = torch.randn(B, S, M, D, generator=gen, device=device).to(dtype)
    loc = lo + (hi - lo) * torch.rand(B, Lq, M, L, P, 2, generator=gen, device=device)
    attn = torch.rand(B, Lq, M, L, P, generator=gen, device=device).to(dtype)
    g = torch.randn(B, Lq, M * D, generator=gen, device=device).to(dtype)
    return dict(value=value, shapes=shapes, loc=loc, attn=attn, g=g)


def run(variant, x, impl="auto"):
    """One call of `variant` on the inputs `x`: its kernel (impl='auto' on a
    CUDA tensor) or its plain version (impl='torch', or a CPU tensor)."""
    route, opts = VARIANTS[variant]
    args = (x["value"], x["shapes"], x["loc"], x["attn"])
    on_card = impl == "auto" and x["value"].is_cuda
    if route == "ablate":
        return msda_ablation.ablate_backward(*args, x["g"], impl=impl, **opts)
    if route == "onlyg":
        return msda_ablation.onlyg(*args, x["g"], impl=impl)
    if route == "xdot":
        return msda_ablation.xdot_backward(*args, x["g"], impl=impl)
    wrapper = ROUTES[route][1]
    plain = {"bwd": ms_deform_attn_torch_backward, "fac_bwd": ms_deform_attn_fac_torch_backward,
             "fwd": ms_deform_attn_torch, "fac_fwd": ms_deform_attn_fac_torch}[route]
    fn = wrapper if on_card else plain
    return fn(*args, x["g"]) if route in ("bwd", "fac_bwd") else (fn(*args),)


def held(names, outs, refs, tols):
    """[(output, max|delta|, rel, tol, ok)] of outputs against references,
    each within its tolerance (`tols`, by name; 0 elsewhere: exact) of the
    reference's max."""
    rows = []
    for name, o, r in zip(names, outs, refs):
        err = float((o.double() - r.double()).abs().max())
        rel = err / max(float(r.double().abs().max()), 1e-30)
        tol = tols.get(name, 0.0)
        ok = (o.dtype == r.dtype and o.shape == r.shape
              and bool(torch.isfinite(o.double()).all()) and rel <= tol)
        rows.append((name, err, rel, tol, ok))
    return rows


def tolerances(route, outs, dtype):
    """The tolerance of each output of a route's kernel that sums in another
    order than its plain version (ORDERED), for a value of type `dtype`."""
    names = ROUTES[route][2]
    return {name: ONLYG_BF16_TOL if route == "onlyg" and dtype == torch.bfloat16
            else TOL[o.dtype] for name, o in zip(names, outs) if name in ORDERED.get(route, ())}


def compare(variant, outs, refs, dtype):
    """[(output, max|delta|, rel, tol, ok)] of a kernel's outputs against its
    plain version's for a value of type `dtype`: exact where the kernel keeps
    the plain version's order, else within its tolerance of the output's
    max."""
    route = VARIANTS[variant][0]
    return held(ROUTES[route][2], outs, refs, tolerances(route, outs, dtype))


def check(variants, dtype=torch.float32, device=None, log=print):
    """Each variant's kernel against its plain version at the check shapes;
    returns (rows, card calls by variant). Raises if any output disagrees."""
    device = resolve_device(device)
    x = make_inputs(CHECK_SHAPES, **CHECK_DIMS, dtype=dtype, device=device, seed=1,
                    lo=-0.2, hi=1.2)
    full = run("full", x, impl="torch")
    calls, rows, bad = Counter(), [], []
    for variant in variants:
        outs = run(variant, x)
        calls[variant] += int(device.type == "cuda")
        refs = run(variant, x, impl="torch")
        if device.type == "cuda":
            torch.cuda.synchronize()
        route = VARIANTS[variant][0]
        for name, err, rel, tol, ok in compare(variant, outs, refs, dtype):
            line = (f"{variant:10s} {name:6s} max|delta| vs plain = {err:.2e} (rel {rel:.1e}, "
                    f"tol {tol:.1e})")
            if route in ("ablate", "onlyg", "xdot"):
                k = ROUTES[route][2].index(name)
                vs_full = float((outs[k].double() - full[k].double()).abs().max())
                line += f"; vs full {vs_full:.2e}"
            log(line + ("  ok" if ok else "  MISMATCH"))
            rows.append(dict(variant=variant, output=name, max_abs_err=err, rel=rel, ok=ok))
            if not ok:
                bad.append(f"{variant}.{name}")
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    return rows, calls


def variant_bound(variant, x, outs):
    """(ms, by) for one call of `variant` on `x` given its outputs."""
    route = VARIANTS[variant][0]
    value, shapes, loc, attn, g = x["value"], x["shapes"], x["loc"], x["attn"], x["g"]
    if route in ("fwd", "fac_fwd"):
        return msda_bound_ms(value, shapes, loc, attn)
    if route in ("bwd", "fac_bwd", "ablate"):
        return msda_bwd_bound_ms(value, shapes, loc, attn, g, outputs=outs)
    # onlyg and the whole xdot variant: two dense products of 2*BM*Lq*S*D
    # operations each, on the tensor cores in bf16; onlyg reads neither the
    # locations nor the attention
    B, S, M, D = value.shape
    ops = 4 * B * M * loc.shape[1] * S * D
    rate = BF16_TC_OPS_PER_S if value.dtype == torch.bfloat16 else FP32_OPS_PER_S
    reads = (value, g) if route == "onlyg" else (value, loc, attn, g)
    return bound_ms(nbytes(*reads, *outs), ops, rate)


def xdot_kernel_bound(x, G, outs):
    """(ms, by) for the `msda_xdot` kernel alone: the ws plane written, the
    locations and attention read, the per-point outputs written, and of G
    the entries at this run's in-map corners."""
    dpy, dpx, daw, ws = outs
    corners = in_map_corners(x["shapes"], x["loc"])
    return bound_ms(nbytes(x["loc"], x["attn"], dpy, dpx, daw, ws)
                    + corners * G.element_size(), 0)


def xdot_sector_ms(x, G, outs):
    """The `msda_xdot` kernel's bytes as the card moves them: as
    `xdot_kernel_bound`, but G counted in the 32-byte sectors that this
    run's in-map corners touch (each sector once), the granularity at which
    the card reads; over the memory rate, in ms. An estimate beside the
    bound, not a bound."""
    dpy, dpx, daw, ws = outs
    loc, shapes = x["loc"], x["shapes"]
    B, Lq, M = loc.shape[:3]
    S, elem = G.shape[-1], G.element_size()
    dev = loc.device
    # row (b, q, m) of the plane starts at ((b * M + m) * Lq + q) * S
    rows = ((torch.arange(B, device=dev).view(B, 1, 1) * M
             + torch.arange(M, device=dev).view(1, 1, M)) * Lq
            + torch.arange(Lq, device=dev).view(1, Lq, 1)) * S
    sectors, start = [], 0
    for lvl, (H, W) in enumerate(shapes):
        px = loc[:, :, :, lvl, :, 0] * W - 0.5
        py = loc[:, :, :, lvl, :, 1] * H - 0.5
        for dy in (0, 1):
            for dx in (0, 1):
                cx, cy = torch.floor(px) + dx, torch.floor(py) + dy
                valid = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
                flat = rows[..., None] + start + (cy * W + cx).long()
                sectors.append((flat[valid] * elem) // 32)
        start += H * W
    n = int(torch.unique(torch.cat(sectors)).numel())
    return (nbytes(loc, x["attn"], dpy, dpx, daw, ws) + 32 * n) / HBM_BYTES_PER_S * 1e3


def onlyg_library(x):
    """`onlyg`'s dvalue by two `torch.matmul` calls (the library's yardstick
    for the dense kernel; nothing of the port calls it): G = g v^T rounded to
    the value's type, then round(G)^T g in float32."""
    B, S, M, D = x["value"].shape
    G = msda_ablation.dense_plane(x["value"], x["g"])
    g = x["g"].reshape(B, -1, M, D).permute(0, 2, 1, 3).reshape(B * M, -1, D)
    return torch.matmul(G.transpose(1, 2).float(), g.float())


def onlyg_unrounded_rel(value, g, dvalue):
    """The control of `ONLYG_BF16_TOL`: max|dv' - dvalue| / max|dvalue|,
    where dv' is onlyg's dvalue from a G kept in float32 (round_T skipped),
    as a kernel that forgot the rounding would give, and `dvalue` the plain
    version's (B, S, M, D)."""
    B, S, M, D = value.shape
    v = value.float().permute(0, 2, 1, 3).reshape(B * M, S, D)
    g = g.float().reshape(B, -1, M, D).permute(0, 2, 1, 3).reshape(B * M, -1, D)
    dv = torch.matmul(torch.matmul(g, v.transpose(1, 2)).transpose(1, 2), g)
    ref = dvalue.permute(0, 2, 1, 3).reshape(B * M, S, D)
    return float((dv - ref).abs().max() / ref.abs().max())


def bench(variants, dtype=torch.bfloat16, device=None, log=print):
    """Times each variant on the card at the TPU script's shapes (the
    `msda_xdot` kernel alone: `kinds_ab`). Returns ({variant: numbers}, card
    calls by variant)."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("the timing mode measures the card; on the CPU run --check")
    x = make_inputs(BENCH_SHAPES, **BENCH_DIMS, dtype=dtype, device=device, seed=0,
                    lo=0.0, hi=1.0)
    # each call samples elsewhere, as the TPU script moves py by 1e-4 a step
    locs = [x["loc"] + 1e-4 * i for i in range(ITERS + WARMUP)]
    calls, results = Counter(), {}
    for variant in variants:
        outs = run(variant, x)
        refs = run(variant, x, impl="torch")
        torch.cuda.synchronize()
        errs = compare(variant, outs, refs, dtype)
        cycle = itertools.cycle(locs)
        ms = median_ms(lambda: run(variant, dict(x, loc=next(cycle))), ITERS, WARMUP)
        plain = median_ms(lambda: run(variant, x, impl="torch"), iters=1, warmup=0)
        calls[variant] += 1 + ITERS + WARMUP
        bound, by = variant_bound(variant, x, outs)
        results[variant] = dict(
            kernel=ROUTES[VARIANTS[variant][0]][0], ms=ms, plain_ms=plain, bound_ms=bound,
            bound_by=by, max_abs_err=max(e[1] for e in errs), ok=all(e[4] for e in errs),
            replaces="scripts/bench_msda_ablation.py" + REPLACES[variant])
        if VARIANTS[variant][0] == "onlyg":
            results[variant]["library_ms"] = median_ms(lambda: onlyg_library(x), ITERS, WARMUP)
            log(f"{'':10s}  two torch.matmul (G = g v^T rounded, round(G)^T g in float32; "
                f"yardstick only): {results[variant]['library_ms']:.4f} ms")
        log(f"{variant:10s}: {ms:8.4f} ms/call (median of {ITERS}, {ROUTES[VARIANTS[variant][0]][0]}),"
            f" bound {bound:.4f} ms ({by}), plain {plain:.3f} ms, max|delta| vs plain "
            + ", ".join(f"{n} {e:.2e}" for n, e, *_ in errs)
            + ("" if results[variant]["ok"] else "  MISMATCH"))
        del outs, refs
        torch.cuda.empty_cache()
    bad = [v for v, r in results.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    return results, calls


def kinds_ab(dtype=torch.bfloat16, device=None, log=print):
    """The tiled and the general `msda_onlyg` kernel (`msda_cuda.ONLYG_KINDS`)
    on the same inputs at the TPU script's shapes, and the `msda_xdot`
    kernel on G made before: each held against its plain version, then
    timed (the onlyg kinds in turns: tiled, general, general, tiled; ms: the
    lower of a kind's two CUDA-event medians, which include the wrapper's
    host work before the launch) and in device time (torch.profiler).
    Returns ({"msda_onlyg_<kind>" or "msda_xdot": numbers}, card calls by
    the same keys). Raises if any output disagrees."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("the timing mode measures the card; on the CPU run --check")
    x = make_inputs(BENCH_SHAPES, **BENCH_DIMS, dtype=dtype, device=device, seed=0, lo=0.0,
                    hi=1.0)
    G = msda_ablation.dense_plane(x["value"], x["g"])
    # each call samples elsewhere, as in bench (onlyg reads no location)
    cycle = itertools.cycle([x["loc"] + 1e-4 * i for i in range(ITERS + WARMUP)])
    calls = Counter()

    def onlyg(kind):
        return lambda loc: msda_cuda._launch_onlyg(kind, x["value"], x["shapes"], loc, x["attn"],
                                                   x["g"])

    ops = {  # key: (launch(loc), plain(), output names, route)
        **{f"msda_onlyg_{kind}": (onlyg(kind), lambda: msda_ablation.onlyg_torch(
            x["value"], x["shapes"], x["loc"], x["attn"], x["g"]), ROUTES["onlyg"][2], "onlyg")
           for kind in msda_cuda.ONLYG_KINDS},
        "msda_xdot": (lambda loc: msda_cuda.ms_deform_attn_xdot_cuda(G, x["shapes"], loc,
                                                                     x["attn"]),
                      lambda: msda_ablation.xdot_torch(G, x["shapes"], x["loc"], x["attn"]),
                      ("dpy", "dpx", "daw", "ws"), "xdot"),
    }

    def counted(key, loc):
        calls[key] += 1
        return ops[key][0](loc)

    def timed(key):
        return median_ms(lambda: counted(key, next(cycle)), ITERS, WARMUP)

    times = {key: [] for key in ops}
    tiled, general = (f"msda_onlyg_{kind}" for kind in msda_cuda.ONLYG_KINDS)
    for key in (tiled, general, general, tiled, "msda_xdot"):
        times[key].append(timed(key))
    results, bad, refs = {}, [], {}
    for key, (_, plain, names, route) in ops.items():
        if route not in refs:
            refs[route] = (plain(), median_ms(plain, iters=1, warmup=0))
        ref, plain_ms = refs[route]
        outs = counted(key, x["loc"])
        torch.cuda.synchronize()
        errs = held(names, outs, ref, tolerances(route, outs, dtype) if route == "onlyg" else {})
        dev = device_ms(lambda: counted(key, next(cycle)), ITERS, WARMUP)
        bound, by = (variant_bound("onlyg", x, outs) if route == "onlyg"
                     else xdot_kernel_bound(x, G, outs))
        r = results[key] = dict(ms=min(times[key]), device_ms=dev, plain_ms=plain_ms,
                                bound_ms=bound, bound_by=by, library_ms=None,
                                max_abs_err=max(e[1] for e in errs),
                                max_rel_err=max(e[2] for e in errs), ok=all(e[4] for e in errs))
        if route == "onlyg":
            r["library_ms"] = median_ms(lambda: onlyg_library(x), ITERS, WARMUP)
            r["library_device_ms"] = device_ms(lambda: onlyg_library(x), ITERS, WARMUP)
            # what the dv tolerance must reject: a kernel that skips round_T
            r["unrounded_rel"] = onlyg_unrounded_rel(x["value"], x["g"], ref[0])
        else:
            r["sector_ms"] = xdot_sector_ms(x, G, outs)
        log(f"{key:18s}: {r['ms']:.4f} ms/call (CUDA events, as launched), device "
            f"{'not measured' if dev is None else f'{dev:.4f}'} ms, bound "
            f"{bound:.4f} ms ({by}), plain {plain_ms:.3f} ms"
            + (f", two torch.matmul {r['library_ms']:.4f} ms (device "
               f"{r['library_device_ms'] or float('nan'):.4f})" if route == "onlyg"
               else f", G in 32-byte sectors {r['sector_ms']:.4f} ms (an estimate)")
            + ", max|delta| vs plain " + ", ".join(f"{n} {e:.2e} (rel {rel:.1e}, tol {t:.1e})"
                                                  for n, e, rel, t, _ in errs)
            + (f"; dv with G unrounded: rel {r['unrounded_rel']:.1e}" if route == "onlyg"
               else "")
            + ("" if r["ok"] else "  MISMATCH"))
        if not r["ok"]:
            bad.append(key)
        del outs
    del refs
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    return results, calls


def card_launches(calls: Counter) -> Counter:
    """The kernel launches that check's or bench's card calls (by variant)
    made."""
    out = Counter()
    for variant, n in calls.items():
        out[ROUTES[VARIANTS[variant][0]][0]] += n
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--check", action="store_true",
                        help="hold each variant's kernel against its plain version")
    parser.add_argument("--fp32", action="store_true", help="time in float32 (default bf16)")
    parser.add_argument("--kinds", action="store_true",
                        help="time the tiled and the general onlyg kernel, and the xdot kernel")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu (--check only)")
    parser.add_argument("variants", nargs="*", metavar="variant",
                        help="any of: " + " ".join(VARIANTS))
    args = parser.parse_args(argv)
    unknown = sorted(set(args.variants) - set(VARIANTS))
    if unknown:
        parser.error(f"unknown variants {unknown}")
    if args.check:
        for dtype in (torch.float32, torch.bfloat16):
            check(args.variants or CHECK_DEFAULT, dtype, args.device)
        return
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    if args.kinds:
        kinds_ab(dtype, args.device)
        return
    bench(args.variants or TIMED_DEFAULT, dtype, args.device)


if __name__ == "__main__":
    main()
