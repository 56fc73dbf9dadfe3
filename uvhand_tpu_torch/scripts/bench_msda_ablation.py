"""MSDA backward ablation bench on the card: port of
`scripts/bench_msda_ablation.py`.

    python -m uvhand_tpu_torch.scripts.bench_msda_ablation [--check] [--fp32]
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
from uvhand_tpu_torch.scripts.measure import (BF16_TC_OPS_PER_S, FP32_OPS_PER_S, bound_ms,
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


def compare(variant, outs, refs):
    """[(output, max|delta|, rel, tol, ok)] of a kernel's outputs against its
    plain version's: exact where the kernel keeps the plain version's order,
    else within TOL of the output's max."""
    route = VARIANTS[variant][0]
    rows = []
    for name, o, r in zip(ROUTES[route][2], outs, refs):
        err = float((o.double() - r.double()).abs().max())
        rel = err / max(float(r.double().abs().max()), 1e-30)
        tol = TOL[o.dtype] if name in ORDERED.get(route, ()) else 0.0
        ok = (o.dtype == r.dtype and o.shape == r.shape
              and bool(torch.isfinite(o.double()).all()) and rel <= tol)
        rows.append((name, err, rel, tol, ok))
    return rows


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
        for name, err, rel, tol, ok in compare(variant, outs, refs):
            line = (f"{variant:10s} {name:6s} max|delta| vs plain = {err:.2e} (rel {rel:.1e}, "
                    f"tol {tol:.0e})")
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
    # operations each, on the tensor cores in bf16
    B, S, M, D = value.shape
    ops = 4 * B * M * loc.shape[1] * S * D
    rate = BF16_TC_OPS_PER_S if value.dtype == torch.bfloat16 else FP32_OPS_PER_S
    return bound_ms(nbytes(value, loc, attn, g, *outs), ops, rate)


def xdot_kernel_bound(x, G, outs):
    """(ms, by) for the `msda_xdot` kernel alone: the ws plane written, the
    locations and attention read, the per-point outputs written, and of G
    the entries at this run's in-map corners."""
    dpy, dpx, daw, ws = outs
    corners = in_map_corners(x["shapes"], x["loc"])
    return bound_ms(nbytes(x["loc"], x["attn"], dpy, dpx, daw, ws)
                    + corners * G.element_size(), 0)


def onlyg_library(x):
    """`onlyg`'s dvalue by two `torch.matmul` calls (the library's yardstick
    for the dense kernel; nothing of the port calls it): G = g v^T rounded to
    the value's type, then round(G)^T g in float32."""
    B, S, M, D = x["value"].shape
    G = msda_ablation.dense_plane(x["value"], x["g"])
    g = x["g"].reshape(B, -1, M, D).permute(0, 2, 1, 3).reshape(B * M, -1, D)
    return torch.matmul(G.transpose(1, 2).float(), g.float())


def bench(variants, dtype=torch.bfloat16, device=None, log=print):
    """Times each variant on the card at the TPU script's shapes. Returns
    ({variant: numbers}, card calls by variant, and the `msda_xdot` kernel's
    own numbers when xdot ran)."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("the timing mode measures the card; on the CPU run --check")
    x = make_inputs(BENCH_SHAPES, **BENCH_DIMS, dtype=dtype, device=device, seed=0,
                    lo=0.0, hi=1.0)
    # each call samples elsewhere, as the TPU script moves py by 1e-4 a step
    locs = [x["loc"] + 1e-4 * i for i in range(ITERS + WARMUP)]
    calls, results, xdot_kernel = Counter(), {}, None
    for variant in variants:
        outs = run(variant, x)
        refs = run(variant, x, impl="torch")
        torch.cuda.synchronize()
        errs = compare(variant, outs, refs)
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
        if VARIANTS[variant][0] == "xdot":
            G = msda_ablation.dense_plane(x["value"], x["g"])
            k_outs = msda_cuda.ms_deform_attn_xdot_cuda(G, x["shapes"], x["loc"], x["attn"])
            k_refs = msda_ablation.xdot_torch(G, x["shapes"], x["loc"], x["attn"])
            torch.cuda.synchronize()
            k_err = max(float((o.double() - r.double()).abs().max())
                        for o, r in zip(k_outs, k_refs))
            k_ms = median_ms(lambda: msda_cuda.ms_deform_attn_xdot_cuda(
                G, x["shapes"], next(cycle), x["attn"]), ITERS, WARMUP)
            k_plain = median_ms(lambda: msda_ablation.xdot_torch(
                G, x["shapes"], x["loc"], x["attn"]), iters=1, warmup=0)
            calls["xdot_kernel"] += 1 + ITERS + WARMUP
            k_bound, k_by = xdot_kernel_bound(x, G, k_outs)
            xdot_kernel = dict(ms=k_ms, plain_ms=k_plain, bound_ms=k_bound, bound_by=k_by,
                               max_abs_err=k_err, ok=k_err == 0.0)
            log(f"{'':10s}  the msda_xdot kernel alone: {k_ms:8.4f} ms/call, bound "
                f"{k_bound:.4f} ms ({k_by}), plain {k_plain:.3f} ms, max|delta| {k_err:.2e}")
            del G, k_outs, k_refs
        del outs, refs
        torch.cuda.empty_cache()
    bad = [v for v, r in results.items() if not r["ok"]]
    if xdot_kernel is not None and not xdot_kernel["ok"]:
        bad.append("msda_xdot")
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    return results, calls, xdot_kernel


def card_launches(calls: Counter) -> Counter:
    """The kernel launches that check's or bench's card calls (by variant,
    and "xdot_kernel" for `msda_xdot` timed alone) made."""
    out = Counter()
    for variant, n in calls.items():
        out["msda_xdot" if variant == "xdot_kernel" else ROUTES[VARIANTS[variant][0]][0]] += n
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--check", action="store_true",
                        help="hold each variant's kernel against its plain version")
    parser.add_argument("--fp32", action="store_true", help="time in float32 (default bf16)")
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
    bench(args.variants or TIMED_DEFAULT, torch.float32 if args.fp32 else torch.bfloat16,
          args.device)


if __name__ == "__main__":
    main()
