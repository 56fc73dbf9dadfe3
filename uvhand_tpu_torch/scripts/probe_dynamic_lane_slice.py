"""Lane-slice probe on the card: port of `scripts/probe_dynamic_lane_slice.py`.

    python -m uvhand_tpu_torch.scripts.probe_dynamic_lane_slice [--device DEV]

The TPU probe asked whether a Mosaic kernel could cut head m's window of
W = 16 lanes at a run-time offset m * W out of the natural (Q, M * W) layout.
Its function is out[m * Q + q, w] = 2 * x[q, m * W + w], a (Q, M, W) ->
(M, Q, W) relayout times two, at Q = 1048, M = 8. A Hopper thread can load
any address, so the question has no counterpart here; the kernels
(`csrc/probe_lane_slice.cu`: 16-byte vectors, `vec4`, where W % 4 == 0 and
the data are aligned, else one float a thread, `general`) measure the
relayout as one pass.

Two cases: the probe's own shape, Q = 1048 (1.07 MB, a 0.32 us byte bound,
below any launch's device time), and the MSDA call site's per-head
relayout that the probe stood for, (B*M, Lq, 16) at B = 16: Q = 16 x 1048
(17.2 MB, a 5.13 us byte bound). Each case is checked exactly against the
probe's own numpy expression, through the plan's kernel and through each
kernel. Then the two kernels are timed in turns (vec4, general, general,
vec4), with the plain version, one PyTorch call that computes the same
function (`torch.mul` of the transposed view into a contiguous output) and
the launch floor: an empty kernel on the vec4 kernel's grid, the least
device time such a launch takes. Each cycles through the same 8 inputs
(69 MB at the call site, more than the 50 MB L2, so its reads come from
device memory). Each is timed twice: its device time (torch.profiler over
50 calls after 5, the kernels' own time; a kernel's is the lower of its two
turns), and its time per call as launched (CUDA events around each call,
median), which the host's work paces at these sizes. On the CPU
(`--device cpu`) it only checks the plain version; the timing needs a card.
"""

from __future__ import annotations

import argparse
from collections import Counter

import numpy as np
import torch

from uvhand_tpu_torch.device import resolve_device
from uvhand_tpu_torch.ops import msda_cuda, probes
from uvhand_tpu_torch.scripts.measure import bound_ms, device_ms, lower, median_ms, us

M, Q, W = 8, 1048, 16  # heads, queries, a head's window (scripts/probe_dynamic_lane_slice.py:30)
#: (name, Q): the probe's shape, and the MSDA call site's at B = 16
CASES = (("probe", Q), ("call site B=16", 16 * Q))
KINDS = tuple(msda_cuda.LANE_SLICE_KINDS)  # vec4, general: timed in turns
INPUTS = 8
ITERS, WARMUP = 50, 5


def lane_bound(q, m=M, w=W):
    """(ms, "bytes"): the least time of one call on the card, x read once
    and out written once (float32) over device memory's rate."""
    return bound_ms(2 * q * m * w * 4, 0)


def judge(ms, bound, floor):
    """How a device time reads beside the byte bound and the launch floor. A
    time under the bound means L2 served the reads: it is no share of the
    bound."""
    if ms is None:
        return "not measured"
    text = ("under the byte bound: L2 served it (no share of the bound)" if ms < bound
            else f"{bound / ms:.1%} of the byte bound")
    return text + ("" if floor is None
                   else f", {(ms - floor) * 1e3:+.2f} us over the launch floor")


def run(device=None, cases=CASES, log=print):
    """Check and (on the card) time the probe -> its numbers: `cases` (one
    row each), `calls` the kernel launches it made, `calls_by_kind` the same
    by kernel name (probe_lane_slice_<kind>), `max_abs_err`."""
    device = resolve_device(device)
    rows, calls = [], Counter()
    for name, q in cases:
        x_np = np.random.default_rng(0).standard_normal((q, M * W)).astype(np.float32)
        x = torch.from_numpy(x_np).to(device)
        want = x_np.reshape(q, M, W).transpose(1, 0, 2).reshape(M * q, W) * 2.0
        out = probes.lane_slice(x, M, W)
        err = float(np.abs(out.cpu().numpy() - want).max())
        label = f"{name} Q={q}"
        log(f"[lane-slice] {label} {device.type}: out {tuple(out.shape)}, max err {err} "
            "(must be 0)")
        if err != 0.0:
            raise AssertionError(f"lane slice disagrees with the probe's numpy expression: {err}")
        row = dict(case=label, Q=q, max_abs_err=err)
        rows.append(row)
        if device.type != "cuda":
            continue
        plan = msda_cuda.lane_slice_plan(q, M, W)
        calls[f"probe_lane_slice_{plan}"] += 1  # the check above
        for kind in KINDS:
            calls[f"probe_lane_slice_{kind}"] += 1
            if not torch.equal(msda_cuda._launch_lane_slice(kind, x, M, W), out):
                raise AssertionError(f"the {kind} lane-slice kernel differs ({label})")
        xs = [x + 0.001 * i for i in range(INPUTS)]
        dst = torch.empty(M * q, W, device=device)

        def kernel(kind):
            def call(i):
                calls[f"probe_lane_slice_{kind}"] += 1
                return msda_cuda._launch_lane_slice(kind, xs[i % INPUTS], M, W)
            return call

        fns = {
            **{kind: kernel(kind) for kind in KINDS},
            "plain": lambda i: probes.lane_slice_torch(xs[i % INPUTS], M, W),
            "library": lambda i: torch.mul(xs[i % INPUTS].view(q, M, W).transpose(0, 1), 2.0,
                                           out=dst.view(M, q, W)),
            "floor": lambda i: msda_cuda.lane_slice_floor_cuda(xs[i % INPUTS], M, W),
        }
        times = {key: [] for key in fns}
        for key in KINDS + KINDS[::-1] + ("plain", "library", "floor"):
            k = iter(range(1 << 30))
            times[key].append((device_ms(lambda: fns[key](next(k)), ITERS, WARMUP),
                               median_ms(lambda: fns[key](next(k)), ITERS, WARMUP)))
        fns["library"](0)
        if not torch.equal(dst, out):
            raise AssertionError(f"torch.mul's relayout differs from the kernel's ({label})")
        bound, by = lane_bound(q)
        ms = {key: lower(t[0] for t in ts) for key, ts in times.items()}
        launched = {key: lower(t[1] for t in ts) for key, ts in times.items()}
        row.update(bound_ms=bound, bound_by=by, floor_ms=ms["floor"], plain_ms=ms["plain"],
                   library_ms=ms["library"], launched_ms=launched,
                   kinds={kind: dict(ms=ms[kind], launched_ms=launched[kind],
                                     reads=judge(ms[kind], bound, ms["floor"]))
                          for kind in KINDS})
        log(f"[lane-slice] {label} device time per call (kinds in turns "
            + ", ".join(KINDS + KINDS[::-1]) + ", the lower of two): "
            + "; ".join(f"{kind} {us(ms[kind])} ({row['kinds'][kind]['reads']})"
                        for kind in KINDS)
            + f"; bound {bound * 1e3:.3f} us ({by}); launch floor (an empty kernel on vec4's "
            f"grid) {us(ms['floor'])}; plain {us(ms['plain'])}; torch.mul into a contiguous "
            f"output {us(ms['library'])} ({judge(ms['library'], bound, ms['floor'])})")
        log(f"[lane-slice] {label} per call as launched (CUDA events, paced by the host): "
            + ", ".join(f"{key} {us(launched[key])}" for key in fns))
        del xs, dst
    return dict(cases=rows, calls=sum(calls.values()), calls_by_kind=calls,
                max_abs_err=max(r["max_abs_err"] for r in rows))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="cuda (default) or cpu (check only)")
    run(parser.parse_args(argv).device)


if __name__ == "__main__":
    main()
