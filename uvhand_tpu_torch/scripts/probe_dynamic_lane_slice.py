"""Lane-slice probe on the card: port of `scripts/probe_dynamic_lane_slice.py`.

    python -m uvhand_tpu_torch.scripts.probe_dynamic_lane_slice [--device DEV]

The TPU probe asked whether a Mosaic kernel could cut head m's window of
W = 16 lanes at a run-time offset m * W out of the natural (Q, M * W) layout.
Its function is out[m * Q + q, w] = 2 * x[q, m * W + w], a (Q, M, W) ->
(M, Q, W) relayout times two, at Q = 1048, M = 8. A Hopper thread can load
any address, so the question has no counterpart here; the kernel
(`csrc/probe_lane_slice.cu`) measures the relayout as one pass.

It checks the kernel against the probe's own numpy expression exactly, then
times it beside its byte bound (0.32 us) and beside one PyTorch call that
computes the same function, `torch.mul` of the transposed view into a
contiguous output. Each of the three is timed over the same 8 inputs, one
after another: its device time (torch.profiler over 50 calls after 5, the
kernels' own time), and its time per call as launched (CUDA events around
each call, median). The call is far shorter than the host's work to launch
it, so the second is the launch's time, not the kernel's. On the CPU
(`--device cpu`) it only checks the plain version; the timing needs a card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from uvhand_tpu_torch.device import resolve_device
from uvhand_tpu_torch.ops import probes
from uvhand_tpu_torch.scripts.measure import bound_ms, device_ms, median_ms, nbytes, us

M, Q, W = 8, 1048, 16  # heads, queries, a head's window (scripts/probe_dynamic_lane_slice.py:30)
ITERS, WARMUP = 50, 5


def run(device=None, log=print):
    """Check and (on the card) time the probe -> its numbers, with `calls`
    the kernel launches it made."""
    device = resolve_device(device)
    x_np = np.random.default_rng(0).standard_normal((Q, M * W)).astype(np.float32)
    x = torch.from_numpy(x_np).to(device)
    out = probes.lane_slice(x, M, W)
    want = x_np.reshape(Q, M, W).transpose(1, 0, 2).reshape(M * Q, W) * 2.0
    err = float(np.abs(out.cpu().numpy() - want).max())
    log(f"[lane-slice] {device.type}: out {tuple(out.shape)}, max err {err} (must be 0)")
    if err != 0.0:
        raise AssertionError(f"lane slice disagrees with the probe's numpy expression: {err}")
    if device.type != "cuda":
        return dict(max_abs_err=err, calls=0)
    xs = [x + 0.001 * i for i in range(8)]
    dst = torch.empty(M * Q, W, device=device)
    fns = {
        "kernel": lambda i: probes.lane_slice(xs[i % 8], M, W),
        "plain": lambda i: probes.lane_slice_torch(xs[i % 8], M, W),
        "library": lambda i: torch.mul(xs[i % 8].view(Q, M, W).transpose(0, 1), 2.0,
                                       out=dst.view(M, Q, W)),
    }
    times = {}
    for name, fn in fns.items():
        k = iter(range(1 << 30))
        times[name] = (device_ms(lambda: fn(next(k)), ITERS, WARMUP),
                       median_ms(lambda: fn(next(k)), ITERS, WARMUP))
    fns["library"](0)
    if not torch.equal(dst, out):
        raise AssertionError("torch.mul's relayout differs from the kernel's")
    bound, by = bound_ms(nbytes(x, out), 0)
    (ms, ms_ev), (plain, plain_ev), (lib, lib_ev) = times.values()
    log(f"[lane-slice] device time per call: kernel {us(ms)}"
        + ("" if ms is None else f" ({x.numel() / (ms * 1e-3) / 1e9:.2f} Gelem/s, "
                                 f"{nbytes(x, out) / (ms * 1e-3) / 1e9:.1f} GB/s)")
        + f"; bound {bound * 1e3:.3f} us ({by}); plain {us(plain)}; torch.mul into a contiguous "
        f"output {us(lib)}")
    log(f"[lane-slice] per call as launched (CUDA events, paced by the host): kernel "
        f"{us(ms_ev)}, plain {us(plain_ev)}, torch.mul {us(lib_ev)}")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                launched_ms=dict(kernel=ms_ev, plain=plain_ev, library=lib_ev),
                max_abs_err=err, calls=1 + 2 * (ITERS + WARMUP))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="cuda (default) or cpu (check only)")
    run(parser.parse_args(argv).device)


if __name__ == "__main__":
    main()
