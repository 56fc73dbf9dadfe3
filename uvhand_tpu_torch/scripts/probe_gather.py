"""Gather probes on the card: port of `scripts/repro_dynamic_gather.py` and
`scripts/probe_gather_scale.py`.

    python -m uvhand_tpu_torch.scripts.probe_gather [--device DEV]

The TPU probes asked whether a Mosaic kernel could run
`take_along_axis(v, idx, axis)` (float32 values, int32 in-range indices)
and at what rate, at MSDA-like shapes:
  - repro_dynamic_gather.py: (1408, 128) along axis 0 and along axis 1;
  - probe_gather_scale.py: along the last axis at (8, 1048, 128),
    (1, 1048, 256), (1, 1048, 1408), (16, 1048, 1408) and (128, 8, 128).
Here every case runs through the gather kernel (`csrc/probe_gather.cu`),
is checked exactly against the probe's own numpy reference, and is timed
beside its byte bound, its plain version and `torch.gather` (the library's
single call for the function; it takes int64 indices, made before the
timing). All three cycle through the same four index arrays (idx + i) % n,
as the probes vary them, and each is timed twice: its device time
(torch.profiler over 20 calls after 3, the kernels' own time), and its time
per call as launched (CUDA events around each call, median), which the
host's work paces for the small cases. Gelem/s is from the device time. On
the CPU (`--device cpu`) it only checks the plain version; the timing needs a
card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from uvhand_tpu_torch.device import resolve_device
from uvhand_tpu_torch.ops import probes
from uvhand_tpu_torch.scripts.measure import bound_ms, device_ms, median_ms, nbytes, us

#: (name, shape, axis): scripts/repro_dynamic_gather.py:69-71, scripts/probe_gather_scale.py:63-69
CASES = (
    ("repro axis 0", (1408, 128), 0),
    ("repro axis 1", (1408, 128), 1),
    ("scale", (8, 1048, 128), 2),
    ("scale", (1, 1048, 256), 2),
    ("scale", (1, 1048, 1408), 2),
    ("scale", (16, 1048, 1408), 2),
    ("scale", (128, 8, 128), 2),
)
ITERS, WARMUP = 20, 3


def case_arrays(shape, axis, seed=0):
    """The probes' inputs: indices uniform over the gathered axis, values normal."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, shape[axis], shape).astype(np.int32)
    v = rng.standard_normal(shape).astype(np.float32)
    return v, idx


def run(device=None, cases=CASES, log=print):
    """Check and (on the card) time every case -> [numbers per case]; each
    holds `calls`, the kernel launches it made."""
    device = resolve_device(device)
    rows = []
    for name, shape, axis in cases:
        v_np, idx_np = case_arrays(shape, axis)
        v, idx = torch.from_numpy(v_np).to(device), torch.from_numpy(idx_np).to(device)
        out = probes.take_along_axis(v, idx, axis)
        err = float(np.abs(out.cpu().numpy() - np.take_along_axis(v_np, idx_np, axis)).max())
        label = f"{name} {'x'.join(map(str, shape))} axis {axis}"
        if err != 0.0:
            raise AssertionError(f"gather {label} disagrees with numpy: {err}")
        row = dict(case=label, max_abs_err=err, calls=0)
        rows.append(row)
        if device.type != "cuda":
            log(f"[gather] {label}: {device.type}, max err 0")
            continue
        n = shape[axis]
        idxs = [(idx + i) % n for i in range(4)]
        idx64s = [i.long() for i in idxs]
        fns = {
            "kernel": lambda i: probes.take_along_axis(v, idxs[i % 4], axis),
            "plain": lambda i: probes.take_along_axis_torch(v, idxs[i % 4], axis),
            "library": lambda i: torch.gather(v, axis, idx64s[i % 4]),
        }
        times = {}
        for fn_name, fn in fns.items():
            k = iter(range(1 << 30))
            times[fn_name] = (device_ms(lambda: fn(next(k)), ITERS, WARMUP),
                              median_ms(lambda: fn(next(k)), ITERS, WARMUP))
        if not torch.equal(fns["library"](0), out):
            raise AssertionError(f"torch.gather differs from the kernel ({label})")
        bound, by = bound_ms(nbytes(v, idx, out), 0)
        (ms, ms_ev), (plain, plain_ev), (lib, lib_ev) = times.values()
        elems = v.numel()

        def rate(t):
            return None if t is None else elems / (t * 1e-3) / 1e9

        row.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                   launched_ms=dict(kernel=ms_ev, plain=plain_ev, library=lib_ev),
                   calls=1 + 2 * (ITERS + WARMUP), gelem_per_s=rate(ms))
        log(f"[gather] {label}: device time per call: kernel {us(ms)}"
            + ("" if ms is None else f" ({rate(ms):.2f} Gelem/s)")
            + f"; bound {bound * 1e3:.3f} us ({by}); plain {us(plain)}; torch.gather {us(lib)}"
            + ("" if lib is None else f" ({rate(lib):.2f} Gelem/s)")
            + f"; as launched (CUDA events): kernel {us(ms_ev)}, plain {us(plain_ev)}, "
            f"torch.gather {us(lib_ev)}")
        del idxs, idx64s
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="cuda (default) or cpu (check only)")
    run(parser.parse_args(argv).device)


if __name__ == "__main__":
    main()
