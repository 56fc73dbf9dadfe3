"""Gather probes on the card: port of `scripts/repro_dynamic_gather.py` and
`scripts/probe_gather_scale.py`.

    python -m uvhand_tpu_torch.scripts.probe_gather [--device DEV]

The TPU probes asked whether a Mosaic kernel could run
`take_along_axis(v, idx, axis)` (float32 values, int32 in-range indices)
and at what rate, at MSDA-like shapes:
  - repro_dynamic_gather.py: (1408, 128) along axis 0 and along axis 1;
  - probe_gather_scale.py: along the last axis at (8, 1048, 128),
    (1, 1048, 256), (1, 1048, 1408), (16, 1048, 1408) and (128, 8, 128).
Here every case runs through the kernel `msda_cuda.gather_plan` picks
(`csrc/probe_gather.cu`: the staged kernel along the last axis from 2 MiB
of values, the general one below and along the other axis), is checked
exactly against the probe's own numpy reference, and each kernel that takes
the case (the staged one along the last axis, and the general one) is held
bit for bit against it too. Then each is timed beside its byte bound, its
plain version and `torch.gather` (the library's single call for the
function; it takes int64 indices, made before the timing). All cycle
through the same four index arrays (idx + i) % n, as the probes vary them.
The two kernels are timed in turns (the plan's, the other, the other, the
plan's), each turn twice: its device time (torch.profiler over 20 calls
after 3, the kernels' own time) and its time per call as launched (CUDA
events around each call, median), which the host's work paces for the
small cases; a kernel's figure is the lower of its two turns. Gelem/s is
from the device time. On the CPU (`--device cpu`) it only checks the plain
version; the timing needs a card.
"""

from __future__ import annotations

import argparse
from collections import Counter

import numpy as np
import torch

from uvhand_tpu_torch.device import resolve_device
from uvhand_tpu_torch.ops import msda_cuda, probes
from uvhand_tpu_torch.scripts.measure import bound_ms, device_ms, lower, median_ms, us

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
#: compulsory bytes an element: its index and value read, the value written
BYTES_PER_ELEMENT = 12


def case_arrays(shape, axis, seed=0):
    """The probes' inputs: indices uniform over the gathered axis, values normal."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, shape[axis], shape).astype(np.int32)
    v = rng.standard_normal(shape).astype(np.float32)
    return v, idx


def case_bound(shape):
    """(ms, "bytes"): the least time of one call at `shape` on the card, its
    compulsory bytes over device memory's rate."""
    return bound_ms(int(np.prod(shape)) * BYTES_PER_ELEMENT, 0)


def case_kinds(shape, axis, sms=132):
    """The gather kernels that take a case of fresh (16-byte aligned)
    tensors, in the order they are timed in turns: the one `gather_plan`
    picks first, then the other where the staged one takes the case."""
    view = (1,) * (3 - len(shape)) + tuple(shape)
    plan = msda_cuda.gather_plan(view, axis % len(shape) + (3 - len(shape)), sms=sms)
    if not plan.stages:
        return ("general",)
    return (plan.kind, "general" if plan.kind == "staged" else "staged")


def turns(kinds):
    """The order the kinds are timed in: a, b, b, a (one kind: once)."""
    return kinds + kinds[::-1] if len(kinds) > 1 else kinds


def run(device=None, cases=CASES, log=print):
    """Check and (on the card) time every case -> [numbers per case]; each
    holds `calls`, the kernel launches it made, and `calls_by_kind`, the
    same by kernel name (probe_gather_<kind>)."""
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
        row = dict(case=label, max_abs_err=err, calls=0, calls_by_kind=Counter())
        rows.append(row)
        if device.type != "cuda":
            log(f"[gather] {label}: {device.type}, max err 0")
            continue
        kinds = case_kinds(shape, axis, torch.cuda.get_device_properties(device)
                           .multi_processor_count)
        calls = row["calls_by_kind"]
        calls[f"probe_gather_{kinds[0]}"] += 1  # the check above
        for kind in kinds:
            calls[f"probe_gather_{kind}"] += 1
            if not torch.equal(msda_cuda._launch_gather(kind, v, idx, axis), out):
                raise AssertionError(f"the {kind} gather kernel differs from numpy ({label})")
        n = shape[axis]
        idxs = [(idx + i) % n for i in range(4)]
        idx64s = [i.long() for i in idxs]

        def kernel(kind):
            def call(i):
                calls[f"probe_gather_{kind}"] += 1
                return msda_cuda._launch_gather(kind, v, idxs[i % 4], axis)
            return call

        fns = {
            **{kind: kernel(kind) for kind in kinds},
            "plain": lambda i: probes.take_along_axis_torch(v, idxs[i % 4], axis),
            "library": lambda i: torch.gather(v, axis, idx64s[i % 4]),
        }
        times = {key: [] for key in fns}
        for key in turns(kinds) + ("plain", "library"):
            k = iter(range(1 << 30))
            times[key].append((device_ms(lambda: fns[key](next(k)), ITERS, WARMUP),
                               median_ms(lambda: fns[key](next(k)), ITERS, WARMUP)))
        if not torch.equal(fns["library"](0), out):
            raise AssertionError(f"torch.gather differs from the kernel ({label})")
        bound, by = case_bound(shape)
        ms = {key: lower(t[0] for t in ts) for key, ts in times.items()}
        launched = {key: lower(t[1] for t in ts) for key, ts in times.items()}
        elems = v.numel()

        def rate(t):
            return None if t is None else elems / (t * 1e-3) / 1e9

        row.update(shape=shape, axis=axis, plan=kinds[0], bound_ms=bound, bound_by=by,
                   plain_ms=ms["plain"], library_ms=ms["library"], launched_ms=launched,
                   kinds={kind: dict(ms=ms[kind], launched_ms=launched[kind],
                                     gelem_per_s=rate(ms[kind])) for kind in kinds})
        log(f"[gather] {label}: device time per call: "
            + ", ".join(f"{kind} {us(ms[kind])}"
                        + ("" if ms[kind] is None else f" ({rate(ms[kind]):.2f} Gelem/s)")
                        for kind in kinds)
            + (" (in turns " + ", ".join(turns(kinds)) + ": the lower of two)"
               if len(kinds) > 1 else "")
            + f"; bound {bound * 1e3:.3f} us ({by}); plain {us(ms['plain'])}; torch.gather "
            f"{us(ms['library'])}"
            + ("" if ms["library"] is None else f" ({rate(ms['library']):.2f} Gelem/s)")
            + "; as launched (CUDA events): "
            + ", ".join(f"{key} {us(launched[key])}" for key in fns))
        row["calls"] = sum(calls.values())
        del idxs, idx64s
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="cuda (default) or cpu (check only)")
    run(parser.parse_args(argv).device)


if __name__ == "__main__":
    main()
