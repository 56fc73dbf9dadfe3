"""The benchmark of the PyTorch/CUDA port (`uvhand_tpu_torch`) on one card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. One run of one cell of `BENCHMARK.json`,
whose pieces `spec.py` finds by name: `configs/`, `traffic/`,
`workloads/`, `metrics/`, and `families/`, the module of the
configuration's model family (`families/__init__.py`: the port's model
and step, the plain reference's, the MSDA calls and the model the FLOPs
are counted on). A configuration of another family brings its module, its
own plain reference (under `reference/` or `families/`, importing nothing
of the port), its configuration, traffic and cell, as new files.

1. set-up (`setup_s`, from the process's start to the first timed step):
   the synthetic MANO layers and object bank, a synthetic ARCTIC root
   under TMPDIR made from the seed (`traffic.make_root`), the cell's
   distinct batches read from it by the port's data path, the port's model
   with weights drawn on the card from the seed (`weights.draw`) and its
   step, both of the family's `port` (arctic_sf: the fused train step,
   `engine.make_fused_train_step` with AdamW, or the eval step,
   `engine.make_eval_step`), and the warm-up: a train cell's first
   `check_steps` steps, which the correctness check follows, an eval
   cell's first batches. The MSDA kernels build once per checkout into
   `build/kernels/`; the line's `kernels_built` says whether this run
   built them (and so counted the build in `setup_s`);
2. the window: the engine's own loop (`engine.train_one_epoch` or
   `engine.evaluate`, with `device_prefetch`) over the set-up's batches in
   turn, fed until `--seconds` have passed; the batches already in flight
   then finish, and the window ends when the loop returns. Every rate is
   all the window's frames over all its seconds;
3. with `--trace 1`, a few more steps under torch.profiler, twice
   (`trace.py`), which the per-layer readers read;
4. the check (`check.py`): the program's state freed, the family's plain
   reference (`reference/`) on the same weights and inputs, and the set-up's
   batches against a plain reading of the synthetic root, which is
   removed only then;
5. the result: the compared numbers beside their limits as the last lines
   of standard error, then one JSON line on standard output.

It exits non-zero and prints no result where there is no card, fewer
cards than the cell asks for, or once `jax`, `jaxlib`, `flax` or the JAX
package is loaded in this process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import check, spec, weights  # noqa: E402
from .reference import assets  # noqa: E402

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "uvhand_tpu")
#: the faults a test plants under the timed path (never set by the CLI):
#: under the step (`with_fault`), in the optimizer (`group_rate`: the
#: sampling-offset group at the general rate, `lr_linear_proj_mult`
#: ignored), or in the set-up's batches (`shifted_images`: every image one
#: pixel to the right)
STEP_FAULTS = ("frozen_state", "half_batch", "altered_answer")
FAULTS = STEP_FAULTS + ("group_rate", "shifted_images")


@dataclass
class Readings:
    """What a run measured, as the metric readers take it."""

    loop: str
    batch: int
    config: dict
    setup_s: float
    window_s: float = 0.0
    steps: int = 0
    timing: Dict[str, List[float]] = field(default_factory=dict)
    peak_alloc_window: int = 0
    trace: Optional[object] = None
    #: the configuration's family module (`msda_roofline` reads its calls;
    #: a reader of spans or rates needs none)
    family: Optional[object] = None

    @property
    def frames(self) -> int:
        return self.steps * self.batch


def parse(argv=None):
    p = argparse.ArgumentParser("benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def world(mano_cls, bank_cls, device):
    """(right MANO, left MANO, object bank) of the given dataclasses (the
    port's or the reference's) from the benchmark's arrays, on `device`."""
    return (mano_cls(**assets.mano_fields(assets.synthetic_mano(assets.MANO_SEEDS["right"]),
                                          True, device)),
            mano_cls(**assets.mano_fields(assets.synthetic_mano(assets.MANO_SEEDS["left"]),
                                          False, device)),
            bank_cls(**assets.bank_fields(assets.synthetic_object_bank(), device)))


def set_precision(config: dict, device) -> None:
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = bool(config["tf32"])
        torch.backends.cudnn.allow_tf32 = bool(config["tf32"])


def cycled(batches, t0: float, seconds: float):
    """The batches in turn until `seconds` have passed since `t0`."""
    i = 0
    while time.perf_counter() - t0 < seconds:
        yield batches[i % len(batches)]
        i += 1


def with_fault(step, fault: Optional[str], params=None, loop: str = "train"):
    """`step` with a fault planted under it (tests and the calibration only):
    `frozen_state` puts the parameters back after each step, `half_batch`
    feeds it the first half of each batch's rows, `altered_answer` changes
    what it returns (a train step's loss, an eval step's first row)."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if fault not in STEP_FAULTS:
        return step

    def broken(batch):
        if fault == "half_batch":
            n = batch["images"].shape[0] // 2
            batch = {k: v[:n] for k, v in batch.items()}
        if fault == "frozen_state":
            saved = [p.detach().clone() for p in params]
        out = step(batch)
        if fault == "frozen_state":
            with torch.no_grad():
                for p, s in zip(params, saved):
                    p.copy_(s)
        if fault == "altered_answer":
            out = dict(out)
            if loop == "train":
                out["total"] = out["total"] * 1.01
            else:
                for k in out:
                    out[k] = out[k].clone()
                    out[k][0] = out[k][0] + 1.0
        return out

    broken.device = getattr(step, "device", None)
    return broken


def recording(step, rows: list):
    """`step`, appending what each call returns to `rows`."""

    def recorded(batch):
        out = step(batch)
        rows.append(out)
        return out

    recorded.device = step.device
    return recorded


class Program:
    """The port's side of a run: its model, step, and what set-up read of it."""

    def __init__(self, cell: spec.Cell, seed: int, device, batches, fault=None):
        self.cell, self.seed, self.device = cell, seed, device
        self.loop = cell.traffic["loop"]
        self.model, step, self.optimizer = cell.family.port(cell.config, world, device, seed,
                                                            self.loop)
        if fault == "group_rate" and self.optimizer is not None:
            for group in self.optimizer.param_groups:
                if group.get("name") == "linear_proj":
                    group["lr"] = cell.config["optimizer"]["lr"]
        self.step = with_fault(step, fault, list(self.model.parameters()), self.loop)
        self.batches = batches

    def first_steps(self) -> dict:
        """A train cell's first `check_steps` steps through the window's own
        loop, one distinct batch each: each step's loss, the first gradient
        as AdamW got it, the parameters' change after the first step and
        after them all."""
        from uvhand_tpu_torch import engine

        names = [n for n, _ in self.model.named_parameters()]
        params = dict(self.model.named_parameters())
        beta1 = self.optimizer.param_groups[0]["betas"][0]
        start = weights.draw(weights.shapes(self.model), self.cell.config, self.seed, self.device)
        losses, grad, update1 = [], None, None
        for k in range(self.cell.traffic["check_steps"]):
            out = engine.train_one_epoch(self.step, [self.batches[k]], print_freq=10 ** 9)
            losses.append(out["loss"])
            if k == 0:
                state = self.optimizer.state
                grad = check.leaf_norms({n: state[params[n]]["exp_avg"] / (1 - beta1)
                                         if params[n] in state else torch.zeros_like(params[n])
                                         for n in names})
                update1 = check.leaf_norms({n: params[n].detach() - start[n] for n in names})
        update = check.leaf_norms({n: params[n].detach() - start[n] for n in names})
        return {"losses": losses, "grad": grad, "update1": update1, "update": update}

    def warm_eval(self, n: int) -> None:
        from uvhand_tpu_torch import engine

        engine.evaluate(self.step, self.batches[:n])

    def window(self, seconds: float, readings: Readings) -> list:
        """The timed window; the eval step's outputs, in order (train: [])."""
        from uvhand_tpu_torch import engine

        timing: Dict[str, List[float]] = {}
        rows: list = []
        step = recording(self.step, rows) if self.loop == "eval" else self.step
        t0 = time.perf_counter()
        if self.loop == "train":
            engine.train_one_epoch(step, cycled(self.batches, t0, seconds), timing=timing,
                                   print_freq=10 ** 9)
        else:
            engine.evaluate(step, cycled(self.batches, t0, seconds), timing=timing)
        readings.window_s = time.perf_counter() - t0
        readings.timing = timing
        readings.steps = len(timing.get("step_ms", timing.get("batch_ms", [])))
        return rows

    def traced(self, steps: int):
        from uvhand_tpu_torch import engine

        from . import trace

        batches = self.batches[:steps]

        def run():
            if self.loop == "train":
                engine.train_one_epoch(self.step, batches, print_freq=10 ** 9)
            else:
                engine.evaluate(self.step, batches)

        return trace.traced(run, steps, engine.TRAIN_STAGES, self.device)


def make_traffic(cell: spec.Cell, seed: int, path: str, fault: Optional[str] = None) -> list:
    """The cell's set-up batches, of the family's `make_batches` and
    `check_batches`, from inputs written under `path` (a directory under
    TMPDIR, which the caller removes once the check has read it)."""
    c, t = cell.config, cell.traffic
    batches = cell.family.make_batches(c, t, seed, path)
    cell.family.check_batches(batches, t, c)
    return shifted(batches) if fault == "shifted_images" else batches


def shifted(batches: list) -> list:
    """The batches with every image one pixel to the right."""
    return [dict(b, images=np.roll(b["images"], 1, axis=2)) for b in batches]


def data_root() -> str:
    return tempfile.mkdtemp(prefix="uvhand_bench_root_")


def stamp(what: str) -> None:
    """A set-up phase's end, seconds since the process started, on stderr."""
    print(f"[setup] {what} done at {time.perf_counter() - T_START:.2f} s", file=sys.stderr)


def free(device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def peak_reserved(device) -> int:
    return torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0


def run_cell(args, device, root: str = spec.ROOT, t_start: float = T_START,
             fault: Optional[str] = None):
    """One run of cell `args.workload` on `device` -> (result, the numbers
    compared, the readings)."""
    path = data_root()
    try:
        return _run_cell(args, device, root, t_start, fault, path)
    finally:
        shutil.rmtree(path, ignore_errors=True)


def kernel_libraries(root: str) -> set:
    """The port's built kernel libraries in the checkout at `root`."""
    import glob

    return set(glob.glob(os.path.join(root, "build", "kernels", "*.so")))


def _run_cell(args, device, root: str, t_start: float, fault: Optional[str], path: str):
    built_before = kernel_libraries(root)
    cell = spec.load_cell(args.workload, root)
    c, t = cell.config, cell.traffic
    set_precision(c, device)
    stamp("imports")
    batches = make_traffic(cell, args.seed, path, fault)
    stamp("traffic")
    prog = Program(cell, args.seed, device, batches, fault)
    stamp("model and step")
    first = prog.first_steps() if prog.loop == "train" else None
    if prog.loop == "eval":
        prog.warm_eval(t["warm_batches"])
    stamp("warm-up")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    peak_setup = peak_reserved(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    readings = Readings(prog.loop, t["batch"], c, time.perf_counter() - t_start,
                        family=cell.family)
    rows = prog.window(args.seconds, readings)
    if device.type == "cuda":
        readings.peak_alloc_window = torch.cuda.max_memory_allocated(device)
    memory_peak = max(peak_setup, peak_reserved(device))
    if args.trace:
        readings.trace = prog.traced(t["trace_steps"])
    attempted = readings.steps
    stamp_check = time.perf_counter()

    # the check, with the program's state freed
    program_rows = [{k: v.cpu().numpy() for k, v in r.items()} for r in rows]
    del prog, rows
    free(device)
    if readings.loop == "train":
        ref = cell.family.reference_train(c, world, device, args.seed, batches,
                                          t["check_steps"])
        numbers = check.train_numbers(first, ref)
    else:
        ids = [i % t["batches"] for i in range(len(program_rows))]
        ref = cell.family.reference_eval(c, world, device, args.seed, batches, ids)
        numbers = check.eval_numbers(program_rows, ids, ref)
    numbers.update(cell.family.data_numbers(batches, path, c, t, args.seed))
    correct, checks = check.judge(numbers, cell.limits)
    print(f"[check] the reference took {time.perf_counter() - stamp_check:.2f} s", file=sys.stderr)

    metrics = spec.read_metrics(cell.per_layer if args.trace else cell.end_to_end, readings,
                                root)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": 0,
              "metrics": metrics, "device": dev}
    if readings.trace is not None:
        dev["busy_s"] = readings.trace.busy_s
        dev["window_s"] = readings.trace.window_s
        result["breakdown"] = readings.trace.breakdown()
    # a run that built the kernels counts the build in `setup_s`: marked, so
    # that a set's first run in a checkout can be told from the others
    result["kernels_built"] = bool(kernel_libraries(root) - built_before)
    result["checks"] = {k: {"value": v["value"] if math.isfinite(v["value"]) else "inf",
                            "limit": v["limit"]} for k, v in checks.items()}
    return result, numbers, readings


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    args = parse(argv)
    cell = spec.load_cell(args.workload)
    chips = int(cell.entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {chips} CUDA card(s), found {n}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(f"[card] {card_line()}", file=sys.stderr)
    result, numbers, readings = run_cell(args, device)
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: modules that must not load here were loaded: {loaded}",
              file=sys.stderr)
        return 3
    if readings.trace is not None:
        print(f"[trace] {readings.trace.steps} steps in {readings.trace.window_s:.3f} s, "
              f"device busy {readings.trace.busy_s:.3f} s, events {readings.trace.kinds}",
              file=sys.stderr)
    if readings.loop == "eval":
        print(f"[window] {len(readings.timing.get('batch_ms', []))} batches in "
              f"{readings.window_s:.3f} s", file=sys.stderr)
    else:
        print(f"[window] {readings.steps} steps in {readings.window_s:.3f} s", file=sys.stderr)
    for name in sorted(numbers):
        if name not in cell.limits:
            print(f"[check] {name} {numbers[name]!r} (not compared)", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
