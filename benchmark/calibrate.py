"""Readings that the correctness limits are set from, for one cell over
many seeds in one process (no timed window):

    python3 -m benchmark.calibrate --workload <cell> --seeds <n> [<n> ...]
        [--control] [--faults half_batch group_rate ...] [--twice <k>]
        [--out <file>]

For each seed it makes the cell's set-up batches and weights and reads the
compared numbers (`check.py`) of
  - the program: a train cell's first `check_steps` steps, or one pass of
    `engine.evaluate` over an eval cell's set-up batches, against the
    plain reference (the lower readings),
  - with `--control`: the reference itself computed with TF32 on (the
    precision below float32 with TF32 off, which the configuration
    states), against the reference (the upper readings),
  - with `--faults`: the program with each named fault planted
    (`run.FAULTS`), against the reference; `shifted_images` reads the
    data numbers alone,
  - with `--twice k`, on the first k seeds: a train cell's program run a
    second time on the same seed, against its first run (what the
    program's own nondeterminism, the backward's atomics, reads),
  - always: the set-up batches against the plain reading of the root
    (the family's `data_numbers`).
One JSON line a seed on standard output, and appended to `--out`.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys

import torch

from . import check, run, spec


def program_numbers(cell, seed, device, batches, reference, fault=None) -> dict:
    numbers, _ = program_run(cell, seed, device, batches, reference, fault)
    return numbers


def program_run(cell, seed, device, batches, reference, fault=None):
    """(the program's numbers against `reference`, a train cell's first
    steps as read)."""
    from uvhand_tpu_torch import engine

    prog = run.Program(cell, seed, device, batches, fault)
    first = None
    if prog.loop == "train":
        first = prog.first_steps()
        numbers = check.train_numbers(first, reference)
        numbers["worst_update_leaves"] = check.worst_leaves(first, reference, "update")
        numbers["worst_update1_leaves"] = check.worst_leaves(first, reference, "update1")
        numbers["losses"] = first["losses"]
    else:
        rows = []
        engine.evaluate(run.recording(prog.step, rows), batches)
        program_rows = [{k: v.cpu().numpy() for k, v in r.items()} for r in rows]
        numbers = check.eval_numbers(program_rows, list(range(len(batches))), reference)
    del prog
    run.free(device)
    return numbers, first


def reference_side(cell, seed, device, batches):
    if cell.traffic["loop"] == "train":
        return cell.family.reference_train(cell.config, run.world, device, seed, batches,
                                           cell.traffic["check_steps"])
    return cell.family.reference_eval(cell.config, run.world, device, seed, batches,
                                      list(range(len(batches))))


def control_numbers(cell, seed, device, batches, reference) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        control = reference_side(cell, seed, device, batches)
    finally:
        run.set_precision(cell.config, device)
    if cell.traffic["loop"] == "train":
        numbers = check.train_numbers(control, reference)
        numbers["worst_update_leaves"] = check.worst_leaves(control, reference, "update")
        numbers["worst_update1_leaves"] = check.worst_leaves(control, reference, "update1")
        return numbers
    return check.eval_numbers([control[i] for i in sorted(control)], sorted(control), reference)


def main(argv=None) -> int:
    p = argparse.ArgumentParser("benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", nargs="*", default=[], choices=run.FAULTS)
    p.add_argument("--twice", type=int, default=0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload)
    run.set_precision(cell.config, device)
    for n, seed in enumerate(args.seeds):
        path = run.data_root()
        try:
            line = calibrate_seed(cell, seed, device, path, args, twice=n < args.twice)
        finally:
            shutil.rmtree(path, ignore_errors=True)
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


def calibrate_seed(cell, seed, device, path, args, twice: bool) -> dict:
    c, t = cell.config, cell.traffic
    batches = run.make_traffic(cell, seed, path)
    line = {"workload": cell.name, "seed": seed,
            "data": cell.family.data_numbers(batches, path, c, t, seed)}
    reference = reference_side(cell, seed, device, batches)
    run.free(device)
    line["program"], first = program_run(cell, seed, device, batches, reference)
    if twice and first is not None:
        _, second = program_run(cell, seed, device, batches, reference)
        line["self"] = check.train_numbers(second, first)
        line["self"]["worst_update_leaves"] = check.worst_leaves(second, first, "update")
    if args.control:
        line["control"] = control_numbers(cell, seed, device, batches, reference)
        run.free(device)
    line["faults"] = {}
    for fault in args.faults:
        if fault == "shifted_images":
            line["faults"][fault] = cell.family.data_numbers(run.shifted(batches), path, c, t,
                                                             seed)
        else:
            line["faults"][fault] = program_numbers(cell, seed, device, batches, reference,
                                                    fault)
    return line


if __name__ == "__main__":
    sys.exit(main())
