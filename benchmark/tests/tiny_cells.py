"""A copy of the benchmark with one tiny cell, for runs on the CPU.

`make(tmp, loop)` copies `benchmark/` and `BENCHMARK.json` into `tmp` and
adds, by files and entries alone, a configuration `tiny` (arctic_sf at
d=32, 4 heads, 1 + 1 layers, 20 queries, 64x64 images, on the full R50),
a traffic mix `tiny_<loop>` (3 batches of 4 frames) and a cell
`tiny.<loop>` whose limits are those of the R50 cell of the same loop.
With `family`, the configuration is `tiny_<family>`, cut alike, names that
family, and its cell is `tiny_<family>.<loop>`; the family's module is
`benchmark/families/<family>.py` of the copy (the repository's, or one
that the caller writes there).
"""

from __future__ import annotations

import json
import os
import shutil
import types
from typing import Optional

from benchmark import spec

CELLS = {"train": "sf_r50.train_b64", "eval": "sf_r50.eval_b64"}


def make(tmp: str, loop: str, family: Optional[str] = None) -> str:
    root = os.path.join(str(tmp), "checkout")
    if not os.path.exists(root):
        shutil.copytree(os.path.join(spec.ROOT, "benchmark"), os.path.join(root, "benchmark"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), root)
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    here = os.path.join(root, "benchmark")
    tiny = config_name(family)
    config = json.load(open(os.path.join(here, "configs", "arctic_sf_r50.json")))
    config["model"].update(num_queries=20, d_model=32, n_heads=4, num_encoder_layers=1,
                           num_decoder_layers=1, dim_feedforward=64)
    config["img_res"] = 64
    if family is not None:
        config["family"] = family
    json.dump(config, open(os.path.join(here, "configs", f"{tiny}.json"), "w"))
    traffic = {"loop": loop, "batch": 4, "batches": 3, "split": "train" if loop == "train"
               else "val", "check_steps": 3, "trace_steps": 1, "warm_batches": 1,
               "root": {"seqs": 2, "frames": 3, "views": 2, "image_hw": [120, 168]}}
    json.dump(traffic, open(os.path.join(here, "traffic", f"tiny_{loop}.json"), "w"))
    limits = json.load(open(os.path.join(here, "workloads", f"{CELLS[loop]}.json")))["limits"]
    name = f"{tiny}.{loop}"
    json.dump({"config": tiny, "traffic": f"tiny_{loop}", "limits": limits},
              open(os.path.join(here, "workloads", f"{name}.json"), "w"))
    if not any(c["name"] == tiny for c in bench["configs"]):
        bench["configs"].append({"name": tiny, "source": "https://github.com/On-JungWoan/UVHand",
                                 "file": f"benchmark/configs/{tiny}.json", "reduced": [],
                                 "why": "a CPU test"})
    bench["workloads"].append({"name": name, "config": tiny, "traffic": f"tiny_{loop}",
                               "chips": 1, "why": "a CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELLS[loop] in m.get("workloads", ()):
            m["workloads"].append(name)
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    return root


def config_name(family: Optional[str] = None) -> str:
    return "tiny" if family is None else f"tiny_{family}"


def args(loop: str, seed: int = 2 ** 31 + 7, seconds: float = 1.0, trace: int = 0,
         family: Optional[str] = None):
    return types.SimpleNamespace(workload=f"{config_name(family)}.{loop}", seed=seed,
                                 seconds=seconds, trace=trace)
