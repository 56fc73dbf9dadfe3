"""Metric logging: smoothed windows, ETA, results files.

Port of `uvhand_tpu/utils/logging.py` (the reference's `MetricLogger` and
`SmoothedValue`, `util/misc.py`, and `save_results`, `util/tools.py`):
`loss.txt` and `results.txt` get the same bytes for the same dicts.
`synchronize_between_processes` is single-process here (multi-card runs
are ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import datetime
import json
import os
import time
from collections import defaultdict, deque
from typing import Dict


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            value=self.value, count=self.count,
        )


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def synchronize_between_processes(self):
        """Merge each meter's (count, total) across processes so that
        global_avg is the global average: nothing to merge in one process,
        which is all the port runs (multi-card runs are ROADMAP Queue 1
        item 6)."""

    def log_every(self, iterable, print_freq: int, header: str = "", total=None):
        i = 0
        total = total if total is not None else (len(iterable) if hasattr(iterable, "__len__") else None)
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total and i == total - 1):
                eta = ""
                if total:
                    eta_s = iter_time.global_avg * (total - i)
                    eta = f"eta: {datetime.timedelta(seconds=int(eta_s))}  "
                print(
                    f"{header} [{i}{'/' + str(total) if total else ''}]  {eta}"
                    f"{self}  time: {iter_time}  data: {data_time}",
                    flush=True,
                )
            i += 1
            end = time.time()
        print(f"{header} Total time: {datetime.timedelta(seconds=int(time.time()-start))}")


def save_results(output_dir: str, epoch: int, loss_dict=None, score_dict=None,
                 header: str | None = None):
    """Append to loss.txt / results.txt (util/tools.py:607-640). `header`
    reproduces the reference's eval banner (test_viewpoint / batch*window /
    iter, util/tools.py:620-623)."""
    os.makedirs(output_dir, exist_ok=True)
    if loss_dict is not None:
        with open(os.path.join(output_dir, "loss.txt"), "a") as f:
            f.write(json.dumps({"epoch": epoch, **{k: float(v) for k, v in loss_dict.items()}}) + "\n")
    if score_dict is not None:
        with open(os.path.join(output_dir, "results.txt"), "a") as f:
            if header:
                f.write(f"{'='*10} {header} {'='*10}\n")
            f.write(json.dumps({"epoch": epoch, **{k: float(v) for k, v in score_dict.items()}}) + "\n")


class WandbLogger:
    """Opt-in Weights & Biases logging (util/settings.py:566-580,
    util/tools.py:643). No-ops when wandb isn't installed or --wandb unset."""

    def __init__(self, enabled: bool, project: str = "uvhand_tpu", config=None,
                 name: str | None = None):
        self.run = None
        if not enabled:
            return
        try:
            import wandb

            self.run = wandb.init(project=project, config=config, name=name)
        except Exception as e:  # wandb absent or offline failure
            print(f"wandb disabled: {e}")

    def log(self, metrics: Dict, step: int | None = None):
        if self.run is not None:
            self.run.log(metrics, step=step)

    def finish(self):
        if self.run is not None:
            self.run.finish()
