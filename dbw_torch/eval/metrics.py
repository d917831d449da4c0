"""Metric meters and their TSV logs (a port of ``AverageMeter`` and
``Metrics`` of dbw_tpu/eval/metrics.py; the mesh evaluators come with the
mesh-scoring slice).

The log is ``iteration, epoch, batch`` followed by the metric names, one
tab-separated row per ``log``. ``read_log`` needs no pandas: it returns
{column: (rows,) float64 array}."""

from __future__ import annotations

import csv
from collections import defaultdict
from pathlib import Path

import numpy as np


def _scalar(v):
    if hasattr(v, "item"):
        return float(v.item())
    return float(v)


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.avg = 0.0
        self.count = 0

    def update(self, val, N=1):
        val = _scalar(val)
        self.val = val
        self.sum += val * N
        self.count += N
        self.avg = self.sum / self.count if self.count else 0.0


class Metrics:
    """Named meters with a TSV append-log."""

    def __init__(self, *names, log_file=None, append=False, truncate_iter=None):
        self.names = list(names)
        self.meters = defaultdict(AverageMeter)
        self.log_file = None if log_file is None else Path(log_file)
        if self.log_file is None:
            return
        if not self.log_file.exists() or not append:
            with open(self.log_file, "w") as f:
                f.write("iteration\tepoch\tbatch\t" + "\t".join(self.names) + "\n")
        elif truncate_iter is not None:
            # resume: the interrupted run logged rows past its last
            # checkpoint, which the replay logs again
            self._truncate(truncate_iter)

    def _truncate(self, max_iter):
        lines = self.log_file.read_text().splitlines(keepends=True)
        keep = lines[:1]
        for ln in lines[1:]:
            try:
                if int(ln.split("\t", 1)[0]) > max_iter:
                    continue
            except ValueError:
                pass
            keep.append(ln)
        if len(keep) != len(lines):
            self.log_file.write_text("".join(keep))

    def __getitem__(self, name):
        return self.meters[name]

    def __repr__(self):
        return ", ".join(f"{n}={self[n].avg:.4f}" for n in self.names)

    @property
    def values(self):
        return [self[n].avg for n in self.names]

    def update(self, values: dict, N=1):
        """Add {name: value} to the meters, each value weighing N."""
        for name, val in values.items():
            if name not in self.names:
                raise KeyError(f"{name} not in current metrics")
            self[name].update(val, N=N)

    def log(self, it, epoch, batch):
        if self.log_file is not None:
            with open(self.log_file, "a") as f:
                f.write(f"{it}\t{epoch}\t{batch}\t"
                        + "\t".join(f"{v:.6f}" for v in self.values) + "\n")

    def reset(self):
        for n in self.names:
            self[n].reset()

    def log_and_reset(self, it=None, epoch=None, batch=None):
        self.log(it, epoch, batch)
        self.reset()

    def read_log(self):
        """The log as {column: (rows,) float64 array} ({} without a log);
        an empty field reads as NaN."""
        if self.log_file is None or not self.log_file.exists():
            return {}
        with open(self.log_file, newline="") as f:
            rows = list(csv.reader(f, delimiter="\t"))
        if not rows:
            return {}
        header, body = rows[0], rows[1:]
        num = lambda s: float(s) if s not in ("", "None") else np.nan
        return {h: np.array([num(r[i]) if i < len(r) else np.nan for r in body],
                            np.float64)
                for i, h in enumerate(header)}

    def get_named_values(self, filter_fn=None):
        pairs = list(zip(self.names, self.values))
        if filter_fn is not None:
            pairs = [p for p in pairs if filter_fn(p[0])]
        return pairs
