"""Run logging: TensorBoard + log.txt + versioned run dirs + metric meters.

The port's own copy of nerfsys_tpu/utils/logging.py (`Logger`,
`SmoothedValue`, `MetricLogger`). TensorBoard scalars go through
torch.utils.tensorboard when it is importable; otherwise the Logger writes
text only.
"""
from __future__ import annotations

import datetime
from collections import defaultdict, deque
from pathlib import Path
from typing import Optional


class Logger:
    """Per-run directory with TensorBoard scalars and append-mode log.txt.

    Collision-safe: an existing run dir gets a `_v{N}` suffix
    (utils.py:44-80). rank != 0 disables writing (DP-compatible).
    """

    def __init__(
        self,
        fn: str,
        logs_path: str = "logs",
        today: bool = False,
        rank: int = 0,
        resume: bool = False,
    ):
        self.rank = rank
        base = Path(logs_path)
        name = fn
        if today:
            name = f"{datetime.date.today().strftime('%y%m%d')}_{fn}"
        logdir = base / name
        if rank == 0 and not resume:
            v = 1
            while logdir.exists() and any(logdir.iterdir()):
                logdir = base / f"{name}_v{v}"
                v += 1
        self.logdir = logdir
        self._writer = None
        if rank == 0:
            self.logdir.mkdir(parents=True, exist_ok=True)
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._writer = SummaryWriter(log_dir=str(self.logdir))
            except Exception:
                self._writer = None
            self._logfile = open(self.logdir / "log.txt", "a")
        else:
            self._logfile = None

    def log(self, msg: str):
        line = f"[{datetime.datetime.now().strftime('%m-%d %H:%M:%S')}] {msg}"
        print(line, flush=True)
        if self._logfile:
            self._logfile.write(line + "\n")
            self._logfile.flush()

    def scalar(self, key: str, value, step: int):
        if self._writer is not None:
            self._writer.add_scalar(key, float(value), step)

    def scalars(self, values: dict, step: int, prefix: str = ""):
        for k, v in values.items():
            try:
                self.scalar(f"{prefix}{k}", float(v), step)
            except (TypeError, ValueError):
                pass  # non-scalar aux entries

    def close(self):
        if self._writer is not None:
            self._writer.close()
        if self._logfile:
            self._logfile.close()


class SmoothedValue:
    """Windowed + global average meter (utils.py:363-460)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        if not self.deque:
            return 0.0
        s = sorted(self.deque)
        return s[len(s) // 2]

    @property
    def avg(self):
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value,
        )


class MetricLogger:
    """Grouped meters with periodic progress lines (utils.py:463-535)."""

    def __init__(self, delimiter: str = "  "):
        self.meters = defaultdict(SmoothedValue)
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
