"""Experiment logging.

Port of ``safe_control_gym_tpu/utils/logging.py`` (the counterpart of the
reference's logging stack, safe_control_gym/utils/logging.py):
StdoutLogger (:13-44), FileLogger with one append-only text log per metric
and its truncation on restore (:47-124), and ExperimentLogger with a stats
buffer, the scalar sinks (a stdout table, the files, TensorBoard where
``torch.utils.tensorboard`` imports) and the dump (:127-289).
"""

from __future__ import annotations

import logging
import os
import sys
from collections import defaultdict
from typing import Optional


class StdoutLogger:
    """File + stream logging (reference logging.py:13-44)."""

    def __init__(self, logger_name: str, log_dir: str, level=logging.INFO):
        logger = logging.getLogger(logger_name)
        logger.setLevel(level)
        logger.handlers = []
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, "std_log.txt"))
        fh.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(fh)
        logger.addHandler(sh)
        self.logger = logger

    def info(self, msg: str):
        self.logger.info(msg)

    def close(self):
        for h in list(self.logger.handlers):
            h.close()
            self.logger.removeHandler(h)


class FileLogger:
    """One '<step> <value>' text log per metric, truncated on restore
    (reference logging.py:47-124)."""

    def __init__(self, log_dir: str):
        self.log_dir = os.path.join(log_dir, "logs")
        os.makedirs(self.log_dir, exist_ok=True)
        self._files = {}

    def _file(self, name: str):
        if name not in self._files:
            path = os.path.join(self.log_dir, name.replace("/", "_") + ".log")
            self._files[name] = open(path, "a")
        return self._files[name]

    def log(self, name: str, value, step: int):
        f = self._file(name)
        f.write(f"{step} {value}\n")
        f.flush()

    def restore(self, step: int):
        """Drop the rows past the restore step (logging.py:95-124)."""
        for fname in os.listdir(self.log_dir):
            path = os.path.join(self.log_dir, fname)
            with open(path) as f:
                lines = [l for l in f if l.strip() and int(l.split()[0]) <= step]
            with open(path, "w") as f:
                f.writelines(lines)

    def close(self):
        for f in self._files.values():
            f.close()
        self._files = {}


class ExperimentLogger:
    """Stats buffer + sinks (reference logging.py:127-289)."""

    def __init__(self, output_dir: str, use_tensorboard: bool = False, log_std_out: bool = True):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.file_logger = FileLogger(output_dir)
        self.std_logger = StdoutLogger("scg_torch", output_dir) if log_std_out else None
        self.stats_buffer = defaultdict(list)
        self.tb_writer = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # tensorboard is not installed
                SummaryWriter = None
            if SummaryWriter is not None:
                self.tb_writer = SummaryWriter(log_dir=os.path.join(output_dir, "tb"))

    def add_scalar(self, name: str, value, step: int, write: bool = True, write_tb: bool = True):
        self.stats_buffer[name].append((step, float(value)))
        if write:
            self.file_logger.log(name, float(value), step)
        if write_tb and self.tb_writer is not None:
            self.tb_writer.add_scalar(name, float(value), step)

    def add_scalars(self, scalars: dict, step: int, prefix: Optional[str] = None, **kw):
        for k, v in scalars.items():
            self.add_scalar(f"{prefix}/{k}" if prefix else k, v, step, **kw)

    def dump_scalars(self):
        """ASCII stats table of each metric's last value (reference
        logging.py:228-275)."""
        if not self.stats_buffer:
            return
        rows = [(name, *vals[-1]) for name, vals in sorted(self.stats_buffer.items())]
        width = max(len(r[0]) for r in rows) + 2
        lines = ["-" * (width + 26)]
        for name, step, v in rows:
            lines.append(f"| {name:<{width}}| {step:>8} | {v:>10.4f} |")
        lines.append("-" * (width + 26))
        out = "\n".join(lines)
        if self.std_logger:
            self.std_logger.info(out)
        else:
            print(out)
        self.stats_buffer = defaultdict(list)

    def load(self, step: int):
        self.file_logger.restore(step)

    def close(self):
        self.file_logger.close()
        if self.std_logger:
            self.std_logger.close()
        if self.tb_writer is not None:
            self.tb_writer.close()
