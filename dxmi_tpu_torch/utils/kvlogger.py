"""Key-value diagnostics logger (``dxmi_tpu.utils.kvlogger``,
``kvlogger.py:19-169``), the openai-baselines logger's live surface:
``KVLogger`` with its stdout, CSV (``progress.csv``, its header rewritten
when a key appears), JSON (``progress.json``, one object a dump), log
(``log.txt``) and TensorBoard formats; the module-level ``configure``,
``get``, ``logkv``, ``logkv_mean``, ``dumpkvs``, ``profile_kv`` and
``profile``. The files are the JAX package's byte for byte. Without
tensorboardX the ``tensorboard`` format prints the JAX package's message to
stderr and is dropped."""
from __future__ import annotations

import contextlib
import datetime
import functools
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from typing import Any, Dict, Optional


class KVLogger:
    def __init__(self, logdir: Optional[str] = None,
                 formats: tuple = ("stdout", "csv", "json")):
        self.logdir = logdir
        self.name2val: Dict[str, float] = {}
        self.name2cnt: Dict[str, int] = defaultdict(int)
        self._csv = self._json = self._log = self._tb = None
        self._csv_keys = []
        self._step = 0
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            if "csv" in formats:
                self._csv = open(os.path.join(logdir, "progress.csv"), "a+")
            if "json" in formats:
                self._json = open(os.path.join(logdir, "progress.json"), "a+")
            if "log" in formats:
                self._log = open(os.path.join(logdir, "log.txt"), "a")
            if "tensorboard" in formats:
                # the reference logger's 'tensorboard' output format
                try:
                    from tensorboardX import SummaryWriter

                    self._tb = SummaryWriter(
                        logdir=os.path.join(logdir, "tb"))
                except ImportError:
                    print("kvlogger: tensorboardX not installed — "
                          "'tensorboard' format dropped", file=sys.stderr)
        elif any(f in formats for f in ("csv", "json", "log", "tensorboard")):
            print(f"kvlogger: no logdir — file formats {formats} dropped",
                  file=sys.stderr)
        self.stdout = "stdout" in formats

    def logkv(self, key: str, val: Any) -> None:
        self.name2val[key] = val

    def logkv_mean(self, key: str, val: float) -> None:
        old, cnt = self.name2val.get(key, 0.0), self.name2cnt[key]
        self.name2val[key] = old * cnt / (cnt + 1) + float(val) / (cnt + 1)
        self.name2cnt[key] = cnt + 1

    def dumpkvs(self) -> Dict[str, Any]:
        d = dict(self.name2val)
        if (self.stdout or self._log) and d:
            width = max(len(k) for k in d)
            lines = ["-" * (width + 24)]
            for k in sorted(d):
                v = d[k]
                vs = f"{v:<12.5g}" if isinstance(v, float) else str(v)
                lines.append(f"| {k:<{width}} | {vs:<18} |")
            lines.append("-" * (width + 24))
            if self.stdout:
                print("\n".join(lines), flush=True)
            if self._log:
                self._log.write("\n".join(lines) + "\n")
                self._log.flush()
        if self._tb is not None and d:
            self._step += 1
            for k, v in d.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, float(v), self._step)
            self._tb.flush()
        if self._json and d:
            self._json.write(json.dumps(
                {k: float(v) if isinstance(v, (int, float)) else str(v)
                 for k, v in d.items()}) + "\n")
            self._json.flush()
        if self._csv and d:
            new_keys = [k for k in d if k not in self._csv_keys]
            if new_keys:
                self._csv_keys.extend(sorted(new_keys))
                self._csv.seek(0)
                lines = self._csv.readlines()
                self._csv.seek(0)
                self._csv.truncate()
                self._csv.write(",".join(self._csv_keys) + "\n")
                for line in lines[1:]:
                    self._csv.write(line)
            self._csv.write(",".join(
                str(d.get(k, "")) for k in self._csv_keys) + "\n")
            self._csv.flush()
        self.name2val.clear()
        self.name2cnt.clear()
        return d


_GLOBAL: Optional[KVLogger] = None


def configure(logdir: Optional[str] = None,
              formats: Optional[tuple] = None) -> KVLogger:
    """The reference logger's ``configure``: the directory from
    ``DXMI_LOGDIR`` when not given (else a time-stamped one in the temporary
    directory); the formats from ``DXMI_LOG_FORMAT`` (comma-separated, like
    OPENAI_LOG_FORMAT: stdout/log/csv/json/tensorboard)."""
    global _GLOBAL
    if logdir is None:
        logdir = os.environ.get("DXMI_LOGDIR") or os.path.join(
            tempfile.gettempdir(),
            "dxmi-" + datetime.datetime.now().strftime("%Y%m%d-%H%M%S"))
    if formats is None:
        env = os.environ.get("DXMI_LOG_FORMAT")
        formats = tuple(f.strip() for f in env.split(",")) if env \
            else ("stdout", "csv", "json")
    _GLOBAL = KVLogger(logdir, formats=formats)
    return _GLOBAL


def get() -> KVLogger:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = KVLogger(None)
    return _GLOBAL


def logkv(key, val):
    get().logkv(key, val)


def logkv_mean(key, val):
    get().logkv_mean(key, val)


def dumpkvs():
    return get().dumpkvs()


@contextlib.contextmanager
def profile_kv(scopename: str):
    """Accumulate wall time spent inside the scope into ``wait_<name>``
    (the reference logger's ``profile_kv``: it accumulates with ``+=``, it
    does not average)."""
    logkey = "wait_" + scopename
    tstart = time.time()
    try:
        yield
    finally:
        lg = get()
        lg.name2val[logkey] = lg.name2val.get(logkey, 0.0) + (
            time.time() - tstart)


def profile(n: str):
    """Decorator form of :func:`profile_kv`
    (the reference logger's ``profile``)."""
    def decorator_with_name(func):
        @functools.wraps(func)
        def func_wrapper(*args, **kwargs):
            with profile_kv(n):
                return func(*args, **kwargs)
        return func_wrapper
    return decorator_with_name
