"""Worker log capture and streaming to the driver.

A port of ``ray_tpu._private.log_monitor`` for the PyTorch port
(reference ``python/ray/_private/log_monitor.py``: every node tails its
workers' stdout and stderr files and publishes new lines to GCS pubsub;
drivers subscribe and print them with a worker prefix, which is how a
``print()`` inside a task in another OS process reaches the driver's
terminal).

The worker pool that spawns a process worker opens
``<temp_dir>/logs/host-<pid>/worker-<id>.{out,err}`` for the child, and
one ``LogMonitor`` thread in that process tails the directory and
publishes complete lines into the GCS publisher on ``LOG_CHANNEL``.  The
driver's mirror (``mirror_worker_logs``) subscribes to that channel.
Left out until node hosts (ROADMAP A.4b.9b): a host publishing through
its wire client.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
from typing import Callable, Dict, Optional

from ray_tpu_torch._private.config import get_config

logger = logging.getLogger(__name__)

LOG_CHANNEL = "worker_logs"


def worker_log_dir(create: bool = True) -> str:
    """This process's worker-log directory, keyed by pid: each host
    process owns one, like the reference's per-node session logs."""
    d = os.path.join(get_config().temp_dir, "logs", f"host-{os.getpid()}")
    if create:
        os.makedirs(d, exist_ok=True)
    return d


def open_worker_log_files(worker_id_hex: str):
    """(stdout, stderr) file objects for a spawning worker process."""
    d = worker_log_dir()
    out = open(os.path.join(d, f"worker-{worker_id_hex}.out"), "ab")
    try:
        err = open(os.path.join(d, f"worker-{worker_id_hex}.err"), "ab")
    except BaseException:
        out.close()
        raise
    return out, err


class LogMonitor:
    """Tails every ``worker-*.{out,err}`` file in this process's log dir
    and ships complete new lines through ``publish(payload)``, where
    ``payload`` = ``{"worker": <id hex>, "is_err": bool,
    "lines": [str, ...], "host_pid": int}``."""

    def __init__(self, publish: Callable[[dict], None],
                 poll_interval_s: float = 0.2):
        self._publish = publish
        self._poll = poll_interval_s
        self._dir = worker_log_dir()
        self._offsets: Dict[str, int] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name="ray_tpu_torch::log_monitor")
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.scan_once()
            except Exception:
                # The reference counts it in its debug plane (ROADMAP
                # A.4b.7b); the tailer lives on.
                logger.exception("log monitor: a scan failed")
            self._stop.wait(self._poll)

    def scan_once(self):
        try:
            names = os.listdir(self._dir)
        except OSError:
            return
        for name in names:
            if not (name.startswith("worker-")
                    and (name.endswith(".out") or name.endswith(".err"))):
                continue
            path = os.path.join(self._dir, name)
            off = self._offsets.get(path, 0)
            try:
                size = os.path.getsize(path)
                if size <= off:
                    continue
                with open(path, "rb") as f:
                    f.seek(off)
                    chunk = f.read(size - off)
            except OSError:
                continue
            # Only complete lines ship; a partial last line waits for
            # its newline.
            last_nl = chunk.rfind(b"\n")
            if last_nl < 0:
                continue
            self._offsets[path] = off + last_nl + 1
            lines = chunk[:last_nl].decode("utf-8", "replace").split("\n")
            worker = name[len("worker-"):].rsplit(".", 1)[0]
            self._publish({"worker": worker,
                           "is_err": name.endswith(".err"),
                           "lines": lines,
                           "host_pid": os.getpid()})

    def stop(self):
        self._stop.set()
        # The poll thread may be mid-scan (``_offsets`` is its own):
        # wait it out before the final sweep, or a chunk ships twice.
        self._thread.join(timeout=5.0)
        try:
            self.scan_once()
        except Exception:
            logger.exception("log monitor: the final scan failed")


def start_local_monitor(publisher) -> LogMonitor:
    """A monitor that publishes straight into the GCS publisher."""
    def publish(payload: dict):
        publisher.publish(LOG_CHANNEL, payload["worker"].encode(), payload)
    return LogMonitor(publish)


# One monitor per OS process: the log dir is keyed by pid, so a second
# tailer (one WorkerPool per node of an in-process cluster) would
# publish every line again.  Counted, so that the first pool to shut
# down does not silence the others.
_local_lock = threading.Lock()
_local_monitor: Optional[LogMonitor] = None
_local_refs = 0


def acquire_local_monitor(publisher) -> None:
    global _local_monitor, _local_refs
    with _local_lock:
        if _local_monitor is None:
            _local_monitor = start_local_monitor(publisher)
        _local_refs += 1


def release_local_monitor() -> None:
    global _local_monitor, _local_refs
    with _local_lock:
        if _local_refs == 0:
            return
        _local_refs -= 1
        if _local_refs > 0:
            return
        monitor, _local_monitor = _local_monitor, None
    if monitor is not None:
        monitor.stop()


def make_log_mirror_callback(out=None, err=None):
    """The driver's mirror: prints a published worker log message with a
    ``(worker=..., pid=...)`` prefix (reference worker.py
    print_worker_logs)."""

    def cb(_key, msg):
        stream = (err or sys.stderr) if msg.get("is_err") \
            else (out or sys.stdout)
        prefix = f"(worker={msg.get('worker', '')[:8]} " \
                 f"pid={msg.get('host_pid', '?')})"
        try:
            for line in msg.get("lines", ()):
                print(f"{prefix} {line}", file=stream, flush=True)
        except (OSError, ValueError):
            pass   # the terminal is gone (a closed stream at exit)

    return cb


def mirror_worker_logs(publisher, out=None, err=None) -> int:
    """Subscribe the driver's mirror to the GCS publisher; returns the
    subscription id."""
    return publisher.subscribe(LOG_CHANNEL, None,
                               make_log_mirror_callback(out, err))
