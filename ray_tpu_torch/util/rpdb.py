"""Remote pdb: debug a task or an actor over a TCP socket on localhost.

A port of ``ray_tpu.util.rpdb`` (reference ``python/ray/util/rpdb.py``,
``ray.util.pdb.set_trace``): a task calls ``set_trace()``, a Pdb session
binds a port on a loopback address, prints where to attach on stderr,
and the developer attaches with ``nc`` (or ``connect``).  Unlike the
reference, every wait is bounded: the listener gives up after
``timeout`` seconds without a client (``TimeoutError``), and a session
whose client says nothing for ``timeout`` seconds ends with
``socket.timeout`` in the task.
"""

from __future__ import annotations

import ipaddress
import pdb
import socket
import sys

#: Seconds the listener waits for a client, and a session for a line.
DEFAULT_TIMEOUT_S = 600.0


class _SocketIO:
    def __init__(self, conn: socket.socket):
        self._file_in = conn.makefile("r")
        self._file_out = conn.makefile("w")

    def close(self):
        for f in (self._file_in, self._file_out):
            try:
                f.close()
            except OSError:
                pass

    def readline(self):
        return self._file_in.readline()

    def write(self, data):
        self._file_out.write(data)

    def flush(self):
        self._file_out.flush()


def _check_loopback(host: str) -> None:
    if host != "localhost" and not ipaddress.ip_address(host).is_loopback:
        raise ValueError(f"remote pdb binds a loopback address only, not "
                         f"{host!r}")


class RemotePdb(pdb.Pdb):
    """Pdb bound to a TCP listener on localhost; one attach per
    breakpoint."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 timeout: float = DEFAULT_TIMEOUT_S):
        _check_loopback(host)
        self._listener = socket.socket(socket.AF_INET,
                                       socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(1)
        self._listener.settimeout(timeout)
        self.address = self._listener.getsockname()
        print(f"RemotePdb waiting on {self.address[0]}:"
              f"{self.address[1]} — attach with "
              f"`nc {self.address[0]} {self.address[1]}`",
              file=sys.stderr, flush=True)
        try:
            conn, _ = self._listener.accept()
        except socket.timeout:
            self._listener.close()
            raise TimeoutError(
                f"no debugger attached to {self.address[0]}:"
                f"{self.address[1]} within {timeout} s") from None
        conn.settimeout(timeout)
        self._conn = conn
        self._io = _SocketIO(conn)
        super().__init__(stdin=self._io, stdout=self._io)
        self.prompt = "(remote-pdb) "

    def do_continue(self, arg):
        out = super().do_continue(arg)
        self._close()
        return out

    do_c = do_cont = do_continue

    def do_quit(self, arg):
        out = super().do_quit(arg)
        self._close()
        return out

    do_q = do_exit = do_quit

    def _close(self):
        # The socket's files hold it open: close them, so that the
        # client sees the end of the session.
        self._io.close()
        for s in (self._conn, self._listener):
            try:
                s.close()
            except OSError:
                pass


def set_trace(host: str = "127.0.0.1", port: int = 0, frame=None,
              timeout: float = DEFAULT_TIMEOUT_S):
    """Breakpoint inside a task or an actor: waits up to ``timeout``
    seconds for a client, then drives a pdb session over the socket."""
    debugger = RemotePdb(host=host, port=port, timeout=timeout)
    debugger.set_trace(frame or sys._getframe().f_back)


def connect(host: str, port: int, timeout: float = DEFAULT_TIMEOUT_S):
    """A client socket to a waiting session (``nc``'s stand-in for
    tests and hosts without netcat)."""
    _check_loopback(host)
    return socket.create_connection((host, port), timeout=timeout)
