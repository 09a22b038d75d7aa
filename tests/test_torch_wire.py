"""The port's framed RPC (``ray_tpu_torch.rpc``) against the JAX
package's (``ray_tpu.rpc``), on the CPU.

Every case of ``tests/test_wire_transport.py``'s ``TestRpcLayer`` and
``TestWireVersioning`` runs on each package's server and client; the
dedup window and the chunk pipeline (``tests/test_network_chaos.py``'s
``TestDedupWindow`` without its fault points, which wait for the port's
fault plane, and ``tests/test_data_plane.py``'s ``TestChunkPipeline``)
likewise.  A plain message and the preamble encode to the same bytes in
both packages, a port client talks to a reference server and back, and
the verb registries are the reference's.  The last test checks that no
thread of the port outlives its servers and clients.
"""

import importlib
import socket
import struct
import threading
import time

import numpy as np
import pytest

PORT = "ray_tpu_torch"
PKGS = ["ray_tpu", PORT]


def _rpc(name):
    return importlib.import_module(f"{name}.rpc")


def _wire(name):
    return importlib.import_module(f"{name}.rpc.wire")


def _config(name):
    return importlib.import_module(f"{name}._private.config").get_config()


# -- TestRpcLayer -------------------------------------------------------------

@pytest.mark.parametrize("name", PKGS)
def test_roundtrip_and_errors(name):
    rpc = _rpc(name)
    server = rpc.RpcServer(name="t")
    server.register("echo", lambda p: p)

    def boom(_p):
        raise ValueError("kaboom")

    server.register("boom", boom)
    client = rpc.RpcClient(server.address)
    try:
        assert client.call("echo", {"x": [1, 2, 3]}) == {"x": [1, 2, 3]}
        with pytest.raises(rpc.RpcError, match="kaboom"):
            client.call("boom", None)
        with pytest.raises(rpc.RpcError, match="no such method"):
            client.call("nope", None)
        # The connection survives handler errors.
        assert client.call("echo", b"still alive") == b"still alive"
    finally:
        client.close()
        server.stop()


@pytest.mark.parametrize("name", PKGS)
def test_concurrent_calls_one_connection(name):
    """A slow handler does not stall pipelined calls on the same
    connection."""
    rpc = _rpc(name)
    server = rpc.RpcServer(name="t2")
    release = threading.Event()
    server.register("slow",
                    lambda _p: (release.wait(10.0), "slow-done")[1])
    server.register("fast", lambda p: p * 2)
    client = rpc.RpcClient(server.address)
    try:
        slow_fut = client.call_future("slow", None)
        assert client.call("fast", 21, timeout=5.0) == 42
        assert not slow_fut.done()
        release.set()
        assert slow_fut.result(timeout=5.0) == "slow-done"
    finally:
        release.set()
        client.close()
        server.stop()


@pytest.mark.parametrize("name", PKGS)
def test_large_payload(name):
    """12 MB crosses the socket intact."""
    rpc = _rpc(name)
    server = rpc.RpcServer(name="t3")
    server.register("sum", lambda p: (len(p), p[:8], p[-8:]))
    client = rpc.RpcClient(server.address)
    try:
        blob = np.random.default_rng(3).integers(
            0, 256, 12 * 1024 * 1024, dtype=np.uint8).tobytes()
        n, head, tail = client.call("sum", blob, timeout=30.0)
        assert n == len(blob)
        assert head == blob[:8] and tail == blob[-8:]
    finally:
        client.close()
        server.stop()


@pytest.mark.parametrize("name", PKGS)
def test_async_handler(name):
    """register_async: the reply fires from a callback."""
    rpc = _rpc(name)
    server = rpc.RpcServer(name="t4")
    pending = []
    server.register_async("lease", lambda p, cb: pending.append((p, cb)))
    client = rpc.RpcClient(server.address)
    try:
        fut = client.call_future("lease", "spec")
        deadline = time.monotonic() + 5.0
        while not pending and time.monotonic() < deadline:
            time.sleep(0.01)
        payload, cb = pending[0]
        assert payload == "spec"
        cb({"worker": "w1"})
        assert fut.result(timeout=5.0) == {"worker": "w1"}
    finally:
        client.close()
        server.stop()


@pytest.mark.parametrize("name", PKGS)
def test_connection_loss_fails_pending(name):
    rpc = _rpc(name)
    server = rpc.RpcServer(name="t5")
    server.register_async("forever", lambda p, cb: None)  # never replies
    client = rpc.RpcClient(server.address)
    try:
        fut = client.call_future("forever", None)
        time.sleep(0.1)
        server.stop()
        with pytest.raises(rpc.RpcConnectionError):
            fut.result(timeout=5.0)
    finally:
        client.close()
        server.stop()


# -- TestWireVersioning -------------------------------------------------------

@pytest.mark.parametrize("name", PKGS)
def test_preamble_negotiation_and_mismatch_rejected(name):
    """A connection opens with MAGIC+version; a peer of another version,
    or not of the protocol at all, is dropped before any message."""
    rpc, wire = _rpc(name), _wire(name)
    server = rpc.RpcServer(name="verstest")
    server.register("echo", lambda p: p)
    try:
        client = rpc.RpcClient(server.address)
        assert client.call("echo", 7, timeout=10) == 7
        client.close()

        raw = socket.create_connection(server.address, timeout=5)
        raw.sendall(struct.Struct("!4sH").pack(wire.WIRE_MAGIC, 999))
        wire.send_msg(raw, (1, "echo", "x"))
        raw.settimeout(5)
        with pytest.raises((wire.ConnectionClosed, OSError)):
            wire.recv_msg(raw)
        raw.close()

        raw2 = socket.create_connection(server.address, timeout=5)
        raw2.sendall(b"GET / HTTP/1.1\r\n\r\n")
        raw2.settimeout(5)
        with pytest.raises((wire.ConnectionClosed, OSError)):
            wire.recv_msg(raw2)
        raw2.close()
    finally:
        server.stop()


# -- byte parity --------------------------------------------------------------

def _written(name, write):
    """The bytes ``write(sock)`` puts on a socket."""
    a, b = socket.socketpair()
    try:
        write(_wire(name), a)
        a.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return out
            out += chunk
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("msg", [
    (1, "echo", {"x": [1, 2, 3], "y": "z"}),
    (7, "add_location", {"object_id": b"\x01" * 28, "size": 12},
     b"\x02" * 16),
    (3, True, [1.5, None, (b"blob", "text")]),
    (2**31, "register_worker", {"worker_id": "ab" * 14, "port": 40123,
                                "pid": 4242}),
], ids=["request", "dedup-request", "reply", "register"])
def test_plain_message_encodes_to_the_reference_bytes(msg):
    want = _written("ray_tpu", lambda w, s: w.send_msg(s, msg))
    got = _written(PORT, lambda w, s: w.send_msg(s, msg))
    assert got == want
    assert int.from_bytes(got[:4], "big") == len(got) - 4


def test_preamble_is_the_reference_bytes():
    want = _written("ray_tpu", lambda w, s: w.send_preamble(s))
    got = _written(PORT, lambda w, s: w.send_preamble(s))
    assert got == want == b"RTPU\x00\x01"


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [(PORT, "ray_tpu"), ("ray_tpu", PORT)])
def test_port_and_reference_speak_to_each_other(client_pkg, server_pkg):
    server = _rpc(server_pkg).RpcServer(name="cross")
    server.register("echo", lambda p: p)
    server.register("add_location", lambda p: ("added", p))
    client = _rpc(client_pkg).RpcClient(server.address)
    try:
        assert client.call("echo", [1, {"a": b"b"}], timeout=10) == \
            [1, {"a": b"b"}]
        assert client.call("add_location", 5, timeout=10) == ("added", 5)
    finally:
        client.close()
        server.stop()


def test_verb_registries_are_the_reference_ones():
    want = importlib.import_module("ray_tpu.rpc.verbs")
    got = importlib.import_module(f"{PORT}.rpc.verbs")
    for registry in ("IDEMPOTENT_VERBS", "DEDUP_VERBS", "CONTROL_VERBS",
                     "NO_RETRY_VERBS"):
        assert getattr(got, registry) == getattr(want, registry), registry
    for verb in sorted(want.IDEMPOTENT_VERBS | want.DEDUP_VERBS |
                       want.NO_RETRY_VERBS | {"echo"}):
        assert got.classify(verb) == want.classify(verb)
        assert got.is_retryable(verb) == want.is_retryable(verb)


# -- the dedup window ---------------------------------------------------------

@pytest.mark.parametrize("name", PKGS)
def test_duplicate_delivery_of_a_token_runs_the_handler_once(name):
    """Two frames with one dedup token: the handler runs once, and both
    get its reply (the window records it)."""
    rpc, wire = _rpc(name), _wire(name)
    server = rpc.RpcServer(name="dedup")
    runs = []
    server.register("add_location",
                    lambda p: (runs.append(p), len(runs))[1])
    sock = wire.connect(server.address)
    try:
        token = b"\x05" * 16
        for msg_id in (1, 2):
            wire.send_msg(sock, (msg_id, "add_location", {"k": 1}, token))
        sock.settimeout(10)
        replies = sorted([wire.recv_msg(sock), wire.recv_msg(sock)])
        assert replies == [(1, True, 1), (2, True, 1)]
        assert runs == [{"k": 1}] and server.dedup_window.hits == 1
    finally:
        sock.close()
        server.stop()


@pytest.mark.parametrize("name", PKGS)
def test_retry_of_a_slow_mutating_verb_runs_it_once(name):
    """``call`` times out on a slow handler of a dedup verb and retries
    under the same token: the retry parks on the first run, which runs
    once and answers both."""
    rpc = _rpc(name)
    cfg = _config(name)
    old = (cfg.rpc_retry_attempts, cfg.rpc_retry_backoff_s)
    cfg.rpc_retry_attempts, cfg.rpc_retry_backoff_s = 3, 0.05
    server = rpc.RpcServer(name="retry")
    runs = []

    def slow(p):
        runs.append(p)
        time.sleep(0.6)
        return len(runs)

    server.register("add_location", slow)
    client = rpc.RpcClient(server.address)
    try:
        assert client.call("add_location", {"k": 2}, timeout=0.4) == 1
        assert runs == [{"k": 2}]
        assert server.dedup_window.hits >= 1
    finally:
        cfg.rpc_retry_attempts, cfg.rpc_retry_backoff_s = old
        client.close()
        server.stop()


@pytest.mark.parametrize("name", PKGS)
def test_handler_error_is_never_retried(name):
    rpc = _rpc(name)
    server = rpc.RpcServer(name="err")
    runs = []

    def boom(_p):
        runs.append(1)
        raise ValueError("deterministic kaboom")

    server.register("add_location", boom)
    client = rpc.RpcClient(server.address)
    try:
        with pytest.raises(rpc.RpcError, match="kaboom"):
            client.call("add_location", {}, timeout=10.0)
        time.sleep(0.2)
        assert len(runs) == 1
    finally:
        client.close()
        server.stop()


# -- the chunk pipeline -------------------------------------------------------

@pytest.mark.parametrize("name", PKGS)
def test_windowed_chunk_pipeline_reassembles(name):
    rpc = _rpc(name)
    chunked = importlib.import_module(f"{name}.rpc.chunked")
    cfg = _config(name)
    old_chunk = cfg.object_manager_chunk_size
    cfg.object_manager_chunk_size = 64 * 1024
    blob = np.random.default_rng(7).integers(
        0, 256, 1_000_000, dtype=np.uint8).tobytes()
    server = rpc.RpcServer(name="chunk-test")
    cs = chunked.serve_chunks(server, lambda key: blob)
    client = rpc.RpcClient(server.address)
    try:
        meta = client.call("fetch_meta", {"object_id": b"k"})
        assert "token" in meta and meta["size"] == len(blob)
        out = bytearray(meta["size"])
        window_peak = [0]

        def on_chunk(_n, inflight):
            window_peak[0] = max(window_peak[0], inflight)

        assert chunked.fetch_session_into(
            client, meta,
            lambda off, data: out.__setitem__(slice(off, off + len(data)),
                                              data),
            pipeline=6, on_chunk=on_chunk)
        assert bytes(out) == blob and window_peak[0] >= 2
        # Small objects come back inline; a session is closed after.
        assert chunked.fetch_chunked(client, b"k") == blob
        small = chunked.ChunkServer(lambda key: b"tiny")
        assert small.handle_meta({"object_id": b"s"}) == {"inline": b"tiny"}
        deadline = time.monotonic() + 5
        while cs.handle_chunk({"token": meta["token"], "index": 0}) \
                is not None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert cs.handle_chunk({"token": meta["token"], "index": 0}) is None
    finally:
        cfg.object_manager_chunk_size = old_chunk
        client.close()
        server.stop()


def test_no_port_thread_survives_stop():
    """Runs last in this file: a port server and client leave no thread
    once stopped and closed."""
    rpc = _rpc(PORT)
    server = rpc.RpcServer(name="last")
    server.register("echo", lambda p: p)
    client = rpc.RpcClient(server.address)
    assert [client.call("echo", i) for i in range(10)] == list(range(10))
    client.close()
    server.stop()
    left = [t.name for t in threading.enumerate()
            if t.name.startswith(f"{PORT}::")]
    assert not left, left
