"""The port's RPC tier on the CPU, mirroring the JAX package's
``tests/test_rpc.py``: framed wire protocol (codec payloads, typed
faults), the in-process WorkerServer protocol contract, and RpcWorker
subprocess workers (``python -m repro_torch.rpc.worker --device cpu``)
under the fleet router — placement, kill-mid-decode failover,
readmission, and wire-sabotage retry, all token-exact and exactly-once.

Against the JAX package: ``pack_tensor`` meta and bytes, and whole
frames, equal byte for byte for every codec in f32 and bf16; and the
ROADMAP gate, a mixed fleet — a JAX worker (the JAX package's own
``WorkerServer``, in a subprocess that dumps its params) and a port
worker loaded from those params — serves greedy requests through the
port's router across a SIGKILL of either worker, every request once and
token-exact against the JAX ``session.generate``.

Every test that starts a subprocess runs under a wall-clock deadline
(SIGALRM) and kills its children in a ``finally``.
"""
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import zlib

import numpy as np
import pytest
import torch

from repro_torch.rpc import (FRAME_OVERHEAD, PROTOCOL_VERSION, FrameError,
                       RpcWorker, WireClosed, WireTimeout, pack_tensor,
                       recv_message, send_message, unpack_tensor)
from repro_torch.rpc.wire import (MAGIC, _FRAME, CompletionMsg, Heartbeat, Hello,
                            HelloAck, Message, SubmitRequest, TokenChunk)
from repro_torch.transport.codecs import CodecSpec, get_codec, list_codecs
from repro_torch.serving.queue import Request


DEADLINE_S = 240


@pytest.fixture()
def deadline():
    """Fail, rather than hang, a test whose worker is stuck."""
    def expired(*_):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")
    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _close(workers):
    """Shut every worker down; SIGKILL any that does not go."""
    for w in workers:
        try:
            w.close()
        except Exception:
            w.kill_process()


def _rand(shape, seed=0, dtype=np.float32):
    return np.random.RandomState(seed).randn(*shape).astype(dtype)


@pytest.fixture(scope="module", autouse=True)
def _pristine_codec_registry():
    """The in-process WorkerServer rig answers ``Calibrate`` by running
    ``calibrate_codec_bws`` *in this process*, which shadows the modeled
    ``decode_bw`` constants on the shared codec registry instances —
    restore them so later test modules sweep against the documented
    constants (subprocess workers calibrate in their own process and
    never touch this one)."""
    saved = {n: dict(get_codec(n).__dict__) for n in list_codecs()}
    yield
    for n, state in saved.items():
        codec = get_codec(n)
        codec.__dict__.clear()
        codec.__dict__.update(state)


# ---------------------------------------------------------------------------
# tensor packing through the codec registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,spec", [
    ("identity", CodecSpec()),
    ("int8", CodecSpec()),
    ("int8", CodecSpec(param=8)),
    ("int4", CodecSpec()),
    ("topk", CodecSpec(param=4)),
    ("segment_means", CodecSpec(L=4)),
])
@pytest.mark.parametrize("shape", [(2, 8, 32), (1, 4, 4, 16)])
def test_pack_tensor_wire_bytes_and_bit_exact(name, spec, shape):
    """The packed blob is exactly ``wire_bytes`` long and unpacking is
    bit-exact with a local decode of the same encoded payload."""
    x = _rand(shape, seed=sum(map(ord, name)) % 100)
    codec = get_codec(name)
    meta, blob = pack_tensor(x, name, spec)
    assert len(blob) == codec.wire_bytes(x.shape, x.dtype, spec)
    local = codec.decode(codec.encode(torch.from_numpy(x), spec), spec,
                         shape=x.shape, dtype=torch.float32)
    np.testing.assert_array_equal(unpack_tensor(meta, blob).numpy(),
                                  local.numpy())


def test_pack_tensor_int_identity_roundtrip():
    x = np.arange(-5, 11, dtype=np.int32).reshape(4, 4)
    meta, blob = pack_tensor(x, "identity")
    np.testing.assert_array_equal(unpack_tensor(meta, blob).numpy(), x)


def test_unpack_truncated_payload_is_frame_error():
    meta, blob = pack_tensor(_rand((2, 8, 32)), "int8")
    with pytest.raises(FrameError):
        unpack_tensor(meta, blob[:-1])
    with pytest.raises(FrameError):
        unpack_tensor(meta, blob + b"\x00")


# ---------------------------------------------------------------------------
# framing across a real socket
# ---------------------------------------------------------------------------

@pytest.fixture()
def pair():
    a, b = socket.socketpair()
    a.settimeout(5.0)
    b.settimeout(5.0)
    yield a, b
    a.close()
    b.close()


@pytest.mark.parametrize("name", sorted(list_codecs()))
def test_framed_codec_roundtrip_over_socket(pair, name):
    """Every registered codec: framed encode → send → recv → decode is
    bit-exact, and bytes-on-wire equals FRAME_OVERHEAD + header +
    ``codec.wire_bytes`` — the exact quantity the policy table sweeps."""
    a, b = pair
    spec = CodecSpec(L=4, param=4)
    x = _rand((2, 8, 32), seed=7)
    msg = SubmitRequest(request_id=9, n_new=3, seed=1, codec=name,
                        codec_l=spec.L, codec_param=spec.param, prompt=x)
    sent = send_message(a, msg)
    got, read = recv_message(b)
    assert sent == read
    # the frame's payload length IS the codec's wire accounting — parse it
    # out of the bytes that actually crossed the socket
    codec = get_codec(name)
    head = msg.encode_frame()[:FRAME_OVERHEAD]
    _, _, _, hlen, plen, _ = _FRAME.unpack(head)
    assert plen == codec.wire_bytes(x.shape, x.dtype, spec)
    assert sent == FRAME_OVERHEAD + hlen + plen
    local = codec.decode(codec.encode(torch.from_numpy(x), spec), spec,
                         shape=x.shape, dtype=torch.float32)
    np.testing.assert_array_equal(got.prompt.numpy(), local.numpy())
    assert (got.request_id, got.n_new, got.codec) == (9, 3, name)


def test_scalar_only_message_roundtrip(pair):
    a, b = pair
    send_message(a, Heartbeat(seq=3, t=1.5, pong=True,
                              stats={"served": 2, "tok": 5}))
    got, _ = recv_message(b)
    assert isinstance(got, Heartbeat) and got.pong
    assert got.stats == {"served": 2, "tok": 5}


def test_truncated_frame_is_typed_wire_closed(pair):
    a, b = pair
    frame = Heartbeat(seq=1).encode_frame()
    a.sendall(frame[: len(frame) // 2])
    a.close()
    with pytest.raises(WireClosed, match="mid-frame"):
        recv_message(b)


def test_clean_close_at_boundary_is_wire_closed(pair):
    a, b = pair
    a.close()
    with pytest.raises(WireClosed, match="closed the connection"):
        recv_message(b)


def test_recv_timeout_is_wire_timeout(pair):
    _, b = pair
    with pytest.raises(WireTimeout):
        recv_message(b, timeout=0.05)


def test_corrupt_crc_is_frame_error(pair):
    a, b = pair
    frame = bytearray(Heartbeat(seq=1).encode_frame())
    frame[-1] ^= 0xFF                      # flip a payload/header byte
    a.sendall(bytes(frame))
    with pytest.raises(FrameError, match="CRC"):
        recv_message(b)


def test_bad_magic_is_frame_error(pair):
    a, b = pair
    frame = b"XX" + Heartbeat(seq=1).encode_frame()[2:]
    a.sendall(frame)
    with pytest.raises(FrameError, match="magic"):
        recv_message(b)


def test_newer_protocol_version_rejected(pair):
    """Versioning rule: accept <= PROTOCOL_VERSION, reject newer frames."""
    a, b = pair
    frame = bytearray(Heartbeat(seq=1).encode_frame())
    struct.pack_into(">H", frame, 2, PROTOCOL_VERSION + 1)
    a.sendall(bytes(frame))
    with pytest.raises(FrameError, match="protocol"):
        recv_message(b)


def test_implausible_lengths_rejected(pair):
    a, b = pair
    head = _FRAME.pack(MAGIC, PROTOCOL_VERSION, Heartbeat.KIND,
                       1 << 30, 0, 0)
    a.sendall(head)
    with pytest.raises(FrameError, match="implausible"):
        recv_message(b)


def test_unknown_header_fields_ignored():
    """Forward compatibility: a newer peer may add header fields; this
    build must decode the frame and drop what it doesn't know."""
    import json
    header = json.dumps({"f": {"seq": 4, "from_the_future": True},
                         "t": []}).encode()
    got = Message.decode_frame(Heartbeat.KIND, header, b"")
    assert isinstance(got, Heartbeat) and got.seq == 4
    with pytest.raises(FrameError, match="unknown message kind"):
        Message.decode_frame(250, header, b"")


def test_all_typed_errors_are_retryable_transport_errors():
    from repro_torch.transport.links import TransportError
    for cls in (WireTimeout, WireClosed, FrameError):
        e = cls("boom", worker="w")
        assert isinstance(e, TransportError) and e.retryable
        assert e.stage.startswith("rpc-")


# ---------------------------------------------------------------------------
# WorkerServer protocol contract (in-process, over a socketpair)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def server_rig():
    """One WorkerServer on a thread + a raw client socket, plus a local
    reference session with identical parameters (the token-exact oracle)."""
    from repro_torch.rpc.worker import WorkerServer, build_session
    session, hardware, link = build_session("llama3.2-1b", vocab=64, seed=0,
                                            device="cpu")
    session.profile(backend="simulated", hardware=hardware, link=link)
    server = WorkerServer(session, name="inproc", arch="llama3.2-1b",
                          n_slots=2, chunk=3, max_len=24,
                          hardware=hardware, link=link)
    client, conn = socket.socketpair()
    client.settimeout(30.0)
    t = threading.Thread(target=server.serve_conn, args=(conn,), daemon=True)
    t.start()
    yield client, server, session
    server._shutdown = True
    client.close()
    conn.close()
    t.join(timeout=5.0)


def _ask(client, msg, want, deadline_s=60.0):
    """Send and pump until a `want` arrives; returns (reply, others)."""
    send_message(client, msg)
    others = []
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        got, _ = recv_message(client, timeout=deadline_s)
        if isinstance(got, want):
            return got, others
        others.append(got)
    raise AssertionError(f"no {want.__name__} within {deadline_s}s")


def test_server_hello_describes_runtime(server_rig):
    client, server, _ = server_rig
    ack, _ = _ask(client, Hello(name="t"), HelloAck)
    assert (ack.n_slots, ack.chunk, ack.max_len) == (2, 3, 24)
    assert ack.arch == "llama3.2-1b"


def test_server_serves_token_exact_and_streams(server_rig):
    client, server, session = server_rig
    prompt = np.arange(1, 6, dtype=np.int32)
    sub = SubmitRequest(request_id=42, n_new=6, seed=11, prompt=prompt)
    done, others = _ask(client, sub, CompletionMsg)
    assert done.request_id == 42
    want = np.asarray(session.generate(prompt[None], 6, seed=11)[0])
    np.testing.assert_array_equal(np.asarray(done.tokens), want)
    # decode progress streamed as TokenChunk frames covering tokens 1..n-1
    chunks = [m for m in others if isinstance(m, TokenChunk)]
    assert chunks and chunks[0].start == 1
    streamed = np.concatenate([np.asarray(c.tokens) for c in chunks])
    np.testing.assert_array_equal(streamed, want[1:1 + len(streamed)])


def test_server_dedups_duplicate_submit(server_rig):
    """Exactly-once: re-submitting a finished id re-sends the cached
    completion (same tokens) instead of decoding twice."""
    client, server, _ = server_rig
    before = server.stats["submits"]
    sub = SubmitRequest(request_id=42, n_new=6, seed=11,
                        prompt=np.arange(1, 6, dtype=np.int32))
    done, _ = _ask(client, sub, CompletionMsg)
    assert done.request_id == 42
    assert server.stats["submits"] == before       # not admitted again
    assert server.stats["dup_submits"] >= 1


def test_server_heartbeat_pong_carries_stats(server_rig):
    client, _, _ = server_rig
    pong, _ = _ask(client, Heartbeat(seq=77, t=1.0), Heartbeat)
    assert pong.pong and pong.seq == 77
    assert pong.stats["completed"] >= 1 and "pid" in pong.stats
    assert pong.stats["submits"] >= 1


def test_server_calibrate_is_measured(server_rig):
    from repro_torch.rpc.wire import Calibrate, CalibrateResult
    client, server, _ = server_rig
    res, _ = _ask(client, Calibrate(shape=(2, 16, 64), iters=1, warmup=0),
                  CalibrateResult, deadline_s=300.0)
    assert res.measured
    want = {n for n in list_codecs()
            if type(get_codec(n)).decode_bw > 0
            and not get_codec(n).summarizing}
    assert set(res.bws) == want and want
    assert all(v > 0 for v in res.bws.values())
    assert server.stats["calibrations"] >= 1


def test_server_drops_conn_on_garbage(server_rig):
    """Stream desync is unrecoverable: the server must close rather than
    guess at framing (the client reconnects and re-submits)."""
    client, server, _ = server_rig
    errs = server.stats["frame_errors"]
    client.sendall(b"ZZ" + bytes(FRAME_OVERHEAD))
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and server.stats["frame_errors"] == errs:
        time.sleep(0.02)
    assert server.stats["frame_errors"] == errs + 1


# ---------------------------------------------------------------------------
# RpcWorker subprocess fleet: placement, failover, readmission
# (ordered tests sharing one spawned fleet — subprocesses are expensive)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rpc_fleet():
    from repro_torch.fleet import DeviceRegistry, FleetRouter
    from repro_torch.rpc.worker import build_session
    from repro_torch.runtime.fault import RetryPolicy
    reg = DeviceRegistry(heartbeat_timeout_s=30.0)
    # liveness timer is NOT what these tests exercise (kill discovery is
    # via failed reconnects) — keep it far above any CPU-starved JIT
    # compile so loaded machines can't false-positive both workers dead
    kw = dict(vocab=64, seed=0, n_slots=2, chunk=3, max_len=24,
              heartbeat_timeout_s=300.0, device="cpu", connect_timeout_s=120.0,
              retry=RetryPolicy(max_retries=3, backoff_base_s=0.02))
    workers = []
    try:
        workers.append(RpcWorker("w1", **kw))
        workers.append(RpcWorker("w2", **kw))
        w1, w2 = workers
        reg.add(w1)
        reg.add(w2)
        router = FleetRouter(reg, retry=RetryPolicy(max_retries=3))
        ref, _, _ = build_session("llama3.2-1b", vocab=64, seed=0,
                                  device="cpu")
        yield dict(reg=reg, router=router, w1=w1, w2=w2, ref=ref)
    finally:
        _close(workers)


def _oracle(ref, req):
    return np.asarray(ref.generate(np.asarray(req.prompt)[None],
                                   req.n_new, seed=req.seed)[0])


def test_rpc_fleet_calibration_is_measured(rpc_fleet, deadline):
    """DeviceRegistry.add routes calibration through the worker process —
    provenance says measured, and the numbers exist for every lossy codec."""
    want = {n for n in list_codecs()
            if type(get_codec(n)).decode_bw > 0
            and not get_codec(n).summarizing}
    for w in (rpc_fleet["w1"], rpc_fleet["w2"]):
        assert w.codec_bws_measured
        assert set(w.codec_bws) == want and want
        assert w.policy is not None          # profiled over the wire


def test_rpc_fleet_placement_token_exact(rpc_fleet, deadline):
    router, ref = rpc_fleet["router"], rpc_fleet["ref"]
    reqs = [Request(prompt=np.arange(1, 5 + i, dtype=np.int32), n_new=6,
                    seed=100 + i) for i in range(4)]
    for r in reqs:
        router.route(r)
    done = router.run()
    assert sorted(c.request_id for c in done) == sorted(r.id for r in reqs)
    by_id = {c.request_id: c for c in done}
    for r in reqs:
        np.testing.assert_array_equal(np.asarray(by_id[r.id].tokens),
                                      _oracle(ref, r))
    assert router.stats["lost"] == 0


class _OneShotChaos:
    """Minimal ChaosController stand-in: arm one dispatch fault."""

    def __init__(self, kind):
        from repro_torch.chaos.schedule import ChaosEvent
        self._armed = [ChaosEvent(t=0.0, kind=kind, target="?")]

    def dispatch_fault(self, worker, now):
        return self._armed.pop(0) if self._armed else None


def test_rpc_truncated_frame_retried_not_dropped(rpc_fleet, deadline):
    """Wire sabotage (half a frame + hard close) surfaces as a typed
    TransportError, backs off, reconnects, re-submits — never loses the
    request."""
    router, w2, ref = rpc_fleet["router"], rpc_fleet["w2"], rpc_fleet["ref"]
    errs0 = w2.stats["transport_errors"]
    reconn0 = w2.stats["reconnects"]
    req = Request(prompt=np.arange(1, 7, dtype=np.int32), n_new=5, seed=400)
    w2.chaos = _OneShotChaos("error")        # armed: next step sabotages
    router.route(req, pin="w2")
    done = router.run()
    w2.chaos = None
    assert [c.request_id for c in done] == [req.id]
    np.testing.assert_array_equal(np.asarray(done[0].tokens),
                                  _oracle(ref, req))
    assert w2.stats["transport_errors"] == errs0 + 1
    assert w2.stats["reconnects"] == reconn0 + 1   # capped-backoff retry
    assert w2.healthy and w2.stats["retries"] >= 1
    assert router.stats["lost"] == 0


def test_rpc_kill_mid_decode_fails_over_token_exact(rpc_fleet, deadline):
    """The tentpole scenario against a real process: SIGKILL w1 with work
    in flight → its breaker opens on genuine reconnect failures → the
    router drains the wire mirror and re-routes EDF to w2 — exactly once,
    token-exact."""
    reg, router = rpc_fleet["reg"], rpc_fleet["router"]
    w1, ref = rpc_fleet["w1"], rpc_fleet["ref"]
    reqs = [Request(prompt=np.arange(1, 6, dtype=np.int32), n_new=8,
                    seed=200 + i) for i in range(3)]
    for r in reqs:
        router.route(r, pin="w1")
    router.step()                            # at least one lands in-flight
    w1.kill_process()                        # real SIGKILL, state is gone
    done = router.run()
    assert sorted(c.request_id for c in done) == sorted(r.id for r in reqs)
    assert all(c.worker == "w2" for c in done)
    by_id = {c.request_id: c for c in done}
    for r in reqs:
        np.testing.assert_array_equal(np.asarray(by_id[r.id].tokens),
                                      _oracle(ref, r))
    assert router.breaker("w1").opened_total >= 1
    assert not w1.healthy and not reg.is_alive("w1")
    assert router.stats["lost"] == 0 and router.stats["rerouted"] >= len(reqs)


def test_rpc_readmit_respawns_process(rpc_fleet, deadline):
    """Re-admission after a real process death: fresh subprocess, fresh
    socket, re-measured calibration, placeable and token-exact again."""
    reg, router = rpc_fleet["reg"], rpc_fleet["router"]
    w1, ref = rpc_fleet["w1"], rpc_fleet["ref"]
    old_pid = w1.proc.pid
    router.readmit("w1")
    assert w1.healthy and reg.is_alive("w1")
    assert w1.proc.pid != old_pid and w1.proc.poll() is None
    assert w1.codec_bws_measured
    req = Request(prompt=np.arange(1, 4, dtype=np.int32), n_new=5, seed=300)
    router.route(req, pin="w1")
    done = router.run()
    assert [c.request_id for c in done] == [req.id]
    assert done[0].worker == "w1"
    np.testing.assert_array_equal(np.asarray(done[0].tokens),
                                  _oracle(ref, req))


# ---------------------------------------------------------------------------
# against the JAX package: frames byte for byte, and the mixed fleet
# ---------------------------------------------------------------------------

FRAME_CODECS = [("identity", CodecSpec()), ("int8", CodecSpec()),
                ("int8", CodecSpec(param=8)), ("int4", CodecSpec(param=8)),
                ("topk", CodecSpec(param=4)),
                ("segment_means", CodecSpec(L=4))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,spec", FRAME_CODECS)
def test_pack_tensor_equals_the_jax_packages_byte_for_byte(name, spec,
                                                           dtype):
    """The same tensor packs to the same meta and bytes in both packages,
    and each package unpacks the other's blob to the same values (bf16
    carried as its 16-bit pattern, with no ``ml_dtypes`` in the port)."""
    import ml_dtypes
    from repro.rpc import wire as jwire
    from repro.transport.codecs import CodecSpec as JSpec
    x = _rand((2, 8, 32), seed=5)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    jspec = JSpec(L=spec.L, param=spec.param)
    jmeta, jblob = jwire.pack_tensor(x, name, jspec)
    meta, blob = pack_tensor(x, name, spec)
    assert meta == jmeta and blob == jblob
    ours = unpack_tensor(jmeta, jblob)
    theirs = np.asarray(jwire.unpack_tensor(meta, blob))
    assert str(ours.dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(ours.float().numpy(),
                                  theirs.astype(np.float32))


@pytest.mark.parametrize("name,spec", FRAME_CODECS)
def test_frames_equal_the_jax_packages_byte_for_byte(name, spec):
    """Whole frames: a SubmitRequest carrying a codec payload and a
    CompletionMsg with tokens leave both packages as the same bytes, and
    each package decodes the other's."""
    from repro.rpc import wire as jwire
    x = _rand((2, 8, 32), seed=3)
    kw = dict(request_id=7, n_new=4, seed=2, temperature=0.5, slo_ms=80.0,
              codec=name, codec_l=spec.L, codec_param=spec.param,
              trace_id="req:7", parent_span="c:1")
    jframe = jwire.SubmitRequest(prompt=x, **kw).encode_frame()
    assert SubmitRequest(prompt=x, **kw).encode_frame() == jframe
    toks = np.arange(9, dtype=np.int32)
    done = dict(request_id=7, plan_key="local", admitted_ts=1.5,
                finished_ts=2.25, wire_bytes=12, tokens=toks)
    assert (CompletionMsg(**done).encode_frame()
            == jwire.CompletionMsg(**done).encode_frame())
    head = jframe[:FRAME_OVERHEAD]
    _, _, kind, hlen, plen, _ = _FRAME.unpack(head)
    got = Message.decode_frame(kind, jframe[FRAME_OVERHEAD:
                                            FRAME_OVERHEAD + hlen],
                               jframe[FRAME_OVERHEAD + hlen:])
    back = jwire.Message.decode_frame(
        kind, jframe[FRAME_OVERHEAD:FRAME_OVERHEAD + hlen],
        jframe[FRAME_OVERHEAD + hlen:])
    assert (got.request_id, got.codec, got.trace_id) == (7, name, "req:7")
    np.testing.assert_array_equal(got.prompt.numpy(), np.asarray(back.prompt))


JAX_WORKER = '''
import sys

import numpy as np

from repro.api import ExecutionPlan, InferenceSession
from repro.profiling.hardware import JETSON_ORIN_NANO, WIFI_GLOO
from repro.rpc.worker import WorkerServer

path = sys.argv[1]
session = InferenceSession.from_config(
    "llama3.2-1b", [ExecutionPlan.local(), ExecutionPlan.prism_sim(L=4, cr=9.9)],
    reduced={"vocab_size": 64, "dtype": "float32"}, seed=0)
flat = {}


def walk(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            walk(prefix + [k], v)
    else:
        flat["/".join(prefix)] = np.asarray(tree)


walk([], session.params)
np.savez(path, **flat)
session.profile(backend="simulated", hardware=JETSON_ORIN_NANO, link=WIFI_GLOO)
WorkerServer(session, name="jax", arch="llama3.2-1b", n_slots=2, chunk=3,
             max_len=24, hardware=JETSON_ORIN_NANO,
             link=WIFI_GLOO).serve_forever("127.0.0.1", 0)
'''


def _start_jax_worker(tmp_path):
    """The JAX package's WorkerServer in a subprocess → (process, port,
    params npz)."""
    script = tmp_path / "jax_worker.py"
    script.write_text(JAX_WORKER)
    npz = tmp_path / "params.npz"
    env = dict(os.environ, PYTHONUNBUFFERED="1", JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, str(script), str(npz)],
                            stdout=subprocess.PIPE, text=True, env=env)
    for line in proc.stdout:
        if line.startswith("RPC_READY"):
            fields = dict(kv.split("=") for kv in line.split()[1:])
            return proc, int(fields["port"]), str(npz)
    raise AssertionError(f"JAX worker exited ({proc.wait()}) before "
                         "RPC_READY")


@pytest.fixture(scope="module")
def jax_reference():
    from repro.api import ExecutionPlan as JPlan
    from repro.api import InferenceSession as JSession
    return JSession.from_config(
        "llama3.2-1b", [JPlan.local(), JPlan.prism_sim(L=4, cr=9.9)],
        reduced={"vocab_size": 64, "dtype": "float32"}, seed=0)


@pytest.mark.parametrize("victim", ["jax", "torch"])
def test_mixed_fleet_fails_over_token_exact(tmp_path, jax_reference,
                                            deadline, victim):
    """The ROADMAP gate: one JAX worker and one port worker (the JAX
    worker's params, f32, on the CPU) behind the port's router; requests
    pinned to the victim are in flight when it is SIGKILLed, and every
    request completes exactly once with the JAX ``generate``'s tokens."""
    from repro_torch.fleet import DeviceRegistry, FleetRouter
    from repro_torch.runtime.fault import RetryPolicy
    jproc, workers = None, []
    try:
        jproc, port, npz = _start_jax_worker(tmp_path)
        kw = dict(n_slots=2, chunk=3, max_len=24, heartbeat_timeout_s=300.0,
                  retry=RetryPolicy(max_retries=2, backoff_base_s=0.02))
        workers.append(RpcWorker("jax", address=("127.0.0.1", port),
                                 spawn=False, **kw))
        workers.append(RpcWorker("torch", vocab=64, seed=0, device="cpu",
                                 dtype="float32", params=npz,
                                 connect_timeout_s=60.0, **kw))
        reg = DeviceRegistry(heartbeat_timeout_s=30.0)
        for w in workers:
            reg.add(w)
        router = FleetRouter(reg, retry=RetryPolicy(max_retries=3))
        survivor = "torch" if victim == "jax" else "jax"
        reqs = [Request(prompt=np.arange(1 + i, 7 + i, dtype=np.int32),
                        n_new=8, seed=i) for i in range(4)]
        for i, r in enumerate(reqs):
            router.route(r, pin=victim if i < 3 else survivor)
        router.step()                        # work in flight on both
        if victim == "jax":
            jproc.kill()
            jproc.wait(timeout=10)
        else:
            workers[1].kill_process()
        done = router.run()
        assert sorted(c.request_id for c in done) == sorted(r.id for r in reqs)
        assert {c.worker for c in done} == {survivor}
        assert not reg.is_alive(victim) and router.stats["lost"] == 0
        by_id = {c.request_id: c for c in done}
        for r in reqs:
            want = np.asarray(jax_reference.generate(r.prompt[None], r.n_new,
                                                     seed=r.seed))[0]
            np.testing.assert_array_equal(np.asarray(by_id[r.id].tokens),
                                          want)
    finally:
        _close(workers)
        if jproc is not None:
            jproc.kill()
            jproc.wait(timeout=10)
            jproc.stdout.close()
