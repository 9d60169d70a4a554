"""RpcWorker — a fleet worker living in another process.

Implements the :class:`repro_torch.fleet.registry.Worker` interface over
the :mod:`repro_torch.rpc.wire` protocol, so a subprocess running
``python -m repro_torch.rpc.worker`` (spawned with ``device=``, the card
by default, and ``full``/``dtype``/``params`` passed through) drops in
beside ``WorkerHandle``/``SimWorker`` in a
:class:`~repro_torch.fleet.registry.DeviceRegistry` — same scoring, same
EDF drain→re-route, same circuit breakers.  ``address=..., spawn=False``
connects to any worker that speaks the protocol, the JAX package's
included.  The differences are exactly the point:

* **liveness is real**: heartbeats cross the wire; a dead socket or dead
  process flips ``healthy`` off, the router stops beating the worker, and
  the existing heartbeat-death drain path re-routes its requests;
* **faults are measured, not modeled**: connection resets, timeouts and
  truncated frames raise typed :class:`TransportError`\\ s that feed the
  same :class:`~repro_torch.runtime.fault.RetryPolicy` capped backoff and
  :class:`~repro_torch.runtime.fault.CircuitBreaker` machinery the chaos tier
  exercises with ``ChaosEvent`` models;
* **calibration is measured on the worker's process**
  (:meth:`measure_codec_bws` → ``Calibrate``), and profiling sweeps run
  remotely (:meth:`reprofile` → ``Profile``), so the policy table prices
  codecs the way *that* process pays for them;
* **the chaos bridge realizes faults on the wire**: an armed ``error``
  becomes an actual half-written frame + hard close, ``straggle`` a real
  delay, and ``kill``/``revive`` a real ``SIGKILL``/respawn
  (:meth:`kill_process`/:meth:`respawn`, driven by ``ChaosController`` and
  ``DeviceRegistry.readmit``).

Exactly-once: the client mirrors every unfinished request (``_owned`` +
the outbox queue), blindly re-submits after a reconnect, and relies on the
server's request-id dedup; completions for unknown ids are dropped as
stale.  Token-exactness is inherited from ``seed``/``temperature`` pinning
plus deterministic session construction (same arch/vocab/seed in every
process).
"""
from __future__ import annotations

import os
import select
import socket
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.chaos.schedule import DispatchFault
from repro_torch.core.perfmap import PerfMap
from repro_torch.obs import MetricsRegistry, StatsDict, request_trace_id
from repro_torch.core.policy import AdaptivePolicy, resolve_objective
from repro_torch.fleet.registry import Worker, scaled_hardware
from repro_torch.profiling.hardware import (JETSON_ORIN_NANO, WIFI_GLOO,
                                      HardwareProfile, LinkProfile)
from repro_torch.runtime.fault import RetryPolicy
from repro_torch.rpc import wire
from repro_torch.rpc.wire import (
    Calibrate, CalibrateResult, CompletionMsg, Drain, DrainResult, ErrorMsg,
    Heartbeat, Hello, HelloAck, Profile, ProfileResult, SetBandwidth,
    Shutdown, SubmitRequest, TokenChunk, TransportError, WireClosed,
    WireTimeout,
)
from repro_torch.serving.engine import Completion
from repro_torch.serving.queue import Request, RequestQueue


class RpcWorker(Worker):
    """A process-boundary fleet worker (spawned subprocess or remote addr).

    The bounded EDF ``queue`` holds accepted-but-unsent requests (the
    outbox); ``_owned`` mirrors everything submitted over the wire and not
    yet completed, so :meth:`drain_requests` can hand the router the full
    set even after the process died taking its state with it.
    """

    def __init__(self, name: str, *,
                 address: Optional[Tuple[str, int]] = None,
                 arch: str = "llama3.2-1b", vocab: int = 64, seed: int = 0,
                 n_slots: int = 2, chunk: int = 4, max_len: int = 64,
                 queue_size: int = 64, hw_scale: float = 1.0,
                 prism_l: int = 4, prism_cr: float = 9.9,
                 bandwidth_mbps: float = 400.0,
                 hardware: Optional[HardwareProfile] = None,
                 link: LinkProfile = WIFI_GLOO,
                 objective="latency", allow_modes=("local", "prism"),
                 retry: Optional[RetryPolicy] = None,
                 io_timeout_s: float = 10.0,
                 heartbeat_every_s: float = 0.25,
                 heartbeat_timeout_s: float = 60.0,
                 connect_timeout_s: float = 300.0,
                 profile_timeout_s: float = 600.0,
                 poll_s: float = 0.002,
                 spawn: bool = True, shed_expired: bool = False,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer=None, device: str = "cuda", full: bool = False,
                 dtype: str = "", params: str = ""):
        self.name = name
        self.arch = arch
        self._spawn_args = dict(arch=arch, vocab=vocab, seed=seed,
                                n_slots=n_slots, chunk=chunk,
                                max_len=max_len, queue_size=queue_size,
                                hw_scale=hw_scale, prism_l=prism_l,
                                prism_cr=prism_cr, device=device,
                                full=full, dtype=dtype, params=params)
        self.hardware = hardware or (
            scaled_hardware(JETSON_ORIN_NANO, hw_scale)
            if hw_scale != 1.0 else JETSON_ORIN_NANO)
        self.link = link
        self.n_slots = n_slots
        self.max_len = max_len
        self.queue = RequestQueue(queue_size, shed_expired=shed_expired)
        self.codec_bws: Dict[str, float] = {}
        self.codec_bws_measured = False
        self.objective = resolve_objective(objective)
        self._allow_modes = tuple(allow_modes)
        self.retry = retry or RetryPolicy()
        self.io_timeout_s = io_timeout_s
        self.heartbeat_every_s = heartbeat_every_s
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.connect_timeout_s = connect_timeout_s
        self.profile_timeout_s = profile_timeout_s
        self.poll_s = poll_s
        self._bandwidth = float(bandwidth_mbps)
        self.perfmap: Optional[PerfMap] = None
        self.policy: Optional[AdaptivePolicy] = None
        self.profiled_count = 0
        # wire state
        self.proc: Optional[subprocess.Popen] = None
        self.sock: Optional[socket.socket] = None
        self.address = address
        self.healthy = True
        self.chaos = None                     # set by ChaosController.attach
        self._owned: Dict[int, Request] = {}  # sent, not yet completed
        self._fresh: List[Completion] = []    # completed since last step()
        self.completions: List[Completion] = []
        self._faults: List[DispatchFault] = []
        self._consec = 0                      # consecutive wire failures
        self._retry_at = 0.0                  # reconnect backoff gate
        self._stall_until = 0.0
        self._hb_seq = 0
        self._last_ping = 0.0
        self._last_rx = time.monotonic()
        self.remote_stats: Dict[str, Any] = {}
        self.metrics = metrics or MetricsRegistry()
        # per-request client-side "dispatch" span: opened when the request
        # goes over the wire, its span id rides SubmitRequest.parent_span
        # so the subprocess worker's spans land under it, finished when the
        # completion surfaces (or the request drains away)
        self.tracer = tracer
        self._dispatch_spans: Dict[int, Any] = {}
        self.stats = StatsDict(
            self.metrics, "rpc.client",
            {"submitted": 0, "served": 0, "tokens": 0,
             "streamed_tokens": 0, "retries": 0, "reconnects": 0,
             "timeouts": 0, "transport_errors": 0, "straggled": 0,
             "stale_completions": 0, "remote_errors": 0,
             "frames_in": 0, "frames_out": 0,
             "bytes_in": 0, "bytes_out": 0},
            labels={"worker": name})
        if address is None and spawn:
            self._spawn()
        self._connect()
        self.reprofile()                      # pull the worker's own table

    # -- process / connection lifecycle --------------------------------------

    def _spawn(self) -> None:
        a = self._spawn_args
        cmd = [sys.executable, "-m", "repro_torch.rpc.worker",
               "--host", "127.0.0.1", "--port", "0", "--name", self.name,
               "--arch", a["arch"], "--vocab", str(a["vocab"]),
               "--seed", str(a["seed"]), "--n-slots", str(a["n_slots"]),
               "--chunk", str(a["chunk"]), "--max-len", str(a["max_len"]),
               "--queue-size", str(a["queue_size"]),
               "--hw-scale", str(a["hw_scale"]),
               "--prism-l", str(a["prism_l"]),
               "--prism-cr", str(a["prism_cr"]),
               "--device", a["device"]]
        cmd += ["--full"] if a["full"] else []
        cmd += ["--dtype", a["dtype"]] if a["dtype"] else []
        cmd += ["--params", a["params"]] if a["params"] else []
        env = dict(os.environ)
        env["PYTHONUNBUFFERED"] = "1"
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                                     env=env)
        deadline = time.monotonic() + self.connect_timeout_s
        while True:
            if time.monotonic() > deadline:
                self.kill_process()
                raise WireTimeout(f"worker {self.name!r} did not print "
                                  f"RPC_READY within {self.connect_timeout_s}"
                                  "s", worker=self.name)
            ready, _, _ = select.select([self.proc.stdout], [], [], 0.5)
            if not ready:
                if self.proc.poll() is not None:
                    raise WireClosed(
                        f"worker {self.name!r} exited with code "
                        f"{self.proc.returncode} before RPC_READY",
                        worker=self.name)
                continue
            line = self.proc.stdout.readline()
            if not line:
                raise WireClosed(
                    f"worker {self.name!r} closed stdout before RPC_READY "
                    f"(exit code {self.proc.poll()})", worker=self.name)
            if line.startswith("RPC_READY"):
                fields = dict(kv.split("=") for kv in line.split()[1:])
                self.address = ("127.0.0.1", int(fields["port"]))
                break

    def _connect(self) -> None:
        if self.address is None:
            raise ValueError(f"worker {self.name!r} has no address "
                             "(spawn=False needs address=)")
        try:
            sock = socket.create_connection(self.address, timeout=5.0)
        except OSError as e:
            raise WireClosed(f"connect to {self.address} failed: {e}",
                             worker=self.name) from None
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(self.io_timeout_s)
        self.sock = sock
        self._last_rx = time.monotonic()
        ack = self._rpc_call(Hello(name=self.name), HelloAck,
                             timeout=self.io_timeout_s)
        self.n_slots = ack.n_slots or self.n_slots
        self.max_len = ack.max_len or self.max_len
        self.remote_pid = ack.pid
        # re-submit everything the wire drop left in limbo: the server's
        # request-id dedup makes duplicates harmless (exactly-once)
        for req in sorted(self._owned.values(),
                          key=lambda r: (r.deadline(), r.arrival_ts)):
            self._send(self._submit_msg(req))

    def kill_process(self) -> None:
        """SIGKILL the subprocess (the chaos `kill` realization)."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            try:
                self.proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                pass

    def respawn(self) -> None:
        """Bring a dead worker back: fresh subprocess, fresh socket, same
        deterministic session (readmission path — DeviceRegistry.readmit
        calls this before re-calibrating)."""
        self.kill_process()
        self._drop_sock()
        self._spawn()
        self._consec = 0
        self._retry_at = 0.0
        self.healthy = True
        self._connect()

    def close(self) -> None:
        """Clean shutdown: ask the worker to exit, then make sure it did."""
        if self.sock is not None:
            try:
                wire.send_message(self.sock, Shutdown(), worker=self.name)
            except TransportError:
                pass
        self._drop_sock()
        if self.proc is not None:
            try:
                self.proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                self.kill_process()
            if self.proc.stdout is not None:
                self.proc.stdout.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _drop_sock(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None

    # -- wire plumbing -------------------------------------------------------

    def _send(self, msg) -> None:
        if self.sock is None:
            raise WireClosed("not connected", worker=self.name)
        n = wire.send_message(self.sock, msg, worker=self.name)
        self.stats["frames_out"] += 1
        self.stats["bytes_out"] += n

    def _recv(self, timeout: Optional[float] = None):
        if self.sock is None:
            raise WireClosed("not connected", worker=self.name)
        msg, n = wire.recv_message(
            self.sock, timeout=self.io_timeout_s if timeout is None
            else timeout, worker=self.name)
        self._last_rx = time.monotonic()
        self.stats["frames_in"] += 1
        self.stats["bytes_in"] += n
        return msg

    def _rpc_call(self, msg, want, *, timeout: float):
        """Send a control message and pump until its reply arrives (serving
        traffic received in between is dispatched normally, not dropped)."""
        self._send(msg)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            readable, _, _ = select.select([self.sock], [], [], 0.1)
            if not readable:
                if self.proc is not None and self.proc.poll() is not None:
                    raise WireClosed(
                        f"worker process died (exit {self.proc.returncode}) "
                        f"awaiting {want.__name__}", worker=self.name)
                continue
            reply = self._recv()
            if isinstance(reply, want):
                return reply
            if isinstance(reply, ErrorMsg) and reply.request_id < 0:
                raise TransportError(f"remote error: {reply.detail}",
                                     worker=self.name, stage="rpc-remote")
            self._dispatch(reply)
        raise WireTimeout(f"no {want.__name__} within {timeout}s",
                          worker=self.name)

    def _dispatch(self, msg) -> None:
        if isinstance(msg, CompletionMsg):
            req = self._owned.pop(msg.request_id, None)
            if req is None:       # duplicate/stale (e.g. re-routed already)
                self.stats["stale_completions"] += 1
                return
            comp = Completion(
                request_id=msg.request_id,
                tokens=np.asarray(msg.tokens, np.int32),
                plan_key=msg.plan_key, arrival_ts=req.arrival_ts,
                admitted_ts=msg.admitted_ts, finished_ts=time.monotonic(),
                slo_ms=req.slo_ms, extrapolated=msg.extrapolated,
                codec=msg.codec, wire_bytes=msg.wire_bytes,
                worker=self.name)
            self._fresh.append(comp)
            self.completions.append(comp)
            self.stats["served"] += 1
            self.stats["tokens"] += len(comp.tokens)
            if self.tracer is not None:
                # re-parenting is implicit: the worker stamped its spans
                # with SubmitRequest.parent_span, so ingest lands them
                # under this client's dispatch span
                self.tracer.ingest(msg.spans)
                d = self._dispatch_spans.pop(msg.request_id, None)
                if d is not None:
                    self.tracer.finish(d, at=comp.finished_ts)
        elif isinstance(msg, TokenChunk):
            self.stats["streamed_tokens"] += int(np.asarray(msg.tokens).size)
            if self.tracer is not None and msg.spans:
                self.tracer.ingest(msg.spans)
        elif isinstance(msg, Heartbeat):
            self.remote_stats = dict(msg.stats)
        elif isinstance(msg, ErrorMsg):
            self.stats["remote_errors"] += 1
            req = self._owned.pop(msg.request_id, None)
            if req is not None:   # per-request rejection: let the router
                self._faults.append(DispatchFault(    # re-place it
                    worker=self.name, kind="error", t=time.monotonic(),
                    retried=(), gave_up=(req,)))
                self._close_dispatch_span(msg.request_id, "remote_error")

    # -- Worker interface: placement inputs ----------------------------------

    @property
    def bandwidth(self) -> float:
        return self._bandwidth

    def observe_bandwidth(self, mbps: float) -> None:
        self._bandwidth = float(mbps)
        if self.sock is not None and self.healthy:
            try:
                self._send(SetBandwidth(mbps=float(mbps)))
            except TransportError as e:
                self._on_wire_error(e, time.monotonic())

    def table(self, objective=None):
        if self.policy is None:
            raise RuntimeError(f"worker {self.name!r} has no policy table "
                               "yet (reprofile failed?)")
        return self.policy.table(objective or self.objective)

    @property
    def in_flight(self) -> int:
        return len(self._owned)

    # -- Worker interface: intake / service ----------------------------------

    def submit_request(self, req: Request, force: bool = False) -> Request:
        if req.total_len > self.max_len:
            raise ValueError(
                f"request needs {req.total_len} positions but worker "
                f"{self.name!r} pools are sized for {self.max_len}")
        return self.queue.put(req, force=force)

    def _submit_msg(self, req: Request) -> SubmitRequest:
        msg = SubmitRequest(
            request_id=req.id, n_new=req.n_new, seed=req.seed,
            temperature=req.temperature, slo_ms=req.slo_ms,
            arrival_ts=req.arrival_ts,
            prompt=np.asarray(req.prompt, np.int32))
        if self.tracer is not None:
            if not req.trace_id:
                req.trace_id = request_trace_id(req.id)
            d = self._dispatch_spans.get(req.id)
            if d is None:
                d = self.tracer.start(
                    "dispatch", kind="rpc", trace_id=req.trace_id,
                    parent_id=req.parent_span or None, worker=self.name,
                    request_id=req.id)
                self._dispatch_spans[req.id] = d
            msg.trace_id = req.trace_id
            msg.parent_span = d.span_id
        return msg

    def step(self, now: Optional[float] = None) -> List[Completion]:
        """One client round: realize armed chaos, flush the outbox, keep
        heartbeats flowing, pump inbound frames.  Any wire failure lands in
        the fault stream (→ breaker) and starts capped-backoff reconnects;
        a dead process (or exhausted budget) flips ``healthy`` off so the
        router's heartbeat-death path drains us."""
        mono = time.monotonic()
        if not self.healthy:
            done, self._fresh = self._fresh, []
            return done
        try:
            self._consume_chaos(mono)
            if self.sock is None:
                self._reconnect(mono)
            if self.sock is not None:
                self._flush_outbox(mono)
                self._heartbeat(mono)
                self._pump()
                self._check_liveness(mono)
        except TransportError as e:
            self._on_wire_error(e, mono)
        done, self._fresh = self._fresh, []
        return done

    def _flush_outbox(self, mono: float) -> None:
        if mono < self._stall_until:
            return
        while self.queue:
            reqs = self.queue.pop_many(1, now=mono)
            if not reqs:
                return             # everything left had expired
            req = reqs[0]
            try:
                self._send(self._submit_msg(req))
            except TransportError:
                self.queue.put(req, force=True)   # keep ownership
                raise
            self._owned[req.id] = req
            self.stats["submitted"] += 1

    def _heartbeat(self, mono: float) -> None:
        if mono - self._last_ping < self.heartbeat_every_s:
            return
        self._hb_seq += 1
        self._last_ping = mono
        self._send(Heartbeat(seq=self._hb_seq, t=mono))

    def _pump(self) -> None:
        # With work in flight and nothing produced yet, wait a moment for
        # the wire instead of returning instantly: spin-loops like
        # ``FleetRouter.run`` then advance in wall-clock time rather than
        # exhausting their step budget while the remote process computes.
        wait = self.poll_s if (self._owned and not self._fresh) else 0.0
        while self.sock is not None:
            readable, _, _ = select.select([self.sock], [], [], wait)
            if not readable:
                return
            self._dispatch(self._recv())
            wait = 0.0

    def _check_liveness(self, mono: float) -> None:
        if mono - self._last_rx > self.heartbeat_timeout_s:
            raise WireTimeout(
                f"no traffic from worker {self.name!r} for "
                f"{mono - self._last_rx:.1f}s", worker=self.name)

    def next_event_at(self, now: float) -> float:
        return now if (self.queue or self._owned) else float("inf")

    # -- failure handling ----------------------------------------------------

    def _close_dispatch_span(self, request_id: int, reason: str) -> None:
        if self.tracer is None:
            return
        d = self._dispatch_spans.pop(request_id, None)
        if d is not None and d.open:
            d.attrs["outcome"] = reason
            self.tracer.finish(d)

    def _on_wire_error(self, err: TransportError, mono: float) -> None:
        self._drop_sock()
        self._consec += 1
        kind = "timeout" if isinstance(err, WireTimeout) else "error"
        self.stats["timeouts" if kind == "timeout"
                   else "transport_errors"] += 1
        self._faults.append(DispatchFault(
            worker=self.name, kind=kind, t=mono,
            retried=tuple(self._owned), gave_up=()))
        if self.tracer is not None:
            # the reconnect will re-submit these under the same dispatch
            # span; the retry leaf marks the wire fault in the request tree
            for rid, req in self._owned.items():
                d = self._dispatch_spans.get(rid)
                self.tracer.record(
                    "retry", start=mono, end=mono, kind="rpc",
                    trace_id=req.trace_id or request_trace_id(rid),
                    parent_id=d.span_id if d is not None else None,
                    worker=self.name, reason=kind, attempt=self._consec)
        # no dead-process short-circuit: a killed worker is discovered the
        # way a crashed remote one would be — reconnects genuinely fail,
        # each failure feeds the breaker, and only an exhausted retry
        # budget flips `healthy` (router fails us → drain → re-route)
        if self._consec > self.retry.max_retries:
            self.healthy = False
        else:
            self.stats["retries"] += 1
            self._retry_at = mono + self.retry.backoff_s(self._consec - 1)

    def _reconnect(self, mono: float) -> None:
        if mono < self._retry_at:
            return
        self._connect()               # re-submits owned requests (dedup'd)
        self._consec = 0
        self.stats["reconnects"] += 1

    def drain_requests(self) -> List[Request]:
        """Everything this worker still owes: unsent outbox + the wire
        mirror of in-flight work (survives the process dying, which is the
        whole reason the mirror exists)."""
        reqs = self.queue.drain()
        reqs.extend(self._owned.values())
        self._owned.clear()
        for req in reqs:
            self._close_dispatch_span(req.id, "drained")
        return reqs

    def pop_faults(self) -> List[DispatchFault]:
        out, self._faults = self._faults, []
        return out

    # -- chaos bridge: modeled events become real wire faults ----------------

    def _consume_chaos(self, mono: float) -> None:
        if self.chaos is None:
            return
        fault = self.chaos.dispatch_fault(self.name, mono)
        if fault is None:
            return
        if fault.kind == "straggle":
            # realized as an actual stall of this client round
            time.sleep(min(0.01 * max(fault.value, 1.0), 0.25))
            self.stats["straggled"] += 1
        elif fault.kind == "error":
            self._sabotage_wire()

    def _sabotage_wire(self) -> None:
        """Realize an armed transport error as *real* bytes: half a frame,
        then a hard close — the server sees an actual truncated frame and
        drops the conn; we see an actual dead socket and retry/back off."""
        if self.sock is None:
            return
        frame = Heartbeat(seq=-1).encode_frame()
        try:
            self.sock.sendall(frame[:len(frame) // 2])
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        raise WireClosed("chaos: wire sabotaged (truncated frame + close)",
                         worker=self.name)

    def apply_stall(self, t: float, duration: float) -> None:
        """Scripted stall: stop flushing the outbox for ``duration`` (the
        wire stays up — requests just sit in the EDF queue)."""
        self._stall_until = max(self._stall_until,
                                time.monotonic() + duration)

    # -- calibration / profiling over the wire -------------------------------

    def measure_codec_bws(self, *, shape=(4, 64, 256), iters: int = 3,
                          warmup: int = 1) -> Dict[str, float]:
        """Truly measured codec decode throughputs — run by
        ``calibrate_codec_bws`` on the worker's own process, not scaled
        from a host estimate."""
        res = self._rpc_call(
            Calibrate(shape=tuple(shape), iters=iters, warmup=warmup),
            CalibrateResult, timeout=self.profile_timeout_s)
        self.codec_bws = {k: float(v) for k, v in res.bws.items()}
        self.codec_bws_measured = bool(res.measured)
        return dict(self.codec_bws)

    def reprofile(self, codec_bws: Optional[Dict[str, float]] = None) -> None:
        """Re-run the profiling sweep on the worker's process and rebuild
        the local policy table from the shipped perf map."""
        if codec_bws is not None:
            self.codec_bws = dict(codec_bws)
        res = self._rpc_call(Profile(codec_bws=self.codec_bws or {}),
                             ProfileResult, timeout=self.profile_timeout_s)
        self.perfmap = PerfMap.from_doc(res.perfmap,
                                        source=f"rpc:{self.name}")
        self.policy = AdaptivePolicy(self.perfmap,
                                     allow_modes=self._allow_modes)
        self.profiled_count += 1

    def drain_remote(self) -> List[int]:
        """Ask the worker to give back everything it holds (ids); used by
        graceful scale-down, not the dead-worker path."""
        res = self._rpc_call(Drain(), DrainResult, timeout=self.io_timeout_s)
        return list(res.request_ids)

    # -- telemetry -----------------------------------------------------------

    def stats_snapshot(self) -> Dict:
        snap = dict(self.stats)
        snap["queue_depth"] = len(self.queue)
        snap["in_flight"] = len(self._owned)
        snap["completed"] = len(self.completions)
        snap["rejected"] = self.queue.rejected
        snap["rejections"] = dict(self.queue.rejections)
        snap["expired"] = self.queue.rejections.get("expired", 0)
        snap["profiled_count"] = self.profiled_count
        snap["healthy"] = self.healthy
        snap["codec_bws_measured"] = self.codec_bws_measured
        snap["remote"] = dict(self.remote_stats)
        return snap

    @property
    def served_tokens(self) -> int:
        return self.stats["tokens"]
