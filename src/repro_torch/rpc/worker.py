"""The worker side of the fleet's process boundary.

:class:`WorkerServer` owns an :class:`~repro_torch.api.InferenceSession` +
:class:`~repro_torch.serving.ServingRuntime` and serves the
:mod:`repro_torch.rpc.wire` protocol over a local TCP socket — decode progress streams out as
``TokenChunk`` frames, finished requests as ``CompletionMsg``.  Codec
calibration (``Calibrate``) and profiling sweeps (``Profile``) run **in this
process**, so the numbers the registry installs are truly measured on the
worker, not eff_inf-scaled host estimates.

Exactly-once: the server deduplicates ``SubmitRequest`` by request id.  A
client that reconnects after a wire fault blindly re-submits everything it
still owns; a duplicate of a finished request gets its cached completion
re-sent, a duplicate of an in-flight request is ignored.  The listener
accepts sequential reconnections from the (single) client for the same
reason.

``worker_main()`` is the subprocess entrypoint
(``python -m repro_torch.rpc.worker --port 0 ...``); it builds the session
on ``--device`` (the card unless ``--device cpu``) — the reduced config
of ``--arch``, or its published widths with ``--full``, with the seeded
weights or those of ``--params`` — and prints a single
``RPC_READY port=<p> pid=<p>`` line to stdout once the session is built and
profiled, which the spawning :class:`~repro_torch.rpc.client.RpcWorker`
parses.  It speaks the JAX package's protocol byte for byte, so either
package's client drives it.
"""
from __future__ import annotations

import argparse
import os
import select
import socket
import sys
from typing import Dict, Optional

import numpy as np

from repro_torch.obs import MetricsRegistry, StatsDict, Tracer, span_to_dict
from repro_torch.rpc import wire
from repro_torch.rpc.wire import (
    Calibrate, CalibrateResult, CompletionMsg, Drain, DrainResult, ErrorMsg,
    Heartbeat, Hello, HelloAck, Profile, ProfileResult, SetBandwidth,
    Shutdown, SubmitRequest, TokenChunk, TransportError,
)
from repro_torch.profiling.sweep import SweepSpec
from repro_torch.serving.engine import ServingRuntime
from repro_torch.serving.queue import Request
from repro_torch.transport.codecs import calibrate_codec_bws, codec_overrides


class WorkerServer:
    """Single-threaded serve loop: alternate between draining the socket
    and stepping the runtime, so decode keeps making progress while frames
    trickle in.  Also usable in-process (tests run it on a thread over a
    socketpair) — the protocol does not care."""

    def __init__(self, session, *, name: str = "worker",
                 arch: str = "", n_slots: int = 4, chunk: int = 8,
                 max_len: int = 256, queue_size: int = 64,
                 hardware=None, link=None, sweep: Optional[SweepSpec] = None):
        self.session = session
        self.name = name
        self.arch = arch
        self.hardware = hardware
        self.link = link
        self.sweep = sweep or SweepSpec()
        self.metrics = MetricsRegistry()
        self.runtime = ServingRuntime(session, n_slots=n_slots, chunk=chunk,
                                      max_len=max_len, queue_size=queue_size,
                                      metrics=self.metrics, worker=name)
        self.runtime.on_progress = self._on_progress
        # exactly-once bookkeeping: id -> cached CompletionMsg (None while
        # the request is still queued/in flight)
        self._seen: Dict[int, Optional[CompletionMsg]] = {}
        self._streamed: Dict[int, int] = {}    # id -> chunk tokens sent
        self._conn: Optional[socket.socket] = None
        self._shutdown = False
        # tracing is demand-driven: stays None (zero cost) until a traced
        # SubmitRequest arrives, then spans ship back on TokenChunk /
        # CompletionMsg frames exactly once each
        self.tracer: Optional[Tracer] = None
        self._trace_ids: Dict[int, str] = {}     # id -> trace id
        self._shipped: Dict[int, set] = {}       # id -> span ids sent
        self.stats = StatsDict(
            self.metrics, "rpc.server",
            {"frames_in": 0, "frames_out": 0, "bytes_in": 0,
             "bytes_out": 0, "submits": 0, "dup_submits": 0,
             "calibrations": 0, "profiles": 0, "reconnects": 0,
             "frame_errors": 0},
            labels={"worker": name})

    # -- streaming -----------------------------------------------------------

    def _on_progress(self, request_id: int, tokens) -> None:
        """Stream newly decoded chunk tokens (positions 1.. of the output;
        position 0 stays on device until completion — the CompletionMsg is
        the authoritative, token-exact record)."""
        if self._conn is None:
            return
        sent = self._streamed.get(request_id, 0)
        fresh = tokens[sent:]
        if not fresh:
            return
        self._streamed[request_id] = sent + len(fresh)
        self._send(TokenChunk(request_id=request_id, start=1 + sent,
                              spans=self._fresh_spans(request_id),
                              tokens=np.asarray(fresh, np.int32)))

    def _fresh_spans(self, request_id: int):
        """Finished spans of this request's trace not yet shipped — each
        span rides exactly one frame (the client ingest dedups anyway)."""
        if self.tracer is None:
            return []
        tid = self._trace_ids.get(request_id)
        if not tid:
            return []
        shipped = self._shipped.setdefault(request_id, set())
        out = []
        for sp in self.tracer.trace(tid):
            if sp.open or sp.span_id in shipped:
                continue
            shipped.add(sp.span_id)
            out.append(span_to_dict(sp))
        return out

    # -- plumbing ------------------------------------------------------------

    def _send(self, msg) -> None:
        if self._conn is None:
            return
        try:
            self.stats["bytes_out"] += wire.send_message(
                self._conn, msg, worker=self.name)
            self.stats["frames_out"] += 1
        except TransportError:
            # client vanished mid-send; drop the conn, keep state — the
            # reconnecting client re-submits and dedup re-sends completions
            self._drop_conn()

    def _drop_conn(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None

    # -- serve loop ----------------------------------------------------------

    def serve_forever(self, host: str = "127.0.0.1", port: int = 0,
                      *, ready=print) -> None:
        listener = socket.create_server((host, port))
        listener.settimeout(0.1)
        actual = listener.getsockname()[1]
        ready(f"RPC_READY port={actual} pid={os.getpid()}", flush=True)
        try:
            while not self._shutdown:
                if self._conn is None:
                    try:
                        conn, _ = listener.accept()
                    except socket.timeout:
                        continue
                    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    self._conn = conn
                    self.stats["reconnects"] += 1
                self.serve_conn(self._conn)
        finally:
            self._drop_conn()
            listener.close()

    def serve_conn(self, conn: socket.socket) -> None:
        """Serve one connection until it drops or Shutdown arrives.  Used
        directly by in-process tests (socketpair); ``serve_forever`` wraps
        it with an accept loop."""
        self._conn = conn
        while not self._shutdown and self._conn is not None:
            busy = bool(self.runtime.queue) or not self.runtime.idle
            try:
                readable, _, _ = select.select(
                    [conn], [], [], 0.0 if busy else 0.02)
            except (OSError, ValueError):
                self._drop_conn()
                return
            if readable:
                try:
                    msg, n = wire.recv_message(conn, timeout=2.0,
                                               worker=self.name)
                except wire.FrameError:
                    # stream desync (truncated/corrupt frame): the only
                    # safe recovery is dropping the conn; the client
                    # reconnects and re-submits
                    self.stats["frame_errors"] += 1
                    self._drop_conn()
                    return
                except TransportError:
                    self._drop_conn()
                    return
                self.stats["frames_in"] += 1
                self.stats["bytes_in"] += n
                self._handle(msg)
            if busy:
                for comp in self.runtime.step():
                    done = CompletionMsg(
                        request_id=comp.request_id, plan_key=comp.plan_key,
                        admitted_ts=comp.admitted_ts,
                        finished_ts=comp.finished_ts, codec=comp.codec,
                        wire_bytes=comp.wire_bytes,
                        extrapolated=comp.extrapolated,
                        spans=self._fresh_spans(comp.request_id),
                        tokens=np.asarray(comp.tokens, np.int32))
                    self._seen[comp.request_id] = done
                    self._streamed.pop(comp.request_id, None)
                    self._shipped.pop(comp.request_id, None)
                    self._trace_ids.pop(comp.request_id, None)
                    self._send(done)

    # -- message handlers ----------------------------------------------------

    def _handle(self, msg) -> None:
        handler = getattr(self, f"_on_{type(msg).__name__}", None)
        if handler is None:
            self._send(ErrorMsg(detail=f"unhandled {type(msg).__name__}"))
            return
        try:
            handler(msg)
        except TransportError:
            raise
        except Exception as e:   # a bad request must not kill the worker
            self._send(ErrorMsg(
                detail=f"{type(msg).__name__}: {type(e).__name__}: {e}",
                request_id=getattr(msg, "request_id", -1)))

    def _on_Hello(self, msg: Hello) -> None:
        self._send(HelloAck(
            name=self.name, pid=os.getpid(), arch=self.arch,
            n_slots=self.runtime.n_slots, chunk=self.runtime.chunk,
            max_len=self.runtime.max_len,
            queue_size=self.runtime.queue.max_size))

    def _on_SubmitRequest(self, msg: SubmitRequest) -> None:
        if msg.request_id in self._seen:
            self.stats["dup_submits"] += 1
            done = self._seen[msg.request_id]
            if done is not None:      # finished before the client's retry
                self._send(done)
            return                    # still in flight: first submit wins
        self._seen[msg.request_id] = None
        self.stats["submits"] += 1
        req = Request(prompt=np.asarray(msg.prompt, np.int32),
                      n_new=msg.n_new, slo_ms=msg.slo_ms, seed=msg.seed,
                      temperature=msg.temperature,
                      arrival_ts=msg.arrival_ts or self.runtime.clock(),
                      id=msg.request_id)     # preserve the fleet-wide id
        if msg.trace_id:
            # the client is tracing: adopt its trace context so this
            # process's spans re-parent under the client dispatch span
            if self.tracer is None:
                self.tracer = Tracer(name=f"rpc:{self.name}")
                self.runtime.tracer = self.tracer
            req.trace_id = msg.trace_id
            req.parent_span = msg.parent_span
            self._trace_ids[msg.request_id] = msg.trace_id
        self.runtime.submit_request(req)

    def _on_Heartbeat(self, msg: Heartbeat) -> None:
        self._send(Heartbeat(seq=msg.seq, t=msg.t, pong=True,
                             stats=self._stats()))

    def _on_Calibrate(self, msg: Calibrate) -> None:
        bws = calibrate_codec_bws(shape=tuple(msg.shape), iters=msg.iters,
                                  warmup=msg.warmup, force=True,
                                  device=self.session.device)
        self.stats["calibrations"] += 1
        self._send(CalibrateResult(bws={k: float(v) for k, v in bws.items()},
                                   measured=True))

    def _on_Profile(self, msg: Profile) -> None:
        sweep = self.sweep
        if msg.bandwidths:
            sweep = SweepSpec(batches=sweep.batches, crs=sweep.crs,
                              bandwidths_mbps=tuple(msg.bandwidths),
                              P=sweep.P, warmup_runs=sweep.warmup_runs,
                              codecs=sweep.codecs)
        with codec_overrides(msg.codec_bws or {}):
            pm = self.session.profile(sweep, backend="simulated",
                                      hardware=self.hardware, link=self.link)
        self.stats["profiles"] += 1
        self._send(ProfileResult(perfmap=pm.to_doc()))

    def _on_Drain(self, msg: Drain) -> None:
        reqs = self.runtime.drain_requests()
        for r in reqs:
            self._seen.pop(r.id, None)     # re-routes elsewhere; forget it
            self._streamed.pop(r.id, None)
            self._shipped.pop(r.id, None)
            self._trace_ids.pop(r.id, None)
        self._send(DrainResult(request_ids=[r.id for r in reqs]))

    def _on_SetBandwidth(self, msg: SetBandwidth) -> None:
        self.session.observe_bandwidth(msg.mbps)

    def _on_Shutdown(self, msg: Shutdown) -> None:
        self._shutdown = True
        self._send(Heartbeat(pong=True, stats=self._stats()))

    def _stats(self) -> Dict:
        snap = self.runtime.stats_snapshot()
        snap.update(self.stats)
        snap["pid"] = os.getpid()
        return snap


# ---------------------------------------------------------------------------
# subprocess entrypoint
# ---------------------------------------------------------------------------

def load_params_npz(path: str, cfg, device="cpu") -> dict:
    """An ``.npz`` of the JAX package's layer-stacked params (keys are the
    tree paths joined by ``/``, e.g. ``layers/attn/wq``) → the port's
    params for ``cfg`` on ``device``, through ``params_from_numpy``."""
    from repro_torch.models.bridge import params_from_numpy
    tree: Dict = {}
    with np.load(path) as npz:
        for key in npz.files:
            node = tree
            *parents, leaf = key.split("/")
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = npz[key]
    return params_from_numpy(tree, cfg, device=device)


def build_session(arch: str, *, vocab: int = 64, seed: int = 0,
                  prism_l: int = 4, prism_cr: float = 9.9,
                  hw_scale: float = 1.0, device="cuda", full: bool = False,
                  dtype: str = "", params: str = ""):
    """Deterministic session construction shared by every worker process:
    same (arch, vocab, seed) → identical parameters → token-exact re-serves
    across the fleet.  ``full`` keeps the published widths (``vocab`` and
    the reduction are then ignored); ``dtype`` overrides the config's;
    ``params`` loads weights from an ``.npz`` (:func:`load_params_npz`) in
    place of the seeded initialisation."""
    import dataclasses

    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.api.session import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.fleet.registry import scaled_hardware
    from repro_torch.models import registry
    from repro_torch.profiling.hardware import JETSON_ORIN_NANO, WIFI_GLOO
    dev = resolve_device(device)
    cfg = get_config(arch)
    if not full:
        cfg = cfg.reduced(vocab_size=vocab)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    weights = (load_params_npz(params, cfg, device=dev) if params
               else registry.init_params(cfg, seed=seed, device=dev))
    plans = [ExecutionPlan.local(),
             ExecutionPlan.prism_sim(L=prism_l, cr=prism_cr)]
    session = InferenceSession(cfg, weights, plans, device=dev)
    hardware = scaled_hardware(JETSON_ORIN_NANO, hw_scale) \
        if hw_scale != 1.0 else JETSON_ORIN_NANO
    return session, hardware, WIFI_GLOO

def worker_main(argv=None) -> int:
    p = argparse.ArgumentParser(description="repro_torch.rpc subprocess worker")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--name", default="rpc-worker")
    p.add_argument("--arch", default="llama3.2-1b")
    p.add_argument("--vocab", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-slots", type=int, default=2)
    p.add_argument("--chunk", type=int, default=4)
    p.add_argument("--max-len", type=int, default=64)
    p.add_argument("--queue-size", type=int, default=64)
    p.add_argument("--hw-scale", type=float, default=1.0)
    p.add_argument("--prism-l", type=int, default=4)
    p.add_argument("--prism-cr", type=float, default=9.9)
    p.add_argument("--bandwidths", default="",
                   help="comma-separated Mb/s grid for the profile sweep")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--full", action="store_true",
                   help="the published widths instead of the reduced "
                        "config (--vocab is then ignored)")
    p.add_argument("--dtype", default="",
                   help="override the config's dtype (e.g. float32)")
    p.add_argument("--params", default="", metavar="PATH",
                   help=".npz of the JAX package's layer-stacked params "
                        "('/'-joined tree paths) in place of --seed's")
    args = p.parse_args(argv)

    session, hardware, link = build_session(
        args.arch, vocab=args.vocab, seed=args.seed, prism_l=args.prism_l,
        prism_cr=args.prism_cr, hw_scale=args.hw_scale, device=args.device,
        full=args.full, dtype=args.dtype, params=args.params)
    sweep = SweepSpec()
    if args.bandwidths:
        sweep = SweepSpec(bandwidths_mbps=tuple(
            float(b) for b in args.bandwidths.split(",")))
    # profile up-front on *this* process so the first Profile reply is warm
    session.profile(sweep, backend="simulated", hardware=hardware, link=link)
    server = WorkerServer(session, name=args.name, arch=args.arch,
                          n_slots=args.n_slots, chunk=args.chunk,
                          max_len=args.max_len, queue_size=args.queue_size,
                          hardware=hardware, link=link, sweep=sweep)
    try:
        server.serve_forever(args.host, args.port)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(worker_main())
