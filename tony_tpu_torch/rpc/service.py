"""gRPC service plumbing for the control plane.

The reference exposes ``ApplicationRpc`` (registerWorkerSpec / getClusterSpec /
taskExecutorHeartbeat / registerExecutionResult / registerTensorBoardUrl /
getTaskInfos) and ``MetricsRpc`` as protobuf-over-Hadoop-RPC services
(SURVEY.md section 2). Here both are folded into one gRPC service,
``tony_tpu.ApplicationRpc``; stubs are hand-written against the generated
message classes because the image ships protoc but not grpcio-tools.

The port's copy of ``tony_tpu/rpc/service.py`` (the service names,
methods, timeouts and client stubs as they are there), so an executor or
CLI of either package can talk to an AM of either, and a gang frontend of
either package to a decode host of either: ``SERVE_SERVICE_NAME`` keeps the
reference's ``tony_tpu.ServeRpc``, the name on the wire.
"""

from __future__ import annotations

import logging
from concurrent import futures
from typing import Any, Callable

import grpc

from tony_tpu_torch.chaos import chaos_hook
from tony_tpu_torch.obs import trace
from tony_tpu_torch.obs.registry import get_registry
from tony_tpu_torch.rpc import tony_pb2 as pb

log = logging.getLogger(__name__)

SERVICE_NAME = "tony_tpu.ApplicationRpc"

# method name -> (request class, response class). The single source of truth
# for both server handler table and client stubs.
_METHODS: dict[str, tuple[Any, Any]] = {
    "RegisterWorkerSpec": (pb.RegisterWorkerSpecRequest, pb.RegisterWorkerSpecResponse),
    "GetClusterSpec": (pb.GetClusterSpecRequest, pb.GetClusterSpecResponse),
    "Heartbeat": (pb.HeartbeatRequest, pb.HeartbeatResponse),
    "RegisterExecutionResult": (
        pb.RegisterExecutionResultRequest,
        pb.RegisterExecutionResultResponse,
    ),
    "RegisterTensorBoardUrl": (pb.RegisterTensorBoardUrlRequest, pb.Empty),
    "PushMetrics": (pb.PushMetricsRequest, pb.Empty),
    "GetTaskInfos": (pb.GetTaskInfosRequest, pb.GetTaskInfosResponse),
    "GetApplicationStatus": (
        pb.GetApplicationStatusRequest,
        pb.GetApplicationStatusResponse,
    ),
    "StopApplication": (pb.StopApplicationRequest, pb.Empty),
    "StartProfile": (pb.StartProfileRequest, pb.StartProfileResponse),
}


class ApplicationRpcServicer:
    """Override the methods you serve; unimplemented ones raise UNIMPLEMENTED."""

    def RegisterWorkerSpec(self, request, context):  # noqa: N802 (rpc casing)
        raise NotImplementedError

    def GetClusterSpec(self, request, context):  # noqa: N802
        raise NotImplementedError

    def Heartbeat(self, request, context):  # noqa: N802
        raise NotImplementedError

    def RegisterExecutionResult(self, request, context):  # noqa: N802
        raise NotImplementedError

    def RegisterTensorBoardUrl(self, request, context):  # noqa: N802
        raise NotImplementedError

    def PushMetrics(self, request, context):  # noqa: N802
        raise NotImplementedError

    def GetTaskInfos(self, request, context):  # noqa: N802
        raise NotImplementedError

    def GetApplicationStatus(self, request, context):  # noqa: N802
        raise NotImplementedError

    def StopApplication(self, request, context):  # noqa: N802
        raise NotImplementedError

    def StartProfile(self, request, context):  # noqa: N802
        raise NotImplementedError


def _remote_parent(context) -> str:
    """Span id the caller attached in metadata ('' for untraced callers)."""
    try:
        for k, v in context.invocation_metadata() or ():
            if k == trace.RPC_METADATA_KEY:
                return v.rsplit("/", 1)[-1]
    except Exception:
        pass
    return ""


def _wrap(method: Callable[[Any, Any], Any]) -> Callable[[Any, Any], Any]:
    requests = get_registry().counter(
        "tony_rpc_requests_total", "served control-plane RPCs",
        method=method.__name__,
    )

    def handler(request, context):
        # chaos seam: delay_rpc injects latency into served control-plane
        # calls (per-method filterable); no-op unless this process armed
        chaos_hook("rpc.server", method=method.__name__)
        requests.inc()
        tracer = trace.active_tracer()
        sp = trace.NOOP_SPAN
        if tracer is not None:
            # server dispatch span, parented on the CALLER's client span
            # via metadata — the cross-process edge of the trace tree
            sp = tracer.span(
                f"rpc.server/{method.__name__}",
                parent=_remote_parent(context) or None,
                method=method.__name__,
            )
        with sp:
            try:
                return method(request, context)
            except NotImplementedError:
                context.abort(grpc.StatusCode.UNIMPLEMENTED, "not implemented")
            except Exception as e:  # surface servicer bugs to the caller
                log.exception("rpc %s failed", method.__name__)
                context.abort(grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}")

    return handler


def serve(
    servicer: ApplicationRpcServicer,
    host: str = "0.0.0.0",
    port: int = 0,
    max_workers: int = 16,
    token: str | None = None,
) -> tuple[grpc.Server, int]:
    """Start the RPC server; returns (server, bound_port).

    ``token`` enables per-application auth (application.security.enabled):
    every call must carry it in metadata (see rpc.auth).
    """
    handlers = {
        name: grpc.unary_unary_rpc_method_handler(
            _wrap(getattr(servicer, name)),
            request_deserializer=req.FromString,
            response_serializer=resp.SerializeToString,
        )
        for name, (req, resp) in _METHODS.items()
    }
    interceptors = ()
    if token:
        from tony_tpu_torch.rpc.auth import TokenServerInterceptor

        interceptors = (TokenServerInterceptor(token),)
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers), interceptors=interceptors
    )
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),)
    )
    bound = server.add_insecure_port(f"{host}:{port}")
    if bound == 0:
        raise RuntimeError(f"could not bind RPC port {host}:{port}")
    server.start()
    return server, bound


class ApplicationRpcClient:
    """Typed client for every control-plane method.

    Used by executors (register/heartbeat/result/metrics) and by the CLI
    (status/stop/task-infos) — the reference splits these across
    ApplicationRpcClient and YARN report polling; here the AM answers both.
    """

    def __init__(self, address: str, timeout_s: float = 10.0, token: str | None = None):
        self.address = address
        self.timeout_s = timeout_s
        self._metadata = None
        if token:
            from tony_tpu_torch.rpc.auth import client_metadata

            self._metadata = client_metadata(token)
        self._channel = grpc.insecure_channel(
            address,
            options=[
                ("grpc.enable_retries", 1),
                ("grpc.keepalive_time_ms", 30000),
            ],
        )
        for name, (req, resp) in _METHODS.items():
            stub = self._channel.unary_unary(
                f"/{SERVICE_NAME}/{name}",
                request_serializer=req.SerializeToString,
                response_deserializer=resp.FromString,
            )
            setattr(self, f"_stub_{name}", stub)

    def _call(self, name: str, request, timeout_s: float | None = None):
        stub = getattr(self, f"_stub_{name}")
        tracer = trace.active_tracer()
        if tracer is None:
            return stub(
                request, timeout=timeout_s or self.timeout_s, metadata=self._metadata
            )
        # client dispatch span; its id rides the call metadata so the
        # server's span parents on it across the process boundary —
        # tracer.ctx() owns the "<trace_id>/<span_id>" wire format
        with tracer.span(f"rpc.client/{name}", method=name):
            md = tuple(self._metadata or ()) + (
                (trace.RPC_METADATA_KEY, tracer.ctx()),
            )
            return stub(request, timeout=timeout_s or self.timeout_s, metadata=md)

    # --- executor-side ---
    def register_worker_spec(
        self,
        job_name: str,
        index: int,
        host: str,
        port: int,
        attempt: int = 0,
        container_id: str = "",
    ) -> pb.RegisterWorkerSpecResponse:
        return self._call(
            "RegisterWorkerSpec",
            pb.RegisterWorkerSpecRequest(
                job_name=job_name,
                index=index,
                host=host,
                port=port,
                attempt=attempt,
                container_id=container_id,
            ),
        )

    def get_cluster_spec(
        self, job_name: str, index: int, attempt: int = 0
    ) -> pb.GetClusterSpecResponse:
        return self._call(
            "GetClusterSpec",
            pb.GetClusterSpecRequest(job_name=job_name, index=index, attempt=attempt),
        )

    def heartbeat(self, job_name: str, index: int, attempt: int = 0) -> pb.HeartbeatResponse:
        return self._call(
            "Heartbeat",
            pb.HeartbeatRequest(job_name=job_name, index=index, attempt=attempt),
        )

    def register_execution_result(
        self, job_name: str, index: int, exit_code: int, message: str = "", attempt: int = 0
    ) -> pb.RegisterExecutionResultResponse:
        return self._call(
            "RegisterExecutionResult",
            pb.RegisterExecutionResultRequest(
                job_name=job_name,
                index=index,
                exit_code=exit_code,
                message=message,
                attempt=attempt,
            ),
        )

    def register_tensorboard_url(self, url: str) -> None:
        self._call("RegisterTensorBoardUrl", pb.RegisterTensorBoardUrlRequest(url=url))

    def push_metrics(
        self, job_name: str, index: int, samples: list[tuple[str, float, float]]
    ) -> None:
        self._call(
            "PushMetrics",
            pb.PushMetricsRequest(
                job_name=job_name,
                index=index,
                samples=[
                    pb.MetricSample(name=n, value=v, timestamp=ts)
                    for n, v, ts in samples
                ],
            ),
        )

    # --- client-side ---
    def get_task_infos(self) -> pb.GetTaskInfosResponse:
        return self._call("GetTaskInfos", pb.GetTaskInfosRequest())

    def get_application_status(self) -> pb.GetApplicationStatusResponse:
        return self._call("GetApplicationStatus", pb.GetApplicationStatusRequest())

    def stop_application(self, reason: str = "") -> None:
        self._call("StopApplication", pb.StopApplicationRequest(reason=reason))

    def start_profile(
        self, steps: int = 0, duration_s: float = 0.0
    ) -> pb.StartProfileResponse:
        """Ask the AM to broadcast a bounded profile window to the fleet
        (`tony profile <app_id>`; docs/OBS.md "Step anatomy")."""
        return self._call(
            "StartProfile",
            pb.StartProfileRequest(steps=steps, duration_s=duration_s),
        )

    def close(self) -> None:
        self._channel.close()

    def __enter__(self) -> "ApplicationRpcClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# --- serving data plane (tony_tpu.ServeRpc) ----------------------------------
#
# The `tony serve` gang's RPC surface (docs/SERVE.md "Gang serving"): decode
# hosts serve it (serve/gang.py), the frontend both consumes it (routing) and
# re-serves it (the public endpoint), so one protocol covers client ->
# frontend -> host. Generate is server-streaming: tokens flow back as the
# engine samples them (the streaming completion return of the serve job type).

SERVE_SERVICE_NAME = "tony_tpu.ServeRpc"

# largest ServeRpc message a host takes in. gRPC's default, 4 MiB, is less
# than one Llama-3-8B KV block (4 MiB of int8 K/V plus its scales; 8 MiB in
# bf16), so a ShipBlocks of a real prompt would come back RESOURCE_EXHAUSTED
# (the reference keeps the default: ROADMAP queue 3, F5)
MAX_SERVE_MESSAGE_BYTES = 2**31 - 1

# method name -> (request class, response class, server-streaming?)
_SERVE_METHODS: dict[str, tuple[Any, Any, bool]] = {
    "Generate": (pb.InferenceRequest, pb.TokenChunk, True),
    "DecodeStats": (pb.DecodeStatsRequest, pb.DecodeStatsResponse, False),
    "Drain": (pb.DrainRequest, pb.DrainResponse, False),
    "Prefill": (pb.PrefillRequest, pb.PrefillResponse, False),
    "ShipBlocks": (pb.ShipBlocksRequest, pb.ShipBlocksResponse, False),
}


class ServeRpcServicer:
    """Override the methods you serve; unimplemented ones raise UNIMPLEMENTED."""

    def Generate(self, request, context):  # noqa: N802 (rpc casing)
        raise NotImplementedError

    def DecodeStats(self, request, context):  # noqa: N802
        raise NotImplementedError

    def Drain(self, request, context):  # noqa: N802
        raise NotImplementedError

    def Prefill(self, request, context):  # noqa: N802
        raise NotImplementedError

    def ShipBlocks(self, request, context):  # noqa: N802
        raise NotImplementedError


def _wrap_stream(method: Callable[[Any, Any], Any]) -> Callable[[Any, Any], Any]:
    """Server-streaming twin of _wrap: the span covers the WHOLE stream
    (first chunk to exhaustion), so a slow consumer or a mid-stream death
    is visible as span duration / an error arg on the shared timeline."""
    requests = get_registry().counter(
        "tony_rpc_requests_total", "served control-plane RPCs",
        method=method.__name__,
    )

    def handler(request, context):
        chaos_hook("rpc.server", method=method.__name__)
        requests.inc()
        tracer = trace.active_tracer()
        sp = trace.NOOP_SPAN
        if tracer is not None:
            sp = tracer.span(
                f"rpc.server/{method.__name__}",
                parent=_remote_parent(context) or None,
                method=method.__name__,
            )
        with sp:
            try:
                yield from method(request, context)
            except NotImplementedError:
                context.abort(grpc.StatusCode.UNIMPLEMENTED, "not implemented")
            except Exception as e:  # surface servicer bugs to the caller
                log.exception("rpc %s failed", method.__name__)
                context.abort(grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}")

    return handler


def serve_rpc(
    servicer: ServeRpcServicer,
    host: str = "0.0.0.0",
    port: int = 0,
    max_workers: int = 16,
    token: str | None = None,
    bind_attempts: int = 1,
) -> tuple[grpc.Server, int]:
    """Start a ServeRpc server; returns (server, bound_port).

    ``bind_attempts`` > 1 retries a busy non-ephemeral port with a short
    backoff (utils.net.bind_with_retry): the decode host binds the exact
    port the executor registered in the cluster spec, and the old
    pick-then-bind gap means that port can be in TIME_WAIT or briefly
    stolen when the host restarts.
    """
    handlers = {}
    for name, (req, resp, streaming) in _SERVE_METHODS.items():
        make = (
            grpc.unary_stream_rpc_method_handler
            if streaming
            else grpc.unary_unary_rpc_method_handler
        )
        wrap = _wrap_stream if streaming else _wrap
        handlers[name] = make(
            wrap(getattr(servicer, name)),
            request_deserializer=req.FromString,
            response_serializer=resp.SerializeToString,
        )
    interceptors = ()
    if token:
        from tony_tpu_torch.rpc.auth import TokenServerInterceptor

        interceptors = (TokenServerInterceptor(token),)
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers), interceptors=interceptors,
        options=[("grpc.max_receive_message_length", MAX_SERVE_MESSAGE_BYTES)],
    )
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVE_SERVICE_NAME, handlers),)
    )
    from tony_tpu_torch.utils.net import bind_with_retry

    bound = bind_with_retry(
        lambda p: server.add_insecure_port(f"{host}:{p}") or None,
        port, attempts=bind_attempts,
    )
    server.start()
    return server, bound


class ServeRpcClient:
    """Typed client for the serving data plane (frontend -> decode host,
    and external clients -> frontend). Same trace-context propagation as
    ApplicationRpcClient: every call's client span id rides the metadata
    so the server span parents on it across the process boundary."""

    def __init__(self, address: str, timeout_s: float = 30.0, token: str | None = None):
        self.address = address
        self.timeout_s = timeout_s
        self._metadata = None
        if token:
            from tony_tpu_torch.rpc.auth import client_metadata

            self._metadata = client_metadata(token)
        self._channel = grpc.insecure_channel(
            address, options=[("grpc.enable_retries", 1)]
        )
        for name, (req, resp, streaming) in _SERVE_METHODS.items():
            make = self._channel.unary_stream if streaming else self._channel.unary_unary
            stub = make(
                f"/{SERVE_SERVICE_NAME}/{name}",
                request_serializer=req.SerializeToString,
                response_deserializer=resp.FromString,
            )
            setattr(self, f"_stub_{name}", stub)

    def _metadata_with_ctx(self) -> tuple | None:
        tracer = trace.active_tracer()
        if tracer is None:
            return self._metadata
        return tuple(self._metadata or ()) + (
            (trace.RPC_METADATA_KEY, tracer.ctx()),
        )

    def generate(self, request: pb.InferenceRequest, timeout_s: float | None = None):
        """Server-streaming call; yields TokenChunk. The client span wraps
        only the DISPATCH (the stream outlives the call frame); chunk
        arrival cadence is the host-side serve.decode span's business."""
        tracer = trace.active_tracer()
        if tracer is not None:
            with tracer.span("rpc.client/Generate", method="Generate", rid=request.rid):
                return self._stub_Generate(
                    request, timeout=timeout_s or self.timeout_s,
                    metadata=self._metadata_with_ctx(),
                )
        return self._stub_Generate(
            request, timeout=timeout_s or self.timeout_s, metadata=self._metadata
        )

    def _call(self, name: str, request, timeout_s: float | None = None):
        stub = getattr(self, f"_stub_{name}")
        tracer = trace.active_tracer()
        if tracer is None:
            return stub(
                request, timeout=timeout_s or self.timeout_s, metadata=self._metadata
            )
        with tracer.span(f"rpc.client/{name}", method=name):
            return stub(
                request, timeout=timeout_s or self.timeout_s,
                metadata=self._metadata_with_ctx(),
            )

    def decode_stats(self, timeout_s: float | None = None) -> pb.DecodeStatsResponse:
        return self._call("DecodeStats", pb.DecodeStatsRequest(), timeout_s)

    def prefill(
        self,
        rid: str,
        prompt: list[int],
        target: str,
        rng_seed: int = 0,
        timeout_s: float | None = None,
    ) -> pb.PrefillResponse:
        """Ask a prefill host to prefill ``prompt`` and ship the finished KV
        blocks to ``target`` (a decode host address)."""
        return self._call(
            "Prefill",
            pb.PrefillRequest(rid=rid, prompt=prompt, target=target, rng_seed=rng_seed),
            timeout_s,
        )

    def ship_blocks(
        self, request: pb.ShipBlocksRequest, timeout_s: float | None = None
    ) -> pb.ShipBlocksResponse:
        """Stream a finished block payload to a decode host (prefill -> decode
        edge of the handoff; the caller builds the request from pack_payload)."""
        return self._call("ShipBlocks", request, timeout_s)

    def drain(
        self, timeout_s: float = 0.0, recycle: bool = False,
        rpc_timeout_s: float | None = None,
    ) -> pb.DrainResponse:
        # the RPC deadline must OUTLIVE the server-side work: the host's
        # drain wait (its own configured budget when timeout_s is 0 — the
        # client cannot see it, so allow generously) plus an engine rebuild
        # on recycle (model init + first compiles can take minutes on a
        # big model). A deadline shorter than the drain would report a
        # successfully drained host as failed.
        deadline = rpc_timeout_s or (timeout_s + 180.0 if timeout_s else 300.0)
        return self._call(
            "Drain", pb.DrainRequest(timeout_s=timeout_s, recycle=recycle),
            deadline,
        )

    def close(self) -> None:
        self._channel.close()

    def __enter__(self) -> "ServeRpcClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = [
    "ApplicationRpcClient",
    "ApplicationRpcServicer",
    "SERVE_SERVICE_NAME",
    "SERVICE_NAME",
    "ServeRpcClient",
    "ServeRpcServicer",
    "serve",
    "serve_rpc",
]
