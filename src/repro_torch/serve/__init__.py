"""Serving front ends of the port: the LM ``ServeEngine`` and the graph
query service (``GraphQueryService``, its durable snapshots and its
in-process replicas)."""

from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.graph_service import (
    AdmissionRejected,
    CancelledRequest,
    DrainTimeout,
    FailedRequest,
    GraphQueryService,
    GraphServiceConfig,
    RejectedRequest,
)
from repro_torch.serve.persist import ServiceCheckpointer
from repro_torch.serve.replicas import ReplicatedGraphService

__all__ = [
    "AdmissionRejected", "CancelledRequest", "DrainTimeout", "FailedRequest",
    "GraphQueryService", "GraphServiceConfig", "RejectedRequest",
    "ReplicatedGraphService", "ServeConfig", "ServeEngine",
    "ServiceCheckpointer",
]
