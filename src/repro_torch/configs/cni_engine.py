"""The CNI engine's presets (the port's copy of the fields it reads from
``repro.configs.cni_engine``)."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class CniEngineConfig:
    filter_variant: str = "cni"      # cni | cni_log | nlf | label_degree | mnd_nlf
    khop: int = 1
    searcher: str = "join"           # join | dfs
    enumerator: str = "host"         # host | device (two-phase resident join)
    distributed_axis: str = "data"   # the mesh axis of core/distributed.py
    # Batched multi-query engine (core/batch_engine.py): queries are bucketed
    # by (d_max, |L(Q)|, |V(Q)|) rounded to powers of two; max_batch bounds
    # the padded batch dim of one batched ILGF round.
    max_batch: int = 32
    # Serving front-end (serve/graph_service.py): static slot shapes.
    service_slots: int = 8
    service_max_query_vertices: int = 16
    service_max_query_labels: int = 16


CONFIG = CniEngineConfig()
