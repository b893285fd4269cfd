"""Synthetic stand-ins for the paper's datasets (§4.1, Table 2), as in
``repro.graphs.datasets``: same vertex/edge/label cardinalities, same seeds.
"""

from __future__ import annotations

from typing import NamedTuple

from repro_torch.graphs.csr import Graph
from repro_torch.graphs.generators import power_law_graph, random_labeled_graph


class DatasetSpec(NamedTuple):
    name: str
    n_vertices: int
    n_edges: int
    n_labels: int
    label_dist: str = "uniform"
    power_law: bool = False


PAPER_DATASETS: dict[str, DatasetSpec] = {
    # Table 2 of the paper.
    "HUMAN": DatasetSpec("HUMAN", 4_675, 86_282, 44),
    "HPRD": DatasetSpec("HPRD", 9_460, 37_081, 307),
    "YEAST": DatasetSpec("YEAST", 3_112, 12_519, 71),
    "DANIO-RERIO-32u": DatasetSpec("DANIO-RERIO-32u", 5_720, 51_464, 32, "uniform"),
    "DANIO-RERIO-128u": DatasetSpec("DANIO-RERIO-128u", 5_720, 51_464, 128, "uniform"),
    "DANIO-RERIO-32g": DatasetSpec("DANIO-RERIO-32g", 5_720, 51_464, 32, "gaussian"),
    "DANIO-RERIO-128g": DatasetSpec("DANIO-RERIO-128g", 5_720, 51_464, 128, "gaussian"),
    "LIVEJOURNAL": DatasetSpec("LIVEJOURNAL", 4_847_571, 68_993_773, 200, "uniform", True),
    "TWITTER": DatasetSpec("TWITTER", 17_069_982, 476_553_560, 200, "uniform", True),
    "FRIENDSTER": DatasetSpec("FRIENDSTER", 65_608_366, 1_806_067_310, 512, "uniform", True),
}


def paper_dataset(name: str, *, scale: float = 1.0, seed: int = 7,
                  device=None) -> Graph:
    """Instantiate a synthetic stand-in, optionally down-scaled."""
    spec = PAPER_DATASETS[name]
    n_v = max(64, int(spec.n_vertices * scale))
    n_e = max(128, int(spec.n_edges * scale))
    if spec.power_law:
        return power_law_graph(
            n_v,
            avg_degree=max(2.0, 2.0 * n_e / n_v),
            n_labels=spec.n_labels,
            label_dist=spec.label_dist,
            seed=seed,
            device=device,
        )
    return random_labeled_graph(
        n_v, n_e, spec.n_labels, label_dist=spec.label_dist, seed=seed,
        device=device,
    )
