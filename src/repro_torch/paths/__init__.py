# repro_torch.paths — batched shortest-path reconstruction over IS-LABEL
# indexes on the card (the port of repro.paths), plus the host-side
# validation gate.
from repro_torch.paths.engine import DEFAULT_HOP_CAP, PathBatch, PathEngine
from repro_torch.paths.validate import (check_path, check_path_batch,
                                        check_vertex_path, edge_weight_map,
                                        integral_weights)

__all__ = [
    "DEFAULT_HOP_CAP", "PathBatch", "PathEngine",
    "check_path", "check_path_batch", "check_vertex_path",
    "edge_weight_map", "integral_weights",
]
