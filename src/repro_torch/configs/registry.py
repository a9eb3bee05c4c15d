"""Architecture registry: ``--arch <id>`` resolution for every launcher —
the port's copy of ``repro.configs.registry``."""
from __future__ import annotations

import importlib

_MODULES = {
    # LM family
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "yi-34b": "repro_torch.configs.yi_34b",
    "qwen2-72b": "repro_torch.configs.qwen2_72b",
    # GNN family
    "dimenet": "repro_torch.configs.dimenet",
    "graphsage-reddit": "repro_torch.configs.graphsage_reddit",
    "gcn-cora": "repro_torch.configs.gcn_cora",
    "egnn": "repro_torch.configs.egnn",
    # recsys
    "dien": "repro_torch.configs.dien",
    # the paper's own workload
    "islabel": "repro_torch.configs.islabel",
}

ASSIGNED = [a for a in _MODULES if a != "islabel"]


def get_spec(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).get_spec()


def all_cells(include_islabel: bool = False):
    """Every runnable (arch, shape) pair — the dry-run/roofline table."""
    out = []
    for arch in (list(_MODULES) if include_islabel else ASSIGNED):
        spec = get_spec(arch)
        for shape in spec.runnable_cells():
            out.append((arch, shape))
    return out
