"""Architecture registry: ``--arch <id>`` resolution for the launchers —
the port's copy of ``repro.configs.registry``, holding the architectures
ported so far. Any other of ``repro``'s ids raises a ``KeyError`` that
names the slice of the port that brings it."""
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
}

_LATER = {
    "islabel": "the data, distributed and launcher slice",
}

PORTED = list(_MODULES)


def get_spec(arch_id: str):
    if arch_id in _LATER:
        raise KeyError(f"arch {arch_id!r} is not ported yet: it comes with "
                       f"{_LATER[arch_id]}; ported: {sorted(_MODULES)}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).get_spec()
