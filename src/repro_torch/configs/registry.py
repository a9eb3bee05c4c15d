"""Architecture registry: ``--arch <id>`` resolution for the launchers —
the port's copy of ``repro.configs.registry``, holding the architectures
ported so far. Any other of ``repro``'s ids raises a ``KeyError`` that
names the slice of the port that brings it."""
from __future__ import annotations

import importlib

_MODULES = {
    # GNN family
    "dimenet": "repro_torch.configs.dimenet",
    "graphsage-reddit": "repro_torch.configs.graphsage_reddit",
    "gcn-cora": "repro_torch.configs.gcn_cora",
    "egnn": "repro_torch.configs.egnn",
    # recsys
    "dien": "repro_torch.configs.dien",
}

_LATER = {
    "qwen2-moe-a2.7b": "the LM slice",
    "kimi-k2-1t-a32b": "the LM slice",
    "granite-8b": "the LM slice",
    "yi-34b": "the LM slice",
    "qwen2-72b": "the LM slice",
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
