# IS-LABEL in PyTorch: the port of repro.core, with hand-written CUDA
# kernels on the query path.
from repro_torch.core.config import IndexConfig, BuildStats
from repro_torch.core.dispatch import (CoreRelaxer, core_relax,
                                       label_intersect_dispatch)
from repro_torch.core.index import ISLabelIndex
from repro_torch.core.query import QueryEngine, label_intersect_mu
from repro_torch.core.hierarchy import build_hierarchy, Hierarchy
from repro_torch.core.labeling import build_labels
from repro_torch.core import ref
