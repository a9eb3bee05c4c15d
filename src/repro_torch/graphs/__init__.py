from repro_torch.graphs.csr import EdgeList, from_host_edges, neighbor_matrix
from repro_torch.graphs import generators, segment_ops
