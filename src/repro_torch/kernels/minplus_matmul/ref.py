"""Plain PyTorch version of the min-plus matmul kernel."""
import torch


def minplus_matmul_ref(a, b):
    """C[i,j] = min_k A[i,k] + B[k,j], broadcast over slices of k so the
    [M, k, N] temporary stays near 2^26 elements."""
    m, k = a.shape
    n = b.shape[1]
    out = torch.full((m, n), float("inf"), dtype=a.dtype, device=a.device)
    step = max(1, 2 ** 26 // max(1, m * n))
    for k0 in range(0, k, step):
        part = a[:, k0:k0 + step, None] + b[None, k0:k0 + step, :]
        out = torch.minimum(out, part.amin(1))
    return out
