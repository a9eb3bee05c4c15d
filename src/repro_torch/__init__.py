"""IS-LABEL on PyTorch and CUDA: the port of ``repro`` (JAX/Pallas) to an
NVIDIA Hopper GPU. It imports torch, numpy and scipy, never jax nor
``repro``; ``repro`` stays the reference the port is tested against."""
