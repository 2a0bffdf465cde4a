"""PyTorch / CUDA port of NopeSAC (two-view plane detection, Sinkhorn plane
matching and NOPE-SAC relative pose), written for an NVIDIA Hopper card.

The layout mirrors the JAX package module for module. This package imports
`torch` only: it never imports JAX, Flax or the JAX package, and keeps its
own copies of the host code it needs. Entry points run on `cuda`
unless the caller passes `device="cpu"`; on a CPU tensor every kernel
wrapper runs its plain PyTorch version instead of the CUDA kernel.
"""
