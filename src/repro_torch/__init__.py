"""PyTorch/CUDA port of the Ising-machine extractive summarization system.

Mirrors the layout of the JAX reference package ``repro`` module for module
(``core``, ``kernels``, ``solvers``, ``data``, ``embeddings``, ``farm``,
``serving``, ``workloads``, ``launch``, ...) and never imports it: the tests
hand both packages the same inputs and compare.
"""
