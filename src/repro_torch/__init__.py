"""PyTorch/CUDA port of the Voronoi token-pruning retrieval system.

Mirrors the JAX reference package ``repro`` module for module
(``core/``, ``kernels/<name>/``, ``models/``, ``serve/``, ``data/``,
``launch/``).  Plain tensor code is PyTorch; every Pallas kernel of the
reference is a hand-written CUDA C++ kernel for Hopper (``sm_90a``)
under ``kernels/csrc/``, built with ``nvcc`` at first use and bound with
``ctypes``.  This package never imports ``jax`` or ``repro``.
"""
