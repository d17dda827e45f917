"""CORE on PyTorch and CUDA: the streaming recognition and counting path.

A port of the JAX package ``repro`` that imports neither JAX nor ``repro``:
``core`` and ``data`` are copies of the host layer, ``vector`` holds the
device engines, and ``kernels`` the hand-written Hopper kernels with their
plain PyTorch versions.  Engines run on the CUDA device unless the caller
passes ``device="cpu"``.
"""
