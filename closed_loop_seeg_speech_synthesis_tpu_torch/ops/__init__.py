"""Numerics: host-side design code (numpy) and torch device ops, plus the
two CUDA kernels of the replay path (``cuda_frontend``, ``cuda_gl``).

Submodules are imported by their users; importing this package loads none
of them, so no kernel is built and no optional dependency is touched."""
