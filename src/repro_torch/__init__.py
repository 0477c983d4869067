"""Hiperfact on PyTorch and CUDA: the port of the ``repro`` package.

``repro_torch`` mirrors the reference package's layout file for file for
the slices ported so far (see ROADMAP.md).  It imports ``torch`` and
``numpy`` and nothing of JAX or of ``repro``.
"""
