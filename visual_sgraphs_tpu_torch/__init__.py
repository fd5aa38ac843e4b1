"""PyTorch / CUDA port of ``visual_sgraphs_tpu`` (the JAX package stays as
the reference).

The ported slice is RGB-D tracking + keyframe insertion + local BA
(``slam.system.SlamSystem``).  Its hot functions are hand-written Hopper
kernels (``csrc/``, built and bound by ``cuda.py``), each with a plain
PyTorch twin that runs on CPU tensors.  The package imports ``torch`` and
``numpy``, never ``jax``.
"""
