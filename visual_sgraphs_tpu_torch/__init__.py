"""PyTorch / CUDA port of ``visual_sgraphs_tpu`` (the JAX package stays as
the reference).

The ported path is RGB-D tracking + keyframe insertion + local BA
(``slam.system.SlamSystem``), with the scene graph (planes, rooms,
semantic point refinement, scene-graph BA) when a
``scenegraph.SceneGraphManager`` is attached.  Its hot functions are
hand-written Hopper kernels (``csrc/``, built and bound by ``cuda.py``),
each with a plain PyTorch twin that runs on CPU tensors.  Entry points
run on the card unless the caller asks for ``device="cpu"``.  The package imports ``torch`` and
``numpy``, never ``jax``.
"""
