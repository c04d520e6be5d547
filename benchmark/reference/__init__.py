"""The benchmark's plain reference: an independent float64 re-derivation of
the renderer's compat semantics, in plain PyTorch, from the same OBJ / MTL /
.camera text and PNG texels that the program is handed.

Nothing here imports ``montecarlopathtracing_torch``, ``montecarlopathtracing_tpu``
or JAX, and nothing takes a tensor that the program made: the scene, its
light CDFs and its texture atlas are parsed and built again here.
"""
