"""A frozen copy of the port's plain path for the benchmarked detector
(CenterPoint with the MsSVT backbone), taken from ``mssvt_tpu_torch`` at
commit abba4ff: the modules whole (``builders.py``, ``generic_post.py``
and ``losses.py`` cut to this detector's stages), with their
imports kept relative, so each can be held against its original by a
diff. The kernel modules keep only their plain versions (``fill_plain``,
``fps_plain``, ``ffn_plain``), the attention runs its plain route (the
assembly in tensor ops, then the per-group einsum), and the BatchNorm
layers keep no cross-rank reduction. Nothing here imports the port, JAX
or the JAX package, or reads what the program has made."""
