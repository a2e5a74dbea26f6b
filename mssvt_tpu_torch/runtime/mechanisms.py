"""Function scopes for the byte count's mechanism keys.

``kernels.work.counting()`` keys each charge by the innermost active
module. Four mechanisms of the MsSVT block are functions, not modules, so
their charges would land on the block: :func:`function_scopes` wraps each
of them, in ``models/backbones_3d/mssvt.py``'s namespace, in
``work.scoped`` under its own name for the time of a counting run. These are
the functions ``tools/ablate_e2e_torch.py`` stubs; the model's code is not
touched.
"""

from __future__ import annotations

import contextlib

# mechanism (``ablate_e2e_torch.py``'s cut) -> function in mssvt.py
FUNCTIONS = {"gather": "gather_window_voxels",
             "fps": "farthest_point_sample_planes_select",
             "interp": "three_interp_weights_planes",
             "writeback": "writeback_inverse_paired"}


@contextlib.contextmanager
def function_scopes():
    """Charges made inside each of :data:`FUNCTIONS` go under
    ``<module path>/<function>``."""
    from ..kernels import work
    from ..models.backbones_3d import mssvt

    saved = {name: getattr(mssvt, name) for name in FUNCTIONS.values()}
    try:
        for name, fn in saved.items():
            setattr(mssvt, name, work.scoped(name, fn))
        yield
    finally:
        for name, fn in saved.items():
            setattr(mssvt, name, fn)
