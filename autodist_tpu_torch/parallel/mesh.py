"""Mesh shape resolution (``autodist_tpu/parallel/mesh.py:26-65``). The port
records the named mesh in the strategy and runs one process per device: a
``seq`` axis of k > 1 is the process group of k ranks that
:mod:`autodist_tpu_torch.parallel.sequence` joins. Data axes over more than
one device are not ported yet."""

import collections
import math
from typing import Dict, Optional

from autodist_tpu_torch import const

# Canonical axis order. Axes the user does not size default to 1.
STANDARD_AXES = (
    const.MESH_AXIS_DATA,
    const.MESH_AXIS_REDUCE,
    const.MESH_AXIS_MODEL,
    const.MESH_AXIS_SEQ,
    const.MESH_AXIS_EXPERT,
    const.MESH_AXIS_PIPE,
)


def standard_mesh_shape(n_devices: int, axes: Optional[Dict[str, int]] = None
                        ) -> "collections.OrderedDict":
    """Resolve a possibly-partial axis-size dict into a full OrderedDict over
    STANDARD_AXES. A value of ``-1`` (or an unspecified ``data`` axis) absorbs
    the remaining devices. Raises if the product does not match ``n_devices``."""
    axes = dict(axes or {})
    unknown = set(axes) - set(STANDARD_AXES)
    if unknown:
        raise ValueError(f"Unknown mesh axes {sorted(unknown)}; valid: {STANDARD_AXES}")
    shape = collections.OrderedDict((a, int(axes.get(a, 1))) for a in STANDARD_AXES)
    if const.MESH_AXIS_DATA not in axes:
        shape[const.MESH_AXIS_DATA] = -1
    bad = {a: s for a, s in shape.items() if s != -1 and s < 1}
    if bad:
        raise ValueError(f"Mesh axis sizes must be >= 1 (or -1 to fill), got {bad}")
    fill_axes = [a for a, s in shape.items() if s == -1]
    if len(fill_axes) > 1:
        raise ValueError(f"At most one -1 axis allowed, got {fill_axes}")
    fixed = math.prod(s for s in shape.values() if s != -1)
    if fill_axes:
        if n_devices % fixed != 0:
            raise ValueError(
                f"Cannot fill axis {fill_axes[0]}: {n_devices} devices not divisible by {fixed}")
        shape[fill_axes[0]] = n_devices // fixed
    elif fixed != n_devices:
        raise ValueError(f"Mesh axes {dict(shape)} require {fixed} devices, have {n_devices}")
    return shape
