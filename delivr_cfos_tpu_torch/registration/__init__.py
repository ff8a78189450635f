"""Atlas registration in plain torch: the port's counterpart of
``delivr_cfos_tpu/registration``, with the same public names."""

from delivr_cfos_tpu_torch.registration.affine import (
    masked_mi,
    masked_ncc,
    register_affine,
    register_affine_multistart,
)
from delivr_cfos_tpu_torch.registration.landmarks import (
    affine_from_landmarks,
    read_marker_file,
    register_affine_landmarks,
)
from delivr_cfos_tpu_torch.registration.bspline import (
    BSplineField,
    register_bspline,
    warp_points,
)
from delivr_cfos_tpu_torch.registration.swc import read_swc, write_swc
from delivr_cfos_tpu_torch.registration.warp import (
    affine_warp_points,
    sample_volume,
    warp_volume_affine,
)

__all__ = [
    "register_affine",
    "register_affine_multistart",
    "register_affine_landmarks",
    "affine_from_landmarks",
    "read_marker_file",
    "masked_ncc",
    "masked_mi",
    "register_bspline",
    "warp_points",
    "BSplineField",
    "sample_volume",
    "warp_volume_affine",
    "affine_warp_points",
    "read_swc",
    "write_swc",
]
