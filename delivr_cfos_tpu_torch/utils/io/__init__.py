from delivr_cfos_tpu_torch.utils.io.nifti import read_nifti, write_nifti
from delivr_cfos_tpu_torch.utils.io.zarr import ZarrVolume, write_zarr

__all__ = ["read_nifti", "write_nifti", "ZarrVolume", "write_zarr"]
