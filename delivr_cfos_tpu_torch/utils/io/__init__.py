from delivr_cfos_tpu_torch.utils.io.nifti import read_nifti, write_nifti

__all__ = ["read_nifti", "write_nifti"]
