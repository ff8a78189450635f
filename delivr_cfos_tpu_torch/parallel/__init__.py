from delivr_cfos_tpu_torch.parallel.mesh import make_mesh
from delivr_cfos_tpu_torch.parallel.sharded_inference import (
    plan_sharding,
    sharded_infer_volume,
)

__all__ = ["make_mesh", "plan_sharding", "sharded_infer_volume"]
