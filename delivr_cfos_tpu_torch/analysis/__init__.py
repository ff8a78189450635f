from delivr_cfos_tpu_torch.analysis.elastix_points import (
    apply_transform_chain,
    transform_points_native,
)
from delivr_cfos_tpu_torch.analysis.ontology import parse_ontology_xml

__all__ = [
    "parse_ontology_xml",
    "apply_transform_chain",
    "transform_points_native",
]
