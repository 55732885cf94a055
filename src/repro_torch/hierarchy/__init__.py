"""Host side of the pod topology (port of ``repro/hierarchy``)."""
from repro_torch.hierarchy.cluster import ClusterState

__all__ = ["ClusterState"]
