"""Host side of the pod topology (port of ``repro/hierarchy``)."""
from repro_torch.hierarchy.cluster import ClusterPolicy, ClusterState

__all__ = ["ClusterPolicy", "ClusterState"]
