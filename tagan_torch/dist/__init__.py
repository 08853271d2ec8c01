"""Distributed pieces of the port over a mesh of (possibly virtual)
ranks: the mesh (counterpart of ``tagan_tpu/dist/mesh.py``) and the
edge-partitioned attention with its collective ring (the first part of
``tagan_tpu/dist/edge_partition.py``)."""

from .edge_partition import (edge_partitioned_attention, make_ring_attention,
                             metric_placeholders,
                             partition_edges_by_query,
                             partition_edges_by_query_and_key,
                             ring_edge_attention, scaling_report)
from .mesh import (DATA_AXIS, GRAPH_AXIS, Mesh, gather_rows, make_mesh,
                   shard_rows)

__all__ = ["DATA_AXIS", "GRAPH_AXIS", "Mesh", "make_mesh", "shard_rows",
           "gather_rows", "partition_edges_by_query",
           "partition_edges_by_query_and_key", "edge_partitioned_attention",
           "make_ring_attention", "ring_edge_attention",
           "metric_placeholders", "scaling_report"]
