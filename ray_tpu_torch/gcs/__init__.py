"""The GCS's managers that the port has: the placement-group manager,
hung off ``LocalCluster`` until the GCS itself is ported (ROADMAP
A.4b.4)."""
