"""Node-sharded execution of the round: an in-process shard group (comm),
the node-axis split of a round and the sharded runner (mesh), the
(hosts, chips) mesh with the solver seam (multihost), and a shard group
of one process per shard over torch.distributed (pgroup) with its
launcher."""
