"""Node-sharded execution of the round: an in-process shard group (comm),
the node-axis split of a round and the sharded runner (mesh), and the
(hosts, chips) mesh with the solver seam (multihost)."""
