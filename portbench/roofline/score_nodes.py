"""score_nodes (csrc/score_nodes.cu): one job's fit, capacity and
best-fit key on every node.

Per node it reads the row of allocatable at the evicted priority and the
node's total (a lane each, int32), its taint and label words, its rank
and id (int32) and its unschedulable flag (one byte), and writes the fit
flag (one byte), the capacity (int32) and the key (int64). Per job it
reads the request (a lane each), its toleration and selector words, its
excluded nodes (8 slots of int32), the resource order and resolutions
(two of each, int32) and the key's three bit widths; a job with an
affinity group also reads one bit a node.
"""

KERNEL = "score_nodes_kernel"
EXCLUDED_SLOTS = 8


def launch_bytes(shape: dict, affinity: bool = False) -> int:
    n, r = shape["nodes"], shape["lanes"]
    words = shape["taint_words"] + shape["label_words"]
    per_node_in = 2 * r * 4 + words * 4 + 4 + 4 + 1
    per_node_out = 1 + 4 + 8
    per_job = r * 4 + words * 4 + EXCLUDED_SLOTS * 4 + 2 * 4 + 2 * 4 + 3 * 4
    aff = (n + 31) // 32 * 4 if affinity else 0
    return n * (per_node_in + per_node_out) + per_job + aff
