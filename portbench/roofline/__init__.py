"""Least times of the round's kernels, from bytes counted from shapes.

Each kernel has a module of its own here, named as its metric's prefix
(`<kernel>_roofline`), with `KERNEL`, the part of the device operation's
name that its launches carry, and `launch_bytes(shape)`, the bytes one
launch must move at the round's shape: each input byte read once and
each output byte written once, whatever the kernel reads again. Both
kernels are bound by memory, so the least time of a launch is its bytes
over the card's peak bandwidth.

The round's shape comes from the configuration, never from the
arguments the program passes: the node axis padded to a power of two
(as the round pads it), the four resource lanes of the pool's scheduling
config (memory, cpu, ephemeral-storage, nvidia.com/gpu), one word of
taint and of label bits, and the fill window.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
RESOURCE_LANES = 4


def pow2(n: int, floor: int = 8) -> int:
    n = max(int(n), floor)
    return 1 << (n - 1).bit_length()


def round_shape(config: dict) -> dict:
    nodes = pow2(config["nodes"])
    return {
        "nodes": nodes,
        "lanes": RESOURCE_LANES,
        "taint_words": 1,
        "label_words": 1,
        "window": min(int(config["batch_fill_window"]), nodes),
    }


def least_seconds(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S
