"""fill_take (csrc/fill_take.cu): the `want` smallest of n packed int64
best-fit keys, in order.

It reads every key once and writes `want` keys (int64) and their
positions (int32)."""

KERNEL = "fill_take_kernel"


def launch_bytes(shape: dict) -> int:
    return shape["nodes"] * 8 + shape["window"] * 12
