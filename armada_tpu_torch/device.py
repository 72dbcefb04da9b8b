"""Device resolution and the port's numeric conventions.

The solve runs on the CUDA card unless the caller asks for the CPU
(`device="cpu"`, as the CPU tests do). There is no silent fallback: with
no card present the default raises.

Numeric conventions, fixed for every tensor the solver makes:
- costs, fair shares and token counts are float64 (`COST_DTYPE`);
- packed best-fit keys and sort keys are int64 (`KEY_DTYPE`);
- resource lanes stay int32, as the host prep emits them.
Hopper runs float64 and int64 natively, so the port has no float32 mode.
"""

from __future__ import annotations

import os

import torch

DEFAULT_DEVICE = "cuda"
COST_DTYPE = torch.float64
KEY_DTYPE = torch.int64


def resolve_device(device=None) -> torch.device:
    """The torch device a solve runs on: `device` when given, else the
    CUDA card. Raises when CUDA is asked for (explicitly or by default)
    and no card is present. Turns on deterministic algorithms, so every
    reduction and scatter the solver uses has a fixed order."""
    # cuBLAS refuses deterministic mode without a fixed workspace; set it
    # before the first CUDA call (the solver itself runs no matmul).
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # The switch is process-wide and nothing in the port turns it off
    # (ops/segment.py sums integers without it), so it is set once.
    if not torch.are_deterministic_algorithms_enabled():
        torch.use_deterministic_algorithms(True)
    # Deterministic mode also fills every fresh allocation, which a round
    # of small eager ops pays as one extra kernel per op; no op here reads
    # memory it did not write, so the fill is turned off.
    torch.utils.deterministic.fill_uninitialized_memory = False
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "armada_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the solve on the CPU"
        )
    return dev
