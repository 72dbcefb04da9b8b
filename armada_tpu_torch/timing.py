"""Timing on the card, for chip_smoke.py and the launcher's ring drive:
CUDA events around many calls, and torch.profiler's device time per
kernel launch. Both need a CUDA card."""

from __future__ import annotations

import torch


def cuda_ms(fn, iters: int, warm: int = 3) -> float:
    """Mean milliseconds per call of fn() on the current card: CUDA events
    around `iters` calls, after `warm` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fns: dict, iters: int, kernel: str) -> dict:
    """Mean device milliseconds per launch of the kernel whose name holds
    `kernel`, for each fn of `fns` ({label: fn}), from one profiler session
    that calls each fn `iters` times in turn (after one warm call each).
    Every label maps to None when the profiler did not see each launch. A
    second profiler session in one worker process has been seen to lose
    the kernel events, so a caller takes all its labels in one."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for fn in fns.values():
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    spans = sorted(
        (e.time_range.start, e.time_range.elapsed_us()) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name
    )
    if len(spans) != iters * len(fns):
        return dict.fromkeys(fns)
    return {
        label: sum(us for _, us in spans[i * iters:(i + 1) * iters]) / iters / 1e3
        for i, label in enumerate(fns)
    }
