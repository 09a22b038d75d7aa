"""Timing on the card, shared by ``chip_smoke.py`` and the profile tools."""

from __future__ import annotations

import re
import subprocess
from pathlib import Path

# Cycles a spin kernel holds the stream before a timed run (about 50 ms
# on an H100): more than the host needs to enqueue the calls of one run.
HOLD_CYCLES = 90_000_000


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def events_ms(fn, iters: int, warmup: int = 2, hold: bool = True) -> float:
    """Mean time of ``fn`` over ``iters`` calls after ``warmup``, by CUDA
    events.  With ``hold`` a spin kernel holds the stream while the host
    enqueues the calls, so a wrapper's host work does not show where the
    device work is shorter: the time on the device.  Without it, the time
    a caller that loops sees."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if hold:
        torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, reps: int = 1):
    """``(device ms, device operations)`` of one call of ``fn``: the
    operations (kernels, copies, fills) ``torch.profiler`` traces over
    ``reps`` calls, and their summed durations, per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = [evt for evt in prof.events()
           if evt.device_type == torch.autograd.DeviceType.CUDA]
    if not ops:
        raise RuntimeError("the profiler saw no device operation")
    ms = sum(evt.time_range.elapsed_us() for evt in ops) / 1e3
    return ms / reps, len(ops) / reps


def print_resource_usage(source: str, kernels: str) -> None:
    """Registers, stack and local (spill) memory of each instance of the
    kernels of ``csrc/<source>`` whose names match the regular expression
    ``kernels``, as ``cuobjdump --dump-resource-usage`` reads them from
    the built library; each instance named with its template arguments
    (integers, then the element type)."""
    from ray_tpu_torch.ops import _build
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run(
        [str(cuobjdump), "--dump-resource-usage",
         str(_build._target(source))],
        capture_output=True, text=True, check=True).stdout
    print(f"{source} kernel instances (cuobjdump --dump-resource-usage):")
    # Mangled: <name>I(Li<int>E)*[<type>]E...
    pattern = re.compile(
        rf"({kernels})I((?:Li\d+E)*)(13__nv_bfloat16|f)?E")
    name = None
    for line in out.splitlines():
        found = pattern.search(line)
        if "Function" in line and found:
            args = re.findall(r"Li(\d+)E", found.group(2))
            if found.group(3):
                args.append("bf16" if "bfloat16" in found.group(3)
                            else "f32")
            name = f"{found.group(1)}<{', '.join(args)}>"
        elif name and "REG:" in line:
            fields = [f for f in line.split() if f.split(":")[0] in
                      ("REG", "STACK", "LOCAL")]
            print(f"  {name}  {' '.join(fields)}")
            name = None


# Kernel-name groups of the switch-MoE FFN's work outside the matrix
# products (``models/moe.py``): the router's softmax, argmax and
# cumulative sum, and the dispatch and combine gathers and scatters (the
# embedding's gather and the loss's gather land there too).
MOE_GROUPS = (
    ("MoE router (softmax, argmax, cumsum)", ("softmax", "argmax", "scan")),
    ("gathers, scatters, index kernels (MoE dispatch and combine, "
     "embedding, the loss's gather)", ("index", "scatter", "gather")),
)


def expert_product_ms(prof, capacity: int, reps: int) -> float:
    """Device ms per repetition of the experts' batched products, forward
    and backward: the kernels of the ``aten::bmm`` calls of a profile
    recorded with ``record_shapes`` whose inputs carry the experts'
    capacity ``capacity`` as a dimension (no other product of the model
    has it)."""
    total = 0.0
    for avg in prof.key_averages(group_by_input_shape=True):
        if avg.key != "aten::bmm":
            continue
        dims = {d for shape in (avg.input_shapes or []) for d in shape}
        if capacity in dims:
            us = getattr(avg, "self_device_time_total",
                         getattr(avg, "self_cuda_time_total", 0.0))
            total += us / 1e3 / reps
    return total
