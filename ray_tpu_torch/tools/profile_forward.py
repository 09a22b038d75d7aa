"""Where the transformer's forward pass spends its time on the card.

    python -m ray_tpu_torch.tools.profile_forward [--moe]

Builds ``bench_model.py``'s single-chip model and batch as
``ray_tpu_torch.models.bench`` defines them for ``chip_smoke.py``'s M2
(the same weights and tokens), runs ``REPS`` forwards under
``torch.inference_mode()`` after ``WARMUP``, first without and then
under ``torch.profiler``, and prints, per forward: the device time
summed over kernels (from the profiled run), the wall time without the
profiler and the device's idle share against it (the profiler's own
host work would inflate both; they are printed beside), and the device
time by group (the flash kernel,
matrix products, everything else) and by kernel; last, the registers and
local (spill) memory of each instance of the flash kernels (bf16 on the
tensor cores, float32 on the CUDA cores, at each head width), as
``cuobjdump`` reads them from the built library.  With ``--moe`` the
model is ``MOE_CONFIG`` (``chip_smoke.py``'s M3), and the groups split
out the MoE router, the gathers and scatters of its dispatch, and the
experts' batched products (``timing.expert_product_ms``) from the other
matrix products; kernels launched and peak memory per forward are
printed beside.  Needs a CUDA device; prints the card's name and power
limit first.
"""

from __future__ import annotations

import argparse
import time
from collections import defaultdict

WARMUP, REPS = 2, 3


def _group(name: str, moe: bool) -> str:
    from ray_tpu_torch.tools.timing import MOE_GROUPS
    low = name.lower()
    if "flash_fwd_" in low:
        return "flash_attention kernel"
    if any(s in low for s in ("gemm", "xmma", "cutlass", "cublas",
                              "matmul", "nvjet")):
        return "matrix products (cuBLAS)"
    if moe:
        for group, keys in MOE_GROUPS:
            if any(k in low for k in keys):
                return group
    return "other (elementwise, norms, casts, gather, reductions)"


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models import bench
    from ray_tpu_torch.models.moe import capacity
    from ray_tpu_torch.tools.timing import (card, expert_product_ms,
                                            print_resource_usage)

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--moe", action="store_true",
                        help="profile MOE_CONFIG instead of CONFIG")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: needs a CUDA device")
    print(card(), flush=True)
    cfg = bench.MOE_CONFIG if args.moe else bench.CONFIG
    model, tokens = bench.make("cuda", cfg=cfg)
    inputs = tokens[:, :-1]
    with torch.inference_mode():
        for _ in range(WARMUP):
            model(inputs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            model(inputs)
        torch.cuda.synchronize()
        plain_wall_ms = (time.perf_counter() - t0) / REPS * 1e3
        torch.cuda.reset_peak_memory_stats()
        model(inputs)
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=args.moe) as prof:
            t0 = time.perf_counter()
            for _ in range(REPS):
                model(inputs)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / REPS * 1e3

    kernels = defaultdict(float)
    launches = 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.name] += evt.time_range.elapsed_us() / 1e3 / REPS
            launches += 1
    launches /= REPS
    device_ms = sum(kernels.values())
    if device_ms == 0:
        raise SystemExit("profile_forward: the profiler saw no device time")
    groups = defaultdict(float)
    for name, ms in kernels.items():
        groups[_group(name, args.moe)] += ms
    if args.moe:
        experts = expert_product_ms(prof, capacity(
            bench.BATCH * bench.SEQ, cfg.moe_experts,
            cfg.moe_capacity_factor), REPS)
        groups["matrix products (cuBLAS)"] -= experts
        groups["experts' batched products (cuBLAS)"] = experts
    print(f"per forward ({cfg.n_layers} layers, {cfg.moe_experts} experts, "
          f"batch {bench.BATCH} x {bench.SEQ}, "
          f"{str(cfg.dtype).split('.')[-1]}): "
          f"device {device_ms:.3f} ms; wall {plain_wall_ms:.3f} ms, idle "
          f"share {max(0.0, 1 - device_ms / plain_wall_ms):.3f} (under the "
          f"profiler: wall {wall_ms:.3f} ms, idle share "
          f"{max(0.0, 1 - device_ms / wall_ms):.3f}); {launches:.0f} kernels; "
          f"peak memory {peak_gb:.2f} GB")
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.3f} ms  {100 * ms / device_ms:5.1f}%  {name}")
    print("top kernels:")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {ms:9.3f} ms  {100 * ms / device_ms:5.1f}%  {name[:110]}")
    print_resource_usage("flash_attention.cu", r"flash_fwd_\w+?_kernel")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
