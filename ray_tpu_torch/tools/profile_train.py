"""Where the transformer's train step spends its time on the card.

    python -m ray_tpu_torch.tools.profile_train [--moe]

Builds ``bench_model.py``'s single-chip train state and batch as
``ray_tpu_torch.models.bench`` defines them for ``chip_smoke.py``'s T2
(the same weights, tokens and ``remat=True``), runs ``REPS`` steps of
``make_train_step`` after ``WARMUP``, first without and then under
``torch.profiler``, and prints, per step: the device time summed over
kernels (from the profiled run), the wall time without the profiler and
the device's idle share against it, the device kernels launched (a step
whose wall is far above its device time is held back by the host's
launches: the wall per launch says what each costs), the achieved
TFLOP/s by the bench's accounting (``bench.train_flops``), the peak
device memory
(``torch.cuda.max_memory_allocated`` over one step), and the device time
by group: the flash forward kernel (run twice a layer under remat), the
flash backward kernels, cuBLAS matrix products, the optimizer
(``AdamW``'s ``torch._foreach_*`` launches, ``multi_tensor_apply``
kernels) and the elementwise rest; then the top kernels and the
registers and spills of each instance of the backward kernels, as
``cuobjdump`` reads them.  With ``--moe`` the model is ``MOE_CONFIG``
(``chip_smoke.py``'s T3, TFLOP/s by ``bench.moe_train_flops``), and the
groups split out the MoE router, the gathers and scatters of its
dispatch, and the experts' batched products forward and backward
(``timing.expert_product_ms``) from the other matrix products.  Needs a
CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import time
from collections import defaultdict

WARMUP, REPS = 1, 3

_GROUPS = (
    ("flash forward kernel", ("flash_fwd_",)),
    ("flash backward kernels", ("bwd_wgmma_kernel", "dkdv_", "dq_kernel",
                                "delta_kernel")),
    ("matrix products (cuBLAS)", ("gemm", "xmma", "cutlass", "cublas",
                                  "matmul", "nvjet")),
    ("optimizer (AdamW, foreach)", ("multi_tensor_apply",)),
)


def _group(name: str, moe: bool) -> str:
    from ray_tpu_torch.tools.timing import MOE_GROUPS
    low = name.lower()
    for group, keys in _GROUPS + (MOE_GROUPS if moe else ()):
        if any(k in low for k in keys):
            return group
    return "elementwise and the rest (norms, RoPE, casts, loss, reductions)"


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
        raise SystemExit("profile_train: needs a CUDA device")
    print(card(), flush=True)
    cfg = bench.MOE_CONFIG if args.moe else bench.CONFIG
    state, step, batch = bench.make_train("cuda", cfg=cfg)
    n_params = bench.n_params(state["params"])
    step_flops = (bench.moe_train_flops(cfg) if args.moe
                  else bench.train_flops(n_params))
    for _ in range(WARMUP):
        step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        step(state, batch)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) / REPS * 1e3
    torch.cuda.reset_peak_memory_stats()
    step(state, batch)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA],
                 record_shapes=args.moe) as prof:
        t0 = time.perf_counter()
        for _ in range(REPS):
            step(state, batch)
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
        raise SystemExit("profile_train: the profiler saw no device time")
    groups = defaultdict(float)
    for name, ms in kernels.items():
        groups[_group(name, args.moe)] += ms
    if args.moe:
        experts = expert_product_ms(prof, capacity(
            bench.BATCH * bench.SEQ, cfg.moe_experts,
            cfg.moe_capacity_factor), REPS)
        groups["matrix products (cuBLAS)"] -= experts
        groups["experts' batched products (cuBLAS)"] = experts
    tflops = step_flops / (plain_wall_ms / 1e3) / 1e12
    print(f"per step ({cfg.n_layers} layers, {cfg.moe_experts} experts, "
          f"batch {bench.BATCH} x "
          f"{bench.SEQ}, {str(cfg.dtype).split('.')[-1]}, remat={cfg.remat}, "
          f"{n_params / 1e6:.1f}M params): device {device_ms:.3f} ms; wall "
          f"{plain_wall_ms:.3f} ms, idle share "
          f"{max(0.0, 1 - device_ms / plain_wall_ms):.3f}, {launches:.0f} "
          f"kernels ({1e3 * plain_wall_ms / launches:.1f} us of wall each), "
          f"{tflops:.1f} TFLOP/s by bench."
          f"{'moe_train_flops' if args.moe else 'train_flops'} (under the "
          f"profiler: "
          f"wall {wall_ms:.3f} ms, idle share "
          f"{max(0.0, 1 - device_ms / wall_ms):.3f}); peak memory "
          f"{peak_gb:.2f} GB")
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.3f} ms  {100 * ms / device_ms:5.1f}%  {name}")
    print("top kernels:")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:20]:
        print(f"  {ms:9.3f} ms  {100 * ms / device_ms:5.1f}%  {name[:110]}")
    print_resource_usage("flash_attention_bwd.cu",
                         r"bwd_wgmma_kernel|dkdv_kernel|dq_kernel|delta_kernel")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
