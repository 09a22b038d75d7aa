"""joblib backend: scikit-learn-style ``Parallel`` on the port's tasks.

A copy of ``ray_tpu.util.joblib`` for the PyTorch port: the backend is
named ``"ray_tpu_torch"`` (with the reference's alias ``"ray"``); joblib
is imported only inside ``register_ray``.

Parity: reference ``python/ray/util/joblib/`` — ``register_ray()``
installs a joblib parallel backend so ``with
joblib.parallel_backend("ray_tpu_torch"): Parallel()(...)`` fans batches out
as tasks:

    from ray_tpu_torch.util.joblib import register_ray
    register_ray()
    with joblib.parallel_backend("ray_tpu_torch"):
        results = joblib.Parallel()(joblib.delayed(f)(i) for i in data)
"""

from __future__ import annotations


def register_ray():
    """Register the 'ray_tpu_torch' joblib parallel backend."""
    from joblib.parallel import ParallelBackendBase, register_parallel_backend

    import ray_tpu_torch

    @ray_tpu_torch.remote
    def _run_batch(batch):
        return batch()

    class _Future:
        def __init__(self, ref, callback):
            self._ref = ref
            self._callback = callback

        def get(self, timeout=None):
            value = ray_tpu_torch.get(self._ref, timeout=timeout)
            if self._callback is not None:
                self._callback(value)
                self._callback = None
            return value

        def result(self, timeout=None):
            return self.get(timeout)

    class RayTpuBackend(ParallelBackendBase):
        supports_timeout = True
        uses_threads = False
        supports_sharedmem = False

        def effective_n_jobs(self, n_jobs):
            if n_jobs == 0:
                raise ValueError("n_jobs == 0 has no meaning")
            if n_jobs is None or n_jobs < 0:
                import os
                return os.cpu_count() or 1
            return n_jobs

        def apply_async(self, func, callback=None):
            ref = _run_batch.remote(func)
            future = _Future(ref, callback)
            if callback is not None:
                def fire(value, err):
                    if err is None and future._callback is not None:
                        cb, future._callback = future._callback, None
                        cb(value)

                from ray_tpu_torch._private.worker import global_worker
                global_worker().core_worker.get_async(ref, fire)
            return future

        def configure(self, n_jobs=1, parallel=None, **_kwargs):
            self.parallel = parallel
            return self.effective_n_jobs(n_jobs)

    register_parallel_backend("ray_tpu_torch", RayTpuBackend)
    register_parallel_backend("ray", RayTpuBackend)   # alias
