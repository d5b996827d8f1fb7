# The port's copy of ray_tpu/util/joblib.py
"""joblib backend (parity: ``python/ray/util/joblib``).

``register_ray()`` then ``joblib.parallel_backend("ray_tpu_torch")`` routes
scikit-learn-style ``Parallel(...)`` work through cluster tasks.
"""

from __future__ import annotations


def register_ray() -> None:
    from joblib import register_parallel_backend
    from joblib._parallel_backends import MultiprocessingBackend

    import ray_tpu_torch

    @ray_tpu_torch.remote
    def _run_batch(batch):
        return batch()  # joblib BatchedCalls is itself callable

    class RayTpuBackend(MultiprocessingBackend):
        """Submit joblib batches as cluster tasks."""

        supports_timeout = True

        def effective_n_jobs(self, n_jobs):
            if n_jobs == 1:
                return 1
            # advertise cluster CPU capacity
            try:
                from ray_tpu_torch._private.worker import global_worker
                total = sum(
                    (n.get("resources_total") or {}).get("CPU", 0)
                    for n in global_worker().cp.list_nodes()
                    if n.get("state") == "ALIVE")
                return max(1, int(total))
            except Exception:  # noqa: BLE001
                return super().effective_n_jobs(n_jobs)

        def configure(self, n_jobs=1, parallel=None, prefer=None,
                      require=None, **kwargs):
            self.parallel = parallel
            return self.effective_n_jobs(n_jobs)

        def submit(self, func, callback=None):
            import threading
            ref = _run_batch.remote(func)

            class _Future:
                def get(self, timeout=None):
                    return ray_tpu_torch.get(ref, timeout=timeout)

            if callback is not None:
                # joblib's completion accounting runs off the callback
                # (supports_retrieve_callback): fire it from a waiter
                # thread, passing the result — or the exception, which
                # retrieve_result_callback re-raises
                def waiter():
                    try:
                        out = ray_tpu_torch.get(ref)
                    except BaseException as e:  # noqa: BLE001
                        out = e
                    callback(out)

                threading.Thread(target=waiter, daemon=True).start()
            return _Future()

        # pre-1.2 joblib name for submit()
        apply_async = submit

        @staticmethod
        def retrieve_result_callback(out):
            if isinstance(out, BaseException):
                raise out
            return out

        def terminate(self):
            pass

        def abort_everything(self, ensure_ready=True):
            if ensure_ready:
                self.configure(n_jobs=self.parallel.n_jobs,
                               parallel=self.parallel)

    register_parallel_backend("ray_tpu_torch", RayTpuBackend)
