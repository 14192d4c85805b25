"""Iteration layer: calls in which the host waits for the device
(cudaStreamSynchronize, cudaDeviceSynchronize, cudaEventSynchronize and
the blocking cudaMemcpy) per traced iteration, the chunk's read-back
included."""


def read(ctx):
    t = ctx["trace"]
    if not t.launches:  # the host's runtime calls were not traced
        return None
    return {"value": t.syncs / t.iters, "unit": "syncs/it"}
