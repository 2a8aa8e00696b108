"""CUDA runtime calls a BC step that make the host wait for the card
(cudaStreamSynchronize, cudaDeviceSynchronize, cudaEventSynchronize,
cudaMemcpy), counted in the traced window's host events, less the window's
own, over its steps begun."""


def read(run):
    t = run["trace"]
    return t["host_syncs"] / t["steps"] if t and t["steps"] else None
