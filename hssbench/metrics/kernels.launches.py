"""kernels.launches: launches of the port's CUDA kernels a call, from
`repro_torch.kernels.cuda.launches` over the window."""


def read(r):
    n = sum(r.counters["launches"].values())
    if r.calls == 0 or n == 0:
        return None
    return n / r.calls
