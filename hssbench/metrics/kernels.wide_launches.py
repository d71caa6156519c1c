"""kernels.wide_launches: launches of the int64 instantiations of the
port's CUDA kernels a call (the counters of
`repro_torch.kernels.cuda.launches` whose names end in `.i64`: K4s's
searches and K5's merges of 64-bit keys), over the window. None where the
window counted none, as a port without them counts."""

WIDE_SUFFIX = ".i64"


def read(r):
    n = sum(v for k, v in r.counters["launches"].items()
            if k.endswith(WIDE_SUFFIX))
    if r.calls == 0 or n == 0:
        return None
    return n / r.calls
