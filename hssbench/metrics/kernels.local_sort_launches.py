"""kernels.local_sort_launches: launches of the port's bitonic local-sort
kernels a call (K1 `bitonic_sort_blocks`, K2 `bitonic_merge_smem` in
both roles, K3 `strided_compare_exchange`), from
`repro_torch.kernels.cuda.launches` over the window: above 0 where
"auto" sends the shard rows (and the splitter rounds' probe rows) to
them. None where the window counted none."""

LOCAL_SORT_KERNELS = ("bitonic_sort_blocks", "bitonic_merge_smem",
                      "strided_compare_exchange")


def read(r):
    n = sum(v for k, v in r.counters["launches"].items()
            if k.split(".")[0] in LOCAL_SORT_KERNELS)
    if r.calls == 0 or n == 0:
        return None
    return n / r.calls
