"""Hand-written CUDA kernels for the sort hot spots, with plain versions.

bitonic_sort  K1 block sort and K2 bitonic merge, both register-and-
              shuffle; the local sort of every row (shards, sample
              buffers, gathered probes).
merge         K3 strided compare-exchange: the HBM pass of the merge
              cascade, for pairs longer than K2 holds on chip; K5 merge
              path: the post-exchange merge of sorted runs' valid
              prefixes, one launch a level.
histogram     the per-round histogram: K4s probe-rank search over sorted
              rows (the main paths), K4 probe-rank count in any order.
sample        K6: each HSS splitter round's sample, compacted from the
              sorted rows (the reference sorts each masked row).

Every kernel takes rows, so the reference's batched Pallas kernels (#2, #4,
#6) are the same kernels over the batched engine's B*p rows.
dispatch      the policy layer every core pipeline routes through:
              `kernel_policy` = "auto" | "kernel" | "torch".
cuda          builds csrc/sort_kernels.cu with nvcc at first use, loads it
              with ctypes, and counts each kernel's launches.

Key contract (as in repro.kernels): keys are int32 and never equal the hi
sentinel, except as padding; K4s, K5 and K6 take int64 keys too (the
core's 64-bit keys), INT64_MAX their hi sentinel. Every kernel wrapper
runs its plain PyTorch version on a CPU tensor and the kernel on a CUDA
tensor; within the contract the two, and the torch policy's `torch.sort`
and `torch.searchsorted`, give the same bits.
"""
