#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and check every kernel.

    python3 chip_smoke.py        # from the repository root, one CUDA device

Phases, in order; any failure raises and the script exits non-zero:

  1. the card: `nvidia-smi --query-gpu=name,power.limit` of device 0;
  2. build: compiles src/repro_torch/kernels/csrc/sort_kernels.cu with nvcc
     (the kernels are built from the checkout's sources, nothing else) and
     prints ptxas's registers, stack and spills for each instantiation of
     K1 (one per block size) and of K2 (one per segment size), and its
     registers, shared memory and spills for K4s's, K5's, K6's and K7's
     int32 and int64 instantiations, failing on a missing size or
     instantiation, a spill or more than 64 registers;
  3. kernels: K1 at every power-of-two block 2..1,024 on 5 rows (random,
     all INT_MAX, duplicates, INT_MIN among INT_MAX and small keys,
     random) and on a row read at a one-key offset, and K2 at every
     power-of-two segment 2..16,384, both roles, on 5 such rows (the last
     unsorted), each against its plain version; then
     each hand-written kernel (K1-K3, K4s, K4, K5) against its
     plain PyTorch version on the card, exactly (torch.equal), at the
     shapes each main path gives it — the sort's (8, 2^21) shard rows and
     the batched sort's 64 = B*p rows of 2^18 (K4s and K4: sorted keys
     (8, 2,000,000) x 256 probes and (64, 250,000) x a distinct probe row
     each, and 70,000 rows past gridDim.y's 65,535, K4s also against K4;
     K5: the benchmark's post-exchange merge, 8 rows of 8 runs of
     12,582,912 slots holding about 2^22 keys each, its three levels
     also against torch.sort of the rows; K5's and K4s's int64
     instantiations at the tagged cell's shapes, the same merge on 35-bit
     packs and one splitter round's search of 8 sorted rows of 2^25
     packs x 256 probes, also against torch.sort and searchsorted) — then
     timed by CUDA events beside its plain version, its bound, the floor
     of an empty launch and, where one PyTorch call computes the same
     function, that call (`library_ms`, a yardstick only); one row per
     Pallas site, path and kernel (#7 and #8 run on both paths, so they
     have a row for each; #5 and #6 have a row for K4s, the main paths'
     search over sorted rows, and one for the counting K4, which only
     `assume_sorted=False` reaches and no main path launches; K5, which
     replaces no Pallas site, is row 9); K6, which replaces the masked
     rows' sort of each splitter round, is row 10 (int32 and int64): the
     K6 calls of `sort` on the benchmark cells' 2^28 UNIF keys and tagged
     SKEW2 keys recorded as they ran, round 1 (nothing satisfied) and
     round 2, each against its plain version and the torch route (the
     reference's masked sort, `library_ms`), and the splitter keys, ranks
     and SplitterStats of those sorts equal to the "torch" policy's; K7,
     which writes the dense exchange's send buffer (the reference cuts
     and pads the slices in XLA), is row 11 (int32 and int64): the
     benchmark cells' send, 8 sorted rows of 2^25 keys cut at row 0's
     octiles into slices of at most 12,582,912 keys, against its plain
     version, which is the torch route (the int64 index gather, timed
     again through the route as `library_ms`), one launch a call;
  4. slice 1: `repro_torch.sort.sort` with 8 shards, eps 0.05 and the
     default "auto" policy on WEAK_SCALING (16,000,000 UNIF int32 keys,
     repro/configs/paper_sort.py:18 at p = 8), 16,000,000 standard-normal
     float32 keys, and 16,000,003 uint32 keys (ragged n). Each must equal
     np.sort of its input with overflow 0 and max(counts) <= (1+eps)N/p + 1,
     must have launched every kernel of the path and not the counting
     K4 (launch counts set to 0 just before the call and read just
     after), and must give the same shards and counts as the same call
     under kernel_policy="torch";
  5. slice 2: `repro_torch.sort.sort_batched` on the serving engine's batch
     (B = 8 requests, serve/service.py:118, of 2,000,000 UNIF int32 keys,
     seeds 0-7, p = 8, eps 0.05, "auto"), once per exchange (dense,
     allgather): per request gather(b) == np.sort, overflow 0 and
     max(counts[b]) <= (1+eps)n/p + 1; every kernel of the path launched
     and the counting K4 not; the torch policy gives identical shards
     and counts; with tag=False, row b equals sort() of row b alone.
     Then, dense only: (8, 2,000,000) standard-normal float32, (8,
     2,000,003) uint32, and a list of five 2,000,000-key and three
     2,000,003-key requests (two length buckets, results in input order);
  6. times: the warm end-to-end sort of the 16M int32 keys (median of 5,
     host clock around torch.cuda.synchronize()) under both policies, and
     a torch.profiler breakdown of one warm sort (the 15 largest names and
     every kernel of the port); the warm batched sort (dense, median of 5)
     beside the same 8 requests as 8 sequential warm sort() calls, under
     both policies, and a profile of one warm batched sort;
  7. recovery: `sort` of 16,000,000 PRESORTED and 16,000,000 REVERSE
     int32 keys (repro_torch.data.distributions) under on_overflow
     "raise" (the overflow is recorded; the result stays inexact),
     "retry" (equal to np.sort; the RecoveryStats fields are printed) and
     "spill" (equal to np.sort, overflow 0), each retry and spill run
     launching every kernel of the path and not the counting K4, and
     giving the same shards and counts as kernel_policy="torch"; then
     `sort_batched` of 8 PRESORTED/REVERSE rows of 2,000,000 keys under
     retry and spill, each row equal to np.sort of the row. The spill
     merge's largest buffer is reckoned before the run, and the peak of
     allocated device memory is read for each retry and spill run under
     each policy;
  8. permutations: (a) MoE dispatch at Phi-3.5-MoE's routing (16 experts,
     top-2; src/repro/configs/phi35_moe.py): `sort_kv` of 16,000,000
     expert ids in [0, 16) with the token of each slot as the value (4 key
     bits + 24 tag bits: int32 packing, the kernels), held to the stable
     NumPy order, launch-gated as the main paths; (b) `argsort` of
     WEAK_SCALING's UNIF keys (30 + 24 bits: int64 packing) and (c) `sort`
     of 16,000,000 standard-normal float64 keys, both on the 64-bit route
     (torch.sort local sorts, the int64 K4s, K5 and K6): equal to NumPy,
     no kernel launched but the int64 K4s, K5 and K6, every output tensor
     on the card; (d) `argsort` of the PRESORTED keys raising RuntimeError from
     gather_perm_checked under "raise" and equal to np.arange under
     "retry"; (e) the benchmark's tagged cell (hssbench's
     `hss_p8_2p28_skew2_tag`): `sort` of 2^28 SKEW2 keys made on the card
     with tag=True (7 + 28 bits: an int64 pack), equal to torch.sort of
     the input, every shard within (1 + eps) N / p, only the int64 K4s
     and K5 launched (K5 three times), its warm median of 3 and its
     peak memory, and the same packs cut to int32, whose sort reads keys
     back wrong;
  9. times: the warm medians (host clock around torch.cuda.synchronize())
     of retry and spill on the PRESORTED keys and of the MoE sort_kv, and
     a torch.profiler breakdown of one warm call of each.
  10. the paper's baselines and the ragged exchange: (a) `sort` of the
     WEAK_SCALING keys under algorithm "sample_random", "sample_regular",
     "ams" and "multistage": under "raise" the overflow, max count,
     n_satisfied and the collective log are printed, the path's kernels
     gated and the torch policy must agree; under "retry" the gather
     must equal np.sort; ams (where its scan succeeded) and multistage
     must meet the balance bound, the sample sorts' balance is printed;
     (b) HSS with exchange="ragged" on the same keys: equal to np.sort,
     overflow 0, within the bound, the same shards and counts as the
     allgather exchange and the torch policy; (c) ragged on 16,000,000
     PRESORTED keys under "raise": equal to np.sort, overflow 0; the
     ragged merge's branch is read from its counter
     (`merge.ops.ragged_branches`): the merge tree on (b), the full sort
     on (c); (d) `sort_batched` of the
     batched cell under each algorithm: under "retry" each gather(b)
     equals np.sort, and with tag=False under "raise" row b equals
     sort() of row b;
  11. times: the warm medians of `sort` on the WEAK_SCALING keys under
     each algorithm and HSS+ragged beside HSS+dense in the same call,
     and a torch.profiler breakdown and the peak device memory of one
     warm multistage call and one warm ragged call;
  13. the fused audit: `sort` of the WEAK_SCALING keys under verify
     "cheap" and "full" (audit ok, count word 16,000,000, imbalance <=
     1 + eps + 8/N, the same audit vector under kernel_policy="torch",
     the same shards, counts and kernel launches as verify="off": the
     audit launches no kernel), 16M float32 normal keys under "cheap" and
     the batched cell under "cheap" (every row_ok); verify_fallback false
     on each;
  14. corruption (chaos.FaultPlan): corrupt_at=(0,) under
     on_verify_failure="retry" (exact, one failure, one retry),
     corrupt_at=(0, 1) (exact through the fallback: verify_fallback, the
     torch policy), corrupt_at=True (VerificationError must be raised),
     and the batched cell with corrupt_key in one row only
     (BatchVerificationError, row_ok false at that row alone, the other
     rows equal to np.sort); chaos.stats() printed;
  15. the clamp: FaultPlan(clamp_pair_cap=200,000) under "retry" on the
     WEAK_SCALING keys: the first attempt overflows, the escalations end
     exact; RecoveryStats printed;
  16. the imbalance SLO: ALL_EQUAL, ZIPF_HH, PRESORTED, REVERSE and
     SAWTOOTH at 16M under verify="cheap", imbalance_slo=1.2 and "retry":
     exact, imbalance <= 1.2, the rung printed; ALL_EQUAL with tag=False
     and out_slack 8 must raise ImbalanceError; the refine rung stamped on
     the WEAK_SCALING keys with a starved sampler (1 round, 8 samples a
     shard, tag=False, SLO 1.1);
  17. grouping: `semisort` of 16M ZIPF_HH keys (groups equal to
     np.unique, each key on one shard), `groupby_aggregate` at
     Phi-3.5-MoE's routing (16M expert ids: count, and sum and max of
     float32 values, against NumPy), `top_k` (k = 1,024) of the
     WEAK_SCALING keys and of 16M float32 normal keys (equal to np.sort;
     one all_gather, no all_to_all), `semisort_batched` and
     `top_k_batched` of the batched cell (each row equal to the single
     call), and `counting_dispatch` of the 16M expert ids (capacity 1.25 *
     N/16) equal to method="argsort";
  18. times: warm medians, taken in turns, of `sort` under verify off,
     cheap and full, `semisort` against `sort` on ZIPF_HH, `top_k`
     against `sort` (with the caching allocator's retries over each), and
     a profile and the peak memory of a warm verify="full" sort and a
     warm semisort;
  19. the sort service (repro_torch.serve) at the batched cell's width:
     `ServiceRunner(SortSpec(shards=8), ServiceConfig(max_batch=8))`,
     every (kind, padded B) cache key warmed first; each kind in its
     own window of 16 concurrent requests of 2,000,000 keys, flushed on
     size only (two full batches; sort of
     UNIF rows, sort_kv of Phi-3.5-MoE's expert ids with the slot index
     as the value, semisort of ZIPF_HH rows, top_k with k = 1,024,
     argsort of UNIF keys on the 64-bit route), each result checked
     against NumPy and each window's kernels gated; over the steady
     windows no degraded request, no verify fallback, a cache hit rate
     above 0.9 and health "ok"; then a mixed window of 64 requests (the
     five kinds interleaved, the default 5 ms flush deadline: throughput,
     latencies, each batch's compute time, peak memory); 16 concurrent /v1/sort requests of 262,144 keys
     over the HTTP front end on 127.0.0.1 and the overload burst (a 429
     and a 200);
  20. the drills of repro_torch.serve.smoke in the process
     (`ServiceRunner.submit`) at 2,000,000 keys a request: chaos (a clamp
     of 20,000 keys a pair under retry, one crash, one executor death,
     one poison request) and corrupt (verify="cheap", a 10 s breaker
     cooldown, the breaker tripped and closed again; each degraded-path
     request, sorted alone under its own spec, launches the HSS path's
     kernels);
  21. times, in turns: the direct `sort_batched` of one full batch, the
     same with its 8 gathers, and the service's batch; the service's
     steps apart (np.stack, the copy, the sort, the gathers); a profile
     of one served batch;
  22. `data.partition.bucket_lengths` of 1,048,576 synthetic document
     lengths over 8 shards (int64 packing: the int64 K4s, K5 and K6): every
     doc once,
     shards contiguous and non-decreasing, the packing's padding;
  23. the analysis lint on the card (`repro_torch.analysis.lint --device
     cuda`, to a temporary path): 0 failures, its checks, collective
     records, sync counts and budget footprints equal to the CPU's
     committed ANALYSIS_torch.json; each kernel's static shared memory
     equal to ptxas's report and its registers within the launch
     bounds' cap (`analysis.budgets`); K2's 64 KB segment within the
     opt-in its launcher set, read back with cudaFuncGetAttributes;
  24. the sync audit: `sort`, `sort_batched` (the batched cell),
     `argsort`, `sort_kv`, `semisort`, `top_k`, and `sort` under "retry"
     and verify="full" of the WEAK_SCALING keys under
     set_sync_debug_mode("error"), each door's documented syncs equal to
     its pinned formula (`analysis.purity`);
  25. the legacy entry points at full width: `hss_sort`, `sample_sort`
     (random, regular), `ams_sort` and `two_stage_sort` of the
     WEAK_SCALING keys equal to `sort` with the same algorithm and seed
     (shards and counts) and to np.sort; `probe_counts` of those keys,
     unsorted, against 256 sorted probes (the counting K4's path) equal
     to its plain version and to np.sort's histogram; `merge_flat_runs`
     of 8 runs of 2^21 keys (K5 alone); `pack_tagged`/`unpack_tagged` at
     31 and 63 bits;
  26. model serving (repro_torch.models, repro_torch.launch.serve): (a)
     Phi-3.5-MoE (src/repro/configs/phi35_moe.py) at full width with 8
     of its 32 layers (78 GiB of bf16 weights at 32 do not fit the card),
     bf16, seeded random weights on the card: `serve_batch` of 8 prompts
     of 2,048 tokens (the chunked flash attention and the big-T MoE
     dispatch in prefill, the small-T one in decode) and 16 generated
     tokens, warmed once: tokens in [0, vocab), logits finite, MoE drops,
     prefill and decode times, tokens/s and peak memory printed; (b) its
     cached decode (2 layers, float32, capacity factor 4.0) against the
     teacher-forced forward within 1e-3 (float32; the reference's bf16
     smoke tolerance, tests/test_arch_smoke.py:91-101, is 0.15);
     (c) mamba2-370m whole: `serve_batch` of 8 x 256 tokens in bf16 and
     the same check in float32; (d) `serve_bucketed` of 64 requests of
     lognormal(3.5, 0.6) lengths clipped to [8, 128] over 8 buckets on
     (a)'s configuration: each request served once, buckets contiguous
     and non-decreasing, pad fractions printed, the bucketing sort's
     kernels gated (`PATH_KERNELS["serve_bucketed"]`: K1, K5 and K4s;
     its 8-key shard rows reach neither K2 nor K3);
  27. model training (repro_torch.launch.train, models/steps, optim,
     ckpt, runtime/ft.TrainSupervisor): (a) Phi-3.5-MoE at full width
     with 2 of its 32 layers (AdamW's 12 bytes a parameter: 32.0 GiB at
     2), bf16, `train` of 4 steps of 8 x 2,048 tokens (the chunked flash
     attention and its backward, the big-T MoE dispatch, remat "block"):
     each step's loss, grad norm, lr and MoE drops, the warm step time,
     tokens/s, TFLOP/s and peak memory; every loss and grad norm finite,
     grad norms above 0, every parameter leaf changed but the norms
     initialised to ones (bf16 1.0 minus 3e-4 rounds back), no kernel launched
     (the path runs no sort: `check_path_launches("train", ..., ())`);
     (a') whether (a)'s rise in loss is the model's or bf16's: Phi at
     full width with 1 layer, the same 4 steps from the same seed in
     bf16 and float32 at lr 3e-4 and in bf16 at 3e-5, each run's losses
     (a reading, gated on finite losses);
     (b) the flash attention's backward (`layers.FlashAttention`)
     against plain autograd through `attention_full` at Phi's head shape
     (32 heads, 8 KV heads, head_dim 128), 2,048 tokens in chunks of
     1,024, float32, causal, within 5e-4 (the reference's tolerance,
     tests/test_attention.py:46); (c) mamba2-370m whole (48 layers), bf16,
     6 steps of 8 x 512 tokens twice without a checkpoint and once under
     TrainSupervisor (a checkpoint every 2 steps, keep 2, a failure raised
     after step 3): the two uninterrupted runs equal bit for bit (the
     step is deterministic on the card), one restart, the restored
     tensors equal to the saved snapshot and written into the state's
     own tensors (no device bytes allocated), the resumed losses equal to the
     uninterrupted run's bit for bit, each save's bytes and seconds; the
     checkpoint directory removed;
  28. the launch layer (repro_torch.launch.mesh, specs, dryrun,
     hillclimb; dp above one): (a) the dry run of all 40 cells on the
     (16, 16) and (2, 16, 16) meshes on `meta`, in worker processes that
     see no card: 32 OK and 8 SKIP(full-attention) a mesh (the multi-pod
     mesh runs its ten train_4k cells only if the single-pod one took
     over 90 s), no FAIL (a shard that does not divide fails its cell),
     and kimi-k2's train_4k cell run in this process holding no device
     byte; the records written to experiments/dryrun_torch.json; (b)
     phase 27's cell (Phi-3.5-MoE, 2 of 32 layers, bf16, AdamW, 8 x
     2,048) reckoned on a (1, 1) mesh: its argument bytes equal to what
     the card holds once the parameters, state and batch sit there,
     within 512 bytes a tensor, and its FLOPs equal to FlopCounterMode's
     count of the real step on the card; the reckoned peak printed beside
     max_memory_allocated and model_flops; (c) the same cell trained 4
     steps at dp 2 x tp 2 and at dp 1 (losses finite; drops, step time,
     peak), and decode against forward at dp 2 x tp 2 (2 layers, float32,
     1e-3, capacity factor 16); (d) hillclimb's kimi_base and
     granite_base; (e) the card's bf16 matmul rate at 8,192^3 and its
     copy rate beside the datasheet constants hillclimb uses; (f) the
     five examples/torch_*.py at their defaults, each a subprocess
     exiting 0. Paths (b)-(d) launch no kernel (`PATH_KERNELS`);
  last (phase 12, run after 13-28): every kernel (K1, K2 by role, K3,
     K4s, K5, K6, K7) against its plain version,
     exactly, at every shape and parameter the main paths of phases 4-5,
     7-10, 13-17, 19-22, 25 and 26 called it with (recorded as they ran,
     `kernel_shapes`):
     multistage's stage 2 searching 8 rows of 4,200,008 keys with
     sentinel tails, ams's 960 probes a row, ragged's full sort of (8,
     2^22) buffers and the like. Each row of the kernels line lists the
     (rows, n) checked in `shapes_checked`.

Each path's kernels are gated (`check_path_launches`): every kernel it
launches by the code, none other. The HSS paths launch K1-K3, K4s, K6,
K7 (every dense exchange's send) and K5 (every post-exchange merge); the
allgather and ragged exchanges send no dense buffer, so no K7; the
sample sorts and top_k rank nothing, so they launch no K4s; top_k
exchanges nothing, so no K7; the counting
dispatch launches no kernel (`PATH_KERNELS`); only `probe_counts`
(phase 25) launches the counting K4, whose operations per pair are read
from the built library's SASS (`k4_sass_line`). A kernel row faster than
its bound fails the run.

Every measurement line is one JSON object carrying the card's name and
power limit. The line before the last is the card line; the kernels line
comes before it; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = "src/repro_torch/kernels/csrc/sort_kernels.cu"

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3; 132 SMs at a 1,980 MHz
# boost clock, each with 64 INT32 lanes and 128 FP32 lanes. An int32
# operation issues at 132 * 64 * 1.98e9 = 16.7 TOPS; an instruction of the
# FMA pipe (IMAD and the float ones) at 132 * 128 * 1.98e9 = 33.5 T/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
FMA_OPS_PER_S = 132 * 128 * 1.98e9

P, EPS = 8, 0.05
N_WEAK = 16_000_000          # WEAK_SCALING: 2,000,000 keys per shard
N_LOCAL = N_WEAK // P
ROW = 1 << 21                # the local sort's power-of-two row
PROBES = 256                 # p x sample cap (32) per round
B = 8                        # serving's flush size (ServiceConfig.max_batch)
N_REQ = 2_000_000            # keys per request of the batched cell
B_ROWS = B * P               # the batched path's kernel rows
B_LOCAL = N_REQ // P         # 250,000 keys per (request, shard) row
B_ROW = 1 << 18              # its power-of-two local-sort row
PALLAS = "src/repro/kernels"
# The short kernels (K4s, its library call, the empty launch) are timed
# over this many calls, so that the launch queue's start-up is not in the
# number; the others over 20.
SHORT_REPS = 200
# A sleep kernel queued before the timed calls holds the device while the
# host enqueues them (about 20 ms at the H100's clock), so a kernel shorter
# than its host-side call is timed back to back on the device.
HEAD_START_CYCLES = 40_000_000
#: The paper's baselines and multistage (phase 10).
BASELINES = ("sample_random", "sample_regular", "ams", "multistage")
#: The kernels each path of phase 10 launches, from the code: every local
#: sort (the shards', the sample buffers', the gathered probes') runs K1,
#: K2 in both roles and K3 at these sizes; every post-exchange merge runs
#: K5 (MERGING); every dense exchange (dense, and dense_spill's dense
#: channel) writes its send buffer with K7 (SENDING); ams, multistage
#: and HSS rank a sample with K4s; the sample sorts rank nothing. Only
#: probe_counts counts (K4).
SORTING = ("bitonic_sort_blocks", "bitonic_merge_smem.reverse",
           "bitonic_merge_smem.tail", "strided_compare_exchange")
MERGING = SORTING + ("merge_path_pairs",)
SENDING = MERGING + ("dense_send",)
RANKING = SENDING + ("probe_rank_search",)
#: HSS's splitter rounds also draw each round's sample with K6, where the
#: reference sorts each masked row; ams ranks a sample of its own.
HSS = RANKING + ("sample_compact",)
#: HSS over an exact exchange (allgather, ragged): no dense send buffer.
HSS_EXACT = tuple(k for k in HSS if k != "dense_send")
#: The 64-bit route's (int64 tag packing, float64 keys): torch.sort local
#: sorts, the int64 K4s, K5, K6 and K7 (`repro_torch.kernels.cuda.WIDE`).
WIDE = ("probe_rank_search.i64", "merge_path_pairs.i64",
        "sample_compact.i64", "dense_send.i64")
PATH_KERNELS = {"sample_random": SENDING, "sample_regular": SENDING,
                "ams": RANKING, "multistage": HSS, "ragged": HSS_EXACT,
                # PRESORTED shards outgrow the ragged slot: a full local
                # sort of each buffer, no merge
                "ragged_presorted": SORTING + ("probe_rank_search",
                                               "sample_compact"),
                # phase 17: semisort sorts the shards and the masked lights
                # and ranks with HSS; the value aggregates ride sort_kv;
                # top_k sorts and merges, ranking nothing; the counting
                # dispatch is torch ops with no kernel (as the reference's
                # is jnp with no Pallas)
                "semisort": HSS, "groupby_aggregate[count]": HSS,
                "groupby_aggregate[sum]": HSS,
                "groupby_aggregate[max]": HSS, "top_k": MERGING,
                "counting_dispatch": (),
                # phase 25: the legacy entry points sort as their
                # algorithm's front door does; probe_counts counts keys in
                # any order (K4, its one path); merge_flat_runs of 2^21-key
                # runs merges by K5 alone
                "legacy:hss": HSS, "legacy:sample_random": SENDING,
                "legacy:sample_regular": SENDING, "legacy:ams": RANKING,
                "legacy:multistage": HSS,
                "probe_counts": ("probe_rank_count",),
                "merge_flat_runs": ("merge_path_pairs",)}
# The CUDA functions of csrc/sort_kernels.cu, as the profiler names them.
PORT_KERNELS = ("bitonic_sort_warp_kernel", "bitonic_merge_smem_kernel",
                "bitonic_merge_warp_kernel", "strided_ce_kernel",
                "strided_ce_vec4_kernel", "probe_rank_count_kernel",
                "probe_rank_search_kernel", "merge_path_pairs_kernel",
                "sample_count_kernel", "sample_emit_kernel",
                "dense_send_kernel")


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def emit(obj: dict):
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True).stdout.strip()
    if not out:
        fail("nvidia-smi reported no card")
    return out.splitlines()[0]


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call by CUDA events over `reps` calls, the
    device given a head start (HEAD_START_CYCLES) before the first."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HEAD_START_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call on the host clock, each call waited for:
    what a caller that needs the result at once pays."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def empty_launch_line(torch, card) -> float:
    """The floor of a launch: a kernel that does nothing, started through
    the same ctypes route as the port's kernels; returns its ms."""
    from repro_torch.kernels import cuda

    lib = cuda.library()

    def launch():
        err = lib.empty_launch(torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"empty_launch failed: error {err}")

    ms = time_ms(torch, launch, reps=SHORT_REPS)
    emit({"measure": "empty_launch", "ms": ms,
          "host_ms": host_ms(torch, launch, reps=SHORT_REPS), "card": card})
    return ms


def search_bound(rows: int, n: int, m: int, key_bytes: int = 4):
    """K4s's bound: each probe read once, each int32 rank written once,
    and the ceil(log2(n + 1)) keys a comparison search reads per probe."""
    depth = n.bit_length()
    return rows * m * (key_bytes * (1 + depth) + 4), rows * m * depth


def bound(bytes_moved: float, int_ops: float, fma_ops: float = 0.0):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and the
    operations' time: int32 operations over the int32 rate, or the FMA
    pipe's instructions over its rate where the compiler put work there."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = max(int_ops / INT32_OPS_PER_S, fma_ops / FMA_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


SASS_INSTR = re.compile(r"^\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)(.*?);")
SASS_MEMORY = ("LD", "ST", "ATOM", "RED")
SASS_CONTROL = ("BRA", "EXIT", "BAR", "NOP", "YIELD", "BSSY", "BSYNC",
                "WARPSYNC", "CALL", "RET", "DEPBAR")
#: Opcodes of the FMA pipe (128 lanes an SM): the IMAD family, sm_90's
#: VIADD and the float ones. The counting K4's loop (per 32 pairs: 32
#: ISETP, 16 IADD3, 20 VIADD, 30 IMAD) could not run at its measured
#: 0.4528 ms if its VIADDs shared the 64-lane int32 pipe (0.528 ms).
SASS_FMA = ("IMAD", "VIADD", "FFMA", "FMUL", "FADD", "HFMA2", "HADD2",
            "HMUL2")
#: keys a shared-memory load reads, by width
SASS_LDS_KEYS = {"LDS.128": 4, "LDS.64": 2, "LDS": 1}


def sass_loops(text: str, function: str):
    """The loops (a branch back to an earlier instruction) of the SASS
    function whose name holds `function`, each a list of opcodes."""
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        if function not in chunk.split("\n", 1)[0]:
            continue
        instrs, labels = [], {}
        for line in chunk.splitlines():
            label = re.match(r"^\s*(\.L_x_\d+):", line)
            if label:
                labels[label.group(1)] = len(instrs)
                continue
            m = SASS_INSTR.match(line)
            if m:
                instrs.append((int(m.group(1), 16), m.group(2), m.group(3)))
        loops = []
        for i, (_, op, rest) in enumerate(instrs):
            if not op.startswith("BRA"):
                continue
            target = re.search(r"(\.L_x_\d+)", rest)
            if target and target.group(1) in labels:
                j = labels[target.group(1)]
            else:
                addr = re.search(r"0x([0-9a-f]+)", rest)
                j = None if addr is None else next(
                    (k for k, ins in enumerate(instrs)
                     if ins[0] == int(addr.group(1), 16)), None)
            if j is not None and j <= i:
                loops.append([op for _, op, _ in instrs[j:i + 1]])
        return loops
    return []


def k4_sass_line(card):
    """The counting K4's operations per (key, probe) pair, read from the
    SASS of the built library (cuobjdump -sass): its inner loop's
    instructions by pipe over the keys its shared-memory loads read.
    Returns (int32 ops, FMA-pipe ops) per pair."""
    from collections import Counter

    from repro_torch.kernels import cuda

    tool = Path(cuda._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(cuda.build())],
                          capture_output=True, text=True, check=True).stdout
    loops = sass_loops(text, "probe_rank_count_kernel")
    keyed = [(sum(SASS_LDS_KEYS.get(op, 0) for op in loop), loop)
             for loop in loops]
    keys, loop = max(keyed, key=lambda kl: kl[0], default=(0, []))
    if keys == 0:
        fail("k4_sass_line: no loop with shared-memory loads in "
             "probe_rank_count_kernel")
    ops = Counter(loop)
    fma = sum(k for op, k in ops.items() if op.startswith(SASS_FMA))
    alu = sum(k for op, k in ops.items()
              if not op.startswith(SASS_MEMORY + SASS_CONTROL + SASS_FMA))
    emit({"measure": "sass_k4", "loop_opcodes": dict(sorted(ops.items())),
          "keys_per_iteration": keys, "alu_ops_per_pair": alu / keys,
          "fma_ops_per_pair": fma / keys, "loops_found": len(loops),
          "card": card})
    return alu / keys, fma / keys


PTXAS_ENTRY = re.compile(r"bitonic_(sort|merge)_(warp|smem)_kernelILi(\d+)E")
#: Instantiations ptxas must report: K1 per block, K2 per segment size.
PTXAS_SIZES = {"sort": [1 << j for j in range(1, 11)],
               "merge": [1 << j for j in range(1, 15)]}
MAX_REGISTERS = 64


def ptxas_line(card):
    """ptxas's registers, stack and spill bytes of every K1 and K2
    instantiation, from the build's `-Xptxas -v` report, one line for each
    kernel; fails on a missing size, a spill or more than 64 registers."""
    from repro_torch.kernels import cuda

    found = {"sort": {}, "merge": {}}
    current = None
    for line in cuda.ptxas_log().splitlines():
        name = re.search(r"entry function '([^']+)'|Function properties "
                         r"for (\S+)", line)
        if name:
            m = PTXAS_ENTRY.search(name.group(1) or name.group(2))
            current = None
            if m is not None:
                size = int(m.group(3))
                key = "block" if m.group(1) == "sort" else "segment"
                current = found[m.group(1)].setdefault(
                    size, {key: size, "kernel": m.group(2)})
            continue
        if current is None:
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
        if frame:
            current.update(zip(
                ("stack_bytes", "spill_store_bytes", "spill_load_bytes"),
                map(int, frame.groups())))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            current["registers"] = int(regs.group(1))
    for kind, tag in (("sort", "k1"), ("merge", "k2")):
        entries = [found[kind][k] for k in sorted(found[kind])]
        emit({"measure": f"ptxas_{tag}", "instantiations": entries,
              "card": card})
        if sorted(found[kind]) != PTXAS_SIZES[kind]:
            fail(f"ptxas report lacks {tag.upper()} sizes: found "
                 f"{sorted(found[kind])}")
        spilled = [k for k, e in sorted(found[kind].items())
                   if e.get("spill_store_bytes", 1)
                   or e.get("spill_load_bytes", 1)]
        if spilled:
            fail(f"{tag.upper()} spills registers at sizes {spilled}")
        heavy = [k for k, e in sorted(found[kind].items())
                 if e.get("registers", MAX_REGISTERS + 1) > MAX_REGISTERS]
        if heavy:
            fail(f"{tag.upper()} uses more than {MAX_REGISTERS} registers "
                 f"at sizes {heavy}")


def ptxas_wide_line(card):
    """ptxas's registers, shared memory and spill bytes of K4s's, K5's,
    K6's (count and emit) and K7's int32 and int64 instantiations
    (`analysis.budgets.ptxas_report`), one line; fails on a missing
    instantiation, a spill or more than 64 registers (K5's and K6's
    __launch_bounds__ of 4 blocks of 256 threads)."""
    from repro_torch.analysis import budgets
    from repro_torch.kernels import cuda

    report = budgets.ptxas_report(cuda.ptxas_log())
    found = {f"{entry}[{config}]": got
             for (entry, config), got in sorted(report.items())
             if entry in ("probe_rank_search_kernel",
                          "merge_path_pairs_kernel", "sample_count_kernel",
                          "sample_emit_kernel", "dense_send_kernel")}
    emit({"measure": "ptxas_k4s_k5_k6_k7", "instantiations": found,
          "card": card})
    if len(found) != 10:
        fail(f"ptxas report lacks K4s/K5/K6/K7 instantiations: found "
             f"{sorted(found)}")
    bad = [k for k, e in found.items()
           if e["spill_bytes"] or e["registers"] > MAX_REGISTERS]
    if bad:
        fail(f"K4s/K5/K6/K7 instantiations spill or exceed {MAX_REGISTERS} "
             f"registers: {bad}")


def edge_rows(torch, keys, rows, n):
    """Random keys with the edge rows: row 1 all INT_MAX (the hi
    sentinel), row 2 duplicates, row 3 INT_MIN among INT_MAX and small
    keys."""
    i32 = torch.iinfo(torch.int32)
    x = keys((rows, n))
    x[1] = i32.max
    x[2] = x[2] & 7
    pick = keys((n,)) & 3
    x[3] = torch.where(pick == 0, i32.min,
                       torch.where(pick == 1, i32.max, x[3] & 15))
    return x


def k1_block_checks(torch, BK, keys, check, card):
    """K1 against its plain version at every power-of-two block, on an odd
    row count with the edge rows (a length that leaves the last warp a
    partial chunk at small blocks), and on one row read at a one-key
    offset from an allocation, so not 16-byte aligned."""
    rows = 5
    blocks = [1 << j for j in range(1, 11)]
    for blk in blocks:
        n = 5 * 1024 + 2 * blk
        x = edge_rows(torch, keys, rows, n)
        check(f"bitonic_sort_blocks[block {blk}]", BK.sort_blocks(x, blk),
              BK.sort_blocks_plain(x, blk))
        off = keys((n + 1,))[1:].view(1, n)
        check(f"bitonic_sort_blocks[block {blk}, offset view]",
              BK.sort_blocks(off, blk), BK.sort_blocks_plain(off, blk))
    emit({"measure": "k1_blocks", "blocks": blocks,
          "shapes": [[rows, 5 * 1024 + 2 * b] for b in (2, 1024)],
          "rows": ["random", "all INT_MAX", "duplicates",
                   "INT_MIN/INT_MAX/small", "random"],
          "offset_view": True, "equal": True, "card": card})


def k2_segment_checks(torch, BK, keys, check, card):
    """K2 against its plain version at every power-of-two segment, both
    roles, on an odd row count with the edge rows."""
    rows, n = 5, 2 * BK.SMEM_MAX_SEG
    for j in range(1, 15):
        sg = 1 << j
        x = edge_rows(torch, keys, rows, n)
        half = sg // 2
        x[:4] = torch.sort(x[:4].view(4, -1, half), dim=-1).values.view(4, n)
        for reverse in (True, False):
            check(f"bitonic_merge_smem[segment {sg}, reverse={reverse}]",
                  BK.bitonic_merge_smem(x, sg, reverse),
                  BK.bitonic_merge_plain(x, sg, reverse))
    emit({"measure": "k2_segments", "segments": [1 << j for j in range(1, 15)],
          "roles": ["reverse", "tail"], "shape": [rows, n],
          "rows": ["random runs", "all INT_MAX", "duplicates",
                   "INT_MIN/INT_MAX/small", "random unsorted"],
          "equal": True, "card": card})


#: The post-exchange merge of the benchmark's `hss_p8_2p28` (2^28 keys over
#: p = 8 shards): 8 destination rows of 8 runs, each about 2^22 keys in its
#: pair capacity; ceil(log2 8) = 3 K5 levels.
MERGE_N_LOCAL = 1 << 25
MERGE_LEVELS = 3


def merge_path_row(torch, row, check, gen, wide=False):
    """K5's row (9; it replaces no Pallas site) at the benchmark's merge:
    runs of pair_cap slots holding 2^22 +- 4,096 sorted keys and the hi
    sentinel past them; the three levels against the plain version's and
    against torch.sort of each row cut to out_cap. Bound: the function's
    bytes, one read of each valid key and one write of each out_cap row;
    `levels_bound_ms` is the three pairwise levels' own, 2 x the key's
    bytes a valid key a level. `wide`: the int64 instantiation at the
    tagged cell's merge (hss_p8_2p28_skew2_tag: the same shapes, 35-bit
    packs of SKEW2 keys over 28 tag bits)."""
    from repro_torch.core.exchange import ExchangeConfig
    from repro_torch.kernels.merge import kernel as MK
    from repro_torch.kernels.merge import ops as mops

    cfg = ExchangeConfig()
    cap = cfg.pair_cap(MERGE_N_LOCAL, P)
    out_cap = cfg.out_cap(MERGE_N_LOCAL, P, EPS)
    counts = (1 << 22) + torch.randint(-4096, 4097, (P, P), generator=gen,
                                       device="cuda", dtype=torch.int32)
    if wide:
        dtype = torch.int64
        x = (torch.randint(0, 101, (P, P, cap), generator=gen,
                           device="cuda", dtype=dtype) << 28) | \
            torch.randint(0, 1 << 28, (P, P, cap), generator=gen,
                          device="cuda", dtype=dtype)
    else:
        dtype = torch.int32
        x = torch.randint(-2 ** 31, 2 ** 31 - 1, (P, P, cap), generator=gen,
                          device="cuda", dtype=dtype)
    hi = torch.iinfo(dtype).max
    key_bytes = x.element_size()
    x = torch.where(torch.arange(cap, device="cuda") < counts[..., None], x,
                    hi)
    x = torch.sort(x, dim=-1).values

    def kernel():
        return mops.merge_sorted_runs(x, counts=counts, out_len=out_cap)

    def plain():
        y, c = x, counts
        while y.shape[1] > 2:
            y, c = MK.merge_path_pairs_plain(y, c)
        return MK.merge_path_pairs_plain(y, c, out_len=out_cap)[0][:, 0]

    def library():
        return torch.sort(x.view(P, -1), dim=-1).values

    name = "merge_path_pairs" + ("[int64]" if wide else "")
    got = kernel()
    err = max(check(name, got, plain()),
              check(f"{name}[vs torch.sort]", got, library()[:, :out_cap]))
    del got
    valid = int(counts.sum())
    row(9, name, "K5", "merge_path_pairs" + (".i64" if wide else ""),
        "sort[skew2_tag]" if wide else "sort",
        "none (the post-exchange merge, which the reference runs as #7 "
        "and #8)", err, kernel, plain, library,
        key_bytes * (valid + P * out_cap), MERGE_LEVELS * valid,
        timed_shape=[P, P, cap], levels=MERGE_LEVELS, valid_keys=valid,
        out_len=out_cap, key_bytes=key_bytes,
        levels_bound_ms=(MERGE_LEVELS * 2 * key_bytes * valid
                         / HBM_BYTES_PER_S * 1e3))
    del x


#: The benchmark cells' keys a call (hssbench's hss_p8_2p28 and
#: hss_p8_2p28_skew2_tag): rows of 2^25 keys at p = 8.
SAMPLE_N = 1 << 28


@contextlib.contextmanager
def sample_calls(calls: list):
    """While the block runs, append each `dispatch.sample_compact` call's
    inputs to `calls`: a splitter round's sorted rows, its state, draws,
    probability and cap. The calls still run."""
    from repro_torch.kernels import dispatch

    real = dispatch.sample_compact

    def record(keys, lo_key, hi_key, satisfied, u, prob, cap, *,
               policy="auto"):
        calls.append((keys, lo_key.clone(), hi_key.clone(),
                      satisfied.clone(), u, prob.clone(), cap))
        return real(keys, lo_key, hi_key, satisfied, u, prob, cap,
                    policy=policy)

    dispatch.sample_compact = record
    try:
        yield calls
    finally:
        dispatch.sample_compact = real


def sample_compact_rows(torch, row, check, card):
    """K6's rows (10; it replaces no Pallas site: the reference sorts each
    masked row), int32 and int64: `sort` of 2^28 UNIF keys (the card
    cell's) and of 2^28 SKEW2 keys with tag=True (the tagged cell's, int64
    packs) records its K6 calls; their splitter keys, ranks and
    SplitterStats must equal the "torch" policy's. Rounds 1 (nothing
    satisfied) and 2 (the state round 1 left) are each held to the plain
    version and to the torch route (membership of every key, the mask and
    torch.sort of each row, `library_ms`), then timed. Bound: bytes, the
    draws over the round's member positions, the kept keys read and the
    (8, 1, cap) buffer written."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.sample import kernel as SK
    from repro_torch.sort import SortSpec, sort

    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    for wide in (False, True):
        high = 101 if wide else 2 ** 30
        x = torch.randint(0, high, (SAMPLE_N,), generator=gen,
                          device="cuda", dtype=torch.int32)
        spec = SortSpec(shards=P, eps=EPS, tag=wide)
        calls = []
        with sample_calls(calls):
            out, launches = launched(torch, lambda: sort(x, spec))
        ref = sort(x, dataclasses.replace(spec, kernel_policy="torch"))
        pairs = [(out.splitter_keys, ref.splitter_keys),
                 (out.splitter_ranks, ref.splitter_ranks),
                 *zip(out.stats, ref.stats)]
        name = "sample_compact" + ("[int64]" if wide else "")
        if not all(torch.equal(a, b) for a, b in pairs):
            fail(f"{name}: the splitters differ from the torch policy's")
        counter = "sample_compact" + (".i64" if wide else "")
        emit({"measure": "splitter_parity", "name": name, "n": SAMPLE_N,
              "rounds_sampled": len(calls),
              "rounds_used": int(out.stats.rounds_used),
              "sample_count": out.stats.sample_count.tolist(),
              "launches": launches, "equal": True, "card": card})
        if launches[counter] != 2 * len(calls):
            fail(f"{name}: {launches[counter]} K6 launches for "
                 f"{len(calls)} sampled rounds, not 2 a round")
        del out, ref, x
        timed = []
        for j, args in enumerate(calls[:2]):
            keys, lo, hi, sat, u, prob, cap = args

            def outputs(res):
                vals, sampled, over = res
                return torch.cat([vals.flatten(),
                                  sampled.flatten().to(vals.dtype),
                                  over.flatten().to(vals.dtype)])

            got = outputs(SK.sample_compact(*args))
            err = max(check(f"{name}[round {j + 1}]", got,
                            outputs(SK.sample_compact_plain(*args))),
                      check(f"{name}[round {j + 1}, vs the torch route]",
                            got, outputs(dispatch.sample_compact(
                                *args, policy="torch"))))
            members = int(dispatch.gamma_mask(keys, lo, hi, sat).sum())
            kept = int(got[-2 * P:-P].sum())
            moved = (u.element_size() * members
                     + keys.element_size() * (kept + P * min(cap,
                                                             keys.shape[-1])))
            timed.append(dict(
                err=err, members=members, kept=kept, bytes=moved,
                fn=lambda a=args: SK.sample_compact(*a),
                plain=lambda a=args: SK.sample_compact_plain(*a),
                library=lambda a=args: dispatch.sample_compact(
                    *a, policy="torch")))
        if len(timed) < 2:
            fail(f"{name}: {len(calls)} sampled round(s); rows 10 time "
                 "rounds 1 and 2")
        first, second = timed
        row(10, name, "K6", counter, "sort[skew2_tag]" if wide else "sort",
            "none (a splitter round's sample: the reference sorts each "
            "masked row through #1-#8)", max(first["err"], second["err"]),
            first["fn"], first["plain"], first["library"], first["bytes"],
            first["members"], timed_shape=list(calls[0][0].shape),
            draws=str(calls[0][4].dtype), round=1,
            members=first["members"], kept=first["kept"],
            round2_ms=time_ms(torch, second["fn"], reps=20),
            round2_bound_ms=bound(second["bytes"], second["members"])[0],
            round2_library_ms=time_ms(torch, second["library"], reps=5),
            round2_members=second["members"], round2_kept=second["kept"],
            rounds_sampled=len(calls))
        del calls, timed, first, second


def send_inputs(torch, keys, gen, shape):
    """The dense exchange's send at one shape: (p, B, n) rows sorted with 0
    to 3/8 of each in hi sentinels past n_valid, cut by p-1 splitters a
    request drawn from its rows (`destination_slices`) -> (rows, starts,
    counts); the counts still uncut by any pair capacity."""
    from repro_torch.core.exchange import destination_slices

    p, batch, n = shape
    hi = torch.iinfo(keys(1).dtype).max
    x = keys(p, batch, n)
    tails = torch.randint(0, 3 * n // 8 + 1, (p, batch), generator=gen,
                          device=x.device, dtype=torch.int32)
    x = torch.where(torch.arange(n, device=x.device) >= n - tails[..., None],
                    hi, x)
    x = torch.sort(x, dim=-1).values
    flat = x.transpose(0, 1).reshape(batch, -1)
    pick = torch.randint(0, flat.shape[1], (batch, p - 1), generator=gen,
                         device=x.device)
    spl = torch.sort(torch.gather(flat, 1, pick), dim=-1).values
    starts, counts = destination_slices(x, spl, n - tails)
    return x, starts, counts


def dense_send_rows(torch, row, check, gen):
    """K7's rows (11; it replaces no Pallas site: the reference cuts and
    pads the slices in XLA), int32 and int64, at the benchmark cells'
    send: 8 sorted rows of 2^25 keys (int64: the tagged cell's 35-bit
    packs of SKEW2 keys over 28 tag bits) cut by row 0's octiles into
    slices of about 2^22 keys, each cut at pair_cap (12,582,912). Against
    its plain version, which is the torch route (the int64 index gather,
    timed again through the route as `library_ms`), one launch a call.
    Bound: bytes, one read of each key sent and one write of the
    (8, 8, 1, cap) buffer."""
    from repro_torch.core.exchange import ExchangeConfig, destination_slices
    from repro_torch.kernels import cuda, dispatch
    from repro_torch.kernels.send import kernel as SEND

    cap = ExchangeConfig().pair_cap(MERGE_N_LOCAL, P)
    for wide in (False, True):
        if wide:
            dtype = torch.int64
            x = (torch.randint(0, 101, (P, 1, MERGE_N_LOCAL), generator=gen,
                               device="cuda", dtype=dtype) << 28) | \
                torch.randint(0, 1 << 28, (P, 1, MERGE_N_LOCAL),
                              generator=gen, device="cuda", dtype=dtype)
        else:
            dtype = torch.int32
            x = torch.randint(-2 ** 31, 2 ** 31 - 1, (P, 1, MERGE_N_LOCAL),
                              generator=gen, device="cuda", dtype=dtype)
        x = torch.sort(x, dim=-1).values
        # row 0's octiles: slices of about 2^22 keys in every row
        starts, counts = destination_slices(
            x, x[0, 0, torch.arange(1, P, device="cuda") * (MERGE_N_LOCAL
                                                             // P)])
        args = (x, starts, torch.clamp(counts, max=cap), cap)
        name = "dense_send" + ("[int64]" if wide else "")
        counter = "dense_send" + (".i64" if wide else "")
        before = cuda.launches[counter]
        got = SEND.dense_send(*args)
        if cuda.launches[counter] != before + 1:
            fail(f"{name}: {cuda.launches[counter] - before} launches a "
                 "call, not 1")
        err = check(name, got, SEND.dense_send_plain(*args))
        del got
        sent = int(args[2].sum())
        key_bytes = x.element_size()
        row(11, name, "K7", counter, "sort[skew2_tag]" if wide else "sort",
            "none (the dense exchange's send buffer: the reference cuts "
            "and pads the slices in XLA)", err,
            lambda a=args: SEND.dense_send(*a),
            lambda a=args: SEND.dense_send_plain(*a),
            lambda a=args: dispatch.dense_send(*a, policy="torch"),
            key_bytes * (sent + P * P * cap), 0,
            timed_shape=[P, P, 1, cap], sent_keys=sent,
            max_slice=int(counts.max()), key_bytes=key_bytes)
        del x, args, starts, counts


def kernel_phase(torch, card, floor_ms, k4_ops):
    """One row per Pallas site and kernel, in site order; `launches` is
    filled in from the main paths' runs later. k4_ops: the counting K4's
    (int32, FMA-pipe) operations per pair (`k4_sass_line`)."""
    from repro_torch.kernels import cuda
    from repro_torch.kernels.bitonic_sort import kernel as BK
    from repro_torch.kernels.histogram import kernel as HK
    from repro_torch.kernels.merge import kernel as MK

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def keys(shape):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                             device="cuda", dtype=torch.int32)

    def runs(rows, n, run):
        return torch.sort(keys((rows, n)).view(rows, n // run, run),
                          dim=-1).values.view(rows, n)

    def check(name, got, want):
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        if not torch.equal(got, want):
            fail(f"{name} disagrees with its plain version (max err {err})")
        return err

    rows = []

    def row(site, name, kernel, counter, path, replaces, err, fn, plain,
            library, bytes_moved, ops, fma_ops=0, reps=20, **extra):
        ms = time_ms(torch, fn, reps=reps)
        plain_ms = time_ms(torch, plain, reps=3, warmup=1)
        lib_ms = (None if library is None
                  else time_ms(torch, library, reps=reps))
        bound_ms, bound_by = bound(bytes_moved, ops, fma_ops)
        rows.append({"site": site, "name": name, "kernel": kernel,
                     "counter": counter, "path": path, "route": "cuda",
                     "source": SOURCE, "replaces": replaces, "launches": 0,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms,
                     "main_path": counter not in cuda.OFF_MAIN_PATH,
                     **extra})

    def search_row(site, path, replaces, err, k, q, **extra):
        """K4s's row on sorted keys k and probes q, with the floor of an
        empty launch and both calls' host-clock times beside it."""
        row(site, "probe_rank_search" + ("[batched]" if site == 6 else ""),
            "K4s", "probe_rank_search", path, replaces, err,
            lambda: HK.probe_rank_search(k, q),
            lambda: HK.probe_ranks_search_plain(k, q),
            lambda: torch.searchsorted(k, q, side="left"),
            *search_bound(k.shape[0], k.shape[1], q.shape[1]),
            reps=SHORT_REPS, floor_ms=floor_ms,
            host_ms=host_ms(torch, lambda: HK.probe_rank_search(k, q),
                            reps=SHORT_REPS),
            library_host_ms=host_ms(
                torch, lambda: torch.searchsorted(k, q, side="left"),
                reps=SHORT_REPS),
            **extra)

    k1_block_checks(torch, BK, keys, check, card)
    k2_segment_checks(torch, BK, keys, check, card)
    log_b = 10                      # block 1024
    seg = BK.SMEM_MAX_SEG

    # -- slice 1 shapes: the sort's (8, 2^21) shard rows
    n = P * ROW
    x = keys((P, ROW))
    paired = runs(P, ROW, seg // 2)
    sorted_rows = torch.sort(keys((P, N_LOCAL)), dim=-1).values
    probes = torch.sort(keys((1, PROBES)), dim=-1).values
    probes = probes.expand(P, -1).contiguous()

    # #1 K1: the shard sort's first stage, 1024-key blocks
    err = check("bitonic_sort_blocks", BK.sort_blocks(x, 1024),
                BK.sort_blocks_plain(x, 1024))
    row(1, "bitonic_sort_blocks", "K1", "bitonic_sort_blocks", "sort",
        f"{PALLAS}/bitonic_sort/kernel.py:83", err,
        lambda: BK.sort_blocks(x, 1024),
        lambda: BK.sort_blocks_plain(x, 1024),
        lambda: torch.sort(x.view(-1, 1024), dim=-1),
        2 * 4 * n, 2 * (n // 2) * log_b * (log_b + 1) // 2)

    # #3 and #8 K2: both flags, on the largest on-chip segment
    for site, reverse, role, line in (
            (3, True, "reverse", "bitonic_sort/kernel.py:117"),
            (8, False, "tail", "merge/kernel.py:71")):
        err = check(f"bitonic_merge_smem(reverse={reverse})",
                    BK.bitonic_merge_smem(paired, seg, reverse),
                    BK.bitonic_merge_plain(paired, seg, reverse))
        row(site, f"bitonic_merge_smem[{role}]", "K2",
            f"bitonic_merge_smem.{role}", "sort", f"{PALLAS}/{line}", err,
            lambda r=reverse: BK.bitonic_merge_smem(paired, seg, r),
            lambda r=reverse: BK.bitonic_merge_plain(paired, seg, r),
            lambda: torch.sort(paired.view(-1, seg), dim=-1),
            2 * 4 * n, 2 * (n // 2) * (seg.bit_length() - 1))

    # #7 K3: the local sort's largest distance (2^20), both relayouts
    d = ROW // 2
    err = 0
    for flip in (True, False):
        err = max(err, check(
            f"strided_compare_exchange(flip={flip})",
            MK.strided_compare_exchange(x, d, flip),
            MK.strided_compare_exchange_plain(x, d, flip)))
    row(7, "strided_compare_exchange", "K3", "strided_compare_exchange",
        "sort", f"{PALLAS}/merge/kernel.py:49", err,
        lambda: MK.strided_compare_exchange(x, d, True),
        lambda: MK.strided_compare_exchange_plain(x, d, True),
        None, 2 * 4 * n, n, timed_shape=[P, ROW], timed_distance=d)

    # #5 K4s: one HSS round's histogram, 8 x 2,000,000 sorted keys x 256,
    # against its plain version and the counting K4
    got = HK.probe_rank_search(sorted_rows, probes)
    err = max(check("probe_rank_search", got,
                    HK.probe_ranks_search_plain(sorted_rows, probes)),
              check("probe_rank_search[vs K4]", got,
                    HK.probe_rank_count(sorted_rows, probes)))
    search_row(5, "sort", f"{PALLAS}/histogram/kernel.py:35", err,
               sorted_rows, probes)
    # #5 K4, the count (off the sort paths; its path is probe_counts,
    # phase 25), on the same rows; its operations per (key, probe) pair
    # are the compiler's (k4_sass_line)
    err = check("probe_rank_count", HK.probe_rank_count(sorted_rows, probes),
                HK.probe_ranks_plain(sorted_rows, probes))
    pairs = sorted_rows.numel() * PROBES
    row(5, "probe_rank_count", "K4", "probe_rank_count", "probe_counts",
        f"{PALLAS}/histogram/kernel.py:35", err,
        lambda: HK.probe_rank_count(sorted_rows, probes),
        lambda: HK.probe_ranks_plain(sorted_rows, probes),
        None,   # searchsorted needs sorted keys: not the count's function
        4 * (sorted_rows.numel() + 2 * probes.numel()),
        k4_ops[0] * pairs, k4_ops[1] * pairs, timed_shape=[P, N_LOCAL],
        note="off the sort paths: assume_sorted=False, probe_counts")
    # #5 K4 at probe_counts's own launch (phase 25): one row of N_WEAK
    # unsorted keys against 256 sorted probes
    xk = keys((1, N_WEAK))
    qk = torch.sort(keys((1, PROBES)), dim=-1).values
    err = check("probe_rank_count[probe_counts]", HK.probe_rank_count(xk, qk),
                HK.probe_ranks_plain(xk, qk))
    row(5, "probe_rank_count[probe_counts]", "K4", "probe_rank_count",
        "probe_counts", f"{PALLAS}/histogram/kernel.py:35", err,
        lambda: HK.probe_rank_count(xk, qk),
        lambda: HK.probe_ranks_plain(xk, qk),
        None,   # searchsorted needs sorted keys: not the count's function
        4 * (xk.numel() + 2 * qk.numel()),
        k4_ops[0] * N_WEAK * PROBES, k4_ops[1] * N_WEAK * PROBES,
        timed_shape=[1, N_WEAK],
        note="probe_counts's shape: one row of unsorted keys")
    del x, paired, sorted_rows, probes, xk, qk

    # -- slice 2 shapes: the batched sort's B*p = 64 rows
    nb = B_ROWS * B_ROW
    xb = keys((B_ROWS, B_ROW))

    # #2 K1 over 64 rows of 2^18
    err = check("bitonic_sort_blocks[batched]", BK.sort_blocks(xb, 1024),
                BK.sort_blocks_plain(xb, 1024))
    row(2, "bitonic_sort_blocks[batched]", "K1", "bitonic_sort_blocks",
        "sort_batched", f"{PALLAS}/bitonic_sort/kernel.py:98", err,
        lambda: BK.sort_blocks(xb, 1024),
        lambda: BK.sort_blocks_plain(xb, 1024),
        lambda: torch.sort(xb.view(-1, 1024), dim=-1),
        2 * 4 * nb, 2 * (nb // 2) * log_b * (log_b + 1) // 2)

    # #4 K2 reverse over 64 rows, at a segment of 2,048 and of 16,384
    seg_ms = {}
    err = 0
    for sg in (2048, seg):
        pb = runs(B_ROWS, B_ROW, sg // 2)
        err = max(err, check(f"bitonic_merge_smem[reverse,batched,{sg}]",
                             BK.bitonic_merge_smem(pb, sg, True),
                             BK.bitonic_merge_plain(pb, sg, True)))
        seg_ms[sg] = time_ms(torch, lambda: BK.bitonic_merge_smem(pb, sg,
                                                                  True),
                             reps=20)
    row(4, "bitonic_merge_smem[reverse,batched]", "K2",
        "bitonic_merge_smem.reverse", "sort_batched",
        f"{PALLAS}/bitonic_sort/kernel.py:132", err,
        lambda: BK.bitonic_merge_smem(pb, seg, True),
        lambda: BK.bitonic_merge_plain(pb, seg, True),
        lambda: torch.sort(pb.view(-1, seg), dim=-1),
        2 * 4 * nb, 2 * (nb // 2) * (seg.bit_length() - 1),
        ms_segment_2048=seg_ms[2048])

    # #8 K2 tail (no reverse) over the same 64 rows at 16,384 keys
    err = check("bitonic_merge_smem[tail,batched]",
                BK.bitonic_merge_smem(pb, seg, False),
                BK.bitonic_merge_plain(pb, seg, False))

    # #7 K3 at the batched path's largest distance, both relayouts: the
    # local sort of (64, 2^18) rows
    k3_err = 0
    for flip in (True, False):
        k3_err = max(k3_err, check(
            f"strided_compare_exchange[(64, 2^18), flip={flip}]",
            MK.strided_compare_exchange(xb, B_ROW // 2, flip),
            MK.strided_compare_exchange_plain(xb, B_ROW // 2, flip)))
    row(8, "bitonic_merge_smem[tail,batched]", "K2",
        "bitonic_merge_smem.tail", "sort_batched",
        f"{PALLAS}/merge/kernel.py:71", err,
        lambda: BK.bitonic_merge_smem(pb, seg, False),
        lambda: BK.bitonic_merge_plain(pb, seg, False),
        lambda: torch.sort(pb.view(-1, seg), dim=-1),
        2 * 4 * nb, 2 * (nb // 2) * (seg.bit_length() - 1),
        shapes_checked=[[B_ROWS, B_ROW]])
    row(7, "strided_compare_exchange[batched]", "K3",
        "strided_compare_exchange", "sort_batched",
        f"{PALLAS}/merge/kernel.py:49", k3_err,
        lambda: MK.strided_compare_exchange(xb, B_ROW // 2, True),
        lambda: MK.strided_compare_exchange_plain(xb, B_ROW // 2, True),
        None, 2 * 4 * nb, nb, timed_shape=[B_ROWS, B_ROW],
        timed_distance=B_ROW // 2)
    del pb, xb

    # K5: the benchmark cell's post-exchange merge (hssbench's
    # hss_p8_2p28: 2^28 keys, p = 8, pair_factor 3.0), 8 rows of 8 runs
    # of 12,582,912 slots, each run's count near 2^22; three levels, the
    # last writing the out_cap row. Against its plain version and against
    # torch.sort of the rows, then timed beside both; then the int64
    # instantiation at the tagged cell's (the same shapes, int64 packs)
    merge_path_row(torch, row, check, gen)
    merge_path_row(torch, row, check, gen, wide=True)

    # K6: the splitter rounds of the benchmark cells' sorts, int32 and
    # int64, rounds 1 and 2 as they ran
    sample_compact_rows(torch, row, check, card)

    # K7: the benchmark cells' dense send, int32 and int64
    dense_send_rows(torch, row, check, gen)

    # #5 K4s's int64 instantiation: one round's search of the tagged
    # cell's splitters, 8 sorted rows of 2^25 int64 packs x 256 probes
    kw = torch.sort((keys((P, MERGE_N_LOCAL)).long() << 28)
                    | (keys((P, MERGE_N_LOCAL)).long() & (2 ** 28 - 1)),
                    dim=-1).values
    qw = torch.sort(kw[:, torch.randint(0, MERGE_N_LOCAL, (PROBES,),
                                        generator=gen, device="cuda")]
                    + 1, dim=-1).values
    qw[:, ::8] = torch.iinfo(torch.int64).max
    got = HK.probe_rank_search(kw, qw)
    err = max(check("probe_rank_search[int64]", got,
                    HK.probe_ranks_search_plain(kw, qw)),
              check("probe_rank_search[int64, vs searchsorted]", got,
                    torch.searchsorted(kw, qw).to(torch.int32)))
    row(5, "probe_rank_search[int64]", "K4s", "probe_rank_search.i64",
        "sort[skew2_tag]", f"{PALLAS}/histogram/kernel.py:35", err,
        lambda: HK.probe_rank_search(kw, qw),
        lambda: HK.probe_ranks_search_plain(kw, qw),
        lambda: torch.searchsorted(kw, qw, side="left"),
        *search_bound(P, MERGE_N_LOCAL, PROBES, key_bytes=8),
        reps=SHORT_REPS, floor_ms=floor_ms, timed_shape=[P, MERGE_N_LOCAL])
    del kw, qw, got

    # #6 K4s and K4: keys (64, 250,000), a distinct sorted probe row of
    # 256 each; and 70,000 rows, past gridDim.y's 65,535
    kb = torch.sort(keys((B_ROWS, B_LOCAL)), dim=-1).values
    qb = torch.sort(keys((B_ROWS, PROBES)), dim=-1).values
    kr = torch.sort(keys((70_000, 64)), dim=-1).values
    qr = torch.sort(keys((70_000, 8)), dim=-1).values
    err = 0
    for what, k, q in (("batched", kb, qb), ("70,000 rows", kr, qr)):
        got = HK.probe_rank_search(k, q)
        err = max(err, check(f"probe_rank_search[{what}]", got,
                             HK.probe_ranks_search_plain(k, q)),
                  check(f"probe_rank_search[{what}, vs K4]", got,
                        HK.probe_rank_count(k, q)))
    search_row(6, "sort_batched", f"{PALLAS}/histogram/kernel.py:64", err,
               kb, qb, rows_limit_checked=70_000)
    err = check("probe_rank_count[batched]", HK.probe_rank_count(kb, qb),
                HK.probe_ranks_plain(kb, qb))
    kr = keys((70_000, 64))         # the count takes keys in any order
    err = max(err, check("probe_rank_count[70,000 rows]",
                         HK.probe_rank_count(kr, qr),
                         HK.probe_ranks_plain(kr, qr)))
    row(6, "probe_rank_count[batched]", "K4", "probe_rank_count",
        "probe_counts", f"{PALLAS}/histogram/kernel.py:64", err,
        lambda: HK.probe_rank_count(kb, qb),
        lambda: HK.probe_ranks_plain(kb, qb),
        None,   # searchsorted needs sorted keys: not the count's function
        4 * (kb.numel() + 2 * qb.numel()), k4_ops[0] * kb.numel() * PROBES,
        k4_ops[1] * kb.numel() * PROBES, timed_shape=[B_ROWS, B_LOCAL],
        rows_limit_checked=70_000,
        note="off the sort paths: assume_sorted=False, probe_counts")
    rows.sort(key=lambda r: r["site"])
    # a kernel cannot beat the least time the card needs: a time under its
    # bound means the bound counts work the kernel does not do
    over = [(r["name"], r["ms"], r["bound_ms"]) for r in rows
            if r["bound_ms"] > r["ms"]]
    if over:
        fail(f"kernels faster than their bounds: {over}")
    return rows


def cascade_line(torch, card):
    """The local sort as a whole (K1 + K2 + K3) against torch.sort, at the
    sort's (8, 2,000,000) rows and the batched sort's (8, 8, 250,000)."""
    from repro_torch.kernels import dispatch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for shape in ((P, N_LOCAL), (B, P, B_LOCAL)):
        x = torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                          device="cuda", dtype=torch.int32)
        got = dispatch.local_sort(x, policy="kernel")
        torch.cuda.synchronize()
        if not torch.equal(got, torch.sort(x, dim=-1).values):
            fail(f"the kernel local sort of {shape} disagrees with "
                 "torch.sort")
        emit({"measure": "local_sort_cascade", "shape": list(shape),
              "kernel_ms": time_ms(torch, lambda: dispatch.local_sort(
                  x, policy="kernel"), reps=10),
              "library_ms": time_ms(torch, lambda: torch.sort(x, dim=-1),
                                    reps=10),
              "card": card})


def check_path_launches(name: str, launches: dict, expected=None):
    """Every kernel the path launches by the code (`expected`; default
    the int32 HSS paths' set, every kernel but the counting K4 and the
    int64 instantiations) launched, and no other."""
    from repro_torch.kernels import cuda

    if expected is None:
        expected = [k for k in cuda.COUNTERS
                    if k not in cuda.OFF_MAIN_PATH + cuda.WIDE]
    missing = [k for k in expected if not launches.get(k)]
    if missing:
        fail(f"{name}: kernels never launched: {missing}")
    stray = [k for k, v in launches.items() if v and k not in expected]
    if stray:
        fail(f"{name}: off-path kernels launched: {stray}")


def slice_inputs(np):
    from repro_torch.data.distributions import make_distribution

    yield "weak_scaling_int32", make_distribution("UNIF", N_WEAK, seed=0)
    yield "normal_float32", np.random.default_rng(1).standard_normal(
        N_WEAK).astype(np.float32)
    # below 2^32 - 1: the uint32 sentinel would force 31-bit tagging
    yield "ragged_uint32", np.random.default_rng(2).integers(
        0, 2 ** 32 - 1, N_WEAK + 3, dtype=np.uint32)


def slice_phase(torch, np, card):
    from repro_torch.kernels import cuda
    from repro_torch.sort import SortSpec, sort

    spec = SortSpec(shards=P, eps=EPS)
    main_launches = None
    for name, x in slice_inputs(np):
        cuda.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sort(x, spec)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches = dict(cuda.launches)
        if main_launches is None:
            main_launches = launches
        check_path_launches(name, launches)
        got = out.gather()
        if not np.array_equal(got, np.sort(x)):
            fail(f"{name}: gather() differs from np.sort")
        overflow = int(out.overflow)
        counts = out.counts.cpu().numpy()
        limit = (1 + EPS) * x.shape[0] / P + 1
        if overflow != 0 or counts.max() > limit:
            fail(f"{name}: overflow {overflow}, max count {counts.max()} "
                 f"(limit {limit})")
        ref = sort(x, dataclasses.replace(spec, kernel_policy="torch"))
        same = (torch.equal(out.shards.view(torch.int32),
                            ref.shards.view(torch.int32))
                and torch.equal(out.counts, ref.counts))
        if not same:
            fail(f"{name}: kernel and torch policies disagree")
        emit({"measure": "slice", "input": name, "n": int(x.shape[0]),
              "dtype": str(x.dtype), "overflow": overflow,
              "max_count": int(counts.max()), "limit": limit,
              "rounds_used": int(out.stats.rounds_used),
              "tagged": out.indices is not None, "launches": launches,
              "first_call_s": cold_s, "policies_agree": True, "card": card})
    return main_launches


def batched_inputs(np):
    from repro_torch.data.distributions import make_distribution

    return np.stack([make_distribution("UNIF", N_REQ, seed=s)
                     for s in range(B)])


def check_batched(np, name, out, xs, sorted_rows=None):
    """Per request: gather == np.sort, overflow 0, balance within
    (1+eps)n/p + 1. Returns (max count, limit)."""
    overflow = out.overflow.cpu().numpy()
    counts = out.counts.cpu().numpy()
    n = xs[0].shape[0]
    limit = (1 + EPS) * n / P + 1
    for b, x in enumerate(xs):
        want = np.sort(x) if sorted_rows is None else sorted_rows[b]
        if not np.array_equal(out.gather(b), want):
            fail(f"{name}: request {b} differs from np.sort")
    if overflow.any() or counts.max() > limit:
        fail(f"{name}: overflow {overflow.tolist()}, max count "
             f"{counts.max()} (limit {limit})")
    return int(counts.max()), limit


def batched_phase(torch, np, card):
    """Slice 2's main path, sort_batched on (8, 2,000,000) keys, under
    both exchanges; returns the dense run's launch counts."""
    from repro_torch.kernels import cuda
    from repro_torch.sort import SortSpec, sort, sort_batched

    xs = batched_inputs(np)
    sorted_rows = np.sort(xs, axis=1)
    main_launches = None
    for exchange in ("dense", "allgather"):
        spec = SortSpec(shards=P, eps=EPS, exchange=exchange)
        cuda.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sort_batched(xs, spec)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches = dict(cuda.launches)
        if main_launches is None:
            main_launches = launches
        check_path_launches(f"sort_batched[{exchange}]", launches,
                            None if exchange == "dense" else HSS_EXACT)
        max_count, limit = check_batched(np, f"sort_batched[{exchange}]",
                                         out, xs, sorted_rows)
        ref = sort_batched(xs, dataclasses.replace(spec,
                                                   kernel_policy="torch"))
        if not (torch.equal(out.shards, ref.shards)
                and torch.equal(out.counts, ref.counts)):
            fail(f"sort_batched[{exchange}]: kernel and torch policies "
                 "disagree")
        # with tag fixed both plans agree: row b is sort() of row b alone
        untagged = dataclasses.replace(spec, tag=False)
        batched = sort_batched(xs, untagged)
        for b in range(B):
            one = sort(xs[b], untagged)
            view = batched.request(b)
            if not (torch.equal(view.shards, one.shards)
                    and torch.equal(view.counts, one.counts)
                    and torch.equal(view.splitter_keys, one.splitter_keys)):
                fail(f"sort_batched[{exchange}]: row {b} differs from "
                     "sort() of that row (tag=False)")
        emit({"measure": "slice_batched", "input": "unif_int32",
              "exchange": exchange, "batch": B, "n": N_REQ,
              "overflow": out.overflow.cpu().tolist(),
              "max_count": max_count, "limit": limit,
              "rounds_used": out.stats.rounds_used.cpu().tolist(),
              "tagged": out.indices is not None, "launches": launches,
              "first_call_s": cold_s, "policies_agree": True,
              "rows_equal_sort_untagged": True, "card": card})

    spec = SortSpec(shards=P, eps=EPS)
    others = (
        ("normal_float32", np.random.default_rng(1).standard_normal(
            (B, N_REQ)).astype(np.float32)),
        # below 2^32 - 1: the uint32 sentinel would force 31-bit tagging
        ("ragged_uint32", np.random.default_rng(2).integers(
            0, 2 ** 32 - 1, (B, N_REQ + 3), dtype=np.uint32)))
    for name, ys in others:
        cuda.reset_launches()
        out = sort_batched(ys, spec)
        torch.cuda.synchronize()
        launches = dict(cuda.launches)
        check_path_launches(name, launches)
        max_count, limit = check_batched(np, name, out, ys)
        emit({"measure": "slice_batched", "input": name, "exchange": "dense",
              "batch": B, "n": int(ys.shape[1]), "max_count": max_count,
              "limit": limit, "tagged": out.indices is not None,
              "launches": launches, "card": card})

    # list input: five 2,000,000-key and three 2,000,003-key requests
    ragged = np.random.default_rng(3).integers(
        0, 2 ** 30, (3, N_REQ + 3)).astype(np.int32)
    reqs = [xs[0], ragged[0], xs[1], xs[2], ragged[1], xs[3], ragged[2],
            xs[4]]
    outs = sort_batched(reqs, spec)
    if len(outs) != len(reqs):
        fail("list input: wrong number of results")
    for i, (x, o) in enumerate(zip(reqs, outs)):
        if int(o.overflow) != 0 or not np.array_equal(o.gather(), np.sort(x)):
            fail(f"list input: request {i} differs from np.sort")
    emit({"measure": "slice_batched", "input": "list_int32",
          "lengths": [int(x.shape[0]) for x in reqs], "buckets": 2,
          "in_order": True, "card": card})
    return main_launches


def profile_line(torch, fn, card, **fields):
    """One warm call of `fn` under torch.profiler: device time by name, the
    15 largest, and every one of the port's kernels however small."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "self_device_time_total", 0) > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)

    def entry(e):
        return {"name": e.key[:80], "device_us": e.self_device_time_total,
                "calls": e.count}

    emit({**fields,
          "device_us_total": sum(e.self_device_time_total for e in events),
          "top": [entry(e) for e in events[:15]],
          "port_kernels": [entry(e) for e in events
                           if any(k in e.key for k in PORT_KERNELS)],
          "card": card})


def timing_phase(torch, np, card):
    from repro_torch.data.distributions import make_distribution
    from repro_torch.sort import SortSpec, sort

    x = make_distribution("UNIF", N_WEAK, seed=0)
    for policy in ("auto", "torch"):
        spec = SortSpec(shards=P, eps=EPS, kernel_policy=policy)
        sort(x, spec)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sort(x, spec)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        emit({"measure": "sort_e2e_warm", "input": "weak_scaling_int32",
              "policy": policy, "median_ms": statistics.median(times),
              "runs_ms": times, "card": card})

    spec = SortSpec(shards=P, eps=EPS)
    profile_line(torch, lambda: sort(x, spec), card, measure="sort_profile",
                 input="weak_scaling_int32")


def median_ms(torch, fn, reps=5):
    """The median and the samples of `reps` warm calls on the host clock,
    each waited for with torch.cuda.synchronize()."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def medians_in_turns(torch, fns: dict, reps=5) -> dict:
    """Each of `fns` warmed, then timed `reps` times in turns (one call of
    each a round, so drift on the shared host falls on all alike): the
    median and the samples of each, as `median_ms` gives them."""
    for fn in fns.values():
        fn()
    runs = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs[name].append((time.perf_counter() - t0) * 1e3)
    return {name: (statistics.median(r), r) for name, r in runs.items()}


def batched_timing_phase(torch, np, card):
    from repro_torch.sort import SortSpec, sort, sort_batched

    xs = batched_inputs(np)
    for policy in ("auto", "torch"):
        spec = SortSpec(shards=P, eps=EPS, kernel_policy=policy)
        batched, runs_b = median_ms(torch, lambda: sort_batched(xs, spec))
        seq, runs_s = median_ms(torch, lambda: [sort(x, spec) for x in xs])
        emit({"measure": "sort_batched_e2e_warm", "input": "unif_int32",
              "exchange": "dense", "batch": B, "n": N_REQ, "policy": policy,
              "batched_median_ms": batched, "batched_runs_ms": runs_b,
              "sequential_median_ms": seq, "sequential_runs_ms": runs_s,
              "card": card})

    spec = SortSpec(shards=P, eps=EPS)
    profile_line(torch, lambda: sort_batched(xs, spec), card,
                 measure="sort_batched_profile", input="unif_int32",
                 exchange="dense")


def recovery_inputs(np):
    from repro_torch.data.distributions import make_adversarial

    for name in ("PRESORTED", "REVERSE"):
        yield name.lower(), make_adversarial(name, N_WEAK, seed=0)


def launched(torch, fn):
    """fn() with every launch count set to 0 just before it; returns
    (result, the counts just after)."""
    from repro_torch.kernels import cuda

    cuda.reset_launches()
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(cuda.launches)


def peak_run(torch, fn):
    """fn() and the peak of allocated device memory while it ran."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated()


def same_as_torch_policy(torch, out, ref) -> bool:
    return (torch.equal(out.shards, ref.shards)
            and torch.equal(out.counts, ref.counts))


def recovery_phase(torch, np, card):
    """Presorted and reversed keys under raise, retry and spill, unbatched
    and batched; returns the launch counts of each recovery path."""
    from repro_torch.data.distributions import make_adversarial
    from repro_torch.sort import SortSpec, sort, sort_batched

    # the spill merge: each of p destinations merges 2p runs of
    # pow2_ceil(n_local) = 2^21 keys, int32
    reckoned = P * 2 * P * ROW * 4
    emit({"measure": "recovery_memory_reckoned",
          "spill_merge_bytes": reckoned, "card": card})
    paths = {}
    peaks = []

    def peak_of(fn):
        out, peak = peak_run(torch, fn)
        peaks.append(peak)
        return out, peak

    for name, x in recovery_inputs(np):
        want = np.sort(x)
        raised = sort(x, SortSpec(shards=P, eps=EPS))
        ovf_raise = int(raised.overflow)
        raise_exact = bool(np.array_equal(raised.gather(), want))
        del raised
        for policy in ("retry", "spill"):
            spec = SortSpec(shards=P, eps=EPS, on_overflow=policy)
            (out, launches), peak = peak_of(
                lambda: launched(torch, lambda: sort(x, spec)))
            path = f"sort[{policy}]"
            paths.setdefault(path, launches)
            check_path_launches(f"{path} {name}", launches)
            if int(out.overflow) != 0 or not np.array_equal(out.gather(),
                                                            want):
                fail(f"{path} {name}: not equal to np.sort (overflow "
                     f"{int(out.overflow)})")
            ref, ref_peak = peak_of(lambda: sort(
                x, dataclasses.replace(spec, kernel_policy="torch")))
            if not same_as_torch_policy(torch, out, ref):
                fail(f"{path} {name}: kernel and torch policies disagree")
            recovery = (None if out.recovery is None
                        else dataclasses.asdict(out.recovery))
            if policy == "retry" and (recovery is None
                                      or recovery["attempts"] < 2):
                fail(f"{path} {name}: retry recorded no escalation "
                     f"({recovery})")
            emit({"measure": "recovery", "input": name, "n": N_WEAK,
                  "policy": policy, "raise_overflow": ovf_raise,
                  "raise_exact": raise_exact, "overflow": int(out.overflow),
                  "recovery": recovery,
                  "rounds_used": int(out.stats.rounds_used),
                  "launches": launches, "policies_agree": True,
                  "max_allocated_bytes": peak,
                  "torch_policy_max_allocated_bytes": ref_peak,
                  "card": card})
            del out, ref
    emit({"measure": "recovery_memory", "max_allocated_bytes": max(peaks),
          "card": card})

    xs = np.stack([make_adversarial("PRESORTED" if b % 2 == 0 else
                                    "REVERSE", N_REQ, seed=b)
                   for b in range(B)])
    for policy in ("retry", "spill"):
        spec = SortSpec(shards=P, eps=EPS, on_overflow=policy)
        out, launches = launched(torch, lambda: sort_batched(xs, spec))
        path = f"sort_batched[{policy}]"
        paths[path] = launches
        check_path_launches(path, launches)
        max_count, limit = check_batched(np, path, out, xs)
        ref = sort_batched(xs, dataclasses.replace(spec,
                                                   kernel_policy="torch"))
        if not same_as_torch_policy(torch, out, ref):
            fail(f"{path}: kernel and torch policies disagree")
        emit({"measure": "recovery_batched", "input": "presorted_reverse",
              "batch": B, "n": N_REQ, "policy": policy,
              "overflow": out.overflow.cpu().tolist(),
              "max_count": max_count, "limit": limit,
              "recovery": (None if out.recovery is None
                           else dataclasses.asdict(out.recovery)),
              "launches": launches, "policies_agree": True, "card": card})
    return paths


#: Phase 29: the tagged cell's path (hssbench's hss_p8_2p28_skew2_tag).
TAGGED_N = 1 << 28


def tagged_phase(torch, np, card):
    """The benchmark's tagged cell on its own path: `sort` of 2^28 SKEW2
    keys (uniform in [0, 100]) made on the card, tag=True (7 key + 28 tag
    bits: an int64 pack), HSS at p = 8, eps 0.05, dense, "auto". Exact
    against torch.sort of the input, every shard within (1 + eps) N / p,
    the int64 K4s, K5 and K6 launched and nothing else of the port's, K5's
    three levels a call; the warm median of 3 calls and the peak of
    allocated memory. Then the narrower precision's reading: the same
    packs cut to int32 and sorted, whose keys read back wrong (the cell's
    `wrong_keys` check tells them apart). Returns the path's launches."""
    from repro_torch.sort import SortSpec, sort

    gen = torch.Generator(device="cuda")
    gen.manual_seed(29)
    x = torch.randint(0, 101, (TAGGED_N,), generator=gen, device="cuda",
                      dtype=torch.int32)
    spec = SortSpec(shards=P, eps=EPS, tag=True)
    torch.cuda.reset_peak_memory_stats()
    out, launches = launched(torch, lambda: sort(x, spec))
    peak = torch.cuda.max_memory_allocated()
    check_path_launches("sort[skew2_tag]", launches, WIDE)
    if launches["merge_path_pairs.i64"] != 3:
        fail(f"sort[skew2_tag]: {launches['merge_path_pairs.i64']} K5 "
             "launches, not ceil(log2 8) = 3")
    want = torch.sort(x).values
    got = torch.cat([out.shards[i, :c]
                     for i, c in enumerate(out.counts.tolist())])
    if out.indices.dtype != torch.int64 or not torch.equal(got, want):
        fail("sort[skew2_tag]: not the sorted input, or not an int64 pack")
    max_count = int(out.counts.max())
    limit = (1 + EPS) * TAGGED_N / P
    if int(out.overflow) or max_count > limit:
        fail(f"sort[skew2_tag]: overflow {int(out.overflow)}, max count "
             f"{max_count} over {limit}")
    del out, got
    med, runs = median_ms(torch, lambda: sort(x, spec), reps=3)
    pack32 = ((x.long() << 28) | torch.arange(TAGGED_N, device="cuda")
              ).to(torch.int32)
    wrong32 = int((torch.sort(pack32).values >> 28 != want).sum())
    del pack32, want
    emit({"measure": "tagged_cell", "n": TAGGED_N, "shards": P,
          "distribution": "SKEW2", "pack_bits": 35, "packing": "int64",
          "launches": launches, "max_count": max_count, "limit": limit,
          "median_ms": med, "runs_ms": runs,
          "keys_per_s": TAGGED_N / (med / 1e3),
          "max_allocated_bytes": peak,
          "int32_pack_wrong_keys": wrong32, "equal": True, "card": card})
    if not wrong32:
        fail("the 35-bit packs cut to int32 still sort right: the check "
             "cannot tell the widths apart")
    return {"sort[skew2_tag]": launches}


def moe_inputs(np):
    """Phi-3.5-MoE routing: 8,000,000 tokens, top-2 of 16 experts, so
    16,000,000 (expert id, token) slots."""
    ids = np.random.default_rng(5).integers(0, 16, N_WEAK).astype(np.int32)
    tokens = np.arange(N_WEAK, dtype=np.int32) // 2
    return ids, tokens


def check_wide_route(name, launches, tensors):
    """The 64-bit route's gate: its searches, samples, sends and merges
    launched the int64 K4s, K6, K7 and K5 and nothing else of the port's
    (its local sorts are torch.sort), every tensor on the card."""
    from repro_torch.kernels import cuda

    check_path_launches(name, launches, cuda.WIDE)
    off = [i for i, t in enumerate(tensors) if t.device.type != "cuda"]
    if off:
        fail(f"{name}: output tensors {off} are not on the card")


def permutation_phase(torch, np, card):
    """sort_kv of the MoE dispatch on the kernels; argsort of wide keys and
    sort of float64 keys on the 64-bit route (torch.sort local sorts, the
    int64 K4s, K5 and K6); argsort of presorted keys under raise and retry.
    Returns the sort_kv and argsort paths' launch counts."""
    from repro_torch.data.distributions import (make_adversarial,
                                                make_distribution)
    from repro_torch.kernels import dispatch
    from repro_torch.sort import SortSpec, argsort, sort, sort_kv

    spec = SortSpec(shards=P, eps=EPS)
    ids, tokens = moe_inputs(np)
    (keys, vals), kv_launches = launched(
        torch, lambda: sort_kv(ids, tokens, spec))
    check_path_launches("sort_kv", kv_launches)
    order = np.argsort(ids, kind="stable")
    if not (np.array_equal(keys, ids[order])
            and np.array_equal(vals, tokens[order])):
        fail("sort_kv: not the stable NumPy order")
    emit({"measure": "permutation", "case": "moe_dispatch_sort_kv",
          "n": N_WEAK, "experts": 16, "top_k": 2, "packing": "int32",
          "launches": kv_launches, "equal": True, "card": card})
    del keys, vals, order

    x = make_distribution("UNIF", N_WEAK, seed=0)
    order, launches = launched(torch, lambda: argsort(x, spec))
    out, more = launched(torch, lambda: sort(
        x, dataclasses.replace(spec, stable=True)))
    check_wide_route("argsort", {k: launches[k] + more[k]
                                 for k in launches},
                     [out.shards, out.counts, out.indices])
    if not np.array_equal(order, np.argsort(x, kind="stable")):
        fail("argsort of the UNIF keys differs from np.argsort")
    argsort_launches = launches
    emit({"measure": "permutation", "case": "argsort_unif_int64_packing",
          "n": N_WEAK, "packing": str(out.indices.dtype),
          "route": {"local_sort": dispatch.route("local_sort", out.indices),
                    "search_merge": dispatch.route("merge_runs",
                                                   out.indices)},
          "launches": launches, "equal": True, "card": card})
    del order, out

    f = np.random.default_rng(6).standard_normal(N_WEAK)
    out, launches = launched(torch, lambda: sort(f, spec))
    check_wide_route("sort[float64]", launches, [out.shards, out.counts])
    if not np.array_equal(out.gather().view(np.int64),
                          np.sort(f).view(np.int64)):
        fail("sort of float64 keys is not bit-equal to np.sort")
    emit({"measure": "permutation", "case": "sort_normal_float64",
          # the core sorts float64 keys as their int64 encoding
          "n": N_WEAK, "route": {
              "local_sort": dispatch.route("local_sort",
                                           out.shards.view(torch.int64)),
              "search_merge": dispatch.route("merge_runs",
                                             out.shards.view(torch.int64))},
          "overflow": int(out.overflow), "launches": launches,
          "equal": True, "card": card})
    del out, f

    x = make_adversarial("PRESORTED", N_WEAK, seed=0)
    try:
        argsort(x, spec)
    except RuntimeError as exc:
        if "dropped" not in str(exc):
            raise
        raised = str(exc)
    else:
        fail("argsort of presorted keys under 'raise' did not raise")
    order = argsort(x, dataclasses.replace(spec, on_overflow="retry"))
    if not np.array_equal(order, np.arange(N_WEAK)):
        fail("argsort of presorted keys under 'retry' is not np.arange")
    emit({"measure": "permutation", "case": "argsort_presorted",
          "n": N_WEAK, "raise": raised[:120], "retry_equal": True,
          "card": card})
    return {"sort_kv": kv_launches, "argsort": argsort_launches}


def recovery_timing_phase(torch, np, card):
    from repro_torch.data.distributions import make_adversarial
    from repro_torch.sort import SortSpec, sort, sort_kv

    x = make_adversarial("PRESORTED", N_WEAK, seed=0)
    for policy in ("retry", "spill"):
        spec = SortSpec(shards=P, eps=EPS, on_overflow=policy)
        med, runs = median_ms(torch, lambda: sort(x, spec))
        emit({"measure": "recovery_e2e_warm", "input": "presorted_int32",
              "n": N_WEAK, "policy": policy, "median_ms": med,
              "runs_ms": runs, "card": card})
        profile_line(torch, lambda: sort(x, spec), card,
                     measure="recovery_profile", input="presorted_int32",
                     policy=policy)
    ids, tokens = moe_inputs(np)
    spec = SortSpec(shards=P, eps=EPS)
    med, runs = median_ms(torch, lambda: sort_kv(ids, tokens, spec))
    emit({"measure": "sort_kv_e2e_warm", "input": "moe_dispatch",
          "n": N_WEAK, "median_ms": med, "runs_ms": runs, "card": card})
    profile_line(torch, lambda: sort_kv(ids, tokens, spec), card,
                 measure="sort_kv_profile", input="moe_dispatch")


def with_comm_log(fn):
    """fn() with the collective seam that `sort.driver.run_batched` (or
    `sort.semisort.top_k`) builds recorded: (result, the last seam's calls
    by "axis:collective")."""
    import importlib

    from repro_torch.sort import driver

    semi = importlib.import_module("repro_torch.sort.semisort")
    made = []
    real = driver.Comm

    def record(p):
        made.append(real(p))
        return made[-1]

    driver.Comm = semi.Comm = record
    try:
        out = fn()
    finally:
        driver.Comm = semi.Comm = real
    return out, {f"{a}:{c}": k for (a, c), k in made[-1].axis_log.items()}


@contextlib.contextmanager
def kernel_shapes(seen: set):
    """While the block runs, add each call of the kernel wrappers to
    `seen` as (counter, rows, n, parameters): the block (K1), the segment
    (K2, counted by role), the distance and flip (K3), the probe count
    (K4s) or, for K5, (counter, rows, k, stride, out_len or 0, whether
    counts were given, whether it fills), for K6 (counter, shards, batch,
    n, splitters, cap, whether the draws are shared, their dtype), for K7
    (counter, shards, batch, n, cap). K4s, K5, K6 and K7 on int64 keys
    are recorded under their `.i64` counters. The wrappers still launch;
    nothing is synchronised."""
    from repro_torch.kernels.bitonic_sort import kernel as BK
    from repro_torch.kernels.histogram import kernel as HK
    from repro_torch.kernels.histogram import ops as hops
    from repro_torch.kernels.merge import kernel as MK
    from repro_torch.kernels.sample import kernel as SK
    from repro_torch.kernels.send import kernel as SEND

    real = {"sort_blocks": BK.sort_blocks,
            "bitonic_merge_smem": BK.bitonic_merge_smem,
            "strided_compare_exchange": MK.strided_compare_exchange,
            "probe_rank_search": HK.probe_rank_search,
            "merge_path_pairs": MK.merge_path_pairs,
            "sample_compact": SK.sample_compact,
            "dense_send": SEND.dense_send}

    def sort_blocks(x, block):
        seen.add(("bitonic_sort_blocks", *x.shape, block))
        return real["sort_blocks"](x, block)

    def bitonic_merge_smem(x, seg, reverse_second_half):
        role = "reverse" if reverse_second_half else "tail"
        seen.add((f"bitonic_merge_smem.{role}", *x.shape, seg))
        return real["bitonic_merge_smem"](x, seg, reverse_second_half)

    def strided_compare_exchange(x, d, flip=False):
        seen.add(("strided_compare_exchange", *x.shape, d, bool(flip)))
        return real["strided_compare_exchange"](x, d, flip)

    def wide(x):
        return ".i64" if x.element_size() == 8 else ""

    def probe_rank_search(keys, probes):
        seen.add(("probe_rank_search" + wide(keys), *keys.shape,
                  probes.shape[1]))
        return real["probe_rank_search"](keys, probes)

    def merge_path_pairs(x, counts=None, out_len=None, *, _fill=True):
        seen.add(("merge_path_pairs" + wide(x), *x.shape, out_len or 0,
                  counts is not None, _fill))
        return real["merge_path_pairs"](x, counts, out_len, _fill=_fill)

    def sample_compact(keys, lo_key, hi_key, satisfied, u, prob, cap):
        seen.add(("sample_compact" + wide(keys), *keys.shape,
                  lo_key.shape[-1], cap, u.dim() == 2, str(u.dtype)))
        return real["sample_compact"](keys, lo_key, hi_key, satisfied, u,
                                      prob, cap)

    def dense_send(keys, starts, counts, cap):
        seen.add(("dense_send" + wide(keys), *keys.shape, cap))
        return real["dense_send"](keys, starts, counts, cap)

    wrappers = {"sort_blocks": sort_blocks,
                "bitonic_merge_smem": bitonic_merge_smem,
                "strided_compare_exchange": strided_compare_exchange,
                "probe_rank_search": probe_rank_search,
                "merge_path_pairs": merge_path_pairs,
                "sample_compact": sample_compact,
                "dense_send": dense_send}
    # every module that holds a wrapper by name, the callers' imports too
    # (dispatch calls K6 and K7 through their modules)
    patched = [(mod, name) for mod in (BK, MK, HK, hops, SK, SEND)
               for name in real if getattr(mod, name, None) is real[name]]
    for mod, name in patched:
        setattr(mod, name, wrappers[name])
    try:
        yield seen
    finally:
        for mod, name in patched:
            setattr(mod, name, real[name])


def merge_path_inputs(torch, keys, gen, sig, device):
    """K5 and its plain version at one recorded signature -> (got, want),
    each output with its merged counts; `keys(*shape)` makes random keys
    of the signature's width. An inner level of merge_sorted_runs (no
    fill) leaves the slots past a merged count unwritten, so they are
    compared as the hi sentinel."""
    from repro_torch.kernels.merge import kernel as MK

    _, rows, k, stride, length, with_counts, fill = sig
    hi = torch.iinfo(keys(1).dtype).max
    counts = (torch.randint(0, stride + 1, (rows, k), generator=gen,
                            device=device, dtype=torch.int32)
              if with_counts else None)
    x = keys(rows, k, stride)
    if with_counts:
        x = torch.where(torch.arange(stride, device=device)
                        < counts[..., None], x, hi)
    x = torch.sort(x, dim=-1).values
    out_len = length or None
    got, got_n = MK.merge_path_pairs(x, counts, out_len, _fill=fill)
    want, want_n = MK.merge_path_pairs_plain(x, counts, out_len)
    if not fill:
        past = (torch.arange(got.shape[-1], device=device)
                >= got_n[..., None])
        got = torch.where(past, hi, got)
    return (torch.cat([got.flatten(), got_n.flatten().to(got.dtype)]),
            torch.cat([want.flatten(), want_n.flatten().to(want.dtype)]))


def sample_compact_inputs(torch, keys, gen, sig, device):
    """K6 and its plain version at one recorded signature -> (got, want),
    the buffer with the counts after it, under two states a signature:
    the first round's (sentinels, nothing satisfied) and one whose
    interval ends are keys drawn from each request's rows, about a third
    of them satisfied. Rows sorted with 0 to 3/8 of each in hi sentinels;
    draws of the signature's shape and dtype; probabilities in (0, 1],
    one of them 1."""
    from repro_torch.kernels.sample import kernel as SK

    _, shards, batch, n, m, cap, shared, u_dtype = sig
    hi = torch.iinfo(keys(1).dtype).max
    lo = torch.iinfo(keys(1).dtype).min
    x = keys(shards, batch, n)
    tails = torch.randint(0, 3 * n // 8 + 1, (shards, batch, 1),
                          generator=gen, device=device)
    x = torch.where(torch.arange(n, device=device) >= n - tails, hi, x)
    x = torch.sort(x, dim=-1).values
    pick = torch.randint(0, n, (batch, 2 * m), generator=gen, device=device)
    ends = torch.sort(torch.gather(x[0], 1, pick), dim=-1).values
    draws = torch.rand((shards, n) if shared else (shards, batch, n),
                       generator=gen, device=device,
                       dtype=getattr(torch, u_dtype.removeprefix("torch.")))
    prob = torch.rand((batch,), generator=gen, device=device)
    prob[0] = 1.0
    states = [(torch.full((batch, m), lo, dtype=x.dtype, device=device),
               torch.full((batch, m), hi, dtype=x.dtype, device=device),
               torch.zeros((batch, m), dtype=torch.bool, device=device)),
              (ends[:, 0::2].contiguous(), ends[:, 1::2].contiguous(),
               torch.rand((batch, m), generator=gen, device=device) < 1 / 3)]
    got, want = [], []
    for state in states:
        for out, fn in ((got, SK.sample_compact),
                        (want, SK.sample_compact_plain)):
            vals, sampled, over = fn(x, *state, draws, prob, cap)
            out += [vals.flatten(), sampled.flatten().to(x.dtype),
                    over.flatten().to(x.dtype)]
    return torch.cat(got), torch.cat(want)


def path_shapes_phase(torch, seen: set, card, device="cuda"):
    """Phase 12: each kernel against its plain version, exactly, at every
    (rows, n, parameters) that the main paths called it with (`seen`, from
    `kernel_shapes`): K1, K2's tail and K3 on random keys, K2's reverse
    role on sorted runs of half a segment, K4s on sorted rows whose tails
    hold 0 to 3/8 of the row in hi sentinels (the padded rows of
    multistage's stage 2 and the exchanges) against probes drawn half from
    the row, some hi sentinels among them, K5 on sorted runs holding a
    random count of keys each (the hi sentinel past it; without counts,
    whole runs), K6 on sorted rows with sentinel tails under two states
    (`sample_compact_inputs`), K7 on sorted rows with sentinel tails cut
    by splitters drawn from them (`send_inputs`), the counts cut at the
    signature's cap; K4s, K5, K6 and K7 at an `.i64` counter's signatures
    on int64 keys, INT64_MAX the sentinel. Returns the (rows, n) checked
    for each counter ((rows, k, stride) for K5, (shards, batch, n) for K6
    and K7)."""
    from repro_torch.kernels.bitonic_sort import kernel as BK
    from repro_torch.kernels.histogram import kernel as HK
    from repro_torch.kernels.merge import kernel as MK
    from repro_torch.kernels.send import kernel as SEND

    gen = torch.Generator(device=device)
    gen.manual_seed(1)

    def keys(*shape):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                             device=device, dtype=torch.int32)

    def wide_keys(*shape):
        return torch.randint(-2 ** 63, 2 ** 63 - 1, shape, generator=gen,
                             device=device, dtype=torch.int64)

    def search_inputs(keys, rows, n, m):
        hi = torch.iinfo(keys(1).dtype).max
        k = torch.sort(keys(rows, n), dim=-1).values
        for r in range(rows):
            tail = (r % 4) * n // 8
            if tail:
                k[r, n - tail:] = hi
        pick = torch.randint(0, n, (rows, m - m // 2), generator=gen,
                             device=device)
        q = torch.cat([torch.gather(k, 1, pick), keys(rows, m // 2)], dim=1)
        q[:, :m // 8] = hi
        return k, torch.sort(q, dim=-1).values

    t0 = time.perf_counter()
    shapes = {}
    for sig in sorted(seen):
        counter, rows, n = sig[:3]
        kind = counter.removesuffix(".i64")
        of_width = wide_keys if kind != counter else keys
        if counter == "bitonic_sort_blocks":
            x = keys(rows, n)
            got, want = BK.sort_blocks(x, sig[3]), BK.sort_blocks_plain(
                x, sig[3])
        elif counter.startswith("bitonic_merge_smem"):
            seg, reverse = sig[3], counter.endswith("reverse")
            x = keys(rows, n)
            if reverse:
                x = torch.sort(x.view(rows, -1, seg // 2),
                               dim=-1).values.view(rows, n)
            got = BK.bitonic_merge_smem(x, seg, reverse)
            want = BK.bitonic_merge_plain(x, seg, reverse)
        elif counter == "strided_compare_exchange":
            x = keys(rows, n)
            got = MK.strided_compare_exchange(x, *sig[3:])
            want = MK.strided_compare_exchange_plain(x, *sig[3:])
        elif kind == "probe_rank_search":
            k, q = search_inputs(of_width, rows, n, sig[3])
            got = HK.probe_rank_search(k, q)
            want = HK.probe_ranks_search_plain(k, q)
        elif kind == "merge_path_pairs":
            got, want = merge_path_inputs(torch, of_width, gen, sig, device)
        elif kind == "sample_compact":
            got, want = sample_compact_inputs(torch, of_width, gen, sig,
                                              device)
        elif kind == "dense_send":
            x, starts, counts = send_inputs(torch, of_width, gen, sig[1:4])
            args = (x, starts, torch.clamp(counts, max=sig[4]), sig[4])
            got, want = SEND.dense_send(*args), SEND.dense_send_plain(*args)
            del x, starts, counts, args
        else:
            fail(f"path_shapes_phase: no inputs for {counter}")
        if not torch.equal(got, want):
            fail(f"{counter}{list(sig[1:])} disagrees with its plain "
                 "version at a main path's shape")
        shapes.setdefault(counter, set()).add(
            tuple(sig[1:4]) if kind in ("merge_path_pairs", "sample_compact",
                                        "dense_send")
            else (rows, n))
        del got, want
    emit({"measure": "path_shapes", "checked": len(seen),
          "seconds": time.perf_counter() - t0,
          "signatures": {c: [list(s[1:]) for s in sorted(seen) if s[0] == c]
                         for c in sorted(shapes)},
          "card": card})
    return {c: sorted(map(list, v)) for c, v in shapes.items()}


def baselines_phase(torch, np, card):
    """Phase 10: the four other algorithms and the ragged exchange on the
    WEAK_SCALING keys, ragged on PRESORTED keys, and the batched cell
    under each algorithm; returns each path's launch counts."""
    from repro_torch.data.distributions import (make_adversarial,
                                                make_distribution)
    from repro_torch.kernels.merge import ops as mops
    from repro_torch.sort import SortSpec, sort, sort_batched

    x = make_distribution("UNIF", N_WEAK, seed=0)
    want = np.sort(x)
    limit = (1 + EPS) * N_WEAK / P + 1
    paths = {}
    for algo in BASELINES:
        spec = SortSpec(shards=P, eps=EPS, algorithm=algo)
        (out, comm), launches = launched(
            torch, lambda: with_comm_log(lambda: sort(x, spec)))
        path = f"sort[{algo}]"
        paths[path] = launches
        check_path_launches(path, launches, PATH_KERNELS[algo])
        counts = out.counts.cpu().numpy()
        overflow = int(out.overflow)
        n_sat = int(out.stats.n_satisfied[0])
        if (algo == "multistage" or (algo == "ams" and n_sat == P - 1)) \
                and counts.max() > limit:
            fail(f"{path}: max count {counts.max()} past {limit}")
        ref = sort(x, dataclasses.replace(spec, kernel_policy="torch"))
        if not same_as_torch_policy(torch, out, ref):
            fail(f"{path}: kernel and torch policies disagree")
        raise_exact = bool(np.array_equal(out.gather(), want))
        del out, ref
        retried = sort(x, dataclasses.replace(spec, on_overflow="retry"))
        if int(retried.overflow) or not np.array_equal(retried.gather(),
                                                       want):
            fail(f"{path}: retry is not equal to np.sort")
        emit({"measure": "baseline", "algorithm": algo, "n": N_WEAK,
              "raise_overflow": overflow, "raise_exact": raise_exact,
              "max_count": int(counts.max()), "limit": limit,
              "n_satisfied": n_sat, "comm_log": comm, "launches": launches,
              "policies_agree": True,
              "retry": dataclasses.asdict(retried.recovery),
              "card": card})
        del retried

    spec = SortSpec(shards=P, eps=EPS, exchange="ragged")
    mops.ragged_branches.clear()
    (out, comm), launches = launched(
        torch, lambda: with_comm_log(lambda: sort(x, spec)))
    branches = dict(mops.ragged_branches)
    if branches != {"merge_tree": 1}:
        fail(f"sort[ragged]: the merge took {branches}; every run fits "
             "the slot, so the merge tree must run once")
    paths["sort[ragged]"] = launches
    check_path_launches("sort[ragged]", launches, PATH_KERNELS["ragged"])
    counts = out.counts.cpu().numpy()
    if (int(out.overflow) or counts.max() > limit
            or not np.array_equal(out.gather(), want)):
        fail(f"sort[ragged]: overflow {int(out.overflow)}, max count "
             f"{counts.max()}, or not equal to np.sort")
    for other in (dataclasses.replace(spec, exchange="allgather"),
                  dataclasses.replace(spec, kernel_policy="torch")):
        if not same_as_torch_policy(torch, out, sort(x, other)):
            fail(f"sort[ragged]: differs from {other.exchange}, "
                 f"{other.kernel_policy}")
    emit({"measure": "ragged", "input": "weak_scaling_int32", "n": N_WEAK,
          "overflow": 0, "max_count": int(counts.max()), "limit": limit,
          "comm_log": comm, "launches": launches, "branches": branches,
          "equal_to_allgather": True, "policies_agree": True,
          "card": card})
    del out, want

    y = make_adversarial("PRESORTED", N_WEAK, seed=0)
    mops.ragged_branches.clear()
    out, launches = launched(torch, lambda: sort(y, spec))
    branches = dict(mops.ragged_branches)
    if branches != {"full_sort": 1}:
        fail(f"sort[ragged] presorted: the merge took {branches}; each "
             "shard's run outgrows the slot, so the full sort must run once")
    paths["sort[ragged,presorted]"] = launches
    check_path_launches("sort[ragged,presorted]", launches,
                        PATH_KERNELS["ragged_presorted"])
    counts = out.counts.cpu().numpy()
    if (int(out.overflow) or counts.max() > limit
            or not np.array_equal(out.gather(), np.sort(y))):
        fail(f"sort[ragged] presorted: overflow {int(out.overflow)}, max "
             f"count {counts.max()}, or not equal to np.sort")
    emit({"measure": "ragged", "input": "presorted_int32", "n": N_WEAK,
          "overflow": 0, "max_count": int(counts.max()), "limit": limit,
          "launches": launches, "branches": branches, "card": card})
    del out, y

    xs = batched_inputs(np)
    sorted_rows = np.sort(xs, axis=1)
    for algo in BASELINES:
        spec = SortSpec(shards=P, eps=EPS, algorithm=algo,
                        on_overflow="retry")
        out, launches = launched(torch, lambda: sort_batched(xs, spec))
        path = f"sort_batched[{algo}]"
        paths[path] = launches
        check_path_launches(path, launches, PATH_KERNELS[algo])
        for b in range(B):
            if not np.array_equal(out.gather(b), sorted_rows[b]):
                fail(f"{path}: request {b} differs from np.sort")
        untagged = SortSpec(shards=P, eps=EPS, algorithm=algo, tag=False)
        batched = sort_batched(xs, untagged)
        for b in range(B):
            one, view = sort(xs[b], untagged), batched.request(b)
            if not all(torch.equal(getattr(view, f), getattr(one, f))
                       for f in ("shards", "counts", "splitter_keys",
                                 "overflow")):
                fail(f"{path}: row {b} differs from sort() of that row "
                     "(tag=False)")
        emit({"measure": "baseline_batched", "algorithm": algo, "batch": B,
              "n": N_REQ, "retry": dataclasses.asdict(out.recovery),
              "raise_overflow": batched.overflow.cpu().tolist(),
              "max_count": int(out.counts.max()), "launches": launches,
              "rows_equal_sort_untagged": True, "card": card})
    return paths


def baselines_timing_phase(torch, np, card):
    """Phase 11: each algorithm's warm sort beside HSS's, HSS+ragged; a
    profile and the peak memory of multistage and of ragged."""
    from repro_torch.data.distributions import make_distribution
    from repro_torch.sort import SortSpec, sort

    x = make_distribution("UNIF", N_WEAK, seed=0)
    cases = [("hss", "dense"), ("hss", "ragged")] + [
        (algo, "dense") for algo in BASELINES]
    for algo, exchange in cases:
        spec = SortSpec(shards=P, eps=EPS, algorithm=algo,
                        exchange=exchange)
        med, runs = median_ms(torch, lambda: sort(x, spec))
        emit({"measure": "baseline_e2e_warm", "input": "weak_scaling_int32",
              "algorithm": algo, "exchange": exchange, "median_ms": med,
              "runs_ms": runs, "card": card})
    for algo, exchange in (("multistage", "dense"), ("hss", "ragged")):
        spec = SortSpec(shards=P, eps=EPS, algorithm=algo,
                        exchange=exchange)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sort(x, spec)
        torch.cuda.synchronize()
        profile_line(torch, lambda: sort(x, spec), card,
                     measure="baseline_profile", input="weak_scaling_int32",
                     algorithm=algo, exchange=exchange,
                     max_allocated_bytes=torch.cuda.max_memory_allocated())


def audit_fields(np, out) -> dict:
    """An output's audit and recovery record as JSON fields."""
    a = out.audit
    return {"audit_ok": a.ok, "count": np.asarray(a.count).tolist(),
            "achieved_imbalance": np.asarray(
                a.achieved_imbalance).tolist(),
            "recovery": dataclasses.asdict(out.recovery)}


def verify_phase(torch, np, card):
    """Phase 13: the fused audit on the main paths at full width; returns
    each audited path's launch counts."""
    from repro_torch.data.distributions import make_distribution
    from repro_torch.sort import SortSpec, sort, sort_batched

    x = make_distribution("UNIF", N_WEAK, seed=0)
    want = np.sort(x)
    limit = 1 + EPS + P / N_WEAK
    paths = {}
    spec = SortSpec(shards=P, eps=EPS)
    off, off_launches = launched(torch, lambda: sort(x, spec))
    for tier in ("cheap", "full"):
        tspec = dataclasses.replace(spec, verify=tier)
        (out, comm), launches = launched(
            torch, lambda: with_comm_log(lambda: sort(x, tspec)))
        path = f"sort[verify={tier}]"
        paths[path] = launches
        check_path_launches(path, launches)
        a = out.audit
        imb = float(a.achieved_imbalance)
        if not (a.ok and int(a.count) == N_WEAK and imb <= limit):
            fail(f"{path}: audit {a.describe()}, count {a.count}, "
                 f"imbalance {imb} (limit {limit})")
        if launches != off_launches:
            fail(f"{path}: the audit launched kernels: {launches} against "
                 f"{off_launches} unaudited")
        if not same_as_torch_policy(torch, out, off):
            fail(f"{path}: shards or counts differ from verify='off'")
        ref = sort(x, dataclasses.replace(tspec, kernel_policy="torch"))
        if not torch.equal(out._audit_vec, ref._audit_vec):
            fail(f"{path}: the audit vector differs under the torch policy")
        if out.recovery.verify_fallback or not np.array_equal(out.gather(),
                                                              want):
            fail(f"{path}: fell back, or not equal to np.sort")
        emit({"measure": "verify", "input": "weak_scaling_int32",
              "tier": tier, "n": N_WEAK, "limit": limit,
              "audit_vec": out._audit_vec.cpu().tolist()[0],
              "comm_log": comm, "launches": launches,
              "launches_equal_unaudited": True, "torch_policy_vec_equal": True,
              **audit_fields(np, out), "card": card})
        del out, ref
    del off

    f = np.random.default_rng(1).standard_normal(N_WEAK).astype(np.float32)
    fspec = dataclasses.replace(spec, verify="cheap")
    out, launches = launched(torch, lambda: sort(f, fspec))
    paths["sort[verify=cheap,float32]"] = launches
    check_path_launches("sort[verify=cheap,float32]", launches)
    if not (out.audit.ok and int(out.audit.count) == N_WEAK
            and not out.recovery.verify_fallback
            and np.array_equal(out.gather().view(np.int32),
                               np.sort(f).view(np.int32))):
        fail(f"sort[verify=cheap,float32]: {out.audit.describe()}")
    emit({"measure": "verify", "input": "normal_float32", "tier": "cheap",
          "n": N_WEAK, "launches": launches, **audit_fields(np, out),
          "card": card})
    del out, f

    xs = batched_inputs(np)
    out, launches = launched(torch, lambda: sort_batched(xs, fspec))
    paths["sort_batched[verify=cheap]"] = launches
    check_path_launches("sort_batched[verify=cheap]", launches)
    a = out.audit
    if not (np.all(a.row_ok) and np.all(a.count == N_REQ)
            and not out.recovery.verify_fallback):
        fail(f"sort_batched[verify=cheap]: {a.describe()}")
    check_batched(np, "sort_batched[verify=cheap]", out, xs)
    emit({"measure": "verify_batched", "input": "unif_int32", "tier": "cheap",
          "batch": B, "n": N_REQ, "row_ok": np.asarray(a.row_ok).tolist(),
          "launches": launches, **audit_fields(np, out), "card": card})
    return paths


def corruption_phase(torch, np, card):
    """Phase 14: injected bit flips caught and recovered."""
    from repro_torch.data.distributions import make_distribution
    from repro_torch.runtime import chaos
    from repro_torch.sort import (BatchVerificationError, SortSpec,
                                  VerificationError, sort, sort_batched)

    x = make_distribution("UNIF", N_WEAK, seed=0)
    want = np.sort(x)
    spec = SortSpec(shards=P, eps=EPS, verify="cheap",
                    on_verify_failure="retry")
    paths = {}
    for corrupt_at, fallback in (((0,), False), ((0, 1), True)):
        with chaos.activate(chaos.FaultPlan(corrupt_at=corrupt_at)):
            out, launches = launched(torch, lambda: sort(x, spec))
            stats = chaos.stats()
        r = out.recovery
        path = f"sort[corrupt_at={list(corrupt_at)}]"
        paths[path] = launches
        check_path_launches(path, launches)
        if not (out.audit.ok and np.array_equal(out.gather(), want)
                and r.verify_failures == len(corrupt_at)
                and r.verify_retries == 1 and r.verify_fallback == fallback):
            fail(f"{path}: {r}")
        emit({"measure": "corruption", "corrupt_at": list(corrupt_at),
              "policy": "retry", "exact": True, "chaos_stats": stats,
              "launches": launches, **audit_fields(np, out), "card": card})
        del out
    with chaos.activate(chaos.FaultPlan(corrupt_at=True)):
        try:
            sort(x, spec)
        except VerificationError as exc:
            raised = str(exc)
        else:
            fail("corrupt_at=True: no VerificationError")
        stats = chaos.stats()
    emit({"measure": "corruption", "corrupt_at": True, "policy": "retry",
          "raised": raised[:160], "chaos_stats": stats, "card": card})

    xs = batched_inputs(np)
    row = 3
    others = np.delete(xs, row, axis=0)
    key = next(int(k) for k in xs[row] if not np.isin(k, others))
    bspec = SortSpec(shards=P, eps=EPS, verify="cheap")
    with chaos.activate(chaos.FaultPlan(corrupt_at=True, corrupt_key=key)):
        try:
            sort_batched(xs, bspec)
        except BatchVerificationError as exc:
            err = exc
        else:
            fail("corrupt_key: no BatchVerificationError")
        stats = chaos.stats()
    bad = np.flatnonzero(~err.row_ok).tolist()
    if bad != [row]:
        fail(f"corrupt_key: rows {bad} failed, want [{row}]")
    for b in range(B):
        if b != row and not np.array_equal(err.output.gather(b),
                                           np.sort(xs[b])):
            fail(f"corrupt_key: clean row {b} differs from np.sort")
    emit({"measure": "corruption_batched", "corrupt_key": key, "row": row,
          "row_ok": err.row_ok.tolist(), "clean_rows_exact": True,
          "chaos_stats": stats, "card": card})
    return paths


#: Phase 15's clamp: below the about 250,000 keys each (source,
#: destination) pair carries on the WEAK_SCALING keys (N / p^2).
CLAMP_PAIR_CAP = 200_000


def clamp_phase(torch, np, card):
    """Phase 15: a capacity clamp below the pairs' load, under retry."""
    from repro_torch.data.distributions import make_distribution
    from repro_torch.runtime import chaos
    from repro_torch.sort import SortSpec, sort

    x = make_distribution("UNIF", N_WEAK, seed=0)
    spec = SortSpec(shards=P, eps=EPS, on_overflow="retry")
    with chaos.activate(chaos.FaultPlan(clamp_pair_cap=CLAMP_PAIR_CAP)):
        out, launches = launched(torch, lambda: sort(x, spec))
        stats = chaos.stats()
    r = out.recovery
    check_path_launches("sort[clamp]", launches)
    if not (r.recovered_overflow > 0 and int(out.overflow) == 0
            and np.array_equal(out.gather(), np.sort(x))):
        fail(f"sort[clamp]: {r}, overflow {int(out.overflow)}")
    emit({"measure": "clamp", "clamp_pair_cap": CLAMP_PAIR_CAP, "n": N_WEAK,
          "recovery": dataclasses.asdict(r), "chaos_stats": stats,
          "exact": True, "launches": launches, "card": card})
    return {"sort[clamp]": launches}


#: The SLO phase's inputs, each under an overflow policy that makes it
#: exact and balanced. ZIPF_HH's untagged first attempt piles its heaviest
#: key on one shard, past the spill channel's out_cap, so it needs retry's
#: larger buffers. ALL_EQUAL is tagged from the start (its keys become
#: their indices, a presorted input) and needs spill: retry warm-starts
#: from the failed attempt's splitter keys, which lose their tag bits in
#: the decode, and ends with every key on one shard (the reference's
#: behaviour too; ROADMAP queue 3).
SLO_INPUTS = {"ALL_EQUAL": "spill", "ZIPF_HH": "retry", "PRESORTED": "spill",
              "REVERSE": "retry", "SAWTOOTH": "retry"}


def slo_phase(torch, np, card):
    """Phase 16: the imbalance SLO on the adversarial family at 16M."""
    from repro_torch.data.distributions import (make_adversarial,
                                                make_distribution)
    from repro_torch.sort import ImbalanceError, SortSpec, sort

    paths = {}
    spec = SortSpec(shards=P, eps=EPS, verify="cheap", imbalance_slo=1.2)
    for name, policy in SLO_INPUTS.items():
        x = make_adversarial(name, N_WEAK, seed=0)
        pspec = dataclasses.replace(spec, on_overflow=policy)
        out, launches = launched(torch, lambda: sort(x, pspec))
        r = out.recovery
        path = f"sort[slo,{name}]"
        paths[path] = launches
        # a tag rung that packs int64 searches, samples and merges on the
        # int64 K4s, K6 and K5 after the untagged attempts' int32 kernels
        wide = out.indices is not None and out.indices.dtype == torch.int64
        check_path_launches(path, launches, HSS + WIDE if wide else None)
        if not (out.audit.ok and r.achieved_imbalance <= 1.2
                and np.array_equal(out.gather(), np.sort(x))):
            fail(f"{path}: {r}")
        emit({"measure": "slo", "input": name, "n": N_WEAK, "slo": 1.2,
              "policy": policy, "rung": r.imbalance_recovery,
              "tagged": out.indices is not None,
              "packing": None if out.indices is None
              else str(out.indices.dtype),
              "launches": launches, **audit_fields(np, out), "card": card})
        del out, x

    # out_slack 8: eight times the (1+eps) output buffers, 8 x 16,800,008
    # int32 keys, so the exact allgather exchange holds the whole input on
    # one shard and the audit passes: what fails is the SLO alone
    x = make_adversarial("ALL_EQUAL", N_WEAK, seed=0)
    espec = dataclasses.replace(spec, tag=False, out_slack=8.0,
                                exchange="allgather", on_overflow="raise")
    emit({"measure": "slo_memory_reckoned",
          "out_buffer_bytes": P * espec.exchange_config().out_cap(
              N_LOCAL, P, EPS) * 4, "card": card})

    def raises():
        try:
            sort(x, espec)
        except ImbalanceError as exc:
            return exc
        fail("ALL_EQUAL with tag=False: no ImbalanceError")

    (err, launches), peak = peak_run(torch, lambda: launched(torch, raises))
    paths["sort[slo,ALL_EQUAL,tag=False]"] = launches
    check_path_launches("sort[slo,ALL_EQUAL,tag=False]", launches,
                        HSS_EXACT)
    emit({"measure": "slo_error", "input": "ALL_EQUAL", "tag": False,
          "out_slack": 8.0, "achieved": err.achieved, "slo": err.slo,
          "launches": launches, "max_allocated_bytes": peak, "card": card})
    del x

    # the refine rung: one round of 8 samples a shard misses 1.1; tagging
    # is off, so the bonus refinement (3 rounds, 16 samples) must meet it
    x = make_distribution("UNIF", N_WEAK, seed=0)
    rspec = SortSpec(shards=P, eps=EPS, rounds=1, sample_per_shard=8,
                     tag=False, verify="cheap", exchange="allgather",
                     out_slack=8.0)
    first = sort(x, rspec)
    miss = first.recovery.achieved_imbalance
    del first
    out, launches = launched(torch, lambda: sort(
        x, dataclasses.replace(rspec, imbalance_slo=1.1)))
    r = out.recovery
    paths["sort[slo,refine]"] = launches
    check_path_launches("sort[slo,refine]", launches, HSS_EXACT)
    if not (miss > 1.1 and r.imbalance_recovery == "refine"
            and r.achieved_imbalance <= 1.1 and out.audit.ok
            and np.array_equal(out.gather(), np.sort(x))):
        fail(f"refine rung: first attempt {miss}, then {r}")
    emit({"measure": "slo_refine", "input": "weak_scaling_int32",
          "rounds": 1, "sample_per_shard": 8, "slo": 1.1,
          "first_attempt_imbalance": miss, "launches": launches,
          **audit_fields(np, out), "card": card})
    return paths


def grouping_phase(torch, np, card):
    """Phase 17: semisort, groupby_aggregate, top_k, their batched forms
    and counting_dispatch at full width."""
    from repro_torch.data.distributions import (make_adversarial,
                                                make_distribution)
    from repro_torch.sort import (SortSpec, groupby_aggregate, semisort,
                                  semisort_batched, top_k, top_k_batched)
    from repro_torch.sort.grouping import counting_dispatch

    paths = {}
    spec = SortSpec(shards=P, eps=EPS)
    z = make_adversarial("ZIPF_HH", N_WEAK, seed=0)
    (out, comm), launches = launched(
        torch, lambda: with_comm_log(lambda: semisort(z, spec=spec)))
    paths["semisort"] = launches
    check_path_launches("semisort", launches, PATH_KERNELS["semisort"])
    keys, counts = out.groups()
    uk, uc = np.unique(z, return_counts=True)
    if not (np.array_equal(keys, uk) and np.array_equal(counts, uc)):
        fail("semisort: groups differ from np.unique")
    light = out.light
    shards, n = light.shards.cpu().numpy(), light.counts.cpu().numpy()
    edges = [(shards[s, 0], shards[s, n[s] - 1]) for s in range(P) if n[s]]
    if any(a[1] >= b[0] for a, b in zip(edges, edges[1:])) or np.isin(
            out.heavy_keys, light.gather()).any():
        fail("semisort: a key lies on two shards, or heavy among lights")
    emit({"measure": "semisort", "input": "zipf_hh_int32", "n": N_WEAK,
          "heavy_keys": out.heavy_keys.tolist(),
          "heavy_counts": out.heavy_counts.tolist(),
          "heavy_total": out.heavy_total(), "light_overflow":
          int(out.overflow), "groups": int(keys.shape[0]),
          "comm_log": comm, "launches": launches, "card": card})
    del out, light

    ids, _ = moe_inputs(np)
    v = np.random.default_rng(7).standard_normal(N_WEAK).astype(np.float32)
    order = np.argsort(ids, kind="stable")
    uk, starts = np.unique(ids[order], return_index=True)
    want = {"count": np.diff(np.append(starts, N_WEAK)),
            "sum": np.add.reduceat(v[order].astype(np.float64), starts),
            "max": np.maximum.reduceat(v[order], starts)}
    for op in ("count", "sum", "max"):
        (k, agg), launches = launched(torch, lambda: groupby_aggregate(
            ids, None if op == "count" else v, op=op, spec=spec))
        path = f"groupby_aggregate[{op}]"
        paths[path] = launches
        check_path_launches(path, launches, PATH_KERNELS[path])
        if not (np.array_equal(k, uk) and np.array_equal(agg, want[op])):
            fail(f"{path}: differs from NumPy")
        emit({"measure": "groupby", "input": "moe_expert_ids", "op": op,
              "n": N_WEAK, "groups": int(k.shape[0]), "equal": True,
              "launches": launches, "card": card})
    heavy = semisort(ids, spec=spec)
    if heavy.heavy_keys.size != 16 or heavy.light.gather().size:
        fail(f"groupby count: {heavy.heavy_keys.size} heavy experts of 16")
    del heavy, order

    f = np.random.default_rng(1).standard_normal(N_WEAK).astype(np.float32)
    for name, x in (("weak_scaling_int32",
                     make_distribution("UNIF", N_WEAK, seed=0)),
                    ("normal_float32", f)):
        (top, comm), launches = launched(
            torch, lambda: with_comm_log(lambda: top_k(x, 1024, spec)))
        paths[f"top_k[{name}]"] = launches
        check_path_launches(f"top_k[{name}]", launches, PATH_KERNELS["top_k"])
        want_top = np.sort(x)[-1024:][::-1]
        if not np.array_equal(top, want_top):
            fail(f"top_k[{name}]: differs from np.sort")
        if comm != {"sort:all_gather": 1}:
            fail(f"top_k[{name}]: collectives {comm}, want one all_gather")
        emit({"measure": "top_k", "input": name, "n": N_WEAK, "k": 1024,
              "comm_log": comm, "launches": launches, "card": card})

    xs = batched_inputs(np)
    out, launches = launched(torch, lambda: semisort_batched(xs, spec))
    paths["semisort_batched"] = launches
    check_path_launches("semisort_batched", launches,
                        PATH_KERNELS["semisort"])
    tops = top_k_batched(xs, 1024, spec)
    for b in range(B):
        one, view = semisort(xs[b], spec=spec), out.request(b)
        if not (np.array_equal(view.heavy_keys, one.heavy_keys)
                and torch.equal(view.light.shards, one.light.shards)
                and torch.equal(view.light.counts, one.light.counts)):
            fail(f"semisort_batched: row {b} differs from semisort()")
        if not np.array_equal(tops[b], top_k(xs[b], 1024, spec)):
            fail(f"top_k_batched: row {b} differs from top_k()")
    emit({"measure": "grouping_batched", "batch": B, "n": N_REQ,
          "rows_equal_single": True, "launches": launches, "card": card})
    del out

    # the one-hot cumsum: (16M, 17) int32 beside its (16M, 17) bool mask
    cap = int(1.25 * N_WEAK / 16)
    emit({"measure": "counting_dispatch_memory_reckoned",
          "onehot_bytes": N_WEAK * 17, "cumsum_bytes": N_WEAK * 17 * 4,
          "card": card})
    dev_ids = torch.from_numpy(ids).cuda()
    (got, launches), peak = peak_run(torch, lambda: launched(
        torch, lambda: counting_dispatch(dev_ids, 16, cap)))
    paths["counting_dispatch"] = launches
    check_path_launches("counting_dispatch", launches,
                        PATH_KERNELS["counting_dispatch"])
    ref = counting_dispatch(dev_ids, 16, cap, method="argsort")
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        fail("counting_dispatch: counting and argsort methods differ")
    emit({"measure": "counting_dispatch", "n": N_WEAK, "experts": 16,
          "capacity": cap, "kept": int(got[2].sum()),
          "equal_to_argsort": True, "launches": launches,
          "max_allocated_bytes": peak, "card": card})
    return paths


def grouping_timing_phase(torch, np, card):
    """Phase 18: the audit's cost, semisort and top_k against sort, and a
    profile and peak memory of a warm verify="full" and semisort call."""
    from repro_torch.data.distributions import (make_adversarial,
                                                make_distribution)
    from repro_torch.sort import SortSpec, semisort, sort, top_k

    x = make_distribution("UNIF", N_WEAK, seed=0)
    z = make_adversarial("ZIPF_HH", N_WEAK, seed=0)
    spec = SortSpec(shards=P, eps=EPS)
    tiers = {tier: dataclasses.replace(spec, verify=tier)
             for tier in ("off", "cheap", "full")}
    for measure, inp, fns, extra in (
            ("verify_e2e_warm", "weak_scaling_int32",
             {t: (lambda s=s: sort(x, s)) for t, s in tiers.items()}, {}),
            ("semisort_e2e_warm", "zipf_hh_int32",
             {"semisort": lambda: semisort(z, spec=spec),
              "sort": lambda: sort(z, spec)}, {}),
            ("top_k_e2e_warm", "weak_scaling_int32",
             {"top_k": lambda: top_k(x, 1024, spec),
              "sort": lambda: sort(x, spec)}, {"k": 1024})):
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        timed = medians_in_turns(torch, fns)
        retries = torch.cuda.memory_stats().get("num_alloc_retries",
                                                0) - retries
        for name, (med, runs) in timed.items():
            emit({"measure": measure, "input": inp, "call": name,
                  "median_ms": med, "runs_ms": runs, "in_turns": True,
                  "alloc_retries": retries, **extra, "card": card})
    full = dataclasses.replace(spec, verify="full")
    for name, fn in (("sort[verify=full]", lambda: sort(x, full)),
                     ("semisort", lambda: semisort(z, spec=spec))):
        _, peak = peak_run(torch, fn)
        profile_line(torch, fn, card, measure="grouping_profile", call=name,
                     max_allocated_bytes=peak)


#: Phases 19-22: the service at the batched cell's width. Each kind's
#: kernels, from the code: sort, sort_kv (4 key + 21 tag bits: int32
#: packing) and semisort run the HSS path's eight; top_k sorts and merges,
#: ranking and sending nothing; argsort of UNIF keys (30 + 21 bits) packs
#: int64: its local sorts are torch.sort, its searches, samples, sends and
#: merges the int64 K4s, K6, K7 and K5 (`cuda.WIDE`); the mixed window is
#: their union. bucket_lengths' 11 key bits (lengths 16..2,048) and 20 tag
#: bits (1,048,576 documents) are over int32's 30, so it packs int64: the
#: int64 K4s, K6 and K5 over the exact allgather exchange, so no K7. The
#: corrupt drill's degraded path sorts each request alone, under its own
#: spec (HSS on int32 keys over the allgather exchange, audited): the HSS
#: path's seven but K7.
SERVE_KINDS = ("sort", "sort_kv", "semisort", "top_k", "argsort")
PATH_KERNELS.update({"serve[sort]": HSS, "serve[sort_kv]": HSS,
                     "serve[semisort]": HSS, "serve[top_k]": MERGING,
                     "serve[argsort]": WIDE, "serve[mixed]": HSS + WIDE,
                     "serve[http]": HSS, "serve[degraded]": HSS_EXACT,
                     "bucket_lengths": tuple(k for k in WIDE
                                             if k != "dense_send.i64")})
SERVE_LOAD = 16              # two full batches of max_batch = B
MIXED_LOAD = 64
HTTP_N = 262_144             # JSON bodies of a few MB
TOP_K = 1024
CHAOS_CLAMP = 20_000         # a pair carries N_REQ / P^2 = 31,250 keys
CORRUPT_COOLDOWN_S = 10.0    # the open breaker outlasts a request by far
DOCS = 1 << 20
SERVE_DEVICE = "cuda"        # where phases 19-22 run


def serve_inputs(np, kind: str, count: int, first: int = 0):
    """`count` requests of N_REQ keys for one kind (seeds first..): UNIF
    int32 (sort, top_k, argsort), Phi-3.5-MoE's expert ids in [0, 16)
    with the slot index as the value (sort_kv), ZIPF_HH (semisort)."""
    from repro_torch.data.distributions import (make_adversarial,
                                                make_distribution)

    out = []
    for s in range(first, first + count):
        if kind == "sort_kv":
            x = np.random.default_rng(100 + s).integers(
                0, 16, N_REQ).astype(np.int32)
        elif kind == "semisort":
            x = make_adversarial("ZIPF_HH", N_REQ, seed=s)
        else:
            x = make_distribution("UNIF", N_REQ, seed=s)
        out.append(x)
    return out


def check_served(np, kind: str, x, got):
    """One served result against NumPy: sort and top_k by value, sort_kv
    and argsort in the stable order, semisort as groups (equal keys
    contiguous, the np.unique counts)."""
    if kind == "sort":
        ok = np.array_equal(got, np.sort(x))
    elif kind == "top_k":
        ok = np.array_equal(got, np.sort(x)[::-1][:TOP_K])
    elif kind == "argsort":
        ok = np.array_equal(got, np.argsort(x, kind="stable"))
    elif kind == "sort_kv":
        order = np.argsort(x, kind="stable")
        ok = (np.array_equal(got[0], x[order])
              and np.array_equal(got[1], np.arange(x.shape[0])[order]))
    else:
        keys, counts = np.unique(got, return_counts=True)
        uk, uc = np.unique(x, return_counts=True)
        runs = 1 + int(np.count_nonzero(got[1:] != got[:-1]))
        ok = (np.array_equal(keys, uk) and np.array_equal(counts, uc)
              and runs == uk.shape[0])
    if not ok:
        fail(f"serve[{kind}]: a served result differs from NumPy")


def submit_all(runner, np, reqs):
    """Every (kind, x) at once from a thread a request -> (results in
    order, each request's latency in ms, the wall seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    def one(req):
        kind, x = req
        t0 = time.perf_counter()
        out = runner.submit(
            x, kind=kind,
            values=np.arange(x.shape[0], dtype=np.int32)
            if kind == "sort_kv" else None,
            param=TOP_K if kind == "top_k" else None)
        return out, (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(reqs)) as pool:
        done = list(pool.map(one, reqs))
    wall = time.perf_counter() - t0
    return [d[0] for d in done], [d[1] for d in done], wall


def warm_service(runner_cls, config_cls, spec, np, inputs):
    """Build every (kind, padded B) shard program the phase's windows can
    use: for each kind, batches of 1, 2, 4 and 8 through a service that
    flushes on size or drain only (the cache is process-wide)."""
    from concurrent.futures import ThreadPoolExecutor

    cfg = config_cls(max_batch=B, max_delay_ms=60_000.0)
    with runner_cls(spec=spec, config=cfg) as warm:
        for kind in SERVE_KINDS:
            b = 1
            while b <= B:
                with ThreadPoolExecutor(b) as pool:
                    futs = [pool.submit(
                        warm.submit, inputs[kind][i], kind=kind,
                        values=np.arange(N_REQ, dtype=np.int32)
                        if kind == "sort_kv" else None,
                        param=TOP_K if kind == "top_k" else None)
                        for i in range(b)]
                    while warm.service.queued < b and not all(
                            f.done() for f in futs):
                        time.sleep(0.001)
                    if b < B:
                        warm.drain()
                    for f in futs:
                        f.result()
                b *= 2


@contextlib.contextmanager
def batch_times(service, record: list):
    """Record the compute seconds of each batch `service` runs (its
    executor thread's `_run_batch`, stacking to results on the host)."""
    real = service._run_batch

    def timed(reqs):
        t0 = time.perf_counter()
        try:
            return real(reqs)
        finally:
            record.append(time.perf_counter() - t0)
    service._run_batch = timed
    try:
        yield record
    finally:
        del service._run_batch


def cache_rate(np, snap) -> tuple:
    hits = sum(b["cache"]["hits"] for b in snap["buckets"].values())
    misses = sum(b["cache"]["misses"] for b in snap["buckets"].values())
    return hits, misses, hits / max(hits + misses, 1)


def serve_phase(torch, np, card):
    """Phase 19: the service at the batched cell's width: each kind in
    its own window, a mixed window, HTTP and the overload burst."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import cuda
    from repro_torch.serve import ServiceConfig, ServiceRunner, smoke
    from repro_torch.serve.http import make_server
    from repro_torch.serve.metrics import percentile
    from repro_torch.sort import SortSpec

    spec = SortSpec(shards=P, eps=EPS, device=SERVE_DEVICE)
    inputs = {k: serve_inputs(np, k, SERVE_LOAD) for k in SERVE_KINDS}
    t0 = time.perf_counter()
    warm_service(ServiceRunner, ServiceConfig, spec, np, inputs)
    emit({"measure": "serve_warm", "seconds": time.perf_counter() - t0,
          "kinds": list(SERVE_KINDS), "batch_sizes": [1, 2, 4, 8],
          "card": card})
    paths = {}
    # each kind's window flushes on size only: two full batches of B
    with ServiceRunner(spec=spec, config=ServiceConfig(
            max_batch=B, max_delay_ms=60_000.0)) as runner:
        runner.reset_metrics()
        for kind in SERVE_KINDS:
            reqs = [(kind, x) for x in inputs[kind]]
            cuda.reset_launches()
            torch.cuda.synchronize()
            outs, lat, wall = submit_all(runner, np, reqs)
            torch.cuda.synchronize()
            launches = dict(cuda.launches)
            paths[f"serve[{kind}]"] = launches
            check_path_launches(f"serve[{kind}]", launches,
                                PATH_KERNELS[f"serve[{kind}]"])
            for (_, x), got in zip(reqs, outs):
                check_served(np, kind, x, got)
            emit({"measure": "serve_kind", "kind": kind, "n": N_REQ,
                  "requests": len(reqs), "wall_s": wall,
                  "latency_ms_max": max(lat), "launches": launches,
                  "card": card})
        snap = runner.metrics()
        hits, misses, rate = cache_rate(np, snap)
        batches = snap["batches"]
        if snap["degraded_requests"] or snap["verify_fallbacks"]:
            fail(f"serve: degraded {snap['degraded_requests']}, verify "
                 f"fallbacks {snap['verify_fallbacks']} on clean traffic")
        if rate <= 0.9:
            fail(f"serve: warm hit rate {rate:.3f} <= 0.9 ({hits} hits, "
                 f"{misses} misses)")
        if runner.health()["health"] != "ok":
            fail(f"serve: health {runner.health()['health']}")
        emit({"measure": "serve_steady", "requests": snap["served"],
              "batches": batches, "cache_hits": hits,
              "cache_misses": misses, "hit_rate": rate,
              "degraded": snap["degraded_requests"],
              "verify_fallbacks": snap["verify_fallbacks"],
              "health": runner.health()["health"],
              "occupancy": {k: b["mean_occupancy"]
                            for k, b in snap["buckets"].items()},
              "flush_reasons": {k: b["flush_reasons"]
                                for k, b in snap["buckets"].items()},
              "card": card})

    # the mixed window: 64 requests, the five kinds interleaved, under
    # the default flush deadline (its batch count is one run's reading)
    with ServiceRunner(spec=spec, config=ServiceConfig(max_batch=B)) \
            as runner:
        mixed = [(SERVE_KINDS[i % 5], inputs[SERVE_KINDS[i % 5]][i // 5])
                 for i in range(MIXED_LOAD)]
        runner.reset_metrics()
        compute = []
        cuda.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with batch_times(runner.service, compute):
            outs, lat, wall = submit_all(runner, np, mixed)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches = dict(cuda.launches)
        paths["serve[mixed]"] = launches
        check_path_launches("serve[mixed]", launches,
                            PATH_KERNELS["serve[mixed]"])
        for (kind, x), got in zip(mixed, outs):
            check_served(np, kind, x, got)
        snap = runner.metrics()
        hits, misses, rate = cache_rate(np, snap)
        if snap["degraded_requests"] or rate <= 0.9:
            fail(f"serve[mixed]: degraded {snap['degraded_requests']}, "
                 f"hit rate {rate:.3f}")
        if runner.health()["health"] != "ok":
            fail(f"serve[mixed]: health {runner.health()['health']}")
        emit({"measure": "serve_mixed", "requests": MIXED_LOAD,
              "n": N_REQ, "batches": snap["batches"], "wall_s": wall,
              "requests_per_s": MIXED_LOAD / wall,
              "keys_per_s": MIXED_LOAD * N_REQ / wall,
              "latency_ms_client": {"p50": percentile(lat, 0.5),
                                    "p99": percentile(lat, 0.99),
                                    "max": max(lat)},
              "latency_ms_by_bucket": {
                  k[:40]: b["latency_ms"] for k, b in
                  snap["buckets"].items()},
              "batch_compute_ms": {
                  "median": 1e3 * statistics.median(compute),
                  "all": [1e3 * c for c in compute]},
              "batch_timer": snap["batch_timer"], "cache_hits": hits,
              "cache_misses": misses, "hit_rate": rate,
              "max_allocated_bytes": peak, "launches": launches,
              "card": card})
    del inputs

    # HTTP: 16 concurrent /v1/sort of HTTP_N keys, then the overload burst
    xs = [np.random.default_rng(200 + s).permutation(4 * HTTP_N)[:HTTP_N]
          .astype(np.int32) for s in range(SERVE_LOAD)]
    with ServiceRunner(spec=spec, config=ServiceConfig(max_batch=B)) \
            as runner:
        server = make_server(runner, port=0)
        host, port = server.server_address[:2]
        base = f"http://{host}:{port}"
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            cuda.reset_launches()
            t0 = time.perf_counter()
            with ThreadPoolExecutor(SERVE_LOAD) as pool:
                replies = list(pool.map(lambda x: smoke._post(
                    base, "/v1/sort", {"keys": x.tolist(),
                                       "dtype": "int32"}), xs))
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = dict(cuda.launches)
            for x, (code, body) in zip(xs, replies):
                if code != 200 or not np.array_equal(
                        np.asarray(body["sorted"], np.int32), np.sort(x)):
                    fail(f"serve[http]: status {code} or a wrong sort")
            paths["serve[http]"] = launches
            check_path_launches("serve[http]", launches,
                                PATH_KERNELS["serve[http]"])
            code, health = smoke._get(base, "/healthz")
            if code != 200 or health["health"] != "ok":
                fail(f"serve[http]: /healthz {code} {health['health']}")
        finally:
            server.shutdown()
            server.server_close()
    codes = smoke.overload_burst(spec, xs[0])
    emit({"measure": "serve_http", "requests": SERVE_LOAD, "n": HTTP_N,
          "wall_s": wall, "requests_per_s": SERVE_LOAD / wall,
          "launches": launches, "overload_codes": sorted(codes),
          "card": card})
    return paths


@contextlib.contextmanager
def degraded_launches(record: list):
    """Record the kernel launches of each degraded-path request (the
    service's `_run_one`, which runs alone on its executor thread), a
    dict a request."""
    from repro_torch.kernels import cuda
    from repro_torch.serve.service import SortService

    real = SortService._run_one

    def run_one(self, req):
        before = dict(cuda.launches)
        try:
            return real(self, req)
        finally:
            record.append({k: cuda.launches[k] - before.get(k, 0)
                           for k in cuda.COUNTERS})
    SortService._run_one = run_one
    try:
        yield record
    finally:
        SortService._run_one = real


def drills_phase(torch, np, card):
    """Phase 20: the chaos and corrupt drills of repro_torch.serve.smoke
    in the process, at requests of N_REQ keys on the card."""
    from repro_torch.serve import smoke

    t0 = time.perf_counter()
    out = smoke.chaos_main(n=N_REQ, clamp_pair_cap=CHAOS_CLAMP,
                           device=SERVE_DEVICE, shards=P)
    m = out["metrics"]
    emit({"measure": "serve_chaos_drill", "n": N_REQ,
          "clamp_pair_cap": CHAOS_CLAMP, "chaos_stats": out["chaos"],
          "executor": out["executor"], "served": m["served"],
          "errors": m["errors"], "batch_retries": m["batch_retries"],
          "bisections": m["bisections"],
          "executor_restarts": m["executor_restarts"],
          "overflow_retries": m["overflow_retries"],
          "overflow_recovered": m["overflow_recovered"],
          "seconds": time.perf_counter() - t0, "card": card})
    t0 = time.perf_counter()
    record = []
    with degraded_launches(record):
        out = smoke.corrupt_main(n=N_REQ, device=SERVE_DEVICE, shards=P,
                                 cooldown_s=CORRUPT_COOLDOWN_S)
    m = out["metrics"]
    if not record:
        fail("serve corrupt drill: no request took the degraded path")
    for launches in record:
        check_path_launches("serve[degraded]", launches,
                            PATH_KERNELS["serve[degraded]"])
    emit({"measure": "serve_corrupt_drill", "n": N_REQ,
          "chaos_stats": out["chaos"], "served": m["served"],
          "errors": m["errors"], "verify_failures": m["verify_failures"],
          "verify_failed_requests": m["verify_failed_requests"],
          "degraded_requests": m["degraded_requests"],
          "degraded_path_launches": record,
          "breaker_cooldown_s": CORRUPT_COOLDOWN_S,
          "clean_cache_hits": out["clean_hits"],
          "clean_cache_misses": out["clean_misses"],
          "seconds": time.perf_counter() - t0, "card": card})


def serve_timing_phase(torch, np, card):
    """Phase 21: one full batch served beside the direct sort_batched of
    the same 8 rows (and with its 8 gathers), in turns; the service's
    host steps timed apart; a profile of one served batch."""
    from repro_torch.serve import ServiceConfig, ServiceRunner
    from repro_torch.serve.metrics import percentile
    from repro_torch.sort import SortSpec, sort_batched

    spec = SortSpec(shards=P, eps=EPS, device=SERVE_DEVICE)
    rows = serve_inputs(np, "sort", B)
    xs = np.stack(rows)
    # a flush on size only, so that each served call is one full batch
    full = ServiceConfig(max_batch=B, max_delay_ms=60_000.0)
    with ServiceRunner(spec=spec, config=full) as runner:
        def served():
            outs, _, _ = submit_all(runner, np, [("sort", x) for x in rows])
            return outs

        def direct_gathered():
            out = sort_batched(xs, spec)
            return [out.gather(b) for b in range(B)]

        timed = medians_in_turns(torch, {
            "direct": lambda: sort_batched(xs, spec),
            "direct_gathered": direct_gathered, "served": served})
        for name, (med, runs) in timed.items():
            emit({"measure": "serve_batch_e2e_warm", "call": name,
                  "batch": B, "n": N_REQ, "median_ms": med,
                  "runs_ms": runs, "in_turns": True, "card": card})
        # the service's steps, each alone: stack, copy, sort, gathers
        steps = {}
        steps["np_stack"] = median_ms(torch, lambda: np.stack(rows))
        steps["host_to_device"] = median_ms(
            torch, lambda: torch.from_numpy(xs).to(SERVE_DEVICE))
        dev = torch.from_numpy(xs).to(SERVE_DEVICE)
        out = sort_batched(dev, spec)
        steps["sort_batched_on_device"] = median_ms(
            torch, lambda: sort_batched(dev, spec))
        steps["gathers"] = median_ms(
            torch, lambda: [out.gather(b) for b in range(B)])
        emit({"measure": "serve_batch_steps", "batch": B, "n": N_REQ,
              "median_ms": {k: v[0] for k, v in steps.items()},
              "runs_ms": {k: v[1] for k, v in steps.items()},
              "card": card})
        profile_line(torch, served, card, measure="serve_batch_profile",
                     batch=B, n=N_REQ)
        if runner.metrics()["batches"] != len(timed["served"][1]) + 2:
            fail("serve timing: a served call ran as more than one batch")

    # the flush deadline: the mixed window again with max_delay_ms 50
    # beside the default 5, in turns (each window's batches and rates)
    per_kind = -(-MIXED_LOAD // len(SERVE_KINDS))
    inputs = {k: serve_inputs(np, k, per_kind, first=300)
              for k in SERVE_KINDS}
    mixed = [(SERVE_KINDS[i % 5], inputs[SERVE_KINDS[i % 5]][i // 5])
             for i in range(MIXED_LOAD)]
    rates = {5.0: [], 50.0: []}
    for _ in range(2):
        for delay in rates:
            cfg = ServiceConfig(max_batch=B, max_delay_ms=delay)
            with ServiceRunner(spec=spec, config=cfg) as runner:
                outs, lat, wall = submit_all(runner, np, mixed)
                snap = runner.metrics()
            for (kind, x), got in zip(mixed, outs):
                check_served(np, kind, x, got)
            rates[delay].append({"wall_s": wall, "batches": snap["batches"],
                                 "requests_per_s": MIXED_LOAD / wall,
                                 "p50_ms": percentile(lat, 0.5),
                                 "p99_ms": percentile(lat, 0.99)})
    emit({"measure": "serve_mixed_deadline", "requests": MIXED_LOAD,
          "n": N_REQ, "by_max_delay_ms": {str(k): v
                                          for k, v in rates.items()},
          "in_turns": True, "card": card})


def bucketing_phase(torch, np, card):
    """Phase 22: length bucketing of 1,048,576 documents over 8 shards."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.data.partition import (bucket_lengths, pack_documents,
                                            padding_fraction)
    from repro_torch.sort import SortSpec

    # the default configuration (repro/data/partition.py:42), placed
    spec = SortSpec(algorithm="hss", eps=EPS, exchange="allgather",
                    device=SERVE_DEVICE)
    lengths = SyntheticTokens(vocab=32000, seq_len=2048,
                              global_batch=B).doc_lengths(0, DOCS)
    (ids, counts), launches = launched(
        torch, lambda: bucket_lengths(lengths, P, spec=spec))
    check_path_launches("bucket_lengths", launches,
                        PATH_KERNELS["bucket_lengths"])
    flat = np.concatenate(ids)
    if not np.array_equal(np.sort(flat), np.arange(DOCS)):
        fail("bucket_lengths: the shards do not hold every doc id once")
    if np.any(np.diff(lengths[flat]) < 0):
        fail("bucket_lengths: shards are not contiguous and non-decreasing")
    if counts.max() > (1 + EPS) * DOCS / P + 1:
        fail(f"bucket_lengths: max count {counts.max()}")
    seqs = [s for shard in ids for s in pack_documents(shard, lengths, 2048)]
    unsorted = pack_documents(np.arange(DOCS), lengths, 2048)
    med, runs = median_ms(torch,
                          lambda: bucket_lengths(lengths, P, spec=spec))
    emit({"measure": "bucket_lengths", "docs": DOCS, "shards": P,
          "counts": counts.tolist(), "launches": launches,
          "sequences": len(seqs),
          "padding_fraction": padding_fraction(seqs, lengths, 2048),
          "padding_fraction_unsorted": padding_fraction(unsorted, lengths,
                                                        2048),
          "median_ms": med, "runs_ms": runs, "card": card})
    return {"bucket_lengths": launches}


def analysis_phase(torch, np, card):
    """Phase 23: the analysis lint on the card (`python -m
    repro_torch.analysis.lint --device cuda`, written to a temporary
    path): 0 failures; the records, checks and sync counts equal to the
    CPU's committed ANALYSIS_torch.json, collective by collective (the
    programs take seeded keys and host draws, so the rounds match too);
    every static footprint of `analysis.budgets` equal to ptxas's "bytes
    smem" and within its register cap; K2's dynamic footprint within the
    opt-in its launcher set, read back from the built library."""
    import tempfile

    from repro_torch.analysis import budgets, lint
    from repro_torch.kernels import cuda

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "ANALYSIS_torch.json"
        if lint.main(["--device", "cuda", "--out", str(out)]) != 0:
            fail("analysis lint on the card reported failures")
        got = json.loads(out.read_text())
    seconds = time.perf_counter() - t0
    want = json.loads((ROOT / "ANALYSIS_torch.json").read_text())
    if got["failures"] or not got["ok"]:
        fail(f"analysis lint: {got['failures']} failure(s)")
    for key in ("checks", "comms_reports", "sync_counts",
                "budget_footprints"):
        if got[key] != want[key]:
            fail(f"analysis lint on the card: {key} differ from the CPU's "
                 "committed ANALYSIS_torch.json")
    footprints = budgets.check_kernel_budgets()
    log = cuda.ptxas_log()
    try:
        rows = budgets.check_ptxas(footprints, log)
    except budgets.BudgetError as e:
        print("\n".join(log.splitlines()[:8]), file=sys.stderr)
        fail(f"the budgets against ptxas: {e}")
    opt_in = []
    for fp in footprints:
        if not fp.dynamic_smem:
            continue
        attrs = cuda.merge_smem_attributes(int(fp.config))
        if attrs["max_dynamic_smem"] < fp.dynamic_smem:
            fail(f"K2 seg={fp.config}: opt-in {attrs['max_dynamic_smem']} "
                 f"B below its {fp.dynamic_smem} B of dynamic shared memory")
        opt_in.append({"segment": int(fp.config),
                       "dynamic_smem": fp.dynamic_smem, **attrs})
    emit({"measure": "analysis", "checks": len(got["checks"]),
          "failures": got["failures"], "seconds": seconds,
          "comms_reports": len(got["comms_reports"]),
          "sync_counts": got["sync_counts"], "ptxas_budgets": rows,
          "k2_opt_in": opt_in, "card": card})


def sync_audit_phase(torch, np, card):
    """Phase 24: each front door of `analysis.purity.DOORS` at WEAK_SCALING
    (16,000,000 UNIF int32 keys on the card, p = 8; the batched cell's 8 x
    2,000,000 for sort_batched) under set_sync_debug_mode("error"): a
    sync outside the documented sites raises, and each door's counts
    must equal its pinned formula."""
    from repro_torch.analysis import purity
    from repro_torch.data.distributions import make_distribution
    from repro_torch.sort import (
        SortSpec, argsort, semisort, sort, sort_batched, sort_kv, top_k)

    x = torch.from_numpy(make_distribution("UNIF", N_WEAK, seed=0)).cuda()
    xs = torch.from_numpy(np.stack([make_distribution("UNIF", N_REQ, seed=s)
                                    for s in range(B)])).cuda()
    vals = np.arange(N_WEAK, dtype=np.int32)
    spec = SortSpec(shards=P, eps=EPS)
    doors = {
        "sort": (lambda: sort(x, spec).gather(), 1),
        "sort_batched": (lambda: sort_batched(xs, spec).gather_all(), B),
        "argsort": (lambda: argsort(x, spec), 1),
        "sort_kv": (lambda: sort_kv(x, vals, spec), 1),
        "semisort": (lambda: semisort(x, spec=spec).gather(), 1),
        "top_k": (lambda: top_k(x, TOP_K, spec), 1),
        "sort[retry]": (lambda: sort(x, spec, on_overflow="retry").gather(),
                        1),
        "sort[verify=full]": (lambda: sort(x, spec,
                                           verify="full").gather(), 1),
    }
    if set(doors) != set(purity.DOORS):
        fail(f"sync audit covers {sorted(doors)}, not {purity.DOORS}")
    t0 = time.perf_counter()
    for door, (call, batch) in doors.items():
        call()
        audit = purity.count_host_syncs(call, device="cuda")
        want = purity.pinned_syncs(door, audit.events, batch=batch)
        emit({"measure": "sync_audit", "door": door,
              "syncs": dict(audit.syncs), "pinned": dict(want),
              "launches": len({e.comm for e in audit.events}),
              "rounds_entered": sum(e.kind == "round"
                                    for e in audit.events),
              "card": card})
        if audit.syncs != want:
            fail(f"sync audit {door}: {dict(audit.syncs)} against the "
                 f"pinned {dict(want)}")
    emit({"measure": "sync_audit_total", "doors": len(doors),
          "seconds": time.perf_counter() - t0, "card": card})


def legacy_phase(torch, np, card):
    """Phase 25: the legacy entry points at full width. hss_sort,
    sample_sort (random, regular), ams_sort and two_stage_sort of the
    WEAK_SCALING keys equal `sort` with the same algorithm and seed bit
    for bit, and np.sort; probe_counts of those keys, unsorted, against
    256 sorted probes equals its plain version and the np.histogram-style
    counts and launches the counting K4; merge_flat_runs of 8 runs of
    2^21 keys equals np.sort; pack_tagged/unpack_tagged round-trip at 31
    and 63 bits. Each path's kernels are gated (PATH_KERNELS)."""
    from repro_torch.core import ams, hss, multistage, sample_sort, tagging
    from repro_torch.data.distributions import make_distribution
    from repro_torch.kernels.histogram import kernel as HK
    from repro_torch.kernels.histogram import ops as hops
    from repro_torch.kernels.merge import ops as mops
    from repro_torch.sort import SortSpec, sort

    keys = make_distribution("UNIF", N_WEAK, seed=0)
    want = np.sort(keys)
    x = torch.from_numpy(keys).cuda()
    spec = SortSpec(shards=P, eps=EPS, tag=False)
    paths = {}
    legacy = {
        "hss": lambda: hss.hss_sort(x, shards=P),
        "sample_random": lambda: sample_sort.sample_sort(x, shards=P),
        "sample_regular": lambda: sample_sort.sample_sort(
            x, shards=P, method="regular"),
        "ams": lambda: ams.ams_sort(x, shards=P),
        "multistage": lambda: multistage.two_stage_sort(x, shards=P),
    }
    for algo, call in legacy.items():
        got, launches = launched(torch, call)
        front = sort(x, spec, algorithm=algo)
        if algo == "multistage":
            out, counts, ovf = got
            got = hss.SortResult(out.reshape(P, -1), counts.reshape(P),
                                 None, None, ovf, None)
        name = f"legacy:{algo}"
        check_path_launches(name, launches, PATH_KERNELS[name])
        paths[name] = launches
        if not (torch.equal(got.shards, front.shards)
                and torch.equal(got.counts, front.counts)):
            fail(f"{name}: not the sort front door's shards and counts")
        if not np.array_equal(hss.gather_sorted(got), want):
            fail(f"{name}: gather differs from np.sort")
        emit({"measure": "legacy", "entry": name,
              "overflow": int(got.overflow),
              "max_count": int(got.counts.max()), "launches": launches,
              "card": card})

    rng = np.random.default_rng(5)
    probes = np.sort(rng.choice(keys, PROBES, replace=False))
    q = torch.from_numpy(probes).cuda()
    counts, launches = launched(torch, lambda: hops.probe_counts(x, q))
    check_path_launches("probe_counts", launches, PATH_KERNELS["probe_counts"])
    paths["probe_counts"] = launches
    ranks = HK.probe_ranks_plain(x[None], q[None])[0]
    plain = torch.diff(torch.cat([ranks.new_zeros(1), ranks,
                                  ranks.new_full((1,), N_WEAK)]))
    host = np.diff(np.concatenate(
        [[0], np.searchsorted(want, probes, side="left"), [N_WEAK]]))
    if not torch.equal(counts, plain):
        fail("probe_counts disagrees with its plain version")
    if not np.array_equal(counts.cpu().numpy(), host):
        fail("probe_counts disagrees with the histogram of np.sort")
    emit({"measure": "legacy", "entry": "probe_counts", "keys": N_WEAK,
          "probes": PROBES, "launches": launches,
          "median_ms": median_ms(torch, lambda: hops.probe_counts(x, q))[0],
          "card": card})

    runs = torch.sort(torch.cat([x, x[:8 * ROW - N_WEAK]]).view(8, ROW),
                      dim=-1).values.reshape(-1)
    merged, launches = launched(torch,
                                lambda: mops.merge_flat_runs(runs, ROW))
    check_path_launches("merge_flat_runs", launches,
                        PATH_KERNELS["merge_flat_runs"])
    paths["merge_flat_runs"] = launches
    if not np.array_equal(merged.cpu().numpy(), np.sort(runs.cpu().numpy())):
        fail("merge_flat_runs differs from np.sort")
    emit({"measure": "legacy", "entry": "merge_flat_runs", "runs": 8,
          "run": ROW, "launches": launches, "card": card})

    shard = torch.arange(P, device="cuda")[:, None]
    for key_bits in (7, 39):        # 24 tag bits: 31 and 63 in all
        k = (x.view(P, N_LOCAL).long() + 2 ** 31) >> (32 - key_bits)
        packed, launches = launched(torch, lambda: tagging.pack_tagged(
            k, shard, p=P, n_local=N_LOCAL, key_bits=key_bits))
        check_path_launches("pack_tagged", launches, ())
        back = tagging.unpack_tagged(packed, p=P, n_local=N_LOCAL)
        wide = torch.int32 if key_bits == 7 else torch.int64
        if packed.dtype != wide or not torch.equal(back.long(), k):
            fail(f"pack_tagged at {key_bits} key bits does not round-trip")
        if torch.unique(packed).numel() != packed.numel():
            fail(f"pack_tagged at {key_bits} key bits: tags not distinct")
    emit({"measure": "legacy", "entry": "pack_tagged",
          "key_bits": [7, 39], "dtypes": ["int32", "int64"], "card": card})
    return paths


#: Phase 26: the model stack's serving path. Phi-3.5-MoE
#: (src/repro/configs/phi35_moe.py) at full width with 8 of its 32
#: layers: all 32 are 41.9 B parameters, 78 GiB of bf16 weights, which do
#: not fit one 80 GB card beside a cache and activations; 8 are 10.67 B,
#: 19.9 GiB. A prompt of 2,048 tokens is over attn_chunk (1,024), so the
#: prefill runs the chunked flash attention and the big-T MoE dispatch;
#: decode runs the small-T one.
SERVE_ARCH = "phi3.5-moe-42b-a6.6b"
SERVE_LAYERS = 8
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 2048, 16
CHECK_LAYERS, CHECK_SEQ, CHECK_PREFILL, CHECK_STEPS = 2, 64, 32, 3
#: The decode-against-forward checks' tolerance and their capacity factor.
#: Both checks run in float32, where a sound cached decode reads 1.5e-5
#: (Phi-3.5-MoE) to 4.2e-5 (mamba2) on an H100 (PERF.md §6); 1e-3
#: holds them well under the reference's bf16 smoke tolerance of 0.15
#: (tests/test_arch_smoke.py:91-101), which would pass a decode many times
#: worse. The capacity factor is smoke_config's 4.0 (registry.py:50), so
#: that the forward drops no routed token that the decode keeps.
CHECK_TOL, CHECK_CAPACITY = 1e-3, 4.0
MAMBA_ARCH = "mamba2-370m"
MAMBA_PROMPT = 256
BUCKET_REQUESTS, BUCKETS = 64, 8
#: serve_bucketed's sort of 64 prompt lengths over 8 shards (7 key bits, 6
#: tag bits: int32 packing, the kernels): K1 sorts each 8-key shard row
#: and the gathered sample, K6 draws each round's sample, K5 merges the
#: received runs (64-key rows), K4s ranks; no row is long enough for K2
#: or K3.
PATH_KERNELS["serve_bucketed"] = ("bitonic_sort_blocks", "merge_path_pairs",
                                  "probe_rank_search", "sample_compact")


@contextlib.contextmanager
def model_observer(torch):
    """While the block runs, keep each MoE layer's drop count and whether
    each logits tensor is finite (device tensors, read after the block)."""
    import repro_torch.models.lm as lm
    import repro_torch.models.moe as moe

    real_ffn, real_unembed = moe.moe_ffn, lm.unembed
    seen = {"dropped": [], "finite": []}

    def moe_ffn(x, p, cfg, ctx):
        y, aux = real_ffn(x, p, cfg, ctx)
        seen["dropped"].append((x.shape[1], aux["dropped"]))
        return y, aux

    def unembed(params, h, cfg, ctx):
        logits = real_unembed(params, h, cfg, ctx)
        seen["finite"].append(torch.isfinite(logits[..., :cfg.vocab]).all())
        return logits

    moe.moe_ffn, lm.unembed = moe_ffn, unembed
    try:
        yield seen
    finally:
        moe.moe_ffn, lm.unembed = real_ffn, real_unembed


def free_device(torch):
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def served_line(torch, np, cfg, card, name, batch, prompt, gen, **extra):
    """serve_batch of `cfg` (seeded weights), once to warm up (gen 2) and
    once measured: tokens in [0, vocab), logits finite, the MoE drops
    counted by path; one JSON line."""
    from repro_torch.launch.serve import seeded_params, serve_batch
    from repro_torch.models import flops
    from repro_torch.models.lm import tree_map

    t0 = time.perf_counter()
    params = seeded_params(cfg, 0, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    serve_batch(cfg, batch=batch, prompt_len=prompt, gen=2, params=params,
                device="cuda")
    torch.cuda.reset_peak_memory_stats()
    with model_observer(torch) as seen:
        toks, stats = serve_batch(cfg, batch=batch, prompt_len=prompt,
                                  gen=gen, params=params, device="cuda")
    peak = torch.cuda.max_memory_allocated()
    leaves = []
    tree_map(leaves.append, params)
    if toks.shape != (batch, gen) or toks.min() < 0 or toks.max() >= cfg.vocab:
        fail(f"{name}: tokens outside [0, {cfg.vocab}) or of shape "
             f"{toks.shape}")
    if not all(bool(f) for f in seen["finite"]) or not seen["finite"]:
        fail(f"{name}: non-finite logits")
    drops = {"prefill": sum(int(d) for s, d in seen["dropped"] if s > 1),
             "decode": sum(int(d) for s, d in seen["dropped"] if s == 1)}
    prefill_flops = flops.model_flops(cfg, "prefill", prompt, batch)
    decode_flops = flops.model_flops(cfg, "decode", prompt + gen // 2, batch)
    decode_ms = stats["decode_s"] * 1e3 / (gen - 1)
    emit({"measure": "model_serve", "arch": cfg.name, "family": cfg.family,
          "n_layers": cfg.n_layers, "dtype": cfg.dtype, "batch": batch,
          "prompt_len": prompt, "gen": gen, "params": cfg.param_count(),
          "param_gib": sum(t.numel() * t.element_size() for t in
                           leaves) / 2 ** 30,
          "init_s": init_s, "prefill_ms": stats["prefill_s"] * 1e3,
          "decode_ms_per_token": decode_ms, "tok_per_s": stats["tok_per_s"],
          "prefill_tflops": prefill_flops / stats["prefill_s"] / 1e12,
          "decode_tflops": decode_flops / (decode_ms / 1e3) / 1e12,
          "moe_dropped": drops if cfg.n_experts else None,
          "peak_gib": peak / 2 ** 30,
          "tokens_head": toks[0, :8].tolist(), **extra, "card": card})
    del params, leaves
    free_device(torch)


def decode_check_line(torch, np, cfg, card, name, ctx=None, **extra):
    """Prefill CHECK_PREFILL tokens, then CHECK_STEPS cached decode steps,
    each against the teacher-forced forward over CHECK_SEQ tokens, within
    CHECK_TOL, under `ctx` (default the local (1, 1) layout)."""
    from repro_torch.launch.serve import seeded_params
    from repro_torch.models.lm import forward, tree_map
    from repro_torch.models.steps import make_prefill_step, make_serve_step
    from repro_torch.parallel.ctx import local_ctx

    ctx = ctx or local_ctx()
    params = seeded_params(cfg, 1, "cuda")
    leaves = []
    tree_map(leaves.append, params)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, CHECK_SEQ)).astype(np.int32)).to(leaves[0].device)
    with torch.no_grad(), model_observer(torch) as seen:
        full, _, _ = forward(params, toks, cfg, ctx)
    fwd_drops = sum(int(d) for _, d in seen["dropped"])
    last, cache = make_prefill_step(cfg, ctx, CHECK_SEQ)(
        params, {"tokens": toks[:, :CHECK_PREFILL]})
    diffs = [float((last - full[:, CHECK_PREFILL - 1]).abs().max())]
    ok = torch.allclose(last, full[:, CHECK_PREFILL - 1], rtol=CHECK_TOL,
                        atol=CHECK_TOL)
    serve = make_serve_step(cfg, ctx)
    for t in range(CHECK_PREFILL, CHECK_PREFILL + CHECK_STEPS):
        logits, cache = serve(params, cache, toks[:, t:t + 1], t)
        diffs.append(float((logits - full[:, t]).abs().max()))
        ok = ok and torch.allclose(logits, full[:, t], rtol=CHECK_TOL,
                                   atol=CHECK_TOL)
    if not ok:
        fail(f"{name}: cached decode differs from the forward ({diffs})")
    emit({"measure": "decode_vs_forward", "arch": cfg.name,
          "dp": ctx.dp_size, "tp": ctx.tp_size,
          "n_layers": cfg.n_layers, "dtype": cfg.dtype, "seq": CHECK_SEQ,
          "prefill": CHECK_PREFILL, "steps": CHECK_STEPS,
          "max_abs_diff": diffs, "tol": CHECK_TOL,
          "forward_moe_dropped": fwd_drops if cfg.n_experts else None,
          **extra, "card": card})
    del params, leaves, cache, full
    free_device(torch)


def model_phase(torch, np, card):
    """Phase 26: the model stack's serving path on the card. (a)
    Phi-3.5-MoE at full width, 8 of 32 layers, bf16: serve_batch of 8
    prompts of 2,048 tokens and 16 generated tokens; (b) its cached decode
    against the teacher-forced forward (2 layers, float32); (c)
    mamba2-370m whole: serve_batch of 8 x 256 tokens in bf16 and the same
    check in float32; (d) serve_bucketed of 64 lognormal-length requests
    (launch/serve.py:129-130) over 8 buckets on (a)'s configuration:
    every request served once, contiguous non-decreasing buckets, the
    bucketing sort's kernels gated (PATH_KERNELS)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_bucketed

    cut = f"n_layers {SERVE_LAYERS} of 32 (78 GiB of bf16 weights at 32)"
    phi = dataclasses.replace(get_config(SERVE_ARCH), n_layers=SERVE_LAYERS)
    served_line(torch, np, phi, card, "phi3.5-moe serve", SERVE_BATCH,
                SERVE_PROMPT, SERVE_GEN, cut=cut)

    lens = np.random.default_rng(0).lognormal(
        3.5, 0.6, size=BUCKET_REQUESTS).clip(8, 128).astype(np.int32)
    t0 = time.perf_counter()
    (results, totals), launches = launched(torch, lambda: serve_bucketed(
        phi, prompt_lens=lens, gen=SERVE_GEN, n_buckets=BUCKETS,
        device="cuda"))
    wall_s = time.perf_counter() - t0
    check_path_launches("serve_bucketed", launches,
                        PATH_KERNELS["serve_bucketed"])
    flat = np.concatenate([ids for ids, _ in results])
    if not np.array_equal(np.sort(flat), np.arange(BUCKET_REQUESTS)):
        fail("serve_bucketed: a request is not served exactly once")
    if np.any(np.diff(lens[flat]) < 0):
        fail("serve_bucketed: buckets are not contiguous and non-decreasing")
    emit({"measure": "serve_bucketed", "arch": phi.name,
          "n_layers": phi.n_layers, "requests": BUCKET_REQUESTS,
          "buckets": totals["buckets"], "gen": SERVE_GEN,
          "sizes": [int(ids.size) for ids, _ in results],
          "max_len": [int(lens[ids].max()) for ids, _ in results],
          "pad_frac": [stats["pad_frac"] for _, stats in results],
          "tokens": totals["tokens"], "serve_s": totals["total_s"],
          "wall_s": wall_s, "launches": launches, "cut": cut, "card": card})
    free_device(torch)

    check = dict(n_layers=CHECK_LAYERS, dtype="float32",
                 moe_capacity_factor=CHECK_CAPACITY)
    decode_check_line(torch, np, dataclasses.replace(
        get_config(SERVE_ARCH), **check), card, "phi3.5-moe check",
        cut=f"n_layers {CHECK_LAYERS} of 32, float32, capacity factor "
            f"{CHECK_CAPACITY}")
    mamba = get_config(MAMBA_ARCH)
    served_line(torch, np, mamba, card, "mamba2 serve", SERVE_BATCH,
                MAMBA_PROMPT, SERVE_GEN, cut="none")
    decode_check_line(torch, np, dataclasses.replace(mamba, dtype="float32"),
                      card, "mamba2 check", cut="none, float32")
    return {"serve_bucketed": launches}


#: Phase 27: the model stack's training path. (a) Phi-3.5-MoE at full
#: width with 2 of its 32 layers, bf16, AdamW (the config's optimizer and
#: remat "block"): 2.86 B parameters hold 32.0 GiB standing (bf16
#: parameter and gradient, float32 m and v: 12 bytes a parameter), and
#: each float32 temporary of the update of the stacked (2, 16, 4,096,
#: 6,400) expert weights adds 3.1 GiB; 3 layers (46.5 GiB standing) leave
#: no margin on one 80 GB card, 8 (119 GiB) do not fit. 8 x 2,048 tokens
#: is over attn_chunk (1,024): the chunked flash attention, its backward
#: and the big-T MoE dispatch run. (a') The same steps at 1 layer in bf16
#: and float32 at (a)'s lr and in bf16 at a tenth of it. (b) The flash backward at Phi's head
#: shape against plain autograd through attention_full, float32, within
#: the reference's own tolerance for that comparison
#: (tests/test_attention.py:46). (c) mamba2-370m whole (48 layers) under
#: TrainSupervisor: a checkpoint every 2 steps, keep 2, one failure
#: injected after step 3.
TRAIN_LAYERS = 2
PROBE_LAYERS = 1
PROBE_RUNS = (("bfloat16", 3e-4), ("float32", 3e-4), ("bfloat16", 3e-5))
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 4
FLASH_SHAPE = dict(heads=32, kv_heads=8, head_dim=128, seq=2048, chunk=1024)
FLASH_TOL = 5e-4
DRILL_STEPS, DRILL_BATCH, DRILL_SEQ = 6, 8, 512
DRILL_SAVE_EVERY, DRILL_KEEP, DRILL_FAIL_AT = 2, 2, 3


def train_reckoning(cfg, batch: int, seq: int) -> dict:
    """The training state's device memory, derived from the config's
    shapes (not measured): 12 bytes a parameter standing under AdamW
    (bf16 parameter and gradient, float32 m and v), the float32 temporary
    of the update of the largest leaf, the logits in bf16 and float32."""
    import math
    from repro_torch.models.params import arch_layout

    n = cfg.param_count()
    largest = max(math.prod(p.shape) for p in arch_layout(cfg).values())
    logits = batch * seq * cfg.padded_vocab
    return {"params": n, "standing_gib": 12 * n / 2 ** 30,
            "largest_leaf": largest, "update_temp_gib": 4 * largest / 2 ** 30,
            "logits_bf16_gib": 2 * logits / 2 ** 30,
            "logits_f32_gib": 4 * logits / 2 ** 30}


def model_train_line(torch, np, cfg, card, cut: str):
    """Phase 27 (a): launch/train.train of `cfg`, TRAIN_STEPS steps of
    TRAIN_BATCH x TRAIN_SEQ tokens, no checkpoint; each step's metrics, the
    warm step time, tokens/s, TFLOP/s and peak memory; gated on finite
    losses and grad norms, a grad norm above 0, every parameter leaf
    changed but those initialised to ones (a bf16 1.0 moves by less than
    half an ulp at this lr), and no sort-kernel launch."""
    from repro_torch.launch.serve import seeded_params
    from repro_torch.launch.train import train
    from repro_torch.models import flops
    from repro_torch.models.lm import tree_paths
    from repro_torch.models.params import arch_layout

    emit({"measure": "train_memory_reckoning", "arch": cfg.name,
          "n_layers": cfg.n_layers, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          **train_reckoning(cfg, TRAIN_BATCH, TRAIN_SEQ),
          "derived": "from shapes, not measured", "card": card})
    steps, stamps = [], []

    def on_metrics(step, metrics, slow):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        steps.append({k: float(v) for k, v in metrics.items()})

    torch.cuda.reset_peak_memory_stats()
    (state, _), launches = launched(torch, lambda: train(
        cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        ckpt_dir=None, on_metrics=on_metrics, device="cuda"))
    peak = torch.cuda.max_memory_allocated()
    check_path_launches("train", launches, ())
    params, _ = state
    init = tree_paths(seeded_params(cfg, 0, "cuda"))
    unchanged = sorted(p for p, t in tree_paths(params).items()
                       if torch.equal(t, init[p]))
    # a leaf initialised to ones (the norms) moves by lr (at most 3e-4
    # here) a step, under half a bf16 ulp at 1.0: it may stay put
    ones = {p for p, spec in arch_layout(cfg).items() if spec.init == "ones"}
    losses = [m["loss"] for m in steps]
    norms = [m["grad_norm"] for m in steps]
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        fail(f"model_train: non-finite loss or grad norm ({losses}, {norms})")
    if min(norms) <= 0:
        fail(f"model_train: a grad norm of 0 ({norms})")
    if not set(unchanged) <= ones or len(unchanged) == len(init):
        fail(f"model_train: parameter leaves unchanged: {unchanged}")
    step_s = statistics.median(b - a for a, b in zip(stamps, stamps[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    emit({"measure": "model_train", "arch": cfg.name, "family": cfg.family,
          "n_layers": cfg.n_layers, "dtype": cfg.dtype,
          "optimizer": cfg.optimizer, "remat": cfg.remat,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
          "loss": losses, "grad_norm": norms,
          "lr": [m["lr"] for m in steps],
          "moe_dropped": [m.get("moe_dropped") for m in steps],
          "step_ms": step_s * 1e3,
          "step_ms_each": [(b - a) * 1e3 for a, b in zip(stamps,
                                                          stamps[1:])],
          "tok_per_s": tokens / step_s,
          "train_tflops": flops.model_flops(cfg, "train", TRAIN_SEQ,
                                            TRAIN_BATCH) / step_s / 1e12,
          "flops_note": "models/flops.model_flops(cfg, 'train'): 6 N D "
                        "plus attention; remat's second forward not counted",
          "peak_gib": peak / 2 ** 30,
          "leaves_changed": f"{len(init) - len(unchanged)}/{len(init)}",
          "unchanged_ones_leaves": unchanged,
          "launches": launches, "cut": cut, "card": card})
    del state, params
    free_device(torch)
    return launches


def train_dtype_probe_line(torch, np, cfg, card):
    """Phase 27 (a'): is (a)'s rise in loss a property of the model and
    the 4-step schedule, or a bf16 fault of the port? `cfg` at
    PROBE_LAYERS layers, TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ
    tokens from the same seed, for each (dtype, lr) of PROBE_RUNS: each
    run's losses and grad norms. A reading, gated on finite losses."""
    from repro_torch.launch.train import train

    runs = []
    t0 = time.perf_counter()
    for dtype, lr in PROBE_RUNS:
        c = dataclasses.replace(cfg, n_layers=PROBE_LAYERS, dtype=dtype)
        norms = []
        _, losses = train(
            c, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
            ckpt_dir=None, lr=lr, device="cuda",
            on_metrics=lambda s, m, slow: norms.append(float(m["grad_norm"])))
        free_device(torch)
        if not np.isfinite(losses).all():
            fail(f"train_dtype_probe: non-finite loss ({dtype}, lr {lr}: "
                 f"{losses})")
        runs.append({"dtype": dtype, "lr": lr, "loss": losses,
                     "grad_norm": norms})
    emit({"measure": "train_dtype_probe", "arch": cfg.name,
          "n_layers": PROBE_LAYERS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "steps": TRAIN_STEPS, "runs": runs,
          "wall_s": time.perf_counter() - t0, "card": card})


def flash_grad_line(torch, card):
    """Phase 27 (b): the flash Function's dq, dk, dv (and output) against
    plain autograd through attention_full at Phi-3.5-MoE's head shape,
    batch 1, float32, causal, within FLASH_TOL; and each one's warm time
    (forward and backward, median of 3)."""
    from repro_torch.models.layers import attention_chunked, attention_full
    from repro_torch.sort.api import resolve_device

    f = FLASH_SHAPE
    dev = resolve_device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def draw(h):
        return torch.randn((1, f["seq"], h, f["head_dim"]), generator=g,
                           device=dev, dtype=torch.float32)

    q, k, v = draw(f["heads"]), draw(f["kv_heads"]), draw(f["kv_heads"])
    do = draw(f["heads"])

    def run(fn):
        qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*qkv)
        return (out.detach(),) + torch.autograd.grad(out, qkv, do)

    flash = lambda *a: attention_chunked(*a, causal=True, chunk=f["chunk"])
    full = lambda *a: attention_full(*a, causal=True)
    got, want = run(flash), run(full)
    diffs = {name: float((a - b).abs().max())
             for name, a, b in zip(("out", "dq", "dk", "dv"), got, want)}
    if max(diffs.values()) > FLASH_TOL:
        fail(f"flash_grad_check: {diffs} over {FLASH_TOL}")
    times = {}
    for name, fn in (("flash_ms", flash), ("full_ms", full)):
        times[name] = median_ms(torch, lambda fn=fn: run(fn), reps=3)[0]
    emit({"measure": "flash_grad_check", **f, "batch": 1, "dtype": "float32",
          "causal": True, "max_abs_diff": diffs, "tol": FLASH_TOL,
          "tol_source": "tests/test_attention.py:46", **times, "card": card})
    del q, k, v, do, got, want
    free_device(torch)


@contextlib.contextmanager
def drill_observer(torch):
    """While the block runs: keep the supervisors train() builds (with
    keep DRILL_KEEP), each save's seconds and bytes and the snapshot it
    wrote, and for each restore its step and whether its tensors equal
    that step's snapshot (compared as restored: the step then updates
    them in place), whether it wrote into the supervisor's own tensors
    and the device bytes it allocated."""
    import os

    import repro_torch.ckpt.checkpoint as ck
    import repro_torch.launch.train as tr
    import repro_torch.runtime.ft as ft
    from repro_torch.models.lm import tree_leaves

    real_sup, real_save, real_restore = tr.TrainSupervisor, ck.save, \
        ft.restore
    seen = {"supervisors": [], "saves": [], "snapshots": {}, "restored": []}

    def supervisor(*a, **kw):
        sup = real_sup(*a, **{**kw, "keep": DRILL_KEEP})
        seen["supervisors"].append(sup)
        return sup

    def save(ckpt_dir, step, tree, **kw):
        t0 = time.perf_counter()
        final = real_save(ckpt_dir, step, tree, **kw)
        seconds = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(final, n))
                   for n in os.listdir(final))
        seen["saves"].append({"step": step, "s": seconds, "bytes": size})
        seen["snapshots"][step] = tree
        return final

    def restore(ckpt_dir, step, like, **kw):
        before = torch.cuda.memory_allocated()
        out = real_restore(ckpt_dir, step, like, **kw)
        grown = torch.cuda.memory_allocated() - before
        leaves = tree_leaves(list(out[0]))
        in_place = all(a is b for a, b in zip(leaves,
                                              tree_leaves(list(like))))
        equal = all(a.dtype == b.dtype and torch.equal(a.cpu(), b)
                    for a, b in zip(leaves, tree_leaves(
                        list(seen["snapshots"][step]))))
        seen["restored"].append((step, equal, in_place, grown))
        return out

    tr.TrainSupervisor, ck.save, ft.restore = supervisor, save, restore
    try:
        yield seen
    finally:
        tr.TrainSupervisor, ck.save, ft.restore = real_sup, real_save, \
            real_restore


def train_drill_line(torch, np, cfg, card):
    """Phase 27 (c): train() of `cfg` for DRILL_STEPS steps twice without
    a checkpoint and once under TrainSupervisor (a checkpoint every
    DRILL_SAVE_EVERY steps, keep DRILL_KEEP, a failure raised after step
    DRILL_FAIL_AT): the two uninterrupted runs equal bit for bit, one
    restart, the restored tensors equal to the saved snapshot and
    written into the state's own tensors (no device bytes allocated), and
    the resumed steps' losses equal to the uninterrupted run's bit for
    bit."""
    import os
    import shutil
    import tempfile

    from repro_torch.launch.train import train

    kw = dict(steps=DRILL_STEPS, batch=DRILL_BATCH, seq=DRILL_SEQ,
              device="cuda")
    plain = [train(cfg, ckpt_dir=None, on_metrics=lambda *a: None, **kw)[1]
             for _ in range(2)]
    free_device(torch)
    deterministic = plain[0] == plain[1]
    failed = []

    def on_metrics(step, metrics, slow):
        if step == DRILL_FAIL_AT and not failed:
            failed.append(step)
            raise RuntimeError("injected failure (chip_smoke drill)")

    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        with drill_observer(torch) as seen:
            _, history = train(cfg, ckpt_dir=d, save_every=DRILL_SAVE_EVERY,
                               on_metrics=on_metrics, **kw)
        wall_s = time.perf_counter() - t0
        kept = sorted(os.listdir(d))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    (sup,) = seen["supervisors"]
    if sup.restarts != 1 or len(seen["restored"]) != 1:
        fail(f"train drill: {sup.restarts} restarts, "
             f"{len(seen['restored'])} restores (want 1 and 1)")
    step, equal, in_place, grown = seen["restored"][0]
    if not equal:
        fail(f"train drill: the tensors restored at step {step} differ from "
             "those saved")
    # the restore writes into the state the step updates: one copy of the
    # state on the card across a restart
    if not in_place or grown > 0:
        fail(f"train drill: the restore made a second copy of the state "
             f"(in place {in_place}, {grown} device bytes allocated)")
    # history: steps 0..DRILL_FAIL_AT, then step..DRILL_STEPS-1 again
    resumed = history[DRILL_FAIL_AT + 1:]
    want = plain[0][step:]
    # the step is deterministic on the card (PERF.md §6), so the
    # gate is bit for bit
    if not deterministic:
        fail(f"train drill: two uninterrupted runs differ ({plain})")
    if resumed != want:
        fail(f"train drill: resumed losses {resumed} != {want}")
    emit({"measure": "train_drill", "arch": cfg.name,
          "n_layers": cfg.n_layers, "dtype": cfg.dtype, "batch": DRILL_BATCH,
          "seq": DRILL_SEQ, "steps": DRILL_STEPS,
          "save_every": DRILL_SAVE_EVERY, "keep": DRILL_KEEP,
          "failed_after_step": DRILL_FAIL_AT, "restored_step": step,
          "restarts": sup.restarts, "restored_equal_saved": equal,
          "restored_in_place": in_place, "restore_alloc_bytes": grown,
          "deterministic": deterministic,
          "uninterrupted_losses": plain, "resumed_losses": resumed,
          "saves": seen["saves"],
          "kept": kept, "wall_s": wall_s, "card": card})
    free_device(torch)


def train_phase(torch, np, card):
    """Phase 27: the model stack's training path on the card: (a) Phi-3.5-
    MoE at full width, 2 of 32 layers, launch/train.train of 8 x 2,048
    tokens; (a') the same at 1 layer in bf16 and float32; (b) the flash
    backward against plain autograd; (c) the mamba2-370m supervisor
    drill."""
    from repro_torch.configs import get_config

    phi = dataclasses.replace(get_config(SERVE_ARCH), n_layers=TRAIN_LAYERS)
    launches = model_train_line(
        torch, np, phi, card,
        cut=f"n_layers {TRAIN_LAYERS} of 32: AdamW holds 12 bytes a "
            "parameter, 32.0 GiB at 2 layers, 46.5 GiB at 3 plus 3.1 GiB a "
            "float32 update temporary")
    train_dtype_probe_line(torch, np, phi, card)
    flash_grad_line(torch, card)
    train_drill_line(torch, np, get_config(MAMBA_ARCH), card)
    return {"train": launches}


#: Phase 28: the launch layer on the card. (a) The dry run of every cell
#: of cells(ARCH_IDS) on both production meshes, on `meta`, in DRY_JOBS
#: worker processes that see no card (CUDA_VISIBLE_DEVICES empty), both
#: meshes' 80 cells in one pool, the costliest shapes first (DRY_ORDER):
#: 32 OK and 8 SKIP(full-attention) a mesh, within DRY_BUDGET_S. The
#: records go to DRY_OUT. (b) Phase 27's cell (Phi-3.5-MoE at
#: full width, 2 of 32 layers, bf16, AdamW, 8 x 2,048 tokens) reckoned on
#: a (1, 1) mesh against the card: the argument bytes against
#: memory_allocated() with the parameters, state and batch on the card
#: (the caching allocator rounds each tensor up to 512 bytes), the FLOPs
#: against FlopCounterMode's count of the real step. (c) The same cell
#: trained at dp 2 x tp 2 beside dp 1, and decode against forward at dp 2
#: x tp 2 (2 layers, float32). (d) hillclimb's kimi_base and
#: granite_base. (e) The card's bf16 matmul and copy rates beside the
#: datasheet constants hillclimb uses. (f) The five examples at their
#: defaults, each a subprocess.
DRY_JOBS = 7
#: the same 80 cells took 95.8 s to 154.9 s in calls on one card type
#: (the host's CPUs vary; PERF.md §6): 240 s leaves a margin
DRY_BUDGET_S = 240.0
#: the shapes by their cells' cost on `meta` (469, 191, 21 and 19 s of
#: cell time over both meshes in one H100 machine's run)
DRY_ORDER = ("prefill_32k", "train_4k", "decode_32k", "long_500k")
DRY_OUT = "experiments/dryrun_torch.json"
DP_STEP = dict(dp_size=2, tp_size=2)
#: The dp 2 x tp 2 decode check's capacity factor: Phi's 16 experts, so
#: that each expert's capacity holds every token a grid shard routes
#: (cap >= t_local * k at any tp) and neither the forward nor the prefill
#: drops one. Where they drop, each shard's capacity is cut for its own
#: t_local (32 tokens in the 64-token forward, 16 in the prefill) and the
#: reference's own decode leaves its forward too:
#: tests/test_torch_dp.py::test_decode_against_forward_at_dp2_tp2 holds
#: the port's prefill and decode to the reference's at 1e-5 there.
CHECK_CAPACITY_DP = 16.0
PEAK_N, PEAK_REPS = 8192, 20
COPY_BYTES = 1 << 30
EXAMPLES = ("torch_quickstart", "torch_sort_load", "torch_sort_service",
            "torch_moe_routing", "torch_train_lm")
EXAMPLE_TIMEOUT_S = 240
HILLCLIMB = ("kimi_base", "granite_base")
#: the launch layer runs no sort: its paths launch no kernel
PATH_KERNELS.update({"dryrun_vs_card": (), "dp_step": (), "hillclimb": ()})


def dryrun_line(torch, card):
    """Phase 28 (a): every cell on both production meshes, gated on the
    statuses, on the seconds, on no device bytes allocated in this
    process (one cell run here) and on none visible to the workers."""
    import os

    from repro_torch.configs import ARCH_IDS, cells
    from repro_torch.launch.dryrun import run_cell, run_cells

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    here = run_cell("kimi-k2-1t-a32b", "train_4k", False)
    here_s = time.perf_counter() - t0
    grown = torch.cuda.memory_allocated() - before
    peak_grown = torch.cuda.max_memory_allocated() - before
    if here["status"] != "OK" or grown or peak_grown:
        fail(f"dryrun: kimi train_4k in this process: {here['status']}, "
             f"{grown} device bytes held, {peak_grown} at the peak")
    keys = sorted(((a, s, multi) for multi in (False, True)
                   for a, s, _ in cells(ARCH_IDS)),
                  key=lambda k: DRY_ORDER.index(k[1]))
    hidden = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""      # the workers see no card
    try:
        t0 = time.perf_counter()
        records = list(run_cells(keys, DRY_JOBS))
        seconds = time.perf_counter() - t0
    finally:
        if hidden is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = hidden
    out = ROOT / DRY_OUT
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(records, indent=1))
    meshes = {}
    for name in ("16x16", "2x16x16"):
        recs = [r for r in records if r["mesh"] == name]
        status = [r["status"] for r in recs]
        meshes[name] = {
            "cells": len(recs), "ok": status.count("OK"),
            "skip": sum(st.startswith("SKIP") for st in status),
            "fail": [f"{r['arch']} {r['shape']}: {r['status']} "
                     f"{r.get('error', '')[:200]}" for r in recs
                     if r["status"].startswith("FAIL")],
            "cell_seconds": sum(r.get("calib_s", 0.0) for r in recs)}
        m = meshes[name]
        if m["fail"] or (m["ok"], m["skip"]) != (32, 8):
            fail(f"dryrun {name}: {m['ok']} OK, {m['skip']} SKIP (want "
                 f"32, 8), failures {m['fail']}")
    if seconds > DRY_BUDGET_S:
        fail(f"dryrun: {seconds:.1f} s for both meshes, over the "
             f"{DRY_BUDGET_S} s budget")
    ok = [r for r in records if r["status"] == "OK"]
    top = max(ok, key=lambda r: r["memory"]["peak_live_bytes"])
    emit({"measure": "dryrun", "jobs": DRY_JOBS, "meshes": meshes,
          "seconds": seconds, "budget_s": DRY_BUDGET_S,
          "in_process": {"cell": "kimi-k2-1t-a32b train_4k 16x16",
                         "seconds": here_s, "device_bytes": grown,
                         "peak_device_bytes": peak_grown,
                         "peak_live_gib": here["memory"]["peak_live_bytes"]
                         / 2 ** 30},
          "largest_peak": {"cell": f"{top['arch']} {top['shape']} "
                                   f"{top['mesh']}",
                           "peak_live_gib": top["memory"]["peak_live_bytes"]
                           / 2 ** 30},
          "records": DRY_OUT, "card": card})


def dryrun_vs_card_line(torch, np, card):
    """Phase 28 (b): phase 27's cell reckoned on a (1, 1) mesh against the
    card: argument bytes against the bytes the card holds for them, FLOPs
    against FlopCounterMode's count of the real step, the reckoned peak
    beside max_memory_allocated and models/flops.model_flops."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import Shape
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.launch.dryrun import cell_figures
    from repro_torch.launch.mesh import make_ctx
    from repro_torch.launch.serve import seeded_params
    from repro_torch.models import flops
    from repro_torch.models.lm import tree_leaves
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import cosine_schedule, make_optimizer
    from repro_torch.parallel.ctx import Mesh

    cfg = dataclasses.replace(get_config(SERVE_ARCH), n_layers=TRAIN_LAYERS)
    shape = Shape("phase27", "train", TRAIN_SEQ, TRAIN_BATCH)
    ctx = make_ctx(cfg, Mesh(("data", "model"), (1, 1)))
    t0 = time.perf_counter()
    mem, cal = cell_figures(cfg, shape, ctx)
    dry_s = time.perf_counter() - t0

    def run():
        free_device(torch)
        base = torch.cuda.memory_allocated()
        params = seeded_params(cfg, 0, "cuda")
        opt = make_optimizer(cfg.optimizer)
        state = opt.init(params)
        tokens, labels = SyntheticTokens(
            vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
            seed=0).batch(0)
        batch = {"tokens": torch.from_numpy(tokens).cuda(),
                 "labels": torch.from_numpy(labels).cuda()}
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        n = len(tree_leaves((params, state, batch)))
        step = make_train_step(cfg, ctx, opt,
                               cosine_schedule(3e-4, 2000, 100_000))
        with FlopCounterMode(display=False) as counter:
            step(params, state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(params, state, batch)
        torch.cuda.synchronize()
        return held, n, counter.get_total_flops(), \
            torch.cuda.max_memory_allocated()

    (held, n, card_flops, peak), launches = launched(torch, run)
    free_device(torch)
    check_path_launches("dryrun_vs_card", launches, ())
    if abs(held - mem["argument_bytes"]) > 512 * n:
        fail(f"dryrun_vs_card: argument bytes {mem['argument_bytes']} "
             f"against {held} on the card ({n} tensors)")
    if int(round(cal["flops"])) != card_flops:
        fail(f"dryrun_vs_card: dry-run FLOPs {cal['flops']} against "
             f"{card_flops} counted on the card")
    emit({"measure": "dryrun_vs_card", "arch": cfg.name,
          "n_layers": cfg.n_layers, "dtype": cfg.dtype, "batch": TRAIN_BATCH,
          "seq": TRAIN_SEQ, "mesh": "1x1", "dry_s": dry_s,
          "argument_bytes": mem["argument_bytes"], "card_bytes": held,
          "tensors": n, "tolerance_bytes": 512 * n,
          "flops_dry": cal["flops"], "flops_card": card_flops,
          "model_flops": flops.model_flops(cfg, "train", TRAIN_SEQ,
                                           TRAIN_BATCH),
          "reckoned_peak_gib": mem["peak_live_bytes"] / 2 ** 30,
          "reckoned_temp_gib": mem["temp_bytes"] / 2 ** 30,
          "max_allocated_gib": peak / 2 ** 30,
          "launches": launches, "card": card})
    return launches


def dp_step_line(torch, np, card):
    """Phase 28 (c): phase 27's cell trained for TRAIN_STEPS steps at dp 2
    x tp 2 and at dp 1: losses (gated finite), drops a step, the warm
    step time and the peak; then decode against forward at dp 2 x tp 2
    (2 layers, float32, CHECK_TOL)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.parallel.ctx import ParallelCtx

    cfg = dataclasses.replace(get_config(SERVE_ARCH), n_layers=TRAIN_LAYERS)
    runs = {}
    launches = {}
    for name, ctx in (("dp2_tp2", ParallelCtx(**DP_STEP)),
                      ("dp1_tp1", ParallelCtx())):
        stamps, steps = [], []

        def on_metrics(step, metrics, slow):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            steps.append({k: float(v) for k, v in metrics.items()})

        free_device(torch)
        torch.cuda.reset_peak_memory_stats()
        state, launches[name] = launched(torch, lambda: train(
            cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
            ckpt_dir=None, ctx=ctx, on_metrics=on_metrics, device="cuda"))
        peak = torch.cuda.max_memory_allocated()
        del state           # one run's state on the card at a time
        check_path_launches(f"dp_step[{name}]", launches[name], ())
        losses = [m["loss"] for m in steps]
        if not np.isfinite(losses).all():
            fail(f"dp_step {name}: non-finite loss ({losses})")
        step_s = statistics.median(b - a for a, b in zip(stamps, stamps[1:]))
        runs[name] = {"dp": ctx.dp_size, "tp": ctx.tp_size, "loss": losses,
                      "moe_dropped": [m["moe_dropped"] for m in steps],
                      "step_ms": step_s * 1e3,
                      "step_ms_each": [(b - a) * 1e3 for a, b in
                                       zip(stamps, stamps[1:])],
                      "peak_gib": peak / 2 ** 30}
    free_device(torch)
    emit({"measure": "dp_step", "arch": cfg.name, "n_layers": cfg.n_layers,
          "dtype": cfg.dtype, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "steps": TRAIN_STEPS, "runs": runs,
          "launches": launches["dp2_tp2"], "card": card})
    check = dict(n_layers=CHECK_LAYERS, dtype="float32",
                 moe_capacity_factor=CHECK_CAPACITY_DP)
    decode_check_line(torch, np, dataclasses.replace(
        get_config(SERVE_ARCH), **check), card, "phi3.5-moe check at dp 2",
        ctx=ParallelCtx(**DP_STEP),
        cut=f"n_layers {CHECK_LAYERS} of 32, float32, capacity factor "
            f"{CHECK_CAPACITY_DP}")
    return launches["dp2_tp2"]


def hillclimb_line(torch, card):
    """Phase 28 (d): hillclimb's kimi_base and granite_base on `meta`,
    with their roofline terms."""
    from repro_torch.launch import hillclimb

    recs = []

    def run():
        for exp in HILLCLIMB:
            t0 = time.perf_counter()
            rec = hillclimb.measure(*hillclimb.EXPERIMENTS[exp])
            recs.append({"exp": exp, **rec,
                         "seconds": time.perf_counter() - t0})

    _, launches = launched(torch, run)
    check_path_launches("hillclimb", launches, ())
    emit({"measure": "hillclimb", "experiments": recs,
          "constants": {"peak_flops": hillclimb.PEAK,
                        "hbm_bytes_per_s": hillclimb.HBM,
                        "collective_bytes_per_s": hillclimb.COLLECTIVE},
          "card": card})
    return launches


def card_peaks_line(torch, card):
    """Phase 28 (e): the card's bf16 torch.matmul rate at PEAK_N^3 and its
    device-to-device copy rate (COPY_BYTES read and written), by CUDA
    events, beside the datasheet constants hillclimb uses."""
    from repro_torch.launch import hillclimb

    a = torch.randn((PEAK_N, PEAK_N), device="cuda", dtype=torch.bfloat16)
    b = torch.randn((PEAK_N, PEAK_N), device="cuda", dtype=torch.bfloat16)
    mm_ms = time_ms(torch, lambda: torch.matmul(a, b), PEAK_REPS)
    x = torch.empty(COPY_BYTES, dtype=torch.uint8, device="cuda")
    y = torch.empty_like(x)
    copy_ms = time_ms(torch, lambda: y.copy_(x), PEAK_REPS)
    del a, b, x, y
    free_device(torch)
    tflops = 2 * PEAK_N ** 3 / (mm_ms / 1e3) / 1e12
    gbps = 2 * COPY_BYTES / (copy_ms / 1e3) / 1e9
    emit({"measure": "card_peaks", "matmul_n": PEAK_N, "matmul_ms": mm_ms,
          "bf16_tflops": tflops,
          "datasheet_bf16_tflops": hillclimb.PEAK / 1e12,
          "copy_bytes": COPY_BYTES, "copy_ms": copy_ms,
          "copy_gb_per_s": gbps, "datasheet_hbm_gb_per_s": hillclimb.HBM / 1e9,
          "card": card})


def examples_line(card):
    """Phase 28 (f): each example at its defaults, a subprocess on the
    card: exit 0 and its seconds."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = []
    for name in EXAMPLES:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(ROOT / "examples" /
                                                   f"{name}.py")],
                              cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=EXAMPLE_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        if proc.returncode:
            fail(f"example {name}: exit {proc.returncode}\n"
                 f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
        runs.append({"example": name, "seconds": seconds,
                     "last_line": proc.stdout.strip().splitlines()[-1]})
    emit({"measure": "examples", "runs": runs, "card": card})


def launch_phase(torch, np, card):
    """Phase 28: the launch layer on the card ((a)-(f) above)."""
    dryrun_line(torch, card)
    paths = {"dryrun_vs_card": dryrun_vs_card_line(torch, np, card),
             "dp_step": dp_step_line(torch, np, card),
             "hillclimb": hillclimb_line(torch, card)}
    card_peaks_line(torch, card)
    examples_line(card)
    return paths


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        print(f"chip_smoke: needs numpy and torch ({exc})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import cuda
    except ImportError as exc:
        print(f"chip_smoke: run it from the repository root ({exc})",
              file=sys.stderr)
        return 2

    card = card_line()
    emit({"measure": "toolchain", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "card": card})

    t0 = time.perf_counter()
    path = cuda.build(force=True)
    cuda.library()
    emit({"measure": "build", "seconds": time.perf_counter() - t0,
          "library": str(path), "card": card})
    ptxas_line(card)
    ptxas_wide_line(card)

    rows = kernel_phase(torch, card, empty_launch_line(torch, card),
                        k4_sass_line(card))
    cascade_line(torch, card)
    seen = set()            # every kernel call's shape on the main paths
    with kernel_shapes(seen):
        paths = {"sort": slice_phase(torch, np, card),
                 "sort_batched": batched_phase(torch, np, card)}
    timing_phase(torch, np, card)
    batched_timing_phase(torch, np, card)
    with kernel_shapes(seen):
        paths.update(recovery_phase(torch, np, card))
        paths.update(permutation_phase(torch, np, card))
        paths.update(tagged_phase(torch, np, card))
        paths.update(baselines_phase(torch, np, card))
    recovery_timing_phase(torch, np, card)
    baselines_timing_phase(torch, np, card)
    with kernel_shapes(seen):
        paths.update(verify_phase(torch, np, card))
        paths.update(corruption_phase(torch, np, card))
        paths.update(clamp_phase(torch, np, card))
        paths.update(slo_phase(torch, np, card))
        paths.update(grouping_phase(torch, np, card))
    grouping_timing_phase(torch, np, card)
    with kernel_shapes(seen):
        paths.update(serve_phase(torch, np, card))
        drills_phase(torch, np, card)
        paths.update(bucketing_phase(torch, np, card))
    serve_timing_phase(torch, np, card)
    analysis_phase(torch, np, card)
    sync_audit_phase(torch, np, card)
    with kernel_shapes(seen):
        paths.update(legacy_phase(torch, np, card))
        paths.update(model_phase(torch, np, card))
        paths.update(train_phase(torch, np, card))
        paths.update(launch_phase(torch, np, card))
    shapes = path_shapes_phase(torch, seen, card)
    for r in rows:
        r["launches_by_path"] = {k: v[r["counter"]] for k, v in paths.items()}
        r["launches"] = r["launches_by_path"][r["path"]]
        if r["counter"] in shapes:
            r["shapes_checked"] = sorted(
                {tuple(s) for s in r.get("shapes_checked", [])}
                | {tuple(s) for s in shapes[r["counter"]]})

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
