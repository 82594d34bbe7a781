#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one CUDA card, `nvcc` and a checkout of the repository around this
file; exits non-zero, printing no result, without them.  Phases:

1. Environment: Python, torch, CUDA and nvcc versions, the card's name
   and power limit, and the time `nvcc` takes to build every kernel
   source under `src/repro_torch/kernels/csrc/` (one nvcc per source,
   all at once).
2. Cut kernels against their plain PyTorch versions on the card, at the
   main paths' shapes (white-wine (8, 242,628), domain adaptation (2,
   925,590)) and a few ragged ones, in f32 and bf16: forward values,
   first and second derivatives through the MV/VM/OUTER autograd
   Functions, one launch a `matvec` and a `vecmat` call and their bitwise
   repeatability, and device times (CUDA events around back-to-back calls
   on operands that together overflow the L2 cache) beside the
   memory-rate bound, the plain version and one library call; `matvec`
   must be no slower than `torch.mv` at both main shapes, in f32 and in
   bf16, and `vecmat` no slower than `g @ A` in f32.
3. The fused level-2 round kernel against its plain version at both main
   shapes, (3, 1,025) and (64, 242,628) (above what the SMs' shared
   memory holds: A streamed), f32 and bf16: one device kernel and one
   launch call per round under torch.profiler, the launch plan (blocks,
   columns, A held on chip or streamed), values of v_new / cv1 / s_new /
   gamma_new, a bitwise repeat, how many active rows take each branch of
   s' and gamma' (at white-wine, operands from the first seed that takes
   all four, which must occur in the kernel's result too), first
   derivatives and grad-of-grad through `FusedRound`, and device times
   beside the bound, the plain version and the three-call composition
   torch.mv / g @ A / torch.mv, which the kernel must not be slower than
   at both main shapes in f32.
4. White-wine robust HPO (Table 1: N=6, S=4, tau=10, one 5x straggler,
   MLP 11-16-1, K=4, P=8, t_pre=10, t1=400), 120 iterations through
   `run(RunSpec(engine="scan"))` in four routes: the plain cut route and
   the cut kernels (PR 11's main path), and with
   `Hyper(use_fused_inner=True)` the plain fused round and the fused
   kernel; after a warm-up, in turns.  Histories, cut counts and the
   final II-layer cuts, gamma_k and inner level-2 state must agree.
5. Domain adaptation (§5.2, Table 1's SVHN-pretrain setting: N=6, S=3,
   two 5x stragglers, tau=15, three LeNet-5s, 24/12 pretrain/finetune
   digits per worker, K=1, P=2, t_pre=20), 40 iterations with
   `use_fused_inner=True` through the kernels and through the plain
   versions; cuDNN held to f32 and deterministic algorithms.
6. Where the time goes: 20 iterations of white-wine (cut kernels, then
   the fused kernel; two refreshes each) and of domain adaptation (one
   refresh) under `torch.profiler`: the device's busy share and the
   kernels that fill it.
7. The LLM kernels against their plain versions on the card: flash
   attention at Llama-3 8B's prefill shape (B 4, S = T = 1024, H 32,
   Hkv 8, hd 128; windows 0 and 1024) and two ragged shapes, in bf16
   through the tensor-core kernel (plus Whisper's heads, hd 64, S = T =
   1500) and in f32 through the f32 tensor-core kernel (3xTF32), each
   launch checked against `flash_route`; at Gemma 3 12B's head dim 256
   (H 16, Hkv 8), in bf16 through the hd-256 tensor-core kernel and in
   f32 through the f32 one, at (B 4, S = T = 1024), Llama's flops, at
   Gemma's serving shapes (B 2, S = T = 2048, windows 0 and 1024) and
   at a ragged 1000, every one timed beside its bound, the plain
   version, `scaled_dot_product_attention` (a window as an explicit
   mask) and the SIMT kernel on the same inputs, which the hd-256 kernel
   must beat ten times over at the first and the f32 kernel twice over
   (F32_OVER_SIMT) at Llama's first row and Gemma's windowed one; the
   mLSTM chunk kernels at xLSTM-125M's chunk (B 4, H 4, L 256, hd 192)
   and at L = 100, with a carried state, in bf16 through the tensor-core
   kernel and in f32 through the f32 tensor-core kernel, each launch
   checked against `mlstm_route`; bitwise repeats, device times beside
   the bound, the plain version, (flash only)
   `scaled_dot_product_attention`, a yardstick the port never calls, and
   the SIMT kernels' times on the same inputs (the tensor-core mLSTM
   kernels must beat their SIMT kernel there, the f32 one twice over).
   Every f32 row holds the routed kernel and the SIMT kernel on the same
   inputs to FLASH_TOL / MLSTM_TOL, FLASH_ROW_TOL and the f32-grade
   limit F32_GRADE_TOL, and to a bitwise repeat.  The bf16 tensor-core
   mLSTM kernel's bound counts the products it runs (C and k w_k as two
   bf16 halves each, at the bf16 rate; `bound_ms_f32_qc` keeps the
   earlier definition, q C at the f32 rate); an f32 row's bound counts
   every product as three TF32 products (`bound_ms_f32`: at the f32
   rate of the CUDA cores).
8. Llama-3 8B serving at full width and depth (bf16, random weights from
   seed 0): `serve(batch=4, prompt_len=1024, gen=32)` on the kernel route
   and on the plain route; prefill logits of the two routes compared, and
   again in f32 with the depth cut to 2 layers; one prefill under
   `torch.profiler`.  The bf16 prefill launches the tensor-core flash
   kernel 32 times and no other; the f32 one only the f32 tensor-core
   kernel, 2 times.  The f32 prefill is timed in turns on its route and
   on the SIMT kernels (`simt_routes`, the f32 route before them).
9. xLSTM-125M serving at its full config (bf16): the same, with the f32
   run at full depth.  The bf16 prefill launches the tensor-core mLSTM
   kernel 40 times and no other; the f32 one only the f32 tensor-core
   kernel, 40 times.
10. The paper's evaluation (`repro_torch.experiments`), at the reference
   scripts' settings on the kernel route, each method and seed a `scan`
   run after the other (`engine="scan"`): Fig. 1 on all four datasets (Table 1: diabetes,
   boston and red wine N=4, S=3; white wine N=6, S=4; one 5x straggler,
   tau=10; 60 iterations, half the reference's, AFTO then SFTO), with
   diabetes again on the
   plain cut route; Fig. 2 in both directions (SVHN pretrain N=6, S=3,
   two stragglers, tau=15; MNIST pretrain N=4, S=3, one straggler,
   tau=5; 40 iterations; cuDNN held to f32 and deterministic); Table 2 on
   white wine, seed 0, at two thirds of the reference's `--fast` counts
   (AFTO and ADBO 200 iterations, FedNest 40); the Thm 4.5 rate check
   (400 iterations x 2 seeds) and the Thm 4.6 communication count (60
   iterations).  Per run: ms per master iteration and the cut kernels'
   launches (20 iterations of diabetes, MNIST pretrain and the rate
   problem, AFTO, under `torch.profiler` as in phase 6); every history
   must be finite, every AFTO-loop run (ADBO's too) must launch
   `matvec` and `vecmat`, and diabetes's kernel-route histories must
   equal the plain route's within rtol 1e-4 with the cut counts exact.
11. The sweep engine (`engine="sweep"`, R runs through one vmapped loop;
   its kernel checks run right after phase 3, its sweeps after phase 10).
   The batched cut kernels (`matvec_runs`, `vecmat_runs`, `rank1_runs`)
   against their plain batched versions at white wine (R = 2 and 4) and
   domain adaptation (R = 2), f32 and bf16: each row bitwise the
   single-run kernel on that run, one launch a call (the count and
   torch.profiler), a bitwise repeat, a shared operand at run stride 0;
   device times beside R x the single-run kernel's, the bound (R x the
   bytes) and `torch.bmm`, and matvec's layout (blocks x runs, how v
   arrives, blocks an SM).  vmap(grad), vmap(grad(grad)) and jvp through
   MV and FusedRound against the plain route (grad-of-grad against
   float64, as phase 2).  The batched fused round at white wine, R = 2
   (A on chip) and R = 4 (7 of its 8 rows on chip): its plan (blocks,
   rows held), values, rows bitwise the single-run kernel at the batched
   plan, one launch, times.  At white wine in f32 `matvec_runs` (R = 2
   and 4) and `fused_round_runs` (R = 4) may take at most RUNS_GATES of
   R x the single-run kernel's time.  Then the
   paper's sweeps on the kernel route, each swept row held to the serial
   `scan` run of its method and seed (histories within rtol 1e-4; cut
   counts, sim_time and max_staleness exact; final II-layer cut rows,
   gamma_k and inner level-2 state within 1e-4 of each tensor's largest
   entry), with functorch's per-run fallback turned off: Fig. 1 white
   wine (AFTO and SFTO as R = 2, against phase 10), phase 4's fused route
   at seeds 0 and 1 (row 0 against phase 4's run), Fig. 2 MNIST pretrain
   (against phase 10), Table 2 white wine at N = 4 (AFTO seeds 0 and 1 on
   stacked per-seed data, 60 iterations, against serial runs) and the
   rate check (`seeds=`, against phase 10); ms per iteration of each
   sweep and of its serial runs, and each sweep's launches (single-run
   kernels must not launch in a sweep).  `engine_speed.sweep_record`
   (R = 4 white-wine runs, 15 iterations) is printed, not gated, and 20
   swept white-wine iterations are profiled with the other profiles.
12. Streams, chunked runs and checkpoints, through `run(RunSpec(...))`
   only.  (a) The registry's streamed quadratic problem
   (src/repro/fed/runtime/problems.py:99-145; N=4, S=3, tau=5, one 5x
   straggler, K=3, P=6, t_pre=5) at dim 16,384, cut space (6, 180,224),
   A's scale held at the registry's operator norm (0.3 sqrt(3 / dim)):
   every iteration draws a fresh (A, b) per worker on the card (4.3 GB),
   60 iterations on the cut-kernel and the plain route, histories within
   rtol 1e-4 and cut counts exact, the multipliers and whether a cut
   binds, ms per iteration and the device time of one iteration's batch
   (CUDA events around `next_batch`); the same run in chunks [0, 23, 60]
   bit for bit.  (b) Phase 4's white wine on the cut-kernel and the
   fused route, 120 iterations recorded every iteration: unchunked, in
   chunks [0, 37, 80, 120] (`chunk_size`, a `chunk_hook` writing
   `repro_torch.checkpoint.save_checkpoint` at each boundary), and
   resumed from the step-80 checkpoint loaded into a fresh `init_state`,
   final states and histories (all but host_time) bit for bit; on a
   difference a second unchunked run tells a nondeterministic route from
   a chunking fault.  (c) (a) as a sweep of 2 (schedule seeds 0 and 1,
   one shared stream), each row held to its serial streamed run as in
   phase 11, through the batched kernels only.  (d) The launches of
   `matvec`, `vecmat`, `fused_round` and the `*_runs` kernels on (a)-(c)
   (each must launch; the kernel line's `launches_phase12`),
   `engine_speed.streamed_record` (printed, not gated), the phase's time,
   and 20 streamed iterations profiled with the other profiles.
13. The async federation runtime (`repro_torch.fed.runtime`), after
   phase 12.  (a) Phase 4's white wine (its schedule, 120 iterations)
   replayed through `run(RunSpec(engine="async", schedule=...))` over
   the in-process transport, six worker threads on the card, on the
   cut-kernel and the fused route, each held to phase 4's scan run of
   its route with phase 4's gate (histories within rtol 1e-4; cut
   counts, sim_time and max_staleness exact; final II-layer cut rows,
   gamma_k and level-2 inner state within 1e-4 of each tensor's largest
   entry), ms per master iteration beside phase 4's.  (b) A live run on
   the kernel route (30 iterations): recorded staleness within tau, its
   schedule replayed through the runtime bit for bit and through
   `run_scanned` within (a)'s gate.  (c) (a)'s kernel route checkpointed every 40
   iterations, stopped after 80 and resumed by a fresh master: bit for
   bit the uninterrupted run.  (d) `run_chaos_async` on white wine
   (lossy frames, worker 1 crashing at its 5th push and rejoining):
   completes, prints its deaths and rejoins, replays bit for bit.  (e)
   `serve fed --transport tcp --workers 4 --iters 60` with worker
   processes on the card, plain and `--stream` (its replay gate
   included), both exit 0 (started after (b), so that their processes
   come up beside (c) and (d)); beside them, in this process, a TCP run whose
   worker 0 is SIGKILLed and respawned with `--epoch 1`, and one with
   `--max-workers 5` whose late worker 4 widens the run, which replays
   bit for bit through `run_scanned_elastic` (these two side by side,
   each paced until its worker is back, then unpaced).  (f) The
   launches of `matvec`, `vecmat` and `fused_round` on (a)-(d) (each
   must launch; the kernel line's `launches_phase13`), the bytes of a
   white-wine push frame, and 20 async white-wine iterations profiled
   with the other profiles.
14. The worker-mesh sharded engine (`run(RunSpec(mesh=))`, one process
   per shard), after phase 13: one job of 4 gloo ranks sharing the card
   (`launch.mesh.spawn_mesh`), whose first 2, 3 and 4 ranks and, over
   NCCL, its first rank form the meshes (`make_worker_mesh`).  (a) Phase
   4's white wine (its schedule, 120 iterations, full width) on 2 and on
   3 ranks and (b) on the 1-rank NCCL mesh, each held to phase 4's
   unsharded plain-route run: every final state leaf within rtol 5e-5 /
   atol 1e-6, gap_sq within rtol 5e-4, cut counts, t, sim_time and
   max_staleness exact.  (c) Phase 12 (a')'s streamed quadratic at dim
   4,096 (60 iterations) on 2 and on 4 ranks, held to phase 12 (a')'s
   plain route the same way, a level-2 cut binding.  (d) White wine as
   a sweep of 2 (schedule seeds 0 and 1) on 2 ranks, each row held to
   phase 11's serial run of its seed.  (e) (a) on 2 ranks in chunks [0,
   37, 80, 120] with a checkpoint at each boundary, and resumed from the
   step-80 checkpoint: bit for bit (a).  (f) On every leg the bytes each
   rank all-reduced equal `core.sharded.traffic_record`'s, every rank's
   result is bitwise the same (replicated leaves included), ms per
   master iteration beside phase 4's unsharded plain scan, and the
   launches of every port kernel (none: the sharded path contracts the
   cuts with plain products; the kernel line's `launches_phase14`); 30
   white-wine iterations on 2 ranks with every all-reduce timed, the
   device synchronised first.
15. Gemma 3 12B serving at full width and depth (bf16, 48 layers, five
   local ones of window 1024 before each global one, head dim 256;
   random weights from seed 0, about 22 GiB), run right after phase 8:
   `serve(batch=2, prompt_len=2048, gen=32)`, so the window binds in 40
   layers and the decode rings wrap from the first step; the same checks
   as phase 8, the bf16 prefill holding the hd-256 kernel to exactly 48
   launches, the f32 evaluation of the bf16 weights taken one block at a
   time, and the f32 copy cut to one period (six layers) on the f32
   tensor-core kernel, 6 launches, timed as phase 8's; one prefill
   profiled, with the hd-256 kernel's share of the busy time.

16. The LLM training path (`repro_torch.launch.train`, after phase 14).
   (a) xLSTM-125M at full size (bf16, 66M parameters, nothing cut) on
   the driver's AFTO defaults (sketch r 256, N 4, per-worker batch 2,
   sequence 129, tau 10) with t_pre 10 at lr TRAIN_LR: the chunked
   engine for 20 iterations in chunks of 10 (kept for phase 19), the
   eager engine for 10, a `--stream` run of 6 checkpointing every 3 and
   a run resumed from its step-3 checkpoint; eager bitwise the chunked
   run after its first refresh, resumed bitwise the uninterrupted
   streamed run, losses finite, an active cut in both
   polytopes after every refresh, no kernel launched by a step or a
   refresh, the validation forwards on the bf16 mLSTM kernel, whose loss
   meets the bf16 route rule (PERF.md §2) against the plain route and an
   f32 evaluation, and each of whose kernel calls is held to its plain
   version on the call's inputs (ROUTE_ROW_TOL); ms per iteration and per refresh, peak
   `torch.cuda.max_memory_allocated`, and the chunked run's last two
   iterations and its second refresh under torch.profiler.  (b) Llama-3
   8B's widths at one layer (bf16, 1.27B parameters): four plain AdamW
   steps (batch 2 x 2, sequence 129) and one AFTO step (N 2, batch 1,
   sketch r 4096), finite, no kernel launched; the validation forward on
   the bf16 flash kernel under the same rule; peak memory.  (c) Reduced
   llama3-8b and xlstm-125m (f32) from one initial state made on the
   CPU: 4 AFTO iterations with one refresh (t_pre 2), each stage run on
   the card from the CPU's state before it and held to the CPU's, every
   state leaf within its arch's and block's limit of its largest
   magnitude (CARD_CPU_TOL; ROADMAP.md Queue 3 items 16-17), cut
   `active` and `age` exact; and the card's own 4 iterations held to
   the CPU's within TRAJECTORY_TOL and within TRAJECTORY_OVER_ULP x what
   one ulp in the starting weights moves the card's.  (d) Each kernel wrapper, handed a CUDA
   tensor that requires grad or one inside `torch.func.grad`, raises.

17. Mamba, MoE and Whisper's encoder served (after phase 9), each at full
   width in bf16 (random weights from seed 0), the depth cut to what the
   card holds (`phase17_cfgs`): Jamba v0.1 one period of its pattern (8
   layers: 7 Mamba, 1 attention, 4 MoE of 16 experts, top 2; batch 4,
   1,024-token prompts), Mixtral 8x22B 4 layers (batch 2, 5,120-token
   prompts past its 4,096-token window, so the decode ring wraps), Kimi
   K2 its dense first layer and one MoE layer of 384 experts, top 8
   (batch 4, 1,024), Whisper large-v3 whole, 32 encoder and 32 decoder
   layers (batch 4, 1,500 frames, 416-token prompts); 32 tokens each.
   The checks of phase 8 through `serve_phase`: the bf16 prefill
   launches the bf16 flash kernel exactly 1 / 4 / 2 / 96 times (Whisper:
   32 non-causal encoder layers, 32 causal, 32 cross-attention over the
   frames), the plain route none; each bf16 prefill within 5e-2 of the
   plain route and within the f32-distance gate (`f32_logits` widens
   Kimi K2's experts a group at a time); each f32 copy (Jamba pattern
   positions 0-3, Mixtral 1 layer, Kimi K2 the dense layer, Whisper 2 +
   2 layers) on the f32 flash kernel within 2e-3 of its plain route; and
   per model the prefill and decode times, peak memory, busy shares, the
   MoE assignments dropped per prefill and per decode step, and the
   prefill's model-FLOP rate (`step_flops`) against the bf16 peak,
   beside the card's name and power limit.

18. The dry-run against the card (after phase 16): the counts of
   `repro_torch.launch.dryrun.run_one` on a 1 x 1 mesh (meta tensors,
   traced in two processes started before phase 16, `start_counts`)
   for Llama-3 8B's bf16 prefill at (4, 1024) on the kernel and the
   plain route, Jamba's one-period prefill at (4, 1024), xLSTM-125M's
   AFTO step and refresh at phase 16 (a)'s settings and the one-layer
   Llama-3 8B step and refresh at phase 16 (b)'s (the refresh only
   where the count is under DRYRUN_REFRESH_FITS), each held to the card:
   the counted argument bytes within DRYRUN_ARG_TOL of the bytes the
   call's arguments keep resident, the counted temp within
   DRYRUN_TEMP_TOL of `torch.cuda.max_memory_allocated()` above them
   (from `reset_peak_memory_stats()` just before the call), and the
   roofline's compute term no longer than the call; each reading beside
   the card's name and power limit.

19. The LLM federation over a worker mesh (`launch.train --mesh-workers`,
   after phases 16 and 18): one job of 2 gloo ranks sharing the card
   (`launch.mesh.spawn_mesh`), whose first rank alone also forms a
   1-rank NCCL mesh.  (a) xLSTM-125M at full size (bf16) on phase 16
   (a)'s settings, N 4 on the 2 ranks, 20 iterations in chunks of 10
   through `launch.train.run_afto_on_mesh`: losses finite, an active cut
   in both polytopes after each refresh, no kernel launched by a step or
   a refresh, rank 0's validation forwards on the bf16 mLSTM kernel,
   each call held to its plain version (ROUTE_ROW_TOL), the replicated
   leaves bitwise equal across ranks, and the gathered state and the
   logged losses held to phase 16 (a)'s unsharded chunked run
   (MESH_TRAIN_TOL, MESH_LOSS_RTOL); the gate sits between that reading
   and two faults planted in the step's sum (a dropped theta sum, rank
   1's b-part of the cut values left out) over MESH_FAULT_ITERATIONS
   iterations from the state after the first refresh, `plant`ed so
   that the sums carry: each must read beyond the gate or split the
   ranks' replicated leaves.  (b) Reduced llama3-8b and xlstm-125m
   (f32), N 4, in exact and sketch cut modes, on the 2 ranks and on the
   1-rank NCCL mesh: 4 iterations with one refresh (t_pre 2) from a
   `plant`ed state (each rank plants one arch's and hands them to the
   other), each held to the card's unsharded run from the same state,
   which the second rank runs beside the first's NCCL legs (every leaf
   within its arch's CARD_CPU_TOL limit of its largest
   magnitude: the cut blocks of ROADMAP.md Queue 3 item 16 at theirs,
   each block taken as one vector as sketch mode stores it, the rest at
   1e-4 for llama3-8b and at Queue 3 item 17's 3e-3 for reduced xLSTM;
   cut active / age exact); whether the 1-rank mesh is bitwise
   is printed.
   (c) On (a) and (b) each rank's all-reduced bytes by label equal
   `fed.trilevel_llm_sharded.llm_traffic`'s, and on (a) each rank's
   resident state equals `fed.sharding.local_bytes` of the layout; ms
   per iteration and refresh beside phase 16 (a)'s, the share of the
   wall time in all-reduces (device synchronised first) and each rank's
   peak `max_memory_allocated`, beside the card's name and power limit;
   the kernel line's `launches_phase19`.

Each phase ends with a `[clock]` line (its seconds and the script's),
also on standard error; past WATCHDOG_S seconds every thread's stack
goes to standard error.  The line before the nvidia-smi line is a JSON
object listing every ported kernel; the last line is the JSON result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import platform
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
L2_BYTES = 50 * 2 ** 20
F32_FLOP_PER_S = 67e12      # H100 SXM f32 outside the tensor cores

MAIN_SHAPE = (8, 242_628)   # the white-wine cut space, P = p_max = 8
DA_SHAPE = (2, 925_590)     # domain adaptation, N=6: 15 LeNets' columns
SHAPES = (MAIN_SHAPE, DA_SHAPE, (8, 57_366), (3, 33), (13, 5_000))
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (5e-2, 5e-2)}
# grad-of-grad entries grow with D (to ~D at the white-wine width), so
# elementwise f32 agreement of two summation orders is out of reach
# there; both routes are held to a float64 computation instead: the
# kernel route's error, relative to the largest entry, may not exceed
# twice the plain route's plus one rounding of the input type
GOG_FLOOR = {"float32": 1e-6, "bfloat16": 1e-2}

SOURCES = {"matvec": "src/repro_torch/kernels/csrc/cut_kernels.cu",
           "vecmat": "src/repro_torch/kernels/csrc/cut_kernels.cu",
           "rank1": "src/repro_torch/kernels/csrc/cut_kernels.cu",
           "fused_round": "src/repro_torch/kernels/csrc/inner_round.cu",
           "flash_attention":
               "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
           "flash_attention_hd256":
               "src/repro_torch/kernels/csrc/flash_attention_sm90_hd256.cu",
           "flash_attention_simt":
               "src/repro_torch/kernels/csrc/flash_attention.cu",
           "flash_attention_f32":
               "src/repro_torch/kernels/csrc/flash_attention_sm90_f32.cu",
           "mlstm_chunk": "src/repro_torch/kernels/csrc/mlstm_chunk_sm90.cu",
           "mlstm_chunk_f32":
               "src/repro_torch/kernels/csrc/mlstm_chunk_sm90_f32.cu",
           "mlstm_chunk_simt": "src/repro_torch/kernels/csrc/mlstm_chunk.cu"}
REPLACES = {"matvec": "src/repro/kernels/cut_eval.py:60",
            "vecmat": "src/repro/kernels/cut_eval.py:96",
            "rank1": "src/repro/kernels/cut_eval.py:129",
            "fused_round": "src/repro/kernels/inner_round.py:53",
            "flash_attention": "src/repro/kernels/flash_attention.py:26",
            "flash_attention_hd256":
                "src/repro/kernels/flash_attention.py:26",
            "flash_attention_simt":
                "src/repro/kernels/flash_attention.py:26",
            "flash_attention_f32": "src/repro/kernels/flash_attention.py:26",
            "mlstm_chunk": "src/repro/kernels/mlstm_chunk.py:25",
            "mlstm_chunk_f32": "src/repro/kernels/mlstm_chunk.py:25",
            "mlstm_chunk_simt": "src/repro/kernels/mlstm_chunk.py:25"}
# the batched forms of the sweep engine (phase 11): the same TPU kernels,
# which the reference batches by vmapping them
BATCHED = {"matvec_runs": "matvec", "vecmat_runs": "vecmat",
           "rank1_runs": "rank1", "fused_round_runs": "fused_round"}
for _name, _single in BATCHED.items():
    SOURCES[_name] = SOURCES[_single]
    REPLACES[_name] = REPLACES[_single]
KERNELS = tuple(REPLACES)
STEP_NAMES = ("eta_z", "eta_s", "eta_dual", "rho2")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def close(got, want, rtol, atol) -> float:
    """Max abs error of got vs want; fails beyond rtol/atol."""
    got = got.detach().float().cpu().numpy()
    want = want.detach().float().cpu().numpy()
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    if not np.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"max abs err {err:.3e} beyond rtol={rtol} "
                             f"atol={atol}")
    return err


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

# the card's name and power limit, as nvidia-smi gives them (phase 1)
CARD = "not read"


def environment():
    global CARD
    import torch
    from repro_torch.kernels import build

    print(f"python {platform.python_version()}  torch {torch.__version__}"
          f"  cuda {torch.version.cuda}")
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"nvcc: {nvcc.splitlines()[-1]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {torch.cuda.get_device_name(0)}  "
          f"count {torch.cuda.device_count()}")
    CARD = smi.splitlines()[0]
    # f32 products in full f32 for every comparison below
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.load()
    print(f"kernel build+load: {time.perf_counter() - t0:.2f} s "
          f"({build.library_path().name}, "
          f"{len(build.SOURCES)} sources)", flush=True)
    return smi.splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def operands(p, d, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale) \
            .to(dtype)

    return {"a": rnd(p, d, scale=d ** -0.5), "v": rnd(d), "g": rnd(p),
            "x": rnd(p), "y": rnd(d)}


def median_ms(fn, copies, n_launch=48, reps=7, warmup=3):
    """Median over `reps` of the device time per call of fn, from CUDA
    events around `n_launch` back-to-back calls that cycle through
    operand copies.  At the main path's shapes the copies together span
    twice the 50 MB L2, so every call reads its operands from device
    memory, as the bound assumes.  A sleep kernel holds the stream while
    the host enqueues the calls, so host launch overhead is not timed."""
    import torch
    for o in copies[:warmup]:
        fn(o)
    times = []
    for _ in range(reps):
        torch.cuda._sleep(50_000_000)     # ~25 ms at the H100's clock
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for j in range(n_launch):
            fn(copies[j % len(copies)])
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / n_launch)
    return float(np.median(times))


def work(name, o):
    """(bytes, flops) the function must move and do on these inputs."""
    a, p, d = o["a"], o["a"].shape[0], o["a"].shape[1]
    es = a.element_size()
    if name == "matvec":
        return p * d * es + d * es + p * 4, 2 * p * d
    if name == "vecmat":
        return p * d * es + p * es + d * 4, 2 * p * d
    return p * es + d * es + p * d * 4, p * d


def bound_of(nbytes, t_ops):
    """(ms, what bounds it): the least time for the work on this card,
    the larger of the bytes over the memory rate and `t_ops`, the seconds
    its operations take at their types' peak rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def kernel_phase():
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import cut_eval as K

    calls = {
        "matvec": (lambda o: K.matvec(o["a"], o["v"]),
                   lambda o: K.matvec_ref(o["a"], o["v"]),
                   lambda o: torch.mv(o["a"], o["v"])),
        "vecmat": (lambda o: K.vecmat(o["g"], o["a"]),
                   lambda o: K.vecmat_ref(o["g"], o["a"]),
                   lambda o: o["g"] @ o["a"]),
        "rank1": (lambda o: K.rank1(o["x"], o["y"]),
                  lambda o: K.rank1_ref(o["x"], o["y"]),
                  lambda o: torch.outer(o["x"], o["y"])),
    }
    rows = {}
    speed = {}
    print("kernel  dtype     P      D   max_abs_err  ms  plain_ms  "
          "library_ms  bound_ms")
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        rtol, atol = TOL[dname]
        for i, (p, d) in enumerate(SHAPES):
            o = operands(p, d, dtype, seed=i)
            n_copies = min(16, -(-2 * L2_BYTES // work("matvec", o)[0]))
            copies = [operands(p, d, dtype, seed=100 + k)
                      for k in range(n_copies)]
            for name, (kern, plain, lib) in calls.items():
                try:
                    err = close(kern(o), plain(o), rtol, atol)
                except AssertionError as e:
                    fail(f"{name} {dname} ({p}, {d}) vs plain: {e}")
                ms = median_ms(kern, copies)
                plain_ms = median_ms(plain, copies)
                lib_ms = median_ms(lib, copies)
                nbytes, flops = work(name, o)
                bound, bound_by = bound_of(nbytes, flops / F32_FLOP_PER_S)
                print(f"{name:7s} {dname:8s} {p:3d} {d:7d}  {err:.3e}  "
                      f"{ms:.4f}  {plain_ms:.4f}  {lib_ms:.4f}  "
                      f"{bound:.4f}", flush=True)
                if dtype == torch.float32 and (p, d) == MAIN_SHAPE:
                    rows[name] = {
                        "name": name, "route": "cuda",
                        "source": SOURCES[name],
                        "replaces": REPLACES[name], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": bound_by, "library_ms": lib_ms}
                if (name in SPEED_GATES and dname in SPEED_GATES[name][1]
                        and (p, d) in (MAIN_SHAPE, DA_SHAPE)):
                    speed[(name, dname, p, d)] = (ms, lib_ms, bound)
            for name in ("matvec", "vecmat"):
                args = (o["a"], o["v"]) if name == "matvec" \
                    else (o["g"], o["a"])
                K.reset_launches()
                once = getattr(K, name)(*args)
                check(dict(K.LAUNCHES) == {name: 1},
                      f"{name} {dname} ({p}, {d}) launched "
                      f"{dict(K.LAUNCHES)}")
                again = getattr(K, name)(*args)
                check(torch.equal(once, again),
                      f"{name} {dname} ({p}, {d}) not bitwise repeatable")
                print(f"{name} {dname} ({p}, {d}): one launch a call, "
                      "bitwise repeatable: yes")
            grads_check(o, dname, ops)
    speed_gates(speed)
    return rows


# kernels that must be no slower than their library call at both main
# shapes, in the types listed
SPEED_GATES = {"matvec": ("torch.mv", ("float32", "bfloat16")),
               "vecmat": ("g @ A", ("float32",)),
               "fused_round": ("the three-call composition", ("float32",))}


def speed_gates(speed):
    """Print each gated kernel's time beside its bound and library call;
    fail where the kernel is the slower."""
    for (name, dname, p, d), (ms, lib_ms, bound) in speed.items():
        lib = SPEED_GATES[name][0]
        print(f"{name} {dname} ({p}, {d}): {ms * 1e3:.2f} us (bound "
              f"{bound * 1e3:.2f} us), {lib} {lib_ms * 1e3:.2f} us "
              f"({lib_ms / ms:.2f}x)")
        check(ms <= lib_ms, f"{name} {dname} ({p}, {d}): {ms * 1e3:.2f} us "
              f"is slower than {lib}'s {lib_ms * 1e3:.2f} us")


def grads_check(o, dname, ops):
    """MV's first and second derivatives w.r.t. A and v through the
    kernel route, against plain-torch autograd (first derivatives) and a
    float64 plain computation (grad-of-grad).  The only place OUTER runs
    on the card: the main path never differentiates the cut matrix."""
    import torch
    p, d = o["a"].shape
    c = o["g"].float()
    # row 0 always active, so the second derivatives are not all zero
    # (at P = 2 every row may draw inactive)
    act = (o["x"].float() > -0.5).float()
    act[0] = 1.0
    w = o["y"].float()[:p] if d >= p else torch.ones(p, device="cuda")

    def derivs(impl, dtype=None):
        a = o["a"].detach().to(dtype or o["a"].dtype).requires_grad_(True)
        v = o["v"].detach().to(dtype or o["v"].dtype).requires_grad_(True)
        cc, aa, ww = (x.to(dtype or torch.float32) for x in (c, act, w))
        raw = ops.cut_eval(a, v, cc, aa, impl=impl) if dtype is None \
            else (a @ v - cc) * aa
        loss = 0.5 * torch.sum(ww * raw ** 2)
        da, dv = torch.autograd.grad(loss, (a, v), create_graph=True)
        inner = torch.sum(da.to(raw.dtype) ** 2) \
            + torch.sum(dv.to(raw.dtype) ** 2)
        dda, ddv = torch.autograd.grad(inner, (a, v))
        return da, dv, dda, ddv

    rtol, atol = TOL[dname]
    got, want = derivs("kernel"), derivs("ref")
    truth = derivs(None, dtype=torch.float64)
    try:
        errs = [close(got[0], want[0], rtol, atol),
                close(got[1], want[1], rtol, atol)]
    except AssertionError as e:
        fail(f"MV first derivatives {dname} ({p}, {d}): {e}")
    gog = []
    for k, name in ((2, "dda"), (3, "ddv")):
        t = truth[k].detach()
        scale = float(t.abs().max())
        e_k = float((got[k].double() - t).abs().max()) / scale
        e_p = float((want[k].double() - t).abs().max()) / scale
        check(e_k <= 2 * e_p + GOG_FLOOR[dname],
              f"MV grad-of-grad {name} {dname} ({p}, {d}): error "
              f"{e_k:.2e} of max |entry| vs the plain route's {e_p:.2e}")
        gog.append((e_k, e_p))
    print(f"MV grads {dname} ({p}, {d}): max abs err vs plain da "
          f"{errs[0]:.2e} dv {errs[1]:.2e} | grad-of-grad err vs float64 "
          f"(of max |entry|) kernel/plain dda {gog[0][0]:.1e}/"
          f"{gog[0][1]:.1e} ddv {gog[1][0]:.1e}/{gog[1][1]:.1e}",
          flush=True)


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

FUSED_STEPS = dict(eta_z=0.05, eta_s=0.05, eta_dual=0.05, rho2=1.0)
ROUND_ARGS = ("a", "v", "g_other", "mask", "c", "active", "s", "gamma")


def round_operands(p, d, dtype, seed):
    """One round's operands: A scaled so A v is O(1), a third of the
    columns masked out, about a third of the cuts inactive (row 0
    active)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    active = (rnd(p) > -0.4).float()
    active[0] = 1.0      # at P = 2 every row may draw inactive
    return {"a": rnd(p, d, scale=d ** -0.5).to(dtype), "v": rnd(d),
            "g_other": rnd(d),
            "mask": (torch.arange(d, device="cuda") % 3 > 0).float(),
            "c": rnd(p), "active": active,
            "s": rnd(p).abs(), "gamma": rnd(p).abs()}


def round_work(o):
    """(bytes, flops) of one round: A and the three D-vectors read once,
    v_new written once, the (P,) rows in and out; three passes of 2PD
    operations over A plus the D-wide update."""
    p, d = o["a"].shape
    nbytes = p * d * o["a"].element_size() + 3 * d * 4 + d * 4 \
        + 4 * p * 4 + 3 * p * 4
    return nbytes, 6 * p * d + 4 * d


# above the shared memory of the 132 SMs: the kernel streams A instead
OVER_SHAPE = (64, 242_628)
BRANCH_SEEDS = range(200, 456)


def round_branches(o, s_new, gamma_new):
    """Active rows whose s' and gamma' were clamped to 0 or not:
    (s' clamped, s' not, gamma' clamped, gamma' not)."""
    act = o["active"] > 0
    s0, g0 = (s_new == 0) & act, (gamma_new == 0) & act
    return tuple(int(x.sum()) for x in (s0, act & ~s0, g0, act & ~g0))


def branch_operands(p, d, dtype, R):
    """The first operands from seeds BRANCH_SEEDS whose plain round takes
    both branches of s' and of gamma' on its active rows (round_operands
    reaches all four); fails if no seed does."""
    for seed in BRANCH_SEEDS:
        o = round_operands(p, d, dtype, seed)
        out = R.fused_cut_round_ref(*(o[k] for k in ROUND_ARGS),
                                    **FUSED_STEPS)
        if all(round_branches(o, out[2], out[3])):
            return o, seed
    fail(f"fused_round ({p}, {d}) {dtype}: no seed of {BRANCH_SEEDS} takes "
         "every branch of s' and gamma'")


def device_launches(fn):
    """(device kernels, runtime launch calls) of one call of fn under
    torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [ev.name for ev in prof.events()
               if ev.device_type == DeviceType.CUDA]
    calls = [ev.name for ev in prof.events()
             if ev.name.startswith(("cudaLaunch", "cuLaunch"))]
    return kernels, calls


def fused_phase(rows):
    import torch
    from repro_torch.kernels import cut_eval as K
    from repro_torch.kernels import inner_round as R
    from repro_torch.kernels import ops

    print("fused   dtype     P      D   max_abs_err(v_new/cv1/s/gamma)  "
          "ms  plain_ms  3call_ms  bound_ms")
    speed, profiled = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        rtol, atol = TOL[dname]
        for i, (p, d) in enumerate((MAIN_SHAPE, DA_SHAPE, (3, 1_025),
                                    OVER_SHAPE)):
            if (p, d) == MAIN_SHAPE:
                o, seed = branch_operands(p, d, dtype, R)
            else:
                o, seed = round_operands(p, d, dtype, seed=200 + i), 200 + i
            n_copies = min(16, -(-2 * L2_BYTES // round_work(o)[0]))
            copies = [round_operands(p, d, dtype, seed=300 + k)
                      for k in range(n_copies)]

            def kern(o):
                return R.fused_cut_round(*(o[k] for k in ROUND_ARGS),
                                         **FUSED_STEPS)

            def plain(o):
                return R.fused_cut_round_ref(*(o[k] for k in ROUND_ARGS),
                                             **FUSED_STEPS)

            def three_calls(o):
                # no single library call computes the round: the three
                # contractions it chains, each one PyTorch call (f32 only:
                # torch.mv takes no mixed operand types)
                a = o["a"]
                return torch.mv(a, torch.mv(a, o["v"]) @ a)

            got, want = kern(o), plain(o)
            try:
                errs = [close(x, y, rtol, atol) for x, y in zip(got, want)]
            except AssertionError as e:
                fail(f"fused_round {dname} ({p}, {d}) vs plain: {e}")
            again = kern(o)
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"fused_round {dname} ({p}, {d}) not bitwise repeatable")
            branches = round_branches(o, got[2], got[3])
            if (p, d) == MAIN_SHAPE:
                check(all(branches), f"fused_round {dname} ({p}, {d}): "
                      f"branches {branches} miss one")
            plan = R.plan_for(o["a"])
            ms = median_ms(kern, copies)
            plain_ms = median_ms(plain, copies)
            lib_ms = median_ms(three_calls, copies) \
                if dtype == torch.float32 else float("nan")
            nbytes, flops = round_work(o)
            bound, bound_by = bound_of(nbytes, flops / F32_FLOP_PER_S)
            print(f"fused   {dname:8s} {p:3d} {d:7d}  "
                  + "/".join(f"{e:.2e}" for e in errs)
                  + f"  {ms:.4f}  {plain_ms:.4f}  {lib_ms:.4f}  "
                  f"{bound:.4f}  (bitwise repeatable: yes)", flush=True)
            print(f"  {plan.blocks} blocks of {plan.cw} columns, "
                  f"{'A held on chip' if plan.on_chip else 'A streamed'}"
                  f" ({plan.smem} bytes of shared memory a block); "
                  f"operand seed {seed}: active rows with s' clamped / not "
                  f"{branches[0]} / {branches[1]}, gamma' clamped / not "
                  f"{branches[2]} / {branches[3]}", flush=True)
            profiled.append((f"{dname} ({p}, {d})", o))
            if dtype == torch.float32 and (p, d) in (MAIN_SHAPE, DA_SHAPE):
                speed[("fused_round", dname, p, d)] = (ms, lib_ms, bound)
            if dtype == torch.float32 and (p, d) == MAIN_SHAPE:
                rows["fused_round"] = {
                    "name": "fused_round", "route": "cuda",
                    "source": SOURCES["fused_round"],
                    "replaces": REPLACES["fused_round"],
                    "max_abs_err": max(errs), "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": bound_by, "library_ms": None,
                    "three_call_ms": lib_ms}
                print(f"  three-call composition torch.mv / u @ A / "
                      f"torch.mv (no single library call computes the "
                      f"round): {lib_ms:.4f} ms")
            if (p, d) in (MAIN_SHAPE, DA_SHAPE):
                round_grads_check(o, dname, R, ops)
    speed_gates(speed)
    # under the profiler last: it slows later host launches
    for label, o in profiled:
        # CUPTI may drop a session's only device record (seen once, on the
        # H100, with the launch call and the count present): observe the
        # call again then, up to three times; any record seen is gated
        for _ in range(3):
            K.reset_launches()
            kernels, calls = device_launches(
                lambda: R.fused_cut_round(*(o[k] for k in ROUND_ARGS),
                                          **FUSED_STEPS))
            if kernels:
                break
            print(f"fused_round {label}: the profiler recorded no device "
                  f"kernel (launch calls {calls}); profiling the call again",
                  flush=True)
        check(dict(K.LAUNCHES) == {"fused_round": 1}
              and len(kernels) == 1 and "fused_round" in kernels[0]
              and len(calls) == 1,
              f"fused_round {label}: one call ran {kernels} through {calls},"
              f" counted {dict(K.LAUNCHES)}")
        print(f"fused_round {label}, one call under torch.profiler: "
              f"{len(kernels)} device kernel ({kernels[0][:40]}...), "
              f"launched by {calls[0]}", flush=True)


def round_grads_check(o, dname, R, ops):
    """FusedRound's first derivatives w.r.t. (A, v, s, gamma) against
    plain-torch autograd of the plain version, and its grad-of-grad
    w.r.t. (A, v) against a float64 computation of the same round."""
    import torch
    p, d = o["a"].shape
    wrt = ("a", "v", "s", "gamma")
    steps = tuple(FUSED_STEPS[k] for k in STEP_NAMES)

    def derivs(impl, dtype=None):
        x = {k: o[k].detach().clone().to(dtype or o[k].dtype)
             .requires_grad_(k in wrt) for k in ROUND_ARGS}
        args = [x[k] for k in ROUND_ARGS]
        if impl is None:
            outs = R.fused_round_math(lambda a, v: a @ v,
                                      lambda g, a: g @ a, *args, *steps)
        else:
            outs = ops.fused_cut_round(*args, impl=impl, **FUSED_STEPS)
        loss = sum(torch.sum(t.to(outs[0].dtype) ** 2) for t in outs)
        g = torch.autograd.grad(loss, [x[k] for k in wrt],
                                create_graph=True)
        inner = sum(torch.sum(t.to(outs[0].dtype) ** 2) for t in g)
        gg = torch.autograd.grad(inner, [x["a"], x["v"]])
        return g, gg

    rtol, atol = TOL[dname]
    (g_k, gg_k), (g_p, gg_p) = derivs("kernel"), derivs("ref")
    truth = derivs(None, dtype=torch.float64)[1]
    try:
        errs = [close(x, y, rtol, atol) for x, y in zip(g_k, g_p)]
    except AssertionError as e:
        fail(f"FusedRound first derivatives {dname} ({p}, {d}): {e}")
    gog = []
    for k_, p_, t, name in zip(gg_k, gg_p, truth, ("dda", "ddv")):
        t = t.detach()
        scale = float(t.abs().max())
        e_k = float((k_.double() - t).abs().max()) / scale
        e_p = float((p_.double() - t).abs().max()) / scale
        check(e_k <= 2 * e_p + GOG_FLOOR[dname],
              f"FusedRound grad-of-grad {name} {dname} ({p}, {d}): error "
              f"{e_k:.2e} of max |entry| vs the plain route's {e_p:.2e}")
        gog.append((e_k, e_p))
    print(f"FusedRound grads {dname} ({p}, {d}): max abs err vs plain "
          + " ".join(f"d{k} {e:.2e}" for k, e in zip(wrt, errs))
          + f" | grad-of-grad err vs float64 (of max |entry|) kernel/plain "
          f"dda {gog[0][0]:.1e}/{gog[0][1]:.1e} ddv {gog[1][0]:.1e}/"
          f"{gog[1][1]:.1e}", flush=True)


# ---------------------------------------------------------------------------
# phases 4 and 5: the main paths
# ---------------------------------------------------------------------------

N_ITERATIONS = 120
# phase 4's second, timed-only turn of each route (cut from 120 to pay
# for phase 19)
TIMING_ITERATIONS = 60
DA_ITERATIONS = 40
# final-state agreement between routes, relative to the tensor's largest
# entry: the routes sum in other orders, so only the cut rows and inner
# states that the cut values move may differ, by f32 rounding carried
# through 120 iterations
STATE_RTOL = 1e-4


def timed_run(spec):
    """(result, seconds, kernel launches) of one run, counts set to 0
    just before it."""
    import torch
    from repro_torch.core import run
    from repro_torch.kernels import cut_eval as K

    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    res = run(spec)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, dict(K.LAUNCHES)


def in_turns(specs, order, later=None):
    """Run `specs[name]` for each name of `order`; keep each route's
    first result and launches and every time, in ms per iteration.
    `order` is symmetric, so each route sees the same mean position;
    `later` (fields of `RunSpec`) shortens each route's later turns,
    which are timed only."""
    first, times = {}, {name: [] for name in specs}
    for name in order:
        spec = specs[name]
        if name in first and later:
            spec = dataclasses.replace(spec, **later)
        res, secs, launches = timed_run(spec)
        times[name].append(secs / spec.resolved_iterations() * 1e3)
        first.setdefault(name, (res, launches))
    return first, times


def final_state_diffs(st, ref):
    """{name: max |diff| / max |entry|} of the final II-layer cuts,
    gamma_k and level-2 inner state of two runs."""
    from repro_torch.utils.tree import tree_leaves
    pairs = {"cuts_ii.a": (st.cuts_ii.a, ref.cuts_ii.a),
             "cuts_ii.c": (st.cuts_ii.c, ref.cuts_ii.c),
             "gamma_k": (st.gamma_k, ref.gamma_k)}
    for k in ("x2", "z2", "phi", "s", "gamma"):
        pairs[f"inner2.{k}"] = (getattr(st.inner2, k),
                                getattr(ref.inner2, k))
    out = {}
    for name, (x, y) in pairs.items():
        num = max(float((a - b).abs().max())
                  for a, b in zip(tree_leaves(x), tree_leaves(y)))
        den = max(float(b.abs().max()) for b in tree_leaves(y))
        out[name] = num / den if den > 0 else num
    return out


def compare_routes(label, h, hr, keys, rtol):
    for k in keys:
        rel = float(np.max(np.abs(h[k] - hr[k]) / np.abs(hr[k])))
        print(f"  {label} {k}: max rel diff {rel:.3e}")
        check(bool(np.all(np.isfinite(h[k]))), f"{label} {k} not finite")
        check(bool(np.allclose(h[k], hr[k], rtol=rtol, atol=0.0)),
              f"{label} {k} beyond rtol {rtol}")
    for k in ("n_cuts_i", "n_cuts_ii"):
        check(list(h[k]) == list(hr[k]), f"{label} {k} differs")


def print_multipliers(label, st):
    print(f"  {label} final multipliers: max lam {float(st.lam.max()):.3e},"
          f" max gamma_k {float(st.gamma_k.max()):.3e}, max inner2.s "
          f"{float(st.inner2.s.max()):.3e}, max inner2.gamma "
          f"{float(st.inner2.gamma.max()):.3e}")


def white_wine():
    """Phase 4's white-wine robust HPO on the card (Table 1: N=6, S=4,
    tau=10, one 5x straggler): (task, hyper, scheduler config)."""
    from repro_torch.apps.robust_hpo import (default_hyper,
                                             make_robust_hpo_problem)
    from repro_torch.core import StragglerConfig

    n, s, tau = 6, 4, 10
    task = make_robust_hpo_problem("white_wine", n_workers=n, seed=0,
                                   device="cuda")
    cfg = StragglerConfig(n_workers=n, s_active=s, tau=tau, n_stragglers=1,
                          straggler_slowdown=5.0, seed=0)
    return task, default_hyper(task, n, s, tau), cfg


def slice_phase(rows):
    from repro_torch.core import RunSpec

    task, hyper, cfg = white_wine()

    def metrics(state):
        w = {k: v.mean(0) for k, v in state.X3.items()}
        return {"mse_clean": task.test_mse(w, 0.0),
                "mse_noisy": task.test_mse(w, 0.3, seed=0)}

    fused = dataclasses.replace(hyper, use_fused_inner=True)
    hypers = {"plain": dataclasses.replace(hyper, cut_impl="ref"),
              "kernel": hyper,
              "fused_plain": dataclasses.replace(fused, cut_impl="ref"),
              "fused": fused}
    specs = {name: RunSpec(problem=task.problem, hyper=hy, scheduler=cfg,
                           n_iterations=N_ITERATIONS, metrics_every=10,
                           metrics_fn=metrics, engine="scan")
             for name, hy in hypers.items()}
    # the first use of each route loads its modules and kernels: keep
    # that out of the timed runs, which then go in turns
    for spec in specs.values():
        timed_run(dataclasses.replace(spec, n_iterations=20))
    order = ("plain", "fused_plain", "kernel", "fused", "fused", "kernel",
             "fused_plain", "plain")
    first, ms = in_turns(specs, order, later=dict(
        n_iterations=TIMING_ITERATIONS))
    print("white-wine ms/iteration in turns (" + ", ".join(order) + "; "
          f"the second of each route {TIMING_ITERATIONS} iterations): "
          + ", ".join(f"{ms[name][order[:i].count(name)]:.3f}"
                      for i, name in enumerate(order)))

    res, launches = first["kernel"]
    h = res.history
    a_shape = tuple(res.state.cuts_ii.a.shape)
    check(a_shape == MAIN_SHAPE, f"cut matrix {a_shape} != {MAIN_SHAPE}")
    print(f"white-wine slice (cut kernels): cut matrix {a_shape}")
    for k in ("t", "gap_sq", "mse_clean", "mse_noisy", "n_cuts_i",
              "n_cuts_ii"):
        print(f"  {k:9s} " + " ".join(f"{x:.6g}" for x in h[k]))
    check(h["gap_sq"][-1] < h["gap_sq"][0], "gap_sq did not decrease")
    check(h["mse_noisy"][-1] < h["mse_noisy"][0],
          "noisy test MSE did not decrease")
    for name in hypers:
        got = first[name][1]
        print(f"  launches, {name} route: " + ", ".join(
            f"{k} {got.get(k, 0)} ({got.get(k, 0) / N_ITERATIONS:.2f}"
            "/iteration)" for k in KERNELS))
    for k in ("matvec", "vecmat"):
        check(launches.get(k, 0) > 0, f"{k} never launched on the main path")
        rows[k]["launches"] = int(launches[k])
    rows["rank1"]["launches"] = int(launches.get("rank1", 0))
    fused_launches = first["fused"][1]
    check(fused_launches.get("fused_round", 0) > 0,
          "fused_round never launched on the fused route")
    rows["fused_round"]["launches"] = int(fused_launches["fused_round"])
    check(launches.get("fused_round", 0) == 0,
          "the unfused kernel route launched the fused round")
    for name in ("plain", "fused_plain"):
        check(sum(first[name][1].values()) == 0,
              f"the {name} route launched kernels: {first[name][1]}")

    keys = ("gap_sq", "mse_clean", "mse_noisy")
    ref_state = first["plain"][0].state
    for name in ("kernel", "fused_plain", "fused"):
        compare_routes(f"{name} vs plain", first[name][0].history,
                       first["plain"][0].history, keys, 1e-4)
        diffs = final_state_diffs(first[name][0].state, ref_state)
        print(f"  {name} vs plain final state (max |diff| / max |entry|): "
              + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items()))
        for k, v in diffs.items():
            check(v <= STATE_RTOL, f"white-wine {name} vs plain final {k}: "
                  f"{v:.2e} of the largest entry > {STATE_RTOL}")
    for name in hypers:
        print_multipliers(f"white-wine {name}", first[name][0].state)
    PHASE4.update({name: r for name, (r, _) in first.items()})
    return {name: float(np.mean(v)) for name, v in ms.items()}, specs


# phase 4's first result of each route, which phase 11's swept fused route
# is held to
PHASE4 = {}


def hold_cudnn_f32():
    """cuDNN's f32 convolutions default to TF32 and may pick
    nondeterministic algorithms: either would make two routes differ for
    reasons that have nothing to do with the cut kernels."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    print(f"cudnn: allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"deterministic={torch.backends.cudnn.deterministic} "
          f"benchmark={torch.backends.cudnn.benchmark}")


def da_phase(rows):
    from repro_torch.apps.domain_adaptation import (
        default_hyper, make_domain_adaptation_problem)
    from repro_torch.core import RunSpec, StragglerConfig

    hold_cudnn_f32()

    n, s, stragglers, tau = 6, 3, 2, 15     # Table 1, SVHN pretrain
    task = make_domain_adaptation_problem(
        n, pretrain_domain="svhn", n_pretrain_per=24, n_finetune_per=12,
        seed=0, device="cuda")
    hyper = default_hyper(n, s, tau, t_pre=20, k_inner=1, p_max=2,
                          use_fused_inner=True)
    cfg = StragglerConfig(n_workers=n, s_active=s, tau=tau,
                          n_stragglers=stragglers, straggler_slowdown=5.0,
                          seed=0)

    def metrics(state):
        return task.test_metrics({k: v.mean(0) for k, v in state.X2.items()})

    specs = {name: RunSpec(problem=task.problem, hyper=hy, scheduler=cfg,
                           n_iterations=DA_ITERATIONS, metrics_every=5,
                           metrics_fn=metrics, engine="scan")
             for name, hy in (("fused", hyper), ("fused_plain",
                              dataclasses.replace(hyper, cut_impl="ref")))}
    # the warm-up reaches the first refresh (t_pre = 20)
    for spec in specs.values():
        timed_run(dataclasses.replace(spec, n_iterations=20))
    order = ("fused_plain", "fused", "fused", "fused_plain")
    first, ms = in_turns(specs, order)
    print("domain adaptation ms/iteration in turns (" + ", ".join(order)
          + "): " + ", ".join(f"{ms[name][order[:i].count(name)]:.3f}"
                              for i, name in enumerate(order)))
    res, launches = first["fused"]
    h = res.history
    a_shape = tuple(res.state.cuts_ii.a.shape)
    print(f"domain adaptation (fused kernel route): cut matrix {a_shape}")
    check(a_shape == DA_SHAPE, f"cut matrix {a_shape} != {DA_SHAPE}")
    for k in ("t", "gap_sq", "test_acc", "test_loss", "n_cuts_i",
              "n_cuts_ii"):
        print(f"  {k:9s} " + " ".join(f"{x:.6g}" for x in h[k]))
    check(h["test_loss"][-1] < h["test_loss"][0],
          "domain adaptation test_loss did not decrease")
    for name in specs:
        got = first[name][1]
        print(f"  launches, {name} route: " + ", ".join(
            f"{k} {got.get(k, 0)} ({got.get(k, 0) / DA_ITERATIONS:.2f}"
            "/iteration)" for k in KERNELS))
    for k in ("matvec", "fused_round"):
        check(launches.get(k, 0) > 0,
              f"{k} never launched on the domain-adaptation path")
    check(sum(first["fused_plain"][1].values()) == 0,
          "the plain domain-adaptation route launched kernels")
    compare_routes("fused vs plain", h, first["fused_plain"][0].history,
                   ("gap_sq", "test_loss", "test_acc"), 1e-4)
    diffs = final_state_diffs(res.state, first["fused_plain"][0].state)
    print("  fused vs plain final state (max |diff| / max |entry|): "
          + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items()))
    for k, v in diffs.items():
        check(v <= STATE_RTOL, f"domain adaptation fused vs plain final "
              f"{k}: {v:.2e} of the largest entry > {STATE_RTOL}")
    for name in specs:
        print_multipliers(f"domain adaptation {name}", first[name][0].state)
    return {name: float(np.mean(v)) for name, v in ms.items()}, launches, \
        specs["fused"]


# the port's kernels by the names the profiler gives them
OUR_KERNELS = ("matvec", "vecmat", "rank1", "fused_round",
               "flash_fwd_sm90", "flash_fwd_sm90_f32", "flash_fwd",
               "mlstm_y", "mlstm_state", "mlstm_chunk_sm90",
               "mlstm_chunk_sm90_f32")


def profile_phase(label, spec):
    """Device time of 20 iterations of `spec` by kernel, and the device's
    busy share of the wall time, under torch.profiler."""
    from repro_torch.core import run

    spec = dataclasses.replace(spec, n_iterations=20, metrics_every=10,
                               metrics_fn=None)
    profile_call(f"{label} (20 iterations, profiler on)",
                 lambda: run(spec))


def profile_call(label, fn, focus=None):
    """Device time of one call of `fn` by kernel, and the device's busy
    share of the wall time, under torch.profiler; with `focus`, also the
    time and share of busy of the kernels whose name holds it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return report_profile(label, prof, wall_us, focus)


def report_profile(label, prof, wall_us, focus=None):
    """`profile_call`'s report of a finished torch.profiler session that
    spanned `wall_us` of wall time; returns the device's busy share."""
    from torch.autograd import DeviceType

    # the profiler's raw records: `prof.events()` would build a Python
    # tree of every host op first, 20-30 s for 20 AFTO iterations
    by_name = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            n, us = by_name.get(ev.name(), (0, 0.0))
            by_name[ev.name()] = (n + 1, us + ev.duration_ns() / 1e3)
    busy_us = sum(us for _, us in by_name.values())
    check(busy_us > 0, "the profiler saw no device time")
    ours = sum(us for name, (_, us) in by_name.items()
               if any(k in name for k in OUR_KERNELS))
    n_kernels = sum(n for n, _ in by_name.values())
    print(f"profile, {label}: wall "
          f"{wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.2f} ms "
          f"({100 * busy_us / wall_us:.1f}%), {n_kernels} kernels, the "
          f"port's kernels {ours / 1e3:.3f} ms ({100 * ours / busy_us:.1f}%"
          " of busy)")
    if focus is not None:
        hits = [v for name, v in by_name.items() if focus in name]
        n_f, us_f = sum(n for n, _ in hits), sum(us for _, us in hits)
        print(f"  {focus}: {us_f / 1e3:.3f} ms in {n_f} launches "
              f"({100 * us_f / busy_us:.1f}% of busy)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    for name, (n, us) in top:
        print(f"  {us / 1e3:8.3f} ms  {n:6d}x  {name[:90]}")
    return busy_us / wall_us


# ---------------------------------------------------------------------------
# phase 7: the LLM kernels
# ---------------------------------------------------------------------------

BF16_FLOP_PER_S = 989e12    # H100 SXM dense bf16 on the tensor cores
TF32_FLOP_PER_S = 495e12    # H100 SXM dense TF32 on the tensor cores
FLASH_TOL = {"float32": 2e-3, "bfloat16": 4e-2}   # tests/test_kernels.py:230
MLSTM_TOL = {"float32": 6e-3, "bfloat16": 6e-2}   # tests/test_kernels.py:285
# every flash row beside FLASH_TOL: the largest over query rows of max
# |diff| / max |plain| across the head dim (`row_rel_err`).  FLASH_TOL is
# about the size of a late row's outputs at 2,048 keys (0.03-0.05), so it
# cannot see a fault in the rows where the window and the tile skipping
# act; this one is scaled to each row.  Each limit lies between the
# kernels' readings on the H100 (f32 at most 4.5e-6; bf16 7.8e-3, one
# bf16 ulp of a row's largest entry) and those of the planted faults of
# `fault_masks` (0.20 at least), which every row also checks
FLASH_ROW_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# every f32 row of the f32 tensor-core kernels and of the SIMT kernels,
# beside the limits above: flash by `row_rel_err`, mLSTM by max |diff| /
# max |plain| of each of y, C', n' and m'.  Each limit lies between the
# f32 kernels' readings on the H100 (flash at most 4.6e-6, both kernels;
# mLSTM's y 1.05e-5 for the SIMT kernel, 9.7e-6 for the f32 tensor-core
# one, at xLSTM-125M's chunk)
# and one TF32 product's (flash 9e-4 to 1.5e-3, mLSTM's y 8.5e-4, as
# tests/test_torch_flash_f32.py and tests/test_torch_mlstm_f32.py
# emulate it), which FLASH_ROW_TOL and MLSTM_TOL let through
F32_GRADE_TOL = {"flash": 1e-5, "mlstm": 5e-5}
# (B, S, T, H, Hkv, hd, window): Llama-3 8B's prefill first
FLASH_SHAPES = ((4, 1024, 1024, 32, 8, 128, 0),
                (4, 1024, 1024, 32, 8, 128, 1024),
                (4, 1000, 1000, 32, 8, 128, 0),
                (1, 77, 77, 32, 32, 128, 0))
# bf16 only: Whisper's heads and head dim (20 x 64) at 1,500 frames, run
# causal like the others: the tensor-core kernel's hd-64 instance
FLASH_HD64_SHAPE = (1, 1500, 1500, 20, 20, 64, 0)
# bf16 only, on the hd-256 tensor-core kernel, every row timed: Gemma 3
# 12B's heads (16, 8 kv) at Llama's prefill flops (H hd = 4,096 either
# way), Gemma's serving shapes (batch 2, 2,048 tokens; global and
# windowed layers) and a ragged length
FLASH_HD256_SHAPES = ((4, 1024, 1024, 16, 8, 256, 0),
                      (2, 2048, 2048, 16, 8, 256, 0),
                      (2, 2048, 2048, 16, 8, 256, 1024),
                      (2, 1000, 1000, 16, 8, 256, 0))
# the row the kernel line carries: the windowed serving shape, 40 of a
# Gemma prefill's 48 launches; the hd-256 kernel must be at least this
# many times faster than the SIMT kernel at the first row
FLASH_HD256_MAIN = FLASH_HD256_SHAPES[2]
HD256_OVER_SIMT = 10.0
# the f32 tensor-core kernels must be at least this many times faster than
# the SIMT kernels on the same f32 inputs at Llama's first row, Gemma's
# windowed row and xLSTM-125M's chunk
F32_OVER_SIMT = 2.0
# (B, H, L, hd): xLSTM-125M's chunk first
MLSTM_SHAPES = ((4, 4, 256, 192), (4, 4, 100, 192))


def flop_rate(dtype) -> float:
    import torch
    return BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S


def causal_pairs(s, t, window):
    """Query-key pairs a causal (windowed) attention of these lengths
    computes: the work this run's masks leave."""
    q = np.arange(s)
    hi = np.minimum(q, t - 1)
    lo = np.maximum(0, q - window + 1) if window else np.zeros_like(q)
    return int(np.maximum(0, hi - lo + 1).sum())


def row_rel_err(got, want) -> float:
    """max over query rows of max |got - want| / max |want| across the
    last (head) dim."""
    got, want = got.float(), want.float()
    scale = want.abs().amax(-1).clamp_min(1e-30)
    return float(((got - want).abs().amax(-1) / scale).max())


def fault_masks(s, t, window, device):
    """Key masks of the plain version with one planted fault each:
    "edge", the window off by one (every row's oldest key dropped) or,
    without a window, key 0 dropped from the rows from S/2 on; "tile",
    the 64 keys before S/2 dropped from the rows from S/2 on."""
    import torch
    q = torch.arange(s, device=device)[:, None]
    k = torch.arange(t, device=device)[None]
    sound = k <= q
    if window:
        sound = sound & (k > q - window)
    late = q >= s // 2
    edge = (sound & (k > q - window + 1) if window
            else sound & ~(late & (k == 0)))
    tile = sound & ~(late & (k >= max(0, s // 2 - 64)) & (k < s // 2))
    return {"edge": edge[None, None], "tile": tile[None, None]}


def flash_operands(shape, dtype, seed):
    import torch
    b, s, t, h, hkv, hd, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*sh):
        return torch.randn(sh, generator=g, device="cuda").to(dtype)

    return {"q": rnd(b, s, h, hd), "k": rnd(b, t, hkv, hd),
            "v": rnd(b, t, hkv, hd)}


def flash_work(shape, dtype, tf32x3=False):
    """(bytes, seconds of operations): q, k, v read and the output written
    once; q k^T and p v over the pairs the masks leave, at the input
    type's rate, or with `tf32x3` as three TF32 products each (the least
    time for f32-accurate products on the tensor cores)."""
    b, s, t, h, hkv, hd, window = shape
    es = 2 if "bfloat16" in str(dtype) else 4
    nbytes = (2 * b * s * h * hd + 2 * b * t * hkv * hd) * es
    flops = 4 * hd * causal_pairs(s, t, window) * b * h
    if tf32x3:
        return nbytes, 3 * flops / TF32_FLOP_PER_S
    return nbytes, flops / flop_rate(dtype)


def mlstm_operands(shape, dtype, seed):
    import torch
    b, h, l, hd = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*sh, scale=1.0):
        return torch.randn(sh, generator=g, device="cuda") * scale

    return {"q": rnd(b, h, l, hd).to(dtype), "k": rnd(b, h, l, hd).to(dtype),
            "v": rnd(b, h, l, hd).to(dtype), "li": rnd(b, h, l, 1, scale=0.5),
            "lf": torch.nn.functional.logsigmoid(rnd(b, h, l, 1) + 2.0),
            "c": rnd(b, h, hd, hd, scale=0.3), "n": rnd(b, h, 1, hd,
                                                       scale=0.3),
            "m": rnd(b, h, 1, 1)}


MLSTM_ARGS = ("q", "k", "v", "li", "lf", "c", "n", "m")


def mlstm_work(shape, dtype, split=False, tf32x3=False):
    """(bytes, seconds of operations): q/k/v, gates and state read once,
    y and the new state written once; q k^T and p v over the causal pairs
    and k^T v at the input type's rate, q C and q . n (C and n are f32)
    at the f32 rate.  With `split`, the arithmetic the bf16 tensor-core
    kernel runs: C and k w_k enter as bf16 halves hi and lo, so q C and
    (k w_k)^T v are two bf16 products each at the bf16 rate; q . n stays
    an f32 reduction.  With `tf32x3` (f32), the four products as three
    TF32 products each, q . n and the n' sums at the f32 rate."""
    b, h, l, hd = shape
    es = 2 if "bfloat16" in str(dtype) else 4
    bh = b * h
    nbytes = bh * (4 * l * hd * es + 2 * l * 4
                   + 2 * (hd * hd + hd + 1) * 4)
    pairs = 4 * hd * l * (l + 1) // 2
    if tf32x3:
        return nbytes, (3 * bh * (pairs + 4 * l * hd * hd) / TF32_FLOP_PER_S
                        + bh * 4 * l * hd / F32_FLOP_PER_S)
    if split:
        typed = bh * (pairs + 2 * 2 * l * hd * hd + 2 * 2 * l * hd * hd)
        return nbytes, (typed / BF16_FLOP_PER_S
                        + bh * 2 * l * hd / F32_FLOP_PER_S)
    typed = bh * (pairs + 2 * l * hd * hd + 2 * l * hd)
    f32 = bh * (2 * l * hd * hd + 2 * l * hd)
    return nbytes, typed / flop_rate(dtype) + f32 / F32_FLOP_PER_S


def simt_flash(lib, o, window=0):
    """The SIMT flash kernel called directly (uncounted) on o's causal
    inputs: the route bf16 took before the tensor-core kernels."""
    import math
    import torch
    q, k, v = o["q"], o["k"], o["v"]
    b, s, h, hd = q.shape
    out = torch.empty_like(q)
    err = lib.flash_attention_simt(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), b, s, k.shape[1], h, k.shape[2], hd,
        1, window, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"flash_attention_simt: launch failed with error {err}")
    return out


def simt_mlstm(lib, o):
    """The SIMT mLSTM kernel called directly (uncounted) on o's inputs:
    the route bf16 took before the tensor-core kernel."""
    import math
    import torch
    q = o["q"]
    b, h, l, hd = q.shape
    y = torch.empty_like(q)
    c2, n2, m2 = (torch.empty_like(o[k]) for k in ("c", "n", "m"))
    err = lib.mlstm_chunk_simt(
        *(o[k].data_ptr() for k in MLSTM_ARGS), y.data_ptr(), c2.data_ptr(),
        n2.data_ptr(), m2.data_ptr(), int(q.dtype == torch.bfloat16), b * h,
        l, hd, 1.0 / math.sqrt(hd), torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"mlstm_chunk_simt: launch failed with error {err}")
    return y, c2, n2, m2


def llm_kernel_phase(rows):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels import cut_eval as K
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import mlstm_chunk as mk
    from repro_torch.kernels import ref
    from repro_torch.models.attention import attend, causal_window_mask

    lib = build.load()
    print("flash   dtype    kernel               B    S    T  H Hkv  hd "
          "window  max_abs_err  row_rel_err (faults edge/tile)  ms  plain_ms"
          "  sdpa_ms  bound_ms")
    print(f"  every f32 row, the routed kernel and the SIMT kernel on the "
          f"same inputs: row_rel_err within F32_GRADE_TOL "
          f"{F32_GRADE_TOL['flash']} of the plain version; f32 bound_ms as "
          "three TF32 products (bound_ms_f32: at the f32 rate)")
    hd256, f32_rows = [], []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        f32 = dtype == torch.float32
        tol = FLASH_TOL[dname]
        shapes = FLASH_SHAPES + (FLASH_HD256_SHAPES if f32
                                 else (FLASH_HD64_SHAPE,) + FLASH_HD256_SHAPES)
        for i, shape in enumerate(shapes):
            window = shape[-1]
            name = flash.flash_route(dtype, shape[5])
            o = flash_operands(shape, dtype, seed=400 + i)

            def kern(o, window=window):
                return flash.flash_attention(o["q"], o["k"], o["v"],
                                             causal=True, window=window)

            def plain(o, window=window):
                return ref.flash_attention_ref(o["q"], o["k"], o["v"],
                                               causal=True, window=window)

            K.reset_launches()
            got = kern(o)
            check(dict(K.LAUNCHES) == {name: 1},
                  f"flash_attention {dname} {shape} launched "
                  f"{dict(K.LAUNCHES)}, expected {{{name!r}: 1}}")
            want = plain(o)
            try:
                err = close(got, want, tol, tol)
            except AssertionError as e:
                fail(f"{name} {dname} {shape} vs plain: {e}")
            row_err, row_tol = row_rel_err(got, want), FLASH_ROW_TOL[dname]
            faults = {f: row_rel_err(attend(o["q"], o["k"], o["v"], m), want)
                      for f, m in fault_masks(shape[1], shape[2], window,
                                              "cuda").items()}
            check(row_err <= row_tol,
                  f"{name} {dname} {shape}: row_rel_err {row_err:.3e} vs "
                  f"plain beyond {row_tol}")
            check(min(faults.values()) > row_tol,
                  f"{name} {dname} {shape}: a planted fault reads "
                  f"{faults}, within the row_rel_err limit {row_tol}")
            check(torch.equal(got, kern(o)),
                  f"{name} {dname} {shape} not bitwise repeatable")
            line = (f"flash   {dname:8s} {name:20s} "
                    + " ".join(str(x) for x in shape) + f"  {err:.3e}  "
                    f"{row_err:.3e} ({faults['edge']:.3e}/"
                    f"{faults['tile']:.3e})")
            if f32:
                # the SIMT kernel on the same inputs, held to the same limits
                simt = simt_flash(lib, o, window)
                try:
                    simt_err = close(simt, want, tol, tol)
                except AssertionError as e:
                    fail(f"flash_attention_simt f32 {shape} vs plain: {e}")
                simt_row = row_rel_err(simt, want)
                grade = F32_GRADE_TOL["flash"]
                check(row_err <= grade and simt_row <= grade,
                      f"flash f32 {shape}: row_rel_err {row_err:.3e} "
                      f"({name}), {simt_row:.3e} (SIMT) beyond "
                      f"F32_GRADE_TOL {grade}")
                check(torch.equal(simt, simt_flash(lib, o, window)),
                      f"flash_attention_simt f32 {shape} not bitwise "
                      "repeatable")
                line += (f"; the SIMT kernel {simt_err:.3e} "
                         f"{simt_row:.3e}")
            if i == 0 or shape in FLASH_HD256_SHAPES:
                nbytes, t_ops = flash_work(shape, dtype, tf32x3=f32)
                copies = [flash_operands(shape, dtype, seed=500 + k)
                          for k in range(max(2, -(-2 * L2_BYTES // nbytes)))]
                # the same function in one library call: a window as an
                # explicit mask
                mask = None
                if window:
                    mask = causal_window_mask(
                        torch.arange(shape[1], device="cuda"),
                        torch.arange(shape[2], device="cuda"), window)

                def sdpa(o, mask=mask):
                    return F.scaled_dot_product_attention(
                        o["q"].transpose(1, 2), o["k"].transpose(1, 2),
                        o["v"].transpose(1, 2), attn_mask=mask,
                        is_causal=mask is None, enable_gqa=True)

                lib_err = float((sdpa(o).transpose(1, 2).float()
                                 - plain(o).float()).abs().max())
                ms = median_ms(kern, copies, n_launch=8, reps=5)
                plain_ms = median_ms(plain, copies, n_launch=4, reps=5)
                lib_ms = median_ms(sdpa, copies, n_launch=8, reps=5)
                simt_ms = median_ms(lambda o: simt_flash(lib, o, window),
                                    copies, n_launch=4, reps=5)
                bound, bound_by = bound_of(nbytes, t_ops)
                line += (f"  {ms:.4f}  {plain_ms:.4f}  {lib_ms:.4f}  "
                         f"{bound:.4f} ({bound_by}; sdpa vs plain "
                         f"{lib_err:.2e}); the SIMT kernel on the same "
                         f"inputs {simt_ms:.4f} ms")
                rec = {
                    "name": name, "route": "cuda", "source": SOURCES[name],
                    "replaces": REPLACES[name], "max_abs_err": err,
                    "row_rel_err": row_err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound, "bound_by": bound_by,
                    "library_ms": lib_ms}
                if name == "flash_attention_hd256":
                    hd256.append(dict(rec, shape=list(shape),
                                      simt_ms=simt_ms))
                    if shape == FLASH_HD256_SHAPES[0]:
                        check(HD256_OVER_SIMT * ms <= simt_ms,
                              f"{name} {shape}: {ms:.4f} ms, not "
                              f"{HD256_OVER_SIMT}x faster than the SIMT "
                              f"kernel's {simt_ms:.4f} ms")
                elif f32:
                    bound_f32 = bound_of(*flash_work(shape, dtype))[0]
                    line += f"; bound at the f32 rate {bound_f32:.4f}"
                    f32_rows.append(dict(
                        rec, shape=list(shape), bound_ms_f32=bound_f32,
                        simt_ms=simt_ms, simt_max_abs_err=simt_err,
                        simt_row_rel_err=simt_row))
                    if shape in (FLASH_SHAPES[0], FLASH_HD256_MAIN):
                        check(F32_OVER_SIMT * ms <= simt_ms,
                              f"{name} {shape}: {ms:.4f} ms, not "
                              f"{F32_OVER_SIMT}x faster than the SIMT "
                              f"kernel's {simt_ms:.4f} ms")
                else:
                    rows[name] = rec
            print(line + "  (bitwise repeatable: yes)", flush=True)
    # the kernel line's hd-256 row: the windowed serving shape, with every
    # timed shape beside it
    main = next(r for r in hd256 if tuple(r["shape"]) == FLASH_HD256_MAIN)
    rows["flash_attention_hd256"] = dict(main, shapes=[
        {k: r[k] for k in ("shape", "max_abs_err", "row_rel_err", "ms",
                           "plain_ms", "bound_ms", "bound_by", "library_ms",
                           "simt_ms")}
        for r in hd256])
    # the f32 rows: Llama's prefill shape (phase 8's) with every timed
    # shape beside it, for the tensor-core kernel and for the SIMT kernel
    # on the same inputs (the f32 route before it, on no path now)
    same = ("shape", "plain_ms", "bound_ms", "bound_ms_f32", "bound_by",
            "library_ms")
    rows["flash_attention_f32"] = dict(f32_rows[0], shapes=[
        {k: r[k] for k in same + ("max_abs_err", "row_rel_err", "ms",
                                  "simt_ms")}
        for r in f32_rows])
    simt_rows = [dict({k: r[k] for k in same}, max_abs_err=r[
        "simt_max_abs_err"], row_rel_err=r["simt_row_rel_err"],
        ms=r["simt_ms"]) for r in f32_rows]
    rows["flash_attention_simt"] = dict(
        simt_rows[0], name="flash_attention_simt", route="cuda",
        source=SOURCES["flash_attention_simt"],
        replaces=REPLACES["flash_attention_simt"], launches=0,
        shapes=simt_rows)

    print("mlstm   dtype    kernel            B  H    L   hd  "
          "max_abs_err(y/c/n/m)  ms  plain_ms  bound_ms")
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        f32 = dtype == torch.float32
        tol = MLSTM_TOL[dname]
        for i, shape in enumerate(MLSTM_SHAPES):
            name = mk.mlstm_route(dtype, shape[3], shape[2])
            o = mlstm_operands(shape, dtype, seed=600 + i)

            def kern(o):
                return mk.mlstm_chunk(*(o[k] for k in MLSTM_ARGS))

            def plain(o):
                return ref.mlstm_chunk_ref(*(o[k] for k in MLSTM_ARGS))

            K.reset_launches()
            got = kern(o)
            check(dict(K.LAUNCHES) == {name: 1},
                  f"mlstm_chunk {dname} {shape} launched {dict(K.LAUNCHES)},"
                  f" expected {{{name!r}: 1}}")
            want = plain(o)
            try:
                errs = [close(x, y, tol, tol) for x, y in zip(got, want)]
            except AssertionError as e:
                fail(f"{name} {dname} {shape} vs plain: {e}")
            check(all(torch.equal(x, y) for x, y in zip(got, kern(o))),
                  f"{name} {dname} {shape} not bitwise repeatable")
            line = (f"mlstm   {dname:8s} {name:16s} "
                    + " ".join(str(x) for x in shape) + "  "
                    + "/".join(f"{e:.2e}" for e in errs))
            if f32:
                # the SIMT kernel on the same inputs, held to the same
                # limits; both each output's max |diff| / max |plain|
                simt = simt_mlstm(lib, o)
                try:
                    simt_errs = [close(x, y, tol, tol)
                                 for x, y in zip(simt, want)]
                except AssertionError as e:
                    fail(f"mlstm_chunk_simt f32 {shape} vs plain: {e}")
                rels = [rel_diff(x, y) for x, y in zip(got, want)]
                simt_rels = [rel_diff(x, y) for x, y in zip(simt, want)]
                grade = F32_GRADE_TOL["mlstm"]
                check(max(rels + simt_rels) <= grade,
                      f"mlstm f32 {shape}: relative errors {rels} ({name}),"
                      f" {simt_rels} (SIMT) beyond F32_GRADE_TOL {grade}")
                check(all(torch.equal(x, y) for x, y in
                          zip(simt, simt_mlstm(lib, o))),
                      f"mlstm_chunk_simt f32 {shape} not bitwise repeatable")
                line += ("; relative " + "/".join(f"{e:.2e}" for e in rels)
                         + "; the SIMT kernel "
                         + "/".join(f"{e:.2e}" for e in simt_errs)
                         + ", relative "
                         + "/".join(f"{e:.2e}" for e in simt_rels))
            if i == 0:
                # the bound of the arithmetic the routed kernel runs; for
                # the bf16 tensor-core kernel also the earlier definition
                # (q C at the f32 rate), which earlier measurements used
                tc = name == "mlstm_chunk"
                nbytes, t_ops = mlstm_work(shape, dtype, split=tc,
                                           tf32x3=f32)
                copies = [mlstm_operands(shape, dtype, seed=700 + k)
                          for k in range(max(2, -(-2 * L2_BYTES // nbytes)))]
                ms = median_ms(kern, copies)
                plain_ms = median_ms(plain, copies, n_launch=8, reps=5)
                simt_ms = median_ms(lambda o: simt_mlstm(lib, o), copies)
                bound, bound_by = bound_of(nbytes, t_ops)
                line += (f"  {ms:.4f}  {plain_ms:.4f}  {bound:.4f} "
                         f"({bound_by}); the SIMT kernel on the same inputs "
                         f"{simt_ms:.4f} ms")
                rows[name] = {
                    "name": name, "route": "cuda", "source": SOURCES[name],
                    "replaces": REPLACES[name], "max_abs_err": max(errs),
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": bound_by, "library_ms": None}
                if tc:
                    f32_qc = bound_of(*mlstm_work(shape, dtype))[0]
                    rows[name]["bound_ms_f32_qc"] = f32_qc
                    line += f"; with q C at the f32 rate {f32_qc:.4f}"
                    check(ms < simt_ms,
                          f"{name} ({ms:.4f} ms) is not faster than the "
                          f"SIMT kernel ({simt_ms:.4f} ms) on the same inputs")
                else:
                    bound_f32 = bound_of(*mlstm_work(shape, dtype))[0]
                    line += f"; bound at the f32 rate {bound_f32:.4f}"
                    rows[name]["bound_ms_f32"] = bound_f32
                    rows[name]["simt_ms"] = simt_ms
                    rows["mlstm_chunk_simt"] = dict(
                        rows[name], name="mlstm_chunk_simt",
                        source=SOURCES["mlstm_chunk_simt"],
                        replaces=REPLACES["mlstm_chunk_simt"],
                        max_abs_err=max(simt_errs), ms=simt_ms, launches=0)
                    del rows["mlstm_chunk_simt"]["simt_ms"]
                    check(F32_OVER_SIMT * ms <= simt_ms,
                          f"{name} {shape}: {ms:.4f} ms, not "
                          f"{F32_OVER_SIMT}x faster than the SIMT kernel's "
                          f"{simt_ms:.4f} ms")
            print(line + "  (bitwise repeatable: yes)", flush=True)
    print("  mlstm_chunk has no single library call (the chunk is a decayed "
          "attention plus a matrix-memory update): library_ms null")


# ---------------------------------------------------------------------------
# phases 8 and 9: LLM serving at full width
# ---------------------------------------------------------------------------

SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 1024, 32
# Gemma 3 12B (phase 15): prompts past its 1,024-token window, so the
# window binds in 40 of 48 layers and the decode rings wrap at once
GEMMA_BATCH, GEMMA_PROMPT = 2, 2048
# prefill in f32, kernel route vs plain route, max |diff| / max |entry|:
# the kernels' own f32 tolerances (Llama's and Gemma's logits; xLSTM
# block by block)
ROUTE_TOL = {"llama3-8b": 2e-3, "gemma3-12b": 2e-3, "xlstm-125m": 6e-3}
# bf16 at full depth: each route's logits against an f32 evaluation of
# the same weights (plain route); the kernel route may be at most this
# many times farther from it than the plain route, plus BF16_FLOOR
DISTANCE_FACTOR, BF16_FLOOR = 2.0, 1e-3
# and kernel vs plain route directly, where bf16 rounding leaves a
# margin: Llama-3 8B measured 1.712e-2 on the H100; xLSTM-125M's routes
# differ by as much as bf16 differs from f32 (0.95 vs 0.94), so only the
# f32-distance gate holds it
BF16_ROUTE_TOL = {"llama3-8b": 5e-2, "gemma3-12b": 5e-2, "xlstm-125m": None}


def rel_diff(a, b):
    """max |a - b| / max |b|."""
    return float((a.float() - b.float()).abs().max()) \
        / float(b.float().abs().max())


def prefill_logits(cfg, params, prompts, impl=None, frames=None):
    """Prefill logits and the kernels launched for them."""
    import torch
    from repro_torch.kernels import cut_eval as K
    from repro_torch.models import transformer as tfm

    with torch.inference_mode():
        K.reset_launches()
        logits = tfm.prefill(cfg, params, prompts, frames, impl=impl)[0]
        launches = dict(K.LAUNCHES)
    check(bool(torch.isfinite(logits).all()),
          f"{cfg.name}: prefill logits not finite")
    check(logits.shape == (prompts.shape[0], prompts.shape[1],
                           cfg.vocab_size),
          f"{cfg.name}: prefill logits of shape {tuple(logits.shape)}")
    return logits, launches


# bytes of f32 expert weights `f32_logits` widens at once: Kimi K2's MoE
# block holds 384 experts, 68 GB in f32
F32_WIDEN_BYTES = 4 * 2 ** 30


def f32_moe(cfg, p, h, widen_bytes=F32_WIDEN_BYTES):
    """`moe.moe_apply` of the bf16 MoE weights `p` widened to f32, on f32
    `h`, with the experts widened a group at a time (as many as
    `widen_bytes` of f32 hold): the same products as the whole block
    widened at once."""
    import torch
    from repro_torch.models import moe

    b, s, d = h.shape
    t, e = b * s, p["wi"].shape[0]
    disp = moe.dispatch(p["router"].float(), h.reshape(t, d), cfg.top_k,
                        moe.capacity_of(t, cfg.top_k, e,
                                        cfg.capacity_factor))
    per = 4 * sum(p[k][0].numel() for k in ("wi", "wg", "wo"))
    g = max(1, widen_bytes // per)
    y = torch.cat([
        moe.experts({k: p[k][e0:e0 + g].float() for k in ("wi", "wg", "wo")},
                    disp.buf[e0:e0 + g], cfg.act)
        for e0 in range(0, e, g)])
    return moe.combine(y, disp, t, cfg.top_k).reshape(b, s, d)


def f32_logits(cfg, params, prompts, frames=None,
               widen_bytes=F32_WIDEN_BYTES):
    """Prefill logits of an f32 evaluation of the weights `params` on the
    plain route, one block's weights widened to f32 at a time (an MoE
    block's experts a group at a time, `f32_moe`): the same operations
    as prefill on the whole tree widened at once, without a second, f32
    copy of the model beside it."""
    import dataclasses as dc
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import rms_norm
    from repro_torch.utils.tree import tree_index, tree_map

    cfg32 = dc.replace(cfg, dtype="float32")

    def wide(tree):
        return tree_map(lambda a: a.float(), tree)

    def blocks(stages_params, stages, x, pos, enc_out=None):
        for st_params, st in zip(stages_params, stages):
            for r in range(st.repeats):
                for i, spec in enumerate(st.pattern):
                    bp = tree_index(st_params[f"pos{i}"], r)
                    if spec.mlp != "moe":
                        x = tfm._block_fwd(cfg32, spec, wide(bp), x, pos,
                                           enc_out, impl="ref")[0]
                        continue
                    rest = wide({k: v for k, v in bp.items() if k != "moe"})
                    x = tfm._block_fwd(cfg32, dc.replace(spec, mlp="none"),
                                       rest, x, pos, enc_out, impl="ref")[0]
                    h = rms_norm(x, rest["norm2"], cfg.norm_eps)
                    x = x + f32_moe(cfg, bp["moe"], h, widen_bytes)
        return x

    b, s = prompts.shape
    with torch.inference_mode():
        enc_out = None
        if cfg.is_encoder_decoder:
            t = frames.shape[1]
            e = frames.float() + params["enc_pos"][None, :t].float()
            e = blocks(params["encoder"], cfg.encoder_stages, e,
                       tfm._positions(b, t, e.device))
            enc_out = rms_norm(e, params["enc_norm"].float(), cfg.norm_eps)
        x = tfm._embed(params, prompts).float()
        x = blocks(params["stages"], cfg.stages, x,
                   tfm._positions(b, s, x.device), enc_out)
        head = "embed" if cfg.tie_embeddings else "lm_head"
        logits = tfm._logits(cfg32, {"final_norm": params["final_norm"]
                                     .float(), head: params[head].float()},
                             x)
    check(bool(torch.isfinite(logits).all()),
          f"{cfg.name}: f32 prefill logits not finite")
    return logits


def bf16_route_check(cfg, params, prompts, tol, frames=None):
    """Kernel and plain routes in bf16 against each other and against an
    f32 evaluation of the same weights (`f32_logits`); gates: the kernel
    route no farther from the f32 logits than DISTANCE_FACTOR times the
    plain route's distance plus BF16_FLOOR, and within `tol` of the plain
    route where `tol` is given."""
    import torch

    got, _ = prefill_logits(cfg, params, prompts, frames=frames)
    plain, _ = prefill_logits(cfg, params, prompts, impl="ref",
                              frames=frames)
    rel_kp = rel_diff(got, plain)
    f32 = f32_logits(cfg, params, prompts, frames)
    torch.cuda.empty_cache()
    d_k, d_p = rel_diff(got, f32), rel_diff(plain, f32)
    agree = float((got[:, -1].argmax(-1) == plain[:, -1].argmax(-1))
                  .float().mean())
    print(f"  prefill logits (bf16, full depth), max |diff| / max |logit|: "
          f"kernel vs plain route {rel_kp:.3e}; vs the f32 evaluation of "
          f"the same weights: kernel route {d_k:.3e}, plain route "
          f"{d_p:.3e} (gate {DISTANCE_FACTOR} x plain + {BF16_FLOOR}); "
          f"last-position argmax equal on {agree:.2f} of the rows",
          flush=True)
    check(d_k <= DISTANCE_FACTOR * d_p + BF16_FLOOR,
          f"{cfg.name} bf16: the kernel route is {d_k:.3e} from the f32 "
          f"logits, the plain route {d_p:.3e}")
    if tol is not None:
        print(f"  kernel vs plain route gate (bf16): {tol}")
        check(rel_kp <= tol, f"{cfg.name} bf16 prefill logits of the two "
              f"routes differ by {rel_kp:.3e}")
    del got, plain, f32
    torch.cuda.empty_cache()


def counting_drops():
    """A context in which every MoE dispatch appends its count of
    dropped (token, k) assignments and of all assignments (device
    tensors) to the list it yields."""
    from repro_torch.models import moe

    @contextlib.contextmanager
    def ctx():
        real, counts = moe.dispatch, []

        def dispatch(*args, **kw):
            d = real(*args, **kw)
            counts.append(((~d.keep).sum(), d.keep.numel()))
            return d

        moe.dispatch = dispatch
        try:
            yield counts
        finally:
            moe.dispatch = real
    return ctx()


def drops_of(counts):
    """(dropped, assignments) summed over `counting_drops`' records."""
    return (sum(int(n) for n, _ in counts), sum(t for _, t in counts))


def serve_phase(cfg, kernel, per_prefill, f32_cfg, per_block=False,
                batch=SERVE_BATCH, prompt=SERVE_PROMPT, focus=None,
                simt_turns=True, per_call=False):
    """Serve `cfg` (at full width; its depth as given) on both routes,
    `batch` prompts of `prompt` tokens; check the launches, the prefill
    logits of the two routes (bf16, then f32 on `f32_cfg`: whole model,
    or block by block with `per_block`), profile one prefill (with
    `focus`, the share of the kernels whose name holds it), print the
    figures (prefill and decode times, peak memory, busy shares, the MoE
    drops, the prefill's model-FLOP rate) beside the card, and return
    the kernel route's launches of one bf16 prefill and of the f32
    prefill.  `simt_turns` also times the f32 prefill on the SIMT
    kernels, in turns with its own route; `per_call` holds each kernel
    call of one bf16 prefill to its plain version on the call's inputs
    (`route_calls_check`)."""
    import torch
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.kernels import cut_eval as K
    from repro_torch.launch.serve import draw_frames, serve
    from repro_torch.models import transformer as tfm
    from repro_torch.models.config import param_count, step_flops

    arch = cfg.name
    n_params = param_count(cfg)["total"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = tfm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    print(f"{arch}: {cfg.n_layers} layers, d {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, hd {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}: "
          f"{n_params / 1e9:.3f} B parameters drawn in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB on the card",
          flush=True)
    # first use of every path outside the timed runs
    serve(cfg, batch, 64, 2, params=params)
    serve(cfg, batch, 64, 2, params=params, impl="ref")

    runs, peak = {}, {}
    for impl, label in ((None, "kernel"), ("ref", "plain"), (None, "kernel"),
                        ("ref", "plain")):
        K.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        res = serve(cfg, batch, prompt, SERVE_GEN, seed=0, params=params,
                    impl=impl)
        launches = dict(K.LAUNCHES)
        peak[label] = max(peak.get(label, 0),
                          torch.cuda.max_memory_allocated())
        runs.setdefault(label, []).append((res, launches))
        print(f"  {label:6s} route: prefill {res['prefill_s'] * 1e3:.2f} ms,"
              f" decode {res['decode_s'] / (SERVE_GEN - 1) * 1e3:.3f} "
              f"ms/token, {res['tok_per_s']:.1f} tok/s, launches {launches}",
              flush=True)
    res, launches = runs["kernel"][0]
    check(launches == {kernel: per_prefill},
          f"{arch}: the kernel route launched {launches}, expected "
          f"{{{kernel!r}: {per_prefill}}}")
    check(all(sum(x[1].values()) == 0 for x in runs["plain"]),
          f"{arch}: the plain route launched kernels")
    gen_k, gen_p = res["generated"], runs["plain"][0][0]["generated"]
    check(gen_k.shape == (batch, SERVE_GEN)
          and bool(((gen_k >= 0) & (gen_k < cfg.vocab_size)).all()),
          f"{arch}: generated tokens of shape {gen_k.shape} out of range")
    agree = float((gen_k == gen_p).mean())
    print(f"  greedy tokens equal on the two routes: {agree:.4f} of "
          f"{gen_k.size}; first row (kernel route): "
          f"{gen_k[0, :16].tolist()}")
    prompts = torch.as_tensor(make_token_stream(
        cfg.vocab_size, batch, prompt, seed=0), device="cuda")
    frames = draw_frames(cfg, batch, 0, "cuda")
    bf16_route_check(cfg, params, prompts, BF16_ROUTE_TOL[arch], frames)
    if per_call:
        with torch.inference_mode(), kernel_calls() as calls:
            tfm.prefill(cfg, params, prompts, frames)
        worst, rms, _ = route_calls_check(f"{arch} bf16 prefill", calls)
        print(f"  each of the prefill's {len(calls)} kernel calls against "
              f"its plain version on the call's inputs: row_rel_err at "
              f"most {worst:.3e} (gate {FLASH_ROW_TOL['bfloat16']}), RMS "
              f"relative difference at most {rms:.3e}", flush=True)
        del calls
        torch.cuda.empty_cache()
    with torch.inference_mode():
        busy_p = profile_call(f"{arch} prefill, kernel route",
                              lambda: tfm.prefill(cfg, params, prompts,
                                                  frames), focus=focus)
        with counting_drops() as counts:
            logits, caches = tfm.prefill(cfg, params, prompts, frames,
                                         max_seq=prompt + SERVE_GEN + 1)
            drop_p = drops_of(counts)
            counts.clear()
            # the first decode step of `serve`: the greedy tokens
            tok = tfm.greedy_sample(logits)[:, None]
            pos = torch.full((batch,), prompt, dtype=torch.int32,
                             device="cuda")
            tfm.decode_step(cfg, params, caches, tok, pos)
            drop_d = drops_of(counts)
            del logits

        def decode4():
            c = caches
            for i in range(4):
                pos = torch.full((batch,), prompt + i, dtype=torch.int32,
                                 device="cuda")
                c = tfm.decode_step(cfg, params, c, tok, pos)[1]

        busy_d = profile_call(f"{arch} 4 decode steps", decode4)
        del caches

    prefill_s = float(np.mean([r["prefill_s"] for r, _ in runs["kernel"]]))
    decode_s = float(np.mean([r["decode_s"] for r, _ in runs["kernel"]]))
    flops = step_flops(cfg, batch, prompt, training=False)["total"]
    rate = flops / prefill_s
    line = (f"  figures ({CARD}; kernel route, mean of two runs): prefill "
            f"{prefill_s * 1e3:.2f} ms, decode "
            f"{decode_s / (SERVE_GEN - 1) * 1e3:.3f} ms/token, "
            f"{batch * (SERVE_GEN - 1) / decode_s:.1f} tok/s; peak "
            f"{peak['kernel'] / 2 ** 30:.2f} GiB (plain route "
            f"{peak['plain'] / 2 ** 30:.2f}); busy: prefill "
            f"{100 * busy_p:.1f}%, decode {100 * busy_d:.1f}%; prefill "
            f"model FLOPs {flops / 1e12:.2f} T at "
            f"{rate / 1e12:.1f} TFLOP/s, "
            f"{100 * rate / BF16_FLOP_PER_S:.2f}% of the bf16 peak")
    if cfg.n_experts:
        line += (f"; MoE assignments dropped: {drop_p[0]} of {drop_p[1]} "
                 f"a prefill, {drop_d[0]} of {drop_d[1]} a decode step")
    print(line, flush=True)

    del params
    torch.cuda.empty_cache()
    params = tfm.init_params(
        f32_cfg, torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    got, launches32 = prefill_logits(f32_cfg, params, prompts,
                                     frames=frames)
    plain = prefill_logits(f32_cfg, params, prompts, impl="ref",
                           frames=frames)[0]
    rel32 = rel_diff(got, plain)
    tol = ROUTE_TOL[arch]
    print(f"  prefill logits, kernel vs plain route (f32, "
          f"{f32_cfg.n_layers} layers): max |diff| / max |logit| "
          f"{rel32:.3e}; launches {launches32}", flush=True)
    if simt_turns:
        times = {"tensor-core": [], "SIMT": []}
        for label in ("tensor-core", "SIMT", "tensor-core", "SIMT"):
            with simt_routes() if label == "SIMT" \
                    else contextlib.nullcontext():
                times[label].append(prefill_ms(f32_cfg, params, prompts))
        print(f"  f32 prefill ({f32_cfg.n_layers} layers), ms by the host "
              "clock in turns: the f32 tensor-core kernels "
              + ", ".join(f"{t:.2f}" for t in times["tensor-core"])
              + "; the SIMT kernels (the f32 route before them) "
              + ", ".join(f"{t:.2f}" for t in times["SIMT"]), flush=True)
    if per_block:
        f32_depth_check(f32_cfg, params, prompts, got, plain, tol)
    else:
        check(rel32 <= tol, f"{arch} f32 prefill logits differ by "
              f"{rel32:.3e} (gate {tol})")
    del params, got, plain
    torch.cuda.empty_cache()
    return launches, launches32


def simt_routes():
    """A context in which f32 flash and mLSTM calls take the SIMT kernels,
    the f32 route before the tensor-core kernels: the "before" of an f32
    prefill, timed beside the "after" in one run (the SIMT kernels are
    the parent's, byte for byte)."""
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import mlstm_chunk as mk

    @contextlib.contextmanager
    def ctx():
        fr, mr = flash.flash_route, mk.mlstm_route

        def flash_route(dtype, hd):
            name = fr(dtype, hd)
            return ("flash_attention_simt" if name == "flash_attention_f32"
                    else name)

        def mlstm_route(dtype, hd, l):
            name = mr(dtype, hd, l)
            return "mlstm_chunk_simt" if name == "mlstm_chunk_f32" else name

        flash.flash_route, mk.mlstm_route = flash_route, mlstm_route
        try:
            yield
        finally:
            flash.flash_route, mk.mlstm_route = fr, mr
    return ctx()


def prefill_ms(cfg, params, prompts):
    """Host-clock ms of one prefill, the device synchronised at both
    ends."""
    import torch
    from repro_torch.models import transformer as tfm

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        tfm.prefill(cfg, params, prompts)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def f32_depth_check(cfg, params, prompts, got, plain, tol):
    """For a model that amplifies f32 rounding from block to block (the
    random-weight xLSTM: about 3x per block), hold each block's kernel
    route to its plain route on the same input at `tol`, and the kernel
    route's logits to an independent f32 evaluation (the plain route on
    the CPU) no farther than DISTANCE_FACTOR times the plain card route's
    distance plus `tol`."""
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.utils.tree import tree_index, tree_map

    worst, apart = 0.0, []
    b, s = prompts.shape
    with torch.inference_mode():
        x = x_kern = params["embed"][prompts.long()]
        pos = torch.arange(s, dtype=torch.int32, device="cuda")[None] \
            .expand(b, s)
        for st_params, st in zip(params["stages"], cfg.stages):
            for r in range(st.repeats):
                for i, spec in enumerate(st.pattern):
                    bp = tree_index(st_params[f"pos{i}"], r)
                    out = tfm._block_fwd(cfg, spec, bp, x, pos)[0]
                    x = tfm._block_fwd(cfg, spec, bp, x, pos, impl="ref")[0]
                    worst = max(worst, rel_diff(out, x))
                    # the two routes' residual streams, each run on its own
                    x_kern = tfm._block_fwd(cfg, spec, bp, x_kern, pos)[0]
                    apart.append(rel_diff(x_kern, x))
    print("  f32, the two routes' residual streams run apart, after each "
          "block (max |diff| / max |entry|): "
          + " ".join(f"{a:.1e}" for a in apart), flush=True)
    with torch.inference_mode():
        t0 = time.perf_counter()
        cpu = tfm.prefill(cfg, tree_map(lambda a: a.cpu(), params),
                          prompts.cpu())[0]
        cpu_s = time.perf_counter() - t0
    d_k, d_p = rel_diff(got.cpu(), cpu), rel_diff(plain.cpu(), cpu)
    print(f"  f32, each block on the same input: kernel vs plain route at "
          f"most {worst:.3e} of the block's largest output (gate {tol}); "
          f"logits vs the plain route on the CPU ({cpu_s:.1f} s): kernel "
          f"route {d_k:.3e}, plain card route {d_p:.3e} (gate "
          f"{DISTANCE_FACTOR} x plain + {tol})", flush=True)
    check(worst <= tol, f"{cfg.name} f32: a block's kernel route differs "
          f"by {worst:.3e} from its plain route")
    check(d_k <= DISTANCE_FACTOR * d_p + tol,
          f"{cfg.name} f32: the kernel route is {d_k:.3e} from the CPU "
          f"logits, the plain card route {d_p:.3e}")


def llama_phase(rows):
    import dataclasses as dc
    from repro_torch.configs import get_config
    from repro_torch.models.config import BlockSpec, uniform_stages

    cfg32 = dc.replace(get_config("llama3-8b"), dtype="float32", n_layers=2,
                       stages=uniform_stages(2, BlockSpec()))
    launches, launches32 = serve_phase(get_config("llama3-8b"),
                                       "flash_attention", 32, cfg32)
    # bf16 at hd 128 runs the tensor-core kernel only (serve_phase holds
    # the bf16 prefill to exactly {"flash_attention": 32}); f32 the f32 one
    check(launches32 == {"flash_attention_f32": cfg32.n_layers},
          f"llama3-8b f32 prefill launched {launches32}, expected "
          f"{{'flash_attention_f32': {cfg32.n_layers}}}")
    rows["flash_attention"]["launches"] = int(launches["flash_attention"])
    rows["flash_attention_f32"]["launches"] = int(
        launches32["flash_attention_f32"])


def gemma_phase(rows):
    """Phase 15: Gemma 3 12B served at full width and depth in bf16 on the
    hd-256 tensor-core kernel; its f32 copy cut to one period of the
    pattern (five local layers, one global) on the f32 tensor-core
    kernel."""
    import dataclasses as dc
    from repro_torch.configs import get_config
    from repro_torch.models.config import Stage

    cfg = get_config("gemma3-12b")
    period = cfg.stages[0].pattern
    cfg32 = dc.replace(cfg, dtype="float32", n_layers=len(period),
                       stages=(Stage(period, 1),))
    launches, launches32 = serve_phase(
        cfg, "flash_attention_hd256", cfg.n_layers, cfg32,
        batch=GEMMA_BATCH, prompt=GEMMA_PROMPT, focus="flash_fwd_sm90_hd256")
    # bf16 at hd 256 runs the hd-256 kernel only (serve_phase holds the
    # bf16 prefill to exactly {"flash_attention_hd256": 48}); f32 the f32
    # tensor-core kernel
    check(launches32 == {"flash_attention_f32": len(period)},
          f"gemma3-12b f32 prefill launched {launches32}, expected "
          f"{{'flash_attention_f32': {len(period)}}}")
    rows["flash_attention_hd256"]["launches"] = int(
        launches["flash_attention_hd256"])
    rows["flash_attention_f32"]["launches_phase15"] = int(
        launches32["flash_attention_f32"])


def xlstm_phase(rows):
    import dataclasses as dc
    from repro_torch.configs import get_config

    cfg32 = dc.replace(get_config("xlstm-125m"), dtype="float32")
    launches, launches32 = serve_phase(get_config("xlstm-125m"),
                                       "mlstm_chunk", 40, cfg32,
                                       per_block=True)
    # bf16 at hd 192 runs the tensor-core kernel only (serve_phase holds
    # the bf16 prefill to exactly {"mlstm_chunk": 40}); f32 the f32 one
    check(launches32 == {"mlstm_chunk_f32": 40},
          f"xlstm-125m f32 prefill launched {launches32}, expected "
          "{'mlstm_chunk_f32': 40}")
    rows["mlstm_chunk"]["launches"] = int(launches["mlstm_chunk"])
    rows["mlstm_chunk_f32"]["launches"] = int(launches32["mlstm_chunk_f32"])


# ---------------------------------------------------------------------------
# phase 17: Mamba, MoE and Whisper's encoder served
# ---------------------------------------------------------------------------

# (batch, prompt) served: Mixtral's prompts run past its 4,096-token
# window (the decode ring wraps); Whisper's 416 + 32 tokens fill its
# 448-token text context
PHASE17 = {"jamba-v0.1-52b": (4, 1024), "mixtral-8x22b": (2, 5120),
           "kimi-k2-1t-a32b": (4, 1024), "whisper-large-v3": (4, 416)}
ROUTE_TOL.update({name: 2e-3 for name in PHASE17})
# bf16, kernel against plain route: Llama's 5e-2 where the model meets
# it (Whisper read 2.172e-2 on an NVIDIA H100 80GB HBM3, 700 W).  Jamba,
# Mixtral and Kimi K2 read 4.453e-1 / 3.859e-1 / 1.025e-1 there, as far
# as bf16 is from f32 on either route (6.46e-1 / 4.59e-1 / 1.11e-1): a
# rounding flip of one token's experts reorders an overflowing expert's
# queue (the Zipfian prompts drop 1.7% / 46% / 72% of the assignments)
# and Mamba's state carries it on (ROADMAP.md Queue 3 item 19).  So, as
# for xLSTM, the f32-distance gate holds them, each kernel call of the
# prefill is held to its plain version on its inputs (`per_call`), and
# the f32 copies to 2e-3
BF16_ROUTE_TOL.update({"whisper-large-v3": 5e-2, "jamba-v0.1-52b": None,
                       "mixtral-8x22b": None, "kimi-k2-1t-a32b": None})


def phase17_cfgs(name):
    """(the bf16 config served, its f32 copy) of a phase-17 model at full
    width: depth cut to what 80 GB holds beside the plain route (Jamba
    one period of its pattern; Mixtral 4 layers; Kimi K2 its dense first
    layer and one MoE layer; Whisper whole), the f32 copy further (Jamba
    pattern positions 0-3: Mamba, MoE and attention; Mixtral 1 layer;
    Kimi K2 the dense layer only, its MoE layer alone would take 68 GB in
    f32; Whisper 2 encoder and 2 decoder layers)."""
    import dataclasses as dc
    from repro_torch.configs import get_config
    from repro_torch.models.config import Stage

    cfg = get_config(name)

    def cut(stages, enc=None):
        kw = {} if enc is None else {"encoder_stages": enc}
        return dc.replace(cfg, stages=stages, n_layers=sum(
            st.n_layers for st in stages), **kw).validate()

    if name == "jamba-v0.1-52b":
        pat = cfg.stages[0].pattern
        served, small = cut((Stage(pat, 1),)), cut((Stage(pat[:4], 1),))
    elif name == "mixtral-8x22b":
        pat = cfg.stages[0].pattern
        served, small = cut((Stage(pat, 4),)), cut((Stage(pat, 1),))
    elif name == "kimi-k2-1t-a32b":
        dense, moe = cfg.stages
        served = cut((dense, Stage(moe.pattern, 1)))
        small = cut((dense,))
    else:
        served = cfg
        small = cut((Stage(cfg.stages[0].pattern, 2),),
                    (Stage(cfg.encoder_stages[0].pattern, 2),))
    return served, dc.replace(small, dtype="float32")


def flash_layers(cfg) -> int:
    """Flash launches of one prefill: one a self-attention layer, the
    encoder's included, and one a cross-attention layer."""
    layers = cfg.all_layers() + [b for st in cfg.encoder_stages
                                 for b in st.pattern * st.repeats]
    return sum((b.mixer == "attn") + b.cross_attn for b in layers)


def moe_phase(rows):
    """Phase 17: Jamba v0.1, Mixtral 8x22B, Kimi K2 and Whisper large-v3
    served at full width in bf16 on the bf16 flash kernel (Whisper's
    encoder and cross-attention through its non-causal mode), the depth
    cut as `phase17_cfgs` says; each f32 copy on the f32 flash kernel."""
    t0 = time.perf_counter()
    total = {}
    for name, (batch, prompt) in PHASE17.items():
        cfg, cfg32 = phase17_cfgs(name)
        launches, launches32 = serve_phase(
            cfg, "flash_attention", flash_layers(cfg), cfg32, batch=batch,
            prompt=prompt, focus="flash_fwd_sm90", simt_turns=False,
            per_call=True)
        check(launches32 == {"flash_attention_f32": flash_layers(cfg32)},
              f"{name} f32 prefill launched {launches32}, expected "
              f"{{'flash_attention_f32': {flash_layers(cfg32)}}}")
        total[name] = int(launches.get("flash_attention", 0))
    print(f"phase 17 flash launches per bf16 prefill: {total}")
    rows["flash_attention"]["launches_phase17"] = sum(total.values())
    print(f"phase 17 (Mamba, MoE and Whisper served): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 10: the paper's evaluation
# ---------------------------------------------------------------------------

# the reference scripts run Fig. 1 for 120 iterations: cut to 60 (and
# phase 11's swept Fig. 1 with it) to keep the script within half its
# time limit, then to 40 (four refreshes at t_pre 10) to pay for phase 19
FIG1_ITERATIONS = 40
FIG2_ITERATIONS = 40
# the reference's --fast Table 2 runs AFTO and ADBO GRAD_EQUAL (5) times
# this many iterations and FedNest this many, at 60: cut to 40 to pay
# for phase 14, then to 20 (AFTO and ADBO 100 iterations) for phase 19
TABLE2_ITERATIONS = 20
RATE_ITERATIONS = 400
COMM_ITERATIONS = 60


@contextlib.contextmanager
def metered_runs(plain=False):
    """Every `repro_torch.core.runner.run` call that the experiments make
    while this is active: its iterations, host seconds (the device
    synchronised at both ends), cut-kernel launches (counts set to 0 just
    before the run and read just after) and result.  With `plain`, each
    run takes the plain cut route (`Hyper(cut_impl="ref")`)."""
    import torch
    from repro_torch.core import runner
    from repro_torch.kernels import cut_eval as K

    inner, runs = runner.run, []

    def metered(spec):
        if plain:
            spec = dataclasses.replace(spec, hyper=dataclasses.replace(
                spec.hyper, cut_impl="ref"))
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        res = inner(spec)
        torch.cuda.synchronize()
        runs.append({"iterations": spec.resolved_iterations(),
                     "seconds": time.perf_counter() - t0,
                     "launches": dict(K.LAUNCHES), "result": res,
                     "spec": spec})
        return res

    runner.run = metered
    try:
        yield runs
    finally:
        runner.run = inner


def profile_run(label, run):
    """`profile_phase` of a metered run's first 20 iterations."""
    spec = run["spec"]
    if spec.schedule is not None:
        spec = dataclasses.replace(spec, schedule=spec.schedule.slice(0, 20))
    profile_phase(label, spec)


def ms_per_iteration(run) -> float:
    return run["seconds"] / run["iterations"] * 1e3


def check_afto_runs(label, names, runs, plain=False):
    """Each run's history finite; on the kernel route both cut kernels
    launched, on the plain route none."""
    check(len(runs) == len(names),
          f"{label}: {len(runs)} runs, expected {len(names)}")
    for name, r in zip(names, runs):
        got = r["launches"]
        res = r["result"]
        print(f"  {label} {name}: {r['iterations']} iterations, "
              f"{ms_per_iteration(r):.3f} ms/iteration, cut matrix "
              f"{tuple(res.state.cuts_ii.a.shape)}, launches matvec "
              f"{got.get('matvec', 0)} vecmat {got.get('vecmat', 0)} "
              f"rank1 {got.get('rank1', 0)} fused_round "
              f"{got.get('fused_round', 0)}, final cuts "
              f"{res.history['n_cuts_i'][-1]:.0f} / "
              f"{res.history['n_cuts_ii'][-1]:.0f}", flush=True)
        for k, v in res.history.items():
            check(bool(np.all(np.isfinite(np.asarray(v, np.float64)))),
                  f"{label} {name}: history {k} not finite")
        if plain:
            check(sum(got.values()) == 0,
                  f"{label} {name}: the plain route launched {got}")
            continue
        for k in ("matvec", "vecmat"):
            check(got.get(k, 0) > 0, f"{label} {name}: {k} never launched")


def final_rows(rows, keys):
    """{algo: {key: value of its last row}}."""
    return {a: {k: float([r for r in rows if r["algo"] == a][-1][k])
                for k in keys} for a in ("AFTO", "SFTO")}


def fig1_part():
    """Fig. 1; returns diabetes's metered AFTO run (profiled later)."""
    from repro_torch.experiments import fig1_robust_hpo as fig1

    for ds, setting in fig1.SETTINGS.items():
        with metered_runs() as runs:
            rows = fig1.run_dataset(ds, FIG1_ITERATIONS, engine="scan",
                                    device="cuda")
        PHASE10[f"fig1 {ds}"] = runs
        finals = final_rows(rows, ("mse_noisy", "mse_clean"))
        print(f"fig1 {ds} (N, S, stragglers, tau) = {setting}: accel "
              f"{fig1.speedup(rows, ds):.4f}; final noisy / clean MSE "
              + "; ".join(f"{a} {f['mse_noisy']:.6g} / {f['mse_clean']:.6g}"
                          for a, f in finals.items()), flush=True)
        check_afto_runs(f"fig1 {ds}", ("AFTO", "SFTO"), runs)
        if ds != "diabetes":
            continue
        diabetes_afto = runs[0]
        with metered_runs(plain=True) as plain:
            fig1.run_dataset(ds, FIG1_ITERATIONS, engine="scan",
                             device="cuda")
        check_afto_runs(f"fig1 {ds} plain route", ("AFTO", "SFTO"), plain,
                        plain=True)
        for name, r, p in zip(("AFTO", "SFTO"), runs, plain):
            h, hp = r["result"].history, p["result"].history
            compare_routes(f"fig1 {ds} {name} kernel vs plain", h, hp,
                           ("gap_sq", "mse_clean", "mse_noisy"), 1e-4)
            check(list(h["sim_time"]) == list(hp["sim_time"]),
                  f"fig1 {ds} {name}: sim_time differs between routes")
    return diabetes_afto


def fig2_part():
    """Fig. 2; returns MNIST pretrain's metered AFTO run."""
    from repro_torch.experiments import fig2_domain_adapt as fig2

    hold_cudnn_f32()
    for d, setting in fig2.SETTINGS.items():
        with metered_runs() as runs:
            rows = fig2.run_direction(d, FIG2_ITERATIONS, engine="scan",
                                      device="cuda")
        PHASE10[f"fig2 {d}"] = runs
        finals = final_rows(rows, ("test_acc", "test_loss"))
        print(f"fig2 {d} (N, S, stragglers, tau) = {setting}: accel "
              f"{fig2.accel(rows):.4f}; final test accuracy / loss "
              + "; ".join(f"{a} {f['test_acc']:.4f} / {f['test_loss']:.6g}"
                          for a, f in finals.items()), flush=True)
        check_afto_runs(f"fig2 {d}", ("AFTO", "SFTO"), runs)
    return runs[0]


def table2_part():
    from repro_torch.experiments import table2_baselines as table2

    with metered_runs() as runs:
        scores = table2.score_methods("white_wine", TABLE2_ITERATIONS,
                                      seeds=(0,), device="cuda",
                                      engine="scan")
    check_afto_runs("table2 white_wine", ("AFTO", "ADBO"), runs)
    ms = {name: ms_per_iteration(r) for name, r in zip(("AFTO", "ADBO"),
                                                       runs)}
    ms["FEDNEST"] = scores["FEDNEST"][1] / TABLE2_ITERATIONS * 1e3
    for name, (mses, secs) in scores.items():
        check(bool(np.all(np.isfinite(mses))),
              f"table2 {name}: noisy-test MSE not finite")
        print(f"  table2 white_wine {name}: noisy-test MSE {mses[0]:.6g}, "
              f"{ms[name]:.3f} ms/iteration ({secs:.2f} s with scoring)",
              flush=True)


def theorem_part():
    """Thm 4.5 and 4.6; returns the rate check's first metered run."""
    from repro_torch.experiments import comm_complexity, rate_thm45

    with metered_runs() as runs:
        (_, _, derived), = rate_thm45.main(RATE_ITERATIONS, device="cuda",
                                           engine="scan")
    PHASE10["rate_thm45"] = runs
    print(f"rate_thm45 ({RATE_ITERATIONS} iterations x 2 seeds): {derived}",
          flush=True)
    check_afto_runs("rate_thm45", ("seed 0", "seed 1"), runs)
    rate_run = runs[0]
    with metered_runs() as runs:
        (_, _, derived), = comm_complexity.main(COMM_ITERATIONS,
                                                device="cuda")
    print(f"comm_complexity_thm46 ({COMM_ITERATIONS} iterations): "
          f"{derived}", flush=True)
    check_afto_runs("comm_complexity_thm46", ("seed 0",), runs)
    return rate_run


# phase 10's metered runs by part, which phase 11's sweeps are held to
PHASE10 = {}


def paper_phase():
    t0 = time.perf_counter()
    profiled = {"fig1 diabetes AFTO, cut kernels (two refreshes)":
                fig1_part(),
                "fig2 mnist_pretrain AFTO, cut kernels (one refresh)":
                fig2_part()}
    table2_part()
    profiled["rate_thm45 seed 0, cut kernels (two refreshes)"] = \
        theorem_part()
    print(f"phase 10 (the paper's evaluation): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return profiled


# ---------------------------------------------------------------------------
# phase 11: the sweep engine
# ---------------------------------------------------------------------------

# (R, P, D): white wine at two and four runs, domain adaptation at two
SWEEP_SHAPES = ((2,) + MAIN_SHAPE, (4,) + MAIN_SHAPE, (2,) + DA_SHAPE)
# the batched kernels' time against R x the single-run kernel's at white
# wine, f32: the most each may take (RUNS_GATES[name][R]), each between
# the redesigned kernel's readings and the earlier kernel's on the H100
# (matvec_runs 0.657 / 0.679-0.684 against 0.743-0.75 / 0.783-0.79;
# fused_round_runs at R = 4 0.624-0.647 against 0.80; PERF.md).  At R = 4
# the single-run reference cycles four copies that mostly stay in L2, and
# its time alone varied by 8% between runs, so matvec's gate there sits
# at 0.73.  At R = 2 the round keeps the earlier kernel's plan: no gate.
RUNS_GATES = {"matvec_runs": {2: 0.7, 4: 0.57},
              "fused_round_runs": {4: 0.65}}
# a swept row against the serial scan run of its method and seed
SWEEP_RTOL = 1e-4
# Table 2's two seeds, each way; the swept-against-looped record
TABLE2_SWEEP_ITERATIONS = 60
SPEED_RUNS, SPEED_ITERATIONS = 4, 15


@contextlib.contextmanager
def no_vmap_fallback():
    """An op without a batching rule raises under vmap, instead of
    functorch looping over the runs one by one."""
    import torch
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        yield
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(True)


def stack_runs(trees):
    import torch
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def batched_operands(r, p, d, dtype, seed):
    """R runs' operands of phase 2, each run its own draw."""
    return stack_runs([operands(p, d, dtype, seed + 1000 * k)
                       for k in range(r)])


def batched_calls():
    """{name: (kernel, plain, single run r, library, shared-operand call,
    its single run r)} of the three batched cut kernels."""
    import torch
    from repro_torch.kernels import cut_eval as K

    def expand(x):
        return x[0].expand(x.shape)

    return {
        "matvec_runs": (
            lambda o: K.matvec(o["a"], o["v"]),
            lambda o: K.matvec_ref(o["a"], o["v"]),
            lambda o, r: K.matvec(o["a"][r], o["v"][r]),
            lambda o: torch.bmm(o["a"], o["v"][:, :, None])[:, :, 0],
            lambda o: K.matvec(o["a"], expand(o["v"])),
            lambda o, r: K.matvec(o["a"][r], o["v"][0])),
        "vecmat_runs": (
            lambda o: K.vecmat(o["g"], o["a"]),
            lambda o: K.vecmat_ref(o["g"], o["a"]),
            lambda o, r: K.vecmat(o["g"][r], o["a"][r]),
            lambda o: torch.bmm(o["g"][:, None], o["a"])[:, 0],
            lambda o: K.vecmat(o["g"], expand(o["a"])),
            lambda o, r: K.vecmat(o["g"][r], o["a"][0])),
        "rank1_runs": (
            lambda o: K.rank1(o["x"], o["y"]),
            lambda o: K.rank1_ref(o["x"], o["y"]),
            lambda o, r: K.rank1(o["x"][r], o["y"][r]),
            lambda o: torch.bmm(o["x"][:, :, None], o["y"][:, None]),
            lambda o: K.rank1(o["x"], expand(o["y"])),
            lambda o, r: K.rank1(o["x"][r], o["y"][0])),
    }


def one_launch(name, fn):
    """fn's one call launches `name` once: the count, one runtime launch
    call under torch.profiler and at most one device kernel there.
    CUPTI may drop a short session's only device record (phase 3), so
    the call is profiled up to three times for it; returns the device
    kernel's name, or what the profiler saw instead."""
    from repro_torch.kernels import cut_eval as K
    for _ in range(3):
        K.reset_launches()
        kernels, calls = device_launches(fn)
        if kernels:
            break
    check(dict(K.LAUNCHES) == {name: 1} and len(kernels) <= 1
          and len(calls) == 1,
          f"{name}: one call ran {kernels} through {calls}, counted "
          f"{dict(K.LAUNCHES)}")
    return kernels[0] if kernels else \
        f"{calls[0]}; no device record in three sessions"


def single_copies(copies, r):
    """(copy, run) pairs over every run of every batched copy: the
    single-run kernel's reference cycles R times as many distinct
    operands as the batched call, so they too span twice the L2 cache
    and are read from device memory (run 0 of each copy alone stayed
    largely in L2 at R = 4)."""
    return [(c, k) for c in copies for k in range(r)]


def runs_gate(name, dname, r, p, d, ms, single_ms):
    """Fail where a batched kernel at white wine, f32, takes more than its
    RUNS_GATES share of R x the single-run kernel's time."""
    if dname != "float32" or (p, d) != MAIN_SHAPE \
            or r not in RUNS_GATES[name]:
        return
    share = ms / (r * single_ms)
    check(share <= RUNS_GATES[name][r],
          f"{name} ({r}, {p}, {d}): {ms * 1e3:.2f} us is {share:.3f} x R x "
          f"the single-run kernel's {single_ms * 1e3:.2f} us (gate "
          f"{RUNS_GATES[name][r]})")


def batched_kernel_phase(rows):
    """The batched cut kernels against their plain batched versions, each
    row against the single-run kernel on that run (bitwise), one launch a
    call, bitwise repeats, a shared operand at run stride 0; device times
    beside R x the single-run kernel's, the bound and torch.bmm."""
    import torch
    from repro_torch.kernels import cut_eval as K

    print("batched  dtype     R  P      D   max_abs_err  ms  R*single_ms  "
          "plain_ms  bmm_ms  bound_ms")
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        rtol, atol = TOL[dname]
        for i, (r, p, d) in enumerate(SWEEP_SHAPES):
            o = batched_operands(r, p, d, dtype, seed=i)
            single_bytes = work("matvec", {"a": o["a"][0]})[0]
            n_copies = min(16, -(-2 * L2_BYTES // (r * single_bytes)))
            copies = [batched_operands(r, p, d, dtype, seed=100 + k)
                      for k in range(n_copies)]
            for name, (kern, plain, single, lib, shared, shared_one) in \
                    batched_calls().items():
                label = f"{name} {dname} ({r}, {p}, {d})"
                out = kern(o)
                try:
                    err = close(out, plain(o), rtol, atol)
                except AssertionError as e:
                    fail(f"{label} vs plain: {e}")
                check(all(torch.equal(out[k], single(o, k))
                          for k in range(r)),
                      f"{label}: a row differs from the single-run kernel")
                check(torch.equal(out, kern(o)),
                      f"{label} not bitwise repeatable")
                got = shared(o)
                check(all(torch.equal(got[k], shared_one(o, k))
                          for k in range(r)),
                      f"{label}: a shared operand changed a row")
                kernel = one_launch(name, lambda: kern(o))
                ms = median_ms(kern, copies)
                single_ms = median_ms(lambda ck: single(*ck),
                                      single_copies(copies, r))
                plain_ms = median_ms(plain, copies)
                lib_ms = median_ms(lib, copies) \
                    if dtype == torch.float32 else None
                nbytes, flops = work(BATCHED[name], {"a": o["a"][0]})
                bound, bound_by = bound_of(r * nbytes,
                                           r * flops / F32_FLOP_PER_S)
                print(f"{name:12s} {dname:8s} {r} {p:2d} {d:7d}  "
                      f"{err:.3e}  {ms:.4f}  {r * single_ms:.4f}  "
                      f"{plain_ms:.4f}  "
                      + ("-" if lib_ms is None else f"{lib_ms:.4f}")
                      + f"  {bound:.4f}  (rows bitwise the single-run "
                      f"kernel, shared operand at stride 0, one launch: "
                      f"{kernel[:30]})", flush=True)
                if name == "matvec_runs":
                    blocks, cw = K._cut_grid(0, p, d, o["a"].element_size())
                    print(f"  layout: {blocks} x {r} blocks (chunk, run) of "
                          f"{cw} columns, "
                          + ("v fetched ahead of A" if dtype == torch.float32
                             else "v staged after A's loads")
                          + (", two 4-row sweeps of one staged v slice, "
                             "4 blocks an SM"
                             if dtype == torch.float32 and p > 2 else
                             ", 4 blocks an SM" if dtype == torch.float32
                             else ", 2 blocks an SM")
                          + f"; {ms / (r * single_ms):.3f} x R x single",
                          flush=True)
                    runs_gate(name, dname, r, p, d, ms, single_ms)
                if dtype == torch.float32 and i == 0:
                    rows[name] = {
                        "name": name, "route": "cuda",
                        "source": SOURCES[name],
                        "replaces": REPLACES[name], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": bound_by, "library_ms": lib_ms,
                        "runs": r, "single_x_runs_ms": r * single_ms}
            if dtype == torch.float32 and i in (0, 2):
                with no_vmap_fallback():
                    sweep_grads_check(o, f"({r}, {p}, {d})")
    with no_vmap_fallback():
        batched_round_phase(rows)


def gog_error(got, want, truth):
    """(kernel, plain) errors against float64, of its max |entry|."""
    t = truth.detach()
    scale = float(t.abs().max())
    return (float((got.double() - t).abs().max()) / scale,
            float((want.double() - t).abs().max()) / scale)


def sweep_grads_check(o, label):
    """vmap(grad) and vmap(grad(grad)) through MV (its backward: VM,
    OUTER), and jvp, against the plain route (first order) and float64
    (second order), as phase 2 holds the single-run route; only batched
    kernels launch."""
    import torch
    from torch.func import grad, jvp, vmap
    from repro_torch.kernels import cut_ad
    from repro_torch.kernels import cut_eval as K

    a, v = o["a"], o["v"]
    p = a.shape[1]
    c = o["g"][0].float()
    act = (o["x"][0].float() > -0.5).float()
    act[0] = 1.0
    w = o["y"][0, :p].float()

    def loss_of(mv):
        return lambda a, v: 0.5 * torch.sum(w * ((mv(a, v) - c) * act) ** 2)

    k_loss = loss_of(cut_ad.MV.apply)
    p_loss = loss_of(K.matvec_ref)
    t_loss = lambda a, v: 0.5 * torch.sum(   # noqa: E731
        w.double() * ((a @ v - c.double()) * act.double()) ** 2)

    def gog(loss):
        return lambda a, v: grad(
            lambda v: torch.sum(grad(loss, argnums=1)(a, v) ** 2))(v)

    K.reset_launches()
    g_k = vmap(grad(k_loss, argnums=(0, 1)))(a, v)
    gg_k = vmap(gog(k_loss))(a, v)
    launched = dict(K.LAUNCHES)
    g_p = vmap(grad(p_loss, argnums=(0, 1)))(a, v)
    gg_p = vmap(gog(p_loss))(a, v)
    gg_t = vmap(gog(t_loss))(a.double(), v.double())
    check(set(launched) == {"matvec_runs", "vecmat_runs", "rank1_runs"},
          f"vmap(grad) {label} launched {launched}")
    try:
        errs = [close(x, y, *TOL["float32"]) for x, y in zip(g_k, g_p)]
    except AssertionError as e:
        fail(f"vmap(grad) through MV {label}: {e}")
    e_k, e_p = gog_error(gg_k, gg_p, gg_t)
    check(e_k <= 2 * e_p + GOG_FLOOR["float32"],
          f"vmap(grad(grad)) through MV {label}: {e_k:.2e} of max |entry| "
          f"vs the plain route's {e_p:.2e}")
    da, dv = o["a"][1].float(), o["v"][1].float()
    tk = jvp(lambda a, v: (cut_ad.MV.apply(a, v) - c) * act, (a[0], v[0]),
             (da, dv))[1]
    tp = jvp(lambda a, v: (K.matvec_ref(a, v) - c) * act, (a[0], v[0]),
             (da, dv))[1]
    try:
        e_jvp = close(tk, tp, *TOL["float32"])
    except AssertionError as e:
        fail(f"jvp through MV {label}: {e}")
    print(f"MV under vmap {label}: vmap(grad) max abs err vs plain da "
          f"{errs[0]:.2e} dv {errs[1]:.2e}; vmap(grad(grad)) err vs "
          f"float64 kernel/plain {e_k:.1e}/{e_p:.1e}; jvp {e_jvp:.2e}; "
          f"launches {launched}", flush=True)


def batched_round_phase(rows):
    """The batched fused round at white wine, R = 2 (A held on chip) and
    R = 4 (7 of 8 rows held): the plan, values against the plain
    version, each row bitwise the single-run kernel at the batched plan,
    one launch, a bitwise repeat, times and their gates; vmap(grad), vmap(grad(grad)) and jvp through
    FusedRound at R = 2."""
    import torch
    from torch.func import grad, jvp, vmap
    from repro_torch.kernels import inner_round as R
    from repro_torch.kernels import ops

    p, d = MAIN_SHAPE
    rtol, atol = TOL["float32"]
    steps = tuple(FUSED_STEPS[k] for k in STEP_NAMES)
    for r in (2, 4):
        def ops_of(seed):
            return stack_runs([round_operands(p, d, torch.float32,
                                              seed + k) for k in range(r)])
        o = ops_of(500)
        copies = [ops_of(600 + 10 * k) for k in range(
            min(16, -(-2 * L2_BYTES // (r * round_work(
                {"a": o["a"][0]})[0]))))]

        def kern(o):
            return R.fused_cut_round(*(o[k] for k in ROUND_ARGS),
                                     **FUSED_STEPS)

        def plain(o):
            return R.fused_cut_round_ref(*(o[k] for k in ROUND_ARGS),
                                         **FUSED_STEPS)

        plan = R.plan_for(o["a"])

        def single(o, k, plan=None):
            return R.fused_cut_round(*(o[n][k] for n in ROUND_ARGS),
                                     plan=plan, **FUSED_STEPS)

        label = f"fused_round_runs float32 ({r}, {p}, {d})"
        got = kern(o)
        try:
            errs = [close(x, y, rtol, atol) for x, y in zip(got, plain(o))]
        except AssertionError as e:
            fail(f"{label} vs plain: {e}")
        check(all(torch.equal(x[k], y) for k in range(r)
                  for x, y in zip(got, single(o, k, plan))),
              f"{label}: a row differs from the single-run kernel at the "
              "batched plan")
        check(all(torch.equal(x, y) for x, y in zip(got, kern(o))),
              f"{label} not bitwise repeatable")
        kernel = one_launch("fused_round_runs", lambda: kern(o))
        ms = median_ms(kern, copies)
        single_ms = median_ms(lambda ck: single(*ck),
                              single_copies(copies, r))
        plain_ms = median_ms(plain, copies)
        nbytes, flops = round_work({"a": o["a"][0]})
        bound, bound_by = bound_of(r * nbytes, r * flops / F32_FLOP_PER_S)
        held = ("A held on chip" if plan.on_chip else
                f"{plan.rows_on_chip} of {p} rows held on chip"
                if plan.rows_on_chip else "A streamed")
        print(f"{label}: {plan.blocks} blocks a run of {plan.cw} columns,"
              f" {held} ({plan.smem} bytes of shared memory a block; one run alone:"
              f" {R.plan_for(o['a'][0])}); max abs err "
              + "/".join(f"{e:.2e}" for e in errs)
              + f"; {ms:.4f} ms ({ms / (r * single_ms):.3f} x R x single), "
              f"R x single {r * single_ms:.4f}, plain "
              f"{plain_ms:.4f}, bound {bound:.4f}; rows bitwise the "
              f"single-run kernel at this plan; one launch "
              f"({kernel[:30]})", flush=True)
        runs_gate("fused_round_runs", "float32", r, p, d, ms, single_ms)
        if r == 2:
            rows["fused_round_runs"] = {
                "name": "fused_round_runs", "route": "cuda",
                "source": SOURCES["fused_round_runs"],
                "replaces": REPLACES["fused_round_runs"],
                "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": bound_by,
                "library_ms": None, "runs": r,
                "single_x_runs_ms": r * single_ms}

    # derivatives through FusedRound under vmap, at R = 2
    o = stack_runs([round_operands(p, d, torch.float32, 700 + k)
                    for k in range(2)])
    rest = tuple(o[k] for k in ("g_other", "mask", "c", "active"))

    def loss_of(round_fn):
        def loss(a, v, s, gamma, rest):
            outs = round_fn(a, v, rest[0], rest[1], rest[2], rest[3], s,
                            gamma)
            return sum(torch.sum(t ** 2) for t in outs)
        return loss

    def k_round(*xs):
        return ops.FusedRound.apply(*xs, *steps)

    def p_round(*xs):
        return R.fused_cut_round_ref(*xs, **FUSED_STEPS)

    def t_round(*xs):
        return R.fused_round_math(lambda a, x: a @ x, lambda g, a: g @ a,
                                  *xs, *steps)

    def gog(loss):
        return lambda a, v, s, gamma, rest: grad(
            lambda v: sum(torch.sum(t ** 2) for t in grad(
                loss, argnums=(0, 1))(a, v, s, gamma, rest)))(v)

    wrt = tuple(o[k] for k in ("a", "v", "s", "gamma"))
    g_k = vmap(grad(loss_of(k_round), argnums=(0, 1, 2, 3)))(*wrt, rest)
    g_p = vmap(grad(loss_of(p_round), argnums=(0, 1, 2, 3)))(*wrt, rest)
    try:
        errs = [close(x, y, rtol, atol) for x, y in zip(g_k, g_p)]
    except AssertionError as e:
        fail(f"vmap(grad) through FusedRound: {e}")
    gg_k = vmap(gog(loss_of(k_round)))(*wrt, rest)
    gg_p = vmap(gog(loss_of(p_round)))(*wrt, rest)
    gg_t = vmap(gog(loss_of(t_round)))(
        *(x.double() for x in wrt), tuple(x.double() for x in rest))
    e_k, e_p = gog_error(gg_k, gg_p, gg_t)
    check(e_k <= 2 * e_p + GOG_FLOOR["float32"],
          f"vmap(grad(grad)) through FusedRound: {e_k:.2e} of max |entry| "
          f"vs the plain route's {e_p:.2e}")
    ins = tuple(o[k][0] for k in ROUND_ARGS)
    tans = tuple(o[k][1] if k in ("a", "v", "g_other", "s", "gamma")
                 else torch.zeros_like(o[k][1]) for k in ROUND_ARGS)
    tk = jvp(k_round, ins, tans)[1]
    tp = jvp(p_round, ins, tans)[1]
    try:
        e_jvp = [close(x, y, rtol, atol) for x, y in zip(tk, tp)]
    except AssertionError as e:
        fail(f"jvp through FusedRound: {e}")
    print("FusedRound under vmap (2, 8, 242628): vmap(grad) max abs err vs"
          " plain " + " ".join(f"{e:.2e}" for e in errs)
          + f"; vmap(grad(grad)) err vs float64 kernel/plain {e_k:.1e}/"
          f"{e_p:.1e}; jvp " + " ".join(f"{e:.2e}" for e in e_jvp),
          flush=True)


def check_sweep_rows(label, swept, serial):
    """Each row of a metered sweep against the serial scan run of its
    method and seed: histories within rtol 1e-4, cut counts, sim_time
    and max_staleness exact, the final II-layer cut rows, gamma_k and
    inner level-2 state within 1e-4 of each tensor's largest entry."""
    res = swept["result"]
    check(res.n_runs == len(serial),
          f"{label}: {res.n_runs} swept runs, {len(serial)} serial")
    keys = [k for k in res.history if k not in (
        "t", "sim_time", "max_staleness", "host_time", "n_cuts_i",
        "n_cuts_ii")]
    worst = (0.0, "")
    for r, one in enumerate(serial):
        row, ref = res.run(r), one["result"]
        compare_routes(f"{label} row {r} vs serial", row.history,
                       ref.history, keys, SWEEP_RTOL)
        for k in ("sim_time", "max_staleness", "t"):
            check(list(row.history[k]) == list(ref.history[k]),
                  f"{label} row {r}: {k} differs from the serial run")
        diffs = final_state_diffs(row.state, ref.state)
        for k, v in diffs.items():
            check(v <= STATE_RTOL, f"{label} row {r} final {k}: {v:.2e} "
                  f"of the largest entry > {STATE_RTOL}")
        worst = max([worst, *((v, f"row {r} {k}")
                               for k, v in diffs.items())])
    got = swept["launches"]
    serial_ms = sum(one["seconds"] for one in serial) \
        / swept["iterations"] * 1e3
    print(f"  {label}: sweep of {res.n_runs} {ms_per_iteration(swept):.3f} "
          f"ms/iteration, serial runs {serial_ms:.3f} ms/iteration in all "
          "(nan: a run timed in an earlier phase); "
          "sweep launches " + ", ".join(
              f"{k} {v}" for k, v in sorted(got.items()))
          + f"; final state within {worst[0]:.2e} of the serial runs' "
          f"(largest: {worst[1]})", flush=True)
    for k in ("matvec", "vecmat", "rank1", "fused_round"):
        check(got.get(k, 0) == 0,
              f"{label}: the sweep launched the single-run {k}")
    for k in ("matvec_runs", "vecmat_runs"):
        check(got.get(k, 0) > 0, f"{label}: {k} never launched")


def swept_paper_runs(rows, ww_specs):
    """The paper's sweeps on the kernel route, each row held to phase 10's
    serial scan run (or phase 4's) of the same method and seed; the
    batched kernels' launches on them; returns the metered white-wine
    Fig. 1 sweep."""
    from repro_torch.apps.robust_hpo import make_robust_hpo_problem
    from repro_torch.core import runner
    from repro_torch.experiments import fig1_robust_hpo as fig1
    from repro_torch.experiments import fig2_domain_adapt as fig2
    from repro_torch.experiments import rate_thm45
    from repro_torch.experiments import table2_baselines as table2

    with metered_runs() as runs:
        fig1.run_dataset("white_wine", FIG1_ITERATIONS, device="cuda")
    ww_sweep = runs[0]
    check_sweep_rows("fig1 white_wine AFTO+SFTO", ww_sweep,
                     PHASE10["fig1 white_wine"])
    for name in ("matvec_runs", "vecmat_runs", "rank1_runs"):
        rows[name]["launches"] = int(ww_sweep["launches"].get(name, 0))

    # phase 4's fused route, its seed and the next as one sweep
    spec = ww_specs["fused"]
    with metered_runs() as runs:
        runner.run(dataclasses.replace(spec, engine="sweep", seeds=(0, 1)))
    with metered_runs() as serial:
        runner.run(dataclasses.replace(spec, scheduler=dataclasses.replace(
            spec.scheduler, seed=1)))
    check_sweep_rows("white-wine fused route, seeds 0 and 1", runs[0],
                     [{"result": PHASE4["fused"], "seconds": float("nan")},
                      serial[0]])
    PHASE11["fused seed 1"] = serial[0]["result"]
    check(runs[0]["launches"].get("fused_round_runs", 0) > 0,
          "fused_round_runs never launched on the swept fused route")
    rows["fused_round_runs"]["launches"] = int(
        runs[0]["launches"]["fused_round_runs"])

    hold_cudnn_f32()
    with metered_runs() as runs:
        fig2.run_direction("mnist_pretrain", FIG2_ITERATIONS, device="cuda")
    check_sweep_rows("fig2 mnist_pretrain AFTO+SFTO", runs[0],
                     PHASE10["fig2 mnist_pretrain"])

    tasks = [make_robust_hpo_problem("white_wine", n_workers=4, seed=s,
                                     device="cuda") for s in (0, 1)]
    with metered_runs() as serial:
        table2.run_afto_seeds(tasks, 4, TABLE2_SWEEP_ITERATIONS, (0, 1))
    with metered_runs() as runs:
        table2.run_afto_swept(tasks, 4, TABLE2_SWEEP_ITERATIONS, (0, 1))
    check_sweep_rows("table2 white_wine N=4 AFTO seeds 0 and 1 (stacked "
                     "per-seed data)", runs[0], serial)

    with metered_runs() as runs:
        (_, _, derived), = rate_thm45.main(RATE_ITERATIONS, device="cuda")
    print(f"  rate_thm45 swept (seeds=(0, 1)): {derived}", flush=True)
    check_sweep_rows("rate_thm45 seeds 0 and 1", runs[0],
                     PHASE10["rate_thm45"])
    return ww_sweep


# phase 11's serial white-wine run of the fused route at schedule seed 1,
# which phase 14's sharded sweep is held to
PHASE11 = {}


def sweep_phase(rows, ww_specs):
    """Phase 11's sweeps, with no per-run fallback, and the sweep against
    a loop of single runs; returns the spec of a white-wine sweep to
    profile."""
    from repro_torch.core import StragglerConfig
    from repro_torch.experiments import engine_speed

    t0 = time.perf_counter()
    with no_vmap_fallback():
        ww_sweep = swept_paper_runs(rows, ww_specs)
        record = engine_speed.sweep_record(SPEED_ITERATIONS, SPEED_RUNS,
                                           reps=1, device="cuda")
    print(f"  engine_speed.sweep_record (white wine, R = {SPEED_RUNS}, "
          f"{SPEED_ITERATIONS} iterations, not gated): "
          f"{json.dumps(record['sweep'])}", flush=True)
    print(f"phase 11 (the sweep engine): {time.perf_counter() - t0:.1f} s",
          flush=True)
    return dataclasses.replace(
        ww_sweep["spec"], schedules=None, seeds=(0, 1), sweep_hypers=None,
        scheduler=StragglerConfig(n_workers=6, s_active=4, tau=10,
                                  n_stragglers=1, seed=0))


# ---------------------------------------------------------------------------
# phase 12: streams, chunked runs and checkpoints
# ---------------------------------------------------------------------------

STREAM_DIM = 16_384
STREAM_WORKERS = 4
STREAM_ITERATIONS = 60
# the quadratic's cut space at p_max = 6: (a1, a2, a3) of dim each and the
# workers' (b2, b3) blocks
STREAM_SHAPE = (6, 3 * STREAM_DIM + 2 * STREAM_WORKERS * STREAM_DIM)
STREAM_CHUNKS = (0, 23, 60)
# white wine's 120 iterations, boundaries off the t_pre = 10 stride
WW_CHUNKS = (0, 37, 80, 120)
WW_RESUME = 80
# phase 12 (b)'s white-wine runs (unchunked, in chunks, resumed; each
# route): 60 iterations, cut from phase 4's 120 to pay for phase 19,
# the first boundary off the t_pre = 10 stride, the resumed run crossing
# two refreshes
CKPT_ITERATIONS = 60
CKPT_CHUNKS = (0, 17, 40, 60)
CKPT_RESUME = 40


def stream_scales(dim, b_unit=False):
    """(A scale, b scale) holding the registry's norms at dim 3 (A at 0.3,
    b at 1 per entry): at 0.3 and dim 16,384, ||A^T A|| ~ 5,900 and the
    x3 step (eta_x = 0.05) diverges within a few iterations.  `b_unit`
    keeps b at 1 per entry."""
    s = (3 / dim) ** 0.5
    return 0.3 * s, 1.0 if b_unit else s


def quadratic_stream_setup(dim=STREAM_DIM, b_unit=False):
    """The registry's `quadratic` problem and `quadratic_stream`
    (src/repro/fed/runtime/problems.py:99-145) at width `dim` on the card,
    at `stream_scales`: (problem, hyper, scheduler config, stream).  Each
    worker's static row and each stream row is its own generator's
    draw."""
    import torch
    from repro_torch.core import Hyper, StragglerConfig, TrilevelProblem
    from repro_torch.data import stream as stream_lib

    n = STREAM_WORKERS
    a_scale, b_scale = stream_scales(dim, b_unit)

    def sample(key, device):
        g = stream_lib.generator(key, device)
        return {"A": torch.randn((dim, dim), generator=g,
                                 device=device).mul_(a_scale),
                "b": torch.randn((dim,), generator=g,
                                 device=device).mul_(b_scale)}

    rows = [sample(j, "cuda") for j in range(n)]
    data = {k: torch.stack([r[k] for r in rows]) for k in ("A", "b")}
    del rows

    def f1(d, x1, x2, x3):
        return torch.sum((x1 - d["A"] @ x3 - d["b"]) ** 2)

    def f2(d, x1, x2, x3):
        return torch.sum((x2 + x3) ** 2) + 0.1 * torch.sum(x2 ** 2)

    def f3(d, x1, x2, x3):
        return torch.sum((x3 - x1) ** 2) + 0.1 * torch.sum((x3 - x2) ** 2)

    def zeros():
        return torch.zeros(dim, device="cuda")

    problem = TrilevelProblem(f1=f1, f2=f2, f3=f3, data=data, n_workers=n,
                              x1_init=zeros(), x2_init=zeros(),
                              x3_init=zeros())
    hyper = Hyper(n_workers=n, s_active=n - 1, tau=5, k_inner=3, p_max=6,
                  t_pre=5, t1=100, eta_x=0.05, eta_z=0.05, d1=dim)
    cfg = StragglerConfig(n_workers=n, s_active=n - 1, tau=5,
                          n_stragglers=1, straggler_slowdown=5.0, seed=0)
    # the registry's stream key is its own, apart from the data's seed
    return problem, hyper, cfg, stream_lib.make_stream(sample, n, 1000)


def run_in_chunks(spec, schedule, bounds, hook=None):
    """`spec` over `schedule` as state-continued `run(RunSpec)` calls over
    `bounds`, each one chunk (`chunk_size` = its length) whose
    `chunk_hook` is `hook`: (result with the stitched history,
    launches, seconds)."""
    from repro_torch.core import RunSpec

    state, parts, launches, secs = spec.state, [], {}, 0.0
    for a, b in zip(bounds[:-1], bounds[1:]):
        res, dt, got = timed_run(dataclasses.replace(
            spec, schedule=schedule.slice(a, b), state=state,
            chunk_size=b - a, chunk_hook=hook))
        state, secs = res.state, secs + dt
        parts.append(dict(res.history, t=res.history["t"] + a))
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    history = {k: np.concatenate([h[k] for h in parts]) for k in parts[0]}
    return (type(res)(state=state, history=history), launches, secs)


def bitwise_diffs(got, want, offset=0):
    """Names of the state leaves and history keys (all but t and
    host_time, from row `offset` of `want`'s) that differ in any bit."""
    import torch
    from repro_torch.utils.tree import tree_flatten

    out = []
    la, _ = tree_flatten(got.state)
    lb, _ = tree_flatten(want.state)
    for i, (x, y) in enumerate(zip(la, lb)):
        if not (x.dtype == y.dtype and torch.equal(x, y)):
            out.append(f"state leaf {i}")
    for k, v in got.history.items():
        if k in ("t", "host_time"):
            continue
        if not np.array_equal(v, want.history[k][offset:offset + len(v)]):
            out.append(f"history {k}")
    return out


def check_bitwise(label, got, want, rerun, offset=0):
    """`got` equals `want` bit for bit; on a difference, a second run of
    `want` (`rerun()`) tells a nondeterministic route from a chunking
    fault before the phase fails."""
    diffs = bitwise_diffs(got, want, offset)
    if diffs:
        again = bitwise_diffs(rerun(), want)
        fail(f"{label}: differs from the unchunked run in {diffs[:6]}; a "
             "second unchunked run " + (f"differs too, in {again[:6]}: the "
                                        "route is not deterministic"
                                        if again else "is bitwise equal"))
    print(f"  {label}: bitwise equal to the unchunked run (final state, "
          f"{len(got.history['gap_sq'])} history rows)", flush=True)


def batch_ms(stream, t_hats):
    """Device ms and host ms per `next_batch` call at each row of
    `t_hats`, CUDA events around each call."""
    import torch
    from repro_torch.data import stream as stream_lib

    dev, host = [], []
    for t_hat in t_hats:
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        s.record()
        batch = stream_lib.next_batch(stream, t_hat, device="cuda")
        e.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(s.elapsed_time(e))
        del batch
    return float(np.median(dev)), float(np.median(host))


BIND_DIM = 4_096
# phase 12 (a')'s plain-route run, which phase 14's streamed legs are held
# to
PHASE12 = {}


def binding_part(launches):
    """(a') The streamed quadratic at dim 4,096 with b at the registry's
    1 per entry, where a level-2 cut binds (gamma_k > 0): the cut-kernel
    and fused-kernel routes held to their plain routes on histories, cut
    counts, and the final cut rows, gamma_k and level-2 inner state."""
    from repro_torch.core import RunSpec, StragglerScheduler

    problem, hyper, cfg, stream = quadratic_stream_setup(BIND_DIM,
                                                         b_unit=True)
    schedule = StragglerScheduler(cfg).precompute(STREAM_ITERATIONS)
    fused = dataclasses.replace(hyper, use_fused_inner=True)
    hypers = {"plain": dataclasses.replace(hyper, cut_impl="ref"),
              "kernel": hyper,
              "fused_plain": dataclasses.replace(fused, cut_impl="ref"),
              "fused": fused}
    res = {}
    for name, hy in hypers.items():
        res[name] = timed_run(RunSpec(
            problem=problem, hyper=hy, schedule=schedule, metrics_every=5,
            data=stream, engine="scan"))
    print(f"  (a') streamed quadratic, dim {BIND_DIM:,}, b at 1 per entry, "
          f"{STREAM_ITERATIONS} iterations, ms/iteration: " + ", ".join(
              f"{k} {v[1] / STREAM_ITERATIONS * 1e3:.3f}"
              for k, v in res.items()), flush=True)
    for k in ("gap_sq", "n_cuts_i", "n_cuts_ii"):
        print(f"    {k:9s} " + " ".join(
            f"{x:.6g}" for x in res["kernel"][0].history[k]))
    for name, ref in (("kernel", "plain"), ("fused", "fused_plain"),
                      ("fused_plain", "plain")):
        got, want = res[name][0], res[ref][0]
        compare_routes(f"(a') {name} vs {ref}", got.history, want.history,
                       ("gap_sq",), 1e-4)
        diffs = final_state_diffs(got.state, want.state)
        print(f"    {name} vs {ref} final state (max |diff| / max |entry|):"
              " " + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items()))
        for k, v in diffs.items():
            check(v <= STATE_RTOL, f"(a') {name} vs {ref} final {k}: "
                  f"{v:.2e} of the largest entry > {STATE_RTOL}")
    for name, (r, _, _) in res.items():
        print_multipliers(f"(a') {name}", r.state)
        check(float(r.state.gamma_k.max()) > 0,
              f"(a') no level-2 cut binds on the {name} route")
    for name in ("plain", "fused_plain"):
        check(sum(res[name][2].values()) == 0,
              f"(a') the {name} route launched {res[name][2]}")
    PHASE12["(a') plain"] = (res["plain"][0], hyper)
    launches["(a') binding, cut kernels"] = res["kernel"][2]
    launches["(a') binding, fused kernel"] = res["fused"][2]
    check(res["fused"][2].get("fused_round", 0) > 0,
          "(a') fused_round never launched on the fused route")


def streamed_part(launches):
    """(a) the streamed quadratic on the cut-kernel and the plain route,
    and in chunks; returns (kernel-route spec, scheduler config, its
    result)."""
    from repro_torch.core import RunSpec, StragglerScheduler

    problem, hyper, cfg, stream = quadratic_stream_setup()
    schedule = StragglerScheduler(cfg).precompute(STREAM_ITERATIONS)
    spec = RunSpec(problem=problem, hyper=hyper, schedule=schedule,
                   metrics_every=1, data=stream, engine="scan")
    plain_spec = dataclasses.replace(
        spec, hyper=dataclasses.replace(hyper, cut_impl="ref"))
    timed_run(dataclasses.replace(spec, schedule=schedule.slice(0, 3)))
    kern, k_s, k_launch = timed_run(spec)
    plain, p_s, p_launch = timed_run(plain_spec)
    a_shape = tuple(kern.state.cuts_ii.a.shape)
    check(a_shape == STREAM_SHAPE, f"streamed cut matrix {a_shape} != "
          f"{STREAM_SHAPE}")
    h = kern.history
    print(f"  (a) streamed quadratic, N={STREAM_WORKERS}, dim "
          f"{STREAM_DIM:,}, cut matrix {a_shape}, A and b scales "
          f"{stream_scales(STREAM_DIM)}, {STREAM_ITERATIONS} iterations: "
          f"cut kernels {k_s / STREAM_ITERATIONS * 1e3:.3f} ms/iteration, "
          f"plain {p_s / STREAM_ITERATIONS * 1e3:.3f}", flush=True)
    for k in ("gap_sq", "n_cuts_i", "n_cuts_ii"):
        print(f"    {k:9s} " + " ".join(f"{x:.6g}" for x in h[k][9::10]))
    compare_routes("(a) streamed kernel vs plain", h, plain.history,
                   ("gap_sq",), 1e-4)
    check(sum(p_launch.values()) == 0,
          f"the plain streamed route launched {p_launch}")
    for k in ("matvec", "vecmat"):
        check(k_launch.get(k, 0) > 0,
              f"{k} never launched on the streamed run")
    launches["(a) streamed, cut kernels"] = k_launch
    st = kern.state
    print_multipliers("(a) streamed", st)
    bound = float(st.lam.max()) > 0 or float(st.gamma_k.max()) > 0 or \
        float(st.inner2.gamma.max()) > 0
    print(f"    a cut binds on the streamed run: {'yes' if bound else 'no'}"
          f" (lam, gamma_k or inner2.gamma above 0)", flush=True)

    t_hats = [np.full(STREAM_WORKERS, t) for t in range(5)]
    dev_ms, host_ms = batch_ms(stream, t_hats)
    print(f"    batch synthesis: {dev_ms:.3f} ms device, {host_ms:.3f} ms "
          f"host per iteration ({STREAM_WORKERS} x {STREAM_DIM:,}^2 f32, "
          f"{STREAM_WORKERS * STREAM_DIM ** 2 * 4 / 1e9:.2f} GB; median "
          "of 5, CUDA events around next_batch)", flush=True)

    chunked, _, _ = run_in_chunks(spec, schedule, STREAM_CHUNKS)
    check_bitwise(f"(a) streamed run in chunks {list(STREAM_CHUNKS)}",
                  chunked, kern, lambda: timed_run(spec)[0])
    return spec, cfg, kern


def checkpoint_part(ww_specs, launches, tmp):
    """(b) white wine on the cut-kernel and fused routes: unchunked, in
    chunks with a checkpoint at each boundary, and resumed from the
    step-40 checkpoint into a fresh template, all bit for bit."""
    from repro_torch import checkpoint
    from repro_torch.core import StragglerScheduler, afto

    for name in ("kernel", "fused"):
        spec = ww_specs[name]
        schedule = StragglerScheduler(spec.scheduler).precompute(
            CKPT_ITERATIONS)
        spec = dataclasses.replace(spec, schedule=schedule, scheduler=None,
                                   metrics_every=1, metrics_fn=None)
        full, f_s, f_launch = timed_run(spec)
        directory = str(Path(tmp) / name)
        saved = []

        def save(state, t_abs):
            saved.append(int(state.t))
            checkpoint.save_checkpoint(directory, state, int(state.t))

        chunked, c_launch, c_s = run_in_chunks(spec, schedule, CKPT_CHUNKS,
                                               save)
        check(saved == list(CKPT_CHUNKS[1:]),
              f"(b) {name}: checkpoints at {saved}")
        rerun = lambda: timed_run(spec)[0]  # noqa: E731
        check_bitwise(f"(b) white wine, {name} route, in chunks "
                      f"{list(CKPT_CHUNKS)}", chunked, full, rerun)
        template = afto.init_state(spec.problem, spec.hyper)
        state = checkpoint.load_checkpoint(directory, template, CKPT_RESUME)
        resumed, r_s, _ = timed_run(dataclasses.replace(
            spec, schedule=schedule.slice(CKPT_RESUME, CKPT_ITERATIONS),
            state=state))
        check_bitwise(f"(b) white wine, {name} route, resumed from the "
                      f"step-{CKPT_RESUME} checkpoint", resumed, full, rerun,
                      offset=CKPT_RESUME)
        print(f"  (b) white wine {name}: unchunked "
              f"{f_s / CKPT_ITERATIONS * 1e3:.3f} ms/iteration, in chunks "
              f"{c_s / CKPT_ITERATIONS * 1e3:.3f} (3 checkpoints), resumed "
              f"{r_s / (CKPT_ITERATIONS - CKPT_RESUME) * 1e3:.3f}; checkpoint "
              f"files {sorted(p.name for p in Path(directory).iterdir())}",
              flush=True)
        launches[f"(b) white wine, {name}, in chunks"] = c_launch
    for k in ("matvec", "vecmat"):
        check(launches["(b) white wine, kernel, in chunks"].get(k, 0) > 0,
              f"(b) {k} never launched on the chunked cut-kernel route")
    check(launches["(b) white wine, fused, in chunks"].get(
        "fused_round", 0) > 0, "(b) fused_round never launched on the "
          "chunked fused route")


def streamed_sweep_part(spec, cfg, serial0, launches):
    """(c) the streamed quadratic as a sweep of 2 (schedule seeds 0 and
    1, one shared stream), each row held to its serial streamed run."""
    from repro_torch.core import runner

    spec = dataclasses.replace(spec, schedule=None,
                               n_iterations=STREAM_ITERATIONS)
    with metered_runs() as serial:
        runner.run(dataclasses.replace(
            spec, scheduler=dataclasses.replace(cfg, seed=1)))
    with metered_runs() as runs:
        runner.run(dataclasses.replace(spec, engine="sweep", seeds=(0, 1),
                                       scheduler=cfg))
    check_sweep_rows("(c) streamed sweep of 2, seeds 0 and 1", runs[0],
                     [{"result": serial0, "seconds": float("nan")},
                      serial[0]])
    launches["(c) streamed sweep"] = runs[0]["launches"]


def stream_phase(rows, ww_specs):
    """Phase 12: returns the streamed spec to profile."""
    import tempfile

    import torch
    from repro_torch.experiments import engine_speed

    t0 = time.perf_counter()
    # earlier phases may leave cyclic garbage that still holds device
    # tensors; phase 12 draws 4-9 GB a batch
    gc.collect()
    print(f"  device memory allocated at the start: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    launches, peaks = {}, {}

    def part(label, fn, *args):
        torch.cuda.reset_peak_memory_stats()
        out = fn(*args)
        peaks[label] = torch.cuda.max_memory_allocated() / 2 ** 30
        return out

    spec, cfg, kern = part("(a)", streamed_part, launches)
    part("(a')", binding_part, launches)
    with tempfile.TemporaryDirectory(prefix="phase12_ckpt_") as tmp:
        part("(b)", checkpoint_part, ww_specs, launches, tmp)
    part("(c)", streamed_sweep_part, spec, cfg, kern, launches)
    del kern
    print("  peak device memory allocated, GiB: " + ", ".join(
        f"{k} {v:.2f}" for k, v in peaks.items()), flush=True)
    for label, got in launches.items():
        print(f"  launches, {label}: " + ", ".join(
            f"{k} {v}" for k, v in sorted(got.items())), flush=True)
    totals = {}
    for got in launches.values():
        for k, v in got.items():
            totals[k] = totals.get(k, 0) + v
    for k in KERNELS:
        rows[k]["launches_phase12"] = int(totals.get(k, 0))
    for k in ("matvec", "vecmat", "fused_round", "matvec_runs",
              "vecmat_runs"):
        check(totals.get(k, 0) > 0, f"phase 12: {k} never launched")
    record = engine_speed.streamed_record(50, reps=1, device="cuda")
    print("  engine_speed.streamed_record (quickstart, 50 iterations, not "
          f"gated): {json.dumps(record['streamed'])}", flush=True)
    print(f"phase 12 (streams, chunked runs and checkpoints): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return dataclasses.replace(spec, schedule=None, scheduler=cfg)


# ---------------------------------------------------------------------------
# phase 13: the async federation runtime
# ---------------------------------------------------------------------------

ASYNC_CKPT_EVERY = 40
ASYNC_KILL_AT = 80
CHAOS_ITERATIONS = 60
# halved from 60 to pay for phase 19 (three refreshes; the script's
# time limit)
LIVE_ITERATIONS = 30
FED_ITERATIONS = 60
# the in-process TCP legs, run side by side, paced at PACE s an
# iteration until the respawned or late worker process is back and
# PACED_TAIL iterations more, then unpaced: up to 38 s for a process to
# come back on the card (34 s while the command-line legs started beside
# it, 19-25 s on faster hosts, PERF.md, section 6; those legs now
# start after (b), so that their processes are up before these: 22 s on
# the slowest host read)
KILL_ITERATIONS = 320
ELASTIC_ITERATIONS = 320
PACE = 0.12
PACED_TAIL = 20
# fault deadlines of seconds on the card (the defaults, but a quicker
# heartbeat and poll)
ASYNC_FAULT = dict(heartbeat_every=0.05, resend_every=0.2,
                   refresh_resend_every=0.2, death_timeout=10.0,
                   poll_interval=0.005, all_dead_timeout=60.0)


def timed_call(fn):
    """(result, seconds, kernel launches) of fn(), counts set to 0 just
    before it."""
    import torch
    from repro_torch.kernels import cut_eval as K

    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, dict(K.LAUNCHES)


def check_against_scan(label, got, want):
    """Phase 4's gate between an async run and a scan run of the same
    schedule: histories within rtol 1e-4, cut counts, sim_time and
    max_staleness exact, final II-layer cut rows, gamma_k and level-2
    inner state within STATE_RTOL of each tensor's largest entry."""
    keys = [k for k in ("gap_sq", "mse_clean", "mse_noisy")
            if k in want.history]
    compare_routes(label, got.history, want.history, keys, 1e-4)
    for k in ("t", "sim_time", "max_staleness"):
        check(np.array_equal(np.asarray(got.history[k], np.float64),
                             np.asarray(want.history[k], np.float64)),
              f"{label} {k} differs")
    diffs = final_state_diffs(got.state, want.state)
    print(f"  {label} final state (max |diff| / max |entry|): "
          + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items()),
          flush=True)
    for k, v in diffs.items():
        check(v <= STATE_RTOL, f"{label} final {k}: {v:.2e} of the "
              f"largest entry > {STATE_RTOL}")


def check_async_bitwise(label, got, want):
    """`got` equals `want` bit for bit: every state leaf and every
    history row but host_time, and the arrivals."""
    diffs = bitwise_diffs(got, want)
    check(not diffs, f"{label}: differs in {diffs[:6]}")
    check(np.array_equal(got.arrivals.active, want.arrivals.active),
          f"{label}: arrivals differ")
    print(f"  {label}: bitwise equal (final state, "
          f"{len(got.history['gap_sq'])} history rows, arrivals)",
          flush=True)


def async_replay_part(ww_specs, ww_ms, launches):
    """(a) phase 4's schedule replayed through the runtime on the
    cut-kernel and the fused route; returns the kernel route's result."""
    from repro_torch.core import RunSpec, StragglerScheduler, run

    out = {}
    for name in ("kernel", "fused"):
        spec = ww_specs[name]
        schedule = StragglerScheduler(spec.scheduler).precompute(
            N_ITERATIONS)
        aspec = dataclasses.replace(spec, engine="async", scheduler=None,
                                    schedule=schedule)
        # worker threads, their cuBLAS handles and the route's first use
        timed_call(lambda: run(dataclasses.replace(
            aspec, schedule=schedule.slice(0, 5))))
        res, secs, got = timed_call(lambda: run(aspec))
        ms = secs / N_ITERATIONS * 1e3
        print(f"  (a) white wine replayed through the runtime, {name} "
              f"route, 6 worker threads: {ms:.3f} ms per master iteration "
              f"(phase 4's scan: {ww_ms[name]:.3f})", flush=True)
        check_against_scan(f"(a) async {name} vs phase 4 scan", res,
                           PHASE4[name])
        check(np.array_equal(res.arrivals.active, schedule.active),
              f"(a) {name}: the replay did not keep the schedule")
        launches[f"(a) replay, {name}"] = got
        out[name] = (res, schedule, aspec, ms)
    for k in ("matvec", "vecmat"):
        check(launches["(a) replay, kernel"].get(k, 0) > 0,
              f"(a) {k} never launched on the async kernel route")
    check(launches["(a) replay, fused"].get("fused_round", 0) > 0,
          "(a) fused_round never launched on the async fused route")
    return out


def async_live_part(replayed, launches):
    """(b) a free white-wine run on the kernel route; its recorded
    schedule through the runtime (bit for bit) and run_scanned (phase
    4's gate)."""
    from repro_torch.core import run, run_scanned

    _, _, aspec, _ = replayed["kernel"]
    live_spec = dataclasses.replace(aspec, schedule=None,
                                    n_iterations=LIVE_ITERATIONS)
    live, secs, got = timed_call(lambda: run(live_spec))
    rec = live.arrivals
    stale = int(rec.max_staleness.max())
    counts = rec.active.sum(1)
    print(f"  (b) live white-wine run, {LIVE_ITERATIONS} iterations: "
          f"{secs / LIVE_ITERATIONS * 1e3:.3f} ms "
          f"per master iteration, max recorded staleness {stale} (tau "
          f"{aspec.hyper.tau}), workers per iteration min "
          f"{int(counts.min())} mean {counts.mean():.2f} max "
          f"{int(counts.max())}", flush=True)
    check(stale <= aspec.hyper.tau, "(b) recorded staleness beyond tau")
    launches["(b) live"] = got
    echo, _, got = timed_call(lambda: run(dataclasses.replace(
        live_spec, schedule=rec)))
    launches["(b) echo"] = got
    check_async_bitwise("(b) live run vs its replay through the runtime",
                        echo, live)
    scan = run_scanned(aspec.problem, aspec.hyper, rec,
                       metrics_fn=aspec.metrics_fn,
                       metrics_every=aspec.metrics_every)
    check_against_scan("(b) live run vs run_scanned of its schedule",
                       live, scan)


def async_resume_part(replayed, launches, tmp):
    """(c) (a)'s kernel route checkpointed every 40 iterations, stopped
    after 80 and resumed by a fresh master: bit for bit the
    uninterrupted run."""
    from repro_torch.fed.runtime import run_async

    full, schedule, aspec, _ = replayed["kernel"]
    kw = dict(metrics_fn=aspec.metrics_fn, metrics_every=aspec.metrics_every,
              ckpt_dir=str(Path(tmp) / "async"), device="cuda")
    _, s1, got1 = timed_call(lambda: run_async(
        aspec.problem, aspec.hyper,
        replay=schedule.slice(0, ASYNC_KILL_AT),
        ckpt_every=ASYNC_CKPT_EVERY, **kw))
    saved = sorted(p.name for p in Path(kw["ckpt_dir"]).iterdir())
    check(saved[-1] == f"step_{ASYNC_KILL_AT:08d}",
          f"(c) checkpoints {saved}")
    resumed, s2, got2 = timed_call(lambda: run_async(
        aspec.problem, aspec.hyper, replay=schedule, resume=True, **kw))
    check_async_bitwise(f"(c) stopped after {ASYNC_KILL_AT} and resumed "
                        "vs uninterrupted", resumed, full)
    print(f"  (c) checkpoints {saved}; first master {s1:.2f} s, resumed "
          f"master {s2:.2f} s", flush=True)
    launches["(c) kill and resume"] = {k: got1.get(k, 0) + got2.get(k, 0)
                                      for k in set(got1) | set(got2)}


def async_chaos_part(replayed, launches):
    """(d) white wine under a seeded chaos script (lossy frames, worker 1
    crashing at its 5th push and rejoining): completes, and its degraded
    schedule replays through the runtime bit for bit."""
    from repro_torch.fed.runtime import (ChaosScript, FaultConfig,
                                         run_async, run_chaos_async)

    _, _, aspec, _ = replayed["kernel"]
    script = ChaosScript(seed=5, drop_p=0.05, dup_p=0.05, delay_p=0.05,
                         delay_s=0.002, cut_p=0.03,
                         crash_at_push=((1, 5),))
    fault = FaultConfig(**ASYNC_FAULT)
    seen = {}
    res, secs, got = timed_call(lambda: run_chaos_async(
        aspec.problem, aspec.hyper, script, n_iterations=CHAOS_ITERATIONS,
        fault=fault, restart_delay=0.3, metrics_every=10,
        master_hook=lambda m: seen.update(m=m), device="cuda"))
    status = seen["m"].status
    rec = res.arrivals
    print(f"  (d) chaos white wine, {CHAOS_ITERATIONS} iterations: "
          f"{secs:.2f} s, deaths {status['deaths']}, rejoins "
          f"{status['rejoins']}, corrupt frames {status['corrupt_frames']},"
          f" iterations with worker 1 dead {int(rec.dead[:, 1].sum())}, "
          f"max staleness {int(rec.max_staleness.max())}", flush=True)
    check(status["deaths"] >= 1 and status["rejoins"] >= 1,
          "(d) the scripted crash did not die and rejoin")
    check(int(rec.max_staleness.max()) <= aspec.hyper.tau,
          "(d) recorded staleness beyond tau")
    launches["(d) chaos"] = got
    echo, _, got = timed_call(lambda: run_async(
        aspec.problem, aspec.hyper, replay=rec, metrics_every=10,
        device="cuda"))
    check_async_bitwise("(d) chaos run vs its replay through the runtime",
                        echo, res)
    launches["(d) chaos echo"] = got


def fed_args(**kw):
    """`serve fed`'s parsed arguments on the card, with `kw` changed."""
    from repro_torch.launch.serve import fed_parser

    args = fed_parser().parse_args(["--transport", "tcp", "--workers", "4",
                                    "--iters", str(FED_ITERATIONS),
                                    "--accept-timeout", "300"])
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def start_serve_fed_cli(extra, log_path):
    """Start `python -m repro_torch.launch.serve fed --transport tcp
    --workers 4 --iters 60` plus `extra`, worker subprocesses on the
    card, its output into `log_path`: (process, start time)."""
    from repro_torch.launch.serve import worker_env

    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "fed",
           "--transport", "tcp", "--workers", "4", "--iters",
           str(FED_ITERATIONS), "--accept-timeout", "300", *extra]
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, env=worker_env(), stdout=log,
                                stderr=subprocess.STDOUT)
    return proc, time.perf_counter()


def finish_serve_fed_cli(label, extra, proc, t0, log_path, times):
    """Wait for a `serve fed` CLI run (at most 600 s), print its tail and
    fail unless it exited 0 (and, streamed, passed its replay gate)."""
    try:
        rc = proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    secs = time.perf_counter() - t0
    out = Path(log_path).read_text()
    tail = [ln for ln in out.splitlines() if not ln.startswith("{")]
    print(f"  (e) serve fed --transport tcp --workers 4 --iters "
          f"{FED_ITERATIONS} {' '.join(extra)}: exit {rc}, {secs:.1f} s; "
          + " | ".join(tail[-3:]), flush=True)
    check(rc == 0, f"(e) serve fed {label} exited {rc}:\n{out[-3000:]}")
    if extra:
        check("streamed replay gate" in out and "(ok)" in out,
              "(e) the streamed replay gate did not pass")
    times[f"serve fed {label}"] = secs


def tcp_run(args, watcher, fault_kw):
    """A TCP `serve fed` run in this process with `watcher(master, procs)`
    on a thread beside the master: (result, seconds, marks)."""
    import threading

    from repro_torch.fed.runtime import FaultConfig, TcpTransport, problems
    from repro_torch.fed.runtime import run_async
    from repro_torch.launch.serve import spawn_tcp_workers

    problem, hyper = problems.build(args.problem, n_workers=args.workers,
                                    dim=args.dim, seed=args.seed,
                                    device="cuda")
    elastic = (problems.elastic_config(args.problem, args.max_workers,
                                       dim=args.dim, seed=args.seed,
                                       device="cuda")
               if args.max_workers > args.workers else None)
    transport = TcpTransport(args.workers, port=0,
                             max_workers=max(args.max_workers, args.workers))
    transport.master_endpoint()
    procs = spawn_tcp_workers(args, transport.port)
    marks = {"killed": []}

    def hook(master):
        threading.Thread(target=watcher,
                         args=(master, procs, transport.port, marks),
                         daemon=True).start()

    t0 = time.perf_counter()
    try:
        res = run_async(problem, hyper, n_iterations=args.iters,
                        metrics_every=args.metrics_every,
                        transport=transport, master_hook=hook,
                        fault=FaultConfig(**fault_kw), elastic=elastic,
                        accept_timeout=300.0, device="cuda")
    finally:
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    check(all(p.returncode == 0 for p in procs if p not in marks["killed"]),
          f"worker processes exited {[p.returncode for p in procs]}")
    return res, time.perf_counter() - t0, marks


def wait_for(master, cond, timeout=120.0):
    t0 = time.monotonic()
    while not cond() and not master.status["done"]:
        if time.monotonic() - t0 > timeout:
            return False
        time.sleep(0.02)
    return cond()


def unpace(master, marks, since):
    """Drop the master's pacing PACED_TAIL iterations after `since`."""
    wait_for(master, lambda: master.status["t"] >= since + PACED_TAIL)
    marks["unpaced_at"] = master.status["t"]
    master.fault = dataclasses.replace(master.fault, min_iter_time=0.0)


def fed_kill_leg(times):
    """Worker 0 SIGKILLed mid-run and respawned with --epoch 1."""
    from repro_torch.core import run_scanned
    from repro_torch.fed.runtime import problems
    from repro_torch.launch.serve import worker_command, worker_env

    # paced long enough for the respawned process (torch, CUDA, one
    # warm-up gradient) to come back while the command-line legs start
    # beside it
    args = fed_args(iters=KILL_ITERATIONS)

    def watcher(master, procs, port, marks):
        st = master.status
        wait_for(master, lambda: st["t"] >= 5)
        marks["killed_at"], deaths = st["t"], st["deaths"]
        marks["killed"].append(procs[0])
        procs[0].kill()
        marks["died"] = wait_for(master, lambda: st["deaths"] > deaths)
        marks["death_at"], rejoins = st["t"], st["rejoins"]
        procs.append(subprocess.Popen(
            worker_command(args, port, 0, epoch=1), env=worker_env()))
        # the respawned session announces epoch 1
        marks["rejoined"] = wait_for(
            master, lambda: st["rejoins"] > rejoins
            and st["workers"][0]["epoch"] >= 1)
        marks["rejoin_at"] = st["t"]
        marks["status"] = st
        unpace(master, marks, marks["rejoin_at"])

    res, secs, marks = tcp_run(args, watcher, dict(
        ASYNC_FAULT, min_iter_time=PACE))
    rec = res.arrivals
    check(marks.get("died") and marks.get("rejoined")
          and float(rec.dead[:, 0].max()) == 1.0,
          f"(e) the killed worker did not die and rejoin: {marks}")
    check(int(rec.max_staleness.max()) <= 5, "(e) staleness beyond tau")
    problem, hyper = problems.build("quadratic", n_workers=4, device="cuda")
    echo = run_scanned(problem, hyper, rec, metrics_every=10)
    rel = float(np.max(np.abs(res.history["gap_sq"] - echo.history["gap_sq"])
                       / np.abs(echo.history["gap_sq"])))
    check(rel <= 1e-5, f"(e) killed run's schedule replays at {rel:.2e}")
    times["tcp, worker 0 killed and respawned"] = secs
    dead = np.nonzero(rec.dead[:, 0] > 0)[0]
    st = marks["status"]
    print(f"  (e) tcp, worker 0 SIGKILLed at iteration "
          f"{marks['killed_at']} and respawned with --epoch 1: death seen "
          f"at {marks['death_at']}, its epoch-1 session back at "
          f"{marks['rejoin_at']}; "
          f"deaths {st['deaths']}, rejoins {st['rejoins']}, recorded dead "
          f"in {dead.size} iterations ({int(dead[0]) + 1}-"
          f"{int(dead[-1]) + 1}), unpaced at {marks.get('unpaced_at')} of "
          f"{KILL_ITERATIONS}; replay through run_scanned {rel:.2e}; "
          f"{secs:.1f} s", flush=True)


def fed_elastic_leg(times):
    """`--max-workers 5` with a late worker 4: the widening schedule
    replays bit for bit through run_scanned_elastic."""
    from repro_torch.fed.runtime import problems
    from repro_torch.fed.runtime.membership import run_scanned_elastic
    from repro_torch.launch.serve import worker_command, worker_env

    args = fed_args(iters=ELASTIC_ITERATIONS, max_workers=5)

    def watcher(master, procs, port, marks):
        wait_for(master, lambda: master.status["t"] >= 5)
        marks["started_at"] = master.status["t"]
        procs.append(subprocess.Popen(
            worker_command(args, port, 4), env=worker_env()))
        marks["admitted"] = wait_for(master,
                                     lambda: master.hyper.n_workers >= 5)
        marks["admitted_at"] = master.status["t"]
        unpace(master, marks, marks["admitted_at"])

    res, secs, marks = tcp_run(args, watcher, dict(
        ASYNC_FAULT, min_iter_time=PACE))
    rec = res.arrivals
    check(rec.width is not None and int(rec.width[0]) == 4
          and int(rec.width[-1]) == 5,
          f"(e) the late worker did not widen the run mid-way: {marks}")
    check(float(rec.active[:, 4].sum()) > 0,
          "(e) the admitted worker never arrived")
    echo = run_scanned_elastic(
        lambda n: problems.build("quadratic", n_workers=n, device="cuda"),
        rec, metrics_every=args.metrics_every)
    diffs = bitwise_diffs(echo, dataclasses.replace(
        res, history={k: v for k, v in res.history.items()
                      if k in echo.history}))
    check(not diffs, f"(e) widened run vs run_scanned_elastic: {diffs[:6]}")
    times["tcp, --max-workers 5, late worker"] = secs
    print(f"  (e) tcp --max-workers 5: worker 4 started at iteration "
          f"{marks.get('started_at')}, admitted at "
          f"{marks.get('admitted_at')} (width column {int(rec.width[0])} -> "
          f"{int(rec.width[-1])}), unpaced at {marks.get('unpaced_at')} of "
          f"{ELASTIC_ITERATIONS}, bitwise equal to run_scanned_elastic; "
          f"{secs:.1f} s", flush=True)


CLI_LEGS = {"tcp": [], "tcp --stream": ["--stream"]}


def start_cli_legs(tmp):
    """Start (e)'s two `serve fed` command-line runs: {label: (process,
    start time)}."""
    return {label: start_serve_fed_cli(extra, Path(tmp) / f"{i}.log")
            for i, (label, extra) in enumerate(CLI_LEGS.items())}


def serve_fed_part(times, tmp, started):
    """(e) `serve fed` over TCP with worker subprocesses on the card: the
    two command-line runs (`started` by `start_cli_legs`) go on beside
    the two in-process legs, which go on side by side, each on its own
    thread (a failed check there ends the script when its result is
    read)."""
    from concurrent.futures import ThreadPoolExecutor

    legs = CLI_LEGS
    try:
        with ThreadPoolExecutor(2) as pool:
            done = [pool.submit(leg, times)
                    for leg in (fed_kill_leg, fed_elastic_leg)]
        for d in done:
            d.result()
        for i, (label, extra) in enumerate(legs.items()):
            finish_serve_fed_cli(label, extra, *started[label],
                                 Path(tmp) / f"{i}.log", times)
    finally:
        # a failed leg leaves no serve process behind (each dismisses
        # its own workers when it ends)
        for proc, _ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def push_frame_bytes(aspec):
    """Bytes of one white-wine push frame and one refresh frame."""
    from repro_torch.core import afto
    from repro_torch.fed.runtime import messages as msg_lib
    from repro_torch.utils.tree import tree_index

    st = afto.init_state(aspec.problem, aspec.hyper)
    rows = tuple(tree_index(x, 0) for x in (st.X1, st.X2, st.X3))
    return (len(msg_lib.encode(msg_lib.push(0, 1, rows))),
            len(msg_lib.encode(msg_lib.refresh(0, 1, rows))))


def async_phase(rows, ww_specs, ww_ms):
    """Phase 13: returns the async spec to profile."""
    import tempfile

    t0 = time.perf_counter()
    launches, times, parts = {}, {}, []

    def part(label, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        parts.append(f"{label} {time.perf_counter() - t:.1f} s")
        return out

    replayed = part("(a)", async_replay_part, ww_specs, ww_ms, launches)
    part("(b)", async_live_part, replayed, launches)
    with tempfile.TemporaryDirectory(prefix="phase13_fed_") as fed_tmp:
        # (e)'s command-line runs start here, beside (c) and (d) (whose
        # times are not compared), so that their worker processes are up
        # before (e)'s in-process legs start theirs
        cli = start_cli_legs(fed_tmp)
        try:
            with tempfile.TemporaryDirectory(prefix="phase13_ckpt_") as tmp:
                part("(c)", async_resume_part, replayed, launches, tmp)
            part("(d)", async_chaos_part, replayed, launches)
        except BaseException:
            for proc, _ in cli.values():
                proc.kill()
                proc.wait()
            raise
        part("(e)", serve_fed_part, times, fed_tmp, cli)
    for label, got in launches.items():
        print(f"  launches, {label}: " + ", ".join(
            f"{k} {v}" for k, v in sorted(got.items())), flush=True)
    totals = {}
    for got in launches.values():
        for k, v in got.items():
            totals[k] = totals.get(k, 0) + v
    for k in KERNELS:
        rows[k]["launches_phase13"] = int(totals.get(k, 0))
    for k in ("matvec", "vecmat", "fused_round"):
        check(totals.get(k, 0) > 0, f"phase 13: {k} never launched")
    aspec = replayed["kernel"][2]
    push_b, refresh_b = push_frame_bytes(aspec)
    print(f"  white-wine frames: push {push_b} bytes, refresh {refresh_b} "
          "bytes", flush=True)
    print("  ms per master iteration: " + ", ".join(
        f"async {k} {v[3]:.3f}" for k, v in replayed.items())
        + "; TCP legs, s: " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in times.items()))
    print(f"phase 13 (the async federation runtime): "
          f"{time.perf_counter() - t0:.1f} s (" + ", ".join(parts) + ")",
          flush=True)
    return dataclasses.replace(aspec, schedule=aspec.schedule.slice(0, 20))


# ---------------------------------------------------------------------------
# phase 14: the worker mesh
# ---------------------------------------------------------------------------

# one job of MESH_RANKS gloo ranks on the card; a narrower mesh is the
# job's first ranks (`make_worker_mesh`), the NCCL mesh its first rank
MESH_RANKS = 4
MESH_TIMEOUT = 300.0
# one refresh (t_pre = 10) on each mesh before its timed legs
MESH_WARMUP = 12
MESH_PROFILE_ITERATIONS = 30
# tests/test_sharded_engine.py:40-56
MESH_STATE_TOL = dict(rtol=5e-5, atol=1e-6)
MESH_HIST_TOL = dict(rtol=5e-4, atol=1e-6)


def host_result(res):
    """A run's result with its state on the host (to cross processes)."""
    import torch.utils._pytree as pytree
    return dataclasses.replace(
        res, state=pytree.tree_map(lambda x: x.cpu(), res.state))


def digest(res) -> str:
    """sha256 of a result's state leaves and history (host_time aside)."""
    import hashlib

    import torch
    from repro_torch.utils.tree import tree_flatten

    h = hashlib.sha256()
    for x in tree_flatten(res.state)[0]:
        h.update(x.detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes())
    for k in sorted(res.history):
        if k != "host_time":
            h.update(k.encode())
            h.update(np.ascontiguousarray(res.history[k]).tobytes())
    return h.hexdigest()


def aligned_diffs(got, want, t_offset=0):
    """Names of the state leaves, and of the history keys at the
    iterations both record (`got`'s t shifted by `t_offset`), that differ
    in any bit (host_time aside)."""
    import torch
    from repro_torch.utils.tree import tree_flatten

    out = [f"state leaf {i}" for i, (x, y) in enumerate(zip(
        tree_flatten(got.state)[0], tree_flatten(want.state)[0]))
        if not (x.dtype == y.dtype and torch.equal(x, y))]
    t_got = np.asarray(got.history["t"]) + t_offset
    t_want = np.asarray(want.history["t"])
    mine, theirs = np.isin(t_got, t_want), np.isin(t_want, t_got)
    if not theirs.any():
        out.append("no common history rows")
    for k, v in got.history.items():
        if k not in ("t", "host_time") and not np.array_equal(
                np.asarray(v)[mine], np.asarray(want.history[k])[theirs]):
            out.append(f"history {k}")
    return out


def mesh_rank(world):
    """Phase 14 on one rank of the MESH_RANKS-rank gloo job sharing the
    card: the legs on the meshes of its first 2, 3 and 4 ranks (gloo) and
    of its first rank (NCCL), each timed on every member: {"started",
    "ready": wall-clock times on entry and with the problems built,
    "legs": {leg: record}}, with the results of rank 0."""
    started = time.time()
    import tempfile

    import torch
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.core import RunSpec, StragglerScheduler, afto, run
    from repro_torch.kernels import cut_eval as K
    from repro_torch.launch.mesh import make_worker_mesh

    task, hyper, cfg = white_wine()
    plain = dataclasses.replace(hyper, cut_impl="ref")
    schedule = StragglerScheduler(cfg).precompute(N_ITERATIONS)
    spec = RunSpec(problem=task.problem, hyper=plain, schedule=schedule,
                   metrics_every=10, engine="scan", device="cuda")
    sweep = dataclasses.replace(spec, engine="sweep", schedule=None,
                                scheduler=cfg, n_iterations=N_ITERATIONS,
                                seeds=(0, 1))
    qprob, qhyper, qcfg, qstream = quadratic_stream_setup(BIND_DIM,
                                                          b_unit=True)
    qspec = RunSpec(problem=qprob, hyper=qhyper, schedule=StragglerScheduler(
        qcfg).precompute(STREAM_ITERATIONS), metrics_every=5, data=qstream,
        engine="scan", device="cuda")
    ready = time.time()
    out = {}

    def leg(label, mesh, fn):
        if not mesh.member:
            return None
        torch.cuda.synchronize()
        K.reset_launches()
        mesh.reset_traffic()
        t0 = time.perf_counter()
        res = fn(mesh)
        torch.cuda.synchronize()
        out[label] = dict(
            seconds=time.perf_counter() - t0, width=mesh.size,
            backend=mesh.backend, traffic=dict(mesh.traffic),
            calls=dict(mesh.calls), reduce_s=dict(mesh.seconds),
            launches=dict(K.LAUNCHES), digest=digest(res),
            result=host_result(res) if mesh.rank == 0 else None)
        return res

    def warm(mesh, s):
        if mesh.member:
            run(dataclasses.replace(
                s, schedule=s.schedule.slice(0, MESH_WARMUP), mesh=mesh))

    mesh2 = make_worker_mesh(2, backend="gloo", device="cuda")
    warm(mesh2, spec)
    full = leg("(a) white wine, 2 ranks", mesh2,
               lambda m: run(dataclasses.replace(spec, mesh=m)))
    if mesh2.member:
        with tempfile.TemporaryDirectory(prefix="phase14_ckpt_") as tmp:
            def hook(state, _t):
                save_checkpoint(tmp, state, int(state.t), keep=4)

            chunked = leg("(e) chunks", mesh2, lambda m: run_in_chunks(
                dataclasses.replace(spec, mesh=m), schedule, WW_CHUNKS,
                hook)[0])
            start = load_checkpoint(tmp, afto.init_state(task.problem, plain),
                                    step=WW_RESUME)
        resumed = leg("(e) resumed", mesh2, lambda m: run(dataclasses.replace(
            spec, schedule=schedule.slice(WW_RESUME, N_ITERATIONS),
            state=start, mesh=m)))
        out["(e) chunks"]["diffs"] = aligned_diffs(chunked, full)
        out["(e) resumed"]["diffs"] = aligned_diffs(resumed, full,
                                                    WW_RESUME)
    leg("(d) white-wine sweep of 2, 2 ranks", mesh2,
        lambda m: run(dataclasses.replace(sweep, mesh=m)))
    leg("(c) streamed quadratic, 2 ranks", mesh2,
        lambda m: run(dataclasses.replace(qspec, mesh=m)))
    if mesh2.member:
        mesh2.profile = True
        leg("(f) white wine, 2 ranks, collectives timed", mesh2,
            lambda m: run(dataclasses.replace(
                spec, schedule=schedule.slice(0, MESH_PROFILE_ITERATIONS),
                mesh=m)))
        mesh2.profile = False

    mesh3 = make_worker_mesh(3, backend="gloo", device="cuda")
    warm(mesh3, spec)
    leg("(a) white wine, 3 ranks", mesh3,
        lambda m: run(dataclasses.replace(spec, mesh=m)))
    warm(world, qspec)
    leg("(c) streamed quadratic, 4 ranks", world,
        lambda m: run(dataclasses.replace(qspec, mesh=m)))
    mesh1 = make_worker_mesh(1, backend="nccl", device="cuda")
    warm(mesh1, spec)
    leg("(b) white wine, 1-rank NCCL", mesh1,
        lambda m: run(dataclasses.replace(spec, mesh=m)))
    return {"started": started, "ready": ready, "legs": out}


def expected_traffic(hyper, spec, segments, metrics_every, runs=1):
    """{label: bytes} that `core.sharded.traffic_record` predicts for a
    run over the iteration `segments` ([a, b) each, one call each)."""
    from repro_torch.core.engine import record_slots, refresh_due
    from repro_torch.core.sharded import traffic_record

    rec = traffic_record(spec, hyper)
    out = {"step": 0, "refresh": 0, "gap": 0, "gap_aux": 0}
    for a, b in segments:
        its, _ = record_slots(b - a, metrics_every)
        due = {t for t in range(a + 1, b + 1) if refresh_due(hyper, t)}
        out["step"] += (b - a) * rec["step_bytes"]
        out["refresh"] += len(due) * rec["refresh_bytes"]
        out["gap"] += len(its) * rec["gap_bytes"]
        out["gap_aux"] += sum(a + int(i) + 1 in due for i in its) \
            * rec["gap_aux_bytes"]
    return {k: v * runs for k, v in out.items()}


def check_mesh_state(label, got, want):
    """Every state leaf of `got` within MESH_STATE_TOL of `want`'s."""
    from repro_torch.utils.tree import tree_flatten

    worst = (0.0, -1)
    ga, gb = tree_flatten(got)[0], tree_flatten(want)[0]
    check(len(ga) == len(gb), f"{label}: state layouts differ")
    for i, (x, y) in enumerate(zip(ga, gb)):
        x = x.detach().cpu().double().numpy()
        y = y.detach().cpu().double().numpy()
        excess = np.abs(x - y) / (MESH_STATE_TOL["atol"]
                                  + MESH_STATE_TOL["rtol"] * np.abs(y))
        worst = max(worst, (float(excess.max(initial=0.0)), i))
    print(f"  {label}: final state within {worst[0]:.3f} of the tolerance "
          f"(rtol {MESH_STATE_TOL['rtol']}, atol {MESH_STATE_TOL['atol']};"
          f" worst leaf {worst[1]})", flush=True)
    check(worst[0] <= 1.0, f"{label}: state leaf {worst[1]} beyond "
          f"the tolerance ({worst[0]:.3f})")


def check_mesh_history(label, h, hr):
    rel = float(np.max(np.abs(h["gap_sq"] - hr["gap_sq"])
                       / np.abs(hr["gap_sq"])))
    print(f"  {label} gap_sq: max rel diff {rel:.3e}", flush=True)
    check(bool(np.allclose(h["gap_sq"], hr["gap_sq"], **MESH_HIST_TOL)),
          f"{label}: gap_sq beyond rtol {MESH_HIST_TOL['rtol']}")
    for k in ("t", "n_cuts_i", "n_cuts_ii", "sim_time", "max_staleness"):
        check(np.array_equal(np.asarray(h[k], np.float64),
                             np.asarray(hr[k], np.float64)),
              f"{label}: {k} differs")


def mesh_phase(rows, ww_ms, ww_specs):
    """Phase 14: the worker-mesh sharded engine on the card."""
    from repro_torch.launch.mesh import spawn_mesh

    t0, wall0 = time.perf_counter(), time.time()
    ranks = spawn_mesh("chip_smoke:mesh_rank", MESH_RANKS, backend="gloo",
                       device="cuda", pythonpath=[str(ROOT)],
                       timeout=MESH_TIMEOUT)
    started = max(r["started"] for r in ranks) - wall0
    ready = max(r["ready"] for r in ranks) - wall0
    out = [r["legs"] for r in ranks]
    legs = out[0]
    want = PHASE4["plain"]
    ww_spec = want.state.cuts_ii.spec
    hyper = ww_specs["plain"].hyper
    q, qhyper = PHASE12["(a') plain"]
    totals = {}
    for label, rec in legs.items():
        members = [o[label] for o in out if label in o]
        check(len(members) == rec["width"],
              f"{label}: {len(members)} records for {rec['width']} shards")
        check(all(m["digest"] == rec["digest"] for m in members),
              f"{label}: the shards' results differ")
        for k, v in rec["launches"].items():
            totals[k] = totals.get(k, 0) + v
        ms = rec["seconds"] * 1e3
        res = rec["result"]
        if label.startswith("(a)") or label.startswith("(b)"):
            check_mesh_history(f"(a/b) {label} vs phase 4 plain",
                               res.history, want.history)
            check_mesh_state(f"(a/b) {label} vs phase 4 plain", res.state,
                             want.state)
            segments, runs, me = [(0, N_ITERATIONS)], 1, 10
            ms /= N_ITERATIONS
        elif label.startswith("(c)"):
            check_mesh_history(f"{label} vs phase 12 (a') plain",
                               res.history, q.history)
            check_mesh_state(f"{label} vs phase 12 (a') plain", res.state,
                             q.state)
            print_multipliers(label, res.state)
            check(float(res.state.gamma_k.max()) > 0,
                  f"{label}: no level-2 cut binds")
            segments, runs, me = [(0, STREAM_ITERATIONS)], 1, 5
            ms /= STREAM_ITERATIONS
        elif label.startswith("(d)"):
            for r, ref in enumerate((PHASE4["fused"],
                                     PHASE11["fused seed 1"])):
                row = res.run(r)
                check_mesh_history(f"{label} row {r} vs phase 11 serial",
                                   row.history, ref.history)
                check_mesh_state(f"{label} row {r} vs phase 11 serial",
                                 row.state, ref.state)
            segments, runs, me = [(0, N_ITERATIONS)], 2, 10
            ms /= N_ITERATIONS
        elif label == "(e) chunks":
            check(not rec["diffs"], f"{label}: differs from (a) in "
                  f"{rec['diffs'][:6]}")
            segments, runs, me = list(zip(WW_CHUNKS[:-1], WW_CHUNKS[1:])), \
                1, 10
            ms /= N_ITERATIONS
        elif label == "(e) resumed":
            check(not rec["diffs"], f"{label}: differs from (a) in "
                  f"{rec['diffs'][:6]}")
            segments, runs, me = [(WW_RESUME, N_ITERATIONS)], 1, 10
            ms /= N_ITERATIONS - WW_RESUME
        else:
            segments, runs, me = [(0, MESH_PROFILE_ITERATIONS)], 1, 10
            ms /= MESH_PROFILE_ITERATIONS
        hy, spec = (qhyper, q.state.cuts_ii.spec) if label.startswith(
            "(c)") else (hyper, ww_spec)
        expect = expected_traffic(hy, spec, segments, me, runs)
        for m in members:
            got = {k: m["traffic"].get(k, 0) for k in expect}
            check(got == expect, f"{label}: all-reduced bytes {got} != "
                  f"traffic_record's {expect}")
        extra = ""
        if rec["reduce_s"]:
            spent = sum(rec["reduce_s"].values())
            extra = (f"; {sum(rec['calls'].get(k, 0) for k in expect)} "
                     f"all-reduces, {spent / rec['seconds']:.1%} of the "
                     "wall time in them (device synchronised first): "
                     + ", ".join(f"{k} {v * 1e3:.1f} ms"
                                 for k, v in rec["reduce_s"].items()))
        if "diffs" in rec:
            extra += "; bitwise equal to (a)"
        print(f"  {label}: {ms:.3f} ms per master iteration (phase 4's "
              f"unsharded plain scan: {ww_ms['plain']:.3f}); bytes per "
              f"shard {dict(sorted(rec['traffic'].items()))} = "
              f"traffic_record's; shards bitwise equal{extra}; launches "
              + (", ".join(f"{k} {v}" for k, v in sorted(
                  rec["launches"].items())) or "none"), flush=True)
    check(sum(totals.values()) == 0,
          f"phase 14 launched the port's kernels: {totals} (the sharded "
          "path contracts the cut matrix with plain products)")
    for k in KERNELS:
        rows[k]["launches_phase14"] = int(totals.get(k, 0))
    print(f"phase 14 (the worker mesh, {MESH_RANKS} gloo ranks on the card, "
          f"every rank in its job {started:.1f} s and its problems built "
          f"{ready:.1f} s after the spawn): {time.perf_counter() - t0:.1f} s",
          flush=True)


# ---------------------------------------------------------------------------
# phase 16: the LLM training path
# ---------------------------------------------------------------------------

TRAIN_ITERATIONS, TRAIN_T_PRE, TRAIN_CHUNK = 20, 10, 10
# 16 (a)'s eager run stops at the first refresh (iteration 10, held to
# the chunked run's state there); the streamed run takes 4 iterations
# with a refresh every 2 and a checkpoint (and a logged row) every 2, so
# the checkpoint holds refreshed cuts, and the run resumed from it
# crosses the refresh at 4 (the script's time limit)
TRAIN_SHORT = 10
TRAIN_STREAM, TRAIN_STREAM_T_PRE, TRAIN_STREAM_CKPT = 4, 2, 2
# at the driver's lr (3e-3) plain SGD on xLSTM-125M's gate weights
# (gradients up to 3.4e3 in the first steps) drives an mLSTM stabiliser
# below -88.7 by the third step at full width: the normaliser's
# exp(-m) overflows and its backward gives NaN, the reference's math
# (ROADMAP.md Queue 3 item 17); so the phase takes 1e-5
TRAIN_LR = 1e-5
# card against CPU (16 (c)): each stage (a step, the refresh) run on the
# card from the CPU's state before it, every leaf's max |card - CPU| /
# max |CPU| within its limit: the five cut blocks derived through the
# bf16 perturbation (cuts/b2, cuts/b3, cuts_i/a2) or equal to one
# rollout step's move, a difference of nearly equal numbers (cuts_i/a3 =
# 2 (z3 - z3_k), cuts_i/b3 = 2 (X3 - X3_k)), each within its own limit,
# every other leaf within "rest" (ROADMAP.md Queue 3 items 16 and 17,
# tests/test_torch_trilevel_llm.py).  Each limit is about three times
# the stage's reading on an NVIDIA H100 80GB HBM3 (in brackets), and a
# fault reads far beyond it: dropping the second-order terms moves
# cuts/b3 and cuts_i/a2 by 1.0
CARD_CPU_TOL = {
    # [2.3e-4 - 4.7e-4, 1.7e-5, 2.0e-4 - 2.4e-4, 9.0e-8, 3.0e-4;
    #  7.7e-5 - 8.2e-5]
    "llama3-8b": {"cuts/b2": 1e-3, "cuts/b3": 1e-4, "cuts_i/a2": 1e-3,
                  "cuts_i/a3": 1e-4, "cuts_i/b3": 1e-3, "rest": 1e-4},
    # [2.5e-3, 2.7e-3, 3.9e-3, 9.0e-8, 5.3e-4; 8.7e-4 - 1.3e-3]
    "xlstm-125m": {"cuts/b2": 1e-2, "cuts/b3": 1e-2, "cuts_i/a2": 1e-2,
                   "cuts_i/a3": 1e-4, "cuts_i/b3": 2e-3, "rest": 3e-3},
}
# ... and the card's own 4-iteration trajectory against the CPU's: its
# worst leaf within TRAJECTORY_TOL, about twice the reading (llama3-8b
# 2.3e-4 - 4.7e-4, reduced xLSTM 1.4e-1 on a zero-initialised norm
# scale), and
# within TRAJECTORY_OVER_ULP x the worst leaf of the witness, the card's
# trajectory from weights one ulp up against its own (4.7e-4 and 1.1e-1:
# one ulp in the starting weights moves the trajectory as far as the
# card's arithmetic does; ROADMAP.md Queue 3 item 17)
TRAJECTORY_TOL = {"llama3-8b": 1e-3, "xlstm-125m": 3e-1}
TRAJECTORY_OVER_ULP = 3.0
TRAIN_PHASE_S = 120.0


def train_args(*argv, **kw):
    """The training driver's namespace: its defaults, `argv`, then `kw`."""
    from repro_torch.launch import train

    args = train.parser().parse_args(list(argv))
    for k, v in kw.items():
        setattr(args, k, v)
    return args


class TrainMeter:
    """Wraps the training driver's step and refresh (the names it calls):
    the device synchronised around each, their ms, the kernels they
    launch (there must be none: they differentiate the plain math), and
    after each refresh the count of active cuts in both polytopes."""

    def __init__(self, profile_steps=(), keep_refresh=None):
        self.step_ms, self.refresh_ms, self.launches = [], [], 0
        self.cuts_after_refresh = []
        # the state after the refresh of this count (from 0), kept
        self.keep_refresh, self.kept = keep_refresh, None
        # steps (by count, from 0) run under torch.profiler, with the
        # refresh that follows the last of them: (profiler, wall_us)
        self.profile_steps, self.profiled = tuple(profile_steps), None
        self._prof = None

    @contextlib.contextmanager
    def installed(self):
        import torch
        from repro_torch.kernels import cut_eval as K
        from repro_torch.launch import train

        step0, refresh0 = train.afto_llm_step, train.cut_refresh_llm

        from torch.profiler import ProfilerActivity, profile

        def timed(fn, out_ms):
            def call(*a):
                torch.cuda.synchronize()
                before = sum(K.LAUNCHES.values())
                t0 = time.perf_counter()
                out = fn(*a)
                torch.cuda.synchronize()
                out_ms.append((time.perf_counter() - t0) * 1e3)
                self.launches += sum(K.LAUNCHES.values()) - before
                return out
            return call

        def step(*a):
            if self.profile_steps and \
                    len(self.step_ms) == self.profile_steps[0]:
                torch.cuda.synchronize()
                # device activity only: host-op records of ~200,000 ops
                # would double the window's wall time
                self._prof = profile(activities=[ProfilerActivity.CUDA])
                self._prof.__enter__()
                self._t0 = time.perf_counter()
            return timed(step0, self.step_ms)(*a)

        def refresh(*a):
            st = timed(refresh0, self.refresh_ms)(*a)
            if len(self.refresh_ms) - 1 == self.keep_refresh:
                self.kept = st
            self.cuts_after_refresh.append(
                (int(st.cuts.active.sum()), int(st.cuts_i.active.sum())))
            if self._prof is not None:
                wall_us = (time.perf_counter() - self._t0) * 1e6
                self._prof.__exit__(None, None, None)
                self.profiled, self._prof = (self._prof, wall_us), None
            return st

        train.afto_llm_step = step
        train.cut_refresh_llm = refresh
        try:
            yield self
        finally:
            train.afto_llm_step, train.cut_refresh_llm = step0, refresh0


def states_bitwise(label, got, want):
    import torch
    from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path

    names = ["/".join(str(e[0]) for e in p)
             for p, _ in tree_leaves_with_path(want)]
    diff = [n for n, a, b in zip(names, tree_leaves(got), tree_leaves(want))
            if a.dtype != b.dtype or not torch.equal(a, b)]
    check(not diff, f"{label}: leaves differ bitwise: {diff[:6]}")


def histories_equal(label, got, want):
    strip = lambda h: [{k: v for k, v in r.items() if k != "host_s"}
                       for r in h]
    check(strip(got) == strip(want),
          f"{label}: histories differ: {strip(got)} vs {strip(want)}")


def finite_losses(label, history):
    check(all(np.isfinite(h["loss"]) for h in history),
          f"{label}: a loss is not finite: {history}")


@contextlib.contextmanager
def kernel_calls():
    """Records every call of `ops.mlstm_chunk` and `ops.flash_attention`
    that the model makes inside the block: (name, args, kwargs, output)."""
    from repro_torch.kernels import ops

    calls, saved = [], {}
    for name in ("mlstm_chunk", "flash_attention"):
        fn = saved[name] = getattr(ops, name)

        def rec(*a, _fn=fn, _name=name, **kw):
            out = _fn(*a, **kw)
            calls.append((_name, a, kw, out))
            return out
        setattr(ops, name, rec)
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


# a kernel call of a bf16 validation forward (16 (a), (b)) against its
# plain version on the call's inputs: the output's `row_rel_err` (per
# query row; an mLSTM row's near-zero entries sit beside entries 100x
# larger, so an elementwise limit fails on bf16 rounding of the large
# ones: xLSTM-125M's call 4 read 0.069 at an entry of 0.073 in a row of
# 20, 5.6e-3 of the row from an f64 evaluation where the plain route
# reads 3.9e-3; on an NVIDIA H100 80GB HBM3), the mLSTM's f32 state at
# MLSTM_TOL, the flash output also at FLASH_TOL.  The kernels read at
# most 7.8e-3; a key tile dropped from the mLSTM (`mlstm_tile_fault`)
# must read beyond the limit (phase 7 plants flash's faults)
ROUTE_ROW_TOL = {"mlstm_chunk": 2e-2, "flash_attention": FLASH_ROW_TOL}


def mlstm_tile_fault(a):
    """The plain mLSTM chunk on a call's inputs `a` with a planted fault:
    the 16 keys before the chunk's middle dropped (their input gates at
    -inf), as a kernel that skipped a key tile would; its y."""
    from repro_torch.kernels import ops

    li = a[3].clone()
    mid = li.shape[2] // 2
    li[:, :, mid - 16:mid] = -np.inf
    return ops.mlstm_chunk(*a[:3], li, *a[4:], impl="ref")[0]


def route_calls_check(label, calls):
    """Phases 7 and 9's kernel checks at the shapes and values of a
    forward: each kernel call's outputs against its plain version on the
    same inputs (`ROUTE_ROW_TOL`), and for the mLSTM a planted fault
    (`mlstm_tile_fault`) that must read beyond the limit.  Returns the
    worst row_rel_err and the worst RMS relative difference of the first
    output, and the least row_rel_err of a planted fault (inf if none)."""
    from repro_torch.kernels import ops

    worst = rms = 0.0
    fault_min = np.inf
    for i, (name, a, kw, out) in enumerate(calls):
        kw = dict(kw, impl="ref")
        want = getattr(ops, name)(*a, **kw)
        got, want = (out, want) if name == "mlstm_chunk" \
            else ((out,), (want,))
        dname = str(got[0].dtype).split(".")[-1]
        row = row_rel_err(got[0], want[0])
        tol = ROUTE_ROW_TOL[name]
        tol = tol[dname] if isinstance(tol, dict) else tol
        check(row <= tol, f"{label}: call {i} of {name} against its plain "
              f"version at the forward's inputs: row_rel_err {row:.3e} "
              f"(gate {tol})")
        if name == "mlstm_chunk":     # the state is f32 on both routes
            pairs, lim = list(zip(got[1:], want[1:])), MLSTM_TOL["float32"]
        else:
            pairs, lim = [(got[0], want[0])], FLASH_TOL[dname]
        try:
            for x, y in pairs:
                close(x, y, lim, lim)
        except AssertionError as e:
            fail(f"{label}: call {i} of {name} against its plain version "
                 f"at the forward's inputs: {e}")
        if name == "mlstm_chunk":
            fault = row_rel_err(mlstm_tile_fault(a), want[0])
            check(fault > tol, f"{label}: call {i}: a planted fault (a "
                  f"key tile dropped) reads {fault:.3e}, within the gate "
                  f"{tol}: the check cannot see it")
            fault_min = min(fault_min, fault)
        g, w = got[0].float(), want[0].float()
        worst = max(worst, row)
        rms = max(rms, float((g - w).pow(2).mean().sqrt()
                             / w.pow(2).mean().sqrt()))
    return worst, rms, fault_min


def loss_route_check(label, cfg, params, tokens):
    """The validation loss on the kernel route (bf16) held to the plain
    route by the bf16 rule of PERF.md §2: within DISTANCE_FACTOR x the
    plain route's distance from an f32 evaluation of the same weights
    plus BF16_FLOOR, and within 5e-2 of the plain route (relative).  The
    loss of an untrained model barely depends on its mixer, so every
    kernel call of the forward is also held to its plain version on the
    call's own inputs (`route_calls_check`).  Returns the kernel route's
    launches."""
    import dataclasses as dc
    import torch
    from repro_torch.kernels import cut_eval as K
    from repro_torch.models import transformer as tfm
    from repro_torch.utils.tree import tree_map

    with torch.no_grad():
        K.reset_launches()
        with kernel_calls() as calls:
            got = float(tfm.train_loss(cfg, params, tokens, impl=None))
        launches = dict(K.LAUNCHES)
        per_call, per_rms, fault = route_calls_check(label, calls)
        del calls
        plain = float(tfm.train_loss(cfg, params, tokens, impl="ref"))
        wide = tree_map(lambda a: a.float(), params)
        f32 = float(tfm.train_loss(dc.replace(cfg, dtype="float32"), wide,
                                   tokens, impl="ref"))
        del wide
    torch.cuda.empty_cache()
    d_k, d_p = abs(got - f32) / abs(f32), abs(plain - f32) / abs(f32)
    rel_kp = abs(got - plain) / abs(plain)
    print(f"  {label} validation loss: kernel route {got:.6f} (launches "
          f"{launches}), plain route {plain:.6f}, f32 evaluation {f32:.6f};"
          f" relative distance from f32: kernel {d_k:.3e}, plain {d_p:.3e} "
          f"(gate {DISTANCE_FACTOR} x plain + {BF16_FLOOR}); kernel vs "
          f"plain {rel_kp:.3e} (gate 5e-2); each kernel call against its "
          f"plain version on its inputs: worst row_rel_err of the output "
          f"{per_call:.3e} (gate {ROUTE_ROW_TOL}), worst RMS relative "
          f"difference {per_rms:.3e}"
          + (f", a planted fault at least {fault:.3e}"
             if np.isfinite(fault) else ""), flush=True)
    check(np.isfinite(got) and np.isfinite(plain),
          f"{label}: validation loss not finite")
    check(d_k <= DISTANCE_FACTOR * d_p + BF16_FLOOR,
          f"{label}: the kernel route's loss is {d_k:.3e} from the f32 "
          f"evaluation, the plain route's {d_p:.3e}")
    check(rel_kp <= 5e-2, f"{label}: the routes' losses differ by "
          f"{rel_kp:.3e}")
    return launches


# phase 16 (a)'s chunked run and times, which phase 19 holds its mesh to
PHASE16 = {}


def xlstm_training(tmp, launches):
    """16 (a): xLSTM-125M at full size, the driver's AFTO defaults."""
    import shutil
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import cut_eval as K
    from repro_torch.launch import train
    from repro_torch.utils.tree import tree_index, tree_map

    cfg = get_config("xlstm-125m")
    common = ("--t-pre", str(TRAIN_T_PRE), "--log-every", str(TRAIN_CHUNK),
              "--lr", str(TRAIN_LR))
    base = ("--steps", str(TRAIN_ITERATIONS), *common)
    short = ("--steps", str(TRAIN_SHORT), *common)
    streamed = ("--steps", str(TRAIN_STREAM), "--t-pre",
                str(TRAIN_STREAM_T_PRE), "--log-every",
                str(TRAIN_STREAM_CKPT), "--lr", str(TRAIN_LR))
    args0 = train_args(*base)
    _, state0, _, _ = train._afto_setup(cfg, args0)
    n_params = sum(x.numel() for x in train.tree_leaves(state0.z3))
    print(f"  xLSTM-125M: {n_params:,} parameters ({cfg.dtype}), N "
          f"{args0.workers}, per-worker batch {args0.batch}, sequence "
          f"{args0.seq}, sketch r {args0.sketch_r}, tau {args0.tau}, "
          f"t_pre {TRAIN_T_PRE}, lr {TRAIN_LR}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    # the chunked run goes first: its last two steps and its second
    # refresh run under torch.profiler (their times are left out of the
    # means), and its state after its first refresh is kept
    prof_steps = (TRAIN_ITERATIONS - 2, TRAIN_ITERATIONS - 1)
    meter = TrainMeter(profile_steps=prof_steps, keep_refresh=0)
    runs = {}
    K.reset_launches()
    with meter.installed():
        runs["chunked"] = train.run_afto(
            cfg, train_args(*base, "--scan-chunk", str(TRAIN_CHUNK)),
            state=state0)
        runs["eager"] = train.run_afto(cfg, train_args(*short,
                                                       "--engine", "eager"),
                                       state=state0)
        full, part = f"{tmp}/stream_full", f"{tmp}/stream_resumed"
        stream = (*streamed, "--stream", "--scan-chunk",
                  str(TRAIN_STREAM_CKPT), "--ckpt-every",
                  str(TRAIN_STREAM_CKPT))
        runs["streamed"] = train.run_afto(
            cfg, train_args(*stream, "--ckpt-dir", full), state=state0)
        shutil.copytree(f"{full}/step_{TRAIN_STREAM_CKPT:08d}",
                        f"{part}/step_{TRAIN_STREAM_CKPT:08d}")
        before = len(meter.refresh_ms)
        runs["resumed"] = train.run_afto(
            cfg, train_args(*stream, "--ckpt-dir", part, "--resume"),
            state=state0)
        resumed_refreshes = len(meter.refresh_ms) - before
    total = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    states_bitwise(f"16 (a) eager ({TRAIN_SHORT} iterations) against the "
                   "chunked run after its first refresh",
                   runs["eager"]["state"], meter.kept)
    meter.kept = None
    histories_equal("16 (a) eager against chunked",
                    runs["eager"]["history"],
                    runs["chunked"]["history"][:1])
    states_bitwise("16 (a) resumed against uninterrupted (--stream)",
                   runs["resumed"]["state"], runs["streamed"]["state"])
    check(runs["resumed"]["history"] == [] or
          runs["resumed"]["history"][-1]["loss"]
          == runs["streamed"]["history"][-1]["loss"],
          "16 (a) resumed run's last loss differs")
    at_ckpt = [h for h in runs["streamed"]["history"]
               if h["step"] == TRAIN_STREAM_CKPT]
    check(len(at_ckpt) == 1 and at_ckpt[0]["cuts"] >= 1,
          f"16 (a): the streamed run's checkpoint at step "
          f"{TRAIN_STREAM_CKPT} holds no active cut: "
          f"{runs['streamed']['history']}")
    check(resumed_refreshes >= 1, "16 (a): the resumed run crossed no "
          "refresh")
    for name, out in runs.items():
        finite_losses(f"16 (a) {name}", out["history"])
    check(all(a >= 1 and b >= 1 for a, b in meter.cuts_after_refresh),
          f"16 (a) a polytope without an active cut after a refresh: "
          f"{meter.cuts_after_refresh}")
    check(meter.launches == 0, f"16 (a): training steps and refreshes "
          f"launched {meter.launches} kernels")
    check(total.get("mlstm_chunk", 0) > 0,
          f"16 (a): the validation forwards launched {total}")
    # timed means: every step and refresh of the four runs but the first
    # of all (the process's warm-up) and the profiled ones
    steps = [ms for i, ms in enumerate(meter.step_ms)
             if i not in prof_steps and i != 0]
    refreshes = meter.refresh_ms[2:]
    ms_it, ms_ref = float(np.mean(steps)), float(np.mean(refreshes))
    print(f"  16 (a) runs: chunks of {TRAIN_CHUNK} ({TRAIN_ITERATIONS} "
          f"iterations), eager ({TRAIN_SHORT}), --stream ({TRAIN_STREAM}, "
          f"a refresh every {TRAIN_STREAM_T_PRE}) with a checkpoint every "
          f"{TRAIN_STREAM_CKPT} ({at_ckpt[0]['cuts']:.0f} active cuts in "
          f"it), and resumed from step {TRAIN_STREAM_CKPT} ("
          f"{resumed_refreshes} refresh after the resume): eager bitwise "
          "the chunked run after its first refresh, resumed bitwise "
          "uninterrupted; losses "
          + ", ".join(f"{k} {[round(h['loss'], 4) for h in v['history']]}"
                      for k, v in runs.items())
          + f"; active cuts (II, I) after each refresh "
          f"{meter.cuts_after_refresh}", flush=True)
    print(f"  16 (a) launches: steps and refreshes {meter.launches} "
          f"({len(meter.step_ms)} steps, {len(meter.refresh_ms)} refreshes"
          f"); validation forwards {total}", flush=True)
    print(f"  16 (a) ms per iteration {ms_it:.1f} (mean of {len(steps)} "
          f"steps of the four runs; the first {meter.step_ms[0]:.1f}), ms per"
          f" refresh {ms_ref:.1f} (mean of {len(refreshes)}; the first "
          f"{meter.refresh_ms[0]:.1f}); peak torch.cuda.max_memory_allocated "
          f"{peak:.2f} GiB ({CARD})", flush=True)
    check(meter.profiled is not None, "16 (a): the profiled window ran no "
          "refresh")
    report_profile(f"16 (a) xLSTM-125M, chunked steps {TRAIN_ITERATIONS - 1}"
                   f"-{TRAIN_ITERATIONS} and the refresh at step "
                   f"{TRAIN_ITERATIONS}", *meter.profiled)
    for k, v in total.items():
        launches[k] = launches.get(k, 0) + v
    PHASE16.update(
        state=tree_map(lambda x: x.cpu(), runs["chunked"]["state"]),
        history=runs["chunked"]["history"], ms_it=ms_it, ms_ref=ms_ref,
        peak=peak)
    # the bf16 rule on the last validation batch of the chunked run
    w0 = tree_index(runs["chunked"]["state"].X3, 0)
    from repro_torch.data.synthetic import make_token_stream
    toks = torch.as_tensor(make_token_stream(
        cfg.vocab_size, args0.workers * args0.batch, args0.seq,
        seed=args0.seed * 7919 + TRAIN_ITERATIONS - 1),
        device="cuda")[:args0.batch]
    route = loss_route_check("16 (a) xLSTM-125M", cfg, w0, toks)
    check(route.get("mlstm_chunk", 0) > 0,
          f"16 (a): the validation forward launched {route}")
    del runs, state0
    torch.cuda.empty_cache()
    return ms_it, ms_ref, peak


def llama_training(launches):
    """16 (b): Llama-3 8B's widths at one layer."""
    import dataclasses as dc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.kernels import cut_eval as K
    from repro_torch.launch import train
    from repro_torch.models.config import BlockSpec, uniform_stages
    from repro_torch.utils.tree import tree_index

    cfg = dc.replace(get_config("llama3-8b"), n_layers=1,
                     stages=uniform_stages(1, BlockSpec())).validate()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    plain = train.run_plain(cfg, train_args(
        "--arch", "llama3-8b", "--mode", "plain", "--steps", "4",
        "--workers", "2", "--batch", "2", "--seq", "129", "--log-every", "1",
        "--lr", str(TRAIN_LR)))
    finite_losses("16 (b) plain AdamW", plain["history"])
    plain_losses = [round(h["loss"], 4) for h in plain["history"]]
    check(sum(K.LAUNCHES.values()) == 0,
          f"16 (b) plain steps launched {dict(K.LAUNCHES)}")
    peak_plain = torch.cuda.max_memory_allocated() / 2 ** 30
    del plain
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = train_args("--workers", "2", "--batch", "1", "--seq", "129",
                      "--sketch-r", "4096", "--lr", str(TRAIN_LR))
    hyper, state, _, _ = train._afto_setup(cfg, args)
    toks = torch.as_tensor(make_token_stream(cfg.vocab_size, 2, 129),
                           device="cuda").reshape(2, 1, 129)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = train.afto_llm_step(cfg, hyper, state,
                                {"tokens": toks, "val_tokens": toks},
                                torch.ones(2, device="cuda"))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    check(sum(K.LAUNCHES.values()) == 0,
          f"16 (b) the AFTO step launched {dict(K.LAUNCHES)}")
    bad = [k for k, x in enumerate(train.tree_leaves(state))
           if x.is_floating_point() and not bool(torch.isfinite(x).all())]
    check(not bad, f"16 (b) AFTO step: non-finite leaves {bad[:5]}")
    peak_afto = torch.cuda.max_memory_allocated() / 2 ** 30
    route = loss_route_check("16 (b) Llama-3 8B widths, one layer", cfg,
                             tree_index(state.X3, 0), toks[0])
    check(route.get("flash_attention", 0) > 0,
          f"16 (b): the validation forward launched {route}")
    for k, v in route.items():
        launches[k] = launches.get(k, 0) + v
    print(f"  16 (b) Llama-3 8B widths at one layer "
          f"({sum(x.numel() for x in train.tree_leaves(state.z3)):,} "
          f"parameters, bf16): 4 AdamW steps at batch 2 x 2, sequence 129, "
          f"losses {plain_losses}, peak {peak_plain:.2f} GiB; one AFTO step "
          f"(N 2, batch 1, "
          f"sketch r 4096) {step_ms:.1f} ms, peak {peak_afto:.2f} GiB; "
          "the refresh at this width waits for the dryrun slice "
          "(ROADMAP.md Queue 1, item 9)", flush=True)
    del state
    torch.cuda.empty_cache()
    return peak_plain, peak_afto


def leaf_diffs(got, want, exact_ints=True, label="16 (c)"):
    """[(name, max |got - want| / max |want|)] over the floating leaves
    of two states, taken on `got`'s device; cut active / age must be
    exact (with exact_ints)."""
    import torch
    from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path

    out = []
    for (path, g), w in zip(tree_leaves_with_path(got), tree_leaves(want)):
        name = "/".join(str(e[0]) for e in path)
        g, w = g.double(), w.to(g.device).double()
        if name.endswith(("active", "age")):
            check(not exact_ints or torch.equal(g, w),
                  f"{label}: {name} differs")
            continue
        scale = float(w.abs().max()) if w.numel() else 0.0
        out.append((name, float((g - w).abs().max()) / scale
                    if scale else 0.0))
    return out


def stage_diffs(arch, label, got, want, worst):
    """Fail unless every leaf of the card's state `got` is within its
    arch's limit of the CPU's `want` (cut active / age exact); the worst
    reading of each cut block and of the rest goes into `worst`."""
    for name, err in leaf_diffs(got, want):
        block = "/".join(name.split("/")[:2])
        kind = block if block in CARD_CPU_TOL[arch] else "rest"
        tol = CARD_CPU_TOL[arch][kind]
        check(err <= tol, f"16 (c) {arch} {label}: {name} at {err:.3e} of "
              f"its largest magnitude (gate {tol})")
        if err > worst.get((arch, kind), (0.0, ""))[0]:
            worst[(arch, kind)] = (err, name)


def card_against_cpu():
    """16 (c): reduced llama3-8b and xlstm-125m (f32), one initial state
    made on the CPU, 4 AFTO iterations with one refresh (the driver's
    batches and schedule, t_pre 2) on the CPU.  Each stage (a step, the
    refresh) also runs on the card from the CPU's state before it, and
    its result is held to the CPU's (`CARD_CPU_TOL`); and the card runs
    the 4 iterations from the initial state on its own, whose end is
    held to the CPU's end (`TRAJECTORY_TOL`), and no farther from it
    than TRAJECTORY_OVER_ULP x its own trajectory from weights one ulp
    up."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.launch import train
    from repro_torch.utils.tree import tree_map

    worst, n_stages, traj = {}, 0, {}
    for arch in ("llama3-8b", "xlstm-125m"):
        cfg = reduced(get_config(arch))
        args = train_args("--steps", "4", "--t-pre", "2", "--t1", "2",
                          "--workers", "4", "--batch", "2", "--seq", "33",
                          "--sketch-r", "128", "--lr", str(TRAIN_LR),
                          device="cpu")
        hyper, cpu, sched, _ = train._afto_setup(cfg, args)
        own = tree_map(lambda x: x.to("cuda"), cpu)
        # the witness: the card's trajectory from weights one ulp up
        up = lambda x: torch.nextafter(x, torch.full_like(x, np.inf))
        nudged = dataclasses.replace(own, X3=tree_map(up, own.X3),
                                     z3=tree_map(up, own.z3))
        n, b, sq = args.workers, args.batch, args.seq
        for it in range(args.steps):
            toks = torch.as_tensor(make_token_stream(
                cfg.vocab_size, n * b, sq, seed=args.seed * 7919 + it)) \
                .reshape(n, b, sq)
            batch = {"tokens": toks, "val_tokens": toks}
            on_card = tree_map(lambda x: x.to("cuda"), batch)
            mask = torch.as_tensor(sched.next_active()[0])
            stages = [("step", lambda st, bt, m: train.afto_llm_step(
                cfg, hyper, st, bt, m))]
            if (it + 1) % args.t_pre == 0 and it < args.t1:
                stages.append(("refresh", lambda st, bt, m:
                               train.cut_refresh_llm(cfg, hyper, st, bt)))
            for label, stage in stages:
                card = stage(tree_map(lambda x: x.to("cuda"), cpu),
                             on_card, mask.to("cuda"))
                own = stage(own, on_card, mask.to("cuda"))
                nudged = stage(nudged, on_card, mask.to("cuda"))
                cpu = stage(cpu, batch, mask)
                stage_diffs(arch, f"iteration {it} {label}", card, cpu,
                            worst)
                n_stages += 1
        check(float(cpu.cuts.active.sum()) >= 1 and
              float(cpu.cuts_i.active.sum()) >= 1,
              f"16 (c) {arch}: a polytope without an active cut")
        diffs = sorted(leaf_diffs(own, cpu), key=lambda x: -x[1])
        ulp = dict(leaf_diffs(nudged, own, exact_ints=False))
        worst_ulp = max(ulp.items(), key=lambda x: x[1])
        traj[arch] = ([(n, v, ulp[n]) for n, v in diffs[:3]], worst_ulp)
    print(f"  16 (c) card against CPU, {n_stages} stages (4 iterations and a"
          " refresh each arch, each stage from the CPU's state), worst leaf"
          " error / its largest magnitude: " + ", ".join(
              f"{a} {k} {v:.3e} ({n})" for (a, k), (v, n)
              in sorted(worst.items()))
          + f" (gates: {CARD_CPU_TOL}); the card's own trajectory against "
          "the CPU's after 4 iterations, the three worst leaves (beside "
          "each, how far the card's trajectory from weights one ulp up "
          "ends from its own; then that witness's worst leaf): "
          + "; ".join(f"{a} " + ", ".join(
              f"{n} {v:.3e} (one ulp: {u:.3e})" for n, v, u in d)
              + f"; one ulp's worst {w[0]} {w[1]:.3e}"
              for a, (d, w) in traj.items())
          + f" (gates: {TRAJECTORY_TOL})", flush=True)
    for arch, (d, w) in traj.items():
        name, err, _ = d[0]
        check(err <= TRAJECTORY_TOL[arch], f"16 (c) {arch}: the card's own "
              f"4 iterations end with {name} at {err:.3e} of the CPU's "
              f"largest magnitude (gate {TRAJECTORY_TOL[arch]})")
        check(err <= TRAJECTORY_OVER_ULP * w[1], f"16 (c) {arch}: the "
              f"card's trajectory strays {err:.3e} from the CPU's, more than "
              f"{TRAJECTORY_OVER_ULP} x one ulp's {w[1]:.3e}")


def guard_check():
    """16 (d): each kernel wrapper, handed a CUDA tensor that a gradient
    can flow through, raises."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mlstm_chunk as mc

    q = torch.randn(1, 128, 4, 128, device="cuda", dtype=torch.bfloat16)
    ml = [torch.randn(1, 4, 128, 192, device="cuda", dtype=torch.bfloat16)
          for _ in range(3)]
    gates = [-torch.rand(1, 4, 128, 1, device="cuda") for _ in range(2)]
    st = [torch.zeros(1, 4, 192, 192, device="cuda"),
          torch.zeros(1, 4, 1, 192, device="cuda"),
          torch.zeros(1, 4, 1, 1, device="cuda")]
    calls = {
        "flash_attention": lambda a: fa.flash_attention(a, q, q),
        "mlstm_chunk": lambda a: mc.mlstm_chunk(a, *ml[1:], *gates, *st)[0],
    }
    firsts = {"flash_attention": q, "mlstm_chunk": ml[0]}
    for name, call in calls.items():
        for how in ("requires_grad", "torch.func.grad"):
            a = firsts[name].detach()
            try:
                if how == "requires_grad":
                    call(a.requires_grad_(True))
                else:
                    torch.func.grad(lambda x: call(x).float().sum())(a)
            except RuntimeError as e:
                check("forward only" in str(e),
                      f"16 (d) {name} ({how}) raised another error: {e}")
                continue
            fail(f"16 (d) {name} handed a tensor a gradient flows through "
                 f"({how}) returned")
    print("  16 (d) flash_attention and mlstm_chunk raise when handed a "
          "CUDA tensor that requires grad, and inside torch.func.grad",
          flush=True)


def training_phase(rows):
    """Phase 16: the LLM training path (`repro_torch.launch.train`)."""
    import tempfile

    t0 = time.perf_counter()
    launches, parts = {}, []

    def part(label, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        parts.append(f"{label} {time.perf_counter() - t:.1f} s")
        return out

    part("(d)", guard_check)
    with tempfile.TemporaryDirectory(prefix="phase16_ckpt_") as tmp:
        part("(a)", xlstm_training, tmp, launches)
    part("(b)", llama_training, launches)
    part("(c)", card_against_cpu)
    for k in KERNELS:
        rows[k]["launches_phase16"] = int(launches.get(k, 0))
    took = time.perf_counter() - t0
    print(f"phase 16 (the LLM training path): {took:.1f} s ("
          + ", ".join(parts) + f"; budget "
          f"{TRAIN_PHASE_S:.0f} s; host speed varies between calls, so "
          "the budget is read, not gated)", flush=True)


# ---------------------------------------------------------------------------
# phase 18: the dry-run's count held to the card
# ---------------------------------------------------------------------------

# the gates: the count's argument bytes within 1% of the bytes the card
# holds resident for the call, its temp within 10% + 64 MiB of the
# card's peak above them, and its compute term no longer than the call
DRYRUN_ARG_TOL = 0.01
DRYRUN_TEMP_TOL = (0.10, 64 * 2 ** 20)
# the Llama-3 8B refresh runs when the count says it fits below this
DRYRUN_REFRESH_FITS = 70 * 2 ** 30


def resident(build):
    """(build(), the bytes it leaves allocated on the card)."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    out = build()
    torch.cuda.synchronize()
    return out, torch.cuda.memory_allocated() - base


def held_to_count(label, row, held, fn):
    """Run fn() once from a reset peak and hold the card's readings to
    the dry-run row (a 1 x 1 mesh: the whole step); `held` is the bytes
    the call's arguments keep on the card."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    temp = torch.cuda.max_memory_allocated() - base
    del out
    arg_err = abs(row["arg_bytes"] - held) / held
    temp_err = abs(row["temp_bytes"] - temp)
    rel, slack = DRYRUN_TEMP_TOL
    print(f"  18 {label}: arguments counted {row['arg_bytes'] / 2 ** 30:.3f}"
          f" GiB, resident {held / 2 ** 30:.3f} GiB (off {arg_err:.2e}); "
          f"temp counted {row['temp_bytes'] / 2 ** 30:.3f} GiB, measured "
          f"{temp / 2 ** 30:.3f} GiB (off {temp_err / 2 ** 20:.1f} MiB); "
          f"compute term {row['compute_s'] * 1e3:.2f} ms, the call "
          f"{secs * 1e3:.1f} ms; memory term {row['memory_s'] * 1e3:.2f} ms;"
          f" {CARD}", flush=True)
    check(arg_err <= DRYRUN_ARG_TOL,
          f"18 {label}: counted arguments off by {arg_err:.2e}")
    check(temp_err <= rel * temp + slack,
          f"18 {label}: counted temp {row['temp_bytes']:.0f} B against "
          f"{temp} B measured")
    check(row["compute_s"] <= secs,
          f"18 {label}: compute term {row['compute_s']:.4f} s above the "
          f"measured {secs:.4f} s")
    return {"arg_bytes": row["arg_bytes"], "resident": held,
            "temp_bytes": row["temp_bytes"], "temp_measured": temp,
            "compute_s": row["compute_s"], "seconds": secs}


def phase18_cases():
    """(label, config, shape, step, route, `launch.train`'s argv or None)
    of each step phase 18 holds, in order: the shapes, dtype and
    route of phases 8, 17 and 16."""
    import dataclasses as dc
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.models.config import BlockSpec, uniform_stages

    llama = get_config("llama3-8b")
    one_layer = dc.replace(llama, n_layers=1,
                           stages=uniform_stages(1, BlockSpec())).validate()
    lr = ("--lr", str(TRAIN_LR))
    largs = ("--workers", "2", "--batch", "1", "--seq", "129",
             "--sketch-r", "4096") + lr
    xname = "xLSTM-125M AFTO (N 4, batch 2, sequence 129, sketch r 256)"
    lname = ("Llama-3 8B widths, one layer, AFTO (N 2, batch 1, sequence "
             "129, sketch r 4096)")
    prompt = InputShape("prefill (4, 1024)", 1024, 4, "prefill")
    return [
        ("Llama-3 8B bf16 prefill (4, 1024), kernel route", llama, prompt,
         "prefill", "kernel", None),
        ("Llama-3 8B bf16 prefill (4, 1024), ref route", llama, prompt,
         "prefill", "ref", None),
        ("Jamba v0.1 one-period prefill (4, 1024)",
         phase17_cfgs("jamba-v0.1-52b")[0], prompt, "prefill", "kernel",
         None),
        (f"{xname}: step", get_config("xlstm-125m"),
         InputShape("xlstm", 129, 8, "train"), "afto_train", "ref", lr),
        (f"{xname}: refresh", get_config("xlstm-125m"),
         InputShape("xlstm", 129, 8, "train"), "cut_refresh", "ref", lr),
        (f"{lname}: step", one_layer, InputShape("llama", 129, 2, "train"),
         "afto_train", "ref", largs),
        (f"{lname}: refresh", one_layer,
         InputShape("llama", 129, 2, "train"), "cut_refresh", "ref", largs),
    ]


def count_hyper(args):
    """The `FedHyper` that `launch.train` builds from `args`
    (`train._afto_setup`'s; phase 18 checks that they are equal)."""
    from repro_torch.fed.trilevel_llm import FedHyper
    return FedHyper(n_workers=args.workers, cut_mode=args.cut_mode,
                    sketch_r=args.sketch_r, p_max=2, k_inner=1, remat=False,
                    eta_x=args.lr, eta_z=args.lr)


def dryrun_counts(labels, path):
    """`dryrun.run_one` on a 1 x 1 mesh for the phase-18 cases named in
    `labels`, on meta tensors (no card), written to `path` as JSON."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh

    rows = {}
    for label, cfg, shape, step, route, argv in phase18_cases():
        if label in labels:
            hyper = None if argv is None else count_hyper(train_args(*argv))
            rows[label] = dryrun.run_one(cfg, shape, make_debug_mesh(1, 1),
                                         step=step, route=route,
                                         hyper=hyper, verbose=False)
    with open(path, "w") as f:
        json.dump(rows, f)


def start_counts():
    """Start phase 18's counts in two processes that run beside the
    phases before it (tracing xLSTM's refresh on meta tensors takes
    most of a minute): the xLSTM refresh in one, the rest in the other.
    Returns their handle for `collect_counts`."""
    import atexit
    import os
    import tempfile

    tmp = tempfile.mkdtemp(prefix="phase18_")
    labels = [c[0] for c in phase18_cases()]
    groups = [[x for x in labels if x.startswith("xLSTM") and
               x.endswith("refresh")]]
    groups.append([x for x in labels if x not in groups[0]])
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    procs = []
    for i, group in enumerate(groups):
        code = (f"import sys; sys.path[:0] = [{str(SRC)!r}, {str(ROOT)!r}]; "
                f"import chip_smoke as c; c.dryrun_counts({group!r}, "
                f"{tmp + f'/counts{i}.json'!r})")
        log = open(f"{tmp}/counts{i}.log", "w")
        procs.append((subprocess.Popen([sys.executable, "-c", code],
                                       stdout=log, stderr=subprocess.STDOUT,
                                       env=env), log, i))

    def stop():
        for proc, log, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()

    atexit.register(stop)
    return tmp, procs, stop


def collect_counts(started, timeout=600.0):
    """The rows of `start_counts`' processes, waiting for them."""
    import shutil

    tmp, procs, stop = started
    rows = {}
    try:
        for proc, _, i in procs:
            try:
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                fail(f"phase 18: the dry-run counts {i} ran past {timeout} s")
            if proc.returncode != 0:
                with open(f"{tmp}/counts{i}.log") as f:
                    fail(f"phase 18: the dry-run counts {i} failed:\n"
                         + f.read()[-3000:])
            with open(f"{tmp}/counts{i}.json") as f:
                rows.update(json.load(f))
    finally:
        stop()
        shutil.rmtree(tmp, ignore_errors=True)
    return rows


def phase18_call(cfg, step, route, made):
    """The call phase 18 measures: `made` holds (params, tokens) for a
    prefill, (hyper, state, batch, active) for a fed step.  (A function
    of its own, so that nothing of one case outlives it.)"""
    from repro_torch.launch import train
    from repro_torch.models import transformer as tfm

    if step == "prefill":
        return lambda: tfm.prefill(cfg, made[0], made[1], impl=route)
    hyper, state, batch, active = made
    if step == "cut_refresh":
        return lambda: train.cut_refresh_llm(cfg, hyper, state, batch)
    return lambda: train.afto_llm_step(cfg, hyper, state, batch, active)


def dryrun_phase(started):
    """Phase 18: `repro_torch.launch.dryrun.run_one`'s count on a 1 x 1
    mesh (computed beside the earlier phases, `start_counts`) against the
    card, for steps that earlier phases run at their shapes, dtype and
    route."""
    import gc
    import torch
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.launch import train
    from repro_torch.models import transformer as tfm

    t0 = time.perf_counter()
    counts = collect_counts(started)
    waited = time.perf_counter() - t0
    readings = {}

    def tokens(cfg, *shape):
        return torch.as_tensor(make_token_stream(
            cfg.vocab_size, math.prod(shape[:-1]), shape[-1]),
            device="cuda").reshape(shape)

    cases = phase18_cases()
    built = {}
    for label, cfg, shape, step, route, argv in cases:
        row = counts[label]
        if step == "cut_refresh" and \
                row["arg_bytes"] + row["temp_bytes"] > DRYRUN_REFRESH_FITS:
            print(f"  18 {label}: counted "
                  f"{(row['arg_bytes'] + row['temp_bytes']) / 2 ** 30:.1f} "
                  "GiB, above the 70 GiB the phase runs it under",
                  flush=True)
            continue
        key = (cfg, shape, argv)
        if key not in built:
            built.clear()
            gc.collect()
            torch.cuda.empty_cache()
            if argv is None:
                gen = torch.Generator(device="cuda").manual_seed(0)
                built[key] = resident(lambda: (
                    tfm.init_params(cfg, gen, device="cuda"),
                    tokens(cfg, shape.global_batch, shape.seq_len)))
            else:
                args = train_args(*argv)
                n, b = args.workers, args.batch
                built[key] = resident(lambda: (
                    *train._afto_setup(cfg, args)[:2],
                    {"tokens": tokens(cfg, n, b, args.seq),
                     "val_tokens": tokens(cfg, n, b, args.seq)},
                    torch.ones(n, device="cuda")))
                check(built[key][0][0] == count_hyper(args),
                      f"18 {label}: the counted hyper is not launch.train's")
        readings[label] = held_to_count(label, row, built[key][1],
                                        phase18_call(cfg, step, route,
                                                     built[key][0]))
    built.clear()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 18 (the dry-run against the card): "
          f"{time.perf_counter() - t0:.1f} s, {waited:.1f} s of it waiting "
          "for the counts", flush=True)
    return readings


# ---------------------------------------------------------------------------
# phase 19: the LLM federation over a worker mesh
# ---------------------------------------------------------------------------

# one job of 2 gloo ranks sharing the card; its first rank alone forms
# the NCCL mesh (`make_worker_mesh`; every rank creates it, in order)
LLM_MESH_RANKS = 2
LLM_MESH_TIMEOUT = 600.0
# 19 (a)'s gate against phase 16 (a)'s unsharded chunked run: every
# leaf of the gathered state within MESH_TRAIN_TOL of its largest
# magnitude (cut active / age exact), the logged losses within
# MESH_LOSS_RTOL.  At these settings theta stays 0 and no cut binds, so
# the step's sums carry nothing there; the planted window (see
# `fault_windows`) makes them carry, and its gathered correct run is
# held to the same window unsharded at MESH_TRAIN_TOL.  Set between the
# readings and the planted faults of the 1-iteration window on an
# NVIDIA H100 80GB HBM3: the 20-iteration state read 9.35e-8 (cuts_i/c;
# every other leaf closer), the losses were equal, the correct window
# 0 from the unsharded one; the dropped theta sum read 2.861e-6 (z1),
# rank 1's b-part left out 9.996e-1 (stale_lam)
MESH_TRAIN_TOL = 1e-6
MESH_LOSS_RTOL = 1e-5
# 19 (b): every leaf within its arch's CARD_CPU_TOL limit of its largest
# magnitude in the card's unsharded run from the same planted state:
# the cut blocks of ROADMAP.md Queue 3 item 16 at theirs (each block's
# leaves taken as one vector), the rest at "rest", 1e-4 for llama3-8b
# and reduced xLSTM's 3e-3 of Queue 3 item 17 (its f32 gradients are
# ill-conditioned: on 2 ranks in exact mode X3's zero-initialised
# stages/0/pos0/norm1 read 9.87e-4)
# ... and, past STAGE_WITNESS_FLOOR (the 1e-4 every leaf was first
# held to), within
# TRAJECTORY_OVER_ULP x the larger of two witnesses' readings of the same
# leaf or block, each the card's unsharded run against its own: with the
# worker vmap over blocks of 2 rows, as each rank runs it ("pairs";
# `vmapped_in_pairs`), and from weights one ulp up ("ulp", 16 (c)'s).
# On an NVIDIA H100 80GB HBM3 "pairs" read exactly what the 2-rank legs
# read on every leaf past 1e-4 (reduced xLSTM's X3 norm1 up to 1.23e-3,
# cuts_i/a2 5.18e-3): the legs differ by the vmap's rounding alone
STAGE_WITNESS_FLOOR = 1e-4
STAGE_WITNESSES = ("pairs", "ulp")
MESH_STAGE_ARGS = ("--steps", "4", "--t-pre", "2", "--t1", "2", "--workers",
                   "4", "--batch", "2", "--seq", "33", "--sketch-r", "128")
# the planted state of 19 (b) and of (a)'s fault windows (`plant`):
# lam and stale_lam on the active cuts, theta's rows drawn in
# [-MESH_PLANTED_THETA, MESH_PLANTED_THETA] from seed 19
MESH_PLANTED_LAM, MESH_PLANTED_STALE_LAM = 2e-3, 1e-3
MESH_PLANTED_THETA = 0.5
# the fault windows of 19 (a): iterations from the state after the
# first refresh (`plant`ed: see there), correct and with each fault
# planted in the step's sum
MESH_FAULT_ITERATIONS = 1
# ... in which each active II-cut is violated by this much at the step's
# new variables (lam comes out near 0.01 x this, inside its clamp of 10):
# the cut value's f32 rounding, a few ulps of its terms, stays far below
# it (a violation of 1 let the unsharded window read 2.3e-6 on lam on
# the CPU at reduced size; at full size the violation of 1 planted at
# the input fell below 0 after the step's moves, so lam was clipped to 0
# in both).  On an NVIDIA H100 80GB HBM3 the correct window read bitwise
# the unsharded one, the faults 2.861e-6 (z1) and 9.996e-1 (stale_lam)
MESH_WINDOW_VIOLATION = 500.0
MESH_FAULTS = {"theta": "a dropped theta sum (each rank keeps its own)",
               "b-part": "rank 1's b-part left out of the cut values"}
PHASE19_S = 150.0


def storage_bytes(tree) -> int:
    """The bytes the distinct storages of a tree's tensors hold."""
    from repro_torch.utils.tree import tree_leaves

    seen = {}
    for x in tree_leaves(tree):
        st = x.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


class MeshMeter:
    """Wraps the driver's sharded step and refresh (the names it calls)
    in a rank: device-synchronised ms, the kernels they launch (there
    must be none), the active cuts after each refresh, the resident
    bytes of the first step's state argument, and the state after the
    first refresh (for the fault windows)."""

    def __init__(self):
        self.step_ms, self.refresh_ms, self.launches = [], [], 0
        self.cuts_after_refresh, self.resident = [], None
        self.after_refresh = None

    @contextlib.contextmanager
    def installed(self):
        import torch
        from repro_torch.kernels import cut_eval as K
        from repro_torch.launch import train

        step0 = train.afto_llm_step_sharded
        refresh0 = train.cut_refresh_llm_sharded

        def timed(fn, out_ms, *a):
            torch.cuda.synchronize()
            before = sum(K.LAUNCHES.values())
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            out_ms.append((time.perf_counter() - t0) * 1e3)
            self.launches += sum(K.LAUNCHES.values()) - before
            return out

        def step(shard, cfg, hyper, st, *a):
            if self.resident is None:
                self.resident = storage_bytes(st)
            return timed(step0, self.step_ms, shard, cfg, hyper, st, *a)

        def refresh(*a):
            st = timed(refresh0, self.refresh_ms, *a)
            if self.after_refresh is None:
                self.after_refresh = st
            self.cuts_after_refresh.append(
                (int(st.cuts.active.sum()), int(st.cuts_i.active.sum())))
            return st

        train.afto_llm_step_sharded, train.cut_refresh_llm_sharded = \
            step, refresh
        try:
            yield self
        finally:
            train.afto_llm_step_sharded = step0
            train.cut_refresh_llm_sharded = refresh0


@contextlib.contextmanager
def recorded_val_calls(calls):
    """The driver's validation forwards with their kernel calls recorded
    into `calls` (`kernel_calls`), and none of the steps' plain calls."""
    from repro_torch.launch import train

    make0 = train.make_val_loss

    def make(cfg):
        val_loss = make0(cfg)

        def recorded(w, toks):
            with kernel_calls() as got:
                out = val_loss(w, toks)
            calls.extend(got)
            return out
        return recorded

    train.make_val_loss = make
    try:
        yield calls
    finally:
        train.make_val_loss = make0


@contextlib.contextmanager
def planted_fault(mesh, fault):
    """The mesh's all-reduce with `fault` planted in the step's sum
    ("step": (theta sum, cut values' worker part) and, in sketch mode,
    z2's sketch): "theta" keeps each rank's own theta partial, "b-part"
    leaves rank 1's worker part out; None plants nothing."""
    import torch

    reduce0 = mesh.all_reduce

    def faulty(**parts):
        if fault is None or "step" not in parts:
            return reduce0(**parts)
        payload = parts["step"]
        nested = isinstance(payload[0], tuple)
        theta, part = payload[0] if nested else payload
        if fault == "b-part" and mesh.rank == 1:
            part = torch.zeros_like(part)
        sent = ((theta, part), payload[1]) if nested else (theta, part)
        got = reduce0(step=sent)["step"]
        if fault == "theta":
            summed = got[0] if nested else got
            got = ((theta, summed[1]), got[1]) if nested \
                else (theta, summed[1])
        return {"step": got}

    mesh.all_reduce = faulty
    try:
        yield
    finally:
        del mesh.all_reduce


def replicated_digest(state) -> str:
    """sha256 of the leaves the launcher's layout replicates."""
    import hashlib

    import torch
    from repro_torch.fed import sharding as shd
    from repro_torch.utils.tree import tree_leaves_with_path

    h = hashlib.sha256()
    for path, x in tree_leaves_with_path(state):
        if shd._llm_worker_dim(path) is None:
            h.update(x.detach().cpu().contiguous().view(-1).view(
                torch.uint8).numpy().tobytes())
    return h.hexdigest()


def local_leaf_errors(got, want):
    """[(name, max |got - want|, max |want|)] over a shard's floating
    leaves (combined over the ranks into global readings)."""
    from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path

    out = []
    for (path, g), w in zip(tree_leaves_with_path(got), tree_leaves(want)):
        if not g.is_floating_point() or not g.numel():
            continue
        g, w = g.double(), w.double()
        out.append(("/".join(str(e[0]) for e in path),
                    float((g - w).abs().max()), float(w.abs().max())))
    return out


def plant(st, n_workers, cutvals, rows=slice(None)):
    """A state in which every sum of the step carries: lam and stale_lam
    positive on the active cuts, each polytope's active cuts violated by
    1 (their constants c moved by `cutvals`, the cut values at `st`, one
    (P,) tensor a polytope, "cuts" and optionally "cuts_i"), and theta's
    rows (and their stale views) drawn from seed 19.  At the driver's
    settings a cut never binds (c ~ 6.6e4 from the bound term mu (2N +
    2) alpha, the cut values far below), so lam stays 0 and the cut
    values' sum is multiplied by zero; z1's step is below an f32 ulp at
    lr 1e-5, so theta stays 0 and so does its sum.  `rows` are the
    state's workers of the `n_workers`."""
    import torch
    from repro_torch.fed.trilevel_llm import N_PHI

    act = st.cuts.active
    g = torch.Generator(device=act.device).manual_seed(19)
    theta = (2 * torch.rand((n_workers, N_PHI), generator=g,
                            device=act.device) - 1) * MESH_PLANTED_THETA
    theta = theta[rows].contiguous()
    polytopes = {name: dataclasses.replace(
        getattr(st, name), c=getattr(st, name).c
        + (cutvals[name] - 1.0) * getattr(st, name).active)
        for name in cutvals}
    return dataclasses.replace(
        st, lam=act * MESH_PLANTED_LAM,
        stale_lam=(act * MESH_PLANTED_STALE_LAM)[None].expand(
            st.stale_lam.shape[0], -1).contiguous(),
        theta=theta, stale_theta=theta.clone(), **polytopes)


def sharded_cut_values(shard, hyper, st):
    """The II-layer cut values at a shard's state, summed over the mesh
    (label "probe")."""
    from repro_torch.fed import trilevel_llm_sharded as tls

    seed = hyper.seed_ii
    sketched = hyper.cut_mode == "sketch"
    part = tls._worker_cut_part(shard.start, hyper, st.cuts, st.z2, st.X2,
                                st.X3, seed, with_a2=not sketched)
    if sketched:
        part, s_z2 = tls._sum_with_sketch(shard, "probe", part, st.z2, seed,
                                          hyper.sketch_r)
    else:
        part, s_z2 = shard.reduce("probe", part), None
    return tls._cut_values(hyper, st.cuts, st.z1, st.z3, part, s_z2, seed)


def fault_windows(mesh, cfg, args, st):
    """MESH_FAULT_ITERATIONS iterations of 19 (a) from the shard's state
    `st` after the first refresh, `plant`ed, correct and with each
    planted fault: each leaf's local error against the correct window,
    and the digest of the replicated leaves (a fault that desynchronises
    the ranks shows there).  Rank 0 also runs the window unsharded
    (`afto_llm_step`) from the gathered planted state and holds the
    gathered correct window to it: [(leaf, max |diff| / max |unsharded|)]
    and whether cut active / age are equal."""
    import torch
    from repro_torch.fed.sharding import gather_fed_state
    from repro_torch.fed.trilevel_llm_sharded import Shard
    from repro_torch.launch import train

    shard = Shard(mesh, args.workers)
    rows = slice(shard.start, shard.start + shard.n_local)
    hyper = train.afto_hyper(args)
    st = plant(st, args.workers, {"cuts": sharded_cut_values(
        shard, hyper, st)}, rows)
    _, _, sched, _ = train._afto_setup(cfg, args, state=st)
    first = int(st.t)
    stop = first + MESH_FAULT_ITERATIONS
    toks = torch.as_tensor(np.ascontiguousarray(train._chunk_tokens(
        cfg, args, first, stop)[:, rows]), device="cuda")
    masks = torch.as_tensor(np.ascontiguousarray(sched.precompute(
        stop).active[:, rows]), device="cuda")

    def window(fault):
        out = st
        with planted_fault(mesh, fault):
            for i, it in enumerate(range(first, stop)):
                out = train._step(cfg, args, hyper, out,
                                  {"tokens": toks[i], "val_tokens": toks[i]},
                                  masks[it], it, shard)
        return out

    # the step's cut values are taken after its own moves: the constants
    # c are set from a first correct window so that they read
    # MESH_WINDOW_VIOLATION there
    after = sharded_cut_values(shard, hyper, window(None))
    act = st.cuts.active
    st = dataclasses.replace(st, cuts=dataclasses.replace(
        st.cuts, c=st.cuts.c + (after - MESH_WINDOW_VIOLATION) * act))
    correct = window(None)
    readings = {}
    for fault in MESH_FAULTS:
        got = window(fault)
        readings[fault] = dict(errors=local_leaf_errors(got, correct),
                               digest=replicated_digest(got))
        del got
    readings[None] = dict(digest=replicated_digest(correct))
    planted, gathered = gather_fed_state(st, mesh), \
        gather_fed_state(correct, mesh)
    del st, correct
    if mesh.rank == 0:
        all_toks = torch.as_tensor(train._chunk_tokens(cfg, args, first,
                                                       stop), device="cuda")
        all_masks = torch.as_tensor(sched.precompute(stop).active,
                                    device="cuda")
        out = planted
        for i, it in enumerate(range(first, stop)):
            out = train._step(cfg, args, hyper, out,
                              {"tokens": all_toks[i],
                               "val_tokens": all_toks[i]},
                              all_masks[it], it)
        ints = all(torch.equal(getattr(gathered, k).active,
                               getattr(out, k).active)
                   and torch.equal(getattr(gathered, k).age,
                                   getattr(out, k).age)
                   for k in ("cuts", "cuts_i"))
        readings[None]["unsharded"] = (
            leaf_diffs(gathered, out, exact_ints=False), ints)
        del out
    del planted, gathered
    return readings


def mesh_training_leg(mesh):
    """19 (a) on one rank: xLSTM-125M at full size on phase 16 (a)'s
    settings, the federation split over `mesh`."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import cut_eval as K
    from repro_torch.launch import train
    from repro_torch.utils.tree import tree_map

    cfg = get_config("xlstm-125m")
    args = train_args("--steps", str(TRAIN_ITERATIONS), "--t-pre",
                      str(TRAIN_T_PRE), "--log-every", str(TRAIN_CHUNK),
                      "--lr", str(TRAIN_LR), "--scan-chunk",
                      str(TRAIN_CHUNK), "--mesh-workers", str(mesh.size))
    meter, calls = MeshMeter(), []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    mesh.reset_traffic()
    mesh.profile = True
    t0 = time.perf_counter()
    with meter.installed(), recorded_val_calls(calls):
        res = train.run_afto_on_mesh(mesh, cfg, args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    traffic, calls_n = dict(mesh.traffic), dict(mesh.calls)
    seconds = dict(mesh.seconds)
    mesh.profile = False
    peak = torch.cuda.max_memory_allocated()
    route = None
    if mesh.rank == 0:
        route = route_calls_check("19 (a) rank 0's validation forwards",
                                  calls)
    n_calls = len(calls)
    del calls
    faults = fault_windows(mesh, cfg, args, meter.after_refresh)
    meter.after_refresh = None
    return dict(
        history=res["history"], digest=replicated_digest(res["state"]),
        state=tree_map(lambda x: x.cpu(), res["state"])
        if mesh.rank == 0 else None,
        step_ms=meter.step_ms, refresh_ms=meter.refresh_ms,
        step_launches=meter.launches, cuts=meter.cuts_after_refresh,
        resident=meter.resident, launches=launches, traffic=traffic,
        calls=calls_n, reduce_s=seconds, wall=wall, peak=peak, route=route,
        val_calls=n_calls, faults=faults)


def stage_args(mode, mesh_size=None):
    return train_args(*MESH_STAGE_ARGS, "--lr", str(TRAIN_LR), "--cut-mode",
                      mode, device="cuda", mesh_workers=mesh_size)


@contextlib.contextmanager
def vmapped_in_pairs():
    """The unsharded step and refresh with their worker vmap
    (`trilevel_llm._per_worker`) run over blocks of 2 rows, as each of 2
    ranks runs it, and every sum over the workers still taken over all
    of them."""
    import torch
    from repro_torch.fed import trilevel_llm as fed

    per_worker0 = fed._per_worker
    fed._per_worker = lambda fn, *stacked: torch.func.vmap(
        fn, chunk_size=2)(*stacked)
    try:
        yield
    finally:
        fed._per_worker = per_worker0


def one_ulp_up(st):
    """`st` with its weights (X3, z3) one ulp up: 16 (c)'s witness."""
    import torch
    from repro_torch.utils.tree import tree_map

    up = lambda x: torch.nextafter(x, torch.full_like(x, np.inf))
    return dataclasses.replace(st, X3=tree_map(up, st.X3),
                               z3=tree_map(up, st.z3))


def mesh_stage_legs(world, nccl, planted):
    """19 (b) on one rank: each planted state's 4 iterations on the
    job's mesh and on the 1-rank NCCL mesh of its first rank, beside
    which the second rank runs the card's unsharded 4 iterations; then
    the witnesses, unsharded too: the second rank's with the worker vmap
    over blocks of 2 rows (`vmapped_in_pairs`), the first rank's from
    weights one ulp up (`one_ulp_up`)."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import cut_eval as K
    from repro_torch.launch import train
    from repro_torch.utils.tree import tree_map

    out, unsharded, witness = {}, {}, {}

    def unsharded_run(cfg, mode, state):
        res = train.run_afto(cfg, stage_args(mode), state=tree_map(
            lambda x: x.to("cuda"), state))
        return tree_map(lambda x: x.cpu(), res["state"])

    for (arch, mode), state in planted.items():
        cfg = reduced(get_config(arch))
        for mesh in (world, nccl):
            if not mesh.member:
                unsharded[(arch, mode)] = unsharded_run(cfg, mode, state)
                with vmapped_in_pairs():
                    witness[(arch, mode, "pairs")] = unsharded_run(
                        cfg, mode, state)
                continue
            K.reset_launches()
            mesh.reset_traffic()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = train.run_afto_on_mesh(mesh, cfg, stage_args(
                mode, mesh.size), state=state)
            torch.cuda.synchronize()
            out[(arch, mode, mesh.size, mesh.backend)] = dict(
                seconds=time.perf_counter() - t0,
                traffic=dict(mesh.traffic), launches=dict(K.LAUNCHES),
                history=res["history"], digest=replicated_digest(
                    res["state"]),
                state=tree_map(lambda x: x.cpu(), res["state"])
                if mesh.rank == 0 else None)
            if mesh is nccl:
                witness[(arch, mode, "ulp")] = unsharded_run(
                    cfg, mode, one_ulp_up(state))
    return out, unsharded, witness


def llm_mesh_rank(world):
    """Phase 19 on one rank of the LLM_MESH_RANKS-rank gloo job sharing
    the card: the rank plants (b)'s states of one arch and hands them to
    the other, then runs (a) on the job's mesh, then (b) on it and on
    the 1-rank NCCL mesh of the first rank."""
    started = time.time()
    import torch
    from repro_torch.launch.mesh import make_worker_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nccl = make_worker_mesh(1, backend="nccl", device="cuda")
    # each rank plants one arch's states, and each hands them to the other
    mine = planted_stage_states(MESH_STAGE_ARCHS[world.rank::world.size])
    planted = {}
    for src in range(world.size):
        planted.update(world.broadcast_object(mine, src=src))
    planted = {k: planted[k] for k in sorted(planted)}
    planted_at = time.time()
    t0 = time.perf_counter()
    a = mesh_training_leg(world)
    t_a = time.perf_counter() - t0
    b, unsharded, witness = mesh_stage_legs(world, nccl, planted)
    return {"started": started, "planted": planted_at,
            "a": a, "b": b, "unsharded": unsharded, "witness": witness,
            "a_s": t_a, "b_s": time.perf_counter() - t0 - t_a}


MESH_STAGE_ARCHS = ("llama3-8b", "xlstm-125m")


def planted_stage_states(archs):
    """19 (b)'s planted states of `archs` (one refresh's cuts active in
    both polytopes, then `plant`), on the host."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.fed import trilevel_llm as fed
    from repro_torch.launch import train
    from repro_torch.utils.tree import tree_map

    planted = {}
    for arch in archs:
        cfg = reduced(get_config(arch))
        for mode in ("exact", "sketch"):
            args = stage_args(mode)
            hyper, st, _, _ = train._afto_setup(cfg, args)
            toks = torch.as_tensor(train._chunk_tokens(cfg, args, 0, 1)[0],
                                   device="cuda")
            batch = {"tokens": toks, "val_tokens": toks}
            st = train.afto_llm_step(cfg, hyper, st, batch,
                                     torch.ones(args.workers, device="cuda"))
            st = train.cut_refresh_llm(cfg, hyper, st, batch)
            st = plant(st, args.workers, {
                name: fed.eval_llm_cuts(hyper, getattr(st, name), st.z1,
                                        st.z2, st.z3, st.X2, st.X3, seed)
                for name, seed in (("cuts", hyper.seed_ii),
                                   ("cuts_i", hyper.seed_i))})
            check(float(st.cuts.active.sum()) >= 1
                  and float(st.cuts_i.active.sum()) >= 1,
                  f"19 (b) {arch} {mode}: a planted polytope without an "
                  "active cut")
            planted[(arch, mode)] = tree_map(lambda x: x.cpu(), st)
    return planted


def block_errors(got, want):
    """{name: (max |got - want|, max |want|)} over the floating leaves of
    two states, cut active / age exact; the leaves of each cut block of
    ROADMAP.md Queue 3 item 16 ("cuts/b3", ...) taken as one vector, as
    sketch mode stores the block (in exact mode a per-leaf measure
    divides each leaf's rounding by that leaf's own move)."""
    import torch
    from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path

    blocks = {k for arch in CARD_CPU_TOL for k in CARD_CPU_TOL[arch]
              if k != "rest"}
    out = {}
    for (path, g), w in zip(tree_leaves_with_path(got), tree_leaves(want)):
        name = "/".join(str(e[0]) for e in path)
        g, w = g.cpu().double(), w.cpu().double()
        if name.endswith(("active", "age")):
            check(torch.equal(g, w), f"19 (b): {name} differs")
            continue
        block = "/".join(name.split("/")[:2])
        key = block if block in blocks else name
        num = float((g - w).abs().max()) if w.numel() else 0.0
        den = float(w.abs().max()) if w.numel() else 0.0
        old = out.get(key, (0.0, 0.0))
        out[key] = (max(old[0], num), max(old[1], den))
    return out


def relative_errors(blocks):
    """{name: max |diff| / max |want|} from `block_errors`' pairs."""
    return {k: num / den if den else 0.0 for k, (num, den) in blocks.items()}


def cut_leaf_worst(got, want):
    """{cut block: (leaf, its max |diff| / the leaf's own max |want|)}:
    the per-leaf measure, each block's worst leaf."""
    blocks = {k for arch in CARD_CPU_TOL for k in CARD_CPU_TOL[arch]
              if k != "rest"}
    out = {}
    for name, err in leaf_diffs(got, want, exact_ints=False):
        block = "/".join(name.split("/")[:2])
        if block in blocks and err >= out.get(block, ("", -1.0))[1]:
            out[block] = (name, err)
    return out


def mesh_traffic(got, cfg, args, steps, refreshes):
    """(the bytes a rank all-reduced by label, `llm_traffic`'s for
    `steps` steps and `refreshes` refreshes, `llm_traffic`'s record)."""
    from repro_torch.fed.trilevel_llm_sharded import llm_traffic
    from repro_torch.launch import train

    rec = llm_traffic(cfg, train.afto_hyper(args), args.mesh_workers,
                      args.batch, args.seq, device="cuda")
    want = {"step": steps * rec["step_bytes"],
            "refresh": refreshes * rec["refresh_bytes"]}
    return {k: got.get(k, 0) for k in want}, want, rec


def stage_limit(arch, name):
    block = "/".join(name.split("/")[:2])
    return CARD_CPU_TOL[arch].get(block, CARD_CPU_TOL[arch]["rest"])


def llm_mesh_phase(rows):
    """Phase 19: the LLM federation over a worker mesh
    (`launch.train --mesh-workers`).  Every reading is printed before
    the gates are read."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.fed import sharding as shd
    from repro_torch.fed import trilevel_llm as fed
    from repro_torch.launch import train
    from repro_torch.launch.mesh import AbstractMesh, spawn_mesh
    from repro_torch.utils.tree import tree_leaves, tree_map

    t0, wall0 = time.perf_counter(), time.time()
    torch.cuda.empty_cache()
    ranks = spawn_mesh("chip_smoke:llm_mesh_rank", LLM_MESH_RANKS,
                       backend="gloo", device="cuda", pythonpath=[str(ROOT)],
                       timeout=LLM_MESH_TIMEOUT)
    in_job = max(r["started"] for r in ranks) - wall0
    planted_at = max(r["planted"] for r in ranks) - wall0
    unsharded = ranks[1]["unsharded"]
    totals, gates = {}, []

    def gate(ok, msg):
        if not ok:
            gates.append(msg)

    # ---- (a)
    legs = [r["a"] for r in ranks]
    a = legs[0]
    cfg = get_config("xlstm-125m")
    args = train_args("--steps", str(TRAIN_ITERATIONS), "--t-pre",
                      str(TRAIN_T_PRE), "--mesh-workers",
                      str(LLM_MESH_RANKS))
    for r, leg in enumerate(legs):
        for k, v in leg["launches"].items():
            totals[k] = totals.get(k, 0) + v
        gate(leg["step_launches"] == 0, f"19 (a) rank {r}: steps and "
             f"refreshes launched {leg['step_launches']} kernels")
        gate(all(x >= 1 and y >= 1 for x, y in leg["cuts"]),
             f"19 (a) rank {r}: a polytope without an active cut after a "
             f"refresh: {leg['cuts']}")
        gate(leg["digest"] == a["digest"], "19 (a): the ranks' gathered "
             "states differ")
    gate(a["launches"].get("mlstm_chunk", 0) > 0 and a["val_calls"] > 0,
         f"19 (a): rank 0's validation forwards launched {a['launches']}")
    want_h = PHASE16["history"]
    gate([h["step"] for h in a["history"]] == [h["step"] for h in want_h],
         "19 (a): the logged steps differ from phase 16 (a)'s")
    loss_rel = max(abs(g["loss"] - w["loss"]) / abs(w["loss"])
                   for g, w in zip(a["history"], want_h))
    gate(loss_rel <= MESH_LOSS_RTOL, f"19 (a): losses {loss_rel:.3e} from "
         f"phase 16 (a)'s (gate {MESH_LOSS_RTOL})")
    for g, w in zip(a["history"], want_h):
        gate(np.isfinite(g["loss"]) and g["cuts"] == w["cuts"]
             and g["sim_time"] == w["sim_time"],
             f"19 (a): the loss, cut count or sim_time at step {g['step']}")
    diffs = leaf_diffs(tree_map(lambda x: x.to("cuda"), a["state"]),
                       PHASE16["state"], label="19 (a)")
    worst = max(diffs, key=lambda x: x[1])
    gate(worst[1] <= MESH_TRAIN_TOL, f"19 (a): {worst[0]} at "
         f"{worst[1]:.3e} of its largest magnitude in phase 16 (a)'s "
         f"state (gate {MESH_TRAIN_TOL})")
    fault_reads = {}
    for fault in MESH_FAULTS:
        per = [leg["faults"][fault]["errors"] for leg in legs]
        reading = max((max(e[i][1] for e in per)
                       / max(max(e[i][2] for e in per), 1e-300), e0[0])
                      for i, e0 in enumerate(per[0]))
        split = len({leg["faults"][fault]["digest"] for leg in legs}) > 1
        fault_reads[fault] = (reading, split)
        gate(reading[0] > MESH_TRAIN_TOL or split,
             f"19 (a): the planted fault '{MESH_FAULTS[fault]}' reads "
             f"{reading[0]:.3e} ({reading[1]}), within the gate "
             f"{MESH_TRAIN_TOL}, and leaves the ranks' replicated leaves "
             "equal: the checks cannot see it")
    gate(len({leg["faults"][None]["digest"] for leg in legs}) == 1,
         "19 (a): the correct fault window's ranks differ")
    window_diffs, window_ints = a["faults"][None]["unsharded"]
    window_worst = max(window_diffs, key=lambda x: x[1])
    gate(window_ints, "19 (a): the correct fault window's cut active / "
         "age differ from the unsharded window's")
    gate(window_worst[1] <= MESH_TRAIN_TOL, f"19 (a): the correct fault "
         f"window's {window_worst[0]} at {window_worst[1]:.3e} of its "
         f"largest magnitude in the unsharded window's (gate "
         f"{MESH_TRAIN_TOL})")
    rec = [mesh_traffic(leg["traffic"], cfg, args, TRAIN_ITERATIONS,
                        TRAIN_ITERATIONS // TRAIN_T_PRE) for leg in legs]
    for r, (seen, want, _) in enumerate(rec):
        gate(seen == want, f"19 (a) rank {r}: all-reduced bytes {seen} != "
             f"llm_traffic's {want}")
    template = fed.init_fed_state(cfg, train.afto_hyper(args),
                                  torch.Generator(), args.batch,
                                  args.seq - 1, device="meta")
    layout = shd.local_bytes(template, shd.llm_worker_specs(
        template, LLM_MESH_RANKS), AbstractMesh(("data",), (LLM_MESH_RANKS,)))
    for r, leg in enumerate(legs):
        gate(leg["resident"] == layout, f"19 (a) rank {r}: the state holds "
             f"{leg['resident']:,} bytes, the layout's local_bytes "
             f"{layout:,}")
    step_ms = [float(np.mean(leg["step_ms"][1:])) for leg in legs]
    share = [sum(leg["reduce_s"].get(k, 0.0) for k in ("step", "refresh"))
             / ((sum(leg["step_ms"]) + sum(leg["refresh_ms"])) / 1e3)
             for leg in legs]
    terms = rec[0][2]
    print(f"  19 (a) xLSTM-125M at full size (bf16), N {args.workers} on "
          f"{LLM_MESH_RANKS} gloo ranks sharing the card, phase 16 (a)'s "
          f"settings, {TRAIN_ITERATIONS} iterations in chunks of "
          f"{TRAIN_CHUNK}: losses "
          f"{[round(h['loss'], 4) for h in a['history']]} (phase 16 (a)'s "
          f"chunked run {[round(h['loss'], 4) for h in want_h]}, worst "
          f"relative {loss_rel:.3e}, gate {MESH_LOSS_RTOL}); gathered state "
          f"against phase 16 (a)'s: worst leaf {worst[0]} {worst[1]:.3e} of "
          f"its largest magnitude (gate {MESH_TRAIN_TOL}); active cuts (II, "
          f"I) after each refresh {a['cuts']}; ranks' gathered states "
          f"{'equal' if a['digest'] == legs[1]['digest'] else 'differ'}",
          flush=True)
    print("  19 (a) planted faults over " + str(MESH_FAULT_ITERATIONS)
          + (" iteration" if MESH_FAULT_ITERATIONS == 1 else " iterations")
          + " from the state after the first refresh (planted: "
          "binding cuts, lam and theta live): the correct window against "
          "the same window unsharded (afto_llm_step from the gathered "
          f"planted state): worst leaf {window_worst[0]} "
          f"{window_worst[1]:.3e} (gate {MESH_TRAIN_TOL}); against the "
          "correct window: "
          + "; ".join(
              f"{MESH_FAULTS[f]}: worst leaf {r[1]} {r[0]:.3e}"
              + (", replicated leaves differ across ranks" if split else "")
              for f, (r, split) in fault_reads.items()), flush=True)
    print(f"  19 (a) rank 0's validation forwards: {a['val_calls']} kernel "
          f"calls held to their plain versions (worst row_rel_err "
          f"{a['route'][0]:.3e}, gate {ROUTE_ROW_TOL['mlstm_chunk']}; a "
          f"planted key-tile fault at least {a['route'][2]:.3e}); launches "
          + ", ".join(f"rank {r} {leg['launches']}"
                      for r, leg in enumerate(legs))
          + f"; steps and refreshes launched "
          f"{sum(leg['step_launches'] for leg in legs)}", flush=True)
    print(f"  19 (c) ({CARD}) ms per iteration "
          + " / ".join(f"{v:.1f}" for v in step_ms)
          + f" (ranks 0 / 1, mean of {len(a['step_ms']) - 1} steps, the "
          f"first {a['step_ms'][0]:.1f}; phase 16 (a) unsharded "
          f"{PHASE16['ms_it']:.1f}), ms per refresh " + " / ".join(
              "[" + ", ".join(f"{v:.1f}" for v in leg["refresh_ms"]) + "]"
              for leg in legs)
          + f" (phase 16 (a) {PHASE16['ms_ref']:.1f}); share of the steps'"
          " and refreshes' wall time in all-reduces (device synchronised "
          "first) " + " / ".join(f"{v:.1%}" for v in share)
          + "; all-reduce seconds " + " / ".join(
              str({k: round(v, 3) for k, v in leg["reduce_s"].items()})
              for leg in legs)
          + f"; bytes per rank {a['traffic']} (llm_traffic: "
          f"{TRAIN_ITERATIONS} x step {terms['step_bytes']:,}, "
          f"{TRAIN_ITERATIONS // TRAIN_T_PRE} x refresh "
          f"{terms['refresh_bytes']:,}: {terms['refresh_terms']}); "
          f"resident state {layout:,} bytes a rank (local_bytes of the "
          "layout); peak max_memory_allocated "
          + " / ".join(f"{leg['peak'] / 2 ** 30:.2f}" for leg in legs)
          + f" GiB (phase 16 (a) unsharded {PHASE16['peak']:.2f})",
          flush=True)

    # ---- (b)
    b = ranks[0]["b"]
    witness = {**ranks[0]["witness"], **ranks[1]["witness"]}
    readings, witnessed = [], []
    for key, leg in b.items():
        arch, mode, size, backend = key
        label = f"19 (b) {arch} {mode}, {size} {backend} rank(s)"
        scfg = reduced(get_config(arch))
        sargs = stage_args(mode, size)
        for r in ranks:
            if key not in r["b"]:
                continue
            for k, v in r["b"][key]["launches"].items():
                totals[k] = totals.get(k, 0) + v
            gate(r["b"][key]["digest"] == leg["digest"],
                 f"{label}: the ranks' gathered states differ")
            seen, want, _ = mesh_traffic(r["b"][key]["traffic"], scfg,
                                         sargs, 4, 1)
            gate(seen == want, f"{label}: all-reduced bytes {seen} != "
                 f"llm_traffic's {want}")
        want = unsharded[(arch, mode)]
        seen_by = {w: relative_errors(block_errors(
            witness[(arch, mode, w)], want)) for w in STAGE_WITNESSES}
        worst_b = (0.0, "", 0.0)
        for name, err in relative_errors(block_errors(
                leg["state"], want)).items():
            lim = stage_limit(arch, name)
            gate(err <= lim, f"{label}: {name} at {err:.3e} of its largest "
                 f"magnitude in the card's unsharded run (gate {lim})")
            worst_b = max(worst_b, (err / lim, name, err))
            if err <= STAGE_WITNESS_FLOOR:
                continue
            seen = max(v[name] for v in seen_by.values())
            gate(err <= TRAJECTORY_OVER_ULP * seen, f"{label}: {name} at "
                 f"{err:.3e}, more than {TRAJECTORY_OVER_ULP} x the "
                 f"witnesses' {seen:.3e}")
            if size > 1:
                witnessed.append(
                    f"{arch} {mode} {name} {err:.2e} (" + ", ".join(
                        f"{w} {v[name]:.2e}" for w, v in seen_by.items())
                    + ")")
        if size > 1 and mode == "exact":
            per_leaf = {w: cut_leaf_worst(witness[(arch, mode, w)], want)
                        for w in STAGE_WITNESSES}
            mine = cut_leaf_worst(leg["state"], want)
            witnessed.append(f"{arch} {mode} per leaf: " + ", ".join(
                f"{blk} {v[1]:.2e} ({v[0]}; " + ", ".join(
                    f"{w} {per_leaf[w][blk][1]:.2e}" for w in per_leaf)
                + ")" for blk, v in mine.items()))
        bitwise = all(x.dtype == y.dtype and torch.equal(x, y)
                      for x, y in zip(tree_leaves(leg["state"]),
                                      tree_leaves(want)))
        readings.append(f"{arch} {mode} {size} {backend}: worst against its "
                        f"limit {worst_b[1]} {worst_b[2]:.2e} "
                        f"({worst_b[0]:.2f} of the limit)"
                        + (", bitwise" if bitwise else ", not bitwise")
                        + f", {leg['seconds']:.1f} s")
    print("  19 (b) reduced llama3-8b / xlstm-125m (f32), N 4, 4 iterations "
          "and one refresh from a planted state (a refresh's cuts active, "
          f"lam {MESH_PLANTED_LAM} and stale_lam {MESH_PLANTED_STALE_LAM} on "
          "them, each violated by 1, theta's rows within "
          f"{MESH_PLANTED_THETA}), each held to the card's unsharded run "
          "from the same state, run by the second rank beside the first's "
          "NCCL legs (every leaf of the gathered state against its largest "
          "magnitude, each cut block of Queue 3 item 16 as one vector, at "
          "its arch's CARD_CPU_TOL limits; cut active / age exact; bytes "
          "per label = llm_traffic's): "
          + "; ".join(readings), flush=True)
    print("  19 (b) witnesses, the card's unsharded run with the worker vmap "
          "over blocks of 2 rows (pairs) and from weights one ulp up (ulp), "
          "each against the unsharded run: every reading of the 2-rank legs "
          f"above {STAGE_WITNESS_FLOOR} (beside it the witnesses'; gate "
          f"{TRAJECTORY_OVER_ULP} x the larger): "
          + "; ".join(witnessed) + (" (none)" if not witnessed else ""),
          flush=True)
    for k in KERNELS:
        rows[k]["launches_phase19"] = int(totals.get(k, 0))
    took = time.perf_counter() - t0
    print(f"phase 19 (the LLM federation over a worker mesh, {LLM_MESH_RANKS}"
          f" gloo ranks on the card and a 1-rank NCCL mesh): {took:.1f} s "
          f"(every rank in its job {in_job:.1f} s and (b)'s states planted "
          f"{planted_at:.1f} s after the spawn; (a) {ranks[0]['a_s']:.1f} s, "
          f"(b) {ranks[0]['b_s']:.1f} s; budget {PHASE19_S:.0f} s, read, not "
          "gated); launches "
          + (", ".join(f"{k} {v}" for k, v in sorted(totals.items()))
             or "none"), flush=True)
    check(not gates, "phase 19: " + "; ".join(gates))


# past this many seconds every thread's stack goes to standard error, so
# that a run stopped at its time limit shows where it was
WATCHDOG_S = 900.0
CLOCK0 = time.perf_counter()


def clocked(label, fn, *args):
    """fn(*args), its seconds and the script's clock printed to standard
    output and (for a run that is cut) standard error."""
    t0 = time.perf_counter()
    print(f"[clock] {label} starts at {t0 - CLOCK0:.1f} s", file=sys.stderr,
          flush=True)
    out = fn(*args)
    t1 = time.perf_counter()
    msg = f"[clock] {label}: {t1 - t0:.1f} s, ends at {t1 - CLOCK0:.1f} s"
    print(msg, flush=True)
    print(msg, file=sys.stderr, flush=True)
    return out


def main() -> None:
    import faulthandler

    if not (SRC / "repro_torch").is_dir():
        fail("src/repro_torch is not beside chip_smoke.py: run it from a "
             "checkout of the repository")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=False)
    smi = clocked("phase 1", environment)
    rows = clocked("phase 2", kernel_phase)
    clocked("phase 3", fused_phase, rows)
    # phase 11's kernel checks, beside phases 2 and 3 (its sweeps need
    # phases 4 and 10 first)
    clocked("phase 11 kernels", batched_kernel_phase, rows)
    ww_ms, ww_specs = clocked("phase 4", slice_phase, rows)
    da_ms, da_launches, da_spec = clocked("phase 5", da_phase, rows)

    def phase6():
        profile_phase("white-wine, cut kernels (two refreshes)",
                      ww_specs["kernel"])
        profile_phase("white-wine, fused kernel (two refreshes)",
                      ww_specs["fused"])
        profile_phase("domain adaptation, fused kernel (one refresh)",
                      da_spec)

    clocked("phase 6", phase6)
    clocked("phase 7", llm_kernel_phase, rows)
    clocked("phase 8", llama_phase, rows)
    clocked("phase 15", gemma_phase, rows)
    clocked("phase 9", xlstm_phase, rows)
    clocked("phase 17", moe_phase, rows)
    profiled = clocked("phase 10", paper_phase)
    sweep_spec = clocked("phase 11 sweeps", sweep_phase, rows, ww_specs)
    stream_spec = clocked("phase 12", stream_phase, rows, ww_specs)
    async_spec = clocked("phase 13", async_phase, rows, ww_specs, ww_ms)
    # phase 18's counts run on meta tensors in two processes beside
    # phases 14 and 16
    counting = start_counts()
    clocked("phase 14", mesh_phase, rows, ww_ms, ww_specs)
    clocked("phase 16", training_phase, rows)
    clocked("phase 18", dryrun_phase, counting)
    clocked("phase 19", llm_mesh_phase, rows)

    def late_profiles():
        # under the profiler after every timed run: it slows later host
        # launches
        for label, run in profiled.items():
            profile_run(label, run)
        profile_phase("white-wine sweep of 2 (AFTO, seeds 0 and 1), "
                      "batched cut kernels (two refreshes)", sweep_spec)
        profile_phase(f"streamed quadratic, dim {STREAM_DIM:,}, cut "
                      "kernels (four refreshes)", stream_spec)
        profile_phase("white-wine async runtime, 6 worker threads, cut "
                      "kernels (two refreshes)", async_spec)

    clocked("the later profiles", late_profiles)
    faulthandler.cancel_dump_traceback_later()
    print("ms/iteration, mean of two runs per route: white-wine "
          + ", ".join(f"{k} {v:.3f}" for k, v in ww_ms.items())
          + "; domain adaptation "
          + ", ".join(f"{k} {v:.3f}" for k, v in da_ms.items()))
    print("domain-adaptation launches (fused route): " + ", ".join(
        f"{k} {da_launches.get(k, 0)}" for k in KERNELS))
    print(json.dumps({"kernels": [rows[k] for k in KERNELS]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
