#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device  - require CUDA; print the card's name and power limit;
2. build   - build the seven kernels from ``src/repro_torch/kernels/csrc``,
             one ``nvcc`` per source, started together; print each
             kernel's registers, spills and shared memory;
3. kernel  - hold the fan-in kernel against its plain PyTorch version on
             the card, bit for bit: its per-slot entry (``seg_fanin_rows``)
             on each case's per-slot inputs, and its grouped entry
             (``FaninGroups``, the main path's) on the step's own layout;
             the batch shapes (F = 24,
             256, 1024 slots, rows = cells x 8) with the main path's
             groups and a ragged layout, Paxos's segments of 1, one
             segment of 1024, padded groups of size 0 (with and without a
             tail), the WAN scenarios' per-region groups (F = 48 with
             16/16/16, F = 100 with 34/33/33, crossing 32-slot windows),
             the backend override's layouts (Table 2's N = 5: F = 4 as
             [4] and [2, 2], unpadded; Fig. 8's N = 49 at R = 7 and
             N = 101 at R = 10), the megagrid study's group layouts
             (F = 8, 16, 24: Paxos and R = 1 to 8 padded to the bucket's
             group count, N = 5 in F = 8 with a tail; 4,096-cell chunks
             at B = 4 and 8), ties, masked
             slots and a fully masked segment; one launch a call
             (``launches`` moving by one);
4. timing  - both entries at each batch grid's shape (384 x 1024,
             2048 x 256, 1536 x 24) on the same inputs: device ms a
             launch (200 launches captured once in a CUDA graph and
             replayed: the replay's output equals an eager launch's),
             host-launched ms a call (200 calls from Python), each entry's
             bound, the plain version, and an empty kernel's graph-replay
             time, the floor of a launch;
5. main    - ``scale/batch/N=1025/R=32``, ``N=257/R=16`` and
             ``replicates/R=3`` at their full grids through
             ``repro_torch.experiments.runner.run_scenarios`` on cuda; every
             scan step launches the sm90 fan-in once (``launches ==
             scan_steps``), and R=3's mean throughput must sit inside its
             ``benchmarks/reference_bounds.json`` window; a quick N=1025
             run under ``torch.profiler`` counts the device kernels a scan
             step;
6. check   - R=3 in quick mode: kernel run == plain-version run on the card
             (bit-identical), a rerun is bit-identical, and the card agrees
             with the CPU within the parity tolerance;
36. draws  - (run after phase 4) the threefry draws kernel
             (``threefry_draws_sm90.cu``) against the composition of
             ``prng`` calls at pig25.montecarlo's block (24,576 cells, B 8,
             G 3, F 24, one step), bit for bit, and its exponential over
             all 2**23 uniforms against torch's; device ms a launch (200
             captured in a CUDA graph) beside its bounds (46.4 MB of
             output at 3.35 TB/s, its INT32 operations at the card's INT32
             rate) and the plain composition's ms; the kernel's EPaxos
             entry the same way at epaxos25.montecarlo's block (393,216
             cells, n 25, one step) against ``ref.epaxos_draws_ref``;
             phases 5, 17, 20, 22, 31 and 33 check ``draw_launches ==
             draw_blocks`` on every grid, group and EPaxos, and print
             them;
17. branches - (run after phase 6, with the batch path) the 14 scenarios of
             the group kernel's other branches (``wan/*``, ``avail/*``,
             ``batching/*``, ``obs/*``, ``reads/*``) at their full grids
             through ``run_scenarios`` on cuda: ``launches ==
             scan_steps`` for each, no cell exhausted or
             non-finite, the gate's speedup floors on the port's own pairs
             (``batching/paxos/m=8/batch`` >= 2x ``m=1/batch``,
             ``reads/paxos/lease/r=0.9/batch`` >= 2x ``log/r=0.9/batch``)
             and ``obs/pigpaxos/backlog/batch``'s quick-mode mean
             throughput inside its ``reference_bounds.json`` window; per
             scenario the cells, scan steps, launches, wall, cells/s,
             ms/step, mean throughput and the timeline/obs/rw shapes;
18. bcheck - one quick scenario of each branch (batching m=8, wan/N=25,
             avail/relay, reads lease, obs): the card run == a rerun ==
             the plain fan-in's run on the card, bit for bit, extras
             included, and the card agrees with the CPU within phase 6's
             tolerance (extras: timeline buckets and read/write counts
             within one, backlog and read/write means rel 1e-5).
19. efanin - (run after phase 18, with the batch path) the sm90 per-slot
             entry ``seg_fanin_rows`` against its plain version, bit for
             bit, at the EPaxos layouts: one segment of F = 5, 9, 17, 25,
             49 slots a row with the coordinator's slot +inf, caps fq - 2
             and majority - 2, ties, rows = 8 cells (a conflict grid) and
             4,096 (a megagrid chunk); timed (graph replay, host-launched,
             the interface's bound and the EPaxos path's, plain version)
             at 8 x 25 and 4,096 x 17;
20. conflict - the 8 ``conflict/*/batch`` full grids through
             ``run_scenarios`` on cuda: ``launches == 2 x scan_steps``
             (and the runner's own count), no cell exhausted or
             non-finite, ``conflict/N=25/c=0.1/batch``'s quick mean
             throughput inside its ``reference_bounds.json`` window;
21. ccheck - quick ``conflict/N=25/c=0.1/batch`` and a zipfian EPaxos
             grid: card == rerun == the plain fan-in's run on the card, bit
             for bit, and card vs CPU within phase 6's tolerance;
22. megagrid - the 4 ``megagrid/slice/*`` full grids (one launch a scan
             step) with their three quick gate windows;
             ``simulate_grid_sharded`` in 64-cell chunks == one
             ``simulate_grid`` call, bit for bit, on a group and an EPaxos
             bucket of the study; one 4,096-cell chunk of a group bucket
             of each width (F = 8, 16, 24) and of an EPaxos bucket through
             the sm90 fan-in == through the plain one, bit for bit (two
             launches an EPaxos scan step, one a group one, none in the
             plain run); then ``run_megagrid`` at the full axes
             and 2**16 cells (every bucket of the 1,000,000-cell study,
             whose CLI run takes ~280 s): per bucket cells,
             scan steps, retries,
             wall and host stacking seconds, the launches (one a group
             scan step, two an EPaxos one), no cell exhausted after retry,
             the roofline note;
23. jaxsim - ``relay_load_mc(25, 3, 8192)`` on the card == the CPU's, bit
             for bit; ``latency_curve`` within 1e-6 relative.
31. figures - (run after phase 23, with the batch path) the 44
             discrete-event scenarios marked ``batch_ok`` through
             ``run_scenarios(..., backend_override="batch")`` on cuda:
             Fig. 8's 20 and Tables 1-2's 4 at their full grids (the
             paper's), zipf, conflict, wan and avail quick (every one,
             ``quick_skip`` too); per scenario
             the cells, scan steps, launches, wall, ms a step and mean
             throughput, with
             ``launches == scan_steps`` (EPaxos: 2 x), the switched
             spec in the artifact, no cell exhausted or non-finite; the
             report rows (``report.rows_for_artifact``: the tables'
             asserts of Eq. 1-3 against the measured loads), Fig. 8's best
             R (rotating must be 1; static printed), and the gate's seven
             quick-mode windows that name these scenarios;
32. fcheck - quick ``fig8/static/R=1``, ``table2/validate/R=2``,
             ``fig8/scale/N=101/R=10`` and ``avail/relay/N=49``: card ==
             rerun == the plain fan-in's run on the card, bit for bit,
             extras included; card vs CPU within phase 6's tolerance, or
             the cell's envelope (``FCHECK``: a static relay's latency
             envelope, a chaotic cell's tolerance).
33. gate  - (run after phase 32) the regression gate on the port: the
             discrete-event halves of ``reference_bounds.json``'s 8
             ``fidelity`` pairs and the bases of its 3 ``speedup`` floors
             (``reads/pigpaxos/{lease,log}/r=0.9`` besides) quick through
             ``run_scenarios`` on the host, one scenario a pool worker,
             and the pairs' ``/batch`` halves quick on cuda
             (``launches == scan_steps``, EPaxos 2 x): each batch/DES
             throughput ratio inside its window, each speedup floor on
             the DES halves, the quick ``bounds`` window of every
             scenario the phase runs, no audited unit in violation; the
             DES half of ``wan/N=25`` run again, bit for bit; per DES
             scenario its units, events, wall and events/s.
34. des    - (submitted when the pooled phases begin, to a second spawned
             pool of ``DES_WORKERS``, the costliest first; collected after
             phase 33) the 18 discrete-event scenarios of the failover and
             lease families, the overload cells with admission control
             and the traced and relay-fairness obs cells, quick (every
             one, ``quick_skip`` too) on the host: each a ``"des"``
             artifact run on the host, no audited unit in violation, the
             quick ``bounds`` windows of ``reference_bounds.json`` that
             name them, its ``overload`` goodput windows
             (``overload/paxos/{adm,latadm}``) and its ``obs_fairness``
             entry, held by the unchanged ``benchmarks/regression_gate``;
             ``obs/paxos/traced`` run again, bit for bit; the exact
             engine's sampled-tracing CPU overhead at rate 0.05 (paired
             minimum over 6 interleaved rounds, as
             ``benchmarks/sim_engine_bench.py``) under the gate's
             ``sim_engine.tracing_overhead_max``; the exact and seed
             engines' events/s; per scenario its unit walls, events and
             events/s, and the host CPU.
7. flash   - the sm90 flash_attention kernel against its plain version on
             the card in bf16 at granite-8b's prefill shape, granite at its
             max_seq_len, a ragged S, gemma-7b's head dim 256 and a
             non-causal Dh 64 case in (B, H, S, Dh), and through
             ``flash_attention_bshd`` on (B, S, H, Dh) tensors at granite's
             prefill shape, a ragged S and S = 1: within 2e-3 + 1.6e-2
             |plain|, one launch a call (of the sm90 kernel), a rerun
             bit-identical; the CUDA-core kernel (f32, Dh 32) at the first
             five cases in f32; ``ops.flash_attention`` at head dims no
             kernel takes, padded to the next (zamba2-7b's shared
             attention, 32 heads of 112, and h2o-danube's 80, bf16, S
             2048), within the same bound;
8. timing  - the sm90 kernel at granite's prefill shape beside its bound,
             the plain version, PyTorch's fused attention (the yardstick,
             which the port never calls) and the CUDA-core kernel on the
             same inputs; ``ops.flash_attention`` on the model's layout
             beside the same kernel behind transposes and copies, and at
             zamba2-7b's shared attention (4, 2048, 32 heads, Dh 112
             padded to 128) beside the bounds of the Dh-112 and of the
             padded work, the plain version and SDPA at Dh 112;
9. serve   - granite-8b at full width (36 layers, random bf16 weights from a
             seed): 4 prompts of 2048 tokens prefilled and 31 greedy decode
             steps through ``repro_torch.launch.serve.generate`` with
             ``impl="flash"``: the sm90 kernel launches once per layer;
10. check  - the same prefill through ``build_prefill_step`` with the plain
             attention (``impl="ref"``) agrees within a relative L2
             tolerance; the kernel agrees with the plain version on each
             layer's own attention inputs; the warm prefill and flash's share
             of it are printed; two flash prefills launch the kernel once
             per layer each and are bit-identical; decode steps launch it
             never, and
             one decode step is counted (aten operations) and traced
             (device kernels, busy time, idle share); granite-smoke's
             ``generate`` agrees between the card and the CPU (every
             serving phase drives its model through the same
             ``run_generate`` and checks its smoke config through the same
             ``check_smoke``);
11. pig    - pig_aggregate against its plain PyTorch version on the card,
             bit for bit, one launch a call, a rerun bit-identical: the
             three shapes of ``tests/test_kernels.py``, the relay's
             aggregate of granite-8b's largest gradient leaf on the
             multi-pod production mesh (2 x 8,257,536 int8), phase 13's
             largest leaf, all-zero blocks and -127/+127 extremes;
12. timing - pig_aggregate at the relay shape and at (4, 268,435,456)
             beside its bound and the plain version (no PyTorch call
             computes it);
13. sync   - a one-rank NCCL world (``repro_torch.launch.mesh``): granite-8b's
             gradient tree at full width, 12 of 36 layers (bf16, f32 norms,
             from a seed) through ``collectives.sync_grads`` with
             ``direct``, ``pig`` and ``pig_q8``: direct and pig return the
             input bit for bit, pig_q8 stays within half a quantization
             step (plus bf16 rounding) and out + residual recovers the
             input; pig_aggregate launches once a leaf; ``final_norm`` and
             ``layers.attn.wk`` equal the same calls on the CPU through a
             one-rank gloo group, bit for bit;
14. ssm    - both ssm_scan kernels against their plain PyTorch version on
             the card.  ssm_scan.cu: the eight cases of
             ``tests/test_kernels.py`` (four shapes x scalar or per-channel
             decay, inclusive mask, f32) and its bonus case;
             ssm_scan_sm90.cu: rwkv6-3b's prefill shape (B 4, T 2048, H 40,
             Dk = Dv 64, chunk 16, bf16 q/k/v, clamped f32 log_a, u, a
             non-zero s0), a ragged T = 1000, T = 5, the f32 path and the
             inclusive mask at Dv 128; y and the final state within the
             stated tolerance, one launch a call (``launches_sm90`` moving
             only for the sm90 kernel's cases), a rerun bit-identical; and
             ssm_scan.cu called directly at rwkv6-3b's prefill shape;
15. timing - both kernels at rwkv6-3b's prefill shape on the same inputs,
             beside their bounds (bytes; 3xTF32 operations; ssm_scan.cu's
             f32 operations on the CUDA cores) and the plain version (no
             PyTorch call computes it);
16. serve  - rwkv6-3b at full width (32 layers, random bf16 weights from a
             seed, LoRA-B drawn non-zero so that the decay depends on the
             data): 4 prompts of 2048 tokens and 31 greedy decode steps
             through ``generate`` (``impl="auto"``), ssm_scan_sm90 launching
             once a layer in the prefill and never in decode; a second kernel
             prefill is bit-identical; the kernel against the plain scan
             (``impl="ref"``) layer by layer on identical bf16 inputs and
             end to end on an f32 copy of the model, within the stated
             tolerances (the bf16 end-to-end gap is printed); the clamp's
             share per layer; rwkv6-smoke's ``generate`` agrees between the
             card and the CPU.

24. hybrid - zamba2-7b at full width (81 Mamba2 layers, the shared
             attention + MLP block after every 6th of the first 78: 13
             applications; random bf16 weights from a seed): 4 prompts of
             2048 tokens and 31 greedy decode steps through ``generate``
             (``impl="flash"``), the sm90 flash kernel launching 13 times
             (Dh 112 padded to 128) in the prefill and never in decode;
             prefill and decode ms, tokens/s, peak memory;
25. hcheck - two flash prefills bit-identical; each shared-attention
             application's kernel call against the plain version on its
             own inputs (phase 7's bound); the ``impl="ref"`` prefill's
             logits beside the flash one's (relative L2, printed); one
             decode step counted and traced as in phase 10; layer 0's
             Mamba2 block in f32, card vs CPU on identical inputs within
             ``MAMBA2_CARD_REL`` (no TF32); an f32 copy of the model end to
             end, flash vs ref, within ``HYBRID_F32_REL``; zamba2-smoke
             and its ``ssm`` variant card vs CPU;
26. moe    - qwen2-moe-a2.7b at full width (24 layers, 60 experts top-4
             and a shared expert, f32 router) served the same way (24
             launches a prefill, none in decode), the share of routed
             pairs dropped at capacity, two flash prefills bit-identical,
             each layer's attention kernel call against the plain version,
             the ``ref`` prefill's logits and routing beside the flash
             one's (printed), a decode step counted and traced; layer 0's
             MoE block in bf16, card vs CPU on identical inputs (the
             router's gates, the top-k sets outside near-ties, the output
             on the card's routing within the CPU tests' bf16 bound);
             qwen3-moe-235b-a22b at full width, 2 of its 94 layers (a
             prefill and 3 decode steps, flash at Dh 64, GQA 16, each
             launch's inputs then through the kernel and the plain
             version); qwen2-moe-smoke and qwen3-moe-smoke card vs CPU
             (bf16: the launches alone; f32: the values).
27. train  - rwkv6-3b trained at full width and depth (32 layers, random
             bf16 weights, the decay LoRA-B as in phase 16) through
             ``build_train_step`` with the JAX training CLI's options
             (remat, impl "auto", AdamW lr 3e-3, 10 warmup steps) on 3
             batches of 4 x 2048 from ``SyntheticLMStream``:
             ssm_scan_sm90 64 times a step (the forward and remat's
             recompute), no other kernel; the loss finite and within
             (0.1, 3) ln V; every parameter moved, ``opt.step`` 3; step 1
             run once more from the same state, bit-identical; one
             layer's scan through the autograd Function vs the plain
             version (y within phase 14's bound, input gradients
             bit-equal); an f32 copy at 4 layers, impl auto vs ref (loss
             and gradients); warm step ms, tokens/s, 6 N tokens / (step x
             989 TFLOP/s), peak memory, the kernel's and the plain
             backward's shares of the step;
28. train  - h2o-danube-1.8b (the JAX training CLI's default arch, 24
             layers, sliding window 4096) trained the same way: the
             chunked plain attention, no kernel launch; the same figures;
             ``lm_loss(impl="flash")`` and ``ops.flash_attention`` on CUDA
             tensors that require grad raise ``ValueError``;
29. smokes - every family's smoke config in f32 from one CPU init: loss
             and gradients and one step (moments, parameters) card vs CPU,
             microbatch 2 vs 1 on the card (loss and moments), a
             checkpoint restart on the card (save at step 2, restore,
             replay 2 steps) bit for bit, and the CPU's checkpoint
             restored on the card bit for bit.
35. control - the trainer's control plane: ``python -m
             repro_torch.launch.train --arch rwkv6-3b --smoke`` on the card
             (started from phase 34's pool once its scenarios are done)
             for 4 steps, a checkpoint every 2 committed through the
             port's PigPaxos ``CoordinationService`` (journalled in the
             checkpoint directory), then a second process with
             ``--resume`` that must restore the committed step 4 and
             commit step 6; the committed step restored in this process
             on the card, bit for bit against its files; then, in this
             process, a service with a follower crashed after one save
             and the leader crashed after the next: the third commit
             lands on the new leader and ``restore`` returns that step's
             state on the card bit for bit; each commit's latency in
             virtual and wall time.

30. shard  - the sharding layer on a one-rank NCCL world and its (1, 1)
             ``("data", "model")`` ``DeviceMesh``: granite-8b (after phase
             10's check, impl "flash") and rwkv6-3b (after phase 16's
             check, impl "auto") with their loaded parameters placed as
             DTensors by ``param_shardings`` (fsdp, no copy), the cache by
             ``cache_shardings``, the prompts by ``batch_sharding``;
             ``generate`` (3 decode steps) under ``sharding_rules``: 36
             flash_attention_sm90 and 32 ssm_scan_sm90 launches through
             ``local_map``, no other kernel; the prefill's last-token
             logits, every cache leaf and the tokens bit for bit against
             the same calls unsharded; one training step of rwkv6-3b at
             full width cut to 4 layers (4 x 2048), sharded and unsharded
             from the same state and batch: loss, gradients and moments
             bit for bit, 8 ssm_scan_sm90 launches; walls sharded beside
             unsharded, peak memory; and the dry-run CLI for granite-8b
             decode_32k on the single production mesh in a subprocess (a
             fake world of 256 ranks cannot share a process with NCCL),
             its JSON fields and H100 roofline terms printed.

The batch phases (17-22, 31-33) run their grids and their check runs in
``POOL_WORKERS`` spawned processes that drive the one card side by side
(the step loops are host-bound), the costliest first; each worker sets
the fan-in counts to 0 before its run and reads them after.  Phase 34's
discrete-event runs (host only) go to ``DES_WORKERS`` more processes at
the same time.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
import json
import math
import multiprocessing
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_S = 3.35e12      # H100 SXM device memory rate
F32_OPS_S = 67e12          # H100 SXM f32 peak outside the tensor cores
BF16_OPS_S = 989e12        # H100 SXM bf16 dense tensor-core peak
TF32_OPS_S = 495e12        # H100 SXM TF32 dense tensor-core peak
# 132 SMs x 64 INT32 lanes x 1.98 GHz: the H100 SXM's 32-bit integer issue
INT32_OPS_S = 16.7e12
KERNELS = ["seg_fanin_sm90", "flash_attention", "flash_attention_sm90",
           "pig_aggregate", "ssm_scan", "ssm_scan_sm90",
           "threefry_draws_sm90"]
# the threefry draws kernel's launches on the main paths, by phase (the
# runner's ``draw_launches`` of phases 5, 17, 20, 22, 31 and 33), and those
# of its EPaxos entry among them
DRAW_LAUNCHES = {}
EPAXOS_DRAW_LAUNCHES = {}
MAIN = ("scale/batch/N=1025/R=32", "scale/batch/N=257/R=16",
        "scale/batch/replicates/R=3")
CHECK = "scale/batch/replicates/R=3"
# the group kernel's other branches (phase 17) and one quick scenario of
# each (phase 18)
BRANCH_FAMILIES = "wan,avail,batching,obs,reads"
BRANCH_CHECKS = ("avail/relay/N=25/batch", "reads/paxos/lease/r=0.9/batch",
                 "obs/pigpaxos/backlog/batch", "wan/N=25/batch",
                 "batching/paxos/m=8/batch")
OBS = "obs/pigpaxos/backlog/batch"
SPEEDUPS = (("batching/paxos/m=8/batch", "batching/paxos/m=1/batch"),
            ("reads/paxos/lease/r=0.9/batch", "reads/paxos/log/r=0.9/batch"))
SPEEDUP_MIN = 2.0          # benchmarks/reference_bounds.json "speedup"
# the EPaxos fan-in layouts (phase 19): one segment of F = n slots a row,
# rows = cells (8: a conflict grid; 4,096: a megagrid chunk, to which
# every EPaxos bucket of the study is padded)
EFANIN_F = (5, 9, 17, 25, 49)
EFANIN_ROWS = (8, 4096)
EFANIN_TIMED = (("conflict N=25", 8, 25), ("megagrid N=17", 4096, 17))
CONFLICT_CHECK = "conflict/N=25/c=0.1/batch"
# the megagrid slices' gate windows (reference_bounds.json, quick mode)
MEGAGRID_WINDOWS = ("megagrid/slice/N=9/R=2/PRC=1/lan",
                    "megagrid/slice/N=9/R=2/PRC=1/wan3",
                    "megagrid/slice/N=25/R=4/PRC=0/lan")
# phase 22's study: 2**16 cells (every one of the 24 buckets, a sixteenth
# of the chunks; it was 2**18, then 2**17 before the training phases 27-29
# came) keeps the script inside 600 s (2**15 took as long on the card:
# the EPaxos buckets, one padded chunk each, set its wall); the
# 1,000,000-cell study runs from the megagrid CLI (README)
MEGAGRID_CELLS = 2 ** 16
# the study's buckets run whole-chunk through the sm90 fan-in and the plain
# one on the card (phase 22): each group width class, both requests a step
# (B = min(8, clients class)), and an EPaxos bucket
PLAIN_CHUNKS = (("group", 8, 4, "lan"), ("group", 16, 16, "wan3"),
                ("group", 24, 16, "lan"), ("epaxos", 17, 16, "wan3"))
# the CPU parity tolerance for damped cells (tests/test_torch_vectorsim.py):
# counts within one request at the window edges, latency percentiles to
# rel 1e-5, message loads to abs 1e-6
COUNT_SLACK, LAT_REL, MSG_ABS = 1, 1e-5, 1e-6
# the batch phases (17-22, 31-33) run their grids and check runs in this
# many processes on the one card: alone or four side by side, a
# scenario's wall is the same within the host's spread (on an H100 80GB
# HBM3 host with 8 cores, four processes ran 8 Fig. 8 and avail grids
# 1.76x faster than one, results bit for bit equal; four threads in one
# process were 3.2x slower)
POOL_WORKERS = 4
# phase 31: Fig. 8 and Tables 1-2 run at their full grids (the paper's),
# the rest quick; the gate's quick-mode windows that name them
FIGURES_FULL = ("fig8/", "table1/", "table2/")
FIGURE_WINDOWS = ("fig8/rotating/R=1", "table1/validate/R=1",
                  "table2/validate/R=1", "zipf/pigpaxos/theta=0.99",
                  "conflict/N=25/c=0.1", "wan/N=25", "avail/leader/N=25")
# phase 32: the cells, and the tolerance card vs CPU (tests/figures_parity.py):
# phase 6's, or for a static relay its latency envelope (the reference's jit
# run against its own op-by-op run), or for a chaotic cell counts within
# 0.5%, percentiles rel 3%, loads abs 1e-3, timeline buckets within 5% of
# the peak bucket
FCHECK = {"avail/relay/N=49": "chaotic", "fig8/static/R=1": "static",
          "table2/validate/R=2": "chaotic", "fig8/scale/N=101/R=10": None}
STATIC_LAT_REL = 5e-5
# phase 33: the DES half run again, bit for bit
GATE_RERUN = "wan/N=25"
# phase 34: the rest of the discrete-event scenarios (the failover and
# lease families, the overload cells with admission control, the traced
# and relay-fairness obs cells), quick with quick_skip ignored, in a
# second spawned pool of DES_WORKERS beside the batch phases' (the host
# has 8 cores: the batch pool's 4, this process and these 2; with 3 the
# batch phases took ~27 s longer), at a lower priority (nice DES_NICE, on
# these processes only) so that the host-bound batch loops go first; the
# traced
# cell run again, bit for bit; the exact engine's sampled-tracing CPU
# overhead (benchmarks/sim_engine_bench.py's method: a 25-node PigPaxos
# R=3 run of 40 clients over 0.4 s, traced at TRACE_RATE and untraced in
# turn, TRACE_ROUNDS rounds, the minimum of the paired overheads) and
# the exact and seed engines' events/s (ENGINE_ROUNDS interleaved rounds,
# the median ratio)
DES_REST = ("failover/detect=50ms", "failover/detect=100ms",
            "failover/detect=200ms", "lease/expiry/d=50ms",
            "lease/expiry/d=400ms", "overload/paxos/adm",
            "overload/paxos/adm+batch", "overload/paxos/bursty/adm",
            "overload/paxos/diurnal/adm", "overload/paxos/latadm",
            "overload/pigpaxos/adm", "overload/audit/adm",
            "overload/audit/adm+batch", "obs/pigpaxos/traced",
            "obs/paxos/traced", "obs/epaxos/traced",
            "obs/fairness/rotating", "obs/fairness/static")
DES_REST_RERUN = "obs/paxos/traced"
DES_WORKERS = 2
DES_NICE = 10
TRACE_RATE, TRACE_ROUNDS, ENGINE_ROUNDS = 0.05, 6, 3
# phase 35: the trainer's control plane: launch.train on the card at
# rwkv6-3b's smoke config, checkpoints every TRAIN_CTL_EVERY steps
# committed through the port's CoordinationService, then --resume in a
# second process (both run from phase 34's pool, after its scenarios,
# beside the batch phases: ~36 s off the script's serial path); in this
# process, a follower and the leader of the service crashed between saves
TRAIN_CTL_ARCH, TRAIN_CTL_STEPS, TRAIN_CTL_EVERY = "rwkv6-3b", 4, 2
CHAOTIC_COUNT_REL, CHAOTIC_LAT_REL = 5e-3, 3e-2
CHAOTIC_MSG_ABS, CHAOTIC_TIMELINE_REL = 1e-3, 5e-2
# flash_attention against its plain version in bf16: both compute in f32
# and round once, so 2 bf16 ulps (2**-7 relative each) cover it
FLASH_ATOL, FLASH_RTOL = 2e-3, 1.6e-2
# (B, Hq, Hkv, S, Dh, causal): granite-8b's prefill, granite at its
# max_seq_len, a ragged S, gemma-7b's head dim, and no mask
FLASH_CASES = (("granite prefill", 4, 32, 8, 2048, 128, True),
               ("granite max_seq_len", 1, 32, 8, 4096, 128, True),
               ("ragged S", 2, 32, 8, 1000, 128, True),
               ("gemma-7b", 1, 16, 16, 1024, 256, True),
               ("Dh 64 non-causal", 2, 8, 2, 512, 64, False))
# flash_attention_bshd on the model's (B, S, H, Dh) tensors: granite-8b's
# prefill, a ragged S and one row
FLASH_BSHD_CASES = (("granite prefill", 4, 32, 8, 2048, 128, True),
                    ("ragged S", 2, 32, 8, 1000, 128, True),
                    ("one row", 1, 32, 8, 1, 128, True))
# ops.flash_attention at head dims no kernel takes, padded with zeros to
# the next one (128) and scaled by 1/sqrt of the unpadded Dh: zamba2-7b's
# shared attention (32 heads of 112) and h2o-danube-1.8b's (32 / 8 of 80)
FLASH_PADDED_CASES = (("zamba2-7b shared attn", 1, 32, 32, 2048, 112, True),
                      ("h2o-danube-1.8b", 1, 32, 8, 2048, 80, True))
# the CUDA-core kernel (csrc/flash_attention.cu, which serves f32 and Dh 32)
# against its plain version in f32 at FLASH_CASES: other summation orders,
# expf against torch.exp (the f32 tolerance of tests/test_torch_cuda.py)
FLASH_F32_ATOL, FLASH_F32_RTOL = 1e-5, 1e-4
SERVE_ARCH, SERVE_B, SERVE_PROMPT, SERVE_GEN = "granite-8b", 4, 2048, 32
# the impl="ref" prefill against the flash one, relative L2 of the
# last-token logits over 36 bf16 layers: measured 0.0181 on an H100 80GB
# HBM3 at 700 W (PERF.md); the two attentions round their bf16 outputs
# apart by an ulp here and there and 36 random layers amplify it, so the
# bound leaves ~2.8x room
SERVE_REL_L2 = 5e-2
DECODE_STEPS = 4         # decode steps timed, and traced, after the check
# pig_aggregate: the three shapes of tests/test_kernels.py; the relay's
# aggregate of granite-8b's mlp.w1 gradient (36 x 4096 x 14336) on the
# repo's multi-pod production mesh (2 pods x 16 data x 16 model): each
# relay owns 1/16 of the leaf's 1/16 model slice and sums 2 pods; and the
# largest leaf of phase 13 (mlp.w1 at 12 layers, one rank)
PIG_BLOCK = 1024
RELAY_N = 36 * 4096 * 14336 // (16 * 16)              # 8,257,536
SYNC_LAYERS = 12                                      # of granite-8b's 36
PIG_CASES = (("test shape", 2, 2048, 1024, "normal"),
             ("test shape", 5, 8192, 512, "normal"),
             ("test shape", 16, 4096, 256, "normal"),
             ("relay, granite-8b mlp.w1", 2, RELAY_N, PIG_BLOCK, "normal"),
             ("phase 13 mlp.w1, 1 rank", 1, SYNC_LAYERS * 4096 * 14336,
              PIG_BLOCK, "normal"),
             ("all-zero blocks", 3, 1 << 20, PIG_BLOCK, "zeros"),
             ("-127/+127 extremes", 4, 1 << 20, PIG_BLOCK, "extremes"))
PIG_TIMED = ((2, RELAY_N), (4, 1 << 28))              # at PIG_BLOCK
# granite-smoke card vs CPU: the bf16 logit tolerance of the CPU tests
# (tests/test_torch_models.py)
SMOKE_LOGIT_TOL = 0.08
# ssm_scan against its plain version: f32 outputs and the state within
# 2e-4 max(1, max|plain|) (the reference's own 2e-4 between its kernel and
# oracle, tests/test_kernels.py:89); bf16 outputs within that f32 slack
# (the two f32 sums before rounding) plus 2 bf16 ulps of |plain| (each
# side rounds once, and a value next to a power of two may round across)
SSM_REL = 2e-4
# (name, B, T, H, Dk, Dv, chunk, decay, dtype, bonus and s0): the eight
# cases of tests/test_kernels.py and its bonus case (ssm_scan.cu); rwkv6-3b's
# prefill, a ragged T, T < 16, the f32 path and the inclusive mask at two
# column blocks (ssm_scan_sm90.cu: Dk 64, Dv a multiple of 64, chunk 16)
SSM_TEST_SHAPES = ((1, 128, 2, 64, 64, 32), (2, 96, 4, 64, 64, 32),
                   (1, 100, 1, 32, 64, 32), (2, 64, 2, 16, 64, 16))
SSM_CASES = tuple(
    (f"test {decay}", *shape, decay, "f32", False)
    for shape in SSM_TEST_SHAPES for decay in ("scalar", "channel")) + (
    ("test bonus", 1, 64, 2, 32, 32, 16, "channel", "f32", True),
    ("rwkv6-3b prefill", 4, 2048, 40, 64, 64, 16, "rwkv", "bf16", True),
    ("ragged T", 4, 1000, 40, 64, 64, 16, "rwkv", "bf16", True),
    ("T < 16", 4, 5, 40, 64, 64, 16, "rwkv", "bf16", True),
    ("f32", 2, 1000, 40, 64, 64, 16, "rwkv", "f32", True),
    ("inclusive Dv 128", 2, 500, 8, 64, 128, 16, "channel", "bf16", False))
SSM_TIMED = next(c for c in SSM_CASES if c[0] == "rwkv6-3b prefill")
RWKV_ARCH, RWKV_CHUNK = "rwkv6-3b", 16
# the decay LoRA-B's std: with it w0 + tanh(x A) B has a std of ~5 and
# log w = -exp(.) reaches both ends of the clamp [-2.3, -1e-4] (the JAX
# init's zero makes every decay -e^0.5); the CPU tests use the same
LORA_B_STD = 1.0
# the impl="ref" prefill of rwkv6-3b against the kernel's.  In bf16 the
# 32 random layers amplify every rounding difference: the gap grows layer
# by layer from 1.6e-3 (layer 1's state) to 0.53 (layer 31's) and 0.39 on
# the logits, and by the same factor in f32 (1.5e-6 to 4.8e-4, logits
# 3.2e-4) (measured on an H100 80GB HBM3 at 700 W, PERF.md).  So the kernel is held to the plain version (1) layer
# by layer on identical bf16 inputs: each block's output delta (its
# residual branch) within RWKV_LAYER_REL (measured <= 4.6e-4: bf16
# rounding of y) and its final state within RWKV_STATE_REL (measured
# <= 7.2e-9: f32 sums in another order), and (2) end to end on an f32 copy
# of the model: the last-token logits and every layer's final state
# within RWKV_F32_REL (measured <= 4.8e-4).  The bf16 end-to-end relative
# L2s are printed.
RWKV_LAYER_REL, RWKV_STATE_REL, RWKV_F32_REL = 2e-3, 1e-6, 5e-3
# rwkv6-smoke card vs CPU: the rwkv6 bf16 logit tolerance of the CPU tests
# (tests/test_torch_rwkv.py)
RWKV_SMOKE_LOGIT_TOL = 0.15


# zamba2-7b (phases 24-25): 81 Mamba2 layers and the shared attention block
# after every 6th of the first 78 (13 applications, flash padded from Dh 112
# to 128).  One Mamba2 block in f32, card vs CPU on identical inputs: f32
# sums of n terms in other orders move a result by ~sqrt(n) 2**-24
# relative (the in-projection's 3584 terms: ~4e-6; the scan's chunk sums
# fewer), where TF32's 10-bit mantissa would move each product by up to
# 2**-11 (~5e-4): MAMBA2_CARD_REL sits between.  The f32 copy end to end,
# flash (flash_attention.cu in f32) against ref: the same attention summed
# in other orders, through 81 random layers that amplify it
HYBRID_ARCH = "zamba2-7b"
MAMBA2_CARD_REL = 1e-4
HYBRID_F32_REL = 5e-3
# zamba2-smoke card vs CPU: the CPU tests' bf16 tolerances for the Mamba2
# families (tests/test_torch_hybrid.py): max |d| and relative L2 of logits
HYBRID_SMOKE_TOL, HYBRID_SMOKE_REL_L2 = 1.0, 0.2
# qwen2-moe-a2.7b (phase 26) and qwen3-moe-235b-a22b at full width, 2 of
# its 94 layers (one 80 GB card holds ~15), a 4 x 2048 prefill and 3 decode
# steps; the smoke configs card vs CPU in f32 (max |d|, relative L2: f32
# sums in other orders, no TF32)
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_CUT_ARCH, MOE_CUT_LAYERS, MOE_CUT_STEPS = "qwen3-moe-235b-a22b", 2, 3
MOE_SMOKE_F32_TOL, MOE_SMOKE_F32_REL_L2 = 1e-3, 1e-5
# one MoE block of qwen2-moe-a2.7b in bf16, card vs CPU.  The router is
# f32: its gates move by f32 sums of 2048 terms in other orders (~1e-6
# relative), where TF32 would move them by ~5e-4, so MOE_GATES_REL sits
# between (as MAMBA2_CARD_REL); a top-k set may differ only where two
# gates part by less than MOE_TIE (~100x the gates' f32 rounding).  On the
# card's routing the output is held to the CPU tests' BF16_REL
# (tests/test_torch_moe.py): 2**-6 of the largest |value|, an ulp or two
# of rounding in the expert products, the combine and the shared expert
MOE_GATES_REL, MOE_TIE, MOE_BLOCK_REL = 1e-4, 1e-6, 2.0 ** -6
# training (phases 27-29): the JAX training CLI's options (launch/train.py:
# remat, impl "auto", AdamW lr 3e-3 with 10 warmup steps over 50) at batch
# 4 x 2048 from the data stream, 3 steps, at full width and depth
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 2048, 3
TRAIN_ADAMW = dict(lr=3e-3, warmup_steps=10, total_steps=50)
TRAIN_ARCH_DENSE = "h2o-danube-1.8b"
# rwkv6-3b's f32 copy at 4 of its 32 layers, full width, impl "auto" vs
# "ref": the scan's forward through ssm_scan_sm90's 3xTF32 (phase 14's
# 2e-4 bound; ~1e-6 on f32 inputs), its backward the plain version's at
# those inputs, so the loss to TRAIN_LOSS_REL and each gradient leaf to
# TRAIN_F32_GRAD_REL relative L2 (set before the first run; PERF.md §6).
# The decay's clamp ([-2.3, -1e-4], models/rwkv.py) makes the gradient
# discontinuous, so any rounding of the scan's output moves whole
# elements in and out of it: the gradients measured 2.05e-3 worst at the
# parameters after step 1 (in two calls) and 4.65e-4 at those after step
# 3 (an H100 80GB HBM3 at 700 W), and the plain version moves its own
# gradients by as much when its output moves by one f32 ulp.  So the
# bound is also TRAIN_ENVELOPE times that envelope, measured in the same
# run at the same parameters
TRAIN_F32_LAYERS, TRAIN_LOSS_REL, TRAIN_F32_GRAD_REL = 4, 1e-5, 1e-3
TRAIN_ENVELOPE = 2.0
# phase 29: every family's smoke config in f32, card vs CPU, at batch 4 x
# 32 (the CPU tests' tolerances, tests/test_torch_train.py: loss 1e-5,
# gradients, moments and parameters 1e-4 relative L2)
TRAIN_SMOKES = (("h2o-danube-1.8b", None), ("granite-8b", None),
                ("qwen2-moe-a2.7b", None), ("qwen3-moe-235b-a22b", None),
                ("rwkv6-3b", None), ("zamba2-7b", "ssm"), ("zamba2-7b", None),
                ("internvl2-76b", None), ("musicgen-large", None))
# microbatch 2 against 1 on the card compares the loss and AdamW's
# moments after step 1 (from zero: mu = (1 - b1) g, nu = (1 - b2) g^2),
# so the gradients, to the same TRAIN_SMOKE_GRAD_REL; the parameters
# after step 1 move by about lr x sign(g), which turns a gradient element
# near zero into a whole step
TRAIN_SMOKE_GRAD_REL = 1e-4
# phase 30: the sharded paths on a one-rank mesh (the prefill's token and
# 3 decode steps; rwkv6-3b's training step cut to 4 layers); the dry-run
# cell run by the CLI
SHARD_GEN, SHARD_TRAIN_LAYERS = 4, 4
DRYRUN_CELL = ("granite-8b", "decode_32k", "single")


def log(*a):
    print(*a, flush=True)


# --------------------------------------------------------------- phase 3
def layouts(F):
    """(name, segment sizes) for F slots: the main path's relay groups and
    a ragged layout of the same width."""
    from repro_torch.core.pig import partition_followers
    r = {24: 3, 256: 16, 1024: 32}[F]
    sizes = [len(g) for g in partition_followers(list(range(1, F + 1)), r)]
    ragged, left, k = [], F, 0
    while left:
        s = min(left, 1 + (7 * k + 3) % 37)
        ragged.append(s)
        left -= s
        k += 1
    return [(f"R={r}", sizes), ("ragged", ragged)]


def max_abs_err(a, b):
    import torch
    same_inf = torch.equal(torch.isinf(a), torch.isinf(b)) and torch.equal(
        a[torch.isinf(a)], b[torch.isinf(b)])
    fin = torch.isfinite(a) & torch.isfinite(b)
    err = (a[fin] - b[fin]).abs().max().item() if fin.any() else 0.0
    return err if same_inf else math.inf


def groups_case(sizes, pad, F, cells, B, device, seed):
    """The grouped entry's inputs for one step, in the step loop's layout:
    ``sizes`` real groups then ``pad`` groups of size 0 (a mixed grid's
    padding: gstart at the end of the real slots, the tail's slots in the
    last group); arrivals on a 2**-8 grid (ties), ~10% masked slots, the
    first segment fully masked (where there are two or more), B_r of
    either sign, caps in [0, size)."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    G = len(sizes) + pad
    sz = torch.tensor(list(sizes) + [0] * pad)
    gstart = torch.cumsum(sz, 0) - sz
    grp = torch.full((F,), G - 1)
    grp[:int(sz.sum())] = torch.repeat_interleave(torch.arange(G), sz)
    arr = 1.0 + torch.floor(torch.rand(cells, B, F, generator=g) * 256) / 256
    mask = torch.rand(cells, B, F, generator=g) >= 0.1
    if len(sizes) > 1:
        mask[:, :, :sizes[0]] = False
    B_r = (torch.rand(cells, B, G, generator=g) * 2 - 1) * 1e-3
    kg = torch.floor(torch.rand(cells, G, generator=g)
                     * torch.clamp_min(sz, 1)).to(torch.int32)
    rm1 = -0.05 - 0.9 * torch.rand(cells, generator=g)
    md1 = 3e-4 * torch.rand(cells, generator=g)
    c = 2e-5 * torch.ones(cells)
    L1 = 1.0 + 1e-3 * torch.rand(cells, B, generator=g)
    rep = lambda t: t.to(torch.int32).expand(cells, -1).contiguous()
    to = lambda t: t.contiguous().to(device)
    layout = tuple(to(rep(t)) for t in (grp, gstart, sz)) + (to(kg),)
    step = tuple(to(t) for t in (arr, mask, B_r, rm1, md1, c, L1))
    return layout, step


def rows_of(layout, step):
    """The per-slot entry's inputs for the same step: vals = arr_back
    masked to +inf, coef = B_r[grp], segid = grp, kcap = kg[grp], scal rows
    [rho - 1, md1, c_repl, L1]."""
    import torch
    grp, gstart, sz, kg = layout
    arr, mask, B_r, rm1, md1, c, L1 = step
    C, B, F = arr.shape
    g64 = grp.long()
    vals = torch.where(mask, arr, torch.inf).reshape(C * B, F)
    coef = torch.gather(B_r, 2, g64[:, None, :].expand(C, B, F))
    kcap = torch.gather(kg.long(), 1, g64).to(torch.int32)
    per_row = lambda x: x[:, None].expand(C, B).reshape(-1)
    scal = torch.stack((per_row(rm1), per_row(md1), per_row(c),
                        L1.reshape(-1)), dim=1)
    return (vals.contiguous(), coef.reshape(C * B, F).contiguous(),
            grp.contiguous(), kcap.contiguous(), scal.contiguous(), B)


def fanin_cases():
    """(F, name, real group sizes, padded groups, cells, B) of phase 3: the
    main path's groups and a ragged layout at each of its widths, Paxos's
    segments of 1, one segment of 1024 (PigPaxos at R=1), padded groups of
    size 0, with and without a tail of slots past the last group, and the
    megagrid study's chunks (``megagrid_cases``)."""
    cases = [(F, name, sizes, 0, cells, 8)
             for F, cells in ((24, 192), (256, 256), (1024, 48))
             for name, sizes in layouts(F)]
    r3 = layouts(24)[0][1]
    return cases + [
        (24, "paxos", [1] * 24, 0, 192, 8),
        (1024, "paxos", [1] * 1024, 0, 48, 8),
        (1024, "R=1", [1024], 0, 48, 8), (24, "R=3 of R=4", r3, 1, 192, 8),
        (24, "20+tail", [7, 7, 6], 2, 192, 8),
        (1024, "31 of 32", [32] * 31, 1, 48, 8),
        (48, "wan/N=49", [16, 16, 16], 0, 32, 8),
        (100, "wan/N=101", [34, 33, 33], 0, 32, 8)] + figure_cases() \
        + megagrid_cases()


def figure_cases():
    """The grouped entry's layouts that the backend override's scenarios
    add (phase 31): Table 2's N=5 (F=4, R=1 and 2, unpadded) and Fig. 8's
    sweep at N=49, R=7 and N=101, R=10, as ``partition_followers`` makes
    them."""
    from repro_torch.core.pig import partition_followers
    cases = []
    for F, r, cells, tag in ((4, 1, 8, "table2"), (4, 2, 8, "table2"),
                             (48, 7, 32, "fig8"), (100, 10, 32, "fig8")):
        sizes = [len(g) for g in partition_followers(list(range(1, F + 1)),
                                                     r)]
        cases.append((F, f"{tag} R={r}", sizes, 0, cells, 8))
    return cases


def megagrid_cases():
    """The grouped entry's layouts in the megagrid study's group buckets
    (F = 8, 16 and 24 slots; N = 5 padded into F = 8 with a tail; R = 1 to
    8 groups and Paxos's segments of 1, padded to the bucket's group
    count), each at a chunk of 4,096 cells and at the bucket's requests a
    step (B = 4 or 8): read from the bucket's stacked cells and held equal
    to ``groups_case``'s layout."""
    import numpy as np
    from repro_torch.core import vectorsim
    from repro_torch.experiments import megagrid
    pts, buckets = megagrid.plan(MEGAGRID_CELLS)
    cases = {}
    for bkey, pairs in buckets:
        if bkey[0] != "group":
            continue
        pis = sorted({pi for pi, _ in pairs})
        grid = [(pis.index(pi), k, 0) for pi, k in pairs]
        batch, _, kmax = vectorsim._stack_cells(
            [pts[pi]["cfg"] for pi in pis], grid, 0.1, 0.05)
        F, B = batch["grp"].shape[1], min(8, kmax)
        for i, (pi, _) in enumerate(pairs):
            sz = batch["sizes"][i]
            sizes = [int(v) for v in sz[sz > 0]]
            pad = len(sz) - len(sizes)
            key = (F, tuple(sizes), pad, B)
            if key in cases:
                continue
            layout, _ = groups_case(sizes, pad, F, 1, B, "cpu", seed=0)
            want = (batch["grp"][i], batch["gstart"][i], sz)
            if not all(np.array_equal(t[0].numpy(), w)
                       for t, w in zip(layout, want)):
                raise SystemExit(f"megagrid layout {pts[pi]['name']} is not "
                                 f"groups_case({sizes}, {pad}, {F})")
            name = pts[pi]["name"].split("/")
            cases[key] = (F, "mg " + "/".join(name[:3 if name[0] == "pig"
                                                    else 2]),
                          sizes, pad, 4096, B)
    return list(cases.values())


def check_kernel(device):
    """Phase 3: the fan-in kernel against the plain version on the card,
    bit for bit: its per-slot entry on every case's per-slot inputs, its
    grouped entry on the case's layout; one launch a call."""
    import torch
    from repro_torch.kernels import segfanin
    from repro_torch.kernels.ref import (seg_fanin_groups_ref,
                                         seg_fanin_rows_ref)
    worst = 0.0
    for F, name, sizes, pad, cells, B in fanin_cases():
        layout, step = groups_case(sizes, pad, F, cells, B, device,
                                   seed=F + len(sizes) + pad)
        rows = rows_of(layout, step)
        want_rows = seg_fanin_rows_ref(*rows)
        want_groups = seg_fanin_groups_ref(*step[:3], layout[0], layout[1],
                                           layout[3], *step[3:])
        plan = segfanin.FaninGroups(*layout, B)
        for kernel, fn, want in (
                ("sm90 rows", lambda: segfanin.seg_fanin_rows(*rows),
                 want_rows),
                ("sm90 groups", lambda: plan(*step), want_groups)):
            before = segfanin.launches
            got = fn()
            launched = segfanin.launches - before
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            worst = max(worst, err)
            ok = same_bits(got, want) and launched == 1
            log(f"kernel   {kernel:11s} F={F:5d} {name:10s} "
                f"rows={cells * B:5d} groups={len(sizes) + pad:4d} "
                f"launches={launched} equal={ok} "
                f"(tolerance: bit equality) max_abs_err={err}")
            if not ok:
                raise SystemExit(f"seg_fanin {kernel} != plain version at "
                                 f"F={F} ({name})")
    return worst


# --------------------------------------------------------------- phase 4
def time_ms(fn, iters, warmup=10):
    """Host-launched ms a call: CUDA events around ``iters`` calls issued
    from Python, so a small kernel's time is the host's launch rate."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(fn, launches=200, replays=5):
    """Device ms a launch: ``launches`` calls captured once in a CUDA graph
    (which checks that the call is capturable), the graph replayed with
    CUDA events around each replay; the median replay over ``launches``.
    Returns (ms, the last captured call's output after a replay)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            out = fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(replays):
        t0.record()
        graph.replay()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / launches)
    return sorted(times)[replays // 2], out


FANIN_SHAPES = (("N=1025/R=32", 1024, 48), ("N=257/R=16", 256, 256),
                ("R=3", 24, 192))


def time_kernel(device):
    """Phase 4: the fan-in kernel's two entries on the same inputs at each
    batch grid's shape (rows = cells x 8): graph-replay device ms, host-
    launched ms, bounds, the empty kernel's floor.  Returns N=1025's record
    of the grouped entry (the main path's)."""
    from repro_torch.kernels import segfanin
    floor_ms, _ = graph_ms(lambda: segfanin.empty_launch(device))
    log(f"timing   empty kernel, 200 launches in a CUDA graph: "
        f"{floor_ms:.6f} ms a launch (the floor)")
    out = None
    for name, F, cells in FANIN_SHAPES:
        timing = time_fanin(device, name, F, cells, floor_ms)
        out = out or timing
    return out


def time_fanin(device, name, F, cells, floor_ms):
    import torch
    from repro_torch.kernels import segfanin
    from repro_torch.kernels.ref import (seg_fanin_groups_ref,
                                         seg_fanin_rows_ref)
    sizes = layouts(F)[0][1]
    layout, step = groups_case(sizes, 0, F, cells, 8, device, seed=7)
    rows = rows_of(layout, step)
    plan = segfanin.FaninGroups(*layout, 8)
    R, G, C = cells * 8, len(sizes), cells
    calls = {"sm90 rows": lambda: segfanin.seg_fanin_rows(*rows),
             "sm90 groups": lambda: plan(*step)}
    # read each input once, write the output once
    rows_bytes = 4 * (3 * R * F + 2 * C * F + 4 * R)
    groups_bytes = (4 * R * F + R * F + 4 * R * G + 4 * C * F + 8 * C * G
                    + 12 * C + 4 * R + 4 * R * G)
    ops = R * (2 * sum(s * s for s in sizes) + 9 * F)  # compares + y
    ops_ms = ops / F32_OPS_S * 1e3
    bound = {}
    for entry, nbytes in (("rows", rows_bytes), ("groups", groups_bytes)):
        bytes_ms = nbytes / HBM_BYTES_S * 1e3
        bound[entry] = (max(bytes_ms, ops_ms),
                        "bytes" if bytes_ms >= ops_ms else "operations")
        log(f"timing   seg_fanin {name} rows={R} F={F} G={G}: {entry} entry "
            f"bound {bound[entry][0]:.6f} ms ({nbytes} bytes at 3.35 TB/s "
            f"= {bytes_ms:.6f} ms; {ops} ops at 67 TFLOP/s = "
            f"{ops_ms:.6f} ms)")
    res = {}
    for kernel, fn in calls.items():
        dev_ms, replayed = graph_ms(fn)
        eager = fn()
        torch.cuda.synchronize()
        if not same_bits(replayed, eager):
            raise SystemExit(f"seg_fanin {kernel} at {name}: the graph "
                             f"replay's output != an eager launch's")
        host_ms = time_ms(fn, 200)
        b = bound["groups" if kernel == "sm90 groups" else "rows"][0]
        res[kernel] = (dev_ms, host_ms)
        log(f"timing   seg_fanin {kernel:11s} {name}: device {dev_ms:.6f} ms "
            f"a launch (200 in a CUDA graph; replay == eager: True), "
            f"{100 * b / dev_ms:.2f}% of its bound, "
            f"{dev_ms / floor_ms:.2f}x the empty kernel; host-launched "
            f"{host_ms:.6f} ms a call (200 calls from Python)")
    plain_rows = time_ms(lambda: seg_fanin_rows_ref(*rows), 20, warmup=3)
    plain_groups = time_ms(lambda: seg_fanin_groups_ref(
        *step[:3], layout[0], layout[1], layout[3], *step[3:]), 20, warmup=3)
    log(f"timing   seg_fanin {name}: plain version {plain_rows:.6f} ms "
        f"(per slot), {plain_groups:.6f} ms (grouped); no single PyTorch "
        f"call computes it")
    dev_ms, host_ms = res["sm90 groups"]
    return {"ms": dev_ms, "host_ms": host_ms, "plain_ms": plain_groups,
            "bound_ms": bound["groups"][0], "bound_by": bound["groups"][1],
            "floor_ms": floor_ms}


# -------------------------------------------------------------- phase 36
DRAWS_CELL = dict(C=24_576, B=8, G=3, F=24)    # pig25.montecarlo's block


def check_draw_launches(name, sa, tag):
    """One threefry kernel launch a draw block, on a group grid and on an
    EPaxos grid alike; counted by ``tag`` (EPaxos's also apart)."""
    run = sa["run"]
    if run["draw_launches"] != run["draw_blocks"] or run["draw_blocks"] < 1:
        raise SystemExit(f"{name}: {run['draw_launches']} draws kernel "
                         f"launches for {run['draw_blocks']} draw blocks")
    DRAW_LAUNCHES[tag] = DRAW_LAUNCHES.get(tag, 0) + run["draw_launches"]
    if sa["spec"]["protocol"] == "epaxos":
        EPAXOS_DRAW_LAUNCHES[tag] = (EPAXOS_DRAW_LAUNCHES.get(tag, 0)
                                     + run["draw_launches"])


def cell_keys(C, device):
    """The keys of a grid's C cells at run seed 2**31 (``_stack_cells``:
    PRNGKey(seed x 1_000_003 + cell))."""
    import torch
    s = 2**31 * 1_000_003 + torch.arange(C, dtype=torch.int64)
    return torch.stack([(s >> 32) & 0xFFFFFFFF, s & 0xFFFFFFFF], -1).to(
        device)


def time_draws(entry, call, plain, same, want, nbytes, ops):
    """A draws entry's device time (200 launches captured in a CUDA graph,
    the replay's output held to ``want`` by ``same``) and host-launched
    time beside its bounds (``nbytes`` at 3.35 TB/s, ``ops`` INT32
    operations at the card's INT32 rate) and the plain version's time."""
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = ops / INT32_OPS_S * 1e3
    bound = max(bytes_ms, ops_ms)
    dev_ms, replayed = graph_ms(call)
    if not same(replayed, want):
        raise SystemExit(f"threefry_draws_sm90{entry}: the graph replay's "
                         f"output != an eager launch's")
    del replayed
    host_ms = time_ms(call, 200)
    plain_ms = time_ms(plain, 20, warmup=3)
    log(f"draws   {entry} bounds: {nbytes} bytes at 3.35 TB/s = "
        f"{bytes_ms:.6f} ms; {ops} INT32 ops at {INT32_OPS_S / 1e12:.1f} "
        f"TOP/s = {ops_ms:.6f} ms")
    log(f"draws    threefry_draws_sm90{entry}: device {dev_ms:.6f} ms a "
        f"launch (200 in a CUDA graph; replay == eager: True), "
        f"{100 * bound / dev_ms:.2f}% of its bound; host-launched "
        f"{host_ms:.6f} ms a call; the prng composition {plain_ms:.6f} ms "
        f"({plain_ms / dev_ms:.1f}x); no single PyTorch call computes it")
    return {"ms": dev_ms, "host_ms": host_ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def check_draws(device):
    """Phase 36: the draws kernel at pig25.montecarlo's block against the
    composition of ``prng`` calls (``ref.group_draws_ref``) on the card,
    bit for bit; its exponential over every uniform against torch's; its
    times beside its bounds (``time_draws``)."""
    import torch
    from repro_torch.kernels import draws, ref
    C, B, G, F = (DRAWS_CELL[k] for k in "CBGF")
    n_draw = 2 + 2 * G + 2 * F
    key = cell_keys(C, device)
    call = lambda: draws.group_draws(key, 17, 1, B, n_draw, G)
    plain = lambda: ref.group_draws_ref(key, 17, 1, B, n_draw, G)
    same = lambda got, want: all(same_bits(a, b)
                                 for a, b in zip(got[:2], want[:2]))
    before = draws.launches_sm90
    got, want = call(), plain()
    torch.cuda.synchronize()
    equal = same(got, want)
    u = torch.arange(2**23, dtype=torch.float32, device=device) * 2.0**-23
    exp_differ = int((draws.exponential_of(u).view(torch.int32)
                      != (-torch.log1p(-u.double())).float().view(
                          torch.int32)).sum())
    log(f"draws    threefry_draws_sm90 C={C} B={B} G={G} F={F} n=1: "
        f"launches={draws.launches_sm90 - before} equal={equal} "
        f"(tolerance: bit equality); exponential of all 2**23 uniforms: "
        f"{exp_differ} differ")
    if not equal or exp_differ or draws.launches_sm90 != before + 1:
        raise SystemExit("threefry_draws_sm90 != the prng composition")
    words = C * B * (n_draw + G)
    # a threefry is 2 + 20 x 3 + 5 x 2 adds, rotates and xors, a word's
    # bits and uniform 3 more; three threefry calls a row derive the keys
    return time_draws("", call, plain, same, want, 4 * words + 16 * C,
                      75 * words + 3 * 72 * C)


EPAXOS_DRAWS_CELL = dict(C=393_216, n=25)     # epaxos25.montecarlo's block


def check_epaxos_draws(device):
    """Phase 36, EPaxos: the kernel's EPaxos entry at epaxos25.montecarlo's
    block against ``ref.epaxos_draws_ref`` on the card, bit for bit; its
    times beside its bounds (``time_draws``)."""
    import torch
    from repro_torch.kernels import draws, ref
    C, n = EPAXOS_DRAWS_CELL["C"], EPAXOS_DRAWS_CELL["n"]
    key = cell_keys(C, device)
    call = lambda: draws.epaxos_draws(key, 17, 1, n)
    plain = lambda: ref.epaxos_draws_ref(key, 17, 1, n)

    def same(got, want):
        return torch.equal(got[0], want[0]) and all(
            same_bits(a, b) for a, b in zip(got[1:], want[1:]))
    before = draws.launches_sm90
    got, want = call(), plain()
    torch.cuda.synchronize()
    equal = same(got, want)
    log(f"draws    threefry_draws_sm90 EPaxos C={C} n={n} b=1: "
        f"launches={draws.launches_sm90 - before} equal={equal} "
        f"(tolerance: bit equality)")
    if not equal or draws.launches_sm90 != before + 1:
        raise SystemExit("threefry_draws_sm90's EPaxos entry != "
                         "ref.epaxos_draws_ref")
    del got
    words = C * (2 * n + 5)
    # 75 INT32 operations a word, 72 a threefry call deriving keys: fold_in,
    # the 5-way split and randint's split, 8 a row; an int64 coordinator
    # and 2n + 3 floats written a row, the key read
    return time_draws(" EPaxos", call, plain, same, want,
                      C * (8 + 4 * (2 * n + 3)) + 16 * C,
                      75 * words + 8 * 72 * C)


# --------------------------------------------------------------- phase 5
def run_main_path(device):
    import torch
    from repro_torch.experiments import registry, runner
    from repro_torch.kernels import segfanin
    with open(os.path.join(ROOT, "benchmarks", "reference_bounds.json")) as f:
        bounds = json.load(f)["bounds"]
    total = 0
    for name in MAIN:
        (sc,) = registry.select(name)
        segfanin.launches = 0
        t0 = time.perf_counter()
        art = runner.run_scenarios([sc], quick=False, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = segfanin.launches
        sa = art["scenarios"][0]
        run = sa["run"]
        check_units(name, sa["units"])
        check_draw_launches(name, sa, "5 main")
        if launches != run["scan_steps"]:
            raise SystemExit(f"{name}: {launches} fan-in launches for "
                             f"{run['scan_steps']} scan steps")
        tput = sa["summary"]["throughput"]["mean"]
        log(f"main     {name:28s} cells={run['cells']:4d} "
            f"scan_steps={run['scan_steps']:5d} launches={launches:5d} "
            f"draw_launches={run['draw_launches']} "
            f"wall={wall:.3f}s cells/s={run['cells'] / wall:.2f} "
            f"ms/step={1e3 * run['wall_s'] / run['scan_steps']:.4f} "
            f"tput_mean={tput} device={run['device']}")
        if name in bounds:
            lo, hi = bounds[name]
            if not lo <= tput <= hi:
                raise SystemExit(f"{name}: mean throughput {tput} outside "
                                 f"[{lo}, {hi}]")
            log(f"main     {name} mean throughput {tput} inside "
                f"[{lo}, {hi}]")
        total += launches
    return total


def launches_per_step(device):
    """Phase 5: device kernels a scan step of a quick N=1025 run, counted by
    ``torch.profiler`` through the trace module (every kernel of the run,
    set-up and summary included, over its scan steps)."""
    from repro_torch.experiments import registry, trace
    (sc,) = registry.select(MAIN[0])
    r = trace.trace_scenario(sc, True, device)
    per_step = r["kernel_launches"] / r["scan_steps"]
    log(f"main     {sc.name} quick (trace): cells={r['cells']} "
        f"scan_steps={r['scan_steps']} device kernels={r['kernel_launches']} "
        f"= {per_step:.2f} a scan step; idle share "
        f"{r['device_idle_share']:.6f}; ms/step {r['ms_per_step']:.4f}")
    for kname, count, ms in r["top_kernels"][:6]:
        log(f"main         {ms:10.3f} ms {count:7d}x  {kname[:90]}")
    return per_step


# --------------------------------------------------------------- phase 6
def cross_check(device):
    from repro_torch.core import vectorsim
    from repro_torch.experiments import registry
    (sc,) = registry.select(CHECK)
    rs = sc.resolve(True)
    kw = dict(pig=sc.pig, clients=rs.clients, seeds=rs.seeds,
              duration=rs.duration, warmup=rs.warmup,
              leader_timeout=sc.leader_timeout)

    def run(dev, kernel="auto"):
        return vectorsim.simulate_scenario(sc.protocol, sc.n, kernel=kernel,
                                           device=dev, **kw)
    a, b, p = run(device), run(device), run(device, "torch")
    if a != b:
        raise SystemExit(f"{CHECK}: two runs on the card differ")
    if a != p:
        raise SystemExit(f"{CHECK}: kernel run != plain-version run on the "
                         f"card")
    c = run("cpu")
    worst = {"count": 0, "committed": 0, "lat_rel": 0.0, "msg_abs": 0.0}
    for x, y in zip(a, c):
        for k in ("count", "committed"):
            worst[k] = max(worst[k], abs(x[k] - y[k]))
        for k in ("median_ms", "p25_ms", "p75_ms", "p99_ms"):
            worst["lat_rel"] = max(worst["lat_rel"],
                                   abs(x[k] - y[k]) / abs(y[k]))
        for k in ("leader_msgs_per_op", "follower_msgs_per_op"):
            worst["msg_abs"] = max(worst["msg_abs"], abs(x[k] - y[k]))
    log(f"check    {CHECK} quick ({len(a)} cells): cuda == cuda rerun, "
        f"kernel == plain version; cuda vs cpu worst {worst}")
    if (worst["count"] > COUNT_SLACK or worst["committed"] > COUNT_SLACK
            or worst["lat_rel"] > LAT_REL or worst["msg_abs"] > MSG_ABS):
        raise SystemExit(f"{CHECK}: cuda and cpu disagree beyond the parity "
                         f"tolerance: {worst}")


# ----------------------------------------------- the batch phases' pool
def scenario_run(name, quick):
    """Pool worker: one registered scenario through ``run_scenarios`` on
    cuda (``backend_override="batch"`` switches a ``batch_ok``
    discrete-event one), the fan-in counts set to 0 just before and read
    just after.  Returns the scenario's artifact, its launches and its
    wall."""
    import torch
    from repro_torch.experiments import registry, runner
    from repro_torch.kernels import segfanin
    sc = registry.get(name)
    segfanin.launches = 0
    t0 = time.perf_counter()
    art = runner.run_scenarios([sc], quick=quick, ignore_quick_skip=True,
                               backend_override="batch", device="cuda")
    torch.cuda.synchronize()
    return art["scenarios"][0], segfanin.launches, time.perf_counter() - t0


def units_run(spec, device, kernel):
    """Pool worker: ``simulate_scenario``'s units for ``spec`` (a
    registered scenario's name, run quick as the runner would, or the
    call's own keyword arguments with ``protocol`` and ``n``) on
    ``device`` through ``kernel``, and the run's wall."""
    import torch
    from repro_torch.core import vectorsim
    from repro_torch.experiments import registry
    if isinstance(spec, str):
        sc = registry.get(spec)
        kw = dict(branch_kwargs(sc, sc.resolve(True)), protocol=sc.protocol,
                  n=sc.n)
    else:
        kw = dict(spec)
    if device == "cpu":
        # the step loop is bound by per-operation overhead: one intra-op
        # thread leaves the other workers their cores
        torch.set_num_threads(1)
    t0 = time.perf_counter()
    units = vectorsim.simulate_scenario(kw.pop("protocol"), kw.pop("n"),
                                        kernel=kernel, device=device, **kw)
    if device != "cpu":
        torch.cuda.synchronize()
    return units, time.perf_counter() - t0


def run_cost(name, quick):
    """A scenario's expected host time, to start the costliest first: the
    requests its step budget provides for (the runner's rate estimate
    over the window) at ~0.5 ms a group-kernel request (8 a step), 2 ms
    an EPaxos one, half again on the fault-mask path."""
    from repro_torch.core import vectorsim
    from repro_torch.experiments import registry
    sc = registry.get(name)
    rs = sc.resolve(quick)
    kw = branch_kwargs(sc, rs)
    cfg = vectorsim.build_config(sc.protocol, sc.n, pig=kw["pig"],
                                 topo=kw["topo"], workload=kw["workload"],
                                 masks=kw["masks"], batch_m=kw["batch_m"])
    rate = max(vectorsim._estimate_rate(cfg, k // kw["batch_m"])
               for k in rs.clients)
    per = 2.0 if sc.protocol == "epaxos" else 0.5
    return rate * (rs.warmup + rs.duration) * per * (
        1.5 if kw["masks"] is not None else 1.0)


def pool_runs(pool, fn, args, costs):
    """``fn(*a)`` for each ``a`` of ``args`` in the pool, the costliest
    submitted first; the results in ``args``' order."""
    order = sorted(range(len(args)), key=lambda i: -costs[i])
    jobs = {i: pool.apply_async(fn, args[i]) for i in order}
    return [jobs[i].get() for i in range(len(args))]


# -------------------------------------------------------------- phase 17
def extras_shape(units):
    """The units' timeline / obs / rw records as shapes (cells x length)."""
    out = []
    for key, length in (("timeline", lambda e: len(e["counts"])),
                        ("obs", lambda e: len(e["leader_backlog"]["mean_ms"])),
                        ("rw", len)):
        got = [length(u["extras"][key]) for u in units
               if key in u.get("extras", {})]
        out.append(f"{key}={len(got)}x{max(got)}" if got else f"{key}=-")
    return " ".join(out)


def run_branches(pool):
    """Phase 17: the 14 scenarios of the other branches at full grids."""
    from repro_torch.experiments import registry
    names = [sc.name for sc in registry.select(BRANCH_FAMILIES)
             if sc.backend == "batch"]
    if len(names) != 14:
        raise SystemExit(f"{BRANCH_FAMILIES}: {len(names)} scenarios, "
                         f"expected 14")
    arts, total = run_grids(pool, "branches", [(n, False) for n in names],
                            [OBS])
    for fast, slow in SPEEDUPS:
        ratio = (arts[fast]["summary"]["throughput"]["mean"]
                 / arts[slow]["summary"]["throughput"]["mean"])
        log(f"branches {fast} / {slow}: {ratio:.4f}x (floor "
            f"{SPEEDUP_MIN}x)")
        if ratio < SPEEDUP_MIN:
            raise SystemExit(f"{fast}: {ratio:.4f}x {slow}, under the "
                             f"{SPEEDUP_MIN}x floor")
    return total


# -------------------------------------------------------------- phase 18
def branch_kwargs(sc, rs):
    """``simulate_scenario``'s arguments for a resolved scenario, as the
    runner passes them."""
    from repro_torch.experiments.scenario import build_topology
    plan = sc.fault_plan()
    return dict(pig=sc.pig, topo=build_topology(sc.topo),
                workload=sc.workload, clients=rs.clients, seeds=rs.seeds,
                duration=rs.duration, warmup=rs.warmup,
                leader_timeout=sc.leader_timeout,
                masks=(plan.to_masks(sc.n, rs.warmup + rs.duration + 0.5)
                       if plan is not None else None),
                batch_m=(sc.batch or {}).get("max_batch", 1),
                obs=sc.obs is not None)


def unit_gap(x, y, worst):
    """Fold one card unit ``x`` against its CPU unit ``y`` into ``worst``."""
    for k in ("count", "committed"):
        worst[k] = max(worst[k], abs(x[k] - y[k]))
    for k in ("median_ms", "p25_ms", "p75_ms", "p99_ms"):
        worst["lat_rel"] = max(worst["lat_rel"], abs(x[k] - y[k]) / abs(y[k]))
    for k in ("leader_msgs_per_op", "follower_msgs_per_op"):
        worst["msg_abs"] = max(worst["msg_abs"], abs(x[k] - y[k]))
    if "timeline" in x:
        worst["timeline"] = max(worst["timeline"], max(
            abs(a - b) for a, b in zip(x["timeline"]["counts"],
                                       y["timeline"]["counts"])))
    if "obs" in x:
        a, b = x["obs"]["leader_backlog"], y["obs"]["leader_backlog"]
        worst["backlog_n"] = max(worst["backlog_n"], max(
            abs(p - q) for p, q in zip(a["n"], b["n"])))
        worst["backlog_rel"] = max(worst["backlog_rel"], max(
            abs(p - q) / max(abs(q), 1e-3)
            for p, q in zip(a["mean_ms"], b["mean_ms"])))
    if "rw" in x:
        for k in ("reads", "writes"):
            worst["rw_count"] = max(worst["rw_count"],
                                    abs(x["rw"][k] - y["rw"][k]))
        for k in ("read_mean_ms", "write_mean_ms", "read_p99_ms"):
            worst["rw_rel"] = max(worst["rw_rel"], abs(
                x["rw"][k] - y["rw"][k]) / abs(y["rw"][k]))


def check_branches(pool):
    """Phase 18: card == rerun == plain fan-in, bit for bit, extras
    included; card vs CPU within phase 6's tolerance."""
    card_vs_cpu(pool, "bcheck", [(n, n, None) for n in BRANCH_CHECKS])


# -------------------------------------------------------------- phase 19
def efanin_case(F, rows, kcap, device, seed):
    """``seg_fanin_rows``' inputs at the EPaxos layout: rows = cells, one
    segment of F = n slots a row, the coordinator's slot +inf, arrivals on
    a 2**-8 grid (ties), coef = the coordinator's backlog W_C (zero in a
    quarter of the rows), scalars [-0.5, 0, c, L1], cap ``kcap``."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    vals = 1.0 + torch.floor(torch.rand(rows, F, generator=g) * 256) / 256
    coord = torch.randint(0, F, (rows,), generator=g)
    vals[torch.arange(rows), coord] = math.inf
    wc = 2e-3 * torch.rand(rows, generator=g)
    wc[torch.rand(rows, generator=g) < 0.25] = 0.0
    coef = wc[:, None].expand(rows, F)
    L1 = 1.0 - 1e-3 * torch.rand(rows, generator=g)
    scal = torch.stack((torch.full((rows,), -0.5), torch.zeros(rows),
                        torch.full((rows,), 2e-5), L1), dim=1)
    to = lambda t, dt=torch.float32: t.to(dt).contiguous().to(device)
    return (to(vals), to(coef), to(torch.zeros(rows, F), torch.int32),
            to(torch.full((rows, F), kcap), torch.int32), to(scal), 1)


def check_efanin(device):
    """Phase 19: the sm90 per-slot entry against the plain version at the
    EPaxos layouts, bit for bit, one launch a call; timed at 8 x 25 (a
    conflict grid at N=25) and 4,096 x 17 (a megagrid chunk at N=17).

    Two bounds: the per-slot interface's (vals, coef, segid and kcap read
    as (rows, F), the (rows, F) output written) and the EPaxos path's,
    which needs only vals (rows, F), six values a row (W_C, the four
    scalars, the cap) and one output a row."""
    import torch
    from repro_torch.core.quorums import fast_quorum, majority
    from repro_torch.kernels import segfanin
    from repro_torch.kernels.ref import seg_fanin_rows_ref
    worst = 0.0
    for F in EFANIN_F:
        for rows in EFANIN_ROWS:
            for what, kcap in (("fq-2", fast_quorum(F) - 2),
                               ("maj-2", majority(F) - 2)):
                args = efanin_case(F, rows, kcap, device, seed=F * rows)
                want = seg_fanin_rows_ref(*args)
                before = segfanin.launches
                got = segfanin.seg_fanin_rows(*args)
                launched = segfanin.launches - before
                torch.cuda.synchronize()
                err = max_abs_err(got, want)
                worst = max(worst, err)
                ok = same_bits(got, want) and launched == 1
                log(f"efanin   F={F:3d} rows={rows:5d} kcap={what:5s} "
                    f"({kcap:2d}) launches={launched} equal={ok} "
                    f"(tolerance: bit equality) max_abs_err={err}")
                if not ok:
                    raise SystemExit(f"seg_fanin_rows != plain version at "
                                     f"the EPaxos layout F={F} rows={rows} "
                                     f"{what}")
    floor_ms, _ = graph_ms(lambda: segfanin.empty_launch(device))
    timing = {}
    for name, rows, F in EFANIN_TIMED:
        args = efanin_case(F, rows, fast_quorum(F) - 2, device, seed=1)
        dev_ms, replayed = graph_ms(lambda: segfanin.seg_fanin_rows(*args))
        eager = segfanin.seg_fanin_rows(*args)
        torch.cuda.synchronize()
        if not same_bits(replayed, eager):
            raise SystemExit(f"seg_fanin_rows at {name}: the graph replay's "
                             f"output != an eager launch's")
        host_ms = time_ms(lambda: segfanin.seg_fanin_rows(*args), 200)
        plain_ms = time_ms(lambda: seg_fanin_rows_ref(*args), 20, warmup=3)
        nbytes = 4 * (3 * rows * F + 2 * rows * F + 4 * rows)
        path_bytes = 4 * (rows * F + 7 * rows)
        ops = rows * (2 * F * F + 9 * F)
        bytes_ms = nbytes / HBM_BYTES_S * 1e3
        path_bytes_ms = path_bytes / HBM_BYTES_S * 1e3
        ops_ms = ops / F32_OPS_S * 1e3
        bound = max(bytes_ms, ops_ms)
        path_bound = max(path_bytes_ms, ops_ms)
        timing[name] = dict(ms=dev_ms, host_ms=host_ms, plain_ms=plain_ms,
                            bound_ms=bound, path_bound_ms=path_bound)
        log(f"efanin   timing {name} rows={rows} F={F}: device {dev_ms:.6f} "
            f"ms a launch (200 in a CUDA graph; replay == eager: True), "
            f"{dev_ms / floor_ms:.2f}x the empty kernel ({floor_ms:.6f}); "
            f"interface bound {bound:.6f} ms ({nbytes} bytes = "
            f"{bytes_ms:.6f} ms, {ops} ops = {ops_ms:.6f} ms), "
            f"{100 * bound / dev_ms:.2f}% of it; EPaxos path bound "
            f"{path_bound:.6f} ms ({path_bytes} bytes = {path_bytes_ms:.6f} "
            f"ms), {100 * path_bound / dev_ms:.2f}% of it; host-launched "
            f"{host_ms:.6f} ms a call; plain version {plain_ms:.6f} ms")
    return worst, timing


# -------------------------------------------------------------- phase 20
def check_units(name, units):
    """No cell exhausted, and every throughput and latency finite and
    positive."""
    bad = [u for u in units if u["exhausted"] or not all(
        u[k] is not None and u[k] > 0 for k in
        ("throughput", "mean_ms", "median_ms", "p25_ms", "p75_ms",
         "p99_ms"))]
    if bad:
        raise SystemExit(f"{name}: {len(bad)} cells exhausted or with "
                         f"non-finite/zero results, e.g. {bad[0]}")


def run_grids(pool, tag, grids, windows=()):
    """``grids``, (name, quick) pairs, through ``run_scenarios`` on cuda in
    the pool (``scenario_run``): each scan step launches the sm90 fan-in
    once (twice for EPaxos), and the runner counted the same; no cell
    exhausted or non-finite; the artifact records the batch backend.  Per
    scenario its cells, scan steps, launches, wall, ms a step, mean
    throughput and extras.  ``windows``: scenarios whose quick mean
    throughput must sit inside its ``reference_bounds.json`` window (run
    quick here unless a grid is their quick run).  Returns ({name:
    artifact}, launches)."""
    bounds = gate_windows(windows)
    tasks = list(grids) + [(n, True) for n in windows
                           if (n, True) not in grids]
    results = pool_runs(pool, scenario_run, tasks,
                        [run_cost(n, quick) for n, quick in tasks])
    arts, total, quick_means = {}, 0, {}
    for (name, quick), (sa, launches, wall) in zip(tasks, results):
        run = sa["run"]
        tput = sa["summary"]["throughput"]["mean"]
        if quick:
            quick_means[name] = tput
        if (name, quick) not in grids:
            continue
        check_units(name, sa["units"])
        rounds = 2 if sa["spec"]["protocol"] == "epaxos" else 1
        if not (launches == run["fanin_launches"]
                == rounds * run["scan_steps"]):
            raise SystemExit(f"{name}: {launches} fan-in launches (the "
                             f"runner counted {run['fanin_launches']}) for "
                             f"{run['scan_steps']} scan steps x {rounds}")
        check_draw_launches(name, sa, tag)
        if sa["backend"] != "batch" or sa["spec"]["backend"] != "batch":
            raise SystemExit(f"{name}: the artifact does not record the "
                             f"batch backend")
        log(f"{tag:8s} {name:36s} {'quick' if quick else 'full':5s} "
            f"cells={run['cells']:3d} scan_steps={run['scan_steps']:5d} "
            f"launches={launches:6d} "
            f"draw_launches={run['draw_launches']:5d} wall={wall:.3f}s "
            f"ms/step={1e3 * run['wall_s'] / run['scan_steps']:.4f} "
            f"tput_mean={tput} {extras_shape(sa['units'])}")
        arts[name] = sa
        total += launches
    for name, (lo, hi) in bounds.items():
        mean = quick_means[name]
        log(f"{tag:8s} {name} quick mean throughput {mean} "
            f"{'inside' if lo <= mean <= hi else 'OUTSIDE'} [{lo}, {hi}]")
        if not lo <= mean <= hi:
            raise SystemExit(f"{name}: quick mean throughput {mean} outside "
                             f"[{lo}, {hi}]")
    return arts, total


def gate_windows(names):
    with open(os.path.join(ROOT, "benchmarks", "reference_bounds.json")) as f:
        bounds = json.load(f)["bounds"]
    return {n: bounds[n] for n in names}


def run_conflict(pool):
    """Phase 20: the 8 conflict/*/batch full grids."""
    from repro_torch.experiments import registry
    names = [sc.name for sc in registry.select("conflict")
             if sc.backend == "batch"]
    if len(names) != 8:
        raise SystemExit(f"conflict: {len(names)} scenarios, expected 8")
    return run_grids(pool, "conflict", [(n, False) for n in names],
                     [CONFLICT_CHECK])[1]


# -------------------------------------------------------------- phase 21
def card_vs_cpu(pool, tag, checks):
    """``checks``: (name, spec, envelope) triples.  Each ``spec`` (see
    ``units_run``) runs four times in the pool, all submitted first: on
    the card, again, through the plain fan-in on the card, on the CPU.
    Card == rerun == plain, bit for bit, extras included; card vs CPU
    within phase 6's tolerance (extras: timeline buckets and read/write
    counts within one, backlog and read/write means rel 1e-5), or the
    check's ``envelope``: "static" (a static relay's latency envelope) or
    "chaotic" (``CHAOTIC_*``)."""
    runs = (("cuda", "auto"), ("cuda", "auto"), ("cuda", "torch"),
            ("cpu", "auto"))
    jobs = [[pool.apply_async(units_run, (spec, dev, kernel))
             for dev, kernel in runs] for _, spec, _ in checks]
    for (name, _, envelope), js in zip(checks, jobs):
        (a, wa), (b, wb), (p, wp), (c, wc) = [j.get() for j in js]
        if a != b:
            raise SystemExit(f"{name}: two runs on the card differ")
        if a != p:
            raise SystemExit(f"{name}: kernel run != plain-version run on "
                             f"the card")
        worst = {"count": 0, "committed": 0, "lat_rel": 0.0, "msg_abs": 0.0,
                 "timeline": 0, "backlog_n": 0, "backlog_rel": 0.0,
                 "rw_count": 0, "rw_rel": 0.0}
        for x, y in zip(a, c):
            if sorted(x) != sorted(y):
                raise SystemExit(f"{name}: card and cpu units differ in "
                                 f"their fields")
            unit_gap(x, y, worst)
        worst["count"] = max(worst["count"], worst.pop("committed"))
        tol = {"count": COUNT_SLACK, "lat_rel": LAT_REL, "msg_abs": MSG_ABS,
               "timeline": COUNT_SLACK, "backlog_n": 0,
               "backlog_rel": LAT_REL, "rw_count": COUNT_SLACK,
               "rw_rel": LAT_REL}
        if envelope == "static":
            tol["lat_rel"] = STATIC_LAT_REL
        elif envelope == "chaotic":
            peak = max([max(u["timeline"]["counts"]) for u in c
                        if "timeline" in u] or [0])
            tol.update(count=CHAOTIC_COUNT_REL * min(u["count"] for u in c),
                       lat_rel=CHAOTIC_LAT_REL, msg_abs=CHAOTIC_MSG_ABS,
                       timeline=CHAOTIC_TIMELINE_REL * peak)
        log(f"{tag:8s} {name} ({len(a)} cells): cuda == cuda rerun, kernel "
            f"== plain version (extras included; card runs {wa:.2f}, "
            f"{wb:.2f}, {wp:.2f} s, cpu {wc:.2f} s); cuda == cpu bit for "
            f"bit: {a == c}; worst {worst}; tolerance "
            f"({envelope or 'phase 6'}) {tol}")
        bad = {k: worst[k] for k in tol if worst[k] > tol[k]}
        if bad:
            raise SystemExit(f"{name}: cuda and cpu disagree beyond the "
                             f"tolerance: {bad}")


def check_conflict(pool):
    """Phase 21: quick conflict/N=25/c=0.1/batch and a zipfian EPaxos
    grid."""
    from repro_torch.core.workload import WorkloadConfig
    zipf = dict(protocol="epaxos", n=25, clients=(40,), seeds=(1, 2),
                duration=0.2, warmup=0.1, workload=WorkloadConfig(
                    key_dist="zipfian", zipf_theta=0.99))
    card_vs_cpu(pool, "ccheck", [
        (f"{CONFLICT_CHECK} quick", CONFLICT_CHECK, None),
        ("epaxos N=25 zipfian(0.99) 40 clients x 2 seeds", zipf, None)])


# -------------------------------------------------------------- phase 22
def chunked_equals_unchunked(device):
    """simulate_grid_sharded in 64-cell chunks == one simulate_grid call,
    bit for bit, on a group and an EPaxos bucket of the study (3 chunks
    and a ragged tail)."""
    import numpy as np
    from repro_torch.core import vectorsim
    from repro_torch.experiments import megagrid
    pts, buckets = megagrid.plan(MEGAGRID_CELLS)
    for want_key in (("group", 8, 16, "wan3"), ("epaxos", 17, 4, "lan")):
        (pairs,) = [p for b, p in buckets if b == want_key]
        pis = sorted({pi for pi, _ in pairs})
        cfgs = [pts[pi]["cfg"] for pi in pis]
        grid = [(pis.index(pi), k, s) for pi, k in pairs
                for s in range(40)][:3 * 64 + 17]
        t0 = time.perf_counter()
        want = vectorsim.simulate_grid(cfgs, grid, 0.1, 0.05, device=device)
        t1 = time.perf_counter()
        got = vectorsim.simulate_grid_sharded(cfgs, grid, 0.1, 0.05,
                                              chunk=64, device=device)
        t2 = time.perf_counter()
        same = [k for k in want if k not in ("scan_steps",)
                and not np.array_equal(want[k], got[k], equal_nan=True)]
        chunks = got["sharding"]["chunks"]
        log(f"megagrid chunked == unchunked {want_key}: {len(grid)} cells, "
            f"{len(cfgs)} configs, {len(chunks)} chunks of 64 (retries "
            f"{[m['retries'] for m in chunks]}); fields that differ: "
            f"{same or 'none'}; one call {t1 - t0:.2f}s "
            f"({want['scan_steps']} scan steps), chunked {t2 - t1:.2f}s "
            f"({got['scan_steps']})")
        if same:
            raise SystemExit(f"chunked != unchunked at {want_key}: {same}")


def kernel_equals_plain_chunks(device):
    """One 4,096-cell chunk of each bucket in ``PLAIN_CHUNKS`` through
    ``simulate_grid_sharded`` with the sm90 fan-in and with the plain one
    (``kernel="torch"``) on the card: bit for bit.  A group chunk takes
    seeds round-robin over the bucket's (point, clients) pairs, so that it
    has the bucket's padded shapes; an EPaxos bucket of the study is
    smaller than a chunk and runs whole, padded as the study pads it."""
    import numpy as np
    from repro_torch.core import vectorsim
    from repro_torch.experiments import megagrid
    from repro_torch.kernels import segfanin
    pts, buckets = megagrid.plan(MEGAGRID_CELLS)
    for want_key in PLAIN_CHUNKS:
        (pairs,) = [p for b, p in buckets if b == want_key]
        pis = sorted({pi for pi, _ in pairs})
        cfgs = [pts[pi]["cfg"] for pi in pis]
        full = [(pis.index(pi), k, s) for pi, k in pairs
                for s in range(pts[pi]["seeds"])]
        per = -(-4096 // len(pairs))
        grid = (full if len(full) <= 4096 else
                [(pis.index(pi), k, s) for s in range(per)
                 for pi, k in pairs][:4096])
        if vectorsim._pad_spec(cfgs, grid) != vectorsim._pad_spec(cfgs, full):
            raise SystemExit(f"{want_key}: the chunk's shapes are not the "
                             f"bucket's")
        runs, walls, launched = {}, {}, {}
        for kernel in ("auto", "torch"):
            before = segfanin.launches
            t0 = time.perf_counter()
            runs[kernel] = vectorsim.simulate_grid_sharded(
                cfgs, grid, 0.1, 0.05, kernel=kernel, chunk=4096,
                device=device)
            walls[kernel] = time.perf_counter() - t0
            launched[kernel] = segfanin.launches - before
        a, b = runs["auto"], runs["torch"]
        rounds = 2 if want_key[0] == "epaxos" else 1
        differ = [k for k in a if k != "sharding"
                  and not np.array_equal(a[k], b[k], equal_nan=True)]
        log(f"megagrid sm90 == plain fan-in {want_key}: a chunk of "
            f"{a['sharding']['chunk']} cells ({len(grid)} of the study's, "
            f"{len(cfgs)} configs), {a['scan_steps']} scan steps, "
            f"launches {launched['auto']} (plain run {launched['torch']}); "
            f"fields that differ: {differ or 'none'}; sm90 "
            f"{walls['auto']:.2f}s, plain {walls['torch']:.2f}s")
        want = {"auto": rounds * a["scan_steps"], "torch": 0}
        if differ or launched != want:
            raise SystemExit(f"megagrid chunk {want_key}: the sm90 fan-in's "
                             f"run != the plain fan-in's ({differ}, "
                             f"{launched})")


def run_megagrid(device, pool):
    """Phase 22: the 4 slices, chunked == unchunked, the sm90 fan-in ==
    the plain one on whole chunks, then the study."""
    from repro_torch.experiments import megagrid, registry
    from repro_torch.kernels import segfanin
    slices = registry.select("megagrid")
    if len(slices) != 4:
        raise SystemExit(f"megagrid: {len(slices)} slices, expected 4")
    launches = run_grids(pool, "megagrid", [(sc.name, False) for sc in slices],
                         MEGAGRID_WINDOWS)[1]
    chunked_equals_unchunked(device)
    kernel_equals_plain_chunks(device)
    segfanin.launches = 0
    art = megagrid.run_megagrid(
        MEGAGRID_CELLS, device=device,
        progress=lambda s: log(f"megagrid {s}"))
    mg = art["megagrid"]
    fanin = segfanin.launches
    rounds = sum(b["scan_steps"] * (2 if b["bucket"][0] == "epaxos" else 1)
                 for b in mg["buckets"])
    for b in mg["buckets"]:
        log(f"megagrid bucket {'/'.join(b['bucket']):22s} cells={b['cells']:6d} "
            f"chunks={b['chunks']} scan_steps={b['scan_steps']:5d} "
            f"retries={b['retries']} wall={b['wall_s']}s "
            f"stack={b['stack_s']}s exhausted={b['exhausted']}")
    log(f"megagrid {mg['cells']} cells ({mg['points']} points) in "
        f"{mg['wall_s']} s: {mg['cells_per_s']} cells/s, "
        f"{mg['per_cell_ms']} ms a cell on {mg['device']} through "
        f"{mg['kernel']} ({mg['impl']}, chunk {mg['chunk']}); host stacking "
        f"{mg['stack_s']} s; scan steps {mg['scan_steps']}; launches "
        f"{fanin} (expected {rounds}); exhausted after retry "
        f"{mg['exhausted']}; roofline {mg['roofline']}")
    if mg["cells"] < MEGAGRID_CELLS or mg["exhausted"] or fanin != rounds:
        raise SystemExit("megagrid run failed its checks")
    bad = [s["name"] for s in art["scenarios"]
           for p in s["points"] if p["throughput"]["mean"] is None
           or not p["throughput"]["mean"] > 0]
    if bad:
        raise SystemExit(f"megagrid: points without a finite throughput: "
                         f"{bad[:5]}")
    return launches + fanin


# -------------------------------------------------------------- phase 23
def check_jaxsim(device):
    """Phase 23: relay_load_mc(25, 3, 8192) card == CPU bit for bit,
    latency_curve within 1e-6 relative."""
    import numpy as np
    from repro_torch import prng
    from repro_torch.core import jaxsim
    a = jaxsim.relay_load_mc(prng.PRNGKey(0), 25, 3, 8192, device=device)
    b = jaxsim.relay_load_mc(prng.PRNGKey(0), 25, 3, 8192, device="cpu")
    diff = [k for k in a if not same_bits(a[k].cpu(), b[k])]
    worst = 0.0
    for proto, r in (("paxos", 24), ("pigpaxos", 3), ("epaxos", 1)):
        off = np.linspace(100.0, 60000.0, 64, dtype=np.float32)
        x = jaxsim.latency_curve(off, 25, r, protocol=proto, device=device)
        y = jaxsim.latency_curve(off, 25, r, protocol=proto, device="cpu")
        for k in x:
            u, v = x[k].cpu().numpy(), y[k].numpy()
            if not np.array_equal(np.isfinite(u), np.isfinite(v)):
                raise SystemExit(f"latency_curve {proto} {k}: saturation "
                                 f"differs between cuda and cpu")
            fin = np.isfinite(v)
            worst = max(worst, float(np.max(np.abs(u[fin] - v[fin])
                                            / np.abs(v[fin]))))
    log(f"jaxsim   relay_load_mc(25, 3, 8192): cuda == cpu bit for bit on "
        f"{sorted(a)}: {not diff}; follower mean {float(a['follower_mean'])}"
        f", busiest {float(a['maxavg'])}; latency_curve cuda vs cpu worst "
        f"relative {worst} (tolerance 1e-6)")
    if diff or worst > 1e-6:
        raise SystemExit(f"jaxsim: cuda and cpu differ ({diff}, {worst})")


# -------------------------------------------------------------- phase 31
def run_figures(pool):
    """Phase 31: the 44 ``batch_ok`` discrete-event scenarios through
    ``run_scenarios(..., backend_override="batch")`` on cuda, Fig. 8 at
    N = 25 and Tables 1-2 at their full grids, the rest quick; their
    report rows (the tables' asserts), Fig. 8's best R and the gate's
    windows.  Returns the fan-in launches."""
    from repro_torch.experiments import registry, report
    names = [sc.name for sc in registry.select()
             if sc.backend == "des" and sc.batch_ok]
    if len(names) != 44:
        raise SystemExit(f"{len(names)} batch_ok scenarios, expected 44")
    grids = [(n, not n.startswith(FIGURES_FULL)) for n in names]
    arts, total = run_grids(pool, "figures", grids, FIGURE_WINDOWS)
    rows = []
    for quick in (False, True):
        rows += report.rows_for_artifact({"quick": quick, "scenarios": [
            arts[n] for n, q in grids if q == quick]})
    for row in rows:
        log(f"figures  row {row}")
    (summary,) = [r for r in rows if r.startswith("fig8/summary,")]
    best = dict(re.findall(r"best_R_(\w+)=(\d+)", summary))
    log(f"figures  fig8 best R: rotating {best['rotating']} (paper: 1), "
        f"static {best['static']} (paper: ~sqrt(N) = 5)")
    if best["rotating"] != "1":
        raise SystemExit(f"fig8: best rotating R is {best['rotating']}, "
                         f"not 1")
    return total


# -------------------------------------------------------------- phase 32
def check_figures(pool):
    """Phase 32: four quick override scenarios: card == rerun == the plain
    fan-in's run on the card, bit for bit, extras included; card vs CPU
    within phase 6's tolerance, or the cell's envelope (``FCHECK``)."""
    card_vs_cpu(pool, "fcheck", [(n, n, env) for n, env in FCHECK.items()])


# -------------------------------------------------------------- phase 33
def des_run(name):
    """Pool worker: one registered discrete-event scenario, quick, through
    ``run_scenarios`` on the host (no device).  Returns its artifact and
    the call's wall."""
    from repro_torch.experiments import registry, runner
    t0 = time.perf_counter()
    art = runner.run_scenarios([registry.get(name)], quick=True,
                               ignore_quick_skip=True)
    return art["scenarios"][0], time.perf_counter() - t0


def des_cost(name):
    """A discrete-event scenario's quick units' cost, as the runner's pool
    orders them (virtual seconds x N x clients, EPaxos 4 x)."""
    from repro_torch.experiments import registry, runner
    sc = registry.get(name)
    rs = sc.resolve(True)
    return sum(runner._unit_cost_estimate((sc, k, s, rs.duration,
                                           rs.warmup))
               for k, s in rs.units())


def host_cpu():
    """The host CPU's model, as ``lscpu`` or ``/proc/cpuinfo`` name it."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=10).stdout
        names = [line.split(":", 1)[1].strip() for line in out.splitlines()
                 if line.startswith(("Model name", "Vendor ID"))]
    except (OSError, subprocess.SubprocessError):
        names = []
    if not names:
        with open("/proc/cpuinfo") as f:
            names = [line.split(":", 1)[1].strip() for line in f
                     if line.startswith("model name")][:1]
    return " / ".join(names) or "unknown"


def bare(sa):
    """A scenario artifact without its walls, for a rerun's comparison."""
    sa = json.loads(json.dumps(sa))
    sa["run"].pop("wall_s")
    sa["run"].pop("stack_s", None)
    sa["summary"].pop("wall_s")
    for u in sa["units"] + sa["replicates"]:
        u.pop("wall_s")
    return sa


def run_gate(pool):
    """Phase 33: the gate's fidelity pairs and speedup floors on the port,
    the DES halves on the host and the batch halves on the card.  Returns
    the fan-in launches."""
    with open(os.path.join(ROOT, "benchmarks", "reference_bounds.json")) as f:
        ref = json.load(f)
    fidelity, speedup, bounds = ref["fidelity"], ref["speedup"], ref["bounds"]
    des = list(fidelity)
    for name, spec in speedup.items():
        des += [n for n in (name, spec["over"]) if n not in des]
    if len(fidelity) != 8 or len(speedup) != 3 or len(des) != 10:
        raise SystemExit(f"gate: {len(fidelity)} fidelity pairs, "
                         f"{len(speedup)} speedup floors, {len(des)} DES "
                         f"scenarios; expected 8, 3, 10")
    # the DES halves and the rerun go to the pool first (host only), the
    # costliest first; the batch halves follow through run_grids
    tasks = des + [GATE_RERUN]
    order = sorted(range(len(tasks)), key=lambda i: -des_cost(tasks[i]))
    jobs = {i: pool.apply_async(des_run, (tasks[i],)) for i in order}
    windows = [n + "/batch" for n in fidelity if n + "/batch" in bounds]
    batch, launches = run_grids(pool, "gate", [(n + "/batch", True)
                                               for n in fidelity], windows)
    got = [jobs[i].get() for i in range(len(tasks))]
    arts = {n: sa for n, (sa, _) in zip(des, got)}
    events = walls = 0
    for name, (sa, wall) in zip(des, got):
        run = sa["run"]
        events += run["events"]
        walls += run["wall_s"]
        bad = [u for u in sa["units"] if u.get("consistency") == "violation"]
        log(f"gate     {name:32s} des quick units={run['cells']} "
            f"events={run['events']} wall={run['wall_s']:.3f}s "
            f"({wall:.3f}s in the worker) events/s="
            f"{run['events'] / run['wall_s']:.0f} tput_mean="
            f"{sa['summary']['throughput']['mean']} consistency="
            f"{sa['consistency']}")
        if sa["backend"] != "des" or run["device"] != "host":
            raise SystemExit(f"{name}: not a discrete-event run: "
                             f"{sa['backend']}, {run['device']}")
        if bad:
            raise SystemExit(f"{name}: {len(bad)} unit(s) failed the "
                             f"linearizability audit")
    log(f"gate     DES halves: {events} events in {walls:.3f} s of unit "
        f"walls, {events / walls:.0f} events/s a worker; host CPU "
        f"{host_cpu()}, {os.cpu_count()} cores")
    again = got[-1][0]
    if bare(again) != bare(arts[GATE_RERUN]):
        raise SystemExit(f"{GATE_RERUN}: the DES rerun differs")
    log(f"gate     {GATE_RERUN} DES rerun bit for bit: True")
    for name, (lo, hi) in sorted(fidelity.items()):
        ratio = (batch[name + "/batch"]["summary"]["throughput"]["mean"]
                 / arts[name]["summary"]["throughput"]["mean"])
        log(f"gate     {name:32s} batch/des {ratio:.6f} in [{lo}, {hi}]: "
            f"{lo <= ratio <= hi}")
        if not lo <= ratio <= hi:
            raise SystemExit(f"{name}: batch/des throughput ratio {ratio} "
                             f"outside [{lo}, {hi}]")
    for name, spec in sorted(speedup.items()):
        ratio = (arts[name]["summary"]["throughput"]["mean"]
                 / arts[spec["over"]]["summary"]["throughput"]["mean"])
        log(f"gate     {name:32s} over {spec['over']} {ratio:.6f}x "
            f"(floor {spec['min']}x): {ratio >= spec['min']}")
        if ratio < spec["min"]:
            raise SystemExit(f"{name}: {ratio}x {spec['over']}, under the "
                             f"{spec['min']}x floor")
    for name in [n for n in des if n in bounds]:
        lo, hi = bounds[name]
        mean = arts[name]["summary"]["throughput"]["mean"]
        log(f"gate     {name} quick mean throughput {mean} "
            f"{'inside' if lo <= mean <= hi else 'OUTSIDE'} [{lo}, {hi}]")
        if not lo <= mean <= hi:
            raise SystemExit(f"{name}: quick mean throughput {mean} outside "
                             f"[{lo}, {hi}]")
    return launches


# -------------------------------------------------------------- phase 34
def engine_run(engine, obs=None, dur=0.4):
    """One run of ``benchmarks/sim_engine_bench.py``'s workload on the
    port's engine: PigPaxos N=25 R=3, 40 closed-loop clients, ``dur`` s of
    virtual time.  Returns (events, CPU s, wall s)."""
    from repro_torch.core import Cluster, PigConfig
    c = Cluster("pigpaxos", 25, pig=PigConfig(n_groups=3), seed=2,
                engine=engine, obs=obs)
    c.add_clients(40, stop_at=dur)
    t0, p0 = time.perf_counter(), time.process_time()
    events = c.sched.run(until=dur + 0.1)
    return events, time.process_time() - p0, time.perf_counter() - t0


def des_rest_run(name):
    """Pool worker: ``des_run`` and the wall-clock time it finished."""
    return (*des_run(name), time.time())


def engine_bench():
    """Pool worker: the exact and seed engines' events/s (``ENGINE_ROUNDS``
    interleaved rounds: each engine's fastest wall, the median of the
    rounds' ratios) and the exact engine's sampled-tracing CPU overhead
    (``TRACE_ROUNDS`` rounds of an untraced and a ``TRACE_RATE`` traced
    run, the order alternating; the minimum of the paired overheads, the
    gated number, and their median), as ``sim_engine_bench`` measures
    them."""
    runs = {"ref": [], "exact": []}
    ratios = []
    for _ in range(ENGINE_ROUNDS):
        rnd = {e: engine_run(e) for e in ("ref", "exact")}
        for e, r in rnd.items():
            runs[e].append(r)
        if rnd["ref"][0] != rnd["exact"][0]:
            return {"error": f"exact {rnd['exact'][0]} events, seed stack "
                             f"{rnd['ref'][0]}"}
        ratios.append((rnd["exact"][0] / rnd["exact"][2])
                      / (rnd["ref"][0] / rnd["ref"][2]))
    rate = {e: r[0][0] / min(w for _, _, w in r) for e, r in runs.items()}
    cfgs = [("untraced", None),
            ("traced", {"sample_rate": TRACE_RATE, "max_spans": 2_000_000})]
    cpu = {k: [] for k, _ in cfgs}
    events = set()
    for i in range(TRACE_ROUNDS):
        for k, obs in (cfgs if i % 2 == 0 else cfgs[::-1]):
            ev, c, _ = engine_run("exact", obs=obs)
            events.add(ev)
            cpu[k].append(c)
    if len(events) != 1:
        return {"error": f"tracing changed the events: {sorted(events)}"}
    done_at = time.time()
    per_round = [max(0.0, 1.0 - u / t)
                 for u, t in zip(cpu["untraced"], cpu["traced"])]
    return {"events": runs["ref"][0][0], "events_per_s": rate,
            "exact_over_ref": sorted(ratios)[len(ratios) // 2],
            "ratios": ratios, "cpu_s": cpu, "per_round": per_round,
            "overhead": min(per_round),
            "overhead_median": sorted(per_round)[len(per_round) // 2],
            "done_at": done_at}


def lower_priority():
    """Pool initializer: this worker (and what it starts) at nice
    ``DES_NICE``."""
    os.nice(DES_NICE)


def submit_des_rest(pool, ckpt_dir, device_type):
    """Phase 34's jobs to ``pool`` (host only): the engine bench first,
    then the 18 scenarios and the rerun, the costliest first, then phase
    35's two trainer processes (into ``ckpt_dir``).  Returns (the jobs,
    the submission time)."""
    tasks = list(DES_REST) + [DES_REST_RERUN]
    order = sorted(range(len(tasks)), key=lambda i: -des_cost(tasks[i]))
    jobs = {"bench": pool.apply_async(engine_bench)}
    for i in order:
        jobs[i] = pool.apply_async(des_rest_run, (tasks[i],))
    jobs["train"] = pool.apply_async(train_cli_runs,
                                     (ckpt_dir, device_type))
    return jobs, time.time()


def run_des_rest(jobs, t_submit):
    """Phase 34: collect the 18 scenarios' artifacts and hold them to the
    unchanged gate's windows; the rerun bit for bit; the engine bench."""
    from benchmarks import regression_gate
    with open(os.path.join(ROOT, "benchmarks", "reference_bounds.json")) as f:
        ref = json.load(f)
    got = [jobs[i].get() for i in range(len(DES_REST) + 1)]
    bench = jobs["bench"].get()
    done = [t for _, _, t in got] + [bench.get("done_at", t_submit)]
    log(f"des      the last job finished {max(done) - t_submit:.2f} s after "
        f"their submission, collected {time.time() - t_submit:.2f} s after "
        f"it ({DES_WORKERS} workers beside the batch pool)")
    arts = {n: sa for n, (sa, _, _) in zip(DES_REST, got)}
    events = walls = 0
    for name, (sa, wall, _) in zip(DES_REST, got):
        run = sa["run"]
        events += run["events"]
        walls += run["wall_s"]
        units = sa["units"]
        log(f"des      {name:28s} units={run['cells']} events="
            f"{run['events']} wall={run['wall_s']:.3f}s ({wall:.3f}s in "
            f"the worker) unit walls="
            f"{[round(u['wall_s'], 3) for u in units]} events/s="
            f"{run['events'] / run['wall_s']:.0f} tput_mean="
            f"{sa['summary']['throughput']['mean']} consistency="
            f"{sa['consistency']}")
        if sa["backend"] != "des" or run["device"] != "host":
            raise SystemExit(f"{name}: not a discrete-event run: "
                             f"{sa['backend']}, {run['device']}")
        ex = units[0].get("extras") or {}
        if name.startswith(("failover/", "lease/")):
            log(f"des      {name:28s} unavail_ms={ex.get('unavail_ms')} "
                f"failovers={ex.get('failover_events')}")
            if not ex.get("failover_events"):
                raise SystemExit(f"{name}: the failover policy promoted "
                                 f"no successor")
        if name.startswith("overload/"):
            log(f"des      {name:28s} admission="
                f"{[u['extras']['admission'] for u in units]}")
        if name.startswith("obs/"):
            ob = ex.get("obs") or {}
            log(f"des      {name:28s} trace={ob.get('trace')} "
                f"critical_path={ob.get('critical_path')}")
            if not ob.get("cpu_busy_s"):
                raise SystemExit(f"{name}: no obs section")
    log(f"des      {len(DES_REST)} scenarios: {events} events in "
        f"{walls:.3f} s of unit walls, {events / walls:.0f} events/s a "
        f"worker; host CPU {host_cpu()}, {os.cpu_count()} cores")
    if bare(got[-1][0]) != bare(arts[DES_REST_RERUN]):
        raise SystemExit(f"{DES_REST_RERUN}: the rerun differs")
    log(f"des      {DES_REST_RERUN} rerun bit for bit: True")
    fed = {"bounds": {n: w for n, w in ref["bounds"].items() if n in arts},
           "overload": {n: w for n, w in ref["overload"].items()
                        if n in arts}}
    failures, lines = regression_gate.evaluate(arts, fed)
    fair_fail, fair_lines = regression_gate.evaluate_obs_fairness(
        arts, ref["obs_fairness"])
    for line in lines + fair_lines:
        log(f"des      gate {line}")
    if len(fed["bounds"]) != 9 or len(fed["overload"]) != 2:
        raise SystemExit(f"des: {len(fed['bounds'])} bounds and "
                         f"{len(fed['overload'])} overload windows; "
                         f"expected 9 and 2")
    if failures or fair_fail:
        raise SystemExit(f"des: the gate failed: {failures + fair_fail}")
    if "error" in bench:
        raise SystemExit(f"engine bench: {bench['error']}")
    rate = bench["events_per_s"]
    log(f"des      engines on {bench['events']} events (PigPaxos N=25 R=3, "
        f"40 clients, 0.4 s): exact {rate['exact']:.0f} events/s, seed "
        f"stack {rate['ref']:.0f}; exact/ref median "
        f"{bench['exact_over_ref']:.4f} (rounds "
        f"{[round(r, 4) for r in bench['ratios']]})")
    payload = {"tracing_overhead_frac": round(bench["overhead"], 4)}
    tfail, tlines = regression_gate.evaluate_sim_engine(payload,
                                                        ref["sim_engine"])
    log(f"des      tracing at rate {TRACE_RATE}: overhead (minimum) "
        f"{bench['overhead']:.4f}, median {bench['overhead_median']:.4f}, "
        f"per round {[round(o, 4) for o in bench['per_round']]}; CPU s "
        f"untraced {[round(c, 3) for c in bench['cpu_s']['untraced']]}, "
        f"traced {[round(c, 3) for c in bench['cpu_s']['traced']]}")
    for line in tlines:
        log(f"des      gate {line}")
    if tfail:
        raise SystemExit(f"des: {tfail}")


# --------------------------------------------------------------- phase 2
def build_kernels():
    """Build the kernels at once (one nvcc each) and print what ptxas says
    of their registers, shared memory and spills."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all(KERNELS)
    log(f"build    {', '.join(lib.name for lib in libs)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for lib in libs:
        entry = lib.name.split("-")[0]
        for line in lib.with_suffix(".log").read_text().splitlines():
            m = re.search(r"Compiling entry function '\w*?\d+([a-z_]+_kernel)"
                          r"(?:I(f|13__nv_bfloat16)?"
                          r"(?:Li(\d+)E(?:Li(\d+)E)?)?)?", line)
            if m:
                kernel, dt, a, c = m.groups()
                dims = f"Dh {a}" if c is None else f"Dk {a}, chunk {c}"
                # the sm90 flash kernel takes bf16 alone: no type argument
                dtype = {"f": "f32", None: "bf16"}.get(dt, "bf16")
                entry = (f"{kernel}<{dtype}, {dims}>" if a is not None
                         else f"{kernel}<{dtype}>" if dt else kernel)
            elif ("registers" in line or "smem" in line or "spill" in line
                  or "serialized" in line):
                log(f"build    {entry} ptxas: {line.strip()}")
    from repro_torch.kernels import segfanin
    log("build    seg_fanin_sm90 (fanin_rows_kernel, fanin_groups_kernel) "
        "dynamic shared memory, rows and warps per block: "
        + ", ".join(f"F {F}: {segfanin.sm90_smem_bytes(F)} B, "
                    f"{segfanin.geometry(F)[0]} x {segfanin.geometry(F)[1]}"
                    for F in (24, 256, 1024, 2048)))
    log("build    flash_attention_kernel dynamic shared memory per block "
        "(3 x 64 x (Dh+1) + 64 x 64 f32, as its launcher requests): "
        + ", ".join(f"Dh {dh}: {(3 * 64 * (dh + 1) + 64 * 64) * 4} B"
                    for dh in (32, 64, 128, 256)))
    log("build    flash_wgmma_kernel dynamic shared memory per block (bf16 "
        "Q of 128 rows + 2 stages of K and V tiles of 64 keys "
        "+ 128 B of mbarriers + 1024 B to align, as its launcher requests): "
        + ", ".join(f"Dh {dh}: {sm90_smem(dh)} B" for dh in (64, 128, 256)))
    import ctypes
    smem = ctypes.CDLL(str(libs[KERNELS.index("ssm_scan_sm90")]))
    smem = smem.ssm_scan_sm90_smem_bytes
    log("build    ssm_mma_kernel dynamic shared memory per block (2 stages "
        "of 64-row tiles of log_a, q, k, v + (k e^{Atot-A})^T + scores hi/lo "
        "+ e^{Atot}, as its launcher requests): "
        f"bf16 {smem(1)} B (two blocks an SM), f32 {smem(0)} B")


def sm90_smem(dh):
    # bf16: Q of 128 rows, 2 stages of a K and a V tile of 64 keys
    return 2 * 128 * dh + 2 * 2 * 2 * 64 * dh + 128 + 1024


# --------------------------------------------------------------- phase 7
def flash_inputs(B, Hq, Hkv, S, Dh, device, seed, layout="bhsd",
                 dtype="bf16"):
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (lambda h: (B, h, S, Dh)) if layout == "bhsd" else \
        (lambda h: (B, S, h, Dh))
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    return [torch.randn(shape(h), generator=g, device=device).to(dt)
            for h in (Hq, Hkv, Hkv)]


def flash_case(device, name, B, Hq, Hkv, S, Dh, causal, layout, dtype, seed):
    """One call of the layout's wrapper against the plain version: the
    launches it made (all, sm90), rerun equality, and the error."""
    import torch
    from repro_torch.kernels import flash_attention
    q, kk, v = flash_inputs(B, Hq, Hkv, S, Dh, device, seed, layout, dtype)
    fn = getattr(flash_attention, f"flash_attention_{layout}")
    n0, s0 = flash_attention.launches, flash_attention.launches_sm90
    got = fn(q, kk, v, causal=causal)
    launched = flash_attention.launches - n0
    sm90 = flash_attention.launches_sm90 - s0
    again = fn(q, kk, v, causal=causal)
    want = flash_attention._plain(q, kk, v, causal, None, layout)
    torch.cuda.synchronize()
    atol, rtol = (FLASH_ATOL, FLASH_RTOL) if dtype == "bf16" else \
        (FLASH_F32_ATOL, FLASH_F32_RTOL)
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    ratio = (diff / (atol + rtol * want.float().abs())).max().item()
    same = torch.equal(got, again)
    wants_sm90 = int(dtype == "bf16" and Dh in flash_attention.SM90_HEAD_DIMS)
    ok = ratio <= 1.0 and launched == 1 and sm90 == wants_sm90 and same \
        and bool(torch.isfinite(got.float()).all())
    kernel = "flash_attention_sm90.cu" if sm90 else "flash_attention.cu"
    log(f"flash    {name:20s} {layout} {dtype} B={B} Hq={Hq} Hkv={Hkv} S={S} "
        f"Dh={Dh} causal={causal}: {kernel}, launches={launched} "
        f"(sm90 {sm90}) rerun_equal={same} max_abs_err={err} worst "
        f"err/tolerance={ratio:.4f} (tolerance |d| <= {atol} + "
        f"{rtol}|ref|)")
    if not ok:
        raise SystemExit(f"flash_attention kernel != plain version at {name} "
                         f"({layout}, {dtype})")
    return err


def check_flash(device):
    """The sm90 kernel at FLASH_CASES (B, H, S, Dh) and FLASH_BSHD_CASES
    (B, S, H, Dh) in bf16; the CUDA-core kernel at FLASH_CASES in f32.
    Returns the sm90 kernel's worst error."""
    worst = 0.0
    for k, (name, *shape) in enumerate(FLASH_CASES):
        worst = max(worst, flash_case(device, name, *shape, "bhsd", "bf16",
                                      seed=k))
    for k, (name, *shape) in enumerate(FLASH_BSHD_CASES):
        worst = max(worst, flash_case(device, name, *shape, "bshd", "bf16",
                                      seed=10 + k))
    for k, (name, *shape) in enumerate(FLASH_CASES):
        flash_case(device, name, *shape, "bhsd", "f32", seed=20 + k)
    for k, (name, *shape) in enumerate(FLASH_PADDED_CASES):
        worst = max(worst, flash_padded_case(device, name, *shape,
                                             seed=30 + k))
    return worst


def flash_padded_case(device, name, B, Hq, Hkv, S, Dh, causal, seed):
    """``ops.flash_attention`` on (B, S, H, Dh) bf16 tensors whose head dim
    no kernel takes: padded to ``padded_head_dim``, one launch of the sm90
    kernel, against the plain version at the unpadded Dh."""
    import torch
    from repro_torch.kernels import flash_attention, ops
    q, kk, v = flash_inputs(B, Hq, Hkv, S, Dh, device, seed, "bshd")
    n0, s0 = flash_attention.launches, flash_attention.launches_sm90
    got = ops.flash_attention(q, kk, v, causal=causal)
    launched = flash_attention.launches - n0
    sm90 = flash_attention.launches_sm90 - s0
    again = ops.flash_attention(q, kk, v, causal=causal)
    want = flash_attention._plain(q, kk, v, causal, None, "bshd")
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    ratio = (diff / (FLASH_ATOL + FLASH_RTOL * want.float().abs())
             ).max().item()
    same = torch.equal(got, again)
    size = flash_attention.padded_head_dim(q.dtype, Dh)
    ok = (ratio <= 1.0 and launched == sm90 == 1 and same
          and got.shape == q.shape
          and bool(torch.isfinite(got.float()).all()))
    log(f"flash    {name:20s} bshd bf16 B={B} Hq={Hq} Hkv={Hkv} S={S} "
        f"Dh={Dh} padded to {size}: flash_attention_sm90.cu, launches="
        f"{launched} (sm90 {sm90}) rerun_equal={same} max_abs_err={err} "
        f"worst err/tolerance={ratio:.4f} (tolerance |d| <= {FLASH_ATOL} + "
        f"{FLASH_RTOL}|ref|)")
    if not ok:
        raise SystemExit(f"flash_attention padded head dim != plain version "
                         f"at {name}")
    return err


# --------------------------------------------------------------- phase 8
def time_flash(device):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.kernels.ref import flash_attention_ref
    _, B, Hq, Hkv, S, Dh, _ = FLASH_CASES[0]
    q, k, v = flash_inputs(B, Hq, Hkv, S, Dh, device, seed=0)
    ms = time_ms(lambda: flash_attention.flash_attention_bhsd(q, k, v), 50,
                 warmup=5)
    plain_ms = time_ms(lambda: flash_attention_ref(q, k, v), 5, warmup=2)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 50, warmup=5)
    # the CUDA-core kernel on the same bf16 inputs (its launcher still takes
    # bf16 at Dh 128; the wrapper sends only f32 and Dh 32 there)
    cuda_core_ms = time_ms(lambda: flash_attention._launch_f32(
        q, k, v, True, 1.0 / math.sqrt(Dh)), 10, warmup=2)
    # the model's layout: ops.flash_attention reads it where it lies; a
    # (B, H, S, Dh) kernel needs q, k, v copied to that layout, and the
    # model's reshape copies the transposed output back
    qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    bshd_ms = time_ms(lambda: ops.flash_attention(qs, ks, vs), 50, warmup=5)
    copies_ms = time_ms(lambda: flash_attention.flash_attention_bhsd(
        *(t.transpose(1, 2).contiguous() for t in (qs, ks, vs))
    ).transpose(1, 2).reshape(B, S, Hq * Dh), 50, warmup=5)
    ops_ = 4 * B * Hq * Dh * S * (S + 1) // 2    # QK^T and PV, causal pairs
    nbytes = 2 * B * S * Dh * (2 * Hq + 2 * Hkv)   # q, k, v read, o written
    ops_ms = ops_ / BF16_OPS_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    log(f"timing   flash_attention B={B} Hq={Hq} Hkv={Hkv} S={S} Dh={Dh} "
        f"bf16 causal: kernel (flash_attention_sm90.cu) {ms:.6f} ms, plain "
        f"version {plain_ms:.6f} ms, library (scaled_dot_product_attention) "
        f"{library_ms:.6f} ms, bound {bound_ms:.6f} ms ({ops_} ops at 989 "
        f"TFLOP/s bf16 = {ops_ms:.6f} ms; {nbytes} bytes at 3.35 TB/s = "
        f"{bytes_ms:.6f} ms); kernel at {100 * bound_ms / ms:.2f}% of its "
        f"bound, {ops_ / ms / 1e9:.2f} TFLOP/s, {ms / library_ms:.3f}x the "
        f"library's time; the CUDA-core kernel (flash_attention.cu) on the "
        f"same bf16 inputs {cuda_core_ms:.6f} ms")
    log(f"timing   model layout (B, S, H, Dh): ops.flash_attention "
        f"{bshd_ms:.6f} ms; the same kernel behind transposes and copies "
        f"(q, k, v in, o out) {copies_ms:.6f} ms; the copies "
        f"{copies_ms - bshd_ms:.6f} ms a layer")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": library_ms, "zamba2_timing": time_flash_padded(
                device)}


def time_flash_padded(device):
    """``ops.flash_attention`` at zamba2-7b's shared attention, (B, S, H,
    Dh) = (4, 2048, 32, 112) bf16, which it pads to Dh 128 for the sm90
    kernel (the pads, the launch and the slice), beside two bounds (the
    Dh-112 work the model needs; the padded work the kernel does), the
    plain version and PyTorch's fused attention at Dh 112."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, ops
    B, S, H, Dh = 4, SERVE_PROMPT, 32, 112
    q, k, v = flash_inputs(B, H, H, S, Dh, device, seed=40, layout="bshd")
    ms = time_ms(lambda: ops.flash_attention(q, k, v), 50, warmup=5)
    plain_ms = time_ms(lambda: flash_attention._plain(
        q, k, v, True, None, "bshd"), 5, warmup=2)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 50, warmup=5)
    out = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms}
    for tag, d in (("dh112", Dh), ("padded", 128)):
        ops_ = 4 * B * H * d * S * (S + 1) // 2
        nbytes = 2 * B * S * d * 4 * H         # q, k, v read, o written
        out[f"bound_ms_{tag}"] = max(ops_ / BF16_OPS_S, nbytes / HBM_BYTES_S
                                     ) * 1e3
        out[f"ops_{tag}"] = ops_
    log(f"timing   flash_attention at zamba2-7b's shared attention B={B} "
        f"S={S} H={H} Dh={Dh} bf16 causal through ops.flash_attention "
        f"(padded to Dh 128, flash_attention_sm90.cu): {ms:.6f} ms; bound "
        f"of the Dh-112 work {out['bound_ms_dh112']:.6f} ms "
        f"({out['ops_dh112']} ops at 989 TFLOP/s), "
        f"{100 * out['bound_ms_dh112'] / ms:.2f}% of it; bound of the "
        f"padded work {out['bound_ms_padded']:.6f} ms "
        f"({out['ops_padded']} ops), {100 * out['bound_ms_padded'] / ms:.2f}"
        f"%; plain version {plain_ms:.6f} ms; library "
        f"(scaled_dot_product_attention at Dh 112) {library_ms:.6f} ms, the "
        f"kernel {ms / library_ms:.3f}x its time")
    return out


# --------------------------------------------------------------- phase 9
def new_model(device, arch, **cut):
    """A full-width model of ``arch`` (``cut``: fields replaced, e.g. a depth
    cut) with random weights from seed 0 on the card, and 4 prompts of
    2048 random tokens from seed 1; its parameter count held to the
    config's (less the reference's shortfall for the Mamba2 families)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.config import param_count_shortfall
    cfg = get_config(arch).replace(**cut)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device).manual_seed(0),
                         device=device)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    f32 = sorted({name.rsplit(".", 1)[-1] for name, p in
                  params.named_parameters() if p.dtype == torch.float32})
    log(f"serve    {cfg.name}{' cut ' + str(cut) if cut else ''}: "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.dh}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, family {cfg.family}; {n} parameters, {nbytes} bytes "
        f"(bf16, but f32 {', '.join(f32)}) from a seed in "
        f"{time.perf_counter() - t0:.2f} s; the config's param_count "
        f"{cfg.param_count()}; peak memory "
        f"{torch.cuda.max_memory_allocated()} bytes")
    if n != cfg.param_count() + param_count_shortfall(cfg):
        raise SystemExit(f"{n} parameters, the config counts "
                         f"{cfg.param_count()}")
    prompts = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_PROMPT),
                            device=device,
                            generator=torch.Generator(device).manual_seed(1))
    return cfg, params, prompts


def zero_counts():
    """Every kernel's launch counts to 0 (the main path's run starts)."""
    from repro_torch.kernels import (flash_attention, pig_aggregate,
                                     segfanin, ssm_scan)
    for mod in (flash_attention, ssm_scan, segfanin, pig_aggregate):
        mod.launches = 0
    flash_attention.launches_sm90 = ssm_scan.launches_sm90 = 0


def read_counts(kernel):
    """(``kernel``'s sm90 launches, its launches, every other kernel's);
    ``kernel`` a kernel module, or None (every kernel is another)."""
    from repro_torch.kernels import (flash_attention, pig_aggregate,
                                     segfanin, ssm_scan)
    others = {m.__name__.rsplit(".", 1)[-1]: m.launches
              for m in (flash_attention, ssm_scan, segfanin, pig_aggregate)
              if m is not kernel}
    if kernel is None:
        return 0, 0, others
    return kernel.launches_sm90, kernel.launches, others


def full(t):
    """A DTensor's whole value (a plain tensor as it is)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def on_mesh(cache, prompts, mesh):
    """(cache, prompts, context): placed on ``mesh`` with the sharding
    layer's specs, and its rules' context; as they are, and a null
    context, without a mesh."""
    import contextlib
    if mesh is None:
        return cache, prompts, contextlib.nullcontext()
    from repro_torch.shard import sharding_rules
    from repro_torch.train import sharding as S
    cache = S.place(cache, S.cache_shardings(cache, mesh, False), mesh)
    x = S.distribute(prompts, mesh,
                     S.batch_sharding({"t": prompts}, mesh, False)["t"])
    return cache, x, sharding_rules(mesh, S.activation_rules(False))


def run_generate(device, cfg, params, prompts, kernel, impl, want,
                 gen=SERVE_GEN, mesh=None):
    """The main path of a serving slice: ``generate`` with ``impl`` from an
    empty cache, every kernel count set to 0 just before and read just
    after; the sm90 entry of ``kernel`` (a kernel module) must launch
    ``want`` times (the prefill's) and no other kernel at all.  On
    ``mesh`` (placed parameters) the cache and the prompts are placed too
    and ``generate`` runs under the sharding rules.  Returns (its
    launches, the generated tokens, {the cache, the wall s, the peak
    bytes}), tokens and cache as placed."""
    import torch
    from repro_torch.launch.serve import generate
    from repro_torch.models import make_cache
    cache, x, ctx = on_mesh(
        make_cache(cfg, SERVE_B, SERVE_PROMPT + gen, device=device), prompts,
        mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with ctx:
        zero_counts()
        t0 = time.perf_counter()
        out = generate(params, cfg, cache, tokens=x, gen=gen, impl=impl)
        wall = time.perf_counter() - t0
        sm90, launches, others = read_counts(kernel)
        tokens = full(out.tokens)
    name = kernel.__name__.rsplit(".", 1)[-1]
    peak = torch.cuda.max_memory_allocated()
    tok_s = SERVE_B * (gen - 1) / out.decode_s
    where = "" if mesh is None else " (sharded, one-rank mesh)"
    log(f"serve    {cfg.name}{where} prefill {SERVE_B}x{SERVE_PROMPT} "
        f"tokens (cold): {1e3 * out.prefill_s:.3f} ms; decode {gen - 1} "
        f"steps: {1e3 * out.decode_s:.3f} ms, "
        f"{1e3 * out.decode_s / (gen - 1):.3f} ms a step, {tok_s:.2f} "
        f"tokens/s; peak memory {peak} bytes ({peak / 2**30:.2f} GiB, "
        f"weights and cache included); {name} launches {launches} (sm90 "
        f"{sm90}), other kernels' launches {others}")
    log(f"serve    first sequence: {tokens[0].tolist()}")
    if not launches == sm90 == want or any(others.values()):
        raise SystemExit(f"{cfg.name}{where}: {name} launches {launches} "
                         f"(sm90 {sm90}), expected {want} of the sm90 kernel "
                         f"(the prefill's), other kernels {others}")
    if tokens.shape != (SERVE_B, gen) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab)).all()):
        raise SystemExit(f"generated tokens out of range: {tokens.shape}")
    return sm90, tokens, {"cache": cache, "wall": wall, "peak": peak}


# --------------------------------------------------------------- phase 10
def rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


class FlashInputs:
    """Keeps the (q, k, v) of every ``ops.flash_attention`` call made inside
    it (the attention inputs of a prefill's layers, or shared-block
    applications) and serves each call through the kernel."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.calls, self.served = [], ops.flash_attention

        def keep(q, k, v, causal=True):
            self.calls.append((q, k, v, causal))
            return self.served(q, k, v, causal=causal)
        ops.flash_attention = keep
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.flash_attention = self.served


def flash_on_inputs(name, calls):
    """The kernel (through ``ops.flash_attention``, padded as the model
    calls it) against the plain version on each call's own inputs, within
    phase 7's bound.  Returns (the worst err/tolerance, the max |d|)."""
    import torch
    from repro_torch.kernels import flash_attention, ops
    ratios, rels, errs = [], [], []
    for q, k, v, causal in calls:
        got = ops.flash_attention(q, k, v, causal=causal)
        want = flash_attention._plain(q, k, v, causal, None, "bshd")
        torch.cuda.synchronize()
        d = got.float() - want.float()
        rels.append(float(f"{(d.norm() / want.float().norm()).item():.3g}"))
        ratios.append((d.abs() / (FLASH_ATOL + FLASH_RTOL
                                  * want.float().abs())).max().item())
        errs.append(d.abs().max().item())
        del got, want, d
    log(f"check    {name}: {len(calls)} attention calls {tuple(q.shape)} "
        f"(B, S, H, Dh), the sm90 kernel vs the plain version on each "
        f"call's own bf16 inputs: relative L2 {rels}; max_abs_err "
        f"{max(errs)}; worst err/tolerance {max(ratios):.4f} (tolerance "
        f"|d| <= {FLASH_ATOL} + {FLASH_RTOL}|ref|)")
    return max(ratios), max(errs)


def prefill_run(device, cfg, params, prompts, impl, dtype=None,
                kernel=None):
    """One prefill through ``build_prefill_step`` from an empty cache:
    (last-token logits in f32, the cache, host seconds, launches of
    ``kernel``, a kernel module: by default flash_attention)."""
    import torch
    from repro_torch.kernels import flash_attention
    from repro_torch.models import make_cache
    from repro_torch.train import build_prefill_step
    cache = make_cache(cfg, SERVE_B, SERVE_PROMPT + SERVE_GEN,
                       dtype=dtype or torch.bfloat16, device=device)
    kernel = kernel or flash_attention
    torch.cuda.synchronize()
    n0 = kernel.launches
    t0 = time.perf_counter()
    logits, cache = build_prefill_step(cfg, impl=impl)(params, cache,
                                                       tokens=prompts)
    torch.cuda.synchronize()
    return (logits.float(), cache, time.perf_counter() - t0,
            kernel.launches - n0)


def same_cache(a, b):
    import torch
    return all(torch.equal(a[g][n], b[g][n]) for g in a for n in a[g])


def check_serve(device, cfg, params, prompts, served, flash_ms):
    """granite-8b: the ``ref`` prefill against the flash one within
    ``SERVE_REL_L2``; two flash prefills bit-identical and launching once a
    layer, their first tokens generate's; each layer's attention kernel
    call against the plain version; decode counted and traced.  Returns
    the kernel's max |d| from the plain version."""
    import torch
    ref, _, ref_s, ref_n = prefill_run(device, cfg, params, prompts, "ref")
    with FlashInputs() as calls:
        a, ca, a_s, a_n = prefill_run(device, cfg, params, prompts, "flash")
    b, cb, b_s, b_n = prefill_run(device, cfg, params, prompts, "flash")
    same = torch.equal(a, b) and same_cache(ca, cb)
    del cb
    finite = bool(torch.isfinite(a).all())
    # generate's first tokens are the greedy ones of this same prefill
    same_first = torch.equal(a.argmax(-1).to(torch.int32), served[:, 0])
    rel = rel_l2(a, ref)
    dmax = (a - ref).abs().max().item()
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * dmax
    agree = torch.equal(a.argmax(-1)[clear], ref.argmax(-1)[clear])
    log(f"check    {cfg.name} prefill flash vs ref (attention_chunked): "
        f"relative L2 {rel} (tolerance {SERVE_REL_L2}), max |d| {dmax}; "
        f"greedy first tokens {a.argmax(-1).tolist()} vs "
        f"{ref.argmax(-1).tolist()}, compared {int(clear.sum())} rows with "
        f"top-2 margin > 2 max|d|: equal={agree}; finite logits={finite}; "
        f"two flash prefills bit-identical={same} (their first tokens equal "
        f"generate's: {same_first}); flash launches a prefill {a_n} / {b_n}"
        f", ref {ref_n}; warm prefill ms: flash {1e3 * a_s:.3f} / "
        f"{1e3 * b_s:.3f}, ref {1e3 * ref_s:.3f}")
    log(f"serve    warm flash prefill {1e3 * b_s:.3f} ms; flash "
        f"{cfg.n_layers} x {flash_ms:.6f} ms (phase 8) = "
        f"{cfg.n_layers * flash_ms:.3f} ms, "
        f"{100 * cfg.n_layers * flash_ms / (1e3 * b_s):.2f}% of it")
    if not (rel <= SERVE_REL_L2 and agree and same and same_first and finite
            and a_n == b_n == len(calls.calls) == cfg.n_layers
            and ref_n == 0):
        raise SystemExit(f"{cfg.name} flash prefill check failed")
    del ref
    ratio, err = flash_on_inputs(f"{cfg.name} attention by layer",
                                 calls.calls)
    del calls
    if ratio > 1.0:
        raise SystemExit(f"{cfg.name}: the kernel != plain version on a "
                         f"layer's attention")
    trace_decode(device, cfg, params, ca, a.argmax(-1).to(torch.int32))
    return err


def trace_decode(device, cfg, params, cache, tok):
    """Decode steps of granite-8b from a flash prefill's cache: none may
    launch flash_attention; one step's aten operations are counted;
    DECODE_STEPS steps are timed on the host, then DECODE_STEPS more run
    under ``torch.profiler`` for the device's kernels, busy time and idle
    share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.experiments.trace import _busy_us
    from repro_torch.kernels import flash_attention
    from repro_torch.train import build_serve_step
    class CountOps(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    step = build_serve_step(cfg, impl="flash")
    state = {"tok": tok, "pos": SERVE_PROMPT}

    def run(n):
        for _ in range(n):
            pos = torch.full((SERVE_B,), state["pos"], dtype=torch.int32,
                             device=device)
            _, state["tok"] = step(params, cache, state["tok"], pos)
            state["pos"] += 1
        torch.cuda.synchronize()

    n0 = flash_attention.launches
    run(1)                                       # warm
    counter = CountOps()
    with counter:
        run(1)
    t0 = time.perf_counter()
    run(DECODE_STEPS)
    step_ms = 1e3 * (time.perf_counter() - t0) / DECODE_STEPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(DECODE_STEPS)
        traced_ms = 1e3 * (time.perf_counter() - t0) / DECODE_STEPS
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = 1e-3 * _busy_us(kernels) / DECODE_STEPS
    launched = flash_attention.launches - n0
    log(f"decode   {cfg.name} B={SERVE_B} at positions {SERVE_PROMPT}..: "
        f"{counter.n} aten operations a step (counted on one step); "
        f"{step_ms:.3f} ms a step untraced ({DECODE_STEPS} steps), "
        f"{traced_ms:.3f} ms traced; device kernels a step "
        f"{len(kernels) / DECODE_STEPS}, device busy {busy_ms:.3f} ms a "
        f"step, idle share {1 - busy_ms / traced_ms:.4f} of the traced "
        f"wall; flash_attention launches in {2 + 2 * DECODE_STEPS} decode "
        f"steps: {launched}")
    if launched != 0 or not kernels:
        raise SystemExit(f"decode: {launched} flash launches (expected 0), "
                         f"{len(kernels)} device kernels traced")


def check_smoke(device, cfg, kernel, impl, tol=None, rel_tol=None,
                dtype="bf16", want=None):
    """A smoke config through the prefill step and ``generate`` (16
    tokens) on the card and on the CPU (the plain version), from one CPU
    init and the same prompts.  ``kernel`` (a kernel module, reached through
    ``impl``) launches ``want`` times a prefill on the card (default: once
    a layer), none in decode and none on the CPU.  The last-token logits
    within ``tol`` (max |d|) and ``rel_tol`` (relative L2, where given),
    the generated tokens equal on the rows whose first margin exceeds
    ``tol``.  With ``tol`` None the run holds the launches alone."""
    import torch
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_params, make_cache
    from repro_torch.train import build_prefill_step
    want = cfg.n_layers if want is None else want
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    params = init_params(cfg, torch.Generator().manual_seed(0), dtype=dt,
                         device="cpu")
    prompts = torch.randint(0, cfg.vocab, (4, 64),
                            generator=torch.Generator().manual_seed(1))
    runs = []
    for dev in (device, torch.device("cpu")):
        p = params.to(dev)
        n0 = kernel.launches
        logits, _ = build_prefill_step(cfg, impl=impl)(
            p, make_cache(cfg, 4, 64, dtype=dt, device=dev),
            tokens=prompts.to(dev))
        n1 = kernel.launches
        toks = generate(p, cfg, make_cache(cfg, 4, 80, dtype=dt, device=dev),
                        tokens=prompts.to(dev), gen=16, impl=impl).tokens
        runs.append((toks.cpu(), logits.float().cpu(), n1 - n0,
                     kernel.launches - n1))
    (tg, lg, pg, gg), (tc, lc, pc, gc) = runs
    ok = pg == gg == want and pc == gc == 0
    counts = (f"{kernel.__name__.rsplit('.', 1)[-1]} launches: card prefill "
              f"{pg}, generate {gg} (decode adds none), cpu {pc}/{gc}")
    head = f"check    {cfg.name} ({cfg.family}, {dtype}) generate card vs cpu"
    if tol is None:
        log(f"{head}: launches alone, values not held here; {counts}")
    else:
        rel, dmax = rel_l2(lg, lc), (lg - lc).abs().max().item()
        top2 = lc.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > tol
        same = bool((tg == tc).all(dim=1)[clear].all())
        log(f"{head}: prefill logits max |d| {dmax} (tolerance {tol}), "
            f"relative L2 {rel}"
            + (f" (tolerance {rel_tol})" if rel_tol is not None else "")
            + "; tokens equal on "
            f"{int((tg == tc).all(dim=1).sum())} of 4 rows, required on the "
            f"{int(clear.sum())} rows with a clear first margin: {same}; "
            f"{counts}")
        ok = (ok and dmax <= tol and (rel_tol is None or rel <= rel_tol)
              and same and bool(torch.isfinite(lg).all()))
    if not ok:
        raise SystemExit(f"{cfg.name} card and cpu disagree")


# --------------------------------------------------------------- phase 11
def same_bits(a, b):
    """Bit equality (``torch.equal`` takes -0 for +0)."""
    import torch
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(ints[a.element_size()]), b.view(ints[b.element_size()]))


def pig_inputs(G, N, block, kind, device, seed):
    """The relay's input: G quantized rows of normal values (every third
    block all zero for ``zeros``), or -127/+127 shards with random scales
    (``extremes``)."""
    import torch
    from repro_torch.kernels.pig_aggregate import quantize_blockwise
    g = torch.Generator(device=device).manual_seed(seed)
    if kind == "extremes":
        q = torch.randint(0, 2, (G, N), generator=g, device=device,
                          dtype=torch.int16) * 254 - 127
        s = torch.rand((G, N // block), generator=g, device=device) * 10
        return q.to(torch.int8), s + 1e-3
    q = torch.empty((G, N), dtype=torch.int8, device=device)
    s = torch.empty((G, N // block), device=device)
    for r in range(G):
        x = torch.randn(N, generator=g, device=device)
        if kind == "zeros":
            x.view(-1, block)[::3] = 0.0
        q[r], s[r] = quantize_blockwise(x, block)
    return q, s


def check_pig(device):
    import torch
    from repro_torch.kernels import pig_aggregate
    from repro_torch.kernels.ref import pig_aggregate_ref
    worst = 0.0
    for k, (name, G, N, block, kind) in enumerate(PIG_CASES):
        shards, scales = pig_inputs(G, N, block, kind, device, seed=k)
        before = pig_aggregate.launches
        got = pig_aggregate.pig_aggregate(shards, scales, block)
        launched = pig_aggregate.launches - before
        again = pig_aggregate.pig_aggregate(shards, scales, block)
        want = pig_aggregate_ref(shards, scales, block)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        worst = max(worst, err)
        ok = same_bits(got, want) and same_bits(got, again) \
            and launched == 1
        log(f"pig      {name:26s} G={G:2d} N={N:10d} block={block:4d} "
            f"launches={launched} equal={ok} (tolerance: bit equality) "
            f"max_abs_err={err}")
        if not ok:
            raise SystemExit(f"pig_aggregate kernel != plain version at "
                             f"{name} ({G}, {N})")
        del shards, scales, got, again, want
    return worst


# --------------------------------------------------------------- phase 12
def time_pig(device):
    """The kernel at the relay shape and at (4, 2**28), its bound (each
    input read once, the output written once; 2G flops an element) and the
    plain version.  Inputs are random int8 and scales: the time does not
    depend on the values."""
    import torch
    from repro_torch.kernels import pig_aggregate
    from repro_torch.kernels.ref import pig_aggregate_ref
    g = torch.Generator(device=device).manual_seed(0)
    rows = []
    for G, N in PIG_TIMED:
        nb = N // PIG_BLOCK
        shards = torch.randint(-127, 128, (G, N), generator=g,
                               device=device, dtype=torch.int8)
        scales = torch.rand((G, nb), generator=g, device=device)
        big = G * N > 1 << 28
        ms = time_ms(lambda: pig_aggregate.pig_aggregate(
            shards, scales, PIG_BLOCK), 50 if big else 500)
        plain_ms = time_ms(lambda: pig_aggregate_ref(
            shards, scales, PIG_BLOCK), 5 if big else 50, warmup=2)
        nbytes = G * N + 4 * G * nb + 4 * N
        ops = 2 * G * N
        bytes_ms = nbytes / HBM_BYTES_S * 1e3
        ops_ms = ops / F32_OPS_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        log(f"timing   pig_aggregate G={G} N={N} block={PIG_BLOCK}: kernel "
            f"{ms:.6f} ms, plain version {plain_ms:.6f} ms, bound "
            f"{bound_ms:.6f} ms ({nbytes} bytes at 3.35 TB/s = "
            f"{bytes_ms:.6f} ms; {ops} ops at 67 TFLOP/s = {ops_ms:.6f} ms)"
            f"; kernel at {100 * bound_ms / ms:.2f}% of its bound, "
            f"{nbytes / ms / 1e6:.2f} GB/s; library call: none (no single "
            f"PyTorch call takes int8 shards and per-block scales to the "
            f"f32 sum)")
        rows.append({"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": "bytes" if bytes_ms >= ops_ms
                     else "operations"})
        del shards, scales
    return rows[0]                 # the relay shape: the record's numbers


# --------------------------------------------------------------- phase 13
SPOT = ("final_norm", "layers/attn/wk")


def leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def q8_error(x, out, res, block):
    """(worst |out - x| / (step/2 + 2u(|x| + step)), worst |out + res - x|
    / (2u(|x| + step))) over one leaf, with step its block's quantization
    step and u the unit roundoff of its dtype: both at most 1 (half a step
    of quantization, and the output's own rounding with a factor 2 to
    spare)."""
    import torch
    u = 2.0 ** -8 if x.dtype == torch.bfloat16 else 2.0 ** -24
    xs, os_, rs = (t.reshape(-1, block) for t in (x, out, res))
    worst = [0.0, 0.0]
    for i in range(0, xs.shape[0], 1 << 16):
        xf, of, rf = (t[i:i + (1 << 16)].double() for t in (xs, os_, rs))
        step = xf.abs().amax(1, keepdim=True).clamp_min(1e-12) / 127
        worst[0] = max(worst[0], ((of - xf).abs() / (
            step / 2 + 2 * u * (xf.abs() + step))).max().item())
        worst[1] = max(worst[1], ((of + rf - xf).abs() / (
            2 * u * (xf.abs() + step) + 1e-300)).max().item())
    return worst


def run_sync(device):
    """Phase 13: returns pig_aggregate's launches on the path."""
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.collectives import sync_grads
    from repro_torch.collectives.schedules import tree_map
    from repro_torch.configs import get_config
    from repro_torch.kernels import pig_aggregate
    from repro_torch.launch import mesh
    from repro_torch.models import param_tree_shapes
    cfg = get_config(SERVE_ARCH).replace(n_layers=SYNC_LAYERS)
    g = torch.Generator(device=device).manual_seed(3)
    grads = tree_map(lambda sd: torch.randn(sd[0], generator=g,
                                             device=device, dtype=sd[1]),
                      param_tree_shapes(cfg))
    n = sum(t.numel() for t in _flat_leaves(grads))
    nbytes = sum(t.numel() * t.element_size() for t in _flat_leaves(grads))
    log(f"sync     {cfg.name} gradient tree at full width, {SYNC_LAYERS} of "
        f"36 layers: 12 leaves, {n} elements, {nbytes} bytes (bf16, f32 "
        f"norms)")
    with tempfile.TemporaryDirectory() as d:
        mesh.init(0, 1, dist.FileStore(os.path.join(d, "store"), 1),
                  device=device)
        try:
            card = mesh.make_mesh(1, 1)
            host = mesh.make_mesh(1, 1, backend="gloo")
            for grp in (card.world, card.group, card.pod):   # NCCL set-up
                dist.all_reduce(torch.ones(1, device=device), group=grp)
            torch.cuda.synchronize()
            spot = {p: leaf(grads, p).cpu() for p in SPOT}
            torch.cuda.reset_peak_memory_stats()
            pig_aggregate.launches = 0
            outs = {}
            for schedule in ("direct", "pig", "pig_q8"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, res = sync_grads(grads, card, schedule, block=PIG_BLOCK)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launched = pig_aggregate.launches
                outs[schedule] = {p: (leaf(out, p).cpu(), None if res is None
                                      else leaf(res, p).cpu()) for p in SPOT}
                if schedule == "pig_q8":
                    worst = [max(w) for w in zip(*(
                        q8_error(x, o, r, PIG_BLOCK) for x, o, r in zip(
                            _flat_leaves(grads), _flat_leaves(out),
                            _flat_leaves(res))))]
                    ok = worst[0] <= 1 and worst[1] <= 1 and launched == 12
                    detail = (f"|out - x| <= step/2 + 2u(|x| + step): worst "
                              f"ratio {worst[0]:.6f}; |out + residual - x| "
                              f"<= 2u(|x| + step): worst ratio "
                              f"{worst[1]:.6f}")
                else:
                    ok = all(same_bits(a, b) for a, b in zip(
                        _flat_leaves(out), _flat_leaves(grads)))
                    detail = f"output == input bit for bit: {ok}"
                log(f"sync     {schedule:6s} wall {1e3 * wall:.3f} ms "
                    f"({nbytes / wall / 1e9:.2f} GB/s of gradients); "
                    f"pig_aggregate launches so far {launched}; {detail}")
                if not ok:
                    raise SystemExit(f"sync_grads({schedule!r}) check "
                                     f"failed")
                del out, res
            launches = pig_aggregate.launches
            peak = torch.cuda.max_memory_allocated()
            log(f"sync     peak device memory {peak} bytes "
                f"({peak / 2**30:.2f} GiB); pig_aggregate launches "
                f"{launches} (12 leaves x one pig_q8 call)")
            # the same calls on the CPU, through a one-rank gloo group
            cpu = _nest_spot(spot)
            for schedule, card_out in outs.items():
                out, res = sync_grads(cpu, host, schedule, block=PIG_BLOCK)
                same = all(same_bits(card_out[p][0], leaf(out, p)) and (
                    res is None or same_bits(card_out[p][1], leaf(res, p)))
                           for p in SPOT)
                log(f"check    sync_grads({schedule!r}) card (NCCL) vs cpu "
                    f"(gloo) on {', '.join(SPOT)}: bit-identical={same}")
                if not same:
                    raise SystemExit(f"sync_grads({schedule!r}): card and "
                                     f"cpu differ")
        finally:
            dist.destroy_process_group()
    del grads
    return launches


def _flat_leaves(tree):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat_leaves(tree[k])
        else:
            yield tree[k]


def _nest_spot(spot):
    tree = {}
    for path, t in spot.items():
        *parents, name = path.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = t
    return tree


# --------------------------------------------------------------- phase 14
def ssm_inputs(B, T, H, Dk, Dv, decay, dtype, bonus, device, seed):
    """q, k, v ~ 0.3 N; log_a: the reference tests' -(0.5 |N| + 0.01)
    (``channel``; ``scalar`` broadcasts its first channel), or rwkv6's
    clamp(-exp(0.5 + 5 N), -2.3, -1e-4) (``rwkv``: the model's decay with a
    non-zero LoRA-B); u ~ 0.1 N and s0 ~ 0.5 N with the bonus."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    n = lambda *s: torch.randn(s, generator=g, device=device)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    q, k = (n(B, T, H, Dk) * 0.3).to(dt), (n(B, T, H, Dk) * 0.3).to(dt)
    v = (n(B, T, H, Dv) * 0.3).to(dt)
    if decay == "rwkv":
        la = torch.clamp(-torch.exp(0.5 + 5 * n(B, T, H, Dk)), -2.3, -1e-4)
    else:
        la = -n(B, T, H, Dk).abs() * 0.5 - 0.01
        if decay == "scalar":
            la = la[..., :1].expand(la.shape)
    u = n(H, Dk) * 0.1 if bonus else None
    s0 = n(B, H, Dk, Dv) * 0.5 if bonus else None
    return q, k, v, la, u, s0


def ssm_error(got, want):
    """(max |d|, worst |d| / tolerance) under the phase's tolerance."""
    import torch
    d = (got.float() - want.float()).abs()
    tol = SSM_REL * max(1.0, want.float().abs().max().item())
    if got.dtype == torch.bfloat16:
        tol = tol + 2 * bf16_ulp(want)
    return d.max().item(), (d / tol).max().item()


def bf16_ulp(x):
    """One bf16 ulp at each value of x (8 significant bits)."""
    import torch
    mag = x.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def ssm_scan_cu(q, k, v, la, u, chunk, s0):
    """ssm_scan.cu launched directly (the wrapper sends rwkv6's shapes to
    the sm90 kernel), as the wrapper would launch it; counts nothing."""
    import torch
    from repro_torch.kernels import ssm_scan
    B, T, H, Dk = q.shape
    Dv = v.shape[-1]
    y = torch.empty_like(v)
    state = torch.empty((B, H, Dk, Dv), dtype=torch.float32, device=q.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = ssm_scan._launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), la.data_ptr(), ptr(u),
        ptr(s0), y.data_ptr(), state.data_ptr(), B, T, H, Dk, Dv, chunk,
        ssm_scan.DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"ssm_scan.cu launch failed: CUDA error {err}")
    return y, state


def check_ssm(device):
    """Every SSM case through ``ops.ssm_scan`` (the kernel the dispatch
    rule picks), and ssm_scan.cu directly at rwkv6-3b's prefill shape.
    Returns the worst error of the sm90 kernel's cases."""
    import torch
    from repro_torch.kernels import ops, ssm_scan
    from repro_torch.kernels.ref import ssm_scan_ref
    worst = 0.0
    for i, (name, B, T, H, Dk, Dv, chunk, decay, dtype, bonus) in \
            enumerate(SSM_CASES):
        q, k, v, la, u, s0 = ssm_inputs(B, T, H, Dk, Dv, decay, dtype,
                                        bonus, device, seed=i)
        call = lambda: ops.ssm_scan(q, k, v, la, u=u, chunk=chunk, s0=s0,
                                    return_state=True)
        before, before90 = ssm_scan.launches, ssm_scan.launches_sm90
        y, s = call()
        launched = ssm_scan.launches - before
        sm90 = ssm_scan.launches_sm90 - before90
        y2, s2 = call()
        wy, ws = ssm_scan_ref(q, k, v, la, u=u, chunk=chunk, s0=s0,
                              return_state=True)
        torch.cuda.synchronize()
        ey, ry = ssm_error(y, wy)
        es, rs = ssm_error(s, ws)
        wants90 = ssm_scan.uses_sm90(q.dtype, Dk, Dv, chunk)
        if wants90:
            worst = max(worst, ey, es)
        same = torch.equal(y, y2) and torch.equal(s, s2)
        finite = bool(torch.isfinite(y.float()).all()) and bool(
            torch.isfinite(s).all())
        ok = (ry <= 1 and rs <= 1 and launched == 1 and sm90 == int(wants90)
              and same and finite)
        kernel = "ssm_scan_sm90.cu" if sm90 else "ssm_scan.cu"
        log(f"ssm      {name:16s} B={B} T={T} H={H} Dk={Dk} Dv={Dv} "
            f"chunk={chunk} {dtype} bonus={bonus}: {kernel}, launches="
            f"{launched} (sm90 {sm90}) rerun_equal={same} y max_abs_err={ey} "
            f"(err/tolerance {ry:.4f}) state max_abs_err={es} (err/tolerance "
            f"{rs:.4f}); max|y| {wy.float().abs().max().item():.4f}, "
            f"max|state| {ws.abs().max().item():.4f}")
        if not ok:
            raise SystemExit(f"ssm_scan kernel != plain version at {name}")
        if name == SSM_TIMED[0]:
            # how far the f32 sums sit from the plain version's: phase 16's
            # per-layer check reads the bf16 roundings they flip
            flips = (y != wy).float().mean().item()
            f32 = [t.float() for t in (q, k, v)]
            gap = rel_l2(ops.ssm_scan(*f32, la, u=u, chunk=chunk, s0=s0),
                         ssm_scan_ref(*f32, la, u=u, chunk=chunk, s0=s0))
            log(f"ssm      {name:16s} y differs from the plain version's "
                f"in {flips} of its bf16 values; on f32 copies of the "
                f"inputs, relative L2 {gap}")
            y, s = ssm_scan_cu(q, k, v, la, u, chunk, s0)
            y2, s2 = ssm_scan_cu(q, k, v, la, u, chunk, s0)
            torch.cuda.synchronize()
            ey, ry = ssm_error(y, wy)
            es, rs = ssm_error(s, ws)
            same = torch.equal(y, y2) and torch.equal(s, s2)
            log(f"ssm      {name:16s} ssm_scan.cu called directly: "
                f"rerun_equal={same} y max_abs_err={ey} (err/tolerance "
                f"{ry:.4f}) state max_abs_err={es} (err/tolerance {rs:.4f})")
            if not (ry <= 1 and rs <= 1 and same):
                raise SystemExit(f"ssm_scan.cu != plain version at {name}")
        del q, k, v, la, u, s0, y, s, y2, s2, wy, ws
    log(f"ssm      tolerance: f32 y and state |d| <= {SSM_REL} max(1, "
        f"max|plain|); bf16 y |d| <= {SSM_REL} max(1, max|plain|) + 2 "
        f"bf16 ulps of |plain|")
    return worst


# --------------------------------------------------------------- phase 15
def time_ssm(device):
    """Both kernels at rwkv6-3b's prefill shape on the same inputs, their
    bounds (each input read once, y and the state written once; the
    products of every chunk that the mask leaves live, in f32 on the CUDA
    cores for ssm_scan.cu and in three TF32 passes on the tensor cores for
    ssm_scan_sm90.cu) and the plain version.  Returns the sm90 kernel's
    record and the CUDA-core kernel's time."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssm_scan_ref
    name, B, T, H, Dk, Dv, C, decay, dtype, bonus = SSM_TIMED
    q, k, v, la, u, s0 = ssm_inputs(B, T, H, Dk, Dv, decay, dtype, bonus,
                                    device, seed=0)
    ms = time_ms(lambda: ops.ssm_scan(q, k, v, la, u=u, chunk=C, s0=s0,
                                      return_state=True), 50, warmup=5)
    cu_ms = time_ms(lambda: ssm_scan_cu(q, k, v, la, u, C, s0), 20,
                    warmup=3)
    plain_ms = time_ms(lambda: ssm_scan_ref(q, k, v, la, u=u, chunk=C, s0=s0,
                                            return_state=True), 3, warmup=1)
    rows = B * T * H
    nbytes = (rows * (2 * Dk + Dv) * 2 + rows * Dk * 4 + rows * Dv * 2
              + 2 * B * H * Dk * Dv * 4)
    # multiply-adds per chunk: the scores (Dk) and the intra-chunk term (Dv)
    # over the mask's live triangle, strict with the bonus and then its
    # diagonal (q . (u k)) and (. v); inter C x Dk x Dv; state C x Dk x Dv.
    # Two operations a multiply-add.  The full C x C squares, which the TPU
    # kernel computes before masking, are printed beside it.
    live = C * (C - 1) // 2 + C if bonus else C * (C + 1) // 2
    chunks = B * H * (T // C)
    ops_ = chunks * 2 * (live * (Dk + Dv) + 2 * C * Dk * Dv)
    square_ops = chunks * 2 * C * (C * Dk + C * Dv + 2 * Dk * Dv)
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    f32_ms = ops_ / F32_OPS_S * 1e3
    tf32x3_ms = 3 * ops_ / TF32_OPS_S * 1e3
    bound_ms = max(bytes_ms, tf32x3_ms)
    cu_bound_ms = max(bytes_ms, f32_ms)
    log(f"timing   ssm_scan {name} B={B} T={T} H={H} Dk={Dk} Dv={Dv} "
        f"chunk={C} bf16 bonus, on the same inputs: ssm_scan_sm90.cu "
        f"{ms:.6f} ms, ssm_scan.cu {cu_ms:.6f} ms ({cu_ms / ms:.3f}x), plain "
        f"version {plain_ms:.6f} ms; {nbytes} bytes at 3.35 TB/s = "
        f"{bytes_ms:.6f} ms; {ops_} operations (the mask's live triangles; "
        f"the full C x C squares would be {square_ops}): in three TF32 "
        f"passes at 495 TFLOP/s {tf32x3_ms:.6f} ms, in f32 at 67 TFLOP/s on "
        f"the CUDA cores {f32_ms:.6f} ms")
    log(f"timing   ssm_scan_sm90.cu bound {bound_ms:.6f} ms (bytes), kernel "
        f"at {100 * bound_ms / ms:.2f}% of it, {ops_ / ms / 1e9:.2f} TFLOP/s "
        f"of the live operations; ssm_scan.cu bound {cu_bound_ms:.6f} ms "
        f"(f32 operations on the CUDA cores), kernel at "
        f"{100 * cu_bound_ms / cu_ms:.2f}% of it, "
        f"{ops_ / cu_ms / 1e9:.2f} TFLOP/s; library call: none (no single "
        f"PyTorch call computes a chunked linear recurrence with per-channel "
        f"decay)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= tf32x3_ms else "operations"}


# --------------------------------------------------------------- phase 16
def rwkv_inputs(device):
    """rwkv6-3b from ``new_model``, its decay LoRA-B redrawn from seed 2."""
    import torch
    cfg, params, prompts = new_model(device, RWKV_ARCH)
    g = torch.Generator(device).manual_seed(2)
    with torch.no_grad():
        for lp in params.layers:
            b = lp.time.w_lora_b
            b.copy_(torch.randn(b.shape, generator=g, device=device)
                    * LORA_B_STD)
    log(f"serve    {cfg.name}: decay LoRA-B ~ {LORA_B_STD} N")
    return cfg, params, prompts


def check_rwkv_serve(device, cfg, params, prompts, served, ssm_ms):
    import copy

    import torch
    from repro_torch.kernels import ssm_scan
    from repro_torch.train import build_serve_step

    def prefill(impl, p=params, dtype=torch.bfloat16):
        logits, cache, s, n = prefill_run(device, cfg, p, prompts, impl,
                                          dtype, ssm_scan)
        return logits, cache["rwkv"], s, n

    def states_rel(ca, cr):
        return [rel_l2(ca["state"][i], cr["state"][i])
                for i in range(cfg.n_layers)]

    ref, cr, ref_s, ref_n = prefill("ref")
    a, ca, a_s, a_n = prefill("auto")
    b, cb, b_s, b_n = prefill("auto")
    same = torch.equal(a, b) and all(torch.equal(ca[n], cb[n]) for n in ca)
    del cb
    finite = bool(torch.isfinite(a).all()) and bool(
        torch.isfinite(ca["state"]).all())
    same_first = torch.equal(a.argmax(-1).to(torch.int32), served[:, 0])
    rel16, st16 = rel_l2(a, ref), states_rel(ca, cr)
    log(f"check    {cfg.name} bf16 prefill kernel vs ref (chunked_linear_"
        f"scan), end to end: last-token logits relative L2 {rel16}; final "
        f"states relative L2 by layer {[float(f'{r:.3g}') for r in st16]} "
        f"(the {cfg.n_layers} random layers amplify rounding; held layer by "
        f"layer and in f32 below); greedy first tokens {a.argmax(-1).tolist()} vs "
        f"{ref.argmax(-1).tolist()}; finite={finite}; two kernel prefills "
        f"bit-identical={same} (first tokens equal generate's: "
        f"{same_first}); ssm_scan launches a prefill {a_n} / {b_n}, ref "
        f"{ref_n}; warm prefill ms: kernel {1e3 * a_s:.3f} / "
        f"{1e3 * b_s:.3f}, ref {1e3 * ref_s:.3f}")
    if not (same and same_first and finite and a_n == b_n == cfg.n_layers
            and ref_n == 0):
        raise SystemExit("rwkv6-3b kernel prefill check failed")
    log(f"serve    warm kernel prefill {1e3 * b_s:.3f} ms; ssm_scan_sm90 "
        f"{cfg.n_layers} x {ssm_ms:.6f} ms (phase 15) = "
        f"{cfg.n_layers * ssm_ms:.3f} ms, "
        f"{100 * cfg.n_layers * ssm_ms / (1e3 * b_s):.2f}% of it")
    del cr, ref

    # decode continues from the kernel prefill's state: no launches
    step = build_serve_step(cfg, impl="auto")
    tok = a.argmax(-1).to(torch.int32)
    n0 = ssm_scan.launches
    cache = {"rwkv": ca}
    for i in range(1 + DECODE_STEPS):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        pos = torch.full((SERVE_B,), SERVE_PROMPT + i, dtype=torch.int32,
                         device=device)
        cache, tok = step(params, cache, tok, pos)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / DECODE_STEPS
    launched = ssm_scan.launches - n0
    log(f"decode   {cfg.name} B={SERVE_B} from the kernel prefill's cache: "
        f"{step_ms:.3f} ms a step (warm, {DECODE_STEPS} steps); ssm_scan "
        f"launches in {1 + DECODE_STEPS} decode steps: {launched}")
    if launched:
        raise SystemExit(f"decode launched ssm_scan {launched} times")
    del cache, ca
    layer_by_layer(device, cfg, params, prompts)

    p32 = copy.deepcopy(params).float()
    ref, cr, _, _ = prefill("ref", p32, torch.float32)
    a, ca, _, _ = prefill("auto", p32, torch.float32)
    rel32, st32 = rel_l2(a, ref), states_rel(ca, cr)
    log(f"check    {cfg.name} f32 copy, prefill kernel vs ref end to end: "
        f"last-token logits relative L2 {rel32}; final states relative L2 "
        f"by layer {[float(f'{r:.3g}') for r in st32]} (tolerance "
        f"{RWKV_F32_REL}); greedy first tokens {a.argmax(-1).tolist()} vs "
        f"{ref.argmax(-1).tolist()}")
    if not (rel32 <= RWKV_F32_REL and max(st32) <= RWKV_F32_REL):
        raise SystemExit("rwkv6-3b f32 kernel prefill != plain version")
    del p32, ca, cr


def layer_by_layer(device, cfg, params, prompts):
    """A pass over the prompts layer by layer in bf16: each layer's block
    through the kernel and through the plain scan from the same input (the
    kernel path's) and an empty cache; their residual branches and final
    states compared, and the share of decays at the clamp's ends."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import make_cache, rwkv
    from repro_torch.models.layers import rmsnorm
    lo, hi, out_rel, st_rel = [], [], [], []
    with torch.no_grad():
        x = F.embedding(prompts, params.embed)
        for lp in params.layers:
            xn = rmsnorm(x, lp.ln1, cfg.norm_eps)
            xx = rwkv._shift(xn, None)
            logw = rwkv.log_decay(
                lp.time, xn + (xx - xn) * lp.time.mu_w.to(xn.dtype))
            lo.append((logw == -2.3).float().mean().item())
            hi.append((logw == -1e-4).float().mean().item())
            del xn, xx, logw
            res = {}
            for impl in ("auto", "ref"):
                c = make_cache(cfg, SERVE_B, 1, device=device)["rwkv"]
                lc = {n: t[0] for n, t in c.items()}
                y, _ = rwkv.rwkv_block(lp, x, cfg, cache=lc, impl=impl)
                res[impl] = (y, lc["state"])
            out_rel.append(rel_l2(res["auto"][0] - x, res["ref"][0] - x))
            st_rel.append(rel_l2(res["auto"][1], res["ref"][1]))
            x = res["auto"][0]
            del res
    log(f"serve    decays at the clamp, share per layer: at -2.3 "
        f"{[round(v, 4) for v in lo]}; at -1e-4 {[round(v, 4) for v in hi]}")
    log(f"check    {cfg.name} layer by layer on identical bf16 inputs, "
        f"kernel vs ref: residual branch relative L2 worst {max(out_rel)} "
        f"(tolerance {RWKV_LAYER_REL}), final state relative L2 worst "
        f"{max(st_rel)} (tolerance {RWKV_STATE_REL})")
    if not (min(lo) > 0 and min(hi) > 0):
        raise SystemExit("the decays do not reach both ends of the clamp")
    if not (max(out_rel) <= RWKV_LAYER_REL
            and max(st_rel) <= RWKV_STATE_REL):
        raise SystemExit("rwkv6-3b layer-by-layer kernel check failed")

# --------------------------------------------------------------- phase 25
def check_hybrid(device, cfg, params, prompts, served, padded_ms):
    """zamba2-7b: two flash prefills bit-identical and launching n_super
    times each, their first tokens generate's; each shared-attention
    application's kernel call against the plain version; the ``ref``
    prefill beside it (bf16 end to end: printed); decode counted and
    traced; one Mamba2 block card vs CPU in f32; an f32 copy end to end
    within ``HYBRID_F32_REL``."""
    import copy

    import torch
    from repro_torch.models.model import n_super
    torch.cuda.reset_peak_memory_stats()
    ref, _, ref_s, ref_n = prefill_run(device, cfg, params, prompts, "ref")
    with FlashInputs() as shared:
        a, ca, a_s, a_n = prefill_run(device, cfg, params, prompts, "flash")
    b, cb, b_s, b_n = prefill_run(device, cfg, params, prompts, "flash")
    same = torch.equal(a, b) and same_cache(ca, cb)
    del cb
    finite = bool(torch.isfinite(a).all())
    same_first = torch.equal(a.argmax(-1).to(torch.int32), served[:, 0])
    want = n_super(cfg)
    log(f"check    {cfg.name} bf16 prefill flash vs ref (attention_chunked) "
        f"end to end: last-token logits relative L2 {rel_l2(a, ref)} (the "
        f"{cfg.n_layers} random Mamba2 layers amplify rounding: held per "
        f"application and in f32 below); greedy first tokens "
        f"{a.argmax(-1).tolist()} vs {ref.argmax(-1).tolist()}; finite="
        f"{finite}; two flash prefills bit-identical={same} (first tokens "
        f"equal generate's: {same_first}); flash launches a prefill {a_n} / "
        f"{b_n}, ref {ref_n}; warm prefill ms: flash {1e3 * a_s:.3f} / "
        f"{1e3 * b_s:.3f}, ref {1e3 * ref_s:.3f}; peak memory "
        f"{torch.cuda.max_memory_allocated()} bytes")
    log(f"serve    warm flash prefill {1e3 * b_s:.3f} ms; flash {want} x "
        f"{padded_ms:.6f} ms (phase 8, padded to Dh 128) = "
        f"{want * padded_ms:.3f} ms, "
        f"{100 * want * padded_ms / (1e3 * b_s):.2f}% of it")
    if not (same and same_first and finite and a_n == b_n == want
            and ref_n == 0 and len(shared.calls) == want):
        raise SystemExit(f"{cfg.name} flash prefill check failed")
    del ref
    ratio, err = flash_on_inputs(f"{cfg.name} shared attention",
                                 shared.calls)
    del shared
    if ratio > 1.0:
        raise SystemExit(f"{cfg.name}: the kernel != plain version on a "
                         f"shared-attention application")
    trace_decode(device, cfg, params, ca, a.argmax(-1).to(torch.int32))
    del ca, a, b
    torch.cuda.empty_cache()
    mamba2_card_vs_cpu(device, cfg, params)

    torch.cuda.reset_peak_memory_stats()
    p32 = copy.deepcopy(params).float()
    ref, cr, _, _ = prefill_run(device, cfg, p32, prompts, "ref",
                                torch.float32)
    a, ca, _, n32 = prefill_run(device, cfg, p32, prompts, "flash",
                                torch.float32)
    rel32 = rel_l2(a, ref)
    st32 = [rel_l2(ca["ssm"]["state"][i], cr["ssm"]["state"][i])
            for i in range(cfg.n_layers)]
    log(f"check    {cfg.name} f32 copy, prefill flash (flash_attention.cu, "
        f"{n32} launches) vs ref end to end: last-token logits relative L2 "
        f"{rel32}, final states relative L2 by layer: first "
        f"{st32[0]:.3g}, worst {max(st32):.3g}, last {st32[-1]:.3g} "
        f"(tolerance {HYBRID_F32_REL}); greedy first tokens "
        f"{a.argmax(-1).tolist()} vs {ref.argmax(-1).tolist()}; peak memory "
        f"{torch.cuda.max_memory_allocated()} bytes")
    if not (rel32 <= HYBRID_F32_REL and max(st32) <= HYBRID_F32_REL
            and n32 == want):
        raise SystemExit(f"{cfg.name} f32 flash prefill != plain version")
    return err


def mamba2_card_vs_cpu(device, cfg, params):
    """Layer 0's Mamba2 block at full width in f32, on the card and on the
    CPU from identical inputs (B 2, a ragged T = 300 from a non-zero conv
    shift and state, then one decode step): y, the final state and the
    conv shift within ``MAMBA2_CARD_REL`` (relative L2)."""
    import copy

    import torch
    from repro_torch.models import ssm
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("TF32 matmuls are on: the f32 scan would round")
    d_inner, H, P, N = ssm._ssm_dims(cfg)
    g = torch.Generator().manual_seed(5)
    x = torch.randn((2, 301, cfg.d_model), generator=g)
    cache = {"conv": torch.randn((2, cfg.conv_width - 1, d_inner),
                                 generator=g),
             "state": 0.3 * torch.randn((2, H, N, P), generator=g)}
    blk = copy.deepcopy(params.layers[0].ssm).float()
    outs = []
    for dev in (device, torch.device("cpu")):
        b = blk.to(dev)
        c = {n: t.clone().to(dev) for n, t in cache.items()}
        with torch.no_grad():
            y, _ = ssm.ssm_block(b, x[:, :300].to(dev), cfg, cache=c)
            y1, _ = ssm.ssm_block(b, x[:, 300:].to(dev), cfg, cache=c)
        outs.append([t.cpu() for t in (y, y1, c["state"], c["conv"])])
    names = ("y (prefill)", "y (decode)", "state", "conv shift")
    rels = {n: rel_l2(a, b) for n, a, b in zip(names, *outs)}
    finite = all(bool(torch.isfinite(t).all()) for t in outs[0])
    log(f"check    {cfg.name} layer 0 Mamba2 block (d_inner {d_inner}, {H} "
        f"heads of {P}, state {N}) in f32, card vs cpu on identical inputs "
        f"(B 2, T 300 from a non-zero cache, then a decode step): relative "
        f"L2 " + ", ".join(f"{n} {r:.3g}" for n, r in rels.items())
        + f" (tolerance {MAMBA2_CARD_REL}); finite={finite}; "
        f"torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} (no convolution on the path)")
    if not (finite and max(rels.values()) <= MAMBA2_CARD_REL):
        raise SystemExit(f"{cfg.name}: the Mamba2 block on the card != cpu")


def check_hybrid_smoke(device):
    """zamba2-smoke and its ``ssm`` variant card vs CPU within the CPU
    tests' bf16 tolerances (``tests/test_torch_hybrid.py``)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention
    from repro_torch.models.model import n_super
    cfg = get_smoke_config(HYBRID_ARCH)
    check_smoke(device, cfg, flash_attention, "flash", HYBRID_SMOKE_TOL,
                HYBRID_SMOKE_REL_L2, want=n_super(cfg))
    check_smoke(device, cfg.replace(family="ssm"), flash_attention, "flash",
                HYBRID_SMOKE_TOL, HYBRID_SMOKE_REL_L2, want=0)


# --------------------------------------------------------------- phase 26
class Routes:
    """Records, inside it, each MoE layer's top-k choices and keep mask of
    every prefill-sized call (S > 1)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.topi, self.keep = [], []
        self.route, self.dispatch = moe.route, moe._group_dispatch_indices

        def route(p, x, k):
            out = self.route(p, x, k)
            if x.shape[1] > 1:
                self.topi.append(out[2].sort(dim=-1).values)
            return out

        def dispatch(topi, E, C):
            slot, keep = self.dispatch(topi, E, C)
            if topi.shape[-2] > 1:
                self.keep.append(keep)
            return slot, keep
        moe.route, moe._group_dispatch_indices = route, dispatch
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route, moe._group_dispatch_indices = self.route, self.dispatch


def check_moe(device, cfg, params, prompts, served):
    """qwen2-moe-a2.7b: two flash prefills bit-identical and launching once
    a layer, their first tokens generate's; the share of routed pairs
    dropped at capacity; each layer's attention kernel call against the
    plain version; the ``ref`` prefill beside it (relative L2 and routing
    choices that differ: printed); decode counted and traced."""
    import torch
    from repro_torch.models import moe
    torch.cuda.reset_peak_memory_stats()
    with Routes() as routes_ref:
        ref, _, ref_s, ref_n = prefill_run(device, cfg, params, prompts,
                                           "ref")
    with Routes() as routes, FlashInputs() as calls:
        a, ca, a_s, a_n = prefill_run(device, cfg, params, prompts, "flash")
    b, cb, b_s, b_n = prefill_run(device, cfg, params, prompts, "flash")
    same = torch.equal(a, b) and same_cache(ca, cb)
    del cb
    finite = bool(torch.isfinite(a).all())
    same_first = torch.equal(a.argmax(-1).to(torch.int32), served[:, 0])
    kept = torch.stack([k.float().mean() for k in routes.keep]).tolist()
    flips = [int((x != y).any(dim=-1).sum())
             for x, y in zip(routes.topi, routes_ref.topi)]
    tokens = SERVE_B * SERVE_PROMPT
    log(f"serve    {cfg.name} prefill routing: C = "
        f"{moe.capacity(cfg, SERVE_PROMPT)} slots an expert a sequence; "
        f"share of routed (token, expert) pairs dropped at capacity, by "
        f"layer: {[round(1 - k, 5) for k in kept]}, all layers "
        f"{1 - sum(kept) / len(kept):.5f}")
    log(f"check    {cfg.name} bf16 prefill flash vs ref (attention_chunked) "
        f"end to end: last-token logits relative L2 {rel_l2(a, ref)}; "
        f"tokens whose top-{cfg.top_k} set differs between the two, by "
        f"layer: {flips} of {tokens} each, {sum(flips)} in all (a gate "
        f"near-tie flips an expert, and the two prefills' hidden states "
        f"part further with depth: the kernel is held per layer below); "
        f"greedy first tokens {a.argmax(-1).tolist()} vs "
        f"{ref.argmax(-1).tolist()}; finite={finite}; two flash prefills "
        f"bit-identical={same} (first tokens equal generate's: "
        f"{same_first}); flash launches a prefill {a_n} / {b_n}, ref "
        f"{ref_n}; warm prefill ms: flash {1e3 * a_s:.3f} / "
        f"{1e3 * b_s:.3f}, ref {1e3 * ref_s:.3f}; peak memory "
        f"{torch.cuda.max_memory_allocated()} bytes")
    if not (same and same_first and finite and a_n == b_n == cfg.n_layers
            and ref_n == 0 and len(calls.calls) == cfg.n_layers
            and len(routes.keep) == cfg.n_layers):
        raise SystemExit(f"{cfg.name} flash prefill check failed")
    del ref, routes, routes_ref
    ratio, err = flash_on_inputs(f"{cfg.name} attention by layer",
                                 calls.calls)
    del calls
    if ratio > 1.0:
        raise SystemExit(f"{cfg.name}: the kernel != plain version on a "
                         f"layer's attention")
    trace_decode(device, cfg, params, ca, a.argmax(-1).to(torch.int32))
    del ca, a
    moe_card_vs_cpu(device, cfg, params)
    return err


def moe_card_vs_cpu(device, cfg, params):
    """Layer 0's MoE block at full width in bf16, the type it serves in,
    card against CPU on identical inputs (B 2, S 256: C = 21 slots an
    expert, so some pairs drop): the f32 router's gates within
    ``MOE_GATES_REL`` (relative L2), the top-k sets equal on every token
    whose k-th and (k+1)-th gates part by more than ``MOE_TIE``, and the
    block's output, the CPU given the card's routing, within
    ``MOE_BLOCK_REL`` of its largest |value|."""
    import torch
    from repro_torch.models import moe
    blk = params.layers[0].moe
    host = moe.MoE(cfg, torch.bfloat16, "cpu")
    host.load_state_dict(blk.state_dict())
    x = torch.randn((2, 256, cfg.d_model), generator=torch.Generator(
        ).manual_seed(6)).to(torch.bfloat16)
    C = moe.capacity(cfg, x.shape[1])
    with torch.no_grad():
        card = [t.cpu() for t in moe.route(blk, x.to(device), cfg.top_k)]
        y = moe.moe_block(blk, x.to(device), cfg).cpu()
        gates, _, topi = moe.route(host, x, cfg.top_k)
        route = moe.route
        moe.route = lambda p, x, k: card
        try:
            y_host = moe.moe_block(host, x, cfg)
        finally:
            moe.route = route
    keep = moe._group_dispatch_indices(card[2], cfg.n_experts, C)[1]
    g = gates.sort(dim=-1, descending=True).values
    margin = g[..., cfg.top_k - 1] - g[..., cfg.top_k]
    differ = (card[2].sort(dim=-1).values != topi.sort(dim=-1).values
              ).any(dim=-1)
    gates_rel = rel_l2(card[0], gates)
    err = ((y.float() - y_host.float()).abs().max()
           / y_host.float().abs().max()).item()
    log(f"check    {cfg.name} layer 0 MoE block ({cfg.n_experts} experts "
        f"top-{cfg.top_k}, C {C}) in bf16, card vs cpu on identical inputs "
        f"(B 2, S 256; {1 - keep.float().mean().item():.4f} of the pairs "
        f"dropped): gates relative L2 {gates_rel:.3g} (tolerance "
        f"{MOE_GATES_REL}); top-k sets differ on {int(differ.sum())} of "
        f"{differ.numel()} tokens, {int((margin[differ] > MOE_TIE).sum())} "
        f"of them with a margin above {MOE_TIE} (smallest margin "
        f"{margin.min().item():.3g}); output on the card's routing: max |d| "
        f"{err:.4g} of the largest |value| (tolerance {MOE_BLOCK_REL}); "
        f"torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction="
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    if not (gates_rel <= MOE_GATES_REL and not (margin[differ] > MOE_TIE).any()
            and err <= MOE_BLOCK_REL and not keep.all()
            and bool(torch.isfinite(y).all())):
        raise SystemExit(f"{cfg.name}: the MoE block on the card != cpu")


def run_moe_cut(device):
    """qwen3-moe-235b-a22b at full width, 2 of its 94 layers (one 80 GB card
    holds about 15): a 4 x 2048 prefill and 3 decode steps through
    ``generate``, flash at Dh 64, GQA 16, launching once a layer; each
    launch's inputs then through the kernel and the plain version.
    Returns (the launches, the kernel's max |d| from the plain version)."""
    import torch
    from repro_torch.kernels import flash_attention
    cfg, params, prompts = new_model(device, MOE_CUT_ARCH,
                                     n_layers=MOE_CUT_LAYERS)
    with FlashInputs() as calls:
        sm90, tokens, _ = run_generate(device, cfg, params, prompts,
                                       flash_attention, "flash",
                                       cfg.n_layers, gen=MOE_CUT_STEPS + 1)
    del params
    ratio, err = flash_on_inputs(
        f"{cfg.name} ({cfg.n_layers} layers) attention by layer", calls.calls)
    if len(calls.calls) != cfg.n_layers or ratio > 1.0:
        raise SystemExit(f"{cfg.name}: {len(calls.calls)} attention calls, "
                         f"the kernel against the plain version "
                         f"{ratio:.4f} of its bound")
    return sm90, err


def check_moe_smoke(device):
    """qwen2-moe-smoke and qwen3-moe-smoke card vs CPU: in bf16 the launches
    alone (a near-tie of two gates routes a token apart on the two devices,
    ``tests/test_torch_moe.py``; the bf16 values are held by
    ``moe_card_vs_cpu`` at full width on identical routing), the values in
    f32, where the router's inputs agree to f32 rounding."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention
    for arch in (MOE_ARCH, MOE_CUT_ARCH):
        cfg = get_smoke_config(arch)
        check_smoke(device, cfg, flash_attention, "flash")
        check_smoke(device, cfg, flash_attention, "flash",
                    MOE_SMOKE_F32_TOL, MOE_SMOKE_F32_REL_L2, dtype="f32")


# -------------------------------------------------------------- phase 27
def train_state(params):
    """A ``TrainState`` of ``params`` with zero AdamW moments."""
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainState
    return TrainState(params, adamw_init(params))


def train_options(**kw):
    """The JAX training CLI's options (``launch/train.py``): remat, impl
    "auto", AdamW lr 3e-3 with 10 warmup steps over 50."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainOptions
    return TrainOptions(remat=True, impl="auto",
                        adamw=AdamWConfig(**TRAIN_ADAMW), **kw)


def train_batches(cfg, device, n, B=TRAIN_B, S=TRAIN_S, f32=False):
    """Batches 0..n-1 of ``SyntheticLMStream`` (seed 0) on ``device``;
    ``f32``: a stub frontend's bf16 embeddings cast to f32."""
    import torch
    from repro_torch.data import DataConfig, SyntheticLMStream
    stream = SyntheticLMStream(cfg, DataConfig(B, S), device=device)
    out = []
    for s in range(n):
        b = stream.batch_at(s)
        if f32 and "embeds" in b:
            b["embeds"] = b["embeds"].to(torch.float32)
        out.append(b)
    return out


def run_train(device, cfg, state, batches, kernel, want, first=None):
    """The main path of the training slice: ``build_train_step`` with
    ``train_options`` over ``batches``, every kernel count set to 0 just
    before and read just after; the sm90 entry of ``kernel`` (a kernel
    module, or None) launches ``want`` times a step and no other kernel at
    all.  ``first``, if given, is called with the loss and the state after
    step 1, outside the step's wall.  Returns (its launches, [(loss,
    grad_norm, lr, wall s)] a step, peak bytes)."""
    import torch
    from repro_torch.train import build_train_step
    step = build_train_step(cfg, train_options())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    rows = []
    for batch in batches:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])                   # waits for the device
        rows.append((loss, float(m["grad_norm"]), float(m["lr"]),
                     time.perf_counter() - t0))
        if first is not None and len(rows) == 1:
            first(m["loss"], state)
    sm90, launches, others = read_counts(kernel)
    peak = torch.cuda.max_memory_allocated()
    n = len(batches)
    log(f"train    {cfg.name} {n} steps of {TRAIN_B}x{TRAIN_S} tokens "
        f"(remat, impl auto, AdamW {TRAIN_ADAMW}): loss / grad norm / lr / "
        f"ms a step {[(round(l, 5), round(g, 4), lr, round(1e3 * s, 3)) for l, g, lr, s in rows]}; "
        f"kernel launches {launches} (sm90 {sm90}), other kernels "
        f"{others}; peak memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    if not (launches == sm90 == want * n and not any(others.values())):
        raise SystemExit(f"{cfg.name} training: launches {launches} (sm90 "
                         f"{sm90}), expected {want} a step; others {others}")
    lo, hi = 0.1 * math.log(cfg.vocab), 3.0 * math.log(cfg.vocab)
    if not all(math.isfinite(r[0]) and lo < r[0] < hi for r in rows):
        raise SystemExit(f"{cfg.name} training loss out of ({lo}, {hi})")
    if int(state.opt.step) != n:
        raise SystemExit(f"{cfg.name}: opt.step {int(state.opt.step)}")
    return sm90, rows, peak


def train_speed(cfg, params, rows, peak):
    """Warm step ms (the mean of the steps after the first), tokens/s and
    6 N tokens / (step x 989 TFLOP/s), printed; returns the step ms."""
    n = sum(p.numel() for p in params.parameters())
    warm = sum(r[3] for r in rows[1:]) / len(rows[1:])
    tokens = TRAIN_B * TRAIN_S
    share = 6 * n * tokens / (warm * BF16_OPS_S)
    log(f"train    {cfg.name}: {n} parameters; warm step {1e3 * warm:.3f} ms "
        f"(first {1e3 * rows[0][3]:.3f} ms), {tokens / warm:.2f} tokens/s, "
        f"6 N tokens / (step x 989 TFLOP/s) = {share:.4f}; peak memory "
        f"{peak / 1e9:.2f} GB")
    return 1e3 * warm


def checksums(params):
    """Each parameter's f64 sum: "moved" compares these (an update of
    +-lr x something to a bf16 tensor changes its sum)."""
    import torch
    with torch.no_grad():
        return {n: p.double().sum().item()
                for n, p in params.named_parameters()}


def host_copy(params):
    """name -> a host copy of each parameter (the device's peak memory
    stays the training step's own)."""
    return {n: p.detach().to("cpu", copy=True)
            for n, p in params.named_parameters()}


def step_again(cfg, params, batch, loss1, after1):
    """Step 1 of the main path run once more, from ``params`` (the initial
    parameters, made again from the seed) and zero moments, with the
    wall of every ``kernels.autograd`` scan backward summed (the device
    synchronised around each: the plain version's forward again and its
    gradient).  The loss and the updated parameters must equal the main
    path's step 1 (``loss1``, ``after1``) bit for bit.  Returns that sum
    in ms."""
    import torch
    from repro_torch.kernels import autograd
    from repro_torch.train import build_train_step
    step = build_train_step(cfg, train_options())
    spent = []
    backward = autograd._Scan.backward

    def timed(ctx, *grads):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = backward(ctx, *grads)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    autograd._Scan.backward = staticmethod(timed)
    try:
        _, m = step(train_state(params), batch)
    finally:
        autograd._Scan.backward = staticmethod(backward)
    loss = m["loss"].cpu()
    same = torch.equal(loss, loss1) and all(
        torch.equal(p.detach().cpu(), after1[n])
        for n, p in params.named_parameters())
    log(f"check    {cfg.name} step 1 twice from the same state (the main "
        f"path's, then once more): loss {loss1.item()} / {loss.item()}, "
        f"parameters bit-identical={same}")
    if not same:
        raise SystemExit(f"{cfg.name}: the same step gave other bits")
    return 1e3 * sum(spent)


def check_scan_function(device):
    """One layer's scan at rwkv6-3b's training shape (phase 15's inputs,
    bf16) with the same upstream gradient, through ``ops.ssm_scan`` on
    inputs that require grad (the kernel forward, ``kernels.autograd``'s
    backward) against the plain version's own autograd: y within phase
    14's bound, every input gradient bit-equal."""
    import torch
    from repro_torch.kernels import ops, ssm_scan
    from repro_torch.kernels.ref import ssm_scan_ref
    name, B, T, H, Dk, Dv, C, decay, dtype, bonus = SSM_TIMED
    base = ssm_inputs(B, T, H, Dk, Dv, decay, dtype, bonus, device, seed=0)
    gy = (torch.randn(base[2].shape, device=device,
                      generator=torch.Generator(device).manual_seed(3))
          * 0.1).to(base[2].dtype)

    def run(fn):
        ins = [t.detach().clone().requires_grad_(True) for t in base]
        y, _ = fn(*ins[:4], u=ins[4], chunk=C, s0=ins[5], return_state=True)
        y.backward(gy)
        return y.detach(), [t.grad for t in ins]

    n0 = ssm_scan.launches_sm90
    got_y, got = run(ops.ssm_scan)
    launched = ssm_scan.launches_sm90 - n0
    want_y, want = run(ssm_scan_ref)
    torch.cuda.synchronize()
    err, ratio = ssm_error(got_y, want_y)
    equal = [torch.equal(g, w) for g, w in zip(got, want)]
    del got, want
    log(f"check    ssm_scan through the autograd Function at {name} "
        f"(B={B} T={T} H={H} Dk={Dk} Dv={Dv} chunk {C} bf16, inputs "
        f"requiring grad): sm90 launches {launched}; y vs the plain version "
        f"max |d| {err}, worst |d|/tolerance {ratio:.4f}; input gradients "
        f"(q, k, v, log_a, u, s0) bit-equal to the plain version's "
        f"autograd: {equal}")
    if not (launched == 1 and ratio <= 1.0 and all(equal)):
        raise SystemExit("the ssm_scan autograd Function disagrees")


def check_train_f32(device, cfg, params, batch):
    """An f32 copy of the first ``TRAIN_F32_LAYERS`` layers at full width:
    one loss and its gradients with impl "auto" (ssm_scan_sm90 in f32) and
    "ref" (the plain scan), from the same parameters and batch; and the
    plain version's own envelope: "ref" again with each scan output moved
    by one f32 ulp."""
    import torch
    from repro_torch.kernels import ref, ssm_scan
    from repro_torch.models import model_class
    from repro_torch.train import loss_and_grads
    cut = cfg.replace(n_layers=TRAIN_F32_LAYERS)
    keep = {n: t.detach().to(torch.float32).clone()
            for n, t in params.state_dict().items()
            if not n.startswith("layers.")
            or int(n.split(".")[1]) < TRAIN_F32_LAYERS}
    p32 = model_class(cut)(cut, dtype=torch.float32, device="meta")
    p32.load_state_dict(keep, strict=True, assign=True)
    del keep
    n0 = ssm_scan.launches_sm90
    la, ga = loss_and_grads(p32, cut, batch, "auto")
    launched = ssm_scan.launches_sm90 - n0
    lr_, gr = loss_and_grads(p32, cut, batch, "ref")
    plain = ref.ssm_scan_ref

    def jittered(*a, **kw):
        out = plain(*a, **kw)
        y = out[0] if isinstance(out, tuple) else out
        g = torch.Generator(y.device).manual_seed(7)
        sign = torch.randint(0, 2, y.shape, generator=g, device=y.device)
        y = y * (1 + (2 * sign - 1).to(y.dtype) * 2.0 ** -23)
        return (y,) + out[1:] if isinstance(out, tuple) else y
    ref.ssm_scan_ref = jittered
    try:
        lj, gj = loss_and_grads(p32, cut, batch, "ref")
    finally:
        ref.ssm_scan_ref = plain
    rels = {n: leaf_gap(ga[n], gr[n]) for n in gr}
    env = {n: leaf_gap(gj[n], gr[n]) for n in gr}
    worst, worst_env = max(rels, key=rels.get), max(env, key=env.get)
    bound = max(TRAIN_F32_GRAD_REL, TRAIN_ENVELOPE * env[worst_env])
    loss_rel = abs(la.item() - lr_.item()) / abs(lr_.item())
    med = lambda d: sorted(d.values())[len(d) // 2]
    log(f"check    {cfg.name} f32 copy at {TRAIN_F32_LAYERS} of "
        f"{cfg.n_layers} layers, full width, the initial parameters, one "
        f"loss and its gradients impl auto (ssm_scan_sm90 launches "
        f"{launched}) vs ref: loss {la.item()} vs {lr_.item()} (relative "
        f"{loss_rel:.3g}, tolerance {TRAIN_LOSS_REL}); gradient leaves' "
        f"relative L2 worst {rels[worst]:.3g} at {worst}, median "
        f"{med(rels):.3g}; the plain version's own one-ulp envelope (ref "
        f"with each scan output moved one f32 ulp: loss {lj.item()}) worst "
        f"{env[worst_env]:.3g} at {worst_env}, median {med(env):.3g}; "
        f"bound max({TRAIN_F32_GRAD_REL}, {TRAIN_ENVELOPE} x envelope) = "
        f"{bound:.3g}")
    if not (launched == 2 * TRAIN_F32_LAYERS and loss_rel <= TRAIN_LOSS_REL
            and rels[worst] <= bound):
        raise SystemExit(f"{cfg.name} f32 training auto != ref")


def train_rwkv(device, ssm_ms):
    """Phase 27: rwkv6-3b trained at full width and depth.  Returns the
    main path's ssm_scan_sm90 launches."""
    import torch
    from repro_torch.kernels import ssm_scan
    cfg, params, _ = rwkv_inputs(device)
    batches = train_batches(cfg, device, TRAIN_STEPS)
    first = {}

    def keep(loss, state):
        first["loss"], first["params"] = loss.cpu(), host_copy(state.params)
    before = checksums(params)
    state = train_state(params)
    launches, rows, peak = run_train(device, cfg, state, batches, ssm_scan,
                                     2 * cfg.n_layers, keep)
    step_ms = train_speed(cfg, params, rows, peak)
    after = checksums(params)
    moved = sum(after[n] != before[n] for n in before)
    log(f"train    {cfg.name}: {moved} of {len(before)} parameters moved")
    if moved != len(before):
        raise SystemExit(f"{cfg.name}: a parameter did not move")
    del state, params
    torch.cuda.empty_cache()
    _, params, _ = rwkv_inputs(device)          # the initial parameters
    check_train_f32(device, cfg, params, batches[0])
    bwd_ms = step_again(cfg, params, batches[0], first["loss"],
                        first["params"])
    del params, first
    torch.cuda.empty_cache()
    check_scan_function(device)
    kernel_ms = 2 * cfg.n_layers * ssm_ms
    log(f"train    {cfg.name} warm step {step_ms:.3f} ms: ssm_scan_sm90 "
        f"{2 * cfg.n_layers} x {ssm_ms:.6f} ms (phase 15) = "
        f"{kernel_ms:.3f} ms, {100 * kernel_ms / step_ms:.2f}% of it; the "
        f"plain backward of the {cfg.n_layers} scans in a step (timed in "
        f"step 1's second run, the device synchronised around each) "
        f"{bwd_ms:.3f} ms, {100 * bwd_ms / step_ms:.2f}% of it")
    return launches


# -------------------------------------------------------------- phase 28
def train_dense(device):
    """Phase 28: h2o-danube-1.8b trained at full width and depth (the JAX
    CLI's default arch): the chunked plain attention at S 2048, no kernel;
    ``impl="flash"`` refused in ``lm_loss`` and in ``ops.flash_attention``
    on CUDA tensors that require grad."""
    import torch
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.models import lm_loss
    cfg, params, _ = new_model(device, TRAIN_ARCH_DENSE)
    before = checksums(params)
    batches = train_batches(cfg, device, TRAIN_STEPS)
    state = train_state(params)
    _, rows, peak = run_train(device, cfg, state, batches, None, 0)
    train_speed(cfg, params, rows, peak)
    after = checksums(params)
    moved, total = sum(after[n] != before[n] for n in before), len(before)
    del state
    refused = []
    n0 = flash_attention.launches
    try:
        lm_loss(params, cfg, batches[0], impl="flash")
    except ValueError as e:
        refused.append(str(e))
    q = torch.randn(1, 128, 4, 128, device=device, dtype=torch.bfloat16,
                    requires_grad=True)
    try:
        ops.flash_attention(q, q, q)
    except ValueError as e:
        refused.append(str(e))
    log(f"train    {cfg.name}: {moved} of {total} parameters moved; "
        f"impl=flash refused by lm_loss and by ops.flash_attention under "
        f"grad: {len(refused)} of 2 ({refused[:1]}); flash launches "
        f"{flash_attention.launches - n0}")
    if moved != total:
        raise SystemExit(f"{cfg.name}: a parameter did not move")
    if len(refused) != 2 or flash_attention.launches != n0:
        raise SystemExit("impl=flash was not refused under grad")


# -------------------------------------------------------------- phase 29
def leaf_gap(a, b):
    """Relative L2 of a against b; 0 where both are all zero (a stub
    frontend's gradients and moments), inf where b alone is."""
    d, nb = (a.float() - b.float()).norm().item(), b.float().norm().item()
    return d / nb if nb > 0 else 0.0 if d == 0 else math.inf


def state_to(state, device):
    import copy
    from repro_torch.optim import OptState
    from repro_torch.train import TrainState
    to = lambda d: {n: t.to(device, copy=True) for n, t in d.items()}
    return TrainState(copy.deepcopy(state.params).to(device),
                      OptState(to(state.opt.mu), to(state.opt.nu),
                               state.opt.step.to(device, copy=True)))


def train_smoke(device, arch, family, ckpt_dir):
    """One family's smoke config in f32 from one CPU init: the loss and
    gradients and one step card vs CPU; microbatch 2 vs 1 on the card; a
    checkpoint restart on the card (save at step 2, restore, replay 2
    steps) bit for bit; the CPU's checkpoint restored on the card bit for
    bit.  Returns (worst relative gap card vs CPU, family name)."""
    import torch
    from repro_torch.checkpoint import CheckpointManager, state_leaves
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.train import build_train_step, loss_and_grads
    cfg = get_smoke_config(arch)
    if family:
        cfg = cfg.replace(family=family)
    cpu = train_state(init_params(cfg, torch.Generator().manual_seed(0),
                                  dtype=torch.float32, device="cpu"))
    card, micro = state_to(cpu, device), state_to(cpu, device)
    hb = train_batches(cfg, "cpu", 4, B=4, S=32, f32=True)
    db = [{n: t.to(device) for n, t in b.items()} for b in hb]
    lc, gc = loss_and_grads(cpu.params, cfg, hb[0], "auto")
    lg, gg = loss_and_grads(card.params, cfg, db[0], "auto")
    gaps = {"loss": abs(lg.item() - lc.item()) / abs(lc.item())}
    gaps["grads"] = max(leaf_gap(gg[n].cpu(), gc[n]) for n in gc)
    step = build_train_step(cfg, train_options())
    _, mc = step(cpu, hb[0])
    _, mg = step(card, db[0])
    _, mm = build_train_step(cfg, train_options(microbatch=2))(micro, db[0])
    a, b, m = state_leaves(card), state_leaves(cpu), state_leaves(micro)
    gaps["step loss"] = abs(mg["loss"].item() - mc["loss"].item()) / abs(
        mc["loss"].item())
    gaps["state"] = max(leaf_gap(a[n], b[n]) for n in b
                        if n != "opt/step")
    gaps["microbatch 2 loss"] = abs(mm["loss"].item() - mg["loss"].item()) \
        / abs(mg["loss"].item())
    gaps["microbatch 2 moments"] = max(leaf_gap(m[n], a[n]) for n in a
                                       if n.startswith(("opt/mu/", "opt/nu/")))
    # the restart: save at step 2, go on to step 4; restore, replay
    step(card, db[1])
    mgr = CheckpointManager(os.path.join(ckpt_dir, cfg.name + "-card"))
    mgr.save(2, card)
    for b_ in db[2:]:
        step(card, b_)
    want = state_leaves(card)
    restored, at = mgr.restore(micro)
    for b_ in db[2:]:
        step(restored, b_)
    got = state_leaves(restored)
    replay = at == 2 and all(torch.equal(got[n], want[n]) for n in want)
    # the CPU's checkpoint (after its step 1) restored on the card
    cmgr = CheckpointManager(os.path.join(ckpt_dir, cfg.name + "-cpu"),
                             async_save=False)
    cmgr.save(1, cpu)
    back, _ = cmgr.restore(card)
    got = state_leaves(back)
    crossed = all(torch.equal(got[n], b[n]) for n in b)
    bound = lambda k: TRAIN_LOSS_REL if "loss" in k else TRAIN_SMOKE_GRAD_REL
    bad = [k for k, v in gaps.items() if v > bound(k)]
    log(f"check    {cfg.name} ({cfg.family}, f32) training card vs cpu: "
        + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())
        + f" (tolerances: loss {TRAIN_LOSS_REL}, the rest "
        f"{TRAIN_SMOKE_GRAD_REL} relative L2); "
        f"restart replay bit-identical="
        f"{replay}; the CPU's checkpoint restored on the card "
        f"bit-identical={crossed}")
    if bad or not (replay and crossed):
        raise SystemExit(f"{cfg.name} training card vs cpu: {bad}, replay "
                         f"{replay}, restored {crossed}")


def train_smokes(device):
    """Phase 29: every family's smoke config (``TRAIN_SMOKES``) through
    ``train_smoke``, with deterministic algorithms on (warnings only) so
    that the card's replays are bit for bit where PyTorch has a
    deterministic kernel (the MoE dispatch's gathers accumulate their
    gradient with atomics otherwise)."""
    import shutil
    import tempfile

    import torch
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for arch, family in TRAIN_SMOKES:
            train_smoke(device, arch, family, d)
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(d, ignore_errors=True)


# -------------------------------------------------------------- phase 30
class one_rank_mesh:
    """A one-rank NCCL world through a ``FileStore`` under a temporary
    directory (as ``run_sync``) and its (1, 1) ``("data", "model")``
    ``DeviceMesh``; the group is destroyed on exit."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        import tempfile

        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        from repro_torch.launch import mesh
        self.tmp = tempfile.TemporaryDirectory()
        mesh.init(0, 1, dist.FileStore(os.path.join(self.tmp.name, "store"),
                                       1), device=self.device)
        return DeviceMesh("cuda", torch.arange(1).reshape(1, 1),
                          mesh_dim_names=("data", "model"))

    def __exit__(self, *exc):
        import torch.distributed as dist
        dist.destroy_process_group()
        self.tmp.cleanup()


def unshard_params(params):
    """Each DTensor parameter back to its local tensor (on one rank, the
    whole tensor; no copy)."""
    import torch
    for mod in params.modules():
        for k, p in list(mod._parameters.items()):
            if p is not None and hasattr(p, "to_local"):
                mod._parameters[k] = torch.nn.Parameter(
                    p.to_local(), requires_grad=p.requires_grad)


def last_logits(device, cfg, params, prompts, impl, mesh=None):
    """The prefill's last-token logits from an empty cache (whole)."""
    from repro_torch.models import make_cache, prefill
    cache, x, ctx = on_mesh(
        make_cache(cfg, SERVE_B, SERVE_PROMPT + SHARD_GEN, device=device),
        prompts, mesh)
    with ctx:
        logits, _ = prefill(params, cfg, tokens=x, cache=cache, impl=impl)
        return full(logits)


def shard_serve(device, cfg, params, prompts, kernel, impl, want):
    """Phase 30, serving: ``cfg`` through ``run_generate`` (``SHARD_GEN``
    tokens) unsharded, then sharded on a one-rank mesh, from the same
    loaded parameters and prompts; the kernel launches ``want`` times
    through ``local_map`` and no other kernel (``run_generate`` checks
    it); the prefill's last-token logits, every cache leaf and the tokens
    bit for bit.  Returns the sharded path's launches."""
    from repro_torch.train import sharding as S
    lg0 = last_logits(device, cfg, params, prompts, impl)
    _, tok0, run0 = run_generate(device, cfg, params, prompts, kernel, impl,
                                 want, SHARD_GEN)
    with one_rank_mesh(device) as mesh:
        specs = S.param_shardings(params, mesh)
        S.place_params(params, mesh, specs)
        try:
            lg = last_logits(device, cfg, params, prompts, impl, mesh)
            sm90, tok, run = run_generate(device, cfg, params, prompts,
                                          kernel, impl, want, SHARD_GEN, mesh)
            cache = {g: {n: full(t) for n, t in leaves.items()}
                     for g, leaves in run["cache"].items()}
        finally:
            unshard_params(params)
    same = {"logits": same_bits(lg, lg0), "tokens": same_bits(tok, tok0)}
    same.update({f"cache/{g}/{n}": same_bits(t, run0["cache"][g][n])
                 for g, leaves in cache.items() for n, t in leaves.items()})
    log(f"shard    {cfg.name} generate ({SERVE_B}x{SERVE_PROMPT} prompt, "
        f"{SHARD_GEN - 1} decode steps, impl {impl}) on a one-rank mesh: "
        f"wall {1e3 * run['wall']:.3f} ms sharded, "
        f"{1e3 * run0['wall']:.3f} ms unsharded (DTensor dispatch on the "
        f"host: x{run['wall'] / run0['wall']:.3f}); peak memory "
        f"{run['peak']} bytes sharded, {run0['peak']} unsharded; "
        f"{len(specs)} parameters placed, e.g. layers.0 {sorted(set(str(v) for k, v in specs.items() if k.startswith('layers.0.')))}")
    log(f"shard    {cfg.name} sharded == unsharded bit for bit: {same}")
    if not all(same.values()):
        raise SystemExit(f"{cfg.name}: sharded and unsharded serving "
                         f"differ: {same}")
    return sm90


def train_once(device, cfg, params, batch, mesh=None):
    """``loss_and_grads`` and one counted ``build_train_step`` step from
    ``params`` and zero moments, on ``mesh`` or unsharded.  Returns (loss,
    grads, moments, step loss, step wall, counts, peak), whole tensors."""
    import contextlib

    import torch
    from repro_torch.kernels import ssm_scan
    from repro_torch.optim import OptState, adamw_init
    from repro_torch.shard import sharding_rules
    from repro_torch.train import (TrainState, build_train_step,
                                   loss_and_grads)
    from repro_torch.train import sharding as S
    opt = adamw_init(params)
    if mesh is not None:
        specs = S.opt_shardings(opt, mesh)
        opt = OptState(mu=S.place(opt.mu, specs["mu"], mesh),
                       nu=S.place(opt.nu, specs["nu"], mesh), step=opt.step)
        S.place_params(params, mesh, S.param_shardings(params, mesh))
        bs = S.batch_sharding(batch, mesh, False)
        batch = {n: S.distribute(t, mesh, bs[n]) for n, t in batch.items()}
    ctx = (contextlib.nullcontext() if mesh is None
           else sharding_rules(mesh, S.activation_rules(False)))
    step = build_train_step(cfg, train_options())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with ctx:
        loss, grads = loss_and_grads(params, cfg, batch, "auto", True)
        grads = {n: full(g) for n, g in grads.items()}
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        state, m = step(TrainState(params, opt), batch)
        step_loss = full(m["loss"]).cpu()
        wall = time.perf_counter() - t0
        counts = read_counts(ssm_scan)
    moments = {f"{k}/{leaf}": full(t) for k in ("mu", "nu")
               for leaf, t in getattr(state.opt, k).items()}
    return (full(loss), grads, moments, step_loss, wall, counts,
            torch.cuda.max_memory_allocated())


def shard_train(device):
    """Phase 30, training: rwkv6-3b at full width cut to
    ``SHARD_TRAIN_LAYERS`` layers, one step sharded (one-rank mesh) and
    unsharded from the same seeded state and batch: loss, gradients and
    moments bit for bit; ssm_scan_sm90 twice a layer (the forward and
    remat's recompute).  Returns the sharded step's launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config(RWKV_ARCH).replace(n_layers=SHARD_TRAIN_LAYERS)
    make = lambda: init_params(cfg, torch.Generator(device).manual_seed(0),
                               device=device)
    batch = train_batches(cfg, device, 1)[0]
    ref = train_once(device, cfg, make(), batch)
    torch.cuda.empty_cache()
    with one_rank_mesh(device) as mesh:
        got = train_once(device, cfg, make(), batch, mesh)
    want = 2 * SHARD_TRAIN_LAYERS
    same = {"loss": same_bits(got[0], ref[0]),
            "step loss": same_bits(got[3], ref[3]),
            "grads": all(same_bits(got[1][n], g) for n, g in ref[1].items()),
            "moments": all(same_bits(got[2][n], t)
                           for n, t in ref[2].items())}
    log(f"shard    {cfg.name} ({SHARD_TRAIN_LAYERS} layers, {TRAIN_B}x"
        f"{TRAIN_S} tokens) one step: loss {float(ref[0]):.6f}; wall "
        f"{1e3 * got[4]:.3f} ms sharded, {1e3 * ref[4]:.3f} ms unsharded "
        f"(x{got[4] / ref[4]:.3f}); peak memory {got[6]} bytes sharded, "
        f"{ref[6]} unsharded; ssm_scan_sm90 launches sm90 / all "
        f"{got[5][0]} / {got[5][1]} sharded ({ref[5][0]} / {ref[5][1]} "
        f"unsharded), other kernels {got[5][2]}; sharded == unsharded bit "
        f"for bit: {same}")
    if not (got[5][0] == got[5][1] == want and not any(got[5][2].values())):
        raise SystemExit(f"{cfg.name} sharded training: launches {got[5]}, "
                         f"expected {want}")
    if not all(same.values()):
        raise SystemExit(f"{cfg.name}: sharded and unsharded training "
                         f"differ: {same}")
    return got[5][0]


def shard_dryrun():
    """Phase 30, the dry-run: the CLI for ``DRYRUN_CELL`` in a subprocess
    (a fake world of 256 ranks on the meta device; it cannot share a
    process with NCCL), its JSON fields and H100 roofline terms printed."""
    import tempfile
    arch, shape, mesh = DRYRUN_CELL
    with tempfile.TemporaryDirectory() as d:
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                            "--arch", arch, "--shape", shape, "--mesh", mesh,
                            "--out", d], env=env, cwd=ROOT,
                           capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        path = os.path.join(d, f"{mesh}--{arch}--{shape}.json")
        if r.returncode != 0 or not os.path.exists(path):
            raise SystemExit(f"dry-run failed ({r.returncode}):\n"
                             f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        with open(path) as f:
            cell = json.load(f)
    keep = ("chips", "hlo_flops", "hlo_bytes", "coll_bytes",
            "coll_cross_pod", "model_flops", "t_compute", "t_memory",
            "t_collective", "bottleneck", "useful_flops_ratio",
            "roofline_fraction", "constants_values", "v5e", "collectives",
            "memory", "lower_s", "n_ops")
    log(f"dryrun   {mesh} {arch} {shape} in {wall:.2f} s (subprocess): "
        f"{json.dumps({k: cell[k] for k in keep})}")
    if "error" in cell or cell["chips"] != 256:
        raise SystemExit(f"dry-run cell: {cell}")


# -------------------------------------------------------------- phase 35
class TimedCoord:
    """A ``CoordinationService`` whose every ``put`` is timed: the
    virtual seconds its DES advanced and the wall seconds it took."""

    def __init__(self, coord):
        self.coord = coord
        self.puts = []

    def put(self, name, obj):
        sched = self.coord.cluster.sched
        v0, t0 = sched.now, time.perf_counter()
        self.coord.put(name, obj)
        self.puts.append((name, obj, sched.now - v0,
                          time.perf_counter() - t0))

    def get(self, name):
        return self.coord.get(name)


def train_cli_runs(ckpt_dir, device_type):
    """Pool worker: phase 35's ``python -m repro_torch.launch.train``
    processes on ``device_type``, into ``ckpt_dir``: ``TRAIN_CTL_STEPS``
    steps, then ``TRAIN_CTL_EVERY`` more with ``--resume`` (not after a
    failed first).  Returns [(arguments, exit code, output, errors,
    wall s)]; the checks are the main process's."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    runs = []
    for args in (["--steps", str(TRAIN_CTL_STEPS)],
                 ["--steps", str(TRAIN_CTL_STEPS + TRAIN_CTL_EVERY),
                  "--resume"]):
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               TRAIN_CTL_ARCH, "--smoke", "--ckpt-dir", ckpt_dir,
               "--ckpt-every", str(TRAIN_CTL_EVERY), "--device",
               device_type, *args]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                           text=True, timeout=600)
        runs.append((args, r.returncode, r.stdout, r.stderr,
                     time.perf_counter() - t0))
        if r.returncode != 0:
            break
    return runs


def restored_bits(like, ckpt_dir, step):
    """Every leaf of ``like`` restored from ``step``'s files equal to the
    files' bits (bf16 as its uint16 bits)."""
    import numpy as np
    import torch
    from repro_torch.checkpoint.manager import state_leaves
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        files = json.load(f)["files"]
    got = state_leaves(like)
    for name, info in files.items():
        want = torch.from_numpy(np.array(np.load(os.path.join(
            d, info["file"]))))
        t = got[name]
        t = t.view(torch.uint16) if t.dtype == torch.bfloat16 else t
        if tuple(t.shape) != tuple(want.shape) or not torch.equal(
                t.contiguous().view(-1).view(torch.uint8),
                want.contiguous().view(-1).view(torch.uint8)):
            raise SystemExit(f"restore of step {step}: {name} differs")
    return len(files)


def train_control(device, job, d):
    """Phase 35: the trainer's control plane on the card (see the module
    docstring): ``job`` is phase 34's pool job of ``train_cli_runs`` into
    the directory ``d``, which this removes."""
    import shutil

    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import state_leaves
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.runtime import CoordinationService
    from repro_torch.train import build_train_step, init_train_state
    try:
        a = os.path.join(d, "cli")
        runs = job.get()
        for args, rc, out, err, wall in runs:
            log(f"control  launch.train {' '.join(args)}: {wall:.2f} s "
                f"(beside the batch phases); "
                f"{' | '.join(out.strip().splitlines()[-3:])}")
            if rc != 0:
                raise SystemExit(f"launch.train {' '.join(args)} failed "
                                 f"({rc}):\n{out[-3000:]}\n{err[-3000:]}")
        out = runs[0][2]
        last = TRAIN_CTL_STEPS
        want = f"last committed checkpoint: {{'step': {last}, 'dir': 'step_{last}'}}"
        if f"device={device.type}" not in out or want not in out:
            raise SystemExit(f"launch.train: no commit of step {last} on "
                             f"the card:\n{out[-2000:]}")
        with open(os.path.join(a, "coord.journal")) as f:
            journal = [json.loads(line) for line in f if line.strip()]
        steps = [obj["step"] for name, obj in journal
                 if name == "ckpt/latest"]
        more = last + TRAIN_CTL_EVERY
        log(f"control  committed through the service: steps {steps} (the "
            f"first process's and the resumed one's)")
        if steps != list(range(TRAIN_CTL_EVERY, more + 1, TRAIN_CTL_EVERY)) \
                or len(steps) < 3:
            raise SystemExit(f"launch.train committed {steps}")
        out = runs[1][2]
        if f"resumed from step {last}, the committed checkpoint" not in out \
                or f"'step': {more}," not in out:
            raise SystemExit(f"--resume did not restore step {last} and "
                             f"commit {more}:\n{out[-2000:]}")
        # the committed step, restored here on the card through a service
        # rebuilt from the journal
        cfg = get_smoke_config(TRAIN_CTL_ARCH)
        coord = CoordinationService(
            n_nodes=5, n_groups=2, journal=os.path.join(a, "coord.journal"))
        mgr = CheckpointManager(a, coord=coord, async_save=False)
        like = init_train_state(cfg, torch.Generator(device).manual_seed(9),
                                device)
        like, step = mgr.restore(like)
        n = restored_bits(like, a, step)
        log(f"control  restored committed step {step} on the card: {n} "
            f"leaves bit for bit")
        if step != more:
            raise SystemExit(f"restored step {step}, committed {more}")
        # in process: a follower, then the leader crashed between saves
        b = os.path.join(d, "crash")
        coord = TimedCoord(CoordinationService(n_nodes=5, n_groups=2,
                                               seed=1))
        mgr = CheckpointManager(b, coord=coord, async_save=True)
        state = init_train_state(cfg, torch.Generator(device).manual_seed(0),
                                 device)
        step_fn = build_train_step(cfg, train_options())
        stream = SyntheticLMStream(cfg, DataConfig(global_batch=4,
                                                   seq_len=64, seed=0),
                                   device=device)
        svc = coord.coord
        snap = None
        for s in range(3):
            state, metrics = step_fn(state, stream.batch_at(s))
            snap = {k: v.clone() for k, v in state_leaves(state).items()}
            mgr.save(s + 1, state)
            mgr.wait()
            if s == 0:
                svc.crash_node(3)                 # a follower
            elif s == 1:
                old = svc.cluster.leader_id
                svc.crash_node(old)               # the leader
        new = svc.cluster.leader_id
        meta = coord.get("ckpt/latest")
        log(f"control  crashes: follower 3 after step 1, leader {old} after "
            f"step 2; leader now {new}; ckpt/latest {meta}")
        for name, obj, v, w in coord.puts:
            log(f"control  commit {obj}: {v * 1e3:.3f} ms virtual, "
                f"{w * 1e3:.3f} ms wall")
        if meta != {"step": 3, "dir": "step_3"} or new == old:
            raise SystemExit(f"the commit after the leader's crash: {meta}, "
                             f"leader {old} -> {new}")
        fresh = init_train_state(cfg, torch.Generator(device).manual_seed(5),
                                 device)
        fresh, step = mgr.restore(fresh)
        got = state_leaves(fresh)
        bad = [k for k in snap if not torch.equal(got[k], snap[k])]
        log(f"control  restore after the failover: step {step}, "
            f"{len(snap)} leaves, {len(bad)} differ")
        if step != 3 or bad:
            raise SystemExit(f"restore after the failover: step {step}, "
                             f"{bad[:5]} differ")
        return [(v, w) for _, _, v, w in coord.puts]
    finally:
        shutil.rmtree(d, ignore_errors=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention, ssm_scan
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"device   {kind}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    walls = {}

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        walls[name] = time.perf_counter() - t0
        log(f"wall     phase {name}: {walls[name]:.2f} s")
        return out

    phase("2 build", build_kernels)
    err = phase("3 kernel", check_kernel, device)
    timing = phase("4 timing", time_kernel, device)
    draws_timing = phase("36 draws", check_draws, device)
    epaxos_draws_timing = phase("36 epaxos draws", check_epaxos_draws,
                                device)
    launches = phase("5 main", run_main_path, device)
    phase("5 trace", launches_per_step, device)
    phase("6 check", cross_check, device)
    # the batch phases' step loops are host-bound (the card idles ~90% of
    # a step): their grids and check runs go to POOL_WORKERS processes on
    # the one card, which drive it side by side
    import tempfile
    ctl_dir = tempfile.mkdtemp(prefix="chip_smoke_control_")
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(POOL_WORKERS) as pool, \
            ctx.Pool(DES_WORKERS, initializer=lower_priority) as des_pool:
        des_jobs = submit_des_rest(des_pool, os.path.join(ctl_dir, "cli"),
                                   device.type)
        launches += phase("17 branches", run_branches, pool)
        phase("18 bcheck", check_branches, pool)
        efanin = phase("19 efanin", check_efanin, device)
        conflict_launches = phase("20 conflict", run_conflict, pool)
        phase("21 ccheck", check_conflict, pool)
        mega_launches = phase("22 megagrid", run_megagrid, device, pool)
        phase("23 jaxsim", check_jaxsim, device)
        figure_launches = phase("31 figures", run_figures, pool)
        phase("32 fcheck", check_figures, pool)
        gate_launches = phase("33 gate", run_gate, pool)
        phase("34 des", run_des_rest, *des_jobs)
        # the trainer's processes ran in phase 34's pool: their results
        # are read before the pools close
        train_runs = des_jobs[0]["train"]
        train_runs.wait()
    fanin_paths = {"batch grids": launches, "conflict": conflict_launches,
                   "megagrid": mega_launches, "figures": figure_launches,
                   "gate": gate_launches}
    launches = sum(fanin_paths.values())

    flash_err = phase("7 flash", check_flash, device)
    flash_timing = phase("8 timing", time_flash, device)
    cfg, params, prompts = new_model(device, SERVE_ARCH)
    paths = {}
    paths[cfg.name], served, _ = phase("9 serve", run_generate, device,
                                       cfg, params, prompts, flash_attention,
                                       "flash", cfg.n_layers)
    flash_err = max(flash_err, phase("10 check", check_serve, device, cfg,
                                     params, prompts, served,
                                     flash_timing["ms"]))
    paths[f"{cfg.name} sharded serve"] = phase(
        "30 granite", shard_serve, device, cfg, params, prompts,
        flash_attention, "flash", cfg.n_layers)
    phase("10 smoke", check_smoke, device, get_smoke_config(SERVE_ARCH),
          flash_attention, "flash", SMOKE_LOGIT_TOL)
    del cfg, params, prompts, served
    torch.cuda.empty_cache()

    pig_err = phase("11 pig", check_pig, device)
    pig_timing = phase("12 timing", time_pig, device)
    pig_launches = phase("13 sync", run_sync, device)
    torch.cuda.empty_cache()

    ssm_err = phase("14 ssm", check_ssm, device)
    ssm_timing = phase("15 timing", time_ssm, device)
    cfg, params, prompts = rwkv_inputs(device)
    ssm_launches, served, _ = phase("16 serve", run_generate, device, cfg,
                                    params, prompts, ssm_scan, "auto",
                                    cfg.n_layers)
    phase("16 check", check_rwkv_serve, device, cfg, params, prompts, served,
          ssm_timing["ms"])
    ssm_shard = {"rwkv6-3b sharded serve": phase(
        "30 rwkv", shard_serve, device, cfg, params, prompts, ssm_scan,
        "auto", cfg.n_layers)}
    ssm_shard["rwkv6-3b sharded train"] = phase("30 train", shard_train,
                                                device)
    phase("30 dryrun", shard_dryrun)
    phase("16 smoke", check_smoke, device, get_smoke_config(RWKV_ARCH),
          ssm_scan, "auto", RWKV_SMOKE_LOGIT_TOL)
    del cfg, params, prompts, served
    torch.cuda.empty_cache()

    from repro_torch.models.model import n_super
    cfg, params, prompts = phase("24 hybrid", new_model, device, HYBRID_ARCH)
    paths[cfg.name], served, _ = phase("24 serve", run_generate, device,
                                       cfg, params, prompts, flash_attention,
                                       "flash", n_super(cfg))
    flash_err = max(flash_err, phase(
        "25 hcheck", check_hybrid, device, cfg, params, prompts, served,
        flash_timing["zamba2_timing"]["ms"]))
    phase("25 smoke", check_hybrid_smoke, device)
    del cfg, params, prompts, served
    torch.cuda.empty_cache()

    cfg, params, prompts = phase("26 moe", new_model, device, MOE_ARCH)
    paths[cfg.name], served, _ = phase("26 serve", run_generate, device,
                                       cfg, params, prompts, flash_attention,
                                       "flash", cfg.n_layers)
    flash_err = max(flash_err, phase("26 check", check_moe, device, cfg,
                                     params, prompts, served))
    del cfg, params, prompts, served
    torch.cuda.empty_cache()
    cut_launches, cut_err = phase("26 cut", run_moe_cut, device)
    paths[f"{MOE_CUT_ARCH} ({MOE_CUT_LAYERS} layers)"] = cut_launches
    flash_err = max(flash_err, cut_err)
    torch.cuda.empty_cache()
    phase("26 smoke", check_moe_smoke, device)
    torch.cuda.empty_cache()

    ssm_paths = {"rwkv6-3b serve": ssm_launches, **ssm_shard}
    ssm_paths["rwkv6-3b train"] = phase("27 train", train_rwkv, device,
                                        ssm_timing["ms"])
    torch.cuda.empty_cache()
    phase("28 train", train_dense, device)
    torch.cuda.empty_cache()
    phase("29 smokes", train_smokes, device)
    phase("35 control", train_control, device, train_runs, ctl_dir)
    log(f"wall     phases 2-35 together: {sum(walls.values()):.2f} s")

    record = {"name": "seg_fanin", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/seg_fanin_sm90.cu",
              "replaces": "src/repro/kernels/segfanin.py:46",
              "launches": launches, "launches_by_path": fanin_paths,
              "max_abs_err": max(err, efanin[0]),
              **timing, "epaxos_timing": efanin[1], "library_ms": None}
    flash = {"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
             "replaces": "src/repro/kernels/flash_attention.py:22",
             "launches": sum(paths.values()), "launches_by_path": paths,
             "max_abs_err": flash_err, **flash_timing}
    pig = {"name": "pig_aggregate", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/pig_aggregate.cu",
           "replaces": "src/repro/kernels/pig_aggregate.py:20",
           "launches": pig_launches, "max_abs_err": pig_err, **pig_timing,
           "library_ms": None}
    ssm = {"name": "ssm_scan_sm90", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ssm_scan_sm90.cu",
           "replaces": "src/repro/kernels/ssm_scan.py:26",
           "launches": sum(ssm_paths.values()), "launches_by_path": ssm_paths,
           "max_abs_err": ssm_err, **ssm_timing,
           "library_ms": None}
    draws_rec = {"name": "threefry_draws_sm90", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/"
                           "threefry_draws_sm90.cu",
                 "replaces": None,
                 "launches": sum(DRAW_LAUNCHES.values()),
                 "launches_by_path": DRAW_LAUNCHES,
                 "epaxos_launches": sum(EPAXOS_DRAW_LAUNCHES.values()),
                 "epaxos_launches_by_path": EPAXOS_DRAW_LAUNCHES,
                 "max_abs_err": 0.0, **draws_timing,
                 "epaxos_timing": epaxos_draws_timing, "library_ms": None}
    log(json.dumps({"kernels": [record, flash, pig, ssm, draws_rec]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
