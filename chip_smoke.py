#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, any failure exits non-zero before the result line:
  1. build the CUDA kernels from src/repro_torch/csrc (nvcc, sm_90a) and
     print what -Xptxas -v reports for the redesigned kernels #1-#7
     (registers, spills; #4 and #5's dynamic shared memory); a spill
     fails;
  2. hold each kernel against its plain PyTorch version on the card, at the
     shapes the serving path gives it (paper-demo-110m: Hq 12, Hkv 4,
     hd 64, block 16; vocabulary 32000), with adversarial rows, and one
     decode step on the card against the CPU path on the smoke config
     (same weights, same cache) within a stated tolerance; the mask at
     72 x 32000 torch.equal to its plain version under the phase-2 mix,
     the timed settings (tools/time_mask.py) and a batch of adversarial
     rows (top_p 0, 0.9999999 and an exact prefix mass, all-equal rows,
     more ties than the kernel lists, top_k V - 1, V and V + 7, greedy
     rows scaled by 1/1e-6, rows with nothing to mask), two calls
     bit-equal and every row equal to a call on that row alone;
  3. serve a Poisson trace through ServingEngine on paper-demo-110m at full
     width (16 requests, prompt 64, gen 32, 8 slots, greedy, prefix cache
     on) with the launch counts zeroed before and read after, then check
     every token against the streamed-prefill one-shot baseline;
  4. serve a seeded top-k/top-p run at 8 and 4 slots (counts zeroed
     before the first) and require bit-identical tokens;
  5. time each kernel beside its plain version and a PyTorch yardstick at
     the phase-2 shapes (CUDA events), with its bound from those inputs;
     the mask under four settings (the phase-2 mix; top_k 50, top_p 0.9;
     top_p 0.9 alone; nothing to mask) beside one torch.sort;
  6. profile 24 steps of the greedy serve (torch.profiler): wall time per
     step, device busy time and idle share, the kernels that take it;
  7. the paper's loop at full width: run_trace on paper-demo-110m with an
     int8 KV pool, 2 replicas autoscaled up to 4 nodes under a 16-request
     burst (counts zeroed before, read after the run and before its
     verify): the quant kernel launched and the bf16 one not, a scale-up
     and a scale-down, a drained replica released without a leak, and
     the fleet bit-identical to one engine;
  8. one quant engine under the cluster (counts read the same way): the
     same tokens at 8 and 4 slots;
  9. classic admission at full width: 16 requests of 256-token prompts
     (gen 32, 8 slots, greedy), each admitted by a batch-1 prefill through
     the flash-attention kernel and inserted into the paged pool (counts
     read between the run and its verify: 16 x 12 flash launches), then
     every token against the full-prefill one-shot baseline (one B=16
     prefill);
 10. the same trace on the slot pool (--kv slot): the same tokens as
     phase 9, bit for bit;
 11. the recurrent slice's kernels against their plain versions on the
     card at recurrentgemma-9b's and rwkv6-1.6b's shapes: the RG-LRU scan
     bit-equal (B=1 S=2304 W=4096; B=2 S=200 with h0; S=1; ragged W),
     WKV6 (B=1 S=256 H=32 hd=64; B=3 S=100; hd 16 and 32; at the serve's
     shape with decays from exp(-2981) to 1), flash attention at hd 256
     (MQA 16:1, S=2304 with window 2048; B=2 S=200) and paged decode at
     GQA 16, hd 256 over window-ring tables (full rings, shorter ones, a
     null row; each span of 32-256 tokens checked and timed, and the span
     kernel's and the merge's device time, overlapping), and at up to 8
     heads over phases 9 and 10's 288-token tables and their baseline's
     contiguous cache (spans of 256-512 tokens checked and timed); each
     timed beside its plain version, with its bound; the
     RG-LRU scan's and WKV6's rows of one B=16 call bit-equal to batch-1
     calls, and both timed at the one-shot baselines' shapes too (B=8
     S=2304; B=16 S=256);
 12. recurrentgemma-9b at full width and depth (38 layers, random seeded
     weights): 8 Poisson requests of 2304-token prompts (past the
     2048-token window: prefill rolls the ring, the flash kernel masks by
     window, decode wraps the ring), gen 32, 4 slots, block 16, greedy,
     classic admission; counts read between the run and its verify (8 x
     26 RG-LRU scans, 8 x 12 flash launches, paged decode, no WKV6), then
     every token against the full-prefill one-shot baseline (one B=8
     prefill);
 13. rwkv6-1.6b at full width and depth (24 layers): 16 requests of
     256-token prompts, gen 32, 8 slots: 16 x 24 WKV6 launches and no
     attention kernel, then the one-shot verify;
 14. card vs CPU prefill logits at full width and cut depth: one
     (rglru, rglru, local) unit plus the tail of recurrentgemma-9b (5
     layers) at prompt 160 (the flash branch), 2 layers of rwkv6-1.6b at
     prompt 128, each within twice the CPU path's own spread under
     f64-accumulated GEMMs (phase 2's method);
 15. the flash-decoding path (kernel #5) at full width: flash_decode and
     flash_decode_seq_sharded (over a one-rank NCCL group from a file
     store) at paper-demo-110m's attention over a 32768-token contiguous
     cache (B=8, Hq 12, Hkv 4, hd 64) and recurrentgemma-9b's local layer
     over its window (B=4, Hq 16, Hkv 1, hd 256, S=2048), bf16 and f32,
     counts read after; the partials against the plain version at
     cur_len -1, 0, ragged and S-1, eight slices merged against the whole
     cache, times beside SDPA, and each setting of the op's split knobs
     (BLOCKS_PER_SM, the bf16 tile) checked and timed; #5's per-row form
     (each row's own cur_len over a row-to-slot map, the slot pool under
     seq_sharded's decode) at B=8 rows over 8 slots at spread depths,
     permuted and repeated slots, bf16 and f32: against its plain version
     and every row bit for bit the scalar form's, timed beside the scalar
     form and SDPA with its bound from bytes; the mask kernel on
     8 rows of 57857, 65536 and 256000 logits (split over a cluster of
     blocks) and 462849 (a cluster reading device memory) torch.equal to
     the plain version and timed beside it and one torch.sort under phase
     5's four settings;
     a seeded top-k/top-p serve of rwkv6-1.6b (vocab 65536) at full
     width and depth, bit-identical at 8 and 4 slots;
 16. the host swap tier at full width: an EDF-preemptive engine with one
     slot swaps a seeded (k 50 / p 0.9) victim (prompt 64, gen 32) out
     to pinned host memory for an urgent request and back, on the bf16
     and the int8 pools of paper-demo-110m: its tokens equal an
     unpreempted run's, nothing is recomputed, the bytes out equal the
     bytes in, and one swap-out's and one swap-in's wall time is
     printed; phase 7's autoscaled int8 fleet again with --drain preempt
     --swap on (tokens equal one engine's, nothing recomputed, the host
     pool empty and every pool released with its leak checks); the same
     victim on recurrentgemma-9b at full width and phase 14's cut depth
     (5 layers, prompt 160: flash attention and the RG-LRU scan in its
     prefill), swapping its window-ring blocks and state rows;
 17. speculative decoding at full width (paper-demo-110m cut to
     SPEC_LAYERS = 2 of its 12 layers, to keep the script within its
     time limit): n-gram and model drafters at
     spec_k 4 and auto, greedy and seeded (k 50 / p 0.9), on the paged,
     int8 and slot pools over a repetitive trace (8 requests, prompt 64,
     gen 16, 8 slots), each bit-identical to --spec off on the same pool
     with the launches of #1 / #3 and #2 counted between the run and its
     verify, and n-gram k 4 at 4 slots bit-identical to the 8-slot runs;
     accepted tokens per step, and wall tokens/s of n-gram k 4 and the
     model drafter against --spec off, three runs each;
 18. the four dense attention archs at full width and depth (random
     seeded weights; qwen3-32b at 8 of its 64 layers, to keep the script
     within its time limit):
     qwen2-1.5b, granite-3-8b, yi-9b and qwen3-32b (qk-norm) each serve 8
     Poisson requests
     (prompt 64, gen 32, 8 slots, chunked lanes, greedy, block 16, prefix
     cache on), #1 launched at GQA 6, 4, 8 and 8, every token equal to the
     streamed-prefill one-shot baseline; qwen2-1.5b seeded (k 50 / p 0.9)
     bit-identical at 8 and 4 slots (#2 at 151,936 logits), granite-3-8b
     on the int8 pool at 8 and 4 slots (#3 at GQA 4), yi-9b by classic
     admission at prompt 256 (8 x 48 flash launches at hd 128) against the
     full-prefill one-shot; 16 steps of qwen3-32b profiled; qwen3-32b and
     granite-3-8b at 2 layers, card vs CPU prefill logits (phase 14's
     method);
 19. the two MoE archs at full width and cut depth, grok-1-314b at 4 of
     64 layers and llama4-scout-17b-a16e at 4 of 48: the same serve
     completes with #1 launched (GQA 6 and 5) and again with bit-identical
     tokens, the tokens dispatched, capacity and drops printed per layer;
     one MoE layer on the first 72-row step's input, card vs CPU (routing
     equal up to router near-ties, outputs within a relative RMS), timed
     beside its bound; card vs CPU prefill logits at 1 layer, within twice
     the larger of the CPU's f64 spread and the card's own (its
     tensor-core GEMMs against f32 ones); llama4-scout on the int8 pool
     (#3 at GQA 5). No MoE token is held to a one-shot
     baseline: capacity depends on the tokens one dispatch holds, and the
     JAX package's own engine does not equal its baseline there.
 20. train mode, AdamW and make_train_step at full width (random seeded
     weights, one fixed batch of next-token pairs, lr 1e-3): paper-demo-
     110m at B=8 S=128 for 20 steps, rwkv6-1.6b at B=4 for 5 and
     recurrentgemma-9b at 5 layers, B=2, for 3 with fp32 moments,
     llama4-scout at 1 layer (4.1 B parameters) for 3 with int8 moments;
     each loss falling, the first step's gradients finite and nonzero in
     every leaf, none of the seven kernels launched during the steps,
     step wall time and peak memory printed; then one train step of
     paper-demo-110m at 2 layers, card vs CPU: the loss and every
     gradient leaf's norm within twice the larger of the CPU's f64 spread
     and the card's f32-GEMM spread (phases 14 and 19's method);
 21. the rollout loop (launch/rollout.py) at full width (and full
     ROLLOUT_LAYERS = 4 of its 12 layers, to keep the script within its
     time limit): paper-demo-110m, 4 prompts x 4
     samples, prompt 64, gen 32,
     temperature 0.7, top-k 50, top-p 0.9, 2 replicas x 4 slots, block
     16, 2 rounds of 4 DPO steps, then one round with --kv quant; counts
     read between each loop and its verify: #1 and #2 launched (#3 and #2
     in the quant round), none by the DPO steps; the fleet's rollouts
     bit-identical to one engine's at 2 slots, the first DPO loss log 2
     within 1e-4 and falling, round 1 different from round 0 on the same
     seeds and equal to a fresh engine on the weights swapped in; rollout
     tokens/s, DPO step and set_params wall time printed;
 22. the int8 pool of the recurrent archs: kernel #3 at recurrentgemma-
     9b's rings (8 rows, GQA 16, hd 256, 2048-token rings of 16-token
     blocks, rows past the wrap) against its plain version, timed beside
     it and SDPA over the dequantized KV; recurrentgemma-9b (4 requests
     of 2100-token prompts: its rings full at prefill and wrapping in
     decode, gen 16, 4 slots) and rwkv6-1.6b (8 of 256 tokens, 8 slots)
     at full width and depth served with --kv quant by classic
     admission, on one engine and on 2 replicas at half the slots, counts
     read between each run and its verify (#3 for the rings, never #1;
     #4, #6, #7 once a prefill and layer), each passing its --verify (4
     vs 2 slots, bit-identical; the fleet against one engine); a seeded
     recurrentgemma-9b victim on the int8 pool (ring blocks with their
     scales, state rows) swapped out and back, its tokens equal an
     unpreempted run's with nothing recomputed;
 23. the modality archs: #1 at qwen2-vl-7b's GQA 7 (hd 128: the
     one-shot's 416-position cache, the serving row mix, bf16 and int8)
     and at whisper-small's cross (256 frames) and self caches, #4 at
     qwen2-vl's prefill (B=4, 256 vision + 128 prompt positions, causal)
     and at whisper's encoder (non-causal, 256 frames) and decoder
     prefill, each against its plain version and timed beside it and
     SDPA; qwen2-vl-7b (28 layers, 15.2 GB of bf16 weights; 4 requests,
     prompt 128, gen 32) and whisper-small (12 + 12 layers; 8 requests,
     prompt 512, gen 32) at full width and depth through --trace oneshot,
     the counts read around the run (#4 once a prefill layer, encoder
     included; #1 once a decode step and attention, cross included;
     nothing else); both smoke configs' prefill (the flash branch) and 4
     decode steps on the card against the CPU path with seeded stubs; one
     train step of each at full width and 2 layers (and 2 encoder
     layers), the loss finite and no kernel launched;
 24. the elastic runtime (core/elastic.py ElasticTrainer over a
     VirtualCluster on the card, checkpoint/, data/) at paper-demo-110m's
     full width and depth, seq 128, global batch 8, fp32 moments,
     checkpoints every 5 steps: run A 16 steps uninterrupted and twice
     more for 13 (the card's run-to-run loss spread), run B scaled to 3
     nodes at step 6 and a node lost at step 13 (reshards 2: the
     rollback's restore counts as one in the reference, restores 1,
     steps lost 2), run C with int8 moments scaled at step 4; every
     restored state torch.equal to the state saved at that step, run B's
     losses up to the crash within twice the spread, run A's loss
     falling, counts zeroed before and read after (no kernel launched;
     the JSON line's `elastic_launches`); train step, sync save, the
     blocking part of save_async and restore wall times and the bytes of
     a checkpoint printed with the card's name and power limit; then
     `python -m repro_torch.launch.train --smoke` on the card (scale to 3
     at 8, crash at 14) ends with the JAX CLI's `done:` line;
 25. training across ranks (models/model.py's sharded train forward,
     parallel/collectives.py, models/moe.py's ep and tp modes, the
     elastic trainer over a rendered DeviceMesh). Part (a), one rank of
     an NCCL group and a 1 x 1 (data, model) mesh: paper-demo-110m at full
     width and depth, B=8 S=128, fsdp, 5 sharded steps, the losses
     within twice the one-device step's spread over 3 runs (equal if it
     is 0); grok-1-314b's MoE layer at full width in ep and tp modes
     against the one-device layer (relative RMS within 2^-8, the aux
     loss equal); the elastic trainer over the mesh its cluster renders,
     at 2 layers, through a planned scale and a lost node (counters, every
     restored state equal to the saved one); the train CLI under
     torchrun (one NCCL rank) ends with the JAX CLI's `done:` line.
     Part (b), two processes
     sharing the card over a gloo group with CUDA tensors, a (1, 2) mesh:
     the dense step at 2 layers against part (a)'s (the first loss within
     5e-5 relative, the later ones within 1e-2), the ep layer's ranks
     against the one-device layer on each rank's positions. The sharded
     and one-device step times and each rank's peak memory are printed
     with the card's name and power limit; counts zeroed before and read
     after, the ranks' too: no kernel launched (`sharded_launches`);
 26. the one-shot serve over the cluster's rendered mesh (run_oneshot:
     VirtualCluster.submit of serve_batch over the DeviceMesh it renders;
     prefill and decode per rank). Part (a), one NCCL rank and the 1 x 1
     mesh: the serve CLI's `--trace oneshot` under torchrun ends with the
     JAX CLI's lines; paper-demo-110m (B=8, prompt 256, gen 32),
     rwkv6-1.6b and recurrentgemma-9b at 5 layers (B=8, prompt 256, gen
     16), full width: tokens and every step's logits equal the
     one-device one-shot's bit for bit, #4, #1, #6, #7 counted;
     paper-demo-110m under kv_cache="seq_sharded" launches #5 (logits
     along the replicated tokens within 3e-2 of them, tokens under the
     near-tie oracle); #5 at those shapes (a 288-position cache, and a
     (1, 2) rank's 144) against its plain version, merged over the
     one-rank group, and timed beside its plain version, SDPA and its
     bound. Part (b), two processes sharing the card over gloo with CUDA
     tensors, the (1, 2) mesh a VirtualCluster of two nodes renders: the
     same models against one device (logits within 3e-2 before the first
     differing token, tokens under the near-tie oracle), paper-demo-110m
     at 4 layers and gen 16 in both layouts, recurrentgemma-9b with 2048 channels and 8 gate
     blocks a rank, rwkv6-1.6b with 16 heads a rank at 2 layers (at 24 a
     rounding amplified by the recurrence outgrows any tolerance that
     still tells a fault); #5 merged across
     the two ranks against its plain version on the same slices. Part
     (c): rwkv6-1.6b at 2 layers, 3 sharded steps over that mesh against
     one device. Counts zeroed before each run and read after it, the
     ranks' too (`mesh_launches`; #5's row gains `seq_sharded`);
 27. the modality archs over the rendered mesh (the vision rows, M-RoPE
     over Nv + S positions, whisper's encoder per rank, the cross caches
     xk / xv in the KV layout). Part (a), one NCCL rank and the 1 x 1
     mesh: the serve CLI `--arch whisper-small --trace oneshot` under
     torchrun ends with the JAX CLI's lines; qwen2-vl-7b (B=4, 256 vision
     + 128 prompt positions, gen 16) and whisper-small (B=8, prompt 512:
     256 frames, gen 16) at full width and depth through run_oneshot
     (zero stubs, the CLI's: the one-device tokens; #4 once a layer of
     each prefill, the encoder's included, and #1 once a decode step and
     attention, counted exactly), then on seeded nonzero stubs the
     mesh's tokens and every step's logits equal one device's bit for
     bit; under kv_cache="seq_sharded" serve_batch over the mesh launches
     #5 on the self- and cross-attention decode instead of #1 (logits
     along the replicated tokens within 3e-2, tokens under the near-tie
     oracle); #5 at
     whisper's cross caches (256 frames, a (1, 2) rank's 128, every frame
     valid) against its plain version, merged over the one-rank group,
     timed beside its plain version, SDPA and its bound. Part (b), two
     processes sharing the card over gloo, the (1, 2) mesh:
     whisper-small and qwen2-vl-7b at 4 decoder layers, gen 8, both
     layouts, against one device on the same seeded stubs (logits within
     3e-2 before the first differing token), each rank's decode-cache
     bytes (init_cache on the meta device, cross caches included). Part
     (c): whisper-small, 3 sharded steps over that mesh against one
     device (the first loss within twice the spread f32 products give
     the one-device loss).
     Counts zeroed before each run and read after it, the ranks' too
     (`mesh_modality_launches`; #5's row gains `seq_sharded_cross`);
 28. the analytic dry run and the examples (budget: 90 s). (a)
     launch/dryrun.py over every cell of configs.cells() on both
     production meshes (shape-only, 16 x 16 and 2 x 16 x 16) on the
     H100's rates, the fit against this card's total_memory: 64 OK
     lines, reports under reports/dryrun_torch/. (b) Two one-device
     steps at full width and depth against launch/roofline.py's bound
     for the same configuration: paper-demo-110m's train step (B=8
     S=128, phase 20's plan) and qwen2-1.5b's contiguous-cache decode
     step (B=8, 2048 positions, #1 launched 28 times a step), the
     median wall time of 7 steps after 2, the bound, the share of it
     (fails past 1.05: the count would be wrong) and mfu (model flops
     over the time at 989 TFLOP/s); the train state's modeled weight,
     gradient and AdamW bytes equal to the allocated ones; the modeled
     residency beside max_memory_allocated. (c) The four examples
     (src/repro_torch/examples: quickstart at 20 steps, elastic
     scaling, fault tolerance, the serve demo), each exiting 0 with the
     JAX example's lines (EXAMPLE_LINES); the serve demo's two verdicts
     MATCH, #1 and #2 launched (`dryrun_launches`: the decode steps'
     and the demo's, its verify passes included);
 29. the serving engines over the rendered mesh (ServingEngine and
     ReplicaSet with mesh=, per rank; budget: 60 s). Part (a), one NCCL
     rank and the 1 x 1 mesh VirtualCluster(n_compute=1) renders,
     paper-demo-110m at full width and depth: phase 3's trace with phase
     3's tokens (wall tokens/s beside phase 3's); phase 4's seeded trace
     at 8 and 4 slots, bit-identical; the int8 pool as a 2-replica
     ReplicaSet under VirtualCluster.serve through a scale-up and a
     scale-down (4 slots a replica), bit-identical to one engine; the
     slot pool by classic admission at prompt 256 (#4 once a request and
     layer) with phase 10's tokens; recurrentgemma-9b at 5 layers and
     rwkv6-1.6b at 2 by classic admission equal to the engine without a
     mesh. Part (b), two processes sharing the card over gloo, the (1, 2)
     mesh a VirtualCluster of two nodes renders: paper-demo-110m (4
     requests) and recurrentgemma-9b at 5 layers (8 requests, classic
     admission), prompt 64, gen 8, both ranks' tokens equal and equal to
     the one-shot over the same mesh (streamed where the engine admits by
     lanes, else the full prefill of every prompt together), a rank's
     paged pool holding 2 of paper-demo-110m's 4 KV heads. Counts zeroed
     before each mesh run and read after it, the ranks' too: #1, #2, #3,
     #4, #6 and #7 where expected, #5 never (`mesh_engine_launches`);
 30. ROADMAP item 12.2 over the rendered mesh (budget: 60-90 s). Part
     (a), one NCCL rank and the 1 x 1 mesh, paper-demo-110m at full
     width: phase 17's k-4 spec runs at its depth (n-gram on the three
     pools greedy and seeded, the model drafter greedy on the three and
     seeded on the paged pool), each bit for bit phase 17's tokens and
     spec off over the mesh; phase 16's two swap victims, bit for bit
     phase 16's tokens, nothing recomputed, bytes out = in; phase 10's
     trace on the slot pool under seq_sharded (#4 a prefill and layer, #5
     at each row's own depth), bit for bit the seq_sharded one-shot over
     the same mesh. Part (b), two processes sharing the card over gloo,
     the (1, 2) mesh: paper-demo-110m at 2 layers (4 requests, prompt 64,
     gen 8) through n-gram spec (= spec off), a swap victim (= its
     unpreempted run) and the slot pool under seq_sharded (= the
     seq_sharded one-shot; #5 merged across the ranks), both ranks
     equal; a per-rank prefill of 8 prompts against each prompt alone,
     logits and cache leaves bit for bit (paper-demo-110m at 12 layers,
     recurrentgemma-9b at 5, both layouts). Counts zeroed before each run
     and read after it, the ranks' too (`item12_launches`, by part);
 31. the port's linter (repro_torch.analysis) in-process over
     src/repro_torch, failing on any unsuppressed finding; then a
     host-sync census: phase 3's engine (paper-demo-110m at full width,
     paged, prompt 64, 8 slots, greedy) and phase 4's seeded one, each
     warmed, then 4 engine steps under
     torch.cuda.set_sync_debug_mode("warn"). One line gives the syncs per
     step and their sites (file:line under src/repro_torch/, the
     innermost frame there). Printed, not asserted: the per-step token
     download is the one sync the design intends.
Each phase's wall time is printed as it ends.
Phase 2 also holds the quant kernel to its plain version and to the bf16
kernel on the same pool (relative RMS), the flash-attention kernel to its
plain version at six shapes, and one full-width 256-token prefill on the
card to the CPU path; phase 5 times the first four kernels (flash
attention at three shapes, all in its JSON row), phase 11 the recurrent
ones. Each error line of kernels #4 and #5 gives the output's (P.V's)
max abs error and worst row against the plain version, beside the plain
version with its probabilities rounded to one bf16.
Prints the kernel report as one JSON line, the card's name and power
limit, and last {"ok": true, "device": {...}}. Needs no network; the
kernel build lands in build/ (git-ignored).
"""
import atexit
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, os.path.join(HERE, "tools"))

import time_mask  # noqa: E402  the mask's timed shapes and settings

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 rate, the
# bf16 tensor-core rate (paged decode's products take bf16 inputs) and the
# f32 CUDA-core rate (the mask's arithmetic on f32 logits)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

# paged decode vs its plain version: both compute in f32 from the same bf16
# inputs (or the same int8 values and f32 scales), so they differ only by
# summation order (sound runs read below 1e-6); a kernel rounding its
# probabilities to bf16 before P.V reads above 1e-3 (phase 2 checks that
# on the card)
PAGED_TOL = 1e-5
# the int8 pool's attention output against the bf16 pool's, relative RMS:
# the JAX package's bound for its quant kernel (tests/test_kernels.py)
QUANT_RMS_TOL = 0.05
# one decode step, card vs CPU: |diff| / max(|logit|, 1). bf16 logits keep
# 8 bits, so one rounding step is up to 2^-8 of the value; GEMM sums are
# taken in another order on each device
LOGIT_TOL = 3e-2
# flash attention vs its plain version, max abs error of the bf16 output:
# the JAX package's bound for its kernel (tests/test_kernels.py). Both
# compute in f32 from the same bf16 inputs; the output's one bf16 rounding
# is up to 2^-8 of values of a few units
FLASH_TOL = 2e-2
# the flash kernel at the phase-2 shapes: (B, S, Hq, Hkv, hd, causal,
# window); paper-demo's heads first
FLASH_SHAPES = [(1, 256, 12, 4, 64, True, 0), (2, 200, 12, 4, 64, True, 0),
                (1, 256, 12, 4, 64, True, 64), (1, 256, 12, 4, 64, False, 0),
                (1, 256, 12, 1, 64, True, 0), (2, 256, 12, 4, 16, True, 0)]
# ... and the shapes it is timed at (phase 5): the classic admission's
# batch-1 prefill, the one-shot baseline's B=16, a long prompt
FLASH_TIMED = [(1, 256), (16, 256), (1, 2048)]
# the recurrent slice (phase 11). RG-LRU scan and WKV6 against their plain
# versions, max abs error of the f32 outputs: the JAX package's bound for
# its kernels (tests/test_kernels.py). The RG-LRU kernel rounds each
# product and sum as the plain version does, so it must equal it bit for
# bit (it reads 0).
REC_TOL = 2e-3
RGLRU_SHAPES = [(1, 2304, 4096, False), (2, 200, 4096, True),
                (3, 1, 4096, True), (3, 101, 4100, True),
                (2, 77, 1001, True)]  # (B, S, W, with h0)
WKV_SHAPES = [(1, 256, 32, 64), (3, 100, 32, 64), (2, 70, 4, 16),
              (1, 33, 2, 32)]
# ... and the one-shot baselines' prefill shapes, where each kernel's rows
# are held bit-equal to batch-1 calls and timed beside the serve's:
# recurrentgemma-9b's B=8 (held at B=16), rwkv6-1.6b's B=16
RGLRU_BASELINE = (8, 2304, 4096)
WKV_BASELINE = (16, 256, 32, 64)
# flash attention at recurrentgemma-9b's heads: (B, S, Hq, Hkv, hd,
# causal, window); the first is the classic admission's prefill of phase 12
FLASH256_SHAPES = [(1, 2304, 16, 1, 256, True, 2048),
                   (2, 200, 16, 1, 256, True, 0)]
# ... held per output row (position, head) as well: an output row averages
# up to 2048 value rows, so its entries are ~sqrt(e/2048) ~ 0.04 and
# FLASH_TOL is half of one. |kernel - plain| / |plain| over each row's hd
# entries (L2), the worst row: the two sides differ by summation order in
# f32, which flips the bf16 rounding of an entry now and then (one step is
# 2^-8..2^-7 of it, ~4e-4 of a row's norm per flip). A kernel that drops
# or repeats one key of 2048 moves a row by ~1/sqrt(2048) ~ 2e-2.
FLASH_ROW_TOL = 5e-3
# flash-decoding (phase 15): the kernel's partials (o, m, l) against its
# plain version, both in f32 from the same inputs (bf16 or f32), so they
# differ by summation order only, as paged decode's (PAGED_TOL): o and m
# absolute, l relative (a sum of up to S terms near 1). An all-masked
# slice must read m = -1e30, l = 0, o = 0 exactly.
FD_TOL = 1e-5
# eight slices merged against the whole cache: the JAX package's bound
# for 8 shards (tests/test_multidevice.py)
FD_MERGE_TOL = 1e-3
# (name, B, Hq, Hkv, hd, S): paper-demo-110m's attention over a 32k
# contiguous cache (268 MB of bf16 K/V), recurrentgemma-9b's local layer
# over its 2048-token window
FD_SHAPES = [("paper-demo-110m", 8, 12, 4, 64, 32768),
             ("recurrentgemma-9b local", 4, 16, 1, 256, 2048)]
# the mask's rows past shared memory (8 rows, the sampled step of 8
# slots): the first design's widest one-block row plus one, rwkv6-1.6b's
# and recurrentgemma-9b's vocabularies, and one past the widest cluster
MASK_WIDE = tuple(V for T, V in time_mask.SHAPES if T == 8)


# the zoo slice (phases 18 and 19): the dense archs' depths are their own
# but qwen3-32b's, cut to 8 of 64 layers to keep the script within its
# time limit; the MoE archs keep their width and are cut in depth to fit
# one card and the time limit
ZOO_DENSE = ("qwen2-1.5b", "granite-3-8b", "yi-9b", "qwen3-32b")
ZOO_DEPTH = {"qwen3-32b": 8}
ZOO_MOE = (("grok-1-314b", 4), ("llama4-scout-17b-a16e", 4))
# phase 17's paper-demo-110m depth (its width whole), cut as ZOO_DEPTH,
# and its trace (gen 16 since phase 30 replays its k-4 runs over the mesh);
# the spec paths' checks do not depend on depth or length
SPEC_LAYERS = 2
SPEC_TRACE = ("--trace", "repetitive", "--requests", "8", "--gen", "16")
# phase 21's paper-demo-110m depth (its width whole), cut as ZOO_DEPTH;
# the loop's checks do not depend on depth
ROLLOUT_LAYERS = 4
# one MoE layer, card vs CPU on the same input and weights: the bf16
# outputs of the tokens routed alike differ by the expert products'
# rounding (cuBLAS's bf16 GEMMs against f32-accumulated CPU ones, a bf16
# step of 2^-8 now and then): relative RMS within MOE_RMS_TOL
MOE_RMS_TOL = 1e-2


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


# the redesigned kernels (#1-#7): phase 1 fails if one spills
REDESIGNED = ("paged_decode.cu", "topk_topp_mask.cu", "paged_decode_quant.cu",
              "flash_attention.cu", "flash_decode.cu", "rglru_scan.cu",
              "wkv6.cu")


def redesigned_build_report(kernels):
    """Phase 1: what -Xptxas -v reported for the redesigned kernels #1-#7
    (registers, stack, spills) and #4 and #5's dynamic shared memory at
    the shapes the script runs; fails on a spill."""
    entries, section = [], None
    for line in kernels.build_log.splitlines():
        if line.startswith("== "):
            section = line[3:].strip()
        elif section not in REDESIGNED:
            continue
        elif "entry function" in line:
            entries.append((demangle(line.split("'")[1]), []))
        elif entries and ("registers" in line or "spill" in line
                          or "smem" in line):
            entries[-1][1].append(line.replace("ptxas info    :", "")
                                  .strip())
    if not entries:
        fail("no -Xptxas -v report for kernels #1-#7 in the build log")
    print("kernels #1-#7, -Xptxas -v:")
    spilled = []
    for name, lines in entries:
        short = name.replace("(anonymous namespace)::", "").split("(")[0]
        print(f"  {short}: {'; '.join(lines)}")
        if any(" 0 bytes spill stores" not in x for x in lines
               if "spill stores" in x):
            spilled.append(name)
    from repro_torch.kernels.flash_decode.ops import TILE_BY_HD
    lib = kernels.library()
    fd_smem = lambda Hq, Hkv, hd, bf16: lib.flash_decode_smem_bytes(
        Hq, Hkv, hd, next(t for h, t in TILE_BY_HD if hd <= h), bf16)
    print("  dynamic shared memory a block: flash attention "
          + ", ".join(f"hd {hd} {lib.flash_attention_smem_bytes(hd)} B"
                      for hd in (16, 32, 64, 128, 256))
          + "; flash decode " + ", ".join(
              f"{name} {'bf16' if bf16 else 'f32'} "
              f"{fd_smem(Hq, Hkv, hd, bf16)} B"
              for name, _, Hq, Hkv, hd, _ in FD_SHAPES for bf16 in (1, 0)))
    if spilled:
        fail(f"kernels #1-#7 spill registers: {spilled}")


def demangle(name):
    """A kernel's C++ name (c++filt where the machine has it)."""
    try:
        return subprocess.run(["c++filt", name], capture_output=True,
                              text=True, timeout=30).stdout.strip() or name
    except OSError:
        return name


def _events_ms(run, n):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def call_ms(fn, iters=100, warmup=10):
    """Milliseconds per eager call, host work included: back-to-back calls
    whose Python side is slower than the device leave the device idle."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return _events_ms(fn, iters)


def device_ms(fn, calls=20, replays=20):
    """Milliseconds of device work per call: `calls` calls captured once
    in a CUDA graph, replayed `replays` times, so no host work sits
    between the launches."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(graph.replay, replays) / calls


def paged_inputs(gen, dev):
    """One step of the main path: 8 decode rows at depths 64..95 and a
    64-row prefill lane at 0..63, plus adversarial rows (fully masked,
    depth 0, full table), over the engine's 49-block pool."""
    import torch
    B_dec, lane, Hq, Hkv, hd, bs, MB = 8, 64, 12, 4, 64, 16, 6
    B = B_dec + lane + 3
    NB = 1 + 8 * MB
    q = torch.randn((B, Hq, hd), generator=gen, device=dev).to(torch.bfloat16)
    kp = torch.randn((NB, Hkv, bs, hd), generator=gen,
                     device=dev).to(torch.bfloat16)
    vp = torch.randn((NB, Hkv, bs, hd), generator=gen,
                     device=dev).to(torch.bfloat16)
    perm = torch.randperm(NB - 1, generator=gen, device=dev) + 1
    tables = torch.zeros((B, MB), dtype=torch.int32, device=dev)
    lengths = torch.zeros((B,), dtype=torch.int32, device=dev)
    for b in range(B_dec):
        tables[b] = perm[(b % 8) * MB:(b % 8 + 1) * MB].int()
        lengths[b] = 64 + (b * 5) % 32
    tables[B_dec:B_dec + lane] = perm[:MB].int()
    lengths[B_dec:B_dec + lane] = torch.arange(lane, device=dev).int()
    lengths[B - 3] = -1  # masked row: null table
    tables[B - 2] = perm[MB:2 * MB].int()
    lengths[B - 2] = 0
    tables[B - 1] = perm[2 * MB:3 * MB].int()
    lengths[B - 1] = MB * bs - 1
    return q, kp, vp, tables, lengths


def paged_bound_ms(q, kp, tables, lengths, token_bytes):
    """Least time for this call: q, the used table entries and lengths
    read once, the f32 output written once, and each K/V token that some
    row needs read once, at `token_bytes` per (token, KV head) for K and V
    together (2 x 2 hd in bf16; 2 x (hd + 4) in int8 with its f32 scale):
    rows whose tables share a physical block (every row of a prefill lane
    reads the same blocks) share its read. QK and PV at 2 operations per
    multiply-add per row, at the bf16 rate. Counts this run's lengths."""
    B, Hq, hd = q.shape
    Hkv, bs = kp.shape[1], kp.shape[2]
    n_tok = (lengths.long() + 1).clamp_min(0).tolist()
    tab = tables.tolist()
    need = {}  # physical block -> leading tokens of it that some row reads
    for row, n in zip(tab, n_tok):
        for j in range(-(-n // bs)):
            need[row[j]] = max(need.get(row[j], 0), min(bs, n - j * bs))
    blocks = sum(-(-n // bs) for n in n_tok)
    nbytes = (B * Hq * hd * 2 + sum(need.values()) * Hkv * token_bytes
              + blocks * 4 + B * 4 + B * Hq * hd * 4)
    flops = sum(n_tok) * Hq * hd * 2 * 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def mask_bound_ms(T, V):
    """One read and one write of the [T,V] f32 logits (+ per-row k, p);
    about 7 operations an element (max, exp, sum, divide, two compares,
    select)."""
    nbytes = 2 * T * V * 4 + T * 8
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 7 * T * V / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def mask_adversarial(gen, dev, T, V):
    """Phase 2's adversarial rows for the mask (T >= 21, V >= 3000): top_p
    0 and below, top_p 0.9999999 (the nucleus ends deep in the tail),
    top_p equal to a prefix mass (probabilities 0.5, 0.25, 0.25, then 0s),
    all-equal rows, 3000 logits tied at the top (more candidates than the
    kernel lists), top_k V - 1, V and V + 7, greedy rows (logits / 1e-6:
    every probability but the max's is 0), rows with nothing to mask; the
    other rows at the serves' settings."""
    import torch
    x = torch.randn((T, V), generator=gen, device=dev) * 3.0
    rows = [(0, 0.0), (50, 0.0), (0, -1.0), (0, 0.9999999), (50, 0.9999999),
            (0, 0.5), (0, 0.75), (2, 0.75),  # exact prefix masses
            (5, 1.0), (5, 0.9),  # all equal
            (5, 0.9), (2999, 0.9999999),  # 3000 ties at the top
            (V - 1, 1.0), (V, 0.9), (V + 7, 0.5),
            (0, 0.9), (50, 0.9), (0, 0.9999999),  # greedy rows
            (0, 1.0), (-3, 1.5), (1, 0.9)]
    x[5:8, :3] = torch.tensor([0.5, 0.25, 0.25], device=dev).log()
    x[5:8, 3:] = -1e4
    x[8:10] = 0.5
    x[10:12, :3000] = x[10:12].max(dim=1, keepdim=True).values + 1.0
    x[15:18] /= 1e-6
    rows += [(50, 0.9)] * (T - len(rows))
    ks = torch.tensor([r[0] for r in rows], dtype=torch.int32, device=dev)
    ps = torch.tensor([r[1] for r in rows], device=dev)
    return x, ks, ps


def paged_decode_bf16_probs(q, k_pool, v_pool, tables, lengths):
    """The plain version with its softmax probabilities rounded to bf16
    before P.V: what PAGED_TOL must tell apart from a sound kernel."""
    import torch
    B, Hq, hd = q.shape
    _, Hkv, bs, _ = k_pool.shape
    MB = tables.shape[1]
    idx = tables.long()
    kg = k_pool[idx].transpose(1, 2).reshape(B, Hkv, MB * bs, hd).float()
    vg = v_pool[idx].transpose(1, 2).reshape(B, Hkv, MB * bs, hd).float()
    s = q.reshape(B, Hkv, Hq // Hkv, hd).float() @ kg.transpose(-1, -2)
    ok = (torch.arange(MB * bs, device=q.device)[None, None, None, :]
          <= lengths.long()[:, None, None, None])
    a = torch.softmax((s / math.sqrt(hd)).masked_fill(~ok, float("-inf")), -1)
    a = torch.nan_to_num(a, nan=0.0).to(torch.bfloat16).float()
    return (a @ vg).reshape(B, Hq, hd)


def flash_inputs(gen, dev, B, S, Hq, Hkv, hd):
    import torch
    mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(
        torch.bfloat16)
    return mk(B, S, Hq, hd), mk(B, S, Hkv, hd), mk(B, S, Hkv, hd)


def flash_plain(q, k, v, causal=True, window=0):
    """The plain version in the op's layout ([B,S,H,hd] in, [B,S,Hq*hd]
    out)."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    B, S, Hq, hd = q.shape
    o = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), causal=causal, window=window)
    return o.transpose(1, 2).reshape(B, S, Hq * hd)


def flash_plain_bf16_probs(q, k, v, causal=True, window=0):
    """The plain version with its probabilities rounded to one bf16 before
    P.V: the error the kernel's hi/lo split of P avoids."""
    import torch
    B, S, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qf = q.float().transpose(1, 2).reshape(B, Hkv, Hq // Hkv, S, hd)
    kf = k.float().transpose(1, 2)[:, :, None]
    vf = v.float().transpose(1, 2)[:, :, None]
    sc = qf @ kf.transpose(-1, -2) / math.sqrt(hd)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((S, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qpos >= kpos
    if window > 0:
        ok &= (qpos - kpos) < window
    a = torch.softmax(sc.masked_fill(~ok, float("-inf")), -1)
    o = a.to(torch.bfloat16).float() @ vf
    return o.reshape(B, Hq, S, hd).transpose(1, 2).reshape(
        B, S, Hq * hd).to(q.dtype)


def row_rel_err(got, want, Hq):
    """|got - want| / |want| per (row, position, head), L2 over hd, of two
    [B,S,Hq*hd] outputs: [B,S,Hq] f32."""
    B, S, _ = want.shape
    g = got.float().reshape(B, S, Hq, -1)
    w = want.float().reshape(B, S, Hq, -1)
    return (g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)


def flash_bound_ms(B, S, Hq, Hkv, hd, causal=True, window=0):
    """Least time for one call: q, k, v read once and the output written
    once (bf16), against 4 hd flops (two products, a multiply and an add
    each) per unmasked (query, key) pair per query head, at the bf16
    tensor-core rate."""
    lo = lambda i: max(0, i - window + 1) if window > 0 else 0
    hi = lambda i: i if causal else S - 1
    pairs = sum(hi(i) - lo(i) + 1 for i in range(S))
    nbytes = 2 * (2 * B * S * Hq * hd + 2 * B * S * Hkv * hd)
    flops = 4 * hd * pairs * Hq * B
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def rglru_bound_ms(B, S, W, with_h0):
    """a and b read once and h written once, 4 bytes each per (row, step,
    channel), plus h0; a multiply and an add per element at the f32 rate."""
    nbytes = 12 * B * S * W + (4 * B * W if with_h0 else 0)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * B * S * W / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def wkv6_bound_ms(B, S, H, hd):
    """r, k, v (bf16) and logw (f32) read once, o (f32) written once, u
    read and the final state written once; about 4 hd^2 f32 operations a
    (step, head): r^T S (2 hd^2) and the decayed update as a multiply-add
    (2 hd^2)."""
    n = B * S * H * hd
    nbytes = n * (3 * 2 + 4 + 4) + H * hd * 4 + B * H * hd * hd * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 4 * hd * hd * B * S * H / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def ring_inputs(gen, dev):
    """One decode step of recurrentgemma-9b's local layer over the
    engine's window-ring pool (4 slots of 128 blocks of 16, MQA 16:1, hd
    256): two full rings (lengths 2047 = window - 1), a part-filled ring,
    a short one, a depth-0 row and a masked row with a null table."""
    import torch
    Hq, Hkv, hd, bs, MB = 16, 1, 256, 16, 128
    lens = [2047, 2047, 1500, 17, 0, -1]
    B, NB = len(lens), 1 + 4 * MB
    mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(
        torch.bfloat16)
    q, kp, vp = mk(B, Hq, hd), mk(NB, Hkv, bs, hd), mk(NB, Hkv, bs, hd)
    perm = torch.randperm(NB - 1, generator=gen, device=dev) + 1
    tables = torch.zeros((B, MB), dtype=torch.int32, device=dev)
    for b, n in enumerate(lens):
        if n >= 0:
            tables[b] = perm[(b % 4) * MB:(b % 4 + 1) * MB].int()
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kp, vp, tables, lengths


def classic_table_inputs(gen, dev, bs, B):
    """A decode step of paper-demo-110m's attention (Hq 12, Hkv 4, hd 64)
    over 288-token tables: classic admission's and the slot pool's at
    prompt 256, gen 32 (bs 16, 18 blocks a row), or the one-shot
    baseline's contiguous cache (bs = S = 288, a block a row); B rows at
    depths 256..287."""
    import torch
    Hq, Hkv, hd, MB = 12, 4, 64, 288 // bs
    NB = 1 + B * MB
    mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(
        torch.bfloat16)
    q, kp, vp = mk(B, Hq, hd), mk(NB, Hkv, bs, hd), mk(NB, Hkv, bs, hd)
    perm = torch.randperm(NB - 1, generator=gen, device=dev) + 1
    tables = perm.view(B, MB).int().contiguous()
    lengths = torch.tensor([256 + (b * 31) // max(B - 1, 1)
                            for b in range(B)], dtype=torch.int32,
                           device=dev)
    return q, kp, vp, tables, lengths


def check_wkv6_decay_range(gen, dev):
    """WKV6 at the serve's shape with strong and weak decays mixed: logw =
    -exp(x), x per (head, channel) uniform in [-20, 8] (the model's
    rwkv_decay clamp: w from exp(-2981) = 0 to 1 - 2e-9) plus a per-step
    jitter. Finite and within REC_TOL of the plain version; returns the
    error."""
    import torch
    from repro_torch.kernels.rwkv6.ops import wkv6
    from repro_torch.kernels.rwkv6.ref import wkv6_ref
    B, S, H, hd = WKV_SHAPES[0]
    mk = lambda: torch.randn((B, S, H, hd), generator=gen, device=dev) * 0.5
    r, k, v = (mk().to(torch.bfloat16) for _ in range(3))
    x = torch.rand((H, hd), generator=gen, device=dev) * 28.0 - 20.0 + mk()
    logw = -torch.exp(x.clamp(-20.0, 8.0))
    u = torch.randn((H, hd), generator=gen, device=dev) * 0.3
    o, sf = wkv6(r, k, v, logw, u)
    torch.cuda.synchronize()
    ro, rs = wkv6_ref(*(t.transpose(1, 2) for t in (r, k, v, logw)), u)
    err = max(float((o - ro.transpose(1, 2)).abs().max()),
              float((sf - rs).abs().max()))
    w = torch.exp(logw)
    print(f"wkv6 B={B} S={S} H={H} hd={hd}, decays mixed (w from "
          f"{float(w.min()):.3e} to {float(w.max()):.9f}, "
          f"{float((w < 1e-3).float().mean()):.3f} of them below 1e-3): "
          f"kernel vs plain max abs err {err:.3e}; tolerance {REC_TOL}")
    if (not bool(torch.isfinite(o).all()) or not bool(torch.isfinite(sf)
                                                       .all())):
        fail("wkv6 across the decay range: a value is not finite")
    if not math.isfinite(err) or err > REC_TOL:
        fail(f"wkv6 kernel vs plain across the decay range: {err}")
    return err


def check_batch_rows(gen, dev):
    """Each recurrent kernel's rows of one call at the one-shot baseline's
    batch against batch-1 calls, bit for bit (the engine's batch-1
    prefill is held to the baseline's token for token), and its time at
    the baseline's shape (device work per call)."""
    import torch
    from repro_torch.kernels.rglru.ops import rglru_scan
    from repro_torch.kernels.rwkv6.ops import wkv6
    out = {}
    _, S, W = RGLRU_BASELINE
    a = torch.rand((16, S, W), generator=gen, device=dev) * 0.949 + 0.05
    b = torch.randn((16, S, W), generator=gen, device=dev)
    h = rglru_scan(a, b)
    for i in range(16):
        if not torch.equal(h[i:i + 1], rglru_scan(a[i:i + 1], b[i:i + 1])):
            fail(f"rglru_scan: row {i} of a B=16 call differs from its B=1 "
                 "call")
    B = RGLRU_BASELINE[0]
    a, b = a[:B], b[:B]
    bound, by = rglru_bound_ms(B, S, W, False)
    out["rglru"] = {"shape": [B, S, W], "bound_ms": bound, "bound_by": by,
                    "ms": device_ms(lambda: rglru_scan(a, b), calls=5,
                                    replays=5)}
    del a, b, h
    B, S, H, hd = WKV_BASELINE
    mk = lambda: torch.randn((B, S, H, hd), generator=gen, device=dev) * 0.5
    r, k, v = (mk().to(torch.bfloat16) for _ in range(3))
    logw = -torch.exp(mk() - 1.0)
    u = torch.randn((H, hd), generator=gen, device=dev) * 0.3
    o, sf = wkv6(r, k, v, logw, u)
    for i in range(B):
        oi, si = wkv6(*(t[i:i + 1] for t in (r, k, v, logw)), u)
        if not (torch.equal(o[i:i + 1], oi) and torch.equal(sf[i:i + 1],
                                                              si)):
            fail(f"wkv6: row {i} of a B={B} call differs from its B=1 call")
    bound, by = wkv6_bound_ms(B, S, H, hd)
    out["wkv6"] = {"shape": [B, S, H, hd], "bound_ms": bound,
                   "bound_by": by,
                   "ms": device_ms(lambda: wkv6(r, k, v, logw, u), calls=5,
                                   replays=5)}
    print("rglru_scan (B=16, S=2304, W=4096) and wkv6 (B=16, S=256, H=32, "
          "hd=64): every row of one call bit-equal to its batch-1 call")
    return out


def check_recurrent_kernels(dev):
    """Phase 11: the recurrent slice's kernels against their plain
    versions on the card, and their times at the serving shapes."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_decode import ops as pd_ops
    from repro_torch.kernels.paged_decode.ops import paged_flash_decode
    from repro_torch.kernels.paged_decode.ref import paged_decode_ref
    from repro_torch.kernels.rglru.ops import rglru_scan
    from repro_torch.kernels.rglru.ref import rglru_ref_loop
    from repro_torch.kernels.rwkv6.ops import wkv6
    from repro_torch.kernels.rwkv6.ref import wkv6_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    out = {}
    worst = 0.0
    for B, S, W, with_h0 in RGLRU_SHAPES:
        a = torch.rand((B, S, W), generator=gen, device=dev) * 0.949 + 0.05
        b = torch.randn((B, S, W), generator=gen, device=dev)
        h0 = (torch.randn((B, W), generator=gen, device=dev) if with_h0
              else None)
        got = rglru_scan(a, b, h0)
        torch.cuda.synchronize()
        want = rglru_ref_loop(a, b, h0)
        err = float((got - want).abs().max())
        print(f"rglru_scan B={B} S={S} W={W} h0={with_h0}: kernel vs plain "
              f"max abs err {err:.3e}; must be bit-equal")
        if not torch.equal(got, want):
            fail(f"rglru_scan kernel vs plain at B={B} S={S} W={W}: not "
                 f"bit-equal, max abs err {err}")
        worst = max(worst, err)
        if (B, S, W) == RGLRU_SHAPES[0][:3]:
            out["rglru_in"] = (a, b, h0)
    out["rglru_err"] = worst
    worst = 0.0
    for B, S, H, hd in WKV_SHAPES:
        mk = lambda: torch.randn((B, S, H, hd), generator=gen,
                                 device=dev) * 0.5
        r, k, v = (mk().to(torch.bfloat16) for _ in range(3))
        logw = -torch.exp(mk() - 1.0)
        u = torch.randn((H, hd), generator=gen, device=dev) * 0.3
        o, sf = wkv6(r, k, v, logw, u)
        torch.cuda.synchronize()
        ro, rs = wkv6_ref(*(t.transpose(1, 2) for t in (r, k, v, logw)), u)
        err = max(float((o - ro.transpose(1, 2)).abs().max()),
                  float((sf - rs).abs().max()))
        print(f"wkv6 B={B} S={S} H={H} hd={hd}: kernel vs plain max abs err "
              f"{err:.3e} (output and final state); tolerance {REC_TOL}")
        if not math.isfinite(err) or err > REC_TOL:
            fail(f"wkv6 kernel vs plain at B={B} S={S} H={H} hd={hd}: {err}")
        worst = max(worst, err)
        if (B, S, H, hd) == WKV_SHAPES[0]:
            out["wkv_in"] = (r, k, v, logw, u)
    worst = max(worst, check_wkv6_decay_range(gen, dev))
    out["wkv_err"] = worst
    out["baseline"] = check_batch_rows(gen, dev)
    worst = 0.0
    for B, S, Hq, Hkv, hd, causal, window in FLASH256_SHAPES:
        q, k, v = flash_inputs(gen, dev, B, S, Hq, Hkv, hd)
        got = flash_attention(q, k, v, causal=causal, window=window,
                              n_kv_heads=Hkv)
        torch.cuda.synchronize()
        want = flash_plain(q, k, v, causal, window)
        err = float((got.float() - want.float()).abs().max())
        rel = row_rel_err(got, want, Hq)
        ref16 = flash_plain_bf16_probs(q, k, v, causal, window)
        print(f"flash attention B={B} S={S} Hq={Hq} Hkv={Hkv} hd={hd} "
              f"causal={causal} window={window}: kernel vs plain max abs "
              f"err {err:.3e} (tolerance {FLASH_TOL}), worst row "
              f"{float(rel.max()):.3e} of its norm (median "
              f"{float(rel.median()):.3e}; tolerance {FLASH_ROW_TOL}); the "
              f"plain version with P rounded to one bf16: "
              f"{float((ref16.float() - want.float()).abs().max()):.3e}, "
              f"worst row {float(row_rel_err(ref16, want, Hq).max()):.3e}")
        del ref16
        if not math.isfinite(err) or err > FLASH_TOL:
            fail(f"flash attention kernel vs plain at hd={hd} S={S} "
                 f"window={window}: {err}")
        if not bool(torch.isfinite(rel).all()) or rel.max() > FLASH_ROW_TOL:
            fail(f"flash attention kernel vs plain at hd={hd} S={S} "
                 f"window={window}: a row off by {float(rel.max())} of "
                 "its norm")
        if window:
            # the check sees the window: rows past it, without the mask
            moved = row_rel_err(flash_plain(q, k, v, causal, 0), want,
                                Hq)[:, window:]
            print(f"  rows at or past the window, windowed vs not: median "
                  f"{float(moved.median()):.3e} of the row's norm, "
                  f"{float((moved > FLASH_ROW_TOL).float().mean()):.4f} of "
                  f"them above the tolerance")
            if moved.median() <= FLASH_ROW_TOL:
                fail("flash attention: the row tolerance does not tell the "
                     "window from no window")
        worst = max(worst, err)
        if (B, S) == FLASH256_SHAPES[0][:2]:
            out["flash_in"] = (q, k, v)
    out["flash_err"] = worst
    pin = ring_inputs(gen, dev)
    got = paged_flash_decode(*pin)
    torch.cuda.synchronize()
    err = float((got - paged_decode_ref(*pin)).abs().max())
    print(f"paged decode, GQA 16 hd 256 over window rings (lengths "
          f"{pin[4].tolist()}): kernel vs plain max abs err {err:.3e}; "
          f"tolerance {PAGED_TOL}")
    if not math.isfinite(err) or err > PAGED_TOL:
        fail(f"paged decode kernel vs plain at GQA 16, hd 256: {err}")
    if float(got[-1].abs().max()) != 0.0:
        fail("paged decode at GQA 16: the masked row is not zero")
    out["ring_in"], out["ring_err"] = pin, err
    # the GQA-16 span (tokens a block reads): each width checked and timed,
    # the op's own restored
    chosen, by_span = pd_ops.SPAN_GQA16, {}
    for span in (32, 64, 128, 256):
        pd_ops.SPAN_GQA16 = span
        e = float((paged_flash_decode(*pin) - paged_decode_ref(*pin))
                  .abs().max())
        if not math.isfinite(e) or e > PAGED_TOL:
            fail(f"paged decode at GQA 16 with {span}-token spans: {e}")
        by_span[span] = device_ms(lambda: paged_flash_decode(*pin)) * 1e3
    pd_ops.SPAN_GQA16 = chosen
    print("paged decode at GQA 16 over the rings, us by span (tokens a "
          f"block reads; the op takes {chosen}): {by_span}")
    # ... and its two launches (the spans, then their merge: a programmatic
    # dependent launch, whose blocks start while the span kernel runs and
    # wait for it, so the two times overlap and do not add)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            paged_flash_decode(*pin)
        torch.cuda.synchronize()
    per_launch = {e.key.split("<")[0].split("(")[0].split("::")[-1]:
                  e.device_time_total / e.count
                  for e in prof.key_averages()
                  if "paged_decode" in e.key and e.count}
    print("paged decode over the rings, device us a launch (the merge's "
          f"overlaps the span kernel's): {per_launch}")
    # up to 8 heads: the span over classic admission's and the slot pool's
    # 288-token tables (phases 9 and 10) and their one-shot baseline's
    # contiguous cache, each checked and timed, the op's own restored
    chosen, by_span = pd_ops.SPAN, {}
    wide = {bs: classic_table_inputs(gen, dev, bs, B)
            for bs, B in ((16, 8), (288, 16))}
    for span in (256, 320, 384, 512):
        pd_ops.SPAN = span
        for bs, win in wide.items():
            e = float((paged_flash_decode(*win) - paged_decode_ref(*win))
                      .abs().max())
            if not math.isfinite(e) or e > PAGED_TOL:
                fail(f"paged decode over 288-token tables (bs {bs}) with "
                     f"{span}-token spans: {e}")
            by_span[f"bs {bs}, span {span}"] = device_ms(
                lambda: paged_flash_decode(*win)) * 1e3
    pd_ops.SPAN = chosen
    print("paged decode, Hq 12 Hkv 4 hd 64 over 288-token tables (8 rows at "
          "bs 16, 16 at bs = S), depths 256-287, us by span (the op takes "
          f"{chosen}): {by_span}")

    # times at the serving shapes (device work per call, CUDA graph replay)
    a, b, h0 = out["rglru_in"]
    B, S, W = a.shape
    bound, by = rglru_bound_ms(B, S, W, h0 is not None)
    out["rglru"] = {"ms": device_ms(lambda: rglru_scan(a, b, h0)),
                    "plain_ms": device_ms(lambda: rglru_ref_loop(a, b, h0),
                                          calls=2, replays=3),
                    "bound_ms": bound, "bound_by": by, "library_ms": None}
    r, k, v, logw, u = out["wkv_in"]
    B, S, H, hd = r.shape
    bound, by = wkv6_bound_ms(B, S, H, hd)
    out["wkv6"] = {
        "ms": device_ms(lambda: wkv6(r, k, v, logw, u)),
        "plain_ms": device_ms(lambda: wkv6_ref(
            *(t.transpose(1, 2) for t in (r, k, v, logw)), u),
            calls=2, replays=3),
        "bound_ms": bound, "bound_by": by, "library_ms": None}
    q, k, v = out["flash_in"]
    B, S, Hq, hd = q.shape
    Hkv, window = k.shape[2], FLASH256_SHAPES[0][6]
    bound, by = flash_bound_ms(B, S, Hq, Hkv, hd, True, window)
    qpos = torch.arange(S, device=dev)
    wmask = ((qpos[:, None] >= qpos[None, :])
             & (qpos[:, None] - qpos[None, :] < window))
    out["flash256"] = {
        "ms": device_ms(lambda: flash_attention(
            q, k, v, causal=True, window=window, n_kv_heads=Hkv), calls=5,
            replays=5),
        "plain_ms": device_ms(lambda: flash_plain(q, k, v, True, window),
                              calls=2, replays=3),
        "bound_ms": bound, "bound_by": by,
        "library_ms": device_ms(lambda: torch.nn.functional
                                .scaled_dot_product_attention(
                                    *(t.transpose(1, 2) for t in (q, k, v)),
                                    attn_mask=wmask, enable_gqa=True),
                                calls=5, replays=5)}
    q, kp, vp, tables, lengths = pin
    Bq, Hq, hd = q.shape
    MB, bs, Hkv = tables.shape[1], kp.shape[2], kp.shape[1]
    kg = kp[tables.long()].transpose(1, 2).reshape(
        Bq, Hkv, MB * bs, hd).repeat_interleave(Hq // Hkv, dim=1)
    vg = vp[tables.long()].transpose(1, 2).reshape(
        Bq, Hkv, MB * bs, hd).repeat_interleave(Hq // Hkv, dim=1)
    amask = (torch.arange(MB * bs, device=dev)[None, :]
             <= lengths.clamp_min(0).long()[:, None])[:, None, None, :]
    bound, by = paged_bound_ms(q, kp, tables, lengths, token_bytes=2 * 2 * hd)
    out["ring"] = {
        "ms": device_ms(lambda: paged_flash_decode(*pin)),
        "plain_ms": device_ms(lambda: paged_decode_ref(*pin)),
        "bound_ms": bound, "bound_by": by,
        "library_ms": device_ms(lambda: torch.nn.functional
                                .scaled_dot_product_attention(
                                    q[:, :, None, :], kg, vg,
                                    attn_mask=amask))}
    for name, t in out.pop("baseline").items():
        out[name]["baseline"] = t
        print(f"{name} at the one-shot baseline's {t['shape']}: "
              f"{t['ms'] * 1e3} us kernel, bound {t['bound_ms'] * 1e3} us "
              f"({t['bound_by']}), {t['bound_ms'] / t['ms']:.4f} of the "
              f"bound")
    for name in ("rglru", "wkv6", "flash256", "ring"):
        t = out[name]
        lib = ("none" if t["library_ms"] is None
               else f"{t['library_ms'] * 1e3} us")
        print(f"{name}: {t['ms'] * 1e3} us kernel, {t['plain_ms'] * 1e3} us "
              f"plain, library {lib}, bound {t['bound_ms'] * 1e3} us "
              f"({t['bound_by']}), {t['bound_ms'] / t['ms']:.4f} of the "
              f"bound")
    return out


def check_kernels(dev):
    import torch
    from repro_torch.kernels.paged_decode.ops import (
        paged_flash_decode, paged_flash_decode_quant, quantize_kv)
    from repro_torch.kernels.paged_decode.ref import (paged_decode_quant_ref,
                                                      paged_decode_ref)
    from repro_torch.kernels.sampling.ops import topk_topp_mask
    from repro_torch.kernels.sampling.ref import NEG_INF, topk_topp_mask_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {}
    # paged decode over the block pool, and over a contiguous cache read as
    # B blocks of S tokens (the one-shot baseline's layout)
    pin = paged_inputs(gen, dev)
    q, kp, vp, tables, lengths = pin
    got = paged_flash_decode(*pin)
    torch.cuda.synchronize()
    want = paged_decode_ref(*pin)
    err = float((got - want).abs().max())
    if not math.isfinite(err) or err > PAGED_TOL:
        fail(f"paged decode kernel vs plain: max abs err {err}")
    if float(got[-3].abs().max()) != 0.0:
        fail("paged decode: the masked row is not zero")
    kc = torch.randn((16, 4, 96, 64), generator=gen,
                     device=dev).to(torch.bfloat16)
    vc = torch.randn((16, 4, 96, 64), generator=gen,
                     device=dev).to(torch.bfloat16)
    qc = torch.randn((16, 12, 64), generator=gen, device=dev).to(torch.bfloat16)
    ident = torch.arange(16, dtype=torch.int32, device=dev)[:, None]
    lc = torch.randint(0, 96, (16,), generator=gen, device=dev).int()
    err_c = float((paged_flash_decode(qc, kc, vc, ident, lc)
                   - paged_decode_ref(qc, kc, vc, ident, lc)).abs().max())
    if not math.isfinite(err_c) or err_c > PAGED_TOL:
        fail(f"paged decode kernel vs plain, contiguous cache: {err_c}")
    err_bf16 = float((paged_decode_bf16_probs(*pin) - want).abs().max())
    if not err_bf16 > PAGED_TOL:
        fail(f"paged decode: bf16 probabilities read {err_bf16}, within the "
             f"tolerance {PAGED_TOL}, so it cannot tell them apart")
    out["paged"] = (pin, max(err, err_c))
    print(f"paged decode: kernel vs plain max abs err {err:.3e} (pool), "
          f"{err_c:.3e} (contiguous cache); tolerance {PAGED_TOL}; the plain "
          f"version with bf16 probabilities reads {err_bf16:.3e}")

    # quantized paged decode: the same pool, quantized as the quant
    # backend writes it (int8 over head_dim, one f32 scale per row)
    kq, ks = quantize_kv(kp)
    vq, vs = quantize_kv(vp)
    qin = (q, kq, vq, ks, vs, tables, lengths)
    got_q = paged_flash_decode_quant(*qin)
    torch.cuda.synchronize()
    err_q = float((got_q - paged_decode_quant_ref(*qin)).abs().max())
    if not math.isfinite(err_q) or err_q > PAGED_TOL:
        fail(f"quant paged decode kernel vs plain: max abs err {err_q}")
    if float(got_q[-3].abs().max()) != 0.0:
        fail("quant paged decode: the masked row is not zero")
    fp = paged_flash_decode(*pin)
    rms = float(((got_q - fp) ** 2).mean().sqrt() / (fp ** 2).mean().sqrt())
    if not rms < QUANT_RMS_TOL:
        fail(f"quant paged decode vs the bf16 pool: relative RMS {rms}")
    out["quant"] = (qin, err_q)
    print(f"quant paged decode: kernel vs plain max abs err {err_q:.3e}; "
          f"tolerance {PAGED_TOL}; relative RMS against the bf16 kernel on "
          f"the unquantized pool {rms:.3e} (bound {QUANT_RMS_TOL})")

    # top-k/top-p mask at the sampled step's shapes: 72 rows x 32000,
    # under the phase-2 mix, the other timed settings and adversarial rows
    T, V = 72, 32000
    cases = {st: time_mask.mask_inputs(st, T, V, gen, dev)
             for st in time_mask.SETTINGS}
    cases["adversarial"] = mask_adversarial(gen, dev, T, V)
    for name, (logits, ks, ps) in cases.items():
        got = topk_topp_mask(logits, ks, ps)
        torch.cuda.synchronize()
        want = topk_topp_mask_ref(logits, ks, ps)
        keep_g, keep_w = got > NEG_INF / 2, want > NEG_INF / 2
        if not bool(torch.equal(keep_g, keep_w)):
            bad = int((keep_g != keep_w).sum())
            fail(f"top-k/top-p mask ({name}): keep-sets differ in {bad} "
                 f"entries")
        if not bool(torch.equal(got, want)):
            fail(f"top-k/top-p mask ({name}): kept logits changed")
        print(f"top-k/top-p mask ({name}): keep-sets equal over {T}x{V} "
              f"({int(keep_g.sum())} kept), kept logits bit-equal")
    if not bool(torch.equal(topk_topp_mask(logits, ks, ps), got)):
        fail("top-k/top-p mask: two calls differ")
    for t in range(T):
        if not bool(torch.equal(topk_topp_mask(
                logits[t:t + 1], ks[t:t + 1], ps[t:t + 1])[0], got[t])):
            fail(f"top-k/top-p mask: row {t} alone differs from the batch")
    print("top-k/top-p mask: two calls bit-equal, every adversarial row "
          "alone equal to the batch's")
    logits, ks, ps = cases["mix"]
    out["mask"] = (cases, float((topk_topp_mask(logits, ks, ps)
                                 - topk_topp_mask_ref(logits, ks, ps))
                                .abs().max()))

    # flash attention at the phase-2 shapes (a ragged tile, a window,
    # bidirectional, MQA, narrow heads)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    worst = 0.0
    for B, S, Hq, Hkv, hd, causal, window in FLASH_SHAPES:
        q, k, v = flash_inputs(gen, dev, B, S, Hq, Hkv, hd)
        got = flash_attention(q, k, v, causal=causal, window=window,
                              n_kv_heads=Hkv)
        torch.cuda.synchronize()
        want = flash_plain(q, k, v, causal, window)
        err = float((got.float() - want.float()).abs().max())
        rel = float(row_rel_err(got, want, Hq).max())
        ref16 = flash_plain_bf16_probs(q, k, v, causal, window)
        print(f"flash attention B={B} S={S} Hq={Hq} Hkv={Hkv} hd={hd} "
              f"causal={causal} window={window}: kernel vs plain max abs "
              f"err {err:.3e} (tolerance {FLASH_TOL}), worst row {rel:.3e} "
              f"of its norm; the plain version with P rounded to one bf16: "
              f"{float((ref16.float() - want.float()).abs().max()):.3e}, "
              f"worst row {float(row_rel_err(ref16, want, Hq).max()):.3e}")
        if not math.isfinite(err) or err > FLASH_TOL:
            fail(f"flash attention kernel vs plain at B={B} S={S} "
                 f"Hkv={Hkv} hd={hd} causal={causal} window={window}: {err}")
        worst = max(worst, err)
    out["flash"] = worst
    return out


def serve_args(extra):
    from repro_torch.launch.serve import parse_args
    return parse_args(
        ["--requests", "16", "--prompt-len", "64", "--gen", "32",
         "--slots", "8", "--rate", "16", "--prefix-cache", "on",
         "--device", "cuda"] + extra)


def check_tokens(run, cfg):
    out, trace = run["out"], run["trace"]
    if sorted(out) != sorted(r.rid for r in trace):
        fail("not every request completed")
    for r in trace:
        toks = out[r.rid]
        if len(toks) != r.eff_gen_len or not all(
                0 <= t < cfg.vocab_size for t in toks):
            fail(f"request {r.rid}: bad tokens {toks[:8]}...")


def check_against_cpu():
    """One decode step of the smoke config on the card vs the CPU path on
    the same weights and cache (bf16 logits)."""
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.launch import steps as St
    from repro_torch.models import model as Mo
    from repro_torch.models.env import Env

    cfg = get_smoke("paper-demo")
    params = Mo.init_params(cfg, Env(), seed=1, device="cpu")
    gen = torch.Generator().manual_seed(1)
    B, S = 6, 40
    cache = Mo.init_cache(cfg, Env(), B, S, device="cpu")
    for leaf in cache["blocks"][0].values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen).to(leaf.dtype))
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen)
    cur = torch.tensor([0, 3, 17, 30, 38, 39])
    step = St.make_decode_step(cfg, Env())
    to_dev = lambda t: {k: to_dev(v) for k, v in t.items()} \
        if isinstance(t, dict) else (tuple(to_dev(v) for v in t)
                                     if isinstance(t, tuple) else t.cuda())
    lg_gpu, _ = step(to_dev(params), to_dev(cache), tok.cuda(), cur.cuda())
    lg_cpu, _ = step(params, cache, tok, cur)
    ref = lg_cpu.float()
    err = float(((lg_gpu.float().cpu() - ref).abs()
                 / ref.abs().clamp_min(1.0)).max())
    if not math.isfinite(err) or err > LOGIT_TOL:
        fail(f"decode step card vs CPU: max relative logit err {err}")
    print(f"decode step on the card vs the CPU path (smoke config): max "
          f"relative logit err {err:.3e}; tolerance {LOGIT_TOL}")


def route_capture(records):
    """Patch the MoE router so each call appends (gates [n,E] f32 on the
    CPU, expert set [n,E] bool, kept set [n,E] bool) to `records`; returns
    the undo. The sets read the router's own sorted assignment and rank,
    the capacity the one moe_layer takes for n tokens."""
    import torch
    from repro_torch.models import moe as M
    route, capacity = M._route, M._capacity
    caps = []

    def cap(n, E, k, cf):
        caps.append(capacity(n, E, k, cf))
        return caps[-1]

    def capture(x_flat, router_w, E, k):
        out = route(x_flat, router_w, E, k)
        e_s, tok_s, rank = (t.cpu() for t in (out[0], out[1], out[3]))
        n = x_flat.shape[0]
        sets = torch.zeros((n, E), dtype=torch.bool)
        sets[tok_s, e_s] = True
        keep = rank < caps[-1]
        kept = torch.zeros((n, E), dtype=torch.bool)
        kept[tok_s[keep], e_s[keep]] = True
        gates = torch.softmax(x_flat.float().cpu() @ router_w.cpu(), dim=-1)
        records.append((gates, sets, kept))
        return out

    M._route, M._capacity = capture, cap

    def undo():
        M._route, M._capacity = route, capacity

    return undo


def routing_moves(got, ref, k):
    """Tokens the two runs' MoE layers route otherwise: (moved [n] bool,
    experts differ; affected [n] bool, experts or kept set differ; the
    reference's gate margins (k-th minus (k+1)-th gate) at the moved
    tokens; the router noise: the largest gate difference between the
    runs), over every MoE layer of the records."""
    import torch
    n = ref[0][0].shape[0]
    moved = torch.zeros((n,), dtype=torch.bool)
    affected = torch.zeros((n,), dtype=torch.bool)
    margins, noise = [], 0.0
    for (g1, s1, k1), (g0, s0, k0) in zip(got, ref):
        m = (s1 != s0).any(1)
        top = torch.sort(g0, dim=-1, descending=True).values
        margins += (top[:, k - 1] - top[:, k])[m].tolist()
        moved |= m
        affected |= m | (k1 != k0).any(1)
        noise = max(noise, float((g1 - g0).abs().max()))
    return moved, affected, margins, noise


def check_prefill_against_cpu(cfg, params, S=256, card_spread=False):
    """One full-width prefill (B=1, S=256: the flash branch) on the card
    vs the CPU path (plain attention, f32-accumulated GEMMs) on the same
    weights, |diff| / max(|logit|, 1) over every position's logits.

    Twelve bf16 layers spread under any change of summation order, so the
    tolerance is measured in the same run: the CPU path against itself
    with its GEMMs accumulated in f64 (each product still rounded once to
    bf16; an MoE arch's expert products as well) — two computations of
    the same function that differ only in rounding. The card may differ
    from the CPU by at most twice that spread, in the worst logit and on
    average: it reorders the GEMMs (cuBLAS) and the attention sums (the
    flash kernel's online softmax).

    An MoE arch (run at 1 layer) routes by a top-k of its gates, so a
    rounding difference at a router near-tie sends a token to another
    expert and moves the kept sets of its experts: those positions'
    logits change by O(1), as the JAX package's own MoE decode and forward
    do (its tests hold them to 0.5). Every token routed otherwise must
    have had its k-th and (k+1)-th gates within twice the router noise
    (the largest gate difference between the two runs); the positions
    whose expert or kept set differs in either comparison are counted and
    left out of both the error and the spread (in one layer the MoE
    output reaches only its own position).

    card_spread (phase 19) measures a second spread on the card: its
    bf16 GEMMs (tensor cores) against the same prefill with every product
    taken in f32 on the card, and the tolerance is twice the larger of the
    two spreads. A tensor-core GEMM's f32 accumulation rounds otherwise
    than the CPU's: at llama4-scout's width it moves 0.3% of a bf16
    projection's outputs by one step against the CPU path, and 4.9% of
    the expert FFN's (the down product reads gate and up products that
    moved), where f64 accumulation moves far fewer; so the f64 spread
    alone undercounts the card's rounding (one layer of llama4-scout:
    mean 3.06e-3 on the card against a f64 spread of 8.5e-4, every
    position alike, on an H100; PERF.md §6)."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import model as Mo
    from repro_torch.models import moe as M
    from repro_torch.models.env import Env

    t0 = time.perf_counter()
    tok = torch.randint(0, cfg.vocab_size, (1, S),
                        generator=torch.Generator().manual_seed(2))
    cpu = lambda t: {k: cpu(v) for k, v in t.items()} \
        if isinstance(t, dict) else (tuple(cpu(v) for v in t)
                                     if isinstance(t, tuple) else t.cpu())
    routes = {"card": [], "cpu": [], "alt": []}

    def prefill(p, t, name):
        undo = route_capture(routes[name]) if cfg.moe is not None else None
        try:
            return Mo.forward(p, t, cfg, Env(), mode="prefill")[0].float()
        finally:
            if undo:
                undo()

    lg_gpu = prefill(params, tok.cuda(), "card").cpu()
    cparams = cpu(params)
    ref = prefill(cparams, tok, "cpu")
    linear = L.linear

    def linear_f64(x, w):
        y = x.reshape(-1, x.shape[-1]).double() @ w.double()
        return y.float().to(x.dtype).reshape(*x.shape[:-1], w.shape[-1])

    def expert_ffn_f64(buf, wg, wu, wd):
        mm = lambda a, b: (a.double() @ b.double()).float().to(a.dtype)
        return mm(L.silu(mm(buf, wg)) * mm(buf, wu), wd)

    L.linear = linear_f64
    ffn = M._expert_ffn
    if cfg.moe is not None:  # an MoE arch's expert products too
        M._expert_ffn = expert_ffn_f64
    try:
        alt = prefill(cparams, tok, "alt")
    finally:
        L.linear = linear
        M._expert_ffn = ffn
    card_f32 = None
    if card_spread:
        bmm = L._bf16_matmul
        mm32 = lambda a, b: (a.float() @ b.float()).to(a.dtype)
        L.linear, L._bf16_matmul = mm32, mm32  # experts through L too
        routes["card_f32"] = []
        try:
            card_f32 = prefill(params, tok.cuda(), "card_f32").cpu()
        finally:
            L.linear, L._bf16_matmul = linear, bmm
    keep = torch.ones((S,), dtype=torch.bool)
    moe_line = ""
    if cfg.moe is not None:
        k = cfg.moe.top_k
        moved, affected, margins, noise = routing_moves(
            routes["card"], routes["cpu"], k)
        a_moved, a_affected, a_margins, a_noise = routing_moves(
            routes["alt"], routes["cpu"], k)
        if any(m > 2 * noise for m in margins) or any(
                m > 2 * a_noise for m in a_margins):
            fail(f"{cfg.name} prefill: tokens routed otherwise away from a "
                 f"near-tie: margins {margins} (card, router noise "
                 f"{noise:.3e}), {a_margins} (f64 GEMMs, {a_noise:.3e})")
        keep = ~(affected | a_affected)
        if card_spread:
            _, c_affected, c_margins, c_noise = routing_moves(
                routes["card_f32"], routes["card"], k)
            if any(m > 2 * c_noise for m in c_margins):
                fail(f"{cfg.name} prefill: f32 GEMMs on the card route "
                     f"tokens otherwise away from a near-tie: {c_margins}")
            keep &= ~c_affected
        moe_line = (f"; MoE routing: {int(moved.sum())} tokens routed "
                    f"otherwise on the card (gate margins {margins}, "
                    f"router noise {noise:.3e}), {int(a_moved.sum())} "
                    f"with f64 GEMMs; {int((~keep).sum())} of {S} positions "
                    "whose expert or kept set moved left out")
    rel = lambda a, b=ref: ((a - b).abs() / ref.abs().clamp_min(1.0))[
        :, keep]
    err, spread = rel(lg_gpu), rel(alt)
    alt_max, alt_mean = spread = spread.max(), spread.mean()
    own = ""
    if card_f32 is not None:
        mine = rel(card_f32, lg_gpu)
        own = (f"; the card against itself with f32 GEMMs: max "
               f"{float(mine.max()):.3e}, mean {float(mine.mean()):.3e}")
        spread = (torch.maximum(spread[0], mine.max()),
                  torch.maximum(spread[1], mine.mean()))
    same = float((lg_gpu.argmax(-1) == ref.argmax(-1)).float().mean())
    print(f"{cfg.name} ({cfg.n_layers} layers) full-width prefill (S={S}) "
          f"on the card vs the CPU path: "
          f"relative logit err max {float(err.max()):.3e}, mean "
          f"{float(err.mean()):.3e}; the CPU path against itself with "
          f"f64-accumulated GEMMs: max {float(alt_max):.3e}, mean "
          f"{float(alt_mean):.3e}{own}; argmax equal at {same:.4f} of the "
          f"positions{moe_line}; {time.perf_counter() - t0:.1f}s")
    if not (math.isfinite(float(err.max()))
            and float(err.max()) <= 2 * float(spread[0])
            and float(err.mean()) <= 2 * float(spread[1])):
        fail("prefill card vs CPU: the logits differ by more than twice "
             "the spread of a reordered CPU computation")


def profile_steps(args, cfg, params, n_steps=24, warm=4, host_ops=0):
    """Per-step wall time, device busy time (sum of the profiler's
    device-side events; one stream, so no overlap) and the top kernels,
    over n_steps engine steps after `warm` steps; with host_ops, the
    operators that take the most host time too. The profiler adds host
    time, so the idle share is an upper bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import make_engine, make_trace

    engine = make_engine(args, cfg, params)
    engine.submit(make_trace(args, cfg))
    for _ in range(warm):
        engine.step()
        engine.clock.sleep(args.step_time)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            engine.step()
            engine.clock.sleep(args.step_time)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
    # device-side events only (kernels, copies): an operator's own device
    # time repeats that of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and dev(e) > 0]
    busy_us = sum(dev(e) for e in events)
    wall_us = wall * 1e6
    if not events:
        print(f"profile, {n_steps} greedy steps: {wall_us / n_steps:.0f} us "
              "wall per step; the profiler saw no device time, so device "
              "busy time and idle share are not measured")
        return
    print(f"profile {cfg.name}, {n_steps} greedy steps: "
          f"{wall_us / n_steps:.0f} us wall per step, "
          f"{busy_us / n_steps:.0f} us device busy per step, "
          f"device idle share {1 - busy_us / wall_us:.3f}")
    for e in sorted(events, key=dev, reverse=True)[:8]:
        print(f"  {dev(e) / n_steps:9.1f} us/step  x{e.count / n_steps:6.1f}"
              f"  {e.key[:70]}")
    if host_ops:
        ops = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CPU]
        print(f"  host: {sum(e.self_cpu_time_total for e in ops) / n_steps:.0f}"
              f" us of operator time per step, "
              f"{sum(e.count for e in ops) / n_steps:.0f} operator calls")
        for e in sorted(ops, key=lambda e: e.self_cpu_time_total,
                        reverse=True)[:host_ops]:
            print(f"  {e.self_cpu_time_total / n_steps:9.1f} us/step host  "
                  f"x{e.count / n_steps:6.1f}  {e.key[:60]}")


def serve_recurrent(arch, extra, counted):
    """Phases 12-13: serve `arch` at full width and depth (random seeded
    weights) by classic admission, gen 32, block 16, greedy; read the
    launch counts between the run and its verify, then hold every token to
    the full-prefill one-shot baseline. Returns the launches of the
    arch's recurrence kernel, of paged decode and of flash attention."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_decode.ops import paged_flash_decode
    from repro_torch.kernels.rglru.ops import rglru_scan
    from repro_torch.kernels.rwkv6.ops import wkv6
    from repro_torch.launch.serve import parse_args, serve, verify
    from repro_torch.models import model as Mo
    from repro_torch.models.env import Env

    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = Mo.init_params(cfg, Env(), seed=0, device="cuda")
    torch.cuda.synchronize()
    n_par = sum(x.numel() for x in _leaves(params))
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_par / 1e9:.2f} B parameters on the card "
          f"({time.perf_counter() - t0:.1f}s to draw)")
    args = parse_args(["--arch", arch, "--gen", "32", "--rate", "16",
                       "--block-size", "16", "--device", "cuda"] + extra)
    for op in counted:
        op.launches = 0
    torch.cuda.reset_peak_memory_stats()
    run = serve(args, cfg, params)
    kinds = cfg.block_pattern * cfg.num_blocks + cfg.pattern_tail
    want = {rglru_scan: args.requests * kinds.count("rglru"),
            wkv6: args.requests * kinds.count("rwkv"),
            flash_attention: (args.requests * kinds.count("local")
                              if args.prompt_len > 128 else 0)}
    got = {op: op.launches for op in counted}
    for op, n in want.items():
        if got[op] != n:
            fail(f"{cfg.name}: {op.__name__} launched {got[op]} times, "
                 f"expected {n}")
    n_dec = got[paged_flash_decode]
    if ("local" in kinds) != (n_dec > 0):
        fail(f"{cfg.name}: paged decode launched {n_dec} times")
    if run["engine"].metrics.preemptions:
        fail(f"{cfg.name}: the serve preempted at the worst-case budget")
    check_tokens(run, cfg)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t1 = time.perf_counter()
    ok, line = verify(args, cfg, params, run)
    if not ok:
        fail(f"{cfg.name} serve: {line}")
    print(f"{cfg.name} classic serve (prompt {args.prompt_len}, gen 32, "
          f"{args.slots} slots): {run['tokens']} tokens in {run['steps']} "
          f"decode steps, {run['wall_s']:.3f}s wall, "
          f"{run['tokens'] / run['wall_s']:.1f} tokens/s wall, peak "
          f"{peak:.1f} GiB on {card()}; launches: rglru_scan "
          f"{got[rglru_scan]}, wkv6 {got[wkv6]}, flash attention "
          f"{got[flash_attention]}, paged decode {n_dec}; {line} "
          f"(baseline {time.perf_counter() - t1:.1f}s)")
    # where a decode step's time goes: a burst fills every slot in the
    # first step (its prefills), the next steps decode
    profile_steps(parse_args(["--arch", arch, "--gen", "32", "--trace",
                              "burst", "--block-size", "16", "--device",
                              "cuda"] + extra), cfg, params, n_steps=8,
                  warm=2, host_ops=8)
    del params, run
    torch.cuda.empty_cache()
    return (got[rglru_scan] or got[wkv6]), n_dec, got[flash_attention]


def fd_bound_ms(B, Hq, Hkv, hd, n_tok, itemsize):
    """Least time for one call: the K/V rows up to cur_len and q read once,
    o (f32) and m, l written once, at the card's memory rate; against 4 hd
    operations (two products, a multiply and an add each) per (query head,
    valid key), at the rate of the inputs' type."""
    nbytes = (2 * B * Hkv * n_tok * hd * itemsize + B * Hq * hd * itemsize
              + B * Hq * (hd + 2) * 4)
    flops = 4 * hd * n_tok * Hq * B
    rate = BF16_FLOPS if itemsize == 2 else F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def fd_plain_bf16_probs(q, k, v, cur_len):
    """The plain partials' o with the probabilities rounded to one bf16
    before P.V: the error the kernel's hi/lo split of P avoids."""
    import torch
    B, Hq, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    s = q.float().reshape(B, Hkv, Hq // Hkv, hd) @ k.float().transpose(
        -1, -2) / math.sqrt(hd)
    ok = torch.arange(S, device=q.device) <= cur_len
    m = torch.where(ok, s, torch.full_like(s, -1e30)).amax(-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), torch.zeros_like(s))
    o = (p.to(torch.bfloat16).float() @ v.float()) / torch.clamp_min(
        p.sum(-1, keepdim=True), 1e-30)
    return o.reshape(B, Hq, hd)


def check_flash_decode(dev):
    """Phase 15: the flash-decoding path at full width. The entry points a
    caller uses (flash_decode on one card, flash_decode_seq_sharded over a
    one-rank NCCL group) driven once per shape and dtype with the launch
    count zeroed before and read after; then kernel #5 against its plain
    version at cur_len -1, 0, a ragged value and S-1, eight slices merged
    against the whole cache, the sharded op against the unsharded one, and
    the times at cur_len = S-1."""
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode.ops import (
        flash_decode, flash_decode_partials, flash_decode_seq_sharded,
        merge_partials_stacked)
    from repro_torch.kernels.flash_decode.ref import (
        flash_decode_partials_ref)

    store = tempfile.mkdtemp()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            rank=0, world_size=1)
    gen = torch.Generator(device=dev).manual_seed(15)
    cases = []
    for name, B, Hq, Hkv, hd, S in FD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)
            q, k, v = mk(B, Hq, hd), mk(B, Hkv, S, hd), mk(B, Hkv, S, hd)
            cases.append((name, dtype, q, k, v, S * 5 // 8 + 3))
    try:
        # the path: each entry point once per case, counts zeroed before
        flash_decode_partials.launches = 0
        for name, dtype, q, k, v, ragged in cases:
            cur = torch.tensor([ragged], dtype=torch.int32, device=dev)
            whole = flash_decode(q, k, v, cur)
            sharded = flash_decode_seq_sharded(q, k, v, cur)
            torch.cuda.synchronize()
            # one rank merges o * l / l: one f32 rounding, at most one
            # rounding step of q's dtype after the cast
            eps = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22
            if not bool(((sharded.float() - whole.float()).abs()
                         <= eps * whole.float().abs() + 1e-30).all()):
                fail(f"flash_decode_seq_sharded over one NCCL rank differs "
                     f"from flash_decode ({name}, {dtype})")
        launches = flash_decode_partials.launches
        if launches != 2 * len(cases):
            fail(f"the flash-decoding path launched kernel #5 {launches} "
                 f"times, expected {2 * len(cases)}")
        print(f"flash-decoding entry points (flash_decode, and "
              f"flash_decode_seq_sharded over a one-rank NCCL group, equal "
              f"to it within one rounding of q's dtype) at "
              f"{[c[0] for c in FD_SHAPES]} x (bf16, f32): kernel #5 "
              f"launched {launches} times")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)

    worst, rows = 0.0, []
    for name, dtype, q, k, v, ragged in cases:
        B, Hq, hd = q.shape
        Hkv, S = k.shape[1], k.shape[2]
        tag = f"{name} B={B} Hq={Hq} Hkv={Hkv} hd={hd} S={S} {dtype}"
        for c in (-1, 0, ragged, S - 1):
            cur = torch.tensor([c], dtype=torch.int32, device=dev)
            o, m, l = flash_decode_partials(q, k, v, cur)
            torch.cuda.synchronize()
            if c < 0:
                if (o.any() or l.any()
                        or not bool((m == -1e30).all())):
                    fail(f"flash decode, all-masked slice ({tag}): not m = "
                         "-1e30, l = 0, o = 0")
                continue
            ro, rm, rl = flash_decode_partials_ref(q, k, v, cur)
            errs = (float((o - ro).abs().max()), float((m - rm).abs().max()),
                    float(((l - rl).abs() / rl).max()))
            if not all(math.isfinite(e) and e <= FD_TOL for e in errs):
                fail(f"flash decode kernel vs plain ({tag}, cur_len {c}): "
                     f"o {errs[0]}, m {errs[1]}, l relative {errs[2]}")
            worst = max(worst, errs[0])
            row = lambda x: float(((x - ro).norm(dim=-1)
                                   / ro.norm(dim=-1).clamp_min(1e-30)).max())
            o16 = fd_plain_bf16_probs(q, k, v, c)
            print(f"  cur_len {c}: o (P.V) max abs err {errs[0]:.3e}, worst "
                  f"row {row(o):.3e} of its norm; m {errs[1]:.3e}, l "
                  f"relative {errs[2]:.3e}; the plain version with P "
                  f"rounded to one bf16: o {float((o16 - ro).abs().max()):.3e}"
                  f", worst row {row(o16):.3e}")
            del o16
        n = 8
        s = S // n
        merged = {}
        for c in (ragged, S - 1):
            parts = [flash_decode_partials(
                q, k[:, :, i * s:(i + 1) * s].contiguous(),
                v[:, :, i * s:(i + 1) * s].contiguous(),
                min(max(c - i * s, -1), s - 1)) for i in range(n)]
            got = merge_partials_stacked(*(torch.stack(x) for x in
                                           zip(*parts)))
            merged[c] = float((got - flash_decode_partials(
                q, k, v, c)[0]).abs().max())
            if not math.isfinite(merged[c]) or merged[c] > FD_MERGE_TOL:
                fail(f"flash decode, 8 slices merged vs the whole cache "
                     f"({tag}, cur_len {c}): {merged[c]}")
        print(f"flash decode {tag}: kernel vs plain (o, m, l relative) "
              f"within {FD_TOL} at cur_len -1 (exact), 0, {ragged}, {S - 1}; "
              f"8 slices merged vs the whole: {merged} (tolerance "
              f"{FD_MERGE_TOL})")
        # times at cur_len = S - 1, the cache full
        cur = torch.tensor([S - 1], dtype=torch.int32, device=dev)
        qs = q[:, :, None, :]
        bound, by = fd_bound_ms(B, Hq, Hkv, hd, S, q.element_size())
        row = {"shape": tag, "cur_len": S - 1,
               "ms": device_ms(lambda: flash_decode_partials(q, k, v, cur)),
               "plain_ms": device_ms(lambda: flash_decode_partials_ref(
                   q, k, v, cur), calls=5, replays=5),
               "library_ms": device_ms(
                   lambda: torch.nn.functional.scaled_dot_product_attention(
                       qs, k, v, enable_gqa=True)),
               "bound_ms": bound, "bound_by": by}
        print(f"  {row['ms'] * 1e3} us kernel, {row['plain_ms'] * 1e3} us "
              f"plain, {row['library_ms'] * 1e3} us SDPA, bound "
              f"{bound * 1e3} us ({by}), {bound / row['ms']:.4f} of the "
              f"bound")
        rows.append(row)
        # the op's split knobs: each setting checked and timed, the op's
        # own restored
        ro = flash_decode_partials_ref(q, k, v, cur)[0]
        chosen = (fd_ops.BLOCKS_PER_SM, fd_ops.BF16_TILE)
        by_knob = {}
        try:
            for bps in (4, 8):
                for tile in ((32, 64) if dtype == torch.bfloat16 else
                             (chosen[1],)):
                    fd_ops.BLOCKS_PER_SM, fd_ops.BF16_TILE = bps, tile
                    e = float((flash_decode_partials(q, k, v, cur)[0]
                               - ro).abs().max())
                    if not math.isfinite(e) or e > FD_TOL:
                        fail(f"flash decode ({tag}) at BLOCKS_PER_SM {bps}, "
                             f"tile {tile}: o off by {e}")
                    by_knob[(bps, tile)] = device_ms(
                        lambda: flash_decode_partials(q, k, v, cur)) * 1e3
        finally:
            fd_ops.BLOCKS_PER_SM, fd_ops.BF16_TILE = chosen
        print(f"  us by (BLOCKS_PER_SM, bf16 tile) (the op takes {chosen}; "
              f"f32 keeps its tile of TILE_BY_HD): {by_knob}")
    return launches, worst, rows


def fd_rows_bound_ms(Hq, Hkv, hd, ns, itemsize):
    """fd_bound_ms for rows at their own depths: row b reads its n_b valid
    K/V rows (ns; 0 for a row at -1) once, its q once, and writes its o,
    m, l; 4 hd operations per (query head, valid key)."""
    B, n_tok = len(ns), sum(ns)
    nbytes = (2 * Hkv * n_tok * hd * itemsize + B * Hq * hd * itemsize
              + B * Hq * (hd + 2) * 4 + 2 * B * 4)
    flops = 4 * hd * n_tok * Hq
    rate = BF16_FLOPS if itemsize == 2 else F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_flash_decode_rows(dev):
    """Phase 15: kernel #5's per-row form (the slot pool under a
    seq_sharded plan decodes each row at its own depth over its own
    slot). FD_SHAPES' heads at B=8 rows over a cache of 8 slots, the rows
    at spread depths (-1, 0, a ragged one, S/2, S-1, ...) through a
    permuted row-to-slot map, and again through one with repeated slots
    (verify rows sharing a slot), in bf16 and f32: against its plain
    version (FD_TOL; a row at -1 exactly m = -1e30, l = 0, o = 0) and bit
    for bit the scalar form's row, called on the slots' rows gathered
    (the same B, so the same split) at that row's depth. Then timed
    beside the scalar form over the same gathered rows with the cache
    full and SDPA over them (a boolean mask per row), its bound from the
    bytes its rows' depths read. Returns (the worst o error, rows for
    the JSON line)."""
    import torch
    from repro_torch.kernels.flash_decode.ops import flash_decode_partials
    from repro_torch.kernels.flash_decode.ref import (
        flash_decode_partials_ref)

    gen = torch.Generator(device=dev).manual_seed(151)
    perm = torch.tensor([3, 7, 0, 5, 1, 6, 2, 4], dtype=torch.int32,
                        device=dev)
    shared = torch.tensor([2, 2, 2, 5, 5, 0, 7, 7], dtype=torch.int32,
                          device=dev)
    worst, rows = 0.0, []
    for name, _, Hq, Hkv, hd, S in FD_SHAPES:
        B = 8
        depths = [-1, 0, S * 5 // 8 + 3, S // 2, S - 1, 1, S // 3, S - 1]
        for dtype in (torch.bfloat16, torch.float32):
            mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)
            q, k, v = mk(B, Hq, hd), mk(B, Hkv, S, hd), mk(B, Hkv, S, hd)
            cur = torch.tensor(depths, dtype=torch.int32, device=dev)
            tag = (f"{name} B={B} Hq={Hq} Hkv={Hkv} hd={hd} S={S} {dtype} "
                   f"per-row")
            for label, slots in (("permuted", perm), ("shared", shared)):
                o, m, l = flash_decode_partials(q, k, v, cur, slots)
                ro, rm, rl = flash_decode_partials_ref(q, k, v, cur, slots)
                torch.cuda.synchronize()
                live = cur >= 0
                if (o[~live].any() or l[~live].any()
                        or not bool((m[~live] == -1e30).all())):
                    fail(f"flash decode per-row ({tag}, {label}): a row at "
                         "-1 is not m = -1e30, l = 0, o = 0")
                errs = (float((o - ro)[live].abs().max()),
                        float((m - rm)[live].abs().max()),
                        float(((l - rl)[live].abs() / rl[live]).max()))
                if not all(math.isfinite(e) and e <= FD_TOL for e in errs):
                    fail(f"flash decode per-row kernel vs plain ({tag}, "
                         f"{label}): o {errs[0]}, m {errs[1]}, l relative "
                         f"{errs[2]}")
                worst = max(worst, errs[0])
                kg = k[slots.long()].contiguous()
                vg = v[slots.long()].contiguous()
                for b, c in enumerate(depths):
                    so, sm, sl = flash_decode_partials(
                        q, kg, vg, torch.tensor([c], dtype=torch.int32,
                                                device=dev))
                    if not (torch.equal(so[b], o[b]) and torch.equal(sm[b], m[b])
                            and torch.equal(sl[b], l[b])):
                        fail(f"flash decode per-row ({tag}, {label}) row {b} "
                             f"at {c}: not the scalar form's bits")
                print(f"flash decode {tag}, {label} slots "
                      f"{slots.tolist()}, depths {depths}: vs plain o "
                      f"{errs[0]:.3e}, m {errs[1]:.3e}, l relative "
                      f"{errs[2]:.3e}; every row bit for bit the scalar "
                      f"form's")
            kg, vg = k[perm.long()].contiguous(), v[perm.long()].contiguous()
            full = torch.tensor([S - 1], dtype=torch.int32, device=dev)
            amask = (torch.arange(S, device=dev)[None, :]
                     <= cur.long()[:, None])[:, None, None, :]
            bound, by = fd_rows_bound_ms(Hq, Hkv, hd,
                                         [c + 1 for c in depths],
                                         q.element_size())
            row = {"shape": tag, "depths": depths,
                   "ms": device_ms(lambda: flash_decode_partials(
                       q, k, v, cur, perm)),
                   "scalar_ms": device_ms(lambda: flash_decode_partials(
                       q, kg, vg, full)),
                   "plain_ms": device_ms(lambda: flash_decode_partials_ref(
                       q, k, v, cur, perm), calls=5, replays=5),
                   "library_ms": device_ms(
                       lambda: torch.nn.functional.scaled_dot_product_attention(
                           q[:, :, None, :], kg, vg, attn_mask=amask,
                           enable_gqa=True)),
                   "bound_ms": bound, "bound_by": by,
                   "max_abs_err": errs[0]}
            print(f"  {row['ms'] * 1e3} us per-row kernel, "
                  f"{row['scalar_ms'] * 1e3} us scalar form (cache full), "
                  f"{row['plain_ms'] * 1e3} us plain, "
                  f"{row['library_ms'] * 1e3} us SDPA (masked), bound "
                  f"{bound * 1e3} us ({by}), {bound / row['ms']:.4f} of "
                  f"the bound")
            rows.append(row)
            del q, k, v, kg, vg
            torch.cuda.empty_cache()
    return worst, rows


def check_wide_mask(dev):
    """Phase 15: the mask kernel on 8 rows wider than one block's shared
    memory (a cluster of blocks a row, each staging its share; past the
    widest such cluster, one reading device memory) torch.equal to the
    plain version under phase 5's settings, and their times."""
    import torch
    from repro_torch.kernels.sampling.ops import topk_topp_mask
    from repro_torch.kernels.sampling.ref import topk_topp_mask_ref

    gen = torch.Generator(device=dev).manual_seed(16)
    rows = []
    for V in MASK_WIDE:
        T = 8
        bound, by = mask_bound_ms(T, V)
        for setting in time_mask.SETTINGS:
            logits, ks, ps = time_mask.mask_inputs(setting, T, V, gen, dev)
            got = topk_topp_mask(logits, ks, ps)
            torch.cuda.synchronize()
            if not bool(torch.equal(got, topk_topp_mask_ref(logits, ks, ps))):
                fail(f"top-k/top-p mask at V={V} ({setting}): differs from "
                     f"the plain version")
            row = {"T": T, "V": V, "setting": setting,
                   "ms": device_ms(lambda: topk_topp_mask(logits, ks, ps)),
                   "plain_ms": device_ms(lambda: topk_topp_mask_ref(
                       logits, ks, ps), calls=5, replays=5),
                   "library_ms": device_ms(lambda: torch.sort(
                       logits, dim=-1, descending=True), calls=5, replays=5),
                   "bound_ms": bound, "bound_by": by}
            print(f"top-k/top-p mask T={T} V={V} {setting}: equal to the "
                  f"plain version; {row['ms'] * 1e3} us kernel, "
                  f"{row['plain_ms'] * 1e3} us plain, "
                  f"{row['library_ms'] * 1e3} us torch.sort, bound "
                  f"{bound * 1e3} us ({by})")
            rows.append(row)
    return rows


def serve_seeded_rwkv():
    """Phase 15: a seeded top-k/top-p serve of rwkv6-1.6b (vocab 65536, so
    every sampled row takes the mask's wide-row path) at full width
    and depth on phase 13's trace, counts zeroed before and read after the
    run; seeded tokens bit-identical at another slot count (phase 4's
    rule). Returns the mask's launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.sampling.ops import topk_topp_mask
    from repro_torch.kernels.rwkv6.ops import wkv6
    from repro_torch.launch.serve import parse_args, serve, verify
    from repro_torch.models import model as Mo
    from repro_torch.models.env import Env

    cfg = get_config("rwkv6-1.6b")
    params = Mo.init_params(cfg, Env(), seed=0, device="cuda")
    args = parse_args(["--arch", "rwkv6-1.6b", "--requests", "16",
                       "--prompt-len", "256", "--slots", "8", "--gen", "32",
                       "--rate", "16", "--block-size", "16", "--device",
                       "cuda", "--temperature", "0.8", "--top-k", "50",
                       "--top-p", "0.9", "--sample-seed", "7"])
    topk_topp_mask.launches = wkv6.launches = 0
    run = serve(args, cfg, params)
    n_mask, n_wkv = topk_topp_mask.launches, wkv6.launches
    if n_mask <= 0 or n_wkv != args.requests * cfg.n_layers:
        fail(f"seeded rwkv6 serve: mask launched {n_mask} times, wkv6 "
             f"{n_wkv}")
    check_tokens(run, cfg)
    ok, line = verify(args, cfg, params, run)
    if not ok:
        fail(f"seeded rwkv6 serve: {line}")
    print(f"{cfg.name} seeded serve (vocab {cfg.vocab_size}, temperature "
          f"0.8, top-k 50, top-p 0.9): {run['tokens']} tokens, "
          f"{run['wall_s']:.3f}s wall, "
          f"{run['tokens'] / run['wall_s']:.1f} tokens/s wall, mask "
          f"launches {n_mask}, wkv6 launches {n_wkv}; {line}")
    del params, run
    torch.cuda.empty_cache()
    return n_mask


def _timed(obj, name, acc):
    """Wrap obj.name to append the wall time of each call, the card
    synchronised before and after, to `acc`."""
    import torch
    fn = getattr(obj, name)

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        acc.append(time.perf_counter() - t0)
        return out

    setattr(obj, name, timed)


def swap_victim(cfg, params, kv, prompt_len, counted, label, mesh=None,
                gen=32, tokens=None):
    """An EDF-preemptive engine with one slot: a seeded (k 50 / p 0.9)
    deadline-free victim of `gen` tokens is preempted at t = 0.12 s by an
    urgent 4-token request (deadline 0.4 s), swapped out to the host tier
    and swapped back in. Its tokens must equal an unpreempted run's, with
    nothing recomputed and the bytes out equal to the bytes in. Over
    `mesh` (a DeviceMesh) both engines run per rank. Returns the launches
    of `counted` in the swap run; with tokens=[] the run's tokens are
    appended to it (the victim's, then the urgent request's)."""
    import numpy as np
    import torch
    from repro_torch.core.clock import ManualClock
    from repro_torch.serve import (EDFPolicy, Request, SamplingParams,
                                   ServingEngine, run_to_completion)

    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab_size, (2, prompt_len),
                           dtype=np.int32)
    sp = SamplingParams(temperature=0.8, top_k=50, top_p=0.9, seed=7)
    reqs = lambda: [
        Request(rid=0, prompt=prompts[0], gen_len=gen, sampling=sp),
        Request(rid=1, prompt=prompts[1], gen_len=4, arrival_t=0.12,
                deadline_s=0.4)]
    mk = lambda **kw: ServingEngine(
        cfg, params, num_slots=1, prompt_len=prompt_len, max_gen=gen, kv=kv,
        block_size=16, clock=ManualClock(), device="cuda", mesh=mesh, **kw)
    solo = run_to_completion(mk(), reqs()[:1], dt=0.05)
    for op in counted:
        op.launches = 0
    eng = mk(swap=True, policy=EDFPolicy(preemptive=True, min_slack_s=1.0))
    t_out, t_in = [], []
    _timed(eng.pool, "swap_out", t_out)
    _timed(eng.pool, "swap_in", t_in)
    t0 = time.perf_counter()
    out = run_to_completion(eng, reqs(), dt=0.05)
    wall = time.perf_counter() - t0
    launches = {op.__name__: op.launches for op in counted}
    m, pm = eng.metrics, eng.pool.metrics()
    if not (m.preemptions >= 1 and t_out and t_in):
        fail(f"{label}: the victim was never swapped out and back in")
    if out[0] != solo[0]:
        fail(f"{label}: the swap-resumed victim's tokens differ from an "
             f"unpreempted run's")
    if m.recomputed_tokens != 0 or not (
            pm["swap_out_bytes"] == pm["swap_in_bytes"] > 0):
        fail(f"{label}: recomputed {m.recomputed_tokens} tokens, swapped "
             f"{pm['swap_out_bytes']} bytes out and {pm['swap_in_bytes']} "
             "in")
    eng.pool.release()
    if tokens is not None:
        tokens += [out[0], out[1]]
    print(f"{label}: victim swapped out and resumed, tokens equal the "
          f"unpreempted run's, recomputed 0; {pm['swapped_blocks']:.0f} "
          f"blocks, {pm['swap_out_bytes']:.0f} bytes out = "
          f"{pm['swap_in_bytes']:.0f} in; swap-out {t_out[0] * 1e3:.3f} ms,"
          f" swap-in {t_in[0] * 1e3:.3f} ms wall on {card()}; serve "
          f"{wall:.3f}s wall; launches {launches}")
    return launches


def check_swap_tier(cfg, params, counted, victims=None):
    """Phase 16: the host swap tier at full width. The EDF victim on the
    bf16 and the int8 pools of paper-demo-110m; the autoscaled int8 fleet
    of phase 7 with --drain preempt --swap on (tokens equal one engine's,
    nothing recomputed, every pool released with its leak checks, the
    shared host pool empty); recurrentgemma-9b at full width and phase
    14's cut depth (5 layers, prompt 160: the flash branch), one swap of
    its ring blocks and state rows. Returns launches by kernel name;
    `victims` (a dict) gets paper-demo-110m's victims' tokens by pool
    (phase 30's oracle)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_trace, verify
    from repro_torch.models import model as Mo
    from repro_torch.models.env import Env

    launches = {}
    for kv in ("paged", "quant"):
        toks = []
        got = swap_victim(cfg, params, kv, 64, counted,
                          f"swap tier, {cfg.name} {kv} pool", tokens=toks)
        if victims is not None:
            victims[kv] = toks
        for n, c in got.items():
            launches[n] = launches.get(n, 0) + c
    fargs = serve_args(["--trace", "burst", "--kv", "quant", "--replicas",
                        "2", "--max-nodes", "4", "--drain", "preempt",
                        "--swap", "on"])
    for op in counted:
        op.launches = 0
    frun = run_trace(fargs, cfg, params)
    n_quant = sum(op.launches for op in counted
                  if op.__name__ == "paged_flash_decode_quant")
    check_tokens(frun, cfg)
    snap, fleet = frun["snapshot"], frun["engine"]
    if not fleet.released:
        fail("swap fleet: no replica was drained and released")
    if snap["recomputed_tokens"] != 0 or snap.get(
            "swap_out_bytes", 0.0) != snap.get("swap_in_bytes", 0.0):
        fail(f"swap fleet: recomputed {snap['recomputed_tokens']} tokens, "
             f"{snap.get('swap_out_bytes')} bytes out, "
             f"{snap.get('swap_in_bytes')} in")
    host = fleet.replicas[0].pool.swap_pool
    if host is None or host.blocks_resident:
        fail("swap fleet: requests left on the host tier")
    ok, line = verify(fargs, cfg, params, frun)
    if not ok:
        fail(f"swap fleet: {line}")
    for r in list(fleet.replicas):
        r.release()  # the last detach leak-checks the shared host pool
    print(f"swap fleet (--drain preempt --swap on): timeline "
          f"{frun['sizes']}, released {fleet.released} (leak-checked), "
          f"preemptions {snap['preemptions']:.0f}, "
          f"{snap.get('swapped_blocks', 0.0):.0f} blocks and "
          f"{snap.get('swap_out_bytes', 0.0):.0f} bytes swapped out and "
          f"back, recomputed 0, quant decode launches {n_quant}; {line}")
    launches["paged_flash_decode_quant"] += n_quant
    cut = dataclasses.replace(get_config("recurrentgemma-9b"), n_layers=5)
    rparams = Mo.init_params(cut, Env(), seed=1, device="cuda")
    got = swap_victim(cut, rparams, "paged", 160, counted,
                      f"swap tier, {cut.name} at 5 layers (rings, state "
                      "rows)")
    for n, c in got.items():
        launches[n] = launches.get(n, 0) + c
    if not (got["rglru_scan"] and got["flash_attention"]
            and got["paged_flash_decode"]):
        fail(f"recurrent swap: launches {got}")
    del rparams
    torch.cuda.empty_cache()
    return launches


def check_spec(cfg, params, counted, tokens=None):
    """Phase 17: speculative decoding at full width. n-gram and model
    drafters at spec_k 4 and auto, greedy and seeded (k 50 / p 0.9), on
    the paged, int8 and slot pools, over SPEC_TRACE (8 requests, prompt
    64, gen 16, 8 slots): every run's tokens bit-identical to
    --spec off on the same pool, launches read between the run and its
    verify, and n-gram k 4 at 4 slots equal to them. Then wall tokens/s
    of n-gram k 4 and of the model drafter against --spec off on the
    paged pool, three runs each. Returns the launches by kernel name;
    `tokens` (a dict) gets each k-4 run's tokens by (pool, drafter,
    seeded) (phase 30's oracle)."""
    import statistics
    from repro_torch.launch.serve import serve, verify

    base = list(SPEC_TRACE)
    seeded = ["--temperature", "0.8", "--top-k", "50", "--top-p", "0.9",
              "--sample-seed", "7"]
    launches = {}
    for kv in ("paged", "quant", "slot"):
        for samp in ([], seeded):
            outs = []
            for drafter in ("ngram", "model"):
                for k in ("4", "auto"):
                    args = serve_args(base + ["--kv", kv, "--spec", drafter,
                                              "--spec-k", k] + samp)
                    for op in counted:
                        op.launches = 0
                    run = serve(args, cfg, params)
                    got = {op.__name__: op.launches for op in counted}
                    check_tokens(run, cfg)
                    dec = ("paged_flash_decode_quant" if kv == "quant"
                           else "paged_flash_decode")
                    if got[dec] <= 0 or (got["topk_topp_mask"] > 0) != \
                            bool(samp):
                        fail(f"spec {drafter} k={k} {kv} "
                             f"{'seeded' if samp else 'greedy'}: launches "
                             f"{got}")
                    for n, c in got.items():
                        launches[n] = launches.get(n, 0) + c
                    ok, line = verify(args, cfg, params, run)
                    if not ok:
                        fail(f"spec {drafter} k={k} {kv}: {line}")
                    outs.append(run["out"])
                    if tokens is not None and k == "4":
                        tokens[(kv, drafter, bool(samp))] = run["out"]
                    snap = run["engine"].snapshot()
                    print(f"spec {drafter} k={k} {kv} "
                          f"{'seeded' if samp else 'greedy'}: accepted/step "
                          f"{snap['accepted_per_step']:.3f}, acceptance "
                          f"{snap['spec_acceptance_rate']:.3f}, "
                          f"{run['steps']} steps, "
                          f"{run['tokens'] / run['wall_s']:.1f} tokens/s "
                          f"wall; launches {got}; {line}")
            # a row's output does not depend on the batch around it: the
            # n-gram run at 4 slots emits the 8-slot runs' tokens
            run4 = serve(serve_args(base + ["--kv", kv, "--spec", "ngram",
                                            "--slots", "4"] + samp),
                         cfg, params)
            if any(o != run4["out"] for o in outs):
                fail(f"spec ngram {kv}: 4 slots differ from 8")
            print(f"spec ngram k=4 {kv} {'seeded' if samp else 'greedy'} "
                  "at 4 slots: the tokens of the 8-slot runs, bit for bit")
    rates = {}
    for name, extra in (("off", []), ("ngram k=4", ["--spec", "ngram"]),
                        ("model k=4", ["--spec", "model"])):
        args = serve_args(base + extra)
        rates[name] = []
        for _ in range(3):
            run = serve(args, cfg, params)
            rates[name].append(run["tokens"] / run["wall_s"])
        r = rates[name]
        print(f"wall tokens/s, paged greedy, {name}: {r} (mean "
              f"{statistics.mean(r):.1f}, spread {max(r) - min(r):.1f}); "
              f"{run['steps']} steps on {card()}")
    return launches


def zoo_args(arch, extra):
    """The zoo phases' serve: serve_args's (prompt 64, gen 32, 8 slots,
    block 16, prefix cache on, greedy, chunked lanes) at 8 requests."""
    return serve_args(["--arch", arch, "--requests", "8"] + extra)


def zoo_serve(cfg, params, args, counted, label, want, verify_run=True):
    """Serve args's trace with the counts zeroed before the run and read
    after it (before its verify, whose engines launch kernels too); fail
    unless each kernel named in `want` launched (True) or did not (False)
    and, with verify_run, unless the run passes its --verify. Returns
    (run, launches by kernel name)."""
    from repro_torch.launch.serve import serve, verify
    for op in counted:
        op.launches = 0
    run = serve(args, cfg, params)
    got = {op.__name__: op.launches for op in counted}
    for name, on in want.items():
        if (got[name] > 0) != on:
            fail(f"{label}: {name} launched {got[name]} times")
    check_tokens(run, cfg)
    if run["engine"].metrics.preemptions:
        fail(f"{label}: the serve preempted at the worst-case budget")
    line = ""
    if verify_run:
        t0 = time.perf_counter()
        ok, line = verify(args, cfg, params, run)
        if not ok:
            fail(f"{label}: {line}")
        line = f"; {line} ({time.perf_counter() - t0:.1f}s)"
    print(f"{label}: {run['tokens']} tokens in {run['steps']} decode steps, "
          f"{run['wall_s']:.3f}s wall, "
          f"{run['tokens'] / run['wall_s']:.1f} tokens/s wall on {card()}; "
          f"launches {got}{line}")
    return run, got


def _add(acc, got):
    for n, c in got.items():
        acc[n] = acc.get(n, 0) + c


def load_params(cfg, seed, device="cuda"):
    """cfg's seeded weights on the card, with their size and draw time."""
    import torch
    from repro_torch.models import model as Mo
    from repro_torch.models.env import Env
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = Mo.init_params(cfg, Env(), seed=seed, device=device)
    torch.cuda.synchronize()
    n_par = sum(x.numel() for x in _leaves(params))
    n_bytes = sum(x.numel() * x.element_size() for x in _leaves(params))
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads} (GQA "
          f"{cfg.n_heads // max(cfg.n_kv_heads, 1)}), vocab "
          f"{cfg.vocab_size}, "
          f"{n_par / 1e9:.2f} B parameters, {n_bytes / 1e9:.1f} GB on the "
          f"card (peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB "
          f"while drawn, {time.perf_counter() - t0:.1f}s)")
    return params


def check_zoo_dense(counted):
    """Phase 18: the four dense attention archs at full width and depth
    (random seeded weights). Each serves 8 Poisson requests (prompt 64,
    gen 32, 8 slots, chunked lanes, greedy) with the launches of #1
    counted, every token equal to the streamed-prefill one-shot baseline;
    qwen2-1.5b also seeded (k 50 / p 0.9) at 8 and 4 slots (#2's cluster
    form at 151,936 logits), granite-3-8b on the int8 pool at 8 and 4
    slots (#3 at GQA 4), yi-9b by classic admission at prompt 256 (#4 at
    hd 128, 8 x 48 launches) against the full-prefill one-shot, and 16
    steps of qwen3-32b profiled (phase 6's method). Then qwen3-32b
    (qk-norm) and granite-3-8b (odd vocabulary) at 2 layers: card vs CPU
    prefill logits (phase 14's method). Returns launches by name."""
    import torch
    from repro_torch.configs import get_config

    launches = {}
    for arch in ZOO_DENSE:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if arch in ZOO_DEPTH:
            cfg = dataclasses.replace(cfg, n_layers=ZOO_DEPTH[arch])
        params = load_params(cfg, 0)
        args = zoo_args(arch, [])
        got = zoo_serve(cfg, params, args, counted,
                           f"{arch} greedy serve (chunked lanes)",
                           {"paged_flash_decode": True,
                            "paged_flash_decode_quant": False,
                            "topk_topp_mask": False})[1]
        _add(launches, got)
        if arch == "qwen2-1.5b":
            sargs = zoo_args(arch, ["--temperature", "0.8", "--top-k", "50",
                                    "--top-p", "0.9", "--sample-seed", "7"])
            got = zoo_serve(cfg, params, sargs, counted,
                               f"{arch} seeded serve (k 50, p 0.9, vocab "
                               f"{cfg.vocab_size})",
                               {"topk_topp_mask": True,
                                "paged_flash_decode": True})[1]
            _add(launches, got)
        if arch == "granite-3-8b":
            got = zoo_serve(cfg, params, zoo_args(arch, ["--kv", "quant"]),
                               counted, f"{arch} --kv quant serve",
                               {"paged_flash_decode_quant": True,
                                "paged_flash_decode": False})[1]
            _add(launches, got)
        if arch == "yi-9b":
            cargs = zoo_args(arch, ["--prefill-chunk", "0", "--prompt-len",
                                    "256"])
            got = zoo_serve(cfg, params, cargs, counted,
                               f"{arch} classic serve (prompt 256)",
                               {"paged_flash_decode": True})[1]
            want = cargs.requests * cfg.n_layers
            if got["flash_attention"] != want:
                fail(f"{arch} classic serve: flash attention launched "
                     f"{got['flash_attention']} times, expected {want}")
            _add(launches, got)
        if arch == "qwen3-32b":
            profile_steps(args, cfg, params, n_steps=16, warm=4)
        print(f"{arch}: peak {torch.cuda.max_memory_allocated() / 2 ** 30:.1f}"
              f" GiB, {time.perf_counter() - t0:.1f}s")
        del params
        gc.collect()
        torch.cuda.empty_cache()
    for arch in ("qwen3-32b", "granite-3-8b"):
        cut = dataclasses.replace(get_config(arch), n_layers=2)
        cparams = load_params(cut, 1)
        check_prefill_against_cpu(cut, cparams, 128)
        del cparams
        torch.cuda.empty_cache()
    return launches


def check_moe_layer(cfg, p, x):
    """One MoE layer on a served step's input x [T,1,d] (layer 0's
    weights p), card vs the port's plain CPU path: the expert assignment
    and the kept set equal (a token routed otherwise only at a router
    near-tie: its k-th and (k+1)-th gates within twice the router noise,
    as in check_prefill_against_cpu), the outputs of the tokens routed
    alike within MOE_RMS_TOL; the layer's device time beside its bound."""
    import torch
    from repro_torch.models import moe as M

    E, k = cfg.moe.num_experts, cfg.moe.top_k
    n, d = x.shape[0] * x.shape[1], x.shape[-1]
    pc = {name: w.cpu() for name, w in p.items()}
    routes = {"card": [], "cpu": []}
    ys, stats = {}, {}
    for name, pp, xx in (("card", p, x), ("cpu", pc, x.cpu())):
        undo = route_capture(routes[name])
        try:
            with M.dispatch_stats() as stats[name]:
                ys[name] = M.moe_layer(pp, xx, cfg)[0].float().cpu()
        finally:
            undo()
    st = stats["card"]
    moved, affected, margins, noise = routing_moves(routes["card"],
                                                    routes["cpu"], k)
    if any(m > 2 * noise for m in margins):
        fail(f"{cfg.name} MoE layer: tokens routed otherwise on the card "
             f"away from a near-tie: margins {margins}, router noise "
             f"{noise:.3e}")
    diff = (ys["card"] - ys["cpu"]).reshape(n, d)[~affected]
    ref = ys["cpu"].reshape(n, d)[~affected]
    rms = float(diff.norm() / ref.norm().clamp_min(1e-30))
    if not math.isfinite(rms) or rms > MOE_RMS_TOL:
        fail(f"{cfg.name} MoE layer: card vs CPU relative RMS {rms}")
    kept = routes["card"][0][2]
    used, cap = int(kept.any(0).sum()), st[0]["capacity"]
    w_bytes = used * 3 * d * cfg.d_ff * 2
    t_bytes = w_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = int(kept.sum()) * 3 * 2 * d * cfg.d_ff / BF16_FLOPS * 1e3
    bound, by = max((t_bytes, "bytes"), (t_ops, "operations"))
    ms = device_ms(lambda: M.moe_layer(p, x, cfg), calls=5, replays=5)
    print(f"{cfg.name} MoE layer on a served step's {n} rows: capacity "
          f"{cap}, {st[0]['dropped']} of {n * k} assignments dropped, {used} "
          f"of {E} experts used; card vs CPU: {int(moved.sum())} tokens "
          f"routed otherwise (gate margins {margins}, router noise "
          f"{noise:.3e}), {int(affected.sum())} with another expert or "
          f"kept set; output relative RMS {rms:.3e}, max abs err "
          f"{float(diff.abs().max()):.3e} (tolerance {MOE_RMS_TOL}); "
          f"{ms * 1e3:.1f} us of device time a call (CUDA graph), bound "
          f"{bound * 1e3:.1f} us ({by}: {w_bytes / 1e9:.2f} GB of routed "
          f"expert weights), {bound / ms:.3f} of the bound")


def check_zoo_moe(counted):
    """Phase 19: the two MoE archs at full width and cut depth
    (ZOO_MOE). Each serves 8 Poisson requests (prompt 64, gen 32, 8 slots,
    chunked lanes, greedy): the run completes with #1 launched (GQA 6,
    GQA 5), a second run of the trace emits bit-identical tokens, and the
    tokens dispatched, the capacity and the tokens dropped are printed per
    layer. One MoE layer on the first 72-row step's input, card vs CPU
    (check_moe_layer); card vs CPU prefill logits at 1 layer; llama4-scout
    on the int8 pool (#3 at GQA 5). No token is held to a one-shot
    baseline: MoE capacity depends on the tokens one dispatch holds, and
    the JAX package's own engine does not equal its baseline there.
    Returns launches by name."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M

    launches = {}
    for arch, depth in ZOO_MOE:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=depth)
        print(f"{arch} at full width, {depth} of "
              f"{get_config(arch).n_layers} layers")
        params = load_params(cfg, 0)
        args = zoo_args(arch, [])
        captured = []
        layer = M.moe_layer

        def capture(p, x, c, env=None):
            if not captured and x.shape[0] * x.shape[1] == 72:
                captured.append(x.detach().clone())
            return layer(p, x, c, env)

        M.moe_layer = capture
        try:
            with M.dispatch_stats() as st:
                run, got = zoo_serve(cfg, params, args, counted,
                                     f"{arch} greedy serve (chunked lanes)",
                                     {"paged_flash_decode": True,
                                      "paged_flash_decode_quant": False},
                                     verify_run=False)
        finally:
            M.moe_layer = layer
        _add(launches, got)
        for i in range(depth):
            recs = st[i::depth]
            n_tok = sum(r["tokens"] for r in recs)
            print(f"  layer {i}: {len(recs)} dispatches, {n_tok} tokens "
                  f"dispatched ({n_tok * cfg.moe.top_k} assignments), "
                  f"capacities {sorted({r['capacity'] for r in recs})}, "
                  f"{sum(r['dropped'] for r in recs)} assignments dropped")
        again, got = zoo_serve(cfg, params, args, counted,
                               f"{arch} greedy serve, the same trace again",
                               {"paged_flash_decode": True},
                               verify_run=False)
        _add(launches, got)
        if again["out"] != run["out"]:
            bad = sum(again["out"][r] != run["out"][r] for r in run["out"])
            fail(f"{arch}: a second run of the trace differs in {bad} "
                 "requests")
        print(f"{arch}: the second run's tokens equal the first's, bit for "
              "bit")
        if not captured:
            fail(f"{arch}: no step dispatched 72 rows")
        check_moe_layer(cfg, {n: w[0] for n, w in
                              params["blocks"][0]["moe"].items()},
                        captured[0])
        if arch.startswith("llama4"):
            got = zoo_serve(cfg, params, zoo_args(arch, ["--kv", "quant"]),
                               counted, f"{arch} --kv quant serve",
                               {"paged_flash_decode_quant": True,
                                "paged_flash_decode": False},
                               verify_run=False)[1]
            _add(launches, got)
        print(f"{arch}: peak {torch.cuda.max_memory_allocated() / 2 ** 30:.1f}"
              f" GiB, {time.perf_counter() - t0:.1f}s")
        del params, run, again, captured
        gc.collect()
        torch.cuda.empty_cache()
        cut = dataclasses.replace(cfg, n_layers=1)
        cparams = load_params(cut, 1)
        check_prefill_against_cpu(cut, cparams, 128, card_spread=True)
        del cparams
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phases 20 and 21: train mode, AdamW and the rollout loop
# ---------------------------------------------------------------------------

# phase 20's configs: (arch, layers (None: the config's own), B, S, steps,
# optimizer state); lr 1e-3, no warmup, no weight decay
TRAIN_CELLS = (("paper-demo", None, 8, 128, 20, "fp32"),
               ("rwkv6-1.6b", None, 4, 128, 5, "fp32"),
               ("recurrentgemma-9b", 5, 2, 128, 3, "fp32"),
               ("llama4-scout-17b-a16e", 1, 2, 128, 3, "int8"))


def train_env():
    """The training plan (the JAX package's default_plan for a train
    shape on one device): each pattern unit recomputed in the backward,
    xla_chunked attention (attention_naive at S <= attn_q_chunk)."""
    from repro_torch.configs.base import ParallelPlan
    from repro_torch.models.env import Env
    return Env(plan=ParallelPlan(fsdp=False, remat="nothing",
                                 attn_impl="xla_chunked",
                                 kv_cache="replicated"))


def train_batch(cfg, B, S, device):
    """A fixed seeded batch of next-token pairs: labels are the tokens
    shifted by one (the last label wraps)."""
    import torch
    tok = torch.randint(0, cfg.vocab_size, (B, S),
                        generator=torch.Generator().manual_seed(11))
    return {"tokens": tok.to(device),
            "labels": torch.roll(tok, -1, dims=1).to(device)}


def _launch_counts(counted):
    return {op.__name__: op.launches for op in counted}


def check_train_against_cpu(cfg, params, dev):
    """Loss and per-leaf gradient norms of one train-mode step (B=8,
    S=128) on the card against the CPU path on the same weights and
    batch, |diff| / |cpu|. As phase 14 takes its tolerance: the spread of
    the CPU path against itself with every product accumulated in f64
    (each still rounded once to bf16), and of the card against itself
    with its products taken in f32; the card may differ from the CPU by
    at most twice the larger spread, in the worst leaf and on average."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import model as Mo
    from repro_torch.optim.adamw import tree_leaves, tree_map, value_and_grad

    t0 = time.perf_counter()
    env = train_env()
    batch = train_batch(cfg, 8, 128, "cpu")

    def run(p, dev):
        b = {k: v.to(dev) for k, v in batch.items()}
        (loss, _), g = value_and_grad(
            lambda q: Mo.lm_loss(q, b, cfg, env), p)
        # in f64: an f32 norm of the 24.6 M-entry (un)embedding's gradient
        # sums with ~1e-3 of error on the CPU
        norms = torch.stack([x.double().norm() for x in tree_leaves(g)])
        return torch.cat([loss.double()[None], norms]).cpu()

    card = run(params, dev)
    cparams = tree_map(lambda x: x.cpu(), params)
    ref = run(cparams, "cpu")
    bmm = L._bf16_matmul
    try:
        L._bf16_matmul = lambda a, b: (a.double() @ b.double()).float().to(
            a.dtype)
        alt = run(cparams, "cpu")
        L._bf16_matmul = lambda a, b: (a.float() @ b.float()).to(a.dtype)
        card32 = run(params, dev)
    finally:
        L._bf16_matmul = bmm
    rel = lambda a, b: (a - b).abs() / b.abs().clamp_min(1e-30)
    err, s_cpu, s_card = rel(card, ref), rel(alt, ref), rel(card32, card)
    spread_max = max(float(s_cpu.max()), float(s_card.max()))
    spread_mean = max(float(s_cpu.mean()), float(s_card.mean()))
    names = ["loss"] + _leaf_names(params)
    for i in torch.argsort(err, descending=True)[:4].tolist():
        print(f"  {names[i]}: card vs CPU {float(err[i]):.3e}, CPU f64 "
              f"{float(s_cpu[i]):.3e}, card f32 {float(s_card[i]):.3e}")
    print(f"{cfg.name} ({cfg.n_layers} layers) train step (B=8, S=128) on "
          f"the card vs the CPU path, loss and {len(err) - 1} gradient-leaf "
          f"norms: relative err max {float(err.max()):.3e}, mean "
          f"{float(err.mean()):.3e} (loss {float(err[0]):.3e}); the CPU "
          f"with f64-accumulated products: max {float(s_cpu.max()):.3e}, "
          f"mean {float(s_cpu.mean()):.3e}; the card with f32 products: max "
          f"{float(s_card.max()):.3e}, mean {float(s_card.mean()):.3e}; "
          f"losses {float(card[0]):.6f} (card) {float(ref[0]):.6f} (CPU); "
          f"{time.perf_counter() - t0:.1f}s")
    if not (math.isfinite(float(err.max()))
            and float(err.max()) <= 2 * spread_max
            and float(err.mean()) <= 2 * spread_mean):
        fail("train step card vs CPU: the loss or a gradient norm differs "
             "by more than twice the spread of a reordered computation")


def _leaf_names(tree, path=""):
    """Leaf paths of a params tree in optim.adamw.tree_leaves' order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{path}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{path}/{i}")]
    return [path]


def check_train(counted, dev):
    """Phase 20: train mode, AdamW and make_train_step at full width
    (TRAIN_CELLS): each config's loss per step falling, its first-step
    gradients finite and nonzero in every leaf, none of the seven kernels
    launched during the steps, step wall time and peak memory printed;
    then paper-demo at 2 layers, card vs CPU (check_train_against_cpu)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as Mo
    from repro_torch.optim.adamw import (AdamWConfig, make_train_state,
                                         tree_leaves, value_and_grad)

    env = train_env()
    for arch, layers, B, S, steps, sd in TRAIN_CELLS:
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        params = load_params(cfg, seed=0, device=dev)
        batch = train_batch(cfg, B, S, dev)
        torch.cuda.reset_peak_memory_stats()
        before = _launch_counts(counted)
        (loss0, _), grads = value_and_grad(
            lambda p: Mo.lm_loss(p, batch, cfg, env), params)
        leaves = tree_leaves(grads)
        amax = torch.stack([g.float().abs().amax() for g in leaves]).cpu()
        finite = torch.stack([torch.isfinite(g).all() for g in leaves]).cpu()
        if not bool(finite.all()) or not bool((amax > 0).all()):
            fail(f"{arch} train: {int((~finite).sum())} gradient leaves "
                 f"not finite, {int((amax == 0).sum())} all zero, of "
                 f"{len(leaves)}")
        del grads, leaves
        opt = AdamWConfig(lr=1e-3, warmup_steps=0, weight_decay=0.0,
                          state_dtype=sd)
        step = make_train_step(cfg, env, opt)
        state = make_train_state(params, opt)
        del params
        losses, times = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))  # ends in a host transfer
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 1e9
        launched = {n: c - before[n] for n, c in
                    _launch_counts(counted).items() if c != before[n]}
        print(f"{arch} train ({cfg.n_layers} layers, B={B} S={S}, {sd} "
              f"AdamW states, lr 1e-3): loss "
              f"{' '.join(f'{x:.4f}' for x in losses)}; first-step "
              f"gradients finite and nonzero in all {len(amax)} leaves "
              f"(loss {float(loss0):.4f}); step wall {times[0]:.3f}s "
              f"first, {sum(times[1:]) / max(len(times) - 1, 1):.3f}s "
              f"mean after; peak {peak:.1f} GB on {card()}; kernel "
              f"launches {launched or 'none'}")
        if not losses[-1] < losses[0] or not all(map(math.isfinite, losses)):
            fail(f"{arch} train: the loss did not fall: {losses}")
        if launched:
            fail(f"{arch} train: train mode launched {launched}")
        del state, batch
        gc.collect()
        torch.cuda.empty_cache()
    cut = dataclasses.replace(get_config("paper-demo"), n_layers=2)
    cparams = load_params(cut, seed=1, device=dev)
    check_train_against_cpu(cut, cparams, dev)
    del cparams
    torch.cuda.empty_cache()


def rollout_args(extra, dev):
    """Phase 21's rollout CLI: paper-demo at full width and depth, 4
    prompts x 4 samples, prompt 64, gen 32, temperature 0.7, top-k 50,
    top-p 0.9, 2 replicas x 4 slots (verified against 1 replica x 2),
    block 16, 2 rounds of 4 DPO steps, --verify, on the card."""
    from repro_torch.launch.rollout import parse_args
    return parse_args(["--arch", "paper-demo", "--verify", "--prompt-len",
                       "64", "--gen", "32", "--temperature", "0.7",
                       "--top-k", "50", "--top-p", "0.9", "--block-size",
                       "16", "--rounds", "2", "--train-steps", "4",
                       "--device", str(dev)] + extra)


def check_rollout(counted, dev):
    """Phase 21: the rollout loop at full width, ROLLOUT_LAYERS deep
    (rollout_args),
    then one round with --kv quant. Counts zeroed before each loop and
    read after it, before its verify (the verify's engines launch the
    kernels too); the DPO steps' own launches counted apart (none
    allowed). Checks: the fleet's rollouts bit-identical to one engine's
    at another slot count, the first DPO loss log 2 within 1e-4 and the
    loss falling, every later round different from the round before on
    the same seeds and equal to a fresh engine on the weights swapped in,
    the paged-decode (#1) and mask (#2) kernels launched by the bf16
    loop, the int8 one (#3) and #2 by the quant round. Returns launches
    by kernel name."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import rollout as cli
    from repro_torch.rollout import preference

    cfg = dataclasses.replace(get_config("paper-demo"),
                              n_layers=ROLLOUT_LAYERS)
    params = load_params(cfg, seed=0, device=dev)
    dpo_launches = {}
    step = preference.PreferenceTrainer.step

    def counted_step(self, batch):
        before = _launch_counts(counted)
        out = step(self, batch)
        _add(dpo_launches, {n: c - before[n] for n, c in
                            _launch_counts(counted).items()
                            if c != before[n]})
        return out

    totals = {}
    preference.PreferenceTrainer.step = counted_step
    try:
        for extra, rounds, want in (([], 2, ("paged_flash_decode",
                                             "topk_topp_mask")),
                                    (["--kv", "quant", "--rounds", "1"], 1,
                                     ("paged_flash_decode_quant",
                                      "topk_topp_mask"))):
            args = rollout_args(extra, dev)
            prompts = cli.prompts_of(args, cfg)
            for op in counted:
                op.launches = 0
            res = cli.run_loop(args, cfg, params, prompts)
            got = {n: c for n, c in _launch_counts(counted).items() if c}
            _add(totals, got)
            t0 = time.perf_counter()
            ok, line = cli.verify_fleet(args, cfg, params, prompts)
            ok2, lines = cli.verify_rounds(args, cfg, prompts, res)
            print("\n".join([line] + lines))
            times = res["times"]
            gen_s = sum(times["generate"])
            print(f"rollout loop ({args.kv} KV, {rounds} rounds x "
                  f"{args.prompts * args.n_samples} rollouts): "
                  f"{res['tokens']:.0f} rollout tokens in {gen_s:.3f}s of "
                  f"generation ({res['tokens'] / gen_s:.1f} tokens/s wall), "
                  f"DPO step {1e3 * sum(times['dpo_step']) / len(times['dpo_step']):.1f}"
                  f" ms (mean of {len(times['dpo_step'])}), set_params "
                  f"{1e3 * sum(times['set_params']) / max(len(times['set_params']), 1):.3f}"
                  f" ms (mean of {len(times['set_params'])}); one run each, "
                  f"no spread (PERF.md §7); on {card()}; launches {got}; "
                  f"verify {time.perf_counter() - t0:.1f}s")
            if not (ok and ok2):
                fail(f"rollout loop ({args.kv} KV): verify failed")
            if any(got.get(n, 0) <= 0 for n in want):
                fail(f"rollout loop ({args.kv} KV): launches {got}, "
                     f"expected {want}")
            if args.kv == "quant" and got.get("paged_flash_decode", 0):
                fail("the quant rollout launched the bf16 paged decode")
            del res
    finally:
        preference.PreferenceTrainer.step = step
    if dpo_launches:
        fail(f"the DPO steps (train mode) launched {dpo_launches}")
    print(f"DPO steps launched none of the seven kernels; rollout "
          f"launches {totals}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return totals


# the int8 pool of the recurrent archs (phase 22): each arch served with
# --kv quant at full width and depth, on one engine and on two replicas.
# recurrentgemma-9b's prompts of 2100 tokens fill its 2048-token rings
# (the prefill rolls them) and its decode writes past the wrap
QUANT_RECURRENT = (
    ("recurrentgemma-9b", ["--requests", "4", "--prompt-len", "2100",
                           "--gen", "16", "--slots", "4"]),
    ("rwkv6-1.6b", ["--requests", "8", "--prompt-len", "256", "--gen", "16",
                    "--slots", "8"]))
# the modality archs (phase 23) through --trace oneshot at full width and
# depth: whisper's 512-token prompts give its encoder 256 frames (the
# flash branch, non-causal)
MODALITY = (("qwen2-vl-7b", ["--requests", "4", "--prompt-len", "128",
                             "--gen", "32"]),
            ("whisper-small", ["--requests", "8", "--prompt-len", "512",
                               "--gen", "32"]))


def paged_case(label, pin, quant=None):
    """Check one paged-decode call against its plain version (PAGED_TOL)
    and time it beside the plain version and SDPA over the gathered KV
    (dequantized beforehand for the int8 pool), with its bound. pin: (q,
    k_pool, v_pool, tables, lengths) bf16; quant: (k int8, v int8,
    k_scale, v_scale), which makes it kernel #3's call."""
    import torch
    from repro_torch.kernels.paged_decode.ops import (
        paged_flash_decode, paged_flash_decode_quant)
    from repro_torch.kernels.paged_decode.ref import (paged_decode_quant_ref,
                                                      paged_decode_ref)
    q, kp, vp, tables, lengths = pin
    B, Hq, hd = q.shape
    MB, bs, Hkv = tables.shape[1], kp.shape[2], kp.shape[1]
    if quant is None:
        call = lambda: paged_flash_decode(q, kp, vp, tables, lengths)
        plain = lambda: paged_decode_ref(q, kp, vp, tables, lengths)
        kd, vd, token_bytes, pool = kp, vp, 2 * 2 * hd, kp
    else:
        kq, vq, ks, vs = quant
        call = lambda: paged_flash_decode_quant(q, kq, vq, ks, vs, tables,
                                                lengths)
        plain = lambda: paged_decode_quant_ref(q, kq, vq, ks, vs, tables,
                                               lengths)
        deq = lambda x, sc: (x.float() * sc[..., None]).to(torch.bfloat16)
        kd, vd, token_bytes, pool = deq(kq, ks), deq(vq, vs), 2 * (hd + 4), kq
    err = float((call() - plain()).abs().max())
    if not math.isfinite(err) or err > PAGED_TOL:
        fail(f"{label}: kernel vs plain max abs err {err}")
    g = Hq // Hkv
    gather = lambda x: x[tables.long()].transpose(1, 2).reshape(
        B, Hkv, MB * bs, hd).repeat_interleave(g, dim=1)
    kg, vg = gather(kd), gather(vd)
    amask = (torch.arange(MB * bs, device=q.device)[None, :]
             <= lengths.clamp_min(0).long()[:, None])[:, None, None, :]
    bound, by = paged_bound_ms(q, pool, tables, lengths, token_bytes)
    row = {"shape": {"B": B, "Hq": Hq, "Hkv": Hkv, "hd": hd, "bs": bs,
                     "MB": MB}, "max_abs_err": err,
           "ms": device_ms(call), "plain_ms": device_ms(plain),
           "bound_ms": bound, "bound_by": by,
           "library_ms": device_ms(
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   q[:, :, None, :], kg, vg, attn_mask=amask))}
    print(f"{label}: kernel vs plain max abs err {err:.3e} (tolerance "
          f"{PAGED_TOL}); {row['ms'] * 1e3} us kernel, "
          f"{row['plain_ms'] * 1e3} us plain, {row['library_ms'] * 1e3} us "
          f"SDPA, bound {bound * 1e3} us ({by}), "
          f"{bound / row['ms']:.4f} of the bound")
    return row


def flash_case(label, gen, dev, B, S, Hq, Hkv, hd, causal):
    """Check one flash-attention call against its plain version
    (FLASH_TOL on the bf16 output) and time it beside the plain version
    and SDPA, with its bound."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    fin = flash_inputs(gen, dev, B, S, Hq, Hkv, hd)
    call = lambda: flash_attention(*fin, causal=causal, n_kv_heads=Hkv)
    err = float((call().float() - flash_plain(*fin, causal).float())
                .abs().max())
    if not math.isfinite(err) or err > FLASH_TOL:
        fail(f"{label}: kernel vs plain max abs err {err}")
    bound, by = flash_bound_ms(B, S, Hq, Hkv, hd, causal)
    row = {"shape": {"B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "hd": hd,
                     "causal": causal}, "max_abs_err": err,
           "ms": device_ms(call, calls=5, replays=5),
           "plain_ms": device_ms(lambda: flash_plain(*fin, causal), calls=2,
                                 replays=3),
           "bound_ms": bound, "bound_by": by,
           "library_ms": device_ms(
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   *(t.transpose(1, 2) for t in fin), is_causal=causal,
                   enable_gqa=True), calls=5, replays=5)}
    print(f"{label}: kernel vs plain max abs err {err:.3e} (tolerance "
          f"{FLASH_TOL}); {row['ms'] * 1e3} us kernel, "
          f"{row['plain_ms'] * 1e3} us plain, {row['library_ms'] * 1e3} us "
          f"SDPA, bound {bound * 1e3} us ({by}), "
          f"{bound / row['ms']:.4f} of the bound")
    return row


def quant_ring_inputs(gen, dev):
    """One decode step of recurrentgemma-9b's local layer over the int8
    pool's window rings (MQA 16:1, hd 256, 8 slots of 128 blocks of 16):
    four full rings (a row at or past the wrap attends at depth
    min(cur_len, 2047) = 2047), a part-filled and a short one, a depth-0
    and a masked row. Returns the bf16 (q, pools, tables, lengths) and the
    int8 pools with their scales."""
    import torch
    from repro_torch.kernels.paged_decode.ops import quantize_kv
    Hq, Hkv, hd, bs, MB = 16, 1, 256, 16, 128
    lens = [2047] * 4 + [1500, 17, 0, -1]  # 2047: at or past the wrap
    B, NB = len(lens), 1 + 8 * MB
    q = torch.randn((B, Hq, hd), generator=gen, device=dev).to(torch.bfloat16)
    kf = torch.randn((NB, Hkv, bs, hd), generator=gen, device=dev)
    vf = torch.randn((NB, Hkv, bs, hd), generator=gen, device=dev)
    kq, ks = quantize_kv(kf)
    vq, vs = quantize_kv(vf)
    perm = torch.randperm(NB - 1, generator=gen, device=dev) + 1
    tables = torch.zeros((B, MB), dtype=torch.int32, device=dev)
    for b, n in enumerate(lens):
        if n >= 0:
            tables[b] = perm[b * MB:(b + 1) * MB].int()
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    return ((q, kf.to(torch.bfloat16), vf.to(torch.bfloat16), tables,
             lengths), (kq, vq, ks, vs))


def check_quant_recurrent(counted, dev):
    """Phase 22: the int8 pool of the recurrent archs. Kernel #3 at
    recurrentgemma-9b's int8 rings against its plain version, timed; each
    arch of QUANT_RECURRENT at full width and depth served with --kv quant
    by classic admission on one engine and on two replicas (counts read
    between each run and its verify: the quant kernel launched for the
    rings, the bf16 one never, the recurrence kernels once a prefill and
    layer), each passing its --verify (another slot count; one engine);
    one EDF swap-out and swap-in of a seeded recurrentgemma-9b request on
    the int8 pool (ring blocks with their scales, state rows), resumed
    bit-identical to an unpreempted run. Returns (#3's row at the rings,
    launches by kernel name over the runs)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import parse_args, serve, verify
    gen = torch.Generator(device=dev).manual_seed(22)
    pin, quant = quant_ring_inputs(gen, dev)
    ring = paged_case("int8 paged decode at recurrentgemma-9b's rings (GQA "
                      f"16, hd 256; lengths {pin[4].tolist()})", pin, quant)
    launches = {}
    for arch, extra in QUANT_RECURRENT:
        cfg = get_config(arch)
        params = load_params(cfg, seed=0, device=dev)
        kinds = cfg.block_pattern * cfg.num_blocks + cfg.pattern_tail
        slots = extra[extra.index("--slots") + 1]
        for fleet in ([], ["--replicas", "2", "--slots",
                           str(int(slots) // 2)]):
            args = parse_args(["--arch", arch, "--kv", "quant", "--rate",
                               "16", "--block-size", "16", "--device",
                               str(dev)] + extra + fleet)
            label = (f"{cfg.name} --kv quant, {args.replicas} "
                     f"replica(s) x {args.slots} slots")
            for op in counted:
                op.launches = 0
            run = serve(args, cfg, params)
            got = {op.__name__: op.launches for op in counted}
            n = args.requests
            want = {"rglru_scan": n * kinds.count("rglru"),
                    "wkv6": n * kinds.count("rwkv"),
                    "flash_attention": (n * kinds.count("local")
                                        if args.prompt_len > 128 else 0),
                    "paged_flash_decode": 0}
            for name, w in want.items():
                if got[name] != w:
                    fail(f"{label}: {name} launched {got[name]} times, "
                         f"expected {w}")
            if (got["paged_flash_decode_quant"] > 0) != ("local" in kinds):
                fail(f"{label}: the quant kernel launched "
                     f"{got['paged_flash_decode_quant']} times")
            if run["engine"].snapshot()["preemptions"]:
                fail(f"{label}: the serve preempted at the worst-case "
                     "budget")
            check_tokens(run, cfg)
            t0 = time.perf_counter()
            ok, line = verify(args, cfg, params, run)
            if not ok:
                fail(f"{label}: {line}")
            plane = (run["engine"].describe() if args.replicas > 1
                     else run["engine"].pool.describe())
            print(f"{label}: {plane}; {run['tokens']} tokens in "
                  f"{run['steps']} decode steps, {run['wall_s']:.3f}s wall, "
                  f"{run['tokens'] / run['wall_s']:.1f} tokens/s wall on "
                  f"{card()}; launches {got}; {line} "
                  f"({time.perf_counter() - t0:.1f}s)")
            _add(launches, got)
        if "local" in kinds:
            _add(launches, swap_victim(
                cfg, params, "quant", 2100, counted,
                f"{cfg.name} int8 rings, swap tier"))
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return ring, launches


def check_oneshot_against_cpu(cfg, params, S, G=4):
    """The smoke config's prefill (batch 2, seeded stubs) and G decode
    steps of the same tokens on the card vs the CPU path on the same
    weights, |diff| / max(|logit|, 1) over every logit of the prefill and
    the steps; each device decodes over its own prefill's caches. The
    tolerance: LOGIT_TOL (phase 2's bound for one decode step of a smoke
    config) or, where larger, check_prefill_against_cpu's: twice the CPU
    path's spread against itself with every product accumulated in f64,
    in the worst logit and on average (at d_model 64 the f64 spread is
    small: a GEMM of 64 terms seldom rounds otherwise)."""
    import torch
    from repro_torch.launch.serve import modality_stubs
    from repro_torch.models import layers as L
    from repro_torch.models import model as Mo
    from repro_torch.models.env import Env
    from repro_torch.optim.adamw import tree_map

    gen = torch.Generator().manual_seed(23)
    B = 2
    tok = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    nxt = torch.randint(0, cfg.vocab_size, (B, G), generator=gen)
    stubs = {k: torch.randn(v.shape, generator=gen)
             for k, v in modality_stubs(cfg, B, S, "cpu").items()}
    off = cfg.num_vision_embeds if cfg.family == "vlm" else 0

    def run(p, dev):
        lg, caches = Mo.forward(p, tok.to(dev), cfg, Env(), mode="prefill",
                                **{k: v.to(dev) for k, v in stubs.items()})
        caches = Mo.grow_caches(caches, G, cfg)
        out = [lg.float().reshape(-1)]
        for i in range(G):
            lg, caches = Mo.forward(p, nxt[:, i:i + 1].to(dev), cfg, Env(),
                                    mode="decode", caches=caches,
                                    cur_len=S + off + i)
            out.append(lg.float().reshape(-1))
        return torch.cat(out).cpu()

    t0 = time.perf_counter()
    cparams = tree_map(lambda x: x.cpu(), params)
    card_lg, ref = run(params, params["embed"].device), run(cparams, "cpu")
    linear = L.linear

    def linear_f64(x, w):
        y = x.reshape(-1, x.shape[-1]).double() @ w.double()
        return y.float().to(x.dtype).reshape(*x.shape[:-1], w.shape[-1])

    L.linear = linear_f64
    try:
        alt = run(cparams, "cpu")
    finally:
        L.linear = linear
    rel = lambda a: (a - ref).abs() / ref.abs().clamp_min(1.0)
    err, spread = rel(card_lg), rel(alt)
    vis = f" + {off} vision" if off else ""
    print(f"{cfg.name}: prefill (B={B}, S={S}{vis}) and {G} decode steps"
          f" on the card vs the CPU path: relative logit "
          f"err max {float(err.max()):.3e}, mean {float(err.mean()):.3e}; "
          f"the CPU path against itself with f64-accumulated GEMMs: max "
          f"{float(spread.max()):.3e}, mean {float(spread.mean()):.3e}; "
          f"{time.perf_counter() - t0:.1f}s")
    if not (math.isfinite(float(err.max()))
            and float(err.max()) <= max(LOGIT_TOL, 2 * float(spread.max()))
            and float(err.mean()) <= max(LOGIT_TOL,
                                         2 * float(spread.mean()))):
        fail(f"{cfg.name} card vs CPU: the logits differ by more than "
             f"{LOGIT_TOL} and twice the spread of a reordered CPU "
             "computation")


def check_modality(counted, dev):
    """Phase 23: the modality archs. Kernel #1 at qwen2-vl-7b's GQA 7 (hd
    128: the one-shot's contiguous cache and the serving row mix) and at
    whisper-small's cross and self caches, #4 at qwen2-vl's prefill
    (causal, GQA 7, 256 vision + 128 prompt positions) and at whisper's
    encoder (non-causal) and decoder prefill, each against its plain
    version, timed; each arch of MODALITY at full width and depth through
    --trace oneshot (counts read around the run: #4 once a layer of the
    prefill, encoder included, #1 once a decode step and attention, cross
    included, nothing else); the smoke configs' prefill and decode logits
    on the card against the CPU path; one train step of each at full
    width and 2 layers (2 + 2 for whisper), the loss finite and no kernel
    launched. Returns (#1's rows, #4's rows, launches by kernel
    name)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.kernels.paged_decode.ops import quantize_kv
    from repro_torch.launch.serve import (modality_stubs, parse_args,
                                          run_oneshot)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as Mo
    from repro_torch.models.env import Env
    from repro_torch.optim.adamw import AdamWConfig, make_train_state

    gen = torch.Generator(device=dev).manual_seed(23)
    mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(
        torch.bfloat16)
    ident = lambda B: torch.arange(B, dtype=torch.int32, device=dev)[:, None]
    paged = {}
    # qwen2-vl's one-shot: 4 rows over 256 + 128 + 32 positions
    S = 256 + 128 + 32
    paged["qwen2-vl one-shot"] = paged_case(
        "paged decode, qwen2-vl-7b's one-shot cache (GQA 7, hd 128, 416 "
        "positions)", (mk(4, 28, 128), mk(4, 4, S, 128), mk(4, 4, S, 128),
                       ident(4), torch.tensor([384, 395, 405, 414],
                                              dtype=torch.int32, device=dev)))
    q, kp, vp, tables, lengths = (
        t.to(dev) for t in paged_inputs(torch.Generator(device=dev)
                                        .manual_seed(7), dev))
    mix = (mk(*q.shape[:1], 28, 128), mk(kp.shape[0], 4, 16, 128),
           mk(kp.shape[0], 4, 16, 128), tables, lengths)
    paged["gqa7 serving mix"] = paged_case(
        "paged decode, GQA 7 hd 128 at the serving row mix", mix)
    kq, ks = quantize_kv(mix[1].float())
    vq, vs = quantize_kv(mix[2].float())
    paged["gqa7 serving mix int8"] = paged_case(
        "int8 paged decode, GQA 7 hd 128 at the serving row mix", mix,
        (kq, vq, ks, vs))
    paged["whisper cross"] = paged_case(
        "paged decode, whisper-small's cross caches (MHA 12, hd 64, 256 "
        "frames)", (mk(8, 12, 64), mk(8, 12, 256, 64), mk(8, 12, 256, 64),
                    ident(8), torch.full((8,), 255, dtype=torch.int32,
                                         device=dev)))
    paged["whisper self"] = paged_case(
        "paged decode, whisper-small's self caches (512 + 32 positions)",
        (mk(8, 12, 64), mk(8, 12, 544, 64), mk(8, 12, 544, 64), ident(8),
         torch.arange(512, 544, 4, dtype=torch.int32, device=dev)))
    flash = {
        "qwen2-vl prefill": flash_case(
            "flash attention, qwen2-vl-7b's prefill (GQA 7, hd 128, 256 + "
            "128 positions, causal)", gen, dev, 4, 384, 28, 4, 128, True),
        "whisper encoder": flash_case(
            "flash attention, whisper-small's encoder (MHA 12, hd 64, 256 "
            "frames, non-causal)", gen, dev, 8, 256, 12, 12, 64, False),
        "whisper decoder": flash_case(
            "flash attention, whisper-small's decoder prefill (512 tokens, "
            "causal)", gen, dev, 8, 512, 12, 12, 64, True)}
    launches = {}
    for arch, extra in MODALITY:
        cfg = get_config(arch)
        params = load_params(cfg, seed=0, device=dev)
        args = parse_args(["--arch", arch, "--trace", "oneshot", "--device",
                           str(dev)] + extra)
        for op in counted:
            op.launches = 0
        run = run_oneshot(args, cfg, params)
        got = {op.__name__: op.launches for op in counted}
        attn = 2 if cfg.is_encdec else 1
        want = {op.__name__: 0 for op in counted}
        want["flash_attention"] = cfg.n_layers + (
            cfg.encoder_layers if cfg.is_encdec else 0)
        want["paged_flash_decode"] = (args.gen - 1) * cfg.n_layers * attn
        if got != want:
            fail(f"{cfg.name} one-shot: launches {got}, expected {want}")
        toks = np.asarray(run["tokens"])
        if toks.shape != (args.requests, args.gen) or not (
                (toks >= 0) & (toks < cfg.vocab_size)).all():
            fail(f"{cfg.name} one-shot: bad tokens {toks[:, :8]}")
        print(f"{cfg.name} one-shot ({args.requests} x prompt "
              f"{args.prompt_len}, gen {args.gen}): {run['wall_s']:.3f}s "
              f"wall, {toks.size / run['wall_s']:.1f} tokens/s wall on "
              f"{card()}; launches {got}; sample {toks[0, :8].tolist()}")
        _add(launches, got)
        del params, run
        gc.collect()
        torch.cuda.empty_cache()
    for arch, S in (("qwen2-vl-7b", 248), ("whisper-small", 512)):
        cfg = get_smoke(arch)
        check_oneshot_against_cpu(cfg, Mo.init_params(
            cfg, Env(), seed=1, device=dev), S)
    env = train_env()
    for arch in ("qwen2-vl-7b", "whisper-small"):
        cfg = get_config(arch)
        cut = dict(n_layers=2)
        if cfg.is_encdec:
            cut["encoder_layers"] = 2
        cfg = dataclasses.replace(cfg, **cut)
        params = load_params(cfg, seed=0, device=dev)
        B, S = 2, 128
        batch = train_batch(cfg, B, S, dev)
        batch.update({k: torch.randn(v.shape, generator=gen, device=dev)
                      for k, v in modality_stubs(cfg, B, S, dev).items()})
        opt = AdamWConfig(lr=1e-3, warmup_steps=0, weight_decay=0.0)
        step = make_train_step(cfg, env, opt)
        state = make_train_state(params, opt)
        del params
        before = _launch_counts(counted)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        wall = time.perf_counter() - t0
        launched = {n: c - before[n] for n, c in
                    _launch_counts(counted).items() if c != before[n]}
        enc = ", 2 encoder layers" if cfg.is_encdec else ""
        print(f"{cfg.name} train step (2 layers{enc}, "
              f"B={B} S={S}, stubs seeded): loss {loss:.4f}, {wall:.3f}s "
              f"wall, peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB "
              f"on {card()}; kernel launches {launched or 'none'}")
        if not math.isfinite(loss) or launched:
            fail(f"{cfg.name} train step: loss {loss}, launches {launched}")
        del state, batch
        gc.collect()
        torch.cuda.empty_cache()
    return paged, flash, launches


# the elastic runtime (phase 24): paper-demo-110m at full width and depth,
# seq 128, global batch 8, lr 1e-3 without warmup, checkpoints every 5
# steps. Run A 16 steps uninterrupted (and twice more for 13 steps with no
# checkpoint: the card's run-to-run spread, its embedding backward adds
# with atomics); run B scales to 3 nodes at step 6 and loses a node at
# step 13; run C (int8 moments) scales at step 4
ELASTIC_STEPS = 16
ELASTIC_SPREAD_STEPS = 13
ELASTIC_CLI = ["--smoke", "--steps", "20", "--nodes", "2", "--scale-to",
               "3@8", "--crash-at", "14", "--ckpt-every", "5",
               "--log-every", "5"]
ELASTIC_DONE = "done: 20 steps; epochs=3 reshards=2 restores=1 steps_lost=1"


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, n))
               for n in os.listdir(path))


def _whole(x):
    """A DTensor gathered whole (a collective over its mesh); a tensor as
    it is."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def elastic_run(label, state_dtype, steps, *, scale_at=None, crash_at=None,
                ckpt_every=5, final_save=True, cfg=None):
    """One ElasticTrainer run on a VirtualCluster over the card (2 nodes,
    TTL 2 s) in a temporary checkpoint directory, removed after. The
    checkpoint manager's save, save_async and restore are wrapped: each
    call's wall time is kept (the card synchronised before and after;
    for save_async that is the part that blocks the step), each save
    snapshots the state it was given on the card, and each restore's
    every leaf must torch.equal the snapshot of the step it restored.
    Returns the losses by step (in order: a rollback repeats steps), the
    trainer's counters, the times and the bytes of one checkpoint (None
    without one). final_save=False leaves out the trainer's finalize.
    cfg: the model (paper-demo-110m by default). Under a process group
    the cluster renders a DeviceMesh over its ranks and the state's
    leaves are DTensors, compared gathered."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import VirtualCluster
    from repro_torch.core.elastic import ElasticTrainer
    from repro_torch.optim.adamw import AdamWConfig, tree_leaves, tree_map

    cfg = cfg or get_config("paper-demo")
    opt = AdamWConfig(lr=1e-3, warmup_steps=0, weight_decay=0.0,
                      state_dtype=state_dtype)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    cluster = VirtualCluster(n_compute=2, ttl=2.0, device="cuda")
    trainer = ElasticTrainer(cluster.template, cfg,
                             ShapeConfig("phase24", 128, 8, "train"), tmp,
                             opt=opt, ckpt_every=ckpt_every)
    mgr = trainer.ckpt
    times = {"save": [], "save_async": [], "restore": [], "step": []}
    snaps, checked = {}, []
    clone = lambda t: tree_map(lambda x: None if x is None else x.clone(), t)

    def wrap(name):
        fn = getattr(mgr, name)

        def timed(*a, **kw):
            if name != "restore":  # (step, state, metadata)
                snaps[a[0]] = clone(a[1])
            step = mgr.latest_step()  # restore's: the latest
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
            if name == "restore":
                want = tree_leaves(snaps[step])
                got = tree_leaves(out)
                if len(got) != len(want) or not all(
                        g.device.type == "cuda"
                        and torch.equal(_whole(g), _whole(w))
                        for g, w in zip(got, want)):
                    fail(f"elastic {label}: the state restored at step "
                         f"{step} is not the state saved there")
                checked.append(step)
            return out

        setattr(mgr, name, timed)

    for name in ("save", "save_async", "restore"):
        wrap(name)
    losses = []
    try:
        for i in range(steps):
            if i == scale_at:
                cluster.scale_to(3)
                trainer.ensure_ready(planned=True)
            if i == crash_at:
                cluster.crash_node(cluster.compute_nodes()[-1])
                cluster.pump(dt=10.0)  # let the TTL lapse
                trainer.ensure_ready(planned=False)
            cluster.pump(dt=0.1)
            n_io = len(times["save_async"]) + len(times["restore"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = trainer.run_steps(1)  # ends in a host transfer (the loss)
            # the first step builds the state; a step that saved is apart
            if i and len(times["save_async"]) + len(times["restore"]) == \
                    n_io:
                times["step"].append(time.perf_counter() - t0)
            losses.append((trainer.step, m["loss"]))
        mgr.wait()
        last = mgr.latest_step()
        ckpt_bytes = (None if last is None else
                      _dir_bytes(os.path.join(tmp, f"step_{last:08d}")))
        if final_save:
            trainer.finalize()
        st = trainer.stats
        stats = dict(epochs=st.epoch_changes, reshards=st.reshards,
                     restores=st.restores, steps_lost=st.steps_lost,
                     step=trainer.step, restored=checked)
    finally:
        cluster.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
        snaps.clear()
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    return losses, stats, times, ckpt_bytes


def _ms(xs):
    return (f"{1e3 * sum(xs) / len(xs):.1f} ms mean of {len(xs)}"
            if xs else "none")


def check_elastic(counted):
    """Phase 24: the elastic runtime (ElasticTrainer, checkpoints, the data
    pipeline) at full width and depth (elastic_run). Counts zeroed before
    and read after: no kernel may launch. Checks: run B's counters (one
    planned reshard and one rollback: JAX's semantics count the rollback's
    restore as a reshard too, as its CLI's `reshards=2` does), every
    restored state equal to the saved one on the card, run B's losses up
    to the crash within twice the spread of run A against its repeats
    (equal if they repeat bit for bit), run A's loss falling, every loss
    finite, run C's counters, and the train CLI's smoke run on the card ending with the
    JAX CLI's `done:` line. Returns the launches by kernel name."""
    for op in counted:
        op.launches = 0
    t0 = time.perf_counter()
    a, a_stats, a_times, a_bytes = elastic_run("A", "fp32", ELASTIC_STEPS)
    repeats = [elastic_run(f"A{k}", "fp32", ELASTIC_SPREAD_STEPS,
                           ckpt_every=10 ** 6, final_save=False)[0]
               for k in (2, 3)]
    b, b_stats, b_times, _ = elastic_run("B", "fp32", ELASTIC_STEPS,
                                         scale_at=6, crash_at=13)
    c, c_stats, c_times, c_bytes = elastic_run("C", "int8", 8, scale_at=4)
    launches = {("flash_decode" if op.__name__ == "flash_decode_partials"
                 else op.__name__): op.launches for op in counted}
    n = ELASTIC_SPREAD_STEPS
    first = [x for _, x in a[:n]]
    runs = [first] + [[x for _, x in r[:n]] for r in repeats]
    spread = max(abs(p - q) for r1 in runs for r2 in runs
                 for p, q in zip(r1, r2))
    b_err = max(abs(p - q) for (_, p), q in zip(b[:n], first))
    print(f"elastic run A (paper-demo-110m, 12 layers, seq 128, batch 8, "
          f"fp32 moments, 16 steps): loss "
          f"{' '.join(f'{x:.4f}' for _, x in a)}; {a_stats}")
    print(f"elastic run B (scale to 3 at step 6, crash at 13): loss "
          f"{' '.join(f'{s}:{x:.4f}' for s, x in b)}; {b_stats}; losses "
          f"up to the crash vs A: max |diff| {b_err:.3e}, the card's spread "
          f"over 3 runs of {n} steps {spread:.3e}")
    print(f"elastic run C (int8 moments, scale at 4): loss "
          f"{' '.join(f'{x:.4f}' for _, x in c)}; {c_stats}")
    for label, t, nbytes in (("A fp32", a_times, a_bytes),
                             ("B fp32", b_times, None),
                             ("C int8", c_times, c_bytes)):
        print(f"elastic {label} on {card()}: train step {_ms(t['step'])}"
              f" (steps that build, save or restore left out); sync save "
              f"{_ms(t['save'])}; save_async blocking {_ms(t['save_async'])};"
              f" restore {_ms(t['restore'])}"
              + (f"; {nbytes} bytes a checkpoint" if nbytes else ""))
    want_b = dict(epochs=3, reshards=2, restores=1, steps_lost=2,
                  step=ELASTIC_STEPS - 2, restored=[6, 11])
    if b_stats != want_b:
        fail(f"elastic run B: counters {b_stats}, expected {want_b}")
    want_c = dict(epochs=2, reshards=1, restores=0, steps_lost=0, step=8,
                  restored=[4])
    if c_stats != want_c:
        fail(f"elastic run C: counters {c_stats}, expected {want_c}")
    if a_stats["reshards"] or a_stats["step"] != ELASTIC_STEPS:
        fail(f"elastic run A: counters {a_stats}")
    if not b_err <= 2 * spread:
        fail(f"elastic run B: losses differ from A's by {b_err:.3e}, more "
             f"than twice the card's spread {spread:.3e}")
    if not (all(math.isfinite(x) for _, x in a + b + c)
            and a[-1][1] < a[0][1]):
        fail("elastic: a loss is not finite or did not fall")
    if any(launches.values()):
        fail(f"elastic: the trainer launched {launches}")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as ck:
        t1 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *ELASTIC_CLI,
             "--ckpt-dir", ck], capture_output=True, text=True, env=env,
            timeout=300)
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines or lines[-1] != ELASTIC_DONE:
        fail(f"train CLI on the card: exit {out.returncode}, "
             f"{out.stdout[-2000:]}{out.stderr[-2000:]}")
    print(f"train CLI --smoke on the card ({time.perf_counter() - t1:.1f}s,"
          f" a process of its own): {lines[-1]}")
    print(f"elastic phase: {time.perf_counter() - t0:.1f}s; kernel "
          f"launches {launches}")
    return launches


# phase 25: training across ranks
SHARDED_STEPS = 5  # paper-demo-110m, full width and depth, B=8 S=128
SHARDED_SPREAD_RUNS = 3  # one-device runs: the card's run-to-run spread
SHARDED_B_LAYERS = 2  # part (b)'s dense step: paper-demo-110m, cut depth
SHARDED_B_STEPS = 3
# part (b) against part (a), two tp ranks against one: the first loss
# within STEP1_TOL relative (tests/test_torch_sharded.py: the row
# products' tp shares summed in f32 in another order, the log-sum-exp
# over the vocabulary's shards), the later ones within LATER_TOL (each
# rank's gradient shares rounded to bf16 before they are summed; lr 1e-3
# without warmup takes the loss from 10.9 to 4.1 in three steps)
SHARDED_STEP1_TOL = 5e-5
SHARDED_LATER_TOL = 1e-2
# grok-1-314b's MoE layer, the ranks' outputs against the one-device
# layer on the same tokens: relative RMS within one bf16 rounding
SHARDED_MOE_RMS = 2.0 ** -8
SHARDED_MOE_X = (2, 256)  # the layer's input, batch x positions


def sharded_plan(fsdp=True):
    """The sharded step's plan: phase 20's (attention_naive at S <= 128),
    with FSDP."""
    from repro_torch.configs.base import ParallelPlan
    return ParallelPlan(fsdp=fsdp, remat="nothing", attn_impl="xla_chunked",
                        kv_cache="replicated")


def sharded_steps(cfg, env, steps):
    """`steps` make_train_step steps from Mo.init_params(seed 0) on a fixed
    batch (B=8, S=128, lr 1e-3, no warmup; a modality arch's seeded
    stubs): over env.mesh with the state and the batch placed by
    parallel/rules.py, else on one device.
    Returns (losses, the wall time of each step after the first, peak
    device memory in GiB)."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as St
    from repro_torch.models import model as Mo
    from repro_torch.models.env import Env
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.parallel import rules as R

    torch.cuda.reset_peak_memory_stats()
    opt = AdamWConfig(lr=1e-3, warmup_steps=0, weight_decay=0.0)
    params = Mo.init_params(cfg, Env(plan=env.plan), seed=0, device="cuda")
    state = {"params": params, "opt": adamw_init(params, opt)}
    batch = train_batch(cfg, 8, 128, "cuda")
    batch.update(modality_stubs_seeded(cfg, 8, 128))
    if env.mesh is not None:
        state = R.apply_shardings(
            state, R.state_specs(St.state_struct(cfg, env, opt), cfg, env),
            env)
        batch = R.apply_shardings(batch, R.batch_specs(
            batch, cfg, ShapeConfig("s", 128, 8, "train"), env), env)
    step = St.make_train_step(cfg, env, opt)
    losses, times = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))  # a host transfer ends the step
        if i:
            times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, params
    gc.collect()
    torch.cuda.empty_cache()
    return losses, times, peak


def moe_inputs(cfg):
    """grok-1-314b's MoE layer at full width: seeded weights (one layer,
    drawn on the card) and a seeded input [SHARDED_MOE_X, d] bf16."""
    import torch
    from repro_torch.models import moe as M
    gen = torch.Generator(device="cuda").manual_seed(25)
    p = M.init_moe(gen, cfg)
    x = torch.randn(SHARDED_MOE_X + (cfg.d_model,), generator=gen,
                    device="cuda").to(torch.bfloat16)
    return p, x


def rel_rms(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


def sharded_rank(rank, store, out):
    """Part (b) of phase 25, one of two processes sharing the card: a gloo
    group with CUDA tensors, a (1, 2) (data, model) DeviceMesh. The dense
    step at SHARDED_B_LAYERS layers and full width, then grok-1-314b's MoE
    layer in ep mode (4 experts a rank: each rank's slice of the
    experts, its own positions); writes the losses, step times, peak
    memory, the layer's output for this rank's positions and the launch
    counts of the seven kernels (they must stay 0) to out.<rank>.json /
    .pt."""
    import torch
    import torch.distributed as dist
    from repro_torch import kernels  # noqa: F401  (the counted ops)
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_decode.ops import flash_decode_partials
    from repro_torch.kernels.paged_decode.ops import (
        paged_flash_decode, paged_flash_decode_quant)
    from repro_torch.kernels.rglru.ops import rglru_scan
    from repro_torch.kernels.rwkv6.ops import wkv6
    from repro_torch.kernels.sampling.ops import topk_topp_mask
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe as M
    from repro_torch.models.env import Env

    counted = (paged_flash_decode, paged_flash_decode_quant, topk_topp_mask,
               flash_attention, rglru_scan, wkv6, flash_decode_partials)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=2)
    mesh = make_test_mesh(2, model=2)
    env = Env(plan=sharded_plan(), mesh=mesh)
    cfg = dataclasses.replace(get_config("paper-demo"),
                              n_layers=SHARDED_B_LAYERS)
    losses, times, peak = sharded_steps(cfg, env, SHARDED_B_STEPS)
    grok = get_config("grok-1-314b")
    p, x = moe_inputs(grok)
    el = grok.moe.num_experts // 2
    local = {"router": p["router"], **{
        k: p[k][rank * el:(rank + 1) * el].clone()
        for k in ("w_gate", "w_up", "w_down")}}  # apply_shardings' ep split
    del p
    torch.cuda.empty_cache()
    ep = Env(plan=sharded_plan(fsdp=False), mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y, aux = M.moe_layer(local, x, grok, ep)
    torch.cuda.synchronize()
    moe_s = time.perf_counter() - t0
    half = SHARDED_MOE_X[1] // 2
    torch.save(y[:, rank * half:(rank + 1) * half].cpu(), f"{out}.{rank}.pt")
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump({"losses": losses, "times": times, "peak_gib": peak,
                   "moe_s": moe_s, "aux": float(aux),
                   "peak_moe_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                   "launches": {op.__name__: op.launches for op in counted}},
                  f)
    dist.destroy_process_group()


def check_sharded(counted):
    """Phase 25: training across ranks. Part (a), one rank of an NCCL group
    and a 1 x 1 (data, model) DeviceMesh: paper-demo-110m at full width
    and depth through the sharded train step (fsdp, SHARDED_STEPS steps)
    against the one-device step (SHARDED_SPREAD_RUNS runs: the card's
    run-to-run spread; the sharded losses within twice it, equal if it is
    0), grok-1-314b's MoE layer at full width in ep and tp modes against
    the one-device layer (SHARDED_MOE_RMS), and the ElasticTrainer over
    the mesh its VirtualCluster renders through one planned scale and
    one lost node (elastic_run at 2 layers: counters, every restored
    state equal to the saved one), and the train CLI under torchrun (its
    `done:` line). Part (b), two processes sharing the
    card over a gloo group with CUDA tensors (every collective the step
    uses carries them: all_gather_into_tensor, reduce_scatter_tensor,
    all_reduce, all_to_all_single), a (1, 2) mesh (sharded_rank): the
    dense step at 2 layers against part (a)'s and the ep layer's ranks
    against the one-device layer on each rank's tokens. Counts zeroed
    before and read after, the children's too: none of the seven kernels
    is launched. Returns the launches by kernel name."""
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe as M
    from repro_torch.models.env import Env

    for op in counted:
        op.launches = 0
    t0 = time.perf_counter()
    cfg = get_config("paper-demo")
    cut = dataclasses.replace(cfg, n_layers=SHARDED_B_LAYERS)
    singles = [sharded_steps(cfg, Env(plan=sharded_plan()), SHARDED_STEPS)
               for _ in range(SHARDED_SPREAD_RUNS)]
    spread = max(abs(a - b) for r1 in singles for r2 in singles
                 for a, b in zip(r1[0], r2[0]))
    grok = get_config("grok-1-314b")
    store = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            rank=0, world_size=1)
    try:
        env = Env(plan=sharded_plan(), mesh=make_test_mesh(1, model=1))
        losses, times, peak = sharded_steps(cfg, env, SHARDED_STEPS)
        err = max(abs(a - b) for a, b in zip(losses, singles[0][0]))
        print(f"sharded train step over a 1 x 1 NCCL mesh (paper-demo-110m, "
              f"12 layers, B=8 S=128, fsdp, {SHARDED_STEPS} steps): loss "
              f"{' '.join(f'{x:.6f}' for x in losses)}; one device "
              f"{' '.join(f'{x:.6f}' for x in singles[0][0])}; max |diff| "
              f"{err:.3e}, the card's spread over {SHARDED_SPREAD_RUNS} "
              f"one-device runs {spread:.3e}")
        print(f"on {card()}: sharded step {_ms(times)}, one-device step "
              f"{_ms(singles[0][1])}; peak memory {peak:.2f} GiB sharded, "
              f"{singles[0][2]:.2f} GiB one device")
        if not err <= 2 * spread:
            fail(f"sharded step over 1 x 1: losses differ from the one-device"
                 f" step's by {err:.3e}, more than twice the spread "
                 f"{spread:.3e}")
        cut_losses = sharded_steps(cut, env, SHARDED_B_STEPS)[0]
        p, x = moe_inputs(grok)
        y1, aux1 = M.moe_layer(p, x, grok)
        half = SHARDED_MOE_X[1] // 2
        halves = [M.moe_layer(p, x[:, r * half:(r + 1) * half], grok)[0]
                  .cpu() for r in range(2)]
        moe_err = {}
        for mode in ("ep", "tp"):
            menv = Env(plan=dataclasses.replace(sharded_plan(),
                                                moe_mode=mode),
                       mesh=env.mesh)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            y, aux = M.moe_layer(p, x, grok, menv)
            torch.cuda.synchronize()
            moe_err[mode] = (rel_rms(y, y1), float(aux) - float(aux1),
                             time.perf_counter() - t1)
        del p, x, y, y1
        gc.collect()
        torch.cuda.empty_cache()
        print(f"grok-1-314b MoE layer at full width over the 1 x 1 mesh "
              f"(tokens {SHARDED_MOE_X}): relative RMS against the "
              f"one-device layer and aux difference "
              + ", ".join(f"{m} {e:.3e} / {a:.3e} ({t * 1e3:.1f} ms)"
                          for m, (e, a, t) in moe_err.items())
              + f" (tolerance {SHARDED_MOE_RMS:.3e})")
        if not all(e <= SHARDED_MOE_RMS and a == 0.0
                   for e, a, _ in moe_err.values()):
            fail(f"MoE layer over the 1 x 1 mesh: {moe_err}")
        d, d_stats, d_times, _ = elastic_run("D", "fp32", 8, scale_at=3,
                                             crash_at=6, ckpt_every=2,
                                             cfg=cut)
        want_d = dict(epochs=3, reshards=2, restores=1, steps_lost=1, step=7,
                      restored=[3, 5])
        print(f"elastic run D over the rendered 1 x 1 mesh (paper-demo-110m "
              f"at 2 layers, scale to 3 at step 3, crash at 6): loss "
              f"{' '.join(f'{s}:{x:.4f}' for s, x in d)}; {d_stats}; train "
              f"step {_ms(d_times['step'])} on {card()}")
        if d_stats != want_d:
            fail(f"elastic run D: counters {d_stats}, expected {want_d}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    # the train CLI under torchrun (one NCCL rank on the card)
    env_b = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_torchrun_") as ck:
        t1 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "1", "-m", "repro_torch.launch.train",
             *ELASTIC_CLI, "--ckpt-dir", ck], capture_output=True,
            text=True, env=env_b, timeout=300)
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines or lines[-1] != ELASTIC_DONE:
        fail(f"train CLI under torchrun: exit {out.returncode}, "
             f"{out.stdout[-2000:]}{out.stderr[-2000:]}")
    print(f"train CLI --smoke under torchrun, one NCCL rank on the card "
          f"({time.perf_counter() - t1:.1f}s): {lines[-1]}")
    # part (b): two processes on the card, a (1, 2) mesh over gloo
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    t1 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "chip_smoke.py"),
         "--sharded-rank", str(r), f"{tmp}/store", f"{tmp}/out"],
        env=env_b, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    logs = []
    for proc in procs:
        try:
            logs.append(proc.communicate(timeout=400)[0])
        finally:
            proc.kill()
    if any(proc.returncode != 0 for proc in procs):
        fail("phase 25 part (b): a rank failed:\n" + "\n".join(
            log[-3000:] for log in logs))
    ranks = []
    for r in range(2):
        with open(f"{tmp}/out.{r}.json") as f:
            ranks.append(json.load(f))
        ranks[r]["moe_rms"] = rel_rms(torch.load(f"{tmp}/out.{r}.pt"),
                                      halves[r])
    shutil.rmtree(tmp, ignore_errors=True)
    wall_b = time.perf_counter() - t1
    b_losses = ranks[0]["losses"]
    moe_rms = " ".join(f"{rep['moe_rms']:.3e}" for rep in ranks)
    moe_ms = " ".join(f"{rep['moe_s'] * 1e3:.1f} ms" for rep in ranks)
    step_err = [abs(a - b) / abs(b) for a, b in zip(b_losses, cut_losses)]
    print(f"part (b), two processes on the card over gloo (CUDA tensors), a "
          f"(1, 2) mesh, {wall_b:.1f}s with their start: paper-demo-110m at "
          f"{SHARDED_B_LAYERS} layers, loss "
          f"{' '.join(f'{x:.6f}' for x in b_losses)} against the 1 x 1 "
          f"mesh's {' '.join(f'{x:.6f}' for x in cut_losses)} (relative "
          f"{' '.join(f'{e:.2e}' for e in step_err)}; tolerance "
          f"{SHARDED_STEP1_TOL:.0e} first, {SHARDED_LATER_TOL:.0e} after); "
          f"grok-1-314b MoE layer in ep mode, each rank's positions against "
          f"the one-device layer on them: relative RMS {moe_rms} "
          f"({moe_ms})")
    for r, rep in enumerate(ranks):
        print(f"part (b) rank {r} on {card()}: sharded step "
              f"{_ms(rep['times'])}, peak memory {rep['peak_gib']:.2f} GiB "
              f"(dense step), {rep['peak_moe_gib']:.2f} GiB (with the MoE "
              f"layer)")
    if not (ranks[0]["losses"] == ranks[1]["losses"]
            and step_err[0] <= SHARDED_STEP1_TOL
            and all(e <= SHARDED_LATER_TOL for e in step_err[1:])):
        fail(f"part (b): losses {[rep['losses'] for rep in ranks]} against "
             f"{cut_losses}")
    if not all(rep["moe_rms"] <= SHARDED_MOE_RMS for rep in ranks):
        fail(f"part (b): MoE layer relative RMS {moe_rms}")
    launches = {("flash_decode" if op.__name__ == "flash_decode_partials"
                 else op.__name__): op.launches for op in counted}
    child = {k: sum(rep["launches"].get(k, 0) for rep in ranks) for k in
             ("paged_flash_decode", "paged_flash_decode_quant",
              "topk_topp_mask", "flash_attention", "rglru_scan", "wkv6",
              "flash_decode_partials")}
    if any(launches.values()) or any(child.values()):
        fail(f"phase 25 launched {launches}, its ranks {child}")
    print(f"sharded phase: {time.perf_counter() - t0:.1f}s; kernel launches "
          f"{launches}, part (b)'s ranks {child}")
    return launches


# phase 26: the one-shot over the cluster's rendered mesh. (arch, layers
# (None: its own depth), B, prompt, gen): paper-demo-110m and rwkv6-1.6b
# at full width and depth, recurrentgemma-9b at full width and 5 layers
# (one (rglru, rglru, local) unit and the rglru tail pair: every kernel of
# its path, at 2.3 of its 9.2 billion parameters)
MESH_CASES = (("paper-demo", None, 8, 256, 32),
              ("rwkv6-1.6b", None, 8, 256, 16),
              ("recurrentgemma-9b", 5, 8, 256, 16))
# ... and part (b)'s, the (1, 2) mesh against one device, rwkv6-1.6b cut to
# 2 layers: a row product's tp shares rounded once in another order part
# the logits by a rounding, and RWKV's 24 layers of recurrence amplify it
# (the CPU, full width, 64-token prompts: 0.031, 0.079, 0.135-0.148 and
# 0.34-0.37 at logits up to 5.1 at 2, 6, 12 and 24 layers; the card at 24
# layers and 256 tokens 0.25 of the largest logit), which no tolerance
# tells from a fault; at 2 layers a wrong head, gather or sum still moves
# every logit. paper-demo-110m at 4 of its 12 layers and gen 16 (the
# script's time: every collective of gloo a host round trip)
MESH_B_CASES = (("paper-demo", 4, 8, 256, 16),
                ("rwkv6-1.6b", 2, 8, 256, 16),
                ("recurrentgemma-9b", 5, 8, 256, 16))
# the (1, 2) mesh (two processes sharing the card over gloo) and the
# seq_sharded layout against one device: |diff| / max(|logit|, 1) on the
# prefill's and on every decode step before the first differing token
# (LOGIT_TOL: a row product's tp shares summed in f32 and rounded once,
# or flash-decoding's partials merged, against one GEMM or one paged
# decode); the tokens equal up to the first step where either side's
# top-2 margin falls under MESH_TIE of the row's largest logit (|.| >= 1)
MESH_TOL = LOGIT_TOL
MESH_TIE = LOGIT_TOL
MESH_TRAIN = ("rwkv6-1.6b", 2, 3)  # part (c): arch, layers, sharded steps
# part (c)'s losses against one device's: the first within
# SHARDED_STEP1_TOL (the forward and the vocabulary-parallel loss over
# the ranks); the later ones within MESH_LATER_TOL. lr 1e-3 without
# warmup takes rwkv6-1.6b from 11.58 to 2.75 in three steps, so weights
# a rounding of the gradients' shares apart after a step move the third
# loss by 3.05e-2 (this phase's first full run; 1.04e-3 at the second):
# the tolerance was set from that run. The tight checks of the gradient
# path are the CPU's (tests/test_torch_mesh_serving.py, three steps
# within 5e-4) and the sharded AdamW update's (tests/test_torch_sharded
# .py, bit for bit)
MESH_LATER_TOL = 0.1


def mesh_cfg(arch, layers):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def mesh_args(B, S, gen, nodes):
    """run_oneshot's arguments: B prompts of S tokens (seed 0), gen."""
    import argparse
    return argparse.Namespace(nodes=nodes, device="cuda", requests=B,
                              prompt_len=S, gen=gen, seed=0)


def mesh_prompts(cfg, B, S):
    """run_oneshot's prompts for mesh_args(B, S, ...)."""
    import numpy as np
    return np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S),
                                             dtype=np.int32)


def logit_err(got, want, ok=None):
    """max |got - want| / max(|want|, 1) over [G, B, V] logits, on every
    step (ok None) or the [G, B] steps of `ok`."""
    import numpy as np
    err = np.abs(got - want).max(-1) / np.maximum(np.abs(want).max(-1), 1)
    return float(err.max() if ok is None else err[ok].max())


def near_tie_equal(a, b, la, lb):
    """Tokens a, b [B, G] equal up to each row's first differing step,
    where either side's top-2 margin (la, lb [G, B, V] along each side's
    own tokens) is under MESH_TIE of the row's largest |logit| (>= 1).
    Returns (ok, the [G, B] steps before each row's first difference,
    the number of rows that part)."""
    import numpy as np

    def tie(lg):
        top2 = np.sort(lg, -1)[-2:]
        return top2[1] - top2[0] < MESH_TIE * max(np.abs(lg).max(), 1)

    same = np.cumprod(a == b, axis=1).astype(bool)
    agreed = np.concatenate([np.ones((a.shape[0], 1), bool),
                             same[:, :-1]], axis=1).T
    parted = 0
    for row in range(a.shape[0]):
        diff = np.nonzero(a[row] != b[row])[0]
        if diff.size:
            parted += 1
            t = diff[0]
            if not (tie(la[t, row]) or tie(lb[t, row])):
                return False, agreed, parted
    return True, agreed, parted


def kv_bytes(cfg, env, B, n):
    """The bytes of this rank's decode cache for B rows of n positions
    (init_cache's shapes on the meta device: k / v and state rows)."""
    from repro_torch.models import model as Mo
    return sum(x.numel() * x.element_size() for x in _leaves(
        Mo.init_cache(cfg, env, B, n, device="meta")))


# kernel #5's merged output (in q's dtype, bf16) against its plain
# version merged the same way: within one bf16 rounding of the value
# (2^-8 of it, taken as 2^-7 as phase 15's sharded-vs-whole check) plus
# FD_TOL: the two sides' f32 partials differ by FD_TOL, which flips a
# rounding now and then
FD_MERGED_REL = 2.0 ** -7


def fd_seq_case(q, k, v, group, index, n):
    """Kernel #5 over the rank's slice k, v of a cache split over the n
    ranks of `group` (slice `index`), merged across them, against its
    plain version merged the same way on the same slices, at a ragged
    and at the last position. Returns (the max abs error, the largest
    excess over FD_MERGED_REL of the value: <= FD_TOL passes)."""
    from repro_torch.kernels.flash_decode.ops import (
        flash_decode_seq_sharded, merge_partials)
    from repro_torch.kernels.flash_decode.ref import (
        flash_decode_partials_ref)
    import torch
    s_local, worst, excess = k.shape[2], 0.0, 0.0
    for c in (n * s_local * 5 // 8 + 3, n * s_local - 1):
        cur = torch.tensor([c], dtype=torch.int32, device=q.device)
        got = flash_decode_seq_sharded(q, k, v, cur, group, index).float()
        local = min(max(c - index * s_local, -1), s_local - 1)
        want = merge_partials(*flash_decode_partials_ref(q, k, v, local),
                              group).to(q.dtype).float()
        err = (got - want).abs()
        worst = max(worst, float(err.max()))
        excess = max(excess, float((err - FD_MERGED_REL * want.abs()).max()))
    return worst, excess


def mesh_rank(rank, store, out):
    """Parts (b) and (c) of phase 26, one of two processes sharing the
    card: a gloo group with CUDA tensors and the (1, 2) DeviceMesh a
    VirtualCluster of two nodes renders from its hostfile. run_oneshot
    over it for each MESH_B_CASES model (paper-demo-110m under both
    layouts), each run's logits along its own tokens (serve_logits; the
    seq_sharded one's along the replicated tokens too); kernel #5 merged
    across the two ranks against its plain version on the same slices at
    paper-demo-110m's seq_sharded shapes; then MESH_TRAIN's sharded train
    steps over a (1, 2) make_test_mesh. Rank 0 writes the tokens and
    logits (out.<case>.npz), every rank its launch counts, the runs' wall
    times and the losses (out.<rank>.json)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_decode.ops import flash_decode_partials
    from repro_torch.kernels.paged_decode.ops import (
        paged_flash_decode, paged_flash_decode_quant)
    from repro_torch.kernels.rglru.ops import rglru_scan
    from repro_torch.kernels.rwkv6.ops import wkv6
    from repro_torch.kernels.sampling.ops import topk_topp_mask
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.serve import (run_oneshot, serve_batch,
                                          serve_logits)
    from repro_torch.models import model as Mo
    from repro_torch.models.env import SERVE_PLAN, Env
    from repro_torch.parallel import collectives as C

    counted = (paged_flash_decode, paged_flash_decode_quant, topk_topp_mask,
               flash_attention, rglru_scan, wkv6, flash_decode_partials)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=2)
    seq = dataclasses.replace(SERVE_PLAN, kv_cache="seq_sharded")
    mesh = make_test_mesh(2, model=2)
    rep = {"wall_s": {}, "warm_s": {}, "launches": {}}
    for arch, layers, B, S, gen in MESH_B_CASES:
        cfg = mesh_cfg(arch, layers)
        params = Mo.init_params(cfg, Env(), seed=0, device="cuda")
        prompts = mesh_prompts(cfg, B, S)
        plans = [("replicated", SERVE_PLAN)]
        if arch == "paper-demo":
            plans.append(("seq_sharded", seq))
        toks = {}
        for layout, plan in plans:
            for op in counted:
                op.launches = 0
            run = run_oneshot(mesh_args(B, S, gen, 2), cfg, params, plan)
            rep["launches"][f"{arch}/{layout}"] = {
                op.__name__: op.launches for op in counted}
            rep["wall_s"][f"{arch}/{layout}"] = run["wall_s"]
            rep.setdefault("kv_bytes", {})[f"{arch}/{layout}"] = kv_bytes(
                cfg, Env(plan=plan, mesh=mesh), B, S + gen)
            toks[layout] = run["tokens"]
            kw = dict(streamed_prefill=False, mesh=mesh, plan=plan)
            res = {"tokens": run["tokens"], "logits": serve_logits(
                cfg, params, prompts, run["tokens"], **kw)}
            if layout == "seq_sharded":
                res["forced"] = serve_logits(cfg, params, prompts,
                                             toks["replicated"], **kw)
            torch.cuda.synchronize()  # warm: the mesh served before
            t1 = time.perf_counter()
            serve_batch(cfg, params, prompts, gen, **kw)
            rep["warm_s"][f"{arch}/{layout}"] = time.perf_counter() - t1
            if rank == 0:
                np.savez(f"{out}.{arch}.{layout}.npz", **res)
        del params
        torch.cuda.empty_cache()
    # kernel #5 across the two ranks at paper-demo-110m's seq_sharded
    # decode shapes: every head's q, this rank's half of the positions
    cfg = mesh_cfg("paper-demo", None)
    B, S, gen = MESH_CASES[0][2:]
    gen_ = torch.Generator(device="cuda").manual_seed(26)
    mk = lambda *s: torch.randn(s, generator=gen_, device="cuda").to(
        torch.bfloat16)
    q = mk(B, cfg.n_heads, cfg.head_dim)
    half = (S + gen) // 2
    k = mk(2, B, cfg.n_kv_heads, half, cfg.head_dim)[rank].contiguous()
    v = mk(2, B, cfg.n_kv_heads, half, cfg.head_dim)[rank].contiguous()
    env = Env(plan=seq, mesh=mesh)
    rep["fd_merged_err"] = fd_seq_case(
        q, k, v, C._group(env, "model"), C.axis_rank(env, "model"), 2)
    # part (c): the recurrent train step over the same mesh
    arch, layers, steps = MESH_TRAIN
    for op in counted:
        op.launches = 0
    tenv = Env(plan=sharded_plan(), mesh=mesh)
    losses, times, peak = sharded_steps(mesh_cfg(arch, layers), tenv, steps)
    rep.update(losses=losses, step_s=times, peak_gib=peak,
               train_launches={op.__name__: op.launches for op in counted})
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(rep, f)
    dist.destroy_process_group()


def check_mesh_serving(counted):
    """Phase 26: the one-shot serve over the cluster's rendered mesh
    (launch/serve.py run_oneshot: VirtualCluster.submit of serve_batch
    over the DeviceMesh it renders under a process group; prefill and
    decode per rank, models/model.py _Ranks). Part (a), one rank of an
    NCCL group and the 1 x 1 mesh: the CLI `--trace oneshot` under
    torchrun ends with the JAX CLI's lines; each MESH_CASES model's
    tokens and every step's logits (serve_logits) equal the one-device
    one-shot's bit for bit under the replicated layout, #4 and #1 (and
    #6, #7) counted; paper-demo-110m under seq_sharded launches #5, its
    logits along the replicated tokens within MESH_TOL and its tokens
    under the near-tie oracle; #5 merged over the one-rank group against
    its plain version at those shapes, and timed there. Part (b), two
    processes sharing the card over gloo with CUDA tensors (mesh_rank):
    MESH_B_CASES's models over the (1, 2) mesh against one device,
    paper-demo-110m in both layouts; #5 merged across the two ranks against its
    plain version on the same slices. Part (c): rwkv6-1.6b at 2 layers,
    3 sharded steps over that mesh against one device. Counts zeroed
    before each run and read after it, the children's too. Returns
    ({kernel: launches}, #5's seq_sharded row)."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.flash_decode.ops import flash_decode_partials
    from repro_torch.kernels.flash_decode.ref import (
        flash_decode_partials_ref)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.serve import (run_oneshot, serve_batch,
                                          serve_logits)
    from repro_torch.models import model as Mo
    from repro_torch.models.env import SERVE_PLAN, Env
    from repro_torch.parallel import collectives as C

    t0 = time.perf_counter()
    seq = dataclasses.replace(SERVE_PLAN, kv_cache="seq_sharded")
    names = {op: ("flash_decode" if op.__name__ == "flash_decode_partials"
                  else op.__name__) for op in counted}
    launches = {n: 0 for n in names.values()}

    def read(label, want):
        got = {names[op]: op.launches for op in counted}
        for k, n in got.items():
            launches[k] += n
        if any((got[k] > 0) != w for k, w in want.items()):
            fail(f"phase 26 {label}: launches {got}, expected "
                 f"{ {k: 'some' if w else 0 for k, w in want.items()} }")
        return got

    def zero():
        for op in counted:
            op.launches = 0

    # the CLI under torchrun: one NCCL rank, its rendered 1 x 1 mesh
    env_b = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t1 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "1", "-m", "repro_torch.launch.serve",
         "--trace", "oneshot"], capture_output=True, text=True, env=env_b,
        timeout=300)
    # the JAX CLI's last lines: the count and rate, then the sample (numpy
    # wraps its 16 tokens)
    gi = cli.stdout.rfind("generated 384 tokens in ")
    si = cli.stdout.rfind("sample: [")
    if cli.returncode != 0 or not 0 <= gi < si:
        fail(f"serve CLI --trace oneshot under torchrun: exit "
             f"{cli.returncode}, {cli.stdout[-2000:]}{cli.stderr[-2000:]}")
    print(f"serve CLI --trace oneshot under torchrun, one NCCL rank on the "
          f"card ({time.perf_counter() - t1:.1f}s): "
          + " ".join(cli.stdout[gi:].split()))

    store = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    # one device, per (arch, layers): tokens, logits, wall tokens/s, cache
    ref = {}
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_test_mesh(1, model=1)
        for arch, layers, B, S, gen in MESH_CASES:
            cfg = mesh_cfg(arch, layers)
            params = load_params(cfg, 0)
            prompts = mesh_prompts(cfg, B, S)
            kw = dict(streamed_prefill=False)
            tok1 = serve_batch(cfg, params, prompts, gen, **kw)
            lg1 = serve_logits(cfg, params, prompts, tok1, **kw)
            torch.cuda.synchronize()  # warm: timed after two runs
            t1 = time.perf_counter()
            serve_batch(cfg, params, prompts, gen, **kw)
            one_s = time.perf_counter() - t1
            ref[arch, layers] = (tok1, lg1, B * gen / one_s,
                                 kv_bytes(cfg, Env(), B, S + gen))
            kinds = cfg.block_pattern * cfg.num_blocks + cfg.pattern_tail
            want = {"flash_attention": S > 128 and any(
                        k in ("attn", "local") for k in kinds),
                    "paged_flash_decode": any(k in ("attn", "local")
                                              for k in kinds),
                    "rglru_scan": "rglru" in kinds,
                    "wkv6": "rwkv" in kinds, "flash_decode": False,
                    "topk_topp_mask": False,
                    "paged_flash_decode_quant": False}
            zero()
            run = run_oneshot(mesh_args(B, S, gen, 1), cfg, params)
            got = read(f"(a) {arch} replicated", want)
            lgm = serve_logits(cfg, params, prompts, run["tokens"],
                               mesh=mesh, **kw)
            if not (np.array_equal(run["tokens"], tok1)
                    and np.array_equal(lgm, lg1)):
                fail(f"phase 26 (a) {arch}: the 1 x 1 mesh's tokens or "
                     f"logits differ from one device's (tokens equal: "
                     f"{np.array_equal(run['tokens'], tok1)})")
            # warm: the same mesh's groups already carried a run
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            serve_batch(cfg, params, prompts, gen, mesh=mesh, **kw)
            warm_s = time.perf_counter() - t1
            n_tok = B * gen
            cache_b = kv_bytes(cfg, Env(mesh=mesh), B, S + gen)
            print(f"(a) {cfg.name} ({cfg.n_layers} layers, B={B} prompt {S} "
                  f"gen {gen}) over the rendered 1 x 1 NCCL mesh: tokens and "
                  f"all {gen} steps' logits equal one device's bit for bit; "
                  f"wall tokens/s {n_tok / run['wall_s']:.1f} through "
                  f"run_oneshot (a new cluster's mesh: its NCCL "
                  f"communicators start inside), {n_tok / warm_s:.1f} warm "
                  f"on a mesh that served before, {n_tok / one_s:.1f} one "
                  f"device, on {card()}; cache {cache_b} bytes; launches { {k: n for k, n in got.items() if n} }")
            if arch == "paper-demo":
                zero()
                srun = run_oneshot(mesh_args(B, S, gen, 1), cfg, params, seq)
                want = dict(want, flash_decode=True,
                            paged_flash_decode=False)
                got = read("(a) paper-demo seq_sharded", want)
                kws = dict(kw, mesh=mesh, plan=seq)
                own = serve_logits(cfg, params, prompts, srun["tokens"],
                                   **kws)
                forced = serve_logits(cfg, params, prompts, tok1, **kws)
                ok, agreed, parted = near_tie_equal(srun["tokens"], tok1,
                                                    own, lg1)
                err = logit_err(forced, lg1)
                if not ok or err > MESH_TOL:
                    fail(f"phase 26 (a) seq_sharded: near-tie oracle {ok}, "
                         f"logits along the replicated tokens {err:.3e}")
                print(f"(a) {cfg.name} under seq_sharded over the 1 x 1 "
                      f"mesh: logits along the replicated tokens within "
                      f"{err:.3e} of them (tolerance {MESH_TOL}), {parted} "
                      f"of {B} rows part at a near-tie; "
                      f"{n_tok / srun['wall_s']:.1f} tokens/s wall; "
                      f"launches { {k: n for k, n in got.items() if n} }")
            del params
            gc.collect()
            torch.cuda.empty_cache()
        # kernel #5 at the seq_sharded decode shapes, the cache full
        cfg = mesh_cfg("paper-demo", None)
        B, S, gen = MESH_CASES[0][2:]
        fgen = torch.Generator(device="cuda").manual_seed(26)
        mk = lambda *s: torch.randn(s, generator=fgen, device="cuda").to(
            torch.bfloat16)
        q = mk(B, cfg.n_heads, cfg.head_dim)
        rows = []
        for n in (1, 2):  # the (1, 1) mesh's cache, a (1, 2) rank's half
            n_tok = (S + gen) // n
            k = mk(B, cfg.n_kv_heads, n_tok, cfg.head_dim)
            v = mk(B, cfg.n_kv_heads, n_tok, cfg.head_dim)
            cur = torch.tensor([n_tok - 1], dtype=torch.int32, device="cuda")
            o, _, _ = flash_decode_partials(q, k, v, cur)
            ro = flash_decode_partials_ref(q, k, v, cur)[0]
            bound, by = fd_bound_ms(B, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.head_dim, n_tok, 2)
            qs = q[:, :, None, :]
            rows.append({
                "shape": f"B={B} Hq={cfg.n_heads} Hkv={cfg.n_kv_heads} "
                         f"hd={cfg.head_dim} S={n_tok} bf16 (tp {n})",
                "max_abs_err": float((o - ro).abs().max()),
                "ms": device_ms(lambda: flash_decode_partials(q, k, v,
                                                              cur)),
                "plain_ms": device_ms(lambda: flash_decode_partials_ref(
                    q, k, v, cur)),
                "library_ms": device_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qs, k, v, enable_gqa=True)),
                "bound_ms": bound, "bound_by": by})
            if n == 1:
                env = Env(plan=seq, mesh=mesh)
                rows[-1]["merged_err"] = fd_seq_case(
                    q, k, v, C._group(env, "model"), 0, 1)
            print(f"#5 at {rows[-1]['shape']}: {rows[-1]['ms'] * 1e3} us "
                  f"kernel, {rows[-1]['plain_ms'] * 1e3} us plain, "
                  f"{rows[-1]['library_ms'] * 1e3} us SDPA, bound "
                  f"{bound * 1e3} us ({by}), {bound / rows[-1]['ms']:.4f} "
                  f"of the bound; max abs err {rows[-1]['max_abs_err']:.3e}"
                  + (f"; merged over the one-rank group (max abs err, "
                     f"excess) {rows[-1]['merged_err']}" if n == 1 else "")
                  + f" on {card()}")
            if not rows[-1]["max_abs_err"] <= FD_TOL or not rows[0].get(
                    "merged_err", (0.0, 0.0))[1] <= FD_TOL:
                fail(f"phase 26: #5 at {rows[-1]['shape']}: {rows[-1]}")
        del q, k, v
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    # part (b)'s one-device runs not in part (a), part (c)'s one-device
    # losses, then parts (b) and (c) on two ranks
    for arch, layers, B, S, gen in MESH_B_CASES:
        if (arch, layers) not in ref:
            cfg = mesh_cfg(arch, layers)
            params = load_params(cfg, 0)
            prompts = mesh_prompts(cfg, B, S)
            kw = dict(streamed_prefill=False)
            tok1 = serve_batch(cfg, params, prompts, gen, **kw)
            lg1 = serve_logits(cfg, params, prompts, tok1, **kw)
            torch.cuda.synchronize()  # warm: timed after two runs
            t1 = time.perf_counter()
            serve_batch(cfg, params, prompts, gen, **kw)
            one_s = time.perf_counter() - t1
            ref[arch, layers] = (tok1, lg1, B * gen / one_s,
                                 kv_bytes(cfg, Env(), B, S + gen))
            del params
            torch.cuda.empty_cache()
    arch, layers, steps = MESH_TRAIN
    one_losses = sharded_steps(mesh_cfg(arch, layers),
                               Env(plan=sharded_plan()), steps)[0]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_ranks_")
    t1 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "chip_smoke.py"),
         "--mesh-rank", str(r), f"{tmp}/store", f"{tmp}/out"],
        env=env_b, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    logs = []
    for proc in procs:
        try:
            logs.append(proc.communicate(timeout=600)[0])
        finally:
            proc.kill()
    if any(proc.returncode != 0 for proc in procs):
        fail("phase 26 part (b): a rank failed:\n" + "\n".join(
            log[-3000:] for log in logs))
    ranks = []
    for r in range(2):
        with open(f"{tmp}/out.{r}.json") as f:
            ranks.append(json.load(f))
    wall_b = time.perf_counter() - t1
    for arch, layers, B, S, gen in MESH_B_CASES:
        tok1, lg1, one_rate, one_kv = ref[arch, layers]
        for layout in (("replicated", "seq_sharded") if arch == "paper-demo"
                       else ("replicated",)):
            z = np.load(f"{tmp}/out.{arch}.{layout}.npz")
            ok, agreed, parted = near_tie_equal(z["tokens"], tok1,
                                                z["logits"], lg1)
            err = logit_err(z["logits"], lg1, agreed)
            # the seq_sharded run along the replicated run's tokens against
            # the replicated run's logits, both over the mesh
            forced = (logit_err(z["forced"], np.load(
                f"{tmp}/out.{arch}.replicated.npz")["logits"])
                if "forced" in z else None)
            label = f"{arch}/{layout}"
            walls = [rep["wall_s"][label] for rep in ranks]
            warms = [rep["warm_s"][label] for rep in ranks]
            per = [rep["launches"][label] for rep in ranks]
            for p in per:
                for k, n in p.items():
                    launches[k.replace("_partials", "")] += n
            print(f"(b) {mesh_cfg(arch, layers).name} {layout} over the "
                  f"(1, 2) gloo mesh (two processes on the card; a rank's "
                  f"decode cache {ranks[0]['kv_bytes'][label]} bytes, one "
                  f"device's {one_kv}): logits "
                  f"within {err:.3e} of one device's before the first "
                  f"differing token (tolerance {MESH_TOL})"
                  + ("" if forced is None else
                     f", {forced:.3e} of the replicated mesh run's along "
                     f"its tokens")
                  + f"; {parted} of {B} rows part at a near-tie; wall "
                  f"tokens/s {B * gen / max(walls):.1f} through run_oneshot,"
                  f" {B * gen / max(warms):.1f} warm (the slower rank; one "
                  f"device {one_rate:.1f}); launches per rank "
                  f"{[{k: n for k, n in p.items() if n} for p in per]}")
            if not ok or err > MESH_TOL or (forced or 0.0) > MESH_TOL:
                fail(f"phase 26 (b) {label}: near-tie oracle {ok}, logits "
                     f"{err:.3e}, forced {forced}")
            kinds = set(mesh_cfg(arch, layers).block_pattern)
            attn = bool(kinds & {"attn", "local"})
            need = {"wkv6": "rwkv" in kinds, "rglru_scan": "rglru" in kinds,
                    "flash_attention": attn,
                    "paged_flash_decode": attn and (
                        layout == "replicated" or "local" in kinds),
                    "flash_decode_partials": layout == "seq_sharded",
                    "topk_topp_mask": False,
                    "paged_flash_decode_quant": False}
            if any((p[k] > 0) != w for p in per for k, w in need.items()):
                fail(f"phase 26 (b) {label}: launches {per}")
    if any(any(rep["train_launches"].values()) for rep in ranks):
        fail(f"phase 26 (c) launched "
             f"{[rep['train_launches'] for rep in ranks]}")
    merged = [rep["fd_merged_err"] for rep in ranks]
    if not all(e[1] <= FD_TOL for e in merged):
        fail(f"phase 26 (b): #5 merged across two ranks vs plain {merged}")
    b_losses = ranks[0]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(b_losses, one_losses)]
    print(f"(b) #5 merged across the two gloo ranks against its plain "
          f"version on the same slices: (max abs err, excess over "
          f"{FD_MERGED_REL} of the value) {merged} (tolerance {FD_TOL})")
    print(f"(c) {MESH_TRAIN[0]} at {MESH_TRAIN[1]} layers, {MESH_TRAIN[2]} "
          f"sharded steps over the (1, 2) mesh: loss "
          f"{' '.join(f'{x:.6f}' for x in b_losses)}, one device "
          f"{' '.join(f'{x:.6f}' for x in one_losses)} (relative "
          f"{' '.join(f'{e:.2e}' for e in rel)}; tolerance "
          f"{SHARDED_STEP1_TOL:.0e} first, {MESH_LATER_TOL:.0e} after); "
          f"sharded step {_ms(ranks[0]['step_s'])} on {card()}; parts (b) "
          f"and (c) {wall_b:.1f}s with the processes' start")
    if not (ranks[0]["losses"] == ranks[1]["losses"]
            and rel[0] <= SHARDED_STEP1_TOL
            and all(e <= MESH_LATER_TOL for e in rel[1:])):
        fail(f"phase 26 (c): losses {[r['losses'] for r in ranks]} against "
             f"{one_losses}")
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"mesh serving phase: {time.perf_counter() - t0:.1f}s; kernel "
          f"launches {launches}")
    return launches, rows


# phase 27: the modality archs over the cluster's rendered mesh. Part
# (a)'s models at full width and depth, (arch, layers (None: its own
# depth), B, prompt, gen): qwen2-vl-7b's 4 rows of 256 vision + 128 prompt
# positions, whisper-small's 8 prompts of 512 tokens (256 frames: the
# encoder through #4, non-causal)
MODALITY_MESH = (("qwen2-vl-7b", None, 4, 128, 16),
                 ("whisper-small", None, 8, 512, 16))
# ... and part (b)'s over the (1, 2) gloo mesh, gen 8 (the script's time:
# every collective of gloo a host round trip): qwen2-vl-7b at full width
# cut to 4 of its 28 layers, whisper-small to 4 of its 12 decoder layers
MODALITY_MESH_B = (("qwen2-vl-7b", 4, 4, 128, 8),
                   ("whisper-small", 4, 8, 512, 8))
MODALITY_TRAIN = ("whisper-small", 3)  # part (c): arch, sharded steps


def modality_stubs_seeded(cfg, B, S):
    """Seeded nonzero stubs (a VLM's vision embeddings, an
    encoder-decoder's frames) of the whole batch on the card: zero stubs,
    the CLI's, leave whisper's encoder and cross caches zeros."""
    import torch
    from repro_torch.launch.serve import modality_stubs
    gen = torch.Generator(device="cuda").manual_seed(27)
    return {k: torch.randn(v.shape, generator=gen, device="cuda")
            for k, v in modality_stubs(cfg, B, S, "cuda").items()}


def modality_launches_want(cfg, S, gen, layout):
    """The launches one run of the one-shot gives each kernel: #4 once a
    layer of a prefill past 128 positions (the encoder's and the
    decoder's), #1 (replicated) or #5 (seq_sharded) once a decode step and
    attention, cross-attention included."""
    attn = 2 if cfg.is_encdec else 1
    pos = S + (cfg.num_vision_embeds if cfg.family == "vlm" else 0)
    n_flash = cfg.n_layers * (pos > 128) + (
        cfg.encoder_layers * (S // cfg.enc_downsample > 128)
        if cfg.is_encdec else 0)
    n_dec = (gen - 1) * cfg.n_layers * attn
    seq = layout == "seq_sharded"
    return {"flash_attention": n_flash,
            "paged_flash_decode": 0 if seq else n_dec,
            "flash_decode": n_dec if seq else 0,
            "paged_flash_decode_quant": 0, "topk_topp_mask": 0,
            "rglru_scan": 0, "wkv6": 0}


def modality_rank(rank, store, out):
    """Parts (b) and (c) of phase 27, one of two processes sharing the
    card: a gloo group with CUDA tensors and the (1, 2) DeviceMesh a
    VirtualCluster of two nodes renders. For each MODALITY_MESH_B model,
    each layout: run_oneshot over it (zero stubs; counts zeroed before
    and read after), serve_batch and serve_logits on the seeded nonzero
    stubs (the seq_sharded run's logits along the replicated
    tokens too; under seq_sharded the counts are serve_batch's); then
    MODALITY_TRAIN's sharded train steps over a (1, 2) make_test_mesh. Rank 0 writes the tokens and logits (out.<case>.npz),
    every rank its launch counts, the runs' wall times, its decode-cache
    bytes and the losses (out.<rank>.json)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_decode.ops import flash_decode_partials
    from repro_torch.kernels.paged_decode.ops import (
        paged_flash_decode, paged_flash_decode_quant)
    from repro_torch.kernels.rglru.ops import rglru_scan
    from repro_torch.kernels.rwkv6.ops import wkv6
    from repro_torch.kernels.sampling.ops import topk_topp_mask
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.serve import (run_oneshot, serve_batch,
                                          serve_logits)
    from repro_torch.models import model as Mo
    from repro_torch.models.env import SERVE_PLAN, Env

    counted = (paged_flash_decode, paged_flash_decode_quant, topk_topp_mask,
               flash_attention, rglru_scan, wkv6, flash_decode_partials)
    name = lambda op: ("flash_decode" if op is flash_decode_partials
                       else op.__name__)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=2)
    mesh = make_test_mesh(2, model=2)
    rep = {"wall_s": {}, "launches": {}, "kv_bytes": {}}
    for arch, layers, B, S, gen in MODALITY_MESH_B:
        cfg = mesh_cfg(arch, layers)
        params = Mo.init_params(cfg, Env(), seed=0, device="cuda")
        prompts = mesh_prompts(cfg, B, S)
        stubs = modality_stubs_seeded(cfg, B, S)
        toks = None
        for layout in ("replicated", "seq_sharded"):
            plan = dataclasses.replace(SERVE_PLAN, kv_cache=layout)
            label = f"{arch}/{layout}"
            kw = dict(streamed_prefill=False, mesh=mesh, plan=plan,
                      stubs=stubs)
            for op in counted:
                op.launches = 0
            t1 = time.perf_counter()
            if layout == "replicated":  # the cluster's rendered mesh
                run_oneshot(mesh_args(B, S, gen, 2), cfg, params, plan)
            else:  # serve_batch over the mesh, on the seeded stubs
                got = serve_batch(cfg, params, prompts, gen, **kw)
            rep["wall_s"][label] = time.perf_counter() - t1
            rep["launches"][label] = {name(op): op.launches
                                      for op in counted}
            n = S + gen + (cfg.num_vision_embeds if cfg.family == "vlm"
                           else 0)
            rep["kv_bytes"][label] = kv_bytes(cfg, Env(plan=plan, mesh=mesh),
                                              B, n)
            if layout == "replicated":
                got = serve_batch(cfg, params, prompts, gen, **kw)
            res = {"tokens": got, "logits": serve_logits(
                cfg, params, prompts, got, **kw)}
            if layout == "replicated":
                toks = got
            else:
                res["forced"] = serve_logits(cfg, params, prompts, toks,
                                             **kw)
            if rank == 0:
                np.savez(f"{out}.{arch}.{layout}.npz", **res)
        del params
        torch.cuda.empty_cache()
    arch, steps = MODALITY_TRAIN
    for op in counted:
        op.launches = 0
    tenv = Env(plan=sharded_plan(), mesh=mesh)
    losses, times, peak = sharded_steps(mesh_cfg(arch, None), tenv, steps)
    rep.update(losses=losses, step_s=times, peak_gib=peak,
               train_launches={name(op): op.launches for op in counted})
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(rep, f)
    dist.destroy_process_group()


def check_mesh_modality(counted):
    """Phase 27: the modality archs over the cluster's rendered mesh
    (run_oneshot: serve_batch submitted over the DeviceMesh; the vision
    rows and whisper's encoder per rank, the cross caches in the KV
    layout). Part (a), one NCCL rank and the 1 x 1 mesh: the serve CLI
    `--arch whisper-small --trace oneshot` (8 requests, gen 8) under
    torchrun ends with the JAX CLI's lines; each MODALITY_MESH model at full width and depth
    through run_oneshot (zero stubs, the CLI's: its tokens the one-device
    one-shot's, #4 and #1 counted), then on seeded nonzero stubs the
    mesh's tokens and every step's logits equal the one device's bit for
    bit under the replicated layout; under seq_sharded serve_batch over
    the mesh launches #5 on the self- and cross-attention decode and #1
    not, the logits along the replicated tokens within MESH_TOL and the
    tokens under the near-tie oracle; #5 at whisper's cross caches (256 frames,
    and a (1, 2) rank's 128, every frame valid) against its plain
    version, merged over the one-rank group, timed beside its plain
    version, SDPA and its bound. Part (b), two processes sharing the card
    over gloo (modality_rank): MODALITY_MESH_B's models over the (1, 2)
    mesh in both layouts against one device on the same stubs, each
    rank's decode-cache bytes (the cross caches included). Part (c):
    whisper-small's sharded train step over that mesh against one device
    (the first loss within twice the spread that f32 products give the
    one-device loss, or SHARDED_STEP1_TOL). Counts zeroed before each run and read after it, the
    children's too. Returns ({kernel: launches}, #5's cross rows)."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.flash_decode.ops import flash_decode_partials
    from repro_torch.kernels.flash_decode.ref import (
        flash_decode_partials_ref)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.serve import (run_oneshot, serve_batch,
                                          serve_logits)
    from repro_torch.models.env import SERVE_PLAN, Env
    from repro_torch.parallel import collectives as C

    t0 = time.perf_counter()
    seq = dataclasses.replace(SERVE_PLAN, kv_cache="seq_sharded")
    names = {op: ("flash_decode" if op.__name__ == "flash_decode_partials"
                  else op.__name__) for op in counted}
    launches = {n: 0 for n in names.values()}

    def read(label, want):
        got = {names[op]: op.launches for op in counted}
        for k, n in got.items():
            launches[k] += n
        if got != want:
            fail(f"phase 27 {label}: launches {got}, expected {want}")
        return got

    def zero():
        for op in counted:
            op.launches = 0

    env_b = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    store = tempfile.mkdtemp(prefix="chip_smoke_modality_")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    ref = {}  # (arch, layers): one device's tokens and logits, nonzero stubs
    rows = []
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_test_mesh(1, model=1)
        for arch, layers, B, S, gen in MODALITY_MESH:
            cfg = mesh_cfg(arch, layers)
            params = load_params(cfg, 0)
            prompts = mesh_prompts(cfg, B, S)
            stubs = modality_stubs_seeded(cfg, B, S)
            kw = dict(streamed_prefill=False)
            tok1 = serve_batch(cfg, params, prompts, gen, stubs=stubs, **kw)
            lg1 = serve_logits(cfg, params, prompts, tok1, stubs=stubs, **kw)
            torch.cuda.synchronize()  # warm: timed after two runs
            t1 = time.perf_counter()
            tok0 = serve_batch(cfg, params, prompts, gen, **kw)  # zero stubs
            one_s = time.perf_counter() - t1
            ref[arch, layers, gen] = (tok1, lg1)
            zero()
            run = run_oneshot(mesh_args(B, S, gen, 1), cfg, params)
            got = read(f"(a) {arch} replicated",
                       modality_launches_want(cfg, S, gen, "replicated"))
            kwm = dict(kw, mesh=mesh, stubs=stubs)
            torch.cuda.synchronize()  # warm: the mesh served before
            t1 = time.perf_counter()
            tokm = serve_batch(cfg, params, prompts, gen, **kwm)
            warm_s = time.perf_counter() - t1
            lgm = serve_logits(cfg, params, prompts, tokm, **kwm)
            if not (np.array_equal(run["tokens"], tok0)
                    and np.array_equal(tokm, tok1)
                    and np.array_equal(lgm, lg1)):
                fail(f"phase 27 (a) {arch}: the 1 x 1 mesh's tokens or "
                     f"logits differ from one device's (run_oneshot "
                     f"{np.array_equal(run['tokens'], tok0)}, seeded stubs "
                     f"{np.array_equal(tokm, tok1)})")
            n_tok = B * gen
            vis = (f"{cfg.num_vision_embeds} vision + "
                   if cfg.family == "vlm" else "")
            print(f"(a) {cfg.name} ({cfg.n_layers} layers, B={B}, {vis}"
                  f"prompt {S}, gen {gen}) over the rendered 1 x 1 NCCL "
                  f"mesh: run_oneshot's tokens equal one device's, and on "
                  f"seeded stubs the tokens and all {gen} steps' logits bit "
                  f"for bit; wall tokens/s {n_tok / run['wall_s']:.1f} "
                  f"through run_oneshot, {n_tok / warm_s:.1f} warm, "
                  f"{n_tok / one_s:.1f} one device, on {card()}; launches "
                  f"{ {k: n for k, n in got.items() if n} }")
            kws = dict(kwm, plan=seq)
            zero()
            t1 = time.perf_counter()
            stok = serve_batch(cfg, params, prompts, gen, **kws)
            seq_s = time.perf_counter() - t1
            got = read(f"(a) {arch} seq_sharded",
                       modality_launches_want(cfg, S, gen, "seq_sharded"))
            own = serve_logits(cfg, params, prompts, stok, **kws)
            forced = serve_logits(cfg, params, prompts, tok1, **kws)
            ok, _, parted = near_tie_equal(stok, tok1, own, lg1)
            err = logit_err(forced, lg1)
            if not ok or err > MESH_TOL:
                fail(f"phase 27 (a) {arch} seq_sharded: near-tie oracle "
                     f"{ok}, logits along the replicated tokens {err:.3e}")
            print(f"(a) {cfg.name} under seq_sharded over the 1 x 1 mesh "
                  f"(#5 on the self- and cross-attention decode): logits "
                  f"along the replicated tokens within {err:.3e} of them "
                  f"(tolerance {MESH_TOL}), {parted} of {B} rows part at a "
                  f"near-tie; {n_tok / seq_s:.1f} tokens/s wall "
                  f"(serve_batch, warm); launches "
                  f"{ {k: n for k, n in got.items() if n} }")
            del params
            gc.collect()
            torch.cuda.empty_cache()
        # kernel #5 at whisper-small's cross caches under seq_sharded: every
        # head's q, the frames the rank holds, every one valid (no write)
        cfg = mesh_cfg("whisper-small", None)
        B, S = MODALITY_MESH[1][2:4]
        se = S // cfg.enc_downsample
        fgen = torch.Generator(device="cuda").manual_seed(27)
        mk = lambda *s: torch.randn(s, generator=fgen, device="cuda").to(
            torch.bfloat16)
        q = mk(B, cfg.n_heads, cfg.head_dim)
        for n in (1, 2):  # the (1, 1) mesh's cross cache, a (1, 2) rank's
            n_tok = se // n
            k = mk(B, cfg.n_kv_heads, n_tok, cfg.head_dim)
            v = mk(B, cfg.n_kv_heads, n_tok, cfg.head_dim)
            cur = torch.tensor([n_tok - 1], dtype=torch.int32, device="cuda")
            o, _, _ = flash_decode_partials(q, k, v, cur)
            ro = flash_decode_partials_ref(q, k, v, cur)[0]
            bound, by = fd_bound_ms(B, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.head_dim, n_tok, 2)
            qs = q[:, :, None, :]
            rows.append({
                "shape": f"B={B} Hq={cfg.n_heads} Hkv={cfg.n_kv_heads} "
                         f"hd={cfg.head_dim} Se={n_tok} bf16 cross (tp {n})",
                "max_abs_err": float((o - ro).abs().max()),
                "ms": device_ms(lambda: flash_decode_partials(q, k, v,
                                                              cur)),
                "plain_ms": device_ms(lambda: flash_decode_partials_ref(
                    q, k, v, cur)),
                "library_ms": device_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qs, k, v)),
                "bound_ms": bound, "bound_by": by})
            if n == 1:
                env = Env(plan=seq, mesh=mesh)
                rows[-1]["merged_err"] = fd_seq_case(
                    q, k, v, C._group(env, "model"), 0, 1)
            print(f"#5 at {rows[-1]['shape']}: {rows[-1]['ms'] * 1e3} us "
                  f"kernel, {rows[-1]['plain_ms'] * 1e3} us plain, "
                  f"{rows[-1]['library_ms'] * 1e3} us SDPA, bound "
                  f"{bound * 1e3} us ({by}), {bound / rows[-1]['ms']:.4f} "
                  f"of the bound; max abs err {rows[-1]['max_abs_err']:.3e}"
                  + (f"; merged over the one-rank group (max abs err, "
                     f"excess) {rows[-1]['merged_err']}" if n == 1 else "")
                  + f" on {card()}")
            if not rows[-1]["max_abs_err"] <= FD_TOL or not rows[0].get(
                    "merged_err", (0.0, 0.0))[1] <= FD_TOL:
                fail(f"phase 27: #5 at {rows[-1]['shape']}: {rows[-1]}")
        del q, k, v
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 27 part (a): {time.perf_counter() - t0:.1f}s")
    # the serve CLI under torchrun (one NCCL rank), its start and its
    # communicator's overlapping the one-device runs below and parts (b)
    # and (c), whose wall times it may stretch (nothing of it is timed)
    t_cli = time.perf_counter()
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "1", "-m", "repro_torch.launch.serve",
         "--arch", "whisper-small", "--trace", "oneshot", "--requests",
         "8", "--gen", "8"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env_b)
    # a failure below exits through fail(): stop the CLI then too (torchrun
    # passes SIGTERM on to its worker)
    atexit.register(lambda: cli.poll() is None and cli.terminate())
    # part (b)'s one-device runs, part (c)'s one-device losses, then parts
    # (b) and (c) on two ranks
    for arch, layers, B, S, gen in MODALITY_MESH_B:
        if (arch, layers, gen) not in ref:
            cfg = mesh_cfg(arch, layers)
            params = load_params(cfg, 0)
            prompts = mesh_prompts(cfg, B, S)
            stubs = modality_stubs_seeded(cfg, B, S)
            kw = dict(streamed_prefill=False, stubs=stubs)
            tok1 = serve_batch(cfg, params, prompts, gen, **kw)
            lg1 = serve_logits(cfg, params, prompts, tok1, **kw)
            ref[arch, layers, gen] = (tok1, lg1)
            del params
            torch.cuda.empty_cache()
    # part (c)'s one-device losses, and their first against the same
    # step with every bf16 product taken in f32 and rounded once, as the
    # tp > 1 row products are: the rounding spread its first loss is held
    # to (whisper-small's 24 layers of self-, cross-attention and MLP
    # products part the sharded loss by more than SHARDED_STEP1_TOL)
    from repro_torch.models import layers as L
    arch, steps = MODALITY_TRAIN
    one_losses = sharded_steps(mesh_cfg(arch, None),
                               Env(plan=sharded_plan()), steps)[0]
    bf16_matmul = L._bf16_matmul
    L._bf16_matmul = lambda a, b: (a.float() @ b.float()).to(a.dtype)
    try:
        f32_loss = sharded_steps(mesh_cfg(arch, None),
                                 Env(plan=sharded_plan()), 1)[0][0]
    finally:
        L._bf16_matmul = bf16_matmul
    spread = abs(f32_loss - one_losses[0]) / abs(one_losses[0])
    step1_tol = max(SHARDED_STEP1_TOL, 2 * spread)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_modality_ranks_")
    t1 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "chip_smoke.py"),
         "--modality-rank", str(r), f"{tmp}/store", f"{tmp}/out"],
        env=env_b, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    logs = []
    for proc in procs:
        try:
            logs.append(proc.communicate(timeout=600)[0])
        finally:
            proc.kill()
    if any(proc.returncode != 0 for proc in procs):
        fail("phase 27 part (b): a rank failed:\n" + "\n".join(
            log[-3000:] for log in logs))
    ranks = []
    for r in range(2):
        with open(f"{tmp}/out.{r}.json") as f:
            ranks.append(json.load(f))
    wall_b = time.perf_counter() - t1
    for arch, layers, B, S, gen in MODALITY_MESH_B:
        cfg = mesh_cfg(arch, layers)
        tok1, lg1 = ref[arch, layers, gen]
        for layout in ("replicated", "seq_sharded"):
            label = f"{arch}/{layout}"
            z = np.load(f"{tmp}/out.{arch}.{layout}.npz")
            ok, agreed, parted = near_tie_equal(z["tokens"], tok1,
                                                z["logits"], lg1)
            err = logit_err(z["logits"], lg1, agreed)
            forced = (logit_err(z["forced"], np.load(
                f"{tmp}/out.{arch}.replicated.npz")["logits"])
                if "forced" in z else None)
            per = [rep["launches"][label] for rep in ranks]
            for p in per:
                for k, n in p.items():
                    launches[k] += n
            want = modality_launches_want(cfg, S, gen, layout)
            walls = [rep["wall_s"][label] for rep in ranks]
            print(f"(b) {cfg.name} ({cfg.n_layers} layers) {layout} over "
                  f"the (1, 2) gloo mesh (two processes on the card; a "
                  f"rank's decode cache {ranks[0]['kv_bytes'][label]} "
                  f"bytes, the cross caches included): logits within "
                  f"{err:.3e} of one device's before the first differing "
                  f"token (tolerance {MESH_TOL})"
                  + ("" if forced is None else
                     f", {forced:.3e} of the replicated mesh run's along "
                     f"its tokens")
                  + f"; {parted} of {B} rows part at a near-tie; wall "
                  f"tokens/s {B * gen / max(walls):.1f} through "
                  f"{'run_oneshot' if layout == 'replicated' else 'serve_batch'}"
                  f" (the slower rank) on {card()}; launches per rank "
                  f"{[{k: n for k, n in p.items() if n} for p in per]}")
            if not ok or err > MESH_TOL or (forced or 0.0) > MESH_TOL:
                fail(f"phase 27 (b) {label}: near-tie oracle {ok}, logits "
                     f"{err:.3e}, forced {forced}")
            if any(p != want for p in per):
                fail(f"phase 27 (b) {label}: launches {per}, expected "
                     f"{want}")
    if any(any(rep["train_launches"].values()) for rep in ranks):
        fail(f"phase 27 (c) launched "
             f"{[rep['train_launches'] for rep in ranks]}")
    b_losses = ranks[0]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(b_losses, one_losses)]
    print(f"(c) {MODALITY_TRAIN[0]}, {MODALITY_TRAIN[1]} sharded steps "
          f"over the (1, 2) mesh (seeded frames): loss "
          f"{' '.join(f'{x:.6f}' for x in b_losses)}, one device "
          f"{' '.join(f'{x:.6f}' for x in one_losses)} (relative "
          f"{' '.join(f'{e:.2e}' for e in rel)}; tolerance {step1_tol:.2e} "
          f"first: twice the one-device loss's spread with f32 products, "
          f"{spread:.2e}, or {SHARDED_STEP1_TOL:.0e}; {MESH_LATER_TOL:.0e} "
          f"after); "
          f"sharded step {_ms(ranks[0]['step_s'])}, peak "
          f"{ranks[0]['peak_gib']:.2f} GiB a rank, on {card()}; parts (b) "
          f"and (c) {wall_b:.1f}s with the processes' start")
    if not (ranks[0]["losses"] == ranks[1]["losses"]
            and rel[0] <= step1_tol
            and all(e <= MESH_LATER_TOL for e in rel[1:])):
        fail(f"phase 27 (c): losses {[r['losses'] for r in ranks]} against "
             f"{one_losses}")
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        out, err = cli.communicate(timeout=300)
    finally:
        cli.kill()
    gi = out.rfind("generated 64 tokens in ")
    si = out.rfind("sample: [")
    if cli.returncode != 0 or not 0 <= gi < si:
        fail(f"serve CLI --arch whisper-small --trace oneshot under "
             f"torchrun: exit {cli.returncode}, {out[-2000:]}{err[-2000:]}")
    print(f"serve CLI --arch whisper-small --trace oneshot under torchrun, "
          f"one NCCL rank on the card (ended "
          f"{time.perf_counter() - t_cli:.1f}s after its start, beside parts "
          f"(b) and (c)): " + " ".join(out[gi:].split()))
    print(f"modality mesh phase: {time.perf_counter() - t0:.1f}s; kernel "
          f"launches {launches}")
    return launches, rows


# phase 28: the lines the JAX package's examples print on the CPU
# (examples/*.py; tests/test_torch_examples.py holds the port's CPU runs
# to the JAX runs themselves), which the port's examples must print on
# the card: node lists, hostfiles, epochs, counters, the autoscaler's
# timeline in simulated time, the verdicts
EXAMPLE_LINES = {
    "quickstart": [
        "[2] nodes registered: ['compute001', 'compute002']",
        "# epoch 1; rendered from hpc-node catalog",
        "compute001 slots=1  # simnet://compute001?devices=0 role=compute",
        "compute002 slots=1  # simnet://compute002?devices=0 role=compute",
        "head000 slots=0  # simnet://head000?devices= role=head",
        "[4] 16-domain job result: 512.0000",
        "done; checkpoints at steps [20]"],
    "elastic_scaling": [
        "--- scaling to 4 nodes (epoch 1 -> ...) ---",
        "--- scaling to 3 nodes (epoch 2 -> ...) ---",
        "epoch_changes=3 reshards=2 steps_lost=0 (expected 0: planned "
        "changes)"],
    "fault_tolerance": [
        "trained to step 7; durable ckpt at 5",
        "--- CRASH compute004 (stops heartbeating; no dereg) ---",
        "recovered on 3 nodes at step 6; rolled back 2 steps (restores=1)",
        "--- STRAGGLER: one node reports 5x step times ---",
        "straggler compute001 replaced; nodes=['compute002', 'compute003', "
        "'compute005'] step=8",
        "fault-tolerance demo OK"],
    "serve_demo": [line for verdict in (
        "verify vs streamed-prefill one-shot baseline: token-for-token "
        "MATCH",
        "verify seeded sampling (4 vs 2 slots): bit-identical MATCH")
        for line in (
            "  t=   0.05s  nodes=1  queue=0  p95=0ms  occ=0.00",
            "  t=   0.80s  nodes=2  queue=3  p95=0ms  occ=1.00",
            "  t=   1.17s  nodes=3  queue=5  p95=732ms  occ=1.00",
            "  t=   1.49s  nodes=4  queue=8  p95=713ms  occ=1.00",
            "  t=   1.80s  nodes=3  queue=5  p95=729ms  occ=1.00",
            "  t=   2.12s  nodes=1  queue=0  p95=718ms  occ=1.00",
            "autoscale: start=1 peak=4 final=1 (5 actions)",
            "p50=630ms p95=1121ms tokens/s(sim)=138.6", verdict)],
}
# the elastic example's nodes and epoch at each of its 20 steps
ELASTIC_EXAMPLE_STEPS = [(2, 1)] * 5 + [(4, 2)] * 7 + [(3, 3)] * 8
# phase 28's timed steps: median over STEP_REPS after STEP_WARM warmups
STEP_WARM, STEP_REPS = 2, 7


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def timed_steps(run):
    """Wall seconds of STEP_REPS calls of run() after STEP_WARM, each
    between two synchronisations of the card."""
    import torch
    times = []
    for i in range(STEP_WARM + STEP_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(i)
        torch.cuda.synchronize()
        if i >= STEP_WARM:
            times.append(time.perf_counter() - t0)
    return times


def bound_line(label, rep, t, peak):
    """Print a step's median wall time against its analytic bound;
    returns (share of the bound, mfu)."""
    rates = rep["rates"]
    share = rep["step_s_lower"] / t
    mfu = rep["model_flops_global"] / (t * rates["bf16_flops"])
    print(f"{label}: median step {t * 1e3:.3f} ms over {STEP_REPS} steps; "
          f"bound {rep['step_s_lower'] * 1e3:.4f} ms ({rep['dominant']}: "
          f"compute {rep['compute_s'] * 1e3:.4f}, memory "
          f"{rep['memory_s'] * 1e3:.4f} ms), share of the bound "
          f"{share:.5f}, mfu {mfu:.5f} (model flops "
          f"{rep['model_flops_global']:.4e}, executed "
          f"{rep['analytic_flops_global']:.4e}); modeled resident "
          f"{rep['memory']['resident_bytes_per_device'] / 1e9:.3f} GB, "
          f"max_memory_allocated {peak / 1e9:.3f} GB; on {card()}")
    if not share <= 1.05:
        fail(f"{label}: {share:.3f} of the analytic bound: the count is "
             "wrong")
    return share, mfu


def check_roofline_steps(counted, dev):
    """Phase 28 (b): paper-demo-110m's train step (B=8 S=128, phase 20's
    plan) and qwen2-1.5b's contiguous-cache decode step (B=8, a
    2048-position cache, through #1) at full width and depth, each
    step's median wall time against launch/roofline.py's bound for the
    same configuration on one device; the memory model's weight,
    gradient and optimizer bytes held to what the port allocates, the
    optimizer's less the formula's known excess (formula_excess)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.paged_decode.ops import paged_flash_decode
    from repro_torch.launch import roofline as RF
    from repro_torch.launch.memory_model import formula_excess, tree_bytes
    from repro_torch.launch.steps import make_decode_step, make_train_step
    from repro_torch.models import model as Mo
    from repro_torch.models.env import Env
    from repro_torch.optim.adamw import (AdamWConfig, make_train_state,
                                         value_and_grad)

    out = {}
    # the train step
    cfg = get_config("paper-demo")
    env = train_env()
    opt = AdamWConfig(lr=1e-3, warmup_steps=0, weight_decay=0.0)
    params = load_params(cfg, seed=0, device=dev)
    batch = train_batch(cfg, 8, 128, dev)
    rep = RF.analyze(cfg, ShapeConfig("train_b8_s128", 128, 8, "train"),
                     env, opt)
    _, grads = value_and_grad(lambda p: Mo.lm_loss(p, batch, cfg, env),
                              params)
    state = make_train_state(params, opt)
    allocated = {"weights": tree_bytes(params), "grads": tree_bytes(grads),
                 "opt": tree_bytes(state["opt"])}
    del grads
    modeled = rep["memory"]["train_state_bytes_per_device"]
    excess = formula_excess(params, 12.0)
    del params
    print(f"paper-demo-110m train state: modeled {modeled}, allocated "
          f"{allocated}; the formula's optimizer bytes exceed the "
          f"allocation by {excess:.0f} (f32 leaves counted as two bf16 "
          "parameters; no step counter)")
    if (modeled["weights"] != allocated["weights"]
            or modeled["grads"] != allocated["grads"]
            or modeled["opt"] - excess != allocated["opt"]):
        fail(f"train state: modeled {modeled} less {excess:.0f} of the "
             f"optimizer's != allocated {allocated}")
    step = make_train_step(cfg, env, opt)
    box = {"state": state}

    def train(i):
        box["state"], m = step(box["state"], batch)

    torch.cuda.reset_peak_memory_stats()
    before = _launch_counts(counted)
    t = _median(timed_steps(train))
    peak = torch.cuda.max_memory_allocated()
    if _launch_counts(counted) != before:
        fail("the train step launched a kernel")
    out["train"] = bound_line("paper-demo-110m train B=8 S=128", rep, t,
                              peak)
    del box, state, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    # the decode step through #1
    cfg = get_config("qwen2-1.5b")
    B, Smax = 8, 2048
    params = load_params(cfg, seed=0, device=dev)
    cache = Mo.init_cache(cfg, Env(), B, Smax, device=dev)
    rep = RF.analyze(cfg, ShapeConfig("decode_b8_2048", Smax, B, "decode"),
                     Env())
    step = make_decode_step(cfg, Env())
    tok = torch.randint(0, cfg.vocab_size, (B, 1), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(3)).to(dev)
    n = STEP_WARM + STEP_REPS
    # the last positions of the cache: each step attends over ~2040
    cur = [torch.full((B,), Smax - n + i, dtype=torch.int32, device=dev)
           for i in range(n)]

    def decode(i):
        step(params, cache, tok, cur[i])

    for op in counted:
        op.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t = _median(timed_steps(decode))
    peak = torch.cuda.max_memory_allocated()
    launched = _launch_counts(counted)
    want = n * cfg.n_layers
    if launched.pop("paged_flash_decode") != want or any(launched.values()):
        fail(f"the decode steps launched {_launch_counts(counted)}, "
             f"expected {want} of paged_flash_decode alone")
    out["decode"] = bound_line("qwen2-1.5b decode B=8, 2048-position "
                               "cache", rep, t, peak)
    out["decode_launches"] = want
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_example(name, argv):
    """One example's main(argv) in this process, its output captured;
    fails unless it exits 0 and prints every line EXAMPLE_LINES holds
    for it (in order)."""
    import contextlib
    import importlib
    import io
    module = importlib.import_module(f"repro_torch.examples.{name}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    missing, at = [], 0
    for want in EXAMPLE_LINES[name]:  # in order
        if want in lines[at:]:
            at += lines[at:].index(want) + 1
        else:
            missing.append(want)
    if rc != 0 or missing:
        print(buf.getvalue()[-4000:])
        fail(f"example {name}: rc {rc}, lines missing {missing}")
    print(f"example {name} {' '.join(argv)}: exit 0, its "
          f"{len(EXAMPLE_LINES[name])} JAX lines printed, {wall:.1f}s")
    return lines


def check_examples(counted, dev):
    """Phase 28 (c): the four examples on the card at short step counts
    (the quickstart at 20), each ending with the JAX example's lines;
    the serve demo's two verdicts MATCH with #1 and #2 launched (counts
    zeroed before it and read after, its verify passes included)."""
    import re
    import tempfile
    root = os.path.join(HERE, "build")
    os.makedirs(root, exist_ok=True)
    ckpt = lambda: ["--device", str(dev), "--ckpt-dir",
                    tempfile.mkdtemp(dir=root)]
    run_example("quickstart", ["--steps", "20"] + ckpt())
    lines = run_example("elastic_scaling", ckpt())
    got = [tuple(int(x) for x in re.findall(r"nodes=(\d+) epoch=(\d+)",
                                           l)[0])
           for l in lines if l.startswith("step ")]
    if got != ELASTIC_EXAMPLE_STEPS:
        fail(f"elastic_scaling: nodes and epochs {got}")
    run_example("fault_tolerance", ckpt())
    for op in counted:
        op.launches = 0
    run_example("serve_demo", ["--device", str(dev)])
    launched = _launch_counts(counted)
    if not launched["paged_flash_decode"] or not launched["topk_topp_mask"]:
        fail(f"the serve demo launched {launched}")
    print(f"serve demo launches: {launched}")
    return launched


def check_dryrun(counted, dev):
    """Phase 28: (a) the dry run over both production meshes on the
    card's rates with the card's own memory; (b) two full-size steps
    against their bound; (c) the four examples."""
    import torch
    from repro_torch.configs import cells
    from repro_torch.launch import dryrun
    cap = torch.cuda.get_device_properties(0).total_memory
    t0 = time.perf_counter()
    todo = [(a, s) for a, s, tag in cells() if tag == "run"]
    reports, failures = dryrun.run(
        todo, ["single", "multi"], os.path.join(HERE, "reports",
                                                "dryrun_torch"),
        capacity_bytes=cap)
    n_ok = sum(len(r) for r in reports.values())
    if failures or n_ok != 2 * len(todo):
        fail(f"dry run: {n_ok} cells, failures {failures}")
    unfit = [f"{r['arch']} {r['shape']} {tag}"
             for tag, reps in reports.items() for r in reps
             if not r["memory"]["fits_device"]]
    print(f"dry run: {n_ok} cells OK over both meshes in "
          f"{time.perf_counter() - t0:.1f}s, fit against {cap / 1e9:.2f} GB "
          f"(total_memory of {card()}); cells that do not fit: "
          f"{unfit or 'none'}")
    steps = check_roofline_steps(counted, dev)
    demo = check_examples(counted, dev)
    launches = dict(demo)
    launches["paged_flash_decode"] += steps["decode_launches"]
    return launches, steps


# phase 29: the serving engines over the cluster's rendered mesh. Part
# (a)'s recurrent archs (arch, layers, the trace's requests, prompt, gen,
# slots): recurrentgemma-9b at 5 layers (one (rglru, rglru, local) unit
# and the rglru tail pair: #6, #1 over its rings), rwkv6-1.6b at 2
MESH_ENGINE_RECURRENT = (("recurrentgemma-9b", 5, 8, 64, 16, 4),
                         ("rwkv6-1.6b", 2, 8, 64, 16, 4))
# part (b)'s (1, 2) mesh: (arch, layers, requests, prompt, gen, slots).
# Its classic admission (recurrentgemma-9b's batch-1 prefills) is held to
# the full-prefill one-shot of all 8 prompts over the same mesh: the
# per-rank prefill pads each sequence to whole row tiles at every tp
# degree (models/model.py _Ranks), so a prompt's rows do not depend on
# the batch around it (phase 30 (b) checks the rows themselves)
MESH_ENGINE_B = (("paper-demo", None, 4, 64, 8, 4),
                 ("recurrentgemma-9b", 5, 8, 64, 8, 4))


def layer_kinds(cfg):
    """The block kinds cfg's layers hold (a cut depth may hold no full
    pattern unit)."""
    return set(cfg.block_pattern * cfg.num_blocks + cfg.pattern_tail)


def recurrent_args(requests, prompt, gen, slots):
    return serve_args(["--requests", str(requests), "--prompt-len",
                       str(prompt), "--gen", str(gen), "--slots", str(slots)])


def mesh_engine_rank(rank, store, out):
    """Part (b) of phase 29, one of two processes sharing the card: a gloo
    group with CUDA tensors and the (1, 2) DeviceMesh a VirtualCluster of
    two nodes renders. Each MESH_ENGINE_B model served through a
    ServingEngine over that mesh (counts zeroed before, read after), then
    the one-shot over the same mesh on the same prompts: streamed where
    the engine admits by lanes, else by full prefill of them all. Every
    rank
    writes its tokens, the one-shot's, its launch counts, its pool's KV
    heads and the wall times (out.<rank>.json)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import VirtualCluster
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_decode.ops import flash_decode_partials
    from repro_torch.kernels.paged_decode.ops import (
        paged_flash_decode, paged_flash_decode_quant)
    from repro_torch.kernels.rglru.ops import rglru_scan
    from repro_torch.kernels.rwkv6.ops import wkv6
    from repro_torch.kernels.sampling.ops import topk_topp_mask
    from repro_torch.launch.serve import serve, serve_batch
    from repro_torch.models import model as Mo
    from repro_torch.models.env import Env

    counted = (paged_flash_decode, paged_flash_decode_quant, topk_topp_mask,
               flash_attention, rglru_scan, wkv6, flash_decode_partials)
    name = lambda op: ("flash_decode" if op is flash_decode_partials
                       else op.__name__)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=2)
    cluster = VirtualCluster(n_compute=2, devices_per_node=1, device="cuda")
    mesh = cluster.rendering.mesh
    rep = {"mesh": list(mesh.shape), "cases": {}}
    for arch, layers, n, S, gen, slots in MESH_ENGINE_B:
        cfg = mesh_cfg(arch, layers)
        params = Mo.init_params(cfg, Env(), seed=0, device="cuda")
        for op in counted:
            op.launches = 0
        run = serve(recurrent_args(n, S, gen, slots), cfg, params, mesh)
        launches = {name(op): op.launches for op in counted}
        engine, trace, res = run["engine"], run["trace"], run["out"]
        k = engine.pool.caches["blocks"][-1].get("k")
        streamed = engine.prefill_chunk > 0
        prompts = np.stack([r.prompt for r in trace])
        kw = dict(streamed_prefill=streamed, mesh=mesh)
        base = serve_batch(cfg, params, prompts, gen, **kw)
        rep["cases"][arch] = {
            "tokens": [res[r.rid] for r in trace], "oneshot": base.tolist(),
            "streamed": streamed,
            "launches": launches, "wall_s": run["wall_s"],
            "kv_heads": None if k is None else int(k.shape[2])}
        del engine, params
        torch.cuda.empty_cache()
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(rep, f)
    dist.destroy_process_group()


def check_mesh_engines(counted, phase3, phase10):
    """Phase 29: the serving engines over the cluster's rendered mesh
    (serve/scheduler.py ServingEngine and serve/router.py ReplicaSet with
    mesh=, per rank). Part (a), one rank of an NCCL group and the 1 x 1
    mesh VirtualCluster(n_compute=1) renders under it, paper-demo-110m at
    full width and depth: phase 3's trace (greedy, prefix cache on) with
    phase 3's tokens (`phase3`: (rid -> tokens, wall tokens/s)); phase 4's
    seeded trace at 8 and 4 slots, bit-identical; the int8 pool as a
    2-replica ReplicaSet under VirtualCluster.serve through a scale-up
    and a scale-down, bit-identical to one engine; the slot pool by
    classic admission at prompt 256 (#4) with phase 10's tokens
    (`phase10`); recurrentgemma-9b at 5 layers and rwkv6-1.6b at 2 by
    classic admission, equal to the same engine without a mesh. Part
    (b), two processes sharing the card over gloo and the (1, 2) mesh
    (mesh_engine_rank): paper-demo-110m (4 requests) and
    recurrentgemma-9b at 5 layers (8, classic), both ranks' tokens equal
    and equal to the one-shot over the same mesh (the batched full
    prefill for classic admission), each rank's pool holding 2 of the 4
    KV heads. Counts
    zeroed before each mesh run and read after it, the ranks' too;
    #5 never launches. Returns {kernel: launches}."""
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.core import VirtualCluster
    from repro_torch.launch.serve import make_trace, serve
    from repro_torch.serve.router import ReplicaSet

    t0 = time.perf_counter()
    names = {op: ("flash_decode" if op.__name__ == "flash_decode_partials"
                  else op.__name__) for op in counted}
    launches = {n: 0 for n in names.values()}

    def zero():
        for op in counted:
            op.launches = 0

    def read(label, want):
        """Add the counts since zero() to `launches`; fail unless each
        kernel of `want` launched (True) or did not (False)."""
        got = {names[op]: op.launches for op in counted}
        for k, n in got.items():
            launches[k] += n
        if any((got[k] > 0) != w for k, w in want.items()):
            fail(f"phase 29 {label}: launches {got}, expected "
                 f"{ {k: 'some' if w else 0 for k, w in want.items()} }")
        return {k: n for k, n in got.items() if n}

    none = {k: False for k in launches}
    store = tempfile.mkdtemp(prefix="chip_smoke_engines_")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            rank=0, world_size=1)
    try:
        cluster = VirtualCluster(n_compute=1, devices_per_node=1)
        mesh = cluster.rendering.mesh
        if tuple(mesh.shape) != (1, 1):
            fail(f"phase 29: the one-rank cluster rendered {mesh}")
        cfg = mesh_cfg("paper-demo", None)
        params = load_params(cfg, 0)
        # phase 3's trace
        zero()
        run = serve(serve_args([]), cfg, params, mesh)
        got = read("(a) greedy", dict(none, paged_flash_decode=True))
        want_out, one_rate = phase3
        out, wall, n_tok = run["out"], run["wall_s"], run["tokens"]
        if out != want_out:
            fail("phase 29 (a): the 1 x 1 mesh's greedy tokens differ from "
                 "phase 3's")
        print(f"(a) {cfg.name} over the rendered 1 x 1 NCCL mesh, phase 3's "
              f"trace: tokens equal phase 3's bit for bit; {n_tok} tokens, "
              f"{n_tok / wall:.1f} tokens/s wall (phase 3, one device: "
              f"{one_rate:.1f}) on {card()}; launches {got}")
        # phase 4's seeded trace at 8 and 4 slots
        seeded = ["--temperature", "0.8", "--top-k", "50", "--top-p",
                  "0.9", "--sample-seed", "7"]
        zero()
        run8 = serve(serve_args(seeded), cfg, params, mesh)
        got = read("(a) seeded", dict(none, paged_flash_decode=True,
                                      topk_topp_mask=True))
        run4 = serve(serve_args(seeded + ["--slots", "4"]), cfg, params,
                     mesh)
        if run8["out"] != run4["out"]:
            fail("phase 29 (a): seeded tokens at 8 and 4 slots differ")
        print(f"(a) seeded over the 1 x 1 mesh: 8 vs 4 slots bit-identical; "
              f"{run8['tokens'] / run8['wall_s']:.1f} tokens/s wall at 8 "
              f"slots; launches {got}")
        # the int8 pool as a 2-replica fleet under VirtualCluster.serve
        fargs = serve_args(["--trace", "burst", "--kv", "quant"])
        zero()
        # 4 slots a replica: the burst outlasts the drained replicas, so
        # they are released before the run ends
        fleet = ReplicaSet(cfg, params, replicas=2, clock=cluster.clock,
                           num_slots=4, prompt_len=fargs.prompt_len,
                           max_gen=fargs.gen_max, kv="quant",
                           device="cuda", mesh=mesh)
        sizes = []

        def on_step(i, snap, c):
            if i == 2:
                c.scale_to(3)
            elif i == 12:
                c.scale_to(1)
            sizes.append(len(fleet.live_replicas()))

        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fout = cluster.serve(fleet, make_trace(fargs, cfg),
                             dt=fargs.step_time, on_step=on_step)
        wall = time.perf_counter() - t1
        got = read("(a) quant fleet", dict(none,
                                           paged_flash_decode_quant=True))
        if fout != serve(fargs, cfg, params, mesh)["out"]:
            fail("phase 29 (a): the quant fleet under serve differs from "
                 "one engine")
        if not (fleet.replica_warmups and fleet.released
                and max(sizes) > 2 and sizes[-1] < max(sizes)):
            fail(f"phase 29 (a): no scale-up and scale-down: live replicas "
                 f"{sizes}, warmups {fleet.replica_warmups}, released "
                 f"{fleet.released}")
        print(f"(a) int8 fleet under VirtualCluster.serve over the 1 x 1 "
              f"mesh: live replicas {sizes[0]} -> {max(sizes)} -> "
              f"{sizes[-1]}, released {fleet.released}; bit-identical to "
              f"one engine; {sum(len(t) for t in fout.values()) / wall:.1f} "
              f"tokens/s wall; launches {got}")
        del fleet
        # the slot pool by classic admission at prompt 256
        slargs = serve_args(["--kv", "slot", "--prompt-len", "256"])
        zero()
        run = serve(slargs, cfg, params, mesh)
        got = read("(a) slot pool", dict(none, paged_flash_decode=True,
                                         flash_attention=True))
        if got.get("flash_attention") != slargs.requests * cfg.num_blocks:
            fail(f"phase 29 (a): the slot pool launched #4 "
                 f"{got.get('flash_attention')} times")
        if run["out"] != phase10:
            fail("phase 29 (a): the slot pool's tokens differ from phase "
                 "10's")
        print(f"(a) slot pool over the 1 x 1 mesh, prompt 256: tokens equal "
              f"phase 10's bit for bit; {run['tokens'] / run['wall_s']:.1f} "
              f"tokens/s wall; launches {got}")
        del params
        gc.collect()
        torch.cuda.empty_cache()
        for arch, layers, n, S, gen, slots in MESH_ENGINE_RECURRENT:
            rcfg = mesh_cfg(arch, layers)
            rparams = load_params(rcfg, 0)
            rargs = recurrent_args(n, S, gen, slots)
            kinds = layer_kinds(rcfg)
            zero()
            run = serve(rargs, rcfg, rparams, mesh)
            got = read(f"(a) {arch}", dict(
                none, rglru_scan="rglru" in kinds, wkv6="rwkv" in kinds,
                paged_flash_decode=bool(kinds & {"attn", "local"})))
            if run["out"] != serve(rargs, rcfg, rparams)["out"]:
                fail(f"phase 29 (a) {arch}: the 1 x 1 mesh's tokens differ "
                     "from the engine's without a mesh")
            print(f"(a) {rcfg.name} ({layers} layers) over the 1 x 1 mesh, "
                  f"classic: tokens equal the engine's without a mesh; "
                  f"{run['tokens'] / run['wall_s']:.1f} tokens/s wall; "
                  f"launches {got}")
            del rparams
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    t_a = time.perf_counter() - t0
    # part (b): two processes over gloo, the (1, 2) mesh
    env_b = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_engine_ranks_")
    t1 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "chip_smoke.py"),
         "--engine-rank", str(r), f"{tmp}/store", f"{tmp}/out"],
        env=env_b, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    logs = []
    for proc in procs:
        try:
            logs.append(proc.communicate(timeout=600)[0])
        finally:
            proc.kill()
    if any(proc.returncode != 0 for proc in procs):
        fail("phase 29 part (b): a rank failed:\n" + "\n".join(
            log[-3000:] for log in logs))
    ranks = []
    for r in range(2):
        with open(f"{tmp}/out.{r}.json") as f:
            ranks.append(json.load(f))
    shutil.rmtree(tmp, ignore_errors=True)
    for arch, layers, n, S, gen, slots in MESH_ENGINE_B:
        cases = [rep["cases"][arch] for rep in ranks]
        c = cases[0]
        kinds = layer_kinds(mesh_cfg(arch, layers))
        need = dict(none, rglru_scan="rglru" in kinds, wkv6="rwkv" in kinds,
                    paged_flash_decode=bool(kinds & {"attn", "local"}))
        for case in cases:
            for k, m in case["launches"].items():
                launches[k] += m
            if any((case["launches"][k] > 0) != w for k, w in need.items()):
                fail(f"phase 29 (b) {arch}: launches "
                     f"{[x['launches'] for x in cases]}")
        if not (ranks[0]["mesh"] == [1, 2]
                and all(x["tokens"] == c["tokens"] for x in cases)
                and c["tokens"] == c["oneshot"]):
            fail(f"phase 29 (b) {arch}: the ranks' tokens differ, or from "
                 f"the one-shot over the mesh")
        if arch == "paper-demo" and not all(x["kv_heads"] == 2
                                            for x in cases):
            fail(f"phase 29 (b): a rank's pool holds "
                 f"{[x['kv_heads'] for x in cases]} KV heads")
        oracle = ("the streamed one-shot" if c["streamed"] else
                  f"the full-prefill one-shot of all {n} prompts")
        print(f"(b) {mesh_cfg(arch, layers).name} over the (1, 2) gloo mesh "
              f"(two processes on the card): both ranks' tokens equal, and "
              f"equal {oracle} over the same mesh; a rank's pool holds "
              f"{c['kv_heads']} KV heads; wall tokens/s "
              f"{n * gen / max(x['wall_s'] for x in cases):.1f} (the slower "
              f"rank); launches per rank "
              f"{[{k: m for k, m in x['launches'].items() if m} for x in cases]}")
    print(f"(a) {t_a:.1f}s; (b) {time.perf_counter() - t1:.1f}s with the "
          f"processes' start; "
          f"mesh engines phase: {time.perf_counter() - t0:.1f}s; kernel "
          f"launches {launches}")
    return launches


# phase 30: ROADMAP item 12.2 over the rendered mesh. Part (b)'s model over
# the (1, 2) gloo mesh: (arch, layers, requests, prompt, gen)
ITEM12_B = ("paper-demo", 2, 4, 64, 8)
# ... and the archs whose per-rank prefill of one prompt alone and inside
# a batch of 8 must give the same bits over (1, 2): (arch, layers)
ITEM12_LEAD = (("paper-demo", None), ("recurrentgemma-9b", 5))


def kernel_name(op):
    """The JSON line's name of a counted op (#5's wrapper is
    flash_decode_partials)."""
    return ("flash_decode" if op.__name__ == "flash_decode_partials"
            else op.__name__)


def seq_plan():
    """SERVE_PLAN with the KV cache split over tp along the positions."""
    from repro_torch.models.env import SERVE_PLAN
    return dataclasses.replace(SERVE_PLAN, kv_cache="seq_sharded")


def item12_rank(rank, store, out):
    """Part (b) of phase 30, one of two processes sharing the card: a gloo
    group with CUDA tensors and the (1, 2) DeviceMesh a VirtualCluster of
    two nodes renders. ITEM12_B's model through n-gram speculation (and
    spec off), a swap victim (swap_victim over the mesh: its own checks),
    the slot pool under seq_sharded (and the full-prefill one-shot over
    the mesh in that layout), counts zeroed before each and read after;
    then each ITEM12_LEAD arch's per-rank prefill of 8 prompts against
    each prompt alone, logits and cache leaves, in both layouts. Every
    rank writes its tokens, counts and the unequal rows (out.<rank>.json)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import bridge
    from repro_torch.core import VirtualCluster
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_decode.ops import flash_decode_partials
    from repro_torch.kernels.paged_decode.ops import (
        paged_flash_decode, paged_flash_decode_quant)
    from repro_torch.kernels.rglru.ops import rglru_scan
    from repro_torch.kernels.rwkv6.ops import wkv6
    from repro_torch.kernels.sampling.ops import topk_topp_mask
    from repro_torch.launch.serve import serve, serve_batch
    from repro_torch.models import model as Mo
    from repro_torch.models.env import SERVE_PLAN, Env

    counted = (paged_flash_decode, paged_flash_decode_quant, topk_topp_mask,
               flash_attention, rglru_scan, wkv6, flash_decode_partials)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=2)
    mesh = VirtualCluster(n_compute=2, devices_per_node=1,
                          device="cuda").rendering.mesh
    rep = {"mesh": list(mesh.shape), "cases": {}, "lead": {}}
    arch, layers, n, S, gen = ITEM12_B
    cfg = mesh_cfg(arch, layers)
    params = Mo.init_params(cfg, Env(), seed=0, device="cuda")
    base = ["--requests", str(n), "--prompt-len", str(S), "--gen", str(gen),
            "--slots", "4"]

    def counts():
        return {kernel_name(op): op.launches for op in counted}

    def zero():
        for op in counted:
            op.launches = 0

    order = lambda res: [res[r] for r in sorted(res)]
    rep_args = serve_args(base + ["--trace", "repetitive", "--spec",
                                  "ngram"])
    zero()
    t0 = time.perf_counter()
    run = serve(rep_args, cfg, params, mesh)
    got = counts()
    rep["cases"]["spec"] = {
        "tokens": order(run["out"]), "launches": got,
        "wall_s": time.perf_counter() - t0,
        "accepted_per_step": run["engine"].snapshot()["accepted_per_step"],
        "off": order(serve(serve_args(base + ["--trace", "repetitive"]),
                           cfg, params, mesh)["out"])}
    toks = []
    got = swap_victim(cfg, params, "paged", S, counted,
                      f"(b) rank {rank}: swap victim over (1, 2)", mesh=mesh,
                      gen=gen, tokens=toks)
    rep["cases"]["swap"] = {"tokens": toks, "launches": {
        ("flash_decode" if k == "flash_decode_partials" else k): v
        for k, v in got.items()}}
    sl_args = serve_args(base + ["--kv", "slot"])
    zero()
    t0 = time.perf_counter()
    run = serve(sl_args, cfg, params, mesh, plan=seq_plan())
    got = counts()
    prompts = np.stack([r.prompt for r in run["trace"]])
    rep["cases"]["slotseq"] = {
        "tokens": order(run["out"]), "launches": got,
        "wall_s": time.perf_counter() - t0,
        "positions": int(run["engine"].pool.caches["blocks"][0]["k"]
                         .shape[3]),
        "oneshot": serve_batch(cfg, params, prompts, gen,
                               streamed_prefill=False, mesh=mesh,
                               plan=seq_plan()).tolist()}
    del params
    for arch, layers in ITEM12_LEAD:
        lcfg = mesh_cfg(arch, layers)
        lparams = Mo.init_params(lcfg, Env(), seed=0, device="cuda")
        tok = torch.as_tensor(np.random.default_rng(1).integers(
            0, lcfg.vocab_size, (8, S), dtype=np.int32), device="cuda")
        for plan in (SERVE_PLAN, seq_plan()):
            env = Env(mesh=mesh, plan=plan)
            p = bridge.rank_shards(lparams, lcfg, env)
            lb, cb = Mo.forward(p, tok, lcfg, env, mode="prefill")
            rows = leaves = 0
            for i in range(8):
                l1, c1 = Mo.forward(p, tok[i:i + 1], lcfg, env,
                                    mode="prefill")
                rows += int(not torch.equal(l1[0], lb[i]))
                leaves += sum(int(not torch.equal(a[:, 0], b[:, i]))
                              for a, b in zip(Mo._all_views(c1),
                                              Mo._all_views(cb)))
            rep["lead"][f"{lcfg.name} ({lcfg.n_layers} layers) "
                        f"{plan.kv_cache}"] = [rows, leaves]
            del p
        del lparams
        torch.cuda.empty_cache()
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(rep, f)
    dist.destroy_process_group()


def check_item12(counted, spec_tokens, victims, phase10):
    """Phase 30: ROADMAP item 12.2 over the cluster's rendered mesh.
    Part (a), one rank of an NCCL group and the 1 x 1 mesh
    VirtualCluster(n_compute=1) renders under it, paper-demo-110m at full
    width: n-gram and model speculation (k 4) greedy and seeded on the
    paged, int8 and slot pools at phase 17's SPEC_LAYERS depth (the model
    drafter seeded on the paged pool only) over SPEC_TRACE, each
    bit-identical to phase 17's tokens (`spec_tokens`) and to spec off
    over the mesh; phase 16's swap victim on the bf16 and int8 pools at
    full depth, its tokens phase 16's (`victims`); phase 10's trace on the
    slot pool under a seq_sharded plan (#4's prefills, #5's decode at each
    row's own depth), bit for bit the seq_sharded one-shot over the same
    mesh, its tokens against phase 10's (`phase10`) counted. Part (b), two
    processes sharing the card over gloo and the (1, 2) mesh
    (item12_rank): n-gram speculation equal to spec off, a swap victim
    equal to its unpreempted run, the slot pool under seq_sharded equal to
    the seq_sharded one-shot and #5 merged across the two ranks, both
    ranks' tokens equal; the per-rank prefill's rows independent of the
    batch. Counts zeroed before each run and read after it, the ranks'
    too. Returns ({kernel: launches}, {part: {kernel: launches}})."""
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.core import VirtualCluster
    from repro_torch.launch.serve import serve, verify
    from repro_torch.models import model as Mo
    from repro_torch.models.env import Env

    t0 = time.perf_counter()
    launches = {kernel_name(op): 0 for op in counted}
    parts = {}

    def zero():
        for op in counted:
            op.launches = 0

    def read():
        got = {kernel_name(op): op.launches for op in counted}
        for k, v in got.items():
            launches[k] += v
        return {k: v for k, v in got.items() if v}

    store = tempfile.mkdtemp(prefix="chip_smoke_item12_")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            rank=0, world_size=1)
    try:
        mesh = VirtualCluster(n_compute=1, devices_per_node=1).rendering.mesh
        if tuple(mesh.shape) != (1, 1):
            fail(f"phase 30: the one-rank cluster rendered {mesh}")
        cfg = mesh_cfg("paper-demo", None)
        spec_cfg = dataclasses.replace(cfg, n_layers=SPEC_LAYERS)
        spec_params = Mo.init_params(spec_cfg, Env(), seed=0, device="cuda")
        base = list(SPEC_TRACE)
        seeded = ["--temperature", "0.8", "--top-k", "50", "--top-p", "0.9",
                  "--sample-seed", "7"]
        for kv in ("paged", "quant", "slot"):
            for samp in ([], seeded):
                off = serve(serve_args(base + ["--kv", kv] + samp), spec_cfg,
                            spec_params, mesh)["out"]
                # the model drafter's T=1 steps are the phase's time: its
                # seeded rows on the paged pool only
                for drafter in (("ngram", "model") if kv == "paged"
                                or not samp else ("ngram",)):
                    args = serve_args(base + ["--kv", kv, "--spec", drafter,
                                              "--spec-k", "4"] + samp)
                    zero()
                    run = serve(args, spec_cfg, spec_params, mesh)
                    got = read()
                    label = (f"(a) spec {drafter} {kv} "
                             f"{'seeded' if samp else 'greedy'}")
                    if run["out"] != spec_tokens[(kv, drafter, bool(samp))]:
                        fail(f"phase 30 {label}: the 1 x 1 mesh's tokens "
                             "differ from phase 17's")
                    if run["out"] != off:
                        fail(f"phase 30 {label}: spec differs from spec off "
                             "over the mesh")
                    snap = run["engine"].snapshot()
                    print(f"{label} over the 1 x 1 mesh ({SPEC_LAYERS} "
                          f"layers): tokens equal phase 17's and spec off's "
                          f"bit for bit; accepted/step "
                          f"{snap['accepted_per_step']:.3f}, "
                          f"{run['tokens'] / run['wall_s']:.1f} tokens/s "
                          f"wall; launches {got}")
        del spec_params
        params = load_params(cfg, 0)
        for kv in ("paged", "quant"):
            toks = []
            zero()
            swap_victim(cfg, params, kv, 64, counted,
                        f"(a) swap victim over the 1 x 1 mesh, {kv} pool",
                        mesh=mesh, tokens=toks)
            read()
            if toks != victims[kv]:
                fail(f"phase 30 (a) swap {kv}: the 1 x 1 mesh's tokens "
                     "differ from phase 16's")
        slargs = serve_args(["--kv", "slot", "--prompt-len", "256"])
        zero()
        run = serve(slargs, cfg, params, mesh, plan=seq_plan())
        got = read()
        if (got.get("flash_attention") != slargs.requests * cfg.num_blocks
                or not got.get("flash_decode")
                or got.get("paged_flash_decode")):
            fail(f"phase 30 (a) slot pool under seq_sharded: launches {got}")
        ok, line = verify(slargs, cfg, params, run, mesh=mesh,
                          plan=seq_plan())
        if not ok:
            fail(f"phase 30 (a) slot pool under seq_sharded: {line}")
        parted = sum(a != b for r in phase10 for a, b in
                     zip(run["out"][r], phase10[r]))
        print(f"(a) slot pool under seq_sharded over the 1 x 1 mesh, phase "
              f"10's trace (prompt 256): {line} (the seq_sharded one-shot "
              f"over the same mesh); {parted} of "
              f"{sum(len(t) for t in phase10.values())} tokens differ from "
              f"phase 10's (kernel #1's attention there); "
              f"{run['tokens'] / run['wall_s']:.1f} tokens/s wall; "
              f"launches {got}")
        del params
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    t_a = time.perf_counter() - t0
    parts["a"] = dict(launches)
    env_b = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_item12_ranks_")
    t1 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "chip_smoke.py"),
         "--item12-rank", str(r), f"{tmp}/store", f"{tmp}/out"],
        env=env_b, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    logs = []
    for proc in procs:
        try:
            logs.append(proc.communicate(timeout=600)[0])
        finally:
            proc.kill()
    if any(proc.returncode != 0 for proc in procs):
        fail("phase 30 part (b): a rank failed:\n" + "\n".join(
            log[-3000:] for log in logs))
    ranks = []
    for r in range(2):
        with open(f"{tmp}/out.{r}.json") as f:
            ranks.append(json.load(f))
    shutil.rmtree(tmp, ignore_errors=True)
    if not all(x["mesh"] == [1, 2] for x in ranks):
        fail(f"phase 30 (b): meshes {[x['mesh'] for x in ranks]}")
    want = {"spec": {"paged_flash_decode"}, "swap": {"paged_flash_decode"},
            "slotseq": {"flash_decode"}}
    for case, need in want.items():
        cases = [x["cases"][case] for x in ranks]
        c = cases[0]
        for x in cases:
            for k, v in x["launches"].items():
                launches[k] += v
            got = {k for k, v in x["launches"].items() if v}
            if not need <= got or (case == "slotseq"
                                   and "paged_flash_decode" in got):
                fail(f"phase 30 (b) {case}: launches {x['launches']}")
        if not all(x["tokens"] == c["tokens"] for x in cases):
            fail(f"phase 30 (b) {case}: the ranks' tokens differ")
        oracle = {"spec": "off", "slotseq": "oneshot"}.get(case)
        if oracle and c["tokens"] != c[oracle]:
            fail(f"phase 30 (b) {case}: tokens differ from {oracle}")
    spec, slotseq = ranks[0]["cases"]["spec"], ranks[0]["cases"]["slotseq"]
    print(f"(b) {mesh_cfg(*ITEM12_B[:2]).name} ({ITEM12_B[1]} layers) over "
          f"the (1, 2) gloo mesh (two processes on the card): n-gram spec "
          f"equals spec off on both ranks, accepted/step "
          f"{spec['accepted_per_step']:.3f}, "
          f"{sum(map(len, spec['tokens'])) / spec['wall_s']:.1f} tokens/s "
          f"wall; the swap victim equals its unpreempted run; the slot pool "
          f"under seq_sharded ({slotseq['positions']} of "
          f"{ITEM12_B[3] + ITEM12_B[4]} positions a rank) equals the "
          f"seq_sharded one-shot, #5 merged across the ranks, "
          f"{sum(map(len, slotseq['tokens'])) / slotseq['wall_s']:.1f} "
          f"tokens/s wall; launches per rank "
          f"{[{c: {k: v for k, v in x['cases'][c]['launches'].items() if v} for c in want} for x in ranks]}")
    for key in ranks[0]["lead"]:
        per = [x["lead"][key] for x in ranks]
        print(f"(b) per-rank prefill of 8 prompts vs each alone, {key}: "
              f"unequal rows (logits, cache leaves) per rank {per}")
        if any(a or b for a, b in per):
            fail(f"phase 30 (b): {key}'s prefill rows depend on the batch")
    parts["b"] = {k: v - parts["a"][k] for k, v in launches.items()}
    print(f"(a) {t_a:.1f}s; (b) {time.perf_counter() - t1:.1f}s with the "
          f"processes' start; item 12.2 phase: "
          f"{time.perf_counter() - t0:.1f}s; kernel launches {launches} "
          f"(by part {parts})")
    if not (parts["a"]["flash_decode"] and parts["b"]["flash_decode"]):
        fail(f"phase 30 did not launch kernel #5 in each part: {parts}")
    return launches, parts


CENSUS_WARM, CENSUS_STEPS = 8, 4  # phase 31: engine steps warmed, counted


def sync_census(args, cfg, params):
    """Phase 31 (b) for one engine: warm it CENSUS_WARM steps into its
    trace, then run CENSUS_STEPS steps under
    torch.cuda.set_sync_debug_mode("warn"), each synchronizing call's
    warning attributed to the innermost frame under src/repro_torch/.
    Returns ([syncs of each step], {site: count})."""
    import collections
    import traceback
    import warnings

    import torch
    from repro_torch.launch.serve import make_engine, make_trace
    root = HERE + os.sep
    engine = make_engine(args, cfg, params)
    engine.submit(make_trace(args, cfg))
    for _ in range(CENSUS_WARM):
        engine.step()
        engine.clock.sleep(args.step_time)
    sites, per_step = collections.Counter(), []

    stepping = [False]  # count inside engine.step() only

    def record(message, category, filename, lineno, file=None, line=None):
        if not stepping[0] or "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()
                if f.filename.startswith(root + "src/repro_torch/")]
        f = ours[-1] if ours else None
        sites[f"{f.filename[len(root):]}:{f.lineno}" if f
              else f"{filename}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(CENSUS_STEPS):
                n = sum(sites.values())
                stepping[0] = True
                engine.step()
                stepping[0] = False
                per_step.append(sum(sites.values()) - n)
                engine.clock.sleep(args.step_time)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return per_step, dict(sites.most_common())


def check_lint_and_syncs(dev):
    """Phase 31: (a) the port's linter over src/repro_torch, in-process;
    (b) the host-sync census of phases 3 and 4's engines."""
    import torch
    from repro_torch.analysis.core import run_lint
    from repro_torch.configs import get_config
    from repro_torch.models import model as Mo
    from repro_torch.models.env import Env
    t0 = time.perf_counter()
    res = run_lint([os.path.join(HERE, "src", "repro_torch")])
    if res.unsuppressed:
        fail("phase 31: replint findings in src/repro_torch:\n"
             + "\n".join(f.format() for f in res.unsuppressed))
    print(f"(a) replint over src/repro_torch: {len(res.unsuppressed)} "
          f"findings, {len(res.suppressed)} suppressed, "
          f"{len(res.unused_suppressions)} unused, {res.files_scanned} "
          f"files, {time.perf_counter() - t0:.2f}s")
    cfg = get_config("paper-demo")
    params = Mo.init_params(cfg, Env(), seed=0, device=dev)
    census = {}
    for label, extra in (("greedy", []),
                         ("seeded", ["--temperature", "0.8", "--top-k", "50",
                                     "--top-p", "0.9", "--sample-seed", "7"])):
        per_step, sites = sync_census(serve_args(extra), cfg, params)
        census[label] = {"syncs_per_step": sum(per_step) / CENSUS_STEPS,
                         "per_step": per_step, "sites": sites}
    print("host-sync census (" + cfg.name + ", paged, prompt 64, 8 slots, "
          f"after {CENSUS_WARM} warm steps): " + json.dumps(census))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return census


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def phase_clock():
    """done(n) prints phase n's wall time: the time since the last call."""
    last = [time.perf_counter()]

    def done(n):
        now = time.perf_counter()
        print(f"phase {n}: {now - last[0]:.1f}s")
        last[0] = now

    return done


def card():
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return (smi.stdout.strip().splitlines()[0] if smi.returncode == 0
            else "nvidia-smi unavailable")


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_decode.ops import (
        paged_flash_decode, paged_flash_decode_quant)
    from repro_torch.kernels.paged_decode.ref import (paged_decode_quant_ref,
                                                      paged_decode_ref)
    from repro_torch.kernels.sampling.ops import topk_topp_mask
    from repro_torch.kernels.sampling.ref import topk_topp_mask_ref
    from repro_torch.launch.serve import run_trace, serve, verify
    from repro_torch.models import model as Mo
    from repro_torch.models.env import Env

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    # 1. build
    done = phase_clock()
    t0 = time.perf_counter()
    kernels.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f}s")
    for line in kernels.build_log.splitlines():
        if "entry function" in line:  # names the instantiation that follows
            print("  entry " + demangle(line.split("'")[1]))
        elif "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())
    redesigned_build_report(kernels)

    done(1)
    # 2. kernels vs plain versions; one decode step and one full-width
    # prefill, card vs CPU
    checked = check_kernels(dev)
    check_against_cpu()

    cfg = get_config("paper-demo")
    params = Mo.init_params(cfg, Env(), seed=0, device=dev)
    check_prefill_against_cpu(cfg, params)

    done(2)
    # 3. the main path, greedy, full width
    args = serve_args([])
    paged_flash_decode.launches = topk_topp_mask.launches = 0
    run = serve(args, cfg, params)
    n_paged = paged_flash_decode.launches
    if n_paged <= 0:
        fail("the greedy serving run never launched the paged decode kernel")
    check_tokens(run, cfg)
    tok_s = run["tokens"] / run["wall_s"]
    print(f"greedy serve {cfg.name}: {len(run['out'])} requests, "
          f"{run['tokens']} tokens in {run['steps']} steps, "
          f"{run['wall_s']:.3f}s wall, {tok_s:.1f} tokens/s wall; paged "
          f"decode launches {n_paged}")
    ok, line = verify(args, cfg, params, run)
    if not ok:
        fail(f"greedy serve: {line}")
    print(line)

    done(3)
    # 4. seeded top-k/top-p at two slot counts
    sargs = serve_args(["--temperature", "0.8", "--top-k", "50",
                        "--top-p", "0.9", "--sample-seed", "7"])
    paged_flash_decode.launches = topk_topp_mask.launches = 0
    srun = serve(sargs, cfg, params)
    n_mask = topk_topp_mask.launches
    if n_mask <= 0 or paged_flash_decode.launches <= 0:
        fail("the sampled serving run never launched both kernels")
    check_tokens(srun, cfg)
    ok, line = verify(sargs, cfg, params, srun)
    if not ok:
        fail(f"seeded serve: {line}")
    print(f"seeded serve: {srun['tokens']} tokens, {srun['wall_s']:.3f}s "
          f"wall, mask launches {n_mask}; {line}")

    done(4)
    # 5. timings at the phase-2 shapes
    pin, paged_err = checked["paged"]
    q, kp, vp, tables, lengths = pin
    B, Hq, hd = q.shape
    MB, bs, Hkv = tables.shape[1], kp.shape[2], kp.shape[1]
    g = Hq // Hkv  # SDPA over the gathered KV, heads expanded beforehand
    kg = kp[tables.long()].transpose(1, 2).reshape(
        B, Hkv, MB * bs, hd).repeat_interleave(g, dim=1)
    vg = vp[tables.long()].transpose(1, 2).reshape(
        B, Hkv, MB * bs, hd).repeat_interleave(g, dim=1)
    amask = (torch.arange(MB * bs, device=dev)[None, :]
             <= lengths.long()[:, None])[:, None, None, :]
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None, :], kg, vg, attn_mask=amask)
    paged_bound, paged_by = paged_bound_ms(q, kp, tables, lengths,
                                           token_bytes=2 * 2 * hd)
    qin, quant_err = checked["quant"]
    _, kq, vq, kqs, vqs, _, _ = qin
    # the library yardstick for the quant kernel reads KV dequantized to
    # bf16 beforehand: it leaves the dequant out
    deq = lambda x, sc: (x.float() * sc[..., None]).to(torch.bfloat16)
    kgq = deq(kq, kqs)[tables.long()].transpose(1, 2).reshape(
        B, Hkv, MB * bs, hd).repeat_interleave(g, dim=1)
    vgq = deq(vq, vqs)[tables.long()].transpose(1, 2).reshape(
        B, Hkv, MB * bs, hd).repeat_interleave(g, dim=1)
    sdpa_q = lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None, :], kgq, vgq, attn_mask=amask)
    quant_bound, quant_by = paged_bound_ms(q, kq, tables, lengths,
                                           token_bytes=2 * (hd + 4))
    mask_cases, mask_err = checked["mask"]
    logits, ks, ps = mask_cases["mix"]
    mask_bound, mask_by = mask_bound_ms(*logits.shape)
    # flash attention at paper-demo's heads, causal: the classic
    # admission's batch-1 prefill (the JSON line's shape), the one-shot
    # baseline's B=16, one long prompt; beside it PyTorch's fused attention
    fgen = torch.Generator(device=dev).manual_seed(5)
    flash = []
    for B, S in FLASH_TIMED:
        fin = flash_inputs(fgen, dev, B, S, 12, 4, 64)
        sdpa_f = lambda fin=fin: \
            torch.nn.functional.scaled_dot_product_attention(
                *(t.transpose(1, 2) for t in fin), is_causal=True,
                enable_gqa=True)
        bound, by = flash_bound_ms(B, S, 12, 4, 64)
        row = {"B": B, "S": S,
               "ms": device_ms(lambda fin=fin: flash_attention(
                   *fin, causal=True, n_kv_heads=4)),
               "plain_ms": device_ms(lambda fin=fin: flash_plain(*fin)),
               "library_ms": device_ms(sdpa_f), "bound_ms": bound,
               "bound_by": by, "fin": fin}
        print(f"flash attention B={B} S={S}: {row['ms'] * 1e3} us "
              f"kernel, {row['plain_ms'] * 1e3} us plain, "
              f"{row['library_ms'] * 1e3} us SDPA, bound {bound * 1e3} us "
              f"({by}), {bound / row['ms']:.4f} of the bound")
        flash.append(row)
    # every time is device work per call (CUDA graph replay); the kernels'
    # eager per-call times, host work included, are printed beside them
    calls = {"paged_flash_decode": lambda: paged_flash_decode(*pin),
             "topk_topp_mask": lambda: topk_topp_mask(logits, ks, ps),
             "paged_flash_decode_quant":
                 lambda: paged_flash_decode_quant(*qin),
             "flash_attention": lambda: flash_attention(
                 *flash[0]["fin"], causal=True, n_kv_heads=4)}
    # the mask under the other settings, at the same shape and bound
    mask_settings = {}
    for setting in time_mask.SETTINGS[1:]:
        x, k, p = mask_cases[setting]
        mask_settings[setting] = {
            "ms": device_ms(lambda: topk_topp_mask(x, k, p)),
            "plain_ms": device_ms(lambda: topk_topp_mask_ref(x, k, p)),
            "library_ms": device_ms(lambda: torch.sort(x, dim=-1,
                                                       descending=True))}
        print(f"top-k/top-p mask 72x32000 {setting}: "
              f"{mask_settings[setting]['ms'] * 1e3} us kernel, "
              f"{mask_settings[setting]['plain_ms'] * 1e3} us plain, "
              f"{mask_settings[setting]['library_ms'] * 1e3} us torch.sort, "
              f"bound {mask_bound * 1e3} us ({mask_by})")
    report = [
        {"name": "paged_flash_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_decode.cu",
         "replaces": "src/repro/kernels/paged_decode/kernel.py:121",
         "launches": n_paged, "max_abs_err": paged_err,
         "ms": device_ms(calls["paged_flash_decode"]),
         "plain_ms": device_ms(lambda: paged_decode_ref(*pin)),
         "bound_ms": paged_bound, "bound_by": paged_by,
         "library_ms": device_ms(sdpa)},
        {"name": "topk_topp_mask", "route": "cuda",
         "source": "src/repro_torch/csrc/topk_topp_mask.cu",
         "replaces": "src/repro/kernels/sampling/kernel.py:75",
         "launches": n_mask, "max_abs_err": mask_err,
         "ms": device_ms(calls["topk_topp_mask"]),
         "plain_ms": device_ms(lambda: topk_topp_mask_ref(logits, ks, ps)),
         "bound_ms": mask_bound, "bound_by": mask_by,
         "library_ms": device_ms(lambda: torch.sort(logits, dim=-1,
                                                    descending=True)),
         "settings": mask_settings},
        {"name": "paged_flash_decode_quant", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_decode_quant.cu",
         "replaces": "src/repro/kernels/paged_decode/kernel.py:170",
         "launches": None,  # the fleet run's, phase 7
         "max_abs_err": quant_err,
         "ms": device_ms(calls["paged_flash_decode_quant"]),
         "plain_ms": device_ms(lambda: paged_decode_quant_ref(*qin)),
         "bound_ms": quant_bound, "bound_by": quant_by,
         "library_ms": device_ms(sdpa_q)},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:91",
         "launches": None,  # the classic serve's, phase 9
         "max_abs_err": checked["flash"],
         **{k: flash[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")},
         "shapes": [{k: row[k] for k in ("B", "S", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms")}
                    for row in flash[1:]]},
    ]
    for k in report:
        print(f"{k['name']}: {k['ms'] * 1e3:.1f} us kernel, "
              f"{k['plain_ms'] * 1e3:.1f} us plain, "
              f"{k['library_ms'] * 1e3:.1f} us library, bound "
              f"{k['bound_ms'] * 1e3:.2f} us ({k['bound_by']}); "
              f"{call_ms(calls[k['name']]) * 1e3:.1f} us per eager call "
              f"with the wrapper's host work")
    print(f"wall tokens/s (greedy serve, full width): {tok_s:.1f}")

    done(5)
    # 6. where a step's time goes
    profile_steps(args, cfg, params)

    done(6)
    # 7. the paper's loop: an autoscaled fleet of int8-KV replicas
    # counts read between the run and its verify, as in phases 3-4: the
    # verify's own engine launches the kernel too
    fargs = serve_args(["--trace", "burst", "--kv", "quant", "--replicas",
                        "2", "--max-nodes", "4"])
    paged_flash_decode.launches = paged_flash_decode_quant.launches = 0
    topk_topp_mask.launches = 0
    frun = run_trace(fargs, cfg, params)
    n_quant, n_fp = paged_flash_decode_quant.launches, \
        paged_flash_decode.launches
    if n_quant <= 0 or n_fp != 0:
        fail(f"the quant fleet launched the quant kernel {n_quant} times "
             f"and the bf16 one {n_fp} times")
    check_tokens(frun, cfg)
    if not frun["peak"] > frun["start"] or not frun["final"] < frun["peak"]:
        fail(f"the autoscaler did not scale up and back: start "
             f"{frun['start']} peak {frun['peak']} final {frun['final']}")
    if not frun["engine"].released:
        fail("no replica was drained and released")
    ok, line = verify(fargs, cfg, params, frun)
    if not ok:
        fail(f"quant fleet: {line}")
    print(line)
    report[2]["launches"] = n_quant
    print(f"quant fleet: timeline {frun['sizes']}, "
          f"{len(frun['actions'])} autoscaler actions, released "
          f"{frun['engine'].released} (leak-checked), quant decode "
          f"launches {n_quant}, bf16 decode launches {n_fp}; "
          f"{frun['tokens']} tokens in {frun['steps']} replica decode "
          f"steps, {frun['tokens'] / frun['wall_s']:.1f} tokens/s wall")

    done(7)
    # 8. one quant engine under the cluster: 8 vs 4 slots
    qargs = serve_args(["--trace", "burst", "--kv", "quant"])
    paged_flash_decode.launches = paged_flash_decode_quant.launches = 0
    qrun = run_trace(qargs, cfg, params)
    n_quant1 = paged_flash_decode_quant.launches
    if n_quant1 <= 0 or paged_flash_decode.launches != 0:
        fail("the quant engine never launched the quant kernel, or "
             "launched the bf16 one")
    check_tokens(qrun, cfg)
    ok, line = verify(qargs, cfg, params, qrun)
    if not ok:
        fail(f"quant engine: {line}")
    print(f"quant engine: quant decode launches {n_quant1}; {line}")

    done(8)
    # 9. classic admission: a batch-1 prefill per request (the flash
    # kernel at 256 tokens), its K/V inserted into the paged pool; counts
    # read between the run and its verify, whose B=16 prefill launches the
    # kernel too
    cargs = serve_args(["--prefill-chunk", "0", "--prompt-len", "256"])
    counted = (paged_flash_decode, paged_flash_decode_quant, topk_topp_mask,
               flash_attention)
    for op in counted:
        op.launches = 0
    crun = serve(cargs, cfg, params)
    n_flash, n_dec = flash_attention.launches, paged_flash_decode.launches
    want = cargs.requests * cfg.num_blocks
    if n_flash != want or n_dec <= 0:
        fail(f"the classic serve launched flash attention {n_flash} times "
             f"(expected {want}) and paged decode {n_dec} times")
    if crun["engine"].metrics.preemptions:
        fail("the classic serve preempted at the worst-case block budget")
    check_tokens(crun, cfg)
    ok, line = verify(cargs, cfg, params, crun)
    if not ok:
        fail(f"classic serve: {line}")
    report[3]["launches"] = n_flash
    print(f"classic serve {cfg.name} (prompt 256, gen 32, 8 slots): "
          f"{crun['tokens']} tokens in {crun['steps']} decode steps, "
          f"{crun['wall_s']:.3f}s wall, "
          f"{crun['tokens'] / crun['wall_s']:.1f} tokens/s wall on {card()}; "
          f"flash attention launches {n_flash}, paged decode launches "
          f"{n_dec}; {line}")

    done(9)
    # 10. the slot pool on the same trace: paged == slot, bit for bit
    slargs = serve_args(["--kv", "slot", "--prompt-len", "256"])
    for op in counted:
        op.launches = 0
    slrun = serve(slargs, cfg, params)
    if flash_attention.launches != want or paged_flash_decode.launches <= 0:
        fail(f"the slot pool launched flash attention "
             f"{flash_attention.launches} times and paged decode "
             f"{paged_flash_decode.launches} times")
    check_tokens(slrun, cfg)
    if slrun["out"] != crun["out"]:
        bad = sum(slrun["out"][r] != crun["out"][r] for r in crun["out"])
        fail(f"slot pool vs paged classic: {bad} requests differ")
    print(f"slot pool: {slrun['tokens']} tokens, {slrun['wall_s']:.3f}s "
          f"wall, flash attention launches {flash_attention.launches}; "
          "tokens equal the paged classic serve's bit for bit")

    done(10)
    # 11. the recurrent slice's kernels on the card, and their times
    rec = check_recurrent_kernels(dev)

    done(11)
    # 12. recurrentgemma-9b at full width and depth, classic admission
    from repro_torch.kernels.rglru.ops import rglru_scan
    from repro_torch.kernels.rwkv6.ops import wkv6
    counted = counted + (rglru_scan, wkv6)
    n_rglru, rg_dec, rg_flash = serve_recurrent(
        "recurrentgemma-9b", ["--requests", "8", "--prompt-len", "2304",
                              "--slots", "4"], counted)
    done(12)
    # 13. rwkv6-1.6b at full width and depth
    n_wkv, _, _ = serve_recurrent(
        "rwkv6-1.6b", ["--requests", "16", "--prompt-len", "256",
                       "--slots", "8"], counted)

    done(13)
    # 14. card vs CPU at full width, cut depth
    for arch, layers, S in (("recurrentgemma-9b", 5, 160),
                            ("rwkv6-1.6b", 2, 128)):
        cut = dataclasses.replace(get_config(arch), n_layers=layers)
        cparams = Mo.init_params(cut, Env(), seed=1, device=dev)
        check_prefill_against_cpu(cut, cparams, S)
        del cparams
        torch.cuda.empty_cache()

    done(14)
    # 15. the flash-decoding path (kernel #5) at full width; the mask's
    # rows past shared memory and a seeded serve of a 65536-token vocab
    fd_launches, fd_err, fd_rows = check_flash_decode(dev)
    fd_per_row_err, fd_per_row = check_flash_decode_rows(dev)
    fd_err = max(fd_err, fd_per_row_err)
    wide = check_wide_mask(dev)
    n_mask_wide = serve_seeded_rwkv()

    report[0]["ring"] = {k: rec["ring"][k] for k in ("ms", "plain_ms",
                                                     "bound_ms", "bound_by",
                                                     "library_ms")}
    report[0]["ring"].update(max_abs_err=rec["ring_err"], launches=rg_dec)
    report[3]["hd256"] = dict(rec["flash256"], max_abs_err=rec["flash_err"],
                              launches=rg_flash)
    report += [
        {"name": "rglru_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru/kernel.py:45",
         "launches": n_rglru, "max_abs_err": rec["rglru_err"],
         **rec["rglru"]},
        {"name": "wkv6", "route": "cuda",
         "source": "src/repro_torch/csrc/wkv6.cu",
         "replaces": "src/repro/kernels/rwkv6/kernel.py:67",
         "launches": n_wkv, "max_abs_err": rec["wkv_err"], **rec["wkv6"]},
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode/kernel.py:67",
         "launches": fd_launches, "max_abs_err": fd_err,
         **{k: fd_rows[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
         "shapes": fd_rows},
    ]
    report[1]["wide"] = wide
    report[1]["wide_launches"] = n_mask_wide

    done(15)
    # 16. the host swap tier at full width; 17. speculative decoding
    victims = {}  # phase 30's oracles
    swap_launches = check_swap_tier(cfg, params, counted, victims)
    done(16)
    spec_cfg = dataclasses.replace(cfg, n_layers=SPEC_LAYERS)
    spec_params = Mo.init_params(spec_cfg, Env(), seed=0, device=dev)
    spec_tokens = {}
    spec_launches = check_spec(spec_cfg, spec_params, counted, spec_tokens)
    del spec_params
    done(17)
    # 18. the four dense attention archs at full width and depth; 19. the
    # two MoE archs at full width and cut depth (paper-demo's engines and
    # weights freed first)
    phase3, phase10 = (run["out"], tok_s), slrun["out"]  # phase 29's
    del params, run, srun, frun, qrun, crun, slrun
    gc.collect()
    torch.cuda.empty_cache()
    zoo = check_zoo_dense(counted)
    done(18)
    _add(zoo, check_zoo_moe(counted))
    done(19)
    # 20. train mode, AdamW and the train step at full width; 21. the
    # rollout loop at full width and depth
    from repro_torch.kernels.flash_decode.ops import flash_decode_partials
    counted = counted + (flash_decode_partials,)
    check_train(counted, dev)
    done(20)
    rollout_launches = check_rollout(counted, dev)
    done(21)
    # 22. the int8 pool of the recurrent archs at full width and depth;
    # 23. the modality archs (M-RoPE VLM, encoder-decoder) through the
    # one-shot and train mode
    ring_q, qr_launches = check_quant_recurrent(counted, dev)
    done(22)
    mod_paged, mod_flash, mod_launches = check_modality(counted, dev)
    done(23)
    # 24. the elastic runtime: checkpoints, reshards and a rollback of a
    # full-width training job, and the training CLI
    elastic_launches = check_elastic(counted)
    done(24)
    # 25. training across ranks: the sharded step, the MoE layer's ep and
    # tp modes and the elastic trainer over a rendered mesh, on one rank
    # of NCCL and on two processes sharing the card over gloo
    sharded_launches = check_sharded(counted)
    done(25)
    # 26. the one-shot serve over the cluster's rendered mesh: one NCCL
    # rank, two processes sharing the card over gloo, the recurrent train
    # step over the same mesh
    mesh_launches, fd_seq = check_mesh_serving(counted)
    done(26)
    # 27. the modality archs over the rendered mesh: the vision rows,
    # whisper's encoder and cross caches per rank, in both KV layouts
    modality_mesh_launches, fd_cross = check_mesh_modality(counted)
    done(27)
    # 28. the analytic dry run over the production meshes on the card's
    # rates, two full-size steps against their bound, the four examples
    dryrun_launches, _ = check_dryrun(counted, dev)
    done(28)
    # 29. the serving engines over the rendered mesh: one NCCL rank's 1 x 1
    # mesh against phases 3 and 10, two processes' (1, 2) mesh
    mesh_engine_launches = check_mesh_engines(counted, phase3, phase10)
    done(29)
    # 30. ROADMAP item 12.2 over the rendered mesh: speculative decoding,
    # the host swap tier and the slot pool under seq_sharded (kernel #5 at
    # each row's own depth), one NCCL rank and two processes over gloo
    item12_launches, item12_parts = check_item12(counted, spec_tokens,
                                                 victims, phase10)
    done(30)
    # 31. the port's linter in-process, and a host-sync census of the
    # fused steps (phases 3 and 4's engines under the sync debug mode)
    check_lint_and_syncs(dev)
    done(31)
    report[2]["rings_int8"] = ring_q
    report[2]["modality"] = {"gqa7 serving mix int8":
                             mod_paged.pop("gqa7 serving mix int8")}
    report[0]["modality"] = mod_paged
    report[3]["modality"] = mod_flash
    for k in report:
        k["quant_recurrent_launches"] = qr_launches.get(k["name"], 0)
        k["modality_launches"] = mod_launches.get(k["name"], 0)
        if k["name"] in swap_launches:
            k["swap_launches"] = swap_launches[k["name"]]
        if k["name"] in spec_launches:
            k["spec_launches"] = spec_launches[k["name"]]
        k["zoo_launches"] = zoo.get(k["name"], 0)
        k["rollout_launches"] = rollout_launches.get(k["name"], 0)
        k["elastic_launches"] = elastic_launches.get(k["name"], 0)
        k["sharded_launches"] = sharded_launches.get(k["name"], 0)
        k["mesh_launches"] = mesh_launches.get(k["name"], 0)
        k["mesh_modality_launches"] = modality_mesh_launches.get(k["name"], 0)
        k["dryrun_launches"] = dryrun_launches.get(k["name"], 0)
        k["mesh_engine_launches"] = mesh_engine_launches.get(k["name"], 0)
        k["item12_launches"] = item12_launches.get(k["name"], 0)
        k["item12_launches_by_part"] = {
            p: n.get(k["name"], 0) for p, n in item12_parts.items()}
    report[-1]["seq_sharded"] = fd_seq
    report[-1]["seq_sharded_cross"] = fd_cross
    report[-1]["per_row"] = fd_per_row

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": report}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-rank"]:  # phase 25's part (b)
        sharded_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        sys.exit(0)
    if sys.argv[1:2] == ["--mesh-rank"]:  # phase 26's parts (b) and (c)
        mesh_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        sys.exit(0)
    if sys.argv[1:2] == ["--modality-rank"]:  # phase 27's parts (b), (c)
        modality_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        sys.exit(0)
    if sys.argv[1:2] == ["--engine-rank"]:  # phase 29's part (b)
        mesh_engine_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        sys.exit(0)
    if sys.argv[1:2] == ["--item12-rank"]:  # phase 30's part (b)
        item12_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        sys.exit(0)
    sys.exit(main())
