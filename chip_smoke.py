#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: the quickest proof that the port builds, is right, and serves.

    python3 chip_smoke.py [--seed N] [--only flash_bwd|mesh|graph|train]

(``--only flash_bwd`` runs the device and build phases and the flash
backward's cases alone, with a profile of its kernels; ``--only mesh``
the device, build, serve and mesh phases; ``--only graph`` the device,
build, serve, chunked and audit phases, every cell of the serving
entry points without rules; ``--only train`` the device, build and train
phases; none prints a result line.)

Phases, in order; any failure exits non-zero before the last line:

1. device  — require CUDA, print the card's name and power limit, turn
             TF32 off for float32 matrix products and convolutions;
2. build   — compile every ``csrc/*.cu`` of the port with nvcc (sm_90a);
3. kernels — each hand-written kernel against its plain PyTorch version on
             the card, at the serving path's shapes (the attention kernels
             also at the edges of their designs: ragged decode with one
             slot at the cache's end, every slot at 0, positions at the
             chosen split's edges and past the cache, rep 16, hd 128, and
             the MoE family's 16/8 heads (rep 2), the hybrid's 32/8,
             hd 128 (rep 4), and the vlm's 64/8, hd 128 (rep 8) at its
             cross cache of 1601 rows and its self cache; flash prefill at
             2048 and 17 tokens, hd 128, Sq != Skv, 992 tokens at 16/8 and
             at 32/8, hd 128, the vlm's self (992 causal) and cross (992
             queries, 1601 image keys) prefills at 64/8, hd 128, and
             hubert-xlarge's 8 x 1000 frames at 16/16, hd 80 in bf16 and
             float32; the training path's flash attention: the forward's
             log-sum-exp and the backward's dq, dk, dv against
             ``attention_ref_lse`` / ``attention_ref_backward`` at qwen2's
             training shape (8 x 1024, 14/2, hd 64, causal), 17 and 1000
             tokens, 16/8, 32/8 at hd 128, the vlm's cross case (992 x
             1601, 64/8, non-causal), hubert's 16/16 at hd 80 and float32
             at hd 64, 80 and 128, each backward called twice and the
             two bitwise equal, with the backward and forward +
             backward timed against SDPA's;
             chunked prefill at the first and last chunks of a 2048-token
             prompt, B=4, rep 16 and hd 128 over B=8 mixed starts, and
             chunks crossing, starting at and starting past the cache's
             end, and a chunk longer than the cache (T > Smax) from 0 and
             from a later start; the matmul on the TAO product and its 16- and 32-row
             slices, each timed beside ``torch.matmul`` on the same rows,
             and on unaligned and ragged shapes; the sort at the
             runtime's three row lengths with its kernel launches per
             call counted, and past a cluster), with max abs error and
             limit, kernel / plain / library (SDPA) time from CUDA events
             with the L2 cache flushed before every launch, the least
             time the card could take (bytes over memory rate or
             operations over peak rate, whichever is larger), and the
             launch floor (an empty kernel under the same timing);
4. train   — qwen2-0.5b trained at full width (24 layers, 14/2 heads of
             64, vocab 151,936; float32 masters and AdamW state, bf16
             compute), random weights from the seed, through
             ``repro_torch.launch.train``'s ``run`` on SyntheticLMData
             batches of 8 x 1024, its steps on the donated step's cell
             (``models/graphs.py`` ``TrainGraph``: step 1 runs eagerly
             and is captured as one CUDA graph, steps 2-20 replay it, the
             state updated in place): 20 steps with finite, falling
             losses (all printed) and exact launch counts (flash forward
             two a layer a step, a forward and the recompute of the
             checkpointed block; the flash backward one a layer a step),
             no copy of dO on the way (``dout_copies`` 0) and one cell
             built; step p50, tokens/s, MFU against 989 TFLOP/s, the
             capture's time, peak memory allocated and reserved; after
             step 20 (a replay) every parameter has a finite, nonzero
             gradient; the same 20 steps run eagerly through
             ``TrainStep`` from the same seed, their p50 beside the
             cell's, losses and final state bitwise the cell's; one
             replayed step profiled (its idle share); one 2 x 256 batch's
             loss and gradient norm against the port's own CPU run
             (float32, plain versions) within stated limits; one eager
             step profiled with the forward and backward and AdamW as
             ranges; 5 steps on a cell, the state through host memory, 5
             steps on a new cell against 10 straight, bit for bit; two
             steps each of granite-moe-1b-a400m at full width and
             mamba2-130m whole on their cells (losses finite; after the
             replay every dense, attention and SSM parameter with a
             finite nonzero gradient);
5. serve   — qwen2-0.5b at full width, random weights from the seed,
             through ``ServeEngine``: 16 requests with prompts of 64-1024
             tokens and 64 new tokens each, over 8 slots in chunks of 4,
             the decode on its CUDA graph (``models/graphs.py``: exactly
             one cell built for the engine, its capture time printed);
             every request must finish with 64 in-vocabulary tokens, the
             decode and whole-prompt prefill kernels must have launched
             exactly as often as the run's prefills and steps say; the
             same prompts through an engine on the eager loop the cell
             captures give the same 16 streams and launches (tok/s, TPOT,
             TTFT and a profiled window's busy and idle shares of both);
             the same prompts on a legacy engine (``fused=False``, one
             token a step on its ``decode_step`` cell) give the same 16
             streams, 24 ragged decodes a token step and the cell's
             build; and a session exported mid-decode and imported into a
             second engine must continue the same token stream as the
             unmigrated request;
6. chunked — the same 16 prompts through a second engine that prefills in
             chunks of 256 tokens (the ``ragged_prefill`` kernel), 16 new
             tokens each, the chunk on the engine's one chunk cell (its
             CUDA graph, built as the engine allocates its working
             prefill cache): every request finishes in vocabulary, and
             the chunk, decode and whole-prompt kernels launched exactly
             as often as the run's chunks, decode steps and cell builds
             say; the same requests on an engine that calls the chunk
             eagerly give the same streams (TTFT and chunk latency of
             both); a prefill exported after 2 of 4 chunks and a
             ``role="prefill"`` engine handing its sessions to a
             ``role="decode"`` engine both continue the unmigrated
             chunked stream token for token; the chunked and
             whole-prompt prefills of the longest prompt agree on its
             last-token logits within a stated limit; and its chunked
             prefill is traced on the cell and eagerly, the
             ``ragged_prefill`` kernels in each trace equal to the calls
             counted (idle shares of both);
7. wire    — the serve phase's model: a session exported mid-decode and a
             prefill exported after 2 of its chunks travel as wire bytes
             (``export_session_wire``) over a ``LoopbackTransport`` to a
             second engine and continue the unmigrated streams token for
             token; payload bytes, codec and the host's encode and decode
             times; a payload with a flipped bit is refused;
8. fleet   — the serve phase's model and prompts behind ``FleetGateway``
             over three replicas that share its parameters (8 slots,
             chunks of 4 each): (1) monolithic replicas, 32 new tokens a
             request and short follow-ups (the router's probe traffic),
             with a co-tenant (``stream_copy`` over 1 GiB, 3x replica 1's
             baseline step) enqueued before each of replica 1's steps for
             a window of pumps: the interference detector must quarantine
             replica 1 inside the window and readmit it after, and the
             drain must migrate every live non-probe session off it; then
             a forced quarantine of the busiest replica of a fresh fleet
             (migrations = its live sessions); (2) a seeded
             ``FaultInjector`` crash of replica 2 with heartbeats and a
             ``LoopbackTransport``: every request done, the crash counters
             nonzero; (3) one ``role="prefill"`` replica (chunks of 256)
             handing every session to two ``role="decode"`` replicas over
             a ``LoopbackTransport``, 16 new tokens a request, with
             telemetry (spans, metrics, an SLO monitor, a time series)
             off and on.  Every stream equals its solo stream (chunked in
             run 3), and each kernel's launches equal what the engines'
             own counts of prefills, chunks and decode steps (and the
             co-tenant's launches) give; client TTFT, TPOT, tok/s, wall
             per pump, drift ratios, the migration pause, the handoff's
             TTFT breakdown, alerts and peak memory are printed;
9. region  — the serve phase's model behind ``RegionGateway`` over two
             fleets of two replicas each (8 slots, chunks of 4): 8 of the
             serve phase's prompts (64-1024 tokens), 16 new tokens each,
             all entering at region 0 and staying home (the link's RTT row
             trained first); after 3 pumps fleet 0 is browned out and the
             next pump drains every live session to fleet 1 as wire bytes:
             once over ``ReliableTransport(ChaosTransport(
             LoopbackTransport))`` with ``tests/test_chaos.py``'s region
             faults (drop 0.3, corrupt 0.1, duplicate 0.4, a partition of
             link 0 -> 1 over injector steps [2, 4), 10 attempts, no
             jitter), once over the plain ``LoopbackTransport``.  Fleet 0
             holds no live session after the drain pump, every request is
             served once, duplicates are deduplicated, every stream equals
             its solo stream and each kernel's launches equal the engines'
             counts; ships, wire and raw bytes, host export / encode /
             ship / decode times, the transport's and the injector's
             counts, the drain pass, the moved requests' TTFT and TPOT and
             peak memory are printed;
10. moe    — granite-moe-1b-a400m at full width (24 layers, 16/8 heads,
             32 experts top-8), random weights from the seed: 8 requests
             with prompts of 103-992 tokens and 32 new tokens each, 8
             slots, chunks of 4; every request finishes in vocabulary,
             both attention kernels launch exactly as often as the run's
             prefills and decode steps say, and a session moved through
             the wire mid-decode continues the unmigrated stream; tok/s,
             TPOT, TTFT, peak memory, and a profiled decode window (its
             device-busy share, the MoE layers' and expert products'
             device time);
11. moe-alt — granite-moe-1b-a400m at full width with ``moe_every = 2``
             (the reference's alternating layout, not a published
             checkpoint): 12 superblocks of one SwiGLU dense layer and one
             MoE layer (32 experts top-8), random weights from the seed;
             the MoE phase's 8 prompts, 16 new tokens each, 8 slots,
             chunks of 4; every request finishes in vocabulary, 24 flash
             launches a prefill and 24 ragged decodes a token step, and a
             session moved through the wire mid-decode continues the
             unmigrated stream; tok/s, TPOT, TTFT and peak memory;
12. ssm    — mamba2-130m at full width and depth (24 layers, d_model 768,
             24 SSM heads of 64, state 128, chunk 256), random weights
             from the seed: the MoE phase's 8 prompts and 32 new tokens
             each; every request finishes in vocabulary, no attention
             kernel launches anywhere in the phase, and a session (its
             whole SSM and conv state) moved through the wire mid-decode
             continues the unmigrated stream; tok/s, TPOT, TTFT, peak
             memory, the session's payload and host times, a profiled
             decode window and a 992-token prefill;
13. hybrid — jamba-v0.1-52b at full width cut to one superblock (8 of 32
             layers, the most one card holds: 1 attention layer at 32/8
             heads and hd 128 without RoPE, 7 mamba layers, 4 of them with
             16 experts top-2), the same prompts and 16 new tokens each
             (cut for time); both attention kernels launch exactly once
             per prefill and decode token step, and a wire migration
             mid-decode is identical; tok/s, TPOT, TTFT, peak memory, and
             a profiled decode window split into the attention kernel,
             the MoE routing and dispatch, the expert products, the SSM
             layers and the rest;
14. vlm    — llama-3.2-vision-90b at full width cut to two superblocks
             (10 of 100 layers: 8 self layers and 2 gated cross layers at
             64/8 heads, hd 128, 1601 image tokens), the cross gates set
             nonzero, the same prompts, each with its own seeded image
             (1601 x 8192 float32), 16 new tokens each; exact launch
             counts (10 flash per prefill, 10 ragged decode per token step,
             no ragged prefill); one prompt with two images gives two
             streams; a wire migration mid-decode (the image and the whole
             cross cache travel) is identical; tok/s, TPOT, TTFT, peak
             memory, the weight bytes a step reads and their bound, and a
             profiled decode window split into the self-attention kernel,
             the cross-attention kernel and the rest;
15. audio  — hubert-xlarge at full width and depth (48 layers, 16/16
             heads of 80, 945 M parameters): ``Model.forward`` over 8
             seeded clips of 1000 frames, warmed then timed; logits
             (8, 1000, 504) finite, 48 flash launches a forward, clip 0
             within a stated limit of the plain attention path's; one
             ``Model.prefill``; frames/s, ms a forward, the device-busy
             share, the share of the bf16 peak from the shapes' operations,
             peak memory;
16. checkpoint — the MoE model's parameters cut to 2 layers, written by
             ``params_to_numpy`` + ``save_checkpoint`` and read back by
             ``load_checkpoint`` + ``params_from_numpy`` onto the card: one
             prompt's logits bit-identical; seconds and bytes;
17. runtime — the paper's experiment: the mixed random DAG (150 matmul,
             150 sort, 150 copy tasks, average width 4, edge rate 2)
             through the threaded XiTAO runtime on 4 workers, every TAO
             body running its kernel class (``matmul``, ``bitonic_sort``,
             ``stream_copy``) at the paper's sizes on the card, once under
             the homogeneous work-stealing scheduler and once under the
             PTT's performance-based one: every task placed on a valid
             place, 450 PTT updates, each kernel launched exactly as often
             as its tasks' widths sum to, every output right (matmul
             within 1e-5 relative, copy exact, sort exact per chunk); it
             prints tasks/s, makespan, placements by width and the trained
             PTT, and profiles one run (each kernel class's device time
             in it);
18. paper  — the paper's three results through ``repro_torch.sim``,
             labelled simulated (virtual time under the reference's
             platform models, not times of the card): the quickstart's
             TX2 speedups, the Haswell interference run and the VGG-16
             strong-scaling study, each run twice and the two runs equal,
             the mixed DAG's speedup above 1 and the VGG makespan falling
             with the cores; then ``repro_torch.examples.vgg16_classify``'s
             real forward on the card: 8 GEMM TAOs over 2 workers, each
             chunk one ``matmul`` launch into its block and a ReLU on the
             worker's stream; launches equal the TAOs' widths (plus the
             representative layer's one), the activations within 1e-5
             relative of the same forward through ``matmul_ref`` (TF32
             off), the representative (128 x 16) x (16 x 128) layer within
             1e-4 of ``matmul_ref``, its wall time; then the device time
             of each body chunk the run recorded (one a launch, or the
             phase fails), its matmul and its ReLU each replayed alone on
             the same tensors as the kernels phase times a kernel;
19. examples — ``serve_lm``, ``fleet_serve``, ``region_serve``,
             ``slo_smoke`` and ``train_lm`` (20 steps: 10, then a resume to
             20) through their ``main`` on the card, on the reference
             examples' reduced configs with heads widened to 64 (the
             narrowest the attention kernels take; the CPU tests run the
             same configs): every request done in vocabulary, the
             attention kernels launched, losses finite.
The serving families (10-14) each run their prompts on the graph and
again on the eager loop: the same streams and launches, one cell built.
The fleet and region replicas build their decode cells before traffic,
and fleet run 3's prefill replica its chunk cell (one, its build's 24
``ragged_prefill`` launches counted).
Between the region and the MoE phases, the audit (20): the serve phase's
model's ``decode_fused`` (B 8, k 4: the call building its graph, then a
replay) and ``prefill_chunk`` (T 256) under
``torch.cuda.set_sync_debug_mode("error")``, every cache tensor keeping
its ``data_ptr`` and no op returning float64, a decode that reads a
token on the host caught; the retrace budget (one graph per (batch,
chunk) cell for the five families' widened reduced configs over (2, 3)
x (1, 4), one per batch for the dense family's ``prefill_chunk``, and
for the serve model at B 8, k 4 and T 256; a decode that builds a
cell every call caught); then ``python -m repro_torch.analysis`` (lint,
contracts and the audit of all five families on the card) exiting 0.
After the audit, the mesh phase (21): a one-rank NCCL process group
(``repro_torch.distributed.ranks.process_group``, card 0 bound; a failure
to initialise fails the phase) and a (data 1, model 1) ``DeviceMesh``;
under ``use_rules`` the serve phase's model on 4 of its prompts, 64 new
tokens each, through the sharded dense layers (``distributed/tp.py``:
every all-gather, reduce-scatter and all-reduce at group size 1; tokens
identical to the same prompts without rules, the decode on one cell
captured under the NCCL layout, 24 flash launches a prefill, 4 x 24
ragged decodes a step and a build, the cost counter's kernel calls
equal to them, the collectives printed by kind; a decode chunk's cell
built and replayed on new tokens under the layout, bitwise the eager
loop on a twin cache, then both traced: the same kernels, the NCCL
annotations by kind of the eager trace beside the counter's), one
qwen2-0.5b 8 x 1024
train step under rules (loss within 1e-6 relative of the step without
them, 48 flash and 24 flash-backward launches) and two through the
launcher's donated step on its cell captured under the layout (both
losses bitwise the eager step's under rules, launches exact),
granite-moe-1b-a400m's 8 x 1024 prefill through ``moe_ep`` (2 x 24
``all_to_all_single`` calls, 24 flash launches, logits bitwise equal to
the prefill without rules, both timed with CUDA events),
``compressed_allreduce_demo`` over 16.8 MB of f32 on a (pod 1, data 1)
mesh (within half the int8 step of ``x``) and ``elastic_remesh`` of
qwen2-0.5b's training state (params, m, v: 5.9 GB of f32) onto a fresh
mesh, timed, after which one 8 x 1024 train step is bitwise equal to one
without the move.  Then, in the same group: the chunked phase's
requests served chunked under rules (the chunks through
``ragged_prefill`` with its log-sum-exp, merged over ``model``, on one
chunk cell and one decode cell captured under the layout; tokens as the
chunked phase's, 24 ``ragged_prefill`` launches a chunk and a build),
mamba2-130m's 8 x 1024 prefill with the SSD on the rank's block of
heads (logits and caches bitwise), the qwen2 step with
``microbatches=2`` and ``compress_dcn`` (loss bitwise the step without
rules; two steps on its cell under the layout held as above) and ``launch.train.run`` on the mesh with a checkpoint directory
(the step-4 checkpoint bitwise the run's state; resumed from step 3
without a mesh, the fourth loss bitwise the mesh run's).  The group is
destroyed before the next part: two gloo ranks on the one card (gloo
takes CUDA tensors for every collective ``tp`` runs) run qwen2-0.5b's
chunked prefill on a (data 1, model 2) mesh, each rank on its half of a
2048-row cache (chunks crossing the halves' boundary and the cache's
end, padded rows, qlen 0): logits against the unsharded chunked prefill
within 2^-4 of the largest logit, 24 launches a chunk on each rank,
no cell built under the gloo layout (its collectives run on the host).
Then, without a group: ``ragged_decode``'s log-sum-exp output against its
plain version (B 8, Smax 2048, 14/2 heads, positions mixed) and two
half-cache calls merged by it against one whole-cache call; the cost
counter (``distributed/cost.py``) over a real decode chunk and prefill
of the serve model, its kernel calls equal to the launch counters and
its FLOPs to a fake-tensor trace of the same steps; the H100 roofline's
terms for the train step and a decode step beside their measured device
times (the train step a replay of its cell); and ``python -m repro_torch.launch.dryrun`` for qwen2-0.5b x
train_4k x single in a subprocess (exit 0, its wall time).

The kernels phase also holds the runtime's kernels and ``stream_scale_add``
against their plain versions (``torch.matmul``, ``dst.copy_(src)``, the
``a * x + b * y`` expression and ``torch.sort`` are the library times).
Each serve and runtime phase prints its peak device memory.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.  Nothing of JAX or of the JAX
package is imported.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# card name substring -> (memory bytes/s, bf16 dense FLOP/s, f32 FLOP/s),
# NVIDIA data sheets; the SXM part is the default.  phase_device appends
# the card's 32-bit min/max rate (the sort's bound).
PEAKS = {"PCIe": (2.0e12, 756e12, 51e12),
         "NVL": (3.9e12, 835e12, 60e12),
         "SXM": (3.35e12, 989e12, 67e12)}

N_TIMED = 20
TRAIN_BATCH = 8              # the train phase's global batch and sequence
TRAIN_SEQ = 1024
SPIN_CYCLES = 2_000_000      # ~1 ms of device time at the H100's clock


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    peaks = next((v for k, v in PEAKS.items() if k in name), PEAKS["SXM"])
    # 32-bit compare / min / max: 64 results per clock per SM at compute
    # capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
    # throughput), at the card's own SM count and maximum SM clock
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    check(clk.returncode == 0, f"nvidia-smi failed: {clk.stderr.strip()}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    minmax = sms * 64 * float(clk.stdout.split()[0]) * 1e6
    peaks = (*peaks, minmax)
    print(f"[device] {name} x{torch.cuda.device_count()}; peaks used for "
          f"bounds: {peaks[0]:.3g} B/s, {peaks[1]:.3g} bf16 FLOP/s, "
          f"{peaks[2]:.3g} f32 FLOP/s, {minmax:.4g} 32-bit min/max per s "
          f"({sms} SMs x 64 x {clk.stdout.split()[0]} MHz)")
    return card, name, peaks


# ---------------------------------------------------------------------------
# 3. kernels
# ---------------------------------------------------------------------------

def time_ms(torch, fn, flush) -> float:
    """Mean device time of ``fn`` over N_TIMED launches, each timed with
    CUDA events after an L2 flush (the serving path reads every layer's
    cache and weights cold).  A spin kernel keeps the device busy while
    the host enqueues ``fn``, so the events hold device time only, not
    the host's dispatch of the wrapper."""
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(N_TIMED):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / N_TIMED


def bound(peaks, nbytes: float, nops: float, dtype_is_bf16: bool,
          rate: float | None = None):
    """The least time in ms: bytes over the memory rate or operations over
    ``rate`` (default the bf16 or f32 peak), whichever is larger."""
    t_bytes = nbytes / peaks[0]
    t_ops = nops / (rate or (peaks[1] if dtype_is_bf16 else peaks[2]))
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ragged_decode_case(torch, F, rd, gen, peaks, flush, dt, Smax, tol,
                       B=8, Hq=14, Hkv=2, hd=64, pos=None):
    """One decode step of attention; ``pos`` None draws each slot's
    position, with slot 0 at 0 and slot 1 at the cache's last row."""
    dev = "cuda"
    q = torch.randn(B, Hq, hd, generator=gen, device=dev).to(dt)
    k = torch.randn(B, Smax, Hkv, hd, generator=gen, device=dev).to(dt)
    v = torch.randn(B, Smax, Hkv, hd, generator=gen, device=dev).to(dt)
    if pos is None:
        pos = torch.randint(0, Smax, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
        pos[0], pos[1] = 0, Smax - 1
    else:
        pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    launches0 = rd.launches
    out = rd.ragged_decode_attention(q, k, v, pos)
    ref = rd.ragged_decode_ref(q, k, v, pos)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "ragged_decode: non-finite output")
    err = (out - ref).abs().max().item()
    label = (f"ragged_decode {str(dt)[6:]} B={B} Smax={Smax} Hq={Hq} "
             f"Hkv={Hkv} hd={hd}")
    check(err <= tol, f"{label}: max abs err {err} > {tol}")
    ms = time_ms(torch, lambda: rd.ragged_decode_attention(q, k, v, pos),
                 flush)
    plain_ms = time_ms(torch, lambda: rd.ragged_decode_ref(q, k, v, pos),
                       flush)
    # library yardstick: one SDPA call with a per-slot mask
    mask = (torch.arange(Smax, device=dev)[None, :]
            <= pos[:, None].long())[:, None, None, :]
    qs, ks, vs = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, enable_gqa=True), flush)
    rd.launches = launches0            # comparison launches do not count
    es = q.element_size()
    rows = int((pos.clamp(max=Smax - 1) + 1).sum().item())
    nbytes = (q.numel() * es + 2 * rows * Hkv * hd * es + pos.numel() * 4
              + out.numel() * 4)
    nops = 4 * Hq * hd * rows
    bms, by = bound(peaks, nbytes, nops, dt == torch.bfloat16)
    n_split, L = rd.split_geometry(B, Hkv, Smax, rd.sm_count(0))
    pos_s = pos.tolist() if B <= 8 else "drawn"
    print(f"[kernel] {label} pos={pos_s} live_rows={rows} split={n_split}x"
          f"{L}: max_abs_err={err:.3g} (limit {tol}) ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
          f"bound_ms={bms:.5f} ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)


def flash_case(torch, F, fa, gen, peaks, flush, dt, S, causal, tol,
               Skv=None, hd=64, Hq=14, Hkv=2, B=1):
    Sq, Skv = S, Skv or S
    dev = "cuda"
    # the model's (B, S, H, hd) activations, passed as (B, H, S, hd) views
    q = torch.randn(B, Sq, Hq, hd, generator=gen, device=dev).to(dt)
    k = torch.randn(B, Skv, Hkv, hd, generator=gen, device=dev).to(dt)
    v = torch.randn(B, Skv, Hkv, hd, generator=gen, device=dev).to(dt)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    launches0 = fa.launches
    out = fa.flash_attention(qt, kt, vt, causal=causal)
    ref = fa.attention_ref(qt, kt, vt, causal=causal)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "flash_attention: non-finite")
    err = (out.float() - ref.float()).abs().max().item()
    label = (f"flash_attention {str(dt)[6:]} B={B} Sq={Sq} Skv={Skv} Hq={Hq} "
             f"Hkv={Hkv} hd={hd} causal={causal}")
    check(err <= tol, f"{label}: max abs err {err} > {tol}")
    ms = time_ms(torch, lambda: fa.flash_attention(qt, kt, vt,
                                                   causal=causal), flush)
    plain_ms = time_ms(torch, lambda: fa.attention_ref(qt, kt, vt,
                                                       causal=causal), flush)
    qc, kc, vc = qt.contiguous(), kt.contiguous(), vt.contiguous()
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qc, kc, vc, is_causal=causal, enable_gqa=True), flush)
    fa.launches = launches0
    es = q.element_size()
    nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * es
    # causal positions start at 0 on both sides: query i sees keys 0..i
    pairs = (sum(min(i + 1, Skv) for i in range(Sq)) if causal
             else Sq * Skv)
    nops = 4 * B * Hq * hd * pairs
    bms, by = bound(peaks, nbytes, nops, dt == torch.bfloat16)
    print(f"[kernel] {label}: max_abs_err={err:.3g} (limit {tol}) "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
          f"bound_ms={bms:.5f} ({by}) kernel/library="
          f"{ms / lib_ms:.2f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)


def _attn_pairs(Sq: int, Skv: int, causal: bool) -> int:
    """(query, key) pairs attention computes: query i sees keys 0..i when
    causal (positions from 0 on both sides), every key otherwise."""
    return (sum(min(i + 1, Skv) for i in range(Sq)) if causal
            else Sq * Skv)


def flash_bwd_case(torch, F, fa, gen, peaks, flush, dt, S, causal, rel_tol,
                   lse_tol, Skv=None, hd=64, Hq=14, Hkv=2, B=1):
    """The training path's attention at one shape: the forward's log-sum-
    exp against ``attention_ref_lse``, and dq, dk, dv of the backward
    kernels (fed the kernel forward's output and LSE) against
    ``attention_ref_backward`` fed the plain forward's.  A gradient's
    limit is ``rel_tol`` times its reference's largest magnitude; a
    second backward call on the same inputs must give bitwise-equal dq,
    dk and dv (no float atomics, fixed summation order).  Times:
    the backward alone (kernel, plain, and SDPA's backward on a retained
    graph), the forward with the LSE against SDPA's forward in grad mode,
    and forward + backward (the LSE forward and the backward
    kernels against SDPA's forward and ``autograd.grad``), each against
    its bound."""
    Sq, Skv = S, Skv or S
    dev = "cuda"
    mk = lambda s, h: torch.randn(B, s, h, hd, generator=gen,
                                  device=dev).to(dt).transpose(1, 2)
    q, k, v, dO = mk(Sq, Hq), mk(Skv, Hkv), mk(Skv, Hkv), mk(Sq, Hq)
    n_f, n_b = fa.launches, fa.bwd_launches
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal, lse=True)
    grads = fa.flash_attention_backward(q, k, v, out, dO, lse,
                                        causal=causal)
    out_r, lse_r = fa.attention_ref_lse(q, k, v, causal=causal)
    refs = fa.attention_ref_backward(q, k, v, out_r, dO, lse_r,
                                     causal=causal)
    torch.cuda.synchronize()
    label = (f"flash_attention_bwd {str(dt)[6:]} B={B} Sq={Sq} Skv={Skv} "
             f"Hq={Hq} Hkv={Hkv} hd={hd} causal={causal}")
    check(bool(torch.isfinite(lse).all()), f"{label}: non-finite lse")
    lse_err = (lse - lse_r).abs().max().item()
    check(lse_err <= lse_tol, f"{label}: lse max abs err {lse_err} > "
          f"{lse_tol}")
    errs = []
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        check(bool(torch.isfinite(g).all()), f"{label}: non-finite {name}")
        err = (g.float() - r.float()).abs().max().item()
        lim = rel_tol * r.float().abs().max().item()
        check(err <= lim, f"{label}: {name} max abs err {err} > {lim}")
        errs.append((name, err, lim))
    again = fa.flash_attention_backward(q, k, v, out, dO, lse, causal=causal)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(grads, again)),
          f"{label}: two backward calls on the same inputs differ")
    del again
    bwd = lambda: fa.flash_attention_backward(q, k, v, out, dO, lse,
                                              causal=causal)
    ms = time_ms(torch, bwd, flush)
    plain_ms = time_ms(torch, lambda: fa.attention_ref_backward(
        q, k, v, out_r, dO, lse_r, causal=causal), flush)
    plain_fwd_ms = time_ms(torch, lambda: fa.attention_ref_lse(
        q, k, v, causal=causal), flush)

    fwd_ms = time_ms(torch, lambda: fa.flash_attention_forward(
        q, k, v, causal=causal), flush)
    fwd_lse_ms = time_ms(torch, lambda: fa.flash_attention_forward(
        q, k, v, causal=causal, lse=True), flush)

    def ours():
        o, l = fa.flash_attention_forward(q, k, v, causal=causal, lse=True)
        return fa.flash_attention_backward(q, k, v, o, dO, l, causal=causal)
    fwd_bwd_ms = time_ms(torch, ours, flush)
    qc, kc, vc = (t.detach().contiguous().requires_grad_(True)
                  for t in (q, k, v))
    doc = dO.contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(
        qc, kc, vc, is_causal=causal, enable_gqa=True)
    lib_fwd_ms = time_ms(torch, sdpa, flush)    # grad mode, as training
    kept = sdpa()
    lib_ms = time_ms(torch, lambda: torch.autograd.grad(
        kept, (qc, kc, vc), doc, retain_graph=True), flush)
    lib_fwd_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
        sdpa(), (qc, kc, vc), doc), flush)
    del kept
    fa.launches, fa.bwd_launches = n_f, n_b    # checks do not count
    es = q.element_size()
    n_q, n_kv = B * Hq * Sq * hd, B * Hkv * Skv * hd
    pairs = _attn_pairs(Sq, Skv, causal)
    # backward: reads q, k, v, o, dO and lse, writes dq, dk, dv; five
    # products of 2 * hd operations per (head, pair)
    bms, by = bound(peaks, (4 * n_q + 4 * n_kv) * es + B * Hq * Sq * 4,
                    10 * B * Hq * hd * pairs, dt == torch.bfloat16)
    # the forward with the LSE: reads q, k, v, writes o and lse; two
    f_bms, f_by = bound(peaks, (2 * n_q + 2 * n_kv) * es + B * Hq * Sq * 4,
                        4 * B * Hq * hd * pairs, dt == torch.bfloat16)
    # forward + backward: reads q, k, v, dO, writes o, dq, dk, dv; seven
    fb_bms, fb_by = bound(peaks, (4 * n_q + 4 * n_kv) * es,
                          14 * B * Hq * hd * pairs, dt == torch.bfloat16)
    print(f"[kernel] {label}: lse max_abs_err={lse_err:.3g} (limit "
          f"{lse_tol}); "
          + ", ".join(f"{n} {e:.3g} (limit {lim:.3g})" for n, e, lim in errs)
          + f", a second call bitwise equal; backward ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
          f"bound_ms={bms:.5f} ({by}) kernel/library={ms / lib_ms:.2f}; "
          f"forward+backward ms={fwd_bwd_ms:.4f} library_ms="
          f"{lib_fwd_bwd_ms:.4f} bound_ms={fb_bms:.5f} ({fb_by}) "
          f"kernel/library={fwd_bwd_ms / lib_fwd_bwd_ms:.2f}; forward "
          f"ms={fwd_ms:.4f}, with the LSE {fwd_lse_ms:.4f} (plain "
          f"{plain_fwd_ms:.4f}, library_ms={lib_fwd_ms:.4f}, bound_ms="
          f"{f_bms:.5f} ({f_by}))")
    return dict(max_abs_err=max(e for _, e, _ in errs),
                lse_err=lse_err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms, fwd_bwd_ms=fwd_bwd_ms,
                lib_fwd_bwd_ms=lib_fwd_bwd_ms, fwd_bwd_bound_ms=fb_bms,
                fwd_ms=fwd_ms, fwd_lse_ms=fwd_lse_ms,
                plain_fwd_ms=plain_fwd_ms, lib_fwd_ms=lib_fwd_ms)


# the backward's limits, relative to each gradient's largest magnitude:
# bf16 rounds P and dS to bf16 (2^-9 relative) as product operands and the
# gradient once more on output; float32 differs in summation order only.
# The LSE's: absolute, natural-log units (values ~ ln Skv)
BWD_REL_TOL = {"bf16": 2e-2, "f32": 1e-4}
LSE_TOL = {"bf16": 1e-3, "f32": 1e-4}


def flash_bwd_cases(torch, F, fa, gen, peaks, flush):
    """The backward at the training path's shapes and its edges: qwen2's
    training shape first (its numbers go into the kernels line), the
    tails (17 and 1000 tokens), the MoE family's 16/8 heads, hd 128 at
    32/8, the vlm's cross case (992 queries, 1601 keys, non-causal,
    64/8), hubert's 16/16 at hd 80, and float32 at hd 64, 80 and 128."""
    bf16, f32 = torch.bfloat16, torch.float32
    b = dict(rel_tol=BWD_REL_TOL["bf16"], lse_tol=LSE_TOL["bf16"])
    f = dict(rel_tol=BWD_REL_TOL["f32"], lse_tol=LSE_TOL["f32"])
    case = lambda dt, S, causal, **kw: flash_bwd_case(
        torch, F, fa, gen, peaks, flush, dt, S, causal, **kw)
    return [case(bf16, TRAIN_SEQ, True, B=TRAIN_BATCH, **b),
            case(bf16, 17, True, B=2, **b),
            case(bf16, 1000, True, B=2, **b),
            case(bf16, TRAIN_SEQ, True, B=2, Hq=16, Hkv=8, **b),
            case(bf16, TRAIN_SEQ, True, B=2, Hq=32, Hkv=8, hd=128, **b),
            case(bf16, 992, False, Skv=VLM_IMAGE_TOKENS, Hq=64, Hkv=8,
                 hd=128, **b),
            case(bf16, 1000, False, B=8, Hq=16, Hkv=16, hd=80, **b),
            case(f32, 333, True, **f),
            case(f32, 100, False, Skv=300, Hq=16, Hkv=16, hd=80, **f),
            case(f32, 200, True, Hq=32, Hkv=8, hd=128, **f)]


def phase_flash_bwd(torch, seed, peaks, card):
    """``--only flash_bwd``: the backward's cases of the kernel phase
    alone, then one profiled window of three backward calls at the
    training shape and at each bf16 case where the backward loses to
    SDPA's, which splits its device time by kernel (stats pass, dQ, dK /
    dV).  Prints no result line."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    flash_bwd_cases(torch, F, fa, gen, peaks, flush)
    # (B, Sq, Skv, Hq, Hkv, hd, causal)
    for B, Sq, Skv, Hq, Hkv, hd, causal in (
            (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 14, 2, 64, True),
            (2, 1000, 1000, 14, 2, 64, True),
            (1, 992, VLM_IMAGE_TOKENS, 64, 8, 128, False),
            (8, 1000, 1000, 16, 16, 80, False)):
        mk = lambda s, h: torch.randn(B, s, h, hd, generator=gen,
                                      device="cuda").to(torch.bfloat16)
        q, k, v, dO = (t.transpose(1, 2) for t in (
            mk(Sq, Hq), mk(Skv, Hkv), mk(Skv, Hkv), mk(Sq, Hq)))
        out, lse = fa.flash_attention_forward(q, k, v, causal=causal,
                                              lse=True)
        fa.flash_attention_backward(q, k, v, out, dO, lse, causal=causal)
        _profile_window(torch, lambda: [fa.flash_attention_backward(
            q, k, v, out, dO, lse, causal=causal) for _ in range(3)],
            f"3 flash backward calls, B={B} Sq={Sq} Skv={Skv} {Hq}/{Hkv}, "
            f"hd {hd}, causal={causal}", card)


def ragged_prefill_case(torch, F, rp, gen, peaks, flush, dt, Smax, starts,
                        qlens, tol, timed, T=256, Hq=14, Hkv=2, hd=64):
    """One chunk of T tokens per slot (qwen2-0.5b's heads unless given);
    ``timed`` also gives the kernel / plain / SDPA times and the bound."""
    B = len(starts)
    dev = "cuda"
    q = torch.randn(B, T, Hq, hd, generator=gen, device=dev).to(dt)
    k = torch.randn(B, Smax, Hkv, hd, generator=gen, device=dev).to(dt)
    v = torch.randn(B, Smax, Hkv, hd, generator=gen, device=dev).to(dt)
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    qlen = torch.tensor(qlens, dtype=torch.int32, device=dev)
    launches0 = rp.launches
    out = rp.ragged_prefill_attention(q, k, v, start, qlen)
    ref = rp.ragged_prefill_ref(q, k, v, start, qlen)
    torch.cuda.synchronize()
    rp.launches = launches0            # comparison launches do not count
    check(bool(torch.isfinite(out).all()), "ragged_prefill: non-finite")
    err = (out - ref).abs().max().item()
    label = (f"ragged_prefill {str(dt)[6:]} B={B} T={T} Smax={Smax} "
             f"Hq={Hq} Hkv={Hkv} hd={hd} start={starts} qlen={qlens}")
    check(err <= tol, f"{label}: max abs err {err} > {tol}")
    for b, n in enumerate(qlens):
        check(not bool(out[b, n:].any()), f"{label}: padded rows of slot "
                                          f"{b} are not exact zeros")
    print(f"[kernel] {label}: max_abs_err={err:.3g} (limit {tol}), padded "
          f"rows exact zeros")
    if not timed:
        return dict(max_abs_err=err)
    ms = time_ms(torch, lambda: rp.ragged_prefill_attention(
        q, k, v, start, qlen), flush)
    plain_ms = time_ms(torch, lambda: rp.ragged_prefill_ref(
        q, k, v, start, qlen), flush)
    # library yardstick: one SDPA call with a (B, 1, T, Smax) causal mask
    qpos = start[:, None].long() + torch.arange(T, device=dev)[None, :]
    mask = (torch.arange(Smax, device=dev)[None, None, :]
            <= qpos[:, :, None])[:, None]
    qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, enable_gqa=True), flush)
    rp.launches = launches0
    es = q.element_size()
    rows = sum(s + n for s, n in zip(starts, qlens) if n > 0)
    nbytes = (q.numel() * es + 2 * rows * Hkv * hd * es + 8 * B
              + out.numel() * 4)
    pairs = sum(n * s + n * (n + 1) // 2 for s, n in zip(starts, qlens))
    nops = 4 * Hq * hd * pairs
    bms, by = bound(peaks, nbytes, nops, dt == torch.bfloat16)
    print(f"[kernel] {label}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={lib_ms:.4f} bound_ms={bms:.5f} ({by}) "
          f"kernel/library={ms / lib_ms:.2f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)


PREFILL_LSE_STARTS = [0, 300, 700, 1000, 1500, 1792, 5, 1900]
PREFILL_LSE_QLENS = [256, 256, 200, 0, 256, 256, 1, 148]


def prefill_lse_case(torch, rp, gen, flush, ms_row: float) -> dict:
    """``ragged_prefill``'s log-sum-exp on the card at qwen2-0.5b's shape
    (B=8, Smax 2048, 14/2 heads, hd 64, bf16, T=256, mixed starts, padded
    rows): output and LSE against the plain version's, the output bitwise
    the route without the LSE; then the cache split into 2 and into 4
    blocks along Smax, each block's call at starts made local (negative
    where the block begins past a slot's rows), merged by the LSE against
    the whole cache's kernel without it: within 2e-2, padded rows exactly
    0, no NaN.  The route without the LSE timed at row 3's shape against
    ``ms_row`` (the kernel phase's time of it)."""
    B, T, Smax, Hq, Hkv, hd = 8, 256, 2048, 14, 2, 64
    bf = torch.bfloat16
    q = torch.randn(B, T, Hq, hd, generator=gen, device="cuda").to(bf)
    k = torch.randn(B, Smax, Hkv, hd, generator=gen, device="cuda").to(bf)
    v = torch.randn(B, Smax, Hkv, hd, generator=gen, device="cuda").to(bf)
    start = torch.tensor(PREFILL_LSE_STARTS, dtype=torch.int32, device="cuda")
    qlen = torch.tensor(PREFILL_LSE_QLENS, dtype=torch.int32, device="cuda")
    n0 = rp.launches
    out, lse = rp.ragged_prefill_attention(q, k, v, start, qlen, lse=True)
    whole = rp.ragged_prefill_attention(q, k, v, start, qlen)
    ref, ref_lse = rp.ragged_prefill_ref(q, k, v, start, qlen, lse=True)
    pad = torch.arange(T, device="cuda")[None, :] >= qlen[:, None]
    check(bool(torch.isneginf(lse[pad]).all()) and bool(torch.isfinite(
        lse[~pad]).all()), "ragged_prefill lse: -inf exactly on padded rows")
    err = (out - ref).abs().max().item()
    err_lse = (lse[~pad] - ref_lse[~pad]).abs().max().item()
    check(torch.equal(out, whole), "ragged_prefill: the output with the "
          "log-sum-exp differs from the output without it")
    check(err <= 2e-2 and err_lse <= 1e-3, f"ragged_prefill lse: max abs "
          f"err {err} (limit 2e-2), lse {err_lse} (limit 1e-3)")
    merged_err = {}
    for n in (2, 4):
        Sl = Smax // n
        parts = [rp.ragged_prefill_attention(
            q, k[:, r * Sl:(r + 1) * Sl].contiguous(),
            v[:, r * Sl:(r + 1) * Sl].contiguous(), start - r * Sl, qlen,
            lse=True) for r in range(n)]
        ls = torch.stack([p[1] for p in parts])
        m = ls.amax(0)
        m = torch.where(torch.isfinite(m), m, 0.0)
        w = torch.exp(ls - m)
        den = w.sum(0)
        num = sum(w[r][..., None] * parts[r][0] for r in range(n))
        merged = num / torch.where(den > 0, den, 1.0)[..., None]
        check(bool(torch.isfinite(merged).all()), f"ragged_prefill: NaN or "
              f"inf in the merge of {n} blocks")
        check(not bool(merged[pad].any()), f"ragged_prefill: padded rows "
              f"of the merge of {n} blocks are not exact zeros")
        merged_err[n] = (merged - whole).abs().max().item()
        check(merged_err[n] <= 2e-2, f"ragged_prefill: {n} blocks merged "
              f"by the log-sum-exp differ from the whole cache by "
              f"{merged_err[n]} (limit 2e-2)")
    q1, k1, v1 = q[:1].contiguous(), k[:1].contiguous(), v[:1].contiguous()
    s1 = torch.tensor([768], dtype=torch.int32, device="cuda")
    l1 = torch.tensor([256], dtype=torch.int32, device="cuda")
    ms = time_ms(torch, lambda: rp.ragged_prefill_attention(
        q1, k1, v1, s1, l1), flush)
    ms_lse = time_ms(torch, lambda: rp.ragged_prefill_attention(
        q1, k1, v1, s1, l1, lse=True), flush)
    rp.launches = n0                       # comparison launches
    print(f"[kernel] ragged_prefill log-sum-exp, B={B} T={T} Smax={Smax} "
          f"{Hq}/{Hkv} hd {hd} bf16, start {PREFILL_LSE_STARTS} qlen "
          f"{PREFILL_LSE_QLENS}: out max abs err {err:.3g} (limit 2e-2), "
          f"lse {err_lse:.3g} (limit 1e-3), -inf on padded rows, bitwise "
          f"the output without it; 2 and 4 blocks merged by it against the "
          f"whole cache: {merged_err[2]:.3g}, {merged_err[4]:.3g} (limit "
          f"2e-2), padded rows 0, no NaN; row 3's shape (T=256 at 768): "
          f"{ms:.4f} ms without the LSE ({ms_row:.4f} in the case above; "
          f"0.0190 in PERF.md row 3), {ms_lse:.4f} ms with it")
    return {"max_abs_err": err, "merged": merged_err, "ms": ms,
            "ms_lse": ms_lse}


def _within(torch, out, ref, rtol: float, atol: float):
    """max |out - ref|, and whether every element is within atol + rtol *
    |ref| (numpy's assert_allclose, the reference tests' form)."""
    d = (out.float() - ref.float()).abs()
    return d.max().item(), bool((d <= atol + rtol * ref.float().abs()).all())


def matmul_case(torch, mm, gen, peaks, flush, dt, M, K, N, tol, timed,
                rows=None):
    """(M, K) x (K, N) against the plain version within ``tol`` relative
    and ``tol * sqrt(K)`` absolute, the reference tests' limits.  With
    ``rows = (lo, hi)`` the row slice x[lo:hi] goes into out[lo:hi] of an
    (M, N) output whose other rows must stay untouched, as a TAO chunk
    writes."""
    dev = "cuda"
    x = torch.randn(M, K, generator=gen, device=dev).to(dt)
    y = torch.randn(K, N, generator=gen, device=dev).to(dt)
    launches0 = mm.launches
    label = f"matmul {str(dt)[6:]} ({M},{K})x({K},{N})"
    if rows is None:
        out, ref = mm.matmul(x, y), mm.matmul_ref(x, y)
    else:
        lo, hi = rows
        label += f" rows [{lo}:{hi}) into out[{lo}:{hi}]"
        full = torch.full((M, N), -7.0, dtype=dt, device=dev)
        mm.matmul(x[lo:hi], y, out=full[lo:hi])
        out, ref = full[lo:hi], mm.matmul_ref(x[lo:hi], y)
        torch.cuda.synchronize()
        check(bool((full[:lo] == -7).all() and (full[hi:] == -7).all()),
              f"{label}: rows outside the slice were written")
    torch.cuda.synchronize()
    mm.launches = launches0            # comparison launches do not count
    err, ok = _within(torch, out, ref, tol, tol * math.sqrt(K))
    check(math.isfinite(err) and ok, f"{label}: max abs err {err} beyond "
                                     f"{tol} relative + {tol}*sqrt(K)")
    print(f"[kernel] {label}: max_abs_err={err:.3g} (limit {tol} relative "
          f"+ {tol * math.sqrt(K):.3g} absolute)")
    if not timed:
        return dict(max_abs_err=err)
    # a slice is timed as the TAO body runs it: x[lo:hi] into out[lo:hi]
    lo, hi = rows or (0, M)
    xs, o = x[lo:hi], torch.empty(M, N, dtype=dt, device=dev)[lo:hi]
    ms = time_ms(torch, lambda: mm.matmul(xs, y, out=o), flush)
    plain_ms = time_ms(torch, lambda: mm.matmul_ref(xs, y), flush)
    lib_ms = time_ms(torch, lambda: torch.matmul(xs, y), flush)
    mm.launches = launches0
    es, m = x.element_size(), hi - lo
    bms, by = bound(peaks, (m * K + K * N + m * N) * es, 2 * m * N * K,
                    dt == torch.bfloat16)
    print(f"[kernel] {label}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={lib_ms:.4f} (torch.matmul on the same rows, TF32 "
          f"off) bound_ms={bms:.7f} ({by}) kernel/library="
          f"{ms / lib_ms:.2f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)


def copy_case(torch, sc, src, dst, s_lo, d_lo, m, label):
    """src[s_lo:s_lo+m] copied into dst[d_lo:d_lo+m] of a sentinel-filled
    dst: the chunk exact, the rest of dst untouched."""
    launches0 = sc.copy_launches
    sentinel = dst.clone()
    sc.stream_copy(src[s_lo:s_lo + m], out=dst[d_lo:d_lo + m])
    torch.cuda.synchronize()
    sc.copy_launches = launches0
    exact = torch.equal(dst[d_lo:d_lo + m], src[s_lo:s_lo + m])
    rest = (torch.equal(dst[:d_lo], sentinel[:d_lo])
            and torch.equal(dst[d_lo + m:], sentinel[d_lo + m:]))
    check(exact and rest, f"stream_copy {label}: chunk exact {exact}, rest "
                          f"untouched {rest}")
    nb = m * src.element_size()
    print(f"[kernel] stream_copy {label}: {nb} bytes from byte offset "
          f"{src[s_lo:].data_ptr() % 16} to {dst[d_lo:].data_ptr() % 16} "
          f"(mod 16): exact (limit 0), rest of dst untouched")


def phase_paper_kernels(torch, gen, peaks, flush):
    """The runtime's three kernel classes and scale-add against their
    plain versions: the TAO shapes (64x64x64 f32 and a 16-row slice; the
    16.8 MB int32 copy and chunks of it; sort rows of 65,536, 32,768,
    21,845 and 16,384 int32) and ragged ones."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.bitonic_sort import ops as so
    from repro_torch.kernels.matmul import ops as mm
    from repro_torch.kernels.stream_copy import ops as sc
    bf16, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    dev = "cuda"
    # the TAO product (64x64x64, width 1) and its row slices at widths 4
    # (16 rows) and 2 (32 rows), each timed; the slices of width 3 (21 and
    # 22 rows, not multiples of the kernel's 16-row tile), a ragged shape
    # with unaligned rows, a single row, and the large products; bfloat16
    # last
    mm_cases = [matmul_case(torch, mm, gen, peaks, flush, f32, 64, 64, 64,
                            1e-4, True),
                matmul_case(torch, mm, gen, peaks, flush, f32, 64, 64, 64,
                            1e-4, True, rows=(16, 32)),
                matmul_case(torch, mm, gen, peaks, flush, f32, 64, 64, 64,
                            1e-4, True, rows=(32, 64)),
                matmul_case(torch, mm, gen, peaks, flush, f32, 64, 64, 64,
                            1e-4, False, rows=(0, 21)),
                matmul_case(torch, mm, gen, peaks, flush, f32, 64, 64, 64,
                            1e-4, False, rows=(42, 64)),
                matmul_case(torch, mm, gen, peaks, flush, f32, 37, 19, 23,
                            1e-4, False),
                matmul_case(torch, mm, gen, peaks, flush, f32, 1, 64, 64,
                            1e-4, False),
                matmul_case(torch, mm, gen, peaks, flush, f32, 1000, 700,
                            300, 1e-4, False),
                matmul_case(torch, mm, gen, peaks, flush, bf16, 1000, 700,
                            300, 2e-2, False)]
    # the launch floor: an empty kernel under the same timing
    floor_ms = time_ms(torch, lambda: torch.cuda._sleep(1), flush)
    print(f"[kernel] launch floor: torch.cuda._sleep(1) ms={floor_ms:.4f} "
          f"under the same timing as every case")

    # copy: the paper's 16.8 MB of int32, whole and as a TAO chunk at
    # width 3 (16-byte aligned, as every chunk of it is up to width 7);
    # then a head and a tail around the 16-byte body, and bytes at offsets
    # of unequal alignment
    n = 16_800_000 // 4
    src = torch.randint(0, 255, (n,), generator=gen, device=dev, dtype=i32)
    dst = torch.full((n,), -1, dtype=i32, device=dev)
    copy_case(torch, sc, src, dst, 0, 0, n, "16.8 MB int32, whole")
    dst.fill_(-1)
    copy_case(torch, sc, src, dst, n // 3, n // 3, 2 * n // 3 - n // 3,
              "int32 chunk 1 of 3")
    dst.fill_(-1)
    copy_case(torch, sc, src, dst, 2, 2, n - 3, "int32 elements [2, n-1)")
    src8, dst8 = src.view(torch.uint8), dst.view(torch.uint8)
    dst8.fill_(0xAB)
    copy_case(torch, sc, src8, dst8, 3, 6, 1_000_001, "uint8 3 -> 6")
    dst8.fill_(0xAB)
    copy_case(torch, sc, src8, dst8, 5, 21, 999_999, "uint8 5 -> 21")
    launches0 = sc.copy_launches
    ms = time_ms(torch, lambda: sc.stream_copy(src, out=dst), flush)
    plain_ms = time_ms(torch, lambda: sc.stream_copy_ref(src), flush)
    lib_ms = time_ms(torch, lambda: dst.copy_(src), flush)
    sc.copy_launches = launches0
    bms, by = bound(peaks, 2 * n * 4, 0, False)
    print(f"[kernel] stream_copy 16.8 MB int32: ms={ms:.4f} plain_ms="
          f"{plain_ms:.4f} library_ms={lib_ms:.4f} (dst.copy_(src)) "
          f"bound_ms={bms:.5f} ({by})")
    copy_stats = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                      bound_ms=bms, bound_by=by, library_ms=lib_ms)

    # scale-add, 4.2 M elements, a = 0.9, b = 0.1: float32 is rounded as
    # the plain version rounds it (exact); bfloat16 within 2e-2
    sa_errs = {}
    for dt, lo, limit in ((f32, 0, 0.0), (bf16, 0, 2e-2), (f32, 1, 0.0)):
        x = torch.randn(n + lo, generator=gen, device=dev).to(dt)[lo:]
        y = torch.randn(n + lo, generator=gen, device=dev).to(dt)[lo:]
        out = sc.stream_scale_add(x, y, 0.9, 0.1)
        ref = sc.stream_scale_add_ref(x, y, 0.9, 0.1)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        label = (f"stream_scale_add {str(dt)[6:]} n={n}"
                 + (f" at element offset {lo} (scalar path)" if lo else ""))
        check(err <= limit, f"{label}: max abs err {err} > {limit}")
        print(f"[kernel] {label}: max_abs_err={err:.3g} (limit {limit})")
        sa_errs[(dt, lo)] = err
        # these checks are scale-add's only launches (it is on no path),
        # so they stay in its count
    x = torch.randn(n, generator=gen, device=dev)
    y = torch.randn(n, generator=gen, device=dev)
    o = torch.empty_like(x)
    launches0 = sc.scale_add_launches
    ms = time_ms(torch, lambda: sc.stream_scale_add(x, y, 0.9, 0.1, out=o),
                 flush)
    plain_ms = time_ms(torch, lambda: sc.stream_scale_add_ref(x, y, 0.9, 0.1),
                       flush)
    lib_ms = time_ms(torch, lambda: 0.9 * x + 0.1 * y, flush)
    sc.scale_add_launches = launches0
    bms, by = bound(peaks, 3 * n * 4, 3 * n, False)
    print(f"[kernel] stream_scale_add float32 n={n}: ms={ms:.4f} plain_ms="
          f"{plain_ms:.4f} library_ms={lib_ms:.4f} (0.9 * x + 0.1 * y) "
          f"bound_ms={bms:.5f} ({by})")
    sa_stats = dict(max_abs_err=max(sa_errs[(f32, 0)], sa_errs[(f32, 1)]),
                    ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=lib_ms)

    # sort: the runtime's rows at widths 1, 2, 3 and 4 (65,536, 32,768,
    # 21,845, 16,384 int32: one cluster launch each), rows on one block and
    # on clusters of 2 and of 8 full blocks, ragged and not, float32 with
    # -0.0 and +-inf, and the multi-launch path of a row longer than a
    # cluster holds (140,000)
    sort_stats = None
    for dt, rows, m, timed in (
            (i32, 1, 65536, True), (i32, 1, 32768, True),
            (i32, 1, 16384, True), (i32, 1, 21845, False),
            (f32, 8, 1024, False), (i32, 16, 5000, False),
            (f32, 2, 40000, False), (i32, 2, 70000, False),
            (i32, 1, 140000, False)):
        if dt == i32:
            x = torch.randint(0, 1 << 30, (rows, m), generator=gen,
                              device=dev, dtype=i32)
        else:
            x = torch.randn(rows, m, generator=gen, device=dev)
            x[:, :4] = torch.tensor([-0.0, float("inf"), 0.0, -float("inf")],
                                    device=dev)
        launches0 = so.launches
        out = so.sort_rows(x)
        ref = so.sort_rows_ref(x)
        torch.cuda.synchronize()
        plan = so.sort_plan(m)
        # kernel launches of one call, counted where the library issues them
        lib = _build.library()
        issued0 = lib.bitonic_sort_kernel_launches()
        so.sort_rows(x)
        torch.cuda.synchronize()
        dev_launches = lib.bitonic_sort_kernel_launches() - issued0
        so.launches = launches0
        label = (f"bitonic_sort {str(dt)[6:]} ({rows}, {m}) cluster "
                 f"{plan.C} x {1 << plan.lb}")
        check(torch.equal(out, ref), f"{label}: differs from torch.sort")
        check(dev_launches == plan.device_launches,
              f"{label}: {dev_launches} kernel launches, the plan says "
              f"{plan.device_launches}")
        print(f"[kernel] {label}: exact (limit 0), {dev_launches} kernel "
              f"launch{'es' if dev_launches > 1 else ''} per call")
        if not timed:
            continue
        o = torch.empty_like(x)
        ms = time_ms(torch, lambda: so.sort_rows(x, out=o), flush)
        plain_ms = time_ms(torch, lambda: so.sort_rows_ref(x), flush)
        lib_ms = time_ms(torch, lambda: torch.sort(x, -1), flush)
        so.launches = launches0
        # the work a row sort needs, not this kernel's network: at most
        # n ceil(log2 n) comparisons a row, as a comparison sort needs
        comparisons = rows * m * (m - 1).bit_length()
        bms, by = bound(peaks, 2 * x.numel() * 4, comparisons, False,
                        rate=peaks[3])
        print(f"[kernel] {label}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} (torch.sort) bound_ms={bms:.6f} "
              f"({by}: {2 * x.numel() * 4} bytes at {peaks[0]:.4g} B/s; "
              f"{comparisons} comparisons, n ceil(log2 n), at "
              f"{peaks[3]:.4g} min/max per s) kernel/library="
              f"{ms / lib_ms:.2f}")
        if sort_stats is None:
            sort_stats = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                              bound_ms=bms, bound_by=by, library_ms=lib_ms)
    return {"matmul": dict(mm_cases[0], max_abs_err=max(
                c["max_abs_err"] for c in mm_cases[:-1])),
            "stream_copy": copy_stats,
            "stream_scale_add": sa_stats,
            "bitonic_sort": sort_stats}


def phase_kernels(torch, seed, peaks):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ragged_decode import ops as rd
    from repro_torch.kernels.ragged_prefill import ops as rp
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    # bf16 limit: N(0, 1) inputs, outputs up to ~4 in magnitude, one bf16
    # rounding of p and (flash) of the output; f32: summation order only
    # the serving step first (its numbers go into the kernels line), then
    # a short cache, one slot at the cache's end (the old grid gave it 2
    # blocks), every slot at pos 0, positions at the chosen split's edges
    # and past the cache, rep 16, hd 128; float32 last
    rd_B, rd_Hkv, rd_Smax = 8, 2, 2048
    _, L = rd.split_geometry(rd_B, rd_Hkv, rd_Smax, rd.sm_count(0))
    edges = [L - 1, L, 2 * L - 1, rd_Smax, rd_Smax + 100, 0, 1, 63]
    rd_cases = [ragged_decode_case(torch, F, rd, gen, peaks, flush, bf16,
                                   rd_Smax, 2e-2),
                ragged_decode_case(torch, F, rd, gen, peaks, flush, bf16,
                                   1000, 2e-2),
                ragged_decode_case(torch, F, rd, gen, peaks, flush, bf16,
                                   rd_Smax, 2e-2, B=1, pos=[rd_Smax - 1]),
                ragged_decode_case(torch, F, rd, gen, peaks, flush, bf16,
                                   rd_Smax, 2e-2, pos=[0] * rd_B),
                ragged_decode_case(torch, F, rd, gen, peaks, flush, bf16,
                                   rd_Smax, 2e-2, pos=edges),
                ragged_decode_case(torch, F, rd, gen, peaks, flush, bf16,
                                   rd_Smax, 2e-2, Hq=32),
                ragged_decode_case(torch, F, rd, gen, peaks, flush, bf16,
                                   rd_Smax, 2e-2, hd=128),
                # the MoE family's heads (granite-moe-1b-a400m: 16/8, rep 2)
                ragged_decode_case(torch, F, rd, gen, peaks, flush, bf16,
                                   rd_Smax, 2e-2, Hq=16, Hkv=8),
                # the hybrid family's heads (jamba: 32/8, rep 4, hd 128)
                ragged_decode_case(torch, F, rd, gen, peaks, flush, bf16,
                                   rd_Smax, 2e-2, Hq=32, Hkv=8, hd=128),
                # the vlm's heads (64/8, rep 8, hd 128): its cross decode
                # (Smax 1601, not a multiple of the 64-row tile, every slot
                # at the last image row) and its self decode
                ragged_decode_case(torch, F, rd, gen, peaks, flush, bf16,
                                   VLM_IMAGE_TOKENS, 2e-2, Hq=64, Hkv=8,
                                   hd=128, pos=[VLM_IMAGE_TOKENS - 1] * 8),
                ragged_decode_case(torch, F, rd, gen, peaks, flush, bf16,
                                   rd_Smax, 2e-2, Hq=64, Hkv=8, hd=128),
                ragged_decode_case(torch, F, rd, gen, peaks, flush, f32,
                                   1000, 1e-4)]
    # the serving prompt's size first; then a shorter prompt, non-causal,
    # the longest prompt the serve config admits, a single partial tile,
    # hd 128, non-causal Sq != Skv; float32 last
    fa_cases = [flash_case(torch, F, fa, gen, peaks, flush, bf16, 1000,
                           True, 2e-2),
                flash_case(torch, F, fa, gen, peaks, flush, bf16, 512,
                           True, 2e-2),
                flash_case(torch, F, fa, gen, peaks, flush, bf16, 1000,
                           False, 2e-2),
                flash_case(torch, F, fa, gen, peaks, flush, bf16, 2048,
                           True, 2e-2),
                flash_case(torch, F, fa, gen, peaks, flush, bf16, 17,
                           True, 2e-2),
                flash_case(torch, F, fa, gen, peaks, flush, bf16, 1000,
                           True, 2e-2, hd=128),
                flash_case(torch, F, fa, gen, peaks, flush, bf16, 100,
                           False, 2e-2, Skv=1000),
                # the MoE serve phase's longest prompt at 16/8 heads (rep 2)
                flash_case(torch, F, fa, gen, peaks, flush, bf16, 992,
                           True, 2e-2, Hq=16, Hkv=8),
                # and at the hybrid's 32/8 heads, hd 128 (rep 4)
                flash_case(torch, F, fa, gen, peaks, flush, bf16, 992,
                           True, 2e-2, Hq=32, Hkv=8, hd=128),
                # the vlm's 64/8 heads, hd 128 (rep 8): a self layer's
                # prefill, and a cross layer's (Skv = 1601 image tokens, the
                # last key tile holding one live row)
                flash_case(torch, F, fa, gen, peaks, flush, bf16, 992,
                           True, 2e-2, Hq=64, Hkv=8, hd=128),
                flash_case(torch, F, fa, gen, peaks, flush, bf16, 992,
                           False, 2e-2, Skv=VLM_IMAGE_TOKENS, Hq=64, Hkv=8,
                           hd=128),
                # hubert-xlarge's forward: 8 clips of 1000 frames, 16/16
                # heads, hd 80 (the 128-wide tiles, zero-filled), in bf16
                # and float32
                flash_case(torch, F, fa, gen, peaks, flush, bf16, 1000,
                           False, 2e-2, Hq=16, Hkv=16, hd=80, B=8),
                flash_case(torch, F, fa, gen, peaks, flush, f32, 1000,
                           False, 1e-4, Hq=16, Hkv=16, hd=80, B=8),
                flash_case(torch, F, fa, gen, peaks, flush, f32, 333,
                           True, 1e-4)]
    # the serving chunk (a 4th chunk of 256 tokens), the first and the last
    # chunk of a 2048-token prompt, four serving chunks at once (B=4), a
    # first chunk with a ragged tail, mixed slots (one empty, one ending at
    # the cache edge), rep 16 and hd 128 over B=8 mixed starts, the same
    # at T=77 (a tile's tokens and the cache not multiples), past the
    # cache, a chunk longer than the cache, and float32
    rp_cases = [ragged_prefill_case(torch, F, rp, gen, peaks, flush, bf16,
                                    2048, [768], [256], 2e-2, True),
                ragged_prefill_case(torch, F, rp, gen, peaks, flush, bf16,
                                    2048, [0], [256], 2e-2, True),
                ragged_prefill_case(torch, F, rp, gen, peaks, flush, bf16,
                                    2048, [1792], [256], 2e-2, True),
                ragged_prefill_case(torch, F, rp, gen, peaks, flush, bf16,
                                    2048, [768] * 4, [256] * 4, 2e-2, True),
                ragged_prefill_case(torch, F, rp, gen, peaks, flush, bf16,
                                    2048, [0], [97], 2e-2, False),
                ragged_prefill_case(torch, F, rp, gen, peaks, flush, bf16,
                                    2048, [0, 512, 1948, 1200],
                                    [256, 0, 100, 37], 2e-2, False),
                ragged_prefill_case(torch, F, rp, gen, peaks, flush, bf16,
                                    2048, [0, 300, 700, 1000, 1500, 1792, 5,
                                           64],
                                    [256, 256, 200, 0, 256, 256, 1, 63],
                                    2e-2, True, Hq=32, hd=128),
                ragged_prefill_case(torch, F, rp, gen, peaks, flush, bf16,
                                    333, [0, 256], [77, 77], 2e-2, False,
                                    T=77, Hq=32, hd=128),
                # past the cache (a prompt longer than max_seq, chunked):
                # a chunk crossing Smax, one starting at Smax, and B=4 with
                # both, one past Smax and a ragged tail over the edge
                ragged_prefill_case(torch, F, rp, gen, peaks, flush, bf16,
                                    2048, [2048 - 20], [64], 2e-2, False,
                                    T=64),
                ragged_prefill_case(torch, F, rp, gen, peaks, flush, bf16,
                                    2048, [2048], [64], 2e-2, False, T=64),
                ragged_prefill_case(torch, F, rp, gen, peaks, flush, bf16,
                                    2048, [2048 - 20, 2048, 2100, 2000],
                                    [64, 64, 30, 60], 2e-2, False, T=64),
                # a chunk longer than the cache (T > Smax: the engine's
                # chunk of 256 over a 200-row cache), from 0 and from a
                # start past 0 beside a slot from 0
                ragged_prefill_case(torch, F, rp, gen, peaks, flush, bf16,
                                    200, [0], [256], 2e-2, False),
                ragged_prefill_case(torch, F, rp, gen, peaks, flush, bf16,
                                    200, [60, 0], [256, 230], 2e-2, False),
                ragged_prefill_case(torch, F, rp, gen, peaks, flush, f32,
                                    1000, [980, 1000], [64, 64], 1e-4, False,
                                    T=64),
                ragged_prefill_case(torch, F, rp, gen, peaks, flush, f32,
                                    1000, [300, 0], [256, 5], 1e-4, False),
                ragged_prefill_case(torch, F, rp, gen, peaks, flush, f32,
                                    100, [30], [128], 1e-4, False, T=128)]
    rp_lse = prefill_lse_case(torch, rp, gen, flush, rp_cases[0]["ms"])
    fb_cases = flash_bwd_cases(torch, F, fa, gen, peaks, flush)
    paper = phase_paper_kernels(torch, gen, peaks, flush)
    del flush
    # the line's numbers: the first case of each, the serving path's shape
    return {**paper, "ragged_decode": dict(rd_cases[0], max_abs_err=max(
                c["max_abs_err"] for c in rd_cases[:-1])),
            "flash_attention": dict(fa_cases[0], max_abs_err=max(
                c["max_abs_err"] for c in fa_cases[:-1])),
            # qwen2's training shape; the error over the bf16 cases
            "flash_attention_bwd": dict(fb_cases[0], max_abs_err=max(
                c["max_abs_err"] for c in fb_cases[:-3])),
            "ragged_prefill": dict(rp_cases[0], max_abs_err=max(
                c["max_abs_err"] for c in (*rp_cases[:-3], rp_lse)))}


# ---------------------------------------------------------------------------
# 4. train
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen2-0.5b"
TRAIN_STEPS = 20
TRAIN_RESTART = 5            # 5 steps, a restart, 5 steps vs 10 straight
SLICE_BATCH = (2, 256)       # the whole-slice check's batch: rows, tokens
# card (bf16 compute, the kernels) against the port's CPU run (float32,
# plain versions) on the same float32 masters and batch: bf16 rounds each
# product's operands (2^-9 relative) through 24 layers and a 151,936-wide
# head; the loss is a mean over 512 tokens, the gradient norm a sum of
# squares dominated by the largest leaves
SLICE_LOSS_REL = 1e-3
SLICE_GNORM_REL = 1e-2
PEAK_BF16 = 989e12           # H100 SXM dense bf16, the MFU's denominator


def _bad_grads(torch, module, skip=lambda name: False):
    """Names of parameters whose gradient is missing, non-finite or all
    zero (``skip``: names only held to finite)."""
    bad = []
    for name, p in module.named_parameters():
        g = p.grad
        if g is None or not bool(torch.isfinite(g).all()):
            bad.append(name)
        elif not skip(name) and not bool((g != 0).any()):
            bad.append(name)
    return bad


def _train_args(arch, seed, steps, *extra):
    return ["--arch", arch, "--steps", str(steps), "--global-batch",
            str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ), "--seed",
            str(seed), "--log-every", "5", *extra]


def _train_flops(cfg, module) -> float:
    """Model FLOPs of one step: 6 per weight of every matrix per token (the
    tied embedding counted once, as the LM head), and the attention's
    score and value products, forward and backward (3 x 4 x Hq x hd a
    causal pair a layer).  The recompute is not counted."""
    n_mm = sum(p.numel() for p in module.parameters() if p.dim() >= 2)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    attn = (cfg.n_layers * 12 * TRAIN_BATCH * cfg.n_heads * cfg.hd
            * _attn_pairs(TRAIN_SEQ, TRAIN_SEQ, True))
    return 6.0 * n_mm * tokens + attn


def phase_train(torch, seed, card):
    """qwen2-0.5b trained at full width through ``repro_torch.launch.
    train``'s ``run``, whose steps are the donated step's cell
    (``models/graphs.py`` ``TrainGraph``: step 1 runs eagerly and is
    captured, steps 2-20 replay one CUDA graph, the state updated in
    place): random weights from the seed, SyntheticLMData, global batch 8
    x 1024.  The main path's 20 steps, with exact launch counts (flash
    forward: a forward and a recompute a layer; the backward: one a
    layer), finite and falling losses, step p50, tokens/s, MFU, the
    capture's time, the cells built and peak memory; then every
    parameter's gradient, which step 20's replay wrote; the same 20 steps
    eagerly through ``TrainStep`` from the same seed (losses and final
    state against the cell's, the eager p50); one replayed step profiled;
    a whole-slice check of one 2 x 256 batch against the port's own CPU
    run in float32; one eager step profiled by range; a restart check
    through the cell; and two steps each of granite-moe-1b-a400m and
    mamba2-130m through the launcher (gradients after the replay).
    Returns the main path's launches."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import train as launch
    from repro_torch.models import get_model
    from repro_torch.models.convert import (train_state_from_numpy,
                                            train_state_to_numpy)
    from repro_torch.optim import AdamWConfig, global_norm
    from repro_torch.train import (DonatedStep, make_train_step,
                                   train_state_init)
    from repro_torch.tree import tree_items, tree_map

    cfg = get_config(TRAIN_ARCH)
    L = cfg.n_layers
    torch.cuda.empty_cache()

    def counted(argv, steps, layers):
        fa.launches = fa.bwd_launches = fa.dout_copies = 0
        out = launch.run(argv)
        torch.cuda.synchronize()
        got = (fa.launches, fa.bwd_launches)
        check(got == (2 * layers * steps, layers * steps),
              f"train {argv[1]}: launches {got}, expected "
              f"{(2 * layers * steps, layers * steps)}")
        check(fa.dout_copies == 0, f"train {argv[1]}: {fa.dout_copies} "
              f"copies of dO: the model's layout reaches the backward as "
              f"TMA cannot read it")
        cell = out["step"].cell
        check(cell.cells() == 1 and cell.capture_ms[0] is not None,
              f"train {argv[1]}: {cell.cells()} cells built, not one "
              f"captured")
        return out, got

    def batch_at(data, i):
        return {k: torch.from_numpy(v).cuda()
                for k, v in data.batch_at(i).items()}

    # the main path: the launcher's steps on the cell
    torch.cuda.reset_peak_memory_stats()
    out, launches = counted(_train_args(TRAIN_ARCH, seed, TRAIN_STEPS),
                            TRAIN_STEPS, L)
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    step_fn = out["step"]
    # the gradients step 20's replay wrote (after a build, the module's
    # .grad are the capture's buffers, which only a replay fills)
    module = step_fn.module
    bad = _bad_grads(torch, module)
    check(not bad, f"train: {len(bad)} parameters without a finite nonzero "
          f"gradient after step {TRAIN_STEPS} (a replay): {bad[:8]}")
    n_params = sum(p.numel() for p in module.parameters())
    flops = _train_flops(cfg, module)
    print(f"[train] {cfg.name}: {L} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, vocab "
          f"{cfg.vocab}: {n_params} parameters, float32 masters and AdamW "
          f"state, {cfg.compute_dtype} compute; after step {TRAIN_STEPS} (a "
          f"replay of the cell) all {len(list(module.parameters()))} "
          f"parameter tensors have a finite nonzero gradient")
    del module
    losses = out["losses"]
    check(all(math.isfinite(x) for x in losses), f"train: losses {losses}")
    check(np.mean(losses[-5:]) < np.mean(losses[:5]) and
          losses[-1] < losses[0], f"train: the loss does not fall: {losses}")
    steady = sorted(out["step_s"][1:])          # step 1 builds the cell
    p50 = steady[len(steady) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"[train] losses: {[round(x, 4) for x in losses]}")
    print(f"[train] {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} on "
          f"the train cell: step p50 {p50 * 1e3:.2f} ms (steps "
          f"2-{TRAIN_STEPS}, replays; min {steady[0] * 1e3:.2f}, max "
          f"{steady[-1] * 1e3:.2f}), {tokens / p50:.0f} tokens/s, MFU "
          f"{flops / p50 / PEAK_BF16:.4f} ({flops / 1e12:.2f} model TFLOP a "
          f"step over {PEAK_BF16:.3g} FLOP/s); step 1 (the eager run and "
          f"the capture) {out['step_s'][0] * 1e3:.1f} ms, capture "
          f"{step_fn.cell.capture_ms[0]:.1f} ms, cells built "
          f"{step_fn.cell.cells()}; peak memory {peak} bytes allocated, "
          f"{reserved} reserved; launches {launches[0]} flash forward "
          f"({2 * L} a step: forward and recompute), {launches[1]} flash "
          f"backward ({L} a step), {fa.dout_copies} dO copies ({card})")

    # one replayed step, traced; then the cell's state to host memory and
    # the cell dropped, whose pool goes back to the allocator
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab,
                                      global_batch=TRAIN_BATCH,
                                      seq_len=TRAIN_SEQ, seed=seed))
    cell_state = train_state_to_numpy(out["state"])
    batch = batch_at(data, TRAIN_STEPS)
    n0 = (fa.launches, fa.bwd_launches)
    prof = _profile_window(torch, lambda: step_fn(out["state"], batch),
                           f"one replayed train step, {cfg.name}, "
                           f"{TRAIN_BATCH} x {TRAIN_SEQ}", card, top=16)
    fa.launches, fa.bwd_launches = n0
    check(step_fn.cell.cells() == 1, "train: the profiled step built a cell")
    if prof is not None:
        print(f"[train] replayed step: wall {prof['wall'] * 1e3:.3f} ms, "
              f"device busy {prof['busy'] * 1e3:.3f} ms, idle share "
              f"{1 - prof['busy'] / prof['wall']:.3f} ({card})")
    del out, step_fn, batch
    torch.cuda.empty_cache()

    # the same steps eagerly: TrainStep from the same seed, AdamW config
    # and batches as the launcher's
    model = get_model(cfg)
    opt = AdamWConfig(lr=3e-3, warmup_steps=max(5, TRAIN_STEPS // 20),
                      total_steps=TRAIN_STEPS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    state = train_state_init(model, gen, opt, device="cuda")
    eager = make_train_step(model, opt)
    e_losses, e_s = [], []
    n0 = (fa.launches, fa.bwd_launches)
    for i in range(TRAIN_STEPS):
        ts = time.perf_counter()
        state, m = eager(state, batch_at(data, i))
        e_losses.append(float(m["loss"]))
        e_s.append(time.perf_counter() - ts)
    fa.launches, fa.bwd_launches = n0           # checks do not count
    e_steady = sorted(e_s[1:])
    e_p50 = e_steady[len(e_steady) // 2]
    cell_state = train_state_from_numpy(cell_state, "cuda")
    pairs = [(a, b) for (_, a), (_, b) in zip(tree_items(cell_state),
                                              tree_items(state))]
    # the replays run the eager step's kernels on the same operands, the
    # in-place AdamW is bitwise the functional one: the runs are equal
    differ = sum(not torch.equal(a, b) for a, b in pairs)
    worst = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
    d_loss = max(abs(a - b) / abs(b) for a, b in zip(losses, e_losses))
    print(f"[train] the same {TRAIN_STEPS} steps eagerly (TrainStep, a new "
          f"state each step): step p50 {e_p50 * 1e3:.2f} ms (steps "
          f"2-{TRAIN_STEPS}; the cell's {p50 * 1e3:.2f}); losses "
          f"{'bitwise equal' if losses == e_losses else 'differ'} (largest "
          f"relative difference {d_loss:.3g}); final state: "
          f"{len(pairs) - differ} of {len(pairs)} leaves bitwise equal, max "
          f"abs difference {worst} ({card})")
    check(losses == e_losses and not differ,
          "train: the cell's run is not bitwise the eager run")
    del state, cell_state, eager, pairs
    torch.cuda.empty_cache()

    # the whole slice against the port's CPU run, same masters and batch
    opt = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=2 * TRAIN_RESTART)
    gen.manual_seed(seed)
    s0 = train_state_init(model, gen, opt, device="cuda")
    rows, toks = SLICE_BATCH
    small = {k: torch.from_numpy(v[:rows, :toks])
             for k, v in data.batch_at(0).items()}
    n0 = (fa.launches, fa.bwd_launches)
    loss_c, g_c = make_train_step(model, opt).value_and_grad(
        s0["params"], {k: v.cuda() for k, v in small.items()})
    fa.launches, fa.bwd_launches = n0           # checks do not count
    gn_c = float(global_norm(g_c))
    del g_c
    torch.cuda.empty_cache()
    cpu_model = get_model(dataclasses.replace(cfg, compute_dtype="float32"))
    t0 = time.perf_counter()
    params_cpu = train_state_from_numpy(train_state_to_numpy(s0["params"]),
                                        "cpu")
    loss_h, g_h = make_train_step(cpu_model, opt).value_and_grad(
        params_cpu, small)
    gn_h = float(global_norm(g_h))
    t_cpu = time.perf_counter() - t0
    del g_h, params_cpu
    d_loss = abs(float(loss_c) - float(loss_h)) / abs(float(loss_h))
    d_gn = abs(gn_c - gn_h) / gn_h
    print(f"[train] whole slice, one {rows} x {toks} batch, same masters: "
          f"card (bf16, kernels) loss {float(loss_c):.6f} grad norm "
          f"{gn_c:.6f}; CPU (float32, plain versions, {t_cpu:.1f} s) loss "
          f"{float(loss_h):.6f} grad norm {gn_h:.6f}; relative differences "
          f"{d_loss:.3g} (limit {SLICE_LOSS_REL}) and {d_gn:.3g} (limit "
          f"{SLICE_GNORM_REL})")
    check(d_loss <= SLICE_LOSS_REL and d_gn <= SLICE_GNORM_REL,
          "train: the card's loss or gradient norm is off the CPU run's")

    # one eager step profiled after a warm one: the forward and backward,
    # and AdamW, as ranges
    from torch.profiler import record_function
    from repro_torch.optim import adamw_update
    n0 = (fa.launches, fa.bwd_launches)
    prof_step = make_train_step(model, opt)
    batch = batch_at(data, 0)
    prof_step(s0, batch)

    def profiled():
        with record_function("train.forward_backward"):
            _, grads = prof_step.value_and_grad(s0["params"], batch)
        with record_function("train.adamw"):
            adamw_update(opt, grads, s0["opt"], s0["params"])
    _profile_window(torch, profiled, f"one eager train step, {cfg.name}, "
                    f"{TRAIN_BATCH} x {TRAIN_SEQ}", card, top=16,
                    ranges=("train.forward_backward", "train.adamw"))
    fa.launches, fa.bwd_launches = n0
    del prof_step, batch
    torch.cuda.empty_cache()

    # restart: TRAIN_RESTART steps on the cell, the state through host
    # memory (the checkpointer's own leaf conversion; its zlib pass over
    # the 5.9 GB state would take minutes on the card's host, and the
    # files are the CPU tests'), TRAIN_RESTART more on a new cell, against
    # the straight run's cell; each run donates a copy of s0
    def steps(state, lo, hi):
        step = DonatedStep(make_train_step(model, opt))
        for i in range(lo, hi):
            state, _ = step(state, batch_at(data, i))
        return state

    n0 = (fa.launches, fa.bwd_launches)
    fresh = lambda: tree_map(lambda t: t.clone(), s0)
    straight = steps(fresh(), 0, 2 * TRAIN_RESTART)
    half = train_state_to_numpy(steps(fresh(), 0, TRAIN_RESTART))
    resumed = steps(train_state_from_numpy(half, "cuda"), TRAIN_RESTART,
                    2 * TRAIN_RESTART)
    fa.launches, fa.bwd_launches = n0
    data.close()
    pairs = [(a, b) for (_, a), (_, b) in zip(tree_items(straight),
                                              tree_items(resumed))]
    differ = sum(not torch.equal(a, b) for a, b in pairs)
    worst = max(((a.float() - b.float()).abs().max().item()
                 for a, b in pairs), default=0.0)
    print(f"[train] restart on the cell: {TRAIN_RESTART} steps, state to "
          f"host and back, {TRAIN_RESTART} steps vs {2 * TRAIN_RESTART} "
          f"straight: {len(pairs) - differ} of {len(pairs)} leaves bitwise "
          f"equal, max abs difference {worst}")
    check(not differ, f"train: restart differs in {differ} leaves "
          f"(max abs {worst})")
    del straight, resumed, half, s0, model, pairs
    torch.cuda.empty_cache()

    # two steps each of the MoE and SSM families: the cell's build, then a
    # replay, whose gradients are checked
    for arch, layers, skip in (
            ("granite-moe-1b-a400m", 24, lambda n: ".moe.w_" in n),
            ("mamba2-130m", 0, lambda n: False)):
        torch.cuda.reset_peak_memory_stats()
        two, got = counted(_train_args(arch, seed, 2), 2, layers)
        module = two["step"].module
        check(all(math.isfinite(x) for x in two["losses"]),
              f"train {arch}: losses {two['losses']}")
        bad = _bad_grads(torch, module, skip)
        check(not bad, f"train {arch}: no finite nonzero gradient in "
              f"{bad[:8]}")
        idle = [n for n, p in module.named_parameters()
                if skip(n) and not bool((p.grad != 0).any())]
        print(f"[train] {arch} at full width, two steps of {TRAIN_BATCH} x "
              f"{TRAIN_SEQ} on the cell: losses "
              f"{[round(x, 4) for x in two['losses']]}, step 1 (the build) "
              f"{two['step_s'][0] * 1e3:.1f} ms, capture "
              f"{two['step'].cell.capture_ms[0]:.1f} ms, step 2 (a replay) "
              f"{two['step_s'][1] * 1e3:.1f} ms; after the replay every "
              f"parameter's gradient finite and every dense and attention "
              f"one nonzero ({len(idle)} expert tensors with a zero "
              f"gradient); flash launches {got}; peak memory "
              f"{torch.cuda.max_memory_allocated()} bytes allocated, "
              f"{torch.cuda.max_memory_reserved()} reserved ({card})")
        del two, module
        torch.cuda.empty_cache()
    return {"flash_attention": launches[0],
            "flash_attention_bwd": launches[1]}


# ---------------------------------------------------------------------------
# 5. serve
# ---------------------------------------------------------------------------

def _cells_built(model, entry: str = "decode_fused") -> int:
    """The cells ``model``'s entry point ``entry`` (``decode_fused``,
    ``prefill_chunk`` or ``decode_step``) has built (an eager body builds
    none)."""
    return len(_capture_ms(model, entry))


def _capture_ms(model, entry: str = "decode_fused") -> list:
    """Each cell's capture time on the host, in build order."""
    return list(getattr(getattr(model, entry), "capture_ms", ()))


def _passes(steps: int, built: int) -> int:
    """Decode passes over the engines' caches: each decode step, and each
    cell's build, which an engine runs as it allocates its batch cache
    (one eager decode of the cache, then the capture, which launches
    nothing).  Each pass launches ``ragged_decode`` once a token and
    attention layer."""
    return steps + built


def _eager(model, entry: str = "decode_fused"):
    """``model`` with the entry point ``entry`` its eager body, the one
    its cells capture (the k-step loop, the chunk): what the cells are
    held against."""
    import dataclasses
    return dataclasses.replace(model, **{entry: getattr(model, entry).eager})


def _solo_stream(torch, np, model, params, prompt, max_new, export_after):
    """One request alone on an 8-slot engine, to the end; with
    ``export_after`` set, exported after that many steps and finished on a
    second engine.  Batch shape and slot are the same either way, so the
    two streams must match token for token."""
    from repro_torch.serve import Request, ServeEngine
    req = Request(rid=0, prompt=prompt, max_new=max_new)
    a = ServeEngine(model, params, max_batch=8, max_seq=2048, decode_chunk=4)
    a.submit(req)
    if export_after is None:
        a.run_until_drained()
        return list(req.out_tokens), None
    for _ in range(export_after):
        a.step()
    check(not req.done, "migration request finished before export")
    sess = a.export_session(req.rid)
    check(all(isinstance(x, np.ndarray) for x in sess.cache.values()),
          "exported session leaves are not host numpy")
    b = ServeEngine(model, params, max_batch=8, max_seq=2048, decode_chunk=4)
    b.import_session(sess)
    b.run_until_drained()
    return list(req.out_tokens), sess.pos


def phase_serve(torch, seed, card):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ragged_decode import ops as rd
    from repro_torch.models import get_model
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config("qwen2-0.5b")
    model = get_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}, {n_params} parameters in "
          f"{cfg.compute_dtype}, init {time.perf_counter() - t0:.2f} s")

    rng = np.random.default_rng(seed)
    max_new, n_req = 64, 16
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(64, 1025)))
               for _ in range(n_req)]

    # warm-up request (not timed): cuBLAS handles, allocator
    warm = ServeEngine(model, params, max_batch=8, max_seq=2048,
                       decode_chunk=4)
    warm.submit(Request(rid=-1, prompt=prompts[0][:64], max_new=8))
    warm.run_until_drained()
    del warm                  # its idle batch cache must not count in the peak

    def run(m, how, fused=True):
        """The 16 prompts through a fresh engine over ``m`` (with
        ``fused`` False on the per-step legacy path, one token a step):
        checks, prints, and (requests, per-token latencies, launches,
        capture ms of the decode cells built)."""
        reqs = [Request(rid=i, prompt=p, max_new=max_new)
                for i, p in enumerate(prompts)]
        engine = ServeEngine(m, params, max_batch=8, max_seq=2048,
                             decode_chunk=4, fused=fused)
        lat = []
        engine.on_step_latency = lat.append
        for r in reqs:
            engine.submit(r)
        entry, k = ("decode_fused", 4) if fused else ("decode_step", 1)
        built0 = _cells_built(m, entry)
        rd.launches = fa.launches = 0       # count the main path's run only
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {"ragged_decode": rd.launches,
                    "flash_attention": fa.launches}
        captures = _capture_ms(m, entry)[built0:]

        check(all(r.done for r in reqs), "not every request finished")
        check(all(len(r.out_tokens) == max_new for r in reqs),
              f"token counts {[len(r.out_tokens) for r in reqs]} != "
              f"{max_new}")
        check(all(0 <= t < cfg.vocab for r in reqs for t in r.out_tokens),
              "a token is outside [0, vocab)")
        check(engine.stats()["requests_served"] == n_req, "served count")
        check(launches["flash_attention"] == n_req * cfg.n_layers,
              f"{how}: flash_attention launches "
              f"{launches['flash_attention']} != {n_req} prefills x "
              f"{cfg.n_layers} layers")
        steps = len(lat)
        passes = _passes(steps, len(captures))
        check(launches["ragged_decode"] == passes * k * cfg.n_layers,
              f"{how}: ragged_decode launches {launches['ragged_decode']} "
              f"!= {passes} decode passes ({steps} steps, "
              f"{len(captures)} cell builds) x {k} tokens x {cfg.n_layers} "
              f"layers")

        dec_tokens = sum(len(r.out_tokens) - 1 for r in reqs)
        dec_time = sum(lat) * k
        ttft = sorted(r.t_first - r.t_admit for r in reqs)
        ptt_updates = engine.scheduler.ptt.updates
        print(f"[serve] {how}: {n_req} requests x {max_new} tokens, prompts "
              f"{min(len(r.prompt) for r in reqs)}-"
              f"{max(len(r.prompt) for r in reqs)}: wall {wall:.3f} s, "
              f"{steps} decode steps")
        print(f"[serve] {how}: decode {dec_tokens / dec_time:.1f} tok/s, p50 "
              f"per-token step latency {1e3 * float(np.median(lat)):.3f} ms "
              f"(max {1e3 * max(lat):.3f}), p50 prefill "
              f"{1e3 * ttft[len(ttft) // 2]:.3f} ms, ptt.updates "
              f"{ptt_updates} ({card})")
        print(f"[serve] {how}: launches in the run: {launches}; decode cells "
              f"built {len(captures)}, capture ms "
              f"{[round(c, 3) for c in captures]}")
        print(f"[serve] {how}: peak device memory {peak} bytes ({card})")
        return reqs, lat, launches, captures

    # the main path: decode_fused as one CUDA graph per (batch, chunk) cell
    # and cache; then the eager loop the cells capture, on the same prompts
    reqs, _, launches, captures = run(model, "graph")
    check(len(captures) == 1, f"the engine built {len(captures)} decode "
          f"cells, not one (B 8, k 4)")
    eager = _eager(model)
    ereqs, _, elaunches, ecaptures = run(eager, "eager loop")
    check(not ecaptures, "the eager loop built a cell")
    build = {"ragged_decode": 4 * cfg.n_layers, "flash_attention": 0}
    check(all(launches[k] == elaunches[k] + build[k] for k in build),
          f"launches: graph {launches}, eager loop {elaunches} and the "
          f"cell's build {build}")
    for r, e in zip(reqs, ereqs):
        check(r.out_tokens == e.out_tokens, f"request {r.rid}: the graph's "
              f"stream differs from the eager loop's:\n{r.out_tokens}\n"
              f"{e.out_tokens}")
    print(f"[serve] graph against eager loop: all {len(reqs)} streams "
          f"identical, launches equal but for the cell's build {build}")
    # the per-step legacy path (fused=False) on its decode_step cell
    lreqs, _, llaunches, lcaptures = run(model, "legacy step", fused=False)
    check(len(lcaptures) == 1, f"the legacy engine built {len(lcaptures)} "
          f"decode_step cells, not one (B 8)")
    for r, e in zip(reqs, lreqs):
        check(r.out_tokens == e.out_tokens, f"request {r.rid}: the legacy "
              f"step cell's stream differs from the fused graph's:\n"
              f"{e.out_tokens}\n{r.out_tokens}")
    print(f"[serve] legacy step cell against the fused graph: all "
          f"{len(reqs)} streams identical; ragged_decode "
          f"{llaunches['ragged_decode']} (24 a token step and the build's "
          f"24), capture {lcaptures[0]:.3f} ms ({card})")

    phase_profile(torch, np, model, params, reqs, card, "graph")
    phase_profile(torch, np, eager, params, reqs, card, "eager loop",
                  prefill=False)

    # a session exported mid-decode continues the same stream elsewhere
    prompt = min((r.prompt for r in reqs), key=len)
    ref, _ = _solo_stream(torch, np, model, params, prompt, max_new, None)
    got, pos = _solo_stream(torch, np, model, params, prompt, max_new, 3)
    check(got == ref, f"migrated stream differs:\n{got}\n{ref}")
    print(f"[serve] migration: exported at pos {pos}, {len(got)} tokens "
          f"identical to the unmigrated stream")
    return launches, model, params, reqs


# ---------------------------------------------------------------------------
# 6. chunked prefill
# ---------------------------------------------------------------------------

CHUNK = 256
CHUNK_NEW = 16
# last-token logits of the whole-prompt and the chunked prefill, bf16: both
# paths round the residual stream and every projection to 8 significant
# bits (2^-9 relative), but at different places (other GEMM shapes, the
# flash kernel's bf16 output against the chunk kernel's f32 one); over 24
# layers and ~8 roundings each, differences that add like a random walk
# reach sqrt(192) * 2^-9 = 2.7 % of the logits' scale.  The limit is twice
# that: 2^-4 of the largest logit magnitude.
LOGIT_REL_LIMIT = 2.0 ** -4


def _chunked_engine(model, params, **kw):
    from repro_torch.serve import ServeEngine
    return ServeEngine(model, params, max_batch=8, max_seq=2048,
                       decode_chunk=4, prefill_chunk_tokens=CHUNK, **kw)


def _chunked_solo(model, params, prompt, mode):
    """One request alone on 8-slot chunked engines, to the end: unmigrated
    (``mode`` None), exported after 2 chunks and resumed on a second
    chunked engine ("export"), or prefilled on a ``role="prefill"`` engine
    that hands it to a ``role="decode"`` engine ("handoff").  The decode
    batch shape and slot are the same every way, so the streams must match
    token for token."""
    from repro_torch.serve import Request, ServeEngine
    req = Request(rid=0, prompt=prompt, max_new=CHUNK_NEW)
    if mode == "handoff":
        pre = _chunked_engine(model, params, role="prefill")
        dec = ServeEngine(model, params, max_batch=8, max_seq=2048,
                          decode_chunk=4, role="decode")
        pre.on_prefill_complete = dec.import_session
        pre.submit(req)
        for _ in range(1000):
            pre.step()
            dec.step()
            check(pre.active_count() == 0, "the prefill engine took a slot")
            if req.done:
                break
        check(pre.stats()["sessions_exported"] == 1
              and dec.stats()["sessions_imported"] == 1, "no handoff")
        return list(req.out_tokens)
    a = _chunked_engine(model, params)
    a.submit(req)
    if mode == "export":
        a.step()
        a.step()
        sess = a.export_prefill(req.rid)
        check(sess.prefilled == 2 * CHUNK,
              f"exported after {sess.prefilled} prompt tokens")
        a = _chunked_engine(model, params)
        a.import_session(sess)
    a.run_until_drained()
    return list(req.out_tokens)


def _chunked_run(torch, np, model, params, whole_reqs, how, card):
    """The whole-prompt run's prompts, ``CHUNK_NEW`` new each, through a
    fresh chunked engine over ``model``: checks, prints, and (requests,
    launches, chunk cells built with their capture ms)."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ragged_decode import ops as rd
    from repro_torch.kernels.ragged_prefill import ops as rp
    from repro_torch.serve import Request

    cfg = model.cfg
    reqs = [Request(rid=r.rid, prompt=r.prompt, max_new=CHUNK_NEW)
            for r in whole_reqs]
    engine = _chunked_engine(model, params)
    lat, chunk_lat = [], []
    engine.on_step_latency = lat.append
    engine.on_prefill_latency = chunk_lat.append
    for r in reqs:
        engine.submit(r)
    built0 = _cells_built(model)
    chunk0 = _cells_built(model, "prefill_chunk")
    rd.launches = fa.launches = rp.launches = 0  # count this run only
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {"ragged_decode": rd.launches,
                "flash_attention": fa.launches,
                "ragged_prefill": rp.launches}
    captures = _capture_ms(model, "prefill_chunk")[chunk0:]

    check(all(r.done for r in reqs), f"chunked ({how}): not every request "
          f"finished")
    check(all(len(r.out_tokens) == CHUNK_NEW for r in reqs),
          f"chunked ({how}): token counts "
          f"{[len(r.out_tokens) for r in reqs]}")
    check(all(0 <= t < cfg.vocab for r in reqs for t in r.out_tokens),
          f"chunked ({how}): a token is outside [0, vocab)")
    check(engine.stats()["requests_served"] == len(reqs), "served count")
    n_chunks = sum(-(-len(r.prompt) // CHUNK) for r in reqs)
    check(len(chunk_lat) == n_chunks,
          f"{len(chunk_lat)} chunk latencies for {n_chunks} chunks")
    # each chunk cell's build runs one warm-up chunk (qlen 0) eagerly
    passes = n_chunks + len(captures)
    check(launches["ragged_prefill"] == passes * cfg.n_layers,
          f"chunked ({how}): ragged_prefill launches "
          f"{launches['ragged_prefill']} != ({n_chunks} chunks + "
          f"{len(captures)} cell builds) x {cfg.n_layers} layers")
    check(launches["flash_attention"] == 0,
          f"flash_attention launched {launches['flash_attention']} times "
          f"in the chunked run")
    steps = len(lat)
    passes = _passes(steps, _cells_built(model) - built0)
    check(launches["ragged_decode"] == passes * 4 * cfg.n_layers,
          f"ragged_decode launches {launches['ragged_decode']} != {passes} "
          f"decode passes ({steps} steps and the cell's build) x 4 tokens "
          f"x {cfg.n_layers} layers")
    check(engine.scheduler.ptt.updates == n_chunks + steps,
          f"ptt.updates {engine.scheduler.ptt.updates} != {n_chunks} "
          f"chunks + {steps} decode steps")
    ttft = sorted(r.t_first - r.t_admit for r in reqs)
    print(f"[chunked] {how}: {len(reqs)} requests x {CHUNK_NEW} tokens, "
          f"chunks of {CHUNK}: {n_chunks} chunks, {steps} decode steps, "
          f"wall {wall:.3f} s")
    print(f"[chunked] {how}: p50 TTFT {1e3 * ttft[len(ttft) // 2]:.3f} ms, "
          f"p50 chunk latency {1e3 * float(np.median(chunk_lat)):.3f} ms, "
          f"p50 per-token step latency {1e3 * float(np.median(lat)):.3f} ms "
          f"({card})")
    print(f"[chunked] {how}: launches in the run: {launches}; chunk cells "
          f"built {len(captures)}, capture ms "
          f"{[round(c, 3) for c in captures]}")
    print(f"[chunked] {how}: peak device memory {peak} bytes ({card})")
    return reqs, launches, captures


def _chunk_window(torch, model, params, fn, prompt, label, card):
    """The chunked prefill of ``prompt`` through ``fn`` (the chunk cell or
    its eager body) into one cache, zeroed first: once (on the cell, the
    call that builds it), then again under a profile window, where the
    ``ragged_prefill`` calls counted are held against the chunk kernels
    in its trace.  Returns (the first run's last logits, the window's
    profile)."""
    from repro_torch.kernels.ragged_prefill import ops as rp
    tokens = torch.as_tensor(prompt, device="cuda").long()[None]
    cache = {n: torch.zeros(shape, dtype=dt, device="cuda")
             for n, (shape, dt) in model.cache_spec(1, 2048).items()}

    def chain():
        for t in cache.values():
            t.zero_()
        for s in range(0, len(prompt), CHUNK):
            n = min(CHUNK, len(prompt) - s)
            chunk = torch.zeros((1, CHUNK), dtype=torch.long, device="cuda")
            chunk[0, :n] = tokens[0, s:s + n]
            logits, _ = fn(
                params, chunk, cache,
                torch.tensor([s], dtype=torch.int32, device="cuda"),
                torch.tensor([n], dtype=torch.int32, device="cuda"))
        return logits

    first = chain()
    check(torch.equal(chain(), first), f"{label}: a second chunked prefill "
          f"of the same prompt gave other logits")
    n0 = rp.launches
    prof = _profile_window(torch, chain, f"chunked prefill of {len(prompt)} "
                           f"tokens in chunks of {CHUNK} ({label})", card)
    counted = rp.launches - n0
    chunks = -(-len(prompt) // CHUNK)
    check(counted == chunks * model.cfg.n_layers,
          f"{label}: {counted} ragged_prefill calls counted in the window, "
          f"not {chunks} chunks x {model.cfg.n_layers}")
    if prof is not None:
        names = [n for _, _, n in prof["sequence"].get("ragged_prefill", ())]
        kernels = sum("prefill_bf16_wgmma" in n for n in names)
        check(kernels == counted, f"{label}: the trace holds {kernels} "
              f"ragged_prefill kernels, the counter {counted} calls")
        print(f"[profile] chunked window ({label}): ragged_prefill calls "
              f"counted {counted}, in the trace {kernels} kernels")
    return first, prof


def phase_chunked(torch, card, model, params, whole_reqs):
    import numpy as np
    from repro_torch.serve import Request

    reqs = [Request(rid=r.rid, prompt=r.prompt, max_new=CHUNK_NEW)
            for r in whole_reqs]
    warm = _chunked_engine(model, params)
    warm.submit(Request(rid=-1, prompt=reqs[0].prompt[:CHUNK + 8],
                        max_new=8))
    warm.run_until_drained()
    del warm                  # its idle batch cache must not count in the peak

    # the main path: prefill_chunk on the engine's one chunk cell; then
    # the same requests on an engine that calls the chunk eagerly
    reqs, launches, captures = _chunked_run(torch, np, model, params,
                                            whole_reqs, "cell", card)
    check(len(captures) == 1, f"the chunked engine built {len(captures)} "
          f"chunk cells, not one")
    ereqs, elaunches, ecaptures = _chunked_run(
        torch, np, _eager(model, "prefill_chunk"), params, whole_reqs,
        "eager chunk", card)
    check(not ecaptures, "the eager chunk built a cell")
    for r, e in zip(reqs, ereqs):
        check(r.out_tokens == e.out_tokens, f"request {r.rid}: the chunk "
              f"cell's stream differs from the eager chunk's:\n"
              f"{r.out_tokens}\n{e.out_tokens}")
    L = model.cfg.n_layers
    check(launches["ragged_prefill"] == elaunches["ragged_prefill"] + L,
          f"ragged_prefill launches: cell {launches['ragged_prefill']}, "
          f"eager {elaunches['ragged_prefill']}, and the build's {L}")
    print(f"[chunked] chunk cell against the eager chunk: all {len(reqs)} "
          f"streams identical, ragged_prefill launches equal but for the "
          f"cell's build ({L})")
    same = sum(a.out_tokens[0] == b.out_tokens[0]
               for a, b in zip(reqs, whole_reqs))
    print(f"[chunked] first tokens equal to the whole-prompt run's: "
          f"{same}/{len(reqs)} (bf16 near-ties may differ; not a check)")

    prompt = max((r.prompt for r in reqs), key=len)
    check(len(prompt) > 2 * CHUNK, "no prompt of 3 chunks or more")
    ref = _chunked_solo(model, params, prompt, None)
    for mode in ("export", "handoff"):
        got = _chunked_solo(model, params, prompt, mode)
        check(got == ref, f"chunked {mode} stream differs:\n{got}\n{ref}")
        print(f"[chunked] {mode}: {len(got)} tokens identical to the "
              f"unmigrated chunked stream (prompt {len(prompt)} tokens)")

    tokens = torch.as_tensor(prompt, device="cuda").long()[None]
    whole, _ = model.prefill(params, {"tokens": tokens})
    chunked, prof = _chunk_window(torch, model, params, model.prefill_chunk,
                                  prompt, "cell", card)
    diff = (whole.float() - chunked.float()).abs().max().item()
    scale = whole.float().abs().max().item()
    limit = LOGIT_REL_LIMIT * scale
    check(math.isfinite(diff) and diff <= limit,
          f"whole vs chunked prefill logits differ by {diff} > {limit}")
    print(f"[chunked] last-token logits, whole vs chunked prefill of "
          f"{len(prompt)} tokens: max abs diff {diff:.4g}, limit "
          f"{limit:.4g} (2^-4 of max |logit| {scale:.4g})")
    eager, eprof = _chunk_window(torch, model, params,
                                 model.prefill_chunk.eager, prompt,
                                 "eager chunk", card)
    check(torch.equal(chunked, eager), "the chunk cell's last logits differ "
          "from the eager chunk's")
    if prof is not None and eprof is not None:
        print(f"[chunked] window idle share {1 - prof['busy'] / prof['wall']:.3f}"
              f" (eager chunk {1 - eprof['busy'] / eprof['wall']:.3f}), wall "
              f"{1e3 * prof['wall']:.3f} ms ({1e3 * eprof['wall']:.3f}); "
              f"capture of the engine's cell {captures[0]:.3f} ms ({card})")
    # the streams, for the mesh phase's run of the same requests
    return dict(launches, tokens=[list(r.out_tokens) for r in reqs])


# ---------------------------------------------------------------------------
# 7. the session wire
# ---------------------------------------------------------------------------

def _wire_move(src, dst, rid, link, prefill: bool):
    """Move ``rid`` from ``src`` to ``dst`` as wire bytes over ``link``: a
    live session (``export_session_wire``) or, with ``prefill``, an
    unfinished chunked prefill (``export_prefill`` + ``encode_session``).
    Returns the decoded Request that finishes on ``dst``, the payload and
    the host's times: export (device to host and encode), a second encode
    of the decoded session (which must give the same bytes) and a
    decode."""
    from repro_torch.region import decode_session, encode_session
    t0 = time.perf_counter()
    data = (encode_session(src.export_prefill(rid)) if prefill
            else src.export_session_wire(rid))
    export_ms = 1e3 * (time.perf_counter() - t0)
    arrived, _ = link.ship(data, 0, 1)
    check(arrived == data, "the loopback transport changed the payload")
    t0 = time.perf_counter()
    sess = decode_session(arrived)
    decode_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    again = encode_session(sess)
    encode_ms = 1e3 * (time.perf_counter() - t0)
    check(again == data, "re-encoding the decoded session changed its bytes")
    dst.import_session_wire(arrived)
    handle = dst.prefilling[-1].req if prefill else dst.sessions_in[-1].req
    return handle, data, dict(export_ms=export_ms, encode_ms=encode_ms,
                              decode_ms=decode_ms)


def _wire_solo(model, params, prompt, max_new, after, chunk_tokens=0,
               extras=None):
    """One request (with ``extras``, if given) alone on an 8-slot engine:
    to the end (``after`` None),
    or moved after ``after`` steps through the wire and a
    ``LoopbackTransport`` to a second engine of the same shape, where it
    finishes (mid-decode, or mid-prefill with ``chunk_tokens``).  Returns
    the tokens, and the payload and times of a move."""
    from repro_torch.region import LoopbackTransport
    from repro_torch.serve import Request, ServeEngine

    def engine():
        return ServeEngine(model, params, max_batch=8, max_seq=2048,
                           decode_chunk=4, prefill_chunk_tokens=chunk_tokens)

    req = Request(rid=0, prompt=prompt, max_new=max_new,
                  extras=extras or {})
    a = engine()
    a.submit(req)
    if after is None:
        a.run_until_drained()
        return list(req.out_tokens), None, None
    for _ in range(after):
        a.step()
    check(not req.done, "the wire request finished before its export")
    b, link = engine(), LoopbackTransport()
    handle, data, times = _wire_move(a, b, req.rid, link, chunk_tokens > 0)
    check(link.bytes_by_link[(0, 1)] == len(data)
          and link.total_ships == 1, "transport counters")
    b.run_until_drained()
    check(handle.done and handle.rid == req.rid, "the moved request did "
                                                 "not finish")
    return list(handle.out_tokens), data, times


def _print_wire(tag, label, data, times, card):
    from repro_torch.region import wire_header
    h = wire_header(data)
    print(f"[{tag}] {label}: payload {len(data)} bytes, codec {h['codec']}, "
          f"version {h['version']}; host export {times['export_ms']:.3f} ms "
          f"(device to host and encode), encode {times['encode_ms']:.3f} ms, "
          f"decode {times['decode_ms']:.3f} ms, i.e. "
          f"{1e6 * times['encode_ms'] / len(data):.3f} + "
          f"{1e6 * times['decode_ms'] / len(data):.3f} ns per payload byte "
          f"({card})")


def phase_wire(torch, card, model, params, reqs):
    """qwen2-0.5b at full width: a session exported mid-decode and a
    prefill exported after 2 of its chunks cross the wire and a
    ``LoopbackTransport`` to a second engine and finish there with the
    unmigrated streams; a corrupted payload is refused before any state is
    touched."""
    from repro_torch.region import WireFormatError, decode_session
    from repro_torch.serve import ServeEngine
    prompt = min((r.prompt for r in reqs), key=len)
    ref, _, _ = _wire_solo(model, params, prompt, 64, None)
    got, data, times = _wire_solo(model, params, prompt, 64, 3)
    check(got == ref, f"wire-migrated stream differs:\n{got}\n{ref}")
    _print_wire("wire", f"mid-decode session of a {len(prompt)}-token prompt",
                data, times, card)
    print(f"[wire] mid-decode: {len(got)} tokens identical to the "
          f"unmigrated stream")
    prompt = max((r.prompt for r in reqs), key=len)
    ref, _, _ = _wire_solo(model, params, prompt, CHUNK_NEW, None, CHUNK)
    got, pdata, ptimes = _wire_solo(model, params, prompt, CHUNK_NEW, 2,
                                    CHUNK)
    check(got == ref, f"wire-migrated prefill differs:\n{got}\n{ref}")
    check(decode_session(pdata).prefilled == 2 * CHUNK,
          "the prefill left after other than 2 chunks")
    _print_wire("wire", f"mid-prefill session ({2 * CHUNK} of "
                f"{len(prompt)} prompt tokens)", pdata, ptimes, card)
    print(f"[wire] mid-prefill: {len(got)} tokens identical to the "
          f"unmigrated chunked stream")
    bad = bytearray(data)
    bad[len(bad) // 2] ^= 0x10
    eng = ServeEngine(model, params, max_batch=8, max_seq=2048)
    try:
        eng.import_session_wire(bytes(bad))
    except WireFormatError as e:
        check(eng.pending() == 0, "a refused payload left state behind")
        print(f"[wire] a payload with one flipped bit is refused: {e}")
    else:
        raise SmokeFailure("a corrupted payload was imported")


# ---------------------------------------------------------------------------
# 8. the fleet tier
# ---------------------------------------------------------------------------

FLEET_NEW = 32               # new tokens a request in runs 1 and 2
FLEET_WINDOW = (5, 13)       # pumps [start, end) of the co-tenant on r1:
                             # from the first pump at which the detector
                             # judges (4 samples), while the 32-token
                             # requests are still live
COTENANT_FACTOR = 3.0        # co-tenant time / r1's baseline step time
COTENANT_BYTES = 2**30       # one stream_copy of the co-tenant
FOLLOWUP = (8, 24)           # follow-ups: prompt tokens, new tokens (more
                             # new than prompt: the DECODE class, the
                             # router's probe traffic)
FOLLOWUP_FROM = 6            # first pump after which a follow-up arrives:
                             # none earlier, since a prefill on r1 in the
                             # window's first two steps would absorb the
                             # co-tenant at its own sync, before the
                             # decode the detector times
FLEET_MAX_PUMPS = 90
CRASH_AT = 3                 # run 2: replica 2 dies at pump 3,
CRASH_RESTART = 9            # restarts at pump 9


def _fleet_counts(rd, fa, rp, sc, zero=False):
    if zero:
        rd.launches = fa.launches = rp.launches = 0
        sc.copy_launches = 0
    return {"ragged_decode": rd.launches, "flash_attention": fa.launches,
            "ragged_prefill": rp.launches, "stream_copy": sc.copy_launches}


def _fleet_expected(gw, layers, chunk_replicas=(), cotenant=0, built=0,
                    chunk_built=0):
    """The launches the engines' own counts imply: every decode step (one
    detector sample each) and each of the ``built`` decode cell builds (an
    engine's, as it allocates its batch cache: at startup and after a
    restart) runs 4 tokens x ``layers`` ragged decodes; every PTT update
    of a whole-prompt engine that is not a decode step is a prefill
    (``layers`` flash launches); a chunking engine's updates that are not
    decode steps are chunks (``layers`` ragged prefills), and each of the
    ``chunk_built`` chunk cell builds (as an engine allocates its working
    prefill cache) one more chunk."""
    det = gw.router.detector
    check(all(e.decode_chunk == 4 for e in gw.engines), "a chunk is not 4")
    exp = {"ragged_decode": built * 4 * layers, "flash_attention": 0,
           "ragged_prefill": chunk_built * layers, "stream_copy": cotenant}
    for r, e in enumerate(gw.engines):
        steps = int(det.samples[r])
        other = e.scheduler.ptt.updates - steps
        exp["ragged_decode"] += steps * 4 * layers
        exp["ragged_prefill" if r in chunk_replicas
            else "flash_attention"] += other * layers
    return exp


def _hook_steps(gw):
    """Chain a per-replica list of decode step latencies (per token) onto
    the hooks the gateway installed."""
    lat = [[] for _ in gw.engines]
    for r, e in enumerate(gw.engines):
        def hook(dt, _r=r, _h=e.on_step_latency):
            lat[_r].append(dt)
            _h(dt)
        e.on_step_latency = hook
    return lat


def _time_drains(gw):
    """(seconds, sessions) of every drain pass that moved sessions: the
    export of each from its source and the import into its new home."""
    pauses = []
    orig = gw._migrate_quarantined

    def timed():
        t0 = time.perf_counter()
        n = orig()
        if n:
            pauses.append((time.perf_counter() - t0, n))
        return n
    gw._migrate_quarantined = timed
    return pauses


def _fleet_report(tag, np, gw, routed, lat, pumps, wall, tokens, card):
    st = gw.stats()
    ttft = np.asarray(sorted(gw.ttfts().values()))
    flat = np.asarray([x for r in lat for x in r])
    print(f"[fleet] {tag}: routed per replica {routed}, served per replica "
          f"(credit follows migrations) {st['per_replica']}")
    print(f"[fleet] {tag}: client TTFT (arrival -> first token, queue wait "
          f"included) p50 {1e3 * np.percentile(ttft, 50):.3f} ms, p99 "
          f"{1e3 * np.percentile(ttft, 99):.3f} ms over {len(ttft)}; TPOT "
          f"p50 {1e3 * np.median(flat):.3f} ms over {len(flat)} decode "
          f"steps; {tokens / wall:.1f} tok/s fleet-wide ({tokens} tokens "
          f"in {wall:.3f} s); wall per pump mean "
          f"{1e3 * wall / len(pumps):.3f} ms, p50 "
          f"{1e3 * np.median(pumps):.3f} ms over {len(pumps)} pumps ({card})")


def _fleet_check_launches(tag, got, exp, phase="fleet"):
    for k, v in exp.items():
        check(got[k] == v, f"{phase} {tag}: {k} launched {got[k]} times, "
                           f"the engines' counts give {v}")
    print(f"[{phase}] {tag}: launches {got} (exact)")


def _drive(gw, reqs, followups, on_pump, max_pumps):
    """Submit ``reqs``, then pump until every request is done, submitting
    one follow-up after each pump from ``FOLLOWUP_FROM`` on while
    ``followups`` yields; ``on_pump(k)`` runs after pump k.  Returns the
    routed-per-replica counts, every pump's wall time, the run's, and the
    requests sent."""
    routed = [0] * len(gw.engines)

    def submit(r):
        d = gw.submit(r)
        if d.replica is not None:
            routed[d.replica] += 1
    for r in reqs:
        submit(r)
    pumps, sent = [], list(reqs)
    t0 = time.perf_counter()
    for k in range(1, max_pumps + 1):
        tp = time.perf_counter()
        gw.pump()
        pumps.append(time.perf_counter() - tp)
        on_pump(k)
        nxt = next(followups, None) if k >= FOLLOWUP_FROM else None
        if nxt is not None:
            submit(nxt)
            sent.append(nxt)
        if (nxt is None and all(gw.handle(r.rid).done for r in sent)
                and not gw.held):
            break
    wall = time.perf_counter() - t0
    check(all(gw.handle(r.rid).done for r in sent),
          f"not every request finished in {max_pumps} pumps")
    return routed, pumps, wall, sent


def phase_fleet(torch, card, model, params, reqs):
    """qwen2-0.5b at full width behind ``FleetGateway`` (three replicas
    sharing one parameter set): (1) monolithic replicas with a co-tenant
    (``stream_copy`` over a large buffer) on replica 1 for a window of
    pumps, which the interference detector must quarantine and readmit,
    and a forced quarantine of the busiest replica; (2) a seeded crash of
    replica 2 with heartbeat detection and recovery; (3) one prefill-role
    replica (chunks of 256) handing every session to two decode-role
    replicas over a ``LoopbackTransport``, with telemetry off and on.
    Every stream must equal the request's solo stream, and every kernel's
    launches the engines' own counts."""
    import numpy as np
    from repro_torch.chaos import FaultInjector
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ragged_decode import ops as rd
    from repro_torch.kernels.ragged_prefill import ops as rp
    from repro_torch.kernels.stream_copy import ops as sc
    from repro_torch.obs import (MetricRegistry, Objective, SLOMonitor,
                                 SpanTracer, TimeSeriesStore)
    from repro_torch.region import LoopbackTransport
    from repro_torch.router import FleetGateway
    from repro_torch.serve import Request, ServeEngine

    L = model.cfg.n_layers
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches = {"ragged_decode": 0, "flash_attention": 0,
                "ragged_prefill": 0, "stream_copy": 0}

    def add(got):
        for k, v in got.items():
            launches[k] += v

    def engines(n=3, **kw):
        return [ServeEngine(model, params, max_batch=8, max_seq=2048,
                            decode_chunk=4, **kw) for _ in range(n)]

    def clones(new):
        return [Request(rid=r.rid, prompt=r.prompt, max_new=new)
                for r in reqs]

    rng = np.random.default_rng(1234)
    fu_prompts = [rng.integers(0, model.cfg.vocab, FOLLOWUP[0])
                  for _ in range(FLEET_MAX_PUMPS)]

    def followups():
        for i, p in enumerate(fu_prompts):
            yield Request(rid=100 + i, prompt=p, max_new=FOLLOWUP[1])

    # the co-tenant: stream_copy of 1 GiB, timed alone here
    src = torch.empty(COTENANT_BYTES, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    for _ in range(3):
        sc.stream_copy(src, out=dst)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(10):
        sc.stream_copy(src, out=dst)
    e1.record()
    e1.synchronize()
    t_copy = e0.elapsed_time(e1) / 10 / 1e3
    print(f"[fleet] co-tenant: stream_copy of {COTENANT_BYTES} bytes takes "
          f"{1e3 * t_copy:.3f} ms ({card})")

    # -- run 1: monolithic, a co-tenant on replica 1 -----------------------
    gw = FleetGateway(engines())
    lat = _hook_steps(gw)
    pauses = _time_drains(gw)
    e1_step = gw.engines[1].step
    cot = {"launches": 0, "per_step": 0, "pumps": []}

    def r1_step():
        if FLEET_WINDOW[0] <= gw._pump_count < FLEET_WINDOW[1]:
            if not cot["per_step"]:
                # r1's baseline decode step (4 tokens) before the window
                base = 4 * float(np.median(lat[1]))
                cot["base"] = base
                cot["per_step"] = math.ceil(COTENANT_FACTOR * base / t_copy)
            for _ in range(cot["per_step"]):
                sc.stream_copy(src, out=dst)
            cot["launches"] += cot["per_step"]
            cot["pumps"].append(gw._pump_count)
            n = e1_step()
            # an idle step syncs nothing: wait here, so that the co-tenant
            # lands on replica 1 and not on the next replica's step
            torch.cuda.current_stream().synchronize()
            return n
        return e1_step()
    gw.engines[1].step = r1_step
    det = gw.router.detector
    flips = {"q": None, "r": None, "n_live": None, "moved": None,
             "drift": []}

    def on_pump(k):
        flips["drift"].append(det.drift(1))
        if flips["q"] is not None and flips["moved"] is None:
            flips["moved"] = gw.stats()["migrations"]
            probes = {t.req.rid for t in gw.tracked if t.probe}
            check(all(r is None or r.rid in probes
                      for r in gw.engines[1].active),
                  "a non-probe session is still live on replica 1")
        if flips["q"] is None and 1 in det.quarantined:
            flips["q"] = k
            flips["n_live"] = sum(
                1 for t in gw.tracked if t.replica == 1 and not t.probe
                and gw.engines[1].active_pos(t.req.rid) is not None)
        if flips["q"] is not None and flips["r"] is None \
                and 1 not in det.quarantined:
            flips["r"] = k

    fus = followups()
    run1 = clones(FLEET_NEW)

    def until_readmitted():
        for r in fus:
            if flips["r"] is not None:
                return
            yield r
    built0 = _cells_built(model)
    _fleet_counts(rd, fa, rp, sc, zero=True)
    routed, pumps, wall, sent = _drive(gw, run1, until_readmitted(),
                                       on_pump, FLEET_MAX_PUMPS)
    got = _fleet_counts(rd, fa, rp, sc)
    builds = _cells_built(model) - built0
    check(builds == 3, f"run 1: {builds} decode cells built for 3 replicas")
    _fleet_check_launches("run 1", got, _fleet_expected(
        gw, L, cotenant=cot["launches"], built=builds))
    add(got)
    check(flips["q"] is not None
          and FLEET_WINDOW[0] <= flips["q"] < FLEET_WINDOW[1],
          f"replica 1 quarantined at pump {flips['q']}, not inside the "
          f"co-tenant's window {FLEET_WINDOW}")
    check(flips["r"] is not None and flips["r"] >= FLEET_WINDOW[1],
          f"replica 1 readmitted at pump {flips['r']}, not after the "
          f"window {FLEET_WINDOW}")
    check(flips["moved"] == flips["n_live"] and flips["n_live"] > 0,
          f"the drain moved {flips['moved']} sessions, replica 1 held "
          f"{flips['n_live']} live non-probe sessions")
    check(gw.router.fleet.updates > 16, "FleetPTT updates <= 16")
    check(det.samples.sum() > 0, "the detector saw no sample")
    check(gw.stats()["requests_served"] == len(sent), "served count")
    tokens = sum(len(r.out_tokens) for r in sent)
    _fleet_report("run 1 (monolithic, co-tenant on r1)", np, gw, routed,
                  lat, pumps, wall, tokens, card)
    print(f"[fleet] run 1: co-tenant {cot['per_step']} stream_copy launches "
          f"before each of r1's steps in pumps {cot['pumps'][0]}-"
          f"{cot['pumps'][-1]} ({COTENANT_FACTOR}x r1's baseline step of "
          f"{1e3 * cot['base']:.3f} ms), {cot['launches']} in all; "
          f"quarantined at pump {flips['q']}, readmitted at pump "
          f"{flips['r']}; r1's drift ratio at quarantine "
          f"{flips['drift'][flips['q'] - 1]:.3f}, max "
          f"{max(flips['drift']):.3f}; events {list(det.events)}")
    adm = {k: sum(v.values()) for k, v in gw.stats()["admission"].items()}
    print(f"[fleet] run 1: the drain at pump {flips['q'] + 1} moved "
          f"{flips['n_live']} live sessions off r1; {len(sent) - len(run1)} "
          f"follow-ups ({FOLLOWUP[0]} prompt tokens, {FOLLOWUP[1]} new); "
          f"admission {adm}")
    pause = sum(s for s, _ in pauses) / sum(n for _, n in pauses)
    print(f"[fleet] run 1: drains (ms, sessions) "
          f"{[(round(1e3 * s, 3), n) for s, n in pauses]}: the migration "
          f"pause {1e3 * pause:.3f} ms a session ({card})")
    del src, dst
    solo = {}

    def solo_of(r):
        key = (r.rid, r.max_new)
        if key not in solo:
            solo[key], _ = _solo_stream(torch, np, model, params, r.prompt,
                                        r.max_new, None)
        return solo[key]
    for r in sent:
        check(list(gw.handle(r.rid).out_tokens) == solo_of(r),
              f"fleet run 1: request {r.rid}'s stream differs from its "
              f"solo stream")
    print(f"[fleet] run 1: {len(sent)} streams identical to their solo "
          f"streams")

    # -- run 1b: a forced quarantine of the busiest replica ----------------
    gw = FleetGateway(engines())
    lat = _hook_steps(gw)
    pauses = _time_drains(gw)
    run1b = clones(FLEET_NEW)
    built0 = _cells_built(model)
    _fleet_counts(rd, fa, rp, sc, zero=True)
    for r in run1b:
        gw.submit(r)
    for _ in range(3):
        gw.pump()
    victim = max(range(3), key=lambda i: gw.engines[i].active_count())
    n_live = gw.engines[victim].active_count()
    check(n_live > 0, "no live session to drain")
    gw.router.detector.force_quarantine(victim)
    gw.pump()
    check(gw.engines[victim].active_count() == 0,
          f"replica {victim} still holds sessions after the drain")
    check(gw.stats()["migrations"] == n_live,
          f"{gw.stats()['migrations']} migrations != {n_live} live "
          f"sessions of replica {victim}")
    gw.run_until_drained(FLEET_MAX_PUMPS)
    got = _fleet_counts(rd, fa, rp, sc)
    _fleet_check_launches("run 1b", got, _fleet_expected(
        gw, L, built=_cells_built(model) - built0))
    add(got)
    for r in run1b:
        check(r.done and list(r.out_tokens) == solo_of(r),
              f"fleet run 1b: request {r.rid}'s stream differs from its "
              f"solo stream")
    s, n = pauses[0]
    print(f"[fleet] run 1b: force_quarantine({victim}) moved {n_live} live "
          f"sessions in {1e3 * s:.3f} ms ({1e3 * s / n:.3f} ms a session, "
          f"{card}); {len(run1b)} streams identical to their solo streams")

    # -- run 2: a seeded crash of replica 2 --------------------------------
    inj = FaultInjector(0).crash(2, at_step=CRASH_AT,
                                 restart_at=CRASH_RESTART)
    gw = FleetGateway(engines(), transport=LoopbackTransport(),
                      injector=inj, heartbeat_timeout=2)
    lat = _hook_steps(gw)
    run2 = clones(FLEET_NEW)
    built0 = _cells_built(model)
    _fleet_counts(rd, fa, rp, sc, zero=True)
    routed, pumps, wall, sent = _drive(gw, run2, iter(()),
                                       lambda k: None, FLEET_MAX_PUMPS)
    got = _fleet_counts(rd, fa, rp, sc)
    builds = _cells_built(model) - built0
    # the restarted replica allocates a new cache and builds its cell anew
    # as its first request is slotted, whenever that is; one more cell
    # than replicas if it took one after its restart
    check(3 <= builds <= 4, f"run 2: {builds} decode cells built")
    _fleet_check_launches("run 2", got, _fleet_expected(gw, L,
                                                        built=builds))
    add(got)
    st = gw.stats()
    crash = {k: st[k] for k in ("crashes_detected",
                                "crash_sessions_recovered",
                                "crash_requests_resubmitted")}
    check(st["crashes_detected"] == 1, f"crash counters {crash}")
    check(st["crash_sessions_recovered"]
          + st["crash_requests_resubmitted"] > 0,
          f"nothing recovered after the crash: {crash}")
    for r in run2:
        check(list(gw.handle(r.rid).out_tokens) == solo_of(r),
              f"fleet run 2: request {r.rid}'s stream differs from its "
              f"solo stream")
    tokens = sum(len(gw.handle(r.rid).out_tokens) for r in run2)
    _fleet_report("run 2 (crash of r2)", np, gw, routed, lat, pumps, wall,
                  tokens, card)
    print(f"[fleet] run 2: replica 2 crashed at pump {CRASH_AT}, restarted "
          f"at pump {CRASH_RESTART}; counters {crash}; quarantined "
          f"{st['quarantined']}; {len(run2)} streams (through "
          f"gw.handle) identical to their solo streams")

    # -- run 3: prefill -> decode handoff, telemetry off and on ------------
    chunked, per_pump = {}, {}
    # a warm-up fleet, not reported: the first disaggregated fleet pays the
    # allocator's growth and first calls, which would otherwise land on
    # whichever of the two runs below came first
    gw = FleetGateway(
        engines(1, role="prefill", prefill_chunk_tokens=CHUNK)
        + engines(2, role="decode"), transport=LoopbackTransport())
    gw.attach_obs(SpanTracer("warm-up"), MetricRegistry(), name="warm-up")
    for r in clones(CHUNK_NEW)[:2]:
        gw.submit(r)
    gw.run_until_drained(400)
    for telemetry in (False, True):
        gw = FleetGateway(
            engines(1, role="prefill", prefill_chunk_tokens=CHUNK)
            + engines(2, role="decode"), transport=LoopbackTransport())
        if telemetry:
            reg, tr = MetricRegistry(), SpanTracer("fleet")
            gw.attach_obs(tr, reg, name="fleet")
            mon = SLOMonitor([Objective("ttft", target=0.9, threshold=1.0),
                              Objective("tpot", target=0.9, threshold=0.05),
                              Objective("availability", target=0.99)],
                             fast_window=4, slow_window=16)
            gw.attach_slo(mon)
            store = TimeSeriesStore(reg)
            gw.attach_timeseries(store)
        lat = _hook_steps(gw)
        run3 = clones(CHUNK_NEW)
        built0 = _cells_built(model)
        chunk0 = _cells_built(model, "prefill_chunk")
        _fleet_counts(rd, fa, rp, sc, zero=True)
        routed, pumps, wall, sent = _drive(gw, run3, iter(()),
                                           lambda k: None, 400)
        got = _fleet_counts(rd, fa, rp, sc)
        tag = ("run 3 (disaggregated, telemetry "
               f"{'on' if telemetry else 'off'})")
        chunk_built = _cells_built(model, "prefill_chunk") - chunk0
        _fleet_check_launches(tag, got, _fleet_expected(
            gw, L, (0,), built=_cells_built(model) - built0,
            chunk_built=chunk_built))
        add(got)
        n_chunks = sum(-(-len(r.prompt) // CHUNK) for r in run3)
        check(chunk_built == 1, f"{tag}: the prefill replica built "
              f"{chunk_built} chunk cells, not one")
        check(got["ragged_prefill"] == (n_chunks + chunk_built) * L
              and got["flash_attention"] == 0,
              f"{tag}: ({n_chunks} chunks + the cell's build) x {L} layers "
              f"expected")
        st = gw.stats()
        check(st["prefill_handoffs"] == len(run3),
              f"{tag}: {st['prefill_handoffs']} handoffs != {len(run3)}")
        for r in run3:
            if r.rid not in chunked:
                chunked[r.rid] = _chunked_solo(model, params, r.prompt, None)
            check(r.done and list(r.out_tokens) == chunked[r.rid],
                  f"{tag}: request {r.rid}'s stream differs from its "
                  f"chunked solo stream")
        tokens = sum(len(r.out_tokens) for r in run3)
        _fleet_report(tag, np, gw, routed, lat, pumps, wall, tokens, card)
        bd = gw.ttft_breakdown().values()
        p50 = {k: 1e3 * float(np.median([b[k] for b in bd]))
               for k in ("prefill_s", "ship_s", "first_decode_s")}
        print(f"[fleet] {tag}: {len(run3)} handoffs, TTFT breakdown p50 "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in p50.items())
              + f", payload p50 {int(np.median([b['nbytes'] for b in bd]))} "
              f"bytes; {len(run3)} streams identical to their chunked solo "
              f"streams ({card})")
        if telemetry:
            print(f"[fleet] {tag}: SLO alerts "
                  f"{[(a.objective, a.state, a.tick) for a in mon.alerts]}, "
                  f"Prometheus text {len(reg.prometheus_text())} bytes, "
                  f"{len(tr.events)} trace events, {store.samples} "
                  f"time-series samples")
        # the handoffs' wire encode is most of the pump's wall and varies
        # with the host; the pump's time outside it is the steadier reading
        ship = sum(b["ship_s"] for b in bd)
        per_pump[telemetry] = (1e3 * wall / len(pumps),
                               1e3 * (wall - ship) / len(pumps))
    (off, off_x), (on, on_x) = per_pump[False], per_pump[True]
    print(f"[fleet] run 3: wall per pump {off:.3f} ms with the telemetry "
          f"off, {on:.3f} ms on ({on - off:+.3f} ms); outside the "
          f"handoffs' ship time {off_x:.3f} ms off, {on_x:.3f} ms on "
          f"({on_x - off_x:+.3f} ms, {card})")
    peak = torch.cuda.max_memory_allocated()
    print(f"[fleet] peak device memory {peak} bytes; phase "
          f"{time.perf_counter() - t_phase:.1f} s ({card})")
    return launches


# ---------------------------------------------------------------------------
# 9. the region tier
# ---------------------------------------------------------------------------

REGION_NEW = 16              # new tokens a request
REGION_BROWNOUT = 3          # pumps before fleet 0 is browned out
REGION_LINK_RTT = 1e-3       # seconds a delivery over the loopback link
REGION_MAX_PUMPS = 60
# tests/test_chaos.py::test_region_chaos_drain_token_identity's faults: its
# rates, its partition of link 0 -> 1 over pumps [2, 4) of the injector's
# clock (advanced once a pump), 10 attempts and no jitter; the simulated
# backoff starts at 0.5 ms and doubles to at most 2 ms, so that a retried
# delivery's reported time stays below what staying home costs
REGION_FAULTS = dict(drop=0.3, corrupt=0.1, duplicate=0.4)
REGION_PARTITION = (2, 4)
REGION_BACKOFF = (5e-4, 2e-3)


def _timed(obj, name, log):
    """Replace ``obj.name`` by a wrapper that appends each call's seconds
    to ``log``; returns the function that restores it."""
    fn = getattr(obj, name)

    def run(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            log.append(time.perf_counter() - t0)
    setattr(obj, name, run)
    return lambda: setattr(obj, name, fn)


def phase_region(torch, seed, card, model, params, serve_reqs):
    """qwen2-0.5b at full width behind ``RegionGateway`` over two fleets of
    two replicas each (``FleetGateway``, 8 slots, chunks of 4): 8 of the
    serve phase's prompts, 16 new tokens each, all entering at region 0
    (the link's RTT row trained first, so that every request stays home);
    after 3 pumps fleet 0 is browned out and the next pump drains its live
    sessions to fleet 1 as wire bytes.  Once over ``ReliableTransport``
    (``ChaosTransport`` over a ``LoopbackTransport``, seeded faults, the
    injector advanced once a pump) and once over the plain
    ``LoopbackTransport``.  Fleet 0 holds no live session after the drain
    pump, nothing is lost or adopted twice, every stream equals its solo
    stream, and every kernel's launches equal the engines' own counts."""
    import numpy as np
    from repro_torch.chaos import (ChaosTransport, FaultInjector,
                                   ReliableTransport)
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ragged_decode import ops as rd
    from repro_torch.kernels.ragged_prefill import ops as rp
    from repro_torch.kernels.stream_copy import ops as sc
    from repro_torch.region import (LoopbackTransport, RegionGateway,
                                    gateway as region_gateway)
    from repro_torch.router import FleetGateway
    from repro_torch.serve import Request, ServeEngine

    L = model.cfg.n_layers
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prompts = [r.prompt for r in serve_reqs[::2]]
    solo = [_solo_stream(torch, np, model, params, p, REGION_NEW, None)[0]
            for p in prompts]
    launches = {"ragged_decode": 0, "flash_attention": 0,
                "ragged_prefill": 0, "stream_copy": 0}

    def link(s, d):
        return REGION_LINK_RTT

    for chaos in (True, False):
        tag = "chaos" if chaos else "control"
        inj = None
        if chaos:
            inj = (FaultInjector(seed).default_link(**REGION_FAULTS)
                   .partition(0, 1, start=REGION_PARTITION[0],
                              until=REGION_PARTITION[1]))
            transport = ReliableTransport(
                ChaosTransport(LoopbackTransport(link), inj),
                max_attempts=10, base_backoff=REGION_BACKOFF[0],
                max_backoff=REGION_BACKOFF[1], jitter=0.0, seed=seed)
        else:
            transport = LoopbackTransport(link)
        fleets = [FleetGateway([
            ServeEngine(model, params, max_batch=8, max_seq=2048,
                        decode_chunk=4) for _ in range(2)])
            for _ in range(2)]
        lat = _hook_steps(fleets[1])      # fleet 1 decodes moved sessions
        region = RegionGateway(fleets, transport=transport)
        # the link's row trained, as by earlier traffic: a fresh request's
        # search then charges the hop, and every request stays home
        region.router.record_rtt(0, 1, REGION_LINK_RTT)
        times = {"export": [], "encode": [], "ship": [], "decode": [],
                 "drain": []}
        restore = [_timed(fleets[0], "export_for_region", times["export"]),
                   _timed(region_gateway, "encode_session", times["encode"]),
                   _timed(region_gateway, "decode_session", times["decode"]),
                   _timed(transport, "ship", times["ship"]),
                   _timed(region, "_drain_browned_out", times["drain"])]
        reqs = [Request(rid=i, prompt=p, max_new=REGION_NEW)
                for i, p in enumerate(prompts)]
        built0 = _cells_built(model)
        _fleet_counts(rd, fa, rp, sc, zero=True)
        t0 = time.perf_counter()
        homes = [region.submit(r, origin=0, affinity=0).fleet for r in reqs]
        check(homes == [0] * len(reqs), f"region {tag}: requests routed to "
                                        f"{homes}, not all home")
        for _ in range(REGION_BROWNOUT):
            region.pump()
            if inj is not None:
                inj.advance()
        live = [rid for rid, _, _ in fleets[0].live_sessions()]
        check(len(live) == len(reqs),
              f"region {tag}: {len(live)} live sessions on fleet 0 at the "
              f"brownout, not {len(reqs)}")
        region.brownout(0)
        pumps = 0
        for _ in range(REGION_MAX_PUMPS):
            if inj is not None:
                inj.advance()
            active = region.pump()
            pumps += 1
            if pumps == 1:
                left = fleets[0].live_sessions()
                check(not left and not any(
                    e.active_count() or e.pending()
                    for e in fleets[0].engines),
                    f"region {tag}: fleet 0 still holds {left} after the "
                    f"drain pump")
                at_drain = region.stats()
            if (active == 0 and not any(gw.held for gw in fleets)
                    and not any(e.pending() for gw in fleets
                                for e in gw.engines)):
                break
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for undo in restore:
            undo()
        got = _fleet_counts(rd, fa, rp, sc)
        exp = {k: 0 for k in got}
        exp["ragged_decode"] = (_cells_built(model) - built0) * 4 * L
        for gw in fleets:
            for k, v in _fleet_expected(gw, L).items():
                exp[k] += v
        _fleet_check_launches(tag, got, exp, phase="region")
        for k, v in got.items():
            launches[k] += v
        st = region.stats()
        check(st["requests_served"] == len(reqs),
              f"region {tag}: {st['requests_served']} served, not "
              f"{len(reqs)}")
        check(at_drain["wan_ships"] >= len(live),
              f"region {tag}: {at_drain['wan_ships']} ships at the drain, "
              f"{len(live)} live sessions at the brownout")
        check(st["fleet_served"] == [0, len(reqs)],
              f"region {tag}: served per fleet {st['fleet_served']}")
        for r, want in zip(reqs, solo):
            h = region.request(r.rid)
            check(h.done and list(h.out_tokens) == want,
                  f"region {tag}: request {r.rid}'s stream differs from its "
                  f"solo stream")
        moved = [rid for rid in live if region.request(rid) is not reqs[rid]]
        check(sorted(moved) == sorted(live),
              f"region {tag}: moved {moved}, live at the brownout {live}")
        if inj is not None:
            faults, sent = dict(inj.counts), transport.stats()
            check(st["duplicates_deduped"] + st["duplicates_dropped"]
                  == faults["duplicate"],
                  f"region chaos: {faults['duplicate']} duplicated "
                  f"deliveries, {st['duplicates_deduped']} deduplicated "
                  f"and {st['duplicates_dropped']} dropped")
            check(sent["exhausted"] == st["delivery_failures"] == 0,
                  f"region chaos: deliveries failed: {sent}")
        ttft = region.ttfts()
        ttft_moved = np.asarray([ttft[rid] for rid in moved])
        tpot = np.asarray([x for r in lat for x in r])
        n = max(st["wan_ships"], 1)
        drain_s = times.pop("drain")[REGION_BROWNOUT]   # the drain pump's
        per = {k: 1e3 * sum(v) / max(len(v), 1) for k, v in times.items()}
        print(f"[region] {tag}: {len(reqs)} requests x {REGION_NEW} tokens, "
              f"prompts {min(map(len, prompts))}-{max(map(len, prompts))}, "
              f"all home on fleet 0; browned out after {REGION_BROWNOUT} "
              f"pumps with {len(live)} live sessions, all moved by the next "
              f"pump; {pumps} pumps after the brownout; wall {wall:.3f} s")
        print(f"[region] {tag}: {st['wan_ships']} ships, {st['wan_bytes']} "
              f"wire bytes, {st['raw_session_bytes']} raw bytes "
              f"({st['raw_session_bytes'] / n:.0f} a ship); the drain pass "
              f"{1e3 * drain_s:.3f} ms ({1e3 * drain_s / n:.3f} ms a ship); "
              f"per call: export "
              f"{per['export']:.3f} ms (device to host), encode "
              f"{per['encode']:.3f} ms, ship {per['ship']:.3f} ms "
              f"({len(times['ship'])} ships), decode {per['decode']:.3f} ms "
              f"({len(times['decode'])} decodes, duplicates included) "
              f"({card})")
        if inj is not None:
            print(f"[region] chaos: transport {sent}; injector {faults}; "
                  f"duplicates deduplicated {st['duplicates_deduped']}, "
                  f"dropped {st['duplicates_dropped']}; RTT row 0->1 "
                  f"{st['rtt_rows'][0][1]:.6f} s")
        print(f"[region] {tag}: moved requests' client TTFT (arrival -> "
              f"first token, on fleet 0) p50 "
              f"{1e3 * float(np.median(ttft_moved)):.3f} ms; their TPOT on "
              f"fleet 1 p50 {1e3 * float(np.median(tpot)):.3f} ms over "
              f"{len(tpot)} decode steps; {len(reqs)} streams identical to "
              f"their solo streams ({card})")
    peak = torch.cuda.max_memory_allocated()
    print(f"[region] peak device memory {peak} bytes; phase "
          f"{time.perf_counter() - t_phase:.1f} s ({card})")
    return launches


# ---------------------------------------------------------------------------
# 10. the MoE family (and the serving run the SSM and hybrid phases share)
# ---------------------------------------------------------------------------

MOE_NEW = 32


def _ranged(module, names):
    """Wrap the functions ``names`` of ``module`` in profiler ranges (for a
    profiled window only); returns the function that restores them."""
    from torch.profiler import record_function
    saved = {n: getattr(module, n) for n in names}

    def ranged(name, fn):
        def run(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return run

    for n, fn in saved.items():
        setattr(module, n, ranged(n, fn))
    return lambda: [setattr(module, n, fn) for n, fn in saved.items()]


def _init_family(torch, tag, cfg, seed, card, note=""):
    """The family's model with seed-``seed`` weights drawn on the card,
    after the previous phases' memory is given back; prints its size and
    the peak over the init."""
    from repro_torch.models import get_model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = get_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    print(f"[{tag}] {cfg.name}{note}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}: {n_params} parameters "
          f"({cfg.param_count()} by the config), {n_bytes} bytes on the card "
          f"in {cfg.compute_dtype} (float32 norms, SSM scalars and router), "
          f"init {time.perf_counter() - t0:.2f} s, peak over the init "
          f"{torch.cuda.max_memory_allocated()} bytes ({card})")
    return model, params


def _serve_family(torch, np, tag, cfg, model, params, prompts, max_new,
                  card, extras=None):
    """The prompts (with ``extras[i]`` as request i's extras, if given)
    through an 8-slot engine (``max_seq`` 2048, chunks of 4) after a
    warm-up request: every request finishes with ``max_new``
    in-vocabulary tokens, and the engine builds one decode cell (its CUDA
    graph).  The attention kernels' counts are set to 0 just before the
    run and read just after.  Then the same prompts through an engine
    over the eager loop the cell captures: the same tokens, and the same
    launches but for the cell's build (one decode pass).  Prints tok/s,
    TPOT, TTFT and the peak memory of both runs and the cell's capture
    time; returns the graph run's requests, decode passes (steps and the
    cell's build) and launches, and the counts read just before they were
    set to 0."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ragged_decode import ops as rd
    from repro_torch.kernels.ragged_prefill import ops as rp
    from repro_torch.serve import Request, ServeEngine
    extras = extras or [{} for _ in prompts]
    warm = ServeEngine(model, params, max_batch=8, max_seq=2048,
                       decode_chunk=4)
    warm.submit(Request(rid=-1, prompt=prompts[0][:64], max_new=8,
                        extras=extras[0]))
    warm.run_until_drained()
    del warm                  # its idle batch cache must not count in the peak
    cache_bytes = sum(math.prod(shape) * torch.empty((), dtype=dt)
                      .element_size() for shape, dt in
                      model.cache_spec(8, 2048).values())

    def run(m, how):
        engine = ServeEngine(m, params, max_batch=8, max_seq=2048,
                             decode_chunk=4)
        reqs = [Request(rid=i, prompt=p, max_new=max_new, extras=x)
                for i, (p, x) in enumerate(zip(prompts, extras))]
        lat = []
        engine.on_step_latency = lat.append
        for r in reqs:
            engine.submit(r)
        earlier = {"ragged_decode": rd.launches,
                   "flash_attention": fa.launches,
                   "ragged_prefill": rp.launches}
        built0 = _cells_built(m)
        rd.launches = fa.launches = rp.launches = 0   # this path's run only
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {"ragged_decode": rd.launches,
                    "flash_attention": fa.launches,
                    "ragged_prefill": rp.launches}
        captures = _capture_ms(m)[built0:]

        check(all(r.done for r in reqs), f"{tag}: not every request finished")
        check(all(len(r.out_tokens) == max_new for r in reqs),
              f"{tag}: token counts {[len(r.out_tokens) for r in reqs]}")
        check(all(0 <= t < cfg.vocab for r in reqs for t in r.out_tokens),
              f"{tag}: a token is outside [0, vocab)")
        dec_tokens = sum(len(r.out_tokens) - 1 for r in reqs)
        ttft = sorted(r.t_first - r.t_admit for r in reqs)
        print(f"[{tag}] {how}: {len(reqs)} requests x {max_new} tokens, "
              f"prompts {min(map(len, prompts))}-{max(map(len, prompts))}: "
              f"wall {wall:.3f} s, {len(lat)} decode steps")
        print(f"[{tag}] {how}: decode {dec_tokens / (sum(lat) * 4):.1f} "
              f"tok/s, p50 TPOT {1e3 * float(np.median(lat)):.3f} ms, p50 "
              f"TTFT {1e3 * ttft[len(ttft) // 2]:.3f} ms ({card})")
        print(f"[{tag}] {how}: launches in the run: {launches}; decode "
              f"cells built {len(captures)}, capture ms "
              f"{[round(c, 3) for c in captures]}")
        print(f"[{tag}] {how}: peak device memory {peak} bytes; the batch "
              f"cache {cache_bytes} bytes ({card})")
        return reqs, lat, launches, earlier, captures

    reqs, lat, launches, earlier, captures = run(model, "graph")
    check(len(captures) == 1, f"{tag}: the engine built {len(captures)} "
          f"decode cells, not one (B 8, k 4)")
    ereqs, elat, elaunches, _, ecaptures = run(_eager(model), "eager loop")
    check(not ecaptures, f"{tag}: the eager loop built a cell")
    check(len(elat) == len(lat), f"{tag}: {len(lat)} decode steps on the "
          f"graph, {len(elat)} on the eager loop")
    # the cell's build is one more decode pass: the eager run's launches a
    # step, once more
    per_step = elaunches["ragged_decode"] // max(len(elat), 1)
    check(elaunches["ragged_decode"] == per_step * len(elat)
          and launches["ragged_decode"] == per_step * _passes(len(lat), 1)
          and all(launches[k] == elaunches[k] for k in launches
                  if k != "ragged_decode"),
          f"{tag}: launches: graph {launches}, eager loop {elaunches}, "
          f"{len(lat)} steps and the cell's build")
    for r, e in zip(reqs, ereqs):
        check(r.out_tokens == e.out_tokens, f"{tag}: request {r.rid}: the "
              f"graph's stream differs from the eager loop's:\n"
              f"{r.out_tokens}\n{e.out_tokens}")
    print(f"[{tag}] graph against eager loop: all {len(reqs)} streams "
          f"identical, launches equal but for the cell's build "
          f"({per_step} ragged decodes)")
    return reqs, _passes(len(lat), len(captures)), launches, earlier


def _decode_window(torch, model, params, reqs, label, card, ranges=()):
    """A profiled window of 3 decode chunks x 4 tokens on a full batch of
    the given prompts (admitted, and one chunk run, before the window)."""
    from repro_torch.serve import Request, ServeEngine
    eng = ServeEngine(model, params, max_batch=8, max_seq=2048,
                      decode_chunk=4)
    for r in reqs:
        eng.submit(Request(rid=r.rid, prompt=r.prompt, max_new=64,
                           extras=r.extras))
    eng.step()                        # admits all 8, first chunk
    return _profile_window(torch, lambda: [eng.step() for _ in range(3)],
                           label, card, ranges=ranges)


def _wire_check(tag, model, params, prompt, max_new, card, extras=None):
    """A session moved through the wire after 3 steps continues the
    unmigrated stream, which is returned."""
    ref, _, _ = _wire_solo(model, params, prompt, max_new, None,
                           extras=extras)
    got, data, times = _wire_solo(model, params, prompt, max_new, 3,
                                  extras=extras)
    check(got == ref, f"{tag}: wire-migrated stream differs:\n{got}\n{ref}")
    _print_wire(tag, f"mid-decode session of a {len(prompt)}-token prompt",
                data, times, card)
    print(f"[{tag}] migration: {len(got)} tokens identical to the "
          f"unmigrated stream")
    return ref


def phase_moe(torch, seed, card, serve_reqs):
    """granite-moe-1b-a400m at full width through ``ServeEngine``: 8
    requests (the serve phase's prompt lengths, every other one, over this
    vocabulary) and 32 new tokens each, 8 slots, chunks of 4; launch
    counts exact; a session moved through the wire mid-decode continues
    the unmigrated stream."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("granite-moe-1b-a400m")
    model, params = _init_family(
        torch, "moe", cfg, seed, card,
        note=f" ({cfg.n_heads}/{cfg.n_kv_heads} heads, {cfg.n_experts} "
             f"experts top-{cfg.top_k}, d_expert {cfg.d_expert})")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, len(r.prompt))
               for r in serve_reqs[::2]]
    reqs, passes, launches, _ = _serve_family(torch, np, "moe", cfg, model,
                                              params, prompts, MOE_NEW, card)
    check(launches["flash_attention"] == len(reqs) * cfg.n_layers,
          f"moe: flash_attention launches {launches['flash_attention']} != "
          f"{len(reqs)} prefills x {cfg.n_layers} layers")
    check(launches["ragged_decode"] == passes * 4 * cfg.n_layers,
          f"moe: ragged_decode launches {launches['ragged_decode']} != "
          f"{passes} decode passes x 4 tokens x {cfg.n_layers} layers")
    lo, hi = min(map(len, prompts)), max(map(len, prompts))
    print(f"[moe] prefill capacity {moe.capacity(cfg, lo)}-"
          f"{moe.capacity(cfg, hi)} copies per expert; decode at no-drop "
          f"capacity 8")

    prof = _decode_window(torch, model, params, reqs,
                          "moe: 3 decode chunks x 4 tokens, 8 slots (graph)",
                          card)
    if prof is not None:
        print(f"[moe] decode window (graph): device busy share "
              f"{prof['busy'] / prof['wall']:.3f} ({card})")
    # where the decode's device time goes: attention kernels, routing and
    # dispatch, expert products; on the eager loop, since a profiler range
    # sees no kernel that a graph replays
    restore = _ranged(moe, ("moe_apply", "expert_ffn"))
    try:
        prof = _decode_window(torch, _eager(model), params, reqs,
                              "moe: 3 decode chunks x 4 tokens, 8 slots "
                              "(eager loop)", card,
                              ranges=("moe_apply", "expert_ffn"))
    finally:
        restore()
    if prof is not None:
        print(f"[moe] decode window (eager loop): device busy share "
              f"{prof['busy'] / prof['wall']:.3f} ({card})")
    if prof is not None and {"moe_apply", "expert_ffn"} <= prof.keys():
        print(f"[moe] decode window: MoE layers {prof['moe_apply']:.3f} ms "
              f"of {1e3 * prof['busy']:.3f} ms device time: expert products "
              f"{prof['expert_ffn']:.3f} ms, routing and dispatch "
              f"{prof['moe_apply'] - prof['expert_ffn']:.3f} ms")
    longest = max(prompts, key=len)
    tokens = torch.as_tensor(longest, device="cuda").long()[None]
    _profile_window(torch, lambda: model.prefill(params, {"tokens": tokens}),
                    f"moe: prefill of {len(longest)} tokens", card)
    _wire_check("moe", model, params, min(prompts, key=len), MOE_NEW, card)
    return launches


# ---------------------------------------------------------------------------
# 11. the MoE family's alternating dense / MoE layout
# ---------------------------------------------------------------------------

MOE_ALT_EVERY = 2
MOE_ALT_NEW = 16


def phase_moe_alt(torch, seed, card, serve_reqs):
    """granite-moe-1b-a400m at full width with ``moe_every = 2`` (set with
    ``dataclasses.replace``): 12 superblocks, each one SwiGLU dense layer
    and one MoE layer (32 experts top-8).  The layout is the reference's
    (``repro/models/moe.py``'s superblock scan), not a published
    checkpoint; the weights are random, from the seed.  The MoE phase's 8
    prompts, 16 new tokens each, 8 slots, chunks of 4: every request
    finishes in vocabulary, 24 flash launches a prefill and 24 ragged
    decodes a token step, and a session moved through the wire mid-decode
    continues the unmigrated stream."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                              moe_every=MOE_ALT_EVERY)
    nb, per_d = moe.layout(cfg)
    model, params = _init_family(
        torch, "moe-alt", cfg, seed, card,
        note=f" with moe_every {cfg.moe_every}: {nb} superblocks of "
             f"{per_d} dense SwiGLU layer (d_ff {cfg.d_ff}) and 1 MoE layer "
             f"({cfg.n_experts} experts top-{cfg.top_k}, d_expert "
             f"{cfg.d_expert}), {cfg.n_heads}/{cfg.n_kv_heads} heads")
    spec = model.cache_spec(8, 2048)
    print(f"[moe-alt] cache leaves "
          f"{ {k: tuple(v[0]) for k, v in spec.items()} }")
    # the MoE phase's prompts: the same draws over the same vocabulary
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, len(r.prompt))
               for r in serve_reqs[::2]]
    reqs, passes, launches, _ = _serve_family(torch, np, "moe-alt", cfg,
                                              model, params, prompts,
                                              MOE_ALT_NEW, card)
    check(launches["flash_attention"] == len(reqs) * cfg.n_layers,
          f"moe-alt: flash_attention launches "
          f"{launches['flash_attention']} != {len(reqs)} prefills x "
          f"{cfg.n_layers} layers")
    check(launches["ragged_decode"] == passes * 4 * cfg.n_layers,
          f"moe-alt: ragged_decode launches {launches['ragged_decode']} != "
          f"{passes} decode passes x 4 tokens x {cfg.n_layers} layers")
    check(launches["ragged_prefill"] == 0, "moe-alt: a chunk kernel ran")
    _wire_check("moe-alt", model, params, min(prompts, key=len), MOE_ALT_NEW,
                card)
    return launches


# ---------------------------------------------------------------------------
# 12. the SSM family
# ---------------------------------------------------------------------------

SSM_NEW = 32


def phase_ssm(torch, seed, card, serve_reqs):
    """mamba2-130m at full width and depth through ``ServeEngine``: 8
    requests (the serve phase's prompt lengths, every other one) and 32
    new tokens each; no attention kernel launches anywhere in the phase;
    a session (its whole SSM and conv state) moved through the wire
    mid-decode continues the unmigrated stream."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ragged_decode import ops as rd
    from repro_torch.kernels.ragged_prefill import ops as rp

    cfg = get_config("mamba2-130m")
    rd.launches = fa.launches = rp.launches = 0   # the whole phase
    model, params = _init_family(
        torch, "ssm", cfg, seed, card,
        note=f" (d_inner {cfg.d_inner}, {cfg.ssm_heads} SSM heads of "
             f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, conv "
             f"{cfg.ssm_conv}, chunk {cfg.ssm_chunk})")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, len(r.prompt))
               for r in serve_reqs[::2]]
    reqs, _, launches, earlier = _serve_family(torch, np, "ssm", cfg, model,
                                               params, prompts, SSM_NEW, card)
    check(not any(earlier.values()) and not any(launches.values()),
          f"ssm: an attention kernel launched: {earlier} before the run, "
          f"{launches} in it")
    prof = _decode_window(torch, model, params, reqs,
                          "ssm: 3 decode chunks x 4 tokens, 8 slots (graph)",
                          card)
    if prof is not None:
        print(f"[ssm] decode window (graph): device busy share "
              f"{prof['busy'] / prof['wall']:.3f} ({card})")
    longest = max(prompts, key=len)
    tokens = torch.as_tensor(longest, device="cuda").long()[None]
    _profile_window(torch, lambda: model.prefill(params, {"tokens": tokens}),
                    f"ssm: prefill of {len(longest)} tokens", card)
    _wire_check("ssm", model, params, min(prompts, key=len), SSM_NEW, card)
    after = {"ragged_decode": rd.launches, "flash_attention": fa.launches,
             "ragged_prefill": rp.launches}
    check(not any(after.values()),
          f"ssm: an attention kernel launched in the phase: {after}")
    print(f"[ssm] attention kernel launches in the whole phase: {after}")


# ---------------------------------------------------------------------------
# 13. the hybrid family
# ---------------------------------------------------------------------------

HYBRID_LAYERS = 8            # one superblock: what one card's memory holds
HYBRID_NEW = 16              # new tokens a request, cut for time


def phase_hybrid(torch, seed, card, serve_reqs):
    """jamba-v0.1-52b at full width, cut to one superblock (8 of 32
    layers: 49.3 B parameters by the config do not fit one card's 80 GB
    in bf16), through ``ServeEngine``: 8 requests (the serve phase's
    prompt lengths, every other one) and 16 new tokens each; attention
    kernel launches exact (``nb`` per prefill and per decode token step);
    a session moved through the wire mid-decode continues the unmigrated
    stream; a profiled decode window split into the attention kernel, the
    MoE routing and dispatch, the expert products, the SSM layers and the
    rest."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import mamba2, moe

    full = get_config("jamba-v0.1-52b")
    cfg = dataclasses.replace(full, n_layers=HYBRID_LAYERS)
    nb = cfg.n_layers // cfg.attn_every
    model, params = _init_family(
        torch, "hybrid", cfg, seed, card,
        note=f" cut to {cfg.n_layers} of {full.n_layers} layers ({nb} "
             f"superblock; the full depth is {full.param_count()} parameters "
             f"by the config, more than one card holds in bf16; "
             f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, "
             f"{cfg.n_experts} experts top-{cfg.top_k}, d_expert "
             f"{cfg.d_expert})")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, len(r.prompt))
               for r in serve_reqs[::2]]
    reqs, passes, launches, _ = _serve_family(torch, np, "hybrid", cfg,
                                              model, params, prompts,
                                              HYBRID_NEW, card)
    check(launches["flash_attention"] == len(reqs) * nb,
          f"hybrid: flash_attention launches {launches['flash_attention']} "
          f"!= {len(reqs)} prefills x {nb} attention layers")
    check(launches["ragged_decode"] == passes * 4 * nb,
          f"hybrid: ragged_decode launches {launches['ragged_decode']} != "
          f"{passes} decode passes x 4 tokens x {nb} attention layers")
    check(launches["ragged_prefill"] == 0, "hybrid: ragged_prefill launched")
    # every weight but the embedding table is read once a decode step:
    # the experts at no-drop capacity all take tokens
    step_bytes = sum(p.numel() * p.element_size()
                     for n, p in params.named_parameters()
                     if n != "tok.embed")
    print(f"[hybrid] a decode step reads {step_bytes} bytes of weights: "
          f"at least {1e3 * step_bytes / PEAKS['SXM'][0]:.3f} ms at "
          f"{PEAKS['SXM'][0]:.3g} B/s")

    prof = _decode_window(torch, model, params, reqs,
                          "hybrid: 3 decode chunks x 4 tokens, 8 slots "
                          "(graph)", card)
    if prof is not None:
        print(f"[hybrid] decode window (graph): device busy share "
              f"{prof['busy'] / prof['wall']:.3f}, {1e3 * prof['busy']:.3f} "
              f"ms device time a window of 12 token steps ({card})")
    # the split by layer kind: on the eager loop, since a profiler range
    # sees no kernel that a graph replays
    names = ("moe_apply", "expert_ffn", "ssm_layer_step")
    restore = [_ranged(moe, names[:2]), _ranged(mamba2, names[2:])]
    try:
        prof = _decode_window(torch, _eager(model), params, reqs,
                              "hybrid: 3 decode chunks x 4 tokens, 8 slots "
                              "(eager loop)", card, ranges=names)
    finally:
        for r in restore:
            r()
    if prof is not None:
        busy = 1e3 * prof["busy"]
        parts = {"attention kernel": prof.get("ragged_decode", 0.0),
                 "MoE routing and dispatch": prof.get("moe_apply", 0.0)
                 - prof.get("expert_ffn", 0.0),
                 "expert products": prof.get("expert_ffn", 0.0),
                 "SSM layers": prof.get("ssm_layer_step", 0.0)}
        parts["the rest"] = busy - sum(parts.values())
        print(f"[hybrid] decode window (eager loop): device busy share "
              f"{prof['busy'] / prof['wall']:.3f}, {busy:.3f} ms device "
              f"time a window of 12 token steps, {busy / 12:.3f} ms a step "
              f"({card})")
        print("[hybrid] decode window split: " + ", ".join(
            f"{k} {v:.3f} ms ({v / busy:.1%})" for k, v in parts.items()))
    _wire_check("hybrid", model, params, min(prompts, key=len), HYBRID_NEW,
                card)
    return launches


# ---------------------------------------------------------------------------
# 14. the vlm family
# ---------------------------------------------------------------------------

VLM_LAYERS = 10              # two superblocks: the stacked nb axis is checked
VLM_NEW = 16                 # new tokens a request, as the hybrid's
VLM_IMAGE_TOKENS = 1601      # llama-3.2-vision-90b's n_image_tokens
VLM_GATES = ((0.7, -0.4), (0.5, 0.3))   # (attn, mlp) gates per superblock


def _attention_split(cfg, prof):
    """The ragged_decode kernel's device time in a profiled decode window,
    split by the layer each call served: the calls come in layer order,
    ``n_layers`` a token step, each a split launch and a combine launch,
    and layer ``i`` of a step is a cross layer when ``cfg.is_cross_layer(i)``.
    Returns {"self-attention kernel": ms, "cross-attention kernel": ms},
    or None when the window's launches do not fit that order."""
    calls = prof.get("sequence", {}).get("ragged_decode", [])
    splits = [c for c in calls if "decode_split_" in c[2]]
    combines = [c for c in calls if "decode_combine" in c[2]]
    if (not splits or len(splits) != len(combines)
            or len(splits) % cfg.n_layers):
        return None
    out = {"self-attention kernel": 0.0, "cross-attention kernel": 0.0}
    for i, (a, b) in enumerate(zip(splits, combines)):
        kind = "cross" if cfg.is_cross_layer(i % cfg.n_layers) else "self"
        out[f"{kind}-attention kernel"] += (a[1] + b[1]) / 1e3
    return out


def phase_vlm(torch, seed, card, serve_reqs):
    """llama-3.2-vision-90b at full width, cut to two superblocks (10 of
    100 layers: 87.7 B parameters by the config do not fit one card's 80 GB
    in bf16), every cross layer's gates set nonzero, through
    ``ServeEngine``: 8 requests (the serve phase's prompt lengths, every
    other one), each with its own seeded image, 16 new tokens each; kernel
    launches exact (10 flash per prefill, 8 self and 2 cross; 10 ragged
    decode per token step; no ragged prefill); one prompt with two images
    gives two streams; a session (its image and whole cross cache with it)
    moved through the wire mid-decode continues the unmigrated stream; a
    profiled decode window split into the self-attention kernel, the
    cross-attention kernel and the rest."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config

    full = get_config("llama-3.2-vision-90b")
    cfg = dataclasses.replace(full, n_layers=VLM_LAYERS)
    check(cfg.n_image_tokens == VLM_IMAGE_TOKENS, "image token count")
    nb = cfg.n_layers // cfg.cross_attn_every
    model, params = _init_family(
        torch, "vlm", cfg, seed, card,
        note=f" cut to {cfg.n_layers} of {full.n_layers} layers ({nb} "
             f"superblocks of {cfg.cross_attn_every - 1} self layers and 1 "
             f"cross layer; the full depth is {full.param_count()} "
             f"parameters by the config, more than one card holds in bf16; "
             f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, d_ff "
             f"{cfg.d_ff}, {cfg.n_image_tokens} image tokens)")
    with torch.no_grad():
        for sb, (g_attn, g_mlp) in zip(params.blocks, VLM_GATES):
            sb.cross.gate_attn.fill_(g_attn)
            sb.cross.gate_mlp.fill_(g_mlp)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, len(r.prompt))
               for r in serve_reqs[::2]]
    images = [rng.standard_normal((cfg.n_image_tokens, cfg.d_model),
                                  dtype=np.float32) for _ in prompts]
    reqs, passes, launches, _ = _serve_family(
        torch, np, "vlm", cfg, model, params, prompts, VLM_NEW, card,
        extras=[{"image_embeds": img} for img in images])
    check(launches["flash_attention"] == len(reqs) * cfg.n_layers,
          f"vlm: flash_attention launches {launches['flash_attention']} != "
          f"{len(reqs)} prefills x {cfg.n_layers} layers ({nb} cross)")
    check(launches["ragged_decode"] == passes * 4 * cfg.n_layers,
          f"vlm: ragged_decode launches {launches['ragged_decode']} != "
          f"{passes} decode passes x 4 tokens x {cfg.n_layers} layers")
    check(launches["ragged_prefill"] == 0, "vlm: ragged_prefill launched")
    # every weight but the embedding table is read once a decode step
    step_bytes = sum(p.numel() * p.element_size()
                     for n, p in params.named_parameters()
                     if n != "tok.embed")
    print(f"[vlm] a decode step reads {step_bytes} bytes of weights: at "
          f"least {1e3 * step_bytes / PEAKS['SXM'][0]:.3f} ms at "
          f"{PEAKS['SXM'][0]:.3g} B/s")

    prof = _decode_window(torch, model, params, reqs,
                          "vlm: 3 decode chunks x 4 tokens, 8 slots (graph)",
                          card)
    parts = _attention_split(cfg, prof) if prof is not None else None
    if parts is None:
        print("[vlm] decode window split: not measured (the profile holds "
              "no ragged_decode launches in layer order)")
    else:
        busy = 1e3 * prof["busy"]
        parts["the rest"] = busy - sum(parts.values())
        print(f"[vlm] decode window: device busy share "
              f"{prof['busy'] / prof['wall']:.3f}, {busy:.3f} ms device "
              f"time a window of 12 token steps, {busy / 12:.3f} ms a step "
              f"({card})")
        print("[vlm] decode window split: " + ", ".join(
            f"{k} {v:.3f} ms ({v / busy:.1%})" for k, v in parts.items()))

    # the image reaches the output: one prompt, two images, two streams;
    # and the first image's stream survives a wire migration
    prompt = min(prompts, key=len)
    ref = _wire_check("vlm", model, params, prompt, VLM_NEW, card,
                      extras={"image_embeds": images[0]})
    other, _, _ = _wire_solo(model, params, prompt, VLM_NEW, None,
                             extras={"image_embeds": images[1]})
    check(other != ref, "vlm: two images gave the same token stream")
    first = next(i for i, (a, b) in enumerate(zip(ref, other)) if a != b)
    print(f"[vlm] one {len(prompt)}-token prompt, two images: the streams "
          f"differ from token {first} on")
    return launches


# ---------------------------------------------------------------------------
# 15. the audio family
# ---------------------------------------------------------------------------

AUDIO_CLIPS, AUDIO_FRAMES = 8, 1000     # 20 s of audio each at 50 Hz
AUDIO_TIMED = 3
# the kernel path's logits against the plain path's on one clip, bf16:
# 48 layers of about 8 roundings of 2^-9 each, adding like a random walk,
# reach sqrt(384) * 2^-9 = 3.8 % of the logits' scale; the limit is twice
# that, of the largest logit magnitude
AUDIO_REL_LIMIT = 2 * math.sqrt(48 * 8) * 2.0 ** -9


def _forward_flops(cfg, B: int, S: int) -> int:
    """Operations of one encoder forward from its shapes: the projections,
    the non-causal attention (Q K^T and P V) and the MLP of every layer,
    and the head."""
    D, hd, F = cfg.d_model, cfg.hd, cfg.d_ff
    proj = 2 * D * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    attn = 4 * cfg.n_heads * hd * S
    mlp = 2 * 2 * D * F
    return B * S * (cfg.n_layers * (proj + attn + mlp) + 2 * D * cfg.vocab)


def phase_audio(torch, seed, card):
    """hubert-xlarge at full width and depth (48 layers, 16/16 heads of
    80): ``Model.forward`` over 8 seeded clips of 1000 frames, once to
    warm and then timed; logits of shape (8, 1000, 504), finite, 48 flash
    launches a forward, clip 0's logits within a stated limit of the plain
    path's; then one ``Model.prefill``.  Reports frames/s, ms a forward,
    the device-busy share, the share of the bf16 peak and peak memory."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import layers

    cfg = get_config("hubert-xlarge")
    model, params = _init_family(
        torch, "audio", cfg, seed, card,
        note=f" ({cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, d_ff "
             f"{cfg.d_ff}, LayerNorm, gelu, non-causal)")
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.standard_normal(
        (AUDIO_CLIPS, AUDIO_FRAMES, cfg.d_model), dtype=np.float32)).to(
        params.device)
    batch = {"frames": frames}
    shape = (AUDIO_CLIPS, AUDIO_FRAMES, cfg.vocab)
    model.forward(params, batch)                      # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0                                   # this path's run only
    logits = model.forward(params, batch)
    torch.cuda.synchronize()
    launches = fa.launches
    peak = torch.cuda.max_memory_allocated()
    check(tuple(logits.shape) == shape, f"audio: logits {tuple(logits.shape)}"
                                        f" != {shape}")
    check(bool(torch.isfinite(logits).all()), "audio: non-finite logits")
    check(launches == cfg.n_layers, f"audio: flash_attention launches "
                                    f"{launches} != {cfg.n_layers} layers")
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(AUDIO_TIMED):
        model.forward(params, batch)
    e1.record()
    e1.synchronize()
    ms = e0.elapsed_time(e1) / AUDIO_TIMED
    flops = _forward_flops(cfg, AUDIO_CLIPS, AUDIO_FRAMES)
    print(f"[audio] forward of {AUDIO_CLIPS} clips x {AUDIO_FRAMES} frames: "
          f"{ms:.3f} ms (mean of {AUDIO_TIMED}), "
          f"{AUDIO_CLIPS * AUDIO_FRAMES / ms * 1e3:.1f} frames/s; "
          f"{flops} operations from the shapes, {flops / ms / 1e9:.1f} "
          f"TFLOP/s, {flops / ms / 1e-3 / PEAKS['SXM'][1]:.1%} of the bf16 "
          f"peak; peak device memory {peak} bytes ({card})")
    prof = _profile_window(torch, lambda: model.forward(params, batch),
                           f"audio: forward of {AUDIO_CLIPS} x "
                           f"{AUDIO_FRAMES} frames", card)
    if prof is not None:
        print(f"[audio] forward: device busy share "
              f"{prof['busy'] / prof['wall']:.3f} ({card})")

    # the same clip through the plain attention: the kernel path agrees
    one = {"frames": frames[:1]}
    kernel, layers.flash_attention = layers.flash_attention, attention_ref
    try:
        plain = model.forward(params, one)
    finally:
        layers.flash_attention = kernel
    err = (logits[:1].float() - plain.float()).abs().max().item()
    scale = plain.float().abs().max().item()
    check(err <= AUDIO_REL_LIMIT * scale,
          f"audio: clip 0's logits differ from the plain path's by {err} > "
          f"{AUDIO_REL_LIMIT:.4f} x {scale}")
    print(f"[audio] clip 0 against the plain attention path: max abs diff "
          f"{err:.4g}, {err / scale:.4f} of the largest logit {scale:.4g} "
          f"(limit {AUDIO_REL_LIMIT:.4f})")

    n0 = fa.launches
    last, cache = model.prefill(params, batch)
    torch.cuda.synchronize()
    check(fa.launches - n0 == cfg.n_layers, "audio: prefill launches")
    check(tuple(last.shape) == (AUDIO_CLIPS, 1, cfg.vocab)
          and bool(torch.isfinite(last).all()), "audio: prefill logits")
    kv = (cfg.n_layers, AUDIO_CLIPS, AUDIO_FRAMES, cfg.n_kv_heads, cfg.hd)
    check(all(tuple(c.shape) == kv for c in cache.values()),
          "audio: prefill cache shapes")
    print(f"[audio] prefill: last-frame logits {tuple(last.shape)}, caches "
          f"{kv} x 2, {fa.launches - n0} flash launches")
    return {"flash_attention": launches}


# ---------------------------------------------------------------------------
# 16. checkpoints
# ---------------------------------------------------------------------------

CKPT_LAYERS = 2


def phase_checkpoint(torch, seed, card):
    """granite-moe-1b-a400m's full-width parameters, cut to 2 layers for
    time, written through ``params_to_numpy`` and ``save_checkpoint`` and
    read back through ``load_checkpoint`` and ``params_from_numpy`` onto
    the card: one prompt's logits bit-identical to the written model's."""
    import dataclasses
    import tempfile

    import numpy as np
    from repro_torch.checkpoint import (default_codec, load_checkpoint,
                                        save_checkpoint)
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models.convert import params_from_numpy, params_to_numpy

    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                              n_layers=CKPT_LAYERS)
    model = get_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = model.init(gen)
    prompt = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, 257), device="cuda").long()[None]
    want, _ = model.prefill(params, {"tokens": prompt})
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        tree = params_to_numpy(cfg, params)
        path = save_checkpoint(d, 1, tree)
        t_save = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in pathlib.Path(path).iterdir())
        raw = sum(a.nbytes for a in _leaves(tree))
        t0 = time.perf_counter()
        loaded, _ = load_checkpoint(d, 1, tree, device="cuda")
        back = params_from_numpy(cfg, loaded, "cuda")
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    got, _ = model.prefill(back, {"tokens": prompt})
    check(torch.equal(got, want), "checkpoint round trip: logits differ "
          f"by {(got.float() - want.float()).abs().max().item()}")
    print(f"[checkpoint] {cfg.name} at full width cut to {CKPT_LAYERS} of "
          f"24 layers: {raw} bytes of {cfg.param_dtype} leaves -> {nbytes} "
          f"bytes on disk ({default_codec()}); to numpy and save "
          f"{t_save:.2f} s, load and onto the card {t_load:.2f} s; logits of "
          f"a {prompt.shape[1]}-token prompt bit-identical ({card})")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# 17. the paper's threaded runtime
# ---------------------------------------------------------------------------

RUNTIME_TASKS = 150          # per kernel class: the mixed DAG of the paper
RUNTIME_WORKERS = 4
RUNTIME_TIMEOUT_S = 120.0
MATMUL_RTOL = 1e-5           # the reference's threaded-runtime test


def _runtime_run(torch, ThreadedRuntime, pool, dag, policy, seed, ops):
    """One run of the DAG under ``policy`` with this run's outputs reset
    (sentinels -1 where the inputs are never negative) and the launch
    counts set to 0 just before it; returns placements, wall seconds and
    the counts read just after."""
    for t in pool.mat_out:
        t.zero_()
    for t in (*pool.sort_dst, *pool.copy_dst):
        t.fill_(-1)
    mm, sc, so = ops
    mm.launches = sc.copy_launches = so.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    placements = ThreadedRuntime(policy, RUNTIME_WORKERS, seed=seed).run(
        dag, pool.bodies_for_dag(dag), timeout=RUNTIME_TIMEOUT_S)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return placements, wall, {"matmul": mm.launches,
                              "stream_copy": sc.copy_launches,
                              "bitonic_sort": so.launches}


def _check_runtime(torch, pool, dag, layout, placements, launches, label):
    """Every task placed on a valid place; launches = the sum of widths
    over each class's tasks; every written slot right: matmul within the
    reference's 1e-5 relative (1e-5 * sqrt(K) absolute, the reference
    tests' form), copy exact, sort exact per chunk of the slot's last
    writer (its highest node id: a slot's tasks form a dependency
    chain)."""
    from repro_torch.core import KernelType, Place
    from repro_torch.kernels.bitonic_sort import sort_rows_ref
    from repro_torch.kernels.matmul import matmul_ref
    check(len(placements) == len(dag.nodes),
          f"{label}: {len(placements)} of {len(dag.nodes)} tasks placed")
    check(all(layout.is_valid(Place(l, w)) for l, w in placements.values()),
          f"{label}: an invalid place")
    kinds = {"matmul": KernelType.MATMUL, "bitonic_sort": KernelType.SORT,
             "stream_copy": KernelType.COPY}
    for name, k in kinds.items():
        want = sum(placements[n.nid][1] for n in dag.nodes if n.kernel == k)
        check(launches[name] == want, f"{label}: {name} launched "
              f"{launches[name]} times, the {k.name} tasks' widths sum to "
              f"{want}")
    last = {}                          # (kernel, slot) -> its last writer
    for n in dag.nodes:
        last[(n.kernel, n.data_slot)] = max(n.nid, last.get(
            (n.kernel, n.data_slot), -1))
    mm_err = 0.0
    for (k, slot), nid in sorted(last.items()):
        if k == KernelType.MATMUL:
            a = pool.mats[slot]
            err, ok = _within(torch, pool.mat_out[slot], matmul_ref(a, a),
                              MATMUL_RTOL, MATMUL_RTOL * math.sqrt(
                                  a.shape[1]))
            mm_err = max(mm_err, err)
            check(ok, f"{label}: mat_out[{slot}] off by {err}")
        elif k == KernelType.COPY:
            check(torch.equal(pool.copy_dst[slot], pool.copy_src[slot]),
                  f"{label}: copy_dst[{slot}] differs from its source")
        else:
            src, dst = pool.sort_src[slot], pool.sort_dst[slot]
            w, m = placements[nid][1], len(src)
            for c in range(w):
                lo, hi = c * m // w, (c + 1) * m // w
                check(torch.equal(dst[lo:hi],
                                  sort_rows_ref(src[lo:hi][None])[0]),
                      f"{label}: sort_dst[{slot}] chunk {c} of {w} is not "
                      f"its source chunk sorted")
    return mm_err


def phase_runtime(torch, seed, card):
    """The paper's experiment on the card: the mixed random DAG (150 tasks
    of each class, average width 4, edge rate 2) through the threaded
    XiTAO runtime on 4 workers, under the homogeneous work-stealing
    scheduler and under the PTT's performance-based one, with every TAO
    body running its kernel class at the paper's sizes on the device."""
    import numpy as np
    from repro_torch.core import (HomogeneousScheduler, KernelType,
                                  PerformanceBasedScheduler, RandomDAGConfig,
                                  generate_random_dag, homogeneous_layout)
    from repro_torch.core.real_kernels import KernelPool
    from repro_torch.core.runtime import ThreadedRuntime
    from repro_torch.kernels.bitonic_sort import ops as so
    from repro_torch.kernels.matmul import ops as mm
    from repro_torch.kernels.stream_copy import ops as sc
    ops = (mm, sc, so)

    kinds = (KernelType.MATMUL, KernelType.SORT, KernelType.COPY)
    dag = generate_random_dag(RandomDAGConfig(
        tasks_per_kernel={k: RUNTIME_TASKS for k in kinds}, avg_width=4,
        edge_rate=2.0, seed=seed))
    n_slots = max(n.data_slot for n in dag.nodes) + 1
    t0 = time.perf_counter()
    pool = KernelPool(n_slots, seed=seed)          # the paper's sizes
    torch.cuda.synchronize()
    print(f"[runtime] DAG seed {seed}: {len(dag.nodes)} tasks, critical "
          f"path {dag.critical_path_length}, parallelism "
          f"{dag.parallelism:.3f}, {n_slots} data slots; KernelPool on the "
          f"card ({torch.cuda.memory_allocated()} bytes allocated) in "
          f"{time.perf_counter() - t0:.2f} s")
    layout = homogeneous_layout(RUNTIME_WORKERS)
    # warm-up (not timed): the worker streams, the kernels' first launches
    _runtime_run(torch, ThreadedRuntime, pool, dag,
                 HomogeneousScheduler(layout), seed, ops)

    main_launches, mm_err = None, 0.0
    for label, policy in (
            ("homogeneous", HomogeneousScheduler(layout)),
            ("performance", PerformanceBasedScheduler(layout, len(
                KernelType)))):
        torch.cuda.reset_peak_memory_stats()
        placements, wall, launches = _runtime_run(
            torch, ThreadedRuntime, pool, dag, policy, seed, ops)
        peak = torch.cuda.max_memory_allocated()
        mm_err = max(mm_err, _check_runtime(torch, pool, dag, layout,
                                            placements, launches, label))
        hist = {}
        for _, w in placements.values():
            hist[w] = hist.get(w, 0) + 1
        print(f"[runtime] {label}: {len(dag.nodes) / wall:.1f} tasks/s, "
              f"makespan {1e3 * wall:.3f} ms ({card})")
        print(f"[runtime] {label}: placements by width "
              f"{dict(sorted(hist.items()))}; launches {launches}; peak "
              f"device memory {peak} bytes")
        if label == "performance":
            check(policy.ptt.updates == len(dag.nodes),
                  f"ptt.updates {policy.ptt.updates} != {len(dag.nodes)}")
            print(f"[runtime] ptt.updates {policy.ptt.updates}; trained PTT "
                  f"in ms (rows = leader cores, columns = widths "
                  f"{layout.widths()}), {card}:")
            for k in kinds:
                table = np.array2string(1e3 * policy.ptt.table(int(k)),
                                        precision=4, suppress_small=True)
                print(f"[runtime]   {k.name}: " + table.replace(
                    "\n", "\n[runtime]   " + " " * (len(k.name) + 2)))
            main_launches = launches
    print(f"[runtime] outputs right: every written mat_out within "
          f"{MATMUL_RTOL} relative (max abs err {mm_err:.3g}), every "
          f"copy_dst exact, every sort_dst sorted per chunk of its last "
          f"writer")
    _profile_window(torch, lambda: ThreadedRuntime(
        PerformanceBasedScheduler(layout, len(KernelType)), RUNTIME_WORKERS,
        seed=seed).run(dag, pool.bodies_for_dag(dag),
                       timeout=RUNTIME_TIMEOUT_S),
        f"the {len(dag.nodes)}-task DAG under the performance-based "
        f"scheduler (device time summed over the worker streams)", card)
    return main_launches


# ---------------------------------------------------------------------------
# 18. the paper's simulator and the VGG-16 forward on the card
# ---------------------------------------------------------------------------

VGG_RTOL = 1e-5              # activations against the matmul_ref forward
VGG_REP_ATOL = 1e-4          # the reference example's representative check


def _quiet(fn, *args):
    """``fn(*args)`` with its standard output captured: (text, result)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return buf.getvalue(), out


def phase_paper(torch, card):
    """The paper's three results through ``repro_torch.sim`` (virtual time
    under the reference's platform models, not times of this card), each
    run twice and the two runs equal; then the VGG-16 reduced forward on
    the card: every GEMM TAO body a ``matmul`` launch into its block."""
    from repro_torch.examples import interference_adaptation, quickstart
    from repro_torch.examples import vgg16_classify as V
    from repro_torch.kernels.matmul import matmul_ref
    from repro_torch.kernels.matmul import ops as mm

    for name, fn in (("quickstart", quickstart.main),
                     ("interference", interference_adaptation.main),
                     ("vgg16 scaling", V.scaling_study)):
        t0 = time.perf_counter()
        text, out = _quiet(fn)
        again, _ = _quiet(fn)
        host = time.perf_counter() - t0
        check(text == again, f"{name}: two simulations differ")
        for line in text.strip("\n").splitlines():
            if line.strip():
                print(f"[paper] (simulated) {line}")
        print(f"[paper] {name}: two runs identical; {host:.2f} s of host "
              f"time for both")
        if name == "quickstart":
            mixed = out["mixed random DAG (par~4)"]
            check(mixed > 1.0, f"mixed-DAG speedup {mixed} <= 1")
            print(f"[paper] (simulated) speedups: " + ", ".join(
                f"{k} {v:.4f}x" for k, v in out.items()))
        elif name == "interference":
            fracs = {k: float(v) for k, v in out["critical_on_0_1"].items()}
            print(f"[paper] (simulated) share of critical tasks led from "
                  f"cores 0-1: {fracs}; makespan {out['makespan']} "
                  f"against {out['clean_makespan']} without the window")
        else:
            spans = [m for _, m, _ in out]
            check(all(a > b for a, b in zip(spans, spans[1:])),
                  f"VGG makespans do not fall with the cores: {spans}")
            print("[paper] (simulated) efficiencies: " + ", ".join(
                f"{n}: {e:.4f}" for n, _, e in out))

    # the forward on the card; the first run warms the worker streams
    _quiet(V.real_forward, "cuda")
    torch.cuda.synchronize()
    mm.launches = 0
    t0 = time.perf_counter()
    text, out = _quiet(V.real_forward, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = mm.launches
    for line in text.strip("\n").splitlines():
        print(f"[paper] {line}")
    widths = sum(w for _, w in out["placements"].values())
    n_taos = V.TAOS_PER_LAYER * len(V.LAYERS)
    check(len(out["placements"]) == n_taos,
          f"{len(out['placements'])} of {n_taos} TAOs placed")
    # one launch a chunk of each TAO, and the representative layer's one
    check(launches == widths + 1,
          f"matmul launched {launches} times; the TAOs' widths sum to "
          f"{widths}, plus the representative layer's one")
    check(out["ptt"].updates == n_taos,
          f"ptt.updates {out['ptt'].updates} != {n_taos}")
    plain = V.plain_forward(out["acts"][0], out["weights"])
    worst = 0.0
    for i, (got, want) in enumerate(zip(out["acts"][1:], plain[1:])):
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        worst = max(worst, err / scale)
        check(err <= VGG_RTOL * scale, f"VGG layer {i}: max abs err {err} "
              f"> {VGG_RTOL} x {scale}")
    x, y, got = out["representative"]
    rep_err = (got - matmul_ref(x, y)).abs().max().item()
    check(out["representative_ok"] and rep_err <= VGG_REP_ATOL,
          f"representative layer off by {rep_err}")
    print(f"[paper] VGG forward on the card: {n_taos} GEMM TAOs at widths "
          f"summing to {widths}, {launches} matmul launches (with the "
          f"representative layer's), activations within "
          f"{worst:.3g} relative of the matmul_ref forward (limit "
          f"{VGG_RTOL}), representative layer (128 x 16) x (16 x 128) max "
          f"abs err {rep_err:.3g} (limit {VGG_REP_ATOL}); wall "
          f"{1e3 * wall:.3f} ms ({card})")
    print(f"[paper] trained PTT (GEMM row, ms; rows = workers, columns = "
          f"widths): {(1e3 * out['ptt'].table(3)).round(4).tolist()}")
    # device time: CUDA events around a body's launches on its worker's
    # stream also hold the host's hand-offs of the interpreter lock between
    # the runtime's threads (up to its 5 ms switch interval), so each chunk
    # the run recorded is replayed alone, as ``time_ms`` times a kernel
    chunks = out["chunks"]
    check(len(chunks) == launches - 1, f"{len(chunks)} body chunks "
          f"recorded for {launches - 1} matmul launches of the TAOs")
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    mm_ms = relu_ms = 0.0
    for a, w, blk in chunks:
        mm_ms += time_ms(torch, lambda: mm.matmul(a, w, out=blk), flush)
        relu_ms += time_ms(torch, lambda: blk.clamp_(min=0.0), flush)
    del flush
    check(all(math.isfinite(t) and t > 0 for t in (mm_ms, relu_ms)),
          f"VGG device times {mm_ms}, {relu_ms}")
    print(f"[paper] VGG forward device time, the run's {len(chunks)} body "
          f"chunks each replayed alone (CUDA events, L2 flushed, mean of "
          f"{N_TIMED}): matmul {mm_ms:.5f} ms, ReLU {relu_ms:.5f} ms, "
          f"{mm_ms + relu_ms:.5f} ms in all against the run's wall "
          f"{1e3 * wall:.3f} ms ({card})")
    return {"matmul": launches}


# ---------------------------------------------------------------------------
# 19. the serving and training examples
# ---------------------------------------------------------------------------

EXAMPLE_TRAIN_STEPS = 20     # 10, then a resume to 20


def phase_examples(torch, card):
    """``repro_torch.examples``' serving and training entry points, each
    through its ``main`` on the card (reduced configs, heads widened to 64
    for the attention kernels); returns their kernel launches."""
    import importlib
    import tempfile
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ragged_decode import ops as rd
    from repro_torch.kernels.ragged_prefill import ops as rp

    totals = {"flash_attention": 0, "ragged_decode": 0, "ragged_prefill": 0,
              "flash_attention_bwd": 0}
    with tempfile.TemporaryDirectory() as out_dir:
        for name, argv in (
                ("serve_lm", []), ("fleet_serve", []), ("region_serve", []),
                ("slo_smoke", ["--out-dir", out_dir]),
                ("train_lm", ["--steps", str(EXAMPLE_TRAIN_STEPS)])):
            mod = importlib.import_module(f"repro_torch.examples.{name}")
            fa.launches = fa.bwd_launches = rd.launches = rp.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            text, out = _quiet(mod.main, argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {"flash_attention": fa.launches,
                   "ragged_decode": rd.launches,
                   "ragged_prefill": rp.launches,
                   "flash_attention_bwd": fa.bwd_launches}
            for k, n in got.items():
                totals[k] += n
            tail = text.strip("\n").splitlines()[-3:]
            print(f"[examples] {name}: wall {wall:.3f} s ({card}); "
                  f"launches {got}; last lines: {tail}")
            if name == "train_lm":
                losses = out["first"]["losses"] + out["resumed"]["losses"]
                check(len(out["first"]["losses"]) == EXAMPLE_TRAIN_STEPS // 2
                      and len(losses) == EXAMPLE_TRAIN_STEPS,
                      f"train_lm ran {len(losses)} steps")
                check(all(math.isfinite(x) for x in losses),
                      f"a non-finite loss: {losses}")
                check(got["flash_attention"] > 0
                      and got["flash_attention_bwd"] > 0,
                      f"train_lm never reached the flash kernels: {got}")
                print(f"[examples] train_lm losses {losses}")
                continue
            check(got["flash_attention"] > 0 and got["ragged_decode"] > 0,
                  f"{name} never reached the attention kernels: {got}")
            if name == "slo_smoke":
                st = out["gateway"].stats()
                check(st["requests_served"] == 4, "slo_smoke served "
                      f"{st['requests_served']} of 4")
                continue
            reqs = out["requests"]
            reqs = list(reqs.values() if isinstance(reqs, dict) else reqs)
            check(all(r.done and r.out_tokens
                      and all(0 <= t < out["vocab"] for t in r.out_tokens)
                      for r in reqs),
                  f"{name}: a request unfinished or out of vocabulary")
    return totals


# ---------------------------------------------------------------------------
# 20. the analysis gate's audit on the card
# ---------------------------------------------------------------------------

def phase_audit(torch, card, model, params):
    """``Model.decode_fused`` and ``Model.prefill_chunk`` of the serve
    phase's full-width model under ``torch.cuda.set_sync_debug_mode
    ("error")`` (the decode's replay of its cell; the call that builds
    the cell, whose capture synchronizes, under the recorder alone), with
    every cache tensor's ``data_ptr`` checked; the retrace budget
    (:func:`_retrace_on_card`); then ``python -m repro_torch.analysis``
    (every layer) on the card."""
    import dataclasses
    import os
    from repro_torch.analysis import audit
    t0 = time.perf_counter()
    findings = (audit.audit_decode_fused(model, params, batch=8, seq=2048,
                                         chunk=4)
                + audit.audit_prefill_chunk(model, params, batch=1,
                                            seq=2048, chunk_t=256))
    host = time.perf_counter() - t0
    check(not findings, "audit findings:\n" + "\n".join(
        f.render() for f in findings))
    n_leaves = len(model.cache_spec(1, 1))
    print(f"[audit] {model.cfg.name}: decode_fused (B 8, k 4, Smax 2048: "
          f"the call building its graph, then a replay under "
          f"set_sync_debug_mode('error')) and prefill_chunk (T 256, under "
          f"it): no host sync, no float64 op, all {n_leaves} cache leaves "
          f"kept their data_ptr; {host:.3f} s of host time ({card})")
    # the gate itself on the card: a decode that reads a token on the host
    fused = model.decode_fused

    def reads_host(params, tok, pos, cache, k):
        out = fused(params, tok, pos, cache, k)
        out[0][0, 0].item()
        return out
    bad = audit.audit_decode_fused(
        dataclasses.replace(model, decode_fused=reads_host), params,
        batch=8, seq=2048, chunk=4)
    check([f.rule for f in bad] == ["host-sync"],
          f"the audit missed a .item() inside decode_fused: {bad}")
    print(f"[audit] a decode_fused with one .item() is caught: "
          f"{bad[0].message[:120]}")
    _retrace_on_card(torch, card, model, params, audit)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--root", str(ROOT)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    check(r.returncode == 0, f"python -m repro_torch.analysis exited "
          f"{r.returncode}:\n{r.stdout}\n{r.stderr}")
    print(f"[audit] python -m repro_torch.analysis (lint, contracts, and "
          f"the audit of {len(audit.FAMILY_ARCHS)} families on the card): "
          f"exit 0, {r.stdout.strip().splitlines()[-1]} "
          f"({time.perf_counter() - t0:.2f} s)")


def _retrace_on_card(torch, card, model, params, audit):
    """The retrace budget on the card: ``audit_retrace`` over batches (2,
    3) x chunks (1, 4) on each family's widened reduced config, and over
    B 8, k 4 on the serve model, each building exactly one decode cell
    (one CUDA graph) per (batch, chunk) cell; a decode whose key changes
    every call flagged ``retrace-budget``."""
    import dataclasses
    from repro_torch.configs import get_config, widen_heads
    from repro_torch.models import get_model
    small = None
    for arch in audit.FAMILY_ARCHS:
        m = get_model(widen_heads(get_config(arch, reduced=True)))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        p = m.init(gen)
        found = audit.audit_retrace(m, p)
        cells = len(audit.BATCH_SHAPES) * len(audit.DECODE_CHUNKS)
        chunks = len(audit.BATCH_SHAPES) if m.prefill_chunk else 0
        check(not found and _cells_built(m) == cells
              and _cells_built(m, "prefill_chunk") == chunks,
              f"retrace {arch}: {_cells_built(m)} decode cells for {cells}, "
              f"{_cells_built(m, 'prefill_chunk')} chunk cells for {chunks}, "
              f"findings {[f.render() for f in found]}")
        print(f"[audit] retrace {m.cfg.name} (reduced, heads widened): "
              f"batches {audit.BATCH_SHAPES} x chunks {audit.DECODE_CHUNKS}, "
              f"two calls a cell: {cells} graphs for {cells} cells, capture "
              f"ms {[round(c, 3) for c in _capture_ms(m)]}"
              + (f"; prefill_chunk over batches {audit.BATCH_SHAPES}: "
                 f"{chunks} graphs, capture ms "
                 f"{[round(c, 3) for c in _capture_ms(m, 'prefill_chunk')]}"
                 if chunks else "") + f" ({card})")
        small = small or (m, p)
    built0 = (_cells_built(model), _cells_built(model, "prefill_chunk"))
    found = audit.audit_retrace(model, params, batch_shapes=(8,),
                                chunks=(4,), seq=2048, chunk_t=CHUNK)
    built = _capture_ms(model)[built0[0]:]
    chunk = _capture_ms(model, "prefill_chunk")[built0[1]:]
    check(not found and len(built) == len(chunk) == 1,
          f"retrace {model.cfg.name} B 8, k 4 and T {CHUNK}: {len(built)} "
          f"decode and {len(chunk)} chunk cells, findings {found}")
    print(f"[audit] retrace {model.cfg.name} (B 8, k 4, Smax 2048; chunks "
          f"of {CHUNK}), two calls: 1 graph for 1 cell each, capture "
          f"{built[0]:.3f} ms (decode), {chunk[0]:.3f} ms (chunk) ({card})")
    # the control: a decode that hands the cell a new cache every call
    m, p = small
    fused = m.decode_fused

    def unstable(params, tok, pos, cache, k):
        copy = {n: t.clone() for n, t in cache.items()}
        toks, nxt, pos, copy = fused(params, tok, pos, copy, k)
        for n, t in cache.items():
            t.copy_(copy[n])
        return toks, nxt, pos, cache
    unstable.cells = fused.cells
    bad = audit.audit_retrace(dataclasses.replace(m, decode_fused=unstable),
                              p)
    check([f.rule for f in bad] == ["retrace-budget"],
          f"the audit missed a decode that builds a cell every call: {bad}")
    print(f"[audit] a decode that builds a cell every call is caught: "
          f"{bad[0].message[:110]}")


# ---------------------------------------------------------------------------
# 21. mesh: sharding rules, expert parallelism and the collectives on a
#     one-rank NCCL mesh
# ---------------------------------------------------------------------------

MESH_PROMPTS = 4             # of the serve phase's prompts, 64 new each
MOE_PREFILL = (8, 1024)      # granite's prefill through moe_ep: 8,192 tokens
DEMO_FLOATS = 1 << 22        # compressed_allreduce_demo over 16.8 MB of f32


def _events_ms(torch, fn):
    """(fn's result, its device time in ms between two CUDA events)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _decode_lse(torch, rd, card):
    """``ragged_decode``'s log-sum-exp output on the card: against the
    plain version (B=8, Smax 2048, qwen2's 14/2 heads, bf16, positions
    mixed), and the merge of two half-cache calls by it against one
    whole-cache call; a slot with no row in a half gives 0 and -inf."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    B, Smax, Hq, Hkv, hd, half = 8, 2048, 14, 2, 64, 1024
    bf = torch.bfloat16
    q = torch.randn(B, Hq, hd, generator=gen, device="cuda").to(bf)
    k = torch.randn(B, Smax, Hkv, hd, generator=gen, device="cuda").to(bf)
    v = torch.randn(B, Smax, Hkv, hd, generator=gen, device="cuda").to(bf)
    pos = torch.tensor([0, 5, half - 1, half, 1500, Smax - 1, 700, 1300],
                       dtype=torch.int32, device="cuda")
    n0 = rd.launches
    out, lse = rd.ragged_decode_attention(q, k, v, pos, lse=True)
    ref, ref_lse = rd.ragged_decode_ref(q, k, v, pos, lse=True)
    whole = rd.ragged_decode_attention(q, k, v, pos)
    err = (out - ref).abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    check(torch.equal(out, whole), "ragged_decode: the output with the "
          "log-sum-exp differs from the output without it")
    check(err <= 2e-2 and err_lse <= 1e-3, f"ragged_decode lse: max abs "
          f"err {err} (limit 2e-2), lse {err_lse} (limit 1e-3)")
    parts = []
    for lo in (0, half):
        kc = k[:, lo:lo + half].contiguous()
        vc = v[:, lo:lo + half].contiguous()
        parts.append(rd.ragged_decode_attention(q, kc, vc, pos - lo,
                                                lse=True))
    (o1, l1), (o2, l2) = parts
    empty = pos < half                    # no row in the second half
    check(bool((o2[empty] == 0).all()) and bool(torch.isneginf(
        l2[empty]).all()) and bool(torch.isfinite(o2).all()),
          "ragged_decode: a slot with no live row must give 0 and -inf")
    m = torch.maximum(l1, l2)
    w1, w2 = torch.exp(l1 - m), torch.exp(l2 - m)
    merged = (w1[..., None] * o1 + w2[..., None] * o2) / (w1 + w2)[..., None]
    err_m = (merged - whole).abs().max().item()
    check(err_m <= 2e-2, f"ragged_decode: two halves merged by the "
          f"log-sum-exp differ from the whole cache by {err_m} (limit 2e-2)")
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    ms = time_ms(torch, lambda: rd.ragged_decode_attention(q, k, v, pos),
                 flush)
    ms_lse = time_ms(torch, lambda: rd.ragged_decode_attention(
        q, k, v, pos, lse=True), flush)
    rd.launches = n0                        # comparison launches
    print(f"[mesh] ragged_decode log-sum-exp, B={B} Smax={Smax} {Hq}/{Hkv} "
          f"hd {hd} bf16, pos {pos.tolist()}: out max abs err {err:.3g} "
          f"(limit 2e-2), lse {err_lse:.3g} (limit 1e-3), bitwise the "
          f"output without it; halves of {half} rows merged by it against "
          f"the whole cache: {err_m:.3g} (limit 2e-2), slots before the "
          f"second half 0 and -inf there; {ms:.4f} ms without, "
          f"{ms_lse:.4f} ms with the lse ({card})")


def _train_under_rules(torch, tm, opt, s0, batch, mesh, loss_free, card):
    """One qwen2-0.5b 8 x 1024 step under rules on the one-rank mesh,
    through the sharded dense layers: the loss within 1e-6 of the step
    without rules, launches exact, collectives counted.  Returns the cost
    counter's totals."""
    from repro_torch.distributed.cost import CostCounter
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.train import make_train_step
    from repro_torch.train.step import local_train_state
    L = tm.cfg.n_layers
    with use_rules(mesh):
        local = local_train_state(tm, s0)
        step = make_train_step(tm, opt)
        fa.launches = fa.bwd_launches = 0
        with CostCounter() as c:
            got, m = step(local, batch)
        torch.cuda.synchronize()
    n = (fa.launches, fa.bwd_launches)
    loss = float(m["loss"])
    rel = abs(loss - loss_free) / abs(loss_free)
    check(rel <= 1e-6, f"train under rules: loss {loss} against {loss_free} "
          f"without rules ({rel:.3g} relative, limit 1e-6)")
    check(n == (2 * L, L), f"train under rules: launches {n} != "
          f"{(2 * L, L)}")
    check(c.calls == {"flash_attention": 2 * L, "flash_attention_bwd": L},
          f"train under rules: counter calls {c.calls}")
    print(f"[mesh] {tm.cfg.name} {TRAIN_BATCH} x {TRAIN_SEQ} train step "
          f"under rules (FSDP x tensor x sequence parallel at group size "
          f"1): loss {loss:.6f} against {loss_free:.6f} without rules "
          f"({rel:.3g} relative, limit 1e-6); launches {n[0]} flash, "
          f"{n[1]} flash backward; collectives by kind "
          f"{c.totals.coll_counts} ({card})")
    del local, got
    _train_cell_under_rules(torch, tm, opt, s0, batch, mesh, card)
    return c.totals, c.peak_bytes


def _train_cell_under_rules(torch, tm, opt, state, batch, mesh, card, **kw):
    """Two qwen2-0.5b 8 x 1024 steps of the launcher's donated step under
    rules on the one-rank NCCL mesh, through its cell (the first its
    build: the eager run, then the capture with the step's collectives;
    the second a replay), against two steps of the eager ``TrainStep``
    under rules from the same state: both losses bitwise; launches exact,
    one cell built.  ``kw``:
    the step's options (microbatches, ``compress_dcn``)."""
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.train import DonatedStep, make_train_step
    from repro_torch.train.step import local_train_state
    from repro_torch.tree import tree_map
    L, mb = tm.cfg.n_layers, kw.get("microbatches", 1)
    n0 = (fa.launches, fa.bwd_launches)
    with use_rules(mesh):
        eager, want = make_train_step(tm, opt, **kw), []
        s = local_train_state(tm, state)
        for _ in range(2):
            s, m = eager(s, batch)
            want.append(float(m["loss"]))
        del s
        step = DonatedStep(make_train_step(tm, opt, **kw))
        s = tree_map(lambda t: t.clone(), local_train_state(tm, state))
        fa.launches = fa.bwd_launches = 0
        got = []
        for _ in range(2):
            s, m = step(s, batch)
            got.append(float(m["loss"]))
        torch.cuda.synchronize()
        n = (fa.launches, fa.bwd_launches)
    fa.launches, fa.bwd_launches = n0
    built, caps = step.cell.cells(), step.cell.capture_ms
    del s, step                     # the cell and its pool go
    torch.cuda.empty_cache()
    label = f"train cell under rules{' with ' + str(kw) if kw else ''}"
    check(got == want, f"{label}: losses {got} against the eager step's "
          f"{want}")
    check(n == (4 * L * mb, 2 * L * mb), f"{label}: launches {n} != "
          f"{(4 * L * mb, 2 * L * mb)}")
    check(built == 1 and caps[0] is not None,
          f"{label}: {built} cells built, not one captured")
    print(f"[mesh] {tm.cfg.name} {TRAIN_BATCH} x {TRAIN_SEQ} {label}: two "
          f"steps on the cell captured under the NCCL layout (capture "
          f"{caps[0]:.1f} ms): losses {got!r}, bitwise the eager step's; "
          f"launches {n[0]} flash, {n[1]} flash backward ({card})")


def _train_step_times(torch, tm, opt, batch, seed, card):
    """(device busy ms, wall ms) of one qwen2-0.5b step without rules on
    the launcher's cell, its first replay, under the profiler."""
    from repro_torch.train import (DonatedStep, make_train_step,
                                   train_state_init)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    state = train_state_init(tm, gen, opt, device="cuda")
    step = DonatedStep(make_train_step(tm, opt))
    state, _ = step(state, batch)
    prof = _profile_window(torch, lambda: step(state, batch),
                           "train step 8 x 1024 (roofline)", card, top=0)
    check(prof is not None, "the train step's profile saw no device time")
    return prof["busy"] * 1e3, prof["wall"] * 1e3


def _fake_cost(cfg, run):
    """The cost counter over ``run(model, params)`` traced on fake
    tensors: no device, no memory."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    import torch
    from repro_torch.distributed.cost import CostCounter
    from repro_torch.models import get_model
    model = get_model(cfg)
    with FakeTensorMode():
        params = model.init(torch.Generator(), "cpu")
        with torch.no_grad(), CostCounter() as c:
            run(model, params, "cpu")
    return c


COUNTED_DECODE = (8, 2048, 4)  # slots, Smax, tokens of the counted chunk


def _decode_inputs(torch, model, dev):
    """(token, pos, cache) of the counted decode chunk."""
    B, Smax, _ = COUNTED_DECODE
    cache = {n: torch.zeros(s, dtype=dt, device=dev)
             for n, (s, dt) in model.cache_spec(B, Smax).items()}
    tok = torch.zeros((B, 1), dtype=torch.long, device=dev)
    pos = torch.arange(1000, 1000 + 128 * B, 128, dtype=torch.int32,
                       device=dev)
    return tok, pos, cache


def _decode_and_prefill(torch, model) -> dict:
    """``run(model, params, device)`` for an 8-slot, 4-token decode chunk
    over a 2048-row cache (slots at positions 1000 to 1896) and for a
    1,024-token prefill."""
    k = COUNTED_DECODE[2]

    def decode(model, params, dev):
        return model.decode_fused(params, *_decode_inputs(torch, model, dev),
                                  k)

    def prefill(model, params, dev):
        toks = torch.arange(1024, device=dev)[None] % model.cfg.vocab
        return model.prefill(params, {"tokens": toks})
    return {"decode": decode, "prefill": prefill}


def _counter_against_card(torch, model, params, card):
    """The cost counter over one real decode chunk (8 slots, Smax 2048, 4
    tokens) and one 1,024-token prefill of qwen2-0.5b on the card: its
    kernel calls equal the launch counters, its FLOPs the fake trace's of
    the same steps.  Returns the decode chunk's totals and device ms."""
    from repro_torch.distributed.cost import CostCounter
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ragged_decode import ops as rd
    cfg, k = model.cfg, COUNTED_DECODE[2]
    runs = _decode_and_prefill(torch, model)
    out = {}
    for name, run, kernel, mod in (("decode", runs["decode"],
                                    "ragged_decode", rd),
                                   ("prefill", runs["prefill"],
                                    "flash_attention", fa)):
        mod.launches = 0
        with torch.no_grad(), CostCounter() as c:
            run(model, params, "cuda")
        torch.cuda.synchronize()
        fake = _fake_cost(cfg, run)
        check(c.calls == {kernel: mod.launches} == fake.calls,
              f"counter {name}: calls {c.calls} on the card, launches "
              f"{mod.launches}, fake trace {fake.calls}")
        rel = abs(c.totals.flops - fake.totals.flops) / fake.totals.flops
        check(rel <= 1e-9, f"counter {name}: {c.totals.flops} FLOPs on the "
              f"card against {fake.totals.flops} traced on fake tensors")
        out[name] = c.totals
        print(f"[mesh] cost counter over one {name} of {cfg.name} on the "
              f"card: {c.calls} kernel calls = the launch counter; "
              f"{c.totals.flops:.6g} FLOPs, equal to the fake trace's "
              f"{fake.totals.flops:.6g}; {c.totals.bytes:.6g} bytes ({card})")
    tok, pos, cache = _decode_inputs(torch, model, "cuda")
    with torch.no_grad():
        model.decode_fused(params, tok, pos, cache, k)          # warm
        prof = _profile_window(torch, lambda: model.decode_fused(
            params, tok, pos, cache, k), f"decode chunk of {k} tokens, 8 "
            f"slots (roofline)", card, top=0)
    check(prof is not None, "the decode chunk's profile saw no device time")
    return out["decode"], prof["busy"] * 1e3 / k, prof["wall"] * 1e3 / k, k


def _roofline_beside(tcfg, train, step_ms, scfg, decode, card):
    """The H100 roofline's terms for the 8 x 1024 train step and a dense
    decode step (8 slots, Smax 2048, one token) beside the measured
    times."""
    from repro_torch.distributed import roofline as R
    from repro_torch.distributed.cost import CostTotals
    (totals, peak), (dev_ms, wall_ms) = train, step_ms
    rf = R.build_from_walker(tcfg.name, "8x1024", "card", 1, totals, tcfg,
                             peak, R.model_flops_for(tcfg, "train",
                                                     TRAIN_BATCH, TRAIN_SEQ))
    print(f"[roofline] {tcfg.name} train step {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"(H100 SXM constants: {R.PEAK_FLOPS:.3g} bf16 FLOP/s, "
          f"{R.HBM_BW:.3g} B/s): counted {rf.flops_dev:.6g} FLOPs, "
          f"{rf.bytes_dev:.6g} bytes; t_compute {rf.t_compute * 1e3:.3f} "
          f"ms, t_memory {rf.t_memory * 1e3:.3f} ms, t_collective "
          f"{rf.t_collective * 1e3:.3f} ms; bound {rf.step_time * 1e3:.3f} "
          f"ms ({rf.dominant}); model_flops {rf.model_flops:.6g} = "
          f"{rf.model_flops / R.PEAK_FLOPS * 1e3:.3f} ms at peak; measured "
          f"{dev_ms:.3f} ms of device busy time, {wall_ms:.3f} ms wall "
          f"(profiler): bound / busy {rf.step_time * 1e3 / dev_ms:.4f} "
          f"({card})")
    dtot, d_ms, d_wall, k = decode
    per = CostTotals()
    per.add(dtot, 1.0 / k)
    rf = R.build_from_walker(scfg.name, "decode 8x2048", "card", 1, per,
                             scfg, 0, R.model_flops_for(scfg, "decode", 8,
                                                        2048))
    analytic = R.decode_bytes_for(scfg, 8, 2048, 1)
    print(f"[roofline] {scfg.name} decode step (8 slots, Smax 2048, one "
          f"token): counted {rf.flops_dev:.6g} FLOPs, {rf.bytes_dev:.6g} "
          f"bytes a token; t_compute {rf.t_compute * 1e3:.4f} ms, t_memory "
          f"{rf.t_memory * 1e3:.4f} ms, t_collective 0; bound "
          f"{rf.step_time * 1e3:.4f} ms ({rf.dominant}); analytic decode "
          f"bytes {analytic:.6g} = {analytic / R.HBM_BW * 1e3:.4f} ms; "
          f"measured {d_ms:.4f} ms of device busy time and {d_wall:.4f} ms "
          f"wall a token (profiler, a {k}-token chunk / {k}): bound / busy "
          f"{rf.step_time * 1e3 / d_ms:.4f} ({card})")


def _dryrun_cli(card):
    """``python -m repro_torch.launch.dryrun`` for one cell in a
    subprocess on this machine (no JAX): exit 0, its wall time."""
    import subprocess
    import tempfile
    with tempfile.TemporaryDirectory() as out:
        env = dict(os.environ, PYTHONPATH=str(SRC))
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                            "--arch", "qwen2-0.5b", "--shape", "train_4k",
                            "--mesh", "single", "--out", out],
                           capture_output=True, text=True, env=env,
                           timeout=300)
        wall = time.perf_counter() - t0
        check(r.returncode == 0, f"dryrun CLI exit {r.returncode}: "
              f"{r.stderr[-2000:]}")
        rec = json.load(open(os.path.join(
            out, "qwen2-0.5b__train_4k__single.json")))
    check(rec["status"] == "ok", f"dryrun cell {rec.get('status')}")
    rf = rec["roofline"]
    print(f"[mesh] dryrun CLI qwen2-0.5b x train_4k x single (fake 256-rank "
          f"group, no JAX) exit 0 in {wall:.2f} s: flops/dev "
          f"{rf['flops_dev']:.6g}, bytes/dev {rf['bytes_dev']:.6g}, wire "
          f"{rf['wire_ici']:.6g}, peak {rec['memory']['peak_bytes']:.6g} "
          f"bytes, dominant {rf['dominant']} ({card})")


def _chunked_serve(torch, model, params, reqs, rules_mesh=None):
    """The chunked phase's requests (each prompt, ``CHUNK_NEW`` new) on a
    chunked engine, under the rules of ``rules_mesh`` when given: (token
    streams, chunks, decode steps, launches of ragged_prefill, ragged
    decode and flash, wall seconds, capture ms of the chunk cells and of
    the decode cells built)."""
    import contextlib
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ragged_decode import ops as rd
    from repro_torch.kernels.ragged_prefill import ops as rp
    from repro_torch.serve import Request
    eng = _chunked_engine(model, params)
    lat, chunks = [], []
    eng.on_step_latency = lat.append
    eng.on_prefill_latency = chunks.append
    rs = [Request(rid=r.rid, prompt=r.prompt, max_new=CHUNK_NEW)
          for r in reqs]
    for r in rs:
        eng.submit(r)
    n0 = (rp.launches, rd.launches, fa.launches)
    rp.launches = rd.launches = fa.launches = 0
    built0 = (_cells_built(model, "prefill_chunk"), _cells_built(model))
    t0 = time.perf_counter()
    with use_rules(rules_mesh) if rules_mesh is not None \
            else contextlib.nullcontext():
        eng.run_until_drained()
    torch.cuda.synchronize()
    out = ([list(r.out_tokens) for r in rs], len(chunks), len(lat),
           (rp.launches, rd.launches, fa.launches),
           time.perf_counter() - t0,
           (_capture_ms(model, "prefill_chunk")[built0[0]:],
            _capture_ms(model)[built0[1]:]))
    rp.launches, rd.launches, fa.launches = n0
    return out


def _chunked_under_rules(torch, card, model, params, reqs, mesh, free):
    """The chunked serve under rules on the one-rank mesh: the chunked
    prefill through the log-sum-exp merge (``ragged_prefill`` with its
    LSE), tokens as without rules (``free``: the chunked phase's, or run
    here), launches exact.  Returns its ragged_prefill and ragged_decode
    launches."""
    if free is None:
        free = _chunked_serve(torch, model, params, reqs)[0]
    toks, n_chunks, steps, (n_rp, n_rd, n_fa), wall, (cc, dc) = \
        _chunked_serve(torch, model, params, reqs, mesh)
    L = model.cfg.n_layers
    check(toks == free, "chunked serve under rules: tokens differ from the "
          "same prompts without rules")
    check(n_chunks == sum(-(-len(r.prompt) // CHUNK) for r in reqs),
          f"chunked serve under rules: {n_chunks} chunks")
    check(len(cc) == len(dc) == 1, f"chunked serve under rules: "
          f"{len(cc)} chunk cells and {len(dc)} decode cells built, not one "
          f"each under the layout")
    want = ((n_chunks + 1) * L, (steps + 1) * 4 * L, 0)
    check((n_rp, n_rd, n_fa) == want, f"chunked serve under rules: "
          f"launches {(n_rp, n_rd, n_fa)} != {want}")
    print(f"[mesh] {model.cfg.name} chunked serve under rules on cells "
          f"captured under the NCCL layout (chunks of {CHUNK} through "
          f"ragged_prefill with its log-sum-exp, merged over model at group "
          f"size 1): {len(reqs)} prompts x {CHUNK_NEW} tokens identical to "
          f"the run without rules; launches {n_rp} ragged_prefill "
          f"(({n_chunks} chunks + the build) x {L}), {n_rd} ragged decode "
          f"(({steps} steps + the build) x 4 x {L}), 0 flash; capture "
          f"{cc[0]:.3f} ms (chunk), {dc[0]:.3f} ms (decode); wall "
          f"{wall:.3f} s ({card})")
    return {"ragged_prefill": n_rp, "ragged_decode": n_rd}


SSM_MESH_PREFILL = (8, 1024)   # mamba2-130m's prefill under rules


def _ssm_under_rules(torch, np, seed, card, mesh):
    """mamba2-130m's prefill at full width under rules on the one-rank
    mesh, its SSD on the rank's block of heads (all 24): logits and both
    cache leaves bitwise those without rules, ``ssm`` not recorded as
    computed whole."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import use_rules
    cfg = get_config("mamba2-130m")
    m, p = _init_family(torch, "mesh", cfg, seed, card)
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, SSM_MESH_PREFILL)
                              ).cuda()
    with torch.no_grad():
        want, wc = m.prefill(p, {"tokens": tokens})
        with use_rules(mesh) as rules:
            got, gc = m.prefill(p, {"tokens": tokens})
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "mamba2 under rules: non-finite")
    same = torch.equal(got, want) and all(torch.equal(gc[n], wc[n])
                                          for n in wc)
    check(same, f"mamba2 prefill under rules differs from the prefill "
          f"without them (logits max abs "
          f"{(got.float() - want.float()).abs().max().item()})")
    rep = sorted(rules.cache.get("replicated", ()))
    check("ssm" not in rep, f"mamba2 under rules: ssm computed whole {rep}")
    print(f"[mesh] {cfg.name} prefill {SSM_MESH_PREFILL[0]} x "
          f"{SSM_MESH_PREFILL[1]} under rules, the SSD on the rank's block "
          f"of {cfg.ssm_heads} heads (gated norm all-reduced, out_proj "
          f"row-parallel, state gathered): logits {tuple(got.shape)} and "
          f"the ssm and conv caches bitwise those without rules; computed "
          f"whole: {rep} ({card})")


def _train_options_under_rules(torch, tm, opt, s0, batch, mesh, card):
    """One qwen2-0.5b 8 x 1024 step with ``microbatches=2`` and
    ``compress_dcn`` on the one-rank mesh (each rank's rows in two parts;
    each leaf's int8 scale from its max all-reduced over the axes it is
    sharded on): the loss bitwise that of the same step without rules."""
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.optim.compression import ef_init
    from repro_torch.train import make_train_step
    from repro_torch.train.step import local_train_state
    kw = dict(microbatches=2, compress_dcn=True)
    n0 = (fa.launches, fa.bwd_launches)
    state = dict(s0, ef=ef_init(s0["params"]))
    loss_free = float(make_train_step(tm, opt, **kw)(state, batch)[1]["loss"])
    with use_rules(mesh):
        local = local_train_state(tm, state)
        m = make_train_step(tm, opt, **kw)(local, batch)[1]
        loss = float(m["loss"])
    torch.cuda.synchronize()
    fa.launches, fa.bwd_launches = n0
    check(loss == loss_free, f"train under rules with microbatches=2 and "
          f"compress_dcn: loss {loss!r} != {loss_free!r} without rules")
    print(f"[mesh] {tm.cfg.name} {TRAIN_BATCH} x {TRAIN_SEQ} train step "
          f"with microbatches=2 and compress_dcn under rules: loss "
          f"{loss!r}, bitwise the step without rules; grad norm "
          f"{float(m['grad_norm']):.6g} ({card})")
    del local
    _train_cell_under_rules(torch, tm, opt, state, batch, mesh, card, **kw)


def _checkpoint_from_mesh(torch, card, mesh):
    """``launch.train.run`` on the mesh with a checkpoint directory
    (train_lm's reduced smollm, heads widened to 64, microbatches 2) for 4
    steps, saving at 3 and 4: the step-4 checkpoint holds its final state
    bitwise; resumed from step 3 without a mesh, the fourth step's loss is
    bitwise the mesh run's."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.examples.serve_lm import example_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves
    n0 = (fa.launches, fa.bwd_launches)
    arch = "smollm-135m"
    common = ["--arch", arch, "--reduced", "--global-batch", "16",
              "--seq-len", "64", "--microbatches", "2", "--device", "cuda",
              "--d-model", str(example_config(arch).d_model),
              "--log-every", "100", "--steps", "4"]
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        run = train.run(common + ["--ckpt-dir", d, "--ckpt-every", "3"],
                        mesh)
        wall = time.perf_counter() - t0
        back, extra = load_checkpoint(d, 4, run["state"], device="cuda")
        pairs = list(zip(tree_leaves(back), tree_leaves(run["state"])))
        differ = sum(not torch.equal(a, b) for a, b in pairs)
        check(differ == 0 and extra == {"data": {"step": 4}},
              f"checkpoint from the mesh: {differ} of {len(pairs)} leaves "
              f"differ from the run's state, extra {extra}")
        shutil.rmtree(os.path.join(d, f"step_{4:08d}"))
        resumed = train.run(common + ["--ckpt-dir", d, "--resume"])
    fa.launches, fa.bwd_launches = n0
    check(resumed["losses"] == run["losses"][3:],
          f"resumed without the mesh: loss {resumed['losses']} != the mesh "
          f"run's fourth {run['losses'][3:]}")
    print(f"[mesh] launch.train.run on the mesh with a checkpoint directory "
          f"({arch} reduced, d_model {example_config(arch).d_model}, 16 x "
          f"64, microbatches 2): losses {run['losses']} in {wall:.2f} s; the "
          f"step-4 checkpoint bitwise the run's state ({len(pairs)} "
          f"leaves); resumed from step 3 without a mesh: loss "
          f"{resumed['losses']}, bitwise the mesh run's fourth ({card})")


# two chunk calls of 8 slots on a 2048-row cache split over 2 ranks:
# chunks crossing row 1024 (the ranks' boundary) and the cache's end,
# starting past it, padded rows, qlen 0
GLOO_STARTS = ([0, 0, 896, 1792, 0, 512, 1900, 1024],
               [256, 100, 1152, 2048, 0, 768, 2100, 1280])
GLOO_QLENS = ([256, 100, 256, 256, 0, 256, 200, 256],
              [256, 256, 256, 100, 0, 37, 256, 256])


def _gloo_chunked_body(seed: int, tokens):
    """One rank of a 2-rank gloo group on card 0: qwen2-0.5b (seed-``seed``
    weights) through ``prefill_chunk`` over ``GLOO_STARTS`` /
    ``GLOO_QLENS`` without rules, then under a (data 1, model 2) mesh on
    the rank's blocks of the weights and of the cache.  Returns both
    calls' logits and the ruled run's ragged_prefill launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import tp
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.kernels.ragged_prefill import ops as rp
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import convert, get_model
    cfg = get_config("qwen2-0.5b")
    model = get_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    full = model.init(gen)
    B = tokens.shape[1]
    axes = model.cache_logical_axes()

    def chain(params, ruled: bool):
        cache = {n: torch.zeros(tp.local_shape(axes[n], s) if ruled else s,
                                dtype=dt, device="cuda")
                 for n, (s, dt) in model.cache_spec(B, 2048).items()}
        out = []
        for tok, st, ql in zip(tokens, GLOO_STARTS, GLOO_QLENS):
            logits, cache = model.prefill_chunk(
                params, tok.cuda(), cache,
                torch.tensor(st, dtype=torch.int32, device="cuda"),
                torch.tensor(ql, dtype=torch.int32, device="cuda"))
            out.append(logits.float().cpu())
        return torch.stack(out)
    with torch.no_grad():
        want = chain(full, False)
        mesh = make_mesh((1, 2), ("data", "model"), "cpu")
        with use_rules(mesh):
            local = convert.params_from_numpy(cfg, convert.local_tree(
                cfg, convert.param_tree(cfg, full)), "cuda")
            del full
            rp.launches = 0
            built0 = model.prefill_chunk.cells()
            got = chain(local, True)
            n = rp.launches
            built = model.prefill_chunk.cells() - built0
    return {"want": want.numpy(), "got": got.numpy(), "launches": n,
            "cells": built}


def _gloo_chunked(torch, np, seed, card):
    """``_gloo_chunked_body`` on two gloo ranks over the one card: each
    rank's logits against the unsharded chunked prefill's within 2^-4 of
    the largest logit, 24 ragged_prefill launches a chunk on each rank."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.ranks import run_ranks
    cfg = get_config("qwen2-0.5b")
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (len(GLOO_STARTS), 8, CHUNK))).long()
    t0 = time.perf_counter()
    outs = run_ranks(_gloo_chunked_body, 2, seed, tokens, device="cpu",
                     timeout=300)
    wall = time.perf_counter() - t0
    for r, o in enumerate(outs):
        scale = float(np.abs(o["want"]).max())
        diff = float(np.abs(o["got"] - o["want"]).max())
        check(np.isfinite(o["got"]).all() and diff <= LOGIT_REL_LIMIT * scale,
              f"gloo rank {r}: chunked prefill over half the cache differs "
              f"from the unsharded one by {diff} (limit "
              f"{LOGIT_REL_LIMIT * scale})")
        want_n = len(GLOO_STARTS) * cfg.n_layers
        check(o["launches"] == want_n, f"gloo rank {r}: {o['launches']} "
              f"ragged_prefill launches != {want_n}")
        check(o["cells"] == 0, f"gloo rank {r}: {o['cells']} chunk cells "
              f"built under the gloo layout, which runs the chunk eagerly")
        same = int((o["got"].argmax(-1) == o["want"].argmax(-1)).sum())
        print(f"[mesh] gloo rank {r} of 2 on one card, (data 1, model 2): "
              f"qwen2-0.5b chunked prefill, {len(GLOO_STARTS)} calls of 8 "
              f"x {CHUNK}, starts {GLOO_STARTS}, qlens {GLOO_QLENS}, each "
              f"rank on 1024 of the 2048 cache rows, merged by the "
              f"log-sum-exp: logits max abs diff {diff:.4g} from the "
              f"unsharded (limit {LOGIT_REL_LIMIT * scale:.4g}), argmax "
              f"equal in {same} of {o['got'].shape[0] * o['got'].shape[1]}; "
              f"{o['launches']} ragged_prefill launches, eager by the gloo "
              f"rule (no cell built); wall {wall:.1f} s for both ranks "
              f"({card})")


def _device_ops(torch, fn) -> dict:
    """``fn()`` under torch.profiler: {name: count} of the device-side
    events, kernels, copies and the process group's GPU annotations
    (``nccl:*``).  A spin kernel runs first in the window and is left
    out: the trace has been seen to miss the first device op launched
    after the profiler starts (one kernel of an eager decode chunk, the
    two copies a replayed cell starts with)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if ("cuda" in str(getattr(e, "device_type", "")).lower()
                and "spin_kernel" not in e.name):
            out[e.name] = out.get(e.name, 0) + 1
    return out


_NCCL_KINDS = (("all_gather", "all-gather"),
               ("reduce_scatter", "reduce-scatter"),
               ("all_reduce", "all-reduce"))


def _collectives_replayed(torch, model, params, mesh, counted, card):
    """A decode chunk under rules on the one-rank NCCL mesh (8 slots, Smax
    2048, 4 tokens) on its cell captured under the layout, against the
    eager loop on a twin of the cache: the build and two replays on new
    tokens give the eager loop's tokens and caches bit for bit, so each
    replay runs the collectives' data movement (on one rank NCCL launches
    no kernel: an all-gather or a reduce-scatter is a device copy, an
    all-reduce in place nothing).  Then one eager chunk and one replay
    traced: the same kernels by name, and counts and device copies within
    1 % of the eager loop's (the trace has been seen to drop a few of a
    replay's burst of records; the cell adds its 2 copies in and 3 clones
    out).  The eager trace's NCCL annotations by kind are printed beside
    the cost counter's collectives (``counted``)."""
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.kernels.ragged_decode import ops as rd
    k = COUNTED_DECODE[2]
    tok, pos, cache = _decode_inputs(torch, model, "cuda")
    twin = {n: t.clone() for n, t in cache.items()}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    n0 = rd.launches
    with use_rules(mesh), torch.no_grad():
        fused = model.decode_fused
        built0 = _cells_built(model)
        t0 = time.perf_counter()
        got = fused(params, tok, pos, cache, k)             # builds it
        build_s = time.perf_counter() - t0
        check(_cells_built(model) == built0 + 1, "the decode under rules "
              "built no cell")
        want = fused.eager(params, tok, pos, twin, k)
        for i in range(3):
            check(torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
                  and all(torch.equal(cache[n], twin[n]) for n in cache),
                  f"under rules, the cell's call {i} (0 its build) differs "
                  f"from the eager loop's on the same inputs")
            if i < 2:                                       # new tokens
                t2 = torch.randint(0, model.cfg.vocab, tok.shape,
                                   generator=gen, device="cuda")
                got = fused(params, t2, got[2], cache, k)
                want = fused.eager(params, t2, want[2], twin, k)
        eager = _device_ops(torch,
                            lambda: fused.eager(params, tok, pos, twin, k))
        replay = _device_ops(torch, lambda: fused(params, tok, pos, cache, k))
        times = []
        for f in (lambda: fused.eager(params, tok, pos, twin, k),
                  lambda: fused(params, tok, pos, cache, k)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                f()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) / 5)
    rd.launches = n0                  # comparison launches do not count
    by_kind = {}
    for name, n in eager.items():
        if name.startswith("nccl:"):
            kind = next((k2 for part, k2 in _NCCL_KINDS if part in name),
                        name)
            by_kind[kind] = by_kind.get(kind, 0) + n
    memcpy = "Memcpy DtoD (Device -> Device)"

    def kernels(ops):
        return {n: c for n, c in ops.items()
                if not n.startswith(("nccl:", "Memcpy", "Memset"))}
    want_k, got_k = kernels(eager), kernels(replay)
    off = sum(abs(got_k.get(n, 0) - c) for n, c in want_k.items())
    check(set(got_k) == set(want_k) and off <= 0.01 * sum(want_k.values()),
          f"the replayed decode chunk under rules ran other kernels than "
          f"the eager loop: names only in the replay "
          f"{sorted(set(got_k) - set(want_k))}, only in the eager loop "
          f"{sorted(set(want_k) - set(got_k))}, counts off by {off} of "
          f"{sum(want_k.values())}")
    extra = replay.get(memcpy, 0) - eager.get(memcpy, 0)
    check(abs(extra) <= 5 + 0.01 * eager.get(memcpy, 0),
          f"the replayed decode chunk under rules ran {replay.get(memcpy)} "
          f"device-to-device copies, the eager loop {eager.get(memcpy)}")
    check(sum(by_kind.values()) > 0, "the eager decode chunk under rules "
          "traced no NCCL operation")
    print(f"[mesh] a decode chunk under rules (8 slots, Smax 2048, 4 "
          f"tokens) on its cell captured under the layout: the build and "
          f"two replays on new tokens bitwise the eager loop's tokens and "
          f"caches; traced, the eager loop's NCCL annotations by kind "
          f"{by_kind} (the cost counter: {counted}); the replay ran "
          f"{sum(got_k.values())} kernels against the eager loop's "
          f"{sum(want_k.values())}, the same {len(want_k)} names, counts "
          f"off by {off} in all, and "
          f"{replay.get(memcpy, 0)} device-to-device copies against "
          f"{eager.get(memcpy, 0)}; host time a chunk: eager loop "
          f"{1e3 * times[0]:.3f} ms, cell {1e3 * times[1]:.3f} ms, the "
          f"cell's build {1e3 * build_s:.1f} ms ({card})")


def phase_mesh(torch, seed, card, model, params, reqs, chunked=None):
    """The distributed layer on the card: a one-rank NCCL group (card 0
    bound) and a (data 1, model 1) ``DeviceMesh``; under ``use_rules``
    the serve phase's model on 4 of its prompts (tokens as without
    rules, exact launches) and chunked on all of them (tokens as the
    chunked phase's, ``chunked``, or a run here without rules),
    granite-moe-1b-a400m's 8 x 1024 prefill through ``moe_ep`` (48
    ``all_to_all_single`` calls, logits bitwise those without rules, both
    timed), mamba2-130m's prefill with the SSD over its heads (bitwise),
    ``compressed_allreduce_demo`` on a (pod 1, data 1) mesh, a qwen2-0.5b
    train step with microbatches and ``compress_dcn`` (loss bitwise),
    ``elastic_remesh`` of qwen2-0.5b's whole training state onto a fresh
    mesh (one step after it bitwise one step without it), and a
    checkpoint written from the mesh, resumed without it.  Returns the
    ruled runs' launches."""
    import contextlib
    import tempfile

    import numpy as np
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.distributed import elastic_remesh
    from repro_torch.distributed.cost import CostCounter
    from repro_torch.distributed.ranks import process_group
    from repro_torch.distributed.sharding import logical_sharding, use_rules
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ragged_decode import ops as rd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim import AdamWConfig, compressed_allreduce_demo
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.train import (make_train_step, train_state_init,
                                   train_state_specs)
    from repro_torch.train.step import local_train_state
    from repro_torch.tree import tree_leaves, tree_map

    launches = {}
    _decode_lse(torch, rd, card)
    with tempfile.TemporaryDirectory() as store, \
            process_group(0, 1, store):
        check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
        mesh = make_mesh((1, 1), ("data", "model"))
        print(f"[mesh] NCCL group of 1 rank on {card}: mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}, device type "
              f"{mesh.device_type}")

        # qwen2-0.5b served under rules: the serve phase's tokens
        cfg = model.cfg
        prompts = [r.prompt for r in reqs[:MESH_PROMPTS]]

        def serve(rules: bool):
            eng = ServeEngine(model, params, max_batch=8, max_seq=2048,
                              decode_chunk=4)
            lat = []
            eng.on_step_latency = lat.append
            rs = [Request(rid=i, prompt=p, max_new=64)
                  for i, p in enumerate(prompts)]
            for r in rs:
                eng.submit(r)
            rd.launches = fa.launches = 0
            built0 = _cells_built(model)
            t0 = time.perf_counter()
            with use_rules(mesh) if rules else contextlib.nullcontext():
                eng.run_until_drained()
            torch.cuda.synchronize()
            return ([list(r.out_tokens) for r in rs], len(lat),
                    rd.launches, fa.launches, time.perf_counter() - t0,
                    _capture_ms(model)[built0:])
        free = serve(False)
        toks, steps, n_rd, n_fa, wall, caps = serve(True)
        check(toks == free[0], "serve under rules: tokens differ from the "
              "same prompts without rules")
        check(all(len(t) == 64 for t in toks), "serve under rules: counts")
        check(n_fa == len(prompts) * cfg.n_layers,
              f"serve under rules: {n_fa} flash launches != "
              f"{len(prompts)} x {cfg.n_layers}")
        check(len(caps) == 1, f"serve under rules: {len(caps)} decode "
              f"cells built under the layout, not one")
        check(n_rd == (steps + 1) * 4 * cfg.n_layers,
              f"serve under rules: {n_rd} ragged decodes != ({steps} steps "
              f"+ the cell's build) x 4 x {cfg.n_layers}")
        n0 = (rd.launches, fa.launches)
        with use_rules(mesh), torch.no_grad():
            coll = {}
            for name, run in _decode_and_prefill(torch, model).items():
                with CostCounter() as counter:
                    run(model, params, "cuda")
                coll[name] = counter.totals.coll_counts
        rd.launches, fa.launches = n0
        launches = {"flash_attention": n_fa, "ragged_decode": n_rd}
        for k, n in _chunked_under_rules(torch, card, model, params, reqs,
                                         mesh, chunked).items():
            launches[k] = launches.get(k, 0) + n
        print(f"[mesh] {cfg.name} under rules, through the sharded dense "
              f"layers (every collective at group size 1), the decode on a "
              f"cell captured under the NCCL layout (capture "
              f"{caps[0]:.3f} ms): {len(prompts)} prompts x 64 "
              f"tokens identical to the run without rules; launches "
              f"{n_fa} flash ({cfg.n_layers} a prefill), {n_rd} ragged "
              f"decode (({steps} steps + the build) x 4 x {cfg.n_layers}); "
              f"wall {wall:.3f} s (without rules {free[4]:.3f} s); "
              f"collectives by kind of an 8-slot 4-token decode chunk "
              f"{coll['decode']} and of a 1,024-token prefill "
              f"{coll['prefill']} ({card})")
        _collectives_replayed(torch, model, params, mesh, coll["decode"],
                              card)

        # granite-moe-1b-a400m: an 8,192-token prefill through moe_ep
        gcfg = get_config("granite-moe-1b-a400m")
        gm, gp = _init_family(torch, "mesh", gcfg, seed, card)
        rng = np.random.default_rng(seed)
        tokens = torch.from_numpy(rng.integers(0, gcfg.vocab, MOE_PREFILL)
                                  ).cuda()

        def prefill():
            with torch.no_grad():
                return gm.prefill(gp, {"tokens": tokens})[0]

        def ruled():
            with use_rules(mesh):
                return prefill()
        prefill(), ruled()                       # warm-up, not counted
        fa.launches = moe_mod.a2a_calls = 0
        got, ms_rules = _events_ms(torch, ruled)
        n_fa, n_a2a = fa.launches, moe_mod.a2a_calls
        want, ms_free = _events_ms(torch, prefill)
        ms_rules2 = _events_ms(torch, ruled)[1]
        ms_free2 = _events_ms(torch, prefill)[1]
        n_tok = MOE_PREFILL[0] * MOE_PREFILL[1]
        check(n_a2a == 2 * gcfg.n_layers, f"moe_ep: {n_a2a} all_to_all "
              f"calls != 2 x {gcfg.n_layers}")
        check(n_fa == gcfg.n_layers, f"moe_ep prefill: {n_fa} flash "
              f"launches != {gcfg.n_layers}")
        check(bool(torch.isfinite(got).all()), "moe_ep: non-finite logits")
        check(torch.equal(got, want), "moe_ep: logits under rules differ "
              f"from the prefill without them (max abs "
              f"{(got.float() - want.float()).abs().max().item()})")
        launches["flash_attention"] += n_fa
        print(f"[mesh] {gcfg.name} prefill {MOE_PREFILL[0]} x "
              f"{MOE_PREFILL[1]} ({n_tok} tokens) through moe_ep: "
              f"{n_a2a} all_to_all_single, {n_fa} flash, logits "
              f"{tuple(got.shape)} bitwise equal to the prefill without "
              f"rules; CUDA events: with rules {ms_rules:.3f} and "
              f"{ms_rules2:.3f} ms, without {ms_free:.3f} and "
              f"{ms_free2:.3f} ms ({card})")
        del gm, gp, got, want
        torch.cuda.empty_cache()
        _ssm_under_rules(torch, np, seed, card, mesh)
        torch.cuda.empty_cache()

        # compressed_allreduce_demo on (pod 1, data 1)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        x = torch.randn(DEMO_FLOATS, generator=gen, device="cuda")
        pod_mesh = make_mesh((1, 1), ("pod", "data"))
        out, ms = _events_ms(torch,
                             lambda: compressed_allreduce_demo(x, pod_mesh))
        step = float(x.abs().max()) / 127.0
        err = float((out - x).abs().max())
        check(out.shape == x.shape and bool(torch.isfinite(out).all())
              and err <= step * (0.5 + 1e-4),
              f"compressed_allreduce_demo: max abs error {err} against "
              f"half the int8 step {step / 2}")
        print(f"[mesh] compressed_allreduce_demo over {4 * DEMO_FLOATS} "
              f"bytes of f32 on (pod 1, data 1): max abs error {err:.6g}, "
              f"int8 step {step:.6g}; {ms:.3f} ms ({card})")
        del x, out

        # elastic_remesh of qwen2-0.5b's training state
        tm = get_model(get_config(TRAIN_ARCH))
        opt = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=20)
        gen.manual_seed(seed)
        s0 = train_state_init(tm, gen, opt, device="cuda")
        shapes = tree_map(lambda t: t.shape, s0)

        def shardings(m):
            return tree_map(lambda names, shape: logical_sharding(
                m, names, shape), train_state_specs(tm), shapes)
        data = SyntheticLMData(DataConfig(vocab=tm.cfg.vocab,
                                          global_batch=TRAIN_BATCH,
                                          seq_len=TRAIN_SEQ, seed=seed))
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in data.batch_at(0).items()}
        data.close()
        n0 = (fa.launches, fa.bwd_launches)
        want, wm = make_train_step(tm, opt)(s0, batch)
        fa.launches, fa.bwd_launches = n0
        train_totals = _train_under_rules(torch, tm, opt, s0, batch, mesh,
                                          float(wm["loss"]), card)
        fa.launches, fa.bwd_launches = n0
        _train_options_under_rules(torch, tm, opt, s0, batch, mesh, card)
        torch.cuda.empty_cache()
        n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(s0))
        placed = elastic_remesh(s0, shardings, mesh)
        del s0
        fresh = make_mesh((1, 1), ("data", "model"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moved = elastic_remesh(placed, shardings, fresh)
        torch.cuda.synchronize()
        t_remesh = time.perf_counter() - t0
        del placed
        check(all(d.device_mesh is fresh for d in tree_leaves(moved)),
              "elastic_remesh: a leaf is not on the new mesh")
        got, _ = make_train_step(tm, opt)(
            tree_map(lambda d: d.to_local(), moved), batch)
        fa.launches, fa.bwd_launches = n0
        pairs = list(zip(tree_leaves(got), tree_leaves(want)))
        differ = sum(not torch.equal(a, b) for a, b in pairs)
        check(differ == 0, f"elastic_remesh: one step after the move "
              f"differs from one without it in {differ} of {len(pairs)} "
              f"leaves")
        print(f"[mesh] elastic_remesh of {TRAIN_ARCH}'s training state "
              f"(params, m, v: {n_bytes} bytes) onto a fresh mesh in "
              f"{t_remesh * 1e3:.1f} ms; one {TRAIN_BATCH} x {TRAIN_SEQ} "
              f"step after it: all {len(pairs)} leaves bitwise equal to "
              f"one step without the move ({card})")
        del moved, got, want
        step_ms = _train_step_times(torch, tm, opt, batch, seed, card)
        fa.launches, fa.bwd_launches = n0
        del batch
        _checkpoint_from_mesh(torch, card, mesh)
    check(not dist.is_initialized(), "the process group outlived the phase")
    torch.cuda.empty_cache()
    _gloo_chunked(torch, np, seed, card)
    n0 = (rd.launches, fa.launches)
    decode = _counter_against_card(torch, model, params, card)
    rd.launches, fa.launches = n0
    _roofline_beside(tm.cfg, train_totals, step_ms, model.cfg, decode, card)
    _dryrun_cli(card)
    return launches


# the port's kernels' device functions, summed in the profile windows
PROFILE_GROUPS = {"ragged_decode": ("decode_split_", "decode_combine"),
                  "flash_attention": ("flash_bf16_wgmma", "flash_f32"),
                  "ragged_prefill": ("prefill_bf16_wgmma", "prefill_merge"),
                  "bitonic_sort": ("sort_cluster", "global_step"),
                  "matmul": ("matmul_kernel",),
                  "flash_attention_bwd": ("bwd_stats_", "bwd_dq_",
                                          "bwd_dkdv_", "bwd_dot")}


def _profile_window(torch, fn, label: str, card: str, top: int = 8,
                    ranges=()):
    """Run ``fn`` under torch.profiler; print device busy time against
    wall time, the kernels that took most device time and the port's
    kernels, each with its share, and each port kernel's sum; and for each
    ``torch.profiler.record_function`` range named in ``ranges``, the
    device time of the kernels launched inside it.  Returns ``{"wall":
    s, "busy": s, name: device ms for each range and each port kernel
    seen, "sequence": {port kernel: its launches in start order}}``, or
    None when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        # a range's GPU-side annotation spans kernels already counted
        if dev_us > 0 and e.device_type is not None \
                and "cuda" in str(e.device_type).lower() \
                and e.key not in ranges:
            rows.append((dev_us, e.count, e.key))
    busy = sum(r[0] for r in rows) / 1e6
    if busy == 0:
        print(f"[profile] {label}: wall {1e3 * wall:.3f} ms; device time "
              f"not measured (the profiler saw no CUDA kernels)")
        return None
    print(f"[profile] {label}: wall {1e3 * wall:.3f} ms, device busy "
          f"{1e3 * busy:.3f} ms, idle share {1 - busy / wall:.3f} ({card})")
    # the top kernels, and every kernel in an anonymous namespace (all
    # of the port's, and some of PyTorch's), each with its share
    for n, (dev_us, count, key) in enumerate(sorted(rows, reverse=True)):
        if n < top or "(anonymous namespace)" in key:
            print(f"[profile]   {dev_us / 1e3:9.3f} ms {count:6d}x "
                  f"{dev_us / 1e6 / busy:6.1%}  {key[:90]}")
    out = {"wall": wall, "busy": busy, "sequence": {}}
    # each port kernel's launches in start order: (start us, device us,
    # name), for a caller that splits them by the layer they served
    for e in prof.events():
        if "cuda" not in str(getattr(e, "device_type", "")).lower():
            continue
        for name, parts in PROFILE_GROUPS.items():
            if any(p in e.name for p in parts):
                out["sequence"].setdefault(name, []).append(
                    (e.time_range.start, e.time_range.elapsed_us(), e.name))
    for seq in out["sequence"].values():
        seq.sort()
    for name, parts in PROFILE_GROUPS.items():
        got = [(d, c) for d, c, k in rows if any(p in k for p in parts)]
        if got:
            d = sum(x[0] for x in got)
            out[name] = d / 1e3
            print(f"[profile]   {name}: {d / 1e3:.3f} ms of device time in "
                  f"{sum(x[1] for x in got)} launches, {d / 1e6 / busy:.1%} "
                  f"of the window's")
    for e in prof.key_averages():
        # the host-side range: the device time of the kernels launched
        # inside it (its GPU-side annotation is a span, gaps included)
        if e.key in ranges and "cpu" in str(e.device_type).lower():
            dev_us = getattr(e, "device_time_total", None)
            if dev_us is None:
                dev_us = getattr(e, "cuda_time_total", 0.0)
            if dev_us > 0:
                out[e.key] = dev_us / 1e3
            print(f"[profile]   range {e.key}: "
                  + (f"{dev_us / 1e3:.3f} ms of device time in {e.count} "
                     f"calls, {dev_us / 1e6 / busy:.1%} of the window's"
                     if dev_us > 0 else "device time not measured (no "
                     "kernel attributed to the range)"))
    return out


def phase_profile(torch, np, model, params, reqs, card, how,
                  prefill=True):
    """Where the time goes: one traced window of three decode chunks on a
    full batch (``how`` names the decode path), and one traced
    whole-prompt prefill of the longest prompt.  The ``ragged_decode``
    calls counted in the decode window are held against the split and
    combine kernels in its trace."""
    from repro_torch.kernels.ragged_decode import ops as rd
    from repro_torch.serve import Request, ServeEngine
    eng = ServeEngine(model, params, max_batch=8, max_seq=2048,
                      decode_chunk=4)
    for r in reqs[:8]:
        eng.submit(Request(rid=r.rid, prompt=r.prompt, max_new=64))
    eng.step()                        # admits all 8, first chunk
    n0 = rd.launches
    prof = _profile_window(torch, lambda: [eng.step() for _ in range(3)],
                           f"3 decode chunks x 4 tokens, 8 slots ({how})",
                           card)
    counted = rd.launches - n0
    check(counted == 3 * 4 * model.cfg.n_layers,
          f"{how}: {counted} ragged_decode calls counted in the window")
    if prof is not None:
        print(f"[profile] decode window ({how}): busy share "
              f"{prof['busy'] / prof['wall']:.3f}, idle share "
              f"{1 - prof['busy'] / prof['wall']:.3f} ({card})")
        # a replay adds the launches its capture counted: the trace's own
        # kernels, one split and one combine a call, hold that to account
        names = [n for _, _, n in prof["sequence"].get("ragged_decode", ())]
        split = sum("decode_split_" in n for n in names)
        combine = sum("decode_combine" in n for n in names)
        check(split == combine == counted,
              f"{how}: the trace holds {split} split and {combine} combine "
              f"kernels of ragged_decode, the counter {counted} calls")
        print(f"[profile] decode window ({how}): ragged_decode calls "
              f"counted {counted}, in the trace {split} split and "
              f"{combine} combine kernels")
    if not prefill:
        return
    longest = max((r.prompt for r in reqs), key=len)
    tokens = torch.as_tensor(longest, device="cuda").long()[None]
    _profile_window(torch, lambda: model.prefill(params, {"tokens": tokens}),
                    f"prefill of {len(longest)} tokens", card)


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=("flash_bwd", "mesh", "graph",
                                       "train"),
                    help="run the device and build phases and this part "
                         "alone (mesh: after the serve phase that builds "
                         "its model; graph: the serve phase, graph against "
                         "eager loop and the legacy step cell, the chunked "
                         "phase, chunk cell against eager chunk, and the "
                         "audit; train: the train phase), and print no "
                         "result line")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {SRC}", file=sys.stderr)
        return 2
    # the port must run without JAX: make any import of it fail
    sys.modules["jax"] = None
    sys.modules["repro"] = None
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    try:
        card, name, peaks = phase_device(torch)
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        _build.library()
        print(f"[build] {len(_build.sources())} sources -> "
              f"{_build.build().name} in {time.perf_counter() - t0:.2f} s")
        if args.only == "flash_bwd":
            phase_flash_bwd(torch, args.seed, peaks, card)
            return 0
        if args.only == "train":
            phase_train(torch, args.seed, card)
            print(f"[smoke] --only train passed in "
                  f"{time.perf_counter() - t_start:.1f} s ({card})")
            return 0
        if args.only == "graph":
            _, model, params, reqs = phase_serve(torch, args.seed, card)
            phase_chunked(torch, card, model, params, reqs)
            phase_audit(torch, card, model, params)
            print(f"[smoke] --only graph passed in "
                  f"{time.perf_counter() - t_start:.1f} s ({card})")
            return 0
        if args.only == "mesh":
            _, model, params, reqs = phase_serve(torch, args.seed, card)
            phase_mesh(torch, args.seed, card, model, params, reqs)
            print(f"[smoke] --only mesh passed in "
                  f"{time.perf_counter() - t_start:.1f} s ({card})")
            return 0
        stats = phase_kernels(torch, args.seed, peaks)
        train = phase_train(torch, args.seed, card)
        from repro_torch.kernels.stream_copy import ops as sc
        # scale-add is on no path: its launches are its kernel checks'
        scale_add_launches = sc.scale_add_launches
        launches, model, params, reqs = phase_serve(torch, args.seed, card)
        launches["flash_attention"] += train["flash_attention"]
        launches["flash_attention_bwd"] = train["flash_attention_bwd"]
        chunked = phase_chunked(torch, card, model, params, reqs)
        launches["ragged_prefill"] = chunked["ragged_prefill"]
        phase_wire(torch, card, model, params, reqs)
        fleet = phase_fleet(torch, card, model, params, reqs)
        region = phase_region(torch, args.seed, card, model, params, reqs)
        phase_audit(torch, card, model, params)
        mesh = phase_mesh(torch, args.seed, card, model, params, reqs,
                          chunked["tokens"])
        del model, params
        # every serving path's launches: each phase's run counts from 0
        for path in (phase_moe(torch, args.seed, card, reqs),
                     phase_moe_alt(torch, args.seed, card, reqs),
                     phase_ssm(torch, args.seed, card, reqs),
                     phase_hybrid(torch, args.seed, card, reqs),
                     phase_vlm(torch, args.seed, card, reqs),
                     phase_audio(torch, args.seed, card)):
            for kernel, n in (path or {}).items():
                launches[kernel] = launches.get(kernel, 0) + n
        del reqs
        phase_checkpoint(torch, args.seed, card)
        launches.update(phase_runtime(torch, args.seed, card))
        launches["matmul"] += phase_paper(torch, card)["matmul"]
        for kernel, n in phase_examples(torch, card).items():
            launches[kernel] += n
        for kernel, n in (*fleet.items(), *region.items(), *mesh.items()):
            launches[kernel] += n
        launches["stream_scale_add"] = scale_add_launches
        kernels = kernel_line(stats, launches)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"[smoke] every phase passed in {time.perf_counter() - t_start:.1f}"
          f" s of wall time ({card})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def kernel_line(stats: dict, launches: dict) -> list[dict]:
    kernels = [
        dict(name="ragged_decode", route="cuda",
             source="src/repro_torch/kernels/ragged_decode/csrc/"
                    "ragged_decode.cu",
             replaces="src/repro/kernels/ragged_decode/kernel.py:82",
             launches=launches["ragged_decode"], **stats["ragged_decode"]),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:74",
             launches=launches["flash_attention"],
             **stats["flash_attention"]),
        dict(name="flash_attention_bwd", route="cuda",
             source="src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention_bwd.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:74",
             launches=launches["flash_attention_bwd"],
             **{k: stats["flash_attention_bwd"][k] for k in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")}),
        dict(name="ragged_prefill", route="cuda",
             source="src/repro_torch/kernels/ragged_prefill/csrc/"
                    "ragged_prefill.cu",
             replaces="src/repro/kernels/ragged_prefill/kernel.py:97",
             launches=launches["ragged_prefill"],
             **stats["ragged_prefill"]),
        dict(name="matmul", route="cuda",
             source="src/repro_torch/kernels/matmul/csrc/matmul.cu",
             replaces="src/repro/kernels/matmul/kernel.py:35",
             launches=launches["matmul"], **stats["matmul"]),
        dict(name="stream_copy", route="cuda",
             source="src/repro_torch/kernels/stream_copy/csrc/"
                    "stream_copy.cu",
             replaces="src/repro/kernels/stream_copy/kernel.py:21",
             launches=launches["stream_copy"], **stats["stream_copy"]),
        # on no path: its launches are those of its checks in the kernels
        # phase, its only launches
        dict(name="stream_scale_add", route="cuda",
             source="src/repro_torch/kernels/stream_copy/csrc/"
                    "stream_copy.cu",
             replaces="src/repro/kernels/stream_copy/kernel.py:41",
             launches=launches["stream_scale_add"],
             **stats["stream_scale_add"]),
        dict(name="bitonic_sort", route="cuda",
             source="src/repro_torch/kernels/bitonic_sort/csrc/"
                    "bitonic_sort.cu",
             replaces="src/repro/kernels/bitonic_sort/kernel.py:47",
             launches=launches["bitonic_sort"], **stats["bitonic_sort"]),
    ]
    for kr in kernels:
        check(kr["launches"] > 0, f"{kr['name']} never launched")
        check(all(math.isfinite(kr[k]) for k in
                  ("max_abs_err", "ms", "plain_ms", "bound_ms")),
              f"{kr['name']}: a non-finite number in {kr}")
    return kernels


if __name__ == "__main__":
    sys.exit(main())
