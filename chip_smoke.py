#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout (one ``nvcc`` each, all
at once), holds each against its plain PyTorch version on the card, and
drives the port's paths through the kernels:

  * the batched dataplane (``run_window_batch`` -> ``simulate_batch`` ->
    ``run_system_batch`` / ``profile_contexts``, one grant-tick launch a
    tick with one CTA an element): the batched kernel against its plain
    version at B = 1, 6 and 64; a ragged mixed-mode batch of four
    (``batch_parity``) CUDA against CPU, graph against eager body, and each
    element against its serial run; Fig. 6 / Table 3's six elements
    (three systems, two load points) as one ``run_system_batch`` of 5,000
    ticks held against a digest of the JAX reference's run
    (``fig6_batch``); sim_perf's eight heterogeneous profiler contexts
    against eight serial ``profile_context`` calls (``profile_batch8``);
  * the dataplane (the quickstart server: ``ArcusRuntime`` admission +
    ``run_managed``, Algorithm 1), one token-bucket grant-tick launch a
    simulated tick, every window a replay of its compile-cache entry's
    CUDA graph of one tick (``cache_info()`` steady across the managed
    windows; the eager body's µs a tick beside it), with CUDA windows
    (hardware shaping with round robin, software shaping with WFQ) checked
    bitwise against the same windows on the CPU, and graph windows (those
    two, and a resumed one with a register write) bitwise against the
    eager body on the card (``graph_parity``);
  * serving (``ServingEngine`` + ``ArcusScheduler``, every decode step a
    replay of the engine's CUDA graph, held against its eager body in
    ``graph_parity``) of gemma3-12b at full width and depth with random
    weights: the launcher's request mix, a
    long-prompt mix that crosses the 1024-token window, and, at one period
    of depth (6 layers), both mixes through the kernels against the same
    mixes through the plain versions;
  * the same serving of mamba2-780m (48 ``ssd`` layers, every prefill
    through the SSD-scan kernel) at full width and depth: the launcher's
    mix, four 2000-token prompts, and, at 2 layers, both mixes through the
    kernel against the plain scan (each call's logits against the plain
    versions on a copy of the same cache: a recurrent state carries any
    rounding difference forward, so two independent runs drift apart);
  * the same serving of recurrentgemma-9b at full width and depth (26
    ``rglru`` layers and 12 local MQA attention layers: decode attention
    at 16 query heads on one KV head of 256, flash prefill at G = 16),
    four 2560-token prompts across its 2048-token window, and one period
    (3 layers) through the kernels against the plain versions on the same
    cache;
  * the same serving of mixtral-8x22b at full width (48 / 8 heads of 128,
    G = 6; 8 experts of d_ff 16384, top-2) and 8 of its 56 layers (all 56
    would hold about 280 GB of weights): the launcher's mix over 6 s of
    virtual time, four 1536-token prompts, the MoE layer's decode form
    (every expert, unrouted outputs dropped) against its grouped form on
    one hidden state, and 2 layers through the kernels against the plain
    versions on the same cache and the same MoE routing
    (``repro_torch.models.routing``: rounding can move a router's choice
    where its k-th and (k+1)-th experts nearly tie);
  * serving with frontends through ``ServingEngine.admit(req, frontend)``
    + ``step()`` (the launcher's scheduler admits with no frontend, as the
    reference's, so these paths drive the engine; each request with its
    own seeded embeddings): llama-3.2-vision-11b at full width and depth
    (32 global and 8 gated ``cross`` layers over 1600 patch embeddings:
    flash prefill non-causal at Sq != Sk, decode attention over the full
    memory at G = 4), the launcher's request shapes, four 1536-token
    prompts (``_long``) and one period (5 layers) through the kernels
    against the plain versions on the same cache (``_parity``); and
    seamless-m4t-medium at full size (a 12-layer bidirectional encoder
    over 1024 audio frames, 12 decoder layers each with causal
    self-attention and cross-attention to the encoder's output; G = 1,
    D 64), the same request shapes, the encoder's share of a prefill,
    and 2 + 2 layers against the plain versions (``serve_seamless_parity``).
    The card's random weights draw the gates (zero at init: a silent cross
    layer would leave the checks blind), QKV biases and norms from a
    seeded normal; a ``reduced`` line says so.

Flash prefill and the SSD scan have two kernels each, chosen by operand
type: bf16 (what the models pass) on the tensor cores, float32 on the CUDA
cores; their phases check each call's path, and the serving phases check
that every flash-prefill and SSD-scan launch took the tensor-core path.

Training (``launch/train.py`` -> ``make_train_step`` -> ``loss_fn`` ->
``forward`` -> AdamW): ``flash_backward`` holds the flash-attention
backward kernels (bf16 on the tensor cores, TMA and wgmma, three launches
a call, bitwise the same run to run; float32 on the CUDA cores, two
launches) and the forward kernels' LSE
output against their plain versions at training's shapes (starcoder2-3b's
4096 tokens, gemma3-12b's window, a chunked mask, a ragged 1000,
seamless's non-causal G = 1, a cross case, float32, rows that reach no
key) and times it against SDPA's backward; ``train_parity`` runs one train
step of starcoder2-3b's first 2 layers at full width through the kernels
and one through the plain versions; ``train`` trains starcoder2-3b at full
size (30 layers, 3.03 B parameters, one 4096-token sequence a step, remat,
4 steps) through the launcher, with exact launch counts, no plain-version
call, every parameter moved, peak memory, ms a step and a profiled step.
The SSD scan's gradient: ``kernel_ssd_backward`` (after
``kernel_ssd_scan``) holds its kernels (bf16 with N <= 128 on the tensor
cores, four launches a call, the heads of each group sliced over the
CTAs; the rest on the CUDA cores, five; bitwise the same run to run)
against the chunked mirror of their arithmetic, small shapes
against autograd of the sequential scan and the tensor-core kernel
against the CUDA-core one, and times them at mamba2-780m's training
shape; after ``train``, ``train_mamba2_parity`` runs one train step
of mamba2-780m's first 4 layers at full width through the kernels and one
through the plain sequential scan; ``train_mamba2`` trains mamba2-780m at
full size (48 ssd layers, 0.78 B parameters, one 4096-token sequence a
step, remat, 4 steps) through the launcher, as ``train`` does.

The fleet control plane runs the contention, churn and adaptive
benchmarks' configurations uncut on the card (``resource_parity``,
``contention``, ``churn``, ``adaptive_churn``): the grant tick gating on
and charging the link's extra resource axes, placement, churn and the
adaptive control loop through ``FleetController``.

The workload package (``repro_torch.workloads``) runs its generators and
its five named scenarios on the card: ``workload_parity`` holds the seven
generator patterns' traces against the reference's pinned digests and a
batch of seven elements (one a pattern) CUDA against CPU and graph against
eager body; ``scenarios`` is benchmarks/scenarios.py's run uncut (five
scenarios, two servers, 12,000 ticks, each under ``StaticHold`` and the
bi-level adaptive policy), every deterministic field held equal to
benchmarks/results/scenarios.json.

The distributed layer (``repro_torch.distributed``, ``launch/dryrun.py``):
``kernel_decode_attention_partial`` (after ``kernel_decode_attention``)
holds the decode-attention kernel's partial form, which also writes each
head's merged softmax max and sum (``ml``), against its plain version at
one rank's half of gemma3-12b's decode_32k global layer and on edge
lengths (<= 0, past S, a window outside the slice), merges two halves
into the whole, and times the kernel with and without ``ml``;
``seq_sharded_decode`` (after the serving phases) runs ``decode_step``
through the sequence-sharded hooks on two ranks of the one card
(processes of this script, ``--seq-sharded-rank``; gloo over the card's
tensors, as NCCL refuses two ranks on one device): gemma3-12b's first
period at full width, B = 8, a float32 cache of 32,768 rows, each rank
holding half of every layer's rows, one partial launch a layer, held
against the unsharded kernel step on the same cache; ``train_sharded``
(after the training phases) trains through ``launch.train.train(...,
mesh=...)`` on a ("data", "model") = (2, 2) mesh of four processes of this
script on the card (``--train-sharded-rank``; gloo): starcoder2-3b's first
2 layers at full width, parameters and AdamW moments as ``DTensor``
blocks laid out by the reference's rules, each block's weights gathered
inside its remat region, one 2048-token sequence a "data" coordinate, 2
steps, held against the unsharded launcher on the same seed and batches,
each rank's bytes against the dry run's; ``dryrun`` (last,
host only) plans gemma3-12b x decode_32k on the pod mesh and
llama4-maverick-400b-a17b x train_4k on the two-pod mesh and prints each
device's GiB.  Every phase line carries its own seconds (``phase_s``).

Cuts against earlier versions of this script, made to fit the fleet,
training and distributed phases in the time limit: ``fig6_batch`` runs
5,000 ticks (60,000, then 20,000, then 10,000 before; fig6's quick run is
60,000 and its full run 400,000; its digests are the JAX reference's at
5,000), ``profile``
profiles windows of 25 ticks (100, then 50 before) through the graphs
only (the eager body's profiled window went), ``profile_batch8``
holds its entries at 1,000 ticks and times 4,000 (6,000 and 30,000, then
3,000 and 12,000, then 1,500 and 6,000 before), ``parity`` /
``graph_parity`` run 250 / 250 ticks (2,000 / 500, then 1,000 / 250, then
500 / 250 before; ``graph_parity``'s software-shaping window completes
nothing in 125), ``main_path``'s eager window 150 ticks (EAGER_TICKS,
300 before), ``batch_parity`` windows of 200 ticks
(300 before; at 120 an element's serial run completes nothing),
``resource_parity`` windows of 150 (400, then 250 before), ``workload_parity``'s batch 500 ticks (1,000 before), ``interp``
every size to 2^17 and every 61st to 2^20 (every size to 2^20 before),
``serve_mamba2_parity`` 2 layers (4 before), the ``serve*_parity``
phases' serve mix PARITY_SERVE_S = 1.5 s of virtual time (3 s before;
mixtral's stays 6), ``train`` and ``train_mamba2`` 4 steps (5 before), and
``auto_time_ms`` times about 0.1 s of calls (0.2 before).  The mamba2 and
recurrentgemma
paths run more scheduler rounds than the launcher's 2000 (MAMBA_ROUNDS) so
that their mixes reach 3 s of virtual time; mixtral's runs 6 s (its full
config's cost model clocks a 33 ms decode step on one H100), and its depth
is cut to 8 layers (a ``reduced`` line says so).

Each phase prints one JSON line; any failure raises and the script exits
non-zero.  The last three lines are the kernel table, the card's
``nvidia-smi`` name and power limit, and the ``ok`` line.

Imports torch and the port only.  Without a CUDA device, or run from a
directory that holds nothing else of the repository, it fails without
printing a result.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# main-path cuts (the quickstart runs ProfileTable(n_ticks=60_000) and
# run_managed(total_ticks=120_000, window_ticks=30_000)); cut further than
# in the first slice (4_000 and 8_000 / 2_000) to leave time for serving
PROFILE_TICKS = 2_000
TOTAL_TICKS = 6_000
WINDOW_TICKS = 2_000
PARITY_TICKS = 250
PROFILE_WINDOW = 25
# eager windows beside the graph's (``engine._run_window_eager``, about
# 9 ms a tick): the main path's comparison window and graph_parity's
EAGER_TICKS = 150
GRAPH_PARITY_TICKS = 250
# graph_parity's serving decode: steps after three prompts
DECODE_PARITY_STEPS = 8

# H100 SXM peaks (NVIDIA data sheet, dense): 3.35 TB/s of HBM; the table
# has no int32 entry, so integer work is held against the 67 TFLOP/s
# float32 rate of the cores outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# attention products: bf16 operands at the tensor cores' dense bf16 peak,
# float32 operands at the float32 rate outside the tensor cores
PEAK_FLOPS = {"bfloat16": 989.4e12, "float32": 67e12}

# serving: gemma3-12b at full width (48 layers, d_model 3840, vocab 262144)
SERVE_ARCH = "gemma3-12b"
SERVE_SEED = 0
LONG_PROMPT, LONG_NEW, LONG_REQUESTS = 1536, 32, 4
PARITY_LAYERS = 6          # one period: 5 local layers and 1 global
# serving: mamba2-780m at full width (48 ssd layers, d_model 1536, vocab
# 50280); 2000 is a multiple of no power of two above 16, so the scan's last
# chunk is ragged
MAMBA_ARCH = "mamba2-780m"
MAMBA_LONG_PROMPT = 2000
MAMBA_PARITY_LAYERS = 2
# the launcher runs 3 s of virtual time in at most 2000 rounds; an idle round
# advances 0.1 ms and a mamba2 step far less than a gemma3 one, so its mixes
# take about 29,000 rounds to reach 3 s (every request done by then)
MAMBA_ROUNDS = 40_000
# serving: recurrentgemma-9b at full width and depth (38 layers: 26 rglru
# and 12 local, MQA attention of 16 heads on one KV head of 256 with a
# 2048-token window; d_model and lru_width 4096, vocab 256000); its long
# prompts cross the window, and its mixes reach 3 s of virtual time in about
# 18,000 (serve) and 24,000 (long) rounds
RG_ARCH = "recurrentgemma-9b"
RG_LONG_PROMPT, RG_LONG_LEN = 2560, 4096
RG_PARITY_LAYERS = 3       # one period: rglru, rglru, local
# serving: mixtral-8x22b at full width (d_model 6144, 48 / 8 heads of 128,
# window 4096, 8 experts of d_ff 16384, top-2, vocab 32768) and 8 of its 56
# layers: all 56 would hold about 280 GB of bf16 weights, 8 hold 41 GB.  On
# one H100's clock (its full config's cost model) a decode step takes 33 ms,
# so the launcher's mix runs 6 s of virtual time to finish every request
MX_ARCH = "mixtral-8x22b"
MX_LAYERS = 8
MX_LONG_PROMPT = 1536
MX_SERVE_S = 6.0
# the serve mix's virtual seconds in the ``serve*_parity`` phases (kernels
# against plain versions on a few layers; mixtral's stays MX_SERVE_S: at
# 3 s only 44 of its 56 requests finish)
PARITY_SERVE_S = 1.5
MX_PARITY_LAYERS = 2
# serving with frontends: llama-3.2-vision-11b at full width and depth (40
# layers, global x 4 then cross: 32 / 8 heads of 128, d_model 4096, vocab
# 128256; 1600 patch embeddings of dim 1280) and seamless-m4t-medium at
# full size (12 encoder and 12 decoder layers, 16 heads of 64, d_model
# 1024, vocab 256206; 1024 audio frames of dim 1024).  The card's
# frontend embeddings come from numpy's default_rng(FRONTEND_SEED); the
# long mixes run four 1536-token prompts against the memory
LV_ARCH = "llama-3.2-vision-11b"
LV_PARITY_LAYERS = 5       # one period: global x 4, cross
SM_ARCH = "seamless-m4t-medium"
SM_PARITY_LAYERS = 2       # 2 encoder and 2 decoder layers
FRONTEND_SEED = 23
FRONTEND_LONG_PROMPT = 1536
# kernel vs plain logits in bf16: about one bf16 ulp of their scale
LOGIT_RTOL, LOGIT_ATOL = 1e-2, 0.0625

# training (``train``): starcoder2-3b at full width and depth (30 local
# layers, d_model 3072, 24 / 2 heads of 128, window 4096, tied embeddings;
# 3.03 B float32 parameters and AdamW moments, 48.5 GB), one 4096-token
# sequence a step (train_4k's length), remat, 4 launcher steps from seed 0;
# ``train_parity``: its first 2 layers at full width, one 1024-token
# sequence, kernels against plain versions
TRAIN_ARCH = "starcoder2-3b"
TRAIN_ARGV = ["--arch", TRAIN_ARCH, "--production", "--batch", "1",
              "--seq", "4096", "--steps", "4"]
TRAIN_PARITY_LAYERS, TRAIN_PARITY_SEQ = 2, 1024
# kernels vs plain versions over one train step at full width in bf16:
# the loss within 1e-2 (about 1e-3 of it; the attention output differs by
# about one bf16 ulp), each parameter's gradient within 3e-2 relative
# Frobenius error, each updated element within 2.5 lr of the plain step's
# (AdamW's first step moves an element by lr (sign(g) + wd p): a gradient
# element whose sign rounding flips moves by 2 lr; any larger gap is a bug)
TRAIN_LOSS_ATOL, TRAIN_GRAD_RTOL, TRAIN_UPDATE_LR = 1e-2, 3e-2, 2.5
# flash_backward's timed rows (BACKWARD_CASES): starcoder2's and gemma3's
BWD_TIMED = (0, 1)
# training mamba2-780m (``train_mamba2``): full width and depth (48 ssd
# layers, d_model 1536, 48 heads of 64, N 128, vocab 50280; 0.78 B float32
# parameters and AdamW moments), one 4096-token sequence a step (its batch
# of 256 cut to 1), remat, 4 launcher steps; ``train_mamba2_parity``: its
# first 4 layers at full width, one 1024-token sequence, the SSD-scan
# kernels against the plain sequential scan (seeded ``LIVEN_SSD`` noise on
# the conv taps, decay, skip and norm parameters), at TRAIN_* tolerances
MAMBA_TRAIN_ARGV = ["--arch", MAMBA_ARCH, "--production", "--batch", "1",
                    "--seq", "4096", "--steps", "4"]
MAMBA_TRAIN_PARITY_LAYERS, MAMBA_TRAIN_PARITY_SEQ = 4, 1024
# the train step sharded across ranks (``train_sharded``): starcoder2-3b's
# first 2 layers at full width (0.34 B float32 parameters), remat, a global
# batch of 2 x 2048 tokens (one sequence a "data" coordinate), 2 launcher
# steps on a ("data", "model") = (2, 2) mesh: four processes of this
# script on the one card (gloo: NCCL refuses several ranks on one device),
# held against the unsharded launcher on the same seed and batches
SHARDED_LAYERS, SHARDED_MESH = 2, (2, 2)
SHARDED_ARGV = ["--arch", TRAIN_ARCH, "--production", "--batch", "2",
                "--seq", "2048", "--steps", "2"]
# sharded against unsharded, in bf16: each rank's GEMMs run over its own
# sequence and the weight gradients are summed across ranks, in another
# order (measured on an H100 80GB HBM3 at 700 W: loss 1.5e-5 and grad_norm
# 5.3e-6 relative, elements 0.85 of the summed learning rates); each
# step's loss within 2e-4 and grad_norm within 1e-4 relative, each
# parameter element within 2.5 times the two steps' summed learning rates
# (AdamW moves an element by about lr a step, 2 lr where rounding flips a
# gradient's sign: TRAIN_UPDATE_LR's reasoning)
SHARDED_LOSS_RTOL, SHARDED_NORM_RTOL, SHARDED_PARAM_LR = 2e-4, 1e-4, 2.5


T0 = time.perf_counter()
_LAST = [T0]


def emit(phase: str, **kw) -> None:
    """One JSON line for ``phase``, with the seconds since the start and
    the phase's own (``phase_s``: since the line before it)."""
    now = time.perf_counter()
    print(json.dumps({"phase": phase, **kw, "at_s": round(now - T0, 1),
                      "phase_s": round(now - _LAST[0], 1)}), flush=True)
    _LAST[0] = now


def cuda_time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms_per_launch(fn, kind: str, calls: int = 50,
                         attempts: int = 5) -> float:
    """Device time of one launch of ``kind``'s kernels (KERNEL_KINDS), from
    ``torch.profiler`` over ``calls`` calls of ``fn`` (one launch each).
    The profiler's trace misses launches, more of them the more windows
    were traced before it in the process, and now and then all of them; a
    trace that does not show every launch is taken again, up to
    ``attempts`` times.  The mean is over the fullest trace, and the call
    raises when no trace shows a launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    best: list[float] = []
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and any(p in e.name for p in KERNEL_KINDS[kind])]
        best = max(best, us, key=len)
        if len(us) >= calls:
            break
    if not best:
        raise AssertionError(f"{attempts} profiles show no {kind} kernel")
    return sum(best) / len(best) / 1e3


def auto_time_ms(fn, budget_s: float = 0.1, max_iters: int = 200) -> float:
    """``cuda_time_ms`` with as many calls as fit in about ``budget_s``."""
    once = cuda_time_ms(fn, 3)
    return cuda_time_ms(fn, max(3, min(max_iters,
                                       int(budget_s * 1e3 / max(once,
                                                                1e-3)))))


def tb_inputs(n: int, seed: int, dev):
    """Random bucket registers with the edge cases of the CPU tests: the
    unshaped profiling registers (refill = bkt = 2^30, interval 1, which
    overflow int32 on refill), intervals of 1, IOPS and GBPS modes."""
    import numpy as np
    import torch
    from repro_torch.core import token_bucket as tb
    rng = np.random.default_rng(seed)
    refill = rng.integers(1, 5000, n).astype(np.int32)
    bkt = rng.integers(512, 1 << 20, n).astype(np.int32)
    interval = rng.integers(1, 1024, n).astype(np.int32)
    mode = rng.integers(0, 2, n).astype(np.int32)
    big = rng.random(n) < 0.25
    refill[big], bkt[big], interval[big] = 2**30, 2**30, 1
    tokens = np.where(big, 2**30, rng.integers(-(1 << 20), 1 << 20, n)
                      ).astype(np.int32)
    cyc = (rng.integers(0, 1024, n) % interval).astype(np.int32)
    st = tb.TBState(*(torch.as_tensor(x, device=dev) for x in
                      (tokens, cyc, refill, bkt, interval, mode)))
    cost = torch.as_tensor(rng.integers(1, 8192, n).astype(np.int32),
                           device=dev)
    want = torch.as_tensor(rng.random(n) < 0.8, device=dev)
    return st, cost, want


def tb_bound(n: int, per_flow_e: bool, admit: bool) -> tuple[float, str]:
    """Least time for one call, in ms, and what bounds it: every input read
    once and every output written once at HBM rate, against ~16 integer
    operations a flow."""
    read = 6 * 4 * n + (4 * n if per_flow_e else 4)
    read += (4 * n + n) if admit else 0
    written = 8 * n + (n if admit else 0)
    t_bytes = (read + written) / HBM_BYTES_PER_S
    t_ops = 16 * n / SCALAR_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_kernel(dev) -> dict:
    """CUDA token-bucket kernel vs its plain version, bitwise, both with
    fresh outputs and in place (outputs aliased to the inputs, as the
    engine calls it); times."""
    import torch
    from repro_torch.kernels.token_bucket import ops
    worst = 0
    for n in (1, 2, 3, 1000, 1025, 1 << 16, 1 << 20):
        st, cost, want = tb_inputs(n, n, dev)
        e_flow = torch.randint(0, 10**7, (n,), dtype=torch.int32, device=dev)
        for elapsed in (0, 8, 10**7, e_flow):
            for c, w in ((None, None), (cost, want)):
                ref, adm_r = ops.token_bucket_step_plain(st, elapsed, c, w)
                got, adm = ops.token_bucket_step(st, elapsed, c, w)
                own = st._replace(tokens=st.tokens.clone(),
                                  cyc=st.cyc.clone())
                inp, adm_i = ops.token_bucket_step(
                    own, elapsed, c, w, out=(own.tokens, own.cyc))
                torch.cuda.synchronize()
                pairs = [(got.tokens, ref.tokens), (got.cyc, ref.cyc),
                         (inp.tokens, ref.tokens), (inp.cyc, ref.cyc)]
                if w is not None:
                    pairs += [(adm, adm_r), (adm_i, adm_r)]
                for x, y in pairs:
                    bad = int((x != y).sum())
                    worst = max(worst, int((x.long() - y.long()).abs().max()))
                    if bad:
                        raise AssertionError(
                            f"token_bucket kernel != plain at n={n}: {bad}")
    times = {}
    for n in (2, 3, 1 << 20):
        st, cost, want = tb_inputs(n, 7, dev)
        e0 = torch.zeros(1, dtype=torch.int32, device=dev)
        iters = 2000 if n < 1024 else 200
        bound_ms, bound_by = tb_bound(n, False, True)
        times[n] = dict(
            ms=cuda_time_ms(lambda: ops.token_bucket_step(
                st, e0, cost, want), iters),
            plain_ms=cuda_time_ms(lambda: ops.token_bucket_step_plain(
                st, e0, cost, want), iters),
            bound_ms=bound_ms, bound_by=bound_by)
    emit("kernel", name="token_bucket", bitwise=True, max_abs_err=worst,
         times={str(k): v for k, v in times.items()})
    return dict(max_abs_err=worst, times=times)


def phase_kernel_grant_tick(dev) -> dict:
    """The token bucket's grant-tick kernel (one launch: every flow's
    refill, then k_grant shaper + arbiter grants) against its plain version
    on random valid carries, bitwise on every leaf it writes: N = 1, 2, 3,
    33 and 1025 flows, every shaping mode and arbiter, k_grant 1, 4 and 8
    (``rehearse.CASES``); then its times at N = 2, 3 and 1025 (ms a call,
    device ms a launch, plain ms, bound)."""
    from repro_torch.kernels.token_bucket import rehearse
    grants = 0
    for case in rehearse.CASES:
        row = rehearse.check_case(case, dev)
        if row["launches"] != 1 or row["differ"]:
            raise AssertionError(f"grant_tick kernel != plain: {row}")
        grants += row["grants"]
    times = {n: rehearse.time_grant_tick(n, dev) for n in rehearse.TIMED_NS}
    emit("kernel_grant_tick", name="token_bucket/grant_tick", bitwise=True,
         cases=len(rehearse.CASES), grants=grants,
         times={str(k): v for k, v in times.items()})
    return dict(max_abs_err=0, times=times)


# ---------------------------------------------------------------------------
# attention kernels
# ---------------------------------------------------------------------------


def attn_bound(n_bytes: float, flops: float, dtype_name: str
               ) -> tuple[float, str]:
    """Least time in ms: bytes at HBM rate against the products' flops at
    the peak rate of their operands' type; and which of the two bounds."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# B, H, KvH, D, S, window, q dtype, cache dtype, lengths: the cases of
# tests/test_kernels.py:43-51 (lengths drawn there), then gemma3-12b's
# decode: a float32 cache under bf16 activations, at the serve mix's cache
# (S = 256, lengths 13..80), the long mix's local and global caches
# (S = 1024 full; S = 2048, lengths 1536..1568); then recurrentgemma-9b's
# local layers (MQA: 16 query heads on one KV head of 256, G = 16) at the
# serve mix's cache and the long mix's full 2048-row window, and
# mixtral-8x22b's (48 / 8 heads of 128, G = 6) at the serve mix's cache and
# the long mix's (S = 2048, lengths 1536..1568); then llama-3.2-vision-11b's
# (32 / 8 heads of 128, G = 4) self-attention at the serve mix's cache and
# cross layers over the full 1600-row memory (not a power of two: a partial
# last row tile), and seamless-m4t-medium's (16 / 16 heads of 64, G = 1)
# self-attention at the serve mix's cache and cross-attention over the full
# 1024-row memory
DA_CASES = [
    (2, 16, 8, 128, 1024, 0, "float32", "float32", None),
    (1, 8, 1, 64, 512, 0, "float32", "float32", None),
    (3, 12, 2, 80, 777, 0, "float32", "float32", None),
    (2, 16, 8, 128, 2048, 256, "bfloat16", "bfloat16", None),
    (1, 40, 8, 128, 4096, 1024, "float32", "float32", None),
    (2, 16, 16, 96, 300, 0, "bfloat16", "bfloat16", None),
    (1, 24, 2, 128, 640, 128, "float32", "float32", None),
    (8, 16, 8, 256, 256, 0, "bfloat16", "float32", (13, 81)),
    (8, 16, 8, 256, 1024, 0, "bfloat16", "float32", (1024, 1025)),
    (8, 16, 8, 256, 2048, 0, "bfloat16", "float32", (1536, 1569)),
    (8, 16, 1, 256, 256, 0, "bfloat16", "float32", (13, 81)),
    (8, 16, 1, 256, 2048, 0, "bfloat16", "float32", (2048, 2049)),
    (8, 48, 8, 128, 256, 0, "bfloat16", "float32", (13, 81)),
    (8, 48, 8, 128, 2048, 0, "bfloat16", "float32", (1536, 1569)),
    (8, 32, 8, 128, 256, 0, "bfloat16", "float32", (13, 81)),
    (8, 32, 8, 128, 1600, 0, "bfloat16", "float32", (1600, 1601)),
    (8, 16, 16, 64, 256, 0, "bfloat16", "float32", (13, 81)),
    (8, 16, 16, 64, 1024, 0, "bfloat16", "float32", (1024, 1025)),
]
DA_MAIN = 7                 # the serve mix's shape: the table's row
DA_LONG = (8, 9)            # the long mix's two caches
DA_NEW = {"recurrentgemma-9b": (10, 11), "mixtral-8x22b": (12, 13),
          LV_ARCH: (14, 15), SM_ARCH: (16, 17)}


def phase_kernel_decode_attention(dev) -> dict:
    """CUDA decode attention vs its plain version on the card (2e-5 for
    float32, 2e-2 where bf16 is involved, as the JAX tests), then times of
    the kernel, the plain version and SDPA at gemma3-12b's shapes."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops
    rows = []
    for i, (B, H, KvH, D, S, w, qn, cn, lrange) in enumerate(DA_CASES):
        qdt, cdt = getattr(torch, qn), getattr(torch, cn)
        g = torch.Generator(device=dev).manual_seed(100 + i)
        q = torch.randn((B, H, D), generator=g, device=dev).to(qdt)
        k = torch.randn((B, S, KvH, D), generator=g, device=dev).to(cdt)
        v = torch.randn((B, S, KvH, D), generator=g, device=dev).to(cdt)
        rng = np.random.default_rng(i)
        lo, hi = lrange or (max(1, S // 4), S + 1)
        ln = torch.as_tensor(rng.integers(lo, hi, B).astype(np.int32),
                             device=dev)
        got = ops.decode_attention(q, k, v, ln, window=w)
        want = ops.decode_attention_plain(q, k, v, ln, window=w)
        torch.cuda.synchronize()
        tol = 2e-2 if "bfloat16" in (qn, cn) else 2e-5
        err = _max_err(got, want)
        row = dict(shape=[B, H, KvH, D, S], window=w, q=qn, cache=cn,
                   max_abs_err=err, tol=tol)
        if not err < tol:
            emit("kernel_decode_attention", failed=row)
            raise AssertionError(f"decode_attention kernel != plain: {row}")
        if lrange is not None:
            lo_pos = (ln - w).clamp_min(0) if w else torch.zeros_like(ln)
            valid = (torch.minimum(ln, torch.tensor(S, device=dev))
                     - lo_pos).sum().item()
            n_bytes = (2 * valid * KvH * D * k.element_size()
                       + 2 * q.numel() * q.element_size() + 4 * B)
            flops = 4 * valid * H * D
            row["bound_ms"], row["bound_by"] = attn_bound(n_bytes, flops,
                                                          "float32")
            idx = torch.arange(S, device=dev)
            mask = ((idx[None, :] < ln[:, None])
                    & (idx[None, :] >= ln[:, None] - (w or S + 1)))
            mask = mask[:, None, None, :]
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)

            def lib():
                return F.scaled_dot_product_attention(
                    q.to(cdt)[:, :, None], kt, vt, attn_mask=mask,
                    enable_gqa=True)
            lib_err = _max_err(lib()[:, :, 0], want)
            if not lib_err < tol:
                raise AssertionError(f"SDPA yardstick != plain: {lib_err}")
            def call():
                return ops.decode_attention(q, k, v, ln, window=w)
            row["ms"] = auto_time_ms(call)
            row["device_ms"] = device_ms_per_launch(call, "decode_attention")
            row["bound_share"] = row["bound_ms"] / row["device_ms"]
            row["plain_ms"] = auto_time_ms(
                lambda: ops.decode_attention_plain(q, k, v, ln, window=w))
            row["library_ms"] = auto_time_ms(lib)
            row["lengths"] = ln.tolist()
            row["plan"] = ops.launch_plan(B, KvH, H // KvH, S,
                                          D * k.element_size())
        rows.append(row)
    emit("kernel_decode_attention", cases=rows,
         worst_err_over_tol=max(r["max_abs_err"] / r["tol"] for r in rows))
    return dict(rows=rows, main=rows[DA_MAIN],
                long=[rows[i] for i in DA_LONG],
                new={a: [rows[i] for i in ix] for a, ix in DA_NEW.items()},
                max_abs_err=max(r["max_abs_err"] for r in rows))


# the sequence-sharded decode (``seq_sharded_decode``): gemma3-12b at full
# width and one period (5 local layers, 1 global), B = 8, a float32 cache
# of decode_32k's 32,768 rows (K and V of the global layer: 4.3 GB, half on
# each rank) split over SEQ_RANKS ranks on the one card; the sequences'
# lengths (positions before the new token) put the first one's rows all in
# rank 0's half and the others across the boundary (16,383 and 16,384:
# the new token's row the last of the first half, the first of the second)
SEQ_LAYERS = PARITY_LAYERS
SEQ_B = 8
SEQ_ROWS = 32_768
SEQ_RANKS = 2
SEQ_LENGTHS = (1000, 16383, 16384, 20000, 24000, 28000, 31000, 32766)
SEQ_STEPS = 5               # timed steps, hooked and whole
SEQ_SEED = 31

# decode_attention_partial (the kernel writing each head's merged (m, l)):
# B, H, KvH, D, S, window, cache dtype, lengths (as the wrapper gets them:
# shifted by the slice's first row).  First gemma3-12b's global layer as
# rank 1 of ``seq_sharded_decode`` holds it (S = 16,384 rows, lengths
# SEQ_LENGTHS + 1 - 16,384, the first -15,383: no row); then the edge
# lengths: <= 0, on and past S, a window that ends before the slice
# (577 - 64, 600 - 64 > S) or starts before it
DAP_CASES = [
    (8, 16, 8, 256, SEQ_ROWS // 2, 0, "float32",
     tuple(n + 1 - SEQ_ROWS // 2 for n in SEQ_LENGTHS)),
    (8, 16, 8, 256, 512, 0, "float32", (-5, 0, 1, 255, 256, 257, 512, 900)),
    (8, 16, 8, 256, 512, 64, "float32", (-5, 0, 30, 64, 100, 512, 600, 577)),
    (8, 16, 8, 256, 512, 0, "bfloat16", (-5, 0, 1, 255, 256, 257, 512, 900)),
    (2, 12, 2, 80, 777, 128, "bfloat16", (700, 40)),
]


def phase_kernel_decode_attention_partial(dev) -> dict:
    """The decode-attention kernel's partial form
    (``ops.decode_attention_partial``: out float32 and each head's merged
    (m, l)) against its plain version on ``DAP_CASES``: out within 2e-5,
    m within 2e-5 of max(1, |m|), l within 1e-4 relative, and a head with
    no row exactly (out 0, m -1e30, l 0).  At the first case, the two
    halves of a 32,768-row cache, each through the kernel, merged as the
    sequence-sharded decode merges ranks, against the plain attention over
    the whole; and the kernel's times with and without the ``ml`` output
    (``decode_attention`` on the same float32 q), the plain version's,
    SDPA's (the output alone) and the bound."""
    import torch
    from repro_torch.kernels.decode_attention import ops, ref
    rows = []
    for i, (B, H, KvH, D, S, w, cn, lens) in enumerate(DAP_CASES):
        cdt = getattr(torch, cn)
        g = torch.Generator(device=dev).manual_seed(300 + i)
        q = torch.randn((B, H, D), generator=g, device=dev)
        k = torch.randn((B, S, KvH, D), generator=g, device=dev).to(cdt)
        v = torch.randn((B, S, KvH, D), generator=g, device=dev).to(cdt)
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        out, ml = ops.decode_attention_partial(q, k, v, ln, window=w)
        p_out, p_ml = ref.decode_attention_partial(q, k, v, ln, window=w)
        torch.cuda.synchronize()
        empty = p_ml[..., 1] == 0
        m, pm = ml[..., 0], p_ml[..., 0]
        row = dict(shape=[B, H, KvH, D, S], window=w, cache=cn,
                   lengths=list(lens), out_err=_max_err(out, p_out),
                   m_err=float(((m - pm).abs() / pm.abs().clamp_min(1))
                               [~empty].max()) if (~empty).any() else 0.0,
                   l_rel_err=float(((ml[..., 1] - p_ml[..., 1]).abs()
                                    / p_ml[..., 1].clamp_min(1e-30))
                                   [~empty].max()) if (~empty).any()
                   else 0.0, empty_heads=int(empty.sum()))
        exact_empty = bool((m[empty] == -1e30).all()
                           and (ml[..., 1][empty] == 0).all()
                           and (out[empty] == 0).all())
        if not (row["out_err"] < 2e-5 and row["m_err"] < 2e-5
                and row["l_rel_err"] < 1e-4 and exact_empty):
            emit("kernel_decode_attention_partial", failed=row)
            raise AssertionError(f"decode_attention_partial != plain: {row}")
        if i == 0:
            row.update(_partial_timing(dev, q, k, v, ln))
        rows.append(row)
    emit("kernel_decode_attention_partial", cases=rows,
         max_out_err=max(r["out_err"] for r in rows))
    return dict(rows=rows, main=rows[0],
                max_abs_err=max(r["out_err"] for r in rows))


def _partial_timing(dev, q, k, v, ln) -> dict:
    """The first DAP case (one rank's half of the global layer): its other
    half through the kernel and the two merged against the plain attention
    over the whole cache; times and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops, ref
    B, S, KvH, D = k.shape
    H = q.shape[1]
    g = torch.Generator(device=dev).manual_seed(299)
    k0 = torch.randn(k.shape, generator=g, device=dev)
    v0 = torch.randn(v.shape, generator=g, device=dev)
    whole_ln = ln + S
    parts = [ops.decode_attention_partial(q, kk, vv, ll)
             for kk, vv, ll in ((k0, v0, whole_ln), (k, v, ln))]
    mx = torch.maximum(parts[0][1][..., 0], parts[1][1][..., 0])
    acc = sum(o * (ml[..., 1] * torch.exp(ml[..., 0] - mx))[..., None]
              for o, ml in parts)
    den = sum(ml[..., 1] * torch.exp(ml[..., 0] - mx) for _, ml in parts)
    merged = acc / den.clamp_min(1e-30)[..., None]
    whole = ref.decode_attention(q, torch.cat([k0, k], 1),
                                 torch.cat([v0, v], 1), whole_ln)
    merge_err = _max_err(merged, whole)
    if not merge_err < 2e-5:
        raise AssertionError(f"two merged halves != whole: {merge_err}")
    del k0, v0, whole
    valid = int((torch.clamp(ln, 0, S)).sum())
    n_bytes = (2 * valid * KvH * D * k.element_size() + 2 * q.numel() * 4
               + B * H * 2 * 4 + 4 * B)
    bound_ms, bound_by = attn_bound(n_bytes, 4 * valid * H * D, "float32")
    idx = torch.arange(S, device=dev)
    mask = (idx[None, :] < ln[:, None])[:, None, None, :]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)

    def call():
        return ops.decode_attention_partial(q, k, v, ln)
    ms = auto_time_ms(call)
    device_ms = device_ms_per_launch(call, "decode_attention")
    return dict(
        merged_halves_err=merge_err, ms=ms, device_ms=device_ms,
        ms_without_ml=auto_time_ms(lambda: ops.decode_attention(q, k, v,
                                                                ln)),
        device_ms_without_ml=device_ms_per_launch(
            lambda: ops.decode_attention(q, k, v, ln), "decode_attention"),
        plain_ms=auto_time_ms(
            lambda: ref.decode_attention_partial(q, k, v, ln)),
        library_ms=auto_time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True)),
        library="F.scaled_dot_product_attention, masked (the output "
                "alone: no m, l)",
        bound_ms=bound_ms, bound_by=bound_by,
        bound_share=bound_ms / device_ms, valid_rows=valid,
        plan=ops.launch_plan(B, KvH, H // KvH, S, D * k.element_size()))


# B, S, H, KvH, D, window, chunk, dtype: the cases of
# tests/test_flash_prefill_kernel.py:10-17, then gemma3-12b's prefill in
# bf16: the serve mix's prompts (12 and 64 tokens) and the long mix's
# (1536), each through a local layer (window 1024) and a global one; then
# recurrentgemma-9b's local layers (G = 16, D 256, window 2048: packed rows
# i * 16 + g) at 12, 64 and 2560 tokens, and mixtral-8x22b's (G = 6, D 128,
# window 4096: 6 does not divide a 128-row tile) at 12, 64 and 1536; then,
# with a ninth entry Sk, non-causal rows of q [B, S, H, D] against k, v
# [B, Sk, KvH, D]: llama-3.2-vision-11b's cross layers (G = 4, D 128) at
# 12, 64 and 1536 queries against its 1600 memory rows (Sk not a multiple
# of the 64-key tile) and its causal self-attention at 64 and 1536;
# seamless-m4t-medium's (G = 1, D 64) encoder (1024 x 1024), its
# cross-attention at 12, 64 and 1536 queries against 1024 rows and its
# causal self-attention at 64 and 1536; then two untimed edges: Sk = 16
# (the reduced configs' memory, below one tile) and Sk = 1000
FP_CASES = [
    (2, 128, 4, 2, 64, 0, 0, "float32"),
    (1, 256, 8, 8, 128, 0, 0, "float32"),
    (1, 200, 4, 1, 80, 0, 0, "float32"),
    (2, 256, 4, 2, 64, 64, 0, "float32"),
    (1, 256, 4, 2, 64, 0, 64, "float32"),
    (1, 256, 8, 4, 128, 128, 0, "bfloat16"),
    (1, 12, 16, 8, 256, 1024, 0, "bfloat16"),
    (1, 64, 16, 8, 256, 1024, 0, "bfloat16"),
    (1, 64, 16, 8, 256, 0, 0, "bfloat16"),
    (1, 1536, 16, 8, 256, 1024, 0, "bfloat16"),
    (1, 1536, 16, 8, 256, 0, 0, "bfloat16"),
    (1, 12, 16, 1, 256, 2048, 0, "bfloat16"),
    (1, 64, 16, 1, 256, 2048, 0, "bfloat16"),
    (1, 2560, 16, 1, 256, 2048, 0, "bfloat16"),
    (1, 12, 48, 8, 128, 4096, 0, "bfloat16"),
    (1, 64, 48, 8, 128, 4096, 0, "bfloat16"),
    (1, 1536, 48, 8, 128, 4096, 0, "bfloat16"),
    (1, 12, 32, 8, 128, 0, 0, "bfloat16", 1600),
    (1, 64, 32, 8, 128, 0, 0, "bfloat16", 1600),
    (1, 1536, 32, 8, 128, 0, 0, "bfloat16", 1600),
    (1, 64, 32, 8, 128, 0, 0, "bfloat16"),
    (1, 1536, 32, 8, 128, 0, 0, "bfloat16"),
    (1, 1024, 16, 16, 64, 0, 0, "bfloat16", 1024),
    (1, 12, 16, 16, 64, 0, 0, "bfloat16", 1024),
    (1, 64, 16, 16, 64, 0, 0, "bfloat16", 1024),
    (1, 1536, 16, 16, 64, 0, 0, "bfloat16", 1024),
    (1, 64, 16, 16, 64, 0, 0, "bfloat16"),
    (1, 1536, 16, 16, 64, 0, 0, "bfloat16"),
    (2, 40, 4, 1, 64, 0, 0, "bfloat16", 16),
    (1, 300, 8, 2, 128, 0, 0, "bfloat16", 1000),
]
FP_FIRST_TIMED = 6
FP_UNTIMED = (28, 29)       # the non-causal edges
FP_MAIN = 7                 # the serve mix's background prompt: the table's
FP_LONG = (9, 10)           # the long mix's prompt (local, then global)
FP_NEW = {"recurrentgemma-9b": (11, 12, 13), "mixtral-8x22b": (14, 15, 16),
          LV_ARCH: (17, 18, 19, 20, 21), SM_ARCH: (22, 23, 24, 25, 26, 27)}


def _prefill_mask(S: int, w: int, ck: int, dev):
    import torch
    qi = torch.arange(S, device=dev)[:, None]
    ki = torch.arange(S, device=dev)[None, :]
    mask = qi >= ki
    if w:
        mask &= qi - ki < w
    if ck:
        mask &= (qi // ck) == (ki // ck)
    return mask


def phase_kernel_flash_prefill(dev) -> dict:
    """CUDA flash prefill vs its plain version on the card (2e-5 for
    float32, 2e-2 for bf16; bf16 operands go to the tensor-core kernel,
    float32 ones to the CUDA-core kernel), causal or (rows with Sk) not,
    then times of the kernel, the plain version and SDPA at the serving
    paths' shapes: SDPA with the explicit mask, or with none for a
    non-causal row (``library_ms``), and, where the mask is the plain
    causal one, SDPA with ``is_causal`` (its flash backend,
    ``library_causal_ms``); the rows of the frontend archs also the
    profiled device ms a launch."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_prefill import ops
    rows = []
    for i, (B, S, H, KvH, D, w, ck, dn, *sk) in enumerate(FP_CASES):
        dt = getattr(torch, dn)
        Sk, causal = (sk[0], False) if sk else (S, True)
        kw = dict(window=w, chunk_size=ck, causal=causal)
        g = torch.Generator(device=dev).manual_seed(200 + i)
        q = torch.randn((B, S, H, D), generator=g, device=dev).to(dt)
        k = torch.randn((B, Sk, KvH, D), generator=g, device=dev).to(dt)
        v = torch.randn((B, Sk, KvH, D), generator=g, device=dev).to(dt)
        path = ops.kernel_path(q.dtype, k.dtype)
        by_path = dict(ops.LAUNCHES_BY_PATH)
        got = ops.flash_prefill(q, k, v, **kw)
        by_path[path] += 1
        if ops.LAUNCHES_BY_PATH != by_path:
            raise AssertionError(f"flash_prefill: {dn} call not on the "
                                 f"{path} path: {ops.LAUNCHES_BY_PATH}")
        want = ops.flash_prefill_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        tol = 2e-2 if dn == "bfloat16" else 2e-5
        err = _max_err(got, want)
        row = dict(shape=[B, S, H, KvH, D], sk=Sk, causal=causal, window=w,
                   chunk=ck, dtype=dn, path=path, max_abs_err=err, tol=tol)
        if not err < tol:
            emit("kernel_flash_prefill", failed=row)
            raise AssertionError(f"flash_prefill kernel != plain: {row}")
        if i >= FP_FIRST_TIMED and i not in FP_UNTIMED:
            mask = _prefill_mask(S, w, ck, dev) if causal else \
                torch.ones((S, Sk), dtype=torch.bool, device=dev)
            pairs = int(mask.sum())
            # q, k, v read once and the output (q's size) written once
            n_bytes = (2 * q.numel() + k.numel() + v.numel()) \
                * q.element_size()
            flops = 4 * B * H * D * pairs
            row["reachable_pairs"] = pairs
            row["bound_ms"], row["bound_by"] = attn_bound(n_bytes, flops, dn)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

            def lib():
                # no mask at all where there is none: SDPA's plain full
                # attention, the yardstick of the non-causal rows
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask if causal else None,
                    enable_gqa=True)
            lib_err = _max_err(lib().transpose(1, 2), want)
            if not lib_err < tol:
                raise AssertionError(f"SDPA yardstick != plain: {lib_err}")

            def call():
                return ops.flash_prefill(q, k, v, **kw)
            row["ms"] = auto_time_ms(call)
            if i >= FP_NEW[LV_ARCH][0]:
                row["device_ms"] = device_ms_per_launch(call,
                                                        "flash_prefill")
            row["plain_ms"] = auto_time_ms(
                lambda: ops.flash_prefill_plain(q, k, v, **kw))
            row["library_ms"] = auto_time_ms(lib)
            row["library_causal_ms"] = None
            if causal and not ck and (not w or S <= w):

                def lib_causal():
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True)
                lib_err = _max_err(lib_causal().transpose(1, 2), want)
                if not lib_err < tol:
                    raise AssertionError(f"SDPA is_causal yardstick != "
                                         f"plain: {lib_err}")
                row["library_causal_ms"] = auto_time_ms(lib_causal)
            row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
            row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
    emit("kernel_flash_prefill", cases=rows,
         worst_err_over_tol=max(r["max_abs_err"] / r["tol"] for r in rows))
    return dict(rows=rows, main=rows[FP_MAIN],
                long=[rows[i] for i in FP_LONG],
                new={a: [rows[i] for i in ix] for a, ix in FP_NEW.items()},
                max_abs_err=max(r["max_abs_err"] for r in rows))


# Bsz, L, H, P, G, N, dtype: the cases of tests/test_kernels.py:88-94, then
# mamba2-780m's prefills in bf16: the serve mix's prompts (12 and 64 tokens)
# and the long mix's (2000), then bf16 at Bsz = 2 and at G = 2 with N = 256
SSD_CASES = [
    (2, 256, 4, 64, 1, 128, "float32"),
    (1, 100, 3, 32, 1, 64, "float32"),
    (2, 128, 8, 64, 2, 128, "float32"),
    (1, 512, 4, 64, 1, 128, "bfloat16"),
    (1, 12, 48, 64, 1, 128, "bfloat16"),
    (1, 64, 48, 64, 1, 128, "bfloat16"),
    (1, MAMBA_LONG_PROMPT, 48, 64, 1, 128, "bfloat16"),
    (2, 300, 8, 64, 1, 128, "bfloat16"),
    (1, 300, 8, 64, 2, 256, "bfloat16"),
]
SSD_TIMED = (4, 5, 6)       # mamba2's 12-, 64- and 2000-token prefills
SSD_MAIN = 6                # the long mix's prefill: the table's row
SSD_REF_CHUNK = 128         # the reference kernel's chunk (ops.py:18)
# the tensor-core kernel against its chunked mirror (ref.ssd_scan_chunked,
# the same rounding points): float32 summation order and the bf16 roundings
# it flips, a few bf16 ulps of the output's max-abs
SSD_MIRROR_TOL = 2e-2


def ssd_bound(Bz: int, L: int, H: int, P: int, G: int, N: int,
              dtype_name: str) -> tuple[float, str]:
    """Least time in ms of one scan, in ``attn_bound``'s convention: x, a,
    B, C read once, y and the final state written once, against the
    products of the chunked form at the reference's chunk of SSD_REF_CHUNK
    tokens: C B^T once per (batch, group, chunk), and for each token and
    head M x over the chunk, C S^T and the state update, at the peak rate
    of the operands' type."""
    isz = 2 if dtype_name == "bfloat16" else 4
    n_bytes = (2 * Bz * L * H * P * isz + 4 * Bz * L * H
               + 2 * Bz * L * G * N * isz + 4 * Bz * H * P * N)
    flops = 2 * Bz * L * (H * (SSD_REF_CHUNK * P + 2 * N * P)
                          + G * SSD_REF_CHUNK * N)
    return attn_bound(n_bytes, flops, dtype_name)


def phase_kernel_ssd_scan(dev) -> dict:
    """CUDA SSD scan vs its plain (sequential) version on the card: max-abs
    error over the output's max-abs, on y and the final state, within the
    JAX test's limits (2e-3 float32, 1e-1 bf16); bf16 operands go to the
    tensor-core kernel (also held against its chunked mirror within
    SSD_MIRROR_TOL), float32 ones to the CUDA-core kernel, checked per call
    through ``ops.LAUNCHES_BY_PATH``.  Then, at mamba2-780m's shapes, times
    of the kernel, of the CUDA-core kernel on the same bf16 inputs through
    the same wrapper (``cuda_core_ms``), of the plain version, and the
    bound."""
    import torch
    from repro_torch.kernels.ssd_scan import ops, ref
    rows = []
    for i, (Bz, L, H, P, G, N, dn) in enumerate(SSD_CASES):
        dt = getattr(torch, dn)
        g = torch.Generator(device=dev).manual_seed(300 + i)
        x = (0.5 * torch.randn((Bz, L, H, P), generator=g, device=dev)
             ).to(dt)
        a = 0.7 + 0.299 * torch.rand((Bz, L, H), generator=g, device=dev)
        B = (0.3 * torch.randn((Bz, L, G, N), generator=g, device=dev)
             ).to(dt)
        C = (0.3 * torch.randn((Bz, L, G, N), generator=g, device=dev)
             ).to(dt)
        path = ops.kernel_path(x.dtype, B.dtype)
        by_path = dict(ops.LAUNCHES_BY_PATH)
        y, st = ops.ssd_scan(x, a, B, C)
        by_path[path] += 1
        if ops.LAUNCHES_BY_PATH != by_path:
            raise AssertionError(f"ssd_scan: {dn} call not on the {path} "
                                 f"path: {ops.LAUNCHES_BY_PATH}")
        yr, sr = ops.ssd_scan_plain(x, a, B, C)
        torch.cuda.synchronize()
        tol = 1e-1 if dn == "bfloat16" else 2e-3
        rel = [float((u.float() - w.float()).abs().max()
                     / (w.float().abs().max() + 1e-9))
               for u, w in ((y, yr), (st, sr))]
        row = dict(shape=[Bz, L, H, P, G, N], dtype=dn, path=path,
                   rel_err_y=rel[0], rel_err_state=rel[1], tol=tol,
                   max_abs_err=max(_max_err(y, yr), _max_err(st, sr)))
        ok = max(rel) < tol and bool(torch.isfinite(y.float()).all())
        if path == "tensor_core":
            ym, sm = ref.ssd_scan_chunked(x, a, B, C)
            row["mirror_rel_err"] = [
                float((u.float() - w.float()).abs().max()
                      / (w.float().abs().max() + 1e-9))
                for u, w in ((y, ym), (st, sm))]
            row["mirror_tol"] = SSD_MIRROR_TOL
            ok = ok and max(row["mirror_rel_err"]) < SSD_MIRROR_TOL
        if not ok:
            emit("kernel_ssd_scan", failed=row)
            raise AssertionError(f"ssd_scan kernel != plain: {row}")
        if i in SSD_TIMED:
            row["bound_ms"], row["bound_by"] = ssd_bound(Bz, L, H, P, G, N,
                                                         dn)
            row["ms"] = auto_time_ms(lambda: ops.ssd_scan(x, a, B, C))
            # the CUDA-core kernel on the same bf16 inputs, through the
            # same wrapper, in the same run: the time this PR replaces
            kernel_path = ops.kernel_path
            ops.kernel_path = lambda *_: "cuda_core"
            try:
                row["cuda_core_ms"] = auto_time_ms(
                    lambda: ops.ssd_scan(x, a, B, C))
            finally:
                ops.kernel_path = kernel_path
            row["plain_ms"] = auto_time_ms(
                lambda: ops.ssd_scan_plain(x, a, B, C), budget_s=0.5,
                max_iters=5)
            row["library_ms"] = None    # no single PyTorch call scans
            row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
    emit("kernel_ssd_scan", cases=rows,
         worst_err_over_tol=max(max(r["rel_err_y"], r["rel_err_state"])
                                / r["tol"] for r in rows))
    return dict(rows=rows, main=rows[SSD_MAIN],
                timed=[rows[i] for i in SSD_TIMED],
                max_abs_err=max(r["max_abs_err"] for r in rows))


def phase_interp(dev) -> None:
    """interp_grid on CUDA vs CPU over every size 1..INTERP_EVERY, every
    INTERP_STRIDE-th size from there to 2^20, and above."""
    import torch
    from repro_torch.core import accelerator as acc
    m = torch.cat([torch.arange(1, INTERP_EVERY + 1, dtype=torch.float32),
                   torch.arange(INTERP_EVERY + 1, 2**20 + 1, INTERP_STRIDE,
                                dtype=torch.float32),
                   torch.tensor([2**20, 2**20 + 1, 3e6, 2**31 - 1],
                                dtype=torch.float32)])
    tab = acc.AccelTable.build(list(acc.CATALOG.values()))
    bad = int((acc.log2(m.to(dev)).cpu().view(torch.int32)
               != acc.log2(m).view(torch.int32)).sum())
    for t in (tab.service_cycles, tab.egress_bytes):
        t_cpu = torch.as_tensor(t)
        t_dev = t_cpu.to(dev)
        for a in range(tab.n):
            x = acc.interp_grid(t_dev, a, m.to(dev)).cpu()
            y = acc.interp_grid(t_cpu, a, m)
            bad += int((x.view(torch.int32) != y.view(torch.int32)).sum())
    if bad:
        raise AssertionError(f"interp_grid CUDA != CPU at {bad} points")
    emit("interp", sizes=int(m.numel()), accelerators=tab.n, bitwise=True)


# interp's sizes: every one to 2^17, then every 61st to 2^20 (every size to
# 2^20 took 20.5 s of a whole run)
INTERP_EVERY = 2**17
INTERP_STRIDE = 61


def quickstart_specs():
    from repro_torch.core import SLO, FlowSpec, Path, TrafficPattern
    return [FlowSpec(i, vm_id=i, path=Path.FUNCTION_CALL, accel_id=0,
                     pattern=TrafficPattern(1500, load=0.9),
                     slo=SLO.gbps(slo))
            for i, slo in enumerate((10.0, 20.0, 10.0))]


def _counting_eager_body():
    """Count calls of the dataplane's eager window body (``_run_core``):
    the main path must make none on the card.  Returns the count (a list)
    and the function that restores the body."""
    from repro_torch.core import engine
    calls, core = [0], engine._run_core

    def counted(*a):
        calls[0] += 1
        return core(*a)
    engine._run_core = counted
    return calls, lambda: setattr(engine, "_run_core", core)


def _eager_window_us(dev, n_ticks: int) -> float:
    """Synchronised wall µs a tick of one window of the two admitted
    quickstart tenants through the eager body (``_run_window_eager``)."""
    import torch
    from repro_torch.core import engine, token_bucket as tb
    from repro_torch.core.accelerator import CATALOG, AccelTable
    from repro_torch.core.flow import FlowSet
    from repro_torch.core.interconnect import LinkSpec
    from repro_torch.core.sim import SimConfig, gen_arrivals
    flows = FlowSet.build(quickstart_specs()[:2])
    cfg = SimConfig(n_ticks=n_ticks)
    arr = gen_arrivals(flows, cfg, load_ref_gbps={0: 32.0, 1: 32.0})
    tbs = tb.pack([tb.params_for_gbps(10.0), tb.params_for_gbps(20.0)])
    atab = AccelTable.build([CATALOG["ipsec32"]])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine._run_window_eager(flows, atab, LinkSpec(), cfg, tbs, *arr,
                             device=dev)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n_ticks * 1e6


def phase_main_path(dev) -> dict:
    """The quickstart server through ArcusRuntime on the card: every window
    through its entry's CUDA graph (no eager window body), ``cache_info()``
    steady across the managed windows; beside it the eager body's µs a
    tick on the same tenants."""
    import math

    import torch
    from repro_torch.core import engine, runtime
    from repro_torch.core.accelerator import CATALOG
    from repro_torch.core.profiler import ProfileTable
    from repro_torch.core.runtime import ArcusRuntime
    from repro_torch.kernels.token_bucket import ops
    rt = ArcusRuntime([CATALOG["ipsec32"]],
                      profile_table=ProfileTable(n_ticks=PROFILE_TICKS,
                                                 device=dev), device=dev)
    infos = []
    simulate = runtime.simulate

    def windowed(*a, **k):
        out = simulate(*a, **k)
        infos.append(engine.cache_info())
        return out
    runtime.simulate = windowed
    eager_calls, restore = _counting_eager_body()
    _reset_launch_counts()
    torch.cuda.synchronize()
    try:
        t0 = time.perf_counter()
        admitted = [rt.register(s) for s in quickstart_specs()]
        t1 = time.perf_counter()
        res, reports = rt.run_managed(total_ticks=TOTAL_TICKS,
                                      window_ticks=WINDOW_TICKS,
                                      load_ref_gbps={0: 32.0, 1: 32.0})
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        runtime.simulate = simulate
        restore()
    launches = ops.LAUNCHES
    by_path = dict(ops.LAUNCHES_BY_PATH)
    eager_us = _eager_window_us(dev, EAGER_TICKS)
    profiled = len(rt.profile.entries) * PROFILE_TICKS
    ticks = profiled + TOTAL_TICKS
    expect = ticks          # one grant-tick launch a tick
    emit("reduced", what="tick counts only",
         profile_ticks=[PROFILE_TICKS, 60_000],
         total_ticks=[TOTAL_TICKS, 120_000],
         window_ticks=[WINDOW_TICKS, 30_000])
    rates = [{str(k): v for k, v in r.measured.items()} for r in reports]
    emit("main_path", admitted=admitted, window_rates_gbps=rates,
         violated=[r.violated for r in reports],
         profiled_contexts=len(rt.profile.entries),
         simulated_ticks=ticks,
         us_per_tick_admission=(t1 - t0) / profiled * 1e6,
         us_per_tick_managed=(t2 - t1) / TOTAL_TICKS * 1e6,
         us_per_tick=(t2 - t0) / ticks * 1e6,
         eager_us_per_tick=eager_us, eager_ticks=EAGER_TICKS,
         eager_window_bodies=eager_calls[0],
         cache_info_by_window=infos, cache_info=engine.cache_info(),
         tb_launches=launches, tb_launches_expected=expect,
         tb_launches_by_path=by_path)
    if eager_calls[0]:
        raise AssertionError(f"main path ran the eager window body "
                             f"{eager_calls[0]} times")
    if len(set(map(str, infos[-len(reports):]))) != 1:
        raise AssertionError(f"cache_info() moved across the managed "
                             f"windows: {infos}")
    if admitted != [True, True, False]:
        raise AssertionError(f"admission {admitted} != [True, True, False]")
    if launches != expect or by_path != dict(step=0, grant_tick=expect):
        raise AssertionError(f"token_bucket launches {launches} "
                             f"({by_path}) != ticks = {expect}, all "
                             "grant_tick")
    if len(reports) != TOTAL_TICKS // WINDOW_TICKS or not all(
            math.isfinite(v) and v >= 0 for r in reports
            for v in r.measured.values()):
        raise AssertionError(f"bad window reports: {rates}")
    done, adm = res.counters["c_done_msgs"], res.counters["c_adm_msgs"]
    if not ((done <= adm).all() and done.sum() > 0):
        raise AssertionError(f"counters inconsistent: done={done} adm={adm}")
    return dict(launches=launches, by_path=by_path)


def phase_parity(dev) -> None:
    """simulate windows CUDA vs CPU, bitwise on every counter and the
    completion ring: the two admitted tenants under hardware shaping and
    round robin, and three tenants of weights 1, 2 and 3 under software
    shaping (host-descheduling stalls, deferred refills, host delays) and
    weighted fair queueing."""
    import dataclasses

    import numpy as np
    from repro_torch.core import baselines as bl, token_bucket as tb
    from repro_torch.core.accelerator import CATALOG, AccelTable
    from repro_torch.core.flow import FlowSet
    from repro_torch.core.interconnect import ARB_WFQ, LinkSpec
    from repro_torch.core.sim import (SHAPING_SW, SimConfig, gen_arrivals,
                                      gen_stall_mask, simulate)
    atab = AccelTable.build([CATALOG["ipsec32"]])
    plans = [tb.params_for_gbps(g) for g in (10.0, 20.0, 10.0)]
    hw_cfg = SimConfig(n_ticks=PARITY_TICKS)
    sw_cfg = SimConfig(n_ticks=PARITY_TICKS, shaping=SHAPING_SW,
                       arbiter=ARB_WFQ)
    sw_specs = [dataclasses.replace(s, weight=1.0 + i)
                for i, s in enumerate(quickstart_specs())]
    windows = {
        "hw_rr": (FlowSet.build(quickstart_specs()[:2]), hw_cfg,
                  tb.pack(plans[:2]), None),
        "sw_wfq": (FlowSet.build(sw_specs), sw_cfg,
                   bl.make_tb_state(bl.HOST_TS_REFLEX, plans),
                   gen_stall_mask(sw_cfg, seed=1, stall_rate_hz=500_000.0,
                                  stall_us=(0.2, 1.0)))}
    report = {}
    for name, (flows, cfg, tbs, stall) in windows.items():
        arr = gen_arrivals(flows, cfg, load_ref_gbps={
            i: 32.0 for i in range(flows.n)})
        out = [simulate(flows, atab, LinkSpec(), cfg, tbs, *arr, stall,
                        device=d) for d in (dev, "cpu")]
        for k in out[0].counters:
            a, b = out[0].counters[k], out[1].counters[k]
            if a.tobytes() != b.tobytes():
                raise AssertionError(f"{name}: CUDA != CPU counter {k}: {a} "
                                     f"vs {b}")
        for k in ("comp_flow", "comp_lat_s", "comp_t_s", "comp_sz"):
            if not np.array_equal(getattr(out[0], k), getattr(out[1], k)):
                raise AssertionError(f"{name}: CUDA != CPU completion ring "
                                     f"{k}")
        if not len(out[0].comp_flow):
            raise AssertionError(f"{name}: no completions")
        report[name] = dict(
            flows=flows.n, completions=int(len(out[0].comp_flow)),
            stalled_ticks=0 if stall is None else int(np.sum(stall)))
    emit("parity", ticks=PARITY_TICKS, windows=report,
         counters_bitwise=True, ring_bitwise=True)


def _results_equal(name: str, a, b) -> None:
    """Two SimResults bitwise on every counter and the completion ring."""
    import numpy as np
    for k in a.counters:
        if a.counters[k].tobytes() != b.counters[k].tobytes():
            raise AssertionError(f"{name}: counter {k}: {a.counters[k]} vs "
                                 f"{b.counters[k]}")
    for k in ("comp_flow", "comp_lat_s", "comp_t_s", "comp_sz"):
        x, y = getattr(a, k), getattr(b, k)
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"{name}: completion ring {k} differs")
    if not len(a.comp_flow):
        raise AssertionError(f"{name}: no completions")


def phase_graph_parity(dev) -> None:
    """Windows through the entries' CUDA graphs against the same windows
    through the eager body on the card, bitwise on every counter and the
    completion ring: the two admitted tenants under hardware shaping and
    round robin; three tenants under software shaping and WFQ; and the
    first, resumed (t0 > 0) with a register write."""
    import dataclasses

    import numpy as np
    from repro_torch.core import baselines as bl, token_bucket as tb
    from repro_torch.core.accelerator import CATALOG, AccelTable
    from repro_torch.core.flow import FlowSet
    from repro_torch.core.interconnect import ARB_WFQ, LinkSpec
    from repro_torch.core.sim import (SHAPING_SW, SimConfig, gen_arrivals,
                                      gen_stall_mask, simulate)
    n = GRAPH_PARITY_TICKS
    atab = AccelTable.build([CATALOG["ipsec32"]])
    plans = [tb.params_for_gbps(g) for g in (10.0, 20.0, 10.0)]
    hw_cfg = SimConfig(n_ticks=n)
    sw_cfg = SimConfig(n_ticks=n, shaping=SHAPING_SW, arbiter=ARB_WFQ)
    sw_specs = [dataclasses.replace(s, weight=1.0 + i)
                for i, s in enumerate(quickstart_specs())]
    hw_flows = FlowSet.build(quickstart_specs()[:2])
    rewrite = tb.pack([tb.params_for_gbps(3.0), tb.params_for_gbps(30.0)])
    # name: flows, cfg, [(t0, registers)] (a resumed window's first runs
    # from 0), stall mask
    windows = {
        "hw_rr": (hw_flows, hw_cfg, [(0, tb.pack(plans[:2]))], None),
        "sw_wfq": (FlowSet.build(sw_specs), sw_cfg,
                   [(0, bl.make_tb_state(bl.HOST_TS_REFLEX, plans))],
                   gen_stall_mask(sw_cfg, seed=1, stall_rate_hz=500_000.0,
                                  stall_us=(0.2, 1.0))),
        "hw_rr_resumed": (hw_flows, hw_cfg, [(0, tb.pack(plans[:2])),
                                             (n, rewrite)], None)}
    report = {}
    for name, (flows, cfg, steps, stall) in windows.items():
        full = dataclasses.replace(cfg, n_ticks=n * len(steps))
        arr = gen_arrivals(flows, full, load_ref_gbps={
            i: 32.0 for i in range(flows.n)})
        out = []
        for eager in (False, True):
            carry = res = None
            with _eager_windows() if eager else contextlib.nullcontext():
                for t0, regs in steps:
                    res, carry = simulate(flows, atab, LinkSpec(), cfg,
                                          regs, *arr, stall, t0_ticks=t0,
                                          carry=carry, return_carry=True,
                                          device=dev)
            out.append(res)
        _results_equal(f"graph_parity {name}", *out)
        report[name] = dict(
            flows=flows.n, windows=len(steps), t0=[t for t, _ in steps],
            completions=int(len(out[0].comp_flow)),
            stalled_ticks=0 if stall is None else int(np.sum(stall)))
    emit("graph_parity", path="dataplane", ticks=n, windows=report,
         counters_bitwise=True, ring_bitwise=True)


def _decode_graph_parity(arch: str, model, dev, layers: int,
                         encoder_layers: int | None = None) -> None:
    """The serving decode step through the engine's CUDA graph against its
    eager body at ``layers`` of depth (and ``encoder_layers``): three
    prompts (each with its frontend embeddings where the arch has a
    frontend, ``_frontends``), then DECODE_PARITY_STEPS steps, each step's
    logits and the cache it leaves, the memory caches included, against
    the eager body run on a copy of the cache the step started from; and
    each replay's decode-attention launches counted (one a self-attention,
    ``cross`` or ``xattn`` layer).  Bitwise, or else the same tokens
    within LOGIT_RTOL / LOGIT_ATOL, recorded."""
    import numpy as np
    import torch
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    cut = model.first_layers(layers, encoder_layers)
    n_attn = attention_launches(cut.cfg)["decode"]
    fes = _frontends(cut.cfg, 3, dev, seed=3)
    eng = ServingEngine(cut.cfg, cut, max_batch=4, max_len=256, device=dev)
    graph = eng._decode
    rows = []

    def decode(tok, ln, cache):
        snap = [tuple(t.clone() for t in kv) for kv in cache]
        n0 = da.LAUNCHES
        out = graph(tok, ln, cache)
        launched = da.LAUNCHES - n0
        want = eng._decode_eager(tok, ln, snap)
        same_cache = all(torch.equal(a, b) for kv, sv in zip(cache, snap)
                         for a, b in zip(kv, sv))
        rows.append((out, want, same_cache, launched))
        return out
    eng._decode = decode
    rng = np.random.default_rng(3)
    for i, n in enumerate((80, 12, 40)):
        eng.admit(Request(i, 0, list(rng.integers(0, cut.cfg.vocab, n)),
                          2 * DECODE_PARITY_STEPS), fes[i])
    for _ in range(DECODE_PARITY_STEPS):
        eng.step()
    bitwise = all(torch.equal(a, b) and c for a, b, c, _ in rows)
    worst = max(float((a.float() - b.float()).abs().max())
                for a, b, _, _ in rows)
    tokens = all(torch.equal(a.argmax(-1), b.argmax(-1))
                 for a, b, _, _ in rows)
    launches = [n for *_, n in rows]
    emit("graph_parity", path=f"{arch} decode", layers=layers,
         steps=len(rows), logits_and_cache_bitwise=bitwise,
         tokens_equal=tokens, max_abs_logit_diff=worst,
         decode_attention_launches_per_replay=launches)
    if len(rows) != DECODE_PARITY_STEPS or launches != [n_attn] * len(rows):
        raise AssertionError(f"{arch} decode graph: {len(rows)} steps, "
                             f"decode-attention launches {launches}")
    if not bitwise:
        _logits_within(f"{arch} decode graph",
                       [("decode", a, b) for a, b, _, _ in rows])
        if not tokens:
            raise AssertionError(f"{arch} decode graph: tokens differ")


def _is_host_wait(name: str) -> bool:
    """A profiler event at which the host waits for the device: the CUDA
    runtime's stream/device/event synchronisations and blocking copies,
    and the scalar read-backs that lead to them."""
    return ("Synchronize" in name or name == "cudaMemcpy"
            or name in ("aten::item", "aten::_local_scalar_dense"))


@contextlib.contextmanager
def _eager_windows():
    """Within: ``simulate`` runs the dataplane's eager body
    (``engine._run_window_eager``) instead of the compiled entry, for the
    graph-against-eager comparisons."""
    from repro_torch.core import engine
    run = engine.run_window
    engine.run_window = engine._run_window_eager
    try:
        yield
    finally:
        engine.run_window = run


def _profile_window(dev, n_ticks: int) -> dict:
    """torch.profiler over one simulate window of ``n_ticks`` ticks of the
    two admitted tenants through the entry's graph (an unprofiled window
    first captures it): host wall time, device busy time, device kernels,
    the token-bucket kernel's launches and device time, host waits by
    name, and the host time of the costliest ops.  A trace that misses a
    grant-tick launch is taken again, up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import token_bucket as tb
    from repro_torch.core.accelerator import CATALOG, AccelTable
    from repro_torch.core.flow import FlowSet
    from repro_torch.core.interconnect import LinkSpec
    from repro_torch.core.sim import SimConfig, gen_arrivals, simulate
    flows = FlowSet.build(quickstart_specs()[:2])
    cfg = SimConfig(n_ticks=n_ticks)
    arr = gen_arrivals(flows, cfg, load_ref_gbps={0: 32.0, 1: 32.0})
    tbs = tb.pack([tb.params_for_gbps(10.0), tb.params_for_gbps(20.0)])
    atab = AccelTable.build([CATALOG["ipsec32"]])
    simulate(flows, atab, LinkSpec(), cfg, tbs, *arr, device=dev)
    for _ in range(3):      # a trace that misses a grant tick: again
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            simulate(flows, atab, LinkSpec(), cfg, tbs, *arr, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev_us = kernels = tb_us = tb_n = 0
        waits: dict[str, int] = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                dev_us += e.time_range.elapsed_us()  # one stream
                kernels += 1
                if any(pat in e.name
                       for pat in KERNEL_KINDS["token_bucket"]):
                    tb_us += e.time_range.elapsed_us()
                    tb_n += 1
            elif _is_host_wait(e.name):
                waits[e.name] = waits.get(e.name, 0) + 1
        if tb_n == n_ticks:
            break
    top = sorted((e for e in prof.key_averages()
                  if e.key.startswith("aten::")),
                 key=lambda e: -e.cpu_time_total)[:6]
    return dict(wall=wall, dev_us=dev_us, kernels=kernels, waits=waits,
                tb_us=tb_us, tb_launches=tb_n,
                top={e.key: e.cpu_time_total / n_ticks for e in top})


def _window_row(p: dict, n: int) -> dict:
    return dict(host_us_per_tick=p["wall"] / n * 1e6,
                device_busy_us_per_tick=p["dev_us"] / n,
                device_kernels_per_tick=p["kernels"] / n,
                device_idle_share=max(0.0, 1.0 - p["dev_us"]
                                      / (p["wall"] * 1e6)),
                token_bucket_launches=p["tb_launches"],
                token_bucket_device_us_per_launch=p["tb_us"] / max(
                    p["tb_launches"], 1),
                top_host_ops_us_per_tick=p["top"])


def phase_profile(dev) -> dict:
    """Where one window's time goes, through the entry's graph (the eager
    body's profile was cut: ``main_path`` times the eager body), and
    through the batch entry's graph at fig6's
    configuration with B = 1 and BATCH_PROFILE_SIZES elements (kernels and
    device µs a tick as B grows; one grant-tick launch a tick each), and a
    check that the tick never makes the host wait:
    graph windows of PROFILE_WINDOW and 2 x PROFILE_WINDOW ticks must show
    the same host waits (the window's setup and result copies).  Also the
    launch floor: the device time of the smallest kernel the card runs (a
    one-element in-place add) under the same profiler.  Returns the
    token-bucket kernel's device ms per launch and the floor."""
    import torch
    from repro_torch.core import engine
    n = PROFILE_WINDOW
    p1, p2 = _profile_window(dev, n), _profile_window(dev, 2 * n)
    one = torch.zeros(1, device=dev)
    floor_ms = device_ms_per_launch(lambda: one.add_(1), "elementwise", 200)
    grown = {k: (p1["waits"].get(k, 0), v) for k, v in p2["waits"].items()
             if v > p1["waits"].get(k, 0)}
    batched = [_profile_batch_window(dev, B, n)
               for B in (1, *BATCH_PROFILE_SIZES)]
    emit("profile", ticks=n, **_window_row(p1, n),
         launch_floor_ms=floor_ms,
         host_waits_per_window={str(n): p1["waits"], str(2 * n): p2["waits"]},
         batched_fig6_config=batched, cache_info=engine.cache_info())
    for row in batched:
        if row["token_bucket_launches"] != n:
            raise AssertionError(f"batched profile window: {row}")
    if not p1["waits"]:
        raise AssertionError("profiler recorded no host wait at all (the "
                             "window's result copy is one): cannot check")
    if grown:
        raise AssertionError(f"host waits grow with ticks: {grown}")
    if not p1["tb_launches"]:
        raise AssertionError("profiled window shows no token-bucket kernel")
    return dict(tb_device_ms_per_launch=p1["tb_us"] / p1["tb_launches"]
                / 1e3, launch_floor_ms=floor_ms, batched=batched)


# ---------------------------------------------------------------------------
# the batched dataplane: run_window_batch -> simulate_batch ->
# run_system_batch / profile_contexts
# ---------------------------------------------------------------------------

# Fig. 6 / Table 3 (benchmarks/fig6_throughput_cdf.py:48-87), rebuilt from
# the port: two 4096 B Poisson users at SLOs of 300K / 200K IOPS on
# nvme_raid0, Arcus and the two software shapers at load points 1.5 and
# 0.9 (B = 6), LinkSpec(credits=256), seed 3, the benchmark's overrides;
# cut to 5,000 ticks (its quick setting is 60,000, quick=False 400,000)
FIG6_TICKS = 5_000
FIG6_SERIAL_TICKS = 2_000
FIG6_B = 6
FIG6_SYSTEMS = ("Arcus", "Host_TS_reflex", "Host_TS_firecracker")
FIG6_LOADS = (1.5, 0.9)
FIG6_SLOS = (300_000.0, 200_000.0)
FIG6_OVERRIDES = dict(tick_cycles=64, comp_cap=1 << 17, k_grant=8, k_srv=8,
                      k_eg=8, qlen=512, lmax=64)
# result_digest of each element of the JAX reference's run of this batch on
# the CPU at FIG6_TICKS (tests/_torch_parity.fig6_batch_digests)
FIG6_DIGESTS = [
    "97f93ef2142a9bb525a773b58395b1a8e8f121069279bc48b4d0e584f534be96",
    "287d98f049915cdc39afaf925a8aca406c11de086519433c86048910b5be3051",
    "e7a9f40157378a22df20735f5968909de016736c0b457e71fdea85e318dfead7",
    "669b1b03a0df3303761ce257369ab94e5ad9277aa3fc3afd80e85b7badb3b892",
    "9f2eaf5c4766afa08b55d16ff69a55d9e800bcde587158d0ce0788219847cc03",
    "5ee0b443a9eb1022cc94c9c45bb064384d28c4ed482a43809c314b17b239ee1a",
]
# benchmarks/sim_perf.py:180-211: the profiler's eight heterogeneous
# contexts, entries held against serial profile_context calls at 1,500
# ticks, the batched call timed alone at 6,000 (its quick and full
# settings are 6,000 and 30,000)
PROFILE8_TICKS = (1_000, 4_000)
# batch_parity: windows of the ragged B = 4 batch
BATCH_PARITY_TICKS = 200
# the profile phase's batched rows (fig6's configuration)
BATCH_PROFILE_SIZES = (6, 64)


def result_digest(res) -> str:
    """sha256 of one SimResult's counters (by sorted key) and completion
    ring (flow, latency, time, size), each array's bytes in turn (as
    tests/_torch_parity.result_digest)."""
    import hashlib

    import numpy as np
    h = hashlib.sha256()
    for k in sorted(res.counters):
        h.update(np.ascontiguousarray(res.counters[k]).tobytes())
    for k in ("comp_flow", "comp_lat_s", "comp_t_s", "comp_sz"):
        h.update(np.ascontiguousarray(getattr(res, k)).tobytes())
    return h.hexdigest()


def phase_kernel_grant_tick_batch(dev) -> dict:
    """The batched grant tick (one launch, one CTA an element) against its
    plain version on fresh copies, bitwise on every leaf it writes, at
    B = 1, 6 and 64 (``rehearse.batch_case``: ragged flows 1..33 with
    mid-table holes, every shaping mode and arbiter, stalls), with
    per-element and shared stall rows; then its device ms a launch
    (``torch.profiler``) and bound at each B."""
    from repro_torch.kernels.token_bucket import rehearse
    rows = []
    for B in rehearse.BATCH_SIZES:
        for shared in (False, True):
            row = rehearse.check_batch(B, dev, shared_stall=shared)
            if row["launches"] != 1 or row["differ"] or row["hole_grants"]:
                raise AssertionError(f"batched grant tick != plain: {row}")
            rows.append(row)
    times = {B: rehearse.time_grant_tick_batch(B, dev)
             for B in rehearse.BATCH_SIZES}
    emit("kernel_grant_tick_batch", name="token_bucket/grant_tick",
         bitwise=True, cases=[{k: r[k] for k in ("batch", "shared_stall",
                                                 "grants")} for r in rows],
         times={str(k): v for k, v in times.items()})
    return dict(times=times)


def _batch_elements(n_ticks: int):
    """batch_parity's ragged batch, B = 4, built with the port as the CPU
    tests build it (``tests/_engine_cases.BATCH_ELEMENTS``): flows 1-3,
    accelerators 1-2; HW + RR, SW + WFQ with stalls, NONE + PRIORITY, HW +
    WRR.  (flows, tables, configs, registers, traces, stall masks, the
    second window's registers)."""
    import numpy as np
    from repro_torch.core import baselines as bl, token_bucket as tb
    from repro_torch.core.accelerator import CATALOG, AccelTable
    from repro_torch.core.flow import (SLO, FlowSet, FlowSpec, Path,
                                       TrafficPattern)
    from repro_torch.core.interconnect import (ARB_PRIORITY, ARB_RR, ARB_WFQ,
                                               ARB_WRR)
    from repro_torch.core.sim import (SHAPING_HW, SHAPING_NONE, SHAPING_SW,
                                      SimConfig, gen_arrivals,
                                      gen_stall_mask, stack_arrivals)
    system = {SHAPING_NONE: bl.HOST_NO_TS, SHAPING_HW: bl.ARCUS,
              SHAPING_SW: bl.HOST_TS_REFLEX}
    els = [(SHAPING_HW, ARB_RR, 1, ("ipsec32",)),
           (SHAPING_SW, ARB_WFQ, 3, ("ipsec32", "aes256")),
           (SHAPING_NONE, ARB_PRIORITY, 2, ("ipsec32",)),
           (SHAPING_HW, ARB_WRR, 3, ("synthetic50", "sha3_512"))]
    paths = (Path.FUNCTION_CALL, Path.INLINE_NIC_RX)
    out = [[] for _ in range(7)]
    for shaping, arb, n, accels in els:
        slos = [SLO.gbps(8.0 * (i + 1)) for i in range(n)]
        flows = FlowSet.build([
            FlowSpec(i, i, paths[i % 2], i % len(accels),
                     TrafficPattern(1500, load=0.9, process="poisson"),
                     slos[i], priority=i, weight=1.0 + i)
            for i in range(n)])
        sw = dict(sw_host_delay_cycles=100, sw_jitter_cycles=800) \
            if shaping == SHAPING_SW else {}
        cfg = SimConfig(n_ticks=n_ticks, shaping=shaping, arbiter=arb, **sw)
        stall = (gen_stall_mask(cfg, seed=1, stall_rate_hz=500_000.0,
                                stall_us=(0.2, 1.0))
                 if shaping == SHAPING_SW else np.zeros(n_ticks, bool))
        for lst, v in zip(out, (
                flows, AccelTable.build([CATALOG[a] for a in accels]), cfg,
                bl.make_tb_state(system[shaping], [
                    tb.params_for_gbps(s.target) for s in slos]),
                gen_arrivals(flows, cfg, seed=3,
                             load_ref_gbps={i: 40.0 for i in range(n)}),
                stall,
                bl.make_tb_state(system[shaping], [
                    tb.params_for_gbps(4.0 * (i + 1)) for i in range(n)]))):
            lst.append(v)
    flows, tabs, cfgs, regs, arrs, stalls, regs2 = out
    return (flows, tabs, cfgs, regs, stack_arrivals(arrs), np.stack(stalls),
            regs2)


def phase_batch_parity(dev) -> None:
    """The ragged B = 4 batch three ways, bitwise on every carry leaf or
    result: (1) three windows through the batch entry's CUDA graph against
    the same windows on the CPU: a first window with a mid-table
    ``fl_masks`` hole; a resumed window with a recycled lane and register
    writes; a resumed window after a released lane with
    ``tb_states=None``; (2) the same three windows through the eager body
    on the card against the graph's; (3) each element of a
    ``simulate_batch`` window on the card against its own serial
    ``simulate`` on the card."""
    import dataclasses

    import numpy as np
    from repro_torch.core import engine
    from repro_torch.core.interconnect import LinkSpec
    from repro_torch.core.sim import simulate, simulate_batch
    from repro_torch.kernels.token_bucket import ops
    n = BATCH_PARITY_TICKS
    flows, tabs, cfgs, regs, arr, stall, regs2 = _batch_elements(3 * n)
    wins = [dataclasses.replace(c, n_ticks=n) for c in cfgs]
    masks = [np.arange(3) < f.n for f in flows]
    masks[3][1] = False                 # the hole
    steps = [(None, [m.copy() for m in masks], regs),
             ("recycle", [np.arange(3) < f.n for f in flows], regs2),
             ("release", [np.arange(3) < f.n for f in flows], None)]
    steps[2][1][1][2] = False

    def run(fn, device) -> list:
        carry, out = None, []
        for w, (surgery, m, r) in enumerate(steps):
            if surgery == "recycle":
                carry = engine.recycle_flow_lane(carry, 3, 1)
            elif surgery == "release":
                carry = engine.release_flow_lane(carry, 1, 2)
            carry = fn(flows, tabs, LinkSpec(), wins, r, *arr, stall,
                       t0_ticks=w * n, carry=carry, fl_masks=m,
                       device=device)
            out.append(engine.carry_to_numpy(carry))
        return out

    engine.cache_clear()
    n0 = ops.LAUNCHES_BY_PATH["grant_tick"]
    graph = run(engine.run_window_batch, dev)
    launched = ops.LAUNCHES_BY_PATH["grant_tick"] - n0
    info = engine.cache_info()
    cpu = run(engine.run_window_batch, "cpu")
    eager = run(engine._run_window_batch_eager, dev)
    for w, (g, c, e) in enumerate(zip(graph, cpu, eager)):
        for k, v in c.items():
            for a, b, x in zip(*((t[k] if k == "tb" else (t[k],))
                                 for t in (c, g, e))):
                if a.tobytes() != b.tobytes():
                    raise AssertionError(f"batch_parity window {w}: CUDA "
                                         f"graph != CPU on {k}")
                if b.tobytes() != x.tobytes():
                    raise AssertionError(f"batch_parity window {w}: graph "
                                         f"!= eager body on {k}")
    if launched != 3 * n or info != {"entries": 1, "traces": 1}:
        raise AssertionError(f"batch_parity: {launched} grant-tick launches "
                             f"for {3 * n} ticks, cache {info}")
    batch = simulate_batch(flows, tabs, LinkSpec(), wins, regs, *arr,
                           stall, device=dev)
    for b, f in enumerate(flows):
        serial = simulate(f, tabs[b], LinkSpec(), wins[b], regs[b],
                          arr[0][b, :f.n], arr[1][b, :f.n], stall[b],
                          device=dev)
        _results_equal(f"batch_parity element {b} vs serial", serial,
                       batch[b])
    last = cpu[-1]
    emit("batch_parity", batch=len(flows), ticks=n, windows=3,
         flows=[f.n for f in flows], accelerators=[t.n for t in tabs],
         modes=[[c.shaping, c.arbiter] for c in cfgs],
         admitted=last["c_adm_msgs"].tolist(),
         completions=last["comp_n"].tolist(), cache_info=info,
         grant_tick_launches=launched, cuda_vs_cpu_bitwise=True,
         graph_vs_eager_bitwise=True, elements_vs_serial_bitwise=True)
    if not (last["comp_n"] > 0).all():
        raise AssertionError(f"batch_parity: an element completed nothing: "
                             f"{last['comp_n']}")


def fig6_inputs(n_ticks: int, B: int = 6):
    """fig6's batch with the port: ``run_system_batch``'s arguments for
    Arcus, Host_TS_reflex and Host_TS_firecracker at load points 1.5 and
    0.9 (element 2 s + l), cycled to ``B`` elements."""
    from repro_torch.core import baselines as bl, token_bucket as tb
    from repro_torch.core.accelerator import CATALOG, AccelTable
    from repro_torch.core.flow import (SLO, FlowSet, FlowSpec, Path,
                                       TrafficPattern)
    from repro_torch.core.interconnect import LinkSpec
    from repro_torch.core.sim import gen_arrivals

    def flows(load_x):
        return FlowSet.build([
            FlowSpec(i, i, Path.FUNCTION_CALL, 0,
                     TrafficPattern(4096, rate_mps=slo * load_x,
                                    process="poisson"), SLO.iops(slo))
            for i, slo in enumerate(FIG6_SLOS)])
    cfg0 = bl.make_sim_config(bl.ALL[FIG6_SYSTEMS[0]], n_ticks,
                              **FIG6_OVERRIDES)
    arrs_lp = [gen_arrivals(flows(x), cfg0, seed=3) for x in FIG6_LOADS]
    plans = [tb.params_for_iops(s) for s in FIG6_SLOS]
    six = [(bl.ALL[name], a) for name in FIG6_SYSTEMS for a in arrs_lp]
    els = [six[b % len(six)] for b in range(B)]
    return dict(systems=[s for s, _ in els], flows=flows(1.0),
                accels=AccelTable.build([CATALOG["nvme_raid0"]]),
                link=LinkSpec(credits=256),
                tb_states=[bl.make_tb_state(s, plans) for s, _ in els],
                arr=[a for _, a in els])


def deviation_percentiles(res, flow_id: int, target: float,
                          window: int = 500) -> dict:
    """Table 3's p25/p50/p75/p99 throughput deviation from the SLO, in
    percent (benchmarks/fig6_throughput_cdf.py:90-99)."""
    import numpy as np
    samp = res.throughput_samples(flow_id, window_msgs=window, kind="iops",
                                  warmup_s=0.15 * res.seconds)
    if len(samp) == 0:
        return {}
    qs = {q: float(np.percentile(samp, q)) for q in (25, 50, 75, 99)}
    return {f"p{q}_dev_pct": 100 * (v - target) / target
            for q, v in qs.items()}


def phase_fig6_batch(dev) -> dict:
    """The slice's path at full size: fig6's six elements (three systems,
    two load points, mixed shaping modes and stall masks) as ONE
    ``run_system_batch`` of FIG6_TICKS ticks, every tick one replay of the
    batch entry's graph with one grant-tick launch; each element's counters
    and completion ring against the JAX reference's digest; µs a batched
    tick and element-ticks a second, beside one element's serial µs a tick
    (FIG6_SERIAL_TICKS through its graph); Table 3's deviations."""
    import math

    import numpy as np
    import torch
    from repro_torch.core import baselines as bl, engine
    from repro_torch.core.sim import simulate
    from repro_torch.kernels.token_bucket import ops
    inp = fig6_inputs(FIG6_TICKS)
    B = len(inp["systems"])
    engine.cache_clear()
    torch.cuda.synchronize()
    _reset_launch_counts()
    t0 = time.perf_counter()
    res = bl.run_system_batch(
        inp["systems"], inp["flows"], inp["accels"], inp["link"],
        FIG6_TICKS, tb_states=inp["tb_states"], arr=inp["arr"],
        cfg_overrides=FIG6_OVERRIDES, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_path = ops.LAUNCHES, dict(ops.LAUNCHES_BY_PATH)
    info = engine.cache_info()
    digests = [result_digest(r) for r in res]
    # one element (Arcus, load 1.5) alone through its serial graph
    cfg = bl.make_sim_config(inp["systems"][0], FIG6_SERIAL_TICKS,
                             **FIG6_OVERRIDES)
    sargs = (inp["flows"], inp["accels"], inp["link"], cfg,
             inp["tb_states"][0], *inp["arr"][0])
    simulate(*sargs, device=dev)                  # captures its graph
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    simulate(*sargs, device=dev)
    torch.cuda.synchronize()
    serial_us = (time.perf_counter() - t1) / FIG6_SERIAL_TICKS * 1e6
    batch_us = wall / FIG6_TICKS * 1e6
    table3 = {}
    for i, r in enumerate(res):
        name = f"{inp['systems'][i].name}@{FIG6_LOADS[i % 2]}"
        table3[name] = {f"user{u + 1}": deviation_percentiles(r, u, slo)
                        for u, slo in enumerate(FIG6_SLOS)}
    emit("fig6_batch", batch=B, ticks=FIG6_TICKS,
         reduced=dict(ticks=[FIG6_TICKS, 60_000, 400_000]),
         systems=[s.name for s in inp["systems"]], loads=list(FIG6_LOADS),
         wall_s=wall, us_per_batched_tick=batch_us,
         element_ticks_per_s=B * FIG6_TICKS / wall,
         serial_us_per_tick=serial_us, serial_ticks=FIG6_SERIAL_TICKS,
         serial_element_ticks_per_s=1e6 / serial_us,
         grant_tick_launches=launches, launches_by_path=by_path,
         cache_info=info, completions=[int(len(r.comp_flow)) for r in res],
         admitted=[r.counters["c_adm_msgs"].tolist() for r in res],
         digests_match_reference=digests == FIG6_DIGESTS,
         table3_deviation_pct=table3)
    if digests != FIG6_DIGESTS:
        bad = [i for i, (a, b) in enumerate(zip(digests, FIG6_DIGESTS))
               if a != b]
        raise AssertionError(f"fig6_batch: elements {bad} differ from the "
                             f"JAX reference's run: {digests}")
    if launches != FIG6_TICKS or by_path != dict(step=0,
                                                 grant_tick=FIG6_TICKS):
        raise AssertionError(f"fig6_batch: token-bucket launches {by_path} "
                             f"!= {FIG6_TICKS} grant ticks")
    if info != {"entries": 1, "traces": 1}:
        raise AssertionError(f"fig6_batch: cache {info}")
    if not all(len(r.comp_flow) and math.isfinite(
            float(np.sum(r.counters["c_lat_sum"]))) for r in res):
        raise AssertionError("fig6_batch: an element completed nothing")
    return dict(launches=launches, by_path=by_path)


def _profile8_contexts():
    from repro_torch.core.accelerator import CATALOG
    from repro_torch.core.flow import Path
    fc, rx = Path.FUNCTION_CALL, Path.INLINE_NIC_RX
    return [
        (CATALOG["ipsec32"], [(fc, 64, 0.9)]),
        (CATALOG["ipsec32"], [(fc, 1500, 0.9)] * 2),
        (CATALOG["ipsec32"], [(fc, 64, 0.9), (fc, 1500, 0.9)]),
        (CATALOG["synthetic50"], [(fc, 512, 0.9)] * 3),
        (CATALOG["synthetic50"], [(fc, 4096, 0.9)]),
        (CATALOG["aes256"], [(fc, 1024, 0.9)] * 2),
        (CATALOG["sha3_512"], [(rx, 256, 0.9)] * 2),
        (CATALOG["compress"], [(fc, 4096, 0.9), (fc, 64, 0.9),
                               (fc, 1024, 0.9)])]


def phase_profile_batch8(dev) -> dict:
    """sim_perf's eight heterogeneous contexts (ragged 1-3 flows on
    ipsec32 / synthetic50 / aes256 / sha3_512 / compress) through
    ``ProfileTable.profile_contexts``: at PROFILE8_TICKS[0], entries equal
    to eight serial ``profile_context`` calls on the card and exactly one
    new batch entry; at PROFILE8_TICKS[1], the batched call timed alone
    with its launches counted."""
    import dataclasses

    import torch
    from repro_torch.core import engine, profiler
    from repro_torch.kernels.token_bucket import ops
    ctxs = _profile8_contexts()
    quick, full = PROFILE8_TICKS
    engine.cache_clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serial = [profiler.ProfileTable(n_ticks=quick, device=dev)
              .profile_context(a, f) for a, f in ctxs]
    torch.cuda.synchronize()
    serial_s = time.perf_counter() - t0
    before = engine.cache_info()["entries"]
    profiler.profiling_stats_clear()
    batch = profiler.ProfileTable(n_ticks=quick, device=dev) \
        .profile_contexts(ctxs)
    new_entries = engine.cache_info()["entries"] - before
    same = [dataclasses.asdict(e) for e in serial] == \
        [dataclasses.asdict(e) for e in batch]
    stats = profiler.profiling_stats()
    engine.cache_clear()
    torch.cuda.synchronize()
    _reset_launch_counts()
    t1 = time.perf_counter()
    full_entries = profiler.ProfileTable(n_ticks=full, device=dev) \
        .profile_contexts(ctxs)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t1
    launches, by_path = ops.LAUNCHES, dict(ops.LAUNCHES_BY_PATH)
    emit("profile_batch8", contexts=len(ctxs),
         flows=[len(f) for _, f in ctxs], ticks=[quick, full],
         entries_match_serial=same, new_batch_entries=new_entries,
         profiling_stats=stats, serial_wall_s=serial_s,
         batched_wall_s=full_s,
         us_per_batched_tick=full_s / full * 1e6,
         element_ticks_per_s=len(ctxs) * full / full_s,
         grant_tick_launches=launches,
         capacity_gbps=[e.capacity_gbps for e in full_entries])
    if not same:
        raise AssertionError("profile_batch8: batched entries != serial "
                             "profile_context entries")
    if new_entries != 1 or stats["sim_batches"] != 1:
        raise AssertionError(f"profile_batch8: {new_entries} new entries, "
                             f"stats {stats}")
    if launches != full or by_path != dict(step=0, grant_tick=full):
        raise AssertionError(f"profile_batch8: token-bucket launches "
                             f"{by_path} != {full} grant ticks")
    return dict(launches=launches, by_path=by_path)


def _profile_batch_window(dev, B: int, n_ticks: int) -> dict:
    """One window of ``n_ticks`` ticks of fig6's batch cycled to ``B``
    elements through the batch entry's graph (a first window captures it):
    timed alone (µs a tick, element-ticks a second), then under
    torch.profiler (``_trace_window``)."""
    import torch
    from repro_torch.core import baselines as bl
    inp = fig6_inputs(n_ticks, B)

    def window():
        bl.run_system_batch(
            inp["systems"], inp["flows"], inp["accels"], inp["link"],
            n_ticks, tb_states=inp["tb_states"], arr=inp["arr"],
            cfg_overrides=FIG6_OVERRIDES, device=dev)
    window()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    window()
    torch.cuda.synchronize()
    unprofiled = time.perf_counter() - t0
    t = _trace_window(window, n_ticks)
    wall = t.pop("wall_s")
    return dict(batch=B, us_per_tick=unprofiled / n_ticks * 1e6,
                element_ticks_per_s_unprofiled=B * n_ticks / unprofiled,
                element_ticks_per_s=B * n_ticks / wall, **t)


def _trace_window(window, n_ticks: int) -> dict:
    """``window()`` (its entry already captured) under torch.profiler: a
    tick's host µs, device busy µs and device kernels, the device's idle
    share, and the grant tick's launches and device µs a launch (a trace
    that misses a grant-tick launch is taken again, up to three times)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):          # a trace that misses a grant tick: again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            window()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev_us = kernels = tb_us = tb_n = 0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                dev_us += e.time_range.elapsed_us()
                kernels += 1
                if any(pat in e.name
                       for pat in KERNEL_KINDS["token_bucket"]):
                    tb_us += e.time_range.elapsed_us()
                    tb_n += 1
        if tb_n == n_ticks:
            break
    return dict(wall_s=wall, host_us_per_tick=wall / n_ticks * 1e6,
                device_busy_us_per_tick=dev_us / n_ticks,
                device_kernels_per_tick=kernels / n_ticks,
                device_idle_share=max(0.0, 1.0 - dev_us / (wall * 1e6)),
                token_bucket_launches=tb_n,
                token_bucket_device_us_per_launch=tb_us / max(tb_n, 1))


# ---------------------------------------------------------------------------
# the fleet control plane: resource axes, placement, churn, adaptive control
# ---------------------------------------------------------------------------

# resource_parity: ticks of its windows
RESOURCE_TICKS = 150
# benchmarks/contention.py:52-77, uncut: eight synthetic50 servers, 24
# interleaved 5 Gbps tenants (odd ones with a 0.05 memory-bandwidth hint),
# mem_bw(24) and host_dma(48), 6,000 profiling ticks, the dataplane at its
# quick 10,000 ticks
CONTENTION_B = 8
CONTENTION_SLO = 5.0
CONTENTION_MEM_GBPS = 24.0
CONTENTION_DMA_GBPS = 48.0
CONTENTION_PROFILE_TICKS = 6_000
CONTENTION_TICKS = 10_000
# the traced window of contention's dataplane, R = 2 beside R = 0
CONTENTION_TRACE_TICKS = 50
CONTENTION_HEADROOM = 1.05
CONTENTION_FRIENDLY = 0.95
# each arm's placement (benchmarks/results/contention.json, B8)
CONTENTION_DECISIONS = {
    "vector": [0, 1, 2, 3, 4, 5, 6, 7, 1, 3, 5, 7, 3, 0, 7, 2, 4, 6, 1, 0,
               5, 2, 6, 0],
    "axis0": [0, 1, 2, 3, 4, 5, 6, 7, 1, 3, 5, 7, 3, 0, 7, 2, 4, 6, 1, 0,
              5, 2, 6, 0],
    "mem_blind": [0, 1, 2, 3, 4, 5, 6, 7, 0, 1, 2, 3, 4, 5, 6, 7, 0, 1, 2,
                  3, 4, 5, 6, 7]}
# the JAX package's run of the same arms at these ticks on the CPU
CONTENTION_OUTCOMES = {
    "vector": dict(admitted=24, slo_friendly=24, min_measured_gbps=5.3248),
    "axis0": dict(admitted=24, slo_friendly=24, min_measured_gbps=5.3248),
    "mem_blind": dict(admitted=24, slo_friendly=12,
                      min_measured_gbps=3.9935999999999994)}
# benchmarks/churn.py's B8 rate1 (its timeline is the same quick or full)
CHURN_COMPLEMENTS = (["synthetic50"], ["synthetic50", "aes256"],
                     ["synthetic50", "aes256", "ipsec32"])
CHURN_PROFILE_TICKS = 8_000
CHURN_WINDOW = 1_500
CHURN_WINDOWS = 6
# benchmarks/results/churn.json's B8 rate1 (the JAX package's fresh run on
# the CPU gives the same)
CHURN_REFERENCE = dict(
    decisions=[["arrive", 0, 0], ["arrive", 1, 3], ["depart", 0, 0],
               ["arrive", 2, 0], ["depart", 1, 3], ["arrive", 3, 3],
               ["depart", 2, 0]],
    moves=[[900, 0, 6]], ref_gbps_mean=9.774222222222221,
    ref_dev_max_pct=0.9821753364860141, slo_violations=1)
# benchmarks/adaptive.py's churn arm: B = 2, six windows of 1,500 ticks
ADAPTIVE_B = 2
# violation windows and reconfigurations (benchmarks/results/adaptive.json's
# churn arm; the JAX package's fresh run on the CPU gives the same)
ADAPTIVE_REFERENCE = {"static": dict(violations=3, reconfigs=3),
                      "adaptive": dict(violations=1, reconfigs=16)}


def _resource_window_inputs(n_ticks: int, n_flows: int = 4, seed: int = 0):
    """A tight memory-bandwidth axis and a fabric-only host-DMA axis with a
    burst; ``n_flows`` flows of 1024 + 300 i bytes (a fifth 64 B) on
    synthetic50, the odd ones with a 0.05 memory hint, one off-fabric
    (INLINE_NIC_RX)."""
    from repro_torch.core import token_bucket as tb
    from repro_torch.core.accelerator import CATALOG, AccelTable
    from repro_torch.core.flow import (SLO, FlowSet, FlowSpec, Path,
                                       TrafficPattern)
    from repro_torch.core.interconnect import (RES_MEM_BW, LinkSpec,
                                               host_dma, mem_bw)
    from repro_torch.core.sim import SimConfig, gen_arrivals
    specs = [FlowSpec(i, i, Path.FUNCTION_CALL if i % 3
                      else Path.INLINE_NIC_RX, 0,
                      TrafficPattern(1024 + 300 * i, load=0.45,
                                     process="poisson", msg_bytes2=64,
                                     p2=0.2), SLO.gbps(10.0 + 3 * i),
                      res_demand=((RES_MEM_BW, 0.05, 0.05),) if i % 2
                      else ())
             for i in range(n_flows)]
    flows = FlowSet.build(specs)
    cfg = SimConfig(n_ticks=n_ticks)
    arr = gen_arrivals(flows, cfg, seed=seed,
                       load_ref_gbps={i: 40.0 for i in range(n_flows)})
    tbs = tb.pack([tb.params_for_gbps(10.0 + 3 * i)
                   for i in range(n_flows)])
    link = LinkSpec(resources=(mem_bw(20.0), host_dma(37.3, 4096)))
    return flows, AccelTable.build([CATALOG["synthetic50"]]), link, cfg, \
        tbs, arr


def _carries_equal(name: str, a: dict, b: dict) -> None:
    for k in a:
        for x, y in zip(*((t[k] if k == "tb" else (t[k],)) for t in (a, b))):
            if x.tobytes() != y.tobytes():
                raise AssertionError(f"{name}: carry leaf {k} differs")


def phase_resource_parity(dev) -> dict:
    """The resource vector on the card: the grant tick with R = 1-4 extra
    axes (``rehearse.RES_CASES``: B = 1, 8 and 64, k_grant 4 and 8,
    non-dyadic coefficients, egress-only demand, a fabric-only axis,
    budgets around zero) against its plain version bitwise; a window on a
    two-axis link with 0.05 hints through the entry's CUDA graph against
    the CPU and against the eager body on the card (every carry leaf, the
    axes' residue included), over two windows with a register write; a
    ragged two-element batch on that link, CUDA against CPU."""
    import dataclasses

    from repro_torch.core import engine, token_bucket as tb
    from repro_torch.core.sim import simulate_batch, stack_arrivals
    from repro_torch.kernels.token_bucket import ops, rehearse
    cases = []
    for case in rehearse.RES_CASES:
        row = rehearse.check_resources(case, dev)
        if row["launches"] != 1 or row["differ"]:
            raise AssertionError(f"resource grant tick != plain: {row}")
        cases.append(row)
    n = RESOURCE_TICKS
    flows, atab, link, cfg, tbs, arr = _resource_window_inputs(2 * n)
    win = dataclasses.replace(cfg, n_ticks=n)
    tbs2 = tb.pack([tb.params_for_gbps(4.0 + i) for i in range(flows.n)])
    out = {}
    engine.cache_clear()
    n0 = ops.LAUNCHES_BY_PATH["grant_tick"]
    for name, fn, device in (("graph", engine.run_window, dev),
                             ("cpu", engine.run_window, "cpu"),
                             ("eager", engine._run_window_eager, dev)):
        carry, wins = None, []
        for w, regs in enumerate((tbs, tbs2)):
            carry = fn(flows, atab, link, win, regs, *arr, t0_ticks=w * n,
                       carry=carry, device=device)
            wins.append(engine.carry_to_numpy(carry))
        out[name] = wins
        if name == "graph":
            launched = ops.LAUNCHES_BY_PATH["grant_tick"] - n0
            info = engine.cache_info()
    for w in range(2):
        _carries_equal(f"resource window {w}: graph vs CPU",
                       out["graph"][w], out["cpu"][w])
        _carries_equal(f"resource window {w}: graph vs eager",
                       out["graph"][w], out["eager"][w])
    res_res = out["cpu"][1]["res_res"]
    if not (res_res != 0).any() or out["cpu"][1]["comp_n"] <= 0:
        raise AssertionError(f"resource window: axes idle ({res_res})")
    if launched != 2 * n or info != {"entries": 1, "traces": 1}:
        raise AssertionError(f"resource window: {launched} launches, "
                             f"cache {info}")
    els = [_resource_window_inputs(n, k, seed=k) for k in (4, 3)]
    batch = [simulate_batch([e[0] for e in els], atab, link, win,
                            [e[4] for e in els],
                            *stack_arrivals([e[5] for e in els]), device=d)
             for d in (dev, "cpu")]
    for b in range(2):
        _results_equal(f"resource batch element {b}: CUDA vs CPU",
                       batch[0][b], batch[1][b])
    # the grant tick at contention's shape (B = 8, R = 2) and, on the same
    # carry, with no axes: ms a call, device ms a launch, bound
    times = rehearse.time_grant_tick_resources(dev)
    emit("resource_parity", kernel_cases=len(cases),
         kernel_cases_by_axes={str(r): sum(c["case"][1] == r for c in cases)
                               for r in (1, 2, 3, 4)},
         gated_budgets=sum(c["gated"] for c in cases),
         window_ticks=n, windows=2, res_res=res_res.tolist(),
         completions=int(out["cpu"][1]["comp_n"]),
         graph_vs_cpu_bitwise=True, graph_vs_eager_bitwise=True,
         batch_vs_cpu_bitwise=True, grant_tick_launches=launched,
         cache_info=info, times=times)
    return dict(launches=launched, times=times)


def _contention_fleet(arm: str, dev):
    """One control plane of benchmarks/contention.py over a fresh fleet:
    (runtimes, policy); the memory-blind plane profiles the link alone."""
    from repro_torch.core import placement
    from repro_torch.core.accelerator import CATALOG
    from repro_torch.core.interconnect import LinkSpec
    from repro_torch.core.profiler import ProfileTable
    from repro_torch.core.runtime import ArcusRuntime
    link = LinkSpec() if arm == "mem_blind" else _contention_link()
    profile = ProfileTable(link, n_ticks=CONTENTION_PROFILE_TICKS,
                           device=dev)
    rts = [ArcusRuntime([CATALOG["synthetic50"]], link=link,
                        profile_table=profile, device=dev)
           for _ in range(CONTENTION_B)]
    pol = (placement.SLOAware(axis=0) if arm == "axis0"
           else placement.SLOAware())
    return rts, pol


def _contention_link():
    from repro_torch.core.interconnect import LinkSpec, host_dma, mem_bw
    return LinkSpec(resources=(mem_bw(CONTENTION_MEM_GBPS),
                               host_dma(CONTENTION_DMA_GBPS)))


def _contention_tenants():
    """The interleaved stream: bandwidth-bound on even ids (the default
    1.0 / 1.0 demand), compute-bound on odd ids (the 0.05 hint)."""
    from repro_torch.core.flow import SLO, FlowSpec, Path, TrafficPattern
    from repro_torch.core.interconnect import RES_MEM_BW
    return [FlowSpec(i, i, Path.FUNCTION_CALL, 0,
                     TrafficPattern(1024, load=0.5, process="poisson"),
                     SLO.gbps(CONTENTION_SLO),
                     res_demand=() if i % 2 == 0
                     else ((RES_MEM_BW, 0.05, 0.05),))
            for i in range(3 * CONTENTION_B)]


def _contention_inputs(per_server, n_ticks: int):
    """The placed fleet's batched dataplane inputs at ``n_ticks``
    (benchmarks/contention.py ``_run_dataplane``): (flow sets, accelerator
    table, config, registers, stacked arrivals)."""
    from repro_torch.core import token_bucket as tb
    from repro_torch.core.accelerator import CATALOG, AccelTable
    from repro_torch.core.flow import FlowSet
    from repro_torch.core.sim import (SHAPING_HW, SimConfig, gen_arrivals,
                                      stack_arrivals)
    cfg = SimConfig(n_ticks=n_ticks, shaping=SHAPING_HW)
    flows_l, tbs_l, arrs = [], [], []
    for b, specs in enumerate(per_server):
        flows = FlowSet.build(specs)
        flows_l.append(flows)
        tbs_l.append(tb.pack([tb.params_for_gbps(
            CONTENTION_SLO * CONTENTION_HEADROOM) for _ in specs]))
        arrs.append(gen_arrivals(flows, cfg, seed=b + 1, load_ref_gbps={
            i: 32.0 for i in range(flows.n)}))
    return (flows_l, AccelTable.build([CATALOG["synthetic50"]]), cfg, tbs_l,
            stack_arrivals(arrs))


def _contention_dataplane(per_server, dev):
    """One batched window of CONTENTION_TICKS over the placed fleet on the
    vector link: measured ingress Gbps by flow id."""
    from repro_torch.core.sim import simulate_batch
    flows_l, accels, cfg, tbs_l, arr = _contention_inputs(
        per_server, CONTENTION_TICKS)
    res = simulate_batch(flows_l, accels, _contention_link(), cfg, tbs_l,
                         *arr, device=dev)
    return {s.flow_id: float(res[b].mean_ingress_gbps(i, flows_l[b]))
            for b, specs in enumerate(per_server)
            for i, s in enumerate(specs)}


def _contention_trace(per_server, dev) -> dict:
    """The cost of the resource path: one window of CONTENTION_TRACE_TICKS
    of the placed fleet's dataplane on the two-axis link (R = 2) and on
    the default link (R = 0), each through its graph entry (a first window
    captures it) under torch.profiler (``_trace_window``)."""
    from repro_torch.core.interconnect import LinkSpec
    from repro_torch.core.sim import simulate_batch
    flows_l, accels, cfg, tbs_l, arr = _contention_inputs(
        per_server, CONTENTION_TRACE_TICKS)
    out = {}
    for name, link in (("R2", _contention_link()), ("R0", LinkSpec())):
        def window():
            simulate_batch(flows_l, accels, link, cfg, tbs_l, *arr,
                           device=dev)
        window()
        t = _trace_window(window, CONTENTION_TRACE_TICKS)
        del t["wall_s"]
        out[name] = t
    return out


def phase_contention(dev) -> dict:
    """benchmarks/contention.py uncut on the card: the three control planes
    (``vector``: ``SLOAware()`` on the resource-aware fleet; ``axis0``:
    ``SLOAware(axis=0)``; ``mem_blind``: the link-only fleet) place the same
    24 tenants through ``FleetController.place`` (every admission round one
    batched profile of its cache-missing contexts, 6,000 ticks on the
    card), then each placed fleet runs one ``simulate_batch`` of B = 8
    servers on the two-axis link, alone on a cleared cache (one entry, one
    capture, one grant-tick launch a tick).  Decisions against
    contention.json; admitted, SLO-friendly and the least measured rate
    against the JAX package's run; the degenerate gate (huge-capacity axes
    equal the default link) bitwise on the card; one traced window of the
    vector arm's dataplane at R = 2 beside R = 0.  Each placement and each
    dataplane run reads its own launch counts, set to 0 just before it."""
    import torch
    from repro_torch.core import engine, profiler
    from repro_torch.core.controller import FleetController
    from repro_torch.kernels.token_bucket import ops
    arms = {}
    for arm in ("vector", "axis0", "mem_blind"):
        rts, pol = _contention_fleet(arm, dev)
        profiler.profiling_stats_clear()
        _reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        placed = FleetController(rts).place(_contention_tenants(),
                                            policy=pol)
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        place_paths = dict(ops.LAUNCHES_BY_PATH)
        stats = profiler.profiling_stats()
        per_server = [[rt.table[fid].spec for fid in sorted(rt.table)]
                      for rt in rts]
        engine.cache_clear()
        _reset_launch_counts()
        t1 = time.perf_counter()
        measured = _contention_dataplane(per_server, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        by_path = dict(ops.LAUNCHES_BY_PATH)
        info = engine.cache_info()
        arms[arm] = dict(
            admitted=sum(p.accepted for p in placed),
            slo_friendly=sum(m >= CONTENTION_FRIENDLY * CONTENTION_SLO
                             for m in measured.values()),
            min_measured_gbps=min(measured.values()),
            decisions=[p.server if p.accepted else -1 for p in placed],
            tenants_per_server=[len(s) for s in per_server],
            placement_s=place_s, profiling_calls=stats["calls"],
            profiling_batches=stats["sim_batches"],
            profiled_contexts=stats["contexts"],
            score_hits=stats["score_hits"],
            placement_launches_by_path=place_paths,
            dataplane_wall_s=wall,
            us_per_batched_tick=wall / CONTENTION_TICKS * 1e6,
            element_ticks_per_s=CONTENTION_B * CONTENTION_TICKS / wall,
            launches_by_path=by_path, cache_info=info,
            per_server=per_server)
    degenerate = _contention_degenerate(arms, dev)
    engine.cache_clear()
    trace = _contention_trace(arms["vector"].pop("per_server"), dev)
    for d in arms.values():
        d.pop("per_server", None)
    emit("contention", servers=CONTENTION_B,
         tenants=3 * CONTENTION_B, slo_gbps=CONTENTION_SLO,
         mem_gbps=CONTENTION_MEM_GBPS, dma_gbps=CONTENTION_DMA_GBPS,
         profile_ticks=CONTENTION_PROFILE_TICKS, ticks=CONTENTION_TICKS,
         reduced=dict(ticks=[CONTENTION_TICKS, 25_000]), arms=arms,
         degenerate_bitwise=degenerate, traced_window=dict(
             ticks=CONTENTION_TRACE_TICKS, **trace))
    for arm, d in arms.items():
        if d["decisions"] != CONTENTION_DECISIONS[arm]:
            raise AssertionError(f"contention {arm}: decisions "
                                 f"{d['decisions']} != contention.json's")
        got = {k: d[k] for k in CONTENTION_OUTCOMES[arm]}
        if got != CONTENTION_OUTCOMES[arm]:
            raise AssertionError(f"contention {arm}: {got} != the JAX "
                                 f"reference's {CONTENTION_OUTCOMES[arm]}")
        if d["cache_info"] != {"entries": 1, "traces": 1} or \
                d["launches_by_path"] != dict(step=0,
                                              grant_tick=CONTENTION_TICKS):
            raise AssertionError(f"contention {arm}: cache "
                                 f"{d['cache_info']}, launches "
                                 f"{d['launches_by_path']} for "
                                 f"{CONTENTION_TICKS} ticks")
    for name, t in trace.items():
        if t["token_bucket_launches"] != CONTENTION_TRACE_TICKS:
            raise AssertionError(f"contention traced window {name}: {t}")
    return {arm: d["launches_by_path"] for arm, d in arms.items()}


def _contention_degenerate(arms: dict, dev) -> bool:
    """Huge-capacity axes reproduce the default link bitwise on the card:
    the vector arm's server 0 (benchmarks/contention.py
    ``_degenerate_gate``)."""
    from repro_torch.core import token_bucket as tb
    from repro_torch.core.accelerator import CATALOG, AccelTable
    from repro_torch.core.flow import FlowSet
    from repro_torch.core.interconnect import LinkSpec, host_dma, mem_bw
    from repro_torch.core.sim import SimConfig, gen_arrivals, simulate
    tenants = _contention_tenants()
    specs = [tenants[i] for i, b in enumerate(arms["vector"]["decisions"])
             if b == 0]
    flows = FlowSet.build(specs)
    cfg = SimConfig(n_ticks=CONTENTION_TICKS)
    accels = AccelTable.build([CATALOG["synthetic50"]])
    tbs = tb.pack([tb.params_for_gbps(CONTENTION_SLO * CONTENTION_HEADROOM)
                   for _ in specs])
    arr = gen_arrivals(flows, cfg, seed=1,
                       load_ref_gbps={i: 32.0 for i in range(flows.n)})
    inert = LinkSpec(resources=(mem_bw(1e6), host_dma(1e6)))
    r0 = simulate(flows, accels, LinkSpec(), cfg, tbs, *arr, device=dev)
    r1 = simulate(flows, accels, inert, cfg, tbs, *arr, device=dev)
    _results_equal("contention degenerate gate", r0, r1)
    return True


def _churn_controller(profile, dev):
    """benchmarks/churn.py ``_build(8, profile)``: eight servers cycling
    the three complements, each with its long-lived reference tenant."""
    from repro_torch.core.accelerator import CATALOG
    from repro_torch.core.controller import FleetController
    from repro_torch.core.flow import SLO, FlowSpec, Path, TrafficPattern
    from repro_torch.core.runtime import ArcusRuntime
    rts = [ArcusRuntime([CATALOG[n] for n in
                         CHURN_COMPLEMENTS[b % len(CHURN_COMPLEMENTS)]],
                        profile_table=profile, device=dev)
           for b in range(8)]
    ctrl = FleetController(rts)
    ref = [[FlowSpec(1000 + b, 1000 + b, Path.FUNCTION_CALL, 0,
                     TrafficPattern(1024, load=0.35, process="poisson"),
                     SLO.gbps(8.0))] for b in range(8)]
    if not all(all(a) for a in ctrl.admit_fleet(ref)):
        raise AssertionError("churn: reference-tenant admission rejected")
    return ctrl


def _churn_tenant(i: int):
    from repro_torch.core.flow import SLO, FlowSpec, Path, TrafficPattern
    return FlowSpec(i, i, Path.FUNCTION_CALL, 0,
                    TrafficPattern(1024, load=0.4, process="poisson"),
                    SLO.gbps(6.0))


def _churn_timeline(rate: int, n_windows: int) -> list:
    """benchmarks/churn.py ``_timeline``: ``rate`` arrivals a window from
    window 1, each departing two windows after it arrived."""
    from repro_torch.core.controller import TenantEvent
    events, born, nid = [], {}, 0
    for w in range(1, n_windows):
        for fid, bw in sorted(born.items()):
            if bw == w - 2:
                events.append(TenantEvent.depart(w, tenant_id=fid))
                del born[fid]
        if w < n_windows - 1:
            for _ in range(rate):
                events.append(TenantEvent.arrive(
                    w, _churn_tenant(nid), accel_name="synthetic50"))
                born[nid] = w
                nid += 1
    return events


def phase_churn(dev) -> dict:
    """benchmarks/churn.py's B8 ``rate1`` on the card: eight heterogeneous
    servers through ``FleetController.run`` over six windows of 1,500 ticks
    with seven ARRIVE / DEPART events (placed fleet-wide by SLO-aware
    scoring); a warm run on a throwaway clone sharing the ProfileTable
    (8,000 ticks a context), then the timed run on a cleared cache: one
    entry, one capture, no profiling; then a pinned two-tenant burst on
    server 0 and ``rebalance``.  Decisions, moves, the reference tenants'
    mean rate and deviation and the violations against churn.json.  The
    timed run's launch counts are set to 0 just before it and read just
    after: one grant-tick launch a tick."""
    import numpy as np
    import torch
    from repro_torch.core import engine, profiler
    from repro_torch.core.profiler import ProfileTable
    from repro_torch.kernels.token_bucket import ops
    kw = dict(total_ticks=CHURN_WINDOW * CHURN_WINDOWS,
              window_ticks=CHURN_WINDOW, seeds=list(range(8)),
              load_ref_gbps=[{0: 32.0}] * 8,
              events=_churn_timeline(1, CHURN_WINDOWS))
    profile = ProfileTable(n_ticks=CHURN_PROFILE_TICKS, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _churn_controller(profile, dev).run(**kw)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    ctrl = _churn_controller(profile, dev)
    p0 = profiler.profiling_stats()
    engine.cache_clear()
    _reset_launch_counts()
    t1 = time.perf_counter()
    _results, reports = ctrl.run(**kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    by_path = dict(ops.LAUNCHES_BY_PATH)
    info = engine.cache_info()
    p_run = profiler.profiling_stats()
    _reset_launch_counts()
    burst = ctrl.place([_churn_tenant(900 + i) for i in range(2)],
                       pinned=[0, 0], accel_names=["synthetic50"] * 2)
    t2 = time.perf_counter()
    moves = ctrl.rebalance()
    torch.cuda.synchronize()
    rebalance_s = time.perf_counter() - t2
    burst_paths = dict(ops.LAUNCHES_BY_PATH)
    p1 = profiler.profiling_stats()
    ref = np.array([np.mean([w.measured[1000 + b] for w in reports[b]])
                    for b in range(8)])
    got = dict(
        decisions=[[e["kind"], e["tenant"],
                    -1 if e["server"] is None else e["server"]]
                   for e in ctrl.last_events],
        moves=[[m["tenant"], m["src"], m["dst"]] for m in moves],
        ref_gbps_mean=float(ref.mean()),
        ref_dev_max_pct=float(np.max(np.abs(ref - ref.mean()) / ref.mean())
                              * 100),
        slo_violations=sum(len(w.violated) for rep in reports for w in rep))
    ticks = CHURN_WINDOW * CHURN_WINDOWS
    emit("churn", servers=8, rate=1, windows=CHURN_WINDOWS,
         window_ticks=CHURN_WINDOW, events=len(kw["events"]),
         profile_ticks=CHURN_PROFILE_TICKS, **got,
         stats=dict(ctrl.stats), burst_accepted=[p.accepted for p in burst],
         warm_run_s=warm_s, wall_s=wall, rebalance_s=rebalance_s,
         us_per_batched_tick=wall / ticks * 1e6,
         element_ticks_per_s=8 * ticks / wall,
         cache_info=info,
         timed_run_profiled_contexts=p_run["contexts"] - p0["contexts"],
         score_hits=p1["score_hits"] - p0["score_hits"],
         launches_by_path=by_path, burst_rebalance_launches=burst_paths)
    if got != CHURN_REFERENCE:
        raise AssertionError(f"churn: {got} != the reference's "
                             f"{CHURN_REFERENCE}")
    if info != {"entries": 1, "traces": 1} or \
            by_path != dict(step=0, grant_tick=ticks):
        raise AssertionError(f"churn: cache {info}, launches {by_path} "
                             f"for {ticks} ticks")
    if p_run["contexts"] != p0["contexts"] or not all(
            p.accepted for p in burst):
        raise AssertionError(f"churn: the timed run profiled "
                             f"{p_run['contexts'] - p0['contexts']} "
                             "contexts, or the burst was rejected")
    return by_path


def _adaptive_controller(profile, policy, dev):
    """benchmarks/adaptive.py ``_churn_fleet``: two synthetic50 servers,
    each a latency-critical 128 B tenant beside an 8 Gbps reference."""
    from repro_torch.core.accelerator import CATALOG
    from repro_torch.core.controller import FleetController
    from repro_torch.core.flow import SLO, FlowSpec, Path, TrafficPattern
    from repro_torch.core.runtime import ArcusRuntime
    rts = [ArcusRuntime([CATALOG["synthetic50"]], profile_table=profile,
                        device=dev) for _ in range(ADAPTIVE_B)]
    ctrl = FleetController(rts, control=policy)
    specs = [[FlowSpec(2000 + b, 2000 + b, Path.FUNCTION_CALL, 0,
                       TrafficPattern(128, rate_mps=1.0e6,
                                      process="poisson"),
                       SLO.latency(4e-6)),
              FlowSpec(1000 + b, 1000 + b, Path.FUNCTION_CALL, 0,
                       TrafficPattern(1024, load=0.3, process="poisson"),
                       SLO.gbps(8.0))] for b in range(ADAPTIVE_B)]
    if not all(all(a) for a in ctrl.admit_fleet(specs)):
        raise AssertionError("adaptive_churn: admission rejected")
    return ctrl


def _adaptive_events() -> list:
    """benchmarks/adaptive.py ``_churn_events``: a bursty on / off tenant
    per server arrives at window 1 and departs at 4, a second wave
    arrives at 2."""
    from repro_torch.core.controller import TenantEvent
    from repro_torch.core.flow import SLO, FlowSpec, Path, TrafficPattern

    def burster(i):
        return FlowSpec(i, i, Path.FUNCTION_CALL, 0,
                        TrafficPattern(1500, load=0.5, process="onoff",
                                       burst_len=64, duty=0.3),
                        SLO.gbps(6.0))
    ev = []
    for i in range(ADAPTIVE_B):
        ev += [TenantEvent.arrive(1, burster(i), server=i),
               TenantEvent.depart(4, tenant_id=i),
               TenantEvent.arrive(2, burster(100 + i), server=i)]
    return ev


def phase_adaptive_churn(dev) -> dict:
    """benchmarks/adaptive.py's churn arm on the card: ``StaticHold``
    against ``GlobalRetarget(SlackAIMD(), period=3)`` on two servers over
    six windows of 1,500 ticks with bursty churn; each policy warmed on a
    throwaway clone sharing the ProfileTable, then timed on a cleared
    cache (one entry, one capture, launch counts set to 0 just before the
    run and read just after: one grant-tick launch a tick).  Violation
    windows and reconfigurations against the reference's."""
    import torch
    from repro_torch.core import control, engine
    from repro_torch.core.profiler import ProfileTable
    from repro_torch.kernels.token_bucket import ops
    kw = dict(total_ticks=CHURN_WINDOW * CHURN_WINDOWS,
              window_ticks=CHURN_WINDOW, seeds=list(range(ADAPTIVE_B)),
              load_ref_gbps=[{1: 32.0}] * ADAPTIVE_B)
    profile = ProfileTable(n_ticks=CHURN_PROFILE_TICKS, device=dev)
    policies = {"static": control.StaticHold,
                "adaptive": lambda: control.GlobalRetarget(
                    control.SlackAIMD(), period=3)}
    for mk in policies.values():
        _adaptive_controller(profile, mk(), dev).run(
            events=_adaptive_events(), **kw)
    arms = {}
    for name, mk in policies.items():
        ctrl = _adaptive_controller(profile, mk(), dev)
        engine.cache_clear()
        torch.cuda.synchronize()
        _reset_launch_counts()
        t0 = time.perf_counter()
        _res, reports = ctrl.run(events=_adaptive_events(), **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_path = dict(ops.LAUNCHES_BY_PATH)
        arms[name] = dict(
            violations=sum(m.violated for rep in reports for w in rep
                           for m in w.metrics.values()),
            reconfigs=sum(rt.table[f].reconfigs for rt in ctrl.runtimes
                          for f in rt.table),
            wall_s=wall, us_per_batched_tick=wall / kw["total_ticks"] * 1e6,
            cache_info=engine.cache_info(), launches_by_path=by_path)
    emit("adaptive_churn", servers=ADAPTIVE_B, windows=CHURN_WINDOWS,
         window_ticks=CHURN_WINDOW, arms=arms)
    for name, d in arms.items():
        got = {k: d[k] for k in ("violations", "reconfigs")}
        if got != ADAPTIVE_REFERENCE[name]:
            raise AssertionError(f"adaptive_churn {name}: {got} != the "
                                 f"reference's {ADAPTIVE_REFERENCE[name]}")
        if d["cache_info"] != {"entries": 1, "traces": 1} or \
                d["launches_by_path"] != dict(step=0,
                                              grant_tick=kw["total_ticks"]):
            raise AssertionError(f"adaptive_churn {name}: cache "
                                 f"{d['cache_info']}, launches "
                                 f"{d['launches_by_path']} for "
                                 f"{kw['total_ticks']} ticks")
    if arms["adaptive"]["violations"] >= arms["static"]["violations"]:
        raise AssertionError("adaptive_churn: adaptive shaping did not "
                             "reduce violations")
    return {name: d["launches_by_path"] for name, d in arms.items()}


# ---------------------------------------------------------------------------
# workloads: the production-shaped generators and the named scenarios
# ---------------------------------------------------------------------------

# tests/test_workloads.py:84-117: the seven generator patterns' traces at
# 20,000 ticks, seeds 0 and 7 (shape, sha256 of times then sizes)
WORKLOAD_TICKS = 20_000
WORKLOAD_DIGESTS = {
    0: ((7, 1234), "33ac781cceab741f6556bb9abf959eae"
                   "1e31d1569ef644ffacc6c2b79b39f2fd"),
    7: ((7, 1208), "8dee228bcdd48e4da05bf65add80d9a7"
                   "b9b1923cbf36aa8066d58550248fd4a6")}
# workload_parity's batch: one element a pattern, beside a poisson tenant
WORKLOAD_BATCH_TICKS = 500
# benchmarks/scenarios.py, uncut: five scenarios on two servers, eight
# windows of 1,500 ticks, one ProfileTable of 8,000 ticks a context shared
# by every build
SCENARIOS = ("mmpp_surge", "heavy_tail", "diurnal_corr", "flash_crowd",
             "adversarial_probe")
SCENARIO_PROFILE_TICKS = 8_000
# completions before this share of the horizon leave the latency tails
# (benchmarks/scenarios.py:52)
SCENARIO_WARMUP_FRAC = 0.25
# every deterministic field of benchmarks/results/scenarios.json, each
# scenario and arm (the JAX package's fresh run on the CPU gives the same)
SCENARIO_REFERENCE = {
    "mmpp_surge": {
        "static": dict(
            violations=11, lat_violations=0, decisions=[],
            tenant_gbps={"100": 8.298666666666666, "101": 6.8693333333333335,
                         "110": 7.4239999999999995, "111": 7.338666666666667,
                         "1000": 9.386666666666667, "1001": 9.472},
            ref_gbps_mean=9.429333333333332,
            ref_dev_max_pct=0.45248868778281215,
            ref_window_cv_max_pct=22.7573345243469, n=575,
            mean_us=0.3676521739130435, p50_us=0.29200000000000004,
            p99_us=1.48312, p999_us=1.9447520000000067),
        "adaptive": dict(
            violations=11, lat_violations=0, decisions=[],
            tenant_gbps={"100": 8.32, "101": 10.624, "110": 4.437333333333333,
                         "111": 5.866666666666667, "1000": 11.541333333333332,
                         "1001": 9.173333333333332},
            ref_gbps_mean=10.357333333333333,
            ref_dev_max_pct=11.431513903192595,
            ref_window_cv_max_pct=20.283155279253588, n=575,
            mean_us=0.7090295652173912, p50_us=0.41600000000000004,
            p99_us=3.94344, p999_us=4.693864000000008)},
    "heavy_tail": {
        "static": dict(
            violations=19, lat_violations=0, decisions=[],
            tenant_gbps={"100": 5.972729166666667, "101": 4.707729166666667,
                         "110": 6.713791666666666, "111": 7.364041666666667,
                         "1000": 9.408000000000001, "1001": 9.301333333333332},
            ref_gbps_mean=9.354666666666667,
            ref_dev_max_pct=0.5701254275940839,
            ref_window_cv_max_pct=24.390282559811023, n=585,
            mean_us=0.8975794871794871, p50_us=0.256, p99_us=8.85328,
            p999_us=9.437280000000031),
        "adaptive": dict(
            violations=31, lat_violations=0, decisions=[],
            tenant_gbps={"100": 1.8571458333333335, "101": 2.849854166666667,
                         "110": 0.9591458333333334, "111": 3.7972500000000005,
                         "1000": 9.194666666666667, "1001": 9.173333333333334},
            ref_gbps_mean=9.184000000000001,
            ref_dev_max_pct=0.1161440185830495,
            ref_window_cv_max_pct=21.63317204012652, n=584,
            mean_us=0.16806164383561645, p50_us=0.072,
            p99_us=0.8388799999999974, p999_us=1.7662480000000222)},
    "diurnal_corr": {
        "static": dict(
            violations=16, lat_violations=0, decisions=[],
            tenant_gbps={"100": 6.933333333333333, "101": 7.573333333333334,
                         "110": 6.293333333333333, "111": 7.530666666666667,
                         "1000": 9.322666666666667, "1001": 9.578666666666667},
            ref_gbps_mean=9.450666666666667,
            ref_dev_max_pct=1.3544018058690757,
            ref_window_cv_max_pct=22.173457606386567, n=578,
            mean_us=0.5246643598615917, p50_us=0.29200000000000004,
            p99_us=2.7439999999999998, p999_us=3.0578400000000094),
        "adaptive": dict(
            violations=17, lat_violations=0, decisions=[],
            tenant_gbps={"100": 6.933333333333334, "101": 6.5920000000000005,
                         "110": 4.288, "111": 5.930666666666667,
                         "1000": 9.194666666666667, "1001": 9.173333333333332},
            ref_gbps_mean=9.184, ref_dev_max_pct=0.11614401858304954,
            ref_window_cv_max_pct=20.283155279253588, n=580,
            mean_us=0.40176551724137927, p50_us=0.154,
            p99_us=1.7671200000000027, p999_us=2.1347200000000153)},
    "flash_crowd": {
        "static": dict(
            violations=6, lat_violations=0,
            decisions=[['arrive', 300, 0], ['arrive', 301, 1]],
            tenant_gbps={"100": 6.655999999999999, "110": 6.762666666666666,
                         "300": 4.949333333333333, "301": 4.949333333333333,
                         "1000": 9.322666666666667, "1001": 9.472},
            ref_gbps_mean=9.397333333333332,
            ref_dev_max_pct=0.7945516458569878,
            ref_window_cv_max_pct=23.34922676841802, n=584,
            mean_us=0.3873013698630137, p50_us=0.21800000000000003,
            p99_us=3.4535199999999975, p999_us=3.8366960000000025),
        "adaptive": dict(
            violations=6, lat_violations=1,
            decisions=[['arrive', 300, 0], ['arrive', 301, 1]],
            tenant_gbps={"100": 8.576, "110": 7.4879999999999995, "300": 9.728,
                         "301": 8.846222222222222, "1000": 11.541333333333332,
                         "1001": 11.541333333333332},
            ref_gbps_mean=11.541333333333332, ref_dev_max_pct=0.0,
            ref_window_cv_max_pct=18.36115475123148, n=584,
            mean_us=0.9336917808219178, p50_us=0.432, p99_us=7.386359999999979,
            p999_us=8.089020000000001)},
    "adversarial_probe": {
        "static": dict(
            violations=10, lat_violations=0, decisions=[],
            tenant_gbps={"100": 4.096, "110": 4.096, "1000": 9.365333333333332,
                         "1001": 9.450666666666667},
            ref_gbps_mean=9.408, ref_dev_max_pct=0.4535147392290316,
            ref_window_cv_max_pct=22.87044518790476, n=584,
            mean_us=0.33744520547945206, p50_us=0.072, p99_us=2.464,
            p999_us=2.697700000000003),
        "adaptive": dict(
            violations=9, lat_violations=0, decisions=[],
            tenant_gbps={"100": 4.096, "110": 4.096,
                         "1000": 11.541333333333332,
                         "1001": 11.541333333333332},
            ref_gbps_mean=11.541333333333332, ref_dev_max_pct=0.0,
            ref_window_cv_max_pct=18.83638168843618, n=584,
            mean_us=0.320986301369863, p50_us=0.07600000000000001,
            p99_us=2.4187999999999983, p999_us=2.6463960000000055)}}
SCENARIO_PROBE = dict(bucket_bytes=49152, period_s=9.6e-05,
                      period_windows=2)


def _workload_patterns():
    """tests/test_workloads.py's seven digest patterns, with the port."""
    from repro_torch.core.flow import TrafficPattern as TP
    return [
        TP(1024, load=0.3, process="mmpp", params=(("states", (0.25, 2.5)),)),
        TP(1024, load=0.3, process="heavytail",
           params=(("dist", "pareto"), ("alpha", 1.5))),
        TP(1024, load=0.3, process="heavytail",
           params=(("dist", "lognormal"), ("sigma", 1.0))),
        TP(1024, load=0.3, process="diurnal", params=(("amp", 0.8),)),
        TP(1024, load=0.3, process="corrburst",
           params=(("group", 3), ("burst_hz", 50_000.0), ("burst_len", 8))),
        TP(1024, load=0.3, process="flash", params=(("at", 0.3),
                                                    ("mult", 6.0))),
        TP(1024, rate_mps=5e5, process="adversarial",
           params=(("bucket_bytes", 32 * 1024), ("period_s", 96e-6))),
    ]


def _trace_digest(t, s):
    import hashlib

    import numpy as np
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(t.astype("<i4")).tobytes())
    h.update(np.ascontiguousarray(s.astype("<i4")).tobytes())
    return t.shape, h.hexdigest()


def phase_workload_parity(dev) -> dict:
    """The production-shaped generators through the port: the seven
    patterns' traces (``make_trace``, numpy) against the reference's pinned
    digests, then one ``simulate_batch`` of seven elements (one a pattern,
    each beside a 1 KiB poisson tenant, hardware shaping at 6 Gbps) on the
    card: bitwise equal to the same batch on the CPU, and the window's
    CUDA graph bitwise equal to its eager body on the card.  Launch counts
    set to 0 just before the card's ``simulate_batch`` and read just
    after: one grant-tick launch a tick."""
    import torch
    from repro_torch.core import engine, token_bucket as tb
    from repro_torch.core.accelerator import CATALOG, AccelTable
    from repro_torch.core.flow import (SLO, FlowSet, FlowSpec, Path,
                                       TrafficPattern)
    from repro_torch.core.interconnect import LinkSpec
    from repro_torch.core.sim import SimConfig, simulate_batch, stack_arrivals
    from repro_torch.kernels.token_bucket import ops
    from repro_torch.workloads.generators import make_trace
    pats = _workload_patterns()
    digests = {}
    for seed, want in WORKLOAD_DIGESTS.items():
        got = _trace_digest(*make_trace(pats, n_ticks=WORKLOAD_TICKS,
                                        seed=seed))
        digests[seed] = [list(got[0]), got[1]]
        if got != want:
            raise AssertionError(f"workload_parity: seed {seed} traces "
                                 f"{got} != the pinned {want}")
    n = WORKLOAD_BATCH_TICKS
    cfg = SimConfig(n_ticks=n)
    probe = TrafficPattern(1024, load=0.3, process="poisson")
    flows, arrs = [], []
    for b, pat in enumerate(pats):
        flows.append(FlowSet.build([
            FlowSpec(i, i, Path.FUNCTION_CALL, 0, p, SLO.gbps(6.0))
            for i, p in enumerate((pat, probe))]))
        arrs.append(make_trace([pat, probe], n_ticks=n, seed=b))
    regs = [tb.pack([tb.params_for_gbps(6.0)] * 2) for _ in pats]
    args = (flows, AccelTable.build([CATALOG["synthetic50"]]), LinkSpec(),
            cfg, regs, *stack_arrivals(arrs))
    engine.cache_clear()
    torch.cuda.synchronize()
    _reset_launch_counts()
    t0 = time.perf_counter()
    card = simulate_batch(*args, device=dev)
    wall = time.perf_counter() - t0
    by_path = dict(ops.LAUNCHES_BY_PATH)
    info = engine.cache_info()
    cpu = simulate_batch(*args, device="cpu")
    for b, (c, g) in enumerate(zip(cpu, card)):
        _results_equal(f"workload_parity element {b} CUDA vs CPU", c, g)
    graph = engine.carry_to_numpy(engine.run_window_batch(*args,
                                                          device=dev))
    eager = engine.carry_to_numpy(engine._run_window_batch_eager(
        *args, device=dev))
    for k, v in graph.items():
        for a, x in zip(*((t[k] if k == "tb" else (t[k],))
                          for t in (graph, eager))):
            if a.tobytes() != x.tobytes():
                raise AssertionError(f"workload_parity: graph != eager "
                                     f"body on {k}")
    sizes = [int(s.max()) for _, s in arrs]
    emit("workload_parity", patterns=[p.process for p in pats],
         digest_ticks=WORKLOAD_TICKS, digests=digests, batch=len(pats),
         ticks=n, max_msg_bytes=sizes,
         admitted=[int(r.counters["c_adm_msgs"].sum()) for r in card],
         completions=[int(r.comp_flow.size) for r in card],
         cuda_vs_cpu_bitwise=True, graph_vs_eager_bitwise=True,
         wall_s=wall, us_per_batched_tick=wall / n * 1e6, cache_info=info,
         launches_by_path=by_path)
    if by_path != dict(step=0, grant_tick=n) or \
            info != {"entries": 1, "traces": 1}:
        raise AssertionError(f"workload_parity: cache {info}, launches "
                             f"{by_path} for {n} ticks")
    # elements 1 and 2 are the heavy-tailed ones (mean 1 KiB)
    if not all(r.comp_flow.size for r in card) or min(sizes[1:3]) <= 1024:
        raise AssertionError(f"workload_parity: an element completed "
                             f"nothing, or the heavy tails drew no size "
                             f"above 1 KiB: {sizes}")
    return by_path


@contextlib.contextmanager
def _profiling_timer():
    """Seconds spent in the profiler's batched simulations (synchronised
    wall clock around each ``simulate_batch`` that ``profile_contexts_multi``
    runs)."""
    import torch
    from repro_torch.core import profiler
    rec = dict(s=0.0, batches=0)
    inner = profiler.simulate_batch

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a, **kw)
        torch.cuda.synchronize()
        rec["s"] += time.perf_counter() - t0
        rec["batches"] += 1
        return out
    profiler.simulate_batch = timed
    try:
        yield rec
    finally:
        profiler.simulate_batch = inner


def _scenario_stats(spec, built, results, reports) -> dict:
    """benchmarks/scenarios.py:59-128 and benchmarks/common.py:62-81 on
    the port's run: violation windows (all, latency), the lifecycle
    decisions, each rate tenant's mean measured rate, the reference
    tenants' (ids 1000+b) cross-server deviation and worst cross-window CV
    (window 0 left out), and the latency probes' (lane 1) tails past the
    warm-up cut (``np.percentile``'s default interpolation)."""
    import numpy as np
    from repro_torch.core.flow import SLOKind
    lat_kind = int(SLOKind.LATENCY)
    metrics = [m for rep in reports for w in rep
               for m in w.metrics.values()]
    acc: dict = {}
    for m in metrics:
        if m.kind != lat_kind:
            acc.setdefault(m.flow_id, []).append(m.measured)
    per = [np.array([w.measured[1000 + b] for w in reports[b]])
           for b in range(spec.servers)]
    mean_b = np.array([p.mean() for p in per])
    lat = np.concatenate([
        r.comp_lat_s[(r.comp_flow == 1)
                     & (r.comp_t_s >= SCENARIO_WARMUP_FRAC * r.seconds)]
        for r in results]).astype(float)
    out = dict(
        violations=sum(m.violated for m in metrics),
        lat_violations=sum(m.violated for m in metrics
                           if m.kind == lat_kind),
        decisions=[[e["kind"], e["tenant"],
                    -1 if e["server"] is None else e["server"]]
                   for e in built.controller.last_events],
        tenant_gbps={str(f): float(np.mean(v))
                     for f, v in sorted(acc.items())},
        ref_gbps_mean=float(mean_b.mean()),
        ref_dev_max_pct=float(np.max(np.abs(mean_b - mean_b.mean())
                                     / mean_b.mean()) * 100),
        ref_window_cv_max_pct=float(max(
            np.std(p[1:]) / max(np.mean(p[1:]), 1e-12) * 100 for p in per)),
        n=int(lat.size), mean_us=float(np.mean(lat) * 1e6))
    for q, key in ((50, "p50_us"), (99, "p99_us"), (99.9, "p999_us")):
        out[key] = float(np.percentile(lat, q) * 1e6)
    return out


def phase_scenarios(dev) -> dict:
    """benchmarks/scenarios.py's run, uncut, through the port on the card:
    the five named scenarios (``repro_torch.workloads``) on two servers,
    eight windows of 1,500 ticks, each under ``StaticHold`` and under
    ``GlobalRetarget(SlackAIMD(), period=3)``, every build sharing one
    ProfileTable of 8,000 ticks a context.  Both arms are built (admission
    profiling timed), then each runs on a cleared cache with its launch
    counts set to 0 just before the run and read just after: one entry,
    one capture, 12,000 grant-tick launches, nothing profiled.
    ``flash_crowd``'s opportunists arrive at window 2 and their admission
    profiles a context inside ``run``; a throwaway static build and run of
    its first three windows (the arrival included) warms that context
    first, as the benchmark warms every context with a throwaway run.
    Every deterministic field of each arm (and the prober's burst size and
    period) against scenarios.json's."""
    import dataclasses

    import torch
    from repro_torch import workloads as wl
    from repro_torch.core import control, engine, profiler
    from repro_torch.core.profiler import ProfileTable
    from repro_torch.kernels.token_bucket import ops
    policies = {"static": control.StaticHold,
                "adaptive": lambda: control.GlobalRetarget(
                    control.SlackAIMD(), period=3)}
    profile = ProfileTable(n_ticks=SCENARIO_PROFILE_TICKS, device=dev)
    out = {}
    for name in SCENARIOS:
        spec = wl.get_scenario(name)
        p0 = profiler.profiling_stats()
        with _profiling_timer() as prof:
            t0 = time.perf_counter()
            built = {arm: spec.build(control=mk(), profile=profile,
                                     device=dev)
                     for arm, mk in policies.items()}
            build_s = time.perf_counter() - t0
            warm_s = 0.0
            if spec.events is not None:
                t1 = time.perf_counter()
                dataclasses.replace(spec, n_windows=3).build(
                    profile=profile, device=dev).run()
                torch.cuda.synchronize()
                warm_s = time.perf_counter() - t1
        p1 = profiler.profiling_stats()
        arms = {}
        for arm, b in built.items():
            engine.cache_clear()
            torch.cuda.synchronize()
            _reset_launch_counts()
            t2 = time.perf_counter()
            results, reports = b.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t2
            by_path = dict(ops.LAUNCHES_BY_PATH)
            info = engine.cache_info()
            arms[arm] = dict(
                _scenario_stats(spec, b, results, reports),
                wall_s=wall, us_per_batched_tick=wall / spec.total_ticks
                * 1e6, cache_info=info, launches_by_path=by_path)
        p2 = profiler.profiling_stats()
        row = dict(servers=spec.servers, windows=spec.n_windows,
                   window_ticks=spec.window_ticks,
                   total_ticks=spec.total_ticks,
                   profiled_contexts=p1["contexts"] - p0["contexts"],
                   profiling_s=prof["s"], profiling_batches=prof["batches"],
                   build_s=build_s, warm_run_s=warm_s,
                   timed_runs_profiled_contexts=p2["contexts"]
                   - p1["contexts"], arms=arms)
        if name == "adversarial_probe":
            adv = spec.tenants(spec)[0][2].pattern    # [ref, lat, prober]
            row["probe"] = dict(
                bucket_bytes=int(adv.param("bucket_bytes")),
                period_s=float(adv.param("period_s")),
                period_windows=int(round(adv.param("period_s")
                                         / spec.window_s())))
        emit("scenarios", scenario=name, **row)
        out[name] = row
        for arm, d in arms.items():
            got = {k: d[k] for k in SCENARIO_REFERENCE[name][arm]}
            if got != SCENARIO_REFERENCE[name][arm]:
                bad = {k: (v, SCENARIO_REFERENCE[name][arm][k])
                       for k, v in got.items()
                       if v != SCENARIO_REFERENCE[name][arm][k]}
                raise AssertionError(f"scenarios {name} {arm}: (port, "
                                     f"reference) differ on {bad}")
            if d["cache_info"] != {"entries": 1, "traces": 1} or \
                    d["launches_by_path"] != dict(
                        step=0, grant_tick=spec.total_ticks):
                raise AssertionError(
                    f"scenarios {name} {arm}: cache {d['cache_info']}, "
                    f"launches {d['launches_by_path']} for "
                    f"{spec.total_ticks} ticks")
        if row["timed_runs_profiled_contexts"]:
            raise AssertionError(
                f"scenarios {name}: the timed runs profiled "
                f"{row['timed_runs_profiled_contexts']} contexts")
        if row.get("probe", SCENARIO_PROBE) != SCENARIO_PROBE:
            raise AssertionError(f"scenarios {name}: probe {row['probe']} "
                                 f"!= the reference's {SCENARIO_PROBE}")
    return {f"{name}.{arm}": d["launches_by_path"]
            for name, row in out.items() for arm, d in row["arms"].items()}


# ---------------------------------------------------------------------------
# serving: gemma3-12b at full width
# ---------------------------------------------------------------------------


def _kernel_ops() -> dict:
    """The wrapper module of each kernel, by the kernel table's name."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.token_bucket import ops as tb
    return dict(token_bucket=tb, decode_attention=da, flash_prefill=fp,
                ssd_scan=ssd)


def _launch_counts() -> dict:
    return {name: m.LAUNCHES for name, m in _kernel_ops().items()}


def attention_launches(cfg) -> dict:
    """Attention kernel launches of one call of a model of ``cfg``, by
    layer role: ``decode``, decode attention a decode step (one a
    self-attention, ``cross`` or ``xattn`` layer); ``causal``, ``encoder``
    and ``memory``, flash prefill a prefill (one causal a self-attention
    layer, one over the F frames an encoder layer, one against the F
    memory rows a ``cross`` or ``xattn`` layer)."""
    from repro_torch.models.transformer import ATTN_KINDS, has_xattn
    kinds = cfg.layer_kinds()
    causal = sum(k in ATTN_KINDS for k in kinds)
    memory = kinds.count("cross") + sum(has_xattn(cfg, k) for k in kinds)
    return dict(decode=causal + memory, causal=causal,
                encoder=cfg.encoder_layers, memory=memory)


def prefill_masks(cfg, prompts) -> dict:
    """Flash-prefill launches by ``LAUNCHES_BY_MASK`` key of one prefill
    of each prompt length in ``prompts``.  The wrapper files a non-causal
    launch by its shape, so a memory layer's launch is ``full`` (Sq = Sk)
    for a prompt F tokens long and ``full_cross`` for any other."""
    per = attention_launches(cfg)
    out = dict(causal=0, full=0, full_cross=0)
    for n in prompts:
        out["causal"] += per["causal"]
        out["full"] += per["encoder"]
        out["full" if n == cfg.frontend_len else "full_cross"] += \
            per["memory"]
    return out


def _reset_launch_counts() -> None:
    for m in _kernel_ops().values():
        m.LAUNCHES = 0
        for split in ("LAUNCHES_BY_PATH", "LAUNCHES_BY_MASK",
                      "LAUNCHES_WITH_LSE", "LAUNCHES_WITH_SPREV",
                      "PLAIN_CALLS"):
            for key in getattr(m, split, {}):
                getattr(m, split)[key] = 0


def _instrument(engine, keep_logits: bool = False) -> dict:
    """Count and time (synchronised wall clock) the engine's prefill and
    decode calls, check their logits are finite, and optionally keep a
    copy of every call's logits."""
    import torch
    rec = dict(prefills=0, decodes=0, prefill_s=0.0, decode_s=0.0,
               finite=True, logits=[])
    pre, dec = engine._prefill, engine._decode

    def timed(kind, fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        logits = out[0] if kind == "prefill" else out
        rec["finite"] &= bool(torch.isfinite(logits).all())
        torch.cuda.synchronize()
        rec[kind + "_s"] += time.perf_counter() - t0
        rec[kind + "s"] += 1
        if keep_logits:
            rec["logits"].append((kind, logits.clone()))
        return out
    engine._prefill = lambda *a: timed("prefill", pre, *a)
    engine._decode = lambda *a: timed("decode", dec, *a)
    return rec


def _scheduler(model, dev, *, arch, max_batch, max_len, mix, plain=False,
               keep_logits=False, long_prompt=LONG_PROMPT, shadow=None,
               tape=None):
    """An ArcusScheduler (token-bucket kernel on) over a fresh engine, with
    ``mix`` submitted: ``"serve"`` is ``launch/serve.py``'s mix (two
    reserved tenants of 1200 and 800 tokens/s, an opportunistic background
    tenant), ``"long"`` is LONG_REQUESTS prompts of ``long_prompt`` tokens
    for one opportunistic tenant.  The clock is ``arch``'s full config's
    cost model on one H100 (``HardwareSpec()``), whatever the depth run, as
    the launcher clocks its reduced model by the full config.  ``shadow``
    (a list) receives, for every prefill and decode call, the call's logits
    and those of the plain versions run on a copy of the cache the call
    started from (``_shadow_plain``), with ``tape`` (a ``RoutingTape``)
    pinning the plain calls' MoE routing to the kernels' call's; then the
    engine decodes through its eager body (the graph is held against it by
    ``_decode_graph_parity``), where the tape records every call."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve as S
    from repro_torch.serving.costmodel import HardwareSpec, StepCostModel
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ArcusScheduler
    engine = ServingEngine(model.cfg, model, max_batch=max_batch,
                           max_len=max_len, device=dev,
                           plain_kernels=plain)
    if tape is not None:
        engine._decode = engine._decode_eager
    rec = _instrument(engine, keep_logits)
    if shadow is not None:
        _shadow_plain(engine, shadow, tape)
    cost = StepCostModel(get_config(arch), HardwareSpec())
    if mix == "serve":
        sched = ArcusScheduler(engine, S.make_tenants([1200.0, 800.0], True),
                               cost, use_kernel=True)
        n = S.submit_mix(sched, model.cfg.vocab, 2, 3.0, True)
    else:
        sched = ArcusScheduler(engine, S.make_tenants([], True), cost,
                               use_kernel=True)
        rng = np.random.default_rng(1)
        for n in range(LONG_REQUESTS):
            sched.submit(Request(n, 0, list(rng.integers(
                0, model.cfg.vocab, long_prompt)), LONG_NEW))
        n = LONG_REQUESTS
    rounds = [0]
    step = sched.step

    def counted_step():
        rounds[0] += 1
        return step()
    sched.step = counted_step
    return sched, rec, rounds, n


def _shadow_plain(engine, pairs: list, tape=None) -> None:
    """Wrap the engine's prefill and decode so that each call also runs the
    model's plain versions on a copy of the cache it starts from, and
    append (kind, logits, plain logits) to ``pairs``: the kernels against
    their plain versions on the same inputs at every call.  The plain calls
    launch no kernel.  With ``tape``, the plain call takes the MoE routing
    that the kernels' call chose (``repro_torch.models.routing``)."""
    from repro_torch.models import transformer as T
    model = engine.params
    pre, dec = engine._prefill, engine._decode

    def copy(cache):
        return [tuple(t.clone() for t in layer) for layer in cache]

    def shadowed(kind, call, plain_call, cache, *args, after=()):
        snap = copy(cache)
        if tape is not None:
            tape.record()
        out = call(*args, cache, *after)
        if tape is not None:
            tape.replay()
        want = plain_call(model, *args, snap, *after, plain=True)
        if tape is not None:
            tape.stop()
        pairs.append((kind, out[0] if kind == "prefill" else out,
                      want[0] if kind == "prefill" else want))
        return out

    def prefill(tok, cache, frontend=None):
        return shadowed("prefill", pre, T.prefill, cache, tok,
                        after=(frontend,))

    def decode(tok, ln, cache):
        return shadowed("decode", dec, T.decode_step, cache, tok, ln)
    engine._prefill, engine._decode = prefill, decode


def _logits_within(name, pairs) -> float:
    """Every (kind, a, b) within LOGIT_RTOL / LOGIT_ATOL; the largest
    difference."""
    worst = 0.0
    for i, (kind, a, b) in enumerate(pairs):
        a, b = a.float(), b.float()
        diff = (a - b).abs()
        worst = max(worst, float(diff.max()))
        bad = diff > LOGIT_ATOL + LOGIT_RTOL * b.abs()
        if bool(bad.any()):
            raise AssertionError(
                f"{name}: {kind} call {i}: {int(bad.sum())} logits differ, "
                f"max {float(diff.max())}")
    return worst


def _counted(drive) -> dict:
    """Run ``drive()`` with every launch count and the peak memory set to 0
    just before; the wall s, peak memory, launches and launches by kernel
    path and by mask just after."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = time.perf_counter()
    drive()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ops = _kernel_ops()
    return dict(wall_s=wall,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                launches=_launch_counts(),
                flash_prefill_paths=dict(
                    ops["flash_prefill"].LAUNCHES_BY_PATH),
                flash_prefill_masks=dict(
                    ops["flash_prefill"].LAUNCHES_BY_MASK),
                ssd_scan_paths=dict(ops["ssd_scan"].LAUNCHES_BY_PATH),
                token_bucket_paths=dict(ops["token_bucket"].LAUNCHES_BY_PATH))


def _check_serving(name, model, rec, run, expect, n_req, finished,
                   expect_masks=None) -> None:
    """The fields and checks both serving drivers share, on ``run``
    (``_counted``'s): every one of ``n_req`` requests finished with finite
    logits, each kernel launched ``expect`` times (flash prefill by mask
    ``expect_masks`` times, where given), and in a bf16 model every
    flash-prefill and SSD-scan launch on the tensor-core path."""
    launches = run["launches"]
    run.update(layers=model.cfg.n_layers, requests=n_req, finished=finished,
               prefills=rec["prefills"], decode_steps=rec["decodes"],
               ms_per_prefill=rec["prefill_s"] / max(rec["prefills"], 1)
               * 1e3,
               ms_per_decode_step=rec["decode_s"] / max(rec["decodes"], 1)
               * 1e3,
               launches_expected=expect)
    if expect_masks is not None:
        run["flash_prefill_masks_expected"] = expect_masks
    if not rec["finite"]:
        raise AssertionError(f"{name}: non-finite logits")
    if finished != n_req:
        raise AssertionError(f"{name}: {finished} of {n_req} requests "
                             "finished")
    if launches != expect or not all(
            v > 0 for k, v in launches.items() if expect[k]):
        raise AssertionError(f"{name}: launches {launches} != {expect}")
    if expect_masks is not None and \
            run["flash_prefill_masks"] != expect_masks:
        raise AssertionError(f"{name}: flash-prefill launches by mask "
                             f"{run['flash_prefill_masks']} != "
                             f"{expect_masks}")
    # the models' q, k, v and x, B, C are bf16: every flash-prefill and
    # SSD-scan launch is the tensor-core kernel's
    if model.cfg.dtype == "bfloat16":
        for kname in ("flash_prefill", "ssd_scan"):
            paths = run[f"{kname}_paths"]
            if paths["tensor_core"] != launches[kname]:
                raise AssertionError(f"{name}: {kname} off the tensor-core "
                                     f"path: {paths}")


def _run_path(name, model, dev, **kw) -> dict:
    """Drive one serving path with the launch counts set to 0 just before
    and read just after; check every request finished, the logits were
    finite and each kernel launched once for each layer of its kind in each
    call: decode attention per decode step and flash prefill per prefill
    for each attention layer, the SSD scan per prefill for each ``ssd``
    layer, the token bucket once per prefill and once per round."""
    import numpy as np
    max_rounds = kw.pop("max_rounds", 2000)
    duration = kw.pop("duration", 3.0)
    sched, rec, rounds, n_req = _scheduler(model, dev, **kw)
    run = _counted(lambda: sched.run(duration, max_rounds=max_rounds))
    n_ssd = model.cfg.layer_kinds().count("ssd")
    n_attn = attention_launches(model.cfg)["decode"]
    expect = dict(token_bucket=rec["prefills"] + rounds[0],
                  decode_attention=rec["decodes"] * n_attn,
                  flash_prefill=rec["prefills"] * n_attn,
                  ssd_scan=rec["prefills"] * n_ssd)
    if kw.get("plain", False):
        expect.update(decode_attention=0, flash_prefill=0, ssd_scan=0)
    run.update(rounds=rounds[0], virtual_s=sched.now_s,
               longest_sequence=int(sched.engine.lengths.max()),
               tenants={str(t): dict(
                   served_tokens=st.served_tokens, finished=st.finished,
                   p99_ttft_ms=(float(np.percentile(st.ttft, 99)) * 1e3
                                if st.ttft else None))
                   for t, st in sorted(sched.stats.items())})
    _check_serving(name, model, rec, run, expect, n_req,
                   sum(st.finished for st in sched.stats.values()))
    # the scheduler's buckets take the step kernel, never the grant tick
    tb_paths = run["token_bucket_paths"]
    if tb_paths != dict(step=run["launches"]["token_bucket"], grant_tick=0):
        raise AssertionError(f"{name}: token-bucket launches {tb_paths}")
    run["sched"], run["rec"] = sched, rec
    return run


def _public(run: dict) -> dict:
    return {k: v for k, v in run.items() if k not in ("sched", "rec")}


#: kernel-name patterns of each kind in a profile (cuBLAS's Hopper GEMMs
#: are named nvjet_*)
KERNEL_KINDS = {
    # first: the backward's names hold their files', ssd_scan_(tc_)bwd
    "ssd_backward": ("bwd_chunk_kernel", "bwd_state_pass_kernel",
                     "bwd_head_kernel", "bwd_dcb_sum_kernel",
                     "bwd_group_kernel", "tcb_chunk_kernel",
                     "tcb_state_pass_kernel", "tcb_head_slice_kernel",
                     "tcb_group_kernel"),
    "decode_attention": ("decode_attention_cluster",),
    "flash_prefill": ("flash_prefill",),
    "ssd_scan": ("ssd_scan", "ssd_chunk_kernel", "ssd_state_pass_kernel",
                 "ssd_output_kernel"),
    "token_bucket": ("tb_step", "tb_grant_tick"),
    "flash_backward": ("flash_backward",),
    # the backward's kernels apart (device_ms_per_launch; a profile files
    # them all under flash_backward, the first kind that matches): dQ, the
    # dK / dV partial sums, their reduction (dK / dV's too)
    "flash_backward_dq": ("flash_backward_dq",),
    "flash_backward_dkdv": ("flash_backward_dkdv_tc",
                            "flash_backward_dkdv_kernel"),
    "flash_backward_dkdv_reduce": ("flash_backward_dkdv_reduce",),
    "gemm": ("nvjet", "gemm", "gemv", "cutlass", "xmma", "splitK"),
    "elementwise": ("elementwise", "vectorized", "unrolled"),
    "reduce": ("reduce",),
    "copy": ("copy", "Memcpy", "Memset", "scatter", "gather", "index"),
}


def _profile(fn, calls: int) -> dict:
    """torch.profiler over ``calls`` calls of ``fn``: wall and device busy
    ms a call, the device's idle share, device ms a call by kind of kernel
    and the costliest kernels by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kind: dict[str, float] = {}
    by_name: dict[str, float] = {}
    busy = kernels = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3 / calls
            busy += ms
            kernels += 1
            kind = next((k for k, pats in KERNEL_KINDS.items()
                         if any(p in e.name for p in pats)), "other")
            by_kind[kind] = by_kind.get(kind, 0.0) + ms
            by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + ms
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    return dict(calls=calls, wall_ms=wall / calls * 1e3,
                device_busy_ms=busy, device_idle_share=max(
                    0.0, 1.0 - busy / (wall / calls * 1e3)),
                device_kernels=kernels / calls, device_ms_by_kind=by_kind,
                top_kernels_ms=top)


def _profile_serving(model, dev, long_prompt=LONG_PROMPT) -> dict:
    """Where a decode step and a prefill spend their time: 4 decode steps
    of a full batch (8 requests with 64-token prompts, max_len 256) through
    the engine's decode graph, then 4 through its eager body, and the
    prefill of one ``long_prompt``-token prompt (max_len 2048); each
    request with its frontend embeddings where the arch has a frontend."""
    import numpy as np
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(2)
    fes = _frontends(model.cfg, 9, dev, seed=2)
    engine = ServingEngine(model.cfg, model, max_batch=8, max_len=256,
                           device=dev)
    for i in range(8):
        engine.admit(Request(i, 0, list(rng.integers(0, model.cfg.vocab,
                                                     64)), 64), fes[i])
    engine.step()
    decode = _profile(engine.step, 4)
    engine._decode = engine._decode_eager
    engine.step()
    decode_eager = _profile(engine.step, 4)
    del engine
    engine = ServingEngine(model.cfg, model, max_batch=1, max_len=2048,
                           device=dev)
    prompt = list(rng.integers(0, model.cfg.vocab, long_prompt))

    def prefill():
        engine.active[:] = False
        engine.admit(Request(0, 0, prompt, 2), fes[8])
    prefill()
    return {"decode_step": decode, "decode_step_eager": decode_eager,
            f"prefill_{long_prompt}": _profile(prefill, 2)}


def _full_model(arch: str, dev, n_layers: int | None = None):
    """``arch``'s config at full width (``n_layers`` of depth, or all) with
    random weights drawn on the card: (model, seconds to draw, GiB)."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    t0 = time.perf_counter()
    model = T.init_model(SERVE_SEED, cfg, device=dev)
    torch.cuda.synchronize()
    gib = sum(p.numel() * p.element_size()
              for p in model.parameters()) / 2**30
    return model, time.perf_counter() - t0, gib


def _emit_serve(phase: str, arch: str, model, init_s, gib, run, prof
                ) -> None:
    from repro_torch.models import module
    cfg = model.cfg
    emit(phase, arch=arch, n_layers=cfg.n_layers,
         layer_kinds={k: cfg.layer_kinds().count(k)
                      for k in sorted(set(cfg.layer_kinds()))},
         moe_layers=sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers)),
         d_model=cfg.d_model, vocab=cfg.vocab,
         params=module.param_count(model), weights_gib=gib, init_s=init_s,
         max_batch=8, max_len=256, **_public(run), profile=prof)


def phase_serve(dev) -> tuple:
    """gemma3-12b at full width and depth, random weights drawn on the card:
    the launcher's mix through ArcusScheduler(use_kernel=True)."""
    model, init_s, gib = _full_model(SERVE_ARCH, dev)
    run = _run_path("serve", model, dev, arch=SERVE_ARCH, max_batch=8,
                    max_len=256, mix="serve")
    prof = _profile_serving(model, dev)
    _emit_serve("serve", SERVE_ARCH, model, init_s, gib, run, prof)
    return model, run, prof


def phase_serve_long(dev, model) -> dict:
    """The same model over prompts longer than the 1024-token window: the
    prefill keeps the last 1024 positions in the local caches and decode
    wraps their rolling slots."""
    run = _run_path("serve_long", model, dev, arch=SERVE_ARCH,
                    max_batch=LONG_REQUESTS, max_len=2048, mix="long")
    if run["longest_sequence"] <= model.cfg.window:
        raise AssertionError(f"serve_long stayed inside the window: "
                             f"{run['longest_sequence']}")
    emit("serve_long", prompt=LONG_PROMPT, new_tokens=LONG_NEW,
         window=model.cfg.window, max_batch=LONG_REQUESTS, max_len=2048,
         **_public(run))
    return run


def _kernels_vs_plain(name, cut, dev, arch, long_prompt, max_rounds=2000,
                      same_inputs=False, long_len=2048,
                      serve_s=PARITY_SERVE_S,
                      pin_routing=False) -> dict:
    """Both mixes through the kernels and through their plain versions on
    ``cut``: the same tokens, equal stats and virtual time, and logits
    within one bf16 ulp of their scale (LOGIT_RTOL / LOGIT_ATOL) at every
    prefill and decode.  With ``same_inputs`` the logits of each call are
    held against the plain versions run on a copy of the cache that call
    started from (``_shadow_plain``), and the drift between the two
    independent runs is reported, not held: a model with a recurrent state
    carries any rounding difference forward, and two runs that differ only
    in the order of float32 sums drift apart at small logits.  The long
    mix's engine holds ``long_len`` positions; the serve mix runs
    ``serve_s`` seconds of virtual time.  ``pin_routing`` (a model with MoE
    layers; implies ``same_inputs``) runs each call's plain versions on the
    MoE routing of the kernels' call (``repro_torch.models.routing``) and
    reports how often the plain call's own routing moved; the two
    independent runs can then route a token differently, so their tokens
    are reported, not held (their statistics, which the token values do
    not touch, are)."""
    import dataclasses
    import torch
    from repro_torch.models import routing
    same_inputs |= pin_routing
    report = {}
    for mix, max_batch, max_len, secs in (
            ("serve", 8, 256, serve_s), ("long", LONG_REQUESTS, long_len, 3.0)):
        shadow = [] if same_inputs else None
        tape = routing.RoutingTape(cut) if pin_routing else None
        common = dict(arch=arch, max_batch=max_batch, max_len=max_len,
                      mix=mix, keep_logits=True, long_prompt=long_prompt,
                      max_rounds=max_rounds, duration=secs)
        k = _run_path(f"{name}/{mix}", cut, dev, shadow=shadow, tape=tape,
                      **common)
        if tape is not None:
            tape.remove()
        p = _run_path(f"{name}/{mix}", cut, dev, plain=True, **common)
        runs = (k, p)
        kl, pl = k["rec"]["logits"], p["rec"]["logits"]
        if [a for a, _ in kl] != [b for b, _ in pl]:
            raise AssertionError(f"{name}/{mix}: call sequences differ")
        independent = [(kind, a, b) for (kind, a), (_, b) in zip(kl, pl)]
        row = dict(calls=len(kl))
        if same_inputs:
            row["max_abs_logit_diff"] = _logits_within(f"{name}/{mix}",
                                                       shadow)
            drift = [float((a.float() - b.float()).abs().max())
                     for _, a, b in independent]
            row["independent_runs"] = dict(
                max_abs_logit_diff=max(drift),
                calls_beyond_tol=sum(
                    bool(((a.float() - b.float()).abs() > LOGIT_ATOL
                          + LOGIT_RTOL * b.float().abs()).any())
                    for _, a, b in independent))
        else:
            row["max_abs_logit_diff"] = _logits_within(f"{name}/{mix}",
                                                       independent)
        ks, ps = k["sched"], p["sched"]
        toks = [r.generated for r in ks.all_reqs.values()] == \
            [r.generated for r in ps.all_reqs.values()]
        stats = all(dataclasses.asdict(ks.stats[t]) ==
                    dataclasses.asdict(ps.stats[t]) for t in ks.stats)
        if not ((toks or pin_routing) and stats and ks.now_s == ps.now_s):
            raise AssertionError(f"{name}/{mix}: tokens equal {toks}, "
                                 f"stats equal {stats}")
        if tape is not None:
            row["routing"] = tape.report()
        report[mix] = dict(row, tokens_equal=toks, stats_equal=stats,
                           kernel_launches=k["launches"],
                           plain_launches=p["launches"])
        del runs, k, p, kl, pl, independent, shadow, tape
        torch.cuda.empty_cache()
    return report


def phase_serve_parity(dev, model) -> None:
    """At full width and one period of depth, the decode graph against its
    eager body (``_decode_graph_parity``), then both mixes through the
    kernels and through their plain versions (``_kernels_vs_plain``)."""
    _decode_graph_parity(SERVE_ARCH, model, dev, PARITY_LAYERS)
    cut = model.first_layers(PARITY_LAYERS)
    report = _kernels_vs_plain("serve_parity", cut, dev, SERVE_ARCH,
                               LONG_PROMPT)
    emit("serve_parity", layers=PARITY_LAYERS, d_model=cut.cfg.d_model,
         logit_rtol=LOGIT_RTOL, logit_atol=LOGIT_ATOL, mixes=report)


# ---------------------------------------------------------------------------
# serving: mamba2-780m at full width
# ---------------------------------------------------------------------------


def phase_serve_mamba2(dev) -> tuple:
    """mamba2-780m at full width and depth, random weights drawn on the
    card: the launcher's mix through ArcusScheduler(use_kernel=True), every
    prefill through the SSD-scan kernel (48 launches), decode in plain
    torch."""
    model, init_s, gib = _full_model(MAMBA_ARCH, dev)
    run = _run_path("serve_mamba2", model, dev, arch=MAMBA_ARCH, max_batch=8,
                    max_len=256, mix="serve", max_rounds=MAMBA_ROUNDS)
    prof = _profile_serving(model, dev, MAMBA_LONG_PROMPT)
    _emit_serve("serve_mamba2", MAMBA_ARCH, model, init_s, gib, run, prof)
    return model, run, prof


def phase_serve_mamba2_long(dev, model) -> dict:
    """The same model over four 2000-token prompts: each prefill's scan
    crosses 31 full chunks and a ragged one."""
    run = _run_path("serve_mamba2_long", model, dev, arch=MAMBA_ARCH,
                    max_batch=LONG_REQUESTS, max_len=2048, mix="long",
                    long_prompt=MAMBA_LONG_PROMPT, max_rounds=MAMBA_ROUNDS)
    if run["longest_sequence"] < MAMBA_LONG_PROMPT:
        raise AssertionError(f"serve_mamba2_long: longest sequence "
                             f"{run['longest_sequence']}")
    emit("serve_mamba2_long", prompt=MAMBA_LONG_PROMPT, new_tokens=LONG_NEW,
         max_batch=LONG_REQUESTS, max_len=2048, **_public(run))
    return run


def phase_serve_mamba2_parity(dev, model) -> None:
    """At full width and MAMBA_PARITY_LAYERS (2) layers, both mamba2 mixes
    through the SSD-scan kernel and through the plain scan
    (``_kernels_vs_plain``), the logits
    of each call held against the plain versions on the same cache; first
    the decode graph against its eager body (``_decode_graph_parity``)."""
    _decode_graph_parity(MAMBA_ARCH, model, dev, MAMBA_PARITY_LAYERS)
    cut = model.first_layers(MAMBA_PARITY_LAYERS)
    report = _kernels_vs_plain("serve_mamba2_parity", cut, dev, MAMBA_ARCH,
                               MAMBA_LONG_PROMPT, MAMBA_ROUNDS,
                               same_inputs=True)
    emit("serve_mamba2_parity", layers=MAMBA_PARITY_LAYERS,
         d_model=cut.cfg.d_model, logit_rtol=LOGIT_RTOL,
         logit_atol=LOGIT_ATOL, mixes=report)


# ---------------------------------------------------------------------------
# serving: recurrentgemma-9b and mixtral-8x22b at full width
# ---------------------------------------------------------------------------


def phase_serve_recurrentgemma(dev) -> tuple:
    """recurrentgemma-9b at full width and depth, random weights drawn on
    the card: the launcher's mix through ArcusScheduler(use_kernel=True);
    decode attention and flash prefill launch once a step / prefill for
    each of the 12 local layers, the 26 rglru layers run torch ops (the
    reference scans in jnp, with no kernel)."""
    model, init_s, gib = _full_model(RG_ARCH, dev)
    run = _run_path("serve_recurrentgemma", model, dev, arch=RG_ARCH,
                    max_batch=8, max_len=256, mix="serve",
                    max_rounds=MAMBA_ROUNDS)
    prof = _profile_serving(model, dev, RG_LONG_PROMPT)
    _emit_serve("serve_recurrentgemma", RG_ARCH, model, init_s, gib, run,
                prof)
    return model, run, prof


def phase_serve_recurrentgemma_long(dev, model) -> dict:
    """Four 2560-token prompts over the 2048-token window: the local
    caches keep the last 2048 positions and roll, and each rglru prefill
    scans 2560 positions (12 levels of the associative scan)."""
    run = _run_path("serve_recurrentgemma_long", model, dev, arch=RG_ARCH,
                    max_batch=LONG_REQUESTS, max_len=RG_LONG_LEN, mix="long",
                    long_prompt=RG_LONG_PROMPT, max_rounds=MAMBA_ROUNDS)
    if run["longest_sequence"] <= model.cfg.window:
        raise AssertionError(f"serve_recurrentgemma_long stayed inside the "
                             f"window: {run['longest_sequence']}")
    emit("serve_recurrentgemma_long", prompt=RG_LONG_PROMPT,
         new_tokens=LONG_NEW, window=model.cfg.window,
         max_batch=LONG_REQUESTS, max_len=RG_LONG_LEN, **_public(run))
    return run


def phase_serve_recurrentgemma_parity(dev, model) -> None:
    """One period (rglru, rglru, local) at full width: the decode graph
    against its eager body, then both mixes through the kernels against
    the plain versions, each call's logits on a copy of the same cache (the
    recurrent state carries rounding forward, as mamba2's)."""
    _decode_graph_parity(RG_ARCH, model, dev, RG_PARITY_LAYERS)
    cut = model.first_layers(RG_PARITY_LAYERS)
    report = _kernels_vs_plain("serve_recurrentgemma_parity", cut, dev,
                               RG_ARCH, RG_LONG_PROMPT, MAMBA_ROUNDS,
                               same_inputs=True, long_len=RG_LONG_LEN)
    emit("serve_recurrentgemma_parity", layers=RG_PARITY_LAYERS,
         d_model=cut.cfg.d_model, logit_rtol=LOGIT_RTOL,
         logit_atol=LOGIT_ATOL, mixes=report)


def phase_serve_mixtral(dev) -> tuple:
    """mixtral-8x22b at full width and MX_LAYERS of depth, random weights
    drawn on the card: the launcher's mix through
    ArcusScheduler(use_kernel=True), clocked by the full config; each
    prefill's MoE layers dispatch grouped by expert, each decode step (a
    graph replay) runs every expert on the 8 slots."""
    emit("reduced", what="serve_mixtral depth",
         n_layers=[MX_LAYERS, 56], why="56 layers hold about 280 GB of bf16 "
         "weights; one card holds 80 GB")
    model, init_s, gib = _full_model(MX_ARCH, dev, MX_LAYERS)
    run = _run_path("serve_mixtral", model, dev, arch=MX_ARCH, max_batch=8,
                    max_len=256, mix="serve", max_rounds=MAMBA_ROUNDS,
                    duration=MX_SERVE_S)
    prof = _profile_serving(model, dev, MX_LONG_PROMPT)
    _emit_serve("serve_mixtral", MX_ARCH, model, init_s, gib, run, prof)
    return model, run, prof


def phase_serve_mixtral_long(dev, model) -> dict:
    """Four 1536-token prompts: each prefill routes 3,072 (token, expert)
    rows a MoE layer through the grouped dispatch."""
    run = _run_path("serve_mixtral_long", model, dev, arch=MX_ARCH,
                    max_batch=LONG_REQUESTS, max_len=2048, mix="long",
                    long_prompt=MX_LONG_PROMPT, max_rounds=MAMBA_ROUNDS)
    if run["longest_sequence"] < MX_LONG_PROMPT:
        raise AssertionError(f"serve_mixtral_long: longest sequence "
                             f"{run['longest_sequence']}")
    emit("serve_mixtral_long", prompt=MX_LONG_PROMPT, new_tokens=LONG_NEW,
         max_batch=LONG_REQUESTS, max_len=2048, **_public(run))
    return run


def _moe_forms(model, dev) -> dict:
    """The first MoE layer's decode form (every expert on every token,
    ``all_experts``) against its grouped form on the same [8, 1, d_model]
    normed hidden state at full width, within LOGIT_RTOL plus one bf16 ulp
    of the output's largest magnitude; ms of each form, and the expert
    bytes each reads."""
    import torch
    blk = next(b for b in model.blocks if b.moe)
    moe = blk.ffn
    g = torch.Generator(device=dev).manual_seed(11)
    x = blk.ln2(torch.randn((8, 1, model.cfg.d_model), generator=g,
                            device=dev).to(moe.wi.dtype))
    dense, grouped = moe.all_experts(x), moe.grouped(x)
    torch.cuda.synchronize()
    scale = float(grouped.float().abs().max())
    ulp = 2.0 ** (int(torch.tensor(scale).log2().floor()) - 7)
    diff = (dense.float() - grouped.float()).abs()
    bad = diff > ulp + LOGIT_RTOL * grouped.float().abs()
    _, idx = moe.route(x.reshape(8, -1))
    hit = int(torch.unique(idx).numel())
    expert_bytes = (moe.wi[0].numel() + moe.wo[0].numel()) \
        * moe.wi.element_size()
    out = dict(tokens=8, experts_hit=hit, max_abs_diff=float(diff.max()),
               output_max_abs=scale, atol=ulp, rtol=LOGIT_RTOL,
               all_experts_ms=auto_time_ms(lambda: moe.all_experts(x)),
               grouped_ms=auto_time_ms(lambda: moe.grouped(x)),
               all_experts_gb=moe.cfg.n_experts * expert_bytes / 1e9,
               grouped_gb=hit * expert_bytes / 1e9)
    if bool(bad.any()):
        raise AssertionError(f"MoE decode form != grouped form: {out}")
    return out


def phase_serve_mixtral_parity(dev, model) -> None:
    """At full width and MX_PARITY_LAYERS of depth: the MoE layer's two
    dispatch forms on one hidden state, the decode graph against its eager
    body, then both mixes through the kernels against the plain versions,
    each call's plain run on the kernels' call's cache and MoE routing."""
    forms = _moe_forms(model, dev)
    _decode_graph_parity(MX_ARCH, model, dev, MX_PARITY_LAYERS)
    cut = model.first_layers(MX_PARITY_LAYERS)
    report = _kernels_vs_plain("serve_mixtral_parity", cut, dev, MX_ARCH,
                               MX_LONG_PROMPT, MAMBA_ROUNDS,
                               serve_s=MX_SERVE_S, pin_routing=True)
    emit("serve_mixtral_parity", layers=MX_PARITY_LAYERS,
         d_model=cut.cfg.d_model, logit_rtol=LOGIT_RTOL,
         logit_atol=LOGIT_ATOL, moe_forms=forms, mixes=report)


# ---------------------------------------------------------------------------
# serving: llama-3.2-vision-11b and seamless-m4t-medium (frontends)
# ---------------------------------------------------------------------------


def _frontends(cfg, n: int, dev, seed: int) -> list:
    """``n`` frontend embeddings [1, F, frontend_dim] float32 on the card,
    drawn from ``numpy.random.default_rng(seed)`` (not the reference's
    ``frontend_stub``, which seeds with ``hash(kind)``: another value in
    every process); ``n`` Nones for an arch without a frontend."""
    import numpy as np
    import torch
    if not cfg.frontend:
        return [None] * n
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(
        (1, cfg.frontend_len, cfg.frontend_dim), dtype=np.float32),
        device=dev) for _ in range(n)]


#: (scale, centre) of the seeded normal ``_liven`` draws each parameter of
#: these leaf names from: the ``cross`` layers' gate (zero at init, so
#: tanh(xgate) = 0 would silence them), every attention's QKV biases (the
#: decoder's, ``xattn``'s and the encoder's) and every norm's scale and
#: LayerNorm bias.  The CPU parity tests put the same noise on the
#: reference's parameters (``tests/_torch_parity.py``'s ``CROSS_NOISE``).
LIVEN = {"xgate": (0.5, 0.5), "bq": (0.1, 0.0), "bk": (0.1, 0.0),
         "bv": (0.1, 0.0), "scale": (0.2, 1.0), "bias": (0.1, 0.0)}
# the same for a Mamba2 mixer's zero / one parameters (the CPU tests'
# ``_torch_parity.SSD_NOISE``): conv taps and bias, decay, dt bias, skip,
# norm scale
LIVEN_SSD = {"conv_w": (0.3, 0.0), "conv_b": (0.1, 0.0), "a_log": (0.5, 0.0),
             "dt_bias": (0.5, 0.0), "d_skip": (0.2, 1.0),
             "norm_scale": (0.2, 1.0)}


def _liven(model, seed: int, table: dict = LIVEN) -> dict:
    """Seeded noise (``table``: ``LIVEN`` by default) in place on the
    parameters the reference initialises to zeros or ones, so that the
    card's checks see them act.  Returns how many of each were drawn, for
    the ``reduced`` line."""
    import torch
    g = torch.Generator(device=model.device).manual_seed(seed)
    done: dict[str, int] = {}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in table:
            scale, centre = table[leaf]
            noise = torch.randn(p.shape, generator=g, device=p.device)
            p.data.copy_((centre + scale * noise).to(p.dtype))
            done[leaf] = done.get(leaf, 0) + 1
    return done


def _frontend_mix(cfg, mix: str) -> list:
    """(prompt, new tokens) of each request: ``"serve"`` is the launcher's
    request shapes (24 prompts of 64 tokens with 16 new tokens, then 32 of
    12 with 6), ``"long"`` LONG_REQUESTS prompts of FRONTEND_LONG_PROMPT."""
    import numpy as np
    rng = np.random.default_rng(0 if mix == "serve" else 1)
    if mix == "serve":
        return [(list(rng.integers(0, cfg.vocab, 64)), 16)
                for _ in range(24)] + \
            [(list(rng.integers(0, cfg.vocab, 12)), 6) for _ in range(32)]
    return [(list(rng.integers(0, cfg.vocab, FRONTEND_LONG_PROMPT)),
             LONG_NEW) for _ in range(LONG_REQUESTS)]


def _run_frontend_path(name, model, dev, *, mix, max_batch, max_len,
                       shadow=None) -> dict:
    """Drive ``ServingEngine.admit(req, frontend)`` + ``step()`` over
    ``mix`` (``_frontend_mix``): each request admitted with its own
    frontend embeddings when a slot is free, steps until every request is
    done.  The launch counts are set to 0 just before and read just after;
    ``_check_serving``'s checks, with decode attention once a decode step
    for each self-attention, ``cross`` or ``xattn`` layer, flash prefill
    by mask as ``prefill_masks`` counts it, no token-bucket or SSD-scan
    launch.  ``shadow`` (a list) receives each call's logits beside the
    plain versions' on a copy of the same cache (``_shadow_plain``)."""
    import collections
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    cfg = model.cfg
    engine = ServingEngine(cfg, model, max_batch=max_batch, max_len=max_len,
                           device=dev)
    rec = _instrument(engine)
    if shadow is not None:
        _shadow_plain(engine, shadow)
    reqs = _frontend_mix(cfg, mix)
    fes = _frontends(cfg, len(reqs), dev, seed=FRONTEND_SEED)
    pending = collections.deque(
        (Request(i, 0, p, n), fe) for i, ((p, n), fe)
        in enumerate(zip(reqs, fes)))
    done = []

    def drive():
        while pending or engine.active_count:
            while pending and engine.free_slots():
                req, fe = pending.popleft()
                engine.admit(req, fe)
                done.append(req)
            engine.step()
    run = _counted(drive)
    masks = prefill_masks(cfg, [len(p) for p, _ in reqs])
    expect = dict(token_bucket=0, ssd_scan=0,
                  decode_attention=rec["decodes"]
                  * attention_launches(cfg)["decode"],
                  flash_prefill=sum(masks.values()))
    run.update(encoder_layers=cfg.encoder_layers,
               longest_sequence=int(engine.lengths.max()))
    if rec["prefills"] != len(reqs):
        raise AssertionError(f"{name}: {rec['prefills']} prefills of "
                             f"{len(reqs)} requests")
    _check_serving(name, model, rec, run, expect, len(reqs),
                   sum(r.done for r in done), masks)
    run["rec"] = rec
    return run


def _decode_weight_gb(model) -> float:
    """GB of weights a decode step reads: every decoder block's and the
    head's (the tied head's bf16 copy), not the embedding (a gather), the
    frontend projection or the encoder (prefill only)."""
    blocks = sum(p.numel() * p.element_size()
                 for p in model.blocks.parameters())
    head = model.unembed_w if model.cfg.tie_embeddings else model.lm_head
    norm = sum(p.numel() * p.element_size()
               for p in model.final_norm.parameters())
    return (blocks + head.numel() * head.element_size() + norm) / 1e9


def _memory_cache_gb(cfg, max_batch: int) -> float:
    """GB of float32 memory caches (cross and xattn K/V) an engine holds."""
    rows = max_batch * cfg.frontend_len * cfg.n_kv_heads * cfg.head_dim_
    return 2 * 4 * rows * attention_launches(cfg)["memory"] / 1e9


def _emit_frontend_serve(phase, arch, model, init_s, gib, run, prof, notes
                         ) -> None:
    from repro_torch.models import module
    cfg = model.cfg
    emit(phase, arch=arch,
         layer_kinds={k: cfg.layer_kinds().count(k)
                      for k in sorted(set(cfg.layer_kinds()))},
         d_model=cfg.d_model, vocab=cfg.vocab, frontend=cfg.frontend,
         frontend_shape=[1, cfg.frontend_len, cfg.frontend_dim],
         params=module.param_count(model), weights_gib=gib, init_s=init_s,
         decode_weight_gb=_decode_weight_gb(model),
         memory_cache_gb=_memory_cache_gb(cfg, 8), max_batch=8, max_len=256,
         liven=notes, **_public(run), profile=prof)


def _frontend_full_model(arch: str, dev):
    """``_full_model`` with ``_liven``'s noise, stated on a ``reduced``
    line: the card's weights are random, and the parameters the reference
    starts at zero or one are drawn instead."""
    model, init_s, gib = _full_model(arch, dev)
    notes = _liven(model, SERVE_SEED + 1)
    emit("reduced", what=f"{arch} weights", changed=notes,
         why="random weights: xgate (zero at init) would silence every "
             "cross layer, zero biases and unit norms would leave their "
             "paths unchecked; each drawn from a seeded normal")
    return model, init_s, gib, notes


def phase_serve_llama_vision(dev) -> tuple:
    """llama-3.2-vision-11b at full width and depth (32 global and 8 cross
    layers), random weights drawn on the card with live gates: the
    launcher's request shapes, each request admitted with its own
    [1, 1600, 1280] patch embeddings; each prefill launches flash prefill
    32 times causal and 8 times over the 1600 memory rows, each decode step
    decode attention 40 times (8 over the memory)."""
    model, init_s, gib, notes = _frontend_full_model(LV_ARCH, dev)
    run = _run_frontend_path("serve_llama_vision", model, dev, mix="serve",
                             max_batch=8, max_len=256)
    prof = _profile_serving(model, dev, FRONTEND_LONG_PROMPT)
    _emit_frontend_serve("serve_llama_vision", LV_ARCH, model, init_s, gib,
                         run, prof, notes)
    return model, run, prof


def phase_frontend_long(phase: str, dev, model) -> dict:
    """Four FRONTEND_LONG_PROMPT-token prompts: each cross-attention
    prefill 1536 queries against the F memory rows."""
    run = _run_frontend_path(phase, model, dev, mix="long",
                             max_batch=LONG_REQUESTS, max_len=2048)
    if run["longest_sequence"] < FRONTEND_LONG_PROMPT:
        raise AssertionError(f"{phase}: longest sequence "
                             f"{run['longest_sequence']}")
    emit(phase, prompt=FRONTEND_LONG_PROMPT, new_tokens=LONG_NEW,
         max_batch=LONG_REQUESTS, max_len=2048, **_public(run))
    return run


def _frontend_parity(phase: str, arch: str, model, dev, layers: int,
                     encoder_layers: int | None = None) -> None:
    """At full width and ``layers`` decoder layers (``encoder_layers``
    encoder layers): the decode graph against its eager body, then both
    mixes through the kernels, each call's logits held against the plain
    versions run on a copy of the cache it started from, within one bf16
    ulp of their scale."""
    import torch
    _decode_graph_parity(arch, model, dev, layers, encoder_layers)
    cut = model.first_layers(layers, encoder_layers)
    report = {}
    for mix, max_batch, max_len in (("serve", 8, 256),
                                    ("long", LONG_REQUESTS, 2048)):
        pairs = []
        run = _run_frontend_path(f"{phase}/{mix}", cut, dev, mix=mix,
                                 max_batch=max_batch, max_len=max_len,
                                 shadow=pairs)
        report[mix] = dict(calls=len(pairs),
                           max_abs_logit_diff=_logits_within(
                               f"{phase}/{mix}", pairs),
                           launches=run["launches"],
                           flash_prefill_masks=run["flash_prefill_masks"])
        del run, pairs
        torch.cuda.empty_cache()
    emit(phase, layers=layers, encoder_layers=cut.cfg.encoder_layers,
         d_model=cut.cfg.d_model, logit_rtol=LOGIT_RTOL,
         logit_atol=LOGIT_ATOL, mixes=report)


def _encoder_share(model, dev) -> dict:
    """Wall ms (synchronised) of a 64-token and a 12-token prefill and of
    the frontend projection + encoder alone on one request's frames: the
    encoder's share of a prefill."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    fe = _frontends(model.cfg, 1, dev, seed=5)[0]
    rng = np.random.default_rng(5)
    cache = T.init_cache(model.cfg, 1, 256, torch.float32, device=dev)

    def wall_ms(fn, n=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3
    with torch.no_grad():
        enc = wall_ms(lambda: model.encode(model.frontend_kv(fe)))
        out = dict(encoder_ms=enc)
        for S in (64, 12):
            tok = torch.as_tensor(rng.integers(0, model.cfg.vocab, (1, S)),
                                  device=dev)
            ms = wall_ms(lambda: T.prefill(model, tok, cache, fe))
            out[f"prefill_{S}_ms"] = ms
            out[f"encoder_share_{S}"] = enc / ms
    return out


def phase_serve_seamless(dev) -> tuple:
    """seamless-m4t-medium at full size (12 encoder and 12 decoder layers),
    random weights drawn on the card with live QKV biases and LayerNorms:
    the launcher's request shapes, each request admitted with its own
    [1, 1024, 1024] audio frames; each prefill runs the encoder (12
    non-causal 1024 x 1024 flash-prefill launches), 12 causal and 12
    cross-attention launches; each decode step 24 decode-attention
    launches."""
    model, init_s, gib, notes = _frontend_full_model(SM_ARCH, dev)
    run = _run_frontend_path("serve_seamless", model, dev, mix="serve",
                             max_batch=8, max_len=256)
    prof = _profile_serving(model, dev, FRONTEND_LONG_PROMPT)
    prof["encoder"] = _encoder_share(model, dev)
    _emit_frontend_serve("serve_seamless", SM_ARCH, model, init_s, gib, run,
                         prof, notes)
    return model, run, prof


# ---------------------------------------------------------------------------
# Training: the flash-attention backward kernel, kernels vs plain over a
# train step, and starcoder2-3b trained at full size through the launcher
# ---------------------------------------------------------------------------


def _reachable_pairs(Sq: int, Sk: int, w: int, ck: int, causal: bool) -> int:
    """(query, key) pairs the mask lets through (per head)."""
    if not causal:
        return Sq * Sk
    n = 0
    for i in range(Sq):
        hi = min(i + 1, Sk)
        lo = max(0, i - w + 1) if w else 0
        if ck:
            lo, hi = max(lo, i // ck * ck), min(hi, (i // ck + 1) * ck)
        n += max(hi - lo, 0)
    return n


def phase_flash_backward(dev) -> dict:
    """The flash-attention backward kernel against its plain version on the
    card at every ``rehearse.BACKWARD_CASES`` row (``check_backward``: the
    forward kernel's LSE within 1e-2 bf16 / 1e-4 float32, dq, dk, dv within
    1e-2 / 1e-4 of the plain gradients' max-abs; rows that reach no key
    zero), each call checked on its kernels through ``LAUNCHES_BY_PATH``
    (``ops.BACKWARD_LAUNCHES``) and ``LAUNCHES_WITH_LSE`` (bf16 on the
    tensor-core backward, float32 on the CUDA-core one), and every bf16
    row's two calls bitwise equal (``check_deterministic``).  At
    starcoder2-3b's and gemma3-12b's shapes: ms a call, device ms a launch
    of each kernel (profiled, ``device_ms_per_launch``: dQ, the dK / dV
    partials, their reduction) and their sum, the head slices
    (``ops.dkdv_splits``), at starcoder2's the CUDA-core kernels on the
    same bf16 inputs (``cuda_core_ms``, checked too), the plain backward's
    ms, SDPA's backward (``library_ms``: autograd through
    ``scaled_dot_product_attention`` with ``enable_gqa``, ``is_causal``
    where the mask is the plain causal one and the explicit mask otherwise,
    its forward not timed), and the bound (10 D flops a reachable pair and
    head at the bf16 tensor peak, against q, k, v, o, dO and the LSE read
    and dq, dk, dv written once)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_prefill import ops, rehearse
    rows = []
    for i, case in enumerate(rehearse.BACKWARD_CASES):
        path = ops.kernel_path(getattr(torch, case[-1]),
                               getattr(torch, case[-1]))
        before = (dict(ops.LAUNCHES_BY_PATH), dict(ops.LAUNCHES_WITH_LSE))
        row = rehearse.check_backward(case, dev, 300 + i)
        want = dict(before[0])
        want[path] += 1
        bpath = ops.backward_path(getattr(torch, case[-1]), case[4])
        want["backward_" + bpath] += ops.BACKWARD_LAUNCHES[bpath]
        if ops.LAUNCHES_BY_PATH != want or \
                ops.LAUNCHES_WITH_LSE[path] != before[1][path] + 1:
            raise AssertionError(f"flash_backward {case}: launches "
                                 f"{ops.LAUNCHES_BY_PATH} != {want}")
        row["path"], row["backward_path"] = path, bpath
        if bpath == "tensor_core":
            row["deterministic"] = rehearse.check_deterministic(
                case, dev, 300 + i)
        if i in BWD_TIMED:
            B, Sq, H, KvH, D, w, ck, causal, Sk, dn = case
            q, k, v, do, kw = rehearse.backward_inputs(case, dev, 300 + i)
            o, lse = ops.flash_prefill_lse(q, k, v, **kw)
            pairs = _reachable_pairs(Sq, Sk, w, ck, causal)
            esize = q.element_size()
            n_bytes = (3 * q.numel() + 3 * k.numel() + 2 * do.numel()) \
                * esize + 4 * lse.numel()
            flops = 10 * B * H * D * pairs
            row.update(reachable_pairs=pairs, flops=flops, bytes=n_bytes,
                       splits=ops.dkdv_splits(
                           B, Sq, Sk, KvH, H // KvH, D, window=w,
                           chunk_size=ck, causal=causal,
                           sms=torch.cuda.get_device_properties(
                               dev).multi_processor_count))
            row["bound_ms"], row["bound_by"] = attn_bound(n_bytes, flops,
                                                          "bfloat16")

            def call():
                return ops.flash_backward(q, k, v, o, lse, do, **kw)
            row["ms"] = auto_time_ms(call, budget_s=0.5, max_iters=20)
            kinds = ("flash_backward_dq", "flash_backward_dkdv") + (
                ("flash_backward_dkdv_reduce",) if bpath == "tensor_core"
                else ())
            row["device_ms_by_kernel"] = {
                kind: device_ms_per_launch(call, kind, calls=10)
                for kind in kinds}
            row["device_ms"] = sum(row["device_ms_by_kernel"].values())
            if bpath == "tensor_core":
                # the CUDA-core kernels on the same bf16 inputs, through the
                # same wrapper
                path_of = ops.backward_path
                ops.backward_path = lambda *_: "cuda_core"
                try:
                    cc = ops.flash_backward(q, k, v, o, lse, do, **kw)
                    row["cuda_core_rel_err"] = max(
                        _max_err(a, b) / max(float(b.float().abs().max()),
                                             1e-30)
                        for a, b in zip(cc, ops.flash_backward_plain(
                            q, k, v, o, lse, do, **kw)))
                    row["cuda_core_ms"] = auto_time_ms(
                        lambda: ops.flash_backward(q, k, v, o, lse, do,
                                                   **kw),
                        budget_s=0.3, max_iters=10)
                finally:
                    ops.backward_path = path_of
                if not row["cuda_core_rel_err"] < \
                        rehearse.GRAD_RTOL["bfloat16"]:
                    raise AssertionError(f"flash_backward cuda_core != "
                                         f"plain: {row}")
                del cc
            row["plain_ms"] = auto_time_ms(
                lambda: ops.flash_backward_plain(q, k, v, o, lse, do, **kw),
                budget_s=0.5, max_iters=20)
            row["forward_ms"] = auto_time_ms(
                lambda: ops.flash_prefill(q, k, v, **kw))
            row["forward_lse_ms"] = auto_time_ms(
                lambda: ops.flash_prefill_lse(q, k, v, **kw))
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            sdpa_kw = dict(enable_gqa=True)
            if causal and not ck and (not w or Sq <= w) and Sq == Sk:
                sdpa_kw["is_causal"] = True
                row["library"] = "sdpa is_causal"
            else:
                mask = _prefill_mask(Sq, w, ck, dev)
                sdpa_kw["attn_mask"] = mask
                row["library"] = "sdpa explicit mask"
            ot = F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)
            dot = do.transpose(1, 2)
            lib_grads = torch.autograd.grad(ot, (qt, kt, vt), dot,
                                            retain_graph=True)
            want = ops.flash_backward_plain(q, k, v, o, lse, do, **kw)
            lib_err = max(
                _max_err(g.transpose(1, 2), w_) /
                max(float(w_.float().abs().max()), 1e-30)
                for g, w_ in zip(lib_grads, want))
            row["library_rel_err"] = lib_err
            if not lib_err < 5e-2:
                raise AssertionError(f"SDPA backward yardstick != plain: "
                                     f"{lib_err}")
            row["library_ms"] = auto_time_ms(
                lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                            retain_graph=True),
                budget_s=0.5, max_iters=50)
            row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
            row["bound_share"] = row["bound_ms"] / row["ms"]
            del q, k, v, do, o, lse, qt, kt, vt, ot, lib_grads, want
            torch.cuda.empty_cache()
        rows.append(row)
    emit("flash_backward", cases=rows)
    return dict(rows=rows, main=rows[BWD_TIMED[0]],
                gemma3=rows[BWD_TIMED[1]],
                max_abs_err=max(max(r["max_abs_err"].values())
                                for r in rows))


def _train_config(n_layers: int | None = None):
    import dataclasses
    from repro_torch.configs.registry import get_config
    cfg = get_config(TRAIN_ARCH)
    return cfg if n_layers is None else \
        dataclasses.replace(cfg, n_layers=n_layers)


def phase_train_parity(dev) -> dict:
    """starcoder2-3b's first 2 layers at full width (training storage,
    seeded ``LIVEN`` noise on its biases and norms), one 1024-token
    sequence: one ``train_step`` through the kernels and one through the
    plain versions, from the same weights and batch.  The loss within
    TRAIN_LOSS_ATOL, every parameter's gradient within TRAIN_GRAD_RTOL
    (relative Frobenius error), every updated element within
    TRAIN_UPDATE_LR learning rates; the kernels' step launched the forward
    kernel (with its LSE) twice a layer (remat recomputes it) and the
    backward once (``ops.BACKWARD_LAUNCHES`` launches), the plain step no
    kernel."""
    import copy
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as opt, train as TR
    cfg = _train_config(TRAIN_PARITY_LAYERS)
    model = T.init_model(SERVE_SEED, cfg, device=dev, train=True)
    liven = _liven(model, 7)
    plain_model = copy.deepcopy(model)
    b = next(SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_PARITY_SEQ,
                                    global_batch=1, seed=3)).batches())
    batch = {"tokens": torch.as_tensor(b["tokens"], device=dev),
             "mask": torch.as_tensor(b["mask"], device=dev)}
    ocfg = opt.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=5)
    out = {}
    for name, m, plain in (("kernels", model, False),
                           ("plain", plain_model, True)):
        step = TR.make_train_step(cfg, ocfg, remat=True, plain=plain)
        ost = opt.init(dict(m.named_parameters()))
        got = {}

        def drive():
            got["metrics"] = step(m, ost, batch)[2]
        run = _counted(drive)
        out[name] = dict(metrics={k: float(v) for k, v in
                                  got["metrics"].items()},
                         launches=run["launches"],
                         paths=run["flash_prefill_paths"],
                         with_lse=dict(fp.LAUNCHES_WITH_LSE),
                         plain_calls=dict(fp.PLAIN_CALLS),
                         wall_s=run["wall_s"])
    lr = out["kernels"]["metrics"]["lr"]
    grad_err, update_err = {}, 0.0
    for (n, p), (_, q) in zip(model.named_parameters(),
                              plain_model.named_parameters()):
        g, gp = p.grad.float(), q.grad.float()
        grad_err[n] = float((g - gp).norm() / gp.norm().clamp_min(1e-30))
        update_err = max(update_err, float((p - q).abs().max()))
    worst = max(grad_err, key=grad_err.get)
    n_layers = cfg.n_layers
    k_paths = out["kernels"]["paths"]
    res = dict(arch=TRAIN_ARCH, layers=n_layers, seq=TRAIN_PARITY_SEQ,
               liven=liven, loss=out["kernels"]["metrics"]["loss"],
               loss_plain=out["plain"]["metrics"]["loss"],
               grad_norm=out["kernels"]["metrics"]["grad_norm"],
               grad_norm_plain=out["plain"]["metrics"]["grad_norm"],
               max_grad_rel_err=grad_err[worst], worst_param=worst,
               max_update_err_lr=update_err / lr,
               kernels_launches=out["kernels"]["launches"],
               kernels_paths=k_paths,
               kernels_with_lse=out["kernels"]["with_lse"],
               kernels_plain_calls=out["kernels"]["plain_calls"],
               plain_launches=out["plain"]["launches"],
               plain_calls=out["plain"]["plain_calls"],
               wall_s={k: v["wall_s"] for k, v in out.items()},
               tol=dict(loss_abs=TRAIN_LOSS_ATOL, grad_rel=TRAIN_GRAD_RTOL,
                        update_lr=TRAIN_UPDATE_LR))
    emit("train_parity", **res)
    if abs(res["loss"] - res["loss_plain"]) > TRAIN_LOSS_ATOL or \
            res["max_grad_rel_err"] > TRAIN_GRAD_RTOL or \
            res["max_update_err_lr"] > TRAIN_UPDATE_LR:
        raise AssertionError(f"train_parity: kernels != plain: {res}")
    want = dict(tensor_core=2 * n_layers, cuda_core=0,
                backward_tensor_core=fp.BACKWARD_LAUNCHES["tensor_core"]
                * n_layers, backward_cuda_core=0)
    if k_paths != want or any(out["plain"]["launches"].values()) or \
            out["kernels"]["launches"]["flash_prefill"] != 2 * n_layers or \
            res["kernels_with_lse"]["tensor_core"] != 2 * n_layers or \
            any(res["kernels_plain_calls"].values()) or \
            res["plain_calls"]["backward"] != n_layers:
        raise AssertionError(f"train_parity: launches {res}")
    del model, plain_model, out
    gc.collect()
    torch.cuda.empty_cache()
    return res


def train_model_flops(cfg, seq: int, batch: int) -> float:
    """Model FLOPs of one training step (forward and backward, no
    recompute): 3 x (2 x tokens x the matmul weights, the tied head
    included, + 4 D flops a reachable pair and query head of each
    attention layer)."""
    E, H, KvH, Dh, Fd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.head_dim_, cfg.d_ff
    per_layer = E * H * Dh + 2 * E * KvH * Dh + H * Dh * E + \
        E * Fd * (2 if cfg.gated_mlp else 1) + Fd * E
    weights = cfg.n_layers * per_layer + cfg.vocab * E
    attn = 0
    for kind in cfg.layer_kinds():
        w = cfg.window if kind == "local" else 0
        ck = cfg.window if kind == "chunk" else 0
        attn += 4 * Dh * H * _reachable_pairs(seq, seq, w, ck, True)
    return 3.0 * (2 * batch * seq * weights + batch * attn)


def phase_train(dev) -> dict:
    """``repro_torch.launch.train`` with TRAIN_ARGV (starcoder2-3b at full
    size on the synthetic pipeline, remat, 4 steps) with every launch count
    set to 0 and the peak memory reset just before its first step
    (``on_start``): every loss finite, every parameter moved (a strided
    sample of each against its value before the first step), flash prefill
    launched exactly steps x 30 x 2 times with its LSE (remat recomputes
    the forward) and its backward steps x 30 times (each call
    ``ops.BACKWARD_LAUNCHES["tensor_core"]`` launches), no
    plain-version call and no other kernel; peak memory, ms a step (the
    first apart), tokens a second; then one more step profiled by kernel
    kind (the forward and backward, then the optimizer alone), and the
    model FLOPs a step against the bf16 peak."""
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.launch import train as LT
    from repro_torch.models import convert, module
    from repro_torch.training import optimizer as opt, train as TR
    args = LT.parser().parse_args(TRAIN_ARGV)
    samples = {}

    def on_start(model):
        with torch.no_grad():
            for n, p in model.named_parameters():
                flat = p.detach().reshape(-1)
                samples[n] = flat[::max(1, flat.numel() // 4096)].clone()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()

    t0 = time.perf_counter()
    run = LT.train(args, device=dev, on_start=on_start)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    paths, lse = dict(fp.LAUNCHES_BY_PATH), dict(fp.LAUNCHES_WITH_LSE)
    plain_calls = dict(fp.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    model, ost, cfg = run["model"], run["opt_state"], run["cfg"]
    unmoved = []
    with torch.no_grad():
        for n, p in model.named_parameters():
            flat = p.detach().reshape(-1)
            now = flat[::max(1, flat.numel() // 4096)]
            if torch.equal(now, samples[n]):
                unmoved.append(n)
    steps, L = args.steps, cfg.n_layers
    n_params = module.param_count(model)
    step_s = run["step_s"]
    steady = step_s[1:] if len(step_s) > 1 else step_s
    ms_step = sum(steady) / len(steady) * 1e3
    tokens = args.batch * args.seq
    flops = train_model_flops(cfg, args.seq, args.batch)
    # one more step, profiled: the forward and backward, then the optimizer
    b = next(SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch)).batches(
        start_step=steps))
    batch = {"tokens": torch.as_tensor(b["tokens"], device=dev),
             "mask": torch.as_tensor(b["mask"], device=dev)}
    ocfg = opt.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=steps)
    groups = convert.leaf_groups(model)

    def fwd_bwd():
        model.zero_grad(set_to_none=True)
        loss, _ = TR.loss_fn(model, batch, remat=True)
        loss.backward()

    def optimizer():
        params = dict(model.named_parameters())
        opt.apply(ocfg, params, {n: p.grad for n, p in params.items()}, ost,
                  groups=groups)
    prof_fb = _profile(fwd_bwd, 1)
    prof_opt = _profile(optimizer, 1)
    by_kind = dict(prof_fb["device_ms_by_kind"])
    by_kind["optimizer"] = prof_opt["device_busy_ms"]
    res = dict(
        arch=TRAIN_ARCH, argv=TRAIN_ARGV, layers=L, d_model=cfg.d_model,
        params=n_params, params_b=n_params / 1e9,
        state_gib=n_params * 16 / 2**30, losses=run["losses"],
        step_s=step_s, ms_per_step=ms_step, first_step_ms=step_s[0] * 1e3,
        tokens_per_s=tokens / (ms_step / 1e3), wall_s=wall,
        peak_mem_gib=peak, launches=launches, flash_prefill_paths=paths,
        flash_prefill_with_lse=lse, plain_calls=plain_calls,
        unmoved_params=unmoved,
        profiled_step=dict(
            wall_ms=prof_fb["wall_ms"] + prof_opt["wall_ms"],
            device_busy_ms=prof_fb["device_busy_ms"]
            + prof_opt["device_busy_ms"],
            device_kernels=prof_fb["device_kernels"]
            + prof_opt["device_kernels"],
            device_ms_by_kind=by_kind,
            top_kernels_ms=prof_fb["top_kernels_ms"],
            optimizer_wall_ms=prof_opt["wall_ms"]),
        model_flops_per_step=flops,
        model_flops_share_of_bf16_peak=flops / (ms_step / 1e3)
        / PEAK_FLOPS["bfloat16"])
    emit("train", **res)
    want_paths = dict(tensor_core=steps * L * 2, cuda_core=0,
                      backward_tensor_core=steps * L
                      * fp.BACKWARD_LAUNCHES["tensor_core"],
                      backward_cuda_core=0)
    if not all(map(math.isfinite, run["losses"])) or \
            len(run["losses"]) != steps:
        raise AssertionError(f"train: losses {run['losses']}")
    if unmoved:
        raise AssertionError(f"train: parameters did not move: {unmoved}")
    if paths != want_paths or lse != dict(tensor_core=steps * L * 2,
                                          cuda_core=0) or \
            launches != dict(token_bucket=0, decode_attention=0,
                             flash_prefill=steps * L * 2, ssd_scan=0) or \
            any(plain_calls.values()):
        raise AssertionError(f"train: launches {launches}, paths {paths}, "
                             f"with LSE {lse}, plain calls {plain_calls}")
    del run, model, ost
    gc.collect()
    torch.cuda.empty_cache()
    return dict(res, backward_launches=paths["backward_tensor_core"])


def phase_kernel_ssd_backward(dev) -> dict:
    """The SSD-scan gradient's kernels at every ``rehearse.BACKWARD_CASES``
    row (bf16 with N <= 128: ``csrc/ssd_scan_tc_bwd.cu``, four launches, a
    group's heads in ``ops.backward_slices`` slices; float32 and the other
    shapes: ``csrc/ssd_scan_bwd.cu``, five): the forward kernel writing
    S_prev, then the backward's dx, da, dB and dC against
    ``ref.ssd_scan_chunked_backward`` (with the kernel's slices) on the same
    inputs and cotangents (a nonzero d_state) within
    ``rehearse.TOL_BWD_MIRROR``, at L <= 512 against autograd of the
    sequential scan within ``TOL_BWD_PLAIN``, two calls bitwise equal, the
    dy = 0 row's u exactly zero (``check_backward``); then at mamba2-780m's
    training shape [1,4096,48,64], G 1, N 128 bf16 its ms a call (CUDA
    events), device ms by kernel (``torch.profiler``), the slice count and
    workspace bytes, the plain mirror's ms and the bound
    (``time_backward``)."""
    from repro_torch.kernels.ssd_scan import rehearse
    t0 = time.perf_counter()
    rows = [rehearse.check_backward(case, dev, seed=5)
            for case in rehearse.BACKWARD_CASES]
    main = rehearse.time_backward(dev)
    res = dict(rows=rows, main=main, tol_mirror={
        "float32": rehearse.TOL_BWD_MIRROR[False],
        "bfloat16": rehearse.TOL_BWD_MIRROR[True]}, tol_plain={
        "float32": rehearse.TOL_BWD_PLAIN[False],
        "bfloat16": rehearse.TOL_BWD_PLAIN[True]},
        max_abs_err=max(r["max_abs_err"] for r in rows),
        bitwise_rows=sum(r["bitwise"] for r in rows),
        zero_dy_exact_rows=sum(bool(r.get("zero_dy_exact")) for r in rows),
        seconds=time.perf_counter() - t0)
    emit("kernel_ssd_backward", **res)
    return res


def mamba2_train_parity(dev, cfg, seq: int, seed: int = 7) -> dict:
    """One ``train_step`` of ``cfg`` (a mamba2 config; training storage,
    seeded ``LIVEN_SSD`` and ``LIVEN`` noise) on one ``seq``-token batch
    through the SSD-scan kernels and one through the plain sequential scan
    (``plain=True``), from the same weights: the losses, the worst
    relative Frobenius error of a gradient, the worst update gap in
    learning rates, and each step's launches (``_counted``), forward
    launches with S_prev and plain-scan calls."""
    import copy
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as opt, train as TR
    model = T.init_model(SERVE_SEED, cfg, device=dev, train=True)
    liven = dict(_liven(model, seed, LIVEN_SSD), **_liven(model, seed + 1))
    plain_model = copy.deepcopy(model)
    b = next(SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=1, seed=3)).batches())
    batch = {"tokens": torch.as_tensor(b["tokens"], device=dev),
             "mask": torch.as_tensor(b["mask"], device=dev)}
    ocfg = opt.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=5)
    out = {}
    for name, m, plain in (("kernels", model, False),
                           ("plain", plain_model, True)):
        step = TR.make_train_step(cfg, ocfg, remat=True, plain=plain)
        ost = opt.init(dict(m.named_parameters()))
        got = {}

        def drive():
            got["metrics"] = step(m, ost, batch)[2]
        run = _counted(drive)
        out[name] = dict(metrics={k: float(v) for k, v in
                                  got["metrics"].items()},
                         launches=run["launches"],
                         paths=run["ssd_scan_paths"],
                         with_sprev=dict(ssd.LAUNCHES_WITH_SPREV),
                         plain_calls=dict(ssd.PLAIN_CALLS),
                         wall_s=run["wall_s"])
    lr = out["kernels"]["metrics"]["lr"]
    grad_err, update_err = {}, 0.0
    with torch.no_grad():
        for (n, p), (_, q) in zip(model.named_parameters(),
                                  plain_model.named_parameters()):
            g, gp = p.grad.float(), q.grad.float()
            grad_err[n] = float((g - gp).norm()
                                / gp.norm().clamp_min(1e-30))
            update_err = max(update_err, float((p - q).abs().max()))
    worst = max(grad_err, key=grad_err.get)
    res = dict(layers=cfg.n_layers, seq=seq, dtype=cfg.dtype, liven=liven,
               loss=out["kernels"]["metrics"]["loss"],
               loss_plain=out["plain"]["metrics"]["loss"],
               grad_norm=out["kernels"]["metrics"]["grad_norm"],
               grad_norm_plain=out["plain"]["metrics"]["grad_norm"],
               max_grad_rel_err=grad_err[worst], worst_param=worst,
               max_update_err_lr=update_err / lr,
               kernels_launches=out["kernels"]["launches"],
               kernels_paths=out["kernels"]["paths"],
               kernels_with_sprev=out["kernels"]["with_sprev"],
               kernels_plain_calls=out["kernels"]["plain_calls"],
               plain_launches=out["plain"]["launches"],
               plain_calls=out["plain"]["plain_calls"],
               wall_s={k: v["wall_s"] for k, v in out.items()})
    del model, plain_model, out
    gc.collect()
    torch.cuda.empty_cache()
    return res


def mamba2_train_launches_ok(res: dict, path: str) -> bool:
    """Whether ``mamba2_train_parity``'s kernel step launched the forward
    kernel of ``path`` twice a layer with S_prev (remat recomputes it) and
    the backward of the same path (mamba2's N is 128) once
    (``BACKWARD_LAUNCHES`` launches), no flash or other kernel and no
    plain scan; and the plain step no kernel."""
    from repro_torch.kernels.ssd_scan import ops as ssd
    n = res["layers"]
    other = "cuda_core" if path == "tensor_core" else "tensor_core"
    return res["kernels_paths"] == {
        path: 2 * n, other: 0, "backward_" + other: 0,
        "backward_" + path: n * ssd.BACKWARD_LAUNCHES[path]} and \
        res["kernels_with_sprev"] == {path: 2 * n, other: 0} and \
        res["kernels_launches"] == dict(token_bucket=0, decode_attention=0,
                                        flash_prefill=0, ssd_scan=2 * n) \
        and res["kernels_plain_calls"] == {"scan": 0} and \
        not any(res["plain_launches"].values()) and \
        res["plain_calls"] == {"scan": 2 * n}


def phase_train_mamba2_parity(dev) -> dict:
    """mamba2-780m's first MAMBA_TRAIN_PARITY_LAYERS layers at full width
    (bf16 activations: the tensor-core forward and backward), one
    MAMBA_TRAIN_PARITY_SEQ-token sequence, kernels against the
    plain sequential scan (``mamba2_train_parity``): the loss within
    TRAIN_LOSS_ATOL, every gradient within TRAIN_GRAD_RTOL, every updated
    element within TRAIN_UPDATE_LR learning rates, and the launches."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config(MAMBA_ARCH),
                              n_layers=MAMBA_TRAIN_PARITY_LAYERS)
    res = dict(arch=MAMBA_ARCH, **mamba2_train_parity(
        dev, cfg, MAMBA_TRAIN_PARITY_SEQ),
        tol=dict(loss_abs=TRAIN_LOSS_ATOL, grad_rel=TRAIN_GRAD_RTOL,
                 update_lr=TRAIN_UPDATE_LR))
    emit("train_mamba2_parity", **res)
    if abs(res["loss"] - res["loss_plain"]) > TRAIN_LOSS_ATOL or \
            res["max_grad_rel_err"] > TRAIN_GRAD_RTOL or \
            res["max_update_err_lr"] > TRAIN_UPDATE_LR:
        raise AssertionError(f"train_mamba2_parity: kernels != plain: {res}")
    if not mamba2_train_launches_ok(res, "tensor_core"):
        raise AssertionError(f"train_mamba2_parity: launches {res}")
    return res


def mamba2_model_flops(cfg, seq: int, batch: int) -> float:
    """Model FLOPs of one mamba2 training step (forward and backward, no
    recompute): 3 x 2 x (tokens x the matmul weights, the tied head
    included, + the chunked scan's multiply-adds: per head and chunk of
    Q = 128 tokens M x (Q^2 P), the chunk state and C S_prev^T (Q P N
    each), per group C B^T (Q^2 N))."""
    from repro_torch.models.layers import mamba2_split
    E = cfg.d_model
    Din, H, G, N = mamba2_split(cfg)
    P = cfg.ssm_head_dim
    per_layer = E * (2 * Din + 2 * G * N + H) + Din * E
    weights = cfg.n_layers * per_layer + cfg.vocab * E
    nc = -(-seq // 128)
    scan = cfg.n_layers * nc * (H * (128 * 128 * P + 2 * 128 * P * N)
                                + G * 128 * 128 * N)
    return 3.0 * 2 * (batch * seq * weights + batch * scan)


def phase_train_mamba2(dev) -> dict:
    """``repro_torch.launch.train`` with MAMBA_TRAIN_ARGV (mamba2-780m at
    full size, remat, 4 steps), every launch count set to 0 and the peak
    memory reset just before its first step: every loss finite, every
    parameter moved, the SSD-scan forward launched steps x 48 x 2 times,
    all on the tensor cores with S_prev (remat recomputes it), its
    tensor-core backward steps x 48 x ``BACKWARD_LAUNCHES`` times, no
    plain scan and no other kernel; peak memory, ms a step (the first
    apart), tokens a second; one more step profiled by kernel kind (the
    SSD backward a kind of its own), the optimizer apart."""
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.launch import train as LT
    from repro_torch.models import convert, module
    from repro_torch.training import optimizer as opt, train as TR
    args = LT.parser().parse_args(MAMBA_TRAIN_ARGV)
    samples = {}

    def on_start(model):
        with torch.no_grad():
            for n, p in model.named_parameters():
                flat = p.detach().reshape(-1)
                samples[n] = flat[::max(1, flat.numel() // 4096)].clone()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()

    t0 = time.perf_counter()
    run = LT.train(args, device=dev, on_start=on_start)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    paths, sprev = dict(ssd.LAUNCHES_BY_PATH), dict(ssd.LAUNCHES_WITH_SPREV)
    plain_calls = dict(ssd.PLAIN_CALLS, **fp.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    model, ost, cfg = run["model"], run["opt_state"], run["cfg"]
    unmoved = []
    with torch.no_grad():
        for n, p in model.named_parameters():
            flat = p.detach().reshape(-1)
            now = flat[::max(1, flat.numel() // 4096)]
            if torch.equal(now, samples[n]):
                unmoved.append(n)
    steps, L = args.steps, cfg.n_layers
    n_params = module.param_count(model)
    step_s = run["step_s"]
    steady = step_s[1:] if len(step_s) > 1 else step_s
    ms_step = sum(steady) / len(steady) * 1e3
    tokens = args.batch * args.seq
    flops = mamba2_model_flops(cfg, args.seq, args.batch)
    b = next(SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch)).batches(
        start_step=steps))
    batch = {"tokens": torch.as_tensor(b["tokens"], device=dev),
             "mask": torch.as_tensor(b["mask"], device=dev)}
    ocfg = opt.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=steps)
    groups = convert.leaf_groups(model)

    def fwd_bwd():
        model.zero_grad(set_to_none=True)
        loss, _ = TR.loss_fn(model, batch, remat=True)
        loss.backward()

    def optimizer():
        params = dict(model.named_parameters())
        opt.apply(ocfg, params, {n: p.grad for n, p in params.items()}, ost,
                  groups=groups)
    prof_fb = _profile(fwd_bwd, 1)
    prof_opt = _profile(optimizer, 1)
    by_kind = dict(prof_fb["device_ms_by_kind"])
    by_kind["optimizer"] = prof_opt["device_busy_ms"]
    res = dict(
        arch=MAMBA_ARCH, argv=MAMBA_TRAIN_ARGV, layers=L,
        d_model=cfg.d_model, params=n_params, params_b=n_params / 1e9,
        state_gib=n_params * 16 / 2**30, losses=run["losses"],
        step_s=step_s, ms_per_step=ms_step, first_step_ms=step_s[0] * 1e3,
        tokens_per_s=tokens / (ms_step / 1e3), wall_s=wall,
        peak_mem_gib=peak, launches=launches, ssd_scan_paths=paths,
        ssd_scan_with_sprev=sprev, plain_calls=plain_calls,
        unmoved_params=unmoved,
        profiled_step=dict(
            wall_ms=prof_fb["wall_ms"] + prof_opt["wall_ms"],
            device_busy_ms=prof_fb["device_busy_ms"]
            + prof_opt["device_busy_ms"],
            device_idle_share=prof_fb["device_idle_share"],
            device_kernels=prof_fb["device_kernels"]
            + prof_opt["device_kernels"],
            device_ms_by_kind=by_kind,
            top_kernels_ms=prof_fb["top_kernels_ms"],
            optimizer_wall_ms=prof_opt["wall_ms"]),
        model_flops_per_step=flops,
        model_flops_share_of_bf16_peak=flops / (ms_step / 1e3)
        / PEAK_FLOPS["bfloat16"])
    emit("train_mamba2", **res)
    n_fwd = steps * L * 2
    want_paths = dict(tensor_core=n_fwd, cuda_core=0,
                      backward_tensor_core=steps * L
                      * ssd.BACKWARD_LAUNCHES["tensor_core"],
                      backward_cuda_core=0)
    if not all(map(math.isfinite, run["losses"])) or \
            len(run["losses"]) != steps:
        raise AssertionError(f"train_mamba2: losses {run['losses']}")
    if unmoved:
        raise AssertionError(f"train_mamba2: parameters did not move: "
                             f"{unmoved}")
    if paths != want_paths or sprev != dict(tensor_core=n_fwd,
                                            cuda_core=0) or \
            launches != dict(token_bucket=0, decode_attention=0,
                             flash_prefill=0, ssd_scan=n_fwd) or \
            any(plain_calls.values()):
        raise AssertionError(f"train_mamba2: launches {launches}, paths "
                             f"{paths}, with S_prev {sprev}, plain calls "
                             f"{plain_calls}")
    del run, model, ost
    gc.collect()
    torch.cuda.empty_cache()
    return dict(res, backward_launches=paths["backward_tensor_core"])


# ---------------------------------------------------------------------------
# the distributed layer: the sequence-sharded decode on two ranks of the one
# card, and the dry run
# ---------------------------------------------------------------------------


def _seq_sharded_rank(rank: int, port: int, out: str) -> None:
    """One rank of ``seq_sharded_decode`` (``python3 chip_smoke.py
    --seq-sharded-rank RANK PORT OUT``): joins a gloo group of SEQ_RANKS
    ranks on the card's tensors, builds the model and a random float32
    cache from the same seeds as every rank, runs the unsharded kernel
    step on the whole cache and the hooked step on its slice of every
    layer's rows, and writes its numbers (OUT/rank{RANK}.json) and hooked
    logits (OUT/rank{RANK}.pt)."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, SRC)
    from repro_torch.distributed.collectives import (
        make_seq_sharded_cache_update, make_seq_sharded_decode_attn)
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models import transformer as T
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=SEQ_RANKS, rank=rank)
    mesh = make_dev_mesh(SEQ_RANKS, 1, device="cuda")
    model, _, _ = _full_model(SERVE_ARCH, dev, SEQ_LAYERS)
    cfg = model.cfg
    g = torch.Generator(device=dev).manual_seed(SEQ_SEED)
    cache = T.init_cache(cfg, SEQ_B, SEQ_ROWS, torch.float32, device=dev)
    for layer in cache:
        for t in layer:
            t.normal_(generator=g)
    tokens = torch.randint(0, cfg.vocab, (SEQ_B, 1), generator=g,
                           device=dev)
    lengths = torch.tensor(SEQ_LENGTHS, dtype=torch.int32, device=dev)

    def mine(t):
        n = t.shape[1] // SEQ_RANKS
        return t[:, rank * n:(rank + 1) * n]
    local = [tuple(mine(t).clone() for t in layer) for layer in cache]
    hooks = dict(decode_attn_fn=make_seq_sharded_decode_attn(mesh, "data"),
                 decode_update_fn=make_seq_sharded_cache_update(mesh,
                                                                "data"))

    def timed(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SEQ_STEPS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / SEQ_STEPS * 1e3
    whole = T.decode_step(model, tokens, lengths, cache)
    dist.barrier()
    _reset_launch_counts()
    hooked = T.decode_step(model, tokens, lengths, local, **hooks)
    torch.cuda.synchronize()
    launches = _launch_counts()
    diff = (hooked.float() - whole.float()).abs()
    bad = int((diff > LOGIT_ATOL + LOGIT_RTOL * whole.float().abs()).sum())
    # every row the hooked step did not write equals the whole cache's
    rows_equal, slot_err = True, 0.0
    for layer, mine_l in zip(cache, local):
        for t, loc in zip(layer, mine_l):
            W = t.shape[1]
            slot = lengths.long() % W - rank * (W // SEQ_RANKS)
            ref_t = mine(t)
            keep = torch.ones(loc.shape[:2], dtype=torch.bool, device=dev)
            own = (slot >= 0) & (slot < loc.shape[1])
            b = torch.arange(SEQ_B, device=dev)[own]
            keep[b, slot[own]] = False
            rows_equal &= bool(torch.equal(loc[keep], ref_t[keep]))
            slot_err = max(slot_err, float((loc[b, slot[own]]
                                            - ref_t[b, slot[own]]).abs()
                                           .max()) if len(b) else 0.0)
    res = dict(rank=rank, launches=launches,
               max_logit_diff=float(diff.max()), logits_outside_tol=bad,
               finite=bool(torch.isfinite(hooked).all()),
               rows_bitwise=rows_equal, written_row_err=slot_err,
               global_slots=(lengths.long() % SEQ_ROWS).tolist(),
               local_cache_gb=sum(t.numel() * t.element_size()
                                  for lay in local for t in lay) / 1e9,
               mesh=str(mesh))
    dist.barrier()
    res["ms_hooked"] = timed(lambda: T.decode_step(model, tokens, lengths,
                                                   local, **hooks))
    dist.barrier()
    # the unsharded step timed on rank 0 alone (the other rank waits)
    res["ms_whole"] = timed(lambda: T.decode_step(
        model, tokens, lengths, cache)) if rank == 0 else None
    torch.save(hooked.cpu(), os.path.join(out, f"rank{rank}.pt"))
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def phase_seq_sharded_decode(dev) -> dict:
    """decode_step through the sequence-sharded hooks
    (``repro_torch.distributed.collectives``) on SEQ_RANKS ranks of the one
    card: each rank a process holding gemma3-12b's first period at full
    width and its half of every layer's cache rows, its partial through the
    decode-attention kernel's ``ml`` form (one launch a layer), the
    partials merged by gloo all-reduces over the card's tensors (NCCL
    refuses two ranks on one device).  Held against the unsharded kernel
    step on the same cache: logits within LOGIT_RTOL / LOGIT_ATOL, the same
    logits on every rank, every cache row but the written one bitwise.  A
    step's ms is gloo's on one card (host copies), not a multi-card
    number."""
    import socket
    import torch
    out = os.path.join(ROOT, "build", "seq_sharded")
    os.makedirs(out, exist_ok=True)
    for f in os.listdir(out):
        os.remove(os.path.join(out, f))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--seq-sharded-rank",
         str(r), str(port), out], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(SEQ_RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            p.kill()
    if any(p.returncode for p in procs):
        raise AssertionError("seq_sharded_decode: a rank failed:\n"
                             + "\n".join(x[-3000:] for x in logs))
    ranks = []
    for r in range(SEQ_RANKS):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    logits = [torch.load(os.path.join(out, f"rank{r}.pt"))
              for r in range(SEQ_RANKS)]
    same = all(torch.equal(logits[0], x) for x in logits[1:])
    per_rank = [r["launches"] for r in ranks]
    ok = (same and all(r["finite"] and r["rows_bitwise"]
                       and not r["logits_outside_tol"] for r in ranks)
          and all(c == dict(token_bucket=0, decode_attention=SEQ_LAYERS,
                            flash_prefill=0, ssd_scan=0) for c in per_rank))
    emit("seq_sharded_decode", arch=SERVE_ARCH, layers=SEQ_LAYERS,
         batch=SEQ_B, cache_rows=SEQ_ROWS, ranks=SEQ_RANKS,
         lengths=list(SEQ_LENGTHS),
         transport="gloo on one card: two ranks share cuda:0 (NCCL refuses "
                   "two ranks on one device); a step's ms is not a "
                   "multi-card number",
         launches_by_rank=per_rank, logits_equal_across_ranks=same,
         logit_rtol=LOGIT_RTOL, logit_atol=LOGIT_ATOL,
         **{k: [r[k] for r in ranks] for k in (
             "max_logit_diff", "rows_bitwise", "written_row_err",
             "ms_hooked", "ms_whole", "local_cache_gb", "global_slots",
             "mesh")})
    if not ok:
        raise AssertionError(f"seq_sharded_decode: {ranks}, logits equal "
                             f"across ranks: {same}")
    return dict(launches=sum(c["decode_attention"] for c in per_rank),
                ms_hooked=max(r["ms_hooked"] for r in ranks),
                ms_whole=ranks[0]["ms_whole"])


def _sharded_rank(rank: int, port: int, out: str) -> None:
    """One rank of ``train_sharded`` (``python3 chip_smoke.py
    --train-sharded-rank RANK PORT OUT``): joins a gloo group of the
    mesh's ranks on the card's tensors, trains through
    ``launch.train.train(..., mesh=...)`` with every launch count set to 0
    just before the first step, and writes its numbers
    (OUT/rank{RANK}.json); rank 0 also the gathered parameters
    (OUT/params.pt)."""
    import io
    import torch
    import torch.distributed as dist
    sys.path.insert(0, SRC)
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.launch import train as LT
    from repro_torch.launch.mesh import make_dev_mesh
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    n_ranks = math.prod(SHARDED_MESH)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=n_ranks, rank=rank)
    mesh = make_dev_mesh(*SHARDED_MESH, device="cuda")
    samples, at = {}, {"joined": time.perf_counter() - T0}

    def on_start(model):
        with torch.no_grad():
            for n, p in model.named_parameters():
                flat = p.to_local().reshape(-1)
                samples[n] = flat[::max(1, flat.numel() // 4096)].clone()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        at["first_step"] = time.perf_counter() - T0
        _reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = LT.train(LT.parser().parse_args(SHARDED_ARGV), device=dev,
                       mesh=mesh, on_start=on_start,
                       cfg=_train_config(SHARDED_LAYERS))
    torch.cuda.synchronize()
    res = dict(rank=rank, coords=[mesh.get_local_rank(a)
                                  for a in ("data", "model")],
               launches=_launch_counts(), paths=dict(fp.LAUNCHES_BY_PATH),
               with_lse=dict(fp.LAUNCHES_WITH_LSE),
               plain_calls=dict(fp.PLAIN_CALLS), metrics=run["metrics"],
               step_ms=[t * 1e3 for t in run["step_s"]],
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               lines=buf.getvalue().splitlines())
    model, ost = run["model"], run["opt_state"]
    res["bytes"] = ost.step.numel() * ost.step.element_size()
    unmoved = []
    with torch.no_grad():
        for n, p in model.named_parameters():
            for t in (p, ost.m[n], ost.v[n]):
                res["bytes"] += t.to_local().numel() * \
                    t.to_local().element_size()
            flat = p.to_local().reshape(-1)
            if torch.equal(flat[::max(1, flat.numel() // 4096)],
                           samples[n]):
                unmoved.append(n)
    res["unmoved"] = unmoved
    at["trained"] = time.perf_counter() - T0
    full = SH.full_values(model)
    if rank == 0:
        torch.save(full, os.path.join(out, "params.pt"))
    at["saved"] = time.perf_counter() - T0
    res["seconds_since_start"] = at
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def phase_train_sharded(dev) -> dict:
    """The train step sharded across ranks: ``launch.train.train`` with
    SHARDED_ARGV on a ("data", "model") = SHARDED_MESH ``DeviceMesh`` of
    four processes of this script on the one card (``--train-sharded-rank``;
    gloo over the card's tensors), starcoder2-3b's first SHARDED_LAYERS
    layers at full width, held against the unsharded launcher run here
    first on the same seed and batches.  Every rank: the same metrics,
    each step's loss and grad_norm within SHARDED_LOSS_RTOL /
    SHARDED_NORM_RTOL of the unsharded step's and its lr equal; exactly
    the dry run's per-device parameter and optimizer bytes
    (``dryrun.argument_bytes``); the forward kernel (with its LSE)
    steps x layers x 2 times and the backward steps x layers times, all on
    the tensor cores, no plain-version call and no other kernel; every
    parameter moved.  The gathered parameters against the unsharded step's
    within SHARDED_PARAM_LR summed learning rates an element.  A step's ms
    is gloo's on one card (host copies), not a multi-card number."""
    import socket
    import torch
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.launch import dryrun, train as LT
    cfg = _train_config(SHARDED_LAYERS)
    args = LT.parser().parse_args(SHARDED_ARGV)
    out = os.path.join(ROOT, "build", "train_sharded")
    os.makedirs(out, exist_ok=True)
    for f in os.listdir(out):
        os.remove(os.path.join(out, f))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    n_ranks = math.prod(SHARDED_MESH)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--train-sharded-rank",
         str(r), str(port), out], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n_ranks)]
    logs = []
    try:
        # the unsharded run while the ranks start (their first step waits
        # for all four to join, well after it ends)
        with contextlib.redirect_stdout(sys.stderr):
            whole = LT.train(args, device=dev, cfg=cfg)
        want = {n: p.detach()
                for n, p in whole["model"].named_parameters()}
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
    if any(p.returncode for p in procs):
        raise AssertionError("train_sharded: a rank failed:\n"
                             + "\n".join(x[-3000:] for x in logs))
    ranks = []
    for r in range(n_ranks):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    got = torch.load(os.path.join(out, "params.pt"), map_location=dev)
    lrs = sum(m["lr"] for m in whole["metrics"])
    param_err = {}
    with torch.no_grad():
        for n, w in want.items():
            param_err[n] = float((got[n] - w).abs().max()) / lrs
    worst = max(param_err, key=param_err.get)
    plan = dryrun.argument_bytes(
        cfg, "train", args.batch, args.seq,
        SH.MeshShape(dict(zip(("data", "model"), SHARDED_MESH))))
    steps, L = args.steps, cfg.n_layers
    per_rank = dict(launches=dict(token_bucket=0, decode_attention=0,
                                  flash_prefill=steps * L * 2, ssd_scan=0),
                    paths=dict(tensor_core=steps * L * 2, cuda_core=0,
                               backward_tensor_core=steps * L
                               * fp.BACKWARD_LAUNCHES["tensor_core"],
                               backward_cuda_core=0),
                    with_lse=dict(tensor_core=steps * L * 2, cuda_core=0))
    ref = whole["metrics"]
    res = dict(
        arch=TRAIN_ARCH, layers=L, d_model=cfg.d_model, argv=SHARDED_ARGV,
        mesh=dict(zip(("data", "model"), SHARDED_MESH)), ranks=n_ranks,
        transport="gloo on one card: four ranks share cuda:0 (NCCL refuses "
                  "several ranks on one device); a step's ms is not a "
                  "multi-card number",
        metrics_unsharded=ref, metrics_by_rank=[r["metrics"] for r in ranks],
        loss_rel_err=[max(abs(m["loss"] - w["loss"]) / abs(w["loss"])
                          for m, w in zip(r["metrics"], ref))
                      for r in ranks],
        grad_norm_rel_err=[max(abs(m["grad_norm"] - w["grad_norm"])
                               / w["grad_norm"]
                               for m, w in zip(r["metrics"], ref))
                           for r in ranks],
        max_param_err_lr=param_err[worst], worst_param=worst,
        ms_per_step_by_rank=[r["step_ms"] for r in ranks],
        unsharded_ms_per_step=[t * 1e3 for t in whole["step_s"]],
        bytes_by_rank=[r["bytes"] for r in ranks],
        dryrun_bytes=plan["port_params"] + plan["optimizer"],
        dryrun_parts={k: plan[k] for k in ("port_params", "optimizer")},
        peak_mem_gib_by_rank=[r["peak_mem_gib"] for r in ranks],
        rank_seconds=[r["seconds_since_start"] for r in ranks],
        launches_by_rank=[r["launches"] for r in ranks],
        paths_by_rank=[r["paths"] for r in ranks],
        plain_calls_by_rank=[r["plain_calls"] for r in ranks],
        unmoved_by_rank=[r["unmoved"] for r in ranks],
        rank0_lines=ranks[0]["lines"],
        other_ranks_printed=[len(r["lines"]) for r in ranks[1:]],
        tol=dict(loss_rel=SHARDED_LOSS_RTOL, grad_norm_rel=SHARDED_NORM_RTOL,
                 param_lr=SHARDED_PARAM_LR))
    emit("train_sharded", **res)
    mesh_line = f"mesh={res['mesh']}"
    ok = (all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
          and all(e <= SHARDED_LOSS_RTOL for e in res["loss_rel_err"])
          and all(e <= SHARDED_NORM_RTOL for e in res["grad_norm_rel_err"])
          and all(m["lr"] == w["lr"] for r in ranks
                  for m, w in zip(r["metrics"], ref))
          and res["max_param_err_lr"] <= SHARDED_PARAM_LR
          and all(b == res["dryrun_bytes"] for b in res["bytes_by_rank"])
          and all(r[k] == v for r in ranks for k, v in per_rank.items())
          and not any(any(r["plain_calls"].values()) for r in ranks)
          and not any(r["unmoved"] for r in ranks)
          and ranks[0]["lines"][0].endswith(mesh_line)
          and len(ranks[0]["lines"]) == 1 + steps
          and not any(res["other_ranks_printed"]))
    if not ok:
        raise AssertionError(f"train_sharded: {res}")
    del whole, want, got
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=sum(r["launches"]["flash_prefill"] for r in ranks),
                backward_launches=sum(r["paths"]["backward_tensor_core"]
                                      for r in ranks),
                ms_per_step=[sum(r["step_ms"][1:]) / (steps - 1)
                             for r in ranks])


#: the dry run's plans the smoke makes (host only)
DRYRUN_PLANS = (("gemma3-12b", "decode_32k", "pod"),
                ("llama4-maverick-400b-a17b", "train_4k", "multipod"))


def phase_dryrun() -> dict:
    """``repro_torch.launch.dryrun.plan`` of DRYRUN_PLANS on the host (no
    card, nothing allocated): per-device GiB of the arguments by part, the
    step's FLOPs, and the fields left null with their reasons."""
    from repro_torch.launch import dryrun
    rows = []
    for arch, shape, mesh in DRYRUN_PLANS:
        t0 = time.perf_counter()
        rec = dryrun.plan(arch, shape, mesh)
        parts = rec.get("argument_bytes", {})
        if not (rec["status"] == "ok" and rec["flops"] > 0
                and rec["argument_size_in_bytes"] == sum(parts.values())
                and parts.get("params", 0) > 0
                and all(rec[k] is None for k in dryrun.NULL_FIELDS)):
            raise AssertionError(f"dryrun {arch} {shape} {mesh}: {rec}")
        rows.append(dict(
            arch=arch, shape=shape, mesh=mesh, n_devices=rec["n_devices"],
            per_device_gib=rec["argument_size_in_bytes"] / 2**30,
            per_device_gib_by_part={k: v / 2**30 for k, v in parts.items()},
            flops_per_device=rec["flops"], flops_total=rec["flops_total"],
            flops_approx=rec["unrolled"]["approx"],
            null_fields=sorted(rec["null_fields"]),
            seconds=time.perf_counter() - t0))
    emit("dryrun", plans=rows)
    return dict(plans=rows)


def main() -> int:
    import torch
    if len(sys.argv) == 5 and sys.argv[1] == "--seq-sharded-rank":
        _seq_sharded_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0
    if len(sys.argv) == 5 and sys.argv[1] == "--train-sharded-rank":
        _sharded_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: run from a checkout (src/repro_torch missing)",
              file=sys.stderr)
        return 3
    sys.path.insert(0, SRC)
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_prefill import ops as fp_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.token_bucket import ops as tb_ops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])
    t0 = time.perf_counter()
    seconds = _build.build_many([
        ("token_bucket", tb_ops._SRC), (da_ops.NAME, da_ops.SOURCE),
        (fp_ops.NAME, fp_ops.SOURCE), (fp_ops.BWD_NAME, fp_ops.BWD_SOURCE),
        (ssd_ops.NAME, ssd_ops.SOURCE), (ssd_ops.TC_NAME, ssd_ops.TC_SOURCE),
        (ssd_ops.BWD_NAME, ssd_ops.BWD_SOURCE),
        (ssd_ops.TC_BWD_NAME, ssd_ops.TC_BWD_SOURCE)])
    emit("build", kernels=list(seconds), seconds=seconds,
         wall_s=time.perf_counter() - t0,
         ptxas={k: [ln.strip() for ln in v.splitlines()
                    if "registers" in ln or "spill" in ln]
                for k, v in _build.PTXAS_INFO.items()})
    k = phase_kernel(dev)
    gt = phase_kernel_grant_tick(dev)
    gtb = phase_kernel_grant_tick_batch(dev)
    res = phase_resource_parity(dev)
    da = phase_kernel_decode_attention(dev)
    dap = phase_kernel_decode_attention_partial(dev)
    fp = phase_kernel_flash_prefill(dev)
    fbw = phase_flash_backward(dev)
    ssd = phase_kernel_ssd_scan(dev)
    # before the profiled phases: the profiler's traces drop more kernels
    # the more windows the process traced before
    sbw = phase_kernel_ssd_backward(dev)
    phase_interp(dev)
    main = phase_main_path(dev)
    phase_parity(dev)
    phase_graph_parity(dev)
    phase_batch_parity(dev)
    fig6 = phase_fig6_batch(dev)
    prof8 = phase_profile_batch8(dev)
    prof = phase_profile(dev)
    cont = phase_contention(dev)
    churn = phase_churn(dev)
    adapt = phase_adaptive_churn(dev)
    wp = phase_workload_parity(dev)
    scen = phase_scenarios(dev)
    model, serve, _ = phase_serve(dev)
    long = phase_serve_long(dev, model)
    phase_serve_parity(dev, model)
    # the runs hold their schedulers, hence engines and weights: drop them
    serve, long = _public(serve), _public(long)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    model, mserve, mprof = phase_serve_mamba2(dev)
    mlong = phase_serve_mamba2_long(dev, model)
    phase_serve_mamba2_parity(dev, model)
    n_ssd = model.cfg.layer_kinds().count("ssd")
    mserve, mlong = _public(mserve), _public(mlong)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    model, rserve, _ = phase_serve_recurrentgemma(dev)
    rlong = phase_serve_recurrentgemma_long(dev, model)
    phase_serve_recurrentgemma_parity(dev, model)
    rserve, rlong = _public(rserve), _public(rlong)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    model, xserve, _ = phase_serve_mixtral(dev)
    xlong = phase_serve_mixtral_long(dev, model)
    phase_serve_mixtral_parity(dev, model)
    xserve, xlong = _public(xserve), _public(xlong)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    model, lserve, _ = phase_serve_llama_vision(dev)
    llong = phase_frontend_long("serve_llama_vision_long", dev, model)
    _frontend_parity("serve_llama_vision_parity", LV_ARCH, model, dev,
                     LV_PARITY_LAYERS)
    lserve, llong = _public(lserve), _public(llong)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    model, sserve, _ = phase_serve_seamless(dev)
    _frontend_parity("serve_seamless_parity", SM_ARCH, model, dev,
                     SM_PARITY_LAYERS, SM_PARITY_LAYERS)
    sserve = _public(sserve)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    seq = phase_seq_sharded_decode(dev)
    tpar = phase_train_parity(dev)
    train = phase_train(dev)
    mpar = phase_train_mamba2_parity(dev)
    mtrain = phase_train_mamba2(dev)
    sharded = phase_train_sharded(dev)
    phase_dryrun()
    n_main = 2
    t = gt["times"][n_main]
    runs = dict(serve=serve, serve_long=long, serve_mamba2=mserve,
                serve_mamba2_long=mlong, serve_recurrentgemma=rserve,
                serve_recurrentgemma_long=rlong, serve_mixtral=xserve,
                serve_mixtral_long=xlong, serve_llama_vision=lserve,
                serve_llama_vision_long=llong, serve_seamless=sserve)
    by_path = {name: dict(main_path=0, **{p: r["launches"][name]
                                          for p, r in runs.items()})
               for name in serve["launches"]}
    # the token bucket's by kernel: the dataplane's grant ticks, the
    # serving scheduler's steps
    by_path["token_bucket"] = dict(
        main_path=main["by_path"], fig6_batch=fig6["by_path"],
        profile_batch8=prof8["by_path"],
        **{f"contention.{arm}": v for arm, v in cont.items()},
        churn=churn,
        **{f"adaptive_churn.{arm}": v for arm, v in adapt.items()},
        workload_parity=wp,
        **{f"scenarios.{k}": v for k, v in scen.items()},
        **{p: r["token_bucket_paths"] for p, r in runs.items()})
    tb_src = "src/repro_torch/kernels/token_bucket/csrc/token_bucket.cu"
    step = k["times"][n_main]
    rows = [{
        "name": "token_bucket", "route": "cuda", "source": tb_src,
        "sources": {"grant_tick": f"{tb_src}::tb_grant_tick_kernel",
                    "step": f"{tb_src}::tb_step_kernel"},
        "replaces": "src/repro/kernels/token_bucket/kernel.py:41",
        "launches": main["launches"],
        "max_abs_err": max(k["max_abs_err"], gt["max_abs_err"]),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "shape": f"grant tick: [{n_main}] flows, k_grant 4",
        "device_ms_per_launch": prof["tb_device_ms_per_launch"],
        "device_ms_per_launch_alone": t["device_ms"],
        "launch_floor_ms": prof["launch_floor_ms"],
        "grant_tick_times": {str(n): v for n, v in gt["times"].items()},
        "batched_fig6_config": [
            {k: r[k] for k in ("batch", "token_bucket_device_us_per_launch",
                               "device_kernels_per_tick",
                               "device_busy_us_per_tick", "us_per_tick")}
            for r in prof["batched"]],
        "step": dict(step, shape=f"[{n_main}] flows (admission call)"),
        "resource_axes": res["times"],
        "launches_by_path": by_path["token_bucket"]}, {
        # the same kernel launched over a grid of batch elements: its
        # numbers at fig6's batch size, its launches on fig6_batch
        "name": "token_bucket/grant_tick_batch", "route": "cuda",
        "source": f"{tb_src}::tb_grant_tick_kernel",
        "replaces": "src/repro/kernels/token_bucket/kernel.py:41",
        "launches": fig6["launches"], "max_abs_err": 0,
        **{k: gtb["times"][FIG6_B][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "shape": f"grant tick over {FIG6_B} ragged elements "
                 f"({gtb['times'][FIG6_B]['flows']} flows), k_grant 4",
        "device_ms_per_launch": gtb["times"][FIG6_B]["device_ms"],
        "by_batch": {str(B): {k: v[k] for k in (
            "flows", "ms", "plain_ms", "device_ms", "bound_ms", "bound_by")}
            for B, v in gtb["times"].items()},
        "launches_by_path": dict(
            fig6_batch=fig6["launches"], profile_batch8=prof8["launches"],
            **{f"contention.{arm}": v["grant_tick"]
               for arm, v in cont.items()},
            churn=churn["grant_tick"],
            **{f"adaptive_churn.{arm}": v["grant_tick"]
               for arm, v in adapt.items()},
            workload_parity=wp["grant_tick"],
            **{f"scenarios.{k}": v["grant_tick"]
               for k, v in scen.items()})}]
    for name, res, src, rep, shape, run in (
            ("decode_attention", da,
             "src/repro_torch/kernels/decode_attention/csrc/"
             "decode_attention.cu",
             "src/repro/kernels/decode_attention/kernel.py:30",
             "q [8,16,256] bf16, k/v [8,256,8,256] f32, lengths 13..80",
             serve),
            ("flash_prefill", fp,
             "src/repro_torch/kernels/flash_prefill/csrc/flash_prefill.cu",
             "src/repro/kernels/flash_prefill/kernel.py:24",
             "q [1,64,16,256], k/v [1,64,8,256] bf16, window 1024", serve),
            ("ssd_scan", ssd,
             "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_tc.cu",
             "src/repro/kernels/ssd_scan/kernel.py:27",
             f"x [1,{MAMBA_LONG_PROMPT},48,64], B/C [1,{MAMBA_LONG_PROMPT},"
             "1,128] bf16, a f32", mserve)):
        m = res["main"]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": run["launches"][name],
            "max_abs_err": res["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "shape": shape, "launches_by_path": by_path[name]})
        if name == "decode_attention":
            keys = ("shape", "lengths", "ms", "device_ms", "plain_ms",
                    "library_ms", "bound_ms", "bound_by", "bound_share",
                    "plan")
            rows[-1]["device_ms_per_launch"] = m["device_ms"]
            rows[-1]["bound_share"] = m["bound_share"]
            rows[-1]["plan"] = m["plan"]
            rows[-1]["long_cache"] = [{k: r[k] for k in keys}
                                      for r in res["long"]]
            rows[-1]["new_shapes"] = {
                arch: [{k: r[k] for k in keys} for r in rs]
                for arch, rs in res["new"].items()}
        if name == "flash_prefill":
            keys = ("shape", "sk", "causal", "window", "ms", "device_ms",
                    "plain_ms", "library_ms", "library_causal_ms",
                    "bound_ms", "bound_by", "bound_share", "tflops")
            rows[-1]["kernel_paths"] = {
                p: r["flash_prefill_paths"] for p, r in runs.items()
                if r["launches"]["flash_prefill"]}
            rows[-1]["launches_by_mask"] = {
                p: r["flash_prefill_masks"] for p, r in runs.items()
                if r["launches"]["flash_prefill"]}
            rows[-1]["long_prompt"] = [{k: r.get(k) for k in keys}
                                       for r in res["long"]]
            # training's forward launches, each also writing the LSE
            rows[-1]["training_launches_with_lse"] = dict(
                train_parity=tpar["kernels_with_lse"]["tensor_core"],
                train=train["flash_prefill_with_lse"]["tensor_core"],
                train_sharded=sharded["launches"])
            rows[-1]["new_shapes"] = {
                arch: [{k: r.get(k) for k in keys} for r in rs]
                for arch, rs in res["new"].items()}
        if name == "ssd_scan":
            pre = mprof[f"prefill_{MAMBA_LONG_PROMPT}"]
            # one wrapper call (three kernels) a layer
            rows[-1]["device_ms_per_launch"] = \
                pre["device_ms_by_kind"].get("ssd_scan", 0.0) / n_ssd
            rows[-1]["kernel_paths"] = {
                p: r["ssd_scan_paths"] for p, r in (
                    ("serve_mamba2", mserve), ("serve_mamba2_long", mlong))}
            rows[-1]["prompts"] = [
                {k: r.get(k) for k in ("shape", "ms", "cuda_core_ms",
                                       "plain_ms", "bound_ms", "bound_by",
                                       "bound_share")} for r in res["timed"]]
    # the flash-prefill kernel's gradient: its own kernels (three launches
    # a call in bf16), launched on the training path
    m = fbw["main"]
    rows.insert([r["name"] for r in rows].index("flash_prefill") + 1, {
        "name": "flash_backward", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_prefill/csrc/"
                  "flash_backward.cu",
        "replaces": "src/repro/kernels/flash_prefill/kernel.py:24",
        "gradient_of": "src/repro/models/layers.py:70 (XLA's autodiff of "
                       "the jnp flash_attention the reference trains "
                       "through; the Pallas kernel has no backward)",
        "launches": train["backward_launches"],
        "max_abs_err": fbw["max_abs_err"], "ms": m["ms"],
        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"], "library_ms": m["library_ms"],
        "library": m["library"],
        "shape": "q [1,4096,24,128], k/v [1,4096,2,128] bf16, window 4096 "
                 "(starcoder2-3b)",
        "device_ms_per_call": m["device_ms"],
        "device_ms_by_kernel": m["device_ms_by_kernel"],
        "bound_share": m["bound_share"], "tflops": m["tflops"],
        "splits": m["splits"],
        "gemma3": {k: fbw["gemma3"][k] for k in (
            "case", "ms", "device_ms", "device_ms_by_kernel", "plain_ms",
            "library_ms", "library", "bound_ms", "bound_by", "bound_share",
            "tflops", "splits")},
        "bitwise_repeatable_rows": sum(
            bool(r.get("deterministic")) for r in fbw["rows"]),
        "launches_by_path": dict(
            train_parity=tpar["kernels_paths"]["backward_tensor_core"],
            train=train["backward_launches"],
            train_sharded=sharded["backward_launches"])})
    # the SSD scan's gradient: kernels of its own (bf16 on the tensor cores,
    # four launches a call; float32 on the CUDA cores, five), launched on
    # mamba2's training path
    m = sbw["main"]
    rows.insert([r["name"] for r in rows].index("ssd_scan") + 1, {
        "name": "ssd_backward", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_tc_bwd.cu",
        "sources": {
            "tensor_core": "src/repro_torch/kernels/ssd_scan/csrc/"
                           "ssd_scan_tc_bwd.cu",
            "cuda_core": "src/repro_torch/kernels/ssd_scan/csrc/"
                         "ssd_scan_bwd.cu"},
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:27",
        "gradient_of": "src/repro/kernels/ssd_scan/ref.py:21-42 (XLA's "
                       "autodiff of the sequential oracle the reference "
                       "trains through; the Pallas kernel has no backward)",
        "launches": mtrain["backward_launches"],
        "max_abs_err": sbw["max_abs_err"], "ms": m["ms"],
        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"], "library_ms": None,
        "shape": "x/dy [1,4096,48,64], B/C [1,4096,1,128] bf16, a f32, "
                 "S_prev [1,32,48,64,128] bf16 (mamba2-780m)",
        "device_ms_per_call": m["device_ms"],
        "device_ms_by_kernel": m["device_ms_by_kernel"],
        "device_ms_per_launch": m["device_ms"]
        / ssd_ops.BACKWARD_LAUNCHES["tensor_core"],
        "bound_share": m["bound_share"], "bytes": m["bytes"],
        "flops": m["flops"], "slices": m["slices"],
        "workspace_bytes": m["workspace_bytes"],
        "cuda_core_ms": m["cuda_core_ms"],
        "cuda_core_device_ms": m["cuda_core_device_ms"],
        "bitwise_repeatable_rows": sbw["bitwise_rows"],
        "launches_by_path": dict(
            train_mamba2_parity=mpar["kernels_paths"][
                "backward_tensor_core"],
            train_mamba2=mtrain["backward_launches"])})
    # the same decode-attention kernel writing each head's merged (m, l):
    # the sequence-sharded decode's partial, launched on seq_sharded_decode
    m = dap["main"]
    rows.insert([r["name"] for r in rows].index("decode_attention") + 1, {
        "name": "decode_attention/partial", "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attention/csrc/"
                  "decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:30",
        "partial_of": "src/repro/distributed/collectives.py:40-70 "
                      "(local_fn's float32 partial softmax, which the "
                      "reference computes with einsum)",
        "launches": seq["launches"], "max_abs_err": dap["max_abs_err"],
        **{k: m[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "library", "bound_share",
                             "ms_without_ml", "device_ms_without_ml",
                             "merged_halves_err", "plan")},
        "device_ms_per_launch": m["device_ms"],
        "shape": "q [8,16,256] f32, k/v [8,16384,8,256] f32 (one rank's "
                 "half of gemma3-12b's decode_32k global layer)",
        "seq_sharded_ms_per_step": seq["ms_hooked"],
        "unsharded_ms_per_step": seq["ms_whole"],
        "launches_by_path": {"seq_sharded_decode": seq["launches"]}})
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
