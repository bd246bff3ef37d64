#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each timed and printed on its own line; any failure exits non-zero:

  1. environment: card name and power limit, torch/CUDA versions; TF32 off
     for convolutions and matmuls (the kernels' parity checks run in full
     fp32; the fleet engine fixes its own numeric mode whatever is set);
  2. build the CUDA kernel libraries from ``src/repro_torch/kernels/csrc``
     (one nvcc per source, all at once, into ``build/repro_torch_kernels/``);
     print ptxas's registers and spills, the wgmma flash kernel's shared
     memory per CTA and the count of HGMMA (tensor-core) instructions in its
     SASS, and require HGMMAs there and no spills in either flash kernel;
  3. every kernel against its plain torch version on the card, at the
     shapes of the paths below: max abs error, and times beside the bound,
     the plain version's time and, for flash attention, the time of
     ``scaled_dot_product_attention`` on the same inputs (timed only; the
     port never calls it). ``quantize`` and ``dequantize`` run their
     4-element kernels on aligned planes and their one-element kernels on
     views off alignment (x 4 bytes off, idx 3 bytes off), all bit-equal,
     beside an empty kernel's device time (the launch floor). The
     decision's KKT kernel (``qccf_kkt_kernel``) against its plain twin at
     a round of the benchmark cell (U = 1,024, 128 clients on a channel)
     and at a GA population of 32 such rounds, (P, U) = (32, 1,024), at
     lam 0, 20 and 500: levels, feasibility and case codes equal, f and
     q_hat bit-equal; the grid's share of clients from the case codes; the
     kernel's device time beside the launch floor, the wrapper's host time
     and the twin's time. The grouped expert kernels (``moe_rows_gemm``,
     ``moe_wgrad_gemm``) at granite-4.0-h-small's MoE layer as the model
     cell runs it (D 4,096, F 768, 9 of 72 experts, top-10 over 4,096
     tokens): each form a layer step takes against its per-expert float64
     product, timed beside the bound and the per-expert ``torch.matmul``,
     and one layer's forward and backward launching 6 and 3 of them.
     Flash attention is checked in bf16 (the wgmma kernel) and fp32 (the
     SIMT kernel, cp.async loads) at Llama-3-8B's serve shape, StarCoder2-7B's
     heads (g = 9) with its 4096 window at S = 8192, a non-causal ragged
     shape, Granite-3.0 1B-A400M's prefill (hd 64, g = 2, causal),
     SeamlessM4T's encoder (hd 64, g = 1, non-causal) and InternVL2-26B's
     prefill (hd 128, g = 6, causal) and Zamba2-7B's shared attention
     (hd 112, H = KV = 32, causal, window 4096), SDPA timed at each in both
     dtypes;
     at each, bf16 inputs
     that TMA cannot describe (one element off alignment) time the SIMT
     kernel's register-staged loads beside it, and a call with offsets that
     cancel and the fp32 partial must give bit-identical out (rounded) and
     lse. Then (dist a) both kernels with a position offset and the fp32
     partial at the 32k ring's step shapes (a diagonal and a past step of
     Llama-3-8B's heads, StarCoder2-7B's window-4096 partial step), each
     against the plain version with its time, bound and SDPA's with the
     step's mask; (dist b) ``ring_flash_attention`` through ``LocalRing(4)``
     at S = 32,768, Llama-3-8B's heads (10 wgmma launches) and StarCoder2-7B's
     with window 4096 (7), each within the bf16 tolerance of one kernel pass,
     the ring's summed kernel time beside the single pass's, SDPA's and the
     bound;
  4. the main path: ``build_sim("femnist", n_clients=1024, n_channels=8)``
     on the card, 5 QCCF rounds of ``run_compiled`` at the full FEMNIST
     CNN width (Z = 246,590), with ``aggregate`` launched once per round;
     then the paper's policies on the same fleet (the compiled GA at its
     default P = 32, G = 30, and the four baselines at q_cap = 16, each
     launching ``aggregate`` once per round, u16 planes at q_cap 16) and a
     profile of one GA round; a small-input reference (tiny task, U = 8,
     C = 4, the same draws on the card and on the CPU, greedy and GA); the
     compiled runs against ``run_host_policy`` of their numpy oracles on
     the card, and ``host-ga`` through ``run()``; and a profile of one
     greedy round. Telemetry on the same fleet: greedy rounds with every
     tap on (``MetricsConfig(enabled=True)``) and a ``Ledger`` against the
     same rounds with telemetry off (bit-equal outputs, s/round of both,
     ``aggregate`` once per round), one compiled-GA round the same way
     (``ga_best <= ga_median``), every ledger event validated and the
     ledger's summaries printed (``repro_torch.obs.report``);
  5. scenarios, downlink, faults and segments on the same fleet (greedy,
     3 rounds each, ``aggregate`` once per round): the ``cellfree_a4``
     drop, ``single_bs_faulty``, ``downlink="quant"`` and ``"delta"``, an
     aggressive ``FaultSpec`` (every fault channel fires, the model stays
     finite), ``noniid_a01`` on its own Dirichlet(0.1) data; on one sim,
     two unsegmented runs, a segmented run with checkpoints and a resume
     from the round-4 checkpoint, all bit-equal; the engine's numeric scope
     (a run with TF32 and autotuned cuDNN set globally bit-equal to one
     without, the caller's flags restored, a convolution fp32-exact inside
     the scope) and what deterministic cuDNN costs one greedy round's local
     SGD; tiny card-vs-CPU references (faults, downlink,
     cell-free, the GA with the downlink) and run_compiled vs
     run_host_policy on the card under faults and under the downlink;
  6. the wire entry point: ``ops.quantize_pytree_kernel`` on the FEMNIST
     parameters at q = 4 (``quantize_kernel_vec4``, ``dequantize_kernel_vec4``),
     round-trip error against scale / (2^q - 1); then (dist d) NCCL in a world
     of one: ``make_production_mesh(shape="1x1x1x1")``, the ring through
     ``GroupRing`` bit-equal to the single pass, and the FEMNIST fleet after
     ``shard_clients`` on a one-rank ``("data",)`` mesh: 3 greedy rounds
     bit-equal to 3 unsharded ones, ``aggregate`` once per round;
  7. the object runtime (``object_runtime``, after the FEMNIST sim is
     freed): ``build_experiment(pol, task="femnist", beta=150, seed=1)``,
     the paper's Fig.-3 setting (10 clients on 10 channels, Z = 246,590),
     for the five policies, one warm-up round then 3 timed: s/round, final
     accuracy, cumulative energy, mean q, scheduled counts; finite outputs,
     QCCF's energy below NoQuant's, every QCCF round within T_max. Then a
     profile of one QCCF and one NoQuant round (host spans ``fl_decide``,
     ``fl_local_quant``, ``fl_aggregate``); the tiny task on the card and
     on the CPU from the same weights and upload uniforms (schedule and q
     identical, accuracy within 1e-3, parameters within one quantization
     level); the fleet sim against the object runtime driven by
     ``HostFastPolicy`` on the card (U = 8, 12 rounds: scheduled counts and
     q identical). No kernel lies on this path: the object runtime
     quantizes with ``core.quantization.quantize_pytree``, as the JAX
     package's does;
  8. the serve path: ``serve.generate`` on
     Llama-3-8B at full width and depth (32 layers, random bf16 weights from
     a seed) with ``attn_impl="flash"``, batch 4, a 4096-token context from
     ``np.random.default_rng(0)`` and 32 new tokens; the wgmma flash kernel
     runs once per layer of the prefill. Then a two-layer prefill at full width
     through the kernel and through the plain version, a profile of one
     prefill and four decode steps, and a small-input reference (reduced
     Llama-3-8B, fp32, context 2560, the same weights on the card and on the
     CPU: identical greedy tokens, logits within 1e-4; its prefill runs the
     SIMT flash kernel); (dist c) the same weights at
     ``INPUT_SHAPES["prefill_32k"]`` (32,768 positions, the batch cut from 32
     to 1), 8 new tokens: 32 wgmma launches, prefill s, decode tok/s, peak GB;
  9. the other attention families, each model freed before the next:
     Granite-3.0 1B-A400M at full size (24 layers, 32 experts top-8; B = 4,
     context 4096, 32 new tokens; 24 causal wgmma launches in the prefill,
     the mean dropped fraction of its routing), SeamlessM4T-large-v2 at full
     size (24 + 24 layers; ``encode`` of 4 x 4096 normal frames, 24
     non-causal wgmma launches, 32 greedy tokens from BOS) and InternVL2-26B
     at full size (48 layers; 256 patch embeddings + 3840 tokens; 48 wgmma
     launches), each parameter count held to the JAX package's;
     then the recurrent families at full size, each freed before the next:
     RWKV6-7B (ssm; 32 layers, d_model 4096; the chunked WKV scan, no flash
     launch) and Zamba2-7B (hybrid; 81 Mamba2 layers, d_model 3584, the
     shared attention every 9 layers: 9 causal wgmma launches at hd 112,
     window 4096), B = 4, context 4096, 32 new tokens, each profiled and
     its parameter count held to the JAX package's; then the small-input
     reference of each family's reduced config (fp32, 2560 positions, the
     card against the CPU on the same weights; the reduced Zamba2's shared
     attention at window 64 through the SIMT kernel);
 10. training (``launch.steps.make_train_step``, ``make_fl_round``; no
     kernel of the port lies on it, and every phase requires 0 launches):
     (a) the reduced six families, 3 adamw steps each, card against CPU in
     ``exact_fp32``, every step started on both devices from the CPU's
     state (losses and gradient norms within 1e-5 relative); (b)
     Granite-3.0 1B-A400M and SeamlessM4T-large-v2 at full width and depth
     with fp32 masters, bf16 activations, adamw, clip 1.0 and full remat, on
     ``launch.inputs.train_batch_spec`` of train_4k with the global batch
     cut from 256 to 4 (one card holds 16 B a parameter plus one layer's
     recomputed activations): 1 warm-up + 3 timed steps, s/step, tokens/s,
     model TFLOP/s from ``launch.analytic.train_flops`` and its share of
     989 TFLOP/s, peak GB, busy share and launches of one profiled step,
     finite losses with the last timed below the 1st; (c) the four kernel
     wrappers refusing CUDA inputs that require grad before any launch, and
     launching once each under ``no_grad``; (d) ``make_fl_round`` on the
     reduced Granite with K = 4, packed wire and screen, card against CPU
     on the same uniforms (the one-level rule);
 11. model parallelism (``dist.parallel``, ``dist.placement``,
     ``dist.collectives``), its phases beside the paths they extend: (mp c)
     after the flash phase, the wgmma kernel on a TP rank's local heads at
     Llama-3-8B's serve shape (B = 4, 4,096, H 16 / KV 4 for ``model`` 2,
     H 8 / KV 2 for ``model`` 4) against the plain version, with its bound
     and SDPA's time; (mp b) inside the 32k ring phase, heads on ``model``
     = 2 emulated as two head halves through ``LocalRing(4)`` each: 20
     wgmma launches, within ``FLASH_TOL["bfloat16"]`` of the single pass
     and the plain version; (mp a) in an NCCL world of one on a 1x1 mesh,
     after the Llama-3-8B serve phases a prefill + 8 decode tokens under a
     serve plan with the weights placed as DTensors, and after Granite's
     train (b) one placed ``make_train_step`` from its state, each
     bit-equal to the unplaced run, with no collective counted and every
     gradient and output placement its parameter's; (mp d) after the train
     phases, ``launch.dryrun`` of a 4-card Llama-3-8B trainer (``data`` 2 x
     ``model`` 2, train_4k with the global batch cut from 256 to 2) as rank
     0 under torch's fake process group (no data moved: values not held):
     its collective bytes by axis and kind equal to the analytic count, its
     peak below 80 GB, s/step and per-rank state; then prefills on 1x2 and
     1x4 serve meshes (B = 4, 4,096 positions): 32 wgmma launches each at
     the local heads; then (mp e) the other four families: (e5, inside
     (mp c)) the kernel at their TP ranks' local heads (Zamba2-7B's shared
     attention H = KV = 16 at hd 112 with its window, InternVL2-26B's H 24
     / KV 4, SeamlessM4T's encoder H = KV = 8 at hd 64, non-causal) against
     plain and SDPA; (e1) the reduced RWKV6-7B, Zamba2-7B,
     SeamlessM4T-large-v2 and InternVL2-26B on a 1x1 mesh (NCCL, one
     rank): loss, gradients and prefill + 8 decode steps bit-equal to the
     unplaced runs, 0 collectives; (e2) each at full width as rank 0 of a
     1x2 serve mesh under the fake group (B = 4, 4,096 positions): time,
     peak, per-rank parameters, collectives, and one wgmma launch a
     (shared) attention layer a pass at the local heads (Zamba2 9,
     InternVL2 48, Seamless's encoder 24, RWKV6 0); (e3) Zamba2-7B's
     train_4k (global batch 2) as rank 0 of 2x2: peak under 80 GB, the
     same collectives in the warm-up and the timed step; (e4) the dry
     run's gates (``--require-seq-sharded --require-flash``) on Llama-3-8B's
     prefill_32k at B = 1 as rank 0 of 1x1x4x1: both hold, the ring's
     seq-axis send/recv counted, 32 wgmma launches a pass; each gate's
     negative control on the reduced Llama raises; then sequence
     parallelism on 1x1x4x1 under the fake group, every gated dry run
     timed without its shape log (the gates' logged step apart): (f1)
     Granite-3.0 1B-A400M's train_4k step with the seq gate, Zamba2-7B's
     gate report; (f2)-(f4) the RWKV6-7B, Zamba2-7B and Granite
     prefill_32k at B = 1 with the gates, the rings through wgmma; (f6)
     SeamlessM4T-large-v2's prefill_32k: its encoder's non-causal ring
     (144 send/recv, 96 wgmma launches a pass), the flash gate at 30,720
     positions (32,768 / 4 = its d_ff, which the gate's rule would read as
     a sequence dim) and the seq gate's report;
     (f7) its train_4k step (batch 4) and the gate's report; (f5) one
     full-width RWKV6-7B layer and Mamba2 block through ``LocalSeq(4)``
     against one scan; the rings' step kernels (and the Seamless 32k
     non-causal ring against one pass) timed early, beside the
     local-heads rows; (g) after (f), the dry run's other modes at full
     width on JAX's default meshes, each one ``dryrun.main`` call:
     Llama-3-8B's decode_32k on 16x16 (rank 0's 8 of 128 rows, the 8 KV
     heads whole in a 34.4 GB cache, peak below 80 GB), its long_500k (B 1
     whole, the 8,192-slot window), ``--fl-round --multi-pod`` at
     train_512 (client 0's block, the uplink on ``pod``) and ``--wire-ratio
     --downlink quant`` (the inter-pod ratio inside WIRE_RATIO_BAND), each
     with its peak, s/step beside its roofline terms, the fake mesh's
     creation time and its kernel launches; (h) after (g), the MoE's
     all-to-all expert dispatch (``models.moe``: JAX's capacity -> expert
     reshard): (h1) one full-width Granite-3.0 1B-A400M MoE layer in bf16
     at B = 4 x 4,096 through ``LocalExchange`` of 4 and 16 model ranks,
     every routing group's dispatched tensor and expert outputs bit-equal
     to the all-reduce route's rank by rank, the output within 2^-6 of the
     unsharded layer's largest magnitude, each route timed; (h2)
     ``benchmarks/dryrun_sweep.py``'s ``A2A_GATED`` cells, Granite's
     train_4k and prefill_32k at their own batches (256, 32) as rank 0 of
     1x4x2x16 with ``--require-alltoall``: the gate holds, the
     all-to-alls on ``model`` only, count and bytes by the formula, s/step
     and peak; the prefill's ring step on rank 0 (B = 8, 16,384 queries
     and keys) is a kernel row of its own, held against the plain version
     and timed beside the seq rings' steps; (h3) ``bench_moe_alltoall``'s
     own cell, Granite's train_512 (batch 64, 512 positions: one routing
     group across the two ``seq`` shards) as rank 0 of 2x8x2x16 with
     ``--require-alltoall``: no all-to-all byte on ``pod`` or ``data``,
     the all-to-alls on ``model`` by the formula, the group's dispatch
     summed over ``seq`` three times a layer, the ``seq`` traffic by kind,
     and the ``--require-seq-sharded`` report; (h4) one full-width bf16
     Granite MoE layer through ``LocalSeq`` at B = 64 x 512 on 2 shards
     and B = 4 x 4,096 on 16 (each group over two shards): router logits,
     queue positions, keep and every group's dispatched tensor bit-equal
     to the unsharded layer's, the output within 2^-6 of its largest
     magnitude, both timed beside the unsharded layer;
 12. one JSON line with each kernel's launches, error and times (the flash
     rows: launches summed over their paths and listed per path, and each
     checked shape's times; rows of their own for the local-heads shapes
     and the heads-on-``model`` ring).

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the repository's sources beside this file, it exits non-zero
before printing any result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM bf16 dense tensor cores
FEMNIST_U, FEMNIST_C, ROUNDS = 1024, 8, 5


def _tiny_ga():
    from repro_torch.core.genetic import GAConfig

    return GAConfig(generations=4, population=8, elitism=2, repair_infeasible=True)
SERVE_ARCH, SERVE_BATCH, SERVE_CONTEXT, SERVE_NEW = "llama3_8b", 4, 4096, 32
GRANITE_ARCH, SEAMLESS_ARCH, INTERNVL2_ARCH = (
    "granite_moe_1b_a400m", "seamless_m4t_large_v2", "internvl2_26b")
RWKV6_ARCH, ZAMBA2_ARCH = "rwkv6_7b", "zamba2_7b"


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(name: str):
    """Decorator: run, time and report one phase."""
    def wrap(fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            print(f"[phase] {name}: ok in {time.perf_counter() - t0:.3f} s", flush=True)
            return out
        return run
    return wrap


# ---------------------------------------------------------------- timing

def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn()`` on the card: CUDA events around
    ``iters`` back-to-back calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


FL_SCOPES = ("fl_decide", "fl_local_quant", "fl_aggregate")      # the object runtime's
# the fleet round's other layer ranges (repro_torch.sim.engine's docstring)
FLEET_SCOPES = ("draw_inputs", "greedy_assign", "decision_terms", "gather_active",
                "quantize_wire", "wire_aggregate", "eval_model", "round_state",
                "results_to_host")
SCOPES = ("kkt_solve", "evaluate_population", "fleet_local_sgd", "cuda_aggregate",
          "cuda_quantize", "cuda_dequantize", "cuda_flash_attention") + FL_SCOPES \
    + FLEET_SCOPES


def _is_device(e) -> bool:
    """A kernel on the card (the profiler also lists the record_function
    scopes as device-side annotations; those are ranges, not kernels)."""
    return (str(getattr(e, "device_type", "")).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False) and e.key not in SCOPES)


def kernel_ms(fn, kernel: str, iters: int = 200) -> float:
    """Mean device milliseconds of the CUDA kernel whose name contains
    ``kernel``, from a torch.profiler trace of ``iters`` calls of ``fn``
    (the kernel's own duration, free of the host's launch overhead). A
    trace that holds no such kernel is taken once more (a trace has come
    back without the device activity of a call that ran); fails when the
    second holds none either."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    for attempt in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if _is_device(e) and kernel in e.key]
        count = sum(e.count for e in hits)
        if count:
            return sum(e.self_device_time_total for e in hits) / count / 1e3
        print(f"  the profiler trace {attempt + 1} holds no device kernel named {kernel!r}",
              flush=True)
    raise SmokeFailure(f"two profiler traces hold no device kernel named {kernel!r}")


def bound(bytes_moved: float, flops: float, peak: float = FP32_FLOPS) -> tuple[float, str]:
    """Least time on the card in ms, and what bounds it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phases

@phase("environment")
def environment():
    import torch

    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    require((SRC / "repro_torch" / "kernels" / "csrc").is_dir(),
            f"the port's sources are not beside this script ({SRC / 'repro_torch'})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("tf32 off for cuDNN convolutions and CUDA matmuls: parity in full fp32")
    return card


@phase("build")
def build_kernels():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    built = build.build()
    print(f"{len(built)} kernel libraries in {time.perf_counter() - t0:.2f} s (nvcc in parallel)")
    for name, (path, seconds, log) in built.items():
        build.library(name)
        print(f"kernel library {path.relative_to(ROOT)} built in {seconds:.2f} s "
              f"(0 = reused)")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}")
    _wgmma_build_report(*built["flash_attention_wgmma"])
    _no_spills("flash_fwd_kernel (SIMT)", *built["flash_attention"])


def _no_spills(what: str, path: Path, seconds: float, log: str) -> None:
    """A kernel library built in this run spills no register (ptxas): a
    spill in a kernel loop waits on local memory where it stands."""
    if seconds == 0:
        print(f"{what}: spills not checked (library reused)")
        return
    spills = [line.strip() for line in log.splitlines() if "spill" in line]
    require(spills and all(line.startswith("0 bytes stack frame, 0 bytes spill stores, "
                                            "0 bytes spill loads") for line in spills),
            f"{what} spills: {spills}")
    print(f"{what}: no spills in its {len(spills)} instantiations (ptxas)")


def _wgmma_build_report(path: Path, seconds: float, log: str) -> None:
    """The wgmma flash kernel as built: no spills (when this run built
    it), its dynamic shared memory per CTA, and the HGMMA instructions in
    its SASS (cuobjdump of the toolkit that built it)."""
    from repro_torch.kernels import build

    _no_spills("flash_fwd_wgmma_kernel", path, seconds, log)
    lib = build.library("flash_attention_wgmma")
    print(f"flash_fwd_wgmma_kernel: dynamic shared memory per CTA "
          f"{lib.faw_shared_bytes(128)} B (hd 65-128), {lib.faw_shared_bytes(64)} B "
          f"(hd <= 64); 384 threads, setmaxnreg 240 (two consumer warpgroups) / 24 "
          f"(producer)")
    cuobjdump = Path(build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(path)],
                          capture_output=True, text=True, timeout=300)
    require(sass.returncode == 0, f"cuobjdump failed: {sass.stderr.strip()[:500]}")
    counts, fn = {}, None
    for line in sass.stdout.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            fn = found.group(1)
            counts[fn] = 0
        elif fn is not None and re.search(r"\bHGMMA\b", line):
            counts[fn] += 1
    kernels = {k: n for k, n in counts.items() if "flash_fwd_wgmma_kernel" in k}
    require(kernels and all(n > 0 for n in kernels.values()),
            f"no HGMMA in the wgmma flash kernel's SASS: {counts}")
    for k, n in kernels.items():
        print(f"  SASS: {n} HGMMA instructions in {k}")


def _agg_inputs(k: int, m: int, q_max: int, dtype, gen):
    import torch

    dev = "cuda"
    q = torch.randint(1, q_max + 1, (k,), generator=gen, device=dev)
    hi = ((torch.ones_like(q) << q) - 1)[:, None, None]
    idx = (torch.rand((k, m, 128), generator=gen, device=dev) * (hi + 1)).long()
    idx = torch.minimum(idx, hi).to(dtype)
    signs = (torch.rand((k, m, 128), generator=gen, device=dev) < 0.5).to(torch.uint8)
    scales = torch.rand((k,), generator=gen, device=dev) + 0.1
    weights = torch.rand((k,), generator=gen, device=dev)
    return idx, signs, scales, weights / weights.sum(), q


@phase("kernels vs plain on the card")
def kernels_vs_plain(zpad: int, wire_m: int):
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import stochastic_quant as sq

    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {}

    def agg_case(label, k, m, q_max, dtype):
        idx, signs, scales, weights, q = _agg_inputs(k, m, q_max, dtype, gen)
        got = sq.aggregate(idx, signs, scales, weights, q)
        want = sq.aggregate_plain(idx, signs, scales, weights, q)
        torch.cuda.synchronize()
        err = (got - want).abs()
        tol = 1e-7 + 1e-6 * want.abs()
        require(bool((err <= tol).all()),
                f"aggregate {label}: max abs err {err.max().item():.3e} over rtol 1e-6 atol 1e-7")
        print(f"aggregate {label}: K={k} M={m} {str(dtype)[6:]} max_abs_err={err.max().item():.3e}")
        return (idx, signs, scales, weights, q), err.max().item()

    # the fleet round's planes: S = 8 slots, Zpad / 128 rows, u8, q in 1..8
    main_args, main_err = agg_case("u8 main-path shape", FEMNIST_C, zpad // 128, 8, torch.uint8)
    agg_case("u16, q up to 16", FEMNIST_C, zpad // 128, 16, torch.uint16)
    agg_case("K=1024, ragged M", 1024, 37, 8, torch.uint8)
    idx, signs, scales, weights, q = main_args
    k, n = idx.shape[0], idx[0].numel()
    b_ms, b_by = bound(k * n * 2 + 4 * n + 4 * 3 * k, 3.0 * k * n)
    report["aggregate"] = dict(
        shape=f"K={k} M={zpad // 128} u8", max_abs_err=main_err, kernel="aggregate_kernel",
        call=lambda: sq.aggregate(idx, signs, scales, weights, q),
        plain_ms=cuda_ms(lambda: sq.aggregate_plain(idx, signs, scales, weights, q), 50),
        bound_ms=b_ms, bound_by=b_by,
    )

    # the wire entry point's planes: (M, 128) with M = 256-row tiles of Z
    x = torch.randn((wire_m, 128), generator=gen, device="cuda") * 0.05
    rbits = torch.randint(-(2**31), 2**31, x.shape, dtype=torch.int32, generator=gen,
                          device="cuda").view(torch.uint32)
    scale = x.abs().amax().reshape(1)
    corrupt = torch.randint(0, 256, x.shape, generator=gen, device="cuda").to(torch.uint8)
    q_err, d_err = 0.0, 0.0
    for qb in (1, 4, 8):
        i_k, s_k = sq.quantize(x, rbits, scale, qb)
        i_p, s_p = sq.quantize_plain(x, rbits, scale, qb)
        require(torch.equal(i_k, i_p) and torch.equal(s_k, s_p),
                f"quantize q={qb}: kernel is not bit-equal to its plain version")
        for planes, label in ((i_k, "own planes"), (corrupt, "corrupted plane")):
            d_k = sq.dequantize(planes, s_k, scale, qb)
            d_p = sq.dequantize_plain(planes, s_k, scale, qb)
            require(torch.equal(d_k, d_p),
                    f"dequantize q={qb} {label}: kernel is not bit-equal to its plain version")
            # L * (scale * (1 / L)) may round one ulp above scale
            require(bool((d_k.abs() <= scale * (1.0 + 2.0**-22)).all()),
                    f"dequantize q={qb} {label}: value outside [-scale, scale]")
        q_err = max(q_err, (i_k.float() - i_p.float()).abs().max().item())
        d_err = max(d_err, (d_k - d_p).abs().max().item())
        print(f"quantize/dequantize q={qb}: M={wire_m} bit-equal to plain "
              "(own planes and a corrupted plane)")
    n = x.numel()
    i4, s4 = sq.quantize(x, rbits, scale, 4)
    require(sq.quantize_variant(x, rbits, i4, s4) == "vec4",
            "quantize variants: the wire entry point's planes must take vec4")
    # quantize's one-element kernel: x a view 4 bytes off a 16-byte boundary
    xbuf = torch.empty(n + 4, device="cuda")
    x_off = xbuf[1:1 + n].view(x.shape)
    x_off.copy_(x)
    require(sq.quantize_variant(x_off, rbits, i4, s4) == "scalar",
            "quantize variants: an x view 4 bytes off must take the scalar kernel")
    for qb in range(1, 9):
        got = sq.quantize(x_off, rbits, scale, qb)
        want = sq.quantize_plain(x, rbits, scale, qb)
        require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                f"quantize q={qb} of an offset view (scalar kernel) is not bit-equal to plain")
    q_off_ms = kernel_ms(lambda: sq.quantize(x_off, rbits, scale, 4), "quantize_kernel")
    lib = build.library("stochastic_quant")
    dev, stream = torch.cuda.current_device(), build.stream(torch.device("cuda"))
    empty_ms = kernel_ms(lambda: build.check("stochastic_quant", "empty",
                                             lib.sq_empty(dev, stream)), "empty_kernel")
    b_ms, b_by = bound(n * 10 + 4, 8.0 * n)
    print(f"quantize M={wire_m} q=4 on an x view 4 bytes off (one element per thread, "
          f"bit-equal to plain for q=1..8): {q_off_ms * 1e3:.2f} us (profiler); an empty "
          f"kernel: {empty_ms * 1e3:.2f} us (profiler), the floor of any launch; "
          f"bound {b_ms * 1e3:.2f} us ({b_by})")
    report["quantize"] = dict(
        shape=f"M={wire_m} q=4", max_abs_err=q_err, kernel="quantize_kernel_vec4",
        call=lambda: sq.quantize(x, rbits, scale, 4),
        plain_ms=cuda_ms(lambda: sq.quantize_plain(x, rbits, scale, 4), 50),
        bound_ms=b_ms, bound_by=b_by, scalar_ms=q_off_ms, empty_ms=empty_ms,
    )
    # dequantize's two variants: 4 elements per thread on aligned planes (the
    # wire entry point's), one per thread on a view 3 bytes off
    buf = torch.empty(i4.numel() + 16, dtype=torch.uint8, device="cuda")
    i4_off = buf[3:3 + i4.numel()].view(i4.shape)
    i4_off.copy_(i4)
    out_probe = torch.empty(i4.shape, device="cuda")
    require(sq.dequantize_variant(i4, s4, out_probe) == "vec4"
            and sq.dequantize_variant(i4_off, s4, out_probe) == "scalar",
            "dequantize variants: aligned planes must take vec4, an offset view scalar")
    require(torch.equal(sq.dequantize(i4_off, s4, scale, 4), sq.dequantize_plain(i4, s4, scale, 4)),
            "dequantize of an offset view (scalar kernel) is not bit-equal to its plain version")
    off_ms = kernel_ms(lambda: sq.dequantize(i4_off, s4, scale, 4), "dequantize_kernel")
    print(f"dequantize M={wire_m} q=4 on a view 3 bytes off (one element per thread): "
          f"{off_ms * 1e3:.2f} us (profiler), bit-equal to plain")
    b_ms, b_by = bound(n * 6 + 4, 3.0 * n)
    report["dequantize"] = dict(
        shape=f"M={wire_m} q=4", max_abs_err=d_err, kernel="dequantize_kernel_vec4",
        call=lambda: sq.dequantize(i4, s4, scale, 4),
        plain_ms=cuda_ms(lambda: sq.dequantize_plain(i4, s4, scale, 4), 50),
        bound_ms=b_ms, bound_by=b_by,
    )
    for name, r in report.items():
        # ms: the kernel's own device time from a profiler trace; call_ms: the
        # CUDA-event time of back-to-back wrapper calls, host launch included
        call = r.pop("call")
        r["call_ms"] = cuda_ms(call, 500)
        r["ms"] = kernel_ms(call, r.pop("kernel"))
        print(f"timing {name} ({r['shape']}): kernel {r['ms'] * 1e3:.2f} us "
              f"(profiler), wrapper call {r['call_ms'] * 1e3:.2f} us (events), "
              f"bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), "
              f"plain {r['plain_ms'] * 1e3:.2f} us (events)")
    return report


KKT_CHANNELS = 128                             # the benchmark cell's C
# (report row, population P or None for one fleet)
KKT_SHAPES = (("qccf_kkt", None), ("qccf_kkt_population", 32))


def _gap(got, want) -> float:
    """Largest |got - want| in float64 (0 where both hold the same value,
    infinities and NaNs included)."""
    import torch

    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    return float(torch.where(same, 0.0, (got.double() - want.double()).abs()).max())


def _empty_kernel_ms() -> float:
    import torch
    from repro_torch.kernels import build

    lib = build.library("stochastic_quant")
    dev, stream = torch.cuda.current_device(), build.stream(torch.device("cuda"))
    return kernel_ms(lambda: build.check("stochastic_quant", "empty", lib.sq_empty(dev, stream)),
                     "empty_kernel")


@phase("the decision's KKT kernel vs its plain twin on the card")
def kkt_vs_plain(empty_ms: float | None = None) -> dict:
    """Rows ``qccf_kkt`` (U = 1,024) and ``qccf_kkt_population`` (32 x
    1,024) of the kernel table: the kernel's device time (profiler), its
    bound the launch floor (an empty kernel's device time: the work is a
    latency chain, not bytes or operations), the wrapper's host time per
    call, the plain twin's time (CUDA events around back-to-back calls)."""
    import time

    import torch
    from repro_torch.kernels import kkt

    # the card tests' inputs (no JAX): the cell's SystemParams, Z and V
    sys.path.insert(0, str(ROOT / "tests"))
    import kkt_inputs as ki

    empty_ms = _empty_kernel_ms() if empty_ms is None else empty_ms
    rows = {}
    for name, p in KKT_SHAPES:
        arrays = (ki.fleet(FEMNIST_U, KKT_CHANNELS, 33) if p is None
                  else ki.population(p, FEMNIST_U, KKT_CHANNELS, 33))
        v, w, d, theta = ki.tensors(arrays, "cuda")
        shape = f"U={FEMNIST_U}" if p is None else f"P x U={p} x {FEMNIST_U}"
        err = 0.0
        for lam_v in (0.0, 20.0, 500.0):
            args = (v, w, d, theta, ki.lam_tensor(lam_v, "cuda"), ki.SYSP, ki.Z, ki.V_WEIGHT)
            kkt.reset_launches()
            got = kkt.solve_kkt(*args)
            require(kkt.launches["kkt"] == 1, f"{name}: {kkt.launches['kkt']} launches a call")
            want = kkt.solve_kkt_plain(*args)
            torch.cuda.synchronize()
            # the row's error: the largest gap of f and q_hat over the three lam
            err = max(err, _gap(got[1], want[1]), _gap(got[3], want[3]))
            for label, g, wt in zip(("q", "f", "feasible", "q_hat", "case"), got, want):
                same = (torch.equal(g.view(torch.int32), wt.view(torch.int32))
                        if g.dtype == torch.float32 else torch.equal(g, wt))
                require(same, f"{name} lam {lam_v}: {label} differs from the plain twin in "
                              f"{int((g != wt).sum())} clients")
            codes = torch.bincount(got[4].reshape(-1).long(), minlength=7)[1:].tolist()
            print(f"{name} ({shape}) lam {lam_v}: bit-equal to the plain twin; case codes "
                  f"1..6 {codes}, grid {codes[5] / got[4].numel():.4f} of the clients, "
                  f"feasible {int(got[2].sum())}")
        args = (v, w, d, theta, ki.lam_tensor(20.0, "cuda"), ki.SYSP, ki.Z, ki.V_WEIGHT)
        call = lambda: kkt.solve_kkt(*args)           # noqa: E731
        ms = kernel_ms(call, "qccf_kkt_kernel", iters=50)
        call_ms = cuda_ms(call, 50)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            call()
        host_us = (time.perf_counter() - t0) / 50 * 1e6
        torch.cuda.synchronize()
        plain_ms = cuda_ms(lambda: kkt.solve_kkt_plain(*args), 5, warmup=1)
        print(f"timing {name} ({shape}, lam 20): kernel {ms * 1e3:.2f} us (profiler), "
              f"wrapper call {call_ms * 1e3:.2f} us (events), host {host_us:.2f} us a call, "
              f"launch floor {empty_ms * 1e3:.2f} us (empty_kernel), plain twin "
              f"{plain_ms * 1e3:.2f} us (events)")
        rows[name] = dict(shape=shape, max_abs_err=err, ms=ms, call_ms=call_ms,
                          host_us=host_us, plain_ms=plain_ms, bound_ms=empty_ms,
                          bound_by="launch floor (empty_kernel)")
    return rows


# granite-4.0-h-small's MoE layer as the model cell runs it (one client's
# 4,096 tokens, experts 0-8 of 72 held, top-10): D, F, experts, held, k, T
MOE_SHAPE = (4096, 768, 72, (0, 9), 10, 4096)


@phase("the grouped expert kernels vs per-expert products on the card, at the model cell's "
       "shapes")
def moe_grouped_vs_plain() -> tuple[dict, dict]:
    """Rows ``moe_rows_gemm`` and ``moe_wgrad_gemm`` of the kernel table, at
    the MoE layer of the model cell (``MOE_SHAPE``: D 4,096, F 768, 9 of 72
    experts held, top-10 over 4,096 tokens, routed by ``dropless_route``
    with the port's init: some 5,000 rows). Every form a layer step takes
    (``_GroupedSwiGLU``): gate and up from token-indexed rows, down from
    sorted rows, the transposed products of backward and their accumulate;
    the weight gradients from indexed and from sorted rows. Each against
    its per-expert product in float64 on the same inputs, within 1e-5 of
    the largest entry (fp32 sums of 4,096 or 768 terms in index order); the
    kernel's device time (profiler) beside the bound (2 R K N operations at
    the fp32 peak, or bytes) and the per-expert fp32 ``torch.matmul``'s
    (events). Then one layer of the dropless MoE at those shapes, forward
    and backward, its launches counted from 0: 6 rows products and 3
    weight gradients. Returns (rows, each kernel's launches in that
    layer)."""
    import torch
    from repro_torch.kernels import moe_grouped
    from repro_torch.models import moe

    d, f, n_exp, held, top_k, t = MOE_SHAPE
    gen = torch.Generator().manual_seed(35)
    p = {k: v.cuda() for k, v in moe.share_params(gen, d, f, n_exp, held).items()}
    x = torch.randn(t, d, generator=gen).cuda()
    rt = moe.dropless_route(p["router"], x, top_k, held)
    seg, rows = rt.seg, rt.rows
    bounds = seg.tolist()
    routed = bounds[-1]
    n = held[1] - held[0]
    r = rows.shape[0]
    g = torch.Generator(device="cuda").manual_seed(36)
    h = torch.randn(r, f, device="cuda", generator=g)
    dy = torch.randn(r + 1, d, device="cuda", generator=g)
    wg, wd = p["wg"], p["wd"]

    def per_expert(a, rws, b, transpose=False, dtype=torch.float64):
        """The rows of each expert by a plain product; past the last, 0."""
        out = torch.zeros((r, b.shape[1] if transpose else b.shape[2]), dtype=dtype,
                          device="cuda")
        for e in range(n):
            lo, hi = bounds[e], bounds[e + 1]
            src = (a[lo:hi] if rws is None else a[rws[lo:hi]]).to(dtype)
            out[lo:hi] = src @ (b[e].T if transpose else b[e]).to(dtype)
        return out

    def per_expert_wgrad(a, rws, b, dtype=torch.float64):
        return torch.stack([(a[bounds[e]:bounds[e + 1]] if rws is None
                             else a[rws[bounds[e]:bounds[e + 1]]]).to(dtype).T
                            @ b[bounds[e]:bounds[e + 1]].to(dtype) for e in range(n)])

    def gap(got, want) -> float:
        err = float((got.double() - want).abs().max() / want.abs().max())
        return err

    # (name, kernel call, float64 product, fp32 per-expert product, K, N)
    rows_forms = (
        ("gate, token-indexed rows, D -> F",
         lambda: moe_grouped.rows_gemm(x, rows, wg, seg, torch.empty((r, f), device="cuda")),
         lambda: per_expert(x, rows, wg), lambda: per_expert(x, rows, wg, dtype=torch.float32),
         d, f),
        ("down, sorted rows, F -> D",
         lambda: moe_grouped.rows_gemm(h, None, wd, seg, torch.empty((r, d), device="cuda")),
         lambda: per_expert(h, None, wd), lambda: per_expert(h, None, wd, dtype=torch.float32),
         f, d),
        ("backward, D -> F on the transposed down weight",
         lambda: moe_grouped.rows_gemm(dy, None, wd, seg, torch.empty((r, f), device="cuda"),
                                       transpose_b=True),
         lambda: per_expert(dy, None, wd, True),
         lambda: per_expert(dy, None, wd, True, torch.float32), d, f),
        ("backward, F -> D on the transposed gate weight, accumulated onto its first product",
         lambda: moe_grouped.rows_gemm(h, None, wg, seg, moe_grouped.rows_gemm(
             h, None, wg, seg, torch.empty((r, d), device="cuda"), transpose_b=True),
             transpose_b=True, accumulate=True),
         lambda: 2 * per_expert(h, None, wg, True),
         lambda: per_expert(h, None, wg, True, torch.float32), f, d),
    )
    wgrad_forms = (
        ("weight gradient from token-indexed rows, D x F",
         lambda: moe_grouped.wgrad_gemm(x, rows, h, seg),
         lambda: per_expert_wgrad(x, rows, h),
         lambda: per_expert_wgrad(x, rows, h, torch.float32), d, f),
        ("weight gradient from sorted rows, F x D",
         lambda: moe_grouped.wgrad_gemm(h, None, dy[:r], seg),
         lambda: per_expert_wgrad(h, None, dy[:r]),
         lambda: per_expert_wgrad(h, None, dy[:r], torch.float32), f, d),
    )
    out = {}
    for name, kernel, forms in (("moe_rows_gemm", "moe_rows_gemm_kernel", rows_forms),
                                ("moe_wgrad_gemm", "moe_wgrad_gemm_kernel", wgrad_forms)):
        shapes = {}
        for label, call, want_fn, plain, k_dim, n_dim in forms:
            moe_grouped.reset_launches()
            got = call()
            require(moe_grouped.launches[name] == (2 if "accumulated" in label else 1),
                    f"{name} {label}: {moe_grouped.launches}")
            want = want_fn()
            got_rows = got if name == "moe_wgrad_gemm" else got[:routed]
            want_rows = want if name == "moe_wgrad_gemm" else want[:routed]
            err = gap(got_rows, want_rows)
            require(err <= 1e-5, f"{name} {label}: gap {err:.3g} of the largest entry")
            ms = kernel_ms(call, kernel, iters=20)       # a launch: one product
            plain_ms = cuda_ms(plain, 10)
            flops = 2.0 * routed * k_dim * n_dim
            byts = 4.0 * (routed * (k_dim + n_dim) + n * k_dim * n_dim)
            b_ms, b_by = bound(byts, flops)
            print(f"{name} ({label}; {routed} routed rows over {n} experts, seg {bounds}): "
                  f"max gap {err:.3g} of the largest entry (float64 per-expert product); "
                  f"kernel {ms * 1e3:.1f} us (profiler), bound {b_ms * 1e3:.1f} us ({b_by}, "
                  f"{100 * b_ms / ms:.1f} %), per-expert fp32 torch.matmul "
                  f"{plain_ms * 1e3:.1f} us (events)", flush=True)
            shapes[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by)
        first = next(iter(shapes.values()))
        out[name] = dict(first, shapes=shapes, library_ms=None)
    # one layer of the dropless MoE, forward and backward, launches from 0
    leaves = {k: v.requires_grad_(True) for k, v in p.items()}
    xl = x[None].clone().requires_grad_(True)
    moe_grouped.reset_launches()
    y, _loads = moe.dropless_apply(leaves, xl, top_k=top_k, held=held)
    torch.autograd.grad(y.sum(), [xl] + list(leaves.values()))
    torch.cuda.synchronize()
    layer = dict(moe_grouped.launches)
    require(layer == {"moe_rows_gemm": 6, "moe_wgrad_gemm": 3},
            f"one MoE layer's forward and backward launched {layer}")
    print(f"one dropless MoE layer at the model cell's shapes, forward and backward: {layer}")
    return out, layer


@phase("main path: 5 QCCF rounds, FEMNIST U=1024 C=8")
def main_path():
    import numpy as np
    import torch
    from repro_torch.sim import build_sim

    t0 = time.perf_counter()
    sim = build_sim("femnist", n_clients=FEMNIST_U, n_channels=FEMNIST_C, seed=0,
                    mu=1200.0, beta=150.0, batch_size=32)
    torch.cuda.synchronize()
    print(f"build_sim: {time.perf_counter() - t0:.2f} s (host data synthesis + upload); "
          f"Z={sim.z} Zpad={sim._zpad} fleet x {tuple(sim.fleet.x.shape)} "
          f"{sim.fleet.x.numel() * 4 / 1e9:.2f} GB, tau={sim.sysp.tau}")
    require(sim.z == 246590, f"FEMNIST CNN width Z={sim.z}, want 246590")
    sim.run_compiled(1)   # warm-up: cuDNN heuristics, allocator
    _reset_all_launches()
    res = sim.run_compiled(ROUNDS)
    launches = _all_launches()
    sec = sim.run_seconds / ROUNDS
    for n in range(ROUNDS):
        q = res.q_levels[n]
        print(f"round {n}: energy={res.energy[n]:.6e} J acc={res.accuracy[n]:.4f} "
              f"loss={res.loss[n]:.4f} scheduled={int(res.n_scheduled[n])} "
              f"q={sorted(q[q > 0].tolist())} lambda1={res.lambda1[n]:.4f} "
              f"lambda2={res.lambda2[n]:.4f}")
    print(f"seconds per round: {sec:.4f} ({ROUNDS} rounds in {sim.run_seconds:.3f} s, "
          "eval on 1024 test images each round)")
    for k in ("energy", "accuracy", "loss", "latency", "payload_bits", "rates",
              "lambda1", "lambda2"):
        require(bool(np.isfinite(getattr(res, k)).all()), f"non-finite {k}")
    require(bool(torch.isfinite(sim.final_flat).all()), "non-finite final parameters")
    require(res.q_levels.shape == (ROUNDS, FEMNIST_U), f"q_levels {res.q_levels.shape}")
    require(bool((res.n_scheduled > 0).all()), "a round scheduled no client")
    require(launches["aggregate"] == ROUNDS,
            f"aggregate launched {launches['aggregate']} times in {ROUNDS} rounds")
    require(launches["kkt"] == ROUNDS,
            f"the KKT kernel launched {launches['kkt']} times in {ROUNDS} rounds")
    print(f"launches in the main path: {launches}")
    return sim, launches


POLICY_ROUNDS = 3
# (mode, q_cap): the GA at the engine's default wire (u8), the baselines at
# q_cap 16 (u16 planes), as the JAX package's suites run them
POLICY_MODES = (("compiled-ga", 8), ("no_quant", 16), ("channel_allocate", 16),
                ("principle", 16), ("same_size", 16))


def _sim_for(sim, mode: str, q_cap: int, **over):
    """A FleetSim in ``mode`` over ``sim``'s fleet, model, channel and
    constants (no second data synthesis), with a fresh entropy source;
    ``over`` replaces any of FleetSim's arguments (the channel, eps, gates)."""
    from repro_torch.sim.engine import FleetSim

    kw = dict(channel=sim.channel, eps1=sim.eps1, eps2=sim.eps2, v_weight=sim.v_weight,
              lr=sim.lr, batch_size=sim.batch_size, q_cap=q_cap, seed=sim.seed,
              hetero=sim.hetero, name=f"sim_{mode}", host_channel=sim.host_channel,
              policy_mode=mode)
    kw.update(over)
    return FleetSim(sim.fleet, sim.unravel(sim.flat0), sim.loss_fn, sim.eval_fn,
                    kw.pop("channel"), sim.sysp, **kw)


class _PlaneDtypes:
    """Records the index-plane dtype of every ``aggregate`` call while
    active, then calls the wrapper as it is (its launch count unchanged)."""

    def __enter__(self):
        from unittest import mock
        from repro_torch.kernels import stochastic_quant as sq

        real, self.dtypes = sq.aggregate, []

        def spy(idx, *args, **kwargs):
            self.dtypes.append(str(idx.dtype)[6:])
            return real(idx, *args, **kwargs)

        self._patch = mock.patch.object(sq, "aggregate", spy)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


@phase("policies: compiled GA and four baselines, FEMNIST U=1024 C=8")
def policies(sim):
    import numpy as np
    import torch

    out = {}
    for mode, q_cap in POLICY_MODES:
        psim = _sim_for(sim, mode, q_cap)
        if mode == "compiled-ga":
            warm = psim.run_compiled(1)   # round 0 schedules nobody (empty queues)
            print(f"compiled-ga warm-up round: {psim.run_seconds:.3f} s, scheduled "
                  f"{int(warm.n_scheduled[0])}, P={psim.ga_config.population}, "
                  f"G={psim.ga_config.generations}")
        _reset_all_launches()
        with _PlaneDtypes() as planes:
            res = psim.run_compiled(POLICY_ROUNDS)
        launches = _all_launches()
        sec = psim.run_seconds / POLICY_ROUNDS
        for n in range(POLICY_ROUNDS):
            q = res.q_levels[n]
            print(f"{mode} round {n}: scheduled={int(res.n_scheduled[n])} "
                  f"q={sorted(q[q > 0].tolist())} energy={res.energy[n]:.6e} J "
                  f"latency={res.latency[n]:.6e} s lambda1={res.lambda1[n]:.4f} "
                  f"lambda2={res.lambda2[n]:.4f}")
        print(f"{mode}: {sec:.4f} s per round ({POLICY_ROUNDS} rounds in "
              f"{psim.run_seconds:.3f} s), aggregate launches per round "
              f"{launches['aggregate'] / POLICY_ROUNDS:g}, index planes {sorted(set(planes.dtypes))}")
        for k in ("energy", "accuracy", "loss", "latency", "payload_bits", "rates",
                  "lambda1", "lambda2"):
            require(bool(np.isfinite(getattr(res, k)).all()), f"{mode}: non-finite {k}")
        require(bool(torch.isfinite(psim.final_flat).all()), f"{mode}: non-finite parameters")
        require(launches["aggregate"] == POLICY_ROUNDS,
                f"{mode}: aggregate launched {launches['aggregate']} times in "
                f"{POLICY_ROUNDS} rounds")
        want = "uint8" if q_cap <= 8 else "uint16"
        require(planes.dtypes == [want] * POLICY_ROUNDS,
                f"{mode} at q_cap {q_cap}: index planes {planes.dtypes}, want {want}")
        require(int(res.n_scheduled.max()) > 0, f"{mode}: no round scheduled a client")
        require(int(res.q_levels.max()) <= q_cap, f"{mode}: q above q_cap {q_cap}")
        if mode == "compiled-ga":
            sched = res.q_levels[res.q_levels > 0]
            require(bool(((sched >= 1) & (sched <= q_cap)).all()), f"GA: q outside [1, {q_cap}]")
            t_max = psim.sysp.t_max
            require(bool((res.latency <= t_max * (1 + 1e-5)).all()),
                    f"GA: latency {res.latency.max():.6e} above t_max {t_max}")
        # the KKT runs in the GA's fitness (one launch a generation) and its
        # winner's record, in compiled-ga and in same_size's search at the
        # mean size; the other baselines decide in closed form
        ga = mode in ("compiled-ga", "same_size")
        kkt_want = (psim.ga_config.generations + 1 if ga else 0) * POLICY_ROUNDS
        require(launches["kkt"] == kkt_want,
                f"{mode}: the KKT kernel launched {launches['kkt']} times, want {kkt_want}")
        out[mode] = dict(s_per_round=sec, scheduled=res.n_scheduled.tolist(),
                         aggregate_per_round=launches["aggregate"] / POLICY_ROUNDS,
                         kkt=launches["kkt"])
        if mode == "compiled-ga":
            ga_sim = psim
        else:
            del psim
    _profile_ga_round(ga_sim)
    return out


TELEMETRY_ROUNDS = 3
# the taps a greedy round without faults or downlink defines in every round
_GREEDY_TAPS = ("data_term", "quant_term", "energy_comp", "energy_comm", "energy_timeout",
                "n_timeout", "q_mean", "q_max", "q_cont_mean", "quant_mse")
_OUTPUTS = ("energy", "accuracy", "loss", "n_scheduled", "q_levels", "latency", "payload_bits",
            "rates", "lambda1", "lambda2")


def _same_outputs(label: str, a, b, sim_a, sim_b) -> None:
    import numpy as np
    import torch

    for k in _OUTPUTS:
        require(np.array_equal(getattr(a, k), getattr(b, k)),
                f"{label}: {k} differs between telemetry on and off")
    require(torch.equal(sim_a.final_flat, sim_b.final_flat),
            f"{label}: the final model differs between telemetry on and off")


@phase("telemetry: taps and the run ledger, FEMNIST U=1024 C=8")
def telemetry(sim):
    """Greedy rounds with every tap on and a ledger against the same rounds
    with telemetry off (bit-equal outputs), then one compiled-GA round the
    same way; the ledger validated and summarized."""
    import tempfile

    import numpy as np
    from repro_torch.obs import METRIC_FIELDS, Ledger, MetricsConfig, read_ledger, report

    on_cfg = MetricsConfig(enabled=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "ledger.jsonl")
        on = _sim_for(sim, "greedy", 8, telemetry=on_cfg)
        off = _sim_for(sim, "greedy", 8)
        on.run_compiled(1)         # warm-up: the taps' first launches
        secs = {"on": [], "off": []}
        for i, turn in enumerate(("off", "on") * 3):
            psim = on if turn == "on" else off
            # each tapped run its own run in the ledger
            on.ledger = Ledger(path, run_id=f"greedy-{i}")
            _reset_all_launches()
            res = psim.run_compiled(TELEMETRY_ROUNDS)
            launches = _all_launches()
            require(launches["aggregate"] == TELEMETRY_ROUNDS,
                    f"telemetry {turn}: aggregate launched {launches['aggregate']} times in "
                    f"{TELEMETRY_ROUNDS} rounds")
            secs[turn].append(psim.run_seconds / TELEMETRY_ROUNDS)
            if turn == "on":
                res_on = res
            else:
                res_off = res
        _same_outputs("greedy", res_on, res_off, on, off)
        m = res_on.metrics
        require(res_off.metrics is None and set(m) == set(METRIC_FIELDS),
                "telemetry: the taps are missing or present when off")
        for k in _GREEDY_TAPS:
            require(bool(np.isfinite(m[k]).all()), f"telemetry: non-finite {k} {m[k]}")
        for k in ("ga_best", "ga_median", "dl_payload_bits", "dl_mse", "n_dropped"):
            require(bool(np.isnan(m[k]).all()), f"telemetry: {k} defined in a greedy round")
        require(np.allclose(m["energy_comp"] + m["energy_comm"], res_on.energy, rtol=1e-5),
                "telemetry: the energy split does not add up to the round's energy")
        for n in range(TELEMETRY_ROUNDS):
            print(f"taps round {n}: " + " ".join(f"{k}={m[k][n]:.6g}" for k in (
                "q_mean", "q_max", "q_cont_mean", "corr_q_d", "quant_mse", "energy_comp",
                "energy_comm", "data_term", "quant_term")))
        s_on, s_off = float(np.mean(secs["on"])), float(np.mean(secs["off"]))
        fastest = min(secs["on"]) / min(secs["off"]) - 1
        print(f"greedy s/round with telemetry on {s_on:.4f} (turns {secs['on']}) against off "
              f"{s_off:.4f} (turns {secs['off']}), off and on alternating: "
              f"{100 * (s_on / s_off - 1):+.1f} % (means), {100 * fastest:+.1f} % (fastest "
              f"turns); aggregate launches {TELEMETRY_ROUNDS} per run of {TELEMETRY_ROUNDS} rounds")
        # what the taps add to a round, free of the host clock's spread: its
        # kernel launches and device time under the profiler
        cost = {}
        for turn, psim in (("off", off), ("on", on)):
            on.ledger = Ledger(None)
            _, prof = _profiled(f"greedy round, telemetry {turn}",
                                lambda: psim.run_compiled(1), top=0)
            kernels = [e for e in prof.key_averages() if _is_device(e)]
            cost[turn] = (sum(e.count for e in kernels),
                          sum(e.self_device_time_total for e in kernels) / 1e3)
        print(f"the taps add {cost['on'][0] - cost['off'][0]} kernel launches to a greedy "
              f"round ({cost['off'][0]} -> {cost['on'][0]}) and "
              f"{cost['on'][1] - cost['off'][1]:+.3f} ms of device time "
              f"({cost['off'][1]:.3f} -> {cost['on'][1]:.3f} ms)")

        ga = _sim_for(sim, "compiled-ga", 8, telemetry=on_cfg, ledger=Ledger(path, run_id="ga"))
        ga_off = _sim_for(sim, "compiled-ga", 8)
        _reset_all_launches()
        g = ga.run_compiled(1)
        launches = _all_launches()
        require(launches["aggregate"] == 1,
                f"telemetry GA: aggregate launched {launches['aggregate']} times in one round")
        g_off = ga_off.run_compiled(1)
        _same_outputs("compiled-ga", g, g_off, ga, ga_off)
        gm = g.metrics
        require(bool(np.isfinite(gm["ga_best"]).all() and np.isfinite(gm["ga_median"]).all()),
                f"telemetry GA: ga_best {gm['ga_best']} ga_median {gm['ga_median']}")
        require(bool((gm["ga_best"] <= gm["ga_median"]).all()),
                f"telemetry GA: ga_best {gm['ga_best']} above ga_median {gm['ga_median']}")
        print(f"compiled-ga round with taps: {ga.run_seconds:.3f} s (off {ga_off.run_seconds:.3f}"
              f" s), ga_best={gm['ga_best'][0]:.6g} ga_median={gm['ga_median'][0]:.6g}, "
              f"scheduled {int(g.n_scheduled[0])}, bit-equal to the round without taps")

        events = read_ledger(path)      # validates every event
        kinds = [e["event"] for e in events]
        require(kinds.count("run_header") == 4 and kinds.count("timing") == 4
                and kinds.count("round") == 3 * TELEMETRY_ROUNDS + 1,
                f"ledger events {sorted(set(kinds))}: {len(events)} in all")
        print(f"ledger: {len(events)} events, every one valid; its summaries:")
        for summary in report.summarize(path):
            print(report.render(summary))
    return dict(s_on=s_on, s_off=s_off)


SCENARIO_ROUNDS = 3
# every fault channel fires at these rates (3 rounds x 8 slots)
AGGRESSIVE_FAULTS = dict(outage_p=0.3, fade_p=0.2, corrupt_p=0.5, nan_p=0.25)


class _RoundOuts:
    """Records each round's output dict (the fault counters included) of a
    sim's ``_round_body`` while active; the round runs as it is."""

    def __init__(self, sim):
        self.sim, self.outs = sim, []

    def __enter__(self):
        real = self.sim._round_body

        def spy(carry, ridx, with_eval):
            carry, out = real(carry, ridx, with_eval)
            self.outs.append(out)
            return carry, out

        self.sim._round_body = spy
        return self

    def __exit__(self, *exc):
        del self.sim._round_body

    def counts(self, key) -> list:
        return [float(o[key]) for o in self.outs]


def _scenario_run(label: str, psim) -> dict:
    """One warm-up round, then SCENARIO_ROUNDS rounds of ``run_compiled``
    with the launch counts read around them; prints and checks each round."""
    import numpy as np
    import torch

    psim.run_compiled(1)
    _reset_all_launches()
    with _RoundOuts(psim) as rec:
        res = psim.run_compiled(SCENARIO_ROUNDS)
    launches = _all_launches()
    sec = psim.run_seconds / SCENARIO_ROUNDS
    for n in range(SCENARIO_ROUNDS):
        q = res.q_levels[n]
        extra = ""
        if psim.faults.enabled:
            extra = (f" dropped={rec.counts('n_dropped')[n]:g} timeouts="
                     f"{rec.counts('n_timeout_real')[n]:g} screened={rec.counts('n_screened')[n]:g}")
        print(f"{label} round {n}: scheduled={int(res.n_scheduled[n])} "
              f"q={sorted(q[q > 0].tolist())} lambda1={res.lambda1[n]:.4f} "
              f"lambda2={res.lambda2[n]:.4f} acc={res.accuracy[n]:.4f}{extra}")
    print(f"{label}: {sec:.4f} s per round ({SCENARIO_ROUNDS} rounds in {psim.run_seconds:.3f} s), "
          f"aggregate launches {launches['aggregate']} in {SCENARIO_ROUNDS} rounds")
    for k in ("energy", "accuracy", "loss", "latency", "payload_bits", "rates",
              "lambda1", "lambda2"):
        require(bool(np.isfinite(getattr(res, k)).all()), f"{label}: non-finite {k}")
    require(bool(torch.isfinite(psim.final_flat).all()), f"{label}: non-finite parameters")
    require(launches["aggregate"] == SCENARIO_ROUNDS,
            f"{label}: aggregate launched {launches['aggregate']} times in {SCENARIO_ROUNDS} rounds")
    require(int(res.n_scheduled.max()) > 0, f"{label}: no round scheduled a client")
    return dict(s_per_round=sec, rec=rec, res=res)


@phase("scenarios, downlink, faults, segments: FEMNIST U=1024 C=8, greedy")
def scenarios(sim):
    import torch
    from repro_torch.sim import build_sim
    from repro_torch.sim.engine import DownlinkConfig, drop_and_calibrate
    from repro_torch.sim.entropy import DeviceEntropy
    from repro_torch.sim.scenario import FaultSpec, get_scenario

    out = {}
    cf = get_scenario("cellfree_a4", n_clients=FEMNIST_U, n_channels=FEMNIST_C)
    ent = DeviceEntropy(sim.seed, "cuda")
    channel, _, eps1, eps2 = drop_and_calibrate(
        cf.channel, cf.topology, sim.seed, ent, "cuda", sim.fleet.d_sizes, sim.z, sim.sysp,
        cf.lyapunov.target_q)
    d = channel.distances
    print(f"cellfree_a4 drop: distances {tuple(d.shape)} in [{d.min().item():.2f}, "
          f"{d.max().item():.2f}] m, association {channel.association}")
    faulty = get_scenario("single_bs_faulty", n_clients=FEMNIST_U, n_channels=FEMNIST_C)
    runs = (
        ("cellfree_a4", dict(channel=channel, eps1=eps1, eps2=eps2, entropy=ent,
                             host_channel=None, name="sim_cellfree_a4_qccf")),
        ("single_bs_faulty", dict(faults=faulty.faults, name="sim_single_bs_faulty_qccf")),
        ("downlink quant", dict(downlink=DownlinkConfig("quant"))),
        ("downlink delta", dict(downlink=DownlinkConfig("delta"))),
        ("aggressive faults", dict(faults=FaultSpec(**AGGRESSIVE_FAULTS))),
    )
    for label, over in runs:
        out[label] = _scenario_run(label, _sim_for(sim, "greedy", 8, **over))
    rec = out["aggressive faults"]["rec"]
    dropped, timeouts = sum(rec.counts("n_dropped")), sum(rec.counts("n_timeout_real"))
    screened = sum(rec.counts("n_screened"))
    print(f"aggressive faults over {SCENARIO_ROUNDS} rounds: {screened:g} slots screened, "
          f"{dropped:g} in outage, {timeouts:g} realized timeouts, "
          f"{screened - dropped - timeouts:g} or more with a corrupt or non-finite payload")
    require(dropped > 0 and screened > dropped + timeouts,
            "aggressive faults: an outage and a payload screen must both fire")
    # noniid_a01 changes the data: its own synthesis, freed at the end
    t0 = time.perf_counter()
    ni = build_sim("femnist", scenario="noniid_a01", n_clients=FEMNIST_U, n_channels=FEMNIST_C,
                   seed=0, mu=1200.0, beta=150.0, batch_size=32)
    torch.cuda.synchronize()
    print(f"noniid_a01 build_sim: {time.perf_counter() - t0:.2f} s (Dirichlet(0.1) synthesis "
          f"+ upload); hetero in [{ni.hetero.min():.4f}, {ni.hetero.max():.4f}]")
    require(ni.hetero is not None and ni.hetero.min() >= 1.0 and ni.hetero.max() > 1.0,
            "noniid_a01: no heterogeneity multiplier")
    out["noniid_a01"] = _scenario_run("noniid_a01", ni)
    del ni
    gc.collect()
    torch.cuda.empty_cache()
    out["segments"] = _segments(sim, faulty.faults, DownlinkConfig("delta"))
    for r in out.values():
        r.pop("rec", None), r.pop("res", None)
    return out


def _segments(sim, faults, downlink) -> dict:
    """On one sim, under the faulty scenario's faults and the delta downlink
    (every carry slot and the generator state): run_compiled(6) twice, then
    run_compiled(6, segment=2, ckpt_dir) and resume_compiled from the
    round-4 checkpoint; all four bit-equal. Each run starts from the sim's
    own generator state and runs in the engine's fixed numeric mode (fp32,
    cuDNN's deterministic algorithms), so no fresh sim and no flag of the
    caller's is needed."""
    import tempfile
    from unittest import mock

    import numpy as np
    import torch
    from repro_torch.sim import engine

    fields = ("energy", "accuracy", "loss", "q_levels", "rates", "lambda1", "lambda2")

    def same(a, b):
        return all(np.array_equal(getattr(a, f), getattr(b, f)) for f in fields)

    saves = []
    real_save = engine.ckpt.save_checkpoint

    def timed_save(*args, **kwargs):
        t0 = time.perf_counter()
        path = real_save(*args, **kwargs)
        saves.append((time.perf_counter() - t0, Path(path).stat().st_size))
        return path

    seg_sim = _sim_for(sim, "greedy", 8, faults=faults, downlink=downlink)
    full = seg_sim.run_compiled(6)
    full_flat = seg_sim.final_flat.clone()
    again = seg_sim.run_compiled(6)
    require(same(full, again) and torch.equal(full_flat, seg_sim.final_flat),
            "two run_compiled(6) calls on one sim differ")
    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.object(engine.ckpt, "save_checkpoint", timed_save):
        seg = seg_sim.run_compiled(6, segment=2, ckpt_dir=tmp)
        require(same(full, seg) and torch.equal(full_flat, seg_sim.final_flat),
                "segmented run differs from the unsegmented one")
        resumed = seg_sim.resume_compiled(tmp)
    require(same(full, resumed) and torch.equal(full_flat, seg_sim.final_flat),
            "resumed run differs from the unsegmented one")
    # the resume runs rounds 4-5, the last segment, which writes none
    require(len(saves) == 2, f"{len(saves)} checkpoints written, want after rounds 2 and 4")
    for (sec, size), step in zip(saves, (2, 4)):
        print(f"segments: checkpoint after round {step}: {size / 1e6:.3f} MB npz in "
              f"{sec * 1e3:.2f} ms")
    print("segments, one sim: run_compiled(6) twice, run_compiled(6, segment=2, ckpt_dir) and "
          "resume_compiled from the round-4 checkpoint all bit-equal (q, schedule, energy, "
          f"accuracy, queues, final parameters); scheduled {full.n_scheduled.tolist()}")
    return dict(saves=saves)


def _numeric_flags():
    """The four flags a caller may set that change a run's convolutions."""
    import torch

    return ((torch.backends.cudnn, "allow_tf32"), (torch.backends.cuda.matmul, "allow_tf32"),
            (torch.backends.cudnn, "deterministic"), (torch.backends.cudnn, "benchmark"))


def _flag_values() -> list:
    return [getattr(mod, name) for mod, name in _numeric_flags()]


def _set_flags(values) -> None:
    for (mod, name), value in zip(_numeric_flags(), values):
        setattr(mod, name, value)


@phase("numeric scope: the engine's fp32 and deterministic cuDNN, whatever the caller set")
def numeric_scope(sim) -> dict:
    """A greedy run with TF32 and cuDNN's autotuned algorithms set globally
    is bit-equal to one under this script's flags, and the caller's flags
    come back; a convolution inside the engine's scope is fp32-exact where
    the same one under global TF32 is not; and what cuDNN's deterministic
    algorithms cost one greedy round's local SGD (S = 8 slots, tau = 6,
    batch 32 at the FEMNIST width), against its default algorithms, TF32
    off in both."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.device import exact_fp32
    from repro_torch.sim.entropy import DeviceEntropy
    from repro_torch.sim.fleet import fleet_local_sgd, gather_active

    fields = ("energy", "accuracy", "loss", "q_levels", "rates", "lambda1", "lambda2")
    psim = _sim_for(sim, "greedy", 8)
    ours = _flag_values()
    exact = psim.run_compiled(3)
    exact_flat = psim.final_flat.clone()
    loose = [True, True, False, True]
    _set_flags(loose)
    try:
        res = psim.run_compiled(3)
        after = _flag_values()
    finally:
        _set_flags(ours)
    require(after == loose, f"the run left the caller's flags {loose} as {after}")
    require(all(np.array_equal(getattr(exact, f), getattr(res, f)) for f in fields)
            and torch.equal(exact_flat, psim.final_flat),
            "a run under global TF32 and autotuned cuDNN differs from one under fp32 flags")
    print(f"greedy run_compiled(3) with {dict(zip(['cudnn.allow_tf32', 'matmul.allow_tf32', 'deterministic', 'benchmark'], loose))} set "
          "globally: bit-equal to the run under TF32-off flags; the caller's flags restored")

    # a convolution of the CNN's shape inside and outside the scope, against fp64
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((32, 32, 28, 28), generator=gen, device="cuda")
    w = torch.randn((64, 32, 5, 5), generator=gen, device="cuda") * 0.05
    want = F.conv2d(x.double().cpu(), w.double().cpu(), padding=2)
    _set_flags(loose)
    try:
        tf32 = F.conv2d(x, w, padding=2).double().cpu()
        with exact_fp32():
            fp32 = F.conv2d(x, w, padding=2).double().cpu()
    finally:
        _set_flags(ours)
    scale = want.abs().max().item()
    err_fp32 = (fp32 - want).abs().max().item() / scale
    err_tf32 = (tf32 - want).abs().max().item() / scale
    require(err_fp32 < 1e-5, f"conv inside the engine's scope: rel err {err_fp32:.2e} (not fp32)")
    print(f"conv2d (32x32x28x28, 5x5x64) vs fp64, relative to max |out|: inside the scope "
          f"{err_fp32:.2e}, under global TF32 {err_tf32:.2e}")

    # the cost of deterministic cuDNN in one greedy round's local SGD
    slots = torch.arange(FEMNIST_C, device="cuda")
    x_s, y_s, n_s = gather_active(sim.fleet, slots)
    bidx = DeviceEntropy(5, "cuda").batch_indices(0, n_s, sim.sysp.tau, sim.batch_size)
    params = sim.unravel(sim.flat0)

    def sgd():
        return fleet_local_sgd(sim.loss_fn, sim.sysp.tau, params, x_s, y_s, bidx, sim.lr)

    times = {True: [], False: []}
    with torch.no_grad():
        for det in (True, False, False, True):    # in turns
            with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=det,
                                            allow_tf32=False):
                times[det].append(cuda_ms(sgd, 10, warmup=2))
    det_ms, def_ms = (float(np.mean(times[k])) for k in (True, False))
    print(f"fleet_local_sgd of one greedy round (S={FEMNIST_C}, tau={sim.sysp.tau}, batch "
          f"{sim.batch_size}, TF32 off): deterministic cuDNN {det_ms:.3f} ms "
          f"({', '.join(f'{t:.3f}' for t in times[True])}), default algorithms {def_ms:.3f} ms "
          f"({', '.join(f'{t:.3f}' for t in times[False])}): {det_ms / def_ms - 1:+.1%}")
    return dict(sgd_deterministic_ms=det_ms, sgd_default_ms=def_ms)


SCENARIO_REFERENCES = (
    ("faults", dict(faults=dict(outage_p=0.15, outage_corr=0.4, fade_p=0.1, corrupt_p=0.05,
                                nan_p=0.02))),
    ("downlink delta", dict(downlink="delta")),
    ("cellfree_a4", dict(scenario="cellfree_a4")),
    ("compiled-ga + downlink delta", dict(policy_mode="compiled-ga", downlink="delta")),
)


@phase("small-input references: faults, downlink, cell-free, GA + downlink, card vs CPU; "
       "run_compiled vs run_host_policy on the card")
def scenario_references():
    import numpy as np
    from repro_torch.models import cnn
    from repro_torch.sim import build_sim
    from repro_torch.sim.scenario import FaultSpec

    params = cnn.init_params(cnn.TINY_CNN, 0, device="cpu")

    def options(kw):
        kw = dict(kw)
        if "faults" in kw:
            kw["faults"] = FaultSpec(**kw["faults"])
        if kw.get("policy_mode") == "compiled-ga":
            kw["ga_config"] = _tiny_ga()
        return kw

    for label, kw in SCENARIO_REFERENCES:
        runs = {}
        for dev in ("cuda", "cpu"):
            sim = build_sim("tiny", n_clients=8, n_channels=4, seed=0, n_test=64, device=dev,
                            init_params=params, entropy=_HostDraws(0, dev), **options(kw))
            runs[dev] = sim.run_compiled(4)
        g, c = runs["cuda"], runs["cpu"]
        require(np.array_equal(g.q_levels, c.q_levels), f"{label}: q differs between card and CPU")
        require(np.array_equal(g.rates > 0, c.rates > 0),
                f"{label}: schedule differs between card and CPU")
        for k, rtol in (("energy", 1e-5), ("rates", 1e-5), ("lambda1", 1e-4), ("lambda2", 1e-4),
                        ("loss", 1e-3)):
            a, b = getattr(g, k), getattr(c, k)
            require(np.allclose(a, b, rtol=rtol, atol=1e-12), f"{label}: {k} card {a} vs CPU {b}")
        require(np.abs(g.accuracy - c.accuracy).max() <= 1 / 64, f"{label}: accuracy > 1/64")
        require(int(g.n_scheduled.max()) > 0, f"{label}: no round scheduled a client")
        print(f"{label} card vs CPU (4 rounds): q and schedule identical, scheduled "
              f"{g.n_scheduled.tolist()}, energy max rel "
              f"{np.max(np.abs(g.energy - c.energy) / np.maximum(c.energy, 1e-30)):.2e}, "
              f"lambda2 max rel {np.max(np.abs(g.lambda2 / np.maximum(c.lambda2, 1e-30) - 1)):.2e}")
    # the compiled runs against their numpy oracles on the card
    for label, kw in (SCENARIO_REFERENCES[0], SCENARIO_REFERENCES[1]):
        def make():
            return build_sim("tiny", n_clients=8, n_channels=4, seed=0, n_test=64,
                             **options(kw))

        scan = make().run_compiled(4)
        sim = make()
        host = sim.run_host_policy(sim.make_host_policy(), 4)
        q_h = np.stack([r.q_levels for r in host.records])
        e_h = np.array([r.energy for r in host.records])
        require(np.array_equal(scan.q_levels, q_h), f"{label} replay: q differs")
        require(np.array_equal(scan.n_scheduled, [r.n_scheduled for r in host.records]),
                f"{label} replay: schedule differs")
        require(np.allclose(scan.energy, e_h, rtol=1e-5, atol=1e-12),
                f"{label} replay: energy {scan.energy} vs {e_h}")
        print(f"{label}: run_compiled == run_host_policy on the card over 4 rounds: q and "
              f"schedule identical, energy max rel "
              f"{np.max(np.abs(scan.energy - e_h) / np.maximum(e_h, 1e-30)):.2e}")


def _profile_ga_round(psim):
    """One GA round under the profiler, from the state after two rounds
    (queues no longer empty): launches, busy share, host spans."""
    import torch

    carry = psim._init_carry()
    with torch.no_grad():
        for n in range(2):
            carry, _ = psim._round_body(carry, n, with_eval=True)

        def one():
            return psim._round_body(carry, 2, with_eval=True)

        _, prof = _profiled("compiled-GA round (P=32, G=30)", one, top=10)
    spans = {}
    for e in prof.events():
        if e.name in SCOPES and not str(e.device_type).endswith("CUDA"):
            spans[e.name] = spans.get(e.name, 0.0) + e.cpu_time_total
    print("host spans of the scopes in the GA round (ms, under the profiler): " + ", ".join(
        f"{k}={v / 1e3:.2f}" for k, v in sorted(spans.items())))


class _HostDraws:
    """The default entropy source's draws, made on the CPU from one
    generator and moved to the run's device, so a CPU run and a card run
    see the same numbers."""

    def __init__(self, seed: int, device) -> None:
        import torch
        from repro_torch.sim.entropy import DeviceEntropy

        self.inner = DeviceEntropy(seed, "cpu")
        self.device = torch.device(device)

    def rates(self, ridx, channel):
        import dataclasses

        host = dataclasses.replace(channel, distances=channel.distances.cpu())
        return self.inner.rates(ridx, host).to(self.device)

    def ga_draws(self, ridx, n_clients, n_channels, cfg):
        return self.inner.ga_draws(ridx, n_clients, n_channels, cfg).to(self.device)

    def batch_indices(self, ridx, n_s, tau, b):
        return self.inner.batch_indices(ridx, n_s.cpu(), tau, b).to(self.device)

    def uniforms(self, ridx, s, zpad):
        return self.inner.uniforms(ridx, s, zpad).to(self.device)

    def fault_draws(self, ridx, n_clients, s, zpad):
        return self.inner.fault_draws(ridx, n_clients, s, zpad).to(self.device)

    def downlink_uniforms(self, ridx, z):
        return self.inner.downlink_uniforms(ridx, z).to(self.device)

    def drop_uniforms(self, n_clients):
        return tuple(u.to(self.device) for u in self.inner.drop_uniforms(n_clients))

    def probe_normals(self, shape):
        return tuple(n.to(self.device) for n in self.inner.probe_normals(shape))


@phase("small-input reference: tiny task U=8 C=4, card vs CPU, same draws")
def small_reference():
    import numpy as np
    import torch
    from repro_torch.models import cnn
    from repro_torch.sim import build_sim

    params = cnn.init_params(cnn.TINY_CNN, 0, device="cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        sim = build_sim("tiny", n_clients=8, n_channels=4, seed=0, n_test=64, device=dev,
                        init_params=params, entropy=_HostDraws(0, dev))
        runs[dev] = (sim, sim.run_compiled(3))
    (gs, g), (cs, c) = runs["cuda"], runs["cpu"]
    require(np.array_equal(g.q_levels, c.q_levels), "q differs between card and CPU")
    require(np.array_equal(g.rates, c.rates), "schedule differs between card and CPU")
    for k, rtol in (("energy", 1e-5), ("lambda1", 1e-4), ("lambda2", 1e-4), ("loss", 1e-3)):
        a, b = getattr(g, k), getattr(c, k)
        require(np.allclose(a, b, rtol=rtol, atol=0), f"{k} card {a} vs CPU {b}")
    require(np.abs(g.accuracy - c.accuracy).max() <= 1 / 64, "accuracy differs > 1/64")
    # The card's SGD differs from the CPU's in the last bits (shown below);
    # where a uniform sits at its rounding boundary that moves a coordinate
    # one quantizer level. So most coordinates agree within 1e-5, and every
    # one within the largest level w_k theta_k / (2^q_k - 1) of a scheduled
    # slot in any round, read from a step-by-step replay of the CPU run.
    level, replay = _one_level(params, rounds=3)
    require(torch.equal(replay, cs.final_flat), "step replay differs from run_compiled")
    diff = (gs.final_flat.cpu() - cs.final_flat).abs()
    frac = (diff <= 1e-5).float().mean().item()
    require(frac >= 0.997, f"only {frac:.5f} of coordinates within 1e-5")
    require(diff.max().item() <= level + 1e-5,
            f"final params differ by {diff.max().item():.3e}, above one level {level:.3e}")
    print(f"card vs CPU: q and schedule identical over 3 rounds, energy max rel "
          f"{np.max(np.abs(g.energy / c.energy - 1)):.2e}, final params max abs "
          f"{diff.max().item():.2e} (one-level bound {level:.2e}), "
          f"{frac:.5f} of coordinates within 1e-5")
    _drift_source(gs, cs)
    # the compiled GA on the same draws (its GA draws included)
    tiny_ga, ga = _tiny_ga(), {}
    for dev in ("cuda", "cpu"):
        sim = build_sim("tiny", n_clients=8, n_channels=4, seed=0, n_test=64, device=dev,
                        init_params=params, entropy=_HostDraws(0, dev),
                        policy_mode="compiled-ga", ga_config=tiny_ga)
        ga[dev] = sim.run_compiled(4)
    g, c = ga["cuda"], ga["cpu"]
    require(np.array_equal(g.q_levels, c.q_levels), "GA: q differs between card and CPU")
    require(np.array_equal(g.rates > 0, c.rates > 0), "GA: schedule differs between card and CPU")
    require(np.allclose(g.energy, c.energy, rtol=1e-5, atol=1e-12),
            f"GA: energy card {g.energy} vs CPU {c.energy}")
    require(int(g.n_scheduled.max()) > 0, "GA: no round scheduled a client")
    print(f"compiled GA card vs CPU (P={tiny_ga.population}, G={tiny_ga.generations}, 4 rounds): "
          f"q and schedule identical, scheduled {g.n_scheduled.tolist()}, energy max rel "
          f"{np.max(np.abs(g.energy - c.energy) / np.maximum(c.energy, 1e-30)):.2e}")


@phase("replay on the card: run_compiled vs run_host_policy, tiny task U=8 C=4")
def replay_reference():
    import numpy as np
    from repro_torch.sim import build_sim

    tiny_ga = _tiny_ga()

    def make(mode):
        return build_sim("tiny", n_clients=8, n_channels=4, seed=0, n_test=64,
                         policy_mode=mode, ga_config=tiny_ga)

    def check(label, scan, host):
        q_h = np.stack([r.q_levels for r in host.records])
        e_h = np.array([r.energy for r in host.records])
        require(np.array_equal(scan.q_levels, q_h), f"{label}: q differs")
        require(np.array_equal(scan.n_scheduled, [r.n_scheduled for r in host.records])
                and np.array_equal(scan.rates > 0, np.stack([r.rates for r in host.records]) > 0),
                f"{label}: schedule differs")
        require(np.allclose(scan.energy, e_h, rtol=1e-5, atol=1e-12),
                f"{label}: energy scan {scan.energy} vs replay {e_h}")
        print(f"{label} over 4 rounds: q and schedule identical, scheduled "
              f"{scan.n_scheduled.tolist()}, energy max rel "
              f"{np.max(np.abs(scan.energy - e_h) / np.maximum(e_h, 1e-30)):.2e}")

    # the scenario names of the two QCCF modes (qccf -> greedy, qccf_ga -> compiled-ga)
    for mode in ("qccf", "qccf_ga"):
        scan = make(mode).run_compiled(4)
        sim = make(mode)
        policy = sim.make_host_policy()
        check(f"{sim.policy_mode}: run_compiled == run_host_policy({type(policy).__name__})",
              scan, sim.run_host_policy(policy, 4))
    host_ga = make("host-ga").run(4)
    require(host_ga.name == "host_ga", f"host-ga run() returned {host_ga.name!r}")
    check("host-ga: run() == compiled-ga run_compiled", scan, host_ga)


def _one_level(params, rounds: int):
    """Largest one-level step w_k theta_k / (2^q_k - 1) over the scheduled
    slots of ``rounds`` CPU rounds of the small reference, and its final
    parameters."""
    import numpy as np
    from repro_torch.sim import build_sim

    sim = build_sim("tiny", n_clients=8, n_channels=4, seed=0, n_test=64, device="cpu",
                    init_params=params, entropy=_HostDraws(0, "cpu"))
    d = sim.fleet.n_samples.double().numpy()
    carry, level = sim._init_carry(), 0.0
    for n in range(rounds):
        carry, out = sim._round_body(carry, n, with_eval=False)
        q = out["q_levels"].numpy()
        a = q > 0
        w = np.where(a, d, 0.0) / (d * a).sum()
        theta = carry[3].double().numpy()     # this round's slot ranges where a
        step = w * theta / np.maximum(2.0 ** q - 1.0, 1.0)
        level = max(level, float(np.max(np.where(a, step, 0.0))))
    return level, carry[0]


def _drift_source(gs, cs):
    """Where the card and the CPU part: one tau-step local SGD of four slots
    from identical inputs differs in the last bits, while the eq.-4 wire
    quantizer fed identical inputs is bit-equal on both."""
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.sim.engine import _quantize_wire
    from repro_torch.sim.entropy import DeviceEntropy
    from repro_torch.sim.fleet import fleet_local_sgd, gather_active

    slots = torch.arange(4)
    x_s, y_s, n_s = gather_active(cs.fleet, slots)
    bidx = DeviceEntropy(7, "cpu").batch_indices(0, n_s, cs.sysp.tau, cs.batch_size)
    flats = {}
    for sim, dev in ((cs, "cpu"), (gs, "cuda")):
        stacked, _, _ = fleet_local_sgd(sim.loss_fn, sim.sysp.tau, sim.unravel(sim.flat0),
                                        x_s.to(dev), y_s.to(dev), bidx.to(dev), sim.lr)
        flats[dev] = torch.cat([leaf.reshape(4, -1) for leaf in tree_util.leaves(stacked)],
                               dim=1).cpu()
    sgd = (flats["cuda"] - flats["cpu"]).abs()
    gen = torch.Generator().manual_seed(7)
    u01 = torch.rand((4, cs._zpad), generator=gen)
    q = torch.tensor([1, 4, 8, 8])
    wire_c = _quantize_wire(u01, flats["cpu"], q, 8, cs._zpad)
    wire_g = _quantize_wire(u01.cuda(), flats["cpu"].cuda(), q.cuda(), 8, cs._zpad)
    require(all(torch.equal(a, b.cpu()) for a, b in zip(wire_c, wire_g)),
            "the wire quantizer differs between card and CPU on identical inputs")
    print(f"drift source: one local SGD (4 slots, tau={cs.sysp.tau}) card vs CPU from "
          f"identical inputs: max abs {sgd.max().item():.3e}, "
          f"{(sgd > 0).float().mean().item():.4f} of coordinates differ; the wire "
          f"quantizer on identical inputs is bit-equal on both")


@phase("profile of one main-path round")
def profile_round(sim):
    _, prof = _profiled("FEMNIST round", lambda: sim.run_compiled(1), top=12)
    spans = {}
    for e in prof.events():
        if e.name in SCOPES and not str(e.device_type).endswith("CUDA"):
            spans[e.name] = spans.get(e.name, 0.0) + e.cpu_time_total
    print("host spans of the scopes (ms, under the profiler): " + ", ".join(
        f"{k}={v / 1e3:.2f}" for k, v in sorted(spans.items())))


@phase("wire entry point: quantize_pytree_kernel, FEMNIST parameters, q=4")
def wire_entry(sim):
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.kernels import ops

    from unittest import mock

    from repro_torch.kernels import stochastic_quant as sq

    params = sim.unravel(sim.final_flat)
    gen = torch.Generator(device="cuda").manual_seed(4)
    # the variant each wrapper launched (the wrappers take the vec4 entry
    # point exactly when their variant function says "vec4")
    variants = []

    def spy(fn):
        return lambda *a: variants.append((fn.__name__, fn(*a))) or variants[-1][1]

    _reset_all_launches()
    with mock.patch.object(sq, "quantize_variant", spy(sq.quantize_variant)), \
            mock.patch.object(sq, "dequantize_variant", spy(sq.dequantize_variant)):
        deq, scale = ops.quantize_pytree_kernel(params, 4, generator=gen)
    torch.cuda.synchronize()
    launches = _all_launches()
    require(variants == [("quantize_variant", "vec4"), ("dequantize_variant", "vec4")],
            f"wire entry point: kernel variants {variants}, want vec4 for both")
    err = max((a - b).abs().max().item()
              for a, b in zip(tree_util.leaves(deq), tree_util.leaves(params)))
    step = scale.item() / (2**4 - 1)
    require(err <= step * (1 + 1e-6), f"round-trip error {err} above scale/(2^q-1)={step}")
    require(launches["quantize"] >= 1 and launches["dequantize"] >= 1,
            f"wire entry point launches {launches}")
    print(f"round trip max abs err {err:.4e} <= scale/(2^q-1) = {step:.4e}; "
          f"launches {launches}, through quantize_kernel_vec4 and dequantize_kernel_vec4")
    return launches


# ---------------------------------------------------------- object runtime

FIG3_POLICIES = ("qccf", "no_quant", "channel_allocate", "principle_24", "same_size_26")
FIG3_ROUNDS = 3
# card vs CPU on the object runtime: fp32 tolerance of a coordinate that
# no stochastic rounding moved, and the share of coordinates within it
FL_PARAM_ATOL, FL_WITHIN_SHARE = 1e-5, 0.99


class _DecisionSpy:
    """A policy that records the decisions of the policy it wraps."""

    def __init__(self, inner) -> None:
        self.inner, self.name, self.decisions = inner, inner.name, []

    def decide(self, ctx):
        self.decisions.append(self.inner.decide(ctx))
        return self.decisions[-1]

    def commit(self, dec) -> None:
        self.inner.commit(dec)


class _HostUploads:
    """The default upload entropy drawn on the CPU and moved to the run's
    device, so a CPU run and a card run round with the same uniforms."""

    def __init__(self, seed: int, device) -> None:
        from repro_torch.fl.trainer import UploadEntropy

        self.inner, self.device = UploadEntropy(seed, "cpu"), device

    def upload_uniforms(self, shapes):
        return [u.to(self.device) for u in self.inner.upload_uniforms(shapes)]


def _fl_fig3():
    """(a) The paper's Fig.-3 setting on the card: each policy one warm-up
    round, then FIG3_ROUNDS timed; returns {policy: experiment}."""
    import numpy as np
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.fl import ExperimentResult, build_experiment

    out = {}
    for pol in FIG3_POLICIES:
        exp = build_experiment(pol, task="femnist", beta=150.0, seed=1)
        require(exp.z == 246_590 and len(exp.clients) == 10, f"{pol}: Z={exp.z}")
        warm = exp.run(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = exp.run(FIG3_ROUNDS)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / FIG3_ROUNDS
        recs = warm.records + res.records
        vals = [v for r in recs for v in (r.energy, r.cum_energy, r.accuracy, r.loss, r.latency)]
        require(np.all(np.isfinite(vals)), f"{pol}: a record is not finite")
        require(all(bool(torch.isfinite(leaf).all()) for leaf in tree_util.leaves(exp.params)),
                f"{pol}: the model is not finite")
        summary = ExperimentResult(pol, recs).summary()
        print(f"{pol}: {sec:.4f} s per round ({FIG3_ROUNDS} rounds after 1 warm-up), final acc "
              f"{summary['final_accuracy']:.4f}, cumulative energy "
              f"{summary['total_energy_J']:.6e} J, mean q {summary['mean_q']:.3f}, scheduled "
              f"{[r.n_scheduled for r in recs]}, max latency {max(r.latency for r in recs):.6e} s")
        out[pol] = (recs, exp)
    t_max = out["qccf"][1].sysp.t_max
    e_q, e_n = out["qccf"][0][-1].cum_energy, out["no_quant"][0][-1].cum_energy
    require(e_q < e_n, f"QCCF energy {e_q} not below NoQuant's {e_n}")
    require(all(r.latency <= t_max * (1 + 1e-6) for r in out["qccf"][0]),
            f"QCCF busts T_max={t_max}: {[r.latency for r in out['qccf'][0]]}")
    print(f"QCCF energy {e_q:.6e} J < NoQuant {e_n:.6e} J ({e_q / e_n:.4f} of it); every QCCF "
          f"round within T_max = {t_max} s")
    return {pol: exp for pol, (_recs, exp) in out.items()}


def _fl_profile(exp):
    """(b) One profiled round from the state after the timed rounds:
    launches, busy share, the round's host spans."""
    res, prof = _profiled(f"object-runtime {exp.policy.name} round (FEMNIST, U=C=10)",
                          lambda: exp.run(1), top=8)
    spans = {name: 0.0 for name in FL_SCOPES}
    for e in prof.events():
        if e.name in FL_SCOPES and not str(e.device_type).endswith("CUDA"):
            spans[e.name] += e.cpu_time_total
    require(all(v > 0 for v in spans.values()), f"object-runtime spans missing: {spans}")
    print(f"host spans of the {exp.policy.name} round, {res.records[0].n_scheduled} clients "
          "scheduled (ms, under the profiler): " + ", ".join(
              f"{k}={v / 1e3:.2f}" for k, v in spans.items()))


def _fl_card_vs_cpu(rounds: int = 4):
    """(c) The tiny task on the card and on the CPU from the same weights
    and uniforms: schedules and q identical, accuracy within 1e-3, every
    final parameter within one quantization level of the CPU run (the
    largest w_i theta_i / (2^q_i - 1) of an upload in any round) plus
    FL_PARAM_ATOL, and FL_WITHIN_SHARE of them within FL_PARAM_ATOL."""
    import numpy as np
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.fl import build_experiment
    from repro_torch.models import cnn

    params = cnn.init_params(cnn.TINY_CNN, 3, device="cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        exp = build_experiment("qccf", task="tiny", n_clients=8, n_channels=8, seed=3,
                               device=dev, init_params=params, entropy=_HostUploads(3, dev))
        exp.policy = _DecisionSpy(exp.policy)
        recs, level = [], 0.0
        for _ in range(rounds):
            recs += exp.run(1).records
            dec = exp.policy.decisions[-1]
            a = dec.a.astype(bool)
            if a.any():
                w = exp.d_sizes / float(np.sum(dec.a * exp.d_sizes))
                step = w * exp.theta_max / (2.0 ** np.maximum(dec.q, 1) - 1.0)
                level = max(level, float(step[a].max()))
        runs[dev] = (recs, level, exp.params)
    (g, _, gp), (c, level, cp) = runs["cuda"], runs["cpu"]
    require([r.n_scheduled for r in g] == [r.n_scheduled for r in c]
            and np.array_equal(np.stack([r.rates for r in g]), np.stack([r.rates for r in c])),
            "object runtime: schedule differs between card and CPU")
    require(np.array_equal(np.stack([r.q_levels for r in g]), np.stack([r.q_levels for r in c])),
            "object runtime: q differs between card and CPU")
    acc = max(abs(a.accuracy - b.accuracy) for a, b in zip(g, c))
    require(acc <= 1e-3, f"object runtime: accuracy differs by {acc} > 1e-3")
    e_g, e_c = np.array([r.energy for r in g]), np.array([r.energy for r in c])
    require(np.allclose(e_g, e_c, rtol=1e-5, atol=0), f"energy card {e_g} vs CPU {e_c}")
    diff = torch.cat([(x.cpu() - y).abs().reshape(-1)
                      for x, y in zip(tree_util.leaves(gp), tree_util.leaves(cp))])
    share = (diff <= FL_PARAM_ATOL).double().mean().item()
    require(diff.max().item() <= level + FL_PARAM_ATOL,
            f"final params differ by {diff.max().item():.3e}, above one level {level:.3e}")
    require(share >= FL_WITHIN_SHARE, f"only {share:.5f} of coordinates within {FL_PARAM_ATOL}")
    print(f"object runtime card vs CPU (tiny, U=C=8, {rounds} rounds): schedule and q identical, "
          f"scheduled {[r.n_scheduled for r in g]}, accuracy max abs {acc:.3e}, energy max rel "
          f"{np.max(np.abs(e_g - e_c) / np.maximum(e_c, 1e-30)):.2e}, final params max abs "
          f"{diff.max().item():.3e} (one-level bound {level:.3e}), {share:.5f} within "
          f"{FL_PARAM_ATOL:g}")


def _fl_sim_vs_object(rounds: int = 12):
    """(d) The fleet sim against the object runtime driven by the greedy
    KKT oracle, both on the card (tests/test_sim_parity.py's pairing)."""
    import numpy as np
    from repro_torch.fl import build_experiment
    from repro_torch.sim import build_sim
    from repro_torch.sim.policy import HostFastPolicy

    sim = build_sim("tiny", n_clients=8, seed=21)
    res_sim = sim.run_compiled(rounds)
    exp = build_experiment("qccf", task="tiny", n_clients=8, n_channels=8, seed=21)
    exp.policy = HostFastPolicy(sim.sysp, sim.eps1, sim.eps2, sim.v_weight, q_cap=8)
    res_obj = exp.run(rounds)
    n_obj = [r.n_scheduled for r in res_obj.records]
    q_obj = np.stack([r.q_levels for r in res_obj.records])
    require(np.array_equal(n_obj, res_sim.n_scheduled),
            f"sim vs object runtime: scheduled {res_sim.n_scheduled.tolist()} vs {n_obj}")
    require(np.array_equal(q_obj, res_sim.q_levels), "sim vs object runtime: q differs")
    print(f"fleet sim vs object runtime on the card (tiny, U=8, {rounds} rounds): scheduled "
          f"and q identical, q per round {[sorted(set(q.tolist())) for q in q_obj]}, accuracy "
          f"sim {res_sim.accuracy[-1]:.4f} / object {res_obj.records[-1].accuracy:.4f}")


@phase("object_runtime: build_experiment/run_policy, FEMNIST Fig.-3 setting (U=C=10), "
       "card vs CPU, sim vs object runtime")
def object_runtime():
    exps = _fl_fig3()
    _fl_profile(exps["qccf"])
    _fl_profile(exps["no_quant"])        # every client scheduled: the per-client cost
    del exps
    _fl_card_vs_cpu()
    _fl_sim_vs_object()


# ---------------------------------------------------------- flash attention

# Tolerances of the flash kernels against their plain version on the same
# inputs. fp32 (SIMT kernel): both sum in fp32, in another order (64-key
# tiles and FMAs against 512-key blocks and matmuls). bf16 (wgmma kernel):
# fp32 scores and accumulator, p as two bf16 halves (2^-16 relative), so the
# fp32 results again differ only in order and rounding, then round to bf16
# and may land on neighbouring values: one ulp, <= 2^-7 relative.
FLASH_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2.0**-7, 1e-6)}   # (rtol, atol)
FLASH_SHAPES = [
    # name, B, S, T, H, KV, hd, causal, window
    ("llama3_8b serve", 4, 4096, 4096, 32, 8, 128, True, 0),
    ("starcoder2_7b window", 1, 8192, 8192, 36, 4, 128, True, 4096),
    ("non-causal ragged", 2, 1000, 1537, 16, 2, 112, False, 0),
    ("granite prefill", 4, 4096, 4096, 16, 8, 64, True, 0),
    ("seamless encoder", 4, 4096, 4096, 16, 16, 64, False, 0),
    ("internvl2 prefill", 4, 4096, 4096, 48, 8, 128, True, 0),
    ("zamba2 shared attention", 4, 4096, 4096, 32, 32, 112, True, 4096),
]


def visible_pairs(s: int, t: int, causal: bool, window: int, off: int = 0) -> int:
    """(q, k) pairs the mask admits, query i at i + off relative to key 0
    (a ring step's offset): the work these inputs need."""
    import numpy as np

    q = np.arange(s, dtype=np.int64) + off
    hi = np.minimum(q, t - 1) if causal else np.full(s, t - 1, dtype=np.int64)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(s, dtype=np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


# the flash kernel each dtype's route launches (names matched by substring)
FLASH_KERNELS = {"bfloat16": ("wgmma", "flash_fwd_wgmma_kernel"),
                 "float32": ("simt", "flash_fwd_kernel")}


def _sdpa(q, k, v, causal: bool, window: int, off=None):
    """``scaled_dot_product_attention`` on (B, L, heads, hd) tensors: the
    same function as the flash kernels (a window as a boolean mask; with a
    ring step's ``off``, query i at i + off, the step's visibility as one).
    The library yardstick, timed here only; the port never calls it."""
    import torch

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = None
    if window or off is not None:
        qpos = torch.arange(q.shape[1], device=q.device)[:, None] + (off or 0)
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = kpos > qpos - window if window else torch.ones_like(kpos > qpos)
        if causal:
            mask = mask & (kpos <= qpos)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None, enable_gqa=True)


@phase("flash attention kernels vs plain on the card")
def flash_vs_plain():
    import torch
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    report = {}
    for name, b, s, t, h, kv, hd, causal, window in FLASH_SHAPES:
        base = [0.3 * torch.randn(shape, generator=gen, device="cuda")
                for shape in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd))]
        for dtype in (torch.bfloat16, torch.float32):
            route, kernel = FLASH_KERNELS[str(dtype)[6:]]
            q, k, v = (x.to(dtype) for x in base)
            kw = dict(causal=causal, window=window)
            fa.reset_launches()
            out, lse = fa.flash_attention(q, k, v, with_lse=True, **kw)
            require(fa.launches[f"flash_attention_{route}"] == 1,
                    f"flash {name} {dtype} did not take the {route} route: {fa.launches}")
            require(dtype != torch.float32 or fa._load_variant(q, k, v) == "async",
                    f"flash {name}: contiguous fp32 must take the async loads")
            # offsets that cancel and the fp32 partial leave the numbers as
            # the default entry's: out rounds to the same bits, lse is equal
            out32, lse32 = fa.flash_attention(q, k, v, with_lse=True, q_offset=3 * s,
                                              k_offset=3 * s, out_fp32=True, **kw)
            require(torch.equal(out32.to(dtype), out) and torch.equal(lse32, lse),
                    f"flash {name} {dtype}: the offset-0 fp32-partial call is not "
                    "bit-identical to the default entry")
            _unrounded(f"flash {name} {dtype}", out32)
            del out32, lse32
            want, want_lse = fa.flash_attention_plain(q, k, v, with_lse=True, **kw)
            torch.cuda.synchronize()
            err, lse_err = _flash_errors(f"flash {name} {dtype}", out, lse, want, want_lse)
            pairs = visible_pairs(s, t, causal, window)
            esz = q.element_size()
            b_ms, b_by = bound((q.numel() + k.numel() + v.numel() + out.numel()) * esz,
                               4.0 * b * h * hd * pairs,
                               BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS)
            call = lambda: fa.flash_attention(q, k, v, **kw)
            k_ms = kernel_ms(call, kernel, iters=5)
            p_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), 2, warmup=1)
            lib_ms = (cuda_ms(_sdpa(q, k, v, causal, window), 20) if dtype == torch.bfloat16
                      else cuda_ms(_sdpa(q, k, v, causal, window), 3, warmup=1))
            variant = f", {fa._load_variant(q, k, v)} loads" if route == "simt" else ""
            print(f"flash {name} B={b} S={s} T={t} H={h}/{kv} hd={hd} causal={causal} "
                  f"window={window} {str(dtype)[6:]} ({route}{variant}): max_abs_err={err:.3e} "
                  f"(tol rtol {FLASH_TOL[str(dtype)[6:]][0]:g} atol "
                  f"{FLASH_TOL[str(dtype)[6:]][1]:g}), lse err {lse_err:.3e}; "
                  f"kernel {k_ms:.3f} ms (profiler), bound {b_ms:.3f} ms ({b_by}), "
                  f"plain {p_ms:.3f} ms (events), scaled_dot_product_attention "
                  f"{lib_ms:.3f} ms (events); with offsets that cancel and the fp32 partial: "
                  f"bit-identical out (rounded) and lse", flush=True)
            row = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=lib_ms)
            if name == "llama3_8b serve":
                report[f"flash_attention_{route}"] = {**row, "shapes": {}}
            report[f"flash_attention_{route}"]["shapes"][name] = row
            if dtype == torch.bfloat16:
                # the SIMT kernel's operations are fp32 FMAs: its bound is at the fp32 rate
                simt_bound, _ = bound((q.numel() + k.numel() + v.numel() + out.numel()) * esz,
                                      4.0 * b * h * hd * pairs, FP32_FLOPS)
                _simt_bf16_beside(q, k, v, kw, want, want_lse, simt_bound, lib_ms)
            del q, k, v, out, lse, want, want_lse
        del base
    torch.cuda.empty_cache()
    return report


def _out_error(label, out, want) -> float:
    """Require a flash output within FLASH_TOL of its own type (an fp32
    partial of bf16 inputs at the fp32 limit) of the plain version's;
    return the max abs error."""
    rtol, atol = FLASH_TOL[str(out.dtype)[6:]]
    err = (out.float() - want.float()).abs()
    require(bool((err <= atol + rtol * want.float().abs()).all()),
            f"{label}: max abs err {err.max().item():.3e} over rtol {rtol:g} atol {atol:g}")
    return err.max().item()


def _flash_errors(label, out, lse, want, want_lse) -> tuple[float, float]:
    """Require a flash result within FLASH_TOL of the plain version and its
    lse within 2e-5; return both max abs errors."""
    err = _out_error(label, out, want)
    lse_err = (lse - want_lse).abs()
    require(bool((lse_err <= 2e-5 + 2e-5 * want_lse.abs()).all()),
            f"{label}: lse max abs err {lse_err.max().item():.3e}")
    return err, lse_err.max().item()


def _unrounded(label, out32) -> None:
    """Require an fp32 partial to hold values that bf16 cannot (one rounded
    to bf16 before its fp32 store would pass any looser check)."""
    import torch

    require(bool((out32 != out32.to(torch.bfloat16).float()).any()),
            f"{label}: the fp32 partial holds only bf16 values")


def _simt_bf16_beside(q, k, v, kw, want, want_lse, bound_ms, sdpa_ms):
    """The SIMT kernel on the same bf16 inputs, copied one element off
    16-byte alignment so that TMA cannot describe them (register-staged
    loads): checked and timed beside the wgmma kernel in this run, with its
    fp32-rate bound and the bf16 SDPA time beside it."""
    from repro_torch.kernels import flash_attention as fa

    def shifted(x):
        buf = x.new_empty(x.numel() + 1)
        y = buf[1:].view(x.shape)
        y.copy_(x)
        return y

    qs, ks, vs = (shifted(x) for x in (q, k, v))
    require(fa._kernel_route(qs, ks, vs) == "simt", "shifted bf16 inputs did not route to simt")
    out, lse = fa.flash_attention(qs, ks, vs, with_lse=True, **kw)
    err, _ = _flash_errors("flash serve bf16 (simt)", out, lse, want, want_lse)
    require(fa._load_variant(qs, ks, vs) == "sync", "misaligned bf16 must take the sync loads")
    ms = kernel_ms(lambda: fa.flash_attention(qs, ks, vs, **kw), "flash_fwd_kernel", iters=3)
    print(f"  the SIMT kernel on the same bf16 inputs, misaligned (sync loads): {ms:.3f} ms "
          f"(profiler), bound {bound_ms:.3f} ms (fp32 operations), scaled_dot_product_attention "
          f"{sdpa_ms:.3f} ms (bf16, aligned), max_abs_err={err:.3e}", flush=True)


# ---------------------------------------------------------------- serve path

def _reset_all_launches():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kkt, moe_grouped
    from repro_torch.kernels import stochastic_quant as sq

    sq.reset_launches()
    fa.reset_launches()
    kkt.reset_launches()
    moe_grouped.reset_launches()


def _all_launches() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kkt, moe_grouped
    from repro_torch.kernels import stochastic_quant as sq

    return {**sq.launches, **fa.launches, **kkt.launches, **moe_grouped.launches}


def param_count_correction(cfg) -> int:
    """``init_params``'s parameters minus ``ModelConfig.param_count()``
    (signed): the final norm's d_model scales in every family; the
    encoder's norm for encdec; ``vis_proj`` (d_model^2) for vlm; for ssm,
    per layer, five d^2 projections and a rank-``lora`` decay LoRA (2 d
    lora) where the count has 6 d^2, and 13 vectors of d where it has 10
    (so negative at full size); for hybrid, per layer, the depthwise conv
    (CONV_K x (d_inner + 2 d_state)) and ``a_log``, ``d_skip``,
    ``dt_bias`` (3 heads' worth), less the one d of the two norms the count
    has where the tree has one. Held against the JAX package's
    ``init_params`` on the reduced configs by
    ``tests/test_torch_families.py``."""
    d = cfg.d_model
    if cfg.family == "ssm":
        lora = max(32, d // 64)
        return d + cfg.n_layers * (2 * d * lora + 3 * d - d * d)
    if cfg.family == "hybrid":
        conv = 4 * (cfg.d_inner + 2 * cfg.ssm_state)          # mamba2.CONV_K = 4
        return d + cfg.n_layers * (conv + 3 * cfg.n_ssm_heads - d)
    return d + {"encdec": d, "vlm": d * d}.get(cfg.family, 0)


def attention_layers(cfg) -> int:
    """Flash calls of a prefill: one per attention layer (the encoder's
    for encdec, one per shared-attention application for hybrid, none for
    ssm)."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return {"encdec": cfg.n_enc_layers, "ssm": 0}.get(cfg.family, cfg.n_layers)


def _serve_init(cfg):
    """The model's random bf16 weights from seed 0 on the card, held to the
    JAX package's parameter count."""
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.models import model

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(cfg, 0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_util.leaves(params))
    print(f"init_params: {n_params} parameters, matrices in {cfg.dtype}, "
          f"{time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          "allocated on the card")
    want = cfg.param_count() + param_count_correction(cfg)
    require(n_params == want, f"{n_params} parameters, want {cfg.param_count()} + "
                              f"({param_count_correction(cfg)}) = {want}")
    return params


def _serve_generate(label: str, cfg, params, ctx, n_attn: int, causal: bool, window: int = 0,
                    **inputs):
    """``serve.generate`` once with one new token (allocator, cuBLAS
    handles), then with SERVE_NEW, every launch count set to 0 just before
    it: its prefill must run the wgmma flash kernel once per attention layer
    (``n_attn``, 0 for a family without attention), every call ``causal``
    and at ``window`` as asked, and none through SIMT. Returns the
    generation, its launches and the phase's numbers."""
    from unittest import mock

    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve

    warm = serve.generate(cfg, params, ctx, 1, **inputs)
    print(f"warm-up generate (1 new token): prefill {warm.prefill_seconds:.3f} s")
    masks, wrapper = set(), fa.flash_attention

    def recording(q, k, v, **kw):     # keeps the mask, not the tensors (peak memory)
        masks.add((kw["causal"], kw["window"]))
        return wrapper(q, k, v, **kw)

    _reset_all_launches()
    with mock.patch.object(fa, "flash_attention", recording):
        gen = serve.generate(cfg, params, ctx, SERVE_NEW, **inputs)
    launches = _all_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    flash = {k: v for k, v in launches.items() if k.startswith("flash")}
    require(flash["flash_attention_wgmma"] == n_attn and flash["flash_attention_simt"] == 0,
            f"{label}: flash_attention launches {flash}, want {n_attn} through wgmma "
            "and none through simt")
    want_masks = {(causal, window)} if n_attn else set()
    require(masks == want_masks,
            f"{label}: flash calls with (causal, window) in {masks}, want {want_masks}")
    b = gen.tokens.shape[0]
    require(tuple(gen.tokens.shape) == (b, SERVE_NEW + 1), f"tokens {tuple(gen.tokens.shape)}")
    require(bool(((gen.tokens >= 0) & (gen.tokens < cfg.vocab)).all()), "token out of range")
    require(bool(torch.isfinite(gen.logits).all()), "non-finite logits")
    require(bool(torch.equal(gen.tokens[:, 0], warm.tokens[:, 0])),
            "the two prefills' greedy tokens differ")
    tok_s = SERVE_NEW * b / gen.decode_seconds
    print(f"{label}: prefill {gen.prefill_seconds:.4f} s; decode {SERVE_NEW} tokens x {b} "
          f"requests: {gen.decode_seconds:.4f} s ({tok_s:.2f} tok/s, "
          f"{gen.decode_seconds / SERVE_NEW * 1e3:.2f} ms/step); peak memory {peak:.2f} GB "
          f"(max_memory_allocated); {n_attn} {'causal' if causal else 'non-causal'} wgmma "
          f"flash launches{f' at window {window}' if window else ''}")
    print(f"launches in the serve path: {launches}")
    print(f"req0 tokens: {gen.tokens[0, :16].tolist()}")
    return gen, launches, dict(prefill_s=gen.prefill_seconds, decode_tok_s=tok_s, peak_gb=peak)


def _release() -> None:
    """Give the card back the memory of a model that went out of scope."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


@phase("serve path: llama3_8b full width and depth, flash prefill, B=4, context 4096, "
       "32 new tokens")
def serve_path():
    import numpy as np
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(SERVE_ARCH), attn_impl="flash")
    params = _serve_init(cfg)
    ctx = np.random.default_rng(0).integers(0, cfg.vocab, (SERVE_BATCH, SERVE_CONTEXT))
    gen, launches, numbers = _serve_generate(
        f"{SERVE_ARCH} {SERVE_BATCH} x {SERVE_CONTEXT} tokens", cfg, params, ctx,
        cfg.n_layers, True)
    print(f"prefill rate {SERVE_BATCH * SERVE_CONTEXT / gen.prefill_seconds:.0f} tok/s")
    return cfg, params, ctx, launches, numbers


@phase("serve path: granite_moe_1b_a400m full size (24 layers, 32 experts top-8), flash "
       "prefill, B=4, context 4096, 32 new tokens")
def serve_granite():
    from unittest import mock

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config(GRANITE_ARCH), attn_impl="flash")
    params = _serve_init(cfg)
    ctx = np.random.default_rng(0).integers(0, cfg.vocab, (SERVE_BATCH, SERVE_CONTEXT))
    drops, apply = [], moe.moe_apply

    def recording(p, x, **kw):       # the prefill's routing: its dropped fraction
        out, aux = apply(p, x, **kw)
        if x.shape[1] > 1:
            drops.append(aux["dropped_frac"])
        return out, aux

    with mock.patch.object(moe, "moe_apply", recording):
        gen, launches, numbers = _serve_generate(
            f"{GRANITE_ARCH} {SERVE_BATCH} x {SERVE_CONTEXT} tokens", cfg, params, ctx,
            cfg.n_layers, True)
    prefill_drops = drops[-cfg.n_layers:]      # the timed run's layers, after the warm-up's
    require(len(drops) == 2 * cfg.n_layers, f"{len(drops)} MoE prefill calls, want "
                                            f"{cfg.n_layers} in each of two prefills")
    profile_serve(GRANITE_ARCH, cfg, params, ctx)
    numbers["dropped_frac"] = torch.stack(prefill_drops).mean().item()
    require(0.0 <= numbers["dropped_frac"] < 1.0, f"dropped_frac {numbers['dropped_frac']}")
    print(f"routing: capacity factor {cfg.capacity_factor}, {cfg.n_experts} experts top-"
          f"{cfg.top_k} in 512-token chunks; mean dropped_frac of the prefill "
          f"{numbers['dropped_frac']:.4f} (per layer min "
          f"{min(d.item() for d in prefill_drops):.4f}, max "
          f"{max(d.item() for d in prefill_drops):.4f})")
    return launches, numbers


@phase("serve path: seamless_m4t_large_v2 full size (24 + 24 layers), non-causal flash "
       "encode of B=4 x 4096 frames, 32 greedy tokens from BOS")
def serve_seamless():
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import decode

    cfg = dataclasses.replace(get_config(SEAMLESS_ARCH), attn_impl="flash")
    params = _serve_init(cfg)
    src = np.random.default_rng(0).normal(size=(SERVE_BATCH, SERVE_CONTEXT, cfg.d_model))
    src = torch.as_tensor(src, dtype=torch.float32, device="cuda")
    gen, launches, numbers = _serve_generate(
        f"{SEAMLESS_ARCH} encode {SERVE_BATCH} x {SERVE_CONTEXT} frames + BOS step", cfg,
        params, None, cfg.n_enc_layers, False, src_embeds=src)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode.encode(cfg, params, decode.init_cache(cfg, SERVE_BATCH, 1), src)
    torch.cuda.synchronize()
    numbers["encode_s"] = time.perf_counter() - t0
    print(f"encode alone (host clock, synchronized): {numbers['encode_s']:.4f} s")
    profile_serve(SEAMLESS_ARCH, cfg, params, None, src_embeds=src)
    return launches, numbers


@phase("serve path: internvl2_26b full size (48 layers), 256 patch embeddings + 3840 tokens, "
       "flash prefill, B=4, 32 new tokens")
def serve_internvl2():
    import numpy as np
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(INTERNVL2_ARCH), attn_impl="flash")
    params = _serve_init(cfg)
    rng = np.random.default_rng(0)
    n_vis = cfg.n_vis_tokens
    vis = rng.standard_normal((SERVE_BATCH, n_vis, cfg.d_model), dtype=np.float32)
    ctx = rng.integers(0, cfg.vocab, (SERVE_BATCH, SERVE_CONTEXT - n_vis))
    gen, launches, numbers = _serve_generate(
        f"{INTERNVL2_ARCH} {SERVE_BATCH} x ({n_vis} patches + "
        f"{SERVE_CONTEXT - n_vis} tokens)", cfg, params, ctx, cfg.n_layers, True,
        vis_embeds=vis)
    profile_serve(INTERNVL2_ARCH, cfg, params, ctx, vis_embeds=vis)
    return launches, numbers


RECURRENT_PHASES = {
    RWKV6_ARCH: "rwkv6_7b full size (32 layers, d_model 4096), chunked WKV prefill",
    ZAMBA2_ARCH: "zamba2_7b full size (81 Mamba2 layers, d_model 3584, shared attention every "
                 "9 at hd 112), flash prefill",
}


def serve_recurrent(arch: str):
    """Serve a recurrent family's model at full size, B=4, context 4096,
    32 new tokens: RWKV6 without a flash launch, Zamba2 with one causal
    wgmma launch per shared-attention application at its window."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import model

    cfg = dataclasses.replace(get_config(arch), attn_impl="flash")
    params = _serve_init(cfg)
    ctx = np.random.default_rng(0).integers(0, cfg.vocab, (SERVE_BATCH, SERVE_CONTEXT))
    window = model.shared_window(cfg) if cfg.family == "hybrid" else 0
    _gen, launches, numbers = _serve_generate(
        f"{arch} {SERVE_BATCH} x {SERVE_CONTEXT} tokens", cfg, params, ctx,
        attention_layers(cfg), True, window=window)
    profile_serve(arch, cfg, params, ctx)
    return launches, numbers


# The two-layer prefill's logits through the kernel and through the plain
# version: the graphs differ only in attention, whose fp32 results agree to
# ~1e-7 and so round to the same or a neighbouring bf16 value (one ulp,
# <= 2^-7 relative). Those ulps pass through two layers of bf16 matmuls and
# norms into fp32 logits of magnitude ~1; we hold the logits to 2^-6 of
# their largest magnitude, a few bf16 ulps at that scale. A planted fault
# (the plain version with the GQA head map shifted by one KV head) must
# land above that limit, or the check could not tell a wrong attention.
TWO_LAYER_REL = 2.0**-6


@phase("two-layer prefill at full width: kernel vs plain flash on the card")
def two_layer_prefill(cfg, params, ctx):
    from unittest import mock

    import torch
    from repro_torch import tree as tree_util
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import decode

    cfg2 = dataclasses.replace(cfg, n_layers=2)
    p2 = {**params, "layers": tree_util.map(lambda t: t[:2], params["layers"])}
    batch = {"tokens": torch.as_tensor(ctx, device="cuda")}
    fa.reset_launches()
    got, _ = decode.prefill(cfg2, p2, batch, SERVE_CONTEXT)
    require(fa.launches["flash_attention_wgmma"] == 2, f"kernel launches {fa.launches}")
    with mock.patch.object(fa, "flash_attention", fa.flash_attention_plain):
        want, _ = decode.prefill(cfg2, p2, batch, SERVE_CONTEXT)

    def shifted_heads(q, k, v, **kw):
        # planted fault: query head h reads KV head h // g - 1 (mod KV)
        return fa.flash_attention_plain(q, k.roll(1, dims=2), v.roll(1, dims=2), **kw)

    with mock.patch.object(fa, "flash_attention", shifted_heads):
        wrong, _ = decode.prefill(cfg2, p2, batch, SERVE_CONTEXT)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all() and torch.isfinite(want).all()), "non-finite logits")
    err = (got - want).abs().max().item()
    fault = (wrong - want).abs().max().item()
    scale = want.abs().max().item()
    limit = TWO_LAYER_REL * scale
    require(err <= limit, f"two-layer logits differ by {err:.3e}, above 2^-6 x {scale:.3f}")
    require(fault > limit,
            f"a shifted GQA head map moves the logits by only {fault:.3e} <= {limit:.3e}: "
            "the two-layer check cannot tell a wrong attention")
    print(f"two-layer prefill logits (fp32, B={SERVE_BATCH}, V={cfg.vocab}): kernel vs plain "
          f"max abs {err:.3e}, mean abs {(got - want).abs().mean().item():.3e}, "
          f"max |logit| {scale:.3f}, tolerance {limit:.3e}; argmax equal on "
          f"{(got.argmax(-1) == want.argmax(-1)).sum().item()}/{SERVE_BATCH} rows; "
          f"planted fault (GQA head map shifted) vs plain max abs {fault:.3e}")


def profile_serve(label: str, cfg, params, ctx, **inputs):
    """One prefill and 4 decode steps of ``serve.generate``'s path, each
    under the profiler."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import decode

    batch, seq_len = serve._prefill_batch(cfg, ctx, inputs.get("vis_embeds"),
                                          inputs.get("src_embeds"), 4, torch.device("cuda"))
    (logits, cache), _ = _profiled(
        f"{label} prefill", lambda: decode.prefill(cfg, params, batch, seq_len))

    def steps(tok):
        for _ in range(4):
            tok = decode.decode_step(cfg, params, cache, tok)[0].argmax(-1)

    _profiled(f"{label} decode x4", lambda: steps(logits.argmax(-1)))


def _profiled(label: str, fn, top: int = 8, host_ops: bool = True):
    """Run ``fn`` once under the profiler; print wall time, device kernel
    time, busy share and the top kernels by device time. ``host_ops=False``
    records the device activity only (a train step's ~200k launches: the
    host ops' events would take minutes to gather)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] * host_ops + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if _is_device(e)]
    total = sum(e.self_device_time_total for e in kernels)
    prof.wall_ms, prof.device_ms = wall * 1e3, total / 1e3
    prof.n_launches = sum(e.count for e in kernels)
    print(f"profile {label}: wall {wall * 1e3:.2f} ms, device kernel time {total / 1e3:.2f} ms "
          f"(busy share {total / 1e3 / (wall * 1e3):.3f} under the profiler), "
          f"{prof.n_launches} kernel launches")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return out, prof


# The small-input reference: the same fp32 weights and context through the
# card (flash kernel, cuBLAS in full fp32) and the CPU (plain version). Both
# sum in fp32 in other orders; torch on the CPU and the JAX package agree to
# 2e-6 on these logits (|logit| < 3), so 1e-4 leaves a wide margin while
# staying far below any bf16 effect (2^-8 ~ 4e-3 relative).
SMALL_LOGIT_ATOL = 1e-4


# each family's reduced config at 2,560 positions: above DENSE_ATTN_MAX_SEQ
# and a multiple of the reduced chunk (64), so its attention takes the flash
# path (the SIMT kernel in fp32) and its recurrent scans their chunked forms
SMALL_REFERENCES = (
    (SERVE_ARCH, "context 2560"),
    (GRANITE_ARCH, "context 2560, routed in 5 chunks of 512"),
    (INTERNVL2_ARCH, "8 patch embeddings + 2552 tokens"),
    (SEAMLESS_ARCH, "encode of 2560 source frames"),
    (RWKV6_ARCH, "context 2560, chunked WKV, no attention"),
    (ZAMBA2_ARCH, "context 2560, chunked SSD, shared attention at window 64"),
)


def serve_small_reference(arch: str) -> int:
    """The reduced ``arch`` in fp32 from the same weights and inputs on the
    card and on the CPU: identical greedy tokens, logits within
    SMALL_LOGIT_ATOL; the SIMT kernel once per attention layer of the
    prefill (``attention_layers``: none for ssm). Returns those launches."""
    import numpy as np
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.models import model

    cfg = dataclasses.replace(reduce_config(get_config(arch)), attn_impl="flash")
    params_cpu = model.init_params(cfg, 0, device="cpu")
    params_gpu = tree_util.map(lambda t: t.to("cuda"), params_cpu)
    rng = np.random.default_rng(1)
    n, inputs, ctx = 2560, {}, None
    if cfg.family == "encdec":
        inputs["src_embeds"] = rng.standard_normal((2, n, cfg.d_model), dtype=np.float32)
    elif cfg.family == "vlm":
        inputs["vis_embeds"] = rng.standard_normal((2, cfg.n_vis_tokens, cfg.d_model),
                                                   dtype=np.float32)
        ctx = rng.integers(0, cfg.vocab, (2, n - cfg.n_vis_tokens))
    else:
        ctx = rng.integers(0, cfg.vocab, (2, n))
    n_attn = attention_layers(cfg)
    fa.reset_launches()
    g = serve.generate(cfg, params_gpu, ctx, 8, **inputs)
    simt_launches = fa.launches["flash_attention_simt"]
    require(simt_launches == n_attn and fa.launches["flash_attention"] == n_attn,
            f"flash_attention launches in the fp32 prefill: {fa.launches}, want {n_attn} simt")
    c = serve.generate(cfg, params_cpu, ctx, 8, device="cpu", **inputs)
    require(torch.equal(g.tokens.cpu(), c.tokens),
            f"greedy tokens differ: card {g.tokens.tolist()} vs CPU {c.tokens.tolist()}")
    # the prefill's logits: the whole context (encdec: the greedy target)
    tokens = c.tokens if cfg.family == "encdec" else torch.as_tensor(ctx)
    fwd = [model.forward_logits(cfg, p, {"tokens": tokens.to(dev), **{
               k: torch.as_tensor(v, device=dev) for k, v in inputs.items()}})
           for dev, p in (("cuda", params_gpu), ("cpu", params_cpu))]
    err_fwd = (fwd[0].cpu() - fwd[1]).abs().max().item()
    err_last = (g.logits.cpu() - c.logits).abs().max().item()
    require(max(err_fwd, err_last) <= SMALL_LOGIT_ATOL,
            f"card vs CPU logits differ by {max(err_fwd, err_last):.3e} > {SMALL_LOGIT_ATOL}")
    print(f"card vs CPU (B=2, {n} positions, chunk {cfg.chunk_size}, 8 greedy steps): tokens "
          f"identical, forward logits max abs {err_fwd:.3e}, last-step logits max abs "
          f"{err_last:.3e} (tolerance {SMALL_LOGIT_ATOL:g}, max |logit| "
          f"{c.logits.abs().max().item():.3f}); {simt_launches} SIMT flash launches")
    return simt_launches


# ---------------------------------------------------------------- distribution

RING_N = 4
# ring-step shapes: one rank's shard of the 32k ring below (S_loc = 8192)
# name, B, S_loc, H, KV, hd, causal, window, q_offset, k_offset
OFFSET_SHAPES = [
    ("llama3_8b ring diagonal (offset 0)", 1, 8192, 32, 8, 128, True, 0, 8192, 8192),
    ("llama3_8b ring past (offset 8192)", 1, 8192, 32, 8, 128, True, 0, 8192, 0),
    ("starcoder2_7b ring window partial (offset 8192, window 4096)", 1, 8192, 36, 4, 128,
     True, 4096, 8192, 0),
]
RING_SEQ = 32_768
# name, H, KV, window, launches of LocalRing(4) with dead steps skipped
RING_CASES = [("llama3_8b", 32, 8, 0, 10), ("starcoder2_7b", 36, 4, 4096, 7)]


@phase("dist (a): the flash kernels with a position offset and fp32 partials vs plain, at "
       "the 32k ring's step shapes")
def flash_offsets(report: dict):
    """Each ring-step shape through the wgmma kernel (bf16) and the SIMT
    kernel (fp32), ``q_offset``/``k_offset`` and ``out_fp32`` with the lse,
    against the plain version within FLASH_TOL["float32"] (the partial is
    fp32 whatever the input) and not bf16-rounded; rows with no visible key
    write 0 and lse -1e30. Kernel, plain and SDPA (the step's
    visibility as a boolean mask) times and the bound go into the flash rows'
    ``shapes``."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(11)
    for name, b, s, h, kv, hd, causal, window, qo, ko in OFFSET_SHAPES:
        base = [0.3 * torch.randn(shape, generator=gen, device="cuda")
                for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))]
        pairs = visible_pairs(s, s, causal, window, qo - ko)
        for dtype in (torch.bfloat16, torch.float32):
            route, kernel = FLASH_KERNELS[str(dtype)[6:]]
            q, k, v = (x.to(dtype) for x in base)
            kw = dict(causal=causal, window=window, q_offset=qo, k_offset=ko, out_fp32=True)
            fa.reset_launches()
            out, lse = fa.flash_attention(q, k, v, with_lse=True, **kw)
            require(fa.launches[f"flash_attention_{route}"] == 1,
                    f"{name} {dtype}: not the {route} route: {fa.launches}")
            want, want_lse = fa.flash_attention_plain(q, k, v, with_lse=True, **kw)
            torch.cuda.synchronize()
            require(out.dtype == torch.float32, f"{name} {dtype}: out is {out.dtype}")
            err, lse_err = _flash_errors(f"{name} {dtype}", out, lse, want, want_lse)
            _unrounded(f"{name} {dtype}", out)
            rtol, atol = FLASH_TOL["float32"]
            empty = want_lse <= -1e29
            require(bool((out[empty] == 0).all() and (lse[empty] <= -1e29).all()),
                    f"{name} {dtype}: a row with no visible key did not write 0 / -1e30")
            b_ms, b_by = bound((q.numel() + k.numel() + v.numel()) * q.element_size()
                               + out.numel() * 4, 4.0 * b * h * hd * pairs,
                               BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS)
            k_ms = kernel_ms(lambda: fa.flash_attention(q, k, v, **kw), kernel, iters=5)
            p_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), 2, warmup=1)
            lib_ms = cuda_ms(_sdpa(q, k, v, causal, window, off=qo - ko), 5, warmup=1)
            rows_empty = int(empty.sum().item())
            print(f"flash {name} B={b} S_loc={s} H={h}/{kv} hd={hd} q_offset={qo} k_offset={ko}"
                  f" {str(dtype)[6:]} ({route}, fp32 partial): max_abs_err={err:.3e}"
                  f" (tol rtol {rtol:g} atol {atol:g}), not bf16-rounded, lse err {lse_err:.3e}, "
                  f"{rows_empty} (row, head)s with no visible key; kernel {k_ms:.3f} ms "
                  f"(profiler), bound {b_ms:.3f} ms ({b_by}, {pairs} visible pairs), plain "
                  f"{p_ms:.3f} ms (events), scaled_dot_product_attention with the step's mask "
                  f"{lib_ms:.3f} ms (events)", flush=True)
            report[f"flash_attention_{route}"]["shapes"][name] = dict(
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)
            del q, k, v, out, lse, want, want_lse
        del base
    torch.cuda.empty_cache()


@phase(f"dist (b): ring flash attention at S = {RING_SEQ} through LocalRing({RING_N}), bf16, "
       "against one kernel pass")
def ring_32k(report: dict) -> dict:
    """Llama-3-8B's attention shape (B = 1, H = 32 / KV = 8, hd 128, causal)
    and StarCoder2-7B's heads with its 4096 window at S = 32,768: the single
    pass and the ring's merged output each within FLASH_TOL["bfloat16"] of
    the plain version, the ring's of the single pass too, its wgmma
    launches (dead steps skipped) counted from 0; the ring's summed kernel
    time, its wall time with the merges, the single pass's, the plain
    version's and SDPA's, and the bound. Returns each case's ring launches."""
    import torch
    from repro_torch.dist.ring import LocalRing, ring_flash_attention
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(12)
    paths = {}
    for arch, h, kv, window, want_launches in RING_CASES:
        q, k, v = ((0.3 * torch.randn((1, RING_SEQ, heads, 128), generator=gen, device="cuda"))
                   .to(torch.bfloat16) for heads in (h, kv, kv))
        single = fa.flash_attention(q, k, v, causal=True, window=window)
        plain = lambda: fa.flash_attention_plain(q, k, v, causal=True, window=window)
        want = plain()
        single_err = _out_error(f"single pass {arch} S={RING_SEQ}", single, want)
        ring = LocalRing(RING_N)
        _reset_all_launches()
        got = ring_flash_attention(q, k, v, ring=ring, causal=True, window=window)
        torch.cuda.synchronize()
        launches = _all_launches()
        require(launches["flash_attention_wgmma"] == want_launches
                and launches["flash_attention"] == want_launches,
                f"ring {arch}: launches {launches}, want {want_launches} through wgmma")
        rtol, atol = FLASH_TOL["bfloat16"]
        err = (got.float() - single.float()).abs()
        require(bool((err <= atol + rtol * single.float().abs()).all()),
                f"ring {arch}: max abs err {err.max().item():.3e} against the single pass")
        ring_err = _out_error(f"ring {arch} S={RING_SEQ}", got, want)
        pairs = visible_pairs(RING_SEQ, RING_SEQ, True, window)
        b_ms, b_by = bound((q.numel() + 2 * k.numel() + q.numel()) * 2, 4.0 * h * 128 * pairs,
                           BF16_FLOPS)
        call = lambda: ring_flash_attention(q, k, v, ring=ring, causal=True, window=window)
        # the mean launch of three rings times a ring's launches: their sum
        ring_ms = kernel_ms(call, "flash_fwd_wgmma_kernel", iters=3) * want_launches
        ring_wall = cuda_ms(call, 3, warmup=1)
        single_ms = kernel_ms(lambda: fa.flash_attention(q, k, v, causal=True, window=window),
                              "flash_fwd_wgmma_kernel", iters=3)
        sdpa_ms = cuda_ms(_sdpa(q, k, v, True, window), 5, warmup=1)
        p_ms = cuda_ms(plain, 1, warmup=0)
        print(f"ring {arch} B=1 S={RING_SEQ} H={h}/{kv} hd=128 causal window={window}, "
              f"LocalRing({RING_N}), S_loc={RING_SEQ // RING_N}: {want_launches} wgmma launches "
              f"(dead steps skipped); max abs err vs the plain version: single pass "
              f"{single_err:.3e}, ring {ring_err:.3e}; ring vs the single pass "
              f"{err.max().item():.3e} (tol rtol {rtol:g} atol {atol:g}); ring kernels summed "
              f"{ring_ms:.3f} ms (profiler), ring wall with merges {ring_wall:.3f} ms (events), "
              f"single pass {single_ms:.3f} ms (profiler), ratio {ring_ms / single_ms:.3f}; "
              f"plain {p_ms:.3f} ms (events); scaled_dot_product_attention "
              f"{sdpa_ms:.3f} ms (events{', window as a mask' if window else ', is_causal'}); "
              f"bound {b_ms:.3f} ms ({b_by})", flush=True)
        report["flash_attention_wgmma"]["shapes"][f"{arch} S={RING_SEQ} single pass"] = dict(
            max_abs_err=single_err, ms=single_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=sdpa_ms)
        report["flash_attention_wgmma"]["shapes"][f"{arch} S={RING_SEQ} ring of {RING_N}"] = \
            dict(max_abs_err=ring_err, max_abs_err_vs_single_pass=err.max().item(), ms=ring_ms,
                 wall_ms=ring_wall, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                 library_ms=sdpa_ms, launches=want_launches)
        paths[f"ring {arch} S={RING_SEQ}"] = launches["flash_attention_wgmma"]
        if arch == SERVE_ARCH:
            paths.update(_ring_heads_on_model(q, k, v, single, want, ring_ms, p_ms, sdpa_ms,
                                              report))
        del q, k, v, single, got, want
    torch.cuda.empty_cache()
    return paths


@phase("dist (c): serve path: llama3_8b prefill_32k (batch cut from 32 to 1), 8 new tokens")
def serve_32k(cfg, params) -> dict:
    """``serve.generate`` on the Llama-3-8B weights of the serve phase at
    ``INPUT_SHAPES["prefill_32k"]``'s 32,768 positions with the batch cut to
    1: one wgmma flash launch per layer, counted from 0; prefill s, decode
    tok/s, peak GB."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models.config import INPUT_SHAPES

    seq = INPUT_SHAPES["prefill_32k"].seq_len
    new = 8
    ctx = np.random.default_rng(3).integers(0, cfg.vocab, (1, seq))
    torch.cuda.reset_peak_memory_stats()
    _reset_all_launches()
    gen = serve.generate(cfg, params, ctx, new)
    launches = _all_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    require(launches["flash_attention_wgmma"] == cfg.n_layers
            and launches["flash_attention_simt"] == 0,
            f"prefill_32k: flash launches {launches}, want {cfg.n_layers} through wgmma")
    require(tuple(gen.tokens.shape) == (1, new + 1), f"tokens {tuple(gen.tokens.shape)}")
    require(bool(((gen.tokens >= 0) & (gen.tokens < cfg.vocab)).all()), "token out of range")
    require(bool(torch.isfinite(gen.logits).all()), "non-finite logits")
    tok_s = new / gen.decode_seconds
    print(f"{SERVE_ARCH} 1 x {seq} tokens: prefill {gen.prefill_seconds:.4f} s "
          f"({seq / gen.prefill_seconds:.0f} tok/s); decode {new} tokens: "
          f"{gen.decode_seconds:.4f} s ({tok_s:.2f} tok/s, {gen.decode_seconds / new * 1e3:.2f} "
          f"ms/step); peak memory {peak:.2f} GB (max_memory_allocated); {cfg.n_layers} wgmma "
          f"flash launches; req0 tokens {gen.tokens[0].tolist()}", flush=True)
    return {f"{SERVE_ARCH} prefill_32k": launches["flash_attention_wgmma"]}


@phase("dist (d): NCCL in a world of one: the 1x1x1x1 mesh, GroupRing, the client-sharded "
       "FEMNIST fleet")
def nccl_world_of_one(sim) -> dict:
    """``init_process_group("nccl")`` with one rank; ``make_production_mesh
    (shape="1x1x1x1")`` on the card; ``ring_flash_attention`` through
    ``GroupRing`` over its seq group bit-equal to the single pass; the
    FEMNIST fleet sharded on a one-rank ``("data",)`` mesh running 3 greedy
    rounds bit-equal to 3 unsharded rounds of the same sim, ``aggregate``
    once per round. The group is destroyed at the end; nothing is caught.
    Returns the ring's and the sharded rounds' launches."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.dist.ring import GroupRing, ring_flash_attention
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_production_mesh, mesh_label

    rounds = 3
    base = sim.run_compiled(rounds, with_eval=False)
    base_flat, base_s = sim.final_flat.clone(), sim.run_seconds
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg", rank=0, world_size=1,
                                device_id=torch.device("cuda", 0))
        try:
            mesh = make_production_mesh(shape="1x1x1x1")
            require(mesh_label(mesh) == "1x1x1x1"
                    and tuple(mesh.mesh_dim_names) == ("pod", "data", "seq", "model"),
                    f"mesh {mesh_label(mesh)} {mesh.mesh_dim_names}")
            gen = torch.Generator(device="cuda").manual_seed(13)
            q, k, v = ((0.3 * torch.randn((1, 8192, heads, 128), generator=gen, device="cuda"))
                       .to(torch.bfloat16) for heads in (32, 8, 8))
            want = fa.flash_attention(q, k, v)
            _reset_all_launches()
            got = ring_flash_attention(q, k, v, ring=GroupRing(mesh.get_group("seq")))
            torch.cuda.synchronize()
            ring_launches = _all_launches()["flash_attention_wgmma"]
            require(ring_launches == 1, f"GroupRing n=1: launches {_all_launches()}")
            require(torch.equal(got, want), "GroupRing n=1 differs from the single pass")
            del q, k, v, got, want
            data_mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
            t0 = time.perf_counter()
            sim.shard_clients(data_mesh)
            torch.cuda.synchronize()
            shard_s = time.perf_counter() - t0
            require(sim.fleet.group is not None, "the one-rank data axis did not shard the fleet")
            _reset_all_launches()
            res = sim.run_compiled(rounds, with_eval=False)
            run_s = sim.run_seconds
            launches = _all_launches()
            require(launches["aggregate"] == rounds, f"sharded rounds: launches {launches}")
            fields = ("energy", "q_levels", "n_scheduled", "rates", "lambda1", "lambda2",
                      "latency", "payload_bits")
            for f in fields:
                require(np.array_equal(getattr(res, f), getattr(base, f)),
                        f"sharded {f} differs from the unsharded run")
            require(torch.equal(sim.final_flat, base_flat),
                    "sharded final parameters differ from the unsharded run")
        finally:
            dist.destroy_process_group()
    print(f"nccl world of one: mesh 1x1x1x1 {tuple(mesh.mesh_dim_names)}; GroupRing (n=1) "
          f"bit-equal to the single pass, 1 wgmma launch; shard_clients on a one-rank data "
          f"axis in {shard_s:.3f} s, {rounds} greedy rounds bit-equal to the unsharded "
          f"rounds ({len(fields)} outputs and the final parameters), {launches['aggregate']} "
          f"aggregate launches, {run_s / rounds:.4f} s/round against "
          f"{base_s / rounds:.4f} unsharded; group destroyed", flush=True)
    return {"ring": ring_launches, "aggregate": launches["aggregate"]}


# ------------------------------------------------------- model parallelism

RING_HEADS_MODEL = 2       # the model axis the heads-on-model ring emulates
# a TP rank's heads at a serve shape (B = 4, S = T = 4,096, bf16), one row each: H, KV, hd,
# causal, window, the model axis, whose attention
LOCAL_HEADS = ((16, 4, 128, True, 0, 2, "Llama-3-8B"), (8, 2, 128, True, 0, 4, "Llama-3-8B"),
               (16, 16, 112, True, 4096, 2, "Zamba2-7B's shared attention"),
               (24, 4, 128, True, 0, 2, "InternVL2-26B"),
               (8, 8, 64, False, 0, 2, "SeamlessM4T-large-v2's encoder"))
DRYRUN_PREFILLS = ("1x2", "1x4")
# the dry run's predicted forward/backward peak (PERF.md §6): 32.1 GB of fp32
# state, the two gathered vocab tables and a gathered layer, the remat inputs
DRYRUN_FWD_BWD_GB = (36.0, 42.0)


def _ring_heads_on_model(q, k, v, single, want, ring_ms, plain_ms, sdpa_ms,
                         report) -> dict:
    """(mp b) The ring with heads on ``model`` = RING_HEADS_MODEL emulated
    on one card: each model rank's contiguous head block (H/m q heads,
    KV/m K/V heads, as ``models.model`` hands a TP rank's projections to
    the kernel) through ``LocalRing(RING_N)``; the concatenated output
    within FLASH_TOL["bfloat16"] of the single pass and of the plain
    version, m times the ring's launches through wgmma, none through SIMT.
    Adds the row ``flash_attention_wgmma_ring_heads_on_model``."""
    import torch
    from repro_torch.dist.ring import LocalRing, ring_flash_attention

    m, h, kv = RING_HEADS_MODEL, q.shape[2], k.shape[2]
    blocks = [tuple(x[:, :, i * x.shape[2] // m:(i + 1) * x.shape[2] // m].contiguous()
                    for x in (q, k, v)) for i in range(m)]
    ring = LocalRing(RING_N)

    def run():
        return [ring_flash_attention(qb, kb, vb, ring=ring, causal=True) for qb, kb, vb in blocks]

    _reset_all_launches()
    got = torch.cat(run(), dim=2)
    torch.cuda.synchronize()
    launches = _all_launches()
    want_launches = m * RING_N * (RING_N + 1) // 2
    require(launches["flash_attention_wgmma"] == want_launches
            and launches["flash_attention_simt"] == 0,
            f"heads-on-model ring: launches {launches}, want {want_launches} through wgmma")
    rtol, atol = FLASH_TOL["bfloat16"]
    err = (got.float() - single.float()).abs()
    require(bool((err <= atol + rtol * single.float().abs()).all()),
            f"heads-on-model ring: max abs err {err.max().item():.3e} against the single pass")
    plain_err = _out_error(f"heads-on-model ring S={RING_SEQ}", got, want)
    pairs = visible_pairs(RING_SEQ, RING_SEQ, True, 0)
    b_ms, b_by = bound((q.numel() + 2 * k.numel() + q.numel()) * 2, 4.0 * h * 128 * pairs,
                       BF16_FLOPS)
    k_ms = kernel_ms(run, "flash_fwd_wgmma_kernel", iters=2) * want_launches
    print(f"ring with heads on model={m} ({m} blocks of H={h // m}/{kv // m}, LocalRing"
          f"({RING_N}) each, B=1 S={RING_SEQ} hd=128 causal bf16): {want_launches} wgmma "
          f"launches, 0 SIMT; max abs err vs the single pass {err.max().item():.3e}, vs the "
          f"plain version {plain_err:.3e} (tol rtol {rtol:g} atol {atol:g}); kernels summed "
          f"{k_ms:.3f} ms (profiler) against the {RING_N * (RING_N + 1) // 2}-launch ring of "
          f"all {h} heads {ring_ms:.3f} ms, ratio {k_ms / ring_ms:.3f}; bound {b_ms:.3f} ms "
          f"({b_by})", flush=True)
    report["flash_attention_wgmma_ring_heads_on_model"] = dict(
        max_abs_err=plain_err, max_abs_err_vs_single_pass=err.max().item(), ms=k_ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=sdpa_ms,
        launches=want_launches, ring_of_all_heads_ms=ring_ms)
    del blocks, got
    return {f"ring heads on model={m} S={RING_SEQ}": launches["flash_attention_wgmma"]}


@phase("model parallelism (c, e5): the wgmma kernel on a TP rank's local heads at the serve "
       "shapes vs plain")
def local_heads(report: dict) -> None:
    """Each LOCAL_HEADS row at its serve shape (B = 4, S = T = 4,096, bf16)
    on one TP rank's heads: Llama-3-8B's H 16 / KV 4 (``model`` 2) and H 8 /
    KV 2 (``model`` 4), and at ``model`` 2 Zamba2-7B's shared attention (H
    = KV = 16, hd 112, window 4096), InternVL2-26B's H 24 / KV 4 and
    SeamlessM4T's encoder (H = KV = 8, hd 64, non-causal), through the
    wgmma route, against the plain version within FLASH_TOL; kernel time,
    bound and SDPA's time. Adds the rows
    ``flash_attention_wgmma_local_heads_h{H}_kv{KV}``."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(21)
    b, s = 4, 4096
    for h, kv, hd, causal, window, m, whose in LOCAL_HEADS:
        q, k, v = ((0.3 * torch.randn((b, s, heads, hd), generator=gen, device="cuda"))
                   .to(torch.bfloat16) for heads in (h, kv, kv))

        def run():
            return fa.flash_attention(q, k, v, causal=causal, window=window)

        fa.reset_launches()
        out = run()
        require(fa.launches["flash_attention_wgmma"] == 1 and fa.launches["flash_attention_simt"]
                == 0, f"local heads H={h}/{kv}: not the wgmma route: {fa.launches}")
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        err = _out_error(f"local heads H={h}/{kv}", out, want)
        pairs = visible_pairs(s, s, causal, window)
        b_ms, b_by = bound((2 * q.numel() + 2 * k.numel()) * 2, 4.0 * b * h * hd * pairs,
                           BF16_FLOPS)
        k_ms = kernel_ms(run, "flash_fwd_wgmma_kernel", iters=10)
        p_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=causal, window=window),
                       2, warmup=1)
        lib_ms = cuda_ms(_sdpa(q, k, v, causal, window), 20)
        mask = f"causal window {window}" if window else ("causal" if causal else "non-causal")
        print(f"local heads of model={m}, {whose}: B={b} S=T={s} H={h}/{kv} hd={hd} {mask} bf16 "
              f"(wgmma): max_abs_err={err:.3e} (tol rtol {FLASH_TOL['bfloat16'][0]:g} atol "
              f"{FLASH_TOL['bfloat16'][1]:g}); kernel {k_ms:.3f} ms (profiler), bound "
              f"{b_ms:.3f} ms ({b_by}), plain {p_ms:.3f} ms (events), "
              f"scaled_dot_product_attention {lib_ms:.3f} ms (events)", flush=True)
        report[f"flash_attention_wgmma_local_heads_h{h}_kv{kv}"] = dict(
            max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms)
        del q, k, v, out, want
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _nccl_world_of_one():
    """An NCCL process group of one rank on the card, destroyed on exit."""
    import tempfile

    import torch
    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg", rank=0, world_size=1,
                                device_id=torch.device("cuda", 0))
        try:
            yield
        finally:
            dist.destroy_process_group()


@phase("model parallelism (a): Llama-3-8B prefill + 8 decode tokens on a 1x1 serve plan "
       "(NCCL, world of one), weights placed as DTensors")
def tp_serve_world_of_one(cfg, params) -> int:
    """The serve phase's weights placed on a 1x1 ``(data, model)`` mesh
    (``dist.placement.place_tree``; every placement Replicate) and served
    under ``activation_mesh(make_plan(mesh, mode="serve"))``: B = 4, the
    serve context, 8 greedy tokens; tokens and last logits bit-equal to
    the unplaced ``serve.generate``, no collective counted, 32 wgmma
    launches in the placed run. Returns those launches."""
    import numpy as np
    import torch
    from repro_torch.dist.activations import activation_mesh
    from repro_torch.dist.collectives import CollectiveCounter
    from repro_torch.dist.placement import place_tree
    from repro_torch.dist.plan import make_plan
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_production_mesh

    new = 8
    ctx = np.random.default_rng(5).integers(0, cfg.vocab, (SERVE_BATCH, SERVE_CONTEXT))
    want = serve.generate(cfg, params, ctx, new)
    with _nccl_world_of_one():
        plan = make_plan(make_production_mesh(shape="1x1"), mode="serve")
        placed = place_tree(plan, params)
        _reset_all_launches()
        with CollectiveCounter() as counter, activation_mesh(plan):
            got = serve.generate(cfg, placed, ctx, new)
        launches = _all_launches()
        del placed
    require(launches["flash_attention_wgmma"] == cfg.n_layers
            and launches["flash_attention_simt"] == 0,
            f"placed serve: launches {launches}, want {cfg.n_layers} through wgmma")
    require(not counter.log, f"a world of one counted collectives: {counter.log[:4]}")
    require(torch.equal(got.tokens, want.tokens), "placed serve: tokens differ")
    require(torch.equal(got.logits, want.logits), "placed serve: last logits differ")
    print(f"{SERVE_ARCH} on a 1x1 serve plan (NCCL, one rank), weights as DTensors: "
          f"{SERVE_BATCH} x {SERVE_CONTEXT} prefill + {new} tokens bit-equal to the unplaced "
          f"serve (tokens and last logits), 0 collectives, {launches['flash_attention_wgmma']} "
          f"wgmma launches; prefill {got.prefill_seconds:.4f} s against "
          f"{want.prefill_seconds:.4f} unplaced; group destroyed", flush=True)
    return launches["flash_attention_wgmma"]


@phase("model parallelism (a): one Granite-3.0 1B-A400M train step placed on a 1x1 mesh "
       "(NCCL, world of one) from train (b)'s state")
def tp_train_world_of_one(cfg, opt, params, state, batch) -> None:
    """Train (b)'s parameters and Adam state placed on a 1x1 ``(data,
    model)`` mesh (``place_tree``, ``place_opt_state``) and one
    ``make_train_step(..., mesh=)`` on the first row of its batch, against
    the unplaced step from the same state: parameters, Adam state and
    metrics bit-equal; every output placement its input's (the step checks
    each gradient's); no collective counted."""
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.dist.collectives import CollectiveCounter
    from repro_torch.dist.placement import full_tree, place_opt_state, place_tree
    from repro_torch.dist.plan import make_plan
    from repro_torch.dist.sharding import param_specs
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import make_train_step

    batch = {k: v[:1] for k, v in batch.items()}
    t0 = time.perf_counter()
    want_p, want_s, want_m = make_train_step(cfg, opt)(params, state, batch)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    with _nccl_world_of_one():
        mesh = make_production_mesh(shape="1x1")
        plan = make_plan(mesh)
        placed = place_tree(plan, params)
        pstate = place_opt_state(plan, state, param_specs(plan, params))
        step = make_train_step(cfg, opt, mesh=mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with CollectiveCounter() as counter:
            got_p, got_s, got_m = step(placed, pstate, batch)
        torch.cuda.synchronize()
        placed_s = time.perf_counter() - t0
        for a, b in zip(tree_util.leaves(got_p) + tree_util.leaves(got_s["mu"]),
                        tree_util.leaves(placed) + tree_util.leaves(pstate["mu"])):
            require(a.placements == b.placements, "a placement changed in the step")
        got_p, got_s = full_tree(got_p), full_tree(got_s)
    require(not counter.log, f"a world of one counted collectives: {counter.log[:4]}")
    for name, a, b in (("params", got_p, want_p), ("adam state", got_s, want_s)):
        require(all(torch.equal(x, y) for x, y in zip(tree_util.leaves(a), tree_util.leaves(b))),
                f"placed step: {name} differ from the unplaced step")
    require(all(torch.equal(got_m[k], want_m[k]) for k in want_m), "placed step: metrics differ")
    print(f"{cfg.name} train step on a 1x1 mesh (NCCL, one rank), parameters and Adam state as "
          f"DTensors, 1 x {batch['tokens'].shape[1]} tokens: parameters, Adam state and "
          f"metrics bit-equal to the unplaced step (loss {want_m['loss'].item():.6f}); 0 "
          f"collectives; placements unchanged; {placed_s:.3f} s against {plain_s:.3f} s "
          f"unplaced; group destroyed", flush=True)


def _coll_line(rec: dict) -> str:
    """A dry-run record's collectives a step: count and result GB by axis
    and kind."""
    return "; ".join(f"{axis} {kind} {v['count']} / {v['bytes'] / 1e9:.4f} GB"
                     for axis, kinds in sorted(rec["collectives"].items())
                     for kind, v in sorted(kinds.items()))


@phase("model parallelism (d): rank 0 of a 4-card Llama-3-8B trainer (data 2 x model 2) "
       "under the fake process group, then TP prefills on 1x2 and 1x4 serve meshes")
def tp_dryrun() -> dict:
    """``launch.dryrun`` at full width: train_4k with the global batch cut
    from 256 to 2, 1 warm-up + 2 timed steps, adamw with fp32 masters and
    full remat, as rank 0 of a 2x2 mesh under torch's fake process group
    (no data moves: the loss is not held). Its collective bytes and counts
    by axis and kind for a step must equal ``analytic_collectives``, alike
    in both timed steps; peak below 80 GB, and the peak from a step's start
    to its optimizer update (forward, backward, clip) inside DRYRUN_FWD_BWD_GB,
    PERF.md's prediction (a layer gathered outside its remat body would
    raise it past the band); no kernel launch (training runs none). Then a
    prefill_32k shape cut to B = 4, 4,096 positions (flash) on each of
    DRYRUN_PREFILLS' serve meshes: one wgmma launch a layer and a pass at
    the rank's local heads. Returns each prefill's launches."""
    import torch
    from repro_torch.launch import dryrun

    _reset_all_launches()
    rec = dryrun.main(["--arch", SERVE_ARCH, "--shape", "train_4k", "--mesh-shape", "2x2",
                       "--batch", "2", "--steps", "2"])
    launches = _all_launches()
    require(not any(launches.values()), f"the dry-run train steps launched kernels: {launches}")
    require(rec["collectives"] == rec["analytic_collectives"],
            f"collectives {rec['collectives']} != analytic {rec['analytic_collectives']}")
    require(rec["collectives_same_each_step"], "the two timed steps issued different collectives")
    require(rec["peak_gb"] < 80.0, f"peak {rec['peak_gb']:.2f} GB")
    lo, hi = DRYRUN_FWD_BWD_GB
    require(lo <= rec["fwd_bwd_peak_gb"] <= hi,
            f"forward/backward peak {rec['fwd_bwd_peak_gb']:.2f} GB outside {lo}-{hi} GB")
    coll = _coll_line(rec)
    print(f"dry run {SERVE_ARCH} train_4k (global batch cut to 2), rank 0 of 2x2 (data x model), "
          f"fake process group (no data moved: values not held): {rec['s_per_step']:.3f} s/step "
          f"(steps {[f'{t:.3f}' for t in rec['step_seconds']]}), peak {rec['peak_gb']:.2f} GB, "
          f"forward/backward peak {rec['fwd_bwd_peak_gb']:.2f} GB; "
          f"per rank: params {rec['param_bytes'] / 1e9:.3f} GB, grads "
          f"{rec['grad_bytes'] / 1e9:.3f} GB, adamw {rec['opt_bytes'] / 1e9:.3f} GB; "
          f"collectives a step (result bytes), equal to the analytic count: {coll}; roofline "
          f"terms compute {rec['compute_term_s']:.4f} s, memory {rec['memory_term_s']:.4f} s, "
          f"collectives' wire bytes at NVLink {rec['collective_term_s']:.4f} s", flush=True)
    out = {}
    cfg_layers = 32
    for mesh_shape in DRYRUN_PREFILLS:
        m = int(mesh_shape.split("x")[1])
        _reset_all_launches()
        rec = dryrun.main(["--arch", SERVE_ARCH, "--shape", "prefill_32k", "--mesh-shape",
                           mesh_shape, "--batch", str(SERVE_BATCH), "--seq", "4096",
                           "--steps", "1"])
        torch.cuda.synchronize()
        launches = _all_launches()
        require(launches["flash_attention_wgmma"] == 2 * cfg_layers
                and launches["flash_attention_simt"] == 0,
                f"dry-run prefill {mesh_shape}: launches {launches}, want {2 * cfg_layers} wgmma")
        coll = _coll_line(rec)
        print(f"dry run {SERVE_ARCH} prefill B={SERVE_BATCH} x 4096 on a {mesh_shape} serve mesh "
              f"(heads H={32 // m}/{8 // m} a rank; fake group: values not held): "
              f"{rec['s_per_step']:.4f} s, peak {rec['peak_gb']:.2f} GB, params "
              f"{rec['param_bytes'] / 1e9:.3f} GB a rank, {launches['flash_attention_wgmma']} "
              f"wgmma launches (warm-up + 1), collectives {coll}", flush=True)
        out[f"dry-run prefill {mesh_shape} (H={32 // m}/{8 // m})"] = \
            launches["flash_attention_wgmma"]
    return out


# ------------------------------------ model parallelism of the other families

TP_FAMILIES = (RWKV6_ARCH, ZAMBA2_ARCH, SEAMLESS_ARCH, INTERNVL2_ARCH)
# wgmma launches of one prefill pass at full size: one a (shared-)attention layer at the
# rank's local heads (Seamless: its encoder's; its decoder's prefill is one BOS step, dense)
TP_PASS_LAUNCHES = {RWKV6_ARCH: 0, ZAMBA2_ARCH: 9, SEAMLESS_ARCH: 24, INTERNVL2_ARCH: 48}
TP_PREFILL_MESH, TP_TRAIN_MESH, GATE_MESH = "1x2", "2x2", "1x1x4x1"


def _family_batch(cfg, seed: int) -> dict:
    """A reduced family's batch on the card: B = 4, 64 tokens (their
    labels), a mask of ones, and the encdec source frames or the vlm patch
    embeddings."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    b, s = 4, 64
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)), device="cuda")
    batch = {"tokens": toks, "labels": toks, "mask": torch.ones((b, s), device="cuda")}
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.as_tensor(
            rng.standard_normal((b, 24, cfg.d_model), dtype=np.float32), device="cuda")
    if cfg.family == "vlm":
        batch["vis_embeds"] = torch.as_tensor(
            rng.standard_normal((b, cfg.n_vis_tokens, cfg.d_model), dtype=np.float32),
            device="cuda")
    return batch


def _family_greedy(cfg, params, batch, new: int = 8):
    """The prefill's and ``new`` greedy decode steps' logits, stacked."""
    import torch
    from repro_torch.models import decode

    inputs = {k: v for k, v in batch.items() if k not in ("labels", "mask")}
    if cfg.family == "encdec":
        inputs.pop("tokens")
    ctx = batch["tokens"].shape[1] + (cfg.n_vis_tokens if cfg.family == "vlm" else 0)
    logits, cache = decode.prefill(cfg, params, inputs, ctx + new)
    out = [logits]
    for _ in range(new):
        logits, cache = decode.decode_step(cfg, params, cache, torch.argmax(out[-1], -1))
        out.append(logits)
    return torch.stack(out)


@phase("model parallelism (e1): the reduced RWKV6-7B, Zamba2-7B, SeamlessM4T-large-v2 and "
       "InternVL2-26B placed on a 1x1 mesh (NCCL, world of one)")
def tp_families_world_of_one() -> None:
    """Each family's reduced config (fp32), weights placed as DTensors on a
    1x1 ``(data, model)`` mesh: ``value_and_grad`` of a B = 4 x 64 batch
    under the train plan, prefill and 8 greedy decode steps under the serve
    plan; loss, every gradient and every step's logits bit-equal to the
    unplaced runs, no collective counted. At ``model`` 1 no head is split:
    this holds the placement and the NCCL path; the split's numbers are
    held on CPU ranks, its full-width shapes by (e2) and (e3)."""
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_reduced
    from repro_torch.dist.activations import activation_mesh
    from repro_torch.dist.collectives import CollectiveCounter
    from repro_torch.dist.placement import full_tree, place_tree
    from repro_torch.dist.plan import make_plan
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import model

    with _nccl_world_of_one():
        mesh = make_production_mesh(shape="1x1")
        train, serve = make_plan(mesh), make_plan(mesh, mode="serve")
        for arch in TP_FAMILIES:
            cfg = get_reduced(arch)
            params = model.init_params(cfg, 0, param_dtype=torch.float32)
            batch = _family_batch(cfg, 4)
            loss, _, grads = value_and_grad(cfg, params, batch)
            logits = _family_greedy(cfg, params, batch)
            with CollectiveCounter() as counter:
                with activation_mesh(train):
                    got_loss, _, got_grads = value_and_grad(cfg, place_tree(train, params), batch)
                with activation_mesh(serve):
                    got_logits = _family_greedy(cfg, place_tree(serve, params), batch)
            require(not counter.log, f"{arch}: a world of one counted collectives: "
                                     f"{counter.log[:4]}")
            require(torch.equal(got_loss, loss), f"{arch}: placed loss differs")
            require(all(torch.equal(a, b) for a, b in zip(
                tree_util.leaves(full_tree(got_grads)), tree_util.leaves(grads))),
                f"{arch}: placed gradients differ")
            require(torch.equal(got_logits, logits), f"{arch}: placed prefill/decode logits differ")
            print(f"reduced {arch} on a 1x1 mesh (NCCL, one rank), weights as DTensors: loss "
                  f"{loss.item():.6f} and {len(tree_util.leaves(grads))} gradient leaves (train "
                  f"plan), prefill + 8 decode steps' logits (serve plan) bit-equal to the "
                  f"unplaced runs; 0 collectives", flush=True)


@phase("model parallelism (e2): full-width TP prefills of RWKV6-7B, Zamba2-7B, "
       "SeamlessM4T-large-v2 and InternVL2-26B, rank 0 of a 1x2 serve mesh (fake group)")
def tp_family_prefills() -> dict:
    """``launch.dryrun`` of each family's prefill_32k shape cut to B = 4,
    4,096 positions (the vlm's 256 patches among them; the encdec's 4,096
    source frames), as rank 0 of a ``1x2`` serve mesh under torch's fake
    process group (no data moved: values not held), warm-up + 1 timed
    pass: its time, peak, parameter bytes a rank and collectives by axis
    and kind; TP_PASS_LAUNCHES wgmma launches a pass at the rank's local
    heads, none through SIMT. Returns each prefill's launches, keyed by
    the local heads."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    out = {}
    for arch in TP_FAMILIES:
        cfg = get_config(arch)
        heads = f" (H={cfg.n_heads // 2}/{cfg.n_kv_heads // 2})" if cfg.n_heads else ""
        _reset_all_launches()
        rec = dryrun.main(["--arch", arch, "--shape", "prefill_32k", "--mesh-shape",
                           TP_PREFILL_MESH, "--batch", str(SERVE_BATCH), "--seq", "4096",
                           "--steps", "1"])
        torch.cuda.synchronize()
        launches = _all_launches()
        want = 2 * TP_PASS_LAUNCHES[arch]
        require(launches["flash_attention_wgmma"] == want and launches["flash_attention_simt"] == 0,
                f"{arch} TP prefill: launches {launches}, want {want} through wgmma")
        require(rec["collectives_same_each_step"], f"{arch}: warm-up and timed collectives differ")
        print(f"dry run {arch} prefill B={SERVE_BATCH} x 4096, rank 0 of a {TP_PREFILL_MESH} serve "
              f"mesh{heads} (fake group: values not held): {rec['s_per_step']:.4f} s, peak "
              f"{rec['peak_gb']:.2f} GB, params {rec['param_bytes'] / 1e9:.3f} GB a rank, "
              f"{launches['flash_attention_wgmma']} wgmma launches (warm-up + 1), 0 SIMT; "
              f"collectives a pass {_coll_line(rec)}", flush=True)
        if want:
            out[f"dry-run prefill {arch} {TP_PREFILL_MESH}{heads}"] = \
                launches["flash_attention_wgmma"]
        _release()
    return out


@phase("model parallelism (e3): rank 0 of a 4-card Zamba2-7B trainer (data 2 x model 2) "
       "under the fake process group")
def tp_zamba2_train() -> None:
    """``launch.dryrun`` of Zamba2-7B's train_4k with the global batch cut
    from 256 to 2, warm-up + 1 timed step, adamw with fp32 masters and
    full remat (chunked attention), as rank 0 of a ``2x2`` mesh: the
    Mamba2 in-projection's output gathered over ``model`` with a
    reduce-scatter backward, at full width. Peak under 80 GB, the same
    collectives in the warm-up and the timed step, no kernel launch."""
    from repro_torch.launch import dryrun

    _reset_all_launches()
    rec = dryrun.main(["--arch", ZAMBA2_ARCH, "--shape", "train_4k", "--mesh-shape",
                       TP_TRAIN_MESH, "--batch", "2", "--steps", "1"])
    launches = _all_launches()
    require(not any(launches.values()), f"the Zamba2 dry-run step launched kernels: {launches}")
    require(rec["collectives_same_each_step"], "Zamba2: warm-up and timed collectives differ")
    require(rec["peak_gb"] < 80.0, f"Zamba2 dry-run peak {rec['peak_gb']:.2f} GB")
    print(f"dry run {ZAMBA2_ARCH} train_4k (global batch cut to 2), rank 0 of {TP_TRAIN_MESH} "
          f"(data x model), fake process group (values not held): {rec['s_per_step']:.3f} s/step, "
          f"peak {rec['peak_gb']:.2f} GB, forward/backward peak {rec['fwd_bwd_peak_gb']:.2f} GB; "
          f"per rank: params {rec['param_bytes'] / 1e9:.3f} GB, grads "
          f"{rec['grad_bytes'] / 1e9:.3f} GB, adamw {rec['opt_bytes'] / 1e9:.3f} GB; "
          f"collectives a step (result bytes) {_coll_line(rec)}; no kernel launch", flush=True)
    _release()


@phase("model parallelism (e4): the dry run's gates, Llama-3-8B prefill_32k at B=1 on 1x1x4x1 "
       "(fake group), and their negative controls")
def tp_gates() -> dict:
    """``launch.dryrun --require-seq-sharded --require-flash`` of
    Llama-3-8B's prefill_32k cut to B = 1 as rank 0 of a ``(pod, data,
    seq, model) = 1x1x4x1`` mesh under the fake group: both gates hold on
    the gates' untimed pass under the shape log, the ring's seq-axis
    send/recv are counted (``ring_p2p``) and its wgmma launches (rank 0 of
    a causal ring: its diagonal step, one a layer and a pass; the warm-up,
    the logged pass and one timed pass). Then each gate fails on
    purpose on the reduced Llama: ``--require-seq-sharded`` on a ``1x2``
    mesh, ``--require-flash`` at 512 positions (dense attention's
    scores). Returns the launches."""
    import torch
    from repro_torch.launch import dryrun

    _reset_all_launches()
    rec = dryrun.main(["--arch", SERVE_ARCH, "--shape", "prefill_32k", "--mesh-shape",
                       GATE_MESH, "--batch", "1", "--steps", "1", "--require-seq-sharded",
                       "--require-flash"])
    torch.cuda.synchronize()
    launches = _all_launches()
    n_layers = 32
    require(rec["seq_sharded_ok"] and rec["no_s2_scores_ok"], f"gates: {rec}")
    require(rec["ring_p2p"] > 0, "gates: no seq-axis send/recv counted")
    require(launches["flash_attention_wgmma"] == 3 * n_layers
            and launches["flash_attention_simt"] == 0,
            f"gates: launches {launches}, want {3 * n_layers} through wgmma")
    print(f"dry run {SERVE_ARCH} prefill_32k B=1, rank 0 of {GATE_MESH} (pod, data, seq, model; "
          f"fake group: values not held) --require-seq-sharded --require-flash: seq_sharded_ok "
          f"{rec['seq_sharded_ok']}, no_s2_scores_ok {rec['no_s2_scores_ok']}, ring_p2p "
          f"{rec['ring_p2p']}; {_log_on_off(rec)} s a pass, peak {rec['peak_gb']:.2f} GB, "
          f"{launches['flash_attention_wgmma']} wgmma launches (warm-up, logged, 1 timed), "
          f"0 SIMT; collectives a pass {_coll_line(rec)}", flush=True)
    for argv, match in ((["--mesh-shape", "1x2", "--seq", "128", "--require-seq-sharded"],
                         "full-seq intermediates"),
                        (["--mesh-shape", "1x2", "--seq", "512", "--require-flash"],
                         "O(S^2) score tensors")):
        try:
            dryrun.main(["--arch", SERVE_ARCH, "--reduced", "--shape", "prefill_32k",
                         "--batch", "4", "--steps", "1", *argv])
        except AssertionError as e:
            require(match in str(e), f"negative control {argv}: {e}")
            print(f"negative control {' '.join(argv)} (reduced {SERVE_ARCH}): failed as it "
                  f"should: {str(e)[:160]}", flush=True)
        else:
            raise SmokeFailure(f"negative control {argv}: the gate held")
    _release()
    return {f"dry-run gates prefill_32k {GATE_MESH} (H=32/8)": launches["flash_attention_wgmma"]}


# ------------------------------------------------- sequence parallelism, part 2

SEQ_MESH = "1x1x4x1"          # (pod, data, seq, model): rank 0 of 4 seq ranks
SEQ_ZAMBA2_TRAIN_MESH = "1x4x2x1"   # FSDP over 4 data ranks: Zamba2's fp32 state fits a card
# a ring step of each seq prefill_32k at rank 0 of SEQ_MESH, B = 1, 8,192
# queries and keys: the causal rings' diagonal step (offsets 0), the
# Seamless encoder's non-causal step from the shard before it (q_offset -
# k_offset = 8,192; every step of its ring is visible). name, arch, (H, KV,
# hd, window, causal, q_offset - k_offset), wgmma launches a pass on rank 0
SEQ_RINGS = (("flash_attention_wgmma_ring_hd112_window", ZAMBA2_ARCH,
              (32, 32, 112, 4096, True, 0), 9),
             ("flash_attention_wgmma_ring_hd64", GRANITE_ARCH, (16, 8, 64, 0, True, 0), 24),
             ("flash_attention_wgmma_ring_hd64_noncausal", SEAMLESS_ARCH,
              (16, 16, 64, 0, False, 8192), 24 * RING_N))
# rank 0's ring step in (h2)'s prefill_32k on 1x4x2x16 (A2A_MESH): its 8 of
# the 32 rows, 16,384 queries and keys, all 16 heads (KV 8 does not divide
# model 16, so the ring keeps them whole), the causal diagonal step (rank
# 1's shard is all in its future). name, arch, (B, S), (H, KV, hd, window,
# causal, q_offset - k_offset)
A2A_RING = ("flash_attention_wgmma_ring_hd64_b8_s16k", GRANITE_ARCH, (8, 16384),
            (16, 8, 64, 0, True, 0))
SEQ_RECURRENT_TOL = 1e-5      # of the largest magnitude: the fold against one scan, fp32


def _log_on_off(rec: dict) -> str:
    """A gated dry run's time a step: the timed steps (no shape log), and
    the gates' untimed step under the log, apart."""
    return (f"{rec['s_per_step']:.4f} (no shape log; the gates' logged step "
            f"{rec['shape_log_step_s']:.4f})")


def _seq_line(rec: dict) -> str:
    """A dry-run record's seq-axis collectives a step, by kind."""
    return ", ".join(f"{kind} {v['count']} / {v['bytes'] / 1e9:.4f} GB"
                     for kind, v in sorted(rec["collectives"].get("seq", {}).items())) or "none"


@phase("sequence parallelism (f1): Granite-3.0 1B-A400M train_4k (batch 4) as rank 0 of "
       "1x1x4x1 under the fake group, --require-seq-sharded; Zamba2-7B's train gate on 1x4x2x1")
def seq_train_gates() -> None:
    """``launch.dryrun`` of Granite's train step on a ``seq`` axis of 4:
    rank 0 keeps 1,024 of the 4,096 positions (two 512-token routing
    groups), K and V gathered over ``seq``; the gate holds, and the seq
    collectives are counted by kind. Then Zamba2-7B's train_4k (batch 4)
    on ``1x4x2x1`` with the gate on: its K and V carry KV x hd = d_model
    channels, so their gather over ``seq`` is a full-length tensor of 2 B
    S d_model bytes; the gate's report is printed, not loosened."""
    from repro_torch.launch import dryrun

    _reset_all_launches()
    rec = dryrun.main(["--arch", GRANITE_ARCH, "--shape", "train_4k", "--mesh-shape", SEQ_MESH,
                       "--batch", "4", "--steps", "1", "--require-seq-sharded"])
    launches = _all_launches()
    require(rec["seq_sharded_ok"], f"Granite train gate: {rec.get('full_seq_intermediates')}")
    seq = rec["collectives"].get("seq", {})
    require(seq.get("all-gather", {}).get("count", 0) > 0
            and seq.get("reduce-scatter", {}).get("count", 0) > 0,
            f"Granite seq-parallel step: seq collectives {seq}")
    require(rec["collectives_same_each_step"], "Granite: warm-up and timed collectives differ")
    require(not any(launches.values()), f"the Granite train step launched kernels: {launches}")
    print(f"dry run {GRANITE_ARCH} train_4k (global batch cut to 4), rank 0 of {SEQ_MESH} (fake "
          f"group: values not held) --require-seq-sharded: seq_sharded_ok {rec['seq_sharded_ok']}; "
          f"{_log_on_off(rec)} s/step, peak {rec['peak_gb']:.2f} GB, "
          f"forward/backward peak {rec['fwd_bwd_peak_gb']:.2f} GB; seq collectives a step: "
          f"{_seq_line(rec)}; all {_coll_line(rec)}", flush=True)
    _release()
    try:
        dryrun.main(["--arch", ZAMBA2_ARCH, "--shape", "train_4k", "--mesh-shape",
                     SEQ_ZAMBA2_TRAIN_MESH, "--batch", "4", "--steps", "1",
                     "--require-seq-sharded"])
    except AssertionError as e:
        print(f"dry run {ZAMBA2_ARCH} train_4k (global batch 4), rank 0 of "
              f"{SEQ_ZAMBA2_TRAIN_MESH} --require-seq-sharded: the gate reports {str(e)[:600]}",
              flush=True)
    else:
        print(f"dry run {ZAMBA2_ARCH} train_4k on {SEQ_ZAMBA2_TRAIN_MESH}: the gate held",
              flush=True)
    _release()


@phase("sequence parallelism (f2)-(f4): RWKV6-7B, Zamba2-7B and Granite-3.0 1B-A400M "
       "prefill_32k at B=1 as rank 0 of 1x1x4x1 under the fake group, with the gates")
def seq_family_prefills() -> dict:
    """``launch.dryrun`` of each prefill_32k at B = 1 as rank 0 of
    SEQ_MESH, warm-up, the gates' pass under the shape log and 1 timed pass: RWKV6-7B with
    ``--require-seq-sharded`` (no attention: its halos and state pairs are
    the seq all-gathers); Zamba2-7B and Granite with both gates, the ring
    (``ring_p2p`` > 0) through wgmma at hd 112 with window 4,096 and at hd
    64, rank 0's diagonal step one launch a layer, none through SIMT.
    Returns each ring's launches."""
    import torch
    from repro_torch.launch import dryrun

    out = {}
    for arch, flash in ((RWKV6_ARCH, False), (ZAMBA2_ARCH, True), (GRANITE_ARCH, True)):
        _reset_all_launches()
        rec = dryrun.main(["--arch", arch, "--shape", "prefill_32k", "--mesh-shape", SEQ_MESH,
                           "--batch", "1", "--steps", "1", "--require-seq-sharded",
                           *(["--require-flash"] if flash else [])])
        torch.cuda.synchronize()
        launches = _all_launches()
        want = 3 * next((n for _r, a, _s, n in SEQ_RINGS if a == arch), 0)   # 3 passes
        require(rec["seq_sharded_ok"], f"{arch} prefill: {rec.get('full_seq_intermediates')}")
        require(launches["flash_attention_wgmma"] == want and launches["flash_attention_simt"] == 0,
                f"{arch} seq prefill: launches {launches}, want {want} through wgmma")
        if flash:
            require(rec["no_s2_scores_ok"] and rec["ring_p2p"] > 0,
                    f"{arch} seq prefill: flash gate {rec.get('s2_offenders')}, ring_p2p "
                    f"{rec.get('ring_p2p')}")
        require(rec["collectives"].get("seq", {}).get("all-gather", {}).get("count", 0) > 0,
                f"{arch}: no seq all-gather (halos, states or cache rows)")
        print(f"dry run {arch} prefill_32k B=1, rank 0 of {SEQ_MESH} (fake group: values not "
              f"held) --require-seq-sharded{' --require-flash' if flash else ''}: "
              f"seq_sharded_ok {rec['seq_sharded_ok']}"
              + (f", no_s2_scores_ok {rec['no_s2_scores_ok']}, ring_p2p {rec['ring_p2p']}"
                 if flash else "")
              + f"; {_log_on_off(rec)} s a pass, peak {rec['peak_gb']:.2f} "
              f"GB, {launches['flash_attention_wgmma']} wgmma launches (warm-up, logged, 1 "
              f"timed), 0 SIMT; "
              f"seq collectives a pass: {_seq_line(rec)}", flush=True)
        if want:
            out[f"seq-parallel prefill_32k {arch} {SEQ_MESH}"] = launches["flash_attention_wgmma"]
        _release()
    return out


SEAMLESS_LAYERS = 24           # encoder and decoder layers of SeamlessM4T-large-v2


def _seq_gate_report(label: str, argv: list, tensor: str) -> None:
    """``launch.dryrun`` with ``--require-seq-sharded`` where the JAX
    package's step fails the gate too: the gate must fail (the port's
    verdict equal to JAX's), among its offenders ``tensor`` (the shape
    label of what both packages hold whole; other offenders may be
    flattened dims that merely equal S, the rule's numeric caveat). Its
    report is printed."""
    from repro_torch.launch import dryrun

    try:
        dryrun.main([*argv, "--require-seq-sharded"])
    except AssertionError as e:
        shapes = [o["shape"] for o in e.offenders]
        require(tensor in shapes, f"{label}: no {tensor} among the offenders: {e}")
        print(f"{label} --require-seq-sharded: fails, as the JAX package's step does, "
              f"{shapes.count(tensor)} of its {len(shapes)} offenders {tensor}: "
              f"{str(e)[:600]}", flush=True)
        return
    raise SmokeFailure(f"{label}: the seq gate held where the JAX package's step fails it")


# the flash gate's rule (the JAX package's) counts a dim as carrying the
# sequence when it is a multiple of the per-rank length: at 32,768 / 4 =
# 8,192 = Seamless's d_ff it reads the SwiGLU hidden (8192, 8192) as scores.
# The gate runs where no such collision is, 7,680 positions a rank (15 of
# its 512-position chunks); the path and its kernels run at 32,768
SEAMLESS_GATE_SEQ = 30_720


@phase("sequence parallelism (f6): SeamlessM4T-large-v2 prefill_32k at B=1 as rank 0 of "
       "1x1x4x1 under the fake group: the encoder's non-causal ring; the gates")
def seq_seamless_prefill() -> dict:
    """``launch.dryrun`` of Seamless's prefill_32k at B = 1 as rank 0 of
    SEQ_MESH: the encoder runs its 8,192 source positions through the
    non-causal ring (every step visible: 4 wgmma launches a layer on rank
    0, none through SIMT; 24 layers x 3 rotations x (k, v) send/recv); the
    encoder memory is all-gathered over ``seq`` once a pass, so every rank
    builds the whole cross k/v, and the BOS step runs whole. Then
    ``--require-flash`` at SEAMLESS_GATE_SEQ positions (no O(S²) scores,
    ``ring_p2p`` the same), and the seq gate at 32,768, which the JAX
    package's prefill fails too (``tests/test_torch_dryrun.py``): its
    report. Returns the ring's launches in the first run."""
    import torch

    from repro_torch.launch import dryrun

    argv = ["--arch", SEAMLESS_ARCH, "--shape", "prefill_32k", "--mesh-shape", SEQ_MESH,
            "--batch", "1", "--steps", "1"]
    p2p = SEAMLESS_LAYERS * (RING_N - 1) * 2
    per_pass = next(n for _r, a, _s, n in SEQ_RINGS if a == SEAMLESS_ARCH)
    _reset_all_launches()
    rec = dryrun.main(argv)
    torch.cuda.synchronize()
    launches = _all_launches()
    seq = rec["collectives"].get("seq", {})
    require(launches["flash_attention_wgmma"] == 2 * per_pass
            and launches["flash_attention_simt"] == 0,
            f"Seamless seq prefill: launches {launches}, want {per_pass} a pass (warm-up and 1 "
            "timed) through wgmma")
    require(seq.get("send/recv", {}).get("count") == p2p,
            f"Seamless seq prefill: seq send/recv {seq.get('send/recv')}, want {p2p}")
    require(seq.get("all-gather", {}).get("count", 0) == 1,
            f"Seamless seq prefill: want one seq all-gather (the memory): {seq}")
    require(rec["collectives_same_each_step"], "Seamless prefill: passes differ in collectives")
    print(f"dry run {SEAMLESS_ARCH} prefill_32k B=1, rank 0 of {SEQ_MESH} (fake group: values not "
          f"held): {rec['s_per_step']:.4f} s a pass (no shape log), peak {rec['peak_gb']:.2f} GB, "
          f"{launches['flash_attention_wgmma']} wgmma launches ({per_pass} a pass: warm-up and "
          f"1 timed), 0 SIMT; seq collectives a pass: {_seq_line(rec)}", flush=True)
    _release()
    gated = dryrun.main([*argv, "--seq", str(SEAMLESS_GATE_SEQ), "--require-flash"])
    require(gated["no_s2_scores_ok"] and gated["ring_p2p"] == p2p,
            f"Seamless seq prefill at {SEAMLESS_GATE_SEQ}: flash gate "
            f"{gated.get('s2_offenders')}, ring_p2p {gated.get('ring_p2p')}, want {p2p}")
    print(f"dry run {SEAMLESS_ARCH} prefill_32k cut to {SEAMLESS_GATE_SEQ} positions, B=1, rank 0 "
          f"of {SEQ_MESH} --require-flash: no_s2_scores_ok {gated['no_s2_scores_ok']}, ring_p2p "
          f"{gated['ring_p2p']}; {_log_on_off(gated)} s a pass", flush=True)
    _release()
    # each layer's cross k/v over the whole memory (the cache seq never cuts)
    _seq_gate_report(f"dry run {SEAMLESS_ARCH} prefill_32k B=1 on {SEQ_MESH}", argv,
                     "bfloat16[1,32768,16,64]")
    _release()
    return {f"seq-parallel prefill_32k {SEAMLESS_ARCH} {SEQ_MESH}":
            launches["flash_attention_wgmma"]}


@phase("sequence parallelism (f7): SeamlessM4T-large-v2 train_4k (batch 4) as rank 0 of "
       "1x1x4x1 under the fake group")
def seq_seamless_train() -> None:
    """``launch.dryrun`` of Seamless's train step on a ``seq`` axis of 4:
    rank 0 keeps 1,024 of the 4,096 source frames and 128 of the 512
    target tokens; the encoder's K/V and its memory are gathered over
    ``seq`` (reduce-scatter backward). A finite loss, the same collectives
    in every step; s/step, peak and the seq collectives by kind. Then the
    seq gate: the JAX package's step fails it too (its verdict on the CPU,
    ``tests/test_torch_dryrun.py``), so it must fail here; its report."""
    import math

    from repro_torch.launch import dryrun

    argv = ["--arch", SEAMLESS_ARCH, "--shape", "train_4k", "--mesh-shape", SEQ_MESH,
            "--batch", "4", "--steps", "1"]
    _reset_all_launches()
    rec = dryrun.main(argv)
    launches = _all_launches()
    require(math.isfinite(rec["loss_not_held"]), f"Seamless seq train: loss {rec['loss_not_held']}")
    require(rec["collectives_same_each_step"], "Seamless: warm-up and timed collectives differ")
    seq = rec["collectives"].get("seq", {})
    require(seq.get("all-gather", {}).get("count", 0) > 0
            and seq.get("reduce-scatter", {}).get("count", 0) > 0,
            f"Seamless seq-parallel step: seq collectives {seq}")
    require(not any(launches.values()), f"the Seamless train step launched kernels: {launches}")
    print(f"dry run {SEAMLESS_ARCH} train_4k (global batch cut to 4), rank 0 of {SEQ_MESH} (fake "
          f"group: values not held): loss {rec['loss_not_held']:.4f} (finite); "
          f"{rec['s_per_step']:.4f} s/step (no shape log), peak {rec['peak_gb']:.2f} GB, "
          f"forward/backward peak {rec['fwd_bwd_peak_gb']:.2f} GB; seq collectives a step: "
          f"{_seq_line(rec)}; all {_coll_line(rec)}", flush=True)
    _release()
    # the encoder memory gathered over seq (B, S_src, d)
    _seq_gate_report(f"dry run {SEAMLESS_ARCH} train_4k (batch 4) on {SEQ_MESH}", argv,
                     "bfloat16[4,4096,1024]")
    _release()


@phase("sequence parallelism (f3, f4, f6 kernels): the wgmma kernel at the seq rings' step "
       "shapes vs plain; the Seamless encoder's 32k non-causal ring vs one pass")
def seq_ring_kernels(report: dict) -> None:
    """Each SEQ_RINGS shape: a ring step of rank 0 in the 32k prefill
    (B = 1, 8,192 queries and keys, bf16, the fp32 partial with its lse),
    and A2A_RING's (rank 0's diagonal step in (h2)'s prefill, B = 8, 16,384
    queries and keys), through the wgmma route, against the plain version
    within FLASH_TOL;
    kernel time, bound and SDPA's time (the causal steps' masks as the
    kernel's; the non-causal step without a mask). Seamless's non-causal
    step passes no offset to the kernel (its mask reads no position): it is
    held bit-identical to the same step through the ``OFFSET``
    instantiation, and both are timed. Then the whole non-causal ring at
    32,768 positions through ``LocalRing(4)`` against one wgmma pass
    within FLASH_TOL["bfloat16"]. Adds the rows SEQ_RINGS and A2A_RING
    name; their launches come from (f3), (f4), (f6) and (h2). Timed beside
    the local-heads
    rows, early in the run: a profiler trace late in the full run has come
    back without the kernel's device activity."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(25)
    steps = [(name, arch, (1, 8192), spec) for name, arch, spec, _n in SEQ_RINGS]
    for name, arch, (b, s), (h, kv, hd, window, causal, off) in (*steps, A2A_RING):
        q, k, v = ((0.3 * torch.randn((b, s, heads, hd), generator=gen, device="cuda"))
                   .to(torch.bfloat16) for heads in (h, kv, kv))
        kw = dict(causal=causal, window=window, with_lse=True, out_fp32=True, q_offset=off,
                  k_offset=0)

        def run():
            return fa.flash_attention(q, k, v, **kw)

        fa.reset_launches()
        out, lse = run()
        require(fa.launches["flash_attention_wgmma"] == 1 and fa.launches["flash_attention_simt"]
                == 0, f"{name}: not the wgmma route: {fa.launches}")
        want, want_lse = fa.flash_attention_plain(q, k, v, **kw)
        err = _out_error(name, out, want)
        require(bool(torch.isfinite(lse).all()), f"{name}: non-finite lse")
        pairs = visible_pairs(s, s, causal, window, off)
        b_ms, b_by = bound((q.numel() + 2 * k.numel()) * 2 + out.numel() * 4 + lse.numel() * 4,
                           4.0 * b * h * hd * pairs, BF16_FLOPS)
        k_ms = kernel_ms(run, "flash_fwd_wgmma_kernel", iters=10)
        p_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), 2, warmup=1)
        lib_ms = cuda_ms(_sdpa(q, k, v, causal, window), 20)
        extra = ""
        if off and not causal and not window:
            def offset_run():                 # the same step through the OFFSET instantiation
                return fa._launch(q, k, v, causal=False, window=0, off=off, with_lse=True,
                                  out_fp32=True)

            out_o, lse_o = offset_run()
            require(torch.equal(out_o, out) and torch.equal(lse_o, lse),
                    f"{name}: the OFFSET instantiation's step is not bit-identical")
            off_ms = kernel_ms(offset_run, "flash_fwd_wgmma_kernel", iters=10)
            extra = (f"; through the OFFSET instantiation (offset {off}) bit-identical, "
                     f"{off_ms:.3f} ms (profiler)")
        print(f"{name} ({arch}'s ring, rank 0's step at offset {off}): B={b} S=T={s} H={h}/{kv} "
              f"hd={hd} {'causal' if causal else 'non-causal'}"
              f"{f' window {window}' if window else ''} bf16, fp32 partial (wgmma): "
              f"max_abs_err={err:.3e}; kernel {k_ms:.3f} ms (profiler), bound {b_ms:.3f} ms "
              f"({b_by}, {pairs} visible pairs), plain {p_ms:.3f} ms (events), "
              f"scaled_dot_product_attention{'' if causal else ' without a mask'} "
              f"{lib_ms:.3f} ms (events){extra}", flush=True)
        report[name] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                            library_ms=lib_ms)
        del q, k, v, out, lse, want, want_lse
    _seamless_ring_32k(report)
    torch.cuda.empty_cache()


def _seamless_ring_32k(report: dict) -> None:
    """The Seamless encoder's attention at prefill_32k (B = 1, H = KV = 16,
    hd 64, non-causal) as ``LocalRing(4)`` against one wgmma pass over the
    32,768 positions, within FLASH_TOL["bfloat16"] (each against the plain
    version too): all 16 steps visible and launched. Times: the ring's
    kernels summed, the single pass."""
    import torch
    from repro_torch.dist.ring import LocalRing, ring_flash_attention
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(26)
    q, k, v = ((0.3 * torch.randn((1, RING_SEQ, 16, 64), generator=gen, device="cuda"))
               .to(torch.bfloat16) for _ in range(3))
    single = fa.flash_attention(q, k, v, causal=False)
    want = fa.flash_attention_plain(q, k, v, causal=False)
    single_err = _out_error(f"Seamless single pass S={RING_SEQ}", single, want)
    ring = LocalRing(RING_N)
    _reset_all_launches()
    got = ring_flash_attention(q, k, v, ring=ring, causal=False)
    torch.cuda.synchronize()
    launches = _all_launches()
    require(launches["flash_attention_wgmma"] == RING_N * RING_N
            and launches["flash_attention"] == RING_N * RING_N,
            f"Seamless ring: launches {launches}, want {RING_N * RING_N} through wgmma")
    rtol, atol = FLASH_TOL["bfloat16"]
    err = (got.float() - single.float()).abs()
    require(bool((err <= atol + rtol * single.float().abs()).all()),
            f"Seamless ring: max abs err {err.max().item():.3e} against the single pass")
    ring_err = _out_error(f"Seamless ring S={RING_SEQ}", got, want)
    call = lambda: ring_flash_attention(q, k, v, ring=ring, causal=False)
    ring_ms = kernel_ms(call, "flash_fwd_wgmma_kernel", iters=2) * RING_N * RING_N
    single_ms = kernel_ms(lambda: fa.flash_attention(q, k, v, causal=False),
                          "flash_fwd_wgmma_kernel", iters=3)
    print(f"ring {SEAMLESS_ARCH} encoder B=1 S={RING_SEQ} H=KV=16 hd=64 non-causal, "
          f"LocalRing({RING_N}): {RING_N * RING_N} wgmma launches (every step visible); max abs "
          f"err vs the plain version: single pass {single_err:.3e}, ring {ring_err:.3e}; ring vs "
          f"the single pass {err.max().item():.3e} (tol rtol {rtol:g} atol {atol:g}); ring "
          f"kernels summed {ring_ms:.3f} ms (profiler), single pass {single_ms:.3f} ms "
          f"(profiler), ratio {ring_ms / single_ms:.3f}", flush=True)
    shapes = report.setdefault("flash_attention_wgmma", {}).setdefault("shapes", {})
    shapes[f"{SEAMLESS_ARCH} S={RING_SEQ} non-causal ring of {RING_N}"] = dict(
        max_abs_err=ring_err, max_abs_err_vs_single_pass=err.max().item(), ms=ring_ms,
        single_pass_ms=single_ms, launches=RING_N * RING_N)
    del q, k, v, single, got, want


@phase("sequence parallelism (f5): one full-width RWKV6-7B layer and one Zamba2-7B Mamba2 "
       "block at B=1 x 32768 in fp32, 4 shards through LocalSeq(4) vs the unsharded layer")
def seq_local_fold() -> None:
    """Real values on the card: the layer of each recurrent family at full
    width (fp32 weights from seed 0, fp32 activations: the fold's
    association order against one scan is what is measured, not bf16
    rounding), run whole and as four 8,192-position shards through
    ``dist.seq.LocalSeq(4)``: the halos and the state fold. Output, final
    state and carries within SEQ_RECURRENT_TOL of the largest magnitude of
    the unsharded layer's; both timed with CUDA events."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist.seq import LocalSeq
    from repro_torch.models import model

    b, s, n = 1, 32768, 4
    for arch in (RWKV6_ARCH, ZAMBA2_ARCH):
        cfg = dataclasses.replace(get_config(arch), dtype="float32", n_layers=1)
        params = model.init_params(cfg, 0, device="cuda", param_dtype=torch.float32)
        lp = model.layer_params(params, 0)
        gen = torch.Generator(device="cuda").manual_seed(26)
        x = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda")
        with torch.no_grad():
            if arch == RWKV6_ARCH:
                x_prev, s0 = model.rwkv_state(cfg, b, "cuda")

                def layer(seq=None):
                    out = model._rwkv_block(cfg, lp, x, x_prev, x_prev, s0, seq=seq)
                    return dict(zip(("out", "x_tm", "x_cm", "s"), out))
            else:
                def layer(seq=None):
                    out, st = model._mamba_block(cfg, lp, x, seq=seq)
                    return {"out": out, **st}

            want = layer()
            got = layer(LocalSeq(n))
            errs = {}
            for key, w in want.items():
                err = float((got[key] - w).abs().max())
                scale = float(w.abs().max())
                errs[key] = err / scale if scale else err
                require(bool(torch.isfinite(got[key]).all()), f"{arch} {key}: non-finite")
                require(err <= SEQ_RECURRENT_TOL * scale,
                        f"{arch} LocalSeq({n}) {key}: max abs err {err:.3e} over "
                        f"{SEQ_RECURRENT_TOL:g} x {scale:.3e}")
            whole_ms = cuda_ms(layer, 2, warmup=1)
            sharded_ms = cuda_ms(lambda: layer(LocalSeq(n)), 2, warmup=1)
        print(f"{arch} one layer, B={b} x {s}, fp32, LocalSeq({n}) vs unsharded: max abs err / "
              f"largest magnitude " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (bound {SEQ_RECURRENT_TOL:g}); whole {whole_ms:.2f} ms, 4 shards with halos and "
              f"fold {sharded_ms:.2f} ms (events)", flush=True)
        del params, lp, x, want, got
        _release()


# ----------------------------------------------------------- dry-run modes

# (g1) rank 0's k and v of decode_32k on 16x16: 32 layers x 8 rows x 32,768 slots x the
# 8 KV heads whole (8 does not divide model 16) x hd 128, bf16
DECODE_CACHE_BYTES = 2 * 32 * 8 * 32_768 * 8 * 128 * 2
LONG_CACHE_BYTES = 2 * 32 * 1 * 8_192 * 8 * 128 * 2          # (g2) B 1, the 8,192-slot window
WIRE_RATIO_BAND = (0.27, 0.30)   # the payload rule: (u8 index + sign bit / 8) / 4 B fp32


def _terms(rec: dict) -> str:
    return (f"roofline terms compute {rec['compute_term_s']:.6f} s, memory "
            f"{rec['memory_term_s']:.6f} s, collectives' wire bytes at NVLink "
            f"{rec['collective_term_s']:.6f} s")


@phase("dry-run modes (g): Llama-3-8B decode_32k and long_500k on JAX's default 16x16, the "
       "federated round and its wire ratio (downlink quant) at train_512 on 2x16x16, rank 0 "
       "under the fake process group")
def dryrun_modes() -> dict:
    """``launch.dryrun`` of the JAX dry run's other modes at full width,
    each cell one ``dryrun.main`` call on JAX's default mesh (no data
    moved: values not held): (g1) decode_32k (B 128) on 16x16, rank 0's 8
    rows, its q heads 2 and the 8 KV heads whole in a 34.4 GB cache, 1
    warm-up + 2 timed steps, peak below 80 GB; (g2) long_500k (B 1 whole,
    an 8,192-slot window through ``long_context_variant``); (g3)
    ``--fl-round --multi-pod`` at train_512: client 0's 1/256 block in
    fp32 and its 2 rows x 512, the uplink on ``pod``; (g4) ``--wire-ratio
    --downlink quant`` at train_512, the ratio inside WIRE_RATIO_BAND.
    Prints each cell's peak, s/step, roofline terms and the fake mesh's
    creation time. Returns each cell's kernel launches (none predicted)."""
    import torch

    from repro_torch.launch import dryrun

    launches = {}

    def run(cell: str, argv: list) -> dict:
        _reset_all_launches()
        rec = dryrun.main(["--arch", SERVE_ARCH, *argv])
        torch.cuda.synchronize()
        launches[cell] = {k: n for k, n in _all_launches().items() if n}
        _release()
        return rec

    for cell, shape, rows, slots, nbytes in (
            ("g1", "decode_32k", 8, 32_768, DECODE_CACHE_BYTES),
            ("g2", "long_500k", 1, 8_192, LONG_CACHE_BYTES)):
        rec = run(f"{cell} {shape} 16x16", ["--shape", shape, "--steps", "2"])
        want = [32, rows, slots, 8, 128]
        require(rec["mesh"] == "16x16" and rec["batch_local"] == rows
                and rec["cache_shapes"]["k"] == want and rec["cache_bytes"] == nbytes + 4 * slots,
                f"({cell}) rank 0's rows {rec['batch_local']}, cache {rec['cache_shapes']} "
                f"{rec['cache_bytes']} B, want k {want}, {nbytes} B of k/v and the slots")
        require(rec["peak_gb"] < 80.0, f"({cell}) peak {rec['peak_gb']:.2f} GB")
        require(rec["collectives_same_each_step"], f"({cell}) the steps' collectives differ")
        print(f"({cell}) dry run {SERVE_ARCH} {shape}, rank 0 of {rec['world']} on 16x16 (data "
              f"x model; mesh made in {rec['mesh_create_s']:.4f} s; fake group: values not "
              f"held): {rec['batch_local']} of {rec['batch']} rows, k/v "
              f"{rec['cache_shapes']['k']} bf16, cache {rec['cache_bytes'] / 1e9:.3f} GB, "
              f"params {rec['param_bytes'] / 1e9:.3f} GB; {rec['s_per_step']:.4f} s/step "
              f"(steps {[f'{t:.4f}' for t in rec['step_seconds']]}) beside memory_term_s "
              f"{rec['memory_term_s']:.6f}; peak {rec['peak_gb']:.2f} GB; {_terms(rec)}; "
              f"collectives a step {_coll_line(rec)}; launches {launches[f'{cell} {shape} 16x16']}",
              flush=True)
    rec = run("g3 fl_round 2x16x16", ["--fl-round", "--multi-pod", "--shape", "train_512",
                                      "--steps", "1"])
    require(rec["mesh"] == "2x16x16" and rec["n_clients"] == 2 and rec["batch_local"] == 2,
            f"(g3) mesh {rec['mesh']}, clients {rec['n_clients']}, rows {rec['batch_local']}")
    require(rec["collectives"].get("pod", {}).get("all-gather", {}).get("count", 0) > 0,
            f"(g3) no uplink on pod: {rec['collectives']}")
    require(rec["peak_gb"] < 80.0 and rec["collectives_same_each_step"],
            f"(g3) peak {rec['peak_gb']:.2f} GB, same collectives "
            f"{rec['collectives_same_each_step']}")
    print(f"(g3) dry run {SERVE_ARCH} --fl-round train_512, rank 0 of {rec['world']} on "
          f"2x16x16 (pod x data x model; mesh made in {rec['mesh_create_s']:.4f} s; fake group): "
          f"client 0's block {rec['param_bytes'] / 1e9:.4f} GB fp32, {rec['batch_local']} rows "
          f"x {rec['seq']}, q {rec['q_bits']}; {rec['s_per_step']:.4f} s a round, peak "
          f"{rec['peak_gb']:.2f} GB; {_terms(rec)}; collectives a round {_coll_line(rec)}; "
          f"launches {launches['g3 fl_round 2x16x16']}", flush=True)
    rec = run("g4 wire_ratio 2x16x16", ["--wire-ratio", "--downlink", "quant", "--shape",
                                        "train_512"])
    lo, hi = WIRE_RATIO_BAND
    require(lo < rec["inter_pod_ratio"] < hi and rec["packed_inter_dense_bytes"] > 0,
            f"(g4) inter-pod ratio {rec['inter_pod_ratio']:.4f} outside {lo}-{hi}")
    print(f"(g4) dry run {SERVE_ARCH} --wire-ratio --downlink quant train_512 on 2x16x16 (mesh "
          f"made in {rec['mesh_create_s']:.4f} s): inter-pod bytes fp32 "
          f"{rec['fp32_inter_bytes']} ({rec['fp32_inter_by_kind']}), packed "
          f"{rec['packed_inter_bytes']} (wire {rec['packed_inter_wire_bytes']}, dense "
          f"{rec['packed_inter_dense_bytes']}), ratio {rec['inter_pod_ratio']:.6f}; a round "
          f"fp32 {rec['fp32_wall_s']:.4f} s, packed {rec['packed_wall_s']:.4f} s; peak "
          f"{rec['peak_gb']:.2f} GB; Z {rec['model_dim_z']}, downlink {rec['downlink_wire_bytes']} "
          f"of {rec['downlink_fp32_bytes']} B ({rec['downlink_ratio']:.6f}); launches "
          f"{launches['g4 wire_ratio 2x16x16']}", flush=True)
    return launches


# ---------------------------------------------------------------- training

TRAIN_REDUCED_ARCHS = (SERVE_ARCH, GRANITE_ARCH, INTERNVL2_ARCH, SEAMLESS_ARCH, RWKV6_ARCH,
                       ZAMBA2_ARCH)
TRAIN_LR = 3e-3
TRAIN_RTOL = 1e-5         # losses and gradient norms, card vs CPU, each step from one state
# train_4k (4,096 positions, global batch 256) with the batch cut to 4: fp32
# masters, grads and two Adam moments (16 B a parameter) and the activations
# of one recomputed layer must fit one 80 GB card
TRAIN_SEQ, TRAIN_BATCH, TRAIN_TIMED = 4096, 4, 3


def _train_batch_like(cfg, shape, seed: int) -> dict:
    """A batch of ``launch.inputs.train_batch_spec``'s shapes and dtypes on
    the card, drawn from ``seed``: random tokens (the labels too, as the
    launcher makes them), an all-ones mask, standard normal embeddings."""
    import torch
    from repro_torch.launch.inputs import train_batch_spec

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for name, spec in train_batch_spec(cfg, shape).items():
        if name == "tokens":
            out[name] = torch.randint(0, cfg.vocab, spec.shape, generator=gen, device="cuda")
        elif name == "mask":
            out[name] = torch.ones(spec.shape, dtype=spec.dtype, device="cuda")
        elif name != "labels":
            out[name] = torch.randn(spec.shape, generator=gen, device="cuda").to(spec.dtype)
    out["labels"] = out["tokens"]
    return out


@phase("train (a): the reduced six families, 3 adamw steps, card vs CPU from one state a step")
def train_reduced_card_vs_cpu():
    """Each reduced family's ``make_train_step`` (adamw, clip 1.0, remat)
    in fp32 on the card and on the CPU, inside ``exact_fp32``: three
    steps, each started on both devices from the CPU's parameters and Adam
    state (a chained run lets Adam's first step turn last-bit gradient
    differences near g = 0 into updates up to 2 lr apart), so every step's
    loss and gradient norm are held to TRAIN_RTOL. No kernel launches."""
    import numpy as np
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_reduced
    from repro_torch.device import exact_fp32
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model
    from repro_torch.optim import adamw

    def to(tree, dev):
        return tree_util.map(lambda t: t.to(dev), tree)

    _reset_all_launches()
    for arch in TRAIN_REDUCED_ARCHS:
        cfg = get_reduced(arch)
        opt = adamw(TRAIN_LR)
        step = make_train_step(cfg, opt)
        params = model.init_params(cfg, 0, device="cpu", param_dtype=torch.float32)
        state = opt.init(params)
        rng = np.random.default_rng(1)
        worst, losses = {"loss": 0.0, "grad_norm": 0.0}, []
        with exact_fp32():
            for _ in range(3):
                toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 64)))
                batch = {"tokens": toks, "labels": toks, "mask": torch.ones((2, 64))}
                if cfg.family == "encdec":
                    batch["src_embeds"] = torch.as_tensor(
                        rng.standard_normal((2, 48, cfg.d_model)), dtype=torch.float32)
                if cfg.family == "vlm":
                    batch["vis_embeds"] = torch.as_tensor(
                        rng.standard_normal((2, cfg.n_vis_tokens, cfg.d_model)),
                        dtype=torch.float32)
                g_params, _, g = step(to(params, "cuda"), to(state, "cuda"), to(batch, "cuda"))
                params, state, c = step(params, state, batch)
                require(all(bool(torch.isfinite(t).all()) for t in tree_util.leaves(g_params)),
                        f"{arch}: non-finite parameters on the card")
                for name in worst:
                    rel = abs(g[name].item() - c[name].item()) / abs(c[name].item())
                    require(rel <= TRAIN_RTOL, f"{arch}: {name} card {g[name].item()} vs CPU "
                                               f"{c[name].item()}, rel {rel:.2e}")
                    worst[name] = max(worst[name], rel)
                losses.append(c["loss"].item())
        print(f"{arch} reduced ({cfg.family}): losses {[f'{x:.5f}' for x in losses]}; card vs "
              f"CPU max rel loss {worst['loss']:.2e}, grad_norm {worst['grad_norm']:.2e} "
              f"(tolerance {TRAIN_RTOL:g})", flush=True)
    launches = _all_launches()
    require(not any(launches.values()), f"the reduced train steps launched kernels: {launches}")


def train_full(arch: str, after=None) -> dict:
    """``make_train_step`` of ``arch`` at full width and depth: fp32 masters
    from seed 0, bf16 activations, adamw(TRAIN_LR), clip 1.0, full remat, on
    one fixed batch of ``train_batch_spec`` at train_4k cut to TRAIN_BATCH;
    one warm-up step, TRAIN_TIMED timed steps (host clock, each ended by a
    sync), then one profiled step. Every launch count is set to 0 just
    before the steps and must still be 0 after: training runs no kernel of
    the port. ``after(cfg, opt, params, state, batch)`` then runs on the
    last state."""
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_config
    from repro_torch.launch import analytic
    from repro_torch.launch.inputs import encdec_tgt_len
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model
    from repro_torch.models.config import InputShape
    from repro_torch.optim import adamw

    cfg = get_config(arch)
    shape = InputShape("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(cfg, 0, param_dtype=torch.float32)
    n_params = sum(t.numel() for t in tree_util.leaves(params))
    want = cfg.param_count() + param_count_correction(cfg)
    require(n_params == want, f"{n_params} parameters, want {want}")
    require(all(t.dtype == torch.float32 for t in tree_util.leaves(params)), "masters not fp32")
    opt = adamw(TRAIN_LR)
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    batch = _train_batch_like(cfg, shape, 0)
    state_gb = torch.cuda.memory_allocated() / 1e9
    _reset_all_launches()
    losses, times = [], []
    for i in range(1 + TRAIN_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        losses.append(metrics["loss"].item())      # a sync
        times.append(time.perf_counter() - t0)
    launches = _all_launches()
    require(not any(launches.values()), f"{arch} training launched kernels: {launches}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    timed = losses[1:]
    require(all(map(math.isfinite, losses)), f"{arch}: non-finite losses {losses}")
    require(timed[-1] < timed[0], f"{arch}: the last timed loss {timed[-1]} is not below the "
                                  f"1st {timed[0]}")
    (_, prof) = _profiled(f"{arch} train step", lambda: step(params, state, batch), top=10,
                          host_ops=False)
    sec = sum(times[1:]) / TRAIN_TIMED
    flops = analytic.train_flops(cfg, shape)
    tgt_only = cfg.family == "encdec"
    if tgt_only:
        tgt = encdec_tgt_len(TRAIN_SEQ)
        tokens, what = TRAIN_BATCH * tgt, (f"{TRAIN_BATCH} x {TRAIN_SEQ} source frames and "
                                           f"{TRAIN_BATCH} x {tgt} target tokens")
    else:
        tokens, what = TRAIN_BATCH * TRAIN_SEQ, f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens"
    numbers = dict(s_per_step=sec, warmup_s=times[0], tokens_per_s=tokens / sec,
                   model_tflops=flops / sec / 1e12, share_of_bf16_peak=flops / sec / BF16_FLOPS,
                   flop_bound_ms=flops / BF16_FLOPS * 1e3, peak_gb=peak, state_gb=state_gb,
                   busy_share=prof.device_ms / prof.wall_ms, launches_per_step=prof.n_launches,
                   losses=losses)
    print(f"{arch} train step ({n_params} fp32 parameters, {what}, adamw({TRAIN_LR}), clip "
          f"1.0, full remat): {sec:.4f} s/step over {TRAIN_TIMED} steps (warm-up step "
          f"{times[0]:.3f} s, steps {[f'{t:.4f}' for t in times[1:]]}), "
          f"{numbers['tokens_per_s']:.1f} {'target ' if tgt_only else ''}tokens/s, model "
          f"{numbers['model_tflops']:.2f} "
          f"TFLOP/s ({flops:.4g} FLOP a step, launch.analytic.train_flops) = "
          f"{numbers['share_of_bf16_peak']:.4f} of 989 TFLOP/s (bound "
          f"{numbers['flop_bound_ms']:.1f} ms); parameters + Adam state {state_gb:.2f} GB, "
          f"peak {peak:.2f} GB allocated; profiled step: busy share "
          f"{numbers['busy_share']:.3f}, {prof.n_launches} launches; losses "
          f"{[f'{x:.4f}' for x in losses]} (first is the warm-up); 0 kernel launches "
          f"of the port", flush=True)
    if after is not None:
        after(cfg, opt, params, state, batch)
    return numbers


@phase("train (c): the four kernel wrappers refuse grad on the card before any launch")
def train_refusals():
    """Each wrapper, called with CUDA inputs that require grad, raises a
    ValueError naming the differentiable route and launches nothing; the
    same call under ``no_grad`` launches its kernel once."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import stochastic_quant as sq

    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn((1, 256, 8, 64), generator=gen, device="cuda").requires_grad_(True)
    k = torch.randn((1, 256, 2, 64), generator=gen, device="cuda")
    x = torch.randn((64, 128), generator=gen, device="cuda").requires_grad_(True)
    rbits = torch.randint(0, 2**31, (64, 128), generator=gen, device="cuda",
                          dtype=torch.int64).to(torch.uint32)
    scale = torch.ones(1, device="cuda").requires_grad_(True)
    idx = torch.randint(0, 16, (3, 64, 128), generator=gen, device="cuda", dtype=torch.uint8)
    signs = torch.randint(0, 2, (3, 64, 128), generator=gen, device="cuda", dtype=torch.uint8)
    weights = torch.full((3,), 1 / 3, device="cuda").requires_grad_(True)
    calls = {
        "flash_attention": (lambda: fa.flash_attention(q, k, k), 'attn_impl="chunked"'),
        "quantize": (lambda: sq.quantize(x, rbits, scale, 4), "core.quantization"),
        "dequantize": (lambda: sq.dequantize(idx[0], signs[0], scale, 4), "core.quantization"),
        "aggregate": (lambda: sq.aggregate(idx, signs, torch.ones(3, device="cuda"), weights, 4),
                      "core.quantization"),
    }
    for name, (call, route) in calls.items():
        _reset_all_launches()
        try:
            call()
        except ValueError as e:
            require("no backward" in str(e) and route in str(e), f"{name}: {e}")
        else:
            raise SmokeFailure(f"{name} accepted inputs that require grad")
        torch.cuda.synchronize()
        require(not any(_all_launches().values()), f"{name} launched before refusing")
        with torch.no_grad():
            call()
        torch.cuda.synchronize()
        require(_all_launches()[name] == 1, f"{name} under no_grad: {_all_launches()}")
    print("flash_attention, quantize, dequantize, aggregate: each refused CUDA inputs that "
          "require grad (ValueError naming the route), 0 launches; each launched once under "
          "no_grad", flush=True)


@phase("train (d): make_fl_round, reduced granite_moe_1b_a400m, K=4, packed wire + screen, "
       "card vs CPU on the same uniforms")
def train_fl_round():
    """One federated round of four clients (their copies of the reduced
    Granite apart, heterogeneous q and weights) on the card and on the CPU
    from the same parameters, batches and uniforms: n_screened identical,
    theta_max within 1e-6 relative, parameters by the one-level rule."""
    import numpy as np
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_reduced
    from repro_torch.device import exact_fp32
    from repro_torch.launch.steps import make_fl_round
    from repro_torch.models import model

    cfg = get_reduced(GRANITE_ARCH)
    k = 4
    params = model.init_params(cfg, 0, device="cpu", param_dtype=torch.float32)
    stacked = tree_util.map(lambda t: torch.stack([(1.0 + 0.01 * i) * t for i in range(k)]),
                            params)
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (k, 2, 64)))
    batch = {"tokens": toks, "labels": toks, "mask": torch.ones((k, 2, 64))}
    gen = torch.Generator().manual_seed(4)
    shapes = [tuple(t.shape[1:]) for t in tree_util.leaves(stacked)]
    ups = [[torch.rand(s, generator=gen) for s in shapes] for _ in range(k)]
    q, w = torch.tensor([3, 8, 5, 6]), torch.tensor([0.1, 0.4, 0.2, 0.3])
    fl_round = make_fl_round(cfg, lr=1e-2, wire_packed=True, screen=True)

    def to(tree):
        return tree_util.map(lambda t: t.to("cuda"), tree)

    _reset_all_launches()
    with exact_fp32():
        t0 = time.perf_counter()
        got = fl_round(to(stacked), to(batch), q.cuda(), w.cuda(),
                       uniforms=[[u.cuda() for u in c] for c in ups])
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        want = fl_round(stacked, batch, q, w, uniforms=ups)
    require(not any(_all_launches().values()),
            f"the FL round launched kernels: {_all_launches()}")
    require(got[3].item() == want[3].item() == 0.0, f"n_screened {got[3].item()} vs "
                                                    f"{want[3].item()}")
    tmax_rel = ((got[2].cpu() - want[2]).abs() / want[2]).max().item()
    require(tmax_rel <= 1e-6, f"theta_max card {got[2].tolist()} vs CPU {want[2].tolist()}")
    level = float((w * want[2] / (2.0 ** q - 1)).max())
    diffs = torch.cat([(a.cpu() - b).abs().reshape(-1)
                       for a, b in zip(tree_util.leaves(got[0]), tree_util.leaves(want[0]))])
    share = (diffs <= 1e-5).double().mean().item()
    require(diffs.max().item() <= level + 1e-5 and share >= 0.99,
            f"FL round params differ by {diffs.max().item():.3e} (one level {level:.3e}), "
            f"{share:.5f} within 1e-5")
    print(f"make_fl_round K={k} (q {q.tolist()}, w {[round(x, 3) for x in w.tolist()]}), "
          "packed wire, screen: "
          f"{sec:.3f} s on the card; loss card {got[1].item():.6f} vs CPU {want[1].item():.6f}; "
          f"theta_max max rel {tmax_rel:.2e}; params max abs {diffs.max().item():.3e} (one "
          f"level {level:.3e}), {share:.5f} within 1e-5; n_screened 0 on both", flush=True)


# ------------------------------------------------ (h) the all-to-all expert dispatch

A2A_MODEL = (4, 16)           # (h1): the model ranks LocalExchange emulates
A2A_B, A2A_S = 4, 4096        # (h1): eight 512-token routing groups, C = 160
MOE_BF16_REL = 2.0**-6        # of the largest magnitude: a bf16 MoE layer against its reference
                              # (tests/test_torch_moe.py's bf16 bound)
A2A_MESH = "1x4x2x16"         # (h2): benchmarks/dryrun_sweep.py's A2A_GATED mesh
A2A_TRAFFIC_MESH = "2x8x2x16"     # (h3): benchmarks/run.py bench_moe_alltoall's mesh


def _a2a_formula(cfg, rows: int, s_loc: int, m: int, passes: int) -> tuple[int, int]:
    """The all-to-alls a step on rank 0 and their result bytes: ``passes``
    a routing group of a layer (2 forward; a train step with full remat 6:
    forward, recompute, backward), each of rows x E x (C / m) x D bf16
    elements. ``s_loc``: the positions of the groups the rank routes (its
    shard where it holds whole groups; a group's length where one spans
    the shards)."""
    from repro_torch.models import moe

    g = moe.group_length(s_loc)
    groups, c = s_loc // g, moe.group_capacity(g, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    n = passes * cfg.n_layers * groups
    return n, n * rows * cfg.n_experts * (c // m) * cfg.d_model * 2


def _a2a_line(rec: dict) -> str:
    """A dry-run record's all-to-alls a step by axis: count and bytes."""
    return ", ".join(f"{axis} {kinds['all-to-all']['count']} / {kinds['all-to-all']['bytes']} B"
                     for axis, kinds in sorted(rec["collectives"].items())
                     if "all-to-all" in kinds) or "none"


def _expert_calls(fn):
    """``fn()`` and the input and output of each ``moe._experts`` call it
    makes (a routing group of one rank), in order."""
    from repro_torch.models import moe

    calls, experts = [], moe._experts

    def spy(params, xe):
        y = experts(params, xe)
        calls.append((xe, y))
        return y

    moe._experts = spy
    try:
        return fn(), calls
    finally:
        moe._experts = experts


@phase("all-to-all EP (h1): one full-width Granite-3.0 1B-A400M MoE layer, bf16, B=4 x 4096, "
       "through LocalExchange(4) and LocalExchange(16) against the all-reduce route and the "
       "unsharded layer")
def a2a_layer() -> None:
    """``moe.moe_apply`` of one Granite layer (d_model 1,024, 32 experts
    top-8, d_ff 512; random bf16 weights and input from seed 0) by the
    all-to-all route over m emulated model ranks (``moe.LocalExchange``):
    every routing group's dispatched (B, E/m, C, D) tensor and expert
    outputs bit-equal, rank by rank, to the all-reduce route's (each rank's
    experts, ``moe.ExpertSlots``); its output within MOE_BF16_REL of the
    largest magnitude of the unsharded layer's, its aux values equal. Times
    (CUDA events) the unsharded layer and both routes' m ranks run in turn
    on the one card; no kernel of the port runs (the MoE is torch)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config(GRANITE_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = moe.moe_params(gen, cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.n_layers,
                            torch.bfloat16)
    x = torch.randn(A2A_B, A2A_S, cfg.d_model, generator=gen, device="cuda").to(torch.bfloat16)
    kw = dict(top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)
    groups = A2A_S // moe.group_length(A2A_S)
    c = moe.group_capacity(moe.group_length(A2A_S), cfg.top_k, cfg.n_experts,
                           cfg.capacity_factor)
    _reset_all_launches()
    with torch.no_grad():
        want, want_aux = moe.moe_apply(params, x, **kw)
        scale = want.float().abs().max().item()
        whole_ms = cuda_ms(lambda: moe.moe_apply(params, x, **kw), iters=3, warmup=1)
        for m in A2A_MODEL:
            e_loc = cfg.n_experts // m
            blocks = [(moe.expert_block(params, m, r),
                       moe.ExpertSlots(r * e_loc, (r + 1) * e_loc)) for r in range(m)]
            (out, aux), calls = _expert_calls(
                lambda: moe.moe_apply(params, x, route=moe.LocalExchange(m), **kw))
            parts, rank_calls = [], []
            for p, slots in blocks:
                (part, _aux), t = _expert_calls(lambda: moe.moe_apply(p, x, route=slots, **kw))
                parts.append(part)
                rank_calls.append(t)
            require(len(calls) == groups * m and all(len(t) == groups for t in rank_calls),
                    f"m={m}: {len(calls)} expert calls, want {groups} routing groups x {m}")
            for g in range(groups):
                for r in range(m):
                    (xe, y), (ref_xe, ref_y) = calls[g * m + r], rank_calls[r][g]
                    require(tuple(xe.shape) == (A2A_B, e_loc, c, cfg.d_model)
                            and torch.equal(xe, ref_xe) and torch.equal(y, ref_y),
                            f"m={m}, group {g}, rank {r}: the all-to-all route's dispatch or "
                            "expert outputs differ from the all-reduce route's")
            reduced = parts[0]
            for part in parts[1:]:
                reduced = reduced + part
            err = (out.float() - want.float()).abs().max().item()
            err_ar = (reduced.float() - want.float()).abs().max().item()
            require(err <= MOE_BF16_REL * scale and err_ar <= MOE_BF16_REL * scale,
                    f"m={m}: output max abs err {err:.3e} (all-reduce route {err_ar:.3e}) "
                    f"above 2^-6 x {scale:.3f}")
            require(all(torch.equal(aux[k], want_aux[k]) for k in want_aux),
                    f"m={m}: aux {aux} vs {want_aux}")
            del calls, rank_calls, parts
            a2a_ms = cuda_ms(lambda: moe.moe_apply(params, x, route=moe.LocalExchange(m), **kw),
                             iters=3, warmup=1)
            ar_ms = cuda_ms(lambda: [moe.moe_apply(p, x, route=r, **kw) for p, r in blocks],
                            iters=3, warmup=1)
            print(f"(h1) LocalExchange({m}): {groups} "
                  f"groups x {m} ranks' dispatch (B={A2A_B}, E/m={e_loc}, C={c}, "
                  f"D={cfg.d_model}) and expert outputs bit-equal to the "
                  f"all-reduce route's; output max abs err {err:.3e} (all-reduce route "
                  f"{err_ar:.3e}) of the unsharded layer's, largest magnitude {scale:.3f}; aux "
                  f"equal; the {m} ranks in turn on one card: all-to-all route {a2a_ms:.2f} "
                  f"ms, all-reduce route {ar_ms:.2f} ms, the unsharded layer {whole_ms:.2f} ms "
                  "(CUDA events, 3 calls)", flush=True)
    launches = _all_launches()
    require(not any(launches.values()), f"the MoE layer launched kernels: {launches}")
    _release()


MOE_SEQ_SHAPES = ((64, 512, 2), (4, 4096, 16))    # (h4): (B, S, seq shards LocalSeq emulates)
MOE_SEQ_AUX_RTOL = 1e-4      # (h4): fp32 sums of up to 32,768 tokens' values in another order


def _slot_calls(fn):
    """``fn()`` and each ``moe._slots`` call's router logits, queue
    positions and keep (a routing group, or a shard's piece of one), in
    order."""
    from repro_torch.models import moe

    slots, calls = moe._slots, []

    def spy(rt, *args, **kw):
        out = slots(rt, *args, **kw)
        calls.append((rt.logits, out[0], out[1]))
        return out

    moe._slots = spy
    try:
        return fn(), calls
    finally:
        moe._slots = slots


@phase("routing groups across seq shards (h4): one full-width Granite-3.0 1B-A400M MoE layer, "
       "bf16, B=64 x 512 through LocalSeq(2) and B=4 x 4096 through LocalSeq(16), against the "
       "unsharded layer")
def moe_seq_layer() -> None:
    """``moe.moe_apply`` of one Granite layer (d_model 1,024, 32 experts
    top-8, d_ff 512; random bf16 weights and inputs from seed 0) as n
    sequence shards in one process (``dist.seq.LocalSeq``) whose routing
    groups cross the shards' edges: one 512-token group over 2 shards of
    256 (train_512's group on ``seq`` 2) and eight over 16 shards (each
    group over two). Each group's pieces, put together in shard order:
    router logits, queue positions and keep identical to the unsharded
    layer's; each group's dispatched (B, E, C, D) tensor bit-equal; the
    output within MOE_BF16_REL of the unsharded output's largest
    magnitude, the aux values within MOE_SEQ_AUX_RTOL. Times (CUDA events)
    the unsharded layer and the n shards in turn on the one card; no kernel
    of the port runs (the MoE is torch)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist.seq import LocalSeq
    from repro_torch.models import moe

    cfg = get_config(GRANITE_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = moe.moe_params(gen, cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.n_layers,
                            torch.bfloat16)
    kw = dict(top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)
    _reset_all_launches()
    with torch.no_grad():
        for b, s, n in MOE_SEQ_SHAPES:
            x = torch.randn(b, s, cfg.d_model, generator=gen, device="cuda").to(torch.bfloat16)
            g = moe.group_length(s)
            c = moe.group_capacity(g, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
            ((want, want_aux), w_xes), w_slots = _slot_calls(
                lambda: _expert_calls(lambda: moe.moe_apply(params, x, **kw)))
            ((out, aux), xes), p_slots = _slot_calls(lambda: _expert_calls(
                lambda: moe.moe_apply(params, x, seq=LocalSeq(n), **kw)))
            pieces: dict = {}
            calls = iter(p_slots)
            for r in range(n):
                for j, _sl, _a in moe.group_pieces(r, s // n, g):
                    pieces.setdefault(j, []).append(next(calls))
            groups = [[torch.cat([p[i] for p in pieces[j]], dim=1) for i in range(3)]
                      for j in sorted(pieces)]
            require(len(groups) == len(w_slots) == s // g and len(xes) == len(w_xes) == s // g,
                    f"(h4) {b}x{s} on {n}: {len(groups)} groups, {len(xes)} expert calls")
            n_logits = sum(int((got[0] != ref[0]).sum()) for got, ref in zip(groups, w_slots))
            require(n_logits == 0, f"(h4) {b}x{s} on {n}: {n_logits} router logits differ from "
                    "the unsharded layer's")
            require(all(torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
                        for got, ref in zip(groups, w_slots)),
                    f"(h4) {b}x{s} on {n}: queue positions or keep differ")
            require(all(tuple(xe.shape) == (b, cfg.n_experts, c, cfg.d_model)
                        and torch.equal(xe, ref) for (xe, _), (ref, _) in zip(xes, w_xes)),
                    f"(h4) {b}x{s} on {n}: a group's dispatched tensor differs")
            kept = float(torch.cat([ref[2].flatten() for ref in w_slots]).mean())
            scale = want.float().abs().max().item()
            err = (out.float() - want.float()).abs().max().item()
            require(err <= MOE_BF16_REL * scale, f"(h4) {b}x{s} on {n}: output max abs err "
                    f"{err:.3e} above 2^-6 x {scale:.3f}")
            aux_rel = {k: abs(aux[k].item() - v.item()) / max(abs(v.item()), 1e-30)
                       for k, v in want_aux.items() if v.item()}
            require(all(r <= MOE_SEQ_AUX_RTOL for r in aux_rel.values())
                    and (aux["dropped_frac"].item() == 0) == (want_aux["dropped_frac"].item() == 0),
                    f"(h4) {b}x{s} on {n}: aux {aux} vs {want_aux}")
            del w_slots, w_xes, p_slots, xes, pieces, groups
            whole_ms = cuda_ms(lambda: moe.moe_apply(params, x, **kw), iters=3, warmup=1)
            seq_ms = cuda_ms(lambda: moe.moe_apply(params, x, seq=LocalSeq(n), **kw), iters=3,
                             warmup=1)
            print(f"(h4) LocalSeq({n}), B={b} x S={s}: {s // g} routing group(s) of {g}, C={c}, "
                  f"{s // n} positions a shard: router logits, queue positions and keep "
                  f"identical to the unsharded layer's ({kept:.6f} of the slots kept), each "
                  f"group's dispatched (B, E, C, D) tensor bit-equal; output max abs err "
                  f"{err:.3e} of the unsharded layer's, largest magnitude {scale:.3f}; aux "
                  f"relative differences {aux_rel}; the {n} shards in turn on one card "
                  f"{seq_ms:.2f} ms, the unsharded layer {whole_ms:.2f} ms (CUDA events, 3 "
                  "calls)", flush=True)
            del x, want, out
            _release()
    launches = _all_launches()
    require(not any(launches.values()), f"the MoE layer launched kernels: {launches}")


@phase("all-to-all EP (h2): dryrun_sweep's A2A_GATED cells, full Granite-3.0 1B-A400M "
       "train_4k and prefill_32k at their own batches as rank 0 of 1x4x2x16 under the fake "
       "group, --require-alltoall")
def a2a_gated_dryruns() -> dict:
    """``launch.dryrun`` of the two cells ``benchmarks/dryrun_sweep.py``
    gates on ``--require-alltoall``, at full width and depth and the
    shapes' own batches, rank 0 of ``1x4x2x16`` (pod x data x seq x model;
    32 experts, 2 a rank; fake group: no data moved, values not held):
    train_4k (rank 0's 64 of 256 rows, 2,048 positions) and prefill_32k
    (8 of 32 rows, 16,384 positions; the ring over ``seq`` through the
    wgmma kernel). The gate holds; the all-to-alls sit on ``model`` only,
    their count and bytes equal to :func:`_a2a_formula`; peak below 80 GB.
    Returns the prefill's wgmma launches, all at A2A_RING's shape."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    cfg = get_config(GRANITE_ARCH)
    out = {}
    for shape, passes in (("train_4k", 6), ("prefill_32k", 2)):
        _reset_all_launches()
        rec = dryrun.main(["--arch", GRANITE_ARCH, "--shape", shape, "--mesh-shape", A2A_MESH,
                           "--steps", "1", "--require-alltoall"])
        torch.cuda.synchronize()
        launches = {k: n for k, n in _all_launches().items() if n}
        n, nbytes = _a2a_formula(cfg, rec["batch_local"], rec["seq"] // 2, 16, passes)
        got = rec["collectives"].get("model", {}).get("all-to-all")
        require(rec["alltoall_count"] == n and got == {"count": n, "bytes": nbytes},
                f"(h2) {shape}: all-to-alls {_a2a_line(rec)}, gate count "
                f"{rec['alltoall_count']}; the formula {n} / {nbytes} B on model")
        require(rec["peak_gb"] < 80.0 and rec["collectives_same_each_step"],
                f"(h2) {shape}: peak {rec['peak_gb']:.2f} GB, same collectives "
                f"{rec['collectives_same_each_step']}")
        if shape == "prefill_32k":     # warm-up, the gates' step, 1 timed: rank 0's diagonal
            require((rec["batch_local"], rec["seq"] // 2) == A2A_RING[2],
                    f"(h2) prefill: rank 0's {rec['batch_local']} rows x {rec['seq'] // 2} "
                    f"positions, not A2A_RING's {A2A_RING[2]}")
            require(launches.get("flash_attention_wgmma") == 3 * cfg.n_layers
                    and not launches.get("flash_attention_simt"),
                    f"(h2) prefill launches {launches}, want {3 * cfg.n_layers} wgmma")
            out[f"dry-run a2a {GRANITE_ARCH} prefill_32k {A2A_MESH}"] = \
                launches["flash_attention_wgmma"]
        else:
            require(not launches, f"(h2) the train step launched kernels: {launches}")
        print(f"(h2) dry run {GRANITE_ARCH} {shape} (its own global batch {rec['batch']}), "
              f"rank 0 of {rec['world']} on "
              f"{A2A_MESH} (mesh made in {rec['mesh_create_s']:.4f} s; fake group: values not "
              f"held), {rec['batch_local']} rows x {rec['seq'] // 2} positions a rank, "
              f"--require-alltoall: alltoall_count {rec['alltoall_count']}; "
              f"{_log_on_off(rec)} s/step, peak {rec['peak_gb']:.2f} GB"
              + (f", forward/backward peak {rec['fwd_bwd_peak_gb']:.2f} GB"
                 if rec.get("fwd_bwd_peak_gb") is not None else "")
              + f"; all-to-alls a step by axis {_a2a_line(rec)} (formula: {n} / {nbytes} B on "
              f"model, {passes} a 512-token group of a layer); all collectives "
              f"{_coll_line(rec)}; {_terms(rec)}; launches {launches}", flush=True)
        _release()
    return out


A2A_GROUP_SUMS = 3            # (h3): a layer's group sums over seq: forward, recompute, backward


@phase("all-to-all EP (h3): bench_moe_alltoall's cell, Granite-3.0 1B-A400M train_512 as "
       "rank 0 of 2x8x2x16, one routing group across the two seq shards: the all-to-all "
       "bytes by axis, the seq traffic by kind, the seq gate's report")
def a2a_traffic() -> None:
    """``launch.dryrun`` of Granite's train step at train_512's own shape
    (global batch 64: rank 0's 4 rows; 512 positions: one routing group
    across the two ``seq`` shards, 256 positions a rank) on
    ``benchmarks/run.py`` ``bench_moe_alltoall``'s mesh (pod x data x seq x
    model; fake group). Every all-to-all byte rides ``model``: none on
    ``pod`` or ``data`` (JAX's bench asserts under 1 % inter-pod); the
    count and bytes :func:`_a2a_formula`'s for the group. The group's
    dispatch is summed over ``seq``: A2A_GROUP_SUMS all-reduces a layer of
    the rank's (1, 1, B, E, C/m, D) bf16 capacity block, counted apart from
    the rest of the ``seq`` traffic, printed by kind. Then the same step
    with ``--require-seq-sharded``: its verdict and offenders printed."""
    from repro_torch.configs import get_config
    from repro_torch.dist.collectives import CollectiveCounter
    from repro_torch.launch import dryrun
    from repro_torch.models import moe

    cfg = get_config(GRANITE_ARCH)
    argv = ["--arch", GRANITE_ARCH, "--shape", "train_512", "--mesh-shape", A2A_TRAFFIC_MESH,
            "--steps", "1"]
    with CollectiveCounter() as every:
        rec = dryrun.main([*argv, "--require-alltoall"])
    steps = 3                          # the warm-up, the gates' step and the timed one
    s = rec["seq"]
    g = moe.group_length(s)
    c = moe.group_capacity(g, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    n, nbytes = _a2a_formula(cfg, rec["batch_local"], g, 16, 6)
    off_model = {axis: kinds["all-to-all"]["bytes"] for axis, kinds in rec["collectives"].items()
                 if axis != "model" and "all-to-all" in kinds}
    require(s == 512 and (s // 2) % g, f"(h3) {s} positions: no routing group across the shards")
    require(not off_model, f"(h3) all-to-all bytes off model: {off_model}")
    require(rec["collectives"]["model"]["all-to-all"] == {"count": n, "bytes": nbytes},
            f"(h3) all-to-alls {_a2a_line(rec)}, the formula {n} / {nbytes} B")
    block = (s // g) * rec["batch_local"] * cfg.n_experts * (c // 16) * cfg.d_model * 2
    sums = [r for r in every.log if (r.kind, r.axis, r.bytes) == ("all-reduce", "seq", block)]
    require(len(sums) == steps * A2A_GROUP_SUMS * cfg.n_layers and rec["collectives_same_each_step"],
            f"(h3) {len(sums)} seq all-reduces of {block} B in {steps} steps, want "
            f"{A2A_GROUP_SUMS} a layer each")
    seq = rec["collectives"].get("seq", {})
    pod = sum(v["bytes"] for v in rec["collectives"].get("pod", {}).values())
    print(f"(h3) dry run {GRANITE_ARCH} train_512 at its own {s} positions (global batch "
          f"{rec['batch']}), rank 0 of {rec['world']} on {A2A_TRAFFIC_MESH}, {s // 2} "
          f"positions a rank, one routing group of {g} across the two seq shards (C={c}): "
          f"all-to-all bytes a step pod 0, data 0, seq 0, model {nbytes} ({n} all-to-alls, "
          f"the formula's); the group sums a step {len(sums) // steps} all-reduces on seq of "
          f"{block} B ({len(sums) // steps * block} B); all seq traffic a step by kind "
          + ", ".join(f"{k} {v['count']} / {v['bytes']} B" for k, v in sorted(seq.items()))
          + f"; all pod bytes {pod}; {rec['s_per_step']:.4f} s/step, peak "
          f"{rec['peak_gb']:.2f} GB; all collectives {_coll_line(rec)}", flush=True)
    _release()
    try:
        dryrun.main([*argv, "--require-seq-sharded"])
        print(f"(h3) {GRANITE_ARCH} train_512 on {A2A_TRAFFIC_MESH} --require-seq-sharded: "
              "holds", flush=True)
    except AssertionError as e:
        shapes: dict = {}
        for o in e.offenders:          # count and ops of each shape
            n_ops = shapes.setdefault(o["shape"], [0, set()])
            n_ops[0] += 1
            n_ops[1].add(o["op"])
        print(f"(h3) {GRANITE_ARCH} train_512 on {A2A_TRAFFIC_MESH} --require-seq-sharded: "
              f"fails, {len(e.offenders)} offenders (512 positions: the full length, and "
              "Granite's d_ff) by shape, count and ops "
              + "; ".join(f"{k} {n} {sorted(ops)}" for k, (n, ops) in shapes.items()),
              flush=True)
    _release()


def main() -> int:
    import torch

    card = environment()
    sys.path.insert(0, str(SRC))
    build_kernels()
    zpad = 1984 * 128              # FEMNIST Z = 246,590 in 64-row tiles
    wire_m = 2048                  # FEMNIST Z in 256-row tiles of 128 lanes
    report = kernels_vs_plain(zpad, wire_m)
    report.update(kkt_vs_plain(report["quantize"]["empty_ms"]))
    moe_rows, moe_layer = moe_grouped_vs_plain()
    report.update(moe_rows)
    report.update(flash_vs_plain())
    local_heads(report)
    seq_ring_kernels(report)
    flash_offsets(report)
    ring_launches = ring_32k(report)
    sim, main_launches = main_path()
    policy_runs = policies(sim)
    telemetry(sim)
    scenarios(sim)
    numeric_scope(sim)
    scenario_references()
    small_reference()
    replay_reference()
    profile_round(sim)
    wire_launches = wire_entry(sim)
    nccl_launches = nccl_world_of_one(sim)
    del sim                        # its 5.33 GB fleet tensor, before the 8B model
    gc.collect()
    torch.cuda.empty_cache()
    object_runtime()
    cfg, params, ctx, llama_launches, _serve = serve_path()
    two_layer_prefill(cfg, params, ctx)
    phase("profile of one serve prefill and 4 decode steps")(profile_serve)(
        SERVE_ARCH, cfg, params, ctx)
    serve32_launches = serve_32k(cfg, params)
    tp_serve_launches = tp_serve_world_of_one(cfg, params)
    del params
    _release()
    # each serve path's launches, its counts set to 0 just before it
    serve_launches = {SERVE_ARCH: llama_launches}
    for arch, run in ((GRANITE_ARCH, serve_granite), (SEAMLESS_ARCH, serve_seamless),
                      (INTERNVL2_ARCH, serve_internvl2)):
        serve_launches[arch], _numbers = run()
        _release()
    for arch, what in RECURRENT_PHASES.items():
        serve_launches[arch], _numbers = phase(
            f"serve path: {what}, B=4, context 4096, 32 new tokens")(serve_recurrent)(arch)
        _release()
    fp32_launches = {
        arch: phase(f"small-input reference: reduced {arch}, flash, fp32, {what}, card vs "
                    "CPU")(serve_small_reference)(arch)
        for arch, what in SMALL_REFERENCES}
    train_reduced_card_vs_cpu()
    for arch in (GRANITE_ARCH, SEAMLESS_ARCH):
        phase(f"train (b): {arch} full width and depth, train_4k cut to batch {TRAIN_BATCH}, "
              f"1 warm-up + {TRAIN_TIMED} timed steps")(train_full)(
            arch, after=tp_train_world_of_one if arch == GRANITE_ARCH else None)
        _release()
    train_refusals()
    train_fl_round()
    dry_launches = tp_dryrun()
    tp_families_world_of_one()
    dry_launches.update(tp_family_prefills())
    tp_zamba2_train()
    dry_launches.update(tp_gates())
    seq_train_gates()
    seq_launches = seq_family_prefills()
    seq_launches.update(seq_seamless_prefill())
    seq_seamless_train()
    seq_local_fold()
    mode_launches = dryrun_modes()
    a2a_layer()
    a2a_launches = a2a_gated_dryruns()            # Granite's seq ring at B 8 x 16,384
    a2a_traffic()
    moe_seq_layer()

    wgmma_rows = ("flash_attention_wgmma", "flash_attention_wgmma_ring_heads_on_model",
                  *(f"flash_attention_wgmma_local_heads_h{h}_kv{kv}"
                    for h, kv, *_ in LOCAL_HEADS),
                  *(name for name, *_ in SEQ_RINGS), A2A_RING[0])
    sources = {**{n: "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu" for n in wgmma_rows},
               "flash_attention_simt": "src/repro_torch/kernels/csrc/flash_attention.cu",
               **{n: "src/repro_torch/kernels/csrc/qccf_kkt.cu" for n, _ in KKT_SHAPES},
               **{n: "src/repro_torch/kernels/csrc/moe_grouped.cu" for n in moe_layer}}
    replaces = {
        "aggregate": "src/repro/kernels/stochastic_quant.py:172",
        "quantize": "src/repro/kernels/stochastic_quant.py:49",
        "dequantize": "src/repro/kernels/stochastic_quant.py:97",
        **{n: "src/repro/kernels/flash_attention.py:183" for n in wgmma_rows},
        "flash_attention_simt": "src/repro/kernels/flash_attention.py:183",
        # no Pallas kernel: the JAX package's solve_kkt is jnp that XLA fuses
        **{n: "none (src/repro/sim/policy.py solve_kkt, jnp)" for n, _ in KKT_SHAPES},
        # no Pallas kernel: the JAX package's MoE is the capacity route's einsums
        **{n: "none (src/repro/models/moe.py, the capacity route's einsums)"
           for n in moe_layer},
    }
    # each kernel's launches in the runs of the paths that take it: the
    # FEMNIST rounds (unsharded, and sharded in the NCCL world of one), the
    # wire entry point, the bf16 serve prefills (wgmma; RWKV6's has none),
    # the 32k rings and the 32k prefill, the ring through NCCL, the fp32
    # prefills of the small-input references (simt); rows with paths sum
    # them and list each
    by_path = {"aggregate": {"femnist greedy": main_launches["aggregate"],
                             "femnist greedy, client-sharded (nccl, 1 rank)":
                                 nccl_launches["aggregate"]},
               "flash_attention_wgmma": {**{a: n["flash_attention_wgmma"]
                                            for a, n in serve_launches.items()},
                                         **ring_launches, **serve32_launches,
                                         "GroupRing n=1 (nccl)": nccl_launches["ring"],
                                         "placed serve, 1x1 (nccl)": tp_serve_launches,
                                         **dry_launches, **seq_launches, **a2a_launches},
               "flash_attention_simt": fp32_launches,
               "qccf_kkt": {"femnist greedy": main_launches["kkt"]},
               "qccf_kkt_population": {f"femnist {mode}": policy_runs[mode]["kkt"]
                                       for mode in ("compiled-ga", "same_size")},
               **{name: {"granite-4.0-h-small MoE layer, forward and backward": n}
                  for name, n in moe_layer.items()}}
    # the model-parallel rows: the launches of the paths that take each shape
    by_path.update({
        "flash_attention_wgmma_ring_heads_on_model": {
            k: n for k, n in ring_launches.items() if "heads on model" in k},
        **{f"flash_attention_wgmma_local_heads_h{h}_kv{kv}": {
            k: n for k, n in dry_launches.items() if f"(H={h}/{kv})" in k}
           for h, kv, *_ in LOCAL_HEADS},
        **{name: {k: n for k, n in seq_launches.items() if arch in k}
           for name, arch, *_ in SEQ_RINGS},
        A2A_RING[0]: a2a_launches})
    # any kernel launched by a dry-run mode cell (none is predicted: decode attention and
    # the round's quantizer are plain torch)
    for cell, found in mode_launches.items():
        for name in set(found) & set(by_path):
            by_path[name][f"dry-run mode {cell}"] = found[name]
    launches = {name: wire_launches[name] + sum(f.get(name, 0) for f in mode_launches.values())
                for name in ("quantize", "dequantize")}
    launches.update({k: sum(v.values()) for k, v in by_path.items()})
    for name, paths in by_path.items():
        report[name]["launches_by_path"] = paths
    kernels = [
        {"name": name, "route": "cuda",
         "source": sources.get(name, "src/repro_torch/kernels/csrc/stochastic_quant.cu"),
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r.get("library_ms"),
         **{k: r[k] for k in ("launches_by_path", "shapes") if k in r}}
        for name, r in report.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
