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
     beside an empty kernel's device time (the launch floor).
     Flash attention is checked in bf16 (the wgmma kernel) and fp32 (the
     SIMT kernel, cp.async loads) at Llama-3-8B's serve shape, StarCoder2-7B's
     heads (g = 9) with its 4096 window at S = 8192, and a non-causal ragged
     shape; at each, bf16 inputs that TMA cannot describe (one element off
     alignment) time the SIMT kernel's register-staged loads beside it;
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
     round-trip error against scale / (2^q - 1);
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
     SIMT flash kernel);
  9. one JSON line with each kernel's launches, error and times.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the repository's sources beside this file, it exits non-zero
before printing any result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
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
SCOPES = ("kkt_solve", "evaluate_population", "fleet_local_sgd", "cuda_aggregate",
          "cuda_quantize", "cuda_dequantize", "cuda_flash_attention") + FL_SCOPES


def _is_device(e) -> bool:
    """A kernel on the card (the profiler also lists the record_function
    scopes as device-side annotations; those are ranges, not kernels)."""
    return (str(getattr(e, "device_type", "")).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False) and e.key not in SCOPES)


def kernel_ms(fn, kernel: str, iters: int = 200) -> float:
    """Mean device milliseconds of the CUDA kernel whose name contains
    ``kernel``, from a torch.profiler trace of ``iters`` calls of ``fn``
    (the kernel's own duration, free of the host's launch overhead). Fails
    when the trace holds no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if _is_device(e) and kernel in e.key]
    count = sum(e.count for e in hits)
    require(count > 0, f"the profiler trace holds no device kernel named {kernel!r}")
    return sum(e.self_device_time_total for e in hits) / count / 1e3


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
        out[mode] = dict(s_per_round=sec, scheduled=res.n_scheduled.tolist(),
                         aggregate_per_round=launches["aggregate"] / POLICY_ROUNDS)
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
]


def visible_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """(q, k) pairs the mask admits: the work these inputs need."""
    import numpy as np

    q = np.arange(s, dtype=np.int64)
    hi = np.minimum(q, t - 1) if causal else np.full(s, t - 1, dtype=np.int64)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(s, dtype=np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


# the flash kernel each dtype's route launches (names matched by substring)
FLASH_KERNELS = {"bfloat16": ("wgmma", "flash_fwd_wgmma_kernel"),
                 "float32": ("simt", "flash_fwd_kernel")}


def _sdpa(q, k, v, causal: bool, window: int):
    """``scaled_dot_product_attention`` on (B, L, heads, hd) tensors: the
    same function as the flash kernels (a window as a boolean mask). The
    library yardstick, timed here only; the port never calls it."""
    import torch

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = None
    if window:
        qpos = torch.arange(q.shape[1], device=q.device)[:, None]
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = kpos > qpos - window
        if causal:
            mask = mask & (kpos <= qpos)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and not window, enable_gqa=True)


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
            lib_ms = None
            if dtype == torch.bfloat16:
                lib_ms = cuda_ms(_sdpa(q, k, v, causal, window), 20)
            elif name == "llama3_8b serve":
                lib_ms = cuda_ms(_sdpa(q, k, v, causal, window), 3, warmup=1)
            variant = f", {fa._load_variant(q, k, v)} loads" if route == "simt" else ""
            print(f"flash {name} B={b} S={s} T={t} H={h}/{kv} hd={hd} causal={causal} "
                  f"window={window} {str(dtype)[6:]} ({route}{variant}): max_abs_err={err:.3e} "
                  f"(tol rtol {FLASH_TOL[str(dtype)[6:]][0]:g} atol "
                  f"{FLASH_TOL[str(dtype)[6:]][1]:g}), lse err {lse_err:.3e}; "
                  f"kernel {k_ms:.3f} ms (profiler), bound {b_ms:.3f} ms ({b_by}), "
                  f"plain {p_ms:.3f} ms (events), scaled_dot_product_attention "
                  f"{'-' if lib_ms is None else f'{lib_ms:.3f} ms'} (events)", flush=True)
            if name == "llama3_8b serve":
                report[f"flash_attention_{route}"] = dict(
                    max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib_ms)
            if dtype == torch.bfloat16:
                # the SIMT kernel's operations are fp32 FMAs: its bound is at the fp32 rate
                simt_bound, _ = bound((q.numel() + k.numel() + v.numel() + out.numel()) * esz,
                                      4.0 * b * h * hd * pairs, FP32_FLOPS)
                _simt_bf16_beside(q, k, v, kw, want, want_lse, simt_bound, lib_ms)
            del q, k, v, out, lse, want, want_lse
        del base
    torch.cuda.empty_cache()
    return report


def _flash_errors(label, out, lse, want, want_lse) -> tuple[float, float]:
    """Require a flash result within FLASH_TOL of the plain version and its
    lse within 2e-5; return both max abs errors."""
    rtol, atol = FLASH_TOL[str(out.dtype)[6:]]
    err = (out.float() - want.float()).abs()
    require(bool((err <= atol + rtol * want.float().abs()).all()),
            f"{label}: max abs err {err.max().item():.3e} over rtol {rtol:g} atol {atol:g}")
    lse_err = (lse - want_lse).abs()
    require(bool((lse_err <= 2e-5 + 2e-5 * want_lse.abs()).all()),
            f"{label}: lse max abs err {lse_err.max().item():.3e}")
    return err.max().item(), lse_err.max().item()


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
    from repro_torch.kernels import stochastic_quant as sq

    sq.reset_launches()
    fa.reset_launches()


def _all_launches() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import stochastic_quant as sq

    return {**sq.launches, **fa.launches}


@phase("serve path: llama3_8b full width and depth, flash prefill, B=4, context 4096, "
       "32 new tokens")
def serve_path():
    import numpy as np
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model

    cfg = dataclasses.replace(get_config(SERVE_ARCH), attn_impl="flash")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(cfg, 0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_util.leaves(params))
    print(f"init_params: {n_params} parameters, matrices in {cfg.dtype}, "
          f"{time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          "allocated on the card")
    # the analytic count leaves out the final norm's d_model scales
    require(n_params == cfg.param_count() + cfg.d_model,
            f"{n_params} parameters, want {cfg.param_count()} + {cfg.d_model}")
    ctx = np.random.default_rng(0).integers(0, cfg.vocab, (SERVE_BATCH, SERVE_CONTEXT))
    warm = serve.generate(cfg, params, ctx, 1)   # allocator, cuBLAS handles
    print(f"warm-up generate (1 new token): prefill {warm.prefill_seconds:.3f} s")
    _reset_all_launches()
    gen = serve.generate(cfg, params, ctx, SERVE_NEW)
    launches = _all_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    require(launches["flash_attention_wgmma"] == cfg.n_layers
            and launches["flash_attention_simt"] == 0,
            f"flash_attention launches in one prefill of {cfg.n_layers} layers: "
            f"{ {k: v for k, v in launches.items() if k.startswith('flash')} }, want "
            f"{cfg.n_layers} through wgmma and none through simt")
    require(tuple(gen.tokens.shape) == (SERVE_BATCH, SERVE_NEW + 1),
            f"tokens {tuple(gen.tokens.shape)}")
    require(bool(((gen.tokens >= 0) & (gen.tokens < cfg.vocab)).all()), "token out of range")
    require(bool(torch.isfinite(gen.logits).all()), "non-finite logits")
    require(bool(torch.equal(gen.tokens[:, 0], warm.tokens[:, 0])),
            "the two prefills' greedy tokens differ")
    tok_s = SERVE_NEW * SERVE_BATCH / gen.decode_seconds
    print(f"prefill {SERVE_BATCH} x {SERVE_CONTEXT} tokens: {gen.prefill_seconds:.4f} s "
          f"({SERVE_BATCH * SERVE_CONTEXT / gen.prefill_seconds:.0f} tok/s); decode "
          f"{SERVE_NEW} tokens x {SERVE_BATCH} requests: {gen.decode_seconds:.4f} s "
          f"({tok_s:.2f} tok/s, {gen.decode_seconds / SERVE_NEW * 1e3:.2f} ms/step); "
          f"peak memory {peak:.2f} GB (max_memory_allocated)")
    print(f"launches in the serve path: {launches}")
    print(f"req0 tokens: {gen.tokens[0, :16].tolist()}")
    return cfg, params, ctx, launches, dict(prefill_s=gen.prefill_seconds, decode_tok_s=tok_s,
                                            peak_gb=peak)


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


@phase("profile of one serve prefill and 4 decode steps")
def profile_serve(cfg, params, ctx):
    import torch
    from repro_torch.models import decode

    batch = {"tokens": torch.as_tensor(ctx, device="cuda")}
    (logits, cache), _ = _profiled(
        "prefill", lambda: decode.prefill(cfg, params, batch, SERVE_CONTEXT + 4))

    def steps(tok):
        for _ in range(4):
            tok = decode.decode_step(cfg, params, cache, tok)[0].argmax(-1)

    _profiled("decode x4", lambda: steps(logits.argmax(-1)))


def _profiled(label: str, fn, top: int = 8):
    """Run ``fn`` once under the profiler; print wall time, device kernel
    time, busy share and the top kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if _is_device(e)]
    total = sum(e.self_device_time_total for e in kernels)
    print(f"profile {label}: wall {wall * 1e3:.2f} ms, device kernel time {total / 1e3:.2f} ms "
          f"(busy share {total / 1e3 / (wall * 1e3):.3f} under the profiler), "
          f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return out, prof


# The small-input reference: the same fp32 weights and context through the
# card (flash kernel, cuBLAS in full fp32) and the CPU (plain version). Both
# sum in fp32 in other orders; torch on the CPU and the JAX package agree to
# 2e-6 on these logits (|logit| < 3), so 1e-4 leaves a wide margin while
# staying far below any bf16 effect (2^-8 ~ 4e-3 relative).
SMALL_LOGIT_ATOL = 1e-4


@phase("small-input reference: reduced llama3_8b, flash, fp32, context 2560, card vs CPU")
def serve_small_reference():
    import numpy as np
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.models import model

    cfg = dataclasses.replace(reduce_config(get_config(SERVE_ARCH)), attn_impl="flash")
    params_cpu = model.init_params(cfg, 0, device="cpu")
    params_gpu = tree_util.map(lambda t: t.to("cuda"), params_cpu)
    ctx = np.random.default_rng(1).integers(0, cfg.vocab, (2, 2560))
    fa.reset_launches()
    g = serve.generate(cfg, params_gpu, ctx, 8)
    simt_launches = fa.launches["flash_attention_simt"]
    require(simt_launches == cfg.n_layers and fa.launches["flash_attention"] == cfg.n_layers,
            f"flash_attention launches in the fp32 prefill: {fa.launches}")
    c = serve.generate(cfg, params_cpu, ctx, 8, device="cpu")
    require(torch.equal(g.tokens.cpu(), c.tokens),
            f"greedy tokens differ: card {g.tokens.tolist()} vs CPU {c.tokens.tolist()}")
    fwd_g = model.forward_logits(cfg, params_gpu, {"tokens": torch.as_tensor(ctx, device="cuda")})
    fwd_c = model.forward_logits(cfg, params_cpu, {"tokens": torch.as_tensor(ctx)})
    err_fwd = (fwd_g.cpu() - fwd_c).abs().max().item()
    err_last = (g.logits.cpu() - c.logits).abs().max().item()
    require(max(err_fwd, err_last) <= SMALL_LOGIT_ATOL,
            f"card vs CPU logits differ by {max(err_fwd, err_last):.3e} > {SMALL_LOGIT_ATOL}")
    print(f"card vs CPU (B=2, context 2560, chunk {cfg.chunk_size}, 8 greedy steps): tokens "
          f"identical, prefill logits max abs {err_fwd:.3e}, last-step logits max abs "
          f"{err_last:.3e} (tolerance {SMALL_LOGIT_ATOL:g}, max |logit| "
          f"{c.logits.abs().max().item():.3f})")
    return simt_launches


def main() -> int:
    import torch

    card = environment()
    sys.path.insert(0, str(SRC))
    build_kernels()
    zpad = 1984 * 128              # FEMNIST Z = 246,590 in 64-row tiles
    wire_m = 2048                  # FEMNIST Z in 256-row tiles of 128 lanes
    report = kernels_vs_plain(zpad, wire_m)
    report.update(flash_vs_plain())
    sim, main_launches = main_path()
    policies(sim)
    telemetry(sim)
    scenarios(sim)
    numeric_scope(sim)
    scenario_references()
    small_reference()
    replay_reference()
    profile_round(sim)
    wire_launches = wire_entry(sim)
    del sim                        # its 5.33 GB fleet tensor, before the 8B model
    gc.collect()
    torch.cuda.empty_cache()
    object_runtime()
    cfg, params, ctx, serve_launches, _serve = serve_path()
    two_layer_prefill(cfg, params, ctx)
    profile_serve(cfg, params, ctx)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    fp32_serve_launches = serve_small_reference()

    sources = {"flash_attention_wgmma": "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
               "flash_attention_simt": "src/repro_torch/kernels/csrc/flash_attention.cu"}
    replaces = {
        "aggregate": "src/repro/kernels/stochastic_quant.py:172",
        "quantize": "src/repro/kernels/stochastic_quant.py:49",
        "dequantize": "src/repro/kernels/stochastic_quant.py:97",
        "flash_attention_wgmma": "src/repro/kernels/flash_attention.py:183",
        "flash_attention_simt": "src/repro/kernels/flash_attention.py:183",
    }
    # each kernel's launches in the run of the path that takes it: the
    # FEMNIST rounds, the wire entry point, the bf16 serve prefill (wgmma),
    # the fp32 serve prefill of the small-input reference (simt)
    launches = {"aggregate": main_launches["aggregate"],
                "quantize": wire_launches["quantize"],
                "dequantize": wire_launches["dequantize"],
                "flash_attention_wgmma": serve_launches["flash_attention_wgmma"],
                "flash_attention_simt": fp32_serve_launches}
    kernels = [
        {"name": name, "route": "cuda",
         "source": sources.get(name, "src/repro_torch/kernels/csrc/stochastic_quant.cu"),
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r.get("library_ms")}
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
