#!/usr/bin/env python3
"""Where the SIMT flash kernel's time goes, by ablation, on the card.

    PYTHONPATH=src python3 scripts/flash_simt_ablation.py

Needs a CUDA device and nvcc. Builds ``csrc/flash_attention.cu`` as it is
and in variants that each drop one part of the work (text edits of the
source, into ``build/repro_torch_kernels/ablation/``), and times each on
the Llama-3-8B fp32 prefill shape (B=4, S=T=4096, H=32 over KV=8, hd=128,
causal; CUDA events over 5 launches after one, the mean of 2 repeats in
turns). A variant that drops work gives wrong numbers; only the full
kernel's error is printed against the plain version. The variants:

  * ``full``: the kernel;
  * ``no_pv``: no P V products (the V chunks still stream in);
  * ``no_qk``: no Q K^T products (the K chunks still stream in);
  * ``no_products``: neither product: loads, barriers, softmax, Q, epilogue;
  * ``no_loads``: the ring's chunks are never copied in (the products run
    on stale shared memory);
  * ``no_softmax``: the online softmax and the P^T store skipped.

Then the SASS instruction mix of the fp32 async kernel's two product loops
(``cuobjdump`` beside nvcc): FFMA, LDS and other instructions per block.
Prints the card's name and power limit.
"""
from __future__ import annotations

import collections
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

EDITS = {
    "no_pv": [("      for (int kk = 0; kk < kVC; ++kk) {", "      for (int kk = 0; kk < 0; ++kk) {")],
    "no_qk": [("      for (int d4 = 0; d4 < kKC / 4; ++d4) {", "      for (int d4 = 0; d4 < 0; ++d4) {")],
    "no_products": [
        ("      for (int kk = 0; kk < kVC; ++kk) {", "      for (int kk = 0; kk < 0; ++kk) {"),
        ("      for (int d4 = 0; d4 < kKC / 4; ++d4) {", "      for (int d4 = 0; d4 < 0; ++d4) {")],
    "no_loads": [("        src.issue_async(ring + (nx % kStages) * kStageFloats, nk_first, nx % L::CPT, tid);",
                  "        ;")],
    "no_softmax": [("      if (c == L::KCHUNKS - 1) {", "      if (c == L::KCHUNKS - 1 && a.window == -1) {")],
}


def sass_mix(lib: Path, nvcc: str) -> None:
    """FFMA / LDS / other counts of the large straight-line blocks of the
    fp32, hd-128, async kernel."""
    cuobjdump = Path(nvcc).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    for fn in re.split(r"\n\s+Function : ", sass)[1:]:
        if "flash_fwd_kernelIfLi128ELb1E" not in fn.split("\n", 1)[0]:
            continue
        block = collections.Counter()
        for line in fn.split("\n"):
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if not m:
                continue
            op = m.group(1).split(".")[0]
            block[op] += 1
            if op in ("BRA", "BAR", "BSYNC", "EXIT"):
                if block["FFMA"] >= 1000:
                    other = sum(block.values()) - block["FFMA"] - block["LDS"]
                    print(f"SASS product block: {block['FFMA']} FFMA, {block['LDS']} LDS, "
                          f"{other} other ({block['FFMA'] / sum(block.values()):.1%} FFMA)")
                block = collections.Counter()


def main() -> int:
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    src = (build.CSRC / "flash_attention.cu").read_text()
    out_dir = build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    variants = {"full": src}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: the source no longer holds {old.strip()!r}")
            text = text.replace(old, new)
        variants[name] = text
    nvcc = build.find_nvcc()
    procs = {}
    for name, text in variants.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        lib.fa_forward.argtypes = list(build.LIBRARIES["flash_attention"][1]["fa_forward"])
        lib.fa_forward.restype = ctypes.c_int
        libs[name] = lib

    gen = torch.Generator(device="cuda").manual_seed(1)
    b, s, t, h, kv, hd = 4, 4096, 4096, 32, 8, 128
    q = 0.3 * torch.randn((b, s, h, hd), generator=gen, device="cuda")
    k = 0.3 * torch.randn((b, t, kv, hd), generator=gen, device="cuda")
    v = 0.3 * torch.randn((b, t, kv, hd), generator=gen, device="cuda")
    assert fa._load_variant(q, k, v) == "async"
    want = fa.flash_attention_plain(q, k, v, causal=True)
    out = torch.empty_like(q)
    stream = build.stream(torch.device("cuda"))

    def call(lib):
        err = lib.fa_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
                             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                             b, s, t, h, kv, hd, 1, 0, float(hd ** -0.5), 0, 1,
                             torch.cuda.current_device(), stream)
        if err:
            raise SystemExit(f"launch failed: CUDA error {err}")

    call(libs["full"])
    torch.cuda.synchronize()
    print(f"full kernel vs plain: max abs err {(out - want).abs().max().item():.3e}")
    times = {name: [] for name in libs}
    for _ in range(2):
        for name, lib in libs.items():
            call(lib)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(5):
                call(lib)
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / 5)
    for name, ts in times.items():
        print(f"{name}: {sum(ts) / len(ts):.3f} ms ({', '.join(f'{x:.3f}' for x in ts)})")
    sass_mix(out_dir / "libfull.so", nvcc)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
