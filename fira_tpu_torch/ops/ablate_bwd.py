"""What each design choice of the copy-score backward kernel (K2) is worth.

    python -m fira_tpu_torch.ops.ablate_bwd

Compiles ``csrc/copy_score_bwd.cu`` as it is and, beside it, copies with
one choice reverted each (by text substitution on the source), all with
``nvcc`` at once. It then runs every build at the training shape
(170, 30, 370, 256) f32, holds it against the plain autograd at rtol 5e-4 /
atol 5e-5, and times it (``timing.time_ms``: median of 40 launches, L2
flushed before each).
It prints one JSON line per build: time, registers and spills of its f32
D=256 kernel, and whether it agreed; for the source as it is, also the
device time of each of its two kernels. Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from fira_tpu_torch.config import fira_full
from fira_tpu_torch.ops import build, copy_score as cs
from fira_tpu_torch.ops.timing import smi_name_power, time_ms

SHAPE = (170, fira_full().tar_len, 370, 256)
OUT_DIR = build.BUILD_DIR / "ablate"

# name -> [(text in the source, text that reverts the choice)]
REVERSIONS = {
    # the SFU reciprocal through __fdividef, which adds range checks
    "fdividef": [("rcp_approx(fmaf(es, et[t], 1.f))",
                  "__fdividef(1.f, fmaf(es, et[t], 1.f))")],
    # (1 - x^2) / 4 as P r^2 (three products) instead of r - r^2 (one FFMA)
    "p_r_squared": [("const float r = rcp_approx(fmaf(es, et[t], 1.f));",
                     "const float p = es * et[t];\n"
                     "const float r = rcp_approx(p + 1.f);"),
                    ("const float h = fmaf(-r, r, r);",
                     "const float h = (p * r) * r;")],
    # every element through the precise tanhf (the one-pass design alone)
    "precise_tanhf": [("if (tile_fast && fabsf(sv) <= GUARD) {",
                       "if (false) {")],
    # src[b, s] loaded in its own step instead of one step ahead
    "no_prefetch": [("        float sv = to_f32(src_col[0]);\n", ""),
                    ("            const float sv_next = s + 1 < ns ? "
                     "to_f32(src_col[(size_t)(s + 1) * D])\n"
                     "                                             : 0.f;\n",
                     "            const float sv = "
                     "to_f32(src_col[(size_t)s * D]);\n"),
                    ("            sv = sv_next;\n", "")],
    # chunks of at most 64 s (6 at S = 370) instead of 128 (3)
    "chunk_64": [("constexpr int CHUNK_MAX = 128;", "constexpr int CHUNK_MAX = 64;")],
    # registers up to 255 (one block of 256 threads per SM)
    "one_block_per_sm": [("__launch_bounds__(D)", "__launch_bounds__(D, 1)")],
}


def variant_sources(kernel: str = "copy_score_bwd",
                    reversions: dict = REVERSIONS) -> dict:
    """build name -> source text: ``csrc/<kernel>.cu`` as it is
    ("as_is") and with each reversion's substitutions applied."""
    src = (build.CSRC / f"{kernel}.cu").read_text()
    out = {"as_is": src}
    for name, subs in reversions.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"ablate: {kernel} {name}: source text not "
                                 f"found: {old!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def compile_all(sources: dict, symbols=("copy_score_bwd_kernelIfLi256E",),
                out_dir=OUT_DIR) -> dict:
    """name -> (library path, ptxas line of each kernel whose mangled name
    holds one of ``symbols``), every source compiled by nvcc at once into
    ``out_dir``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    built = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"ablate: nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        regs = "; ".join(
            f"{lines[i + 2].split(':', 1)[1].strip()}; {lines[i + 1].strip()}"
            for sym in symbols for i, line in enumerate(lines)
            if "Function properties for" in line and sym in line) or "?"
        built[name] = (so, regs)
    return built


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_bwd: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    built = compile_all(variant_sources())
    B, T, S, D = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(1)
    src = torch.randn((B, S, D), device="cuda", generator=gen)
    tgt = torch.randn((B, T, D), device="cuda", generator=gen)
    w = torch.randn((D,), device="cuda", generator=gen) * 0.1
    dout = torch.randn((B, T, S), device="cuda", generator=gen)
    want = cs.copy_scores_backward_reference(src, tgt, w.reshape(-1, 1), dout)
    flush = torch.empty(32 * 2**20, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for name, (so, regs) in built.items():
        lib = ctypes.CDLL(str(so))
        fn = lib.fira_copy_score_bwd
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        n_c = lib.fira_copy_score_bwd_chunks(S)
        dsrc, dtgt = torch.empty_like(src), torch.empty_like(tgt)
        dtgt_part = torch.empty((B, n_c, T, D), device="cuda")
        dw_part = torch.empty((B, n_c, D), device="cuda")

        def call():
            err = fn(src.data_ptr(), tgt.data_ptr(), w.data_ptr(),
                     dout.data_ptr(), dsrc.data_ptr(), dtgt.data_ptr(),
                     dtgt_part.data_ptr(), dw_part.data_ptr(), B, T, S, D, 0,
                     stream)
            if err != 0:
                raise SystemExit(f"ablate_bwd: {name}: CUDA error {err}")

        call()
        torch.cuda.synchronize()
        got = (dsrc, dtgt, dw_part.sum(dim=(0, 1)).reshape(-1, 1))
        agrees = all(torch.allclose(g, r, rtol=5e-4, atol=5e-5)
                     for g, r in zip(got, want))
        row = dict(build=name, ms=time_ms(call, n=40), agrees=agrees,
                   regs=regs)
        if name == "as_is":
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    flush.zero_()
                    call()
                torch.cuda.synchronize()
            row["kernels_ms"] = {
                e.key.split("::")[-1].split("(")[0]:
                    e.self_device_time_total / e.count / 1e3
                for e in prof.key_averages() if "copy_score" in e.key}
        print(json.dumps(row), flush=True)
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{smi_name_power()}; shape {SHAPE} f32")
    return 0


if __name__ == "__main__":
    sys.exit(main())
