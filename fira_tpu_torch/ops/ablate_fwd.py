"""What each design choice of the copy-score forward kernel (K1) is worth.

    python -m fira_tpu_torch.ops.ablate_fwd

Compiles ``csrc/copy_score.cu`` as it is and, beside it, copies with one
choice reverted each (by text substitution on the source), all with
``nvcc`` at once (the machinery of ``ablate_bwd``). It then runs every
build at the training shape (170, 30, 370, 256), the dev shape
(20, 30, 370, 256) and the decode shape (60, 1, 370, 256), all f32,
holds it against the plain version at rtol / atol 1e-5, and times it
(``timing.time_ms``: median of 40 launches, L2 flushed before each). It
prints one JSON line per build:
the time at each shape, registers and spills of its f32 D=256 kernels,
and whether it agreed; first, as a yardstick for the decode shape, the
time of ``torch.sum`` over the same src. Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import sys

import torch

from fira_tpu_torch.config import fira_full
from fira_tpu_torch.ops import build, copy_score as cs
from fira_tpu_torch.ops.ablate_bwd import compile_all, variant_sources
from fira_tpu_torch.ops.timing import smi_name_power, time_ms

_T = fira_full().tar_len
SHAPES = {"train": (170, _T, 370, 256), "dev": (20, _T, 370, 256),
          "decode": (60, 1, 370, 256)}
SYMBOLS = ("copy_score_tile_kernelIfLi256E", "copy_score_row_kernelIfLi256E")

# name -> [(text in the source, text that reverts the choice)]
REVERSIONS = {
    # T > 1: every element through the precise tanhf (the guard path)
    "precise_tanhf": [("if (!slow[p] && fabsf(s1) <= GUARD && fabsf(s2) <= "
                       "GUARD) {", "if (false) {")],
    # T > 1: the SFU reciprocal through __fdividef, which adds range checks
    "fdividef": [("rcp_approx(a0 * b0)", "__fdividef(1.f, a0 * b0)"),
                 ("rcp_approx(a1 * b1)", "__fdividef(1.f, a1 * b1)")],
    # T > 1: one reciprocal an element instead of one a pair of d
    "rcp_per_element": [
        ("acc[2 * k] = fmaf(fmaf(wp.x, b0, wp.y * a0),\n"
         "                                          rcp_approx(a0 * b0), "
         "acc[2 * k]);",
         "acc[2 * k] = fmaf(wp.y, rcp_approx(b0), "
         "fmaf(wp.x, rcp_approx(a0), acc[2 * k]));"),
        ("acc[2 * k + 1] = fmaf(fmaf(wp.x, b1, wp.y * a1),\n"
         "                                              rcp_approx(a1 * b1), "
         "acc[2 * k + 1]);",
         "acc[2 * k + 1] = fmaf(wp.y, rcp_approx(b1), "
         "fmaf(wp.x, rcp_approx(a1), acc[2 * k + 1]));")],
    # T > 1: the staged e^(2 tgt) read 4 bytes at a time, not 16
    "scalar_et": [("const float4 e = e4[k];",
                   "float4 e; asm volatile(\"ld.shared.f32 %0, [%4]; "
                   "ld.shared.f32 %1, [%4+4]; ld.shared.f32 %2, [%4+8]; "
                   "ld.shared.f32 %3, [%4+12];\" : \"=f\"(e.x), \"=f\"(e.y), "
                   "\"=f\"(e.z), \"=f\"(e.w) : \"r\"((unsigned)"
                   "__cvta_generic_to_shared(e4 + k)));")],
    # T > 1: a src chunk loaded in its own step, not one step ahead
    "no_prefetch": [("#pragma unroll\n"
                     "            for (int j = 0; j < 8; ++j) sv[j] = "
                     "sv_next[j];\n"
                     "            if (d0 + 8 < d_end) load_vec<T, 8>(row + d0 + "
                     "8, sv_next);\n",
                     "            load_vec<T, 8>(row + d0, sv);\n")],
    # T > 1: one slice of d, 128 values of s a block, whatever the batch
    "one_d_slice": [("    while (ts > 32 && ", "    while (false && ")],
    # T = 1: 4-byte lanes, lane l on d = l + 32 k (the first design's loads)
    "scalar_row_loads": [(
        "constexpr int VEC = 16 / (int)sizeof(T) < D / 32 ? "
        "16 / (int)sizeof(T) : D / 32;", "constexpr int VEC = 1;")],
}


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_fwd: no CUDA device", file=sys.stderr)
        return 2
    built = compile_all(variant_sources("copy_score", REVERSIONS), SYMBOLS,
                        build.BUILD_DIR / "ablate_fwd")
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = {}
    for label, (B, T, S, D) in SHAPES.items():
        src = torch.randn((B, S, D), device="cuda", generator=gen)
        tgt = torch.randn((B, T, D), device="cuda", generator=gen)
        w = torch.randn((D,), device="cuda", generator=gen) * 0.1
        want = cs.copy_scores_reference(src, tgt, w.reshape(-1, 1),
                                        torch.zeros(1, device="cuda"))
        cases[label] = (src, tgt, w, want)
    # a yardstick, not a kernel of the port: one PyTorch call that reads
    # the same src bytes at the decode shape
    src = cases["decode"][0]
    print(json.dumps(dict(
        build="reference: torch.sum(src, -1), the decode shape's bytes",
        decode_ms=time_ms(lambda: src.sum(-1), n=40))), flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    for name, (so, regs) in built.items():
        fn = ctypes.CDLL(str(so)).fira_copy_score_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        row = dict(build=name)
        for label, (src, tgt, w, want) in cases.items():
            out = torch.empty_like(want)
            B, S, D = src.shape

            def call():
                err = fn(src.data_ptr(), tgt.data_ptr(), w.data_ptr(),
                         out.data_ptr(), B, tgt.shape[1], S, D, 0, stream)
                if err != 0:
                    raise SystemExit(f"ablate_fwd: {name}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            row[f"{label}_agrees"] = torch.allclose(out, want, rtol=1e-5,
                                                    atol=1e-5)
            row[f"{label}_max_abs_err"] = (out - want).abs().max().item()
            row[f"{label}_ms"] = time_ms(call, n=40)
        row["regs"] = regs
        print(json.dumps(row), flush=True)
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{smi_name_power()}; shapes {SHAPES} f32")
    return 0


if __name__ == "__main__":
    sys.exit(main())
