#!/usr/bin/env python3
"""Write ``wgmma.cuh``: the inline-PTX wrappers of Hopper's warpgroup
matrix multiply that ``flash_fwd.cu``, ``flash_bwd.cu``, the projection
GEMM core (``gemm_sm90.cuh``), the fused conv (``fused_conv.cu``) and the
fp32 routes' 3xTF32 core (``gemm_tf32.cuh``) issue.

    python3 gligen_tpu_torch/csrc/gen_wgmma.py

A ``wgmma.mma_async`` instruction names every accumulator register, N/2 of
them for an m64nNk16 fp32 product, so each width is one wrapper written
out in full.  Three forms, all with fp32 accumulators, two of them with
bf16 operands:

  * ``wgmma_ss<N>``: A and B from shared memory, by descriptor (S = Q K^T,
    and the projections' tiles at every width of their tile table);
  * ``wgmma_rs<N>``: A from registers (four bf16x2 per thread, the layout
    of the accumulator it was computed in, or ``ldmatrix``'s), B from shared
    memory (O += P V; the fused conv's activated input tiles);
  * ``WgmmaRsTf32<N>``: m64nNk8 with TF32 operands, A from registers (four
    TF32 values per thread: rows g and g + 8 of the thread's warp, columns
    t and t + 4, g = lane / 4, t = lane % 4), B from shared memory, K-major
    (TF32 has no transposed form).  The 3xTF32 products of the fp32 flash
    routes (S^T = K Q^T and O^T = V^T P^T at d = 512; O = P V at the
    UNet's head dims, N = d or d / 2: flash_fwd.cu; the backward's dQ, dK,
    dV parts, N = d or d / 2, and at d <= 160 its S and dP with raw Q and dO
    (K and V) as A, N = the 16-key tile: flash_bwd.cu), of the fp32 fused projections
    (the normalised rows as A, fused_proj.cu) and of the fp32 fused conv
    (the activated halo rows as A, fused_conv.cu);
  * ``WgmmaSsTf32<N>``: m64nNk8 with TF32 operands, A and B from shared
    memory by descriptor, both K-major: S = Q K^T of the fp32 flash route
    at the UNet's head dims (N = the key tile, flash_fwd.cu).

``TRANS_B`` is the instruction's imm-trans-b: 0 for a K-major B, 1 for an
MN-major one.  ``tests/test_torch_flash.py`` checks that the committed
header is what this script writes.
"""

from __future__ import annotations

from pathlib import Path

HEADER = Path(__file__).resolve().parent / "wgmma.cuh"
SS_WIDTHS = (32, 64, 96, 128, 160, 192, 256)
RS_WIDTHS = (40, 80, 128, 160, 256)
RS_TF32_WIDTHS = (16, 32, 40, 64, 80)
SS_TF32_WIDTHS = (32, 64)


def _regs(n: int) -> str:
    return ", ".join(f"%{i}" for i in range(n // 2))


def _outs(n: int) -> str:
    lines, per = [], 8
    for i in range(0, n // 2, per):
        lines.append("        " + ", ".join(f'"+f"(d[{j}])' for j in range(i, min(i + per, n // 2))))
    return ",\n".join(lines)


def _ss(n: int) -> str:
    r = n // 2
    return f"""template <>
struct Wgmma<{n}> {{
  template <int TRANS_B>
  static __device__ __forceinline__ void ss(float (&d)[{r}], uint64_t a, uint64_t b, int acc) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
        "{{{_regs(n)}}}, %{r}, %{r + 1}, p, 1, 1, 0, %{r + 3};\\n}}\\n"
        :
{_outs(n)}
        : "l"(a), "l"(b), "r"(acc), "n"(TRANS_B));
  }}
}};
"""


def _rs(n: int) -> str:
    r = n // 2
    return f"""template <>
struct WgmmaRs<{n}> {{
  template <int TRANS_B>
  static __device__ __forceinline__ void rs(float (&d)[{r}], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
        "{{{_regs(n)}}}, {{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, p, 1, 1, %{r + 6};\\n}}\\n"
        :
{_outs(n)}
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TRANS_B));
  }}
}};
"""


def _rs_tf32(n: int) -> str:
    r = n // 2
    return f"""template <>
struct WgmmaRsTf32<{n}> {{
  static __device__ __forceinline__ void rs(float (&d)[{r}], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 "
        "{{{_regs(n)}}}, {{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, p, 1, 1;\\n}}\\n"
        :
{_outs(n)}
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }}
}};
"""


def _ss_tf32(n: int) -> str:
    r = n // 2
    return f"""template <>
struct WgmmaSsTf32<{n}> {{
  static __device__ __forceinline__ void ss(float (&d)[{r}], uint64_t a, uint64_t b, int acc) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 "
        "{{{_regs(n)}}}, %{r}, %{r + 1}, p, 1, 1;\\n}}\\n"
        :
{_outs(n)}
        : "l"(a), "l"(b), "r"(acc));
  }}
}};
"""


def render() -> str:
    parts = [
        "// Generated by gen_wgmma.py: do not edit.  Warpgroup MMA wrappers, m64nNk16,\n"
        "// bf16 x bf16 -> fp32.  Wgmma<N>::ss: A and B by shared-memory descriptor;\n"
        "// WgmmaRs<N>::rs: A from registers.  WgmmaRsTf32<N>::rs: m64nNk8, TF32 x TF32\n"
        "// -> fp32, A from registers; WgmmaSsTf32<N>::ss: the same, A and B by\n"
        "// descriptor.  acc = 0 overwrites d, 1 accumulates.\n",
        "#pragma once\n\n#include <stdint.h>\n\n",
        "template <int N>\nstruct Wgmma;\n\ntemplate <int N>\nstruct WgmmaRs;\n\n"
        "template <int N>\nstruct WgmmaRsTf32;\n\ntemplate <int N>\nstruct WgmmaSsTf32;\n\n",
    ]
    parts += [_ss(n) + "\n" for n in SS_WIDTHS]
    parts += [_rs(n) + "\n" for n in RS_WIDTHS]
    parts += [_rs_tf32(n) + "\n" for n in RS_TF32_WIDTHS]
    parts += [_ss_tf32(n) + "\n" for n in SS_TF32_WIDTHS]
    return "".join(parts).rstrip("\n") + "\n"


if __name__ == "__main__":
    HEADER.write_text(render())
    print(f"wrote {HEADER}")
