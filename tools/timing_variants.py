#!/usr/bin/env python3
"""Write timing-only variants of a kernel's source, to split its time
between its parts on the card.

    python3 tools/timing_variants.py SRC.cu [SRC.cu ...]

Beside each SRC (which must lie outside the checkout's ``src/repro_torch``:
every ``.cu`` there is built into the kernels' library) it writes, for a
warp-specialised conv kernel,

- ``<stem>_nocopy.cu``: each ring stage's copies removed (the producer's
  ``stage`` lambda returns at once, after its wait for the stage where it
  has one, and so does the int8->bf16 stacks' ``widen``), so the consumers
  multiply whatever the ring holds and only they and the barriers take
  time;
- ``<stem>_nomma.cu``: each ``mma.sync`` (``mma_bf16``, ``mma_bf16_z``,
  ``mma_tf32``) replaced by an empty ``asm volatile`` that still reads its
  operand registers, so the fragments are loaded but never multiplied;
- ``<stem>_nocopy_nomma.cu``: both;

and for the int8 stacks' kernels (int8->bf16 and int8->fp32: a ``widen``
lambda beside ``stage``; K5b's ``w1_slice_*`` / ``w2_slice_*`` calls)

- ``<stem>_nowiden.cu``: the x bytes copied but never widened;
- ``<stem>_now_k5b.cu``: K5b's w1 and w2 slices never copied;
- ``<stem>_nox_k5a.cu``, ``<stem>_now_k5a.cu``: K5a's int8 kernels copy
  no x (bytes or elements), or no w1 and w2;
- ``<stem>_noslab_k5a.cu``: its consumers read no conv2 B value from the
  slab (a value made from the address instead);
- ``<stem>_xnear_k5a.cu``: its x runs decoded as ever but copied from the
  first 64 bytes of x (cache-resident), so the copies' latency goes and
  the producers' work stays;
- ``<stem>_noepi_k5a.cu``: its conv1 passes write nothing to the slab;
- ``<stem>_xzero_k5a.cu``: its x copied as ever but widened to zeros (the
  copies and their waits stay; the operands change), to tell the copy
  path's cost from the data's;

and for K5a's float32 kernel (``cluster_stack_kernel``, whose 256 threads
each copy and multiply: the float32 build's)

- ``<stem>_nox_k5a32.cu``: phase A's x never copied;
- ``<stem>_now_k5a32.cu``: w1 and w2 never copied;
- ``<stem>_nofma_k5a32.cu``: each ``fmaf`` an empty ``asm volatile``
  that reads its operands;

and for K5a's bf16 kernels (``conv_stack_chwn.cu``: ``conv1_pass_bf16``
and phase B's ``issue_w2``, in which every thread both copies and
multiplies)

- ``<stem>_nox.cu``: phase A's x never copied (its ring slices keep what
  they hold);
- ``<stem>_now.cu``: w1 and w2 never copied;
- ``<stem>_nomma.cu``: the products removed, as above;

and for the bf16 pool backward (``pool_backward.cu``: K7a bf16's direct
and banded kernels, whose loads and stores go through ``ld_g``,
``ld_unit`` and ``st_unit``)

- ``<stem>_nog.cu``: g never read (a word made from its offset);
- ``<stem>_nox.cu``: x never read (a word made from its address);
- ``<stem>_nostore.cu``: dx stored only under a test no value passes, so
  the loads and the arithmetic stay and the writes go;

and for K7b bf16 (its pair and banded kernels, whose accesses go through
``ld_x8``, ``stage_x``, ``ld_g1`` and ``store_dx``)

- ``<stem>_nox_nchw.cu``: the pair kernel reads no x (8 elements made
  from their address);
- ``<stem>_nostage_nchw.cu``: the banded kernel copies no x row into
  shared memory (phase 1 and the mask read whatever it holds);
- ``<stem>_nog_nchw.cu``: g never read;
- ``<stem>_nostore_nchw.cu``: dx never stored (the arithmetic stays);
- ``<stem>_nophase1_nchw.cu``: the banded kernel's phase 1 runs no item
  (no first max, no g read; phase 2 reads whatever the words hold);
- ``<stem>_nophase2_nchw.cu``: its phase 2 runs no item (no dx formed or
  stored).

Time them with ``tools/storage_variants.py --timing-only KERNEL.VARIANT
SRC_nocopy.cu ...``; their outputs are garbage by design.  A copy of
another tree's kernels (``git archive`` under ``build/``) keeps that tree's
headers beside its variants.
"""
from __future__ import annotations

import re
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# the products, as no-ops that read the operands the mma would have read
NOMMA = """
namespace {
__device__ __forceinline__ void nomma(float (&c)[4], const unsigned (&a)[4],
                                      unsigned b0, unsigned b1) {
  asm volatile("" ::"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
               "r"(b1));
  (void)c;
}
__device__ __forceinline__ void nomma(float (&d)[4], const unsigned (&a)[4],
                                      unsigned b0, unsigned b1,
                                      const float (&c)[4]) {
  nomma(d, a, b0, b1);
  (void)c;
}
}  // namespace
"""
_MMA = re.compile(r"\bmma_(?:bf16_z|bf16|tf32)\(")
# the producers' stage lambdas, and the int8->bf16 kernels' widening ones
_STAGE = re.compile(r"auto (?:stage|widen) = \[&\]\(int sl\) \{")
_WAIT = re.compile(r"\n\s*(if \(sl >= \w+\) bar_sync\([^;]*\);)")
# the bf16 pool backward's accesses, as stand-ins that touch no memory (or
# write none); they go in after the kernel's own helpers
FAKE = """
__device__ __forceinline__ unsigned fake_g(const __nv_bfloat16*, long long o,
                                          long long, int n, bool) {
  return 0x3f803f80u ^ static_cast<unsigned>((o + n) & 0x00010001);
}
__device__ __forceinline__ unsigned fake_unit(const __nv_bfloat16* p, bool) {
  return static_cast<unsigned>(reinterpret_cast<uintptr_t>(p)) & 0x3f7f3f7fu;
}
__device__ __forceinline__ void st_never(__nv_bfloat16* p, float a0,
                                         float a1, bool pair) {
  if (a0 == -12345.f && a1 == -12345.f) st_unit(p, a0, a1, pair);
}
"""
_HELPERS_END = "__device__ __forceinline__ float mask("
# K7b bf16's accesses, as stand-ins; they go in after its own helpers
FAKE_NCHW = """
__device__ __forceinline__ void stage_none(__nv_bfloat16*,
                                           const __nv_bfloat16*) {}
__device__ __forceinline__ uint4 fake_x8(const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(reinterpret_cast<uintptr_t>(p));
  return make_uint4(a & 0x3f7f3f7fu, a >> 3, a ^ 0x3f003f00u, a >> 5);
}
__device__ __forceinline__ unsigned fake_g1(const __nv_bfloat16* p) {
  return static_cast<unsigned>(reinterpret_cast<uintptr_t>(p) >> 1) & 0x3f7fu;
}
__device__ __forceinline__ void store_never(__nv_bfloat16* d,
                                            const float (&acc)[8], bool wide,
                                            int n) {
  if (acc[0] == -12345.f && acc[7] == -12345.f) store_dx(d, acc, wide, n);
}
"""
_NCHW_KERNEL = "// K7b bf16's pair kernel:"


def pool_variants(text: str) -> dict:
    """K7a bf16's part variants (``FAKE``'s stand-ins after its helpers)
    and K7b bf16's (``FAKE_NCHW``'s after its own)."""
    head, sep, rest = text.partition(_HELPERS_END)
    body = rest.partition("\n}\n")
    base = head + FAKE + sep + body[0] + body[1]
    tail = body[2]
    out = {"nog": base + tail.replace("ld_g(", "fake_g("),
           "nox": base + tail.replace("ld_unit(x + ", "fake_unit(x + "),
           "nostore": base + tail.replace("st_unit(", "st_never(")}
    if _NCHW_KERNEL in text:
        head, sep, tail = text.partition(_NCHW_KERNEL)
        head += FAKE_NCHW
        out.update(
            nostage_nchw=head + sep + tail.replace("stage_x(",
                                                   "stage_none("),
            nox_nchw=head + sep + tail.replace("ld_x8(xr", "fake_x8(xr"),
            nog_nchw=head + sep + tail.replace("ld_g1(g", "fake_g1(g"),
            nostore_nchw=head + sep + tail.replace("store_dx(d",
                                                   "store_never(d"),
            nophase1_nchw=head + sep + tail.replace(
                "it.a < pc; it.add(d, wr,", "false; it.add(d, wr,"),
            nophase2_nchw=head + sep + tail.replace(
                "it.a < pc; it.add(d, rows,", "false; it.add(d, rows,"))
    return out


# K5a's bf16 kernels: the copies of every thread's issue lambdas
_K5A_PASS = "conv1_pass_bf16("
_K5A_NOX = (("    if (p.vec_x) {\n      if (tid < kNBK * XCH) {",
             "    if (false) {\n      if (tid < kNBK * XCH) {"),
            ("    } else {\n      const int pc = tid % KRA;",
             "    } else if (false) {\n      const int pc = tid % KRA;"))
_K5A_NOW = (("    if (tid < kNBK * (kCM / 8)) {  // w1",
             "    if (false) {  // w1"),
            ("      for (int i = 0; i < W2PT; ++i) {",
             "      for (int i = 0; false && i < W2PT; ++i) {"))


_WIDEN = "auto widen = [&](int sl) {"
_K5B_NOW = (("w1_slice_bf16(a, id, st, pt);", ""),
            ("w2_slice_bf16<BM>(a, id, st, co0, pt);", ""))
_K5B_F32_NOW = (("w1_slice_f32(a, id, st, pt);", ""),
                ("w2_slice_f32<BM>(a, id, st, co0, pt);", ""))


_K5A_I8_NOX = (("      if (p.vec_x) {\n        // runs of 8 positions",
                "      return;\n      if (p.vec_x) {\n        // runs of 8 "
                "positions"),)
_K5A_I8_NOW = (("      {  // w1: kNBK rows of 8 chunks, one a thread",
                "      if (false) {  // w1: kNBK rows of 8 chunks"),
               ("        for (int e = pt; e < S::KB * kNBK * WCH2; "
                "e += kI8Producers) {",
                "        for (int e = pt; false; e += kI8Producers) {"))
_K5A_F32_NOW = (("      // w1: kNBK rows of 16 quads, two a thread\n#pragma unroll\n"
                 "      for (int i = 0; i < 2; ++i) {",
                 "      // w1: kNBK rows of 16 quads, two a thread\n#pragma unroll\n"
                 "      for (int i = 0; false && i < 2; ++i) {"),
                ("        for (int e = pt; e < BK * WQ2; e += kI8Producers) {",
                 "        for (int e = pt; false; e += kI8Producers) {"))
_K5A_I8_XNEAR = (("ok ? rx.col + rx.k[i].c * a.xs.c + h * a.xs.h +\n"
                  "                            w * a.xs.w\n"
                  "                      : a.x,",
                  "a.x + ((rx.k[i].c * a.xs.c + h * a.xs.h + w * a.xs.w)"
                  " & 56),"),)
_K5A_I8_NOEPI = (("          if (r >= p_hi) continue;\n"
                  "          float v = acc[mt][nt][2 * h + e] + b;\n"
                  "          if (a.relu1) v = v < 0.f ? 0.f : v;  // keeps NaN, as max(v, 0)\n"
                  "          mid[cml * a.RSTR + r] = v;",
                  "          if (r >= p_hi) continue;\n"
                  "          float v = acc[mt][nt][2 * h + e] + b;\n"
                  "          if (v == -12345.f) mid[cml * a.RSTR + r] = v;"),)
_K5A_I8_XZERO = (("            storage::bf16x8(*reinterpret_cast<const uint2*>(\n"
                  "                st + S::X8 + xr * KRA + 8 * xq));",
                  "            make_uint4(0u, 0u, 0u, 0u);"),)
_K5A_I8_NOSLAB = (("const float v = mid[ok ? koff + cbase[nt] : 0];",
                   "const float v = __int_as_float(0x3f800000 ^ "
                   "((koff + cbase[nt]) & 0x7fff));"),)


# K5a's float32 kernel (``cluster_stack_kernel``: the float32 build and
# the int8->fp32 build before it had a kernel of its own): every thread
# both copies (``conv1_pass``'s ``issue``, phase B's ``issue_w2``) and
# multiplies (``fmaf``)
_K5A32_NOX = (("    if (p.vec_x) {\n#pragma unroll\n      for (int i = 0; i < XI;",
               "    if (false) {\n#pragma unroll\n      for (int i = 0; i < XI;"),
              ("    } else {\n#pragma unroll\n      for (int i = 0; i < kBK * "
               "KRA / kThreads; ++i) {",
               "    } else if (false) {\n#pragma unroll\n      for (int i = 0; "
               "i < kBK * KRA / kThreads; ++i) {"))
_K5A32_NOW = (("    if (p.vec_w1) {  // kBK x kCM / 4 quads",
               "    if (false) {  // kBK x kCM / 4 quads"),
              ("    } else {\n#pragma unroll\n      for (int i = 0; i < kBK * "
               "kCM / kThreads; ++i) {",
               "    } else if (false) {\n#pragma unroll\n      for (int i = 0; "
               "i < kBK * kCM / kThreads; ++i) {"),
              ("      if (p.vec_w2) {\n#pragma unroll\n        for (int i = 0; "
               "i < kBK * TBM / 4 / kThreads; ++i) {",
               "      if (false) {\n#pragma unroll\n        for (int i = 0; "
               "i < kBK * TBM / 4 / kThreads; ++i) {"),
              ("      } else {\n#pragma unroll\n        for (int i = 0; "
               "i < kBK * TBM / kThreads; ++i) {",
               "      } else if (false) {\n#pragma unroll\n        for (int "
               "i = 0; i < kBK * TBM / kThreads; ++i) {"))
# its products as no-ops that read the operands an FMA would have read
NOFMA = """
namespace {
__device__ __forceinline__ float nofma(float a, float b, float c) {
  asm volatile("" : "+f"(c) : "f"(a), "f"(b));
  return c;
}
}  // namespace
"""
_K5A32_NOFMA = (("= fmaf(avv[i], bv[j]", "= nofma(avv[i], bv[j]"),
                ("= fmaf(av[i], bv[j]", "= nofma(av[i], bv[j]"))


def _nofma(text: str) -> str:
    """K5a's float32 products as ``nofma`` (``NOFMA`` goes in before the
    kernel's namespace, after the includes)."""
    at = text.index("namespace repro {\n")
    return text[:at] + NOFMA + _swap(text[at:], _K5A32_NOFMA)


def _swap(text: str, pairs) -> str:
    for old, new in pairs:
        if old not in text:
            raise SystemExit(f"K5a variant: {old!r} not found")
        text = text.replace(old, new)
    return text


def _nomma(text: str) -> str:
    """Every product a no-op (``NOMMA``, which goes in before the
    kernel's own namespace, after the includes)."""
    at = min(i for i in (text.find("namespace {\n"),
                         text.find("namespace repro {\n")) if i >= 0)
    return text[:at] + NOMMA + _MMA.sub("nomma(", text[at:]).replace(
        "mma::nomma(", "nomma(")


def _nocopy(text: str) -> str:
    """Each stage lambda returning at once; where the lambda itself waits
    for its stage to be free (``if (sl >= ...) bar_sync(...);``: the
    narrow and int8->fp32 K1 kernels), it still waits first, so the
    consumers' EMPTY arrivals keep meeting the producers'."""
    out, pos = [], 0
    for m in _STAGE.finditer(text):
        body = text[m.end():].partition("\n    };")[0]
        wait = _WAIT.search(body)
        out += [text[pos:m.end()], "\n      " + wait.group(1) if wait else "",
                "\n      return;"]
        pos = m.end()
    return "".join(out) + text[pos:]


def variants(src: Path) -> dict:
    text = src.read_text()
    if _HELPERS_END in text:
        return pool_variants(text)
    if not _MMA.search(text) or (not _STAGE.search(text)
                                 and _K5A_PASS not in text):
        raise SystemExit(f"{src}: no producer stage lambda, K5a issue "
                         "lambda or mma call")
    out = {"nomma": _nomma(text)}
    if _STAGE.search(text):
        nocopy = _nocopy(text)
        out.update(nocopy=nocopy, nocopy_nomma=_nomma(nocopy))
    if _K5A_PASS in text:
        out.update(nox=_swap(text, _K5A_NOX), now=_swap(text, _K5A_NOW))
    if _WIDEN in text:
        out["nowiden"] = text.replace(_WIDEN, _WIDEN + "\n      return;")
    if "w1_slice_bf16(a, id, st, pt);" in text:
        now = _swap(text, _K5B_NOW)
        if "w1_slice_f32(a, id, st, pt);" in text:
            now = _swap(now, _K5B_F32_NOW)
        out["now_k5b"] = now
    if "cluster_stack_kernel(" in text:
        out.update(nox_k5a32=_swap(text, _K5A32_NOX),
                   now_k5a32=_swap(text, _K5A32_NOW),
                   nofma_k5a32=_nofma(text))
    if "cluster_stack_i8bf16_kernel" in text:
        i8 = text.index("// ---- the int8->bf16 build: warp-specialised")
        head, tail = text[:i8], text[i8:]
        now = _swap(text, _K5A_I8_NOW)
        if "cluster_stack_i8f32_kernel" in text:
            now = _swap(now, _K5A_F32_NOW)
        out.update(nox_k5a=_swap(text, _K5A_I8_NOX),
                   now_k5a=now,
                   noslab_k5a=_swap(text, _K5A_I8_NOSLAB),
                   xnear_k5a=_swap(text, _K5A_I8_XNEAR),
                   noepi_k5a=head + _swap(tail, _K5A_I8_NOEPI),
                   xzero_k5a=_swap(text, _K5A_I8_XZERO))
    return out


def main(argv) -> int:
    if not argv:
        print(__doc__)
        return 2
    for arg in argv:
        src = Path(arg).resolve()
        if (REPO / "src" / "repro_torch") in src.parents:
            raise SystemExit(f"{src}: lies in the kernels' sources; copy the "
                             "tree under build/ first")
        for name, text in variants(src).items():
            out = src.with_name(f"{src.stem}_{name}.cu")
            out.write_text(text)
            print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
