"""Time text-edited variants of csrc/win_ffn.cu's bf16 FFN (B2c) on the card:
what its design's parts cost, the measurements its header cites.

Each variant is this commit's source with a few lines replaced (a part
taken out, or one choice made the other way), built by nvcc into a
temporary directory and called through its C entry point at the served
shape, (256, 448, 128) tokens with F = 1024, in turns with the others (two
rounds, CUDA events). The outputs of the variants that take a part out are
wrong by design: only their times mean anything. ``base`` is held to the
plain version. The ``spans`` variants also record clock64() spans of each
warpgroup of the first 16 blocks: the GELU, the wait for the next slot,
the wait for the turn, the issue of the products and the wait for them.

    python -m color_transfer_tpu_torch.tools.ffn_variants [--only REGEX]

One JSON line a variant and round, then one a sampled warpgroup's spans.
"""

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from color_transfer_tpu_torch.ops import _build

GELU = "        pa[ks][u] = gelu_pair(h[e], h[e + 1]);"
NO_GELU = [(GELU, "        pa[ks][u] = pack_bf16(h[e], h[e + 1]);")]
P1 = ("      wgmma_64x64x16_tb(h, x_lo + (ks >> 2) * (kXPartB >> 4) + 2 * (ks & 3),\n"
      "                        w0_lo + s * kSlotStep + ks * kKStep, ks > 0);")
P2 = ("      wgmma_64x128x16_rs_tb(out, pa[ks], w2_lo + s * kSlotStep + ks * kKStep,"
      " c > 0 || ks > 0);")
NO_PRODUCTS = [(P1, "      h[ks] += 1e-3f;"),
               (P2, "      out[ks] += __uint_as_float(pa[ks][0] ^ pa[ks][3]) * 1e-30f;")]
NO_PINGPONG = [("  auto turn = [&] { bar_sync(3 + wg, 256); };\n"
                "  auto pass_turn = [&] { bar_arrive(3 + (wg ^ 1), 256); };",
                "  auto turn = [&] {};\n  auto pass_turn = [&] {};"),
               ("  if (wg == 1) bar_arrive(3, 256);  // warpgroup 0 takes the first turn\n", ""),
               ("  if (wg == 0) bar_sync(3, 256);  // warpgroup 1's last hand-over\n", "")]
FRCP = [("rcp_rn(1.f + 0.3275911f * az)", "__frcp_rn(1.f + 0.3275911f * az)")]
SPANS = [
    ("namespace {\n\nusing namespace win;",
     "__device__ long long g_spans[256];\nnamespace {\n\nusing namespace win;"),
    ("  float out[64], h[32];\n",
     "  float out[64], h[32];\n  long long tg = 0, tr = 0, tt = 0, ti = 0, tw = 0, t0 = clock64();\n"),
    ("    uint32_t pa[4][4];  // gelu(h) in bf16: the A fragments of its 4 k-steps\n",
     "    long long q0 = clock64();\n"
     "    uint32_t pa[4][4];  // gelu(h) in bf16: the A fragments of its 4 k-steps\n"),
    ("    if (more) mbar_wait(full + sn, ((c + 1) / kSlotsB) & 1);\n    turn();\n",
     "    long long q1 = clock64();\n    if (more) mbar_wait(full + sn, ((c + 1) / kSlotsB) & 1);\n"
     "    long long q2 = clock64();\n    turn();\n    long long q3 = clock64();\n"),
    ("    wgmma_commit();\n    pass_turn();\n    wgmma_wait<0>();\n",
     "    wgmma_commit();\n    pass_turn();\n    long long q4 = clock64();\n    wgmma_wait<0>();\n"
     "    long long q5 = clock64();\n"
     "    tg += q1 - q0; tr += q2 - q1; tt += q3 - q2; ti += q4 - q3; tw += q5 - q4;\n"),
    ("  // out rounded to bf16, LayerNorm, the residual",
     "  if (blockIdx.x < 16 && (threadIdx.x & 127) == 0) {\n"
     "    long long* o = g_spans + (blockIdx.x * 2 + wg) * 8;\n"
     "    o[0] = tg; o[1] = tr; o[2] = tt; o[3] = ti; o[4] = tw; o[5] = clock64() - t0;\n  }\n"
     "  // out rounded to bf16, LayerNorm, the residual"),
    ("// Shared memory a bf16 FFN block asks for",
     "extern \"C\" int ffn_spans(long long* d) {\n"
     "  return cudaMemcpyFromSymbol(d, g_spans, sizeof(g_spans));\n}\n\n"
     "// Shared memory a bf16 FFN block asks for"),
]
VARIANTS = {
    "base": [],
    "no_gelu": NO_GELU,
    "no_products": NO_PRODUCTS,
    "neither": NO_PRODUCTS + NO_GELU,
    "no_pingpong": NO_PINGPONG,
    "frcp_branch": FRCP,
    "spans": SPANS,
    "spans_no_gelu": SPANS + NO_GELU,
}
SPAN_NAMES = ("gelu", "slot", "turn", "issue", "wait", "total")


def variant_source(edits):
    src = (_build.CSRC_DIR / "win_ffn.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise ValueError(f"win_ffn.cu no longer has the line(s) a variant edits: {old!r}")
        src = src.replace(old, new)
    return src


def build(name, out_dir):
    cu = out_dir / f"{name}.cu"
    cu.write_text(variant_source(VARIANTS[name]))
    lib = out_dir / f"lib{name}.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr[-4000:]}")
    regs = re.findall(r"Function properties for \S*ffn_bf16_kernel\S*\n\s*(.*)\n.*?Used (\d+) registers",
                      proc.stdout + proc.stderr)
    return name, lib, regs


def main(argv=None):
    from color_transfer_tpu_torch.ops import win_attention as wn
    from color_transfer_tpu_torch.tools.kernel_ab import _time_ms

    ap = argparse.ArgumentParser(prog="color_transfer_tpu_torch.tools.ffn_variants")
    ap.add_argument("--only", default=None, help="the variants whose name matches this regex")
    args = ap.parse_args(argv)
    names = [n for n in VARIANTS if args.only is None or re.search(args.only, n)]
    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="ffn_variants_"))
    try:
        for header in _build.CSRC_DIR.glob("*.cuh"):
            shutil.copy(header, tmp)
        with ThreadPoolExecutor(len(names)) as pool:
            built = list(pool.map(lambda n: build(n, tmp), names))
        g = torch.Generator().manual_seed(0)
        shape, c, f = (256, 448, 128), 128, 1024
        xs, xm = (torch.randn(*shape, generator=g).to(device, torch.bfloat16) for _ in range(2))
        w0 = (torch.randn(2 * c, f, generator=g) / (2 * c) ** 0.5).to(device, torch.bfloat16)
        w2 = (torch.randn(f, c, generator=g) / f**0.5).to(device, torch.bfloat16)
        ns = (1 + 0.1 * torch.randn(c, generator=g)).to(device)
        nb = (0.1 * torch.randn(c, generator=g)).to(device)
        out = torch.empty_like(xs)
        n = shape[0] * shape[1]
        libs = {}
        for name, lib, regs in built:
            libs[name] = ctypes.CDLL(str(lib))
            fn = libs[name].ffn_forward_bf16
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
            print(json.dumps({"variant": name, "build": regs}), flush=True)
        for rnd in range(2):
            for name in names:
                fn = libs[name].ffn_forward_bf16

                def call():
                    err = fn(xs.data_ptr(), xm.data_ptr(), w0.data_ptr(), w2.data_ptr(),
                             ns.data_ptr(), nb.data_ptr(), out.data_ptr(), n, f, 1,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"variant {name}: CUDA error {err}")

                row = {"variant": name, "round": rnd, "ms": round(_time_ms(call, device, 30), 4)}
                if name == "base":
                    want = wn.ffn_plain(xs, xm, w0, w2, ns, nb, add_residual=True)
                    row["max_abs_err"] = float((out.float() - want.float()).abs().max())
                print(json.dumps(row), flush=True)
        for name in names:
            if name.startswith("spans"):
                buf = (ctypes.c_longlong * 256)()
                if libs[name].ffn_spans(buf):
                    raise RuntimeError("ffn_spans failed")
                for blk in (0, 5, 10, 15):
                    for wg in range(2):
                        o = list(buf)[(blk * 2 + wg) * 8:(blk * 2 + wg) * 8 + 6]
                        print(json.dumps({"variant": name, "block": blk, "warpgroup": wg,
                                          "clocks": dict(zip(SPAN_NAMES, o))}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
