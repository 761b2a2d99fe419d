#!/usr/bin/env python3
"""Where a tile's time goes inside K8's float32 backward kernels, at the
train step's shape (q [2, 2048, 64, 128], k/v [2, 2048, 8, 128], causal):
a patched copy of the sources (``patched.patched_csrc``, under
``build/probes/k8b_clock``) in which lane 0 of each warpgroup reads
``clock64()`` at the phase boundaries of every tile and adds the cycles to
a device array, by kernel, warpgroup and phase:

  0 wait    loop top to the tile's TMA load landed (lse / D staging too)
  1 split   the tile split into hi and lo, as loaded and transposed, and
            the barrier after it
  2 prod1   S^T and dP^T (dK/dV kernel) or S and dP (dQ kernel) issued and
            waited for
  3 hand    P^T (or P and dP) handed over through shared memory, with its
            barrier
  4 prod2   dS formed, dV / dK (or dQ) products issued and waited for
  5 end     the barrier that closes the tile
  6 fold    the accumulator fold every 32 tiles

Prints cycles a tile by phase (the sum over CTAs over the tiles counted)
and each phase's share; the SM clock the card reports (``nvidia-smi``
``clocks.sm`` right after the run, which may differ from the clock during
it) turns cycles into µs.  The atomics add a few cycles a phase.  Three
builds, timed in turn: ``all`` (the kernels as they are), ``no_mask`` (P
without its masks) and ``bare_p`` (P = S / 2: no mask, exp or lse); the
last two give wrong gradients by design.

Usage:  python scripts/probes/k8_bwd_clock.py
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from patched import patched_csrc, use_csrc  # noqa: E402

KEEP = ("flash_attention.cu", "flash_attention_bwd.cu", "range_mask.cu")
PHASES = ("wait", "split", "prod1", "hand", "prod2", "end", "fold")

HEAD = '#include "tf32_wgmma.cuh"\n'
CLOCK = HEAD + r'''
__device__ unsigned long long k8b_clk[2][2][8];   // [kernel][wg][phase]
#define K8B_T(k, n)                                                        \
  do {                                                                     \
    const long long now_ = clock64();                                      \
    if ((threadIdx.x & 127) == 0)                                          \
      atomicAdd(&k8b_clk[k][threadIdx.x >> 7][n],                          \
                static_cast<unsigned long long>(now_ - last_));            \
    last_ = now_;                                                          \
  } while (0)
#define K8B_TILE(k)                                                        \
  if ((threadIdx.x & 127) == 0) atomicAdd(&k8b_clk[k][threadIdx.x >> 7][7], 1ull)
extern "C" int k8b_clk_io(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[32] = {};
    return static_cast<int>(cudaMemcpyToSymbol(k8b_clk, z, sizeof(z)));
  }
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, k8b_clk, sizeof(k8b_clk)));
}
'''


def _after(text: str, add: str):
    return (text, text + add)


PATCHES = {"flash_attention_bwd.cu": [
    (HEAD, CLOCK),
    # the dK/dV kernel (0)
    _after("  for (int j = 0; j < ntiles; ++j) {\n"
           "    const int q0 = (qt0 + j % per_head) * QTW;\n",
           "    long long last_ = clock64();\n"),
    _after("    mbar_wait(full, (j + 1) & 1);\n", "    K8B_T(0, 0);\n"),
    ("the split one set\n    if (tid == TMA_TID && j + 1 < ntiles) "
     "issue(j + 1);\n"
     "\n    // ---- S^T = K Q^T",
     "the split one set\n    K8B_T(0, 1);\n    if (tid == TMA_TID && j + 1 < "
     "ntiles) issue(j + 1);\n\n    // ---- S^T = K Q^T"),
    _after("                C::QBLK);\n", "    K8B_T(0, 2);\n"),
    ("    __syncthreads();\n    if (wg == 1) {                   // dS^T",
     "    __syncthreads();\n    K8B_T(0, 3);\n    if (wg == 1) {        "
     "           // dS^T"),
    _after("               sb + (wg ? C::O_QTL : C::O_DTL));\n",
           "    K8B_T(0, 4);\n"),
    ("is done with the tile\n    if ((j + 1) % FOLD_TILES == 0 && j + 1 < "
     "ntiles)\n      fold<HD>(",
     "is done with the tile\n    K8B_T(0, 5);\n    if ((j + 1) % FOLD_TILES"
     " == 0 && j + 1 < ntiles)\n      fold<HD>("),
    _after("      fold<HD>(acc, rows, t, j + 1 == FOLD_TILES, false, 1.f);\n",
           "    K8B_T(0, 6);\n    K8B_TILE(0);\n"),
    # the dQ kernel (1)
    _after("  for (int j = 0; j < ntiles; ++j) {\n"
           "    const int c0 = j * KTW;\n",
           "    long long last_ = clock64();\n"),
    _after("    mbar_wait(full, j & 1);\n", "    K8B_T(1, 0);\n"),
    ("the split one set\n    if (tid == TMA_TID && j + 1 < ntiles) "
     "issue(j + 1);\n"
     "\n    // ---- S = Q K^T",
     "the split one set\n    K8B_T(1, 1);\n    if (tid == TMA_TID && j + 1 < "
     "ntiles) issue(j + 1);\n\n    // ---- S = Q K^T"),
    _after("                C::KBLK);\n", "    K8B_T(1, 2);\n"),
    ("    __syncthreads();\n    // both warpgroups form the same dS",
     "    __syncthreads();\n    K8B_T(1, 3);\n    // both warpgroups form the"
     " same dS"),
    _after("    prod_t<HD / 2>(acc, s, sb + C::O_KTH + ho, sb + C::O_KTL + "
           "ho);\n", "    K8B_T(1, 4);\n"),
    ("is done with the tile\n    if ((j + 1) % FOLD_TILES == 0 && j + 1 < "
     "ntiles)\n      fold<HD / 2>(",
     "is done with the tile\n    K8B_T(1, 5);\n    if ((j + 1) % FOLD_TILES"
     " == 0 && j + 1 < ntiles)\n      fold<HD / 2>("),
    _after("      fold<HD / 2>(acc, rows, t, j + 1 == FOLD_TILES, false, "
           "1.f);\n", "    K8B_T(1, 6);\n    K8B_TILE(1);\n"),
]}


_P_KV = ("        s[e] = ex2(masked(vis, fmaf(s[e], sl2, -st[2 * (e >> 2) + "
         "(e & 1)])));\n")
_P_Q = "        s[e] = ex2(masked(vis, fmaf(s[e], sl2, -lr[(e >> 1) & 1])));\n"
VARIANTS = {
    "all": [],
    "no_mask": [(_P_KV, "        s[e] = ex2(fmaf(s[e], sl2, -st[2 * (e >> 2)"
                        " + (e & 1)]));\n"),
                (_P_Q, "        s[e] = ex2(fmaf(s[e], sl2, -lr[(e >> 1) & 1]"
                       "));\n")],
    "bare_p": [(_P_KV, "        s[e] = s[e] * 0.5f;\n"),
               (_P_Q, "        s[e] = s[e] * 0.5f;\n")]}


def csrc(name: str) -> Path:
    dst = patched_csrc(f"k8b_clock_{name}", {"flash_attention_bwd.cu":
                       PATCHES["flash_attention_bwd.cu"] + VARIANTS[name]})
    for p in dst.glob("*.cu"):
        if p.name not in KEEP:
            p.unlink()
    return dst


def main() -> int:
    if len(sys.argv) == 1:
        for name in VARIANTS:
            csrc(name)
        builds = [subprocess.Popen([sys.executable, __file__, name, "build"])
                  for name in VARIANTS]
        if any(p.wait() != 0 for p in builds):
            return 1
        for name in VARIANTS:
            rc = subprocess.run([sys.executable, __file__, name,
                                 "time"]).returncode
            if rc != 0:
                return rc
        return 0
    import torch
    if not torch.cuda.is_available():
        print("k8_bwd_clock: no CUDA device", file=sys.stderr)
        return 2
    name = sys.argv[1]
    from repro_torch.kernels import ops
    from repro_torch.kernels import selfcheck as SC
    use_csrc(ops, ROOT / "build" / "probes" / f"k8b_clock_{name}" / "csrc")
    if sys.argv[2] == "build":
        return 0
    lib = ops.lib()
    io = lib.k8b_clk_io
    io.restype = ctypes.c_int
    io.argtypes = [ctypes.c_void_p, ctypes.c_int]
    case = SC.train_cases(torch.device("cuda", 0))[1]
    case["run"]()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 32)()
    ops.check(io(None, 1), "k8b_clk reset")
    case["run"]()
    torch.cuda.synchronize()
    ops.check(io(ctypes.addressof(buf), 0), "k8b_clk read")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}; variant {name}")
    for k, kernel in enumerate(("flash_bwd_kv_wg_kernel<128>",
                                "flash_bwd_q_wg_kernel<128>")):
        for wg in range(2):
            base = (k * 2 + wg) * 8
            tiles = buf[base + 7]
            cyc = [buf[base + i] / max(tiles, 1) for i in range(7)]
            total = sum(cyc)
            print(json.dumps({
                "kernel": kernel, "warpgroup": wg, "tiles": tiles,
                "cycles_a_tile": round(total, 1),
                "by_phase": {p: round(c, 1) for p, c in zip(PHASES, cyc)},
                "share": {p: round(c / total, 3) if total else 0.0
                          for p, c in zip(PHASES, cyc)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
