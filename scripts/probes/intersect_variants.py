#!/usr/bin/env python3
"""K3 (sorted intersect mask) and K6 (set intersection counts) at their
main-path shapes, built with other tilings and with parts compiled out,
beside the kernels as the library builds them: K3 with other tile sizes
(``-DK3_THREADS``, ``-DK3_PER_THREAD``), without its shared-memory
searches (``-DK3_PROBE_NO_SEARCH``: the window search and copy alone) and
with only their first steps (``-DK3_PROBE_STEPS=n``); K6 with other
batch shapes (``-DK6_THREADS``, ``-DK6_ITEMS``), without its counting
(``-DK6_PROBE_NO_COUNT``: the loads and the staging alone) and with only
the searches' first steps (``-DK6_PROBE_STEPS=n``).  Timed as
``selfcheck.run_case`` times a kernel (L2 write-flushed device ms, CUDA
events around the call); each result says whether it equals the plain
version.  One JSON line a case.

Usage:  python scripts/probes/intersect_variants.py   (from the
        repository root; builds the probe libraries into build/probes)
"""

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))

NVCC = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                     "nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
K3_TILINGS = [(512, 2), (256, 4), (256, 8), (1024, 1), (256, 2)]
K6_SHAPES = [(256, 4), (128, 8), (128, 4), (256, 8), (512, 4)]
LIBS = ([(f"k3_{t}x{k}", "sorted_intersect.cu",
          [f"-DK3_THREADS={t}", f"-DK3_PER_THREAD={k}"])
         for t, k in K3_TILINGS]
        + [("k3_no_search", "sorted_intersect.cu", ["-DK3_PROBE_NO_SEARCH"])]
        + [(f"k3_steps_{n}", "sorted_intersect.cu", [f"-DK3_PROBE_STEPS={n}"])
           for n in (0, 4)]
        + [(f"k6_{t}x{i}", "set_intersect.cu",
            [f"-DK6_THREADS={t}", f"-DK6_ITEMS={i}"]) for t, i in K6_SHAPES]
        + [("k6_no_count", "set_intersect.cu", ["-DK6_PROBE_NO_COUNT"])]
        + [(f"k6_steps_{n}", "set_intersect.cu", [f"-DK6_PROBE_STEPS={n}"])
           for n in (0, 4)])


def build() -> dict:
    """Every probe library, one nvcc each, all started together."""
    out = ROOT / "build" / "probes"
    out.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        NVCC + ["-I", str(CSRC), *defs, "-o", str(out / f"lib{name}.so"),
                str(CSRC / src)]) for name, src, defs in LIBS}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {name}")
    return {name: ctypes.CDLL(str(out / f"lib{name}.so")) for name in procs}


def main() -> int:
    import torch
    from repro_torch.kernels import selfcheck as SC
    from repro_torch.kernels import columnar_ops as CO
    from repro_torch.kernels import fuzzy_ops as FO
    if not torch.cuda.is_available():
        print("intersect_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    libs = build()
    P_, L_, I_ = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name, lib in libs.items():
        if name.startswith("k3"):
            lib.rt_sorted_intersect.argtypes = [P_, L_, P_, L_, I_, P_, L_,
                                                P_]
        else:
            lib.rt_set_intersect.argtypes = [P_, P_, L_, P_, L_, L_, P_, P_]
    st = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    # main_path_cases' K3 and K6 inputs (seeds 2, 6 and 7)
    keys_np, n, cands_np = SC.k3_arrays(1 << 18, 1 << 16, 2)
    keys = torch.from_numpy(keys_np).to(dev)
    cands = torch.from_numpy(cands_np).to(dev)
    mask = torch.empty(keys.shape[0], dtype=torch.bool, device=dev)
    want3 = CO.sorted_intersect_plain(keys, n, cands)

    def k3(name):
        def run():
            rc = libs[name].rt_sorted_intersect(
                keys.data_ptr(), n, cands.data_ptr(), cands.shape[0], 0,
                mask.data_ptr(), mask.shape[0], st())
            assert rc == 0, rc
            return mask
        return run
    cases = [(f"k3 n=2^18 m=2^16 {name}", k3(name), want3)
             for name, _, _ in LIBS if name.startswith("k3")]
    cases.append(("k3 n=2^18 m=2^16 library build",
                  lambda: CO.sorted_intersect_cuda(keys, n, cands), want3))
    for P, s, seed in ((1 << 7, 32, 6), (1 << 17, 67, 7)):
        a, al, b = SC.k6_arrays(P, s, s, 1 << 20 if P < 1000 else 1 << 16,
                                seed)
        at, lt, bt = (torch.from_numpy(x).to(dev) for x in (a, al, b))
        cnt = torch.empty(P, dtype=torch.int64, device=dev)
        want6 = FO.inter_plain(at, lt, bt)

        def k6(name, at=at, lt=lt, bt=bt, cnt=cnt, P=P, s=s):
            def run():
                rc = libs[name].rt_set_intersect(
                    at.data_ptr(), lt.data_ptr(), s, bt.data_ptr(), s, P,
                    cnt.data_ptr(), st())
                assert rc == 0, rc
                return cnt
            return run
        cases += [(f"k6 P={P} S={s} {name}", k6(name), want6)
                  for name, _, _ in LIBS if name.startswith("k6")]
        cases.append((f"k6 P={P} S={s} library build",
                      lambda at=at, lt=lt, bt=bt: FO.inter_cuda(at, lt, bt),
                      want6))
    for label, fn, want in cases:
        t = SC._time_ms(fn, 50)
        t["equals_plain"] = bool(torch.equal(fn(), want))
        print(json.dumps({"case": label, "card": card, **t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
