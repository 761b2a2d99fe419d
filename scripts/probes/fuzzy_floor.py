#!/usr/bin/env python3
"""Floors under K4's sorted kernel and K5 at the fuzzy path's shapes:
kernels with their grids and memory traffic and none of their logic
(``fuzzy_floor.cu``), and the two kernels built with parts compiled out
(``-DTOCC_PROBE_NO_MISSES``: K4 without queueing what a window misses;
``-DTOCC_ROWS=...`` and the like: other tilings; ``-DED_PROBE_NO_DP``: K5's mask lookups without the
recurrence; ``-DED_PROBE_NO_PEQ``: without the mask table), timed as
``selfcheck.run_case`` times a kernel (L2 write-flushed device ms, and
CUDA events around the call), beside K4 and K5 themselves at the same
shapes.  One JSON line a case.

Usage:  python scripts/probes/fuzzy_floor.py   (from the repository root;
        builds the probe libraries into build/probes with nvcc)
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
# K4 tilings (rows a CTA, threads a CTA, CTAs an SM the registers must
# allow, positions a warp's chunk)
K4_TILINGS = [(256, 512, 1, 320), (256, 512, 2, 320), (512, 512, 2, 640),
              (512, 256, 1, 640), (1024, 512, 1, 1280)]
# (library, source, defines): the floors and the kernels' variants
LIBS = [("floor", Path(__file__).with_suffix(".cu"), []),
        ("k4_no_misses", CSRC / "t_occurrence.cu",
         ["-DTOCC_PROBE_NO_MISSES"])] + [
        (f"k4_tiling_{r}_{t}_{b}_{c}", CSRC / "t_occurrence.cu",
         [f"-DTOCC_ROWS={r}", f"-DTOCC_THREADS={t}",
          f"-DTOCC_MIN_BLOCKS={b}", f"-DTOCC_CHUNK={c}"])
        for r, t, b, c in K4_TILINGS] + [
        ("k5_no_dp", CSRC / "edit_distance.cu", ["-DED_PROBE_NO_DP"]),
        ("k5_no_peq", CSRC / "edit_distance.cu", ["-DED_PROBE_NO_PEQ"]),
        ("k5_no_dp_no_peq", CSRC / "edit_distance.cu",
         ["-DED_PROBE_NO_DP", "-DED_PROBE_NO_PEQ"])]


def build() -> dict:
    """Every probe library, one nvcc each, all started together."""
    out = ROOT / "build" / "probes"
    out.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        NVCC + ["-I", str(CSRC), *defs, "-o", str(out / f"lib{name}.so"),
                str(src)]) for name, src, defs in LIBS}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {name}")
    return {name: ctypes.CDLL(str(out / f"lib{name}.so")) for name in procs}


def main() -> int:
    import numpy as np
    import torch
    from repro_torch.kernels import selfcheck as SC
    from repro_torch.kernels import fuzzy_ops as FO
    if not torch.cuda.is_available():
        print("fuzzy_floor: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    libs = build()
    lib = libs["floor"]
    P, L, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name, args in (("probe_k4_store", [P, L, P]),
                       ("probe_k4_loads", [P, L, L, P, P]),
                       ("probe_k4_counts", [P, L, L, I, P, P]),
                       ("probe_k5_lens", [P, L, P, P]),
                       ("probe_k5_rows", [P, L, L, P, P]),
                       ("probe_k5_rows_warp", [P, P, L, L, P, P])):
        getattr(lib, name).argtypes = args
    for name in ("k5_no_dp", "k5_no_peq", "k5_no_dp_no_peq"):
        libs[name].rt_edit_distance.argtypes = [P, P, L, L, P, I, I, I, P,
                                                P, P]
    for name in ["k4_no_misses"] + [
            f"k4_tiling_{r}_{t}_{b}_{c}" for r, t, b, c in K4_TILINGS]:
        libs[name].rt_t_occurrence_sorted.argtypes = [P, I, L, L, I, P, P,
                                                      P]
    st = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    parts, T = SC.path_gram_segments(5, 1)
    segs = SC.dev_segments(parts, dev, True)
    k4 = SC._k4(segs, SC.PATH_USERS, 1 << 16, T, "ngram d=1")
    descs = FO._sorted_table(segs)
    n_out = 1 << 16
    pos = torch.cat([torch.from_numpy(p[a:b]) for p, a, b, _ in parts]
                    ).to(dev)
    m = int(pos.shape[0])
    mask = torch.empty(n_out, dtype=torch.uint8, device=dev)
    tiles = -(-SC.PATH_USERS // 256)
    names = list(SC.path_user_names(5))
    k5 = SC.k5_case(names, SC.PATH_QUERY, 3, dev)
    bp = FO._pow2_len(len(names))
    mat, lens = FO._char_matrix(names, bp)
    cand = torch.from_numpy(mat).to(dev)
    lt = torch.from_numpy(lens).to(dev)
    qc, _ = FO._code_points([SC.PATH_QUERY])
    qt = torch.from_numpy(qc.astype(np.int32)).to(dev)
    out = torch.empty(bp, dtype=torch.int64, device=dev)

    def k4_variant(name):
        return lambda: libs[name].rt_t_occurrence_sorted(
            ctypes.cast(descs, P), len(segs), SC.PATH_USERS, n_out, T, None,
            mask.data_ptr(), st())

    def k5_variant(name):
        return lambda: libs[name].rt_edit_distance(
            cand.data_ptr(), lt.data_ptr(), bp, mat.shape[1], qt.data_ptr(),
            int(qc.shape[0]), 4, 1, None, out.data_ptr(), st())
    cases = {
        "k4 store only (256 CTAs x 512)":
            lambda: lib.probe_k4_store(mask.data_ptr(), n_out, st()),
        f"k4 loads of the {m} hit positions ({tiles} CTAs) + store":
            lambda: lib.probe_k4_loads(pos.data_ptr(), m, tiles,
                                       mask.data_ptr(), st()),
        "k4 loads + shared-memory counts + mask phase":
            lambda: lib.probe_k4_counts(pos.data_ptr(), m, tiles, 0,
                                        mask.data_ptr(), st()),
        "k4 loads + counts + mask after a parameter-table read":
            lambda: lib.probe_k4_counts(pos.data_ptr(), m, tiles, 1,
                                        mask.data_ptr(), st()),
        "k4 sorted kernel without its miss queue":
            k4_variant("k4_no_misses"),
        "k4 sorted kernel, ngram d=1": k4["run"],
        **{f"k4 sorted kernel tiled {r} rows, {t} threads, {b} CTAs an SM, "
           f"chunk {c}": k4_variant(f"k4_tiling_{r}_{t}_{b}_{c}")
           for r, t, b, c in K4_TILINGS},
        "k5 lengths only (256 blocks x 256)":
            lambda: lib.probe_k5_lens(lt.data_ptr(), bp, out.data_ptr(),
                                      st()),
        "k5 lengths + rows to the length":
            lambda: lib.probe_k5_rows(cand.data_ptr(), lt.data_ptr(), bp,
                                      mat.shape[1], out.data_ptr(), st()),
        "k5 lengths + rows, the warp's rows loaded together":
            lambda: lib.probe_k5_rows_warp(cand.data_ptr(), lt.data_ptr(),
                                           bp, mat.shape[1], out.data_ptr(),
                                           st()),
        "k5 without the recurrence": k5_variant("k5_no_dp"),
        "k5 without the mask table": k5_variant("k5_no_peq"),
        "k5 without either": k5_variant("k5_no_dp_no_peq"),
        "k5 kernel, d=3": k5["run"],
    }
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    want = k4["plain"]()
    for label, fn in cases.items():
        t = SC._time_ms(fn, 50)
        if label.startswith("k4 sorted"):      # the mask each variant left
            mask.zero_()
            got = fn()
            got = got if isinstance(got, torch.Tensor) else mask
            t["equals_plain"] = bool(torch.equal(got.bool(), want))
        print(json.dumps({"case": label, "card": card, **t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
