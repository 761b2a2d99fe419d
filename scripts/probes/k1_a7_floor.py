#!/usr/bin/env python3
"""K1 (range mask) and A7 (bitset intersection counts) at their main-path
shapes, built with other tilings and with parts compiled out, beside the
kernels as the library builds them, and beside the floors of the work
they must do.  A tiling is a copy of the library's source with its
constants replaced (``LIBS``' patches, written under build/probes); a
part compiled out is a ``-D`` flag the source reads.  K1 with 16 rows a
lane, 128 threads a block, every column count through the kernel's
generic loop (its K <= 2 instantiations not dispatched) and without its
column loads (``-DK1_PROBE_NO_LOADS``: the grid and the mask stores
alone), at n = 16 (launch and one memory round), and
``stream_floor.cu``, which reads and writes K1's bytes with no other
work; A7 with the index loads and count stores alone
(``-DA7_PROBE_INDEX_ONLY``: no row gathers, no shuffles), with one or
two blocks an SM and 128 threads a block.  A7's cases are the clustered
and tags FuzzyJoins' operands with their live pairs
(``scripts/time_model_kernels.join_operands``) and 2**18 uniform
pairs.  Each case is timed as
``selfcheck.run_case`` times a kernel (``ms``: L2 write-flushed device
time; ``call_ms``: CUDA events around the call) and after a read-only
sweep (``ms_clean``, as ``time_model_kernels.clean_ms``); each result
says whether it equals the plain version.  One JSON line a case.

``--spans`` prints only what the joins' candidate order gives a block
of 512 consecutive pairs (the distinct rows it reads and the span from
its lowest row to its highest), counted on the host; it needs no card.

Usage:  python scripts/probes/k1_a7_floor.py [--spans]   (from the
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
sys.path.insert(0, str(ROOT / "scripts"))

NVCC = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                     "nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
# (name, source, -D flags, (text, replacement) patches of a copy)
_A7_RESIDENT = ("resident = b > 0 ? b : 1;",
                "resident = b < {0} ? (b > 0 ? b : 1) : {0};")
LIBS = [("k1", "range_mask.cu", [], []),
        ("k1_run16", "range_mask.cu", [],
         [("#define K1_RUN 8 ", "#define K1_RUN 16 ")]),
        ("k1_t128", "range_mask.cu", [],
         [("#define K1_THREADS 256", "#define K1_THREADS 128")]),
        ("k1_generic", "range_mask.cu", [],
         [("range_mask_kernel<1, ROWS><<<", "range_mask_kernel<0, ROWS><<<"),
          ("range_mask_kernel<2, ROWS><<<", "range_mask_kernel<0, ROWS><<<")]),
        ("k1_no_loads", "range_mask.cu", ["-DK1_PROBE_NO_LOADS"], []),
        ("a7", "bitset_intersect.cu", [], []),
        ("a7_index_only", "bitset_intersect.cu", ["-DA7_PROBE_INDEX_ONLY"],
         []),
        ("a7_resident1", "bitset_intersect.cu", [],
         [(_A7_RESIDENT[0], _A7_RESIDENT[1].format(1))]),
        ("a7_resident2", "bitset_intersect.cu", [],
         [(_A7_RESIDENT[0], _A7_RESIDENT[1].format(2))]),
        ("a7_t128", "bitset_intersect.cu", [],
         [("#define A7_THREADS 256", "#define A7_THREADS 128")])]
NAMES = {"k1": ("range_mask",), "a7": ("bitset_intersect",),
         "stream": ("stream_kernel",)}


def build() -> dict:
    """Every probe library, one nvcc each, all started together."""
    out = ROOT / "build" / "probes"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src, defs, patches in LIBS:
        path = CSRC / src
        if patches:
            text = path.read_text()
            for old, new in patches:
                if old not in text:
                    raise RuntimeError(f"{name}: {old!r} not in {src}")
                text = text.replace(old, new)
            path = out / f"{name}.cu"
            path.write_text(text)
        procs[name] = subprocess.Popen(
            NVCC + ["-I", str(CSRC), *defs, "-o",
                    str(out / f"lib{name}.so"), str(path)])
    procs["stream"] = subprocess.Popen(
        NVCC + ["-o", str(out / "libstream.so"),
                str(Path(__file__).with_name("stream_floor.cu"))])
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {name}")
    return {name: ctypes.CDLL(str(out / f"lib{name}.so")) for name in procs}


def spans(ai, bi, block: int = 512) -> dict:
    """Mean distinct rows and mean row span (highest - lowest + 1) of
    each run of ``block`` consecutive pairs."""
    import numpy as np
    distinct, span = [], []
    for s in range(0, ai.shape[0], block):
        rows = np.concatenate([ai[s:s + block], bi[s:s + block]])
        distinct.append(np.unique(rows).shape[0])
        span.append(int(rows.max() - rows.min()) + 1)
    return {"pairs_a_block": block, "distinct_rows": float(np.mean(distinct)),
            "row_span": float(np.mean(span))}


def main() -> int:
    import numpy as np
    import torch
    from repro_torch.kernels import columnar_ops as CO
    from repro_torch.kernels import fuzzy_ops as FO
    from repro_torch.kernels import selfcheck as SC
    from time_model_kernels import clean_ms, join_operands
    if "--spans" in sys.argv:
        for which in ("clustered", "tags"):
            bits, ai, bi = join_operands(FO, which)
            print(json.dumps({"join": which, "records": bits.shape[0],
                              "pairs": int(ai.shape[0]),
                              **spans(ai, bi)}))
        return 0
    if not torch.cuda.is_available():
        print("k1_a7_floor: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    libs = build()
    P_, L_, I_ = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name, lib in libs.items():
        if name.startswith("k1"):
            lib.rt_range_mask.argtypes = [P_, I_, L_, P_, P_]
        elif name == "stream":
            lib.rt_stream.argtypes = [P_, L_, P_, L_, I_, I_, P_]
        else:
            lib.rt_bitset_intersect.argtypes = [P_, L_, P_, P_, L_, P_, P_]
    st = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    cases = []
    for n, kinds in ((1 << 19, ["ts"]), (1 << 19, ["ts", "id"]), (16, ["ts"])):
        cols = SC._columns(np.random.default_rng(0), n, kinds, True, dev)
        descs = CO._descs(cols)
        out = torch.empty(n, dtype=torch.bool, device=dev)
        want = CO.range_mask_plain(cols, n)

        def k1(name, descs=descs, cols=cols, out=out, n=n):
            def run():
                rc = libs[name].rt_range_mask(ctypes.cast(descs, P_),
                                              len(cols), n, out.data_ptr(),
                                              st())
                assert rc == 0, rc
                return out
            return run
        cases += [(f"k1 n={n} K={len(kinds)} {name}", k1(name), want,
                   name != "k1_no_loads")
                  for name, *_ in LIBS if name.startswith("k1")]
        # the same bytes read (values and validity) and written (the mask)
        # by a bare stream, at K1's grid and at four blocks an SM
        n_in = sum(x.element_size() * n + n for x, _, _, _ in cols) // 16
        src = torch.zeros(max(n_in, 1) * 16, dtype=torch.uint8, device=dev)
        dst = torch.empty(max(n // 16, 1) * 16, dtype=torch.uint8,
                          device=dev)
        for blocks in (max(1, -(-n // 2048)), 528):
            def stream(blocks=blocks, src=src, dst=dst, n_in=n_in):
                def run():
                    rc = libs["stream"].rt_stream(
                        src.data_ptr(), n_in, dst.data_ptr(),
                        dst.shape[0] // 16, blocks, 256, st())
                    assert rc == 0, rc
                    return dst
                return run
            cases.append((f"stream n={n} K={len(kinds)} bytes "
                          f"{16 * n_in} + {dst.shape[0]} blocks {blocks}",
                          stream(), None, False))
    ops = []
    for which in ("clustered", "tags"):
        bits, ai, bi = join_operands(FO, which)
        rp = 1 << (bits.shape[0] - 1).bit_length()
        words = np.zeros((rp, bits.shape[1]), dtype=np.uint32)
        words[:bits.shape[0]] = bits
        ops.append((f"{which} join live", words, ai, bi))
    rng = np.random.default_rng(8)
    words = rng.integers(0, 2 ** 32, (1 << 12, 32), dtype=np.uint64)
    ops.append(("uniform 2^18", words.astype(np.uint32),
                rng.integers(0, 1 << 12, 1 << 18),
                rng.integers(0, 1 << 12, 1 << 18)))
    for label, words, ai, bi in ops:
        bt = torch.from_numpy(words.view(np.int32)).to(dev)
        at, ct = (torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64))
                  .to(dev) for x in (ai, bi))
        out = torch.empty(at.shape[0], dtype=torch.int64, device=dev)
        want = FO.popcount_plain(bt, at, ct)

        def a7(name, bt=bt, at=at, ct=ct, out=out):
            def run():
                rc = libs[name].rt_bitset_intersect(
                    bt.data_ptr(), bt.shape[1], at.data_ptr(), ct.data_ptr(),
                    at.shape[0], out.data_ptr(), st())
                assert rc == 0, rc
                return out
            return run
        full = f"a7 {label} R={bt.shape[0]} W={bt.shape[1]} P={at.shape[0]}"
        cases += [(f"{full} {name}", a7(name), want,
                   name != "a7_index_only")
                  for name, *_ in LIBS if name.startswith("a7")]
    for label, fn, want, exact in cases:
        t = SC._time_ms(fn, 50)
        t["ms_clean"] = clean_ms(fn, NAMES[label.split()[0]], 50)
        t["equals_plain"] = want is not None and bool(torch.equal(fn(),
                                                                  want))
        print(json.dumps({"case": label, "card": card, **t}), flush=True)
        if exact and not t["equals_plain"]:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
