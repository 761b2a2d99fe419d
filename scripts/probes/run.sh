#!/bin/bash
# Probes behind PERF.md's account of K8 and K2 (needs a CUDA card and nvcc):
# the card's mma.sync rates, K8's integer TF32 rounding against the cvt,
# K8 with parts of its tile loop compiled out and with each head-chunk size,
# and K2's time against its column count at two sizes.
# Usage: bash scripts/probes/run.sh [OUT_DIR]   (from the repository root)
set -e
out=${1:-build/probes}
mkdir -p "$out"
nvcc=${CUDA_HOME:-/usr/local/cuda}/bin/nvcc
flags="-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
$nvcc $flags -o "$out/mma_rate" scripts/probes/mma_rate.cu &
$nvcc $flags -o "$out/tf32_round" scripts/probes/tf32_round.cu &
# K8 built from patched copies of the sources (scripts/probes/patched.py):
# the library's own sources carry no probe switches
python scripts/probes/patched.py k8 "$out"
for part in all no_qk no_pv no_mma; do
  $nvcc $flags -I "$out/k8_$part/csrc" -DPART="\"$part\"" \
    -o "$out/k8_$part" scripts/probes/k8_parts.cu &
done
wait
"$out/mma_rate"
"$out/tf32_round"
for part in all no_qk no_pv no_mma; do "$out/k8_$part"; done
python scripts/probes/k8_head_chunks.py
python scripts/probes/k2_scaling.py
