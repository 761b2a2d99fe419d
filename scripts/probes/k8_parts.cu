// K8 at the serve prefill's shape (model layout q [8, 512, 64, 128], k/v
// [8, 512, 8, 128], causal, float32), built against a copy of the
// repository's sources with parts of the tile loop patched out (S = QK^T,
// O += PV, both: scripts/probes/patched.py K8_NO_QK, K8_NO_PV): CUDA-event
// ms a call over 20 calls after 3 warm-up calls, zero inputs.  Build and
// run with scripts/probes/run.sh.
#include <cstdio>

#include "flash_attention.cu"

int main() {
  const int B = 8, Sq = 512, H = 64, KV = 8, hd = 128;
  const size_t nq = size_t(B) * Sq * H * hd, nk = size_t(B) * Sq * KV * hd;
  float *q, *k, *v, *o;
  cudaMalloc(&q, sizeof(float) * nq);
  cudaMalloc(&o, sizeof(float) * nq);
  cudaMalloc(&k, sizeof(float) * nk);
  cudaMalloc(&v, sizeof(float) * nk);
  cudaMemset(q, 0, sizeof(float) * nq);
  cudaMemset(k, 0, sizeof(float) * nk);
  cudaMemset(v, 0, sizeof(float) * nk);
  const int64_t qst[3] = {int64_t(Sq) * H * hd, H * hd, hd};
  const int64_t kst[3] = {int64_t(Sq) * KV * hd, KV * hd, hd};
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  int rc = 0;
  for (int i = 0; i < 23; ++i) {
    if (i == 3) cudaEventRecord(e0);
    rc |= rt_flash_attention(q, k, v, o, MT_F32, B, H, KV, Sq, Sq, hd, qst,
                             kst, qst, 1, 0, 0.08838835f, 8, nullptr,
                             nullptr);
  }
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const cudaError_t e = cudaGetLastError();
  printf("k8_parts %s: %.4f ms a call (rc %d, %s)\n", PART, ms / 20, rc,
         cudaGetErrorString(e));
  return rc == 0 && e == cudaSuccess ? 0 : 1;
}
