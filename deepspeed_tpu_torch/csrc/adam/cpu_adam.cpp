// Host-resident Adam(W) kernel of DeepSpeedCPUAdam: the port's copy of
// the JAX package's csrc/adam/cpu_adam.cpp, the same arithmetic, so the
// two builds agree bit for bit with the same compiler and flags.
// Vectorization is left to the compiler (-O3 -march=native), parallelism
// to OpenMP.  A C ABI for ctypes (ops/adam/cpu_adam.py), which passes
// the outputs as the inputs: every element is read before it is written,
// so the update runs in place on the pinned host master and moments.

#include <cmath>
#include <cstdint>

extern "C" void ds_adam_step(
    float* p_out, float* m_out, float* v_out,
    const float* p, const float* m, const float* v, const float* g,
    long long n, float lr, float beta1, float beta2, float eps,
    float weight_decay, float bc1, float bc2, int adamw) {
#pragma omp parallel for schedule(static)
  for (long long i = 0; i < n; ++i) {
    float gi = g[i];
    float pi = p[i];
    if (!adamw) gi += weight_decay * pi;  // L2 mode: decay folded into grad
    float mi = beta1 * m[i] + (1.0f - beta1) * gi;
    float vi = beta2 * v[i] + (1.0f - beta2) * gi * gi;
    float denom = sqrtf(vi / bc2) + eps;
    float upd = (mi / bc1) / denom;
    if (adamw) upd += weight_decay * pi;  // AdamW: decoupled decay
    p_out[i] = pi - lr * upd;
    m_out[i] = mi;
    v_out[i] = vi;
  }
}
