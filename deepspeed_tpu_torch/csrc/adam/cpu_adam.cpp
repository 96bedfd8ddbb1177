// Host-resident Adam(W) kernel of DeepSpeedCPUAdam: the port's copy of
// the JAX package's csrc/adam/cpu_adam.cpp, the same arithmetic, so the
// two builds agree bit for bit (no contraction into FMAs under
// -std=c++17, and sqrt and division are correctly rounded in both the
// scalar and the vector forms).  The loop is written for the vectorizer:
// the AdamW/L2 choice is a template parameter, so the body has no branch,
// and `omp parallel for simd` gives each thread a contiguous range that
// it runs in vector lanes (with -fno-math-errno sqrtf needs no errno
// check, which would keep the loop scalar).  A C ABI for ctypes
// (ops/adam/cpu_adam.py), which passes the outputs as the inputs: every
// element is read before it is written, so the update runs in place on
// the pinned host master and moments.  `threads` > 0 sets the OpenMP
// team's size; 0 leaves it to OpenMP (OMP_NUM_THREADS, else every CPU).

#include <cmath>
#include <cstdint>

#include <omp.h>

namespace {

template <bool ADAMW>
void adam_loop(float* p_out, float* m_out, float* v_out, const float* p,
               const float* m, const float* v, const float* g, long long n,
               float lr, float beta1, float beta2, float eps,
               float weight_decay, float bc1, float bc2, int threads) {
#pragma omp parallel for simd schedule(static) num_threads(threads)
  for (long long i = 0; i < n; ++i) {
    float gi = g[i];
    float pi = p[i];
    if (!ADAMW) gi += weight_decay * pi;  // L2 mode: decay folded into grad
    float mi = beta1 * m[i] + (1.0f - beta1) * gi;
    float vi = beta2 * v[i] + (1.0f - beta2) * gi * gi;
    float denom = sqrtf(vi / bc2) + eps;
    float upd = (mi / bc1) / denom;
    if (ADAMW) upd += weight_decay * pi;  // AdamW: decoupled decay
    p_out[i] = pi - lr * upd;
    m_out[i] = mi;
    v_out[i] = vi;
  }
}

}  // namespace

extern "C" void ds_adam_step(
    float* p_out, float* m_out, float* v_out,
    const float* p, const float* m, const float* v, const float* g,
    long long n, float lr, float beta1, float beta2, float eps,
    float weight_decay, float bc1, float bc2, int adamw, int threads) {
  int team = threads > 0 ? threads : omp_get_max_threads();
  if (adamw)
    adam_loop<true>(p_out, m_out, v_out, p, m, v, g, n, lr, beta1, beta2,
                    eps, weight_decay, bc1, bc2, team);
  else
    adam_loop<false>(p_out, m_out, v_out, p, m, v, g, n, lr, beta1, beta2,
                     eps, weight_decay, bc1, bc2, team);
}
