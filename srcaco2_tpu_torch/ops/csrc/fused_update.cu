// The train step's optimizer as one multi-tensor pass, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's chain is optax under jit,
// which XLA fuses. The port ran the same chain eagerly, one leaf at a
// time (train/schedule.py, train/state.py): ~17 launches a leaf for the
// optimizer, the masked copy and the finite checks, and three blocking
// copies of host scalars a step. This pass does the finite checks, the
// chain (clip by global norm, L2 decay, Adam / AMSGrad or the SGD trace,
// the schedule), the masked update of the parameters, the EMA and the
// corruption flag in two launches (more only where the leaf table must
// be split), with every scalar read from and written to device memory.
//
// What bounds it on the card: bytes. Adam with weight decay over N f32
// parameters reads the grads, the parameters and both moments and
// writes the parameters and both moments, 28 N bytes (SwinIR x8: 11.6 M
// parameters, ~325 MB, ~0.1 ms at 3.35 TB/s); the check launch reads
// the grads once more (4 N bytes).
//
// Design. The leaves (one tensor per parameter) are cut into chunks of
// kChunk elements, each inside one leaf; one CTA takes one chunk. The
// table of leaf pointers and chunks is a kernel parameter (up to ~23 KB:
// CUDA >= 12.1 takes 32 KB of parameters), so the host builds it per step
// and no copy of it goes through device memory. The check launch writes
// one partial (a non-finite flag and the sum of squares) per CTA; the last
// CTA of the last check launch (a ticket counter) sums them in a fixed
// order and runs the scalar prologue: ok, the global norm, the counts
// advanced as optax's safe increment, the bias corrections and the
// learning rate from the counts. The update launch reads those scalars.
// Every operation is rounded as the eager chain rounds it, in its order
// and with no FMA contraction (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn; powf as torch's CUDA pow), so the pass equals the eager
// chain on the card but for the global norm's order of summation.
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kChunk = 16384;         // elements of one chunk (one CTA)
constexpr int kDepth = 6;             // grad, param, s1, s2, s3, ema
constexpr int kMaxLeaves = 320;       // leaves of one launch
constexpr int kMaxChunks = 1280;      // chunks (CTAs) of one launch
constexpr int kMaxMilestones = 16;
constexpr int kInt32Max = 2147483647;

// kind of the moment transform (ops/fused_update.py:KIND)
enum Kind { kPlain = 0, kAdam = 1, kAmsgrad = 2, kTrace = 3, kNesterov = 4 };
enum Sched { kMultiStep = 0, kMyStep = 1 };

struct Table {
  float* ptr[kDepth][kMaxLeaves];
  long long numel[kMaxLeaves];
  unsigned short chunk_leaf[kMaxChunks];   // the launch's leaf of a chunk
  unsigned short chunk_idx[kMaxChunks];    // the chunk's index in its leaf
  int n_chunks;
  int block0;                              // first partial of the launch
};

// The chain's constants, each rounded to f32 as the eager chain rounds
// the Python float it multiplies by (ops/fused_update.py:Hyper).
struct Hyper {
  int kind, clip_on, wd_on, ema_on;
  float max_norm, wd, b1, b2, omb1, omb2, eps, mom, ema_d, ema_omd;
  int sched_kind, step_size, warm, n_ms;
  float base_lr, gamma, min_lr, inv_warm;
  int ms[kMaxMilestones];
};

// The step's scalars in device memory (ops/fused_update.py:HEADER).
struct Header {
  unsigned int ticket;
  int ok, trigger, pad;
  float gnorm, bc1, bc2, step;
};

struct CheckArgs {
  const float* loss;
  int* adam_count;          // null without Adam
  int* sched_count;
  Header* hd;
  int* part_bad;
  float* part_ss;
  unsigned char* flags;     // (ok, corrupt) as torch.bool
  int final_launch, total_blocks;
};

__device__ __forceinline__ int safe_increment(int c) {
  return c < kInt32Max ? c + 1 : c;
}

// int32 arithmetic wraps as torch's does
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// torch.clamp / torch.maximum keep a NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// train/schedule.py:build_schedule at the count, in its roundings
__device__ float schedule_lr(const Hyper& h, int count) {
  float lr;
  if (h.sched_kind == kMyStep) {
    const float pw = powf(h.gamma, static_cast<float>(
        floor_div(count, h.step_size)));
    lr = nan_max(__fmul_rn(h.base_lr, pw), h.min_lr);
  } else {
    lr = h.base_lr;
    for (int i = 0; i < h.n_ms; ++i) {
      const int d = wrap_add(h.ms[i], -count);
      const float ind = d > 0 ? 1.f : 0.f;
      lr = __fadd_rn(__fmul_rn(lr, ind),
                     __fmul_rn(__fmul_rn(__fsub_rn(1.f, ind), h.gamma), lr));
    }
  }
  if (h.warm > 0) {
    // (count + 1) / warm: torch's CUDA division by a host scalar
    // multiplies by its f32 reciprocal
    const float w = __fmul_rn(static_cast<float>(wrap_add(count, 1)),
                              h.inv_warm);
    lr = __fmul_rn(lr, nan_min(w, 1.f));
  }
  return lr;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// the CTA's sum in a fixed order; every thread gets it
__device__ float block_sum(float v) {
  __shared__ float part[kThreads / 32];
  __shared__ float total;
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < kThreads / 32; ++i) s = __fadd_rn(s, part[i]);
    total = s;
  }
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kThreads) check_kernel(
    const __grid_constant__ Table t, const __grid_constant__ Hyper h,
    const __grid_constant__ CheckArgs a) {
  const int leaf = t.chunk_leaf[blockIdx.x];
  const long long start = static_cast<long long>(t.chunk_idx[blockIdx.x])
                          * kChunk;
  const int n = static_cast<int>(min(static_cast<long long>(kChunk),
                                     t.numel[leaf] - start));
  const float* g = t.ptr[0][leaf] + start;
  int bad = 0;
  float ss = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float v = g[i];
    bad |= !isfinite(v);
    if (h.clip_on) ss = __fadd_rn(ss, __fmul_rn(v, v));
  }
  bad = __syncthreads_or(bad);
  if (h.clip_on) ss = block_sum(ss);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    a.part_bad[t.block0 + blockIdx.x] = bad;
    a.part_ss[t.block0 + blockIdx.x] = ss;
    __threadfence();
    last = atomicAdd(&a.hd->ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  if (threadIdx.x == 0) a.hd->ticket = 0;
  if (!a.final_launch) return;

  // the last CTA: every partial of every check launch, in a fixed order
  int tb = 0;
  float ts = 0.f;
  for (int i = threadIdx.x; i < a.total_blocks; i += kThreads) {
    tb |= __ldcg(a.part_bad + i);
    ts = __fadd_rn(ts, __ldcg(a.part_ss + i));
  }
  tb = __syncthreads_or(tb);
  if (h.clip_on) ts = block_sum(ts);
  if (threadIdx.x != 0) return;
  const bool ok = !tb && isfinite(*a.loss);
  // a skipped step takes zero grads through the chain: norm 0, no clip
  const float gnorm = (h.clip_on && ok) ? __fsqrt_rn(ts) : 0.f;
  float bc1 = 1.f, bc2 = 1.f;
  if (a.adam_count) {
    const int c = safe_increment(*a.adam_count);
    *a.adam_count = c;
    bc1 = __fsub_rn(1.f, powf(h.b1, static_cast<float>(c)));
    bc2 = __fsub_rn(1.f, powf(h.b2, static_cast<float>(c)));
  }
  const int sc = *a.sched_count;
  *a.sched_count = safe_increment(sc);
  Header* hd = a.hd;
  hd->ok = ok;
  hd->trigger = !h.clip_on || gnorm < h.max_norm;
  hd->gnorm = gnorm;
  hd->bc1 = bc1;
  hd->bc2 = bc2;
  hd->step = __fmul_rn(-1.f, schedule_lr(h, sc));
  a.flags[0] = ok;
  a.flags[1] = 0;
}

__global__ void __launch_bounds__(kThreads) update_kernel(
    const __grid_constant__ Table t, const __grid_constant__ Hyper h,
    const Header* __restrict__ hd, unsigned char* __restrict__ flags) {
  const int leaf = t.chunk_leaf[blockIdx.x];
  const long long start = static_cast<long long>(t.chunk_idx[blockIdx.x])
                          * kChunk;
  const int n = static_cast<int>(min(static_cast<long long>(kChunk),
                                     t.numel[leaf] - start));
  float* __restrict__ G = t.ptr[0][leaf] + start;
  float* __restrict__ P = t.ptr[1][leaf] + start;
  float* __restrict__ S1 = t.ptr[2][leaf] + start;   // mu or trace
  float* __restrict__ S2 = t.ptr[3][leaf] + start;   // nu
  float* __restrict__ S3 = t.ptr[4][leaf] + start;   // nu_max
  float* __restrict__ E = t.ptr[5][leaf] + start;
  const bool ok = hd->ok, trigger = hd->trigger;
  const float gnorm = hd->gnorm, bc1 = hd->bc1, bc2 = hd->bc2,
              step = hd->step;
  const bool adam = h.kind == kAdam || h.kind == kAmsgrad;
  const bool trace = h.kind == kTrace || h.kind == kNesterov;
  int bad = 0;
  for (int base = threadIdx.x; base < n; base += kThreads * kUnroll) {
    float g[kUnroll], p[kUnroll], s1[kUnroll], s2[kUnroll], s3[kUnroll],
        e[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int i = base + j * kThreads;
      if (i >= n) continue;
      g[j] = ok ? G[i] : 0.f;
      p[j] = P[i];
      if (adam || trace) s1[j] = S1[i];
      if (adam) s2[j] = S2[i];
      if (h.kind == kAmsgrad) s3[j] = S3[i];
      if (h.ema_on) e[j] = E[i];
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int i = base + j * kThreads;
      if (i >= n) continue;
      float u = g[j];
      if (!trigger) u = __fmul_rn(__fdiv_rn(u, gnorm), h.max_norm);
      if (h.wd_on) u = __fadd_rn(u, __fmul_rn(h.wd, p[j]));
      if (adam) {
        const float m = __fadd_rn(__fmul_rn(h.omb1, u), __fmul_rn(h.b1, s1[j]));
        const float v = __fadd_rn(__fmul_rn(h.omb2, __fmul_rn(u, u)),
                                  __fmul_rn(h.b2, s2[j]));
        S1[i] = m;
        S2[i] = v;
        float vh = __fdiv_rn(v, bc2);
        if (h.kind == kAmsgrad) {
          vh = nan_max(s3[j], vh);
          S3[i] = vh;
        }
        u = __fdiv_rn(__fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(vh), h.eps));
      } else if (trace) {
        const float tr = __fadd_rn(u, __fmul_rn(h.mom, s1[j]));
        S1[i] = tr;
        u = h.kind == kNesterov ? __fadd_rn(u, __fmul_rn(h.mom, tr)) : tr;
      }
      u = __fmul_rn(step, u);
      const float pn = ok ? __fadd_rn(p[j], u) : p[j];
      P[i] = pn;
      bad |= !isfinite(pn);
      if (h.ema_on)
        E[i] = __fadd_rn(__fmul_rn(h.ema_d, e[j]), __fmul_rn(h.ema_omd, pn));
    }
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) flags[1] = 1;
}

}  // namespace

// C interface (bound with ctypes). `table` and `hyper` are host copies of
// Table and Hyper, passed to the kernel by value; the rest are device
// pointers. Each returns the CUDA error code of its launch (0 on success).
extern "C" int fused_update_check(const void* table, const void* hyper,
                                  const float* loss, int* adam_count,
                                  int* sched_count, void* header,
                                  int* part_bad, float* part_ss,
                                  unsigned char* flags, int final_launch,
                                  int total_blocks, void* stream) {
  Table t;
  Hyper h;
  std::memcpy(&t, table, sizeof(Table));
  std::memcpy(&h, hyper, sizeof(Hyper));
  const CheckArgs a{loss, adam_count, sched_count,
                    static_cast<Header*>(header), part_bad, part_ss, flags,
                    final_launch, total_blocks};
  check_kernel<<<t.n_chunks, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(t, h, a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_update_apply(const void* table, const void* hyper,
                                  const void* header, unsigned char* flags,
                                  void* stream) {
  Table t;
  Hyper h;
  std::memcpy(&t, table, sizeof(Table));
  std::memcpy(&h, hyper, sizeof(Hyper));
  update_kernel<<<t.n_chunks, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      t, h, static_cast<const Header*>(header), flags);
  return static_cast<int>(cudaGetLastError());
}

// The layout the Python side must mirror: kChunk, kDepth, kMaxLeaves,
// kMaxChunks, kMaxMilestones, sizeof(Table), sizeof(Hyper),
// sizeof(Header), offsetof(Table, numel), offsetof(Table, chunk_leaf),
// offsetof(Table, n_chunks).
extern "C" void fused_update_layout(long long* out) {
  const long long v[] = {kChunk, kDepth, kMaxLeaves, kMaxChunks,
                         kMaxMilestones, sizeof(Table), sizeof(Hyper),
                         sizeof(Header), offsetof(Table, numel),
                         offsetof(Table, chunk_leaf),
                         offsetof(Table, n_chunks)};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
}

extern "C" const char* swin_error_name(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
