// Batched PUCT descent: the whole walk from the root to a leaf, one game
// per thread, over game-minor [N, B] tree columns.
//
// Replaces: the Pallas TPU kernel _descend_kernel
//   (alphazero_general_tpu/ops/descend.py:44, pallas_call at :168).
//
// What it computes, per game b (MCTS.pyx:86-104, 208-217):
//   at node m, over the rows r < N-1 with parent[r] == m (the visited
//   children), score_c = q[r] + cpuct * ep[r] * sqrt(n[m]) / (1 + n[r]);
//   the unexpanded arm reads the rank-walk pointer (nba[m], nbp[m]) and
//   scores fpu + cpuct * nbp[m] * sqrt(n[m]), with
//   fpu = v[m] - fpu_reduction * sqrt(sum of the children's ep). An exact
//   tie goes to the unexpanded action; the walk stops at a new edge, a
//   terminal child or a child with n == 0.
//
// What bounds it on an H100: memory and latency. Each walk step scans the
// parent column of every row (N int32 loads per game and step) plus the
// q / ep / n of the children; the whole input is 9 columns of N x B x 4
// bytes (about 15 MB at N = 203, B = 2048), which the 50 MB L2 holds after
// the first step. The arithmetic is a few flops per row.
//
// What the design does about it: thread b owns game b, so a warp's loads of
// row r hit 32 consecutive words of the [N, B] column (coalesced), and the
// columns stay in L2 between steps. One thread per game with 128 threads a
// block gives 16 blocks at B = 2048, fewer than the 132 SMs: the card is
// under-filled, which a later redesign (a warp per game, or more games per
// launch) addresses.
//
// Arithmetic order matches the JAX kernel and the plain PyTorch version
// (ops/descend.py): children are visited in ascending row order, the seen
// policy is summed in that order, the first strictly larger score wins
// (jnp.argmax's first-max rule), and the library is compiled with
// --fmad=false so that no multiply-add is contracted into an FMA.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -3.0e38f;  // NEG_INF of the JAX kernel
constexpr int kThreads = 128;

__global__ void descend_kernel(const int32_t* __restrict__ parent,
                               const int32_t* __restrict__ parent_action,
                               const int32_t* __restrict__ n,
                               const float* __restrict__ q,
                               const float* __restrict__ v,
                               const float* __restrict__ edge_prior,
                               const float* __restrict__ eany,
                               const int32_t* __restrict__ nba,
                               const float* __restrict__ nbp,
                               int num_nodes, int batch, float cpuct,
                               float fpu_reduction,
                               int32_t* __restrict__ out_node,
                               int32_t* __restrict__ out_action,
                               int32_t* __restrict__ out_child,
                               int32_t* __restrict__ out_depth,
                               float* __restrict__ out_p_sel) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const size_t B = static_cast<size_t>(batch);

  int node = 0;
  int action = 0;
  int child = -1;
  int depth = 0;
  float p_sel = 0.0f;
  // An unvisited or terminal root keeps the initial outputs.
  bool done = (n[b] == 0) || (eany[b] > 0.5f);
  // A walk visits at most N distinct nodes; the cap only guards against a
  // corrupted tree turning into an endless loop.
  for (int step = 0; !done && step < num_nodes; ++step) {
    const size_t at = static_cast<size_t>(node) * B + b;
    const float sqrt_n = sqrtf(static_cast<float>(n[at]));
    float seen = 0.0f;
    float best_c = kNegInf;
    int c_star = 0;
    for (int r = 0; r < num_nodes - 1; ++r) {  // row N-1 is the sink
      const size_t rb = static_cast<size_t>(r) * B + b;
      if (parent[rb] != node) continue;
      const float ep = edge_prior[rb];
      seen = seen + ep;
      const float score =
          q[rb] + cpuct * ep * sqrt_n / (1.0f + static_cast<float>(n[rb]));
      if (score > best_c) {
        best_c = score;
        c_star = r;
      }
    }
    const float fpu = v[at] - fpu_reduction * sqrtf(fmaxf(seen, 0.0f));
    const float pv_u = nbp[at];
    const float best_u =
        pv_u >= 0.0f ? fpu + cpuct * pv_u * sqrt_n : kNegInf;
    if (best_c > best_u) {  // a visited child wins; ties go to the new edge
      const size_t cb = static_cast<size_t>(c_star) * B + b;
      action = parent_action[cb];
      child = c_star;
      p_sel = edge_prior[cb];
      done = (eany[cb] > 0.5f) || (n[cb] == 0);
      node = c_star;
    } else {
      action = nba[at];
      child = -1;
      p_sel = pv_u;
      done = true;
    }
    ++depth;
  }
  out_node[b] = node;
  out_action[b] = action;
  out_child[b] = child;
  out_depth[b] = depth;
  out_p_sel[b] = p_sel;
}

}  // namespace

// Plain C entry point (loaded with ctypes). All pointers are device pointers
// to contiguous [N, B] columns or [B] outputs; ``stream`` is a cudaStream_t.
// Returns the cudaError_t of the launch.
extern "C" int azg_descend(const void* parent, const void* parent_action,
                           const void* n, const void* q, const void* v,
                           const void* edge_prior, const void* eany,
                           const void* nba, const void* nbp, int num_nodes,
                           int batch, float cpuct, float fpu_reduction,
                           void* out_node, void* out_action, void* out_child,
                           void* out_depth, void* out_p_sel, void* stream) {
  const int blocks = (batch + kThreads - 1) / kThreads;
  descend_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(parent),
      static_cast<const int32_t*>(parent_action),
      static_cast<const int32_t*>(n), static_cast<const float*>(q),
      static_cast<const float*>(v), static_cast<const float*>(edge_prior),
      static_cast<const float*>(eany), static_cast<const int32_t*>(nba),
      static_cast<const float*>(nbp), num_nodes, batch, cpuct, fpu_reduction,
      static_cast<int32_t*>(out_node), static_cast<int32_t*>(out_action),
      static_cast<int32_t*>(out_child), static_cast<int32_t*>(out_depth),
      static_cast<float*>(out_p_sel));
  return static_cast<int>(cudaGetLastError());
}
