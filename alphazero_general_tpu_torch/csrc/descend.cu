// Batched PUCT descent: the whole walk from the root to a leaf, one warp per
// game, over the tree columns in either of the port's layouts: game-minor
// [N, B] (descend_kernel, entry point azg_descend) or batch-major [B, N]
// (descend_rows_kernel, azg_descend_rows). Both read the columns where
// they lie; only the indexing (layout.cuh) and the staging differ.
//
// Replaces: the Pallas TPU kernel _descend_kernel
//   (alphazero_general_tpu/ops/descend.py:44, pallas_call at :168), reached
//   through descend_batched_t (:212, game-minor) and, on batch-major
//   columns that it transposes to [N, B] first, descend_batched_pallas
//   (:198) with its wrapper descend_batched (:226).
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
// What bounds it on an H100: latency, not bytes or operations. The bytes a
// walk needs are its game's parent column once (rows 0..N-2, to find the
// children of each node it passes) and a few values of the nodes on its
// path and their children: about 2 MB at N = 203, B = 2048, well under a
// microsecond at 3.35 TB/s. But each walk step depends on the last one (the
// node's children are known only once the node is), so a game's time is a
// chain of dependent memory round trips, and the launch itself costs a few
// microseconds. A simple form with one thread per game (16 blocks of 128 at
// B = 2048 on 132 SMs) rescanned the parent column from global memory at
// every step, a chain of N dependent-in-order loads per step.
//
// What this design does about it:
// - A block takes G neighbouring games (G = 8 when it fits: 8 int32 of one
//   [N, B] row are one 32-byte sector), one warp per game: 256 blocks of
//   256 threads at B = 2048, enough to fill the card.
// - The block first copies the parent links of rows 0..N-2 of its games
//   into shared memory, game-major, with coalesced loads: the column is
//   read from global memory once, as the bound counts it. Game-minor, that
//   is parent[0:N-1, b0:b0+G], read in 16-byte vectors where B % 4 == 0
//   and the column is aligned, in scalars otherwise. Batch-major, the G
//   games' rows are one contiguous run of G * N ints, read in scalars with
//   consecutive threads on consecutive addresses (a game's row starts at a
//   16-byte boundary only when N % 4 == 0; N = 403 at the production
//   config with tree reuse). That copy ends in the kernel's only
//   __syncthreads(); each warp then walks its game alone.
// - At each step the 32 lanes scan the staged rows 32 at a time and
//   __ballot_sync marks the children of the node; up to 32 children at a
//   time are listed (ascending rows) and each lane loads q, n, edge_prior,
//   parent_action and eany of one of them, so a step costs one round of
//   global loads however many children there are. The node's own v, nbp
//   and nba are loaded at the start of the step and arrive during the scan.
// - n, q and edge_prior are not staged: staging them would read three more
//   whole columns, where a walk needs a few rows of each.
// - The wrapper (ops/descend.py) picks G from N so that the staged rows
//   fit in the 227 KB of shared memory a block may have: G = 8 up to
//   N = 7233, G = 1 up to N = 58081; above 48 KB the entry point raises the
//   kernel's dynamic shared memory limit first.
//
// Bit-exact with the plain PyTorch version (ops/descend.py) and the JAX
// kernel: the listed children are taken one at a time in ascending row
// order, by shuffles, so the seen-policy sum adds them in that order and
// the best child is the first strictly larger score (jnp.argmax's rule:
// the lowest row among equal scores); a score keeps the evaluation order
// q + ((cpuct * ep) * sqrt_n) / (1 + n); an exact tie with the unexpanded
// arm goes to the arm (best_c > best_u); the library is compiled with
// --fmad=false and IEEE sqrtf and division, so no multiply-add is
// contracted into an FMA.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "layout.cuh"

namespace {

using azg::BatchMajor;
using azg::GameMinor;

constexpr float kNegInf = -3.0e38f;  // NEG_INF of the JAX kernel
constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;

// Dynamic shared memory of a block of ``games`` games: the staged parent
// rows 0..N-2 of each game (int32[games][N-1]), then a list of 32 child
// rows per warp. ops/descend.py's staged_bytes is the same formula.
constexpr size_t smem_bytes(int num_nodes, int games) {
  return sizeof(int32_t) * static_cast<size_t>(games) *
         static_cast<size_t>(num_nodes - 1 + kWarp);
}

// Stage parent[0:rows, b0:b0+G] of game-minor columns as
// staged[g * rows + r]; games past the batch get -1 (no children).
template <int G>
__device__ __forceinline__ void stage_game_minor(
    const int32_t* __restrict__ parent, int32_t* smem, int rows, int batch,
    int b0) {
  const size_t B = static_cast<size_t>(batch);
  bool staged = false;
  if constexpr (G % 4 == 0) {
    if (batch % 4 == 0 &&
        (reinterpret_cast<uintptr_t>(parent) & 15u) == 0) {
      constexpr int kVecs = G / 4;  // 16-byte vectors per row segment
      for (int i = threadIdx.x; i < rows * kVecs; i += G * kWarp) {
        const int r = i / kVecs;
        const int g = (i - r * kVecs) * 4;
        int4 x = make_int4(-1, -1, -1, -1);
        if (b0 + g < batch) {  // B % 4 == 0: the whole vector is in range
          x = *reinterpret_cast<const int4*>(parent + r * B + b0 + g);
        }
        smem[(g + 0) * rows + r] = x.x;
        smem[(g + 1) * rows + r] = x.y;
        smem[(g + 2) * rows + r] = x.z;
        smem[(g + 3) * rows + r] = x.w;
      }
      staged = true;
    }
  }
  if (!staged) {
    for (int i = threadIdx.x; i < rows * G; i += G * kWarp) {
      const int r = i / G;
      const int g = i - r * G;
      smem[g * rows + r] = b0 + g < batch ? parent[r * B + b0 + g] : -1;
    }
  }
}

// Stage rows 0..N-2 of the block's games of batch-major rows as
// staged[g * rows + r]: the games b0..b0+G-1 are one contiguous run of
// parent, copied element by element. Games past the batch are not staged
// (their warps exit without reading).
template <int G>
__device__ __forceinline__ void stage_batch_major(
    const int32_t* __restrict__ parent, int32_t* smem, int num_nodes,
    int batch, int b0) {
  const int rows = num_nodes - 1;
  const int games = min(G, batch - b0);
  const int32_t* src = parent + static_cast<size_t>(b0) * num_nodes;
  for (int i = threadIdx.x; i < games * num_nodes; i += G * kWarp) {
    const int g = i / num_nodes;
    const int r = i - g * num_nodes;
    if (r < rows) smem[g * rows + r] = src[i];
  }
}

// The walk of game b0 + warp over its staged parent links, after the
// block's barrier. ``lay`` says where element (row, b) of a column lies.
template <int G, class Layout>
__device__ __forceinline__ void walk(
    const int32_t* smem_staged, int32_t* smem_lists, const Layout lay,
    const int32_t* __restrict__ parent_action, const int32_t* __restrict__ n,
    const float* __restrict__ q, const float* __restrict__ v,
    const float* __restrict__ edge_prior, const float* __restrict__ eany,
    const int32_t* __restrict__ nba, const float* __restrict__ nbp,
    int num_nodes, int batch, float cpuct, float fpu_reduction,
    int32_t* __restrict__ out, float* __restrict__ out_p_sel) {
  const int rows = num_nodes - 1;  // row N-1 is the sink, never a child
  const int warp = static_cast<int>(threadIdx.x) / kWarp;
  const int lane = static_cast<int>(threadIdx.x) % kWarp;
  const int b = static_cast<int>(blockIdx.x) * G + warp;
  if (b >= batch) return;
  const size_t B = static_cast<size_t>(batch);
  const int32_t* const my_parent = smem_staged + warp * rows;
  int32_t* const list = smem_lists + warp * kWarp;

  int node = 0;
  int action = 0;
  int child = -1;
  int depth = 0;
  float p_sel = 0.0f;
  int n_node = n[lay.at(0, b)];
  // An unvisited or terminal root keeps the initial outputs.
  bool done = (n_node == 0) || (eany[lay.at(0, b)] > 0.5f);
  // Every value below is the same in all 32 lanes (loaded at one address
  // or broadcast by a shuffle), so the warp never diverges on them. A walk
  // visits at most N distinct nodes; the cap only guards against a
  // corrupted tree turning into an endless loop.
  for (int step = 0; !done && step < num_nodes; ++step) {
    const size_t at = lay.at(node, b);
    const float v_node = v[at];
    const float pv_u = nbp[at];
    const int a_u = nba[at];
    const float sqrt_n = sqrtf(static_cast<float>(n_node));
    float seen = 0.0f;
    float best_c = kNegInf;
    int c_row = 0, c_n = 0, c_action = 0;
    float c_ep = 0.0f, c_eany = 0.0f;

    int base = 0;          // first row of the chunk being scanned
    unsigned pending = 0;  // its children not listed yet (bit = lane)
    bool fresh = true;     // the chunk at ``base`` is not scanned yet
    while (base < rows) {
      // List up to 32 children in ascending row order.
      int count = 0;
      while (count < kWarp && base < rows) {
        if (fresh) {
          const int r = base + lane;
          pending = __ballot_sync(kFullMask, r < rows && my_parent[r] == node);
          fresh = false;
        }
        const int take = min(__popc(pending), kWarp - count);
        const int pos = __popc(pending & ((1u << lane) - 1u));
        if (((pending >> lane) & 1u) && pos < take) {
          list[count + pos] = base + lane;
        }
        count += take;
        for (int t = 0; t < take; ++t) pending &= pending - 1u;
        if (pending == 0) {
          base += kWarp;
          fresh = true;
        }
      }
      __syncwarp();
      if (count == 0) break;
      // Lane j loads the columns of the j-th listed child: one round of
      // global loads for all of them.
      int row = 0, cn = 0, pa = 0;
      float ep = 0.0f, ce = 0.0f, score = kNegInf;
      if (lane < count) {
        row = list[lane];
        const size_t rb = lay.at(row, b);
        ep = edge_prior[rb];
        cn = n[rb];
        pa = parent_action[rb];
        ce = eany[rb];
        score = q[rb] + cpuct * ep * sqrt_n / (1.0f + static_cast<float>(cn));
      }
      // Then the children one at a time, in row order.
      int win = -1;
      for (int j = 0; j < count; ++j) {
        const float ep_j = __shfl_sync(kFullMask, ep, j);
        const float score_j = __shfl_sync(kFullMask, score, j);
        seen = seen + ep_j;
        if (score_j > best_c) {  // first strict maximum
          best_c = score_j;
          win = j;
        }
      }
      if (win >= 0) {
        c_row = __shfl_sync(kFullMask, row, win);
        c_n = __shfl_sync(kFullMask, cn, win);
        c_action = __shfl_sync(kFullMask, pa, win);
        c_ep = __shfl_sync(kFullMask, ep, win);
        c_eany = __shfl_sync(kFullMask, ce, win);
      }
      __syncwarp();  // the next round rewrites the list
    }

    const float fpu = v_node - fpu_reduction * sqrtf(fmaxf(seen, 0.0f));
    const float best_u =
        pv_u >= 0.0f ? fpu + cpuct * pv_u * sqrt_n : kNegInf;
    if (best_c > best_u) {  // a visited child wins; ties go to the new edge
      action = c_action;
      child = c_row;
      p_sel = c_ep;
      done = (c_eany > 0.5f) || (c_n == 0);
      node = c_row;
      n_node = c_n;
    } else {
      action = a_u;
      child = -1;
      p_sel = pv_u;
      done = true;
    }
    ++depth;
  }
  if (lane == 0) {
    out[b] = node;
    out[B + b] = action;
    out[2 * B + b] = child;
    out[3 * B + b] = depth;
    out_p_sel[b] = p_sel;
  }
}

#define AZG_DESCEND_PARAMS                                                  \
  const int32_t *__restrict__ parent,                                       \
      const int32_t *__restrict__ parent_action,                            \
      const int32_t *__restrict__ n, const float *__restrict__ q,           \
      const float *__restrict__ v, const float *__restrict__ edge_prior,    \
      const float *__restrict__ eany, const int32_t *__restrict__ nba,      \
      const float *__restrict__ nbp, int num_nodes, int batch, float cpuct, \
      float fpu_reduction, int32_t *__restrict__ out,                       \
      float *__restrict__ out_p_sel
#define AZG_WALK_ARGS                                                      \
  parent_action, n, q, v, edge_prior, eany, nba, nbp, num_nodes, batch,    \
      cpuct, fpu_reduction, out, out_p_sel

// Game-minor [N, B] columns.
template <int G>
__global__ void __launch_bounds__(G* kWarp)
    descend_kernel(AZG_DESCEND_PARAMS) {
  extern __shared__ int32_t smem[];
  const int rows = num_nodes - 1;
  stage_game_minor<G>(parent, smem, rows, batch,
                      static_cast<int>(blockIdx.x) * G);
  __syncthreads();  // the only block-wide barrier
  walk<G>(smem, smem + G * rows, GameMinor{static_cast<size_t>(batch)},
          AZG_WALK_ARGS);
}

// Batch-major [B, N] rows.
template <int G>
__global__ void __launch_bounds__(G* kWarp)
    descend_rows_kernel(AZG_DESCEND_PARAMS) {
  extern __shared__ int32_t smem[];
  const int rows = num_nodes - 1;
  stage_batch_major<G>(parent, smem, num_nodes, batch,
                       static_cast<int>(blockIdx.x) * G);
  __syncthreads();  // the only block-wide barrier
  walk<G>(smem, smem + G * rows, BatchMajor{static_cast<size_t>(num_nodes)},
          AZG_WALK_ARGS);
}

#undef AZG_WALK_ARGS
#undef AZG_DESCEND_PARAMS

template <int G, bool kRows>
cudaError_t launch(const void* parent, const void* parent_action,
                   const void* n, const void* q, const void* v,
                   const void* edge_prior, const void* eany, const void* nba,
                   const void* nbp, int num_nodes, int batch, float cpuct,
                   float fpu_reduction, void* out, void* out_p_sel,
                   cudaStream_t stream) {
  const auto kernel = kRows ? &descend_rows_kernel<G> : &descend_kernel<G>;
  const size_t smem = smem_bytes(num_nodes, G);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (batch + G - 1) / G;
  kernel<<<blocks, G * kWarp, smem, stream>>>(
      static_cast<const int32_t*>(parent),
      static_cast<const int32_t*>(parent_action),
      static_cast<const int32_t*>(n), static_cast<const float*>(q),
      static_cast<const float*>(v), static_cast<const float*>(edge_prior),
      static_cast<const float*>(eany), static_cast<const int32_t*>(nba),
      static_cast<const float*>(nbp), num_nodes, batch, cpuct, fpu_reduction,
      static_cast<int32_t*>(out), static_cast<float*>(out_p_sel));
  return cudaGetLastError();
}

template <bool kRows>
int descend_entry(const void* parent, const void* parent_action,
                  const void* n, const void* q, const void* v,
                  const void* edge_prior, const void* eany, const void* nba,
                  const void* nbp, int num_nodes, int batch,
                  int games_per_block, float cpuct, float fpu_reduction,
                  void* out, void* out_p_sel, int device, void* stream) {
  azg::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AZG_LAUNCH(G)                                                      \
  launch<G, kRows>(parent, parent_action, n, q, v, edge_prior, eany, nba,  \
                   nbp, num_nodes, batch, cpuct, fpu_reduction, out,       \
                   out_p_sel, s)
  cudaError_t err;
  switch (games_per_block) {
    case 8: err = AZG_LAUNCH(8); break;
    case 4: err = AZG_LAUNCH(4); break;
    case 2: err = AZG_LAUNCH(2); break;
    case 1: err = AZG_LAUNCH(1); break;
    default: err = cudaErrorInvalidValue;
  }
#undef AZG_LAUNCH
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points (loaded with ctypes). The nine inputs are contiguous
// device columns, game-minor [N, B] for azg_descend and batch-major [B, N]
// for azg_descend_rows; ``out`` is int32 [4, B] (node, action, child,
// depth) and ``out_p_sel`` float32 [B]. ``games_per_block`` is 8, 4, 2 or 1
// (chosen by the wrapper so that the staged rows fit); ``device`` is the
// CUDA device of the tensors and ``stream`` a cudaStream_t on it. Each
// returns the cudaError_t of switching the device, raising the shared
// memory limit or the launch.
extern "C" int azg_descend(const void* parent, const void* parent_action,
                           const void* n, const void* q, const void* v,
                           const void* edge_prior, const void* eany,
                           const void* nba, const void* nbp, int num_nodes,
                           int batch, int games_per_block, float cpuct,
                           float fpu_reduction, void* out, void* out_p_sel,
                           int device, void* stream) {
  return descend_entry<false>(parent, parent_action, n, q, v, edge_prior,
                              eany, nba, nbp, num_nodes, batch,
                              games_per_block, cpuct, fpu_reduction, out,
                              out_p_sel, device, stream);
}

extern "C" int azg_descend_rows(const void* parent, const void* parent_action,
                                const void* n, const void* q, const void* v,
                                const void* edge_prior, const void* eany,
                                const void* nba, const void* nbp,
                                int num_nodes, int batch, int games_per_block,
                                float cpuct, float fpu_reduction, void* out,
                                void* out_p_sel, int device, void* stream) {
  return descend_entry<true>(parent, parent_action, n, q, v, edge_prior,
                             eany, nba, nbp, num_nodes, batch,
                             games_per_block, cpuct, fpu_reduction, out,
                             out_p_sel, device, stream);
}
