// Batched MCTS backup: leaf-to-root value propagation, one game per thread,
// updating the n / q / v columns in place, in either of the port's tree
// layouts: game-minor [N, B] (backup_kernel, entry point azg_backup) or
// batch-major [B, N] (backup_rows_kernel, azg_backup_rows). Both read and
// write the columns where they lie; only the indexing (layout.cuh) differs.
//
// Replaces: the Pallas TPU kernel _backup_kernel
//   (alphazero_general_tpu/ops/backup.py:26), in both of its pallas_call
//   sites: backup_batched_pallas_t (:167, pallas_call at :200, game-minor)
//   and backup_batched_pallas (:101, pallas_call at :138, with its wrapper
//   backup_batched :233), which transposes batch-major columns to [N, B]
//   and its results back; the rows kernel has no transposes.
//
// What it computes, per game b (MCTS.pyx:260-289): walking node = leaf,
// parent[node], ... until the root, with i counting the steps,
//   val  = value[player[parent]] (+ value[draw] / num_players if has_draw)
//   disc = exp((i / max(max_depth, 1)) * log(min_discount)), which becomes
//          2 - disc when val < 0.5 and 1 when val == 0.5
//   q    = (q * n + val * disc) / (n + 1);  v = own-player value on the
//          first visit;  n += 1
// and then the root takes its own-player v if n[root] == 0, and n[root] += 1.
//
// What bounds it on an H100: latency. A game touches only the rows on its
// path (a few hundred bytes), so the bytes the function must move are well
// under a megabyte at B = 2048 (under 0.1 microsecond at 3.35 TB/s), and
// the launch and the chain of dependent loads set the time: each path
// row is known only once the row below it has been read. Followed edge by
// edge, a level costs two dependent round trips (parent[node], then
// player[parent]) before its read-modify-write of n, q and v.
//
// What this design does about it: each thread first walks its path,
// following parent from the leaf with one dependent load per level, into a
// register array of up to kChunk rows; then it starts the loads of
// player[parent], n and q for the whole chunk together, computes the
// updates in path order, and stores them. A path of d edges costs about
// d + 1 round trips instead of 2d; a longer path takes further chunks. The
// root's n and player, the leaf, max_depth and the value row are loaded
// before the walk and arrive during it. Reading a whole chunk before
// writing any of it is safe because the rows of a path are distinct (a
// tree has no cycles; only a corrupted tree could repeat a row, and the
// step cap only keeps such a walk finite), and the games' columns are
// disjoint. Small blocks (the wrapper's ``threads``, 64 by default) spread
// the games over more SMs. In either layout the threads of a warp follow
// different paths, so their loads do not coalesce; batch-major, a game's
// path rows at least lie in its own row of N ints (1.6 KB at N = 403),
// where game-minor puts consecutive rows of one game B * 4 bytes apart.
//
// Arithmetic order matches the JAX kernel and the plain PyTorch version
// (ops/backup.py); the library is compiled with --fmad=false so that
// q * n + val * disc is not contracted into an FMA.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "layout.cuh"

namespace {

using azg::BatchMajor;
using azg::GameMinor;

constexpr int kChunk = 16;      // path rows held in registers at a time
constexpr int kMaxValues = 8;   // value rows up to this size sit in registers

// value[p] (+ value[draw] / num_players): the value of player p's side.
struct Values {
  const float* row;
  float draw_share;  // value[V-1] / num_players, or 0 without a draw
  bool has_draw;
  float reg[kMaxValues];
  int size;

  __device__ float at(int p) const {
    float raw;
    if (size <= kMaxValues) {
      raw = reg[0];
#pragma unroll
      for (int k = 1; k < kMaxValues; ++k) {
        if (k == p) raw = reg[k];
      }
    } else {
      raw = row[p];
    }
    return has_draw ? raw + draw_share : raw;
  }
};

// The backup of game b; ``lay`` says where element (row, b) of a column
// lies.
template <class Layout>
__device__ __forceinline__ void backup_game(
    const int b, const Layout lay, const int32_t* __restrict__ parent,
    const int32_t* __restrict__ player, const int32_t* __restrict__ leaf,
    const float* __restrict__ value, const int32_t* __restrict__ max_depth,
    int32_t* __restrict__ n, float* __restrict__ q, float* __restrict__ v,
    int num_nodes, int value_size, int num_players, int has_draw,
    float log_min_discount) {
  const size_t root = lay.at(0, b);

  // Independent loads first: they arrive while the path is followed.
  int node = leaf[b];
  const float maxd = fmaxf(static_cast<float>(max_depth[b]), 1.0f);
  const int root_n = n[root];
  const int root_player = player[root];
  Values val_of;
  val_of.row = value + static_cast<size_t>(b) * value_size;
  val_of.size = value_size;
  val_of.has_draw = has_draw != 0;
#pragma unroll
  for (int k = 0; k < kMaxValues; ++k) {
    val_of.reg[k] = k < value_size ? val_of.row[k] : 0.0f;
  }
  val_of.draw_share =
      val_of.has_draw
          ? val_of.row[value_size - 1] / static_cast<float>(num_players)
          : 0.0f;

  // A path has fewer than N edges. The step cap and the range checks only
  // guard a corrupted tree: they stop the walk instead of looping forever
  // or reading outside the columns.
  int i = 0;  // edges done
  bool live = node > 0 && node < num_nodes;
  while (live) {
    // 1. Follow the path up to kChunk edges: one dependent load per edge.
    int rows[kChunk];
    int pars[kChunk];
    int count = 0;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      rows[k] = 0;
      pars[k] = 0;
      if (live) {
        const int par = parent[lay.at(node, b)];
        if (par >= 0 && par < num_nodes) {
          rows[k] = node;
          pars[k] = par;
          count = k + 1;
          node = par;
          live = node > 0 && i + count < num_nodes;
        } else {
          live = false;
        }
      }
    }
    // 2. The chunk's loads, all started together. Row k's own player is
    //    player[pars[k - 1]] for k >= 1; only row 0's is loaded apart.
    int par_player[kChunk];
    int n_old[kChunk];
    float q_old[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      par_player[k] = 0;
      n_old[k] = 0;
      q_old[k] = 0.0f;
      if (k < count) {
        const size_t at = lay.at(rows[k], b);
        par_player[k] = player[lay.at(pars[k], b)];
        n_old[k] = n[at];
        q_old[k] = q[at];
      }
    }
    const int first_player =
        count > 0 ? player[lay.at(rows[0], b)] : 0;
    // 3. The updates, in path order, as the edge-by-edge walk makes them.
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (k < count) {
        const size_t at = lay.at(rows[k], b);
        const float val = val_of.at(par_player[k]);
        const float frac = static_cast<float>(i + k) / maxd;
        float disc = expf(frac * log_min_discount);
        if (val < 0.5f) disc = 2.0f - disc;
        if (val == 0.5f) disc = 1.0f;
        const float nf = static_cast<float>(n_old[k]);
        q[at] = (q_old[k] * nf + val * disc) / (nf + 1.0f);
        if (n_old[k] == 0) {
          v[at] = val_of.at(k == 0 ? first_player
                                   : par_player[k > 0 ? k - 1 : 0]);
        }
        n[at] = n_old[k] + 1;
      }
    }
    i += count;
  }
  // Root visit (MCTS.pyx:289) and the root's own value on its first visit.
  // No path row is the root, so the values loaded at the start still hold.
  if (root_n == 0) v[root] = val_of.at(root_player);
  n[root] = root_n + 1;
}

#define AZG_BACKUP_PARAMS                                                   \
  const int32_t *__restrict__ parent, const int32_t *__restrict__ player,   \
      const int32_t *__restrict__ leaf, const float *__restrict__ value,    \
      const int32_t *__restrict__ max_depth, int32_t *__restrict__ n,       \
      float *__restrict__ q, float *__restrict__ v, int num_nodes,          \
      int batch, int value_size, int num_players, int has_draw,             \
      float log_min_discount
#define AZG_GAME_ARGS                                                      \
  parent, player, leaf, value, max_depth, n, q, v, num_nodes, value_size,  \
      num_players, has_draw, log_min_discount

// Game-minor [N, B] columns.
__global__ void backup_kernel(AZG_BACKUP_PARAMS) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  backup_game(b, GameMinor{static_cast<size_t>(batch)}, AZG_GAME_ARGS);
}

// Batch-major [B, N] rows.
__global__ void backup_rows_kernel(AZG_BACKUP_PARAMS) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  backup_game(b, BatchMajor{static_cast<size_t>(num_nodes)}, AZG_GAME_ARGS);
}

#undef AZG_GAME_ARGS
#undef AZG_BACKUP_PARAMS

template <bool kRows>
int backup_entry(const void* parent, const void* player, const void* leaf,
                 const void* value, const void* max_depth, void* n, void* q,
                 void* v, int num_nodes, int batch, int value_size,
                 int num_players, int has_draw, float log_min_discount,
                 int threads, int device, void* stream) {
  if (threads <= 0 || threads > 1024 || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  azg::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const auto kernel = kRows ? &backup_rows_kernel : &backup_kernel;
  const int blocks = (batch + threads - 1) / threads;
  kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(parent), static_cast<const int32_t*>(player),
      static_cast<const int32_t*>(leaf), static_cast<const float*>(value),
      static_cast<const int32_t*>(max_depth), static_cast<int32_t*>(n),
      static_cast<float*>(q), static_cast<float*>(v), num_nodes, batch,
      value_size, num_players, has_draw, log_min_discount);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes). ``parent``/``player``/``n``/
// ``q``/``v`` are contiguous device columns, game-minor [N, B] for
// azg_backup and batch-major [B, N] for azg_backup_rows; ``leaf``/
// ``max_depth`` are [B], ``value`` is [B, value_size]; n, q and v are
// updated in place. ``threads`` is the block size (a multiple of 32, at
// most 1024), ``device`` the CUDA device of the tensors and ``stream`` a
// cudaStream_t on it. Each returns the cudaError_t of switching the device
// or of the launch.
extern "C" int azg_backup(const void* parent, const void* player,
                          const void* leaf, const void* value,
                          const void* max_depth, void* n, void* q, void* v,
                          int num_nodes, int batch, int value_size,
                          int num_players, int has_draw,
                          float log_min_discount, int threads, int device,
                          void* stream) {
  return backup_entry<false>(parent, player, leaf, value, max_depth, n, q, v,
                             num_nodes, batch, value_size, num_players,
                             has_draw, log_min_discount, threads, device,
                             stream);
}

extern "C" int azg_backup_rows(const void* parent, const void* player,
                               const void* leaf, const void* value,
                               const void* max_depth, void* n, void* q,
                               void* v, int num_nodes, int batch,
                               int value_size, int num_players, int has_draw,
                               float log_min_discount, int threads,
                               int device, void* stream) {
  return backup_entry<true>(parent, player, leaf, value, max_depth, n, q, v,
                            num_nodes, batch, value_size, num_players,
                            has_draw, log_min_discount, threads, device,
                            stream);
}
