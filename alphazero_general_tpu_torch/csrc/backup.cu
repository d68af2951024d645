// Batched MCTS backup: leaf-to-root value propagation, one game per thread,
// updating the game-minor [N, B] n / q / v columns in place.
//
// Replaces: the Pallas TPU kernel _backup_kernel
//   (alphazero_general_tpu/ops/backup.py:26; pallas_call sites at :138,
//   batch-major, and :200, game-minor — one kernel serves both layouts'
//   semantics; the port calls it on game-minor columns).
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
// path (depth + 1 rows of parent, player, n, q, v: a few hundred bytes), so
// the bytes the function must move are well under a megabyte at B = 2048 and
// the launch and the dependent load chain (each step's row comes from the
// previous step's parent load) set the time.
//
// What the design does about it: one thread per game follows its own chain
// with no synchronisation; loads of the same row by neighbouring games are
// coalesced when their paths share a row index. Nothing is staged in shared
// memory because no row is read twice.
//
// Arithmetic order matches the JAX kernel and the plain PyTorch version
// (ops/backup.py); the library is compiled with --fmad=false so that
// q * n + val * disc is not contracted into an FMA.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float value_at(const float* value_row, int p,
                                          int value_size, int num_players,
                                          bool has_draw) {
  float val = value_row[p];
  if (has_draw) {
    val = val + value_row[value_size - 1] / static_cast<float>(num_players);
  }
  return val;
}

__global__ void backup_kernel(const int32_t* __restrict__ parent,
                              const int32_t* __restrict__ player,
                              const int32_t* __restrict__ leaf,
                              const float* __restrict__ value,
                              const int32_t* __restrict__ max_depth,
                              int32_t* __restrict__ n, float* __restrict__ q,
                              float* __restrict__ v, int num_nodes, int batch,
                              int value_size, int num_players, int has_draw,
                              float log_min_discount) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const size_t B = static_cast<size_t>(batch);
  const float* value_row = value + static_cast<size_t>(b) * value_size;
  const bool draw = has_draw != 0;
  const float maxd = fmaxf(static_cast<float>(max_depth[b]), 1.0f);

  int node = leaf[b];
  // A path has fewer than N edges. The cap and the range checks only guard
  // a corrupted tree: it stops the walk instead of looping forever or
  // reading outside the columns.
  for (int i = 0; node > 0 && node < num_nodes && i < num_nodes; ++i) {
    const size_t at = static_cast<size_t>(node) * B + b;
    const int par = parent[at];
    if (par < 0 || par >= num_nodes) break;
    const int par_player = player[static_cast<size_t>(par) * B + b];
    const float val =
        value_at(value_row, par_player, value_size, num_players, draw);
    const float frac = static_cast<float>(i) / maxd;
    float disc = expf(frac * log_min_discount);
    if (val < 0.5f) disc = 2.0f - disc;
    if (val == 0.5f) disc = 1.0f;
    const int n_node = n[at];
    const float nf = static_cast<float>(n_node);
    q[at] = (q[at] * nf + val * disc) / (nf + 1.0f);
    if (n_node == 0) {
      v[at] = value_at(value_row, player[at], value_size, num_players, draw);
    }
    n[at] = n_node + 1;
    node = par;
  }
  // Root visit (MCTS.pyx:289) and the root's own value on its first visit.
  if (n[b] == 0) {
    v[b] = value_at(value_row, player[b], value_size, num_players, draw);
  }
  n[b] += 1;
}

}  // namespace

// Plain C entry point (loaded with ctypes). ``parent``/``player``/``n``/
// ``q``/``v`` are contiguous [N, B] device columns, ``leaf``/``max_depth``
// are [B], ``value`` is [B, value_size]; ``stream`` is a cudaStream_t.
// n, q and v are updated in place. Returns the cudaError_t of the launch.
extern "C" int azg_backup(const void* parent, const void* player,
                          const void* leaf, const void* value,
                          const void* max_depth, void* n, void* q, void* v,
                          int num_nodes, int batch, int value_size,
                          int num_players, int has_draw,
                          float log_min_discount, void* stream) {
  const int blocks = (batch + kThreads - 1) / kThreads;
  backup_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(parent), static_cast<const int32_t*>(player),
      static_cast<const int32_t*>(leaf), static_cast<const float*>(value),
      static_cast<const int32_t*>(max_depth), static_cast<int32_t*>(n),
      static_cast<float*>(q), static_cast<float*>(v), num_nodes, batch,
      value_size, num_players, has_draw, log_min_discount);
  return static_cast<int>(cudaGetLastError());
}
