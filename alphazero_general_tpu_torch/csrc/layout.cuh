// Where element (row, game) of a tree column lies in each of the port's two
// tree layouts. The kernels take the layout as a template parameter, so
// both layouts run the same arithmetic in the same order and agree bit for
// bit.

#pragma once

#include <cstddef>

namespace azg {

// Game-minor [N, B] columns (a TreeT): row r of game b at r * B + b, so the
// games of a row are neighbours.
struct GameMinor {
  size_t batch;
  __device__ __forceinline__ size_t at(int row, int b) const {
    return static_cast<size_t>(row) * batch + static_cast<size_t>(b);
  }
};

// Batch-major [B, N] rows (a Tree): row r of game b at b * N + r, so a
// game's rows are neighbours.
struct BatchMajor {
  size_t num_nodes;
  __device__ __forceinline__ size_t at(int row, int b) const {
    return static_cast<size_t>(b) * num_nodes + static_cast<size_t>(row);
  }
};

}  // namespace azg
