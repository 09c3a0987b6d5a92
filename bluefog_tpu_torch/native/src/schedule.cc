// Topology -> ppermute-round compiler (native hot path).
//
// Mirrors bluefog_tpu/ops/schedule.py::_rounds_from_matrix / uniform_weights
// bit-for-bit; the Python implementation remains the fallback and the test
// oracle.  At n = 8192 ranks a fully-connected graph has ~67M edges — this
// O(n^2) pass runs in native code so per-step topology changes never stall
// the training loop.  (The reference's equivalent cost center is rebuilding
// the MPI graph communicator + negotiation tables, mpi_context.cc:373-395.)

#include "bluefog_native.h"

#include <cstring>

extern "C" {

int32_t bf_rounds_from_matrix(int32_t n, const double* w, int32_t* distances,
                              double* send_scale, double* recv_mask,
                              int32_t* src_of) {
  // Pass 1: which shift distances are populated?
  // dist index d-1 for d in 1..n-1.
  int32_t n_rounds = 0;
  // Map distance -> output round index (-1 = unseen).
  int32_t* round_idx = new int32_t[n];
  for (int32_t d = 0; d < n; ++d) round_idx[d] = -1;

  for (int32_t s = 0; s < n; ++s) {
    const double* row = w + (int64_t)s * n;
    for (int32_t dcol = 0; dcol < n; ++dcol) {
      if (dcol == s || row[dcol] == 0.0) continue;
      int32_t dist = dcol - s;
      if (dist < 0) dist += n;
      if (round_idx[dist] < 0) round_idx[dist] = 1;  // mark seen
    }
  }
  for (int32_t dist = 1; dist < n; ++dist) {
    if (round_idx[dist] > 0) {
      round_idx[dist] = n_rounds;
      distances[n_rounds] = dist;
      ++n_rounds;
    }
  }

  std::memset(send_scale, 0, sizeof(double) * (size_t)(n - 1) * n);
  std::memset(recv_mask, 0, sizeof(double) * (size_t)(n - 1) * n);
  for (int64_t i = 0; i < (int64_t)(n - 1) * n; ++i) src_of[i] = -1;

  // Pass 2: fill per-round tables.
  for (int32_t s = 0; s < n; ++s) {
    const double* row = w + (int64_t)s * n;
    for (int32_t dcol = 0; dcol < n; ++dcol) {
      if (dcol == s || row[dcol] == 0.0) continue;
      int32_t dist = dcol - s;
      if (dist < 0) dist += n;
      const int32_t r = round_idx[dist];
      send_scale[(int64_t)r * n + s] = row[dcol];
      recv_mask[(int64_t)r * n + dcol] = 1.0;
      src_of[(int64_t)r * n + dcol] = s;
    }
  }
  delete[] round_idx;
  return n_rounds;
}

void bf_uniform_weights(int32_t n, double* w) {
  // indeg[dst] = # nonzero off-diagonal entries in column dst.
  int64_t* indeg = new int64_t[n];
  for (int32_t d = 0; d < n; ++d) indeg[d] = 0;
  for (int32_t s = 0; s < n; ++s)
    for (int32_t d = 0; d < n; ++d)
      if (s != d && w[(int64_t)s * n + d] != 0.0) ++indeg[d];
  for (int32_t d = 0; d < n; ++d) {
    const double share = 1.0 / (double)(indeg[d] + 1);
    for (int32_t s = 0; s < n; ++s) {
      double* cell = w + (int64_t)s * n + d;
      if (s == d) {
        *cell = share;
      } else {
        *cell = (*cell != 0.0) ? share : 0.0;
      }
    }
  }
  delete[] indeg;
}

}  // extern "C"
