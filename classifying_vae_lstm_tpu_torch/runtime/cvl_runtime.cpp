// cvl_runtime: native host-side data-pipeline functions.
//
// Copy of classifying_vae_lstm_tpu/runtime/cvl_runtime.cpp for the PyTorch
// port: the windowing / song-to-roll / gather work that prepares the arrays
// the card trains on. A plain C ABI bound with ctypes
// (classifying_vae_lstm_tpu_torch/runtime/native.py), built with g++ at first
// use into build/torch_runtime/. Each function has a NumPy counterpart in
// classifying_vae_lstm_tpu_torch/data/pianoroll.py (or plain indexing), and
// tests/test_torch_loader.py holds them bit for bit against the JAX
// package's NumPy semantics.

#include <algorithm>
#include <atomic>
#include <climits>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int hardware_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

// Run fn(i) for i in [0, n) across a small thread pool.
template <typename F>
void parallel_for(int64_t n, F fn) {
  int nthreads = hardware_threads();
  if (n < 1024 || nthreads <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> threads;
  threads.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t) {
    threads.emplace_back([&]() {
      constexpr int64_t kChunk = 256;
      while (true) {
        int64_t start = next.fetch_add(kChunk);
        if (start >= n) return;
        int64_t end = std::min(start + kChunk, n);
        for (int64_t i = start; i < end; ++i) fn(i);
      }
    });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Sliding windows over a [T, D] float32 roll -> [n_windows, seq, D].
// Window starts are 0, step, 2*step, ... < T - seq  (the reference's
// arange(T - seq) rule — the final valid window is intentionally dropped,
// quirk Q1 at utils/pianoroll.py:49-50). Returns n_windows.
int64_t cvl_sliding_window_f32(const float* roll, int64_t T, int64_t D,
                               int64_t seq, int64_t step, float* out) {
  if (T - seq <= 0) return 0;
  int64_t n = (T - seq + step - 1) / step;  // len(arange(T-seq, step))
  parallel_for(n, [&](int64_t i) {
    const float* src = roll + (i * step) * D;
    std::memcpy(out + i * seq * D, src, sizeof(float) * seq * D);
  });
  return n;
}

// Binarize one song into an 88-key roll with the reference's octave-shift
// rule (utils/pianoroll.py:31-47): notes is a flat int32 array, offsets[t]
// delimit timestep t's notes [offsets[t], offsets[t+1]).
// Returns the offset actually used (21 +/- 12).
int32_t cvl_song_to_roll_f32(const int32_t* notes, const int64_t* offsets,
                             int64_t T, int32_t base_offset, float* out /*T x 88*/) {
  int64_t total = offsets[T];
  int32_t mn = INT32_MAX, mx = INT32_MIN;
  for (int64_t i = 0; i < total; ++i) {
    mn = std::min(mn, notes[i]);
    mx = std::max(mx, notes[i]);
  }
  int32_t off = base_offset;
  if (mn - off < 0) off -= 12;
  if (mx - off > 87) off += 12;
  std::memset(out, 0, sizeof(float) * T * 88);
  parallel_for(T, [&](int64_t t) {
    for (int64_t i = offsets[t]; i < offsets[t + 1]; ++i) {
      int32_t p = notes[i] - off;
      if (p >= 0 && p < 88) out[t * 88 + p] = 1.0f;
    }
  });
  return off;
}

// Shuffle-gather: out[i] = src[perm[i]] for [N, row_elems] float32 arrays.
// The host-side shuffle of the streamed epochs (data/loader.py).
void cvl_gather_rows_f32(const float* src, const int64_t* perm, int64_t n_rows,
                         int64_t row_elems, float* out) {
  parallel_for(n_rows, [&](int64_t i) {
    std::memcpy(out + i * row_elems, src + perm[i] * row_elems,
                sizeof(float) * row_elems);
  });
}

int32_t cvl_version() { return 1; }

}  // extern "C"
