// Host-side data-prep ops (CPU, feeding the training input pipeline).
//
// The port's own copy of dlrover_tpu/native/src/host_ops.cc, built into
// the port's library (dlrover_tpu_torch/native/__init__.py). These run in
// producer processes so the trainer never burns Python time packing
// batches; the numpy versions in native/host_ops.py are their plain
// versions, and both give the same arrays bit for bit.

#include <algorithm>
#include <cstdint>
#include <cstring>

extern "C" {

// Pack ragged token sequences into a fixed [n_seqs, max_len] batch.
//   tokens  : concatenated token ids
//   offsets : n_seqs+1 prefix offsets into tokens
//   out_ids : [n_seqs, max_len] padded with pad_id (truncates long seqs)
//   out_mask: [n_seqs, max_len] 1 where a real token lives, else 0
void pack_sequences(const int32_t* tokens, const int64_t* offsets,
                    int64_t n_seqs, int64_t max_len, int32_t pad_id,
                    int32_t* out_ids, int32_t* out_mask) {
  for (int64_t i = 0; i < n_seqs; ++i) {
    const int64_t start = offsets[i];
    const int64_t len =
        std::min<int64_t>(offsets[i + 1] - start, max_len);
    int32_t* row = out_ids + i * max_len;
    int32_t* mask = out_mask + i * max_len;
    std::memcpy(row, tokens + start, len * sizeof(int32_t));
    for (int64_t j = 0; j < len; ++j) mask[j] = 1;
    for (int64_t j = len; j < max_len; ++j) {
      row[j] = pad_id;
      mask[j] = 0;
    }
  }
}

// Deterministic in-place Fisher-Yates shuffle of an index array using
// splitmix64 — the record-shuffle primitive for dynamic data sharding
// (each worker shuffles within its received shard, seeded by epoch).
static inline uint64_t splitmix64(uint64_t* state) {
  uint64_t z = (*state += 0x9e3779b97f4a7c15ull);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

void shuffle_indices(int64_t* indices, int64_t n, uint64_t seed) {
  uint64_t state = seed;
  for (int64_t i = n - 1; i > 0; --i) {
    const int64_t j =
        static_cast<int64_t>(splitmix64(&state) % (uint64_t)(i + 1));
    std::swap(indices[i], indices[j]);
  }
}

// Causal-LM label shift: labels[i, :-1] = ids[i, 1:], labels[i, -1] and
// every padded position become ignore_id (the -100 HF convention the
// loss masks on, models/losses.py).
void shift_labels(const int32_t* ids, const int32_t* mask, int64_t n_rows,
                  int64_t row_len, int32_t ignore_id, int32_t* out_labels) {
  for (int64_t i = 0; i < n_rows; ++i) {
    const int32_t* row = ids + i * row_len;
    const int32_t* m = mask + i * row_len;
    int32_t* out = out_labels + i * row_len;
    for (int64_t j = 0; j + 1 < row_len; ++j) {
      out[j] = m[j + 1] ? row[j + 1] : ignore_id;
    }
    out[row_len - 1] = ignore_id;
  }
}

}  // extern "C"
