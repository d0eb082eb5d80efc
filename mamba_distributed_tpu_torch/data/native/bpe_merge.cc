// Native BPE merge loop for the port's GPT-2 tokenizer (a copy of the JAX
// package's data/native/bpe_merge.cc).
//
// The reference's tokenizer dependency (tiktoken) does its merge loop in
// Rust; this is the C++ counterpart for the zero-egress BPE
// (data/gpt2_bpe.py).  Merges are applied on vocab *ids* — Python
// precomputes (a, b) -> (rank, merged) triples from encoder.json +
// vocab.bpe, so no strings cross the boundary.
//
// Semantics mirror GPT2BPE._bpe exactly: repeatedly find the
// lowest-rank adjacent pair present in the table, then merge ALL its
// left-to-right non-overlapping occurrences; stop when no pair ranks.
//
// Built lazily by data/native_bpe.py (g++ -O3 -shared -fPIC), ctypes ABI.

#include <cstddef>
#include <cstdint>
#include <unordered_map>
#include <utility>

namespace {
struct BpeTable {
  std::unordered_map<uint64_t, std::pair<int32_t, int32_t>> m;  // (rank, merged)
};
inline uint64_t pack(int32_t a, int32_t b) {
  return (uint64_t(uint32_t(a)) << 32) | uint32_t(b);
}
}  // namespace

extern "C" {

void* bpe_table_new(const int32_t* a, const int32_t* b, const int32_t* merged,
                    int32_t n) {
  auto* t = new BpeTable();
  t->m.reserve(std::size_t(n) * 2);
  for (int32_t i = 0; i < n; ++i) {
    // first occurrence wins, matching dict-of-ranks construction order
    t->m.emplace(pack(a[i], b[i]), std::make_pair(i, merged[i]));
  }
  return t;
}

void bpe_table_free(void* h) { delete static_cast<BpeTable*>(h); }

// In-place BPE over tok[0..n); returns the merged length.
int32_t bpe_apply(void* h, int32_t* tok, int32_t n) {
  const auto& m = static_cast<BpeTable*>(h)->m;
  while (n > 1) {
    int32_t best_rank = INT32_MAX, best_merged = -1, best_a = 0, best_b = 0;
    for (int32_t i = 0; i + 1 < n; ++i) {
      auto it = m.find(pack(tok[i], tok[i + 1]));
      if (it != m.end() && it->second.first < best_rank) {
        best_rank = it->second.first;
        best_merged = it->second.second;
        best_a = tok[i];
        best_b = tok[i + 1];
      }
    }
    if (best_merged < 0) break;
    int32_t w = 0;
    for (int32_t i = 0; i < n;) {
      if (i + 1 < n && tok[i] == best_a && tok[i + 1] == best_b) {
        tok[w++] = best_merged;
        i += 2;
      } else {
        tok[w++] = tok[i++];
      }
    }
    n = w;
  }
  return n;
}

// Batched form: tok holds n_spans concatenated spans, span i occupying
// tok[offsets[i] .. offsets[i+1]).  Each span is merged independently and
// the results are compacted to the front of tok (w never catches up to
// the next unprocessed span since merging only shrinks).  Per-span merged
// lengths land in out_lens; returns the total compacted length.  One
// ctypes call per document instead of per pre-token.
int32_t bpe_apply_spans(void* h, int32_t* tok, const int32_t* offsets,
                        int32_t n_spans, int32_t* out_lens) {
  int32_t w = 0;
  for (int32_t i = 0; i < n_spans; ++i) {
    int32_t s = offsets[i];
    int32_t n = bpe_apply(h, tok + s, offsets[i + 1] - s);
    out_lens[i] = n;
    for (int32_t j = 0; j < n; ++j) tok[w++] = tok[s + j];
  }
  return w;
}

}  // extern "C"
