// tiktoken-compatible byte-BPE merge core: the port's copy of the JAX
// package's csrc/bpe_tokenizer.cpp, built with g++ into
// torchao_tpu_torch/_build/ and called through ctypes from
// torchao_tpu_torch/io/tokenizer.py. The per-piece merge loop is the hot
// path when tokenizing large eval corpora; the unicode regex presplit stays
// in Python, where \p{L}/\p{N} classes exist.
//
// Algorithm (tiktoken byte_pair_merge): start from single bytes; repeatedly
// merge the adjacent pair whose concatenation has the LOWEST vocab rank,
// until no adjacent pair is in the vocab; emit the ranks of the parts.
//
// C API (ctypes):
//   tq_bpe_new(blob, n)         -> handle   blob = repeated records:
//                                            u32 byte_len, then bytes; the
//                                            record index IS the rank
//   tq_bpe_encode(handle, bytes, n, out, cap) -> n_tokens (or -1 if cap)
//   tq_bpe_free(handle)

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
    std::unordered_map<std::string, int32_t> rank;
    int32_t byte_rank[256];  // rank of each single-byte token (-1 if absent)
};

constexpr int32_t kNoRank = INT32_MAX;

}  // namespace

extern "C" {

void* tq_bpe_new(const uint8_t* blob, int64_t n) {
    auto* v = new Vocab();
    for (int i = 0; i < 256; ++i) v->byte_rank[i] = -1;
    int64_t off = 0;
    int32_t rank = 0;
    while (off + 4 <= n) {
        uint32_t len;
        std::memcpy(&len, blob + off, 4);
        off += 4;
        if (off + len > static_cast<uint64_t>(n)) break;
        std::string tok(reinterpret_cast<const char*>(blob + off), len);
        off += len;
        v->rank.emplace(std::move(tok), rank);
        if (len == 1) v->byte_rank[blob[off - 1]] = rank;
        ++rank;
    }
    return v;
}

void tq_bpe_free(void* handle) { delete static_cast<Vocab*>(handle); }

// Encode one presplit piece. Returns the token count, or -1 if out_cap is
// too small, or -2 if a byte has no single-byte token (malformed vocab).
int32_t tq_bpe_encode(void* handle, const uint8_t* piece, int32_t n,
                      int32_t* out, int32_t out_cap) {
    const Vocab& v = *static_cast<Vocab*>(handle);

    // whole-piece fast path
    {
        auto it = v.rank.find(
            std::string(reinterpret_cast<const char*>(piece), n));
        if (it != v.rank.end()) {
            if (out_cap < 1) return -1;
            out[0] = it->second;
            return 1;
        }
    }

    // parts[i] = start offset of part i; pair_rank[i] = rank of the merged
    // (part i + part i+1) or kNoRank
    std::vector<int32_t> starts(n + 1);
    std::vector<int32_t> pair_rank(n + 1, kNoRank);
    for (int32_t i = 0; i <= n; ++i) starts[i] = i;

    auto rank_of = [&](int32_t a, int32_t b_end) -> int32_t {
        auto it = v.rank.find(std::string(
            reinterpret_cast<const char*>(piece + a), b_end - a));
        return it == v.rank.end() ? kNoRank : it->second;
    };

    int32_t n_parts = n;  // parts are starts[0..n_parts], sentinel at end
    for (int32_t i = 0; i + 1 < n_parts; ++i)
        pair_rank[i] = rank_of(starts[i], starts[i + 2]);

    while (n_parts > 1) {
        int32_t best = 0, best_rank = kNoRank;
        for (int32_t i = 0; i + 1 < n_parts; ++i) {
            if (pair_rank[i] < best_rank) {
                best_rank = pair_rank[i];
                best = i;
            }
        }
        if (best_rank == kNoRank) break;
        // merge parts best, best+1: drop starts[best+1]
        starts.erase(starts.begin() + best + 1);
        pair_rank.erase(pair_rank.begin() + best);
        --n_parts;
        if (best + 1 < n_parts)
            pair_rank[best] = rank_of(starts[best], starts[best + 2]);
        if (best > 0)
            pair_rank[best - 1] = rank_of(starts[best - 1], starts[best + 1]);
    }

    if (n_parts > out_cap) return -1;
    for (int32_t i = 0; i < n_parts; ++i) {
        int32_t len = starts[i + 1] - starts[i];
        if (len == 1) {
            int32_t r = v.byte_rank[piece[starts[i]]];
            if (r < 0) return -2;
            out[i] = r;
        } else {
            out[i] = rank_of(starts[i], starts[i + 1]);
        }
    }
    return n_parts;
}

}  // extern "C"
