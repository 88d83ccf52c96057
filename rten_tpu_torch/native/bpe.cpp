// BPE + WordPiece encode hot loops.
//
// Native core of the port's tokenizer (rten_tpu_torch/text/tokenizer.py):
// the per-piece merge loop, the only hot part, is C++; the pipeline
// (normalizers, pre-tokenizers, decoders) stays in Python. Results equal
// the Python core's (BpeModel / WordPieceModel) for every piece.
//
// BPE: classic linked-list + pair-rank heap, O(n log n) per piece.

#include <cstdint>
#include <cstring>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr size_t kCacheMax = 1 << 16;

struct PairHash {
  size_t operator()(const std::pair<std::string, std::string>& p) const {
    std::hash<std::string> h;
    return h(p.first) * 1000003u ^ h(p.second);
  }
};

struct BpeModel {
  std::unordered_map<std::string, int32_t> vocab;
  std::unordered_map<std::pair<std::string, std::string>, int32_t, PairHash>
      ranks;
  std::string csp;   // continuing_subword_prefix
  std::string eows;  // end_of_word_suffix
  int32_t unk_id = -1;
  // memoized per-piece results (at most kCacheMax pieces)
  std::unordered_map<std::string, std::vector<int32_t>> cache;
  std::vector<int32_t> scratch;  // a result not cached once the cache is full
};

// Split a UTF-8 string into codepoint-sized chunks.
void utf8_chars(const char* s, size_t n, std::vector<std::string>* out) {
  size_t i = 0;
  while (i < n) {
    unsigned char c = s[i];
    size_t len = 1;
    if ((c & 0x80) == 0)
      len = 1;
    else if ((c & 0xE0) == 0xC0)
      len = 2;
    else if ((c & 0xF0) == 0xE0)
      len = 3;
    else if ((c & 0xF8) == 0xF0)
      len = 4;
    if (i + len > n) len = 1;
    out->emplace_back(s + i, len);
    i += len;
  }
}

}  // namespace

extern "C" {

void* rten_bpe_create(const char** vocab_tokens, const int32_t* vocab_ids,
                      int32_t n_vocab, const char** merge_left,
                      const char** merge_right, int32_t n_merges,
                      const char* csp, const char* eows, int32_t unk_id) {
  auto* m = new BpeModel();
  m->vocab.reserve(n_vocab * 2);
  for (int32_t i = 0; i < n_vocab; i++) m->vocab[vocab_tokens[i]] = vocab_ids[i];
  m->ranks.reserve(n_merges * 2);
  for (int32_t i = 0; i < n_merges; i++)
    m->ranks[{merge_left[i], merge_right[i]}] = i;
  m->csp = csp ? csp : "";
  m->eows = eows ? eows : "";
  m->unk_id = unk_id;
  return m;
}

void rten_bpe_destroy(void* h) { delete static_cast<BpeModel*>(h); }

// Tokenize one pre-tokenized piece. Returns the count of ids written, or -1
// when they do not fit max_out (at most one id per UTF-8 byte of the piece:
// a buffer of piece_len ids always suffices).
int32_t rten_bpe_encode(void* h, const char* piece, int32_t piece_len,
                        int32_t* out_ids, int32_t max_out) {
  auto* m = static_cast<BpeModel*>(h);
  std::string key(piece, piece_len);
  auto it = m->cache.find(key);
  if (it == m->cache.end()) {
    std::vector<std::string> syms;
    utf8_chars(piece, piece_len, &syms);
    if (!syms.empty() && !m->eows.empty()) syms.back() += m->eows;
    if (!syms.empty() && !m->csp.empty())
      for (size_t i = 1; i < syms.size(); i++) syms[i] = m->csp + syms[i];

    // Greedy lowest-rank merges.
    while (syms.size() > 1) {
      int best = -1;
      int32_t best_rank = INT32_MAX;
      for (size_t i = 0; i + 1 < syms.size(); i++) {
        auto r = m->ranks.find({syms[i], syms[i + 1]});
        if (r != m->ranks.end() && r->second < best_rank) {
          best_rank = r->second;
          best = static_cast<int>(i);
        }
      }
      if (best < 0) break;
      std::string merged =
          syms[best] + (m->csp.empty()
                            ? syms[best + 1]
                            : syms[best + 1].substr(m->csp.size()));
      syms[best] = merged;
      syms.erase(syms.begin() + best + 1);
    }

    std::vector<int32_t> ids;
    ids.reserve(syms.size());
    for (auto& s : syms) {
      auto v = m->vocab.find(s);
      if (v != m->vocab.end())
        ids.push_back(v->second);
      else if (m->unk_id >= 0)
        ids.push_back(m->unk_id);
      // else: drop silently (HF behavior with no unk token)
    }
    if (m->cache.size() < kCacheMax) {
      it = m->cache.emplace(std::move(key), std::move(ids)).first;
    } else {
      m->scratch = std::move(ids);
    }
  }
  const auto& ids = it == m->cache.end() ? m->scratch : it->second;
  if (static_cast<int32_t>(ids.size()) > max_out) return -1;
  std::memcpy(out_ids, ids.data(), ids.size() * sizeof(int32_t));
  return static_cast<int32_t>(ids.size());
}

// Tokenize n_pieces pieces laid end to end in `data` (piece i is
// piece_lens[i] bytes); their ids go to out_ids one piece after another.
// Returns the total count, or -1 when it does not fit max_out (a buffer of
// one id per byte of `data` always suffices).
int32_t rten_bpe_encode_batch(void* h, const char* data, const int32_t* piece_lens,
                              int32_t n_pieces, int32_t* out_ids, int32_t max_out) {
  int32_t total = 0;
  for (int32_t i = 0; i < n_pieces; i++) {
    int32_t n = rten_bpe_encode(h, data, piece_lens[i], out_ids + total, max_out - total);
    if (n < 0) return -1;
    total += n;
    data += piece_lens[i];
  }
  return total;
}

// ---- WordPiece -----------------------------------------------------------

struct WordPieceModel {
  std::unordered_map<std::string, int32_t> vocab;
  std::string prefix;
  int32_t unk_id;
  int32_t max_chars;
};

void* rten_wordpiece_create(const char** vocab_tokens, const int32_t* vocab_ids,
                            int32_t n_vocab, const char* prefix,
                            int32_t unk_id, int32_t max_chars) {
  auto* m = new WordPieceModel();
  for (int32_t i = 0; i < n_vocab; i++) m->vocab[vocab_tokens[i]] = vocab_ids[i];
  m->prefix = prefix ? prefix : "##";
  m->unk_id = unk_id;
  m->max_chars = max_chars;
  return m;
}

void rten_wordpiece_destroy(void* h) { delete static_cast<WordPieceModel*>(h); }

// At most one id per character, or the one unknown id: a buffer of
// chars + 1 ids always suffices.
int32_t rten_wordpiece_encode(void* h, const char* piece, int32_t piece_len,
                              int32_t* out_ids, int32_t max_out) {
  auto* m = static_cast<WordPieceModel*>(h);
  std::vector<std::string> chars;
  utf8_chars(piece, piece_len, &chars);
  if (static_cast<int32_t>(chars.size()) > m->max_chars) {
    if (max_out < 1) return -1;
    out_ids[0] = m->unk_id;
    return 1;
  }
  std::vector<int32_t> ids;
  size_t start = 0;
  while (start < chars.size()) {
    size_t end = chars.size();
    int32_t found = -1;
    size_t found_end = start;
    while (start < end) {
      std::string sub;
      if (start > 0) sub = m->prefix;
      for (size_t i = start; i < end; i++) sub += chars[i];
      auto v = m->vocab.find(sub);
      if (v != m->vocab.end()) {
        found = v->second;
        found_end = end;
        break;
      }
      end--;
    }
    if (found < 0) {
      if (max_out < 1) return -1;
      out_ids[0] = m->unk_id;
      return 1;
    }
    ids.push_back(found);
    start = found_end;
  }
  if (static_cast<int32_t>(ids.size()) > max_out) return -1;
  std::memcpy(out_ids, ids.data(), ids.size() * sizeof(int32_t));
  return static_cast<int32_t>(ids.size());
}

// The batch form of rten_wordpiece_encode (see rten_bpe_encode_batch); a
// buffer of one id per byte of `data` plus one per piece always suffices.
int32_t rten_wordpiece_encode_batch(void* h, const char* data, const int32_t* piece_lens,
                                    int32_t n_pieces, int32_t* out_ids, int32_t max_out) {
  int32_t total = 0;
  for (int32_t i = 0; i < n_pieces; i++) {
    int32_t n = rten_wordpiece_encode(h, data, piece_lens[i], out_ids + total, max_out - total);
    if (n < 0) return -1;
    total += n;
    data += piece_lens[i];
  }
  return total;
}

}  // extern "C"
