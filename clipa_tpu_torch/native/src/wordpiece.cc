// WordPiece tokenizer — native fast path.
//
// Implements BERT basic tokenization (lowercase, punctuation splitting,
// whitespace) + greedy longest-match WordPiece for ASCII text. Non-ASCII
// input returns -1 and the caller falls back to the Python implementation
// (which handles NFD accent stripping and CJK spacing); LAION captions are
// overwhelmingly ASCII so the fast path covers the hot loop.
//
// Exported C API (ctypes):
//   wp_create(vocab_bytes, len)            -> handle
//   wp_encode(handle, text, len, out, cap) -> n_ids, or -1 on non-ASCII
//   wp_destroy(handle)
//
// `out` is the caller's, one buffer per call: wp_encode reads the handle
// and writes nothing else, so calls from several threads may share a
// handle but never an output buffer.

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
  std::unordered_map<std::string, int32_t> index;
  int32_t unk_id = 0;
  int32_t max_chars_per_word = 100;
};

inline bool is_ascii_punct(unsigned char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

// Greedy longest-match WordPiece over one lowercase word.
int encode_word(const Vocab& v, std::string_view word,
                std::vector<int32_t>* out) {
  if ((int32_t)word.size() > v.max_chars_per_word) {
    out->push_back(v.unk_id);
    return 0;
  }
  size_t start = 0;
  size_t begin_size = out->size();
  std::string piece;
  while (start < word.size()) {
    size_t end = word.size();
    int32_t cur = -1;
    while (start < end) {
      piece.assign(start > 0 ? "##" : "");
      piece.append(word.substr(start, end - start));
      auto it = v.index.find(piece);
      if (it != v.index.end()) {
        cur = it->second;
        break;
      }
      --end;
    }
    if (cur < 0) {
      out->resize(begin_size);
      out->push_back(v.unk_id);
      return 0;
    }
    out->push_back(cur);
    start = end;
  }
  return 0;
}

}  // namespace

extern "C" {

void* wp_create(const char* vocab_bytes, int64_t len) {
  auto* v = new Vocab();
  std::string_view data(vocab_bytes, (size_t)len);
  size_t pos = 0;
  int32_t idx = 0;
  while (pos <= data.size()) {
    size_t nl = data.find('\n', pos);
    std::string_view tok = data.substr(
        pos, nl == std::string_view::npos ? data.size() - pos : nl - pos);
    v->index.emplace(std::string(tok), idx);
    if (tok == "[UNK]") v->unk_id = idx;
    ++idx;
    if (nl == std::string_view::npos) break;
    pos = nl + 1;
  }
  return v;
}

void wp_destroy(void* handle) { delete static_cast<Vocab*>(handle); }

// Returns number of ids written, or -1 if text contains non-ASCII bytes
// (caller must fall back), or -2 if out capacity exceeded.
int64_t wp_encode(void* handle, const char* text, int64_t text_len,
                  int32_t* out, int64_t out_cap) {
  const Vocab& v = *static_cast<Vocab*>(handle);
  std::vector<int32_t> ids;
  ids.reserve(64);
  std::string word;
  word.reserve(32);

  auto flush_word = [&]() {
    if (!word.empty()) {
      encode_word(v, word, &ids);
      word.clear();
    }
  };

  for (int64_t i = 0; i < text_len; ++i) {
    unsigned char c = (unsigned char)text[i];
    if (c >= 0x80) return -1;  // non-ASCII: Python fallback
    if (c == 0 || (c < 0x20 && c != '\t' && c != '\n' && c != '\r')) continue;
    if (c == ' ' || c == '\t' || c == '\n' || c == '\r') {
      flush_word();
    } else if (is_ascii_punct(c)) {
      flush_word();
      word.push_back((char)c);
      flush_word();
    } else {
      word.push_back((char)(c >= 'A' && c <= 'Z' ? c + 32 : c));
    }
  }
  flush_word();

  if ((int64_t)ids.size() > out_cap) return -2;
  std::memcpy(out, ids.data(), ids.size() * sizeof(int32_t));
  return (int64_t)ids.size();
}

}  // extern "C"
