// Copy of proqa_tpu/native/wordpiece.cpp (the port keeps its own host code).
// Native wordpiece tokenizer — host-side hot path for corpus encoding.
//
// The reference tokenizes millions of paragraphs in Python through
// transformers.BertTokenizer inside Dataset.__getitem__
// (upstream retrieval/datasets.py:96-101); at TPU encode throughput the
// host tokenizer becomes the bottleneck. This implements BERT basic+wordpiece
// tokenization (clean -> whitespace split -> lower+strip-accents -> punct
// split -> greedy longest-match wordpiece) for the full Basic Multilingual
// Plane with exact parity to proqa_tpu_torch/text/{basic,wordpiece}.py.
//
// Unicode handling: the Python binding precomputes per-codepoint tables from
// the same `unicodedata` the pure-Python path uses — classification flags
// (whitespace/control/punctuation per BERT rules) and, for the lowercase
// mode, the composed strip_accents(lower(ch)) mapping. Codepoints whose
// behavior is not per-character (final sigma, multi-char case foldings,
// Hangul NFD expansion, reorderable kept combiners) are flagged and routed
// to the Python fallback, as are astral (> BMP) codepoints and malformed
// UTF-8. ASCII text takes the same unified path at full speed.
//
// C ABI (ctypes): see proqa_tpu_torch/native/wordpiece.py.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint8_t kWs = 1;         // BERT whitespace (Zs + \t\n\r + ' ')
constexpr uint8_t kCtrl = 2;       // dropped by clean_text (C* cats, \0, FFFD)
constexpr uint8_t kPunct = 4;      // BERT punctuation (ASCII ranges + P*)
constexpr uint8_t kFallback = 8;   // always needs the Python path
constexpr uint8_t kLowerFallback = 16;  // needs Python only when lowercasing
constexpr uint8_t kWs2 = 32;       // str.split()-only whitespace (Zl/Zp):
                                   // splits tokens, but is NOT a word
                                   // boundary in prepare_context

constexpr int32_t kMapDelete = -2;      // lower+strip maps to empty
constexpr size_t kBmp = 0x10000;
constexpr size_t kMaxCharsPerWord = 100;  // WordpieceTokenizer.max_chars_per_word

struct Tokenizer {
  std::unordered_map<std::string, int32_t> vocab;
  int32_t unk_id = 0;
  bool lower = true;
  std::vector<uint8_t> flags;   // [kBmp]
  std::vector<int32_t> lowmap;  // [kBmp]; valid when lower
};

// Decodes one UTF-8 codepoint at p (null-terminated). Returns the codepoint
// and advances *p past it, or returns -1 on malformed input.
inline int32_t decode_utf8(const unsigned char** p) {
  const unsigned char* s = *p;
  unsigned char c = s[0];
  if (c < 0x80) {
    *p = s + 1;
    return c;
  }
  int n;
  int32_t cp;
  if ((c & 0xE0) == 0xC0) { n = 1; cp = c & 0x1F; }
  else if ((c & 0xF0) == 0xE0) { n = 2; cp = c & 0x0F; }
  else if ((c & 0xF8) == 0xF0) { n = 3; cp = c & 0x07; }
  else return -1;
  for (int i = 1; i <= n; ++i) {
    if ((s[i] & 0xC0) != 0x80) return -1;
    cp = (cp << 6) | (s[i] & 0x3F);
  }
  *p = s + n + 1;
  return cp;
}

inline void encode_utf8(int32_t cp, std::string* out) {
  if (cp < 0x80) {
    out->push_back(static_cast<char>(cp));
  } else if (cp < 0x800) {
    out->push_back(static_cast<char>(0xC0 | (cp >> 6)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else {
    out->push_back(static_cast<char>(0xE0 | (cp >> 12)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
}

// A word under construction: UTF-8 bytes + codepoint start offsets.
struct Word {
  std::string bytes;
  std::vector<uint32_t> starts;

  void push(int32_t cp) {
    starts.push_back(static_cast<uint32_t>(bytes.size()));
    encode_utf8(cp, &bytes);
  }
  size_t chars() const { return starts.size(); }
  void clear() { bytes.clear(); starts.clear(); }
};

// Greedy longest-match-first wordpiece of one word; appends ids. Substring
// boundaries are codepoint boundaries (matches the Python str slicing).
void wordpiece(const Tokenizer& t, const Word& word, std::vector<int32_t>* out) {
  size_t n = word.chars();
  if (n > kMaxCharsPerWord) {
    out->push_back(t.unk_id);
    return;
  }
  std::vector<int32_t> pieces;
  size_t start = 0;
  std::string buf;
  auto off = [&](size_t i) {
    return i < n ? word.starts[i] : static_cast<uint32_t>(word.bytes.size());
  };
  while (start < n) {
    size_t end = n;
    int32_t piece = -1;
    while (start < end) {
      buf.assign(start > 0 ? "##" : "");
      buf.append(word.bytes, off(start), off(end) - off(start));
      auto it = t.vocab.find(buf);
      if (it != t.vocab.end()) {
        piece = it->second;
        break;
      }
      --end;
    }
    if (piece < 0) {
      out->push_back(t.unk_id);
      return;
    }
    pieces.push_back(piece);
    start = end;
  }
  out->insert(out->end(), pieces.begin(), pieces.end());
}

}  // namespace

extern "C" {

// vocab_blob: newline-joined tokens, index = id.
// flags/lowmap: per-BMP-codepoint tables built by the Python binding
// (copied; the caller may free them after the call).
void* wp_create(const char* vocab_blob, int do_lower_case,
                const uint8_t* flags, const int32_t* lowmap) {
  auto* t = new Tokenizer();
  t->lower = do_lower_case != 0;
  t->flags.assign(flags, flags + kBmp);
  t->lowmap.assign(lowmap, lowmap + kBmp);
  const char* p = vocab_blob;
  int32_t id = 0;
  while (*p) {
    const char* nl = strchr(p, '\n');
    size_t len = nl ? static_cast<size_t>(nl - p) : strlen(p);
    if (len > 0) {
      t->vocab.emplace(std::string(p, len), id);
    }
    ++id;
    if (!nl) break;
    p = nl + 1;
  }
  auto unk = t->vocab.find("[UNK]");
  t->unk_id = unk == t->vocab.end() ? 0 : unk->second;
  return t;
}

void wp_destroy(void* handle) { delete static_cast<Tokenizer*>(handle); }

// Tokenize UTF-8 text into wordpiece ids. Returns the token count (may
// exceed max_out; only min(n, max_out) ids are written). Returns -1 if the
// text needs the Python path (astral codepoint, flagged codepoint, or
// malformed UTF-8).
int32_t wp_tokenize(void* handle, const char* text, int32_t* out,
                    int32_t max_out) {
  const Tokenizer& t = *static_cast<Tokenizer*>(handle);
  std::vector<int32_t> ids;
  Word word;
  auto flush_word = [&]() {
    if (word.chars() > 0) {
      wordpiece(t, word, &ids);
      word.clear();
    }
  };
  const unsigned char* p = reinterpret_cast<const unsigned char*>(text);
  while (*p) {
    int32_t cp = decode_utf8(&p);
    if (cp < 0 || cp >= static_cast<int32_t>(kBmp)) return -1;
    uint8_t f = t.flags[cp];
    if (f & kFallback) return -1;
    if (t.lower && (f & kLowerFallback)) return -1;
    if (f & kCtrl) continue;          // clean_text: dropped
    if (f & (kWs | kWs2)) {           // clean_text + whitespace split
      flush_word();
      continue;
    }
    if (t.lower) {
      cp = t.lowmap[cp];              // strip_accents(lower(ch)), single cp
      if (cp == kMapDelete) continue;
    }
    if (t.flags[cp] & kPunct) {       // punct split AFTER the transform
      flush_word();
      word.push(cp);
      flush_word();
      continue;
    }
    word.push(cp);
  }
  flush_word();
  int32_t n = static_cast<int32_t>(ids.size());
  int32_t w = n < max_out ? n : max_out;
  if (w > 0) memcpy(out, ids.data(), sizeof(int32_t) * w);
  return n;
}

// SQuAD prepare_context (proqa_tpu_torch/text/squad.py:15-49; reference
// qa/prepro_utils.py:62-175) in one native call: whitespace-word split +
// char->word offsets + per-word BERT tokenize with piece->word maps.
//
// All positions are CODEPOINT indices (== Python str indices for BMP text).
// Outputs:
//   c2w[n_cp]        word index containing each char (-1 before first word)
//   word_starts/word_lens[n_words]   doc_tokens spans in the original text
//   o2t[n_words]     first piece index of each word
//   t2o/piece_ids[n_pieces]          word index / wordpiece id per piece
//   counts[3] = {n_cp, n_words, n_pieces}
// Returns 0 on success, -1 when the text needs the Python path, -2 when a
// capacity is too small (counts[] still report the required sizes).
int32_t wp_prepare(void* handle, const char* text,
                   int32_t* c2w, int32_t c2w_cap,
                   int32_t* word_starts, int32_t* word_lens, int32_t* o2t,
                   int32_t w_cap,
                   int32_t* t2o, int32_t* piece_ids, int32_t p_cap,
                   int32_t* counts) {
  const Tokenizer& t = *static_cast<Tokenizer*>(handle);
  std::vector<int32_t> cps;
  const unsigned char* p = reinterpret_cast<const unsigned char*>(text);
  while (*p) {
    int32_t cp = decode_utf8(&p);
    if (cp < 0 || cp >= static_cast<int32_t>(kBmp)) return -1;
    uint8_t f = t.flags[cp];
    if (f & kFallback) return -1;
    if (t.lower && (f & kLowerFallback)) return -1;
    cps.push_back(cp);
  }
  const int32_t n_cp = static_cast<int32_t>(cps.size());

  int32_t n_words = 0, n_pieces = 0;
  bool overflow = false;
  bool in_word = false;
  int32_t word_start = 0;

  Word sub;  // wordpiece unit under construction (post clean/lower/punct)
  std::vector<int32_t> ids;
  auto flush_sub = [&]() {
    if (sub.chars() > 0) {
      wordpiece(t, sub, &ids);
      sub.clear();
    }
  };
  auto flush_word = [&](int32_t end_cp) {
    if (!in_word) return;
    // tokenize the word's codepoints (clean -> ws2 split -> lower -> punct
    // split -> wordpiece), exactly wp_tokenize's inner loop
    ids.clear();
    for (int32_t i = word_start; i < end_cp; ++i) {
      int32_t cp = cps[i];
      uint8_t f = t.flags[cp];
      if (f & kCtrl) continue;
      if (f & (kWs | kWs2)) { flush_sub(); continue; }
      if (t.lower) {
        cp = t.lowmap[cp];
        if (cp == kMapDelete) continue;
      }
      if (t.flags[cp] & kPunct) {
        flush_sub();
        sub.push(cp);
        flush_sub();
        continue;
      }
      sub.push(cp);
    }
    flush_sub();
    if (n_words < w_cap) {
      word_starts[n_words] = word_start;
      word_lens[n_words] = end_cp - word_start;
      o2t[n_words] = n_pieces;
    } else {
      overflow = true;
    }
    for (int32_t id : ids) {
      if (n_pieces < p_cap) {
        t2o[n_pieces] = n_words;
        piece_ids[n_pieces] = id;
      } else {
        overflow = true;
      }
      ++n_pieces;
    }
    ++n_words;
    in_word = false;
  };

  for (int32_t i = 0; i < n_cp; ++i) {
    if (t.flags[cps[i]] & kWs) {     // BERT whitespace = word boundary
      flush_word(i);
    } else if (!in_word) {
      in_word = true;
      word_start = i;
    }
    if (i < c2w_cap) {
      c2w[i] = in_word ? n_words : n_words - 1;
    } else {
      overflow = true;
    }
  }
  flush_word(n_cp);

  counts[0] = n_cp;
  counts[1] = n_words;
  counts[2] = n_pieces;
  if (n_cp > c2w_cap) overflow = true;
  return overflow ? -2 : 0;
}

}  // extern "C"
