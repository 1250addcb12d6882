// Copy of proqa_tpu/native/simple_match.cpp (the port keeps its own host code).
// Native DrQA-style span matching — host-side hot path for weak supervision.
//
// The reference runs SimpleTokenizer + token-subsequence answer matching in
// Python per (paragraph, answer) pair, both in the online QA sampler
// (upstream qa/online_sampler.py:132-173) and over the whole
// top-k x question grid in recall evaluation
// (upstream retrieval/eval_retrieval.py:27-45, qa/prepro_dense.py:30-74).
// On a 1-core host this chain is the QA trainer's largest residual cost.
//
// This implements the SimpleTokenizer pattern  ([\p{L}\p{N}\p{M}]+)|([^\p{Z}\p{C}])
// plus lowercased token-subsequence matching and surface-string recovery
// (Tokens.untokenize == para[tok_start(i) : tok_start(i+n)].strip()) in one
// call. Unicode classification tables are probed FROM the same `regex`-module
// pattern the Python path compiles (see native/simple_match.py), so the two
// paths cannot drift. Codepoints whose lowercasing is not a 1:1 BMP map
// (final sigma etc.) and astral codepoints route to the Python fallback.
//
// C ABI (ctypes): see proqa_tpu_torch/native/simple_match.py.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint8_t kAlnum = 1;    // [\p{L}\p{N}\p{M}]
constexpr uint8_t kInvis = 2;    // [\p{Z}\p{C}] — never part of a token
constexpr uint8_t kStripWs = 4;  // str.isspace() — removed by str.strip()
constexpr uint8_t kFallback = 8; // lowercase not a 1:1 BMP map

constexpr size_t kBmp = 0x10000;

struct Matcher {
  std::vector<uint8_t> flags;   // [kBmp]
  std::vector<int32_t> lowmap;  // [kBmp] codepoint -> lower(codepoint)
};

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

struct Doc {
  std::vector<int32_t> cps;        // codepoints
  std::vector<int32_t> byte_off;   // cps.size()+1 byte offsets
  std::vector<int32_t> tok_start;  // codepoint index of each token start
  std::vector<int32_t> tok_end;    // codepoint index one past each token
  std::vector<std::string> keys;   // lowercased UTF-8 token text
};

// Tokenize per the SimpleTokenizer alternation: maximal \p{L}\p{N}\p{M} runs,
// else one non-[\p{Z}\p{C}] char per token. Returns false -> Python fallback.
bool tokenize(const Matcher& m, const char* text, Doc* d) {
  const unsigned char* p = reinterpret_cast<const unsigned char*>(text);
  int32_t off = 0;
  while (*p) {
    const unsigned char* prev = p;
    int32_t cp = decode_utf8(&p);
    if (cp < 0 || cp >= static_cast<int32_t>(kBmp)) return false;
    d->byte_off.push_back(off);
    off += static_cast<int32_t>(p - prev);
    d->cps.push_back(cp);
  }
  d->byte_off.push_back(off);

  const int32_t n = static_cast<int32_t>(d->cps.size());
  std::string key;
  for (int32_t i = 0; i < n;) {
    uint8_t f = m.flags[d->cps[i]];
    if (f & kAlnum) {
      int32_t j = i;
      key.clear();
      while (j < n && (m.flags[d->cps[j]] & kAlnum)) {
        if (m.flags[d->cps[j]] & kFallback) return false;
        encode_utf8(m.lowmap[d->cps[j]], &key);
        ++j;
      }
      d->tok_start.push_back(i);
      d->tok_end.push_back(j);
      d->keys.push_back(key);
      i = j;
    } else if (!(f & kInvis)) {
      if (f & kFallback) return false;
      key.clear();
      encode_utf8(m.lowmap[d->cps[i]], &key);
      d->tok_start.push_back(i);
      d->tok_end.push_back(i + 1);
      d->keys.push_back(key);
      ++i;
    } else {
      ++i;  // Z*/C*: between-token whitespace/invisible
    }
  }
  return true;
}

}  // namespace

extern "C" {

// flags/lowmap: per-BMP-codepoint tables built by the Python binding
// (copied; the caller may free them after the call).
void* sm_create(const uint8_t* flags, const int32_t* lowmap) {
  auto* m = new Matcher();
  m->flags.assign(flags, flags + kBmp);
  m->lowmap.assign(lowmap, lowmap + kBmp);
  return m;
}

void sm_destroy(void* handle) { delete static_cast<Matcher*>(handle); }

// Find gold-answer token subsequences in `para` (both sides lowercased).
//   para          NFD-normalized paragraph, UTF-8
//   answers_blob + ans_off[n_answers+1]  byte ranges of the NFD-normalized
//                 answer strings inside the blob
//   first_only    1 = para_has_answer semantics: stop at the first match,
//                 an answer with no tokens matches vacuously (empty range).
//                 0 = match_answer_span semantics: all matches, empty
//                 answers skipped.
//   out_ranges    [cap_pairs][2] byte ranges into `para` of the matched
//                 surface strings, ALREADY stripped (== Tokens.untokenize)
// Returns the match count (only min(count, cap_pairs) ranges are written),
// or -1 when the text needs the Python path.
int32_t sm_match(void* handle, const char* para,
                 const char* answers_blob, const int32_t* ans_off,
                 int32_t n_answers, int32_t first_only,
                 int32_t* out_ranges, int32_t cap_pairs) {
  const Matcher& m = *static_cast<Matcher*>(handle);
  Doc d;
  if (!tokenize(m, para, &d)) return -1;
  const int32_t ntok = static_cast<int32_t>(d.keys.size());

  int32_t count = 0;
  auto emit = [&](int32_t tok_i, int32_t tok_n) {
    // surface = para[start(i) : start(i+n)].strip()  (text_ws of the slice:
    // each token carries trailing chars up to the next token's start; the
    // last token in the doc carries nothing past its end)
    int32_t s_cp, e_cp;
    if (tok_n == 0) {
      s_cp = e_cp = 0;  // vacuous match: empty surface
    } else {
      s_cp = d.tok_start[tok_i];
      e_cp = (tok_i + tok_n < ntok) ? d.tok_start[tok_i + tok_n]
                                    : d.tok_end[ntok - 1];
      // strip(): only str.isspace() codepoints are removed — other invisible
      // chars in the inter-token gap (e.g. Cf format chars) stay
      while (s_cp < e_cp && (m.flags[d.cps[s_cp]] & kStripWs)) ++s_cp;
      while (e_cp > s_cp && (m.flags[d.cps[e_cp - 1]] & kStripWs)) --e_cp;
    }
    if (count < cap_pairs) {
      out_ranges[2 * count] = d.byte_off[s_cp];
      out_ranges[2 * count + 1] = d.byte_off[e_cp];
    }
    ++count;
  };

  Doc a;
  for (int32_t ai = 0; ai < n_answers; ++ai) {
    std::string ans(answers_blob + ans_off[ai],
                    answers_blob + ans_off[ai + 1]);
    a.cps.clear(); a.byte_off.clear();
    a.tok_start.clear(); a.tok_end.clear(); a.keys.clear();
    if (!tokenize(m, ans.c_str(), &a)) return -1;
    const int32_t na = static_cast<int32_t>(a.keys.size());
    if (na == 0) {
      if (first_only) {  // reference eval_retrieval.py:36-39 vacuous match
        emit(0, 0);
        return count;
      }
      continue;  // train-side span matching skips empty answers
    }
    for (int32_t i = 0; i + na <= ntok; ++i) {
      bool ok = true;
      for (int32_t j = 0; j < na; ++j) {
        if (d.keys[i + j] != a.keys[j]) { ok = false; break; }
      }
      if (ok) {
        emit(i, na);
        if (first_only) return count;
      }
    }
  }
  return count;
}

}  // extern "C"
