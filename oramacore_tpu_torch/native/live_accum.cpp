// Native live-layer accumulator for StringIndex.
//
// The read side applies index_document ops by bumping (path, term, doc)
// posting cells; in Python this is ~2.7us per token occurrence (dict
// lookups + list appends dominate read-side apply throughput). This
// accumulator keeps the live layer in C++ — flat row arrays (doc, tid,
// tf, exact_tf) per path plus an intern table — and exports them as
// numpy-ready buffers for commit/slab-build (the same flat layout the
// Python fallback uses; see index/string_index.py).
//
// The reference runs this loop in Rust (read/index/mod.rs update_data).
//
// Data-structure note: both hot maps are open-addressing flat tables
// over plain vectors, and term bytes live in ONE arena string — no
// per-node allocations. std::unordered_map<std::string, ...> here
// measured 288 ms just to DESTROY at commit-time clear() with a
// bigram-heavy 3k-doc live layer (node frees), and its per-bump probe
// cost sits on the read-side apply hot loop.
//
// C ABI (ctypes): all strings are UTF-8. A "field payload" encodes the
// tokenize_and_stem output for one index_text call:
//   token := surface [ 0x01 variant ]*
//   payload := token ( 0x02 token )*
// Adjacency bigram shadow terms (surface 0x1F surface — BIGRAM_SEP in
// the Python layer) are generated here when index_bigrams != 0.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

constexpr char kVariantSep = '\x01';
constexpr char kTokenSep = '\x02';
constexpr char kBigramSep = '\x1f';

inline uint64_t mix64(uint64_t h) {
  h ^= h >> 33;
  h *= 0xff51afd7ed558ccdULL;
  h ^= h >> 33;
  h *= 0xc4ceb9fe1a85ec53ULL;
  h ^= h >> 33;
  return h;
}

inline uint64_t fnv1a(const char* s, size_t n) {
  uint64_t h = 1469598103934665603ULL;
  for (size_t i = 0; i < n; ++i) {
    h ^= static_cast<unsigned char>(s[i]);
    h *= 1099511628211ULL;
  }
  return h;
}

// Open-addressing uint64 -> row-index map. erase() marks the value -1;
// the slot is reused when the same key is inserted again (a tombstoned
// (term, doc) cell re-bumped later must start a FRESH row).
struct CellMap {
  static constexpr uint64_t kEmpty = ~0ULL;
  std::vector<uint64_t> keys;
  std::vector<int64_t> vals;
  uint64_t mask = 0;
  size_t used = 0;  // occupied slots (incl. erased-marked)

  void insert_raw(uint64_t k, int64_t v) {
    size_t i = mix64(k) & mask;
    while (keys[i] != kEmpty) i = (i + 1) & mask;
    keys[i] = k;
    vals[i] = v;
    ++used;
  }

  void maybe_grow() {
    if (keys.empty()) {
      keys.assign(64, kEmpty);
      vals.assign(64, 0);
      mask = 63;
      used = 0;
      return;
    }
    if (used * 10 < keys.size() * 7) return;
    std::vector<uint64_t> ok;
    std::vector<int64_t> ov;
    ok.swap(keys);
    ov.swap(vals);
    keys.assign(ok.size() * 2, kEmpty);
    vals.assign(ok.size() * 2, 0);
    mask = keys.size() - 1;
    used = 0;
    for (size_t i = 0; i < ok.size(); ++i)
      if (ok[i] != kEmpty && ov[i] >= 0) insert_raw(ok[i], ov[i]);
  }

  // Pointer to the value slot; *inserted true when the key was absent
  // (or previously erased — caller must assign a fresh row).
  int64_t* find_or_insert(uint64_t k, bool* inserted) {
    maybe_grow();
    size_t i = mix64(k) & mask;
    while (true) {
      if (keys[i] == kEmpty) {
        keys[i] = k;
        vals[i] = -1;
        ++used;
        *inserted = true;
        return &vals[i];
      }
      if (keys[i] == k) {
        *inserted = (vals[i] < 0);
        return &vals[i];
      }
      i = (i + 1) & mask;
    }
  }

  void erase(uint64_t k) {
    if (keys.empty()) return;
    size_t i = mix64(k) & mask;
    while (keys[i] != kEmpty) {
      if (keys[i] == k) {
        vals[i] = -1;
        return;
      }
      i = (i + 1) & mask;
    }
  }
};

// Term interner: bytes in one arena, open-addressing (hash, lid) table.
struct Interner {
  std::string arena;
  std::vector<uint32_t> offs, lens;  // per lid
  std::vector<int32_t> slot_lid;     // -1 = empty
  std::vector<uint64_t> slot_hash;
  uint64_t mask = 0;

  void maybe_grow() {
    if (slot_lid.empty()) {
      slot_lid.assign(64, -1);
      slot_hash.assign(64, 0);
      mask = 63;
      return;
    }
    if (offs.size() * 10 < slot_lid.size() * 7) return;
    std::vector<int32_t> ol;
    std::vector<uint64_t> oh;
    ol.swap(slot_lid);
    oh.swap(slot_hash);
    slot_lid.assign(ol.size() * 2, -1);
    slot_hash.assign(ol.size() * 2, 0);
    mask = slot_lid.size() - 1;
    for (size_t i = 0; i < ol.size(); ++i) {
      if (ol[i] < 0) continue;
      size_t j = oh[i] & mask;
      while (slot_lid[j] >= 0) j = (j + 1) & mask;
      slot_lid[j] = ol[i];
      slot_hash[j] = oh[i];
    }
  }

  int32_t intern(const char* s, size_t n) {
    maybe_grow();
    uint64_t h = fnv1a(s, n);
    size_t i = h & mask;
    while (slot_lid[i] >= 0) {
      if (slot_hash[i] == h) {
        int32_t lid = slot_lid[i];
        if (lens[lid] == n &&
            memcmp(arena.data() + offs[lid], s, n) == 0)
          return lid;
      }
      i = (i + 1) & mask;
    }
    int32_t lid = static_cast<int32_t>(offs.size());
    offs.push_back(static_cast<uint32_t>(arena.size()));
    lens.push_back(static_cast<uint32_t>(n));
    arena.append(s, n);
    slot_lid[i] = lid;
    slot_hash[i] = h;
    return lid;
  }
};

struct PathAccum {
  // (lid << 40 | doc) -> row index.  lids < 2^23, docs < 2^40.
  CellMap cell;
  Interner intern;
  std::vector<int64_t> doc;
  std::vector<int32_t> tid;
  std::vector<float> tf;
  std::vector<float> etf;

  static bool packable(int32_t lid, int64_t d) {
    return lid < (1 << 23) && d >= 0 && d < (1LL << 40);
  }

  void bump(const char* s, size_t n, int64_t d, bool exact) {
    int32_t lid = intern.intern(s, n);
    // (lid, doc) outside the packed-key range: append WITHOUT live
    // dedup — commit's (term, doc) lexsort merges duplicate pairs by
    // summing, so correctness holds; only live-layer compactness drops
    if (!packable(lid, d)) {
      doc.push_back(d);
      tid.push_back(lid);
      tf.push_back(1.0f);
      etf.push_back(exact ? 1.0f : 0.0f);
      return;
    }
    uint64_t key =
        (static_cast<uint64_t>(lid) << 40) | static_cast<uint64_t>(d);
    bool inserted = false;
    int64_t* row = cell.find_or_insert(key, &inserted);
    if (inserted) {
      *row = static_cast<int64_t>(doc.size());
      doc.push_back(d);
      tid.push_back(lid);
      tf.push_back(0.0f);
      etf.push_back(0.0f);
    }
    tf[*row] += 1.0f;
    if (exact) etf[*row] += 1.0f;
  }
};

struct LiveAccum {
  std::vector<PathAccum> paths;
  // doc -> rows per path, for tombstoning deletes: (path_id, row)
  std::unordered_map<int64_t, std::vector<std::pair<int32_t, int64_t>>>
      doc_rows;
  int64_t tombstoned = 0;

  PathAccum& path(int32_t pid) {
    if (static_cast<size_t>(pid) >= paths.size()) paths.resize(pid + 1);
    return paths[pid];
  }
};

}  // namespace

extern "C" {

void* la_new() { return new LiveAccum(); }

void la_free(void* h) { delete static_cast<LiveAccum*>(h); }

// Returns the number of surface tokens indexed.
int64_t la_index_field(void* h, int32_t path_id, int64_t doc_id,
                       const char* payload, int64_t payload_len,
                       int32_t index_bigrams) {
  LiveAccum* la = static_cast<LiveAccum*>(h);
  PathAccum& pa = la->path(path_id);
  auto& rows = la->doc_rows[doc_id];
  size_t row_mark = pa.doc.size();

  int64_t n_tokens = 0;
  const char* p = payload;
  const char* end = payload + payload_len;
  const char* prev_surface = nullptr;
  size_t prev_surface_len = 0;
  std::string bigram;
  while (p < end) {
    const char* tok_end = static_cast<const char*>(
        memchr(p, kTokenSep, static_cast<size_t>(end - p)));
    if (tok_end == nullptr) tok_end = end;
    // surface
    const char* var = static_cast<const char*>(
        memchr(p, kVariantSep, static_cast<size_t>(tok_end - p)));
    const char* surf_end = var == nullptr ? tok_end : var;
    if (surf_end > p) {
      pa.bump(p, static_cast<size_t>(surf_end - p), doc_id, true);
      ++n_tokens;
      if (index_bigrams && prev_surface != nullptr) {
        bigram.assign(prev_surface, prev_surface_len);
        bigram.push_back(kBigramSep);
        bigram.append(p, static_cast<size_t>(surf_end - p));
        pa.bump(bigram.data(), bigram.size(), doc_id, true);
      }
      prev_surface = p;
      prev_surface_len = static_cast<size_t>(surf_end - p);
    }
    // variants
    while (var != nullptr) {
      const char* v0 = var + 1;
      const char* v1 = static_cast<const char*>(
          memchr(v0, kVariantSep, static_cast<size_t>(tok_end - v0)));
      const char* v_end = v1 == nullptr ? tok_end : v1;
      if (v_end > v0)
        pa.bump(v0, static_cast<size_t>(v_end - v0), doc_id, false);
      var = v1;
    }
    p = tok_end < end ? tok_end + 1 : end;
  }
  // record the rows this call created for delete tombstoning
  for (size_t r = row_mark; r < pa.doc.size(); ++r)
    rows.emplace_back(path_id, static_cast<int64_t>(r));
  return n_tokens;
}

// Tombstone every live row of a doc (doc -> -1); rows are dropped at
// commit/slab-build by the keep mask. Returns rows tombstoned.
int64_t la_delete_doc(void* h, int64_t doc_id) {
  LiveAccum* la = static_cast<LiveAccum*>(h);
  auto it = la->doc_rows.find(doc_id);
  if (it == la->doc_rows.end()) return 0;
  int64_t n = 0;
  for (auto& [pid, row] : it->second) {
    PathAccum& pa = la->paths[pid];
    if (pa.doc[row] == doc_id) {
      if (PathAccum::packable(pa.tid[row], doc_id)) {
        uint64_t key = (static_cast<uint64_t>(pa.tid[row]) << 40) |
                       static_cast<uint64_t>(doc_id);
        pa.cell.erase(key);
      }
      pa.doc[row] = -1;
      ++n;
    }
  }
  la->doc_rows.erase(it);
  la->tombstoned += n;
  return n;
}

int64_t la_n_rows(void* h, int32_t path_id) {
  LiveAccum* la = static_cast<LiveAccum*>(h);
  if (static_cast<size_t>(path_id) >= la->paths.size()) return 0;
  return static_cast<int64_t>(la->paths[path_id].doc.size());
}

int64_t la_n_terms(void* h, int32_t path_id) {
  LiveAccum* la = static_cast<LiveAccum*>(h);
  if (static_cast<size_t>(path_id) >= la->paths.size()) return 0;
  return static_cast<int64_t>(la->paths[path_id].intern.offs.size());
}

int32_t la_n_paths(void* h) {
  return static_cast<int32_t>(static_cast<LiveAccum*>(h)->paths.size());
}

// Copy row arrays into caller-provided buffers (sized via la_n_rows).
void la_export_rows(void* h, int32_t path_id, int64_t* doc_out,
                    int32_t* tid_out, float* tf_out, float* etf_out) {
  LiveAccum* la = static_cast<LiveAccum*>(h);
  PathAccum& pa = la->paths[path_id];
  size_t n = pa.doc.size();
  memcpy(doc_out, pa.doc.data(), n * sizeof(int64_t));
  memcpy(tid_out, pa.tid.data(), n * sizeof(int32_t));
  memcpy(tf_out, pa.tf.data(), n * sizeof(float));
  memcpy(etf_out, pa.etf.data(), n * sizeof(float));
}

// Term names for a path, '\n'-joined. Caller frees with la_free_buf.
// total byte length returned via out_len.
char* la_term_names(void* h, int32_t path_id, int64_t* out_len) {
  LiveAccum* la = static_cast<LiveAccum*>(h);
  PathAccum& pa = la->paths[path_id];
  const Interner& in = pa.intern;
  size_t total = in.arena.size() + in.offs.size();
  char* buf = static_cast<char*>(malloc(total > 0 ? total : 1));
  char* w = buf;
  for (size_t lid = 0; lid < in.offs.size(); ++lid) {
    memcpy(w, in.arena.data() + in.offs[lid], in.lens[lid]);
    w += in.lens[lid];
    *w++ = '\n';
  }
  *out_len = static_cast<int64_t>(total);
  return buf;
}

void la_free_buf(void* p) { free(p); }

void la_clear(void* h) {
  LiveAccum* la = static_cast<LiveAccum*>(h);
  la->paths.clear();
  la->doc_rows.clear();
  la->tombstoned = 0;
}

}  // extern "C"
