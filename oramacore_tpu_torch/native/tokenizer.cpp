// Native tokenizer + Porter2 (Snowball English) stemmer.
//
// The host-side ingest hot loop (reference: write/index/fields.rs:715
// tokenizes every string field of every document; the reference does this
// in Rust). This implementation must produce byte-identical output to
// utils/tokenizer.py (tests enforce parity; a copy of the JAX package's
// native/tokenizer.cpp).
//
// C ABI:
//   tokenize_and_stem(text) -> malloc'd buffer:
//     "token\tstem\n" per token ("token\t\n" when stem == token);
//   free_result(buf) releases it.
//
// Build: native/_build.py (g++ -O2 -shared -fPIC) into build/native/.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Porter2 stemmer
// ---------------------------------------------------------------------------

inline bool is_vowel(char c) {
    return c == 'a' || c == 'e' || c == 'i' || c == 'o' || c == 'u' || c == 'y';
}
inline bool is_vowel_y(const std::string& w, size_t i) {
    char c = w[i];
    return c == 'a' || c == 'e' || c == 'i' || c == 'o' || c == 'u' || c == 'y';
}

bool ends_with(const std::string& w, const char* suf) {
    size_t n = std::strlen(suf);
    return w.size() >= n && w.compare(w.size() - n, n, suf) == 0;
}

bool has_vowel(const std::string& w, size_t start, size_t end) {
    for (size_t i = start; i < end && i < w.size(); i++)
        if (is_vowel_y(w, i)) return true;
    return false;
}

size_t compute_r1(const std::string& w) {
    static const char* prefixes[] = {"gener", "commun", "arsen"};
    for (const char* p : prefixes) {
        size_t n = std::strlen(p);
        if (w.size() >= n && w.compare(0, n, p) == 0) return n;
    }
    for (size_t i = 1; i < w.size(); i++)
        if (!is_vowel_y(w, i) && is_vowel_y(w, i - 1)) return i + 1;
    return w.size();
}

size_t compute_r2(const std::string& w, size_t r1) {
    for (size_t i = r1 + 1; i < w.size(); i++)
        if (!is_vowel_y(w, i) && is_vowel_y(w, i - 1)) return i + 1;
    return w.size();
}

bool ends_short_syllable(const std::string& w) {
    size_t n = w.size();
    if (n == 2) return is_vowel_y(w, 0) && !is_vowel_y(w, 1);
    if (n >= 3) {
        char c = w[n - 1];
        return !is_vowel_y(w, n - 1) && c != 'w' && c != 'x' && c != 'Y' &&
               is_vowel_y(w, n - 2) && !is_vowel_y(w, n - 3);
    }
    return false;
}

bool is_short(const std::string& w, size_t r1) {
    return r1 >= w.size() && ends_short_syllable(w);
}

bool ends_double(const std::string& w) {
    static const char* doubles[] = {"bb", "dd", "ff", "gg", "mm",
                                    "nn", "pp", "rr", "tt"};
    for (const char* d : doubles)
        if (ends_with(w, d)) return true;
    return false;
}

const char* exception1(const std::string& w) {
    struct { const char* in; const char* out; } table[] = {
        {"skis", "ski"}, {"skies", "sky"}, {"dying", "die"},
        {"lying", "lie"}, {"tying", "tie"}, {"idly", "idl"},
        {"gently", "gentl"}, {"ugly", "ugli"}, {"early", "earli"},
        {"only", "onli"}, {"singly", "singl"}, {"sky", "sky"},
        {"news", "news"}, {"howe", "howe"}, {"atlas", "atlas"},
        {"cosmos", "cosmos"}, {"bias", "bias"}, {"andes", "andes"},
    };
    for (auto& e : table)
        if (w == e.in) return e.out;
    return nullptr;
}

bool exception2(const std::string& w) {
    static const char* table[] = {"inning", "outing", "canning", "herring",
                                  "earring", "proceed", "exceed", "succeed"};
    for (const char* e : table)
        if (w == e) return true;
    return false;
}

void mark_ys(std::string& w) {
    if (!w.empty() && w[0] == 'y') w[0] = 'Y';
    for (size_t i = 1; i < w.size(); i++)
        if (w[i] == 'y' && is_vowel(w[i - 1])) w[i] = 'Y';
}

std::string porter2(const std::string& token) {
    std::string word = token;
    for (auto& c : word)
        if (c >= 'A' && c <= 'Z') c += 32;
    if (word.size() <= 2) return word;
    // lstrip apostrophes
    size_t s = 0;
    while (s < word.size() && word[s] == '\'') s++;
    word = word.substr(s);
    if (const char* e = exception1(word)) return e;
    if (word.size() <= 2) return word;

    const std::string original = word;
    mark_ys(word);
    size_t r1 = compute_r1(word);
    size_t r2 = compute_r2(word, r1);

    // step 0
    if (ends_with(word, "'s'")) word.resize(word.size() - 3);
    else if (ends_with(word, "'s")) word.resize(word.size() - 2);
    else if (ends_with(word, "'")) word.resize(word.size() - 1);

    // step 1a (mirrors the python impl incl. the ied/ies re-derivation)
    bool ied_ies = ends_with(original, "ied") || ends_with(original, "ies");
    if (word.size() >= 4 && ends_with(word, "sses")) {
        word.resize(word.size() - 2);
    } else if (ends_with(word, "ied") || ends_with(word, "ies")) {
        word.resize(word.size() - 2);
        if (word.size() > 2) word.resize(word.size() - 1);
    } else if (ends_with(word, "ss") || ends_with(word, "us")) {
        // keep
    } else if (ends_with(word, "s")) {
        if (word.size() >= 2 && has_vowel(word, 0, word.size() - 2))
            word.resize(word.size() - 1);
    }
    if (ied_ies) {
        std::string base = original.substr(0, original.size() - 3);
        std::string repl = base.size() <= 1 ? "ie" : "i";
        word = base + repl;
        mark_ys(word);
        r1 = compute_r1(word);
        if (r1 > word.size()) r1 = word.size();
        r2 = compute_r2(word, r1);
        if (r2 > word.size()) r2 = word.size();
    }

    if (exception2(word)) return word;

    // step 1b
    if (ends_with(word, "eedly")) {
        if (word.size() - 5 >= r1) word.resize(word.size() - 3);
    } else if (ends_with(word, "eed")) {
        if (word.size() - 3 >= r1) word.resize(word.size() - 1);
    } else {
        static const char* sufs[] = {"ingly", "edly", "ing", "ed"};
        for (const char* suf : sufs) {
            size_t n = std::strlen(suf);
            if (ends_with(word, suf)) {
                std::string stem = word.substr(0, word.size() - n);
                if (has_vowel(stem, 0, stem.size())) {
                    word = stem;
                    if (ends_with(word, "at") || ends_with(word, "bl") ||
                        ends_with(word, "iz"))
                        word += "e";
                    else if (ends_double(word))
                        word.resize(word.size() - 1);
                    else if (is_short(word, r1))
                        word += "e";
                }
                break;
            }
        }
    }

    // step 1c
    if (word.size() > 2 && (word.back() == 'y' || word.back() == 'Y') &&
        !is_vowel_y(word, word.size() - 2))
        word.back() = 'i';

    if (r1 > word.size()) r1 = word.size();
    if (r2 > word.size()) r2 = word.size();

    // step 2 (in R1)
    {
        struct { const char* suf; const char* repl; } sufs[] = {
            {"ization", "ize"}, {"ational", "ate"}, {"fulness", "ful"},
            {"ousness", "ous"}, {"iveness", "ive"}, {"tional", "tion"},
            {"biliti", "ble"}, {"lessli", "less"}, {"entli", "ent"},
            {"ation", "ate"}, {"alism", "al"}, {"aliti", "al"},
            {"ousli", "ous"}, {"iviti", "ive"}, {"fulli", "ful"},
            {"enci", "ence"}, {"anci", "ance"}, {"abli", "able"},
            {"izer", "ize"}, {"ator", "ate"}, {"alli", "al"},
            {"bli", "ble"},
        };
        bool matched = false;
        for (auto& e : sufs) {
            size_t n = std::strlen(e.suf);
            if (ends_with(word, e.suf)) {
                matched = true;
                if (word.size() - n >= r1)
                    word = word.substr(0, word.size() - n) + e.repl;
                break;
            }
        }
        if (!matched) {
            if (ends_with(word, "ogi")) {
                if (word.size() - 3 >= r1 && word.size() >= 4 &&
                    word[word.size() - 4] == 'l')
                    word.resize(word.size() - 1);
            } else if (ends_with(word, "li")) {
                static const std::string li = "cdeghkmnrt";
                if (word.size() - 2 >= r1 && word.size() >= 3 &&
                    li.find(word[word.size() - 3]) != std::string::npos)
                    word.resize(word.size() - 2);
            }
        }
    }

    // step 3 (in R1; ative needs R2)
    {
        struct { const char* suf; const char* repl; } sufs[] = {
            {"ational", "ate"}, {"tional", "tion"}, {"alize", "al"},
            {"icate", "ic"}, {"iciti", "ic"}, {"ical", "ic"},
            {"ful", ""}, {"ness", ""},
        };
        bool matched = false;
        for (auto& e : sufs) {
            size_t n = std::strlen(e.suf);
            if (ends_with(word, e.suf)) {
                matched = true;
                if (word.size() - n >= r1)
                    word = word.substr(0, word.size() - n) + e.repl;
                break;
            }
        }
        if (!matched && ends_with(word, "ative") && word.size() - 5 >= r2)
            word.resize(word.size() - 5);
    }

    // step 4 (in R2)
    {
        static const char* sufs[] = {
            "ement", "ance", "ence", "able", "ible", "ment",
            "ant", "ent", "ism", "ate", "iti", "ous", "ive", "ize",
            "al", "er", "ic",
        };
        bool matched = false;
        for (const char* suf : sufs) {
            size_t n = std::strlen(suf);
            if (ends_with(word, suf)) {
                matched = true;
                if (word.size() - n >= r2) word.resize(word.size() - n);
                break;
            }
        }
        if (!matched && ends_with(word, "ion") && word.size() - 3 >= r2 &&
            word.size() >= 4) {
            char c = word[word.size() - 4];
            if (c == 's' || c == 't') word.resize(word.size() - 3);
        }
    }

    // step 5
    if (!word.empty() && word.back() == 'e') {
        if (word.size() - 1 >= r2)
            word.resize(word.size() - 1);
        else if (word.size() - 1 >= r1) {
            std::string pre = word.substr(0, word.size() - 1);
            if (!ends_short_syllable(pre)) word.resize(word.size() - 1);
        }
    } else if (ends_with(word, "ll") && word.size() - 1 >= r2) {
        word.resize(word.size() - 1);
    }

    for (auto& c : word)
        if (c == 'Y') c = 'y';
    return word;
}

// ---------------------------------------------------------------------------
// Tokenizer: ASCII + Latin-1/UTF-8 word chars, lowercase
// ---------------------------------------------------------------------------

inline bool ascii_word(unsigned char c) {
    return (c >= '0' && c <= '9') || (c >= 'a' && c <= 'z') ||
           (c >= 'A' && c <= 'Z');
}

}  // namespace

extern "C" {

// Returns a malloc'd "token\tstem\n..." buffer; caller frees with
// free_result. Non-ASCII codepoints pass through untouched inside words.
char* tokenize_and_stem(const char* text) {
    std::string out;
    const unsigned char* p = (const unsigned char*)text;
    size_t len = std::strlen(text);
    size_t i = 0;
    std::string token;
    bool token_ascii = true;
    auto flush = [&]() {
        if (token.empty()) return;
        out += token;
        out += '\t';
        if (token_ascii) {
            std::string stem = porter2(token);
            if (stem != token) out += stem;
        }
        out += '\n';
        token.clear();
        token_ascii = true;
    };
    while (i < len) {
        unsigned char c = p[i];
        if (c < 0x80) {
            if (ascii_word(c)) {
                token += (char)(c >= 'A' && c <= 'Z' ? c + 32 : c);
            } else {
                flush();
            }
            i++;
        } else {
            // multi-byte UTF-8: treat letters as word chars (approximate:
            // Latin-1 supplement / Latin extended are word chars; the
            // python tokenizer governs the exact set — callers only use
            // this path for ASCII-dominant text and fall back otherwise)
            size_t n = (c >= 0xF0) ? 4 : (c >= 0xE0) ? 3 : 2;
            for (size_t k = 0; k < n && i < len; k++, i++)
                token += (char)p[i];
            token_ascii = false;
        }
    }
    flush();
    char* buf = (char*)std::malloc(out.size() + 1);
    std::memcpy(buf, out.c_str(), out.size() + 1);
    return buf;
}

// Wire-format variant: returns the packed op-body payload directly
// (token := surface [\x01 stem], payload := token (\x02 token)*) and
// writes the surface-token count to *n_tokens. This is what the writer
// puts on the op log and what live_accum.cpp consumes — producing it
// here skips the per-token Python tuple round-trip entirely.
char* tokenize_and_stem_wire(const char* text, int64_t* n_tokens) {
    std::string out;
    int64_t count = 0;
    const unsigned char* p = (const unsigned char*)text;
    size_t len = std::strlen(text);
    size_t i = 0;
    std::string token;
    bool token_ascii = true;
    auto flush = [&]() {
        if (token.empty()) return;
        if (count > 0) out += '\x02';
        out += token;
        if (token_ascii) {
            std::string stem = porter2(token);
            if (stem != token) {
                out += '\x01';
                out += stem;
            }
        }
        count++;
        token.clear();
        token_ascii = true;
    };
    while (i < len) {
        unsigned char c = p[i];
        if (c < 0x80) {
            if (ascii_word(c)) {
                token += (char)(c >= 'A' && c <= 'Z' ? c + 32 : c);
            } else {
                flush();
            }
            i++;
        } else {
            size_t n = (c >= 0xF0) ? 4 : (c >= 0xE0) ? 3 : 2;
            for (size_t k = 0; k < n && i < len; k++, i++)
                token += (char)p[i];
            token_ascii = false;
        }
    }
    flush();
    *n_tokens = count;
    char* buf = (char*)std::malloc(out.size() + 1);
    std::memcpy(buf, out.c_str(), out.size() + 1);
    return buf;
}

char* stem_word(const char* word) {
    std::string s = porter2(word);
    char* buf = (char*)std::malloc(s.size() + 1);
    std::memcpy(buf, s.c_str(), s.size() + 1);
    return buf;
}

void free_result(char* buf) { std::free(buf); }

}  // extern "C"
